#!/usr/bin/env python3
"""End-to-end pipeline benchmarks for the five BASELINE.json scenarios.

Each scenario drives the REAL CLI entry point in-process on synthetic
fixtures (decode -> device warp -> encode, writer pools, resume guards —
everything a user's run pays for), and reports wall-clock plus the
executor's per-stage timers where available. Prints one JSON line per
scenario and a final summary line.

Default ("quick") mode uses PRODUCTION shapes (5.7K/8K sources, 1600 px
views — the combinations `gs360x-warmup --all` pre-compiles) at small
frame counts, so the walls measure the pipeline, not one-off
compiles; ``--full`` uses production frame counts too (300-frame
exports). Per-stage timers separate host stages (decode, fetch, encode)
and any residual compile from device work. ``--json-out`` writes the
records to a JSON artifact for the docs.

Scenarios (BASELINE.md "measurement configs"):
  1. perspcut_default   — default preset: one 5.7K equirect -> 8x1600px
  2. extract_select     — Video2Frames 2fps + FrameSelector top-k
  3. video_export       — full360coverage batched multi-view video export
  4. dualfisheye        — calibration XML -> dual-fisheye undistort+export
  5. full_chain         — MS360 XML -> PerspCut run-cut + transforms.json
                          + PlyOptimizer rotated/downsampled PLY
"""

import argparse
import json
import math
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_with_stats(fn, argv):
    """Run a CLI main() capturing its stdout; return (rc, wall_s,
    stats) with stats parsed from the executor's ``[STATS]`` line
    (``--stats`` flag), e.g. decode/fetch/warp_dispatch/encode/wall."""
    import contextlib
    import io
    import re
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    wall = time.time() - t0
    stats = {}
    for line in buf.getvalue().splitlines():
        m = re.search(r"\[STATS\]\s*(.*)", line)
        if not m:
            continue
        for part in m.group(1).split("|"):
            kv = part.strip().split()
            if len(kv) >= 2:
                stats[kv[0]] = kv[1]
    return rc, wall, stats


def lonlat_pano(w, h, shift=0.0, dtype=np.uint8):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon + shift),
                    0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(2 * lon)], -1)
    return (img * 255).astype(dtype)


def pano_sequence(w, h, n, step=0.05):
    """n drifting panos as horizontal rolls of one base frame — the
    full-size trig costs seconds per 8K frame; a roll is a memcpy."""
    base = lonlat_pano(w, h)
    px = max(1, int(step / (2.0 * math.pi) * w))
    return [np.roll(base, -(i * px) % w, axis=1) for i in range(n)]


def scenario_perspcut_default(root, full):
    """One 5.7K equirect frame -> default-preset perspective cuts."""
    from gs360x.tools import perspcut

    src_w = 5760                      # BASELINE config 1: 5.7K source
    n_frames = 4 if full else 2
    size = 1600
    panos = root / "panos"
    panos.mkdir()
    from gs360x.io import image as im
    for i in range(n_frames):
        im.write_image(panos / f"city_{i:04d}.jpg",
                       lonlat_pano(src_w, src_w // 2, shift=i * 0.3))
    out = root / "cuts"
    rc, wall, _ = run_with_stats(
        perspcut.main, ["-i", str(panos), "-o", str(out),
                        "--size", str(size), "--stats"])
    n_out = len(list(out.glob("*.jpg")))
    assert rc == 0 and n_out == n_frames * 8, (rc, n_out)
    # warm pass: the first run pays any residual compile plus
    # one-time imports; production runs amortize both
    out2 = root / "cuts_warm"
    rc, warm, stats = run_with_stats(
        perspcut.main, ["-i", str(panos), "-o", str(out2),
                        "--size", str(size), "--stats"])
    assert rc == 0
    return {"scenario": "perspcut_default", "wall_s": round(wall, 2),
            "views": n_out, "views_per_s": round(n_out / wall, 2),
            "warm_wall_s": round(warm, 2),
            "warm_views_per_s": round(n_out / warm, 2),
            "warm_stats": stats}


def scenario_extract_select(root, full):
    """Video2Frames 2fps extract + FrameSelector Laplacian top-k."""
    from gs360x.io import video as vio
    from gs360x.tools import frameselector, video2frames

    w, h = (3840, 1920) if full else (1024, 512)
    seconds, fps = (30, 10) if full else (10, 10)
    clip = root / "clip.y4m"
    frames = pano_sequence(w, h, seconds * fps)
    vio.write_y4m(clip, frames, fps=float(fps))
    out = root / "frames"
    t0 = time.time()
    rc = video2frames.main(["-i", str(clip), "-o", str(out), "-f", "2"])
    t_extract = time.time() - t0
    assert rc == 0, rc
    n = len(list(out.glob("*.jpg")))
    t0 = time.time()
    rc = frameselector.main(["-i", str(out), "-m", "lapvar",
                             "-n", "3", "--dry_run"])
    t_select = time.time() - t0
    assert rc == 0, rc
    return {"scenario": "extract_select", "wall_s": round(t_extract + t_select, 2),
            "frames": n, "extract_s": round(t_extract, 2),
            "select_s": round(t_select, 2),
            "frames_per_s": round(n / (t_extract + t_select), 2)}


def scenario_video_export(root, full):
    """full360coverage batched multi-view direct video export."""
    from gs360x.io import video as vio
    from gs360x.tools import perspcut

    w, h = 7680, 3840                 # BASELINE config 3: 8K video
    n_frames = 300 if full else 6
    size = 1600
    clip = root / "pano.y4m"
    vio.write_y4m(clip, pano_sequence(w, h, n_frames, step=0.1), fps=10.0)
    out = root / "vcuts"
    rc, wall, stats = run_with_stats(
        perspcut.main, ["-i", str(clip), "-o", str(out), "-f", "10",
                        "--preset", "full360coverage", "--size", str(size),
                        "--stats"])
    n_out = len(list(out.glob("*.jpg")))
    assert rc == 0 and n_out > 0, (rc, n_out)
    return {"scenario": "video_export", "wall_s": round(wall, 2),
            "views": n_out, "views_per_s": round(n_out / wall, 2),
            "stats": stats}


def scenario_dualfisheye(root, full):
    """Default calibration -> dual-fisheye undistort + perspective export.

    Runs the FULL per-pair path the reference's hot loop runs
    (`gs360_DualFisheyeDistortionCalibration.py:1910-2064`): LUT-less
    color path + per-lens undistort maps + SFM10 perspective views +
    MASK CO-WARP (``--mask-input-dir``) + JPEG/PNG encode via the
    writer pool."""
    from gs360x.io import image as im
    from gs360x.tools import dualfisheye

    size = 3840                       # production Osmo 360 lens frames
    n_pairs = 3 if full else 1
    d = root / "lenses"
    d.mkdir()
    md = root / "lens_masks"
    md.mkdir()
    xs = (2.0 * np.arange(size) + 1.0) / size - 1.0
    nx, ny = np.meshgrid(xs, xs)
    r = np.sqrt(nx * nx + ny * ny)
    # a plausible subject mask: blob of 'person' pixels near centre
    mask = ((np.abs(nx) < 0.25) & (ny > -0.5) & (ny < 0.6)
            & (r < 0.9)).astype(np.uint8) * 255
    for i in range(n_pairs):
        img = np.stack([0.5 + 0.5 * np.cos(6 * r + i),
                        np.clip(1.0 - r, 0, 1),
                        0.5 + 0.5 * np.sin(4 * nx)], -1)
        for suffix, arr in (("X", img), ("Y", img[::-1])):
            name = f"shot_{i:04d}_{suffix}"
            im.write_image(d / f"{name}.jpg",
                           (arr * 255).astype(np.uint8))
            im.write_image(md / f"{name}.jpg",
                           np.repeat(mask[..., None], 3, axis=-1))
    out = root / "df_out"
    t0 = time.time()
    rc = dualfisheye.main(["-i", str(d), "-o", str(out),
                           "--mask-input-dir", str(md)])
    wall = time.time() - t0
    n_out = len(list(out.rglob("*.jpg")))
    n_masks = len(list(out.rglob("*.png")))
    assert rc == 0 and n_out > 0 and n_masks > 0, (rc, n_out, n_masks)
    # reference anchor: the hot loop is per-view cv2.remap bicubic at
    # 1750 px (~3 views/s/core) + per-view mask remap; n_out views +
    # n_masks mask warps at that rate is the CPU-core-equivalent wall
    ref_est_s = (n_out + n_masks) / 3.0
    return {"scenario": "dualfisheye", "wall_s": round(wall, 2),
            "images": n_out, "masks": n_masks,
            "images_per_s": round(n_out / wall, 2),
            "ref_cpu_core_est_s": round(ref_est_s, 1),
            "vs_ref_core_est": round(ref_est_s / wall, 2)}


def scenario_full_chain(root, full):
    """MS360 XML -> perspective cams + run-cut views + rotated PLY."""
    from gs360x.io import image as im
    from gs360x.tools import ms360xml, plyopt

    src_w = 5760
    n_cams = 6 if full else 2
    panos = root / "chain_panos"
    panos.mkdir()
    lines = ["# cameras"]
    import xml.etree.ElementTree as ET
    doc = ET.Element("document")
    chunk = ET.SubElement(doc, "chunk")
    cams = ET.SubElement(chunk, "cameras")
    for i in range(n_cams):
        name = f"pano_{i:04d}"
        im.write_image(panos / f"{name}.jpg",
                       lonlat_pano(src_w, src_w // 2, shift=i * 0.4))
        c = ET.SubElement(cams, "camera", id=str(i), label=name)
        t = np.eye(4)
        t[0, 3] = i * 0.5
        ET.SubElement(c, "transform").text = " ".join(
            f"{v:.6f}" for v in t.reshape(-1))
    xml_path = root / "scene.xml"
    ET.ElementTree(doc).write(xml_path)

    # small synthetic point cloud
    rng = np.random.default_rng(0)
    pts = rng.random((20000, 3)).astype(np.float32) * 10.0
    cols = (rng.random((20000, 3)) * 255).astype(np.uint8)
    ply_in = root / "cloud.ply"
    with open(ply_in, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(pts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        rec = np.zeros(len(pts), dtype=[("xyz", np.float32, 3),
                                        ("rgb", np.uint8, 3)])
        rec["xyz"] = pts
        rec["rgb"] = cols
        f.write(rec.tobytes())

    out = root / "chain_out"
    t0 = time.time()
    rc = ms360xml.main([str(xml_path), "-o", str(out),
                        "--format", "transforms", "--persp-cut",
                        "--cut-input", str(panos),
                        "--cut-out", str(out / "cuts")])
    t_cams = time.time() - t0
    assert rc == 0, rc
    t0 = time.time()
    rc = plyopt.main(["-i", str(ply_in), "-o", str(root / "cloud_opt.ply"),
                      "-t", "5000"])
    t_ply = time.time() - t0
    assert rc == 0, rc
    n_out = len(list(out.rglob("*.jpg")))
    return {"scenario": "full_chain", "wall_s": round(t_cams + t_ply, 2),
            "views": n_out, "cams_s": round(t_cams, 2),
            "ply_s": round(t_ply, 2)}


SCENARIOS = {
    "perspcut_default": scenario_perspcut_default,
    "extract_select": scenario_extract_select,
    "video_export": scenario_video_export,
    "dualfisheye": scenario_dualfisheye,
    "full_chain": scenario_full_chain,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="Production-scale sizes (8K sources, 300 frames).")
    ap.add_argument("--only", choices=sorted(SCENARIOS), default=None)
    ap.add_argument("--json-out", default=None,
                    help="Also write the scenario records to this file.")
    args = ap.parse_args()

    results = []
    names = [args.only] if args.only else list(SCENARIOS)
    for name in names:
        root = pathlib.Path(tempfile.mkdtemp(prefix=f"gs360x_bench_{name}_"))
        try:
            log(f"[bench_e2e] running {name} "
                f"({'full' if args.full else 'quick'}) in {root}")
            res = SCENARIOS[name](root, args.full)
            results.append(res)
            print(json.dumps(res), flush=True)
        except Exception as exc:
            print(json.dumps({"scenario": name, "error": f"{type(exc).__name__}: {exc}"}),
                  flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    total = round(sum(r.get("wall_s", 0.0) for r in results), 2)
    summary = {"scenario": "TOTAL", "wall_s": total,
               "n_ok": len(results), "n_run": len(names)}
    print(json.dumps(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"mode": "full" if args.full else "quick",
                       "scenarios": results, "total": summary}, f,
                      indent=1)
    return 0 if len(results) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
