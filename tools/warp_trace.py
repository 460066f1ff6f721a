#!/usr/bin/env python3
"""Device trace of the XLA warp at the benchmark shapes, on one GPU.

For each shape: the compiled program's memory analysis, its median wall
time (``block_until_ready``), and from a ``jax.profiler`` trace of a few
calls the device time per op and per call, and the achieved bytes/s
against the card's HBM peak: tap bytes (16 taps × 3 × f32 per output
pixel, mostly served from cache), compulsory bytes (the source read once,
the views written once), and an HBM estimate that adds one write and one
read of the program's temporaries. Then the video path's
frames-per-launch choice (1 vs 4) and the device idle share of a warm
``gs360x-perspcut`` image-mode run.

Shapes: 8 x 8K→1920x1080 bicubic (yaw ring), full360coverage 12 x 1600²,
the d190 fisheye pair at 1792², and one lens of the dual-fisheye SFM10
layout (5 views at 1750² from a 3840² lens).

Usage (on a GPU host)::

    python tools/warp_trace.py --out chiprun_out/warp_trace

Writes ``summary.json`` and the raw traces under ``--out``; exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import shutil
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# HBM bandwidth per device_kind (NVIDIA H100 SXM data sheet). A card that
# is not listed is an error, not a default.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

SRC_H, SRC_W = 3840, 7680
F360_YAWS = [0., 90., 180., -90., 45., 135., -135., -45., 45., 135., -135.,
             -45.]
F360_PITCHES = [0.] * 4 + [30.] * 4 + [-30.] * 4
HFOV_14MM = 104.25003269780362        # 2 atan(18 / 14)
WARP_SHAPES = {
    "yaw8_8k_1080p": dict(yaws=[i * 45.0 for i in range(8)], pitches=[0.] * 8,
                          width=1920, height=1080, hfov_deg=112.6,
                          vfov_deg=73.7, projection="perspective"),
    "full360_12x1600": dict(yaws=F360_YAWS, pitches=F360_PITCHES, width=1600,
                            height=1600, hfov_deg=HFOV_14MM,
                            vfov_deg=HFOV_14MM, projection="perspective"),
    "d190_pair_1792": dict(yaws=[0., 180.], pitches=[0., 0.], width=1792,
                           height=1792, hfov_deg=190.0, vfov_deg=190.0,
                           projection="fisheye_v360"),
}
SFM10_ONE_LENS = ("A", "A_U", "A_D", "B", "J")


def median_seconds(fn, reps=10):
    fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(samples, [25, 50, 75])
    return {"median_s": med, "iqr_s": q3 - q1, "reps": reps}


def device_events(trace_dir):
    """(line name, event name, start ns, duration ns) of every event on the
    GPU device planes of the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                out.extend((line.name, ev.name, ev.start_ns, ev.duration_ns)
                           for ev in line.events)
    return out


def summarize(events):
    """Per line: device ns per event name (top 8). Busy ns: the union of
    the kernel intervals on the stream lines."""
    lines = {}
    for line, name, _s, dur in events:
        lines.setdefault(line, {}).setdefault(name, 0.0)
        lines[line][name] += dur
    top = {line: sorted(d.items(), key=lambda kv: -kv[1])[:8]
           for line, d in lines.items()}
    spans = sorted((s, s + d) for line, _n, s, d in events
                   if line.startswith("Stream"))
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"lines": top, "busy_ns": busy}


def op_table(events):
    """Device ns per op of the 'XLA Ops' line (kernel lines if absent)."""
    ops = [(n, d) for line, n, _s, d in events if line == "XLA Ops"] or \
        [(n, d) for line, n, _s, d in events if line.startswith("Stream")]
    table = {}
    for name, dur in ops:
        table[name] = table.get(name, 0.0) + dur
    return sorted(table.items(), key=lambda kv: -kv[1])


TRACED_CALLS = 3


def trace_calls(out_dir, fn, n=TRACED_CALLS):
    import jax

    fn()
    shutil.rmtree(out_dir, ignore_errors=True)
    with jax.profiler.trace(str(out_dir)):
        for _ in range(n):
            fn()
    return device_events(out_dir)


def warp_shapes(out, dev, summary):
    import jax

    from gs360x.runtime import mesh as meshlib

    rng = np.random.default_rng(0)
    frames = jax.device_put(
        (rng.random((1, SRC_H, SRC_W, 3)) * 255).astype(np.uint8), dev)
    for name, shape in WARP_SHAPES.items():
        v = len(shape["yaws"])
        static = dict(width=shape["width"], height=shape["height"],
                      hfov_deg=shape["hfov_deg"], vfov_deg=shape["vfov_deg"],
                      projection=shape["projection"], interp="bicubic",
                      quantize_bits=8)
        args = (frames, np.asarray(shape["yaws"], np.float32),
                np.asarray(shape["pitches"], np.float32),
                np.zeros(v, np.float32))
        t0 = time.perf_counter()
        compiled = meshlib._warp_batch.lower(*args, **static).compile()
        compile_s = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        print(f"[{name}] compile {compile_s} s; memory_analysis: {mem}")

        def run():
            jax.block_until_ready(compiled(*args))

        timing = median_seconds(run)
        events = trace_calls(out / name, run)
        ops = op_table(events)
        out_px = v * shape["width"] * shape["height"]
        summary["warp"][name] = {
            "views": v, "compile_s": compile_s, "memory_analysis": str(mem),
            "temp_bytes": mem.temp_size_in_bytes, **timing,
            "top_ops_ns_per_call": [(n, d / TRACED_CALLS)
                                    for n, d in ops[:6]],
            "trace": summarize(events),
            "tap_bytes": out_px * 16 * 3 * 4,
            "compulsory_bytes": SRC_H * SRC_W * 3 + out_px * 3,
        }
        print(f"[{name}] {timing}; top ops {ops[:3]}")


def sfm10_lens(out, dev, summary):
    import jax
    import jax.numpy as jnp

    from gs360x import templates
    from gs360x.kernels import warp as warplib
    from gs360x.tools import dualfisheye as df

    calib_path = out / "osmo360.xml"
    templates.write_osmo360_default_calibration(calib_path)
    calib = next(iter(df.load_metashape_calibration(calib_path)[0].values()))
    specs = [s for s in df.build_sfm10_specs(1750, 12.0, "36 36", 45.0, 45.0)
             if s["view_id"] in SFM10_ONE_LENS]
    maps = []
    for s in specs:
        mx, my, valid = df.build_direct_perspective_map(
            calib, df.wrap_angle_deg(s["yaw_deg"]), s["pitch_deg"],
            s["hfov_deg"], s["vfov_deg"], 1750, 1750, 190.0)
        maps.append(tuple(jax.device_put(a, dev) for a in (mx, my, valid)))
    rng = np.random.default_rng(1)
    lens = jax.device_put(rng.random((3840, 3840, 3)).astype(np.float32), dev)

    @jax.jit
    def one(src, mx, my, valid):
        out = warplib.remap(src, mx, my, interp="catmull-rom", valid=valid)
        return jnp.rint(jnp.clip(out, 0.0, 1.0) * 255.0).astype(jnp.uint8)

    def run():
        jax.block_until_ready([one(lens, *m) for m in maps])

    timing = median_seconds(run)
    events = trace_calls(out / "sfm10_one_lens", run)
    ops = op_table(events)
    out_px = len(maps) * 1750 * 1750
    summary["warp"]["sfm10_one_lens_1750"] = {
        "views": len(maps), "temp_bytes": 0, **timing,
        "top_ops_ns_per_call": [(n, d / TRACED_CALLS) for n, d in ops[:6]],
        "trace": summarize(events), "tap_bytes": out_px * 16 * 3 * 4,
        "compulsory_bytes": 3840 * 3840 * 3 * 4 + out_px * (3 + 9),
    }
    print(f"[sfm10_one_lens] {timing}; top ops {ops[:3]}")


def frames_per_launch(dev, summary):
    """Video path: 8 decoded 8K frames through full360coverage, fetched to
    the host, with 1 and with 4 frames per launch (order 1, 4, 4, 1)."""
    import jax

    from gs360x.rig.spec import ViewSpec
    from gs360x.runtime import executor
    from gs360x.runtime.mesh import data_mesh

    rng = np.random.default_rng(2)
    base = (rng.random((SRC_H, SRC_W, 3)) * 255).astype(np.uint8)
    frames = [np.roll(base, 97 * i, axis=1) for i in range(8)]
    views = [ViewSpec(f"v{i}", y, p, HFOV_14MM, HFOV_14MM, 1600, 1600)
             for i, (y, p) in enumerate(zip(F360_YAWS, F360_PITCHES))]
    mesh = data_mesh([dev])

    def export(per_launch):
        t0 = time.perf_counter()
        for i in range(0, len(frames), per_launch):
            outs = executor._warp_frames(
                frames[i:i + per_launch], views, interp="bicubic", mesh=mesh,
                keep_rec709=False, quantize_bits=8)
            for parent in {id(p): p for p, _ in outs[0]}.values():
                np.asarray(jax.device_get(parent))
        return time.perf_counter() - t0

    export(1), export(4)                                  # compile both
    runs = {1: [], 4: []}
    for per_launch in (1, 4, 4, 1, 1, 4):
        runs[per_launch].append(export(per_launch))
    summary["frames_per_launch_s_per_8_frames"] = runs
    print(f"[frames_per_launch] {runs}")


def perspcut_idle(out, summary):
    """Idle share of a warm perspcut image-mode run: 1 - busy / wall."""
    from gs360x.io import image as imagelib
    from gs360x.tools import perspcut

    pano_dir = out / "panos"
    pano_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    base = (rng.random((SRC_H, SRC_W, 3)) * 255).astype(np.uint8)
    for i in range(3):
        imagelib.write_image(pano_dir / f"pano_{i:04d}.png",
                             np.roll(base, 511 * i, axis=1))
    argv = ["-i", str(pano_dir), "-o", str(out / "views"), "--ext", "png",
            "--stats"]
    assert perspcut.main(argv) == 0                        # compile, warm
    trace_dir = out / "perspcut_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.environ["GS360X_TRACE_DIR"] = str(trace_dir)
    t0 = time.perf_counter()
    try:
        assert perspcut.main(argv) == 0
    finally:
        del os.environ["GS360X_TRACE_DIR"]
    wall = time.perf_counter() - t0
    events = device_events(trace_dir)
    trace = summarize(events)
    summary["perspcut_image_3x8k"] = {
        "wall_s": wall, "busy_s": trace["busy_ns"] * 1e-9,
        "idle_share": 1.0 - trace["busy_ns"] * 1e-9 / wall,
        "top_ops_ns": op_table(events)[:8], "trace": trace}
    print(f"[perspcut] wall {wall} s, busy {trace['busy_ns'] * 1e-9} s")
    shutil.rmtree(pano_dir)
    shutil.rmtree(out / "views")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=".warp_trace")
    args = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        return 1
    out = pathlib.Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    summary = {"device_kind": dev.device_kind, "jax": jax.__version__,
               "warp": {}}
    warp_shapes(out, dev, summary)
    sfm10_lens(out, dev, summary)
    frames_per_launch(dev, summary)
    perspcut_idle(out, summary)
    peak = HBM_BYTES_PER_S.get(dev.device_kind)
    for entry in summary["warp"].values():
        dev_s = entry["trace"]["busy_ns"] * 1e-9 / TRACED_CALLS
        entry["device_s_per_call"] = dev_s
        if peak is not None:
            hbm = entry["compulsory_bytes"] + 2 * entry["temp_bytes"]
            entry["tap_bytes_per_s"] = entry["tap_bytes"] / dev_s
            entry["compulsory_share_of_hbm_peak"] = (
                entry["compulsory_bytes"] / dev_s / peak)
            entry["est_hbm_share_of_peak"] = hbm / dev_s / peak
    (out / "summary.json").write_text(json.dumps(summary, indent=1,
                                                 default=str))
    print(json.dumps({k: v for k, v in summary.items() if k != "warp"},
                     default=str))
    if peak is None:
        raise KeyError(f"no HBM peak for device kind {dev.device_kind!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
