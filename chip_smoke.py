#!/usr/bin/env python3
"""Smoke test of the warp pipeline on the GPU, through the CLIs' own
``main(argv)``, at production sizes, in one process.

Phases (one GPU, the default):

1. perspcut, image mode: one seeded 7680x3840 PNG panorama, default preset
   (8 views, 1600²), bicubic, ``--ext png --stats``. Every view is compared
   with the Q14 v360 oracle (``gs360x/kernels/v360_oracle.py``).
2. perspcut, video mode: a seeded 7680x3840 4:2:0 Y4M of 8 frames,
   ``full360coverage`` (4 yaw + 8 views at ±30°, 1600²) with the on-device
   colour move, ``--ext png``. One frame is compared with the same warp run
   on ``jax.devices("cpu")``.
3. dualfisheye: one seeded 3840² ``_X``/``_Y`` PNG lens pair, the default
   Osmo 360 calibration, SFM10 perspective views at 1750²,
   ``--perspective-ext .png``. Every view is compared with the same CLI run
   on ``jax.devices("cpu")``.

Parity limit: 1 u8 LSB, at default precision; the oracle comparison
exempts pixels whose bicubic taps cross a pole row
(``v360_oracle.pole_tap_mask``). Each phase prints its wall time, compile
seconds and ``peak_bytes_in_use``. Any failure exits non-zero. The last
line of stdout is ``{"ok": true, "device": {...}}``.

``--cards 4`` runs only phase 2's export sharded over four GPUs and again on
one GPU in the same process, compares every output file, and checks that the
four-card run put shards on four devices.

Run from the repository root: ``python chip_smoke.py [--cards 4]``. Inputs
are generated from seeds under ``.smoke/`` (removed at exit).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".smoke"
PANO_W, PANO_H = 7680, 3840
LENS_PX = 3840
VIDEO_FRAMES, VIDEO_FPS = 8, 2.0
LSB_LIMIT = 1

_COMPILE_SECONDS = [0.0]


def log(msg: str) -> None:
    print(msg, flush=True)


def _on_duration(event: str, duration: float, **_kw) -> None:
    if event.startswith("/jax/core/compile/"):
        _COMPILE_SECONDS[0] += duration


def run_phase(device, name, fn):
    """Run ``fn`` and print its wall time, compile seconds and the
    device's ``peak_bytes_in_use`` so far."""
    c0, t0 = _COMPILE_SECONDS[0], time.perf_counter()
    result = fn()
    wall = time.perf_counter() - t0
    peak = device.memory_stats().get("peak_bytes_in_use")
    log(f"[phase] {name}: wall {wall} s, compile "
        f"{_COMPILE_SECONDS[0] - c0} s, peak_bytes_in_use {peak}")
    return result


# --------------------------------------------------------------------------
# seeded inputs
# --------------------------------------------------------------------------


def make_texture(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 RGB with gradients, a checkerboard and noise: enough spectral
    content that a sampling bug cannot hide."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    r = (xx * (255.0 / w) + 20.0 * np.sin(yy * 0.011)) % 256.0
    g = (yy * (255.0 / h) + 20.0 * np.sin(xx * 0.007)) % 256.0
    b = ((xx // 64 + yy // 64) % 2) * 160.0 + 40.0
    img = np.stack(np.broadcast_arrays(r, g, b), axis=-1)
    img += rng.normal(0.0, 12.0, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def lsb_diff(got: np.ndarray, want: np.ndarray, mask=None):
    """(max |diff|, differing pixels, compared pixels) in u8 LSB."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    if mask is not None:
        d = d[mask]
    return int(d.max(initial=0)), int((d > 0).sum()), int(d.size)


def check(label: str, results) -> None:
    """Print per-item and total diffs; raise above ``LSB_LIMIT``."""
    worst, differing, compared = 0, 0, 0
    for name, (mx, nd, n) in results:
        log(f"[parity] {label} {name}: max {mx} LSB, {nd} of {n} px differ")
        worst, differing, compared = max(worst, mx), differing + nd, \
            compared + n
    log(f"[parity] {label}: max {worst} LSB over {len(results)} views, "
        f"{differing} of {compared} px differ (limit {LSB_LIMIT} LSB)")
    if worst > LSB_LIMIT:
        raise AssertionError(f"{label}: max diff {worst} LSB > {LSB_LIMIT}")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def perspcut_image(device) -> None:
    from gs360x.io import image as imagelib
    from gs360x.kernels import v360_oracle as vo
    from gs360x.rig.presets import PerspCutConfig, build_view_plan
    from gs360x.tools import perspcut

    pano_dir, out = WORK / "panos", WORK / "image_out"
    pano_dir.mkdir(parents=True)
    pano_path = pano_dir / "pano_0001.png"
    imagelib.write_image(pano_path, make_texture(PANO_H, PANO_W, seed=1))

    def cli():
        rc = perspcut.main(["-i", str(pano_dir), "-o", str(out), "--ext",
                            "png", "--interp", "bicubic", "--stats"])
        if rc != 0:
            raise RuntimeError(f"perspcut image mode exited {rc}")

    run_phase(device, "perspcut-image", cli)

    def parity():
        src = imagelib.read_image(pano_path)
        plan = build_view_plan(PerspCutConfig(ext="png"), [pano_path], out)
        if len(plan.jobs) != 8:
            raise AssertionError(f"expected 8 views, got {len(plan.jobs)}")

        def one(job):
            v = job.view
            geom = dict(width=v.width, height=v.height, hfov_deg=v.hfov_deg,
                        vfov_deg=v.vfov_deg, projection=v.projection)
            want, valid = vo.warp_equirect_oracle(
                src, v.yaw_deg, v.pitch_deg, v.roll_deg, interp="bicubic",
                **geom)
            pole = vo.pole_tap_mask(PANO_H, PANO_W, v.yaw_deg, v.pitch_deg,
                                    v.roll_deg, **geom)
            got = imagelib.read_image(out / job.output_name)
            return job.output_name, lsb_diff(got, want, valid & ~pole)

        with cf.ThreadPoolExecutor(8) as pool:
            check("image vs v360 oracle", list(pool.map(one, plan.jobs)))

    run_phase(device, "parity-image", parity)


def write_video() -> pathlib.Path:
    from gs360x.io import video as videolib

    base = make_texture(PANO_H, PANO_W, seed=2)
    path = WORK / "clip.y4m"
    path.parent.mkdir(parents=True, exist_ok=True)
    videolib.write_y4m(path, (np.roll(base, 97 * i, axis=1)
                              for i in range(VIDEO_FRAMES)),
                       fps=VIDEO_FPS, chroma="420jpeg")
    return path


def video_plan(clip, out):
    from gs360x.rig.presets import PerspCutConfig, build_view_plan

    return build_view_plan(PerspCutConfig(
        preset="full360coverage", ext="png", fps=VIDEO_FPS,
        input_is_video=True), [clip], out)


def perspcut_video_cli(clip, out) -> None:
    from gs360x.tools import perspcut

    rc = perspcut.main(["-i", str(clip), "-o", str(out), "-f",
                        str(VIDEO_FPS), "--preset", "full360coverage",
                        "--ext", "png", "--stats"])
    if rc != 0:
        raise RuntimeError(f"perspcut video mode exited {rc}")
    n = len(list(out.glob("*.png")))
    if n != VIDEO_FRAMES * 12:
        raise AssertionError(f"expected {VIDEO_FRAMES * 12} views, got {n}")


def perspcut_video(device) -> None:
    import jax

    from gs360x.io import image as imagelib
    from gs360x.io import video as videolib
    from gs360x.runtime import executor
    from gs360x.runtime.mesh import data_mesh

    clip, out = write_video(), WORK / "video_out"
    run_phase(device, "perspcut-video", lambda: perspcut_video_cli(clip, out))

    def parity():
        plan = video_plan(clip, out)
        views = plan.unique_views()
        idx, _t, frame = next(iter(videolib.iter_frames(clip,
                                                        fps=VIDEO_FPS)))
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            outs = executor._warp_frames(
                [frame], views, interp=plan.interpolation,
                mesh=data_mesh([cpu]), keep_rec709=plan.keep_rec709,
                quantize_bits=8)[0]
            results = []
            for job, (parent, index) in zip(plan.jobs, outs):
                name = job.output_name.replace("%07d", f"{idx:07d}")
                got = imagelib.read_image(out / name)
                results.append((name, lsb_diff(got,
                                               np.asarray(parent)[index])))
        check("video frame vs cpu", results)

    run_phase(device, "parity-video", parity)


def dualfisheye(device) -> None:
    import jax

    from gs360x import templates
    from gs360x.io import image as imagelib
    from gs360x.tools import dualfisheye as df

    lens_dir = WORK / "lenses"
    lens_dir.mkdir(parents=True)
    for seed, suffix in ((3, "_X"), (4, "_Y")):
        imagelib.write_image(lens_dir / f"pair_0001{suffix}.png",
                             make_texture(LENS_PX, LENS_PX, seed))
    calib = templates.write_osmo360_default_calibration(
        WORK / "osmo360_default_calib.xml")

    def cli(out, *extra):
        rc = df.main(["-i", str(lens_dir), "-x", str(calib), "-o", str(out),
                      "--perspective-size", "1750", "--perspective-ext",
                      ".png", *extra])
        if rc != 0:
            raise RuntimeError(f"dualfisheye exited {rc}")

    out_gpu, out_cpu = WORK / "fisheye_gpu", WORK / "fisheye_cpu"
    run_phase(device, "dualfisheye", lambda: cli(out_gpu))

    def parity():
        # the device map cache holds GPU arrays; the CPU run builds its own
        df._DEVICE_MAPS.clear()
        with jax.default_device(jax.devices("cpu")[0]):
            cli(out_cpu, "--no-fisheye-output")
        df._DEVICE_MAPS.clear()
        names = sorted(p.name for p in
                       (out_gpu / "perspective" / "images").glob("*.png"))
        if len(names) != 10:
            raise AssertionError(f"expected 10 SFM10 views, got {names}")
        check("dualfisheye vs cpu", [
            (n, lsb_diff(
                imagelib.read_image(out_gpu / "perspective" / "images" / n),
                imagelib.read_image(out_cpu / "perspective" / "images" / n)))
            for n in names])

    run_phase(device, "parity-dualfisheye", parity)


def video_four_cards(device) -> None:
    import jax

    from gs360x.io import image as imagelib
    from gs360x.runtime import mesh as meshlib

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--cards 4 needs 4 GPUs, JAX sees {len(devs)}")
    clip = write_video()
    shards = []
    sharded = meshlib.warp_frames_sharded

    def recording(*args, **kw):
        out = sharded(*args, **kw)
        shards.append(len(out.sharding.device_set))
        return out

    out4, out1 = WORK / "video_4cards", WORK / "video_1card"
    with mock.patch.object(meshlib, "warp_frames_sharded", recording):
        run_phase(device, "perspcut-video-4cards",
                  lambda: perspcut_video_cli(clip, out4))
        if set(shards) != {4}:
            raise AssertionError(f"4-card run sharded over {set(shards)} "
                                 "devices")
        log(f"[cards] {len(shards)} launches, each sharded over 4 devices")
        with mock.patch.object(meshlib, "pipeline_devices",
                               lambda: devs[:1]):
            run_phase(device, "perspcut-video-1card",
                      lambda: perspcut_video_cli(clip, out1))
    names = sorted(p.name for p in out4.glob("*.png"))
    check("video 4 cards vs 1 card", [
        (n, lsb_diff(imagelib.read_image(out4 / n),
                     imagelib.read_image(out1 / n))) for n in names])


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: only the video export, sharded over four GPUs "
                         "and compared with one GPU")
    args = ap.parse_args()

    if not (ROOT / "gs360x" / "__init__.py").is_file():
        print(f"[smoke] the gs360x package is not next to {__file__}; run "
              "chip_smoke.py from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"[smoke] no GPU: JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"[gpu] {line}")
    from gs360x.kernels import jaxsetup

    log(f"[jax] {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    log(f"[jax] compile cache: {jaxsetup.cache_dir()}")
    log("[env] importable: " + ", ".join(
        f"{m}={importlib.util.find_spec(m) is not None}"
        for m in ("PIL", "flax", "orbax")))
    log("[env] precision: JAX defaults (what users get)")

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        if args.cards == 4:
            video_four_cards(devs[0])
        else:
            perspcut_image(devs[0])
            perspcut_video(devs[0])
            dualfisheye(devs[0])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
