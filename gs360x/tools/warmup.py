"""gs360x-warmup — prime the persistent compile cache.

First contact with a new (source size × view size × preset) combination
compiles its warp programs. The compiled programs land in the persistent
JAX cache (:func:`gs360x.kernels.jaxsetup.cache_dir`), so paying that once,
ahead of time, makes every later run start hot. This tool runs one dummy
frame through the exact programs a production run would use.

Examples::

    gs360x-warmup --src 7680x3840 --size 1600 --preset default
    gs360x-warmup --src 5760x2880 --size 1600 --preset fisheyelike \\
                  --interp bicubic bilinear
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_wh(text: str):
    for sep in ("x", "X", ","):
        if sep in text:
            w, h = text.split(sep, 1)
            return int(w), int(h)
    raise argparse.ArgumentTypeError(f"expected WxH, got {text!r}")


def build_arg_parser() -> argparse.ArgumentParser:
    from gs360x.rig.presets import PRESET_CHOICES

    ap = argparse.ArgumentParser(
        description="Pre-compile the warp programs for given shapes so "
                    "production runs start hot.")
    ap.add_argument("--src", type=parse_wh, default=(7680, 3840),
                    help="Equirect source size WxH (default 7680x3840)")
    ap.add_argument("--size", type=int, nargs="+", default=[1600],
                    help="View sizes to warm (square px)")
    ap.add_argument("--preset", choices=PRESET_CHOICES, nargs="+",
                    default=["default"],
                    help="Presets whose view sets to warm")
    ap.add_argument("--interp", choices=["bicubic", "bilinear"], nargs="+",
                    default=["bicubic"])
    ap.add_argument("--all", action="store_true",
                    help="Warm the full production matrix: every preset at "
                         "its default size (plus the given --size list), "
                         "and the dual-fisheye SFM10 remap at 1750 px.")
    return ap


def warm_remap(src_size: int = 3840, view_px: int = 1750) -> None:
    """Prime the dual-fisheye direct-perspective remap programs."""
    from gs360x import templates
    from gs360x.tools import dualfisheye as df

    calib_path = templates.default_osmo360_calibration_path()
    if not calib_path.exists():
        templates.write_osmo360_default_calibration(calib_path)
    sensor_map, _ = df.load_metashape_calibration(calib_path)
    calib = next(iter(sensor_map.values()))
    spec = df.build_sfm10_specs(view_px, 12.0, "36 36", 45.0, 45.0)[0]
    mx, my, valid = df.build_direct_perspective_map(
        calib, spec["yaw_deg"], spec["pitch_deg"], spec["hfov_deg"],
        spec["vfov_deg"], view_px, view_px, 190.0)
    frame = np.zeros((src_size, src_size, 3), np.float32)
    # the CLI's --interpolation choices: nearest / linear / cubic
    for interp in ("catmull-rom", "bilinear", "nearest"):
        df.device_remap(frame, mx, my, valid, interp=interp, fill=0.0,
                        quantize=True)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    import pathlib

    import jax

    from gs360x.rig.presets import PerspCutConfig, build_view_plan
    from gs360x.runtime.executor import _warp_frames
    from gs360x.runtime.mesh import data_mesh, pipeline_devices

    src_w, src_h = args.src
    rng = np.random.default_rng(0)
    frame = (rng.random((src_h, src_w, 3)) * 255).astype(np.uint8)
    mesh = data_mesh(pipeline_devices()[:1])
    print(f"[INFO] device: {jax.devices()[0]}  source {src_w}x{src_h}")

    combos = [(p, s, True) for p in args.preset for s in args.size]
    if args.all:
        from gs360x.rig.presets import PRESET_CHOICES

        # every preset at its own default size (size_explicit=False lets
        # the preset pick), plus the explicit --size list
        combos = [(p, args.size[0], False) for p in PRESET_CHOICES]
        combos += [(p, s, True) for p in PRESET_CHOICES
                   for s in args.size]
        t0 = time.time()
        print("[INFO] warming dual-fisheye SFM10 remap (1750 px)")
        warm_remap(src_size=3840)
        print(f"[OK] remap warmed in {time.time() - t0:.1f}s")

    n = 0
    seen = set()
    for preset, size, explicit in combos:
        cfg = PerspCutConfig(preset=preset, size=size,
                             size_explicit=explicit)
        plan = build_view_plan(cfg, [pathlib.Path("warmup.jpg")],
                               pathlib.Path("."))
        views = plan.unique_views()
        vkey = tuple(sorted((v.yaw_deg, v.pitch_deg, v.width, v.height,
                             v.hfov_deg, v.projection) for v in views))
        if vkey in seen:        # preset default == explicit size, etc.
            continue
        seen.add(vkey)
        for interp in args.interp:
            t0 = time.time()
            outs = _warp_frames([frame], views, interp=interp, mesh=mesh,
                                quantize_bits=8)[0]
            jax.block_until_ready([out for out, _ in outs])
            n += 1
            print(f"[OK] {preset} size={size} {interp}: "
                  f"{len(views)} views in {time.time() - t0:.1f}s "
                  "(compiles now cached)")
    print(f"[OK] warmed {n} configuration(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
