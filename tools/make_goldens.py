#!/usr/bin/env python3
"""Render v360 golden tiles with REAL ffmpeg for warp-parity checks.

The warp kernels claim v360-convention sampling (pixel-center offsets,
Lagrange bicubic, seam wrap, pole clamp — see
``gs360x/kernels/warp.py``;
reference command builders: ``gs360_360PerspCut.py:286-349`` rectilinear
and ``:351-414`` equisolid).  This environment has no ffmpeg, so that
claim is asserted, not verified.  This script closes the loop wherever
ffmpeg IS available: it renders the test panoramas through the actual
``v360`` filter and writes small golden tiles + metadata that
``tests/test_v360_goldens.py`` compares against (the test skips when no
goldens have been generated).

Usage (on a machine with ffmpeg):
    python tools/make_goldens.py [--out tests/goldens/v360]

Commit the resulting .npz files; the parity test then runs everywhere.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (name, projection, yaw, pitch, hfov, vfov, out_w, out_h)
CASES = [
    ("rect_front", "rectilinear", 0.0, 0.0, 100.0, 60.0, 256, 128),
    ("rect_seam", "rectilinear", 180.0, 0.0, 100.0, 60.0, 256, 128),
    ("rect_pitch30", "rectilinear", 45.0, 30.0, 104.25, 104.25, 256, 256),
    ("rect_pole", "rectilinear", 0.0, 88.0, 100.0, 60.0, 256, 128),
    ("fisheye190", "fisheye", 0.0, 0.0, 190.0, 190.0, 256, 256),
]

SRC_W, SRC_H = 1024, 512


def lonlat_pano(w, h):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([
        0.5 + 0.5 * np.sin(lon),
        0.5 + 0.5 * np.sin(lat),
        0.5 + 0.5 * np.cos(3 * lon),
    ], -1)
    return (img * 255.0).round().astype(np.uint8)


def run_v360(ffmpeg, pano_png, case, out_png):
    name, proj, yaw, pitch, hfov, vfov, w, h = case
    if proj == "rectilinear":
        vf = (f"v360=equirect:rectilinear:h_fov={hfov}:v_fov={vfov}:"
              f"yaw={yaw}:pitch={pitch}:w={w}:h={h}:interp=cubic")
    else:
        vf = (f"v360=equirect:fisheye:d_fov={hfov}:"
              f"yaw={yaw}:pitch={pitch}:w={w}:h={h}:interp=cubic")
    subprocess.run([ffmpeg, "-y", "-loglevel", "error", "-i",
                    str(pano_png), "-vf", vf, "-frames:v", "1",
                    str(out_png)], check=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "tests" / "goldens"
                                         / "v360"))
    args = ap.parse_args()
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        print("[goldens] ffmpeg not found — nothing to do", file=sys.stderr)
        return 1
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    from gs360x.io import image as im

    pano = lonlat_pano(SRC_W, SRC_H)
    with tempfile.TemporaryDirectory() as td:
        pano_png = pathlib.Path(td) / "pano.png"
        im.write_image(pano_png, pano)
        for case in CASES:
            name = case[0]
            out_png = pathlib.Path(td) / f"{name}.png"
            run_v360(ffmpeg, pano_png, case, out_png)
            golden = im.read_image(out_png)
            np.savez_compressed(
                out_dir / f"{name}.npz", golden=golden,
                meta=json.dumps({
                    "projection": case[1], "yaw": case[2],
                    "pitch": case[3], "hfov": case[4], "vfov": case[5],
                    "width": case[6], "height": case[7],
                    "src_w": SRC_W, "src_h": SRC_H,
                    "interp": "cubic",
                }))
            print(f"[goldens] wrote {name}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
