"""Pixel parity against REAL ffmpeg v360 output (golden tiles).

``tools/make_goldens.py`` renders the test panorama through the actual
``v360`` filter (``interp=cubic``) on a machine with ffmpeg and commits
compressed goldens; this test compares the warp against them
within interpolation tolerance.  Skips when no goldens exist (this
build environment has no ffmpeg — SURVEY §7 lists v360 pixel parity as
a hard part precisely because of that).

Tolerance note: v360's ``cubic`` is a Lagrange-basis 4-tap kernel on
pixel-center coordinates, which is what ``gs360x.kernels.warp``
implements; residual differences come from u8 rounding and
v360's fixed-point tap weights. Measured bounds against the independent
Q14 oracle (``gs360x/kernels/v360_oracle.py``) are recorded in
``docs/V360_PARITY.md`` and gated by ``tests/test_v360_oracle.py``;
the thresholds below leave headroom for real-ffmpeg colorspace and
encode differences on top of those.
"""

import json
import math
import pathlib

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens" / "v360"
GOLDENS = sorted(GOLDEN_DIR.glob("*.npz")) if GOLDEN_DIR.exists() else []


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


@pytest.mark.skipif(not GOLDENS, reason="no v360 goldens generated "
                    "(run tools/make_goldens.py where ffmpeg exists)")
@pytest.mark.parametrize("path", GOLDENS, ids=lambda p: p.stem)
def test_warp_matches_v360_golden(path):
    from gs360x.kernels import warp

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    golden = data["golden"].astype(np.float32)
    pano = lonlat_pano(meta["src_w"], meta["src_h"]).astype(np.float32) \
        / 255.0

    proj = ("perspective" if meta["projection"] == "rectilinear"
            else "fisheye_v360")
    out = warp.warp_equirect_to_views(
        pano, np.asarray([meta["yaw"]], np.float32),
        np.asarray([meta["pitch"]], np.float32),
        np.asarray([0.0], np.float32),
        width=meta["width"], height=meta["height"],
        hfov_deg=meta["hfov"], vfov_deg=meta["vfov"], projection=proj,
        interp="bicubic")
    ours = np.asarray(out)[0] * 255.0

    if proj == "fisheye_v360":
        # compare inside the image circle only (v360 pads differently)
        h, w = golden.shape[:2]
        xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
        ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
        nx, ny = np.meshgrid(xs, ys)
        mask = np.hypot(nx, ny) <= 0.98
    else:
        mask = np.ones(golden.shape[:2], bool)

    diff = np.abs(ours - golden)[mask]
    # interpolation tolerance: u8 quantization + v360's fixed-point taps
    assert float(np.percentile(diff, 99)) <= 3.0, \
        f"p99 diff {np.percentile(diff, 99):.2f} u8 LSB vs v360 golden"
    assert float(diff.mean()) <= 1.0
