"""Gate the warp against the independent v360 oracle.

``gs360x/kernels/v360_oracle.py`` is a from-scratch scalar-numpy port of
ffmpeg v360's remap algorithm (Q14 fixed-point Lagrange taps,
pixel-center mapping, pole reflection with the half-panorama column
shift) — written with none of the repo's jax geometry code, so the
parity measured here is NOT self-referential.
The reference delegates all reprojection to v360
(``/root/reference/cli_tools/gs360_360PerspCut.py:310-314, 375-379``).

Tolerances: the warp accumulates in float where v360 rounds each tap
product to int16 Q14, so up to 1 u8 LSB of rounding difference is
expected anywhere; 2 LSB covers product-vs-separable quantization
corners. Full measured numbers: ``docs/V360_PARITY.md``
(``tools/v360_parity_report.py``).
"""

import numpy as np
import pytest

from gs360x.kernels import v360_oracle as vo
from gs360x.kernels import warp as warp_xla

SRC_H, SRC_W = 256, 512
OUT = 128


@pytest.fixture(scope="module")
def pano():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:SRC_H, 0:SRC_W]
    img = np.stack([
        (xx * 255.0 / SRC_W + 15.0 * np.sin(yy * 0.13)) % 256.0,
        (yy * 255.0 / SRC_H + 15.0 * np.sin(xx * 0.09)) % 256.0,
        ((xx // 8 + yy // 8) % 2) * 140.0 + 50.0,
    ], axis=-1)
    img += rng.normal(0.0, 10.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# --- oracle self-checks ----------------------------------------------------


def test_oracle_constant_panorama_is_constant():
    """Lagrange weights sum to 1; Q14 rounding keeps a flat field flat."""
    src = np.full((64, 128, 3), 137, np.uint8)
    out, valid = vo.warp_equirect_oracle(
        src, 33.0, 21.0, 7.0, width=48, height=48,
        hfov_deg=100.0, vfov_deg=100.0, interp="bicubic")
    assert np.all(np.abs(out[valid].astype(int) - 137) <= 1)


def test_oracle_yaw_shifts_columns():
    """A 90-degree yaw on a longitude-striped pano shifts content by W/4."""
    xs = (np.arange(256)[None, :] * np.ones((128, 1))).astype(np.float64)
    src = np.stack([(xs % 256), np.zeros_like(xs), np.zeros_like(xs)],
                   -1).astype(np.uint8)
    a, _ = vo.warp_equirect_oracle(src, 0.0, 0.0, 0.0, width=64, height=64,
                                   hfov_deg=60.0, vfov_deg=60.0)
    b, _ = vo.warp_equirect_oracle(src, 90.0, 0.0, 0.0, width=64, height=64,
                                   hfov_deg=60.0, vfov_deg=60.0)
    # content under a 90-deg yaw comes from 64 columns (=W/4) to the right
    mid = np.float64(a[32, 32, 0])
    mid_b = np.float64(b[32, 32, 0])
    assert abs(((mid_b - mid) % 256.0) - 64.0) <= 2.0


def _u8(arr01):
    return np.clip(np.rint(np.asarray(arr01) * 255.0), 0, 255).astype(np.uint8)


CASES = [
    # (projection, hfov, yaw, pitch, roll, pole_taps)
    ("perspective", 104.25, 37.0, 0.0, 0.0, False),
    ("perspective", 104.25, 180.0, 0.0, 0.0, False),   # seam crossing
    ("perspective", 104.25, 45.0, 30.0, 0.0, False),
    ("perspective", 110.0, 20.0, 60.0, 0.0, True),     # deep shear
    ("perspective", 104.25, 10.0, 15.0, 20.0, False),  # roll
    ("fisheye_v360", 190.0, 0.0, 0.0, 0.0, True),
    # pole-centered (cube105 up face): wide2-wholesale route; taps cross
    # the pole everywhere near the cap — exercises reflection hardest
    ("perspective", 104.25, 0.0, 90.0, 0.0, True),
]

@pytest.mark.parametrize("proj,hfov,yaw,pitch,roll,pole", CASES)
def test_xla_backend_matches_oracle(pano, proj, hfov, yaw, pitch, roll, pole):
    oracle, valid = vo.warp_equirect_oracle(
        pano, yaw, pitch, roll, width=OUT, height=OUT,
        hfov_deg=hfov, vfov_deg=hfov, projection=proj, interp="bicubic")
    out = warp_xla.warp_equirect_to_views(
        np.asarray(pano, np.float32) / 255.0,
        np.array([yaw]), np.array([pitch]), np.array([roll]),
        width=OUT, height=OUT, hfov_deg=hfov, vfov_deg=hfov,
        projection=proj, interp="bicubic")
    got = _u8(np.asarray(out)[0])
    _assert_parity(got, oracle, valid, pole)


# The geometry classes of the equirect→view warp: a yaw ring, views that
# straddle the ±180° seam, output sizes that are not a multiple of 8,
# pitched views up to and past the poles, roll, a 150° lens, and fisheye
# outputs (v360 equidistant d190 front/back, equisolid).
# (id, projection, width, height, hfov, vfov, yaw, pitch, roll)
GEOMETRY = [
    ("yaw0", "perspective", 64, 64, 104.25, 104.25, 0.0, 0.0, 0.0),
    ("yaw45", "perspective", 64, 64, 104.25, 104.25, 45.0, 0.0, 0.0),
    ("yaw135", "perspective", 64, 64, 104.25, 104.25, 135.0, 0.0, 0.0),
    ("yaw-90", "perspective", 64, 64, 104.25, 104.25, -90.0, 0.0, 0.0),
    ("seam+", "perspective", 64, 48, 100.0, 80.0, 179.5, 0.0, 0.0),
    ("seam-", "perspective", 64, 48, 100.0, 80.0, -179.5, 10.0, 0.0),
    ("size61x37", "perspective", 61, 37, 90.0, 60.0, 20.0, 0.0, 0.0),
    ("size33x71", "perspective", 33, 71, 60.0, 100.0, -60.0, 5.0, 0.0),
    ("pitch30", "perspective", 64, 64, 104.25, 104.25, 45.0, 30.0, 0.0),
    ("pitch60", "perspective", 64, 64, 104.25, 104.25, -20.0, 60.0, 0.0),
    ("pitch75", "perspective", 64, 64, 90.0, 90.0, 10.0, 75.0, 0.0),
    ("pitch85", "perspective", 64, 64, 90.0, 90.0, 0.0, 85.0, 0.0),
    ("pitch89", "perspective", 64, 64, 90.0, 90.0, 33.0, 89.0, 0.0),
    ("pitch90", "perspective", 64, 64, 104.25, 104.25, 0.0, 90.0, 0.0),
    ("pitch-90", "perspective", 64, 64, 104.25, 104.25, 0.0, -90.0, 0.0),
    ("pitch-60", "perspective", 64, 64, 104.25, 104.25, 120.0, -60.0, 0.0),
    ("roll-30", "perspective", 64, 64, 90.0, 90.0, -40.0, 20.0, -30.0),
    ("roll90", "perspective", 64, 48, 90.0, 70.0, 70.0, 0.0, 90.0),
    ("hfov150", "perspective", 72, 72, 150.0, 150.0, 0.0, 0.0, 0.0),
    ("hfov150_tilt", "perspective", 72, 72, 150.0, 150.0, 60.0, 45.0, 0.0),
    ("d190_front", "fisheye_v360", 64, 64, 190.0, 190.0, 0.0, 0.0, 0.0),
    ("d190_back", "fisheye_v360", 64, 64, 190.0, 190.0, 180.0, 0.0, 0.0),
    ("equisolid", "equisolid", 64, 64, 190.0, 190.0, 90.0, 0.0, 0.0),
    ("equisolid_up", "equisolid", 64, 64, 180.0, 180.0, 0.0, 90.0, 0.0),
]


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("case", GEOMETRY, ids=[g[0] for g in GEOMETRY])
def test_warp_geometry_matches_oracle(pano, case, interp):
    _name, proj, w, h, hfov, vfov, yaw, pitch, roll = case
    geom = dict(width=w, height=h, hfov_deg=hfov, vfov_deg=vfov,
                projection=proj)
    oracle, valid = vo.warp_equirect_oracle(pano, yaw, pitch, roll,
                                            interp=interp, **geom)
    out = warp_xla.warp_equirect_to_views(
        np.asarray(pano, np.float32) / 255.0, np.array([yaw]),
        np.array([pitch]), np.array([roll]), interp=interp, **geom)
    assert out.shape == (1, h, w, 3)
    _assert_parity(_u8(np.asarray(out)[0]), oracle, valid, pole_taps=True)


def test_xla_bilinear_matches_oracle(pano):
    oracle, valid = vo.warp_equirect_oracle(
        pano, 25.0, 20.0, 0.0, width=OUT, height=OUT,
        hfov_deg=104.25, vfov_deg=104.25, interp="bilinear")
    out = warp_xla.warp_equirect_to_views(
        np.asarray(pano, np.float32) / 255.0,
        np.array([25.0]), np.array([20.0]), np.array([0.0]),
        width=OUT, height=OUT, hfov_deg=104.25, vfov_deg=104.25,
        interp="bilinear")
    got = _u8(np.asarray(out)[0])
    _assert_parity(got, oracle, valid, pole_taps=False)


def _assert_parity(got_u8, oracle_u8, valid, pole_taps):
    # the warp implements v360's pole reflection per tap, so pole-crossing
    # cases gate at the same tolerance as everything else
    del pole_taps
    diff = np.abs(got_u8.astype(np.int32) - oracle_u8.astype(np.int32))
    dv = diff[valid]
    # only float-vs-Q14 rounding separates the two
    assert int(dv.max()) <= 2, f"max diff {dv.max()} u8 LSB vs oracle"
    assert float((dv > 1).mean()) <= 0.01, \
        f"{(dv > 1).mean():.2%} of samples deviate >1 LSB"
