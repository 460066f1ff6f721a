"""Color science: transfer curves, matrix conversions, 3D LUTs.

jax.numpy throughout so every transform fuses into the device warp program
(the reference runs these inside ffmpeg's ``colorspace`` filter or as host
numpy — ``/root/reference/cli_tools/gs360_Video2Frames.py:464-501`` and
``/root/reference/cli_tools/gs360_DualFisheyeDistortionCalibration.py:494-681``).

Transfer-curve constants match the reference exactly
(``gs360_DualFisheyeDistortionCalibration.py:568-597``): Rec.709 OETF with
the 0.081 / 4.5 / 1.099 / 0.45 spec values and the standard sRGB pair.

The ``.cube`` LUT loader is host-side (tiny text files); the trilinear apply
is a device op.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# --------------------------------------------------------------------------
# Transfer curves (electro-optical), all on [0, 1] float
# --------------------------------------------------------------------------


def rec709_to_linear(v: jnp.ndarray) -> jnp.ndarray:
    v = jnp.clip(v, 0.0, 1.0)
    return jnp.where(v < 0.081, v / 4.5, ((v + 0.099) / 1.099) ** (1.0 / 0.45))


def linear_to_rec709(v: jnp.ndarray) -> jnp.ndarray:
    v = jnp.clip(v, 0.0, 1.0)
    return jnp.where(v < 0.018, v * 4.5, 1.099 * v ** 0.45 - 0.099)


def srgb_to_linear(v: jnp.ndarray) -> jnp.ndarray:
    v = jnp.clip(v, 0.0, 1.0)
    return jnp.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(v: jnp.ndarray) -> jnp.ndarray:
    v = jnp.clip(v, 0.0, 1.0)
    return jnp.clip(jnp.where(v <= 0.0031308, 12.92 * v,
                              1.055 * v ** (1.0 / 2.4) - 0.055), 0.0, 1.0)


def rec709_to_srgb(v: jnp.ndarray) -> jnp.ndarray:
    """The default video color move of the reference pipeline."""
    return linear_to_srgb(rec709_to_linear(v))


# D-Log M (DJI log curve). Published DJI constants; used when a user supplies
# no .cube LUT but asks for a log decode.
_DLOG_A, _DLOG_B, _DLOG_C, _DLOG_D = 0.9892, 0.0108, 0.256663, 0.584555


def dlog_m_to_linear(v: jnp.ndarray) -> jnp.ndarray:
    v = jnp.clip(v, 0.0, 1.0)
    lin = (10.0 ** ((v - _DLOG_D) / _DLOG_C) - _DLOG_B) / _DLOG_A
    low = v * 0.9 / 14.0  # linear toe below cut
    return jnp.where(v <= 0.14, low, jnp.clip(lin, 0.0, None))


# --------------------------------------------------------------------------
# Matrix moves: RGB <-> YCbCr and primaries conversion
# --------------------------------------------------------------------------

# Luma coefficients
_BT709 = (0.2126, 0.7152, 0.0722)
_BT601 = (0.299, 0.587, 0.114)


def _rgb_to_ycbcr_mat(coef: Tuple[float, float, float]) -> np.ndarray:
    kr, kg, kb = coef
    return np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ])


RGB_TO_YCBCR_BT709 = _rgb_to_ycbcr_mat(_BT709)
RGB_TO_YCBCR_BT601 = _rgb_to_ycbcr_mat(_BT601)
YCBCR_TO_RGB_BT709 = np.linalg.inv(RGB_TO_YCBCR_BT709)
YCBCR_TO_RGB_BT601 = np.linalg.inv(RGB_TO_YCBCR_BT601)


def luma_bt601(rgb: jnp.ndarray) -> jnp.ndarray:
    """Y of full-range BT.601 — what ffmpeg ``signalstats`` YAVG averages."""
    kr, kg, kb = _BT601
    return kr * rgb[..., 0] + kg * rgb[..., 1] + kb * rgb[..., 2]


def luma_bt709(rgb: jnp.ndarray) -> jnp.ndarray:
    kr, kg, kb = _BT709
    return kr * rgb[..., 0] + kg * rgb[..., 1] + kb * rgb[..., 2]


# Primaries: linear-RGB conversion BT.709 -> SMPTE-170M via XYZ (D65).
# Computed once from chromaticities (values are the standard matrices).
_BT709_TO_XYZ = np.array([
    [0.4123908, 0.3575843, 0.1804808],
    [0.2126390, 0.7151687, 0.0721923],
    [0.0193308, 0.1191948, 0.9505322],
])
_SMPTE170M_TO_XYZ = np.array([
    [0.3935209, 0.3652581, 0.1916769],
    [0.2123764, 0.7010599, 0.0865638],
    [0.0187391, 0.1119339, 0.9583847],
])
BT709_TO_SMPTE170M = np.linalg.inv(_SMPTE170M_TO_XYZ) @ _BT709_TO_XYZ
SMPTE170M_TO_BT709 = np.linalg.inv(BT709_TO_SMPTE170M)


def apply_rgb_matrix(rgb: jnp.ndarray, mat: np.ndarray) -> jnp.ndarray:
    # HIGHEST: a GPU runs a default-precision f32 contraction in TF32,
    # whose ~1e-3 relative error can move an 8-bit output by one level
    return jnp.einsum("...c,dc->...d", rgb, jnp.asarray(mat, dtype=rgb.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def video_color_move(rgb: jnp.ndarray, *, keep_rec709: bool = False) -> jnp.ndarray:
    """The reference's video color chain, as one fused device op.

    ffmpeg equivalent: ``colorspace=iall=bt709:all=smpte170m`` plus
    ``:trc=iec61966-2-1`` unless ``keep_rec709``
    (``gs360_Video2Frames.py:464-501``): linearize Rec.709, convert
    primaries BT.709→SMPTE-170M, re-encode with sRGB (default) or the same
    Rec.709 curve.
    """
    lin = rec709_to_linear(rgb)
    lin = jnp.clip(apply_rgb_matrix(lin, BT709_TO_SMPTE170M), 0.0, 1.0)
    return linear_to_rec709(lin) if keep_rec709 else linear_to_srgb(lin)


# --------------------------------------------------------------------------
# 3D LUT (.cube)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class CubeLUT:
    """A 3D color LUT. ``table[r, g, b] -> rgb`` with r the fastest axis in
    the .cube file (so the file order fills ``table[b_idx][g_idx][r_idx]``
    reversed — we store it indexed ``[r, g, b]`` for the device op)."""

    size: int
    table: np.ndarray          # (N, N, N, 3) float32, indexed [r, g, b]
    domain_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    domain_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)


def load_cube_lut(path: str | pathlib.Path) -> CubeLUT:
    """Parse a .cube file (Adobe/Resolve format, LUT_3D_SIZE + rows).

    Same contract as ``gs360_DualFisheyeDistortionCalibration.py:494-565``:
    rows are ``r g b`` floats with the **red index varying fastest**.
    """
    size = None
    domain_min = (0.0, 0.0, 0.0)
    domain_max = (1.0, 1.0, 1.0)
    rows = []
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "TITLE":
            continue
        if key == "LUT_3D_SIZE":
            size = int(parts[1])
            continue
        if key == "DOMAIN_MIN":
            domain_min = tuple(float(x) for x in parts[1:4])
            continue
        if key == "DOMAIN_MAX":
            domain_max = tuple(float(x) for x in parts[1:4])
            continue
        if key == "LUT_1D_SIZE":
            raise ValueError("1D LUTs are not supported; expected LUT_3D_SIZE")
        try:
            rows.append([float(parts[0]), float(parts[1]), float(parts[2])])
        except (ValueError, IndexError):
            continue
    if size is None:
        raise ValueError(f"{path}: missing LUT_3D_SIZE")
    if len(rows) != size ** 3:
        raise ValueError(f"{path}: expected {size ** 3} rows, got {len(rows)}")
    # file order: r fastest, then g, then b -> reshape (b, g, r, 3), transpose
    table = np.asarray(rows, dtype=np.float32).reshape(size, size, size, 3)
    table = np.transpose(table, (2, 1, 0, 3)).copy()
    return CubeLUT(size=size, table=table, domain_min=domain_min, domain_max=domain_max)


def apply_cube_lut(rgb: jnp.ndarray, lut: CubeLUT) -> jnp.ndarray:
    """Trilinear 3D-LUT application as a jittable device op.

    ``rgb``: float array (..., 3) in [0,1]. Matches the reference's host
    trilinear interpolation (``gs360_DualFisheyeDistortionCalibration.py:604-681``).
    """
    n = lut.size
    dmin = jnp.asarray(lut.domain_min, dtype=rgb.dtype)
    dmax = jnp.asarray(lut.domain_max, dtype=rgb.dtype)
    t = jnp.clip((rgb - dmin) / (dmax - dmin), 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
    f = t - i0
    i1 = i0 + 1
    table = jnp.asarray(lut.table)

    def tap(ir, ig, ib):
        return table[ir, ig, ib]

    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    r1, g1, b1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fr = f[..., 0:1]
    fg = f[..., 1:2]
    fb = f[..., 2:3]
    c000, c100 = tap(r0, g0, b0), tap(r1, g0, b0)
    c010, c110 = tap(r0, g1, b0), tap(r1, g1, b0)
    c001, c101 = tap(r0, g0, b1), tap(r1, g0, b1)
    c011, c111 = tap(r0, g1, b1), tap(r1, g1, b1)
    c00 = c000 * (1 - fr) + c100 * fr
    c10 = c010 * (1 - fr) + c110 * fr
    c01 = c001 * (1 - fr) + c101 * fr
    c11 = c011 * (1 - fr) + c111 * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    return c0 * (1 - fb) + c1 * fb
