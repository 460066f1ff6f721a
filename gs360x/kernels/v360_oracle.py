"""Independent scalar-numpy oracle of ffmpeg v360's remap algorithm.

The warp engine (:mod:`gs360x.kernels.warp`) claims v360-convention
sampling. This module is its independent, slow oracle: a from-scratch
port of the v360 filter's documented remap algorithm (FFmpeg
``vf_v360.c``), written in plain numpy with none of the repo's jax
geometry code, so that the warp can be diffed against an independent
implementation.

What it reproduces (the reference delegates all reprojection to this
filter — ``/root/reference/cli_tools/gs360_360PerspCut.py:310-314``
rectilinear, ``:375-379`` fisheye):

* output models ``flat`` (rectilinear) and ``fisheye`` (equidistant),
  pixel centers at ``(2 i + 1)/W - 1``;
* the yaw/pitch/roll rotation (yaw→pitch→roll order, positive yaw pans
  right, positive pitch looks up);
* ``xyz_to_equirect`` input mapping ``u = (atan2(x, z)/pi + 1) W/2 - 0.5``;
* the 4x4 tap neighborhood with v360's boundary semantics: horizontal
  modulo-W wrap, and **pole reflection** — a tap row past the top/bottom
  edge reflects back (``y' = -1-y`` / ``2H-1-y``) with the column shifted
  half a panorama (``x + W/2``), i.e. the sample continues over the pole
  onto the opposite meridian;
* ``interp=cubic``: 4-point Lagrange weights on the fractional offset,
  quantized to Q14 fixed point (``round(wx * wy * 16384)``) like v360's
  int16 kernel tables, accumulated in integers and rounded back to u8
  (``(acc + 8192) >> 14``, clipped). v360's C loop shifts without an
  explicit rounding constant in some builds; the difference is bounded
  by half an LSB and is included in the tolerances the parity report
  quotes.

This is an oracle, not a production path: it runs on host numpy at
whatever speed it runs. ``tools/v360_parity_report.py`` diffs the warp
against it and writes the measured deviations to ``docs/V360_PARITY.md``;
``tests/test_v360_oracle.py`` and ``chip_smoke.py`` gate on it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


# --------------------------------------------------------------------------
# Output models: pixel grid -> unit rays (camera frame; x right, y down,
# z forward — v360's vector layout in xyz_to_equirect)
# --------------------------------------------------------------------------


def _ndc(n: int) -> np.ndarray:
    return (2.0 * np.arange(n, dtype=np.float64) + 1.0) / n - 1.0


def flat_rays(width: int, height: int, hfov_deg: float,
              vfov_deg: float) -> np.ndarray:
    """v360 ``flat_to_xyz``: rectilinear output rays, shape (H, W, 3)."""
    nx = _ndc(width)[None, :] * math.tan(math.radians(hfov_deg) / 2.0)
    ny = _ndc(height)[:, None] * math.tan(math.radians(vfov_deg) / 2.0)
    x = np.broadcast_to(nx, (height, width))
    y = np.broadcast_to(ny, (height, width))
    z = np.ones((height, width))
    vec = np.stack([x, y, z], axis=-1)
    return vec / np.linalg.norm(vec, axis=-1, keepdims=True)


def fisheye_rays(width: int, height: int,
                 dfov_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """v360 ``fisheye_to_xyz``: equidistant fisheye output rays + validity.

    Radius is linear in the angle off the optical axis; the image circle
    (radius 1 in NDC) spans ``d_fov``.
    """
    nx = np.broadcast_to(_ndc(width)[None, :], (height, width))
    ny = np.broadcast_to(_ndc(height)[:, None], (height, width))
    r = np.hypot(nx, ny)
    valid = r <= 1.0
    ang = r * math.radians(dfov_deg) / 2.0        # angle off +z
    phi = np.arctan2(ny, nx)
    s = np.sin(ang)
    vec = np.stack([s * np.cos(phi), s * np.sin(phi), np.cos(ang)], axis=-1)
    return vec, valid


def equisolid_rays(width: int, height: int,
                   dfov_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Equisolid fisheye output rays + validity: the radius follows the
    lens law ``r = 2 f sin(theta / 2)``, with the image circle (radius 1
    in NDC) at ``theta = d_fov / 2``."""
    nx = np.broadcast_to(_ndc(width)[None, :], (height, width))
    ny = np.broadcast_to(_ndc(height)[:, None], (height, width))
    r = np.hypot(nx, ny)
    valid = r <= 1.0
    half = math.radians(dfov_deg) / 2.0
    ang = 2.0 * np.arcsin(np.clip(r * math.sin(half / 2.0), -1.0, 1.0))
    phi = np.arctan2(ny, nx)
    s = np.sin(ang)
    vec = np.stack([s * np.cos(phi), s * np.sin(phi), np.cos(ang)], axis=-1)
    return vec, valid


def rotation_ypr(yaw_deg: float, pitch_deg: float,
                 roll_deg: float) -> np.ndarray:
    """Yaw→pitch→roll camera rotation, v360 sign conventions.

    Positive yaw pans right (rotation about the down axis y), positive
    pitch looks up, positive roll tilts clockwise. Returns the camera→
    world matrix applied to output rays before ``xyz_to_equirect``.
    """
    a = math.radians(yaw_deg)
    b = math.radians(pitch_deg)
    c = math.radians(roll_deg)
    ry = np.array([[math.cos(a), 0.0, math.sin(a)],
                   [0.0, 1.0, 0.0],
                   [-math.sin(a), 0.0, math.cos(a)]])
    rx = np.array([[1.0, 0.0, 0.0],
                   [0.0, math.cos(b), -math.sin(b)],
                   [0.0, math.sin(b), math.cos(b)]])
    rz = np.array([[math.cos(c), -math.sin(c), 0.0],
                   [math.sin(c), math.cos(c), 0.0],
                   [0.0, 0.0, 1.0]])
    return ry @ rx @ rz


# --------------------------------------------------------------------------
# Input mapping + boundary semantics
# --------------------------------------------------------------------------


def xyz_to_equirect(vec: np.ndarray, src_w: int,
                    src_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """v360 ``xyz_to_equirect``: continuous source coords (pixel-center 0)."""
    phi = np.arctan2(vec[..., 0], vec[..., 2])
    theta = np.arcsin(np.clip(vec[..., 1], -1.0, 1.0))
    uf = (phi / math.pi + 1.0) * (src_w / 2.0) - 0.5
    vf = (theta / (math.pi / 2.0) + 1.0) * (src_h / 2.0) - 0.5
    return uf, vf


def reflect_taps(xi: np.ndarray, yi: np.ndarray, src_w: int,
                 src_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """v360 ``ereflectx``/``reflecty`` tap boundary handling.

    A tap row past a pole reflects (``y' = -1-y`` top, ``2H-1-y``
    bottom) and the column jumps half a panorama width — the equirect
    continuation over the pole. Columns then wrap modulo W.
    """
    over_top = yi < 0
    over_bot = yi >= src_h
    y_ref = np.where(over_top, -1 - yi, np.where(over_bot, 2 * src_h - 1 - yi,
                                                 yi))
    # a 4-tap neighborhood can reach at most 2 rows past the edge, so a
    # single reflection suffices; clip defensively all the same
    y_ref = np.clip(y_ref, 0, src_h - 1)
    x_adj = np.where(over_top | over_bot, xi + src_w // 2, xi)
    return np.mod(x_adj, src_w), y_ref


def lagrange_weights_q14(t: np.ndarray) -> np.ndarray:
    """4-point Lagrange weights at offset t, Q14-quantized per tap pair.

    v360 quantizes the *product* ``wx * wy`` to int16 Q14
    (``calculate_kernel``); this returns the 1-D float weights, the
    product quantization happens in :func:`resample_bicubic_q14`.
    """
    tt = t * t
    ttt = tt * t
    return np.stack([
        -t / 3.0 + tt / 2.0 - ttt / 6.0,
        1.0 - t / 2.0 - tt + ttt / 2.0,
        t + tt / 2.0 - ttt / 2.0,
        -t / 6.0 + ttt / 6.0,
    ], axis=0)


# --------------------------------------------------------------------------
# Fixed-point resampling
# --------------------------------------------------------------------------


def resample_bicubic_q14(src_u8: np.ndarray, uf: np.ndarray,
                         vf: np.ndarray) -> np.ndarray:
    """v360 ``interp=cubic`` fixed-point resample of a u8 panorama.

    16 taps per output pixel, int16 Q14 kernel weights, integer
    accumulation, round-and-shift back to u8.
    """
    src_h, src_w = src_u8.shape[:2]
    ui = np.floor(uf).astype(np.int64)
    vi = np.floor(vf).astype(np.int64)
    du = uf - ui
    dv = vf - vi
    wx = lagrange_weights_q14(du)            # (4, ...)
    wy = lagrange_weights_q14(dv)
    acc = np.zeros(uf.shape + (src_u8.shape[-1],), dtype=np.int64)
    src_flat = src_u8.reshape(-1, src_u8.shape[-1]).astype(np.int64)
    for i in range(4):                        # tap rows
        for j in range(4):                    # tap cols
            ker = np.rint(wx[j] * wy[i] * 16384.0).astype(np.int64)
            xi, yi = reflect_taps(ui + j - 1, vi + i - 1, src_w, src_h)
            acc += ker[..., None] * src_flat[yi * src_w + xi]
    out = (acc + 8192) >> 14
    return np.clip(out, 0, 255).astype(np.uint8)


def resample_bilinear_q14(src_u8: np.ndarray, uf: np.ndarray,
                          vf: np.ndarray) -> np.ndarray:
    """v360 ``interp=linear`` fixed-point resample (2x2 taps, Q14)."""
    src_h, src_w = src_u8.shape[:2]
    ui = np.floor(uf).astype(np.int64)
    vi = np.floor(vf).astype(np.int64)
    du = uf - ui
    dv = vf - vi
    wx = np.stack([1.0 - du, du], axis=0)
    wy = np.stack([1.0 - dv, dv], axis=0)
    acc = np.zeros(uf.shape + (src_u8.shape[-1],), dtype=np.int64)
    src_flat = src_u8.reshape(-1, src_u8.shape[-1]).astype(np.int64)
    for i in range(2):
        for j in range(2):
            ker = np.rint(wx[j] * wy[i] * 16384.0).astype(np.int64)
            xi, yi = reflect_taps(ui + j, vi + i, src_w, src_h)
            acc += ker[..., None] * src_flat[yi * src_w + xi]
    out = (acc + 8192) >> 14
    return np.clip(out, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# End-to-end oracle
# --------------------------------------------------------------------------


def _view_rays(width, height, hfov_deg, vfov_deg, projection):
    if projection == "perspective":
        return flat_rays(width, height, hfov_deg, vfov_deg), \
            np.ones((height, width), bool)
    if projection == "fisheye_v360":
        return fisheye_rays(width, height, hfov_deg)
    if projection == "equisolid":
        return equisolid_rays(width, height, hfov_deg)
    raise ValueError(f"oracle: unsupported projection {projection!r}")


def pole_tap_mask(src_h: int, src_w: int, yaw_deg: float, pitch_deg: float,
                  roll_deg: float, *, width: int, height: int,
                  hfov_deg: float, vfov_deg: float,
                  projection: str = "perspective") -> np.ndarray:
    """Bool (height, width) mask of output pixels whose bicubic tap rows
    cross a pole row (tap row < 0 or > H-1). There ``u`` is discontinuous
    and any two float implementations of the trig may legitimately pick
    taps on opposite meridians, so parity gates exempt these pixels."""
    rays, _ = _view_rays(width, height, hfov_deg, vfov_deg, projection)
    rot = rotation_ypr(yaw_deg, pitch_deg, roll_deg)
    _, vf = xyz_to_equirect(rays @ rot.T, src_w, src_h)
    vi = np.floor(vf).astype(np.int64)
    return (vi - 1 < 0) | (vi + 2 > src_h - 1)


def warp_equirect_oracle(src_u8: np.ndarray, yaw_deg: float,
                         pitch_deg: float, roll_deg: float, *,
                         width: int, height: int, hfov_deg: float,
                         vfov_deg: float, projection: str = "perspective",
                         interp: str = "bicubic"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One view cut, computed exactly the way the v360 filter would.

    Args:
      src_u8: (H, W, 3) uint8 equirect panorama.
      projection: 'perspective' (v360 output=rectilinear/flat),
        'fisheye_v360' (output=fisheye, ``hfov_deg`` read as d_fov) or
        'equisolid' (:func:`equisolid_rays`, ``hfov_deg`` read as d_fov).
    Returns: ``(out_u8, valid)`` — (height, width, 3) uint8 and a bool
      validity mask (all-True for perspective).
    """
    rays, valid = _view_rays(width, height, hfov_deg, vfov_deg, projection)
    rot = rotation_ypr(yaw_deg, pitch_deg, roll_deg)
    world = rays @ rot.T
    uf, vf = xyz_to_equirect(world, src_u8.shape[1], src_u8.shape[0])
    if interp == "bicubic":
        out = resample_bicubic_q14(src_u8, uf, vf)
    elif interp == "bilinear":
        out = resample_bilinear_q14(src_u8, uf, vf)
    else:
        raise ValueError(f"oracle: unsupported interp {interp!r}")
    out = np.where(valid[..., None], out, 0).astype(np.uint8)
    return out, valid
