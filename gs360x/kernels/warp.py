"""The fused gather-interp warp engine — the framework's north-star kernel.

One engine serves every resampling job in the toolkit (the reference fans
these out to external native code):

* equirect → perspective / fisheye view cuts
  (ffmpeg ``v360``, ``/root/reference/cli_tools/gs360_360PerspCut.py:310-314,375-379``)
* fisheye → perspective and fisheye undistortion
  (``cv2.remap``, ``/root/reference/cli_tools/gs360_DualFisheyeDistortionCalibration.py:1173-1217,1996-2055``)
* generic coordinate remap for calibration maps.

Design: ``dst pixel grid → unit ray (camera) → rotate → source UV →
N-tap gather interpolation``. Everything before the gather is closed-form
math that XLA fuses into the gather loop; views are batched by vmapping over
(yaw, pitch, roll), so a whole frame's multi-view export is ONE device
program (vs. N ffmpeg processes each re-decoding the video in the
reference — see SURVEY §3.1).

Interpolation matches ffmpeg v360's kernels: ``bilinear``; ``bicubic`` = the
4-point Lagrange weights v360 computes in ``calculate_bicubic_coeffs``;
``nearest`` for masks. Horizontal wrap (longitude seam) uses modulo-W; the
vertical axis clamps.

The sampler is plain ``jnp.take`` gathers that XLA compiles for whatever
device runs it; :mod:`gs360x.kernels.v360_oracle` is its independent
reference.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gs360x.rig.spec import ViewSpec

# --------------------------------------------------------------------------
# Traced rotation helpers (jnp mirrors of core.pose, usable under vmap/jit)
# --------------------------------------------------------------------------


def _rot_x(rad):
    c, s = jnp.cos(rad), jnp.sin(rad)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([o, z, z], -1),
        jnp.stack([z, c, -s], -1),
        jnp.stack([z, s, c], -1),
    ], -2)


def _rot_y(rad):
    c, s = jnp.cos(rad), jnp.sin(rad)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, z, s], -1),
        jnp.stack([z, o, z], -1),
        jnp.stack([-s, z, c], -1),
    ], -2)


def _rot_z(rad):
    c, s = jnp.cos(rad), jnp.sin(rad)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, -s, z], -1),
        jnp.stack([s, c, z], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


def view_rotation(yaw_deg, pitch_deg, roll_deg):
    """Traced camera→world rotation in the warp frame (y down, z forward).

    Same convention as :func:`gs360x.core.pose.view_rotation_cv`: positive
    yaw pans right, positive pitch looks up. Composed at HIGHEST matmul
    precision — a default-precision f32 matmul may run in TF32 on a GPU,
    which costs ~1e-3 in the rotation and visibly (0.5+ px) shifts warp
    coords.
    """
    d = jnp.pi / 180.0
    hi = jax.lax.Precision.HIGHEST
    ryx = jnp.matmul(_rot_y(yaw_deg * d), _rot_x(pitch_deg * d), precision=hi)
    return jnp.matmul(ryx, _rot_z(roll_deg * d), precision=hi)


def rotate_rays(rays: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Apply a 3x3 rotation to a (..., 3) ray field elementwise.

    Written as broadcast FMAs rather than a matmul: a (H*W, 3)x(3, 3)
    contraction is a degenerate matmul shape AND may run at reduced
    precision by default (TF32 on a GPU) — elementwise keeps full f32 and
    fuses into the warp.
    """
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    return jnp.stack([
        r[0, 0] * x + r[0, 1] * y + r[0, 2] * z,
        r[1, 0] * x + r[1, 1] * y + r[1, 2] * z,
        r[2, 0] * x + r[2, 1] * y + r[2, 2] * z,
    ], axis=-1)


# --------------------------------------------------------------------------
# Interpolation weights
# --------------------------------------------------------------------------


def lagrange_cubic_weights(t: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """4-point Lagrange interpolation weights at fractional offset t∈[0,1).

    Exactly ffmpeg v360's ``interp=cubic`` kernel (nodes at -1, 0, 1, 2)."""
    tt = t * t
    ttt = tt * t
    w0 = -t / 3.0 + tt / 2.0 - ttt / 6.0
    w1 = 1.0 - t / 2.0 - tt + ttt / 2.0
    w2 = t + tt / 2.0 - ttt / 2.0
    w3 = -t / 6.0 + ttt / 6.0
    return w0, w1, w2, w3


def catmull_rom_weights(t: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """Catmull-Rom (Keys a=-0.5) cubic weights — OpenCV's INTER_CUBIC uses
    a=-0.75; kept for remap parity experiments."""
    tt = t * t
    ttt = tt * t
    w0 = -0.5 * ttt + tt - 0.5 * t
    w1 = 1.5 * ttt - 2.5 * tt + 1.0
    w2 = -1.5 * ttt + 2.0 * tt + 0.5 * t
    w3 = 0.5 * ttt - 0.5 * tt
    return w0, w1, w2, w3


_CUBIC_KERNELS = {
    "bicubic": lagrange_cubic_weights,
    "catmull-rom": catmull_rom_weights,
}


# --------------------------------------------------------------------------
# Gather-based samplers (XLA backend)
# --------------------------------------------------------------------------


def _flat_gather(src_flat: jnp.ndarray, yi: jnp.ndarray, xi: jnp.ndarray,
                 width: int) -> jnp.ndarray:
    """Gather pixels from a flattened (H*W, C) source by integer coords."""
    idx = yi * width + xi
    return jnp.take(src_flat, idx.reshape(-1), axis=0).reshape(*yi.shape, -1)


def _wrap_x(xi: jnp.ndarray, width: int, wrap: bool) -> jnp.ndarray:
    if wrap:
        return jnp.mod(xi, width)
    return jnp.clip(xi, 0, width - 1)


def _reflect_y(yi: jnp.ndarray, h: int):
    """v360 ``reflecty`` tap-row boundary: a row past a pole reflects
    (``-1-y`` top / ``2h-1-y`` bottom) and the sample continues over the
    pole onto the opposite meridian — the caller shifts the column by
    ``w/2`` wherever ``over`` is set.  Matches
    :func:`gs360x.kernels.v360_oracle.reflect_taps`; the reference's
    warps inherit these semantics from ffmpeg's v360 filter
    (``/root/reference/cli_tools/gs360_360PerspCut.py:310-314``).
    Returns ``(y_reflected, over)``."""
    over_top = yi < 0
    over_bot = yi >= h
    y_ref = jnp.where(over_top, -1 - yi,
                      jnp.where(over_bot, 2 * h - 1 - yi, yi))
    return jnp.clip(y_ref, 0, h - 1), over_top | over_bot


def sample_bilinear(src: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, *,
                    wrap_x: bool = False,
                    pole_reflect: bool = False) -> jnp.ndarray:
    """Bilinear sample of src (H, W, C) at continuous coords (u right, v
    down; pixel centers at integers). Returns (*u.shape, C).

    ``pole_reflect`` (equirect sources): tap rows past the top/bottom
    edge reflect over the pole with a half-width column shift (v360
    semantics) instead of clamping."""
    h, w = src.shape[0], src.shape[1]
    src_flat = src.reshape(h * w, -1)
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0r = y0.astype(jnp.int32)
    if pole_reflect:
        y0i, ov0 = _reflect_y(y0r, h)
        y1i, ov1 = _reflect_y(y0r + 1, h)
        sh0 = jnp.where(ov0, w // 2, 0)
        sh1 = jnp.where(ov1, w // 2, 0)
        p00 = _flat_gather(src_flat, y0i, _wrap_x(x0i + sh0, w, True), w)
        p01 = _flat_gather(src_flat, y0i,
                           _wrap_x(x0i + 1 + sh0, w, True), w)
        p10 = _flat_gather(src_flat, y1i, _wrap_x(x0i + sh1, w, True), w)
        p11 = _flat_gather(src_flat, y1i,
                           _wrap_x(x0i + 1 + sh1, w, True), w)
    else:
        y0i = jnp.clip(y0r, 0, h - 1)
        y1i = jnp.clip(y0i + 1, 0, h - 1)
        xa = _wrap_x(x0i, w, wrap_x)
        xb = _wrap_x(x0i + 1, w, wrap_x)
        p00 = _flat_gather(src_flat, y0i, xa, w)
        p01 = _flat_gather(src_flat, y0i, xb, w)
        p10 = _flat_gather(src_flat, y1i, xa, w)
        p11 = _flat_gather(src_flat, y1i, xb, w)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def sample_nearest(src: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, *,
                   wrap_x: bool = False,
                   pole_reflect: bool = False) -> jnp.ndarray:
    h, w = src.shape[0], src.shape[1]
    src_flat = src.reshape(h * w, -1)
    xr = jnp.round(u).astype(jnp.int32)
    yr = jnp.round(v).astype(jnp.int32)
    if pole_reflect:
        yi, over = _reflect_y(yr, h)
        xi = _wrap_x(xr + jnp.where(over, w // 2, 0), w, True)
    else:
        xi = _wrap_x(xr, w, wrap_x)
        yi = jnp.clip(yr, 0, h - 1)
    return _flat_gather(src_flat, yi, xi, w)


def sample_bicubic(src: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, *,
                   wrap_x: bool = False, kernel: str = "bicubic",
                   pole_reflect: bool = False) -> jnp.ndarray:
    """16-tap separable cubic sample (v360 interp=cubic by default).

    ``pole_reflect``: v360 tap-row boundary semantics (reflect over the
    pole + half-width column shift) instead of row clamping."""
    h, w = src.shape[0], src.shape[1]
    src_flat = src.reshape(h * w, -1)
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    wxs = _CUBIC_KERNELS[kernel](fx)
    wys = _CUBIC_KERNELS[kernel](fy)
    out = None
    for dy in range(4):
        if pole_reflect:
            yi, over = _reflect_y(y0i + (dy - 1), h)
            shift = jnp.where(over, w // 2, 0)
        else:
            yi = jnp.clip(y0i + (dy - 1), 0, h - 1)
            shift = None
        row_acc = None
        for dx in range(4):
            xt = x0i + (dx - 1)
            if shift is not None:
                xi = _wrap_x(xt + shift, w, True)
            else:
                xi = _wrap_x(xt, w, wrap_x)
            tap = _flat_gather(src_flat, yi, xi, w) * wxs[dx][..., None]
            row_acc = tap if row_acc is None else row_acc + tap
        term = row_acc * wys[dy][..., None]
        out = term if out is None else out + term
    return out


_SAMPLERS = {
    "bilinear": sample_bilinear,
    "nearest": sample_nearest,
    "bicubic": functools.partial(sample_bicubic, kernel="bicubic"),
    "catmull-rom": functools.partial(sample_bicubic, kernel="catmull-rom"),
}


def remap(src: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, *,
          interp: str = "bilinear", wrap_x: bool = False,
          pole_reflect: bool = False,
          valid: Optional[jnp.ndarray] = None,
          fill: float = 0.0) -> jnp.ndarray:
    """General remap (the device replacement for ``cv2.remap``): sample src at
    (u, v) with the chosen kernel, filling invalid coords with ``fill``.
    ``pole_reflect`` selects v360's equirect tap boundary (reflect over
    the pole + half-width shift) — only meaningful for equirect
    sources."""
    sampler = _SAMPLERS[interp]
    out = sampler(src, u, v, wrap_x=wrap_x, pole_reflect=pole_reflect)
    if valid is not None:
        out = jnp.where(valid[..., None], out, jnp.asarray(fill, out.dtype))
    return out


# --------------------------------------------------------------------------
# View-cut coordinate maps
# --------------------------------------------------------------------------


def view_uv_from_equirect(width: int, height: int, hfov_deg: float,
                          vfov_deg: float, projection: str,
                          yaw_deg, pitch_deg, roll_deg,
                          src_w: int, src_h: int,
                          dtype=jnp.float32):
    """Source-UV map (and validity) of one view cut from an equirect pano.

    ``yaw/pitch/roll`` may be traced scalars (vmap over views). FOV and
    sizes are static (compiled into the program).
    """
    from gs360x.core import camera as cam

    if projection == "perspective":
        rays = cam.perspective_rays(width, height, hfov_deg, vfov_deg, dtype)
        valid = None
    elif projection in ("fisheye_v360", "equisolid"):
        model = "equidistant" if projection == "fisheye_v360" else "equisolid"
        rays, valid = cam.fisheye_rays(width, height, hfov_deg, model=model, dtype=dtype)
    else:
        raise ValueError(f"unknown projection: {projection!r}")
    r = view_rotation(jnp.asarray(yaw_deg, dtype), jnp.asarray(pitch_deg, dtype),
                      jnp.asarray(roll_deg, dtype))
    world = rotate_rays(rays, r)
    u, v = cam.equirect_uv(world, src_w, src_h)
    return u, v, valid


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "hfov_deg", "vfov_deg", "projection",
                     "interp"))
def _warp_equirect_to_views_xla(src, yaws, pitches, rolls, *,
                                width, height, hfov_deg, vfov_deg,
                                projection, interp):
    src_h, src_w = src.shape[0], src.shape[1]

    def one_view(yaw, pitch, roll):
        u, v, valid = view_uv_from_equirect(
            width, height, hfov_deg, vfov_deg, projection,
            yaw, pitch, roll, src_w, src_h, dtype=jnp.float32)
        return remap(src, u, v, interp=interp, wrap_x=True,
                     pole_reflect=True, valid=valid)

    return jax.vmap(one_view)(yaws, pitches, rolls)


def warp_equirect_to_views(src: jnp.ndarray,
                           yaws, pitches, rolls, *,
                           width: int, height: int,
                           hfov_deg: float, vfov_deg: float,
                           projection: str = "perspective",
                           interp: str = "bicubic") -> jnp.ndarray:
    """Cut V views out of an equirect image in one fused device program.

    Args:
      src: (H, W, C) float source panorama.
      yaws/pitches/rolls: (V,) per-view angles in degrees.
    Returns: (V, height, width, C) float.
    """
    return _warp_equirect_to_views_xla(
        src, jnp.asarray(yaws, jnp.float32), jnp.asarray(pitches, jnp.float32),
        jnp.asarray(rolls, jnp.float32), width=width, height=height,
        hfov_deg=hfov_deg, vfov_deg=vfov_deg, projection=projection,
        interp=interp)


def group_views(views: Sequence[ViewSpec]) -> dict:
    """Group view indices by (projection, width, height, hfov, vfov): the
    static part of a warp program. Each group is one batched device call
    whose per-view angles are ``view_angles`` of its members."""
    groups: dict = {}
    for i, view in enumerate(views):
        key = (view.projection, view.width, view.height,
               round(view.hfov_deg, 6), round(view.vfov_deg, 6))
        groups.setdefault(key, []).append(i)
    return groups


def view_angles(views: Sequence[ViewSpec], idxs):
    """(yaws, pitches, rolls) float32 arrays of ``views[i] for i in idxs``."""
    return tuple(np.array([getattr(views[i], name) for i in idxs], np.float32)
                 for name in ("yaw_deg", "pitch_deg", "roll_deg"))


def warp_plan_views(src: jnp.ndarray, views: Sequence[ViewSpec], *,
                    interp: str = "bicubic"):
    """Warp a frame through a heterogeneous list of ViewSpecs.

    Each :func:`group_views` group is one batched device call; outputs
    come back in the original view order.
    """
    results: list = [None] * len(views)
    for (projection, w, h, hfov, vfov), idxs in group_views(views).items():
        yaws, pitches, rolls = view_angles(views, idxs)
        out = warp_equirect_to_views(
            src, yaws, pitches, rolls, width=w, height=h, hfov_deg=hfov,
            vfov_deg=vfov, projection=projection, interp=interp)
        for j, i in enumerate(idxs):
            results[i] = out[j]
    return results


@functools.partial(
    jax.jit, static_argnames=("size", "hfov_deg", "dfov_deg", "model",
                              "interp"))
def warp_fisheye_to_perspective(src: jnp.ndarray, size: int, hfov_deg: float,
                                dfov_deg: float, *, model: str = "equisolid",
                                interp: str = "bicubic") -> jnp.ndarray:
    """Single-lens fisheye → perspective transform (Video2Frames'
    experimental path; the dual-fisheye tool uses the calibrated variant in
    tools.dualfisheye). Both cameras share the optical axis."""
    from gs360x.core import camera as cam

    vfov = cam.vfov_from_hfov(hfov_deg, size, size)
    rays = cam.perspective_rays(size, size, hfov_deg, vfov)
    u, v, valid = cam.fisheye_uv(rays, src.shape[1], src.shape[0], dfov_deg,
                                 model=model)
    return remap(src, u, v, interp=interp, wrap_x=False, valid=valid)


# --------------------------------------------------------------------------
# Dense reference (for kernel tests): no gathers, direct evaluation
# --------------------------------------------------------------------------


def warp_equirect_dense_reference(src, view: ViewSpec, interp: str = "bilinear"):
    """Slow, obviously-correct reference warp used by kernel tests (numpy
    semantics, per-pixel python-free but unbatched)."""
    u, v, valid = view_uv_from_equirect(
        view.width, view.height, view.hfov_deg, view.vfov_deg,
        view.projection, view.yaw_deg, view.pitch_deg, view.roll_deg,
        src.shape[1], src.shape[0])
    return remap(src, u, v, interp=interp, wrap_x=True,
                 pole_reflect=True, valid=valid)
