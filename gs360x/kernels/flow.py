"""Optical flow kernels: Harris corner detection + pyramidal Lucas–Kanade.

Device replacement for the FrameSelector's motion estimation
(``/root/reference/cli_tools/gs360_FrameSelector.py:1283-1337``):
``cv2.goodFeaturesToTrack`` (Shi–Tomasi corners, quality 0.01, min distance
5, block 7) followed by ``cv2.calcOpticalFlowPyrLK`` (15×15 window, 2 pyramid
levels, ≤10 iterations). The contract consumed downstream is a single scalar:
the mean displacement magnitude of successfully tracked points.

Shape-static design: a fixed budget of N_POINTS corners (padded with
invalid entries) so the whole tracker jits once per frame size.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

N_POINTS = 512           # corner budget (reference asks for up to 1000)
QUALITY_LEVEL = 0.01
MIN_DISTANCE = 5
LK_WIN = 15              # odd window size
LK_LEVELS = 2
LK_ITERS = 10
LK_EPS = 0.03


def _box_blur(img, k):
    """k×k box filter via two 1-D passes (edge padding)."""
    pad = k // 2
    p = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    img = sum(p[i:i + img.shape[0], :] for i in range(k)) / k
    p = jnp.pad(img, ((0, 0), (pad, pad)), mode="edge")
    return sum(p[:, i:i + img.shape[1]] for i in range(k)) / k


def _scharr_grads(img):
    """3×3 Sobel derivatives (cv2 goodFeaturesToTrack uses Sobel)."""
    p = jnp.pad(img, 1, mode="edge")
    h, w = img.shape

    def sl(dy, dx):
        return jax.lax.dynamic_slice(p, (dy, dx), (h, w))

    gx = (sl(0, 2) + 2 * sl(1, 2) + sl(2, 2)
          - sl(0, 0) - 2 * sl(1, 0) - sl(2, 0)) / 8.0
    gy = (sl(2, 0) + 2 * sl(2, 1) + sl(2, 2)
          - sl(0, 0) - 2 * sl(0, 1) - sl(0, 2)) / 8.0
    return gx, gy


def _max_pool_same(x, k):
    pad = k // 2
    p = jnp.pad(x, pad, mode="constant", constant_values=-jnp.inf)
    h, w = x.shape
    out = jnp.full_like(x, -jnp.inf)
    for dy in range(k):
        for dx in range(k):
            out = jnp.maximum(out, jax.lax.dynamic_slice(p, (dy, dx), (h, w)))
    return out


@functools.partial(jax.jit, static_argnames=("n_points",))
def shi_tomasi_corners(gray: jnp.ndarray, n_points: int = N_POINTS
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k Shi–Tomasi corners with min-distance NMS.

    Returns (points (n,2) float32 as (x, y), valid (n,) bool).
    """
    gx, gy = _scharr_grads(gray)
    ixx = _box_blur(gx * gx, 7)
    iyy = _box_blur(gy * gy, 7)
    ixy = _box_blur(gx * gy, 7)
    # min eigenvalue of the structure tensor
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    response = tr / 2.0 - disc
    # NMS within MIN_DISTANCE and quality threshold
    local_max = response >= _max_pool_same(response, 2 * MIN_DISTANCE + 1)
    threshold = QUALITY_LEVEL * jnp.max(response)
    good = local_max & (response >= threshold)
    score = jnp.where(good, response, -jnp.inf).reshape(-1)
    top_val, top_idx = jax.lax.top_k(score, n_points)
    w = gray.shape[1]
    pts = jnp.stack([(top_idx % w).astype(jnp.float32),
                     (top_idx // w).astype(jnp.float32)], axis=-1)
    return pts, jnp.isfinite(top_val)


def _bilinear_patch(img, cx, cy, half):
    """Sample a (2*half+1)² patch around continuous center (cx, cy)."""
    size = 2 * half + 1
    dy = jnp.arange(size, dtype=jnp.float32) - half
    dx = jnp.arange(size, dtype=jnp.float32) - half
    ys = cy + dy[:, None]
    xs = cx + dx[None, :]
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(xs - x0, 0.0, 1.0)
    fy = jnp.clip(ys - y0, 0.0, 1.0)
    flat = img.reshape(-1)

    def tap(yy, xx):
        return jnp.take(flat, (yy * w + xx).reshape(-1), axis=0).reshape(size, size)

    p00 = tap(y0, x0)
    p01 = tap(y0, x0 + 1)
    p10 = tap(y0 + 1, x0)
    p11 = tap(y0 + 1, x0 + 1)
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def _pyr_down(img):
    """2× downscale with a small binomial blur."""
    blurred = _box_blur(img, 3)
    return blurred[::2, ::2]


def _lk_level(prev, curr, pts, guess, half):
    """One pyramid level of iterative LK for all points (vmapped)."""
    gx, gy = _scharr_grads(prev)

    def track_one(pt, g):
        cx, cy = pt[0], pt[1]
        tpl = _bilinear_patch(prev, cx, cy, half)
        a_x = _bilinear_patch(gx, cx, cy, half)
        a_y = _bilinear_patch(gy, cx, cy, half)
        gxx = jnp.sum(a_x * a_x)
        gyy = jnp.sum(a_y * a_y)
        gxy = jnp.sum(a_x * a_y)
        det = gxx * gyy - gxy * gxy
        inv_ok = det > 1e-6

        def body(_, d):
            patch = _bilinear_patch(curr, cx + d[0], cy + d[1], half)
            diff = patch - tpl
            bx = jnp.sum(diff * a_x)
            by = jnp.sum(diff * a_y)
            ddx = -(gyy * bx - gxy * by) / jnp.where(inv_ok, det, 1.0)
            ddy = -(-gxy * bx + gxx * by) / jnp.where(inv_ok, det, 1.0)
            step = jnp.where(inv_ok, jnp.array([ddx, ddy]), jnp.zeros(2))
            return d + step

        d = jax.lax.fori_loop(0, LK_ITERS, body, g)
        return d, inv_ok

    return jax.vmap(track_one)(pts, guess)


@functools.partial(jax.jit, static_argnames=("n_points",))
def lk_track(prev: jnp.ndarray, curr: jnp.ndarray, pts: jnp.ndarray,
             n_points: int = N_POINTS):
    """Pyramidal LK displacement for each point. Returns (disp (n,2), ok)."""
    pyr_prev = [prev]
    pyr_curr = [curr]
    for _ in range(LK_LEVELS):
        pyr_prev.append(_pyr_down(pyr_prev[-1]))
        pyr_curr.append(_pyr_down(pyr_curr[-1]))

    half = LK_WIN // 2
    disp = jnp.zeros((pts.shape[0], 2), jnp.float32)
    ok = jnp.ones(pts.shape[0], bool)
    for level in range(LK_LEVELS, -1, -1):
        scale = 2.0 ** level
        d, lvl_ok = _lk_level(pyr_prev[level], pyr_curr[level],
                              pts / scale, disp / scale, half)
        disp = d * scale
        ok = ok & lvl_ok
    h, w = prev.shape
    end = pts + disp
    inside = ((end[:, 0] >= 0) & (end[:, 0] <= w - 1)
              & (end[:, 1] >= 0) & (end[:, 1] <= h - 1))
    return disp, ok & inside


FARNEBACK_WINSIZE = 15       # reference cv2 params
FARNEBACK_ITERS = 3          # (gs360_FrameSelector.py:1326)
FARNEBACK_POLY_N = 5
FARNEBACK_POLY_SIGMA = 1.1


def _corr1d(img, kernel, axis, pad):
    """'same' cross-correlation along one axis with edge-clamp padding."""
    padw = [(0, 0), (0, 0)]
    padw[axis] = (pad, pad)
    imp = jnp.pad(img, padw, mode="edge")
    k = kernel[::-1]  # correlation via convolution kernel flip
    if axis == 0:
        out = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"),
                       in_axes=1, out_axes=1)(imp)
    else:
        out = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(imp)
    return out


def _poly_expansion(img, n: int, sigma: float):
    """Farneback polynomial expansion: per-pixel quadratic fit
    f(x) ~ c + b^T x + x^T A x over a Gaussian applicability window.

    Separable weighted moments + a precomputed normal-matrix inverse.
    Returns (b (H,W,2), A (H,W,2,2))."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    w = np.exp(-x * x / (2.0 * sigma * sigma))
    s0, s2, s4 = (w.sum(), (w * x * x).sum(), (w * x ** 4).sum())
    # normal matrix over basis [1, x, y, x^2, y^2, xy]
    G = np.zeros((6, 6))
    G[0, 0] = s0 * s0
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = s2 * s0
    G[1, 1] = G[2, 2] = s2 * s0
    G[3, 3] = G[4, 4] = s4 * s0
    G[3, 4] = G[4, 3] = s2 * s2
    G[5, 5] = s2 * s2
    Ginv = jnp.asarray(np.linalg.inv(G), jnp.float32)

    k0 = jnp.asarray(w, jnp.float32)
    k1 = jnp.asarray(w * x, jnp.float32)
    k2 = jnp.asarray(w * x * x, jnp.float32)

    # my = order along rows (y), mx = order along cols (x)
    t0 = _corr1d(img, k0, 0, n)
    t1 = _corr1d(img, k1, 0, n)
    t2 = _corr1d(img, k2, 0, n)
    m00 = _corr1d(t0, k0, 1, n)
    m10 = _corr1d(t0, k1, 1, n)   # x moment
    m01 = _corr1d(t1, k0, 1, n)   # y moment
    m20 = _corr1d(t0, k2, 1, n)
    m02 = _corr1d(t2, k0, 1, n)
    m11 = _corr1d(t1, k1, 1, n)
    m = jnp.stack([m00, m10, m01, m20, m02, m11], axis=-1)
    coef = jnp.einsum("ij,hwj->hwi", Ginv, m)
    b = coef[..., 1:3]
    A = jnp.stack([
        jnp.stack([coef[..., 3], 0.5 * coef[..., 5]], -1),
        jnp.stack([0.5 * coef[..., 5], coef[..., 4]], -1)], -2)
    return b, A


def _bilinear_field(field, xq, yq):
    """Sample (H,W,...) fields at float coords with edge clamping."""
    h, w = field.shape[:2]
    x0 = jnp.clip(jnp.floor(xq).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(yq).astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    fx = jnp.clip(xq - x0, 0.0, 1.0)
    fy = jnp.clip(yq - y0, 0.0, 1.0)
    while fx.ndim < field.ndim:
        fx = fx[..., None]
        fy = fy[..., None]
    return ((1 - fy) * ((1 - fx) * field[y0, x0] + fx * field[y0, x1])
            + fy * ((1 - fx) * field[y1, x0] + fx * field[y1, x1]))


def _box_blur_same(img, k):
    kern = jnp.ones(k, jnp.float32) / k
    return _corr1d(_corr1d(img, kern, 0, k // 2), kern, 1, k // 2)


@functools.partial(jax.jit, static_argnames=("winsize", "iterations",
                                             "poly_n"))
def farneback_flow(prev: jnp.ndarray, curr: jnp.ndarray, *,
                   winsize: int = FARNEBACK_WINSIZE,
                   iterations: int = FARNEBACK_ITERS,
                   poly_n: int = FARNEBACK_POLY_N,
                   poly_sigma: float = FARNEBACK_POLY_SIGMA) -> jnp.ndarray:
    """Dense Farneback optical flow (single level), the reference's
    FLOW_METHOD='farneback' option (gs360_FrameSelector.py:1324-1337,
    cv2.calcOpticalFlowFarneback(..., 0.5, 1, 15, 3, 5, 1.1, 0)).

    Polynomial expansion is separable Gaussian-weighted moment filtering
    (convolutions); each iteration re-samples the second
    frame's expansion at the current flow and solves the windowed 2x2
    normal equations. Returns (H, W, 2) [dx, dy] in pixels.
    """
    b1, A1 = _poly_expansion(prev, poly_n, poly_sigma)
    b2, A2 = _poly_expansion(curr, poly_n, poly_sigma)
    h, w = prev.shape
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")

    def step(_, flow):
        xq = xx + flow[..., 0]
        yq = yy + flow[..., 1]
        b2w = _bilinear_field(b2, xq, yq)
        A2w = _bilinear_field(A2, xq, yq)
        A = 0.5 * (A1 + A2w)
        db = -0.5 * (b2w - b1) + jnp.einsum("hwij,hwj->hwi", A, flow)
        g11 = A[..., 0, 0] ** 2 + A[..., 1, 0] ** 2
        g12 = (A[..., 0, 0] * A[..., 0, 1]
               + A[..., 1, 0] * A[..., 1, 1])
        g22 = A[..., 0, 1] ** 2 + A[..., 1, 1] ** 2
        h1 = A[..., 0, 0] * db[..., 0] + A[..., 1, 0] * db[..., 1]
        h2 = A[..., 0, 1] * db[..., 0] + A[..., 1, 1] * db[..., 1]
        g11 = _box_blur_same(g11, winsize)
        g12 = _box_blur_same(g12, winsize)
        g22 = _box_blur_same(g22, winsize)
        h1 = _box_blur_same(h1, winsize)
        h2 = _box_blur_same(h2, winsize)
        det = g11 * g22 - g12 * g12
        safe = jnp.where(jnp.abs(det) > 1e-9, det, 1.0)
        fx_new = (g22 * h1 - g12 * h2) / safe
        fy_new = (g11 * h2 - g12 * h1) / safe
        ok = jnp.abs(det) > 1e-9
        return jnp.stack([jnp.where(ok, fx_new, flow[..., 0]),
                          jnp.where(ok, fy_new, flow[..., 1])], -1)

    flow0 = jnp.zeros((h, w, 2), jnp.float32)
    return jax.lax.fori_loop(0, iterations, step, flow0)


def mean_flow_magnitude_farneback(prev_gray: jnp.ndarray,
                                  curr_gray: jnp.ndarray) -> float:
    """Mean dense-flow magnitude (the Farneback branch of the reference's
    _compute_pair_flow_magnitude, gs360_FrameSelector.py:1324-1337)."""
    flow = farneback_flow(jnp.asarray(prev_gray, jnp.float32),
                          jnp.asarray(curr_gray, jnp.float32))
    mag = jnp.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    out = float(jnp.mean(mag))
    return out if math.isfinite(out) else float("nan")


def mean_flow_magnitude(prev_gray: jnp.ndarray, curr_gray: jnp.ndarray
                        ) -> float:
    """Mean |displacement| of tracked corners — the FrameSelector motion
    scalar. Returns NaN when nothing tracks (caller substitutes the
    missing-high sentinel)."""
    pts, valid = shi_tomasi_corners(prev_gray)
    disp, ok = lk_track(prev_gray, curr_gray, pts)
    use = valid & ok
    mag = jnp.linalg.norm(disp, axis=-1)
    denom = jnp.sum(use)
    mean = jnp.sum(jnp.where(use, mag, 0.0)) / jnp.maximum(denom, 1)
    return float(jnp.where(denom > 0, mean, jnp.nan))
