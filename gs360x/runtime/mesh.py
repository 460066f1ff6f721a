"""Device-mesh data parallelism for the warp pipeline.

The reference's only scale axis is (frames × views) fan-out over ffmpeg
processes (SURVEY §2.5); the device equivalent is pure data parallelism
over a 1-D ``jax.sharding.Mesh``: frames are sharded across cards, each card
warps all views of its frames, and collectives are only needed for metrics
reductions (``psum``). The cards of one host are joined all to all, so the
mesh follows the algorithm alone.

:func:`pipeline_devices` is the one place that decides which devices the
pipeline runs on.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def pipeline_devices() -> list:
    """Devices the pipeline runs on, chosen from the default platform.

    A GPU host gets every card. The CPU gets one device: XLA's CPU SPMD
    partitioner compiles this program pathologically slowly on a multi-device
    host mesh, and the sharding logic itself is tested on virtual CPU
    meshes through :func:`data_mesh` directly. Any other platform is an error,
    not a default.
    """
    devs = jax.devices()
    platform = devs[0].platform
    if platform == "gpu":
        return list(devs)
    if platform == "cpu":
        return list(devs[:1])
    raise RuntimeError(f"unsupported JAX platform {platform!r}")


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devs = np.array(devices if devices is not None else jax.devices())
    return Mesh(devs, (DATA_AXIS,))


def shard_frames(mesh: Mesh, frames: jnp.ndarray) -> jnp.ndarray:
    """Place a (B, H, W, C) frame batch with B sharded across the mesh."""
    return jax.device_put(
        frames, NamedSharding(mesh, P(DATA_AXIS, None, None, None)))


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "hfov_deg", "vfov_deg", "interp",
                     "projection", "keep_rec709", "quantize_bits"))
def _warp_batch(frames, yaws, pitches, rolls, *, width, height, hfov_deg,
                vfov_deg, interp, projection="perspective",
                keep_rec709=None, quantize_bits=None):
    from gs360x.core import color as colorlib
    from gs360x.kernels import warp as warplib

    def per_frame(frame):
        if frame.dtype == jnp.uint8:
            frame = frame.astype(jnp.float32) / 255.0
        elif frame.dtype == jnp.uint16:
            frame = frame.astype(jnp.float32) / 65535.0
        out = warplib._warp_equirect_to_views_xla(
            frame, yaws, pitches, rolls, width=width, height=height,
            hfov_deg=hfov_deg, vfov_deg=vfov_deg,
            projection=projection, interp=interp)
        if keep_rec709 is not None:
            out = colorlib.video_color_move(out, keep_rec709=keep_rec709)
        if quantize_bits is not None:
            scale = 65535.0 if quantize_bits > 8 else 255.0
            dt = jnp.uint16 if quantize_bits > 8 else jnp.uint8
            out = jnp.rint(jnp.clip(out, 0.0, 1.0) * scale).astype(dt)
        return out

    return jax.vmap(per_frame)(frames)


def warp_frames_sharded(mesh: Mesh, frames: jnp.ndarray, yaws, pitches,
                        rolls, *, width: int, height: int, hfov_deg: float,
                        vfov_deg: float, interp: str = "bicubic",
                        projection: str = "perspective",
                        keep_rec709=None, quantize_bits=None):
    """Warp a frame batch data-parallel over the mesh.

    ``frames``: (B, H, W, C), uint8/uint16 batches normalize on device
    (4x less host→device traffic than float). A batch that does not divide
    by the mesh size (a video's tail) is padded with copies of its last
    frame and the padding is dropped from the result. Output is
    (B, V, height, width, C), sharded the same way — each card's outputs
    stay local until the host drains them (no cross-card pixel traffic).
    The optional color move and uint8/uint16 quantization fuse into the
    same program (see gs360x.runtime.executor for why).
    """
    batch = int(frames.shape[0])
    pad = (-batch) % mesh.devices.size
    if pad:
        xp = np if isinstance(frames, np.ndarray) else jnp
        frames = xp.concatenate([frames, xp.repeat(frames[-1:], pad, axis=0)])
    frames = shard_frames(mesh, frames)
    yaws = jnp.asarray(yaws, jnp.float32)
    pitches = jnp.asarray(pitches, jnp.float32)
    rolls = jnp.asarray(rolls, jnp.float32)
    # jit follows the batch's sharding: each card warps its own frames
    out = _warp_batch(frames, yaws, pitches, rolls, width=width,
                      height=height, hfov_deg=hfov_deg, vfov_deg=vfov_deg,
                      interp=interp, projection=projection,
                      keep_rec709=keep_rec709, quantize_bits=quantize_bits)
    return out[:batch] if pad else out


def sharded_batch_stats(mesh: Mesh, frames: jnp.ndarray):
    """Example metrics reduction across the mesh (mean luma + sharpness sum)
    using jit's automatic collectives."""
    from gs360x.kernels import sharpness as sharp

    @jax.jit
    def stats(batch):
        gray = (0.299 * batch[..., 0] + 0.587 * batch[..., 1]
                + 0.114 * batch[..., 2])
        lum = jnp.mean(gray)
        ten = jnp.mean(jax.vmap(sharp.tenengrad)(gray * 255.0))
        return lum, ten

    return stats(shard_frames(mesh, frames))
