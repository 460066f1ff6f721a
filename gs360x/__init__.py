"""gs360x — GPU-accelerated 360° camera → photogrammetry / 3DGS dataset toolkit.

A JAX/XLA framework with the capabilities of the
``360Cam-PGM-3DGS-Tools`` reference toolkit: equirectangular / dual-fisheye
video in, perspective photogrammetry datasets + optimized point clouds out.

Layering (bottom-up):

- :mod:`gs360x.core`    — pure camera/pose/color math (host numpy + device jnp)
- :mod:`gs360x.kernels` — XLA device kernels (warp, sharpness, flow,
  morphology, voxel)
- :mod:`gs360x.rig`     — view-rig presets and the addcam/delcam/setcam grammar
- :mod:`gs360x.io`      — image/video/pointcloud IO and the camera-format hub
- :mod:`gs360x.runtime` — device-mesh scheduling, streaming pipelines,
  manifest-based resume
- :mod:`gs360x.models`  — Flax segmentation network for subject masking
- :mod:`gs360x.tools`   — CLI entry points, flag-compatible with the reference

Unlike the reference (which fans out per-view ffmpeg processes), the hot path
here decodes each frame once and warps all views in one batched device
program; scaling beyond one chip is plain data parallelism over a
``jax.sharding.Mesh`` (frames × views are embarrassingly parallel).
"""

__version__ = "0.1.0"
