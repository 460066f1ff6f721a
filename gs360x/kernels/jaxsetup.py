"""Process-wide JAX configuration for the device kernels.

The reference's per-view ffmpeg processes have no compile step; our batched
XLA programs do (seconds for the 8K warp). A persistent compilation cache
makes that a one-time cost per (shape, kernel) across CLI invocations
instead of per process. Importing :mod:`gs360x.kernels` applies this
automatically; set ``GS360X_NO_JAX_CACHE=1`` to opt out.
"""

from __future__ import annotations

import os
import pathlib

# Fixed, git-ignored directory inside the checkout: the cache key includes
# the path, so a directory that moves never hits.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

_configured = False


def cache_dir() -> pathlib.Path:
    """Where compiled programs are kept: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return pathlib.Path(env) if env else DEFAULT_CACHE_DIR


def enable_persistent_cache() -> None:
    """Point JAX's compilation cache at :func:`cache_dir` (idempotent)."""
    global _configured
    if _configured or os.environ.get("GS360X_NO_JAX_CACHE"):
        return
    _configured = True
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
