"""Pure math core: camera models, pose algebra, color science.

Everything in here is side-effect free. Scalar/plan-level algebra is plain
Python/numpy (it runs on at most thousands of cameras); per-pixel math is
jax.numpy and shape-static so it can live inside jit.
"""

from gs360x.core import camera, pose, color  # noqa: F401
