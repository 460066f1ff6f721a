"""Test env: JAX on the CPU with 8 virtual devices, so the multi-card
sharding logic runs without a GPU.

Tests marked ``gpu`` need a card: they skip on the CPU and run on a GPU
host with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (the `gpu_device` fixture "
        "decides at run time)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU: run with JAX_PLATFORMS=cuda,cpu on a GPU host")
    return devs[0]
