"""Checks that need a GPU. They skip elsewhere; on a GPU host run
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py``."""

import numpy as np
import pytest

from gs360x.kernels import v360_oracle as vo
from gs360x.kernels import warp

pytestmark = pytest.mark.gpu

SRC_H, SRC_W = 1024, 2048

# (projection, size, hfov, yaw, pitch, roll)
GEOMETRY = [
    ("perspective", 512, 104.25, 37.0, 0.0, 0.0),
    ("perspective", 512, 104.25, 180.0, 30.0, 0.0),
    ("perspective", 384, 110.0, 20.0, 60.0, 15.0),
    ("perspective", 384, 104.25, 0.0, 90.0, 0.0),
    ("fisheye_v360", 448, 190.0, 180.0, 0.0, 0.0),
    ("equisolid", 448, 190.0, 90.0, 0.0, 0.0),
]


def _pano():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:SRC_H, 0:SRC_W]
    img = np.stack([(xx * 255.0 / SRC_W) % 256.0,
                    (yy * 255.0 / SRC_H + 20 * np.sin(xx * 0.01)) % 256.0,
                    ((xx // 32 + yy // 32) % 2) * 160.0 + 40.0], -1)
    img += rng.normal(0.0, 12.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _warp_u8(pano, device, case, interp="bicubic"):
    import jax

    proj, size, hfov, yaw, pitch, roll = case
    with jax.default_device(device):
        out = warp.warp_equirect_to_views(
            jax.device_put(pano.astype(np.float32) / 255.0, device),
            [yaw], [pitch], [roll], width=size, height=size, hfov_deg=hfov,
            vfov_deg=hfov, projection=proj, interp=interp)
    return np.clip(np.rint(np.asarray(out[0]) * 255.0), 0, 255).astype(int)


@pytest.mark.parametrize("case", GEOMETRY)
def test_warp_on_gpu_matches_oracle(gpu_device, case):
    proj, size, hfov, yaw, pitch, roll = case
    pano = _pano()
    geom = dict(width=size, height=size, hfov_deg=hfov, vfov_deg=hfov,
                projection=proj)
    want, valid = vo.warp_equirect_oracle(pano, yaw, pitch, roll, **geom)
    pole = vo.pole_tap_mask(SRC_H, SRC_W, yaw, pitch, roll, **geom)
    diff = np.abs(_warp_u8(pano, gpu_device, case) - want)
    assert diff[valid & ~pole].max() <= 1


@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "nearest"])
def test_warp_gpu_matches_cpu(gpu_device, interp):
    import jax

    pano = _pano()
    case = GEOMETRY[2]
    gpu = _warp_u8(pano, gpu_device, case, interp)
    cpu = _warp_u8(pano, jax.devices("cpu")[0], case, interp)
    diff = np.abs(gpu - cpu).max(axis=-1)
    if interp == "nearest":
        # nearest is discontinuous in the coordinate: where the two
        # devices' trig differs in the last bits at a rounding boundary,
        # the neighbouring source pixel is picked
        assert (diff > 0).mean() < 0.01
    else:
        assert diff.max() <= 1


def test_sharded_over_every_gpu(gpu_device):
    import jax

    from gs360x.runtime import mesh as meshlib

    devs = meshlib.pipeline_devices()
    assert devs == jax.devices("gpu")
    frames = np.stack([np.roll(_pano(), 64 * i, axis=1)
                       for i in range(len(devs) + 1)])          # uneven
    kw = dict(width=256, height=256, hfov_deg=90.0, vfov_deg=90.0,
              interp="bicubic", quantize_bits=8)
    angles = (np.array([0.0, 120.0], np.float32),
              np.array([10.0, -30.0], np.float32), np.zeros(2, np.float32))
    out = meshlib.warp_frames_sharded(meshlib.data_mesh(devs), frames,
                                      *angles, **kw)
    ref = meshlib.warp_frames_sharded(meshlib.data_mesh(devs[:1]), frames,
                                      *angles, **kw)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
