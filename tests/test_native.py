"""Native C++ library tests: build, bindings, numpy parity."""

import numpy as np
import pytest

from gs360x import native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.HAS_NATIVE:
        pytest.skip("native library not built (no toolchain)")


class TestYuv:
    def test_yuv444_matches_numpy(self):
        from gs360x.io.video import rgb_to_yuv601, yuv601_to_rgb

        rng = np.random.default_rng(3)
        rgb = rng.integers(0, 256, (48, 64, 3), np.uint8)
        yuv = rgb_to_yuv601(rgb)
        planes = np.ascontiguousarray(np.moveaxis(yuv, -1, 0))
        nat = native.yuv444_to_rgb(planes)
        ref = yuv601_to_rgb(yuv)
        assert np.abs(nat.astype(int) - ref.astype(int)).max() <= 1

    def test_y4m_reader_uses_native(self, tmp_path):
        from gs360x.io import video as vio

        rng = np.random.default_rng(4)
        frames = [rng.integers(0, 256, (32, 64, 3), np.uint8)
                  for _ in range(3)]
        p = tmp_path / "v.y4m"
        vio.write_y4m(p, frames, fps=3.0)
        out = list(vio.Y4MReader(p).frames())
        assert len(out) == 3
        assert np.abs(out[0].astype(int) - frames[0].astype(int)).max() <= 3


class TestAviScan:
    def test_scan_matches_python(self, tmp_path):
        from gs360x.io import video as vio

        rng = np.random.default_rng(5)
        frames = [rng.integers(0, 256, (32, 48, 3), np.uint8)
                  for _ in range(5)]
        p = tmp_path / "v.avi"
        vio.write_mjpeg_avi(p, frames, fps=12.5)
        offs, sizes, info = native.avi_scan(p.read_bytes())
        assert len(offs) == 5
        assert info["width"] == 48 and info["height"] == 32
        assert info["fps"] == pytest.approx(12.5)
        # reader (which prefers native scan) decodes identical frames
        out = list(vio.MJPEGAVIReader(p).frames())
        assert len(out) == 5

    def test_rejects_non_avi(self):
        with pytest.raises(ValueError):
            native.avi_scan(b"RIFFxxxxWAVE" + b"\x00" * 100)
