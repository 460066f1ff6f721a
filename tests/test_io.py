"""IO round-trip tests: PLY codec, image read/write, video codecs."""

import numpy as np
import pytest

from gs360x.io import image as im
from gs360x.io import ply
from gs360x.io import video as vio


def random_cloud(n=100, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
    return xyz, rgb


class TestPly:
    def test_binary_round_trip(self, tmp_path):
        xyz, rgb = random_cloud()
        p = tmp_path / "c.ply"
        ply.save_ply_xyz_rgb(p, xyz, rgb)
        xyz2, rgb2 = ply.load_ply_xyz_rgb(p)
        np.testing.assert_array_equal(xyz2, xyz)
        np.testing.assert_array_equal(rgb2, rgb)

    def test_ascii_round_trip(self, tmp_path):
        xyz, rgb = random_cloud(50)
        p = tmp_path / "c.ply"
        ply.write_ply(p, {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                          "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]},
                      binary=False)
        xyz2, rgb2 = ply.load_ply_xyz_rgb(p)
        np.testing.assert_allclose(xyz2, xyz, rtol=1e-6)
        np.testing.assert_array_equal(rgb2, rgb)

    def test_float_color_autorange(self, tmp_path):
        xyz, _ = random_cloud(10)
        col01 = np.linspace(0, 1, 30, dtype=np.float32).reshape(10, 3)
        p = tmp_path / "f.ply"
        ply.write_ply(p, {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                          "red": col01[:, 0], "green": col01[:, 1],
                          "blue": col01[:, 2]})
        _, rgb = ply.load_ply_xyz_rgb(p)
        np.testing.assert_array_equal(
            rgb, np.clip(np.rint(col01 * 255), 0, 255).astype(np.uint8))

    def test_3dgs_dc_colors(self, tmp_path):
        xyz, _ = random_cloud(20, seed=1)
        dc = np.random.default_rng(2).normal(size=(20, 3)).astype(np.float32)
        p = tmp_path / "gs.ply"
        ply.write_ply(p, {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                          "f_dc_0": dc[:, 0], "f_dc_1": dc[:, 1],
                          "f_dc_2": dc[:, 2]})
        _, rgb = ply.load_ply_xyz_rgb(p)
        np.testing.assert_array_equal(rgb, ply.dc_sh_to_rgb8(dc))

    def test_no_color_defaults_white(self, tmp_path):
        xyz, _ = random_cloud(5)
        p = tmp_path / "w.ply"
        ply.write_ply(p, {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]})
        _, rgb = ply.load_ply_xyz_rgb(p)
        assert (rgb == 255).all()

    def test_list_properties_skipped(self, tmp_path):
        # a PLY with faces must still load vertices
        p = tmp_path / "faces.ply"
        header = (b"ply\nformat binary_little_endian 1.0\n"
                  b"element vertex 3\nproperty float x\nproperty float y\n"
                  b"property float z\nelement face 1\n"
                  b"property list uchar int vertex_indices\nend_header\n")
        verts = np.array([(0, 0, 0), (1, 0, 0), (0, 1, 0)],
                         dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        face = bytes([3]) + np.array([0, 1, 2], "<i4").tobytes()
        p.write_bytes(header + verts.tobytes() + face)
        xyz, rgb = ply.load_ply_xyz_rgb(p)
        assert xyz.shape == (3, 3)


class TestImage:
    def test_png_round_trip(self, tmp_path):
        img = np.random.default_rng(0).integers(0, 256, (32, 48, 3), dtype=np.uint8)
        p = tmp_path / "x.png"
        im.write_image(p, img)
        np.testing.assert_array_equal(im.read_image(p), img)

    def test_jpg_high_quality_close(self, tmp_path):
        rng = np.random.default_rng(1)
        base = rng.integers(64, 192, (16, 16, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(base, 4, 0), 4, 1)  # smooth-ish content
        p = tmp_path / "x.jpg"
        im.write_image(p, img)
        out = im.read_image(p)
        assert np.abs(out.astype(int) - img.astype(int)).mean() < 3.0

    def test_tiff16_rgb(self, tmp_path):
        img = np.random.default_rng(2).integers(0, 65536, (8, 12, 3),
                                                dtype=np.uint16)
        p = tmp_path / "x.tiff"
        im.write_image(p, img)
        # PIL downconverts 16-bit RGB TIFF on read; imageio preserves depth
        import imageio.v3 as iio
        arr = iio.imread(p)
        assert arr.dtype == np.uint16
        np.testing.assert_array_equal(arr, img)

    def test_float_conversions(self):
        img = np.array([[[0, 128, 255]]], dtype=np.uint8)
        f = im.to_float01(img)
        assert f[0, 0, 2] == 1.0
        back = im.from_float01(f)
        np.testing.assert_array_equal(back, img)

    def test_async_writer(self, tmp_path):
        imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(20)]
        with im.AsyncImageWriter(workers=4, max_pending=4) as w:
            for i, img in enumerate(imgs):
                w.submit(tmp_path / f"f{i}.png", img)
        for i in range(20):
            assert (im.read_image(tmp_path / f"f{i}.png") == i).all()

    def test_async_writer_error_surfaces(self, tmp_path):
        w = im.AsyncImageWriter()
        w.submit(tmp_path / "nodir" / "deep" / "x.png", np.zeros((4, 4, 3), np.uint8))
        with pytest.raises(RuntimeError):
            w.close()


def gradient_frames(n=10, w=64, h=32):
    frames = []
    for i in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        img[..., 1] = int(i * 255 / max(1, n - 1))
        img[..., 2] = 128
        frames.append(img)
    return frames


class TestPng16:
    def test_rgb48_png_round_trip(self, tmp_path):
        # the reference writes rgb48le PNGs via ffmpeg
        # (gs360_Video2Frames.py:540-545); PIL lacks 16-bit RGB PNG, so
        # write_image/read_image carry their own codec
        from gs360x.io.image import read_image, write_image

        img = (np.random.default_rng(3).random((41, 67, 3))
               * 65535).astype(np.uint16)
        write_image(tmp_path / "deep.png", img)
        back = read_image(tmp_path / "deep.png")
        assert back.dtype == np.uint16
        np.testing.assert_array_equal(back, img)

    def test_png16_readable_header(self, tmp_path):
        from gs360x.io.image import write_image

        img = np.zeros((8, 8, 3), np.uint16)
        write_image(tmp_path / "z.png", img)
        head = (tmp_path / "z.png").read_bytes()[:8]
        assert head == b"\x89PNG\r\n\x1a\n"


def _png_bytes(w, h, depth, ctype, filtered_rows):
    """A PNG whose scanlines carry the given filter bytes (the encoder side
    of the Sub/Up/Average/Paeth filters, written from the PNG spec)."""
    import struct
    import zlib

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(bytes([f]) + row.tobytes() for f, row in filtered_rows)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _png_filter(filt, row, prev, bpp):
    out = np.zeros_like(row)
    for i in range(len(row)):
        a = int(row[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2}.get(filt)
        if filt == 4:
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (int(row[i]) - pred) & 0xFF
    return out


class TestPngCodec:
    """The zlib+numpy PNG codec that keeps PNG pipelines free of PIL."""

    @pytest.mark.parametrize("shape,dtype", [
        ((29, 41, 3), np.uint8), ((29, 41), np.uint8),
        ((13, 17, 3), np.uint16), ((13, 17), np.uint16)])
    def test_round_trip(self, tmp_path, shape, dtype):
        info = np.iinfo(dtype)
        img = np.random.default_rng(5).integers(0, info.max + 1, shape,
                                                dtype=dtype)
        im.write_image(tmp_path / "x.png", img)
        back = im.read_image(tmp_path / "x.png")
        want = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        assert back.dtype == dtype
        np.testing.assert_array_equal(back, want)

    @pytest.mark.parametrize("ctype,chans", [(2, 3), (6, 4), (0, 1)])
    def test_every_filter_type(self, tmp_path, monkeypatch, ctype, chans):
        import importlib.util

        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda name, *a: None if name == "PIL"
                            else real(name, *a))
        rng = np.random.default_rng(ctype)
        h, w = 10, 7
        img = rng.integers(0, 256, (h, w * chans), dtype=np.uint8)
        rows, prev = [], np.zeros(w * chans, np.uint8)
        for y in range(h):
            filt = y % 5
            rows.append((filt, _png_filter(filt, img[y], prev, chans)))
            prev = img[y]
        p = tmp_path / "f.png"
        p.write_bytes(_png_bytes(w, h, 8, ctype, rows))
        back = im.read_image(p)
        pix = img.reshape(h, w, chans)
        want = np.repeat(pix, 3, -1) if chans == 1 else pix[..., :3]
        np.testing.assert_array_equal(back, want)

    def test_jpeg_without_pil_says_so(self, tmp_path, monkeypatch):
        import sys

        monkeypatch.setitem(sys.modules, "PIL", None)
        with pytest.raises(RuntimeError, match="PIL"):
            im.write_image(tmp_path / "x.jpg", np.zeros((4, 4, 3), np.uint8))
        im.write_image(tmp_path / "x.png", np.zeros((4, 4, 3), np.uint8))
        assert im.read_image(tmp_path / "x.png").shape == (4, 4, 3)


class TestY4M:
    def test_round_trip_444(self, tmp_path):
        frames = gradient_frames()
        p = tmp_path / "v.y4m"
        vio.write_y4m(p, frames, fps=10.0, chroma="444")
        r = vio.Y4MReader(p)
        info = r.info()
        assert (info.width, info.height, info.n_frames) == (64, 32, 10)
        assert info.fps == pytest.approx(10.0)
        out = list(r.frames())
        assert len(out) == 10
        for a, b in zip(out, frames):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 3  # yuv quantization

    def test_round_trip_420(self, tmp_path):
        frames = gradient_frames(4)
        p = tmp_path / "v420.y4m"
        vio.write_y4m(p, frames, fps=5.0, chroma="420jpeg")
        out = list(vio.Y4MReader(p).frames())
        assert len(out) == 4
        assert np.abs(out[0][:, 2:-2].astype(int) -
                      frames[0][:, 2:-2].astype(int)).mean() < 6


class TestMJPEGAVI:
    def test_round_trip(self, tmp_path):
        frames = gradient_frames(6)
        p = tmp_path / "v.avi"
        vio.write_mjpeg_avi(p, frames, fps=12.0)
        r = vio.MJPEGAVIReader(p)
        info = r.info()
        assert (info.width, info.height, info.n_frames) == (64, 32, 6)
        assert info.fps == pytest.approx(12.0)
        out = list(r.frames())
        assert len(out) == 6
        assert np.abs(out[3].astype(int) - frames[3].astype(int)).mean() < 4


class TestIterFrames:
    def test_native_fps(self, tmp_path):
        p = tmp_path / "v.y4m"
        vio.write_y4m(p, gradient_frames(10), fps=10.0)
        out = list(vio.iter_frames(p))
        assert len(out) == 10
        assert out[3][0] == 3
        assert out[3][1] == pytest.approx(0.3)

    def test_downsample_fps(self, tmp_path):
        p = tmp_path / "v.y4m"
        vio.write_y4m(p, gradient_frames(10), fps=10.0)
        out = list(vio.iter_frames(p, fps=2.0))
        # ticks at 0.0, 0.5, 1.0(out of range)... source is 1s long -> 2 ticks
        assert len(out) == 2
        # tick at 0.5s maps to source frame 5 whose green = 5*255/9
        g = out[1][2][0, 0, 1]
        assert abs(int(g) - int(5 * 255 / 9)) <= 3

    def test_start_end_window(self, tmp_path):
        p = tmp_path / "v.y4m"
        vio.write_y4m(p, gradient_frames(20), fps=10.0)
        out = list(vio.iter_frames(p, fps=10.0, start=0.5, end=1.0))
        assert len(out) == 6  # ticks 0.5..1.0 inclusive
        assert out[0][1] == pytest.approx(0.5)

    def test_upsample_duplicates(self, tmp_path):
        p = tmp_path / "v.y4m"
        vio.write_y4m(p, gradient_frames(3), fps=3.0)
        out = list(vio.iter_frames(p, fps=6.0))
        assert len(out) >= 5
        np.testing.assert_array_equal(out[0][2], out[1][2])

    def test_probe(self, tmp_path):
        p = tmp_path / "v.avi"
        vio.write_mjpeg_avi(p, gradient_frames(5), fps=25.0)
        info = vio.probe_video(p)
        assert info.n_frames == 5 and info.fps == pytest.approx(25.0)


class TestFFmpegReaderBitDepth:
    """FFmpegReader pipes rgb48le for >8-bit sources (ffmpeg itself is
    faked — not present in CI — so this pins the command + dtype)."""

    def _run(self, monkeypatch, bit_depth):
        import subprocess as sp

        from gs360x.io import video as vio

        captured = {}

        class FakeStdout:
            def __init__(self, data):
                self.data = data
                self.pos = 0

            def read(self, n):
                out = self.data[self.pos:self.pos + n]
                self.pos += n
                return out

            def close(self):
                pass

        class FakeProc:
            def __init__(self, cmd):
                captured["cmd"] = cmd
                px = 4 * 4 * 3
                itemsize = 2 if "rgb48le" in cmd else 1
                self.stdout = FakeStdout(b"\x01" * (px * itemsize))

            def wait(self):
                return 0

        monkeypatch.setattr(sp, "Popen",
                            lambda cmd, **kw: FakeProc(cmd))
        reader = vio.FFmpegReader.__new__(vio.FFmpegReader)
        reader.path = "fake.mp4"
        reader.stream = None
        reader._info = vio.VideoInfo(width=4, height=4, fps=30.0,
                                     n_frames=1, duration=1 / 30.0,
                                     bit_depth=bit_depth)
        return captured, list(reader.frames())

    def test_8bit_uses_rgb24(self, monkeypatch):
        captured, frames = self._run(monkeypatch, 8)
        assert "rgb24" in captured["cmd"]
        assert frames[0].dtype == np.uint8

    def test_10bit_uses_rgb48le_uint16(self, monkeypatch):
        captured, frames = self._run(monkeypatch, 10)
        assert "rgb48le" in captured["cmd"]
        assert frames[0].dtype == np.uint16
        assert frames[0].shape == (4, 4, 3)
