"""Image read/write with an async writer pool.

Replaces the reference's ffmpeg still-image encodes and cv2/PIL reads.
Quality policy mirrors the reference's encoder settings
(``/root/reference/cli_tools/gs360_360PerspCut.py:317-347``): jpg defaults
to near-lossless 4:4:4 (mjpeg q=1 equivalent → quality 98, subsampling
off), ``jpeg_quality_95`` drops to 95. 16-bit outputs go to PNG/TIFF.

PNG (8- and 16-bit, gray and RGB) is read and written here with ``zlib``
and numpy, so a PNG pipeline runs without PIL. PIL is imported only where
it is needed: JPEG and 8-bit TIFF, and the PNG variants :func:`_read_png`
leaves to it.

The writer pool is the device pipeline's pressure valve: device → host
arrays are handed to a bounded thread pool so encoding overlaps the next
batch's warp (the reference's analogue is one ffmpeg process per view).
"""

from __future__ import annotations

import concurrent.futures as cf
import importlib.util
import pathlib
import struct
import threading
import zlib
from typing import Optional

import numpy as np

IMAGE_EXTS = {".tif", ".tiff", ".jpg", ".jpeg", ".png"}


# --------------------------------------------------------------------------
# conversions
# --------------------------------------------------------------------------


def to_float01(img: np.ndarray) -> np.ndarray:
    """uint8/uint16/float image → float32 in [0,1]."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def from_float01(img: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """float [0,1] → uint8 or uint16 with round-half-away like ffmpeg.

    Already-quantized arrays pass through (device pipelines quantize
    before the host fetch to shrink device→host transfers 4x)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and bit_depth <= 8:
        return img
    if img.dtype == np.uint16 and bit_depth > 8:
        return img
    x = np.clip(img.astype(np.float32), 0.0, 1.0)
    if bit_depth > 8:
        return np.rint(x * 65535.0).astype(np.uint16)
    return np.rint(x * 255.0).astype(np.uint8)


# --------------------------------------------------------------------------
# read / write
# --------------------------------------------------------------------------


def _pil_image():
    """PIL's ``Image`` module, imported on first use."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "PIL (Pillow) is not installed: it is needed for JPEG and 8-bit "
            "TIFF files and for palette or interlaced PNGs; write PNG "
            "instead (--ext png)") from exc
    return Image


def read_image(path) -> np.ndarray:
    """Read an image as (H, W, 3) uint8 or uint16 RGB."""
    if pathlib.Path(path).suffix.lower() == ".png":
        arr = _read_png(path)
        if arr is not None:
            return arr
    with _pil_image().open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(im, dtype=np.uint16)
            return np.repeat(arr[..., None], 3, axis=-1)
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples per pixel (gray, RGB, gray+alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _read_png(path):
    """Decode a non-interlaced 8/16-bit gray/RGB(A) PNG to (H, W, 3) RGB
    (alpha dropped, gray repeated). Returns None for the PNG variants it
    leaves to PIL: palette, interlaced, sub-byte depths, and, when PIL is
    installed, files with Average/Paeth-filtered rows."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload[:13])
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError(f"truncated PNG file: {path}")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        return None
    chans = _PNG_CHANNELS[ctype]
    bpp = chans * depth // 8
    raw = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    rows = raw.reshape(h, w * bpp + 1)
    if np.isin(rows[:, 0], (3, 4)).any() \
            and importlib.util.find_spec("PIL") is not None:
        return None   # Average/Paeth rows decode per pixel here; PIL is faster
    out = _png_unfilter(rows[:, 0], rows[:, 1:], bpp)
    if depth == 16:
        out = out.reshape(h, w * chans, 2)
        arr = (out[..., 0].astype(np.uint16) << 8) | out[..., 1]
    else:
        arr = out
    arr = arr.reshape(h, w, chans)
    if chans <= 2:
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def _png_unfilter(filters: np.ndarray, lines: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo PNG scanline filters. None/Up/Sub rows are vectorized;
    Average/Paeth rows (never written by :func:`_write_png`) run per
    pixel."""
    if not filters.any():
        return lines
    out = np.empty_like(lines)
    prev = np.zeros(lines.shape[1], np.uint8)
    for y in range(lines.shape[0]):
        filt, line = int(filters[y]), lines[y]
        if filt == 0:
            row = line
        elif filt == 2:
            row = line + prev
        elif filt == 1:
            row = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif filt in (3, 4):
            row = _png_unfilter_slow(filt, line, prev, bpp)
        else:
            raise ValueError(f"bad PNG filter type {filt}")
        out[y] = row
        prev = out[y]
    return out


def _png_unfilter_slow(filt, line, prev, bpp):
    row = np.zeros(len(line), np.uint8)
    for i in range(len(line)):
        x = int(line[i])
        a = int(row[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        if filt == 3:
            x += (a + b) // 2
        else:
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            x += a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = x & 0xFF
    return row


def read_image_gray(path) -> np.ndarray:
    """Read an image as (H, W) float32 luma in [0,1] (BT.601 weights, the
    same gray conversion cv2.imread+cvtColor uses in the reference)."""
    img = to_float01(read_image(path))
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def write_image(path, img: np.ndarray, *,
                jpeg_quality: Optional[int] = None) -> None:
    """Write (H, W, 3) uint8/uint16 (or (H, W) gray) to path by extension."""
    path = pathlib.Path(path)
    ext = path.suffix.lower()
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., :3]
    if ext == ".png":
        _write_png(path, img)
        return
    if img.dtype == np.uint16:
        if ext in (".jpg", ".jpeg"):
            img = (img >> 8).astype(np.uint8)
        elif img.ndim == 3:
            # PIL has no 16-bit RGB; the raw writer covers the reference's
            # rgb48le TIFF outputs (gs360_Video2Frames.py:540-545)
            _write_tiff16_rgb(path, img)
            return
    pil = _pil_image().fromarray(img)
    if ext in (".jpg", ".jpeg"):
        # reference encode contract (gs360_Video2Frames.py:517-537):
        # top-quality mjpeg at 4:4:4 with optimal huffman tables maps to
        # PIL quality=98..100, subsampling=0, optimize=True
        q = 98 if jpeg_quality is None else int(jpeg_quality)
        pil.save(path, quality=q, subsampling=0, optimize=True)
    elif ext in (".tif", ".tiff"):
        # lossless deflate, like the reference's -compression_algo deflate
        pil.save(path, compression="tiff_deflate")
    else:
        pil.save(path)


def _write_png(path, img: np.ndarray) -> None:
    """8/16-bit gray or RGB PNG (16-bit RGB is the reference's rgb48le PNG
    analogue): zlib-compressed scanlines, filter byte 0, big-endian
    samples."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG needs uint8 or uint16 pixels, got {img.dtype}")
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    depth = 16 if img.dtype == np.uint16 else 8
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = np.zeros((h, px.nbytes // h + 1), np.uint8)
    rows[:, 1:] = px.view(np.uint8).reshape(h, -1)   # column 0: filter None

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _write_tiff16_rgb(path, img: np.ndarray) -> None:
    """Minimal uncompressed little-endian TIFF for 16-bit RGB (the
    reference's rgb48le TIFF analogue). Single strip, no compression."""
    h, w, _ = img.shape
    data = np.ascontiguousarray(img.astype("<u2")).tobytes()
    # header (8) + IFD later; place pixel data right after header
    data_offset = 8
    ifd_offset = data_offset + len(data)
    entries = []

    def entry(tag, typ, count, value):
        entries.append(struct.pack("<HHI4s", tag, typ, count, value))

    def long_val(v):
        return struct.pack("<I", v)

    def short_val(v):
        return struct.pack("<HH", v, 0)

    extra = b""
    extra_offset = ifd_offset + 2 + 12 * 11 + 4
    # BitsPerSample needs 3 shorts -> external
    bps_offset = extra_offset + len(extra)
    extra += struct.pack("<HHH", 16, 16, 16) + b"\x00\x00"
    entry(256, 3, 1, short_val(w))            # ImageWidth
    entry(257, 3, 1, short_val(h))            # ImageLength
    entry(258, 3, 3, long_val(bps_offset))    # BitsPerSample
    entry(259, 3, 1, short_val(1))            # Compression: none
    entry(262, 3, 1, short_val(2))            # Photometric: RGB
    entry(273, 4, 1, long_val(data_offset))   # StripOffsets
    entry(277, 3, 1, short_val(3))            # SamplesPerPixel
    entry(278, 3, 1, short_val(h))            # RowsPerStrip
    entry(279, 4, 1, long_val(len(data)))     # StripByteCounts
    entry(284, 3, 1, short_val(1))            # PlanarConfig: chunky
    entry(339, 3, 1, short_val(1))            # SampleFormat: unsigned
    ifd = struct.pack("<H", len(entries)) + b"".join(entries) + struct.pack("<I", 0)
    header = struct.pack("<2sHI", b"II", 42, ifd_offset)
    pathlib.Path(path).write_bytes(header + data + ifd + extra)


# --------------------------------------------------------------------------
# async writer pool
# --------------------------------------------------------------------------


class AsyncImageWriter:
    """Bounded thread-pool image writer with backpressure.

    ``submit`` blocks once ``max_pending`` encodes are in flight, so the
    device loop can't race ahead of the disk (the role the reference's
    adaptive memory limiter plays, ``gs360_FrameSelector.py:65-193``).
    """

    def __init__(self, workers: int = 4, max_pending: int = 32):
        self._pool = cf.ThreadPoolExecutor(max_workers=workers)
        self._sem = threading.Semaphore(max_pending)
        self._errors: list = []
        self._lock = threading.Lock()
        self._count = 0

    def submit(self, path, img: np.ndarray, **kw) -> None:
        self._sem.acquire()

        def task():
            try:
                write_image(path, img, **kw)
            except Exception as exc:  # surfaced on close()
                with self._lock:
                    self._errors.append((str(path), exc))
            finally:
                self._sem.release()

        with self._lock:
            self._count += 1
        self._pool.submit(task)

    def close(self) -> int:
        """Wait for completion; raise the first error; return files written."""
        self._pool.shutdown(wait=True)
        if self._errors:
            path, exc = self._errors[0]
            raise RuntimeError(f"failed writing {path}: {exc}") from exc
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
