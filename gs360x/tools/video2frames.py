"""gs360x-video2frames — extract frames from video at N fps.

JAX rebuild of ``gs360_Video2Frames``
(``/root/reference/cli_tools/gs360_Video2Frames.py``): decodes the video
(pure-Python Y4M/MJPEG-AVI codecs, or ffmpeg when present), applies the
Rec.709→SMPTE-170M (+ sRGB transfer unless ``--keep-rec709``) color move as
a device op, and writes ``{prefix}_%07d{suffix}.{ext}`` frames through the
async encoder pool. Bit-depth-aware: >8-bit sources write 16-bit PNG/TIFF
(``gs360_Video2Frames.py:503-545``).

``--map-stream`` selects a video stream (dual-fisheye lens extraction,
``gs360_Video2Frames.py:52-80``); ``--fisheye-perspective`` runs the
experimental single-lens fisheye→perspective transform through the warp
engine instead of ffmpeg's v360 (``gs360_Video2Frames.py:483-493``).
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys
import time

import numpy as np

from gs360x.core import camera as cam

FISHEYE_INPUT_FOV_DEG = 190.0


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Extract frames from a video at N fps (device color "
                    "pipeline; no ffmpeg required for y4m/mjpeg-avi).")
    ap.add_argument("-i", "-in", dest="video", required=True,
                    help="Input video file path.")
    ap.add_argument("-o", "-out", dest="output", default=None,
                    help="Output directory (defaults next to the input).")
    ap.add_argument("-f", "--fps", type=float, required=True,
                    help="Frame extraction rate (e.g. 5, 2.5).")
    ap.add_argument("-e", "--ext", default="jpg",
                    help="Output image extension (default: jpg).")
    ap.add_argument("--prefix", default="out",
                    help="Filename prefix (default: out).")
    ap.add_argument("--start", type=float, default=0.0,
                    help="Optional start time in seconds.")
    ap.add_argument("--end", type=float, default=None,
                    help="Optional end time in seconds.")
    ap.add_argument("--keep-rec709", action="store_true",
                    help="Keep Rec.709 transfer instead of sRGB.")
    ap.add_argument("--overwrite", action="store_true",
                    help="Overwrite existing frames.")
    ap.add_argument("--ffmpeg", default="ffmpeg", help=argparse.SUPPRESS)
    ap.add_argument("--map-stream", dest="map_stream", default=None,
                    help="Stream selector like '0:v:1' (dual-fisheye lens).")
    ap.add_argument("--name-suffix", dest="name_suffix", default="",
                    help="Suffix before the extension (e.g. _X).")
    ap.add_argument("--fisheye-perspective", action="store_true",
                    help="Experimental fisheye→perspective transform.")
    ap.add_argument("--fisheye-focal-mm", type=float, default=8.0)
    ap.add_argument("--fisheye-size", type=int, default=3840)
    ap.add_argument("--fisheye-projection", type=str.lower,
                    choices=("equidistant", "equisolid"), default="equisolid")
    ap.add_argument("--fisheye-input-fov", type=float,
                    default=FISHEYE_INPUT_FOV_DEG)
    return ap


def parse_map_stream_selector(spec):
    """'0:v:N' / 'v:N' / 'N' → video stream index (None = default)."""
    if spec is None:
        return None
    s = str(spec).strip()
    m = re.match(r"^(?:0:)?(?:v:)?(\d+)$", s)
    if not m:
        raise ValueError(f"unsupported --map-stream selector: {spec!r} "
                         "(expected like '0:v:1')")
    return int(m.group(1))


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = create_arg_parser().parse_args(argv)
    in_path = pathlib.Path(args.video).expanduser().resolve()
    if not in_path.is_file():
        print(f"[ERR] Input video not found: {in_path}", file=sys.stderr)
        return 1
    if args.fps <= 0:
        print("[ERR] --fps must be > 0", file=sys.stderr)
        return 1
    try:
        stream = parse_map_stream_selector(args.map_stream)
    except ValueError as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1

    out_dir = (pathlib.Path(args.output).resolve() if args.output
               else in_path.parent / f"{in_path.stem}_frames")
    out_dir.mkdir(parents=True, exist_ok=True)
    ext = args.ext.lower().lstrip(".")
    suffix = re.sub(r"\s+", "_", args.name_suffix.strip())

    if not args.overwrite:
        existing = next(out_dir.glob(f"{args.prefix}_*{suffix}.{ext}"), None)
        if existing is not None:
            print("Output exists and overwrite is disabled. "
                  f"First match: {existing.name}", file=sys.stderr)
            print("Enable --overwrite to replace existing frames.",
                  file=sys.stderr)
            return 1

    from gs360x.io import video as vio
    from gs360x.io.image import AsyncImageWriter, from_float01

    try:
        info = vio.probe_video(in_path)
    except Exception as exc:
        print(f"[ERR] cannot probe video: {exc}", file=sys.stderr)
        return 1
    bit_depth = info.bit_depth
    est_total = None
    if info.n_frames and info.fps:
        span = info.n_frames / info.fps
        t1 = min(args.end, span) if args.end else span
        span = max(0.0, t1 - args.start)
        est_total = int(span * args.fps) + 1
    print(f"[INFO] {info.width}x{info.height} @ {info.fps:g} fps, "
          f"{bit_depth}-bit, extracting at {args.fps:g} fps")

    import jax.numpy as jnp

    from gs360x.core.color import video_color_move
    from gs360x.kernels import warp as warplib

    fisheye_kw = None
    if args.fisheye_perspective:
        hfov = cam.hfov_from_focal_mm(max(args.fisheye_focal_mm, 1e-6), 36.0)
        fisheye_kw = dict(
            size=max(args.fisheye_size, 1), hfov=hfov,
            model=args.fisheye_projection, dfov=args.fisheye_input_fov)
        print(f"[INFO] fisheye→perspective: {fisheye_kw['size']}px "
              f"hfov={hfov:.1f}° model={args.fisheye_projection}")

    import threading

    from gs360x.runtime.executor import _Prefetcher

    def to_device(rgb):
        # transfer in source dtype (uint8 = 4x less host->device traffic),
        # normalize + color-move + optional fisheye cut on device
        dev = jnp.asarray(rgb)
        if dev.dtype == jnp.uint8:
            dev = dev.astype(jnp.float32) * (1.0 / 255.0)
        elif dev.dtype == jnp.uint16:
            dev = dev.astype(jnp.float32) * (1.0 / 65535.0)
        frame = video_color_move(dev, keep_rec709=args.keep_rec709)
        if fisheye_kw:
            frame = warplib.warp_fisheye_to_perspective(
                frame, fisheye_kw["size"], fisheye_kw["hfov"],
                fisheye_kw["dfov"], model=fisheye_kw["model"])
        return frame

    written = 0
    t0 = time.time()
    stop = threading.Event()
    pending = None  # (idx, device frame) dispatched, not yet fetched
    # software pipeline: decode N+1 (thread) || device work N+1 (queued)
    # || fetch+encode N (here + writer pool) — same shape as the executor
    with AsyncImageWriter(workers=8) as writer:
        def drain(entry):
            nonlocal written
            idx, frame = entry
            arr = from_float01(np.asarray(frame), 16 if bit_depth > 8 else 8)
            name = f"{args.prefix}_{idx:07d}{suffix}.{ext}"
            writer.submit(out_dir / name, arr)
            written += 1
            if est_total:
                elapsed = time.time() - t0
                eta = elapsed / written * (est_total - written)
                sys.stdout.write(
                    f"Extracting... {min(100, written * 100 // est_total):3d}%"
                    f" ({written}/{est_total}) ETA {eta:5.1f}s\r")
                sys.stdout.flush()

        try:
            for idx, _t, rgb in _Prefetcher(
                    vio.iter_frames(in_path, fps=args.fps, start=args.start,
                                    end=args.end, stream=stream), stop):
                frame = to_device(rgb)
                if pending is not None:
                    drain(pending)
                pending = (idx, frame)
            if pending is not None:
                drain(pending)
                pending = None
        finally:
            stop.set()
    if est_total:
        sys.stdout.write("\n")
    print(f"[OK] wrote {written} frame(s) to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
