"""RenderPlan executor: the device-centric replacement for the reference's
ffmpeg process fan-out.

Where the reference runs one ffmpeg per (frame × view) — re-decoding the
whole video per view (SURVEY §3.1) — this executor decodes each frame once,
moves it to the device once, and warps **all** views in one batched jitted
program, streaming encodes through the async writer pool. Progress,
cancellation, and resume semantics mirror the reference:

* progress printed in ≥5%% steps (``gs360_360PerspCut.py:67-75``),
* cooperative stop via an Event (SIGINT handler escalation,
  ``gs360_360PerspCut.py:535-561``),
* manifest resume = skip outputs that already exist, like Video2Frames'
  overwrite guard (``gs360_Video2Frames.py:442-455``).
"""

from __future__ import annotations

import pathlib
import queue as queuelib
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax
import numpy as np

from gs360x.io import image as imagelib
from gs360x.io import video as videolib
from gs360x.kernels import warp as warplib
from gs360x.rig.spec import RenderPlan
from gs360x.runtime.profiling import StageTimers, maybe_trace

PROGRESS_INTERVAL = 5


@dataclass
class ExecutionReport:
    ok: int = 0
    failed: int = 0
    skipped: int = 0
    total: int = 0
    seconds: float = 0.0
    errors: List[str] = field(default_factory=list)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def stopped(self) -> bool:
        return self.ok + self.failed + self.skipped < self.total


class ProgressPrinter:
    """Throttled single-line progress, same cadence as the reference."""

    def __init__(self, label: str = "Progress", stream=None):
        self.label = label
        self._stream = stream  # None -> current sys.stdout at write time
        self._last = -1

    @property
    def stream(self):
        return self._stream if self._stream is not None else sys.stdout

    def update(self, completed: int, total: int) -> None:
        if total <= 0:
            return
        pct = int(completed * 100 / total)
        if self._last < 0 or pct >= 100 or (pct - self._last) >= PROGRESS_INTERVAL:
            self.stream.write(f"{self.label}... {pct:3d}% ({completed}/{total})\r")
            self.stream.flush()
            self._last = pct

    def finish(self) -> None:
        if self._last >= 0:
            self.stream.write("\n")
            self.stream.flush()


class _Prefetcher:
    """Background decode thread: overlaps host decode/IO of item N+1 with
    device work on item N (the reference gets this overlap for free from
    its per-frame ffmpeg processes; here decode and warp share one
    process, so the overlap is explicit)."""

    _DONE = object()

    def __init__(self, iterator, stop_event, depth: int = 2):
        self._q: "queuelib.Queue" = queuelib.Queue(maxsize=depth)
        self._stop = stop_event
        self._thread = threading.Thread(
            target=self._pump, args=(iterator,), daemon=True)
        self._thread.start()

    def _pump(self, iterator):
        try:
            for item in iterator:
                while True:
                    if self._stop.is_set():
                        return
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queuelib.Full:
                        continue
            self._q.put(self._DONE)
        except Exception as exc:  # surfaced on the consumer side
            self._q.put(exc)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def _warp_frames(frames, views, *, interp: str, mesh,
                 keep_rec709: Optional[bool] = None,
                 quantize_bits: Optional[int] = None):
    """Warp a batch of decoded frames through all plan views on ``mesh``.

    Views are grouped by :func:`gs360x.kernels.warp.group_views`; each
    group is ONE device program over the whole batch (sharded over the
    mesh's cards). Returns, per frame, ``[(parent, (frame, view)), ...]``
    in view order: ``parent`` is the group's (B, V, h, w, C) device array,
    shared by its views, which :class:`_ViewFetcher` fetches once. The
    video color move (when ``keep_rec709`` is not None) and the u8/u16
    quantization run on device inside the same program — the fetch moves
    quantized pixels only.
    """
    from gs360x.runtime import mesh as meshlib

    batch = frames[0][None] if len(frames) == 1 else np.stack(frames)
    results = [[None] * len(views) for _ in frames]
    groups = warplib.group_views(views)
    for (projection, vw, vh, hfov, vfov), idxs in groups.items():
        yaws, pitches, rolls = warplib.view_angles(views, idxs)
        out = meshlib.warp_frames_sharded(
            mesh, batch, yaws, pitches, rolls, width=vw, height=vh,
            hfov_deg=hfov, vfov_deg=vfov, interp=interp,
            projection=projection, keep_rec709=keep_rec709,
            quantize_bits=quantize_bits)
        for f in range(len(frames)):
            for j, i in enumerate(idxs):
                results[f][i] = (out, (f, j))
    return results


class _ViewFetcher:
    """Lazy bulk fetch for per-view warp outputs.

    Outputs arrive as ``(parent, index)`` pairs whose parents are shared
    across a batch's views. Each distinct parent is ``jax.device_get``
    exactly once, on first use — one transfer per (group, batch) instead
    of one device slice program and one transfer per view, while
    overwrite-skipped entries stay free."""

    def __init__(self, timers):
        self._timers = timers
        self._cache: Dict[int, np.ndarray] = {}

    def __call__(self, parent, index):
        buf = self._cache.get(id(parent))
        if buf is None:
            with self._timers.stage("fetch"):
                buf = np.asarray(jax.device_get(parent))
            self._cache[id(parent)] = buf
        return buf[index]


def run_plan(plan: RenderPlan, *,
             overwrite: bool = True,
             writer_workers: int = 8,
             stop_event: Optional[threading.Event] = None,
             progress: Optional[Callable[[int, int], None]] = None,
             quiet: bool = False,
             stats: bool = False) -> ExecutionReport:
    """Execute a RenderPlan (image-dir or video mode) on
    :func:`gs360x.runtime.mesh.pipeline_devices`."""
    t0 = time.time()
    stop_event = stop_event or threading.Event()
    report = ExecutionReport(total=plan.total if not plan.video_mode else 0)
    out_dir = plan.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    printer = None if quiet else ProgressPrinter()

    def tick(done: int, total: int) -> None:
        if progress:
            progress(done, total)
        if printer:
            printer.update(done, total)

    jpeg_quality = 95 if plan.jpeg_quality_95 else None
    interp = plan.interpolation

    timers = StageTimers()
    with maybe_trace("run_plan"), \
            imagelib.AsyncImageWriter(workers=writer_workers) as writer:
        if plan.video_mode:
            _run_video(plan, writer, report, stop_event, tick, interp,
                       jpeg_quality, overwrite, timers)
        else:
            _run_images(plan, writer, report, stop_event, tick, interp,
                        jpeg_quality, overwrite, timers)
    if printer:
        printer.finish()
    report.seconds = time.time() - t0
    report.stage_seconds = dict(timers.totals)
    if stats and not quiet:
        print(f"[STATS] {timers.report()} | wall {report.seconds:.2f}s")
    return report


def _run_images(plan, writer, report, stop_event, tick, interp,
                jpeg_quality, overwrite, timers) -> None:
    from gs360x.runtime.mesh import data_mesh, pipeline_devices

    # one source per launch: the overwrite guard makes view sets ragged
    mesh = data_mesh(pipeline_devices()[:1])
    qbits = 16 if plan.bit_depth > 8 else 8
    by_source: Dict[pathlib.Path, List] = {}
    for job in plan.jobs:
        by_source.setdefault(job.source, []).append(job)

    done = 0
    work = []  # (source, jobs-to-run) after the overwrite guard
    for source, jobs in by_source.items():
        todo = []
        for job in jobs:
            out_path = plan.out_dir / job.output_name
            if not overwrite and out_path.exists():
                report.skipped += 1
                done += 1
            else:
                todo.append(job)
        if todo:
            work.append((source, todo))
    tick(done, report.total)

    def decode(items):
        for source, jobs in items:
            try:
                with timers.stage("decode"):
                    img = imagelib.read_image(source)
            except Exception as exc:
                yield source, jobs, None, exc
                continue
            yield source, jobs, img, None

    inflight = None  # (jobs, outs) warped on device, not yet fetched

    def drain(entry):
        nonlocal done
        jobs, outs = entry
        fetch = _ViewFetcher(timers)
        for job, (out, index) in zip(jobs, outs):
            writer.submit(plan.out_dir / job.output_name, fetch(out, index),
                          jpeg_quality=jpeg_quality)
            report.ok += 1
            done += 1
            tick(done, report.total)

    # software pipeline: decode N+1 (thread) || warp N+1 (device queue)
    # || fetch+encode N (here + writer pool)
    for source, jobs, src, exc in _Prefetcher(decode(work), stop_event):
        if stop_event.is_set():
            return
        if exc is not None:
            report.failed += len(jobs)
            report.errors.append(f"{source.name}: {exc}")
            done += len(jobs)
            tick(done, report.total)
            continue
        with timers.stage("warp_dispatch"):
            outs = _warp_frames([src], [j.view for j in jobs], interp=interp,
                                mesh=mesh, quantize_bits=qbits)[0]
        if inflight is not None:
            drain(inflight)
        inflight = (jobs, outs)
    if inflight is not None and not stop_event.is_set():
        drain(inflight)


def _run_video(plan, writer, report, stop_event, tick, interp,
               jpeg_quality, overwrite, timers) -> None:
    """Video path: one frame per card at a time, sharded over every
    pipeline device, as ONE device program per (view group, batch). The
    fetch and encode of batch N overlap the device work of batch N+1.
    One frame per card per launch beat four on an H100 (PERF.md)."""
    from gs360x.runtime.mesh import data_mesh, pipeline_devices

    devs = pipeline_devices()
    mesh = data_mesh(devs)
    n_batch = len(devs)
    source = plan.jobs[0].source
    views = plan.unique_views()
    name_patterns = [plan.jobs[i].output_name for i in range(len(views))]
    qbits = 16 if plan.bit_depth > 8 else 8
    info = videolib.probe_video(source)
    total_est = 0
    if info.n_frames and info.fps and plan.fps:
        span = info.n_frames / info.fps
        if plan.start_time or plan.end_time:
            t0 = plan.start_time or 0.0
            t1 = min(plan.end_time, span) if plan.end_time else span
            span = max(0.0, t1 - t0)
        total_est = (int(span * plan.fps) + 1) * len(views)
    report.total = total_est
    frame_iter = videolib.iter_frames(source, fps=plan.fps,
                                      start=plan.start_time,
                                      end=plan.end_time)
    done = 0
    pending = None  # (idxs, results) on device, not yet fetched

    def drain(entry):
        nonlocal done
        idxs, results = entry
        fetch = _ViewFetcher(timers)
        for idx, outs in zip(idxs, results):
            for pattern, (out, index) in zip(name_patterns, outs):
                name = pattern.replace("%07d", f"{idx:07d}")
                out_path = plan.out_dir / name
                if not overwrite and out_path.exists():
                    report.skipped += 1
                else:
                    writer.submit(out_path, fetch(out, index),
                                  jpeg_quality=jpeg_quality)
                    report.ok += 1
                done += 1
                if total_est:
                    tick(done, total_est)

    batch_idx: List[int] = []
    batch_rgb: List[np.ndarray] = []

    def flush():
        nonlocal pending, batch_idx, batch_rgb
        if not batch_rgb:
            return
        with timers.stage("warp_dispatch"):
            results = _warp_frames(batch_rgb, views, interp=interp, mesh=mesh,
                                   keep_rec709=plan.keep_rec709,
                                   quantize_bits=qbits)
        if pending is not None:
            drain(pending)
        pending = (batch_idx, results)
        batch_idx, batch_rgb = [], []

    for idx, _t, rgb in _Prefetcher(
            timers.wrap_iter("decode", frame_iter), stop_event,
            depth=n_batch + 1):
        if stop_event.is_set():
            return
        if plan.selected_frames is not None \
                and idx not in plan.selected_frames:
            continue  # CSV frame selection: original numbering preserved
        batch_idx.append(idx)
        batch_rgb.append(np.ascontiguousarray(rgb))
        if len(batch_rgb) == n_batch:
            flush()
    flush()
    if pending is not None and not stop_event.is_set():
        drain(pending)
    report.total = done
