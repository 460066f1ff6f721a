#!/usr/bin/env python3
"""gs360x headline benchmark: 8K-equirect → 1080p perspective cuts/sec/card.

Measures the default-preset multi-view warp (8 views, bicubic, v360-parity
sampling) of one 8K uint8 equirectangular frame to 1920×1080 uint8
perspective views, through the program the image path of
``gs360x-perspcut`` runs, in steady state on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "views/s", "spread_pct": N,
   "device": {"platform": ..., "kind": ..., "count": N}}
Diagnostics go to stderr. Exits non-zero, printing no result, when JAX
finds no GPU; any failure is fatal.
"""

import json
import sys
import time

import numpy as np

N_VIEWS = 8
OUT_W, OUT_H = 1920, 1080
HFOV, VFOV = 112.6, 73.7  # the 12mm/36mm default preset at 16:9


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def measured_seconds(fn, *, warm=2, reps=20):
    """Median and interquartile spread (over the median) of ``fn``'s wall
    time; ``fn`` must block until its device work is done."""
    for _ in range(warm):
        fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    med = float(np.median(samples))
    p25, p75 = np.percentile(samples, [25, 75])
    return med, float(p75 - p25) / med


def main():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"[bench] no GPU: JAX platform is {devs[0].platform!r}")
        return 1
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log(f"[bench] device {device}")

    from gs360x.runtime import mesh as meshlib

    rng = np.random.default_rng(0)
    frames = (rng.random((1, 3840, 7680, 3)) * 255).astype(np.uint8)
    batch = jax.device_put(frames, devs[0])
    mesh = meshlib.data_mesh(devs[:1])
    yaws = np.arange(N_VIEWS, dtype=np.float32) * (360.0 / N_VIEWS)
    zeros = np.zeros(N_VIEWS, np.float32)

    def run():
        jax.block_until_ready(meshlib.warp_frames_sharded(
            mesh, batch, yaws, zeros, zeros, width=OUT_W, height=OUT_H,
            hfov_deg=HFOV, vfov_deg=VFOV, interp="bicubic",
            quantize_bits=8))

    per, spread = measured_seconds(run)
    log(f"[bench] {per * 1000:.3f} ms/frame "
        f"(spread {spread * 100:.1f}%)")
    print(json.dumps({
        "metric": "8K->1080p perspective cuts/sec/card (8-view bicubic warp)",
        "value": N_VIEWS / per, "unit": "views/s",
        "spread_pct": spread * 100, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
