#!/usr/bin/env python3
"""Diff the warp against the independent v360 oracle.

Diffs :func:`gs360x.kernels.warp.warp_equirect_to_views` against
:mod:`gs360x.kernels.v360_oracle` — a from-scratch scalar-numpy port of
the v360 filter's remap algorithm (fixed-point Q14 Lagrange taps,
pixel-center mapping, pole reflection) — and writes the measured
deviations to ``docs/V360_PARITY.md``.

The reference delegates all reprojection to the v360 filter
(``/root/reference/cli_tools/gs360_360PerspCut.py:310-314`` rectilinear,
``:375-379`` fisheye), so the oracle is the correctness bar.

Known, intentional deviation the report quantifies rather than hides:
the warp accumulates in float where v360 quantizes tap products to
int16 Q14 — a ≤1 u8 LSB rounding difference on any pixel.

The warp runs on JAX's default device; the report names it.

Usage::

    python tools/v360_parity_report.py            # full grid + report
    python tools/v360_parity_report.py --quick    # smaller grid
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRC_H, SRC_W = 512, 1024
OUT = 256

# (name, projection, out_size, hfov, vfov, yaw, pitch, roll)
# Whether a pixel's 4x4 tap rows cross a pole row is computed per pixel
# from the oracle's own mapping (v360_oracle.pole_tap_mask), not
# hand-flagged per case.
CASES = [
    ("yaw_ring", "perspective", OUT, 104.25, 104.25, 37.0, 0.0, 0.0),
    ("seam_cross", "perspective", OUT, 104.25, 104.25, 180.0, 0.0, 0.0),
    ("tilt_p30", "perspective", OUT, 104.25, 104.25, 45.0, 30.0, 0.0),
    ("tilt_m30", "perspective", OUT, 104.25, 104.25, -135.0, -30.0, 0.0),
    ("deep_shear", "perspective", OUT, 110.0, 110.0, 20.0, 60.0, 0.0),
    ("pole_graze", "perspective", OUT, 112.6, 112.6, 0.0, 62.0, 0.0),
    ("roll_20", "perspective", OUT, 104.25, 104.25, 10.0, 15.0, 20.0),
    ("fisheye_d190", "fisheye_v360", OUT, 190.0, 190.0, 0.0, 0.0, 0.0),
    # cube105 up face: pole-centered — reflection everywhere near the cap
    ("pole_up", "perspective", OUT, 104.25, 104.25, 0.0, 90.0, 0.0),
]


def make_panorama(h: int = SRC_H, w: int = SRC_W) -> np.ndarray:
    """Deterministic panorama with gradients, texture, and hard edges —
    enough spectral content that an interpolation bug can't hide."""
    rng = np.random.default_rng(20260819)
    yy, xx = np.mgrid[0:h, 0:w]
    r = (xx * 255.0 / w + 20.0 * np.sin(yy * 0.11)) % 256.0
    g = (yy * 255.0 / h + 20.0 * np.sin(xx * 0.07)) % 256.0
    b = ((xx // 16 + yy // 16) % 2) * 160.0 + 40.0
    img = np.stack([r, g, b], axis=-1)
    img += rng.normal(0.0, 12.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def measure(quick: bool) -> dict:
    """Per-case u8 deviation statistics of the warp vs the oracle."""
    import jax.numpy as jnp

    from gs360x.kernels import v360_oracle as vo
    from gs360x.kernels import warp

    src = make_panorama()
    stats = {}
    for case in CASES[: 4 if quick else len(CASES)]:
        name, proj, size, hf, vf, yaw, pitch, roll = case
        geom = dict(width=size, height=size, hfov_deg=hf, vfov_deg=vf,
                    projection=proj)
        oracle_u8, valid = vo.warp_equirect_oracle(
            src, yaw, pitch, roll, interp="bicubic", **geom)
        pole_px = vo.pole_tap_mask(src.shape[0], src.shape[1], yaw, pitch,
                                   roll, **geom)
        out = warp.warp_equirect_to_views(
            jnp.asarray(src.astype(np.float32) / 255.0),
            np.array([yaw]), np.array([pitch]), np.array([roll]),
            interp="bicubic", **geom)
        arr = np.asarray(out)[0]                          # (H, W, 3)
        got_u8 = np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)
        diff = np.abs(got_u8.astype(np.int32) - oracle_u8.astype(np.int32))
        dv = diff[valid]                                  # (n_valid, 3)
        dnp = diff[valid & ~pole_px]                      # non-pole pixels
        n = dv.size
        stats[name] = {
            "max_lsb": int(dv.max()) if n else 0,
            "mean_lsb": round(float(dv.mean()), 4) if n else 0.0,
            "p999_lsb": int(np.percentile(dv, 99.9)) if n else 0,
            "pct_gt1": round(100.0 * float((dv > 1).sum()) / max(n, 1), 4),
            "max_nonpole_lsb": int(dnp.max()) if dnp.size else 0,
            "pole_px_pct": round(
                100.0 * float((valid & pole_px).sum())
                / max(int(valid.sum()), 1), 2),
        }
    return stats


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "docs",
                                                  "V360_PARITY.md"))
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    results = measure(args.quick)
    print("[parity] " + ", ".join(f"{k}={v['max_lsb']}"
                                  for k, v in results.items()))
    lines = [
        "# v360 parity — the warp vs the independent oracle",
        "",
        "Measured by `tools/v360_parity_report.py`: the warp's u8",
        "output diffed against `gs360x/kernels/v360_oracle.py`, a",
        "from-scratch scalar-numpy port of ffmpeg v360's remap algorithm",
        "(Q14 fixed-point Lagrange taps, pixel-center mapping, pole",
        "reflection). Units: u8 LSB over valid pixels. `pct>1` = percent",
        "of channel samples deviating by more than 1 LSB.",
        "",
        f"The warp ran on JAX device `{dev.platform}` (`{dev.device_kind}`).",
        "These are correctness numbers, not timings. `chip_smoke.py` checks",
        "the same bound on the GPU at production sizes.",
        "",
        "Known semantic delta (quantified, not hidden): the warp",
        "accumulates in float where v360 rounds tap products to int16",
        "Q14 (a <=1 LSB difference anywhere). The warp implements v360's",
        "pole reflection per tap, so pole-crossing cases carry no extra",
        "delta.",
        "",
        "| case | max LSB | max non-pole | mean LSB | p99.9 "
        "| pct>1 | pole px |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, s in results.items():
        lines.append(
            f"| {name} | {s['max_lsb']} | {s['max_nonpole_lsb']} | "
            f"{s['mean_lsb']} | {s['p999_lsb']} | {s['pct_gt1']}% | "
            f"{s['pole_px_pct']}% |")
    lines.append("")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"[parity] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
