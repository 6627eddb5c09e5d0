"""Timing-breakdown plots over the per-frame telemetry CSV — the port's
own copy of ``zenslam_tpu/analysis/plot_timing_breakdown.py`` (stacked
per-phase timing over time, duration distribution, fps trend). The
per-frame phases are wait / step / backend (BA + loop closure on
keyframes); per-kernel device time is not in the CSV (``chip_smoke.py``
measures it).

Usage: python -m zenslam_tpu_torch.analysis.plot_timing_breakdown \
           --csv output/frame_data.csv --output output/plots
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from zenslam_tpu_torch.analysis.style import PALETTE, apply_style, save

PHASES = ["duration_wait_ms", "duration_step_ms", "duration_backend_ms"]
PHASE_LABELS = ["wait (io)", "step (device)", "backend (BA/loop)"]


def load_rows(csv_path):
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty telemetry CSV: {csv_path}")
    return rows


def main(argv=None):
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser("plot_timing_breakdown")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--output", default="output/plots")
    args = ap.parse_args(argv)
    apply_style()
    os.makedirs(args.output, exist_ok=True)

    rows = load_rows(args.csv)
    frames = np.asarray([int(r["frame"]) for r in rows])
    phases = {lab: np.asarray([float(r[c]) for r in rows])
              for c, lab in zip(PHASES, PHASE_LABELS)}
    total = np.asarray([float(r["duration_total_ms"]) for r in rows])

    # 1. stacked per-phase timing over frames
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.stackplot(frames, *phases.values(), labels=phases.keys(),
                 colors=PALETTE[: len(phases)], alpha=0.85)
    ax.set_xlabel("frame")
    ax.set_ylabel("time (ms)")
    ax.set_title("per-frame timing breakdown (stacked)")
    ax.legend(loc="upper right")
    save(fig, os.path.join(args.output, "timing_stacked.png"))

    # 2. total-duration distribution with mean/median markers
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(total, bins=min(40, max(5, len(total) // 4)),
            color=PALETTE[0], alpha=0.85)
    ax.axvline(float(np.mean(total)), color=PALETTE[1], linewidth=2,
               label=f"mean {np.mean(total):.1f} ms")
    ax.axvline(float(np.median(total)), color=PALETTE[2], linewidth=2,
               label=f"median {np.median(total):.1f} ms")
    ax.set_xlabel("total frame time (ms)")
    ax.set_ylabel("frames")
    ax.set_title("frame-time distribution")
    ax.legend()
    save(fig, os.path.join(args.output, "timing_distribution.png"))

    # 3. rolling throughput trend
    k = max(1, min(25, len(total) // 4))
    kernel = np.ones(k) / k
    smooth = np.convolve(total, kernel, mode="valid")
    fps = 1000.0 / np.maximum(smooth, 1e-6)
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(frames[k - 1:], fps, color=PALETTE[0])
    ax.set_xlabel("frame")
    ax.set_ylabel(f"throughput (fps, {k}-frame window)")
    ax.set_title("rolling throughput")
    save(fig, os.path.join(args.output, "timing_throughput.png"))

    print(f"frames {len(rows)}  mean {np.mean(total):.1f} ms  "
          f"median {np.median(total):.1f} ms  "
          f"p95 {np.percentile(total, 95):.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
