"""Compare telemetry CSVs from runs with different configurations — the
port's own copy of ``zenslam_tpu/analysis/plot_detector_comparison.py``.
Takes N labeled CSVs (e.g. FAST+ORB vs Harris+float runs, or CLAHE on/off) and
plots per-run feature/timing summaries side by side.

Usage: python -m zenslam_tpu_torch.analysis.plot_detector_comparison \
           --run fast_orb=output/a/frame_data.csv \
           --run harris_float=output/b/frame_data.csv \
           --output output/plots
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from zenslam_tpu_torch.analysis.style import PALETTE, apply_style, save
from zenslam_tpu_torch.analysis.plot_timing_breakdown import load_rows

METRICS = [
    ("n_tracked", "tracked / frame"),
    ("n_detected", "detected / frame"),
    ("n_triangulated", "triangulated / frame"),
    ("n_pose_inliers", "pose inliers / frame"),
    ("tracked_ratio", "KLT success ratio"),
    ("duration_total_ms", "frame time (ms)"),
]


def main(argv=None):
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser("plot_detector_comparison")
    ap.add_argument("--run", action="append", required=True,
                    help="label=path/to/frame_data.csv (repeatable)")
    ap.add_argument("--output", default="output/plots")
    args = ap.parse_args(argv)
    apply_style()
    os.makedirs(args.output, exist_ok=True)

    runs = []
    for spec in args.run:
        label, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--run wants label=path, got {spec!r}")
        runs.append((label, load_rows(path)))
    if len(runs) > 8:
        raise SystemExit("at most 8 runs (fixed categorical palette)")

    # 1. per-metric mean bars, one group per metric, one hue per run
    fig, axes = plt.subplots(2, 3, figsize=(14, 7))
    for ax, (col, title) in zip(axes.ravel(), METRICS):
        means = [np.mean([float(r[col]) for r in rows]) for _, rows in runs]
        ax.bar([lab for lab, _ in runs], means,
               color=PALETTE[: len(runs)], width=0.6)
        ax.set_title(title, fontsize=10)
        ax.tick_params(axis="x", rotation=15)
    fig.suptitle("run comparison: means over sequence")
    fig.tight_layout()
    save(fig, os.path.join(args.output, "comparison_means.png"))

    # 2. tracked-count overlay per frame (identity by run, fixed hues)
    fig, ax = plt.subplots(figsize=(12, 5))
    for i, (lab, rows) in enumerate(runs):
        ax.plot([int(r["frame"]) for r in rows],
                [int(r["n_tracked"]) for r in rows],
                label=lab, color=PALETTE[i])
    ax.set_xlabel("frame")
    ax.set_ylabel("tracked keypoints")
    ax.set_title("tracked features per frame, by run")
    ax.legend(loc="upper right")
    save(fig, os.path.join(args.output, "comparison_tracked.png"))

    # 3. frame-time overlay
    fig, ax = plt.subplots(figsize=(12, 5))
    for i, (lab, rows) in enumerate(runs):
        ax.plot([int(r["frame"]) for r in rows],
                [float(r["duration_total_ms"]) for r in rows],
                label=lab, color=PALETTE[i])
    ax.set_xlabel("frame")
    ax.set_ylabel("frame time (ms)")
    ax.set_title("frame time per frame, by run")
    ax.legend(loc="upper right")
    save(fig, os.path.join(args.output, "comparison_timing.png"))

    for lab, rows in runs:
        print(f"{lab}: {len(rows)} frames, "
              f"tracked {np.mean([int(r['n_tracked']) for r in rows]):.1f}, "
              f"{np.mean([float(r['duration_total_ms']) for r in rows]):.1f} ms/frame")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
