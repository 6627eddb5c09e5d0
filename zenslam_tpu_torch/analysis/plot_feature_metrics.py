"""Feature-quality plots over the per-frame telemetry CSV — the port's
own copy of ``zenslam_tpu/analysis/plot_feature_metrics.py`` (tracked /
detected / matched / triangulated counts, KLT success ratio, inlier trend,
map growth).

Usage: python -m zenslam_tpu_torch.analysis.plot_feature_metrics \
           --csv output/frame_data.csv --output output/plots
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from zenslam_tpu_torch.analysis.style import PALETTE, apply_style, save
from zenslam_tpu_torch.analysis.plot_timing_breakdown import load_rows

COUNT_COLS = ["n_tracked", "n_detected", "n_stereo", "n_triangulated",
              "n_pose_inliers"]
COUNT_LABELS = ["tracked", "detected", "stereo", "triangulated",
                "pose inliers"]


def main(argv=None):
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser("plot_feature_metrics")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--output", default="output/plots")
    args = ap.parse_args(argv)
    apply_style()
    os.makedirs(args.output, exist_ok=True)

    rows = load_rows(args.csv)
    frames = np.asarray([int(r["frame"]) for r in rows])

    # 1. feature counts per frame (fixed hue order, one line per series)
    fig, ax = plt.subplots(figsize=(12, 5))
    for i, (c, lab) in enumerate(zip(COUNT_COLS, COUNT_LABELS)):
        ax.plot(frames, [int(r[c]) for r in rows], label=lab,
                color=PALETTE[i])
    ax.set_xlabel("frame")
    ax.set_ylabel("count")
    ax.set_title("feature counts per frame")
    ax.legend(loc="upper right", ncols=2)
    save(fig, os.path.join(args.output, "feature_counts.png"))

    # 2. KLT success ratio + keyframe markers
    ratio = np.asarray([float(r["tracked_ratio"]) for r in rows])
    is_kf = np.asarray([r["is_keyframe"] == "True" for r in rows])
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(frames, ratio, color=PALETTE[0], label="tracked ratio")
    if is_kf.any():
        ax.scatter(frames[is_kf], ratio[is_kf], color=PALETTE[1], s=24,
                   zorder=3, label="keyframe")
    ax.axhline(0.5, color=PALETTE[7], linewidth=1.2, linestyle="--",
               label="problem threshold")
    ax.set_ylim(0, 1.05)
    ax.set_xlabel("frame")
    ax.set_ylabel("KLT success ratio")
    ax.set_title("tracking quality")
    ax.legend(loc="lower right")
    save(fig, os.path.join(args.output, "feature_quality.png"))

    # 3. map growth + pose method usage
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(frames, [int(r["map_size"]) for r in rows], color=PALETTE[2],
            label="landmarks in map")
    ax.set_xlabel("frame")
    ax.set_ylabel("landmarks")
    ax.set_title("map growth")
    ax.legend(loc="lower right")
    save(fig, os.path.join(args.output, "feature_map_growth.png"))

    methods = np.asarray([int(r["pose_method"]) for r in rows])
    names = ["pnp cam0", "pnp cam1", "rigid 3d3d", "essential", "fallback"]
    counts = [int((methods == m).sum()) for m in range(5)]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(names, counts, color=PALETTE[: len(names)], width=0.66)
    ax.set_ylabel("frames")
    ax.set_title("pose-estimation method usage")
    save(fig, os.path.join(args.output, "feature_pose_methods.png"))

    print(f"frames {len(rows)}  mean tracked "
          f"{np.mean([int(r['n_tracked']) for r in rows]):.1f}  "
          f"mean ratio {ratio.mean():.3f}  keyframes {int(is_kf.sum())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
