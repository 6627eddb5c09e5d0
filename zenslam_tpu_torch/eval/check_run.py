"""Check an app run against an expected-metrics file — the port's
counterpart of ``scripts/check_euroc_run.py``.

    python -m zenslam_tpu_torch.eval.check_run OUTPUT_DIR \\
        [--expected options/euroc_mh_expected.json] [--groundtruth PATH]

Reads the output directory of ``python -m zenslam_tpu_torch.app`` and exits
0 (pass) or 1 (fail). Checks:

- ATE and RPE of ``trajectory.csv`` against the groundtruth CSV (default:
  ``folder.groundtruth_file`` of the run's ``effective_options.yaml``)
  against ``ate_bound_mm`` / ``rpe_bound_mm``;
- the mean tracked features of ``frame_data.csv`` against
  ``min_tracked_mean``;
- the problem-frame share (low KLT, few triangulations, few inliers) against
  ``max_problem_frame_fraction``.

It reports the steady ms/frame and fps (median of ``duration_total_ms``
after the first 10 frames) beside the card's name and power limit, and
enforces no fps floor: the expected file's ``min_fps_tpu`` is another
device's number. For the same reason slow frames are reported and not
counted as problem frames.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

DEFAULT_EXPECTED = Path(__file__).resolve().parents[2] / "options" / "euroc_mh_expected.json"


def load_trajectory(path: str):
    """(timestamps (T,), camera centres (T, 3)) of a trajectory.csv."""
    ts, pos = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = [float(x) for x in line.split(",")]
            ts.append(parts[0])
            pos.append(parts[1:4])
    return np.asarray(ts), np.asarray(pos)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, or a note
    that this machine has no NVIDIA card."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except FileNotFoundError:
        return "no NVIDIA card (nvidia-smi not found)"
    if smi.returncode != 0 or not smi.stdout.strip():
        return "no NVIDIA card (nvidia-smi failed)"
    return smi.stdout.strip().splitlines()[0]


def check(output_dir: str, expected: str = str(DEFAULT_EXPECTED), groundtruth: str = "") -> dict:
    """The run's metrics and the list of failed checks."""
    from zenslam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
    from zenslam_tpu_torch.io.dataset import Groundtruth
    from zenslam_tpu_torch.io.telemetry import analyze_frame_stats

    with open(expected) as f:
        exp = json.load(f)
    out = {"failures": []}
    fail = out["failures"]
    gt_path = groundtruth
    eff = os.path.join(output_dir, "effective_options.yaml")
    if not gt_path and os.path.exists(eff):
        import yaml

        with open(eff) as f:
            gt_path = ((yaml.safe_load(f) or {}).get("folder") or {}).get("groundtruth_file", "")
    traj_path = os.path.join(output_dir, "trajectory.csv")
    if not os.path.exists(traj_path):
        fail.append(f"no trajectory.csv in {output_dir}")
        return out
    ts, est = load_trajectory(traj_path)
    if gt_path and os.path.exists(gt_path):
        gt = Groundtruth(gt_path)
        gt_pos = np.stack([gt.pose_at(t)[1] for t in ts])
        out["ate_mm"] = ate_rmse(est, gt_pos) * 1000.0
        out["rpe_mm"] = rpe_rmse(est, gt_pos) * 1000.0
        if out["ate_mm"] > exp["ate_bound_mm"]:
            fail.append(f"ATE {out['ate_mm']:.1f} mm > {exp['ate_bound_mm']} mm")
        if out["rpe_mm"] > exp["rpe_bound_mm"]:
            fail.append(f"RPE {out['rpe_mm']:.1f} mm > {exp['rpe_bound_mm']} mm")
    else:
        fail.append(f"no groundtruth available (looked for {gt_path!r})")
    csv_path = os.path.join(output_dir, "frame_data.csv")
    if not os.path.exists(csv_path):
        fail.append("no frame_data.csv")
        return out
    stats = analyze_frame_stats(csv_path, slow_ms=float("inf"))
    out.update(n_frames=stats["n_frames"], mean_tracked=stats["mean_tracked"],
               problem_fraction=stats["problem_fraction"])
    if stats["mean_tracked"] < exp["min_tracked_mean"]:
        fail.append(f"mean tracked {stats['mean_tracked']:.0f} < {exp['min_tracked_mean']}")
    if stats["problem_fraction"] > exp["max_problem_frame_fraction"]:
        fail.append(f"problem fraction {stats['problem_fraction']:.2f} > "
                    f"{exp['max_problem_frame_fraction']}")
    with open(csv_path, newline="") as f:
        total = [float(r["duration_total_ms"]) for r in csv.DictReader(f)]
    steady = total[10:]
    if steady:
        out["steady_ms"] = float(np.median(steady))
        out["steady_fps"] = 1000.0 / max(out["steady_ms"], 1e-9)
        out["slow_frames"] = int(sum(t > 100.0 for t in total))
    out["exp"] = exp
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("zenslam_tpu_torch.eval.check_run",
                                 description="check an app run against expected metrics")
    ap.add_argument("output_dir")
    ap.add_argument("--expected", default=str(DEFAULT_EXPECTED))
    ap.add_argument("--groundtruth", default="",
                    help="groundtruth CSV (default: folder.groundtruth_file of the run's "
                         "effective_options.yaml)")
    args = ap.parse_args(argv)
    r = check(args.output_dir, args.expected, args.groundtruth)
    exp = r.get("exp", {})
    if "ate_mm" in r:
        print(f"ATE {r['ate_mm']:.1f} mm (bound {exp['ate_bound_mm']}) ; "
              f"RPE {r['rpe_mm']:.1f} mm (bound {exp['rpe_bound_mm']})")
    if "mean_tracked" in r:
        print(f"frames {r['n_frames']}, mean tracked {r['mean_tracked']:.0f} "
              f"(min {exp['min_tracked_mean']}), problem fraction "
              f"{r['problem_fraction']:.2f} (max {exp['max_problem_frame_fraction']})")
    if "steady_ms" in r:
        print(f"steady {r['steady_ms']:.2f} ms/frame, {r['steady_fps']:.1f} fps "
              f"({r['slow_frames']} frames over 100 ms; no fps floor enforced) on: "
              f"{card_line()}")
    if r["failures"]:
        print("FAIL:")
        for f in r["failures"]:
            print(f"  - {f}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
