"""Per-frame CSV telemetry writer and problem-frame analysis — counterpart
of ``zenslam_tpu/io/telemetry.py``, with the same header and columns.

``TelemetryWriter`` takes the host telemetry ``process_frame`` returns (numpy
values); ``analyze_frame_stats`` flags low-KLT, slow, low-triangulation and
low-inlier frames.
"""

from __future__ import annotations

import csv
import numpy as np

COLUMNS = [
    "frame", "timestamp",
    "n_tracked", "n_detected", "n_stereo", "n_triangulated",
    "n_pose_inliers", "pose_method", "pose_ok", "tracked_ratio",
    "is_keyframe", "map_size",
    "n_lines", "n_line_triangulated", "line_map_size",
    "tx", "ty", "tz", "r00", "r01", "r02", "r10", "r11", "r12",
    "r20", "r21", "r22",
    # per-phase durations: wait (frame fetch and decode), step (the
    # per-frame step), backend (BA and loop closure on keyframes), total
    "duration_wait_ms", "duration_step_ms", "duration_backend_ms",
    "duration_total_ms",
]


class TelemetryWriter:
    """Streaming CSV writer, one row per frame."""

    def __init__(self, path: str):
        self._f = open(path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(COLUMNS)
        self._n = 0

    def write(self, tel, timestamp: float = 0.0, duration_ms: float = 0.0,
              wait_ms: float = 0.0, step_ms: float = 0.0,
              backend_ms: float = 0.0):
        R = np.asarray(tel.R_cw).reshape(-1)
        t = np.asarray(tel.t_cw)
        row = [
            self._n, timestamp,
            int(tel.n_tracked), int(tel.n_detected), int(tel.n_stereo),
            int(tel.n_triangulated), int(tel.n_pose_inliers),
            int(tel.pose_method), bool(tel.pose_ok), float(tel.tracked_ratio),
            bool(tel.is_keyframe), int(tel.map_size),
            int(getattr(tel, "n_lines", 0)),
            int(getattr(tel, "n_line_triangulated", 0)),
            int(getattr(tel, "line_map_size", 0)),
            *[float(x) for x in t], *[float(x) for x in R],
            wait_ms, step_ms, backend_ms,
            duration_ms,
        ]
        self._w.writerow(row)
        self._n += 1

    def close(self):
        self._f.close()


def analyze_frame_stats(csv_path: str, klt_ratio_threshold: float = 0.5,
                        slow_ms: float = 100.0, min_triangulated: int = 10,
                        min_inliers: int = 15) -> dict:
    """Problem-frame detection: flags frames with low KLT success, slow
    processing, few triangulations, or few inliers."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    problems = {"low_klt": [], "slow": [], "low_tri": [], "low_inlier": []}
    for r in rows:
        i = int(r["frame"])
        if float(r["tracked_ratio"]) < klt_ratio_threshold:
            problems["low_klt"].append(i)
        if float(r["duration_total_ms"]) > slow_ms:
            problems["slow"].append(i)
        if int(r["n_triangulated"]) < min_triangulated:
            problems["low_tri"].append(i)
        if int(r["n_pose_inliers"]) < min_inliers:
            problems["low_inlier"].append(i)
    n = max(len(rows), 1)
    problem_frames = set().union(*problems.values())
    return {
        "n_frames": len(rows),
        "problems": problems,
        "problem_fraction": len(problem_frames) / n,
        "mean_tracked": float(np.mean([int(r["n_tracked"]) for r in rows])) if rows else 0.0,
        "mean_triangulated": float(np.mean([int(r["n_triangulated"]) for r in rows])) if rows else 0.0,
    }
