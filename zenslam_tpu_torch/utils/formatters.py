"""Human-readable log formatters for poses and vectors — counterpart of
``zenslam_tpu/utils/formatters.py`` (same strings). Host-side numpy only.
"""

from __future__ import annotations

import math

import numpy as np


def euler_zyx_deg(R) -> tuple[float, float, float]:
    """Intrinsic Z-Y-X (yaw, pitch, roll) Euler angles of a rotation matrix,
    in degrees."""
    R = np.asarray(R, dtype=np.float64)
    pitch = math.asin(max(-1.0, min(1.0, -R[2, 0])))
    if abs(R[2, 0]) < 1.0 - 1e-9:
        yaw = math.atan2(R[1, 0], R[0, 0])
        roll = math.atan2(R[2, 1], R[2, 2])
    else:  # gimbal lock: put everything in yaw
        yaw = math.atan2(-R[0, 1], R[1, 1])
        roll = 0.0
    d = 180.0 / math.pi
    return yaw * d, pitch * d, roll * d


def format_vec3(v, precision: int = 3) -> str:
    """`[x, y, z]` with fixed precision."""
    v = np.asarray(v, dtype=np.float64).reshape(3)
    return "[" + ", ".join(f"{x:.{precision}f}" for x in v) + "]"


def format_pose(R, t, precision: int = 3) -> str:
    """Pose as translation (m) + ZYX Euler (deg)."""
    yaw, pitch, roll = euler_zyx_deg(R)
    return (f"t={format_vec3(t, precision)} m "
            f"ypr=[{yaw:.1f}, {pitch:.1f}, {roll:.1f}]°")
