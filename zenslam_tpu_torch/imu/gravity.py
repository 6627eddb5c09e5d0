"""Online gravity estimation from VO-vs-IMU acceleration residuals —
counterpart of ``zenslam_tpu/imu/gravity.py``: a central-difference
acceleration from three body positions against the mean measured specific
force rotated into the world, a 6-15 m/s² magnitude gate, and the
component-wise median over >= 10 accepted samples of a fixed-capacity ring.

The slot write is a mask, not a branch, and the median is the reference's
masked sort (invalid rows pushed to +inf) averaging its two middle values
(``torch.median`` would return the lower one): neither reads the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.utils.graphs import Program


class GravityEstimator(NamedTuple):
    samples: torch.Tensor    # (C, 3) candidate gravity vectors
    valid: torch.Tensor      # (C,) bool
    next_slot: torch.Tensor  # () int32
    min_samples: int = 10


def gravity_init(capacity: int = 64, device=None) -> GravityEstimator:
    return GravityEstimator(
        samples=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        next_slot=torch.zeros((), dtype=torch.int32, device=device))


@functools.partial(Program, scalar_argnames=("dt01", "dt12"), copy_outputs=True)
def gravity_add_sample(est: GravityEstimator, p0, p1, p2, dt01, dt12, R_wb1,
                       mean_accel_body) -> GravityEstimator:
    """Add one sample from three consecutive body positions (world frame) and
    the mean measured body acceleration over the interval; ``dt01``/``dt12``
    may be floats or 0-d tensors.
    A captured program: ``dt01`` and ``dt12`` are traced (a Python float goes up as a float32
    device scalar, the value this function makes of it)."""
    dt01 = torch.as_tensor(dt01, dtype=torch.float32, device=p0.device)
    dt12 = torch.as_tensor(dt12, dtype=torch.float32, device=p0.device)
    v01 = (p1 - p0) / torch.clamp(dt01, min=1e-6)
    v12 = (p2 - p1) / torch.clamp(dt12, min=1e-6)
    a_vo = (v12 - v01) / torch.clamp(0.5 * (dt01 + dt12), min=1e-6)
    # the accelerometer measures f = a - g, so g = a_vo - R_wb f
    g_sample = a_vo - R_wb1 @ mean_accel_body
    mag = torch.linalg.vector_norm(g_sample)
    ok = (mag > 6.0) & (mag < 15.0)
    s = est.next_slot
    C = est.samples.shape[0]
    put = ok & (torch.arange(C, device=s.device) == s)
    return est._replace(
        samples=torch.where(put[:, None], g_sample, est.samples),
        valid=est.valid | put,
        next_slot=torch.where(ok, (s + 1) % C, s).to(torch.int32))


@functools.partial(Program, copy_outputs=True)
def gravity_estimate(est: GravityEstimator):
    """Component-wise median over accepted samples: (g (3,), ok () bool)."""
    n = est.valid.sum()
    ok = n >= est.min_samples
    C = est.samples.shape[0]
    srt = torch.sort(torch.where(est.valid[:, None], est.samples, float("inf")), dim=0).values
    mid = torch.clamp(n - 1, min=0) // 2
    lo = srt.index_select(0, mid.reshape(1))[0]
    hi = srt.index_select(0, torch.clamp(n - 1 - mid, 0, C - 1).reshape(1))[0]
    g = 0.5 * (lo + hi)
    return torch.where(torch.isfinite(g), g, 0.0), ok
