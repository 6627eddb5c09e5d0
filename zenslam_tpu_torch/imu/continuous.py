"""Continuous-time IMU preintegration backends, LPM and UGPM-grade —
counterpart of ``zenslam_tpu/imu/continuous.py``.

Both resample the samples onto a uniform midpoint grid over [t0, t1] and run
the same manifold integration (``preintegration.preintegrate``) on it:

- LPM: masked linear interpolation (a sort, ``searchsorted`` and a gather);
- UGPM-grade: the per-channel GP posterior mean (RBF kernel, fixed
  hyperparameters from the data) over the samples, one (S, S) Cholesky
  solve. ``cholesky_ex`` is used because ``torch.linalg.cholesky`` reads its
  error flag back to the host; the masked rows are identity rows, so the
  matrix is positive definite by construction.
"""

from __future__ import annotations

import functools

import torch

from zenslam_tpu_torch.imu.preintegration import ImuIntegral, ImuNoise, preintegrate
from zenslam_tpu_torch.utils.graphs import Program


def _sorted_valid(ts, vals, mask):
    """Sort samples by time with masked rows pushed to the end (1e18)."""
    ts_m = torch.where(mask, ts, 1e18)
    order = torch.argsort(ts_m, stable=True)
    return ts_m[order], vals[order], mask[order]


def interp_masked(ts, vals, mask, grid):
    """Masked linear interpolation of (T, C) channel samples at (G,) grid
    times; clamps to the nearest valid sample outside the support."""
    ts_s, vals_s, _ = _sorted_valid(ts, vals, mask)
    n_valid = torch.clamp(mask.sum(), min=2)
    hi = torch.minimum(torch.clamp(torch.searchsorted(ts_s, grid), min=1), n_valid - 1)
    lo = hi - 1
    t_lo, t_hi = ts_s[lo], ts_s[hi]
    frac = torch.clamp((grid - t_lo) / torch.clamp(t_hi - t_lo, min=1e-9), 0.0, 1.0)
    return vals_s[lo] + frac[:, None] * (vals_s[hi] - vals_s[lo])


def gp_posterior_mean(ts, vals, mask, grid, lengthscale, signal_sd, noise_sd):
    """Per-channel GP posterior mean (RBF kernel, constant prior mean) of
    (T, C) samples at (G,) grid times. Masked rows contribute nothing
    (identity rows in K, zero targets, zero cross-kernel)."""
    mu = torch.where(mask[:, None], vals, 0.0).sum(0) / torch.clamp(mask.sum(), min=1)
    y = torch.where(mask[:, None], vals - mu, 0.0)
    d = (ts[:, None] - ts[None, :]) / lengthscale
    K = signal_sd ** 2 * torch.exp(-0.5 * d * d)
    both = mask[:, None] & mask[None, :]
    K = torch.where(both, K, 0.0)
    diag = torch.where(mask, signal_sd ** 2 + noise_sd ** 2, 1.0)
    eye = torch.eye(ts.shape[0], dtype=torch.bool, device=ts.device)
    K = K + torch.diag_embed(diag) - torch.where(eye, torch.where(both, K, 0.0), 0.0)
    L, _ = torch.linalg.cholesky_ex(K)
    alpha = torch.cholesky_solve(y, L)                       # (T, C)
    dg = (grid[:, None] - ts[None, :]) / lengthscale
    Kx = torch.where(mask[None, :], signal_sd ** 2 * torch.exp(-0.5 * dg * dg), 0.0)
    return mu + Kx @ alpha


@functools.partial(Program, static_argnames=("n_grid", "method"), scalar_argnames=("t0", "t1"),
                   copy_outputs=True)
def preintegrate_continuous(ts, gyro, accel, mask, t0, t1, n_grid: int = 64,
                            method: str = "lpm", noise: ImuNoise = ImuNoise(),
                            bias_gyro=None, bias_accel=None,
                            gp_lengthscale=None) -> ImuIntegral:
    """Continuous-time preintegration of [t0, t1] from (overlap-windowed)
    samples: ts (T,) in any order, gyro/accel (T, 3), mask (T,); t0/t1
    floats or 0-d tensors. Same return contract as ``preintegrate``.
    A captured program: ``t0`` and ``t1`` are traced (a Python float goes up as a float32
    device scalar, the value this function makes of it); ``noise`` and ``gp_lengthscale`` are
    keyed by value."""
    f32, dev = torch.float32, ts.device
    t0 = torch.as_tensor(t0, dtype=f32, device=dev)
    t1 = torch.as_tensor(t1, dtype=f32, device=dev)
    dtg = torch.clamp(t1 - t0, min=1e-6) / n_grid
    grid = t0 + (torch.arange(n_grid, dtype=f32, device=dev) + 0.5) * dtg
    if method == "lpm":
        w = interp_masked(ts, gyro, mask, grid)
        a = interp_masked(ts, accel, mask, grid)
    elif method == "ugpm":
        n_valid = torch.clamp(mask.sum(), min=2).to(f32)
        t_span = (torch.where(mask, ts, float("-inf")).max()
                  - torch.where(mask, ts, float("inf")).min())
        ls = (torch.full((), gp_lengthscale, dtype=f32, device=dev)
              if gp_lengthscale is not None else 3.0 * t_span / n_valid)
        ls = torch.clamp(ls, min=1e-4)
        rate = n_valid / torch.clamp(t_span, min=1e-6)
        w_sd = torch.clamp(torch.where(mask[:, None], gyro, 0.0).std(correction=0), min=1e-3)
        a_sd = torch.clamp(torch.where(mask[:, None], accel, 0.0).std(correction=0), min=1e-2)
        w = gp_posterior_mean(ts, gyro, mask, grid, ls, w_sd, noise.gyro_noise * torch.sqrt(rate))
        a = gp_posterior_mean(ts, accel, mask, grid, ls, a_sd,
                              noise.accel_noise * torch.sqrt(rate))
    else:
        raise ValueError(f"unknown method {method!r} (lpm | ugpm)")
    return preintegrate(w, a, dtg.expand(n_grid), torch.ones(n_grid, dtype=torch.bool, device=dev),
                        noise, bias_gyro, bias_accel)


def overlap_window_mask(ts, mask, t0, t1, overlap_factor: float = 8.0):
    """Keep samples within [t0 - f*(t1-t0), t1 + f*(t1-t0)] for the
    continuous-time fit."""
    period = t1 - t0
    return mask & (ts >= t0 - overlap_factor * period) & (ts <= t1 + overlap_factor * period)
