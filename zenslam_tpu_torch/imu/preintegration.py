"""SO(3)-manifold IMU preintegration with 9x9 covariance — counterpart of
``zenslam_tpu/imu/preintegration.py``.

State order in the covariance: [δθ (3), δv (3), δp (3)]; per sample k the
reference's scan applies

  ΔR_{k+1} = ΔR_k Exp((ω_k - b_g) dt_k)
  Δv_{k+1} = Δv_k + ΔR_k (a_k - b_a) dt_k
  Δp_{k+1} = Δp_k + Δv_k dt_k + ½ ΔR_k (a_k - b_a) dt_k²
  Σ_{k+1}  = A_k Σ_k A_kᵀ + B_k Q_k B_kᵀ

and the five bias-Jacobian recurrences. An eager loop over the S padded
samples would launch ~80 small kernels a sample. Here every recurrence is
solved over all S samples at once, so one call launches about a hundred
kernels whatever S is:

- ΔR_k is a prefix product of the per-sample rotations (a log2 S-step
  Hillis-Steele scan of batched 3x3 products); Δv, Δp and the accel-bias
  Jacobians are prefix sums of terms that depend on ΔR_k only;
- ∂Log(ΔR)/∂b_g obeys X_{k+1} = Exp(ω dt)ᵀ X_k + c_k, whose solution is
  X_k = ΔR_kᵀ Σ_{j<k} ΔR_{j+1} c_j (rotations are orthonormal), so it too is
  a prefix sum, and the gyro-bias Jacobians of Δv and Δp follow from it;
- Σ_S = Σ_k Φ_k B_k Q_k B_kᵀ Φ_kᵀ with Φ_k = A_{S-1} ⋯ A_{k+1}, a suffix
  product of the 9x9 transitions (the same scan, reversed).

A masked row has dt = 0 and zeroed rates, so its rotation is exactly I, its
transition exactly I and its noise term exactly 0: it leaves every field
untouched, as the reference's ``where`` does. ``Q / max(dt, 1e-6)`` keeps
the reference's order of operations, so masked rows give 0 · (finite).
Products and sums are taken in another order than the scan's: results agree
with the reference to float32 rounding (tests/test_torch_imu.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.geometry.lie import so3_exp, so3_hat, so3_left_jacobian
from zenslam_tpu_torch.utils.graphs import Program


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (Kalibr/Allan convention)."""

    gyro_noise: float = 1.6e-4       # rad/s/√Hz
    accel_noise: float = 2.8e-3      # m/s²/√Hz
    gyro_bias_walk: float = 1.9e-5   # rad/s²/√Hz
    accel_bias_walk: float = 8.6e-4  # m/s³/√Hz


class ImuIntegral(NamedTuple):
    dR: torch.Tensor        # (3,3) rotation delta (body frame k -> k+N)
    dv: torch.Tensor        # (3,)
    dp: torch.Tensor        # (3,)
    dt: torch.Tensor        # () total time
    dt2_half: torch.Tensor  # () ∫∫ 1
    cov: torch.Tensor       # (9,9) [δθ, δv, δp]
    dR_dbg: torch.Tensor    # (3,3) ∂Log(ΔR)/∂b_g
    dv_dbg: torch.Tensor    # (3,3)
    dv_dba: torch.Tensor    # (3,3)
    dp_dbg: torch.Tensor    # (3,3)
    dp_dba: torch.Tensor    # (3,3)


def identity_integral(device=None) -> ImuIntegral:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return ImuIntegral(dR=torch.eye(3, dtype=torch.float32, device=device), dv=z(3), dp=z(3),
                       dt=z(), dt2_half=z(), cov=z(9, 9), dR_dbg=z(3, 3), dv_dbg=z(3, 3),
                       dv_dba=z(3, 3), dp_dbg=z(3, 3), dp_dba=z(3, 3))


def prefix_products(M):
    """Inclusive ordered products out[k] = M[0] @ M[1] @ ... @ M[k] over the
    leading dim, in ceil(log2 S) batched matmuls."""
    out, d = M, 1
    while d < M.shape[0]:
        out = torch.cat([out[:d], out[:-d] @ out[d:]])
        d *= 2
    return out


def _cumsum(x):
    """(exclusive prefix sums, total) over the leading dim."""
    c = torch.cumsum(x, 0)
    return torch.cat([torch.zeros_like(x[:1]), c[:-1]]), c[-1]


@functools.partial(Program, copy_outputs=True)
def preintegrate(gyro, accel, dts, mask, noise: ImuNoise = ImuNoise(),
                 bias_gyro=None, bias_accel=None) -> ImuIntegral:
    """Integrate one interval of S masked IMU samples: gyro (S, 3) rad/s,
    accel (S, 3) m/s², dts (S,) s, mask (S,) bool (padding rows False).
    A captured program: ``noise`` (floats) is keyed by value."""
    dev, f32 = gyro.device, torch.float32
    if bias_gyro is None:
        bias_gyro = torch.zeros(3, dtype=f32, device=dev)
    if bias_accel is None:
        bias_accel = torch.zeros(3, dtype=f32, device=dev)
    m = mask.to(torch.bool)
    dt = torch.where(m, dts.to(f32), 0.0)
    w = torch.where(m[:, None], gyro - bias_gyro, 0.0)
    a = torch.where(m[:, None], accel - bias_accel, 0.0)
    d1, d2 = dt[:, None], dt[:, None, None]
    eye = torch.eye(3, dtype=f32, device=dev)

    # ---- rotation: per-sample steps, their prefix products ----------------
    R_step = so3_exp(w * d1)
    Jr = so3_left_jacobian(-w * d1)       # right Jacobian of Exp(w dt)
    R_incl = prefix_products(R_step)       # ΔR_{k+1}
    R = torch.cat([eye[None], R_incl[:-1]])  # ΔR_k
    Ra_hat = R @ so3_hat(a)                # ΔR_k [a_k]x
    dRa = (R @ a[..., None])[..., 0]       # ΔR_k a_k

    # ---- velocity, position, time -----------------------------------------
    v, dv = _cumsum(dRa * d1)
    _, dp = _cumsum(v * d1 + 0.5 * dRa * d1 * d1)
    t, dt_tot = _cumsum(dt)
    _, dt2_half = _cumsum(t * dt + 0.5 * dt * dt)

    # ---- bias Jacobians -----------------------------------------------------
    D_ex, D = _cumsum(R_incl @ (-Jr * d2))
    X = R.transpose(-1, -2) @ D_ex         # ∂Log(ΔR_k)/∂b_g
    e = -(Ra_hat @ X) * d2
    v_bg, dv_dbg = _cumsum(e)
    _, dp_dbg = _cumsum(v_bg * d2 - 0.5 * (Ra_hat @ X) * d2 * d2)
    v_ba, dv_dba = _cumsum(-R * d2)
    _, dp_dba = _cumsum(v_ba * d2 - 0.5 * R * d2 * d2)

    # ---- covariance: Σ_S = Σ_k Φ_k B_k Q_k B_kᵀ Φ_kᵀ ------------------------
    S = gyro.shape[0]
    A = torch.zeros((S, 9, 9), dtype=f32, device=dev)
    A[:, 0:3, 0:3] = R_step.transpose(-1, -2)
    A[:, 3:6, 0:3] = -Ra_hat * d2
    A[:, 3:6, 3:6] = eye
    A[:, 6:9, 0:3] = -0.5 * Ra_hat * d2 * d2
    A[:, 6:9, 3:6] = eye * d2
    A[:, 6:9, 6:9] = eye
    B = torch.zeros((S, 9, 6), dtype=f32, device=dev)
    B[:, 0:3, 0:3] = Jr * d2
    B[:, 3:6, 3:6] = R * d2
    B[:, 6:9, 3:6] = 0.5 * R * d2 * d2
    q = torch.cat([torch.full((3,), noise.gyro_noise ** 2, dtype=f32, device=dev),
                   torch.full((3,), noise.accel_noise ** 2, dtype=f32, device=dev)])
    q = q / torch.clamp(dt, min=1e-6)[:, None]   # discrete: sigma²/dt · dt² = sigma² dt
    N = torch.where(m[:, None, None], (B * q[:, None, :]) @ B.transpose(-1, -2), 0.0)
    suffix = prefix_products(A.flip(0))          # [j] = A_{S-1} ⋯ A_{S-1-j}
    Phi = torch.cat([suffix[:-1].flip(0), torch.eye(9, dtype=f32, device=dev)[None]])
    cov = (Phi @ N @ Phi.transpose(-1, -2)).sum(0)

    return ImuIntegral(dR=R_incl[-1], dv=dv, dp=dp, dt=dt_tot, dt2_half=dt2_half, cov=cov,
                       dR_dbg=R_incl[-1].T @ D, dv_dbg=dv_dbg, dv_dba=dv_dba,
                       dp_dbg=dp_dbg, dp_dba=dp_dba)
