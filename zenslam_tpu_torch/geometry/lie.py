"""SO(3)/SE(3) operations on tensors, batched over leading dims.

Counterpart of ``zenslam_tpu/geometry/lie.py`` (what the per-frame step and
the back end call). Rotations are (..., 3, 3); translations (..., 3).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def so3_hat(w):
    """3-vector -> skew-symmetric matrix. Batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x):
    small = x.abs() < 1e-5
    return torch.where(small, 1.0 - x * x / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def so3_exp(w):
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = so3_hat(w)
    W2 = W @ W
    a = _sinc(theta)
    b = torch.where(theta2 < 1e-10, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (angle in [0, pi])."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    w_generic = so3_vee(R - R.transpose(-1, -2))
    small = theta < 1e-4
    scale_generic = torch.where(
        small, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t) + _EPS))
    near_pi = theta > math.pi - 1e-3
    A = 0.5 * (R + R.transpose(-1, -2))
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS),
        min=0.0)
    axis = torch.sqrt(axis_sq)
    k = torch.argmax(axis, dim=-1)
    offdiag = torch.stack([A[..., 0, 1] + A[..., 1, 0],
                           A[..., 0, 2] + A[..., 2, 0],
                           A[..., 1, 2] + A[..., 2, 1]], dim=-1)
    sgn = torch.sign(offdiag)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    sxy, sxz, syz = sgn[..., 0], sgn[..., 1], sgn[..., 2]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    branches = torch.stack([
        torch.stack([ax, ay * sxy, az * sxz], dim=-1),
        torch.stack([ax * sxy, ay, az * syz], dim=-1),
        torch.stack([ax * sxz, ay * syz, az], dim=-1),
    ], dim=-2)  # (..., 3 branches, 3)
    signed = torch.gather(
        branches, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    w_pi = signed * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, scale_generic[..., None] * w_generic)


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): so3_exp(w + dw) ~ so3_exp(J_l dw) so3_exp(w)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = so3_hat(w)
    W2 = W @ W
    b = torch.where(theta2 < 1e-10, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(theta2 < 1e-10, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def so3_left_jacobian_inv(w):
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = so3_hat(w)
    W2 = W @ W
    half = 0.5 * theta
    cot = torch.where(
        theta2 < 1e-10, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS * _EPS))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - 0.5 * W + cot[..., None, None] * W2


def se3_exp(xi):
    """6-vector [rho, phi] -> (R, t) with t = J_l(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)


def se3_log(R, t):
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, x):
    """Apply (R, t) to points x (..., 3); R/t broadcast against x."""
    return torch.einsum("...ij,...j->...i", R, x) + t


def so3_orthonormalize(R):
    """Project a near-rotation onto SO(3): two Newton steps of
    R ← R·(3I − RᵀR)/2 (see the reference for why this is load-bearing)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return R


def rotation_angle(R):
    """Rotation angle in radians of a rotation matrix."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def se3_identity(dtype=torch.float32, device=None):
    return torch.eye(3, dtype=dtype, device=device), torch.zeros(3, dtype=dtype, device=device)


def quat_to_rotmat(q):
    """Quaternion (w, x, y, z) -> rotation matrix. Normalizes the input."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rotmat_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z) with w >= 0 (Shepperd's
    method, branch-free: the candidate of the largest pivot)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    k = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(cands, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.sign(q[..., :1] + _EPS)


def quat_slerp(q0, q1, alpha):
    """Spherical linear interpolation, alpha in [0, 1]; handles the double
    cover (q1 flipped into q0's hemisphere)."""
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs()
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    safe = torch.where(sin_t < 1e-6, torch.ones_like(sin_t), sin_t)
    lerp = (1 - alpha) * q0 + alpha * q1
    slerp = torch.sin((1 - alpha) * theta) / safe * q0 + torch.sin(alpha * theta) / safe * q1
    out = torch.where(sin_t < 1e-6, lerp, slerp)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)
