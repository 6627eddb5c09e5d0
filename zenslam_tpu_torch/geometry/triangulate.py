"""Two-view triangulation (DLT, midpoint, rectified), the triangulation
gates and the epipolar residual — counterpart of
``zenslam_tpu/geometry/triangulate.py``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from zenslam_tpu_torch.geometry.camera import StereoRig, project
from zenslam_tpu_torch.geometry.lie import se3_apply


def _projection_matrix(K, R, t):
    """P = K [R|t] for T_cam_world = (R, t)."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def _chol4_solve(A, b):
    """Explicit batched 4x4 Cholesky solve A x = b (A SPD)."""
    def a(i, j):
        return A[..., i, j]

    eps = 1e-30
    l00 = torch.sqrt(torch.clamp(a(0, 0), min=eps))
    l10 = a(1, 0) / l00
    l20 = a(2, 0) / l00
    l30 = a(3, 0) / l00
    l11 = torch.sqrt(torch.clamp(a(1, 1) - l10 * l10, min=eps))
    l21 = (a(2, 1) - l20 * l10) / l11
    l31 = (a(3, 1) - l30 * l10) / l11
    l22 = torch.sqrt(torch.clamp(a(2, 2) - l20 * l20 - l21 * l21, min=eps))
    l32 = (a(3, 2) - l30 * l20 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a(3, 3) - l30 * l30 - l31 * l31 - l32 * l32, min=eps))
    y0 = b[..., 0] / l00
    y1 = (b[..., 1] - l10 * y0) / l11
    y2 = (b[..., 2] - l20 * y0 - l21 * y1) / l22
    y3 = (b[..., 3] - l30 * y0 - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00
    return torch.stack([x0, x1, x2, x3], dim=-1)


def _smallest_eigvec_4(ATA, iters: int = 4):
    """Smallest eigenvector of batched 4x4 PSD matrices by shifted inverse
    iteration on the explicit Cholesky."""
    tr = torch.diagonal(ATA, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / 4.0, min=1e-20)[..., None, None]
    A = ATA / scale + 1e-5 * torch.eye(4, dtype=ATA.dtype, device=ATA.device)
    v = torch.full(ATA.shape[:-1], 0.5, dtype=ATA.dtype, device=ATA.device)
    for _ in range(iters):
        z = _chol4_solve(A, v)
        v = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-30)
    return v


def triangulate_dlt(K0, R0, t0, K1, R1, t1, uv0, uv1):
    """Two-view DLT triangulation, batched over points: (N,2),(N,2) -> (N,3)."""
    P0 = _projection_matrix(K0, R0, t0)
    P1 = _projection_matrix(K1, R1, t1)
    u0, v0 = uv0[..., 0:1], uv0[..., 1:2]
    u1, v1 = uv1[..., 0:1], uv1[..., 1:2]
    rows = torch.stack([
        u0 * P0[..., 2, :] - P0[..., 0, :],
        v0 * P0[..., 2, :] - P0[..., 1, :],
        u1 * P1[..., 2, :] - P1[..., 0, :],
        v1 * P1[..., 2, :] - P1[..., 1, :],
    ], dim=-2)
    rows = rows / (torch.linalg.vector_norm(rows, dim=-1, keepdim=True) + 1e-12)
    ATA = rows.transpose(-1, -2) @ rows
    X_h = _smallest_eigvec_4(ATA)
    w = X_h[..., 3]
    w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X_h[..., :3] / w_safe[..., None]


def _matvec(R, t):
    return (R @ t[..., None])[..., 0]


def triangulate_midpoint(K0, R0, t0, K1, R1, t1, uv0, uv1):
    """Midpoint of the common perpendicular between the two viewing rays."""
    K0i = torch.linalg.inv_ex(K0).inverse
    K1i = torch.linalg.inv_ex(K1).inverse
    ones = torch.ones_like(uv0[..., :1])
    d0_cam = torch.cat([uv0, ones], dim=-1) @ K0i.transpose(-1, -2)
    d1_cam = torch.cat([uv1, ones], dim=-1) @ K1i.transpose(-1, -2)
    # ray origins and directions in the world frame
    o0 = -_matvec(R0.transpose(-1, -2), t0)
    o1 = -_matvec(R1.transpose(-1, -2), t1)
    d0 = d0_cam @ R0    # R0ᵀ d0_cam, batched
    d1 = d1_cam @ R1
    d0 = d0 / (torch.linalg.vector_norm(d0, dim=-1, keepdim=True) + 1e-12)
    d1 = d1 / (torch.linalg.vector_norm(d1, dim=-1, keepdim=True) + 1e-12)
    b = o1 - o0
    d0d1 = (d0 * d1).sum(-1)
    denom = 1.0 - d0d1 * d0d1
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    bd0 = (b * d0).sum(-1)
    bd1 = (b * d1).sum(-1)
    s = (bd0 - d0d1 * bd1) / denom
    u = (d0d1 * bd0 - bd1) / denom
    p0 = o0 + s[..., None] * d0
    p1 = o1 + u[..., None] * d1
    return 0.5 * (p0 + p1)


def triangulate_rectified(fx, baseline, cx_l, cx_r, cy, fy, uv_l, uv_r):
    """Rectified stereo: depth z = fx * b / disparity, points in the LEFT
    camera frame; the principal points may differ (cx_l, cx_r)."""
    disparity = (uv_l[..., 0] - cx_l) - (uv_r[..., 0] - cx_r)
    disp_safe = torch.where(disparity.abs() < 1e-6, torch.full_like(disparity, 1e-6),
                            disparity)
    z = fx * baseline / disp_safe
    x = (uv_l[..., 0] - cx_l) / fx * z
    y = (uv_l[..., 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)


class TriangulationGates(NamedTuple):
    min_depth: float = 0.1
    max_depth: float = 50.0
    reprojection_threshold: float = 2.0
    min_parallax_deg: float = 0.25
    max_parallax_deg: float = 179.75
    min_disparity: float = 1.0


def triangulation_gates(rig: StereoRig, R_lw, t_lw, X_world, uv_l, uv_r,
                        gates: TriangulationGates = TriangulationGates()):
    """Validity mask over triangulated points: z > 0 in both cameras, left
    depth within [min_depth, max_depth], reprojection error under the
    threshold in both views, parallax between the rays from the two camera
    centres within (min, max) degrees."""
    R_rw = rig.R_rl @ R_lw
    t_rw = _matvec(rig.R_rl, t_lw) + rig.t_rl
    x_l = se3_apply(R_lw, t_lw, X_world)
    x_r = se3_apply(R_rw, t_rw, X_world)
    z_l, z_r = x_l[..., 2], x_r[..., 2]
    cheirality = (z_l > 1e-6) & (z_r > 1e-6)
    depth_ok = (z_l >= gates.min_depth) & (z_l <= gates.max_depth)
    err_l = torch.linalg.vector_norm(project(rig.left, x_l) - uv_l, dim=-1)
    err_r = torch.linalg.vector_norm(project(rig.right, x_r) - uv_r, dim=-1)
    reproj_ok = (err_l < gates.reprojection_threshold) & (err_r < gates.reprojection_threshold)
    c_l = -_matvec(R_lw.transpose(-1, -2), t_lw)
    c_r = -_matvec(R_rw.transpose(-1, -2), t_rw)
    r0 = X_world - c_l
    r1 = X_world - c_r
    cos_a = (r0 * r1).sum(-1) / (torch.linalg.vector_norm(r0, dim=-1)
                                 * torch.linalg.vector_norm(r1, dim=-1) + 1e-12)
    ang = torch.arccos(torch.clamp(cos_a, -1.0, 1.0)) * (180.0 / math.pi)
    parallax_ok = (ang > gates.min_parallax_deg) & (ang < gates.max_parallax_deg)
    return cheirality & depth_ok & reproj_ok & parallax_ok


def epipolar_residual(F, uv_l, uv_r):
    """Symmetric point-to-epipolar-line distance."""
    ones = torch.ones_like(uv_l[..., :1])
    pl = torch.cat([uv_l, ones], dim=-1)
    pr = torch.cat([uv_r, ones], dim=-1)
    l_r = pl @ F.T
    l_l = pr @ F
    num = (pr * l_r).sum(-1).abs()
    d_r = num / (torch.linalg.vector_norm(l_r[..., :2], dim=-1) + 1e-12)
    d_l = num / (torch.linalg.vector_norm(l_l[..., :2], dim=-1) + 1e-12)
    return 0.5 * (d_r + d_l)
