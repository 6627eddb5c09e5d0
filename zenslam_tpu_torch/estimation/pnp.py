"""Perspective-n-Point: batched 6-point DLT hypotheses + RANSAC + Huber
Gauss-Newton polish — counterpart of ``zenslam_tpu/estimation/pnp.py``.

``solve_pnp_ransac`` solves a batch of problems at once (leading dim P):
the cascade runs the cam0 and cam1 problems together, as the reference
vmaps them.
"""

from __future__ import annotations

import functools

import torch

from zenslam_tpu_torch.estimation.ransac import gather_rows, ransac_sample_indices
from zenslam_tpu_torch.geometry.lie import so3_exp, so3_hat, so3_orthonormalize
from zenslam_tpu_torch.geometry.polar import inv_spd, polar_so3, solve_spd
from zenslam_tpu_torch.utils.graphs import Program


def normalize_pixels(K, uv):
    """Pixels (..., n, 2) -> normalised coordinates; K (..., 3, 3)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def _smallest_eigvec_12(ATA):
    """Smallest eigenvector of (…,12,12) PSD matrices: shifted inverse
    iteration on the unrolled-Cholesky inverse, 6 steps."""
    tr = torch.diagonal(ATA, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr / 12.0, min=1e-20)[..., None, None]
    A = ATA / scale + 1e-5 * torch.eye(12, dtype=ATA.dtype, device=ATA.device)
    Ainv = inv_spd(A)
    v0 = 1.0 / torch.sqrt(torch.tensor(12.0, dtype=ATA.dtype))
    v = torch.full(ATA.shape[:-1], float(v0), dtype=ATA.dtype, device=ATA.device)
    for _ in range(6):
        z = (Ainv @ v[..., None])[..., 0]
        v = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-30)
    return v


def pnp_dlt(X, xn, w=None):
    """DLT pose from ≥6 3D-2D correspondences in normalised coordinates,
    batched: X (..., n, 3), xn (..., n, 2), w (..., n) weights. Returns
    (R (..., 3, 3), t (..., 3))."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zero = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    rows_u = torch.cat([Xh, zero, -u * Xh], dim=-1)
    rows_v = torch.cat([zero, Xh, -v * Xh], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    ATA = A.transpose(-1, -2) @ A
    p = _smallest_eigvec_12(ATA)
    P = p.reshape(p.shape[:-1] + (3, 4))
    lam = (Xh * P[..., 2, None, :]).sum(-1)
    front = torch.where(lam > 0, w, 0.0).sum(-1)
    behind = torch.where(lam < 0, w, 0.0).sum(-1)
    P = torch.where((behind > front)[..., None, None], -P, P)
    R, scale = polar_so3(P[..., :3])
    scale = torch.clamp(scale, min=1e-12)
    return R, P[..., 3] / scale[..., None]


def reprojection_errors(K, R, t, X, uv):
    """Per-point pixel reprojection error, batched: K (..., 3, 3), R (..., 3, 3),
    t (..., 3), X (..., n, 3), uv (..., n, 2) -> (..., n); behind-camera
    points get 1e9."""
    xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(xc[..., 2].abs() < 1e-9, torch.full_like(xc[..., 2], 1e-9), xc[..., 2])
    u = K[..., 0, 0, None] * xc[..., 0] / z + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * xc[..., 1] / z + K[..., 1, 2, None]
    err = torch.sqrt((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2)
    return torch.where(xc[..., 2] > 1e-6, err, 1e9)


def refine_pnp_gn(K, R0, t0, X, uv, weight_mask, iters: int = 10,
                  huber_delta: float = 2.0, damping: float = 1e-4):
    """Damped Gauss-Newton on se(3) (left increment), Huber-weighted, over the
    masked points; batched over leading dims of R0/t0 (K, X, uv, mask
    broadcast against them)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    w_mask = weight_mask.to(X.dtype)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = R0, t0
    for _ in range(iters):
        xc = X @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.where(xc[..., 2].abs() < 1e-9, torch.full_like(xc[..., 2], 1e-9), xc[..., 2])
        inv_z = 1.0 / z
        u = fx * xc[..., 0] * inv_z + cx
        v = fy * xc[..., 1] * inv_z + cy
        r = torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)
        rn = torch.linalg.vector_norm(r, dim=-1)
        hub = torch.where(rn <= huber_delta, 1.0, huber_delta / torch.clamp(rn, min=1e-12))
        wgt = w_mask * hub
        x_, y_ = xc[..., 0], xc[..., 1]
        zero = torch.zeros_like(z)
        J_proj = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * x_ * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y_ * inv_z * inv_z], -1),
        ], dim=-2)
        eye3 = torch.eye(3, dtype=X.dtype, device=X.device).expand(xc.shape + (3,))
        J_xi = torch.cat([eye3, -so3_hat(xc)], dim=-1)
        J = J_proj @ J_xi
        JW = J * wgt[..., None, None]
        H = torch.einsum("...nij,...nik->...jk", JW, J) + damping * eye6
        g = torch.einsum("...nij,...ni->...j", JW, r)
        dx = solve_spd(H, -g)
        E = so3_exp(dx[..., 3:])
        R = E @ R
        t = (E @ t[..., None])[..., 0] + dx[..., :3]
    return R, t


def _take(x, idx):
    """x (P, m, ...) indexed by idx (P,) along dim 1 -> (P, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


@functools.partial(Program, static_argnames=("refine_iters",), copy_outputs=True)
def solve_pnp_ransac(noise, K, X, uv, valid, threshold: float = 3.0,
                     refine_iters: int = 8, huber_delta: float = 2.0,
                     R_init=None, t_init=None):
    """RANSAC PnP over P masked problems at once.

    noise (P, iters, n) Gumbel draws; K (P, 3, 3); X (P, n, 3); uv (P, n, 2);
    valid (P, n); R_init/t_init optional (P, 3, 3)/(P, 3) pose priors whose
    Huber-GN polish competes with the RANSAC winner's. Returns a dict of
    R, t, inliers, n_inliers, ok, mean_err with leading dim P.
    A captured program: ``threshold`` and ``huber_delta`` are keyed by value."""
    thr = threshold
    xn = normalize_pixels(K, uv)
    idx = ransac_sample_indices(noise, valid, 6)             # (P, I, 6)
    Rs, ts = pnp_dlt(gather_rows(X, idx), gather_rows(xn, idx))
    err = reprojection_errors(K[:, None], Rs, ts, X[:, None], uv[:, None])
    scores = ((err < thr) & valid[:, None]).sum(-1)
    best = torch.argmax(scores, dim=-1)
    R0, t0 = _take(Rs, best), _take(ts, best)
    err0 = reprojection_errors(K, R0, t0, X, uv)
    inliers = (err0 < thr) & valid
    if R_init is not None:
        Rb, tb = refine_pnp_gn(
            K[:, None], torch.stack([R0, R_init], 1), torch.stack([t0, t_init], 1),
            X[:, None], uv[:, None], torch.stack([inliers, valid], 1),
            iters=refine_iters, huber_delta=huber_delta)
        errs = reprojection_errors(K[:, None], Rb, tb, X[:, None], uv[:, None])
        ninl = ((errs < thr) & valid[:, None]).sum(-1)
        pick = torch.argmax(ninl, dim=-1)
        R, t, err = _take(Rb, pick), _take(tb, pick), _take(errs, pick)
    else:
        R, t = refine_pnp_gn(K, R0, t0, X, uv, inliers, iters=refine_iters,
                             huber_delta=huber_delta)
        err = reprojection_errors(K, R, t, X, uv)
    new_inliers = (err < thr) & valid
    better = new_inliers.sum(-1) >= inliers.sum(-1)
    R = torch.where(better[:, None, None], R, R0)
    t = torch.where(better[:, None], t, t0)
    inliers = torch.where(better[:, None], new_inliers, inliers)
    err = torch.where(better[:, None], err, err0)
    n_inl = inliers.sum(-1)
    mean_err = torch.where(inliers, err, 0.0).sum(-1) / torch.clamp(n_inl, min=1)
    return {"R": so3_orthonormalize(R), "t": t, "inliers": inliers,
            "n_inliers": n_inl, "ok": n_inl >= 4, "mean_err": mean_err}

