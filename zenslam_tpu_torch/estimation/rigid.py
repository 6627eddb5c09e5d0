"""3D-3D alignment: Umeyama (Horn rotation, optional scale) + fixed-iteration RANSAC —
counterpart of ``zenslam_tpu/estimation/rigid.py``."""

from __future__ import annotations

import functools

import torch

from zenslam_tpu_torch.estimation.ransac import gather_rows, ransac_sample_indices, take
from zenslam_tpu_torch.geometry.polar import rotation_from_cov
from zenslam_tpu_torch.utils.graphs import Program


def umeyama(src, dst, w=None, with_scale: bool = False):
    """Least-squares similarity (R, t, s) with dst ≈ s·R·src + t, batched
    over leading dims: src/dst (..., n, 3), w (..., n) weights. Without
    ``with_scale`` s is 1 (a tensor of ones of the batch shape) and (R, t)
    the rigid fit."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(w.sum(-1), min=1e-12)
    mu_s = (src * w[..., None]).sum(-2) / wsum[..., None]
    mu_d = (dst * w[..., None]).sum(-2) / wsum[..., None]
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).transpose(-1, -2) @ sc / wsum[..., None, None]
    R = rotation_from_cov(cov)
    Rmu = (R @ mu_s[..., None])[..., 0]
    if not with_scale:
        return R, mu_d - Rmu, torch.ones_like(wsum)
    # Umeyama's scale tr(D·S) / var_s = tr(Rᵀ·cov) / var_s for the optimal R
    var_s = (w[..., None] * sc * sc).sum((-2, -1)) / wsum
    s = (R * cov).sum((-2, -1)) / torch.clamp(var_s, min=1e-12)
    return R, mu_d - s[..., None] * Rmu, s


def _align_err(R, t, src, dst):
    return torch.linalg.vector_norm(
        src @ R.transpose(-1, -2) + t[..., None, :] - dst, dim=-1)


@functools.partial(Program, copy_outputs=True)
def solve_rigid_ransac(noise, src, dst, valid, threshold: float = 0.05):
    """RANSAC rigid 3D-3D (3-point hypotheses, full-inlier refit).
    noise (iters, n) Gumbel draws. Returns dict of R, t (dst = R·src + t),
    inliers, n_inliers, ok, mean_err.
    A captured program: ``threshold`` is keyed by value."""
    idx = ransac_sample_indices(noise, valid, 3)
    Rs, ts, _ = umeyama(gather_rows(src, idx), gather_rows(dst, idx))
    err = _align_err(Rs, ts, src, dst)
    scores = ((err < threshold) & valid).sum(-1)
    best = torch.argmax(scores)
    R0, t0 = take(Rs, best), take(ts, best)
    inliers = (_align_err(R0, t0, src, dst) < threshold) & valid
    R, t, _ = umeyama(src, dst, w=inliers.to(src.dtype))
    new_inliers = (_align_err(R, t, src, dst) < threshold) & valid
    better = new_inliers.sum() >= inliers.sum()
    R = torch.where(better, R, R0)
    t = torch.where(better, t, t0)
    inliers = torch.where(better, new_inliers, inliers)
    n_inl = inliers.sum()
    final_err = _align_err(R, t, src, dst)
    mean_err = torch.where(inliers, final_err, 0.0).sum() / torch.clamp(n_inl, min=1)
    return {"R": R, "t": t, "inliers": inliers, "n_inliers": n_inl,
            "ok": n_inl >= 3, "mean_err": mean_err}
