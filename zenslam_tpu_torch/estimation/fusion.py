"""Confidence-weighted multi-method pose fusion — counterpart of
``zenslam_tpu/estimation/fusion.py``: per-candidate confidence 0.4·inlier
ratio + 0.4·exp(−err/scale)·consistency + 0.2·inlier boost (line-based
candidates ×0.9), a confidence-weighted translation re-fused after a
consistency pass and a hard outlier gate, the best candidate's rotation,
and a diagonal 6x6 covariance from the confidence. Indices are gathered with
``index_select``: indexing by a 0-d tensor would read it back to the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.estimation.ransac import take
from zenslam_tpu_torch.utils.graphs import Program


class PoseCandidate(NamedTuple):
    R: torch.Tensor             # (M, 3, 3)
    t: torch.Tensor             # (M, 3)
    inlier_ratio: torch.Tensor  # (M,)
    mean_err: torch.Tensor      # (M,) pixels (or meters for 3D-3D)
    n_inliers: torch.Tensor     # (M,)
    is_line: torch.Tensor       # (M,) bool
    valid: torch.Tensor         # (M,) bool


@functools.partial(Program, copy_outputs=True)
def fuse_poses(cands: PoseCandidate, err_scale=2.0, inlier_boost_at: int = 50,
               outlier_distance: float = 0.5, consistency_scale: float = 0.2):
    """Fuse M pose candidates. Returns (R, t, confidence, cov_diag (6,),
    best). ``err_scale``: a scalar or an (M,) vector of per-candidate scales
    (0.1 m for 3D-3D, 3 px for pixel residuals). ``best`` is the index of
    the winning candidate, the fused rotation's source.
    A captured program: a float ``err_scale`` and the other scalars are keyed by value."""
    f32 = torch.float32
    dev = cands.t.device
    if not isinstance(err_scale, (int, float)):
        err_scale = torch.as_tensor(err_scale, dtype=f32, device=dev)
    valid = cands.valid
    # invalid candidates may carry NaN residuals or poses: 0·NaN = NaN
    mean_err = torch.where(valid & torch.isfinite(cands.mean_err), cands.mean_err, 1e6)
    t_anchor0 = take(cands.t, torch.argmax(torch.where(valid, cands.inlier_ratio, -1.0)))
    t = torch.where((valid & torch.isfinite(cands.t).all(-1))[:, None], cands.t, t_anchor0)
    err_term = torch.exp(-mean_err / err_scale)
    boost = torch.clamp(cands.n_inliers.to(f32) / inlier_boost_at, 0.0, 1.0)
    base = 0.4 * cands.inlier_ratio + 0.4 * err_term + 0.2 * boost
    base = torch.where(cands.is_line, base * 0.9, base)
    w = torch.where(valid, base, 0.0)

    wsum = torch.clamp(w.sum(), min=1e-9)
    t_consensus = (t * w[:, None]).sum(0) / wsum
    dist = torch.linalg.vector_norm(t - t_consensus, dim=-1)
    consistency = torch.exp(-dist / max(consistency_scale, 1e-6))
    w2 = torch.where(valid, 0.4 * cands.inlier_ratio + 0.4 * err_term * consistency
                     + 0.2 * boost, 0.0)
    w2 = torch.where(cands.is_line, w2 * 0.9, w2)
    # hard outlier gate around the best-weighted candidate
    t_anchor = take(t, torch.argmax(w))
    w2 = torch.where(torch.linalg.vector_norm(t - t_anchor, dim=-1) > outlier_distance, 0.0, w2)
    w2sum = torch.clamp(w2.sum(), min=1e-9)
    t_fused = (t * w2[:, None]).sum(0) / w2sum

    best = torch.argmax(w2)
    R_fused = take(cands.R, best)
    confidence = w2.max()
    c = torch.clamp(confidence, min=1e-3)
    sigma_t, sigma_r = 0.05 / c, 0.02 / c
    cov_diag = torch.cat([(sigma_t ** 2).expand(3), (sigma_r ** 2).expand(3)])
    return R_fused, t_fused, torch.where(valid.any(), confidence, 0.0), cov_diag, best
