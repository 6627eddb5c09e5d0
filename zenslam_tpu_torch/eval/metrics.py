"""Trajectory error (numpy) — counterpart of ``zenslam_tpu/eval/metrics.py``
(``ate_rmse``, ``rpe_rmse`` and what they need)."""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares (s, R, t) aligning est -> gt. Positions (T, 3)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / max((ec ** 2).sum() / est.shape[0], 1e-12)) \
        if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE in meters after alignment."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    if align:
        s, R, t = align_umeyama(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))


def camera_positions(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """(T,3,3),(T,3) world->cam extrinsics -> (T,3) camera centres."""
    return -np.einsum("tij,ti->tj", np.asarray(R_cw), np.asarray(t_cw))


def rpe_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation drift) error RMSE over a frame delta."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    return float(np.sqrt(((d_est - d_gt) ** 2).sum(-1).mean()))
