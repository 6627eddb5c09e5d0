"""Pose estimation cascade: PnP cam0 → PnP cam1 → rigid 3D-3D → 2D-2D
essential with metric scale → predicted pose — counterpart of
``zenslam_tpu/estimation/cascade.py``.

All four estimators always run and a priority select picks the result, as in
the reference; with ``fuse=True`` the successful methods are fused instead
(``estimation/fusion.py``), and a given ``pred_sigma_p`` adds the inertial
prediction as a fifth candidate. Randomness enters only as Gumbel noise
(``CascadeNoise``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.estimation.epipolar import estimate_2d2d_scaled
from zenslam_tpu_torch.estimation.fusion import PoseCandidate, fuse_poses
from zenslam_tpu_torch.estimation.pnp import solve_pnp_ransac
from zenslam_tpu_torch.estimation.ransac import gumbel, take
from zenslam_tpu_torch.estimation.rigid import solve_rigid_ransac
from zenslam_tpu_torch.geometry.camera import StereoRig
from zenslam_tpu_torch.geometry.lie import se3_compose, se3_inverse, so3_orthonormalize
from zenslam_tpu_torch.utils.graphs import Program


class CascadeNoise(NamedTuple):
    """Gumbel draws for the four RANSAC estimators, each (iters, width):
    the two PnPs' width is the cam0 problem's (keypoints plus keyline
    endpoints with keylines on), the others' the keypoint count."""

    pnp0: torch.Tensor
    pnp1: torch.Tensor
    rigid: torch.Tensor
    essential: torch.Tensor


def draw_cascade_noise(generator: torch.Generator, n: int, pnp_iters: int,
                       rigid_iters: int, essential_iters: int, device,
                       n_pnp: int | None = None) -> CascadeNoise:
    """All of one frame's RANSAC noise from one generator, in a fixed order
    (pnp0, pnp1, rigid, essential). ``n_pnp``: the PnPs' width (default
    ``n``)."""
    n_pnp = n if n_pnp is None else n_pnp
    return CascadeNoise(
        pnp0=gumbel(generator, (pnp_iters, n_pnp), device),
        pnp1=gumbel(generator, (pnp_iters, n_pnp), device),
        rigid=gumbel(generator, (rigid_iters, n), device),
        essential=gumbel(generator, (essential_iters, n), device))


class PoseEstimate(NamedTuple):
    R: torch.Tensor          # (3,3) world->left-cam
    t: torch.Tensor          # (3,)
    ok: torch.Tensor         # () bool
    n_inliers: torch.Tensor  # () int
    mean_err: torch.Tensor   # () float32
    method: torch.Tensor     # () int32: 0=pnp_cam0, 1=pnp_cam1, 2=rigid3d3d,
                             #           3=essential2d2d, 4=fallback
    inliers0: torch.Tensor   # (N,) bool — inliers of the cam0 correspondences


def _pad_rows(a, m: int):
    if a.shape[0] == m:
        return a
    pad = torch.zeros((m - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


@functools.partial(Program, static_argnames=("fuse",), copy_outputs=True)
def estimate_pose_cascade(noise: CascadeNoise, rig: StereoRig,
                          X0, uv0, valid0, X1, uv1, valid1,
                          src3d, dst3d, valid3d, R_pred, t_pred,
                          p2a=None, p2b=None, valid2=None, X2_prev_cam=None,
                          has3d2=None, R_prev=None, t_prev=None, pred_sigma_p=None,
                          pnp_threshold: float = 3.0, rigid_threshold: float = 0.05,
                          essential_threshold: float = 1.5, min_inliers: int = 4,
                          fuse: bool = False) -> PoseEstimate:
    """Left-camera pose T_cam0_world. Iteration counts come from the noise
    shapes; ``p2a=None`` disables the essential fallback (method 3).
    ``pred_sigma_p``: 1-sigma position uncertainty (m) of the predicted pose
    from the preintegration covariance; with ``fuse`` it makes the
    prediction a candidate weighted on the 0.1 m scale.
    A captured program: the thresholds, ``min_inliers`` and a float ``pred_sigma_p`` are keyed
    by value."""
    R1p, t1p = se3_compose(rig.R_rl, rig.t_rl, R_pred, t_pred)
    n = max(X0.shape[0], X1.shape[0])
    rp = solve_pnp_ransac(
        torch.stack([noise.pnp0, noise.pnp1]),
        torch.stack([rig.left.K, rig.right.K]),
        torch.stack([_pad_rows(X0, n), _pad_rows(X1, n)]),
        torch.stack([_pad_rows(uv0, n), _pad_rows(uv1, n)]),
        torch.stack([_pad_rows(valid0, n), _pad_rows(valid1, n)]),
        threshold=pnp_threshold,
        R_init=torch.stack([R_pred, R1p]), t_init=torch.stack([t_pred, t1p]))
    r2 = solve_rigid_ransac(noise.rigid, src3d, dst3d, valid3d, threshold=rigid_threshold)
    use_2d2d = p2a is not None
    if use_2d2d:
        r3 = estimate_2d2d_scaled(noise.essential, rig.left.K, p2a, p2b, valid2,
                                  X2_prev_cam, has3d2, R_prev, t_prev,
                                  threshold=essential_threshold)

    ok0 = rp["ok"][0] & (rp["n_inliers"][0] >= min_inliers)
    ok1 = rp["ok"][1] & (rp["n_inliers"][1] >= min_inliers)
    ok2 = r2["ok"] & (r2["n_inliers"] >= max(min_inliers, 3))
    ok3 = r3["ok"] if use_2d2d else torch.zeros((), dtype=torch.bool, device=X0.device)

    Rlr, tlr = se3_inverse(rig.R_rl, rig.t_rl)
    R1c0, t1c0 = se3_compose(Rlr, tlr, rp["R"][1], rp["t"][1])
    Rc, tc = se3_inverse(r2["R"], r2["t"])
    R2c0, t2c0 = se3_compose(R_pred, t_pred, Rc, tc)
    if use_2d2d:
        R3, t3, n3, e3 = r3["R"], r3["t"], r3["n_inliers"], r3["mean_err"]
    else:
        R3, t3 = R_pred, t_pred
        n3 = torch.zeros((), dtype=torch.int64, device=X0.device)
        e3 = torch.full((), float("inf"), device=X0.device)

    def pick(f0, f1, f2, f3, fallback):
        return torch.where(ok0, f0, torch.where(ok1, f1, torch.where(
            ok2, f2, torch.where(ok3, f3, fallback))))

    R = so3_orthonormalize(pick(rp["R"][0], R1c0, R2c0, R3, R_pred))
    t = pick(rp["t"][0], t1c0, t2c0, t3, t_pred)
    method = pick(*torch.arange(5, dtype=torch.int32, device=X0.device))
    zero_i = torch.zeros((), dtype=torch.int64, device=X0.device)
    n_inl = pick(rp["n_inliers"][0], rp["n_inliers"][1], r2["n_inliers"],
                 n3.to(torch.int64), zero_i)
    mean_err = pick(rp["mean_err"][0], rp["mean_err"][1], r2["mean_err"], e3,
                    torch.full((), float("inf"), device=X0.device))
    ok = ok0 | ok1 | ok2 | ok3
    if fuse:
        # fuse the successful methods; a failed solver may emit NaN R/t, and
        # 0 * NaN would poison the fused pose, so they carry the prediction
        f32 = torch.float32
        oks = torch.stack([ok0, ok1, ok2, ok3])
        t_st = torch.where(oks[:, None], torch.stack([rp["t"][0], t1c0, t2c0, t3]), t_pred)
        R_st = torch.where(oks[:, None, None], torch.stack([rp["R"][0], R1c0, R2c0, R3]), R_pred)
        e_st = torch.stack([rp["mean_err"][0], rp["mean_err"][1], r2["mean_err"], e3]).to(f32)
        n_st = torch.stack([rp["n_inliers"][0], rp["n_inliers"][1], r2["n_inliers"],
                            n3.to(torch.int64)])
        n_valid = torch.stack([valid0.sum(), valid1.sum(), valid3d.sum(),
                               valid2.sum() if use_2d2d else torch.zeros_like(valid0.sum())])
        ratios = (n_st / torch.clamp(n_valid, min=1)).to(f32)
        # per-method error scales: 3 px for pixel residuals, 0.1 m for 3D-3D
        # (built from fills: a scalar assignment into a CUDA tensor copies
        # from the host and synchronises)
        px = torch.full((2,), 3.0, dtype=f32, device=X0.device)
        scales = torch.cat([px, torch.full_like(px[:1], 0.1), px[:1]])
        if pred_sigma_p is not None:
            # the inertial candidate: mean_err = sigma_p (m) on the 0.1 m
            # scale, no inliers (it measured nothing visual)
            sig = torch.as_tensor(pred_sigma_p, dtype=f32, device=X0.device).reshape(1)
            t_st, R_st = torch.cat([t_st, t_pred[None]]), torch.cat([R_st, R_pred[None]])
            e_st = torch.cat([e_st, sig])
            n_st = torch.cat([n_st, torch.zeros_like(n_st[:1])])
            ratios = torch.cat([ratios, torch.zeros_like(ratios[:1])])
            oks = torch.cat([oks, torch.isfinite(sig)])
            scales = torch.cat([scales, torch.full_like(scales[:1], 0.1)])
        R_f, t_f, _, _, best = fuse_poses(
            PoseCandidate(R=R_st, t=t_st, inlier_ratio=ratios, mean_err=e_st, n_inliers=n_st,
                          is_line=torch.zeros_like(oks), valid=oks), err_scale=scales)
        # telemetry follows the fusion winner (best == 4, the inertial
        # candidate, reports as method 4)
        R = torch.where(ok, so3_orthonormalize(R_f), R)
        t = torch.where(ok, t_f, t)
        method = torch.where(ok, best.to(torch.int32), method)
        n_inl = torch.where(ok, take(n_st, best), n_inl)
        mean_err = torch.where(ok, take(e_st, best), mean_err)
    return PoseEstimate(R=R, t=t, ok=ok, n_inliers=n_inl,
                        mean_err=mean_err, method=method,
                        inliers0=rp["inliers"][0][:X0.shape[0]])

