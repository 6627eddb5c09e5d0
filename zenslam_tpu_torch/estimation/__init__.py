"""Pose estimators: RANSAC PnP, rigid 3D-3D, the 8-point algorithm with
fundamental and essential RANSAC, the cascade and pose fusion."""

from zenslam_tpu_torch.estimation.ransac import ransac_sample_indices
from zenslam_tpu_torch.estimation.pnp import pnp_dlt, refine_pnp_gn, solve_pnp_ransac
from zenslam_tpu_torch.estimation.rigid import solve_rigid_ransac, umeyama
from zenslam_tpu_torch.estimation.epipolar import (
    essential_8pt,
    estimate_2d2d_scaled,
    fundamental_8pt,
    recover_pose_from_essential,
    solve_essential_ransac,
    solve_fundamental_ransac,
)
from zenslam_tpu_torch.estimation.cascade import PoseEstimate, estimate_pose_cascade
from zenslam_tpu_torch.estimation.fusion import PoseCandidate, fuse_poses

__all__ = ["PoseCandidate", "PoseEstimate", "essential_8pt", "estimate_2d2d_scaled",
           "estimate_pose_cascade", "fundamental_8pt", "fuse_poses", "pnp_dlt",
           "ransac_sample_indices", "recover_pose_from_essential", "refine_pnp_gn",
           "solve_essential_ransac", "solve_fundamental_ransac", "solve_pnp_ransac",
           "solve_rigid_ransac", "umeyama"]
