"""Lie groups, cameras, small-matrix solvers and triangulation."""

from zenslam_tpu_torch.geometry.lie import (
    quat_slerp,
    quat_to_rotmat,
    rotation_angle,
    rotmat_to_quat,
    se3_apply,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_hat,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_log,
    so3_vee,
)
from zenslam_tpu_torch.geometry.camera import (
    PinholeCamera,
    StereoRig,
    backproject,
    distort_equidistant,
    distort_radtan,
    essential_from_pose,
    fundamental_from_rig,
    project,
    project_se3,
    undistort_points_equidistant,
    undistort_points_radtan,
)
from zenslam_tpu_torch.geometry.triangulate import (
    TriangulationGates,
    triangulate_dlt,
    triangulate_midpoint,
    triangulate_rectified,
    triangulation_gates,
)

__all__ = ["PinholeCamera", "StereoRig", "TriangulationGates", "backproject",
           "distort_equidistant", "distort_radtan", "essential_from_pose",
           "fundamental_from_rig", "project", "project_se3", "quat_slerp", "quat_to_rotmat",
           "rotation_angle", "rotmat_to_quat", "se3_apply", "se3_compose", "se3_exp",
           "se3_identity", "se3_inverse", "se3_log", "so3_exp", "so3_hat", "so3_left_jacobian",
           "so3_left_jacobian_inv", "so3_log", "so3_vee", "triangulate_dlt",
           "triangulate_midpoint", "triangulate_rectified", "triangulation_gates",
           "undistort_points_equidistant", "undistort_points_radtan"]
