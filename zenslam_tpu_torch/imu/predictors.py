"""Pose and velocity prediction from IMU preintegration — counterpart of
``zenslam_tpu/imu/predictors.py``.

Conventions: T_cw = (R_cw, t_cw) maps world->camera; T_ci maps IMU->camera
(Kalibr T_cam_imu); the IMU body pose is T_iw = T_ci^-1 ∘ T_cw.
"""

from __future__ import annotations

from zenslam_tpu_torch.geometry.lie import se3_compose, se3_inverse
from zenslam_tpu_torch.imu.preintegration import ImuIntegral


def inertial_predict_pose(R_cw, t_cw, v_world, gravity_world, integral: ImuIntegral,
                          R_ci, t_ci):
    """The camera pose (R_cw', t_cw') after the integral's interval, from the
    current pose, the body velocity and gravity in the world frame."""
    Ric, tic = se3_inverse(R_ci, t_ci)
    R_iw, t_iw = se3_compose(Ric, tic, R_cw, t_cw)
    R_wi, p_wi = se3_inverse(R_iw, t_iw)
    dt = integral.dt
    R_wi_new = R_wi @ integral.dR
    p_new = p_wi + v_world * dt + 0.5 * gravity_world * dt * dt + R_wi @ integral.dp
    R_iw_new, t_iw_new = se3_inverse(R_wi_new, p_new)
    return se3_compose(R_ci, t_ci, R_iw_new, t_iw_new)


def propagate_velocity(v_world, gravity_world, R_wi, integral: ImuIntegral):
    """v' = v + g dt + R_wi Δv (world frame)."""
    return v_world + gravity_world * integral.dt + R_wi @ integral.dv
