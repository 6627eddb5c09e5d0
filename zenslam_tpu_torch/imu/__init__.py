"""IMU preintegration (manifold and continuous-time), inertial prediction
and gravity estimation."""

from zenslam_tpu_torch.imu.preintegration import ImuIntegral, ImuNoise, preintegrate
from zenslam_tpu_torch.imu.continuous import (
    gp_posterior_mean, interp_masked, overlap_window_mask, preintegrate_continuous)
from zenslam_tpu_torch.imu.predictors import inertial_predict_pose, propagate_velocity
from zenslam_tpu_torch.imu.gravity import (
    GravityEstimator, gravity_add_sample, gravity_estimate, gravity_init)

__all__ = ["GravityEstimator", "ImuIntegral", "ImuNoise", "gp_posterior_mean",
           "gravity_add_sample", "gravity_estimate", "gravity_init", "inertial_predict_pose",
           "interp_masked", "overlap_window_mask", "preintegrate", "preintegrate_continuous",
           "propagate_velocity"]
