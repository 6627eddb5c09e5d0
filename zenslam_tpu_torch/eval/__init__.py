"""Trajectory metrics."""

from zenslam_tpu_torch.eval.metrics import align_umeyama, ate_rmse, rpe_rmse

__all__ = ["align_umeyama", "ate_rmse", "rpe_rmse"]
