"""Host-side helpers."""

from zenslam_tpu_torch.utils.formatters import euler_zyx_deg, format_pose, format_vec3

__all__ = ["euler_zyx_deg", "format_pose", "format_vec3"]
