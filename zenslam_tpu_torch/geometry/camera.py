"""Pinhole camera and stereo rig, projection and lens distortion —
counterpart of ``zenslam_tpu/geometry/camera.py``.

Convention: ``T_cam_world = (R, t)`` maps world points into the camera frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from zenslam_tpu_torch.geometry.lie import se3_apply, se3_compose, se3_inverse, so3_hat


class PinholeCamera(NamedTuple):
    """Intrinsics as 0-d tensors; ``dist`` (4,) is carried but unused by the
    pinhole path. ``width``/``height`` are plain ints (0 = unknown)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def K(self):
        one = torch.ones_like(self.fx)
        zero = torch.zeros_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, zero, self.cx], dim=-1),
            torch.stack([zero, self.fy, self.cy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ], dim=-2)


class StereoRig(NamedTuple):
    """``R_rl, t_rl`` map left-camera coordinates into the right camera;
    ``R_ci, t_ci`` map the IMU frame into the left camera."""

    left: PinholeCamera
    right: PinholeCamera
    R_rl: torch.Tensor
    t_rl: torch.Tensor
    R_ci: torch.Tensor
    t_ci: torch.Tensor

    @property
    def baseline(self):
        return torch.linalg.norm(self.t_rl)


def project(cam: PinholeCamera, x_cam):
    """Camera-frame 3D points (..., 3) -> pixel coords (..., 2)."""
    z = x_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * x_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * x_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def project_se3(cam: PinholeCamera, R, t, x_world):
    """Project world points through T_cam_world = (R, t)."""
    return project(cam, se3_apply(R, t, x_world))


def backproject(cam: PinholeCamera, uv, depth):
    """Pixels (..., 2) + depth (...,) -> camera-frame 3D points."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def distort_radtan(dist, xy):
    """Normalized -> distorted normalized coords, radial-tangential (k1 k2 p1 p2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points_radtan(dist, xy_dist, iters: int = 8):
    """Inverse of distort_radtan by fixed-point iteration (fixed count)."""
    xy = xy_dist
    for _ in range(iters):
        xy = xy_dist - (distort_radtan(dist, xy) - xy)
    return xy


def distort_equidistant(dist, xy):
    """Kannala-Brandt / Kalibr 'equidistant' fisheye (k1..k4)."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y + 1e-18)
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2 * t2 + k3 * t2 ** 3 + k4 * t2 ** 4)
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def undistort_points_equidistant(dist, xy_dist, iters: int = 10):
    """Inverse of distort_equidistant by Newton steps on theta (fixed count)."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    x, y = xy_dist[..., 0], xy_dist[..., 1]
    theta_d = torch.sqrt(x * x + y * y + 1e-18)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + k1 * t2 + k2 * t2 * t2 + k3 * t2 ** 3 + k4 * t2 ** 4) - theta_d
        df = 1.0 + 3 * k1 * t2 + 5 * k2 * t2 * t2 + 7 * k3 * t2 ** 3 + 9 * k4 * t2 ** 4
        theta = theta - f / df
    scale = torch.tan(theta) / theta_d
    return torch.stack([x * scale, y * scale], dim=-1)


def essential_from_pose(R, t):
    """E = [t]x R for T_b_a = (R, t)."""
    return so3_hat(t) @ R


def fundamental_from_rig(rig: StereoRig):
    """F = K_r^-T [t]x R K_l^-1, normalised so F[2, 2] = 1."""
    E = essential_from_pose(rig.R_rl, rig.t_rl)
    Kl_inv = torch.linalg.inv_ex(rig.left.K).inverse
    Kr_inv_T = torch.linalg.inv_ex(rig.right.K).inverse.T
    F = Kr_inv_T @ E @ Kl_inv
    f22 = F[2, 2]
    return F / (f22 + torch.where(f22.abs() < 1e-12, 1e-12, 0.0))


def camera_pose_to_world(R_cw, t_cw):
    """Invert T_cam_world to get the camera pose in the world."""
    return se3_inverse(R_cw, t_cw)


def right_from_left_extrinsics(rig: StereoRig, R_lw, t_lw):
    """T_right_world = T_rl ∘ T_left_world."""
    return se3_compose(rig.R_rl, rig.t_rl, R_lw, t_lw)
