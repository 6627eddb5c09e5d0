"""Kalibr camchain parsing and stereo rectification — counterpart of
``zenslam_tpu/io/calibration.py``.

- ``parse_kalibr_camchain``: cam0 / cam1 entries (resolution, intrinsics,
  distortion_coeffs, T_cn_cnm1 left->right, T_cam_imu) to a ``StereoRig``;
- ``compute_rectify_maps``: Fusiello-style rectification, a shared K_new and
  the inverse maps (rectified pixel -> source pixel) for both cameras, plus
  the rectified rig (pure horizontal baseline);
- ``parse_imu_config``: the Kalibr imu_config noise densities.

The maps are built once on the host (float64 numpy, the distortion itself
through float32 torch, as the reference distorts through float32 jnp) and
applied per frame on the device with ``ops.image.remap``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from zenslam_tpu_torch.geometry.camera import (
    PinholeCamera, StereoRig, distort_equidistant, distort_radtan)
from zenslam_tpu_torch.pipeline.state import resolve_device


class ImuNoise(NamedTuple):
    """Continuous-time IMU noise densities (the reference's
    ``imu/preintegration.py:ImuNoise`` fields)."""

    gyro_noise: float = 1.6e-4        # rad/s/sqrt(Hz)
    accel_noise: float = 2.8e-3       # m/s^2/sqrt(Hz)
    gyro_bias_walk: float = 1.9e-5
    accel_bias_walk: float = 8.6e-4


class RectifyMaps(NamedTuple):
    left_x: np.ndarray   # (H, W) float32 source x of each rectified pixel
    left_y: np.ndarray
    right_x: np.ndarray
    right_y: np.ndarray
    rig_rectified: StereoRig  # the rig the rectified images obey


def parse_kalibr_camchain(d: dict, device=None):
    """(StereoRig on ``device``, (model0, model1)) from a loaded Kalibr
    camchain dict. cam1 carries T_cn_cnm1 (left->right), cam0 may carry
    T_cam_imu."""
    dev = resolve_device(device)

    def s(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def cam_of(e):
        fx, fy, cx, cy = e["intrinsics"]
        dist = (list(e.get("distortion_coeffs", [0, 0, 0, 0])) + [0.0] * 4)[:4]
        w, h = e["resolution"]
        return PinholeCamera(fx=s(fx), fy=s(fy), cx=s(cx), cy=s(cy), dist=s(dist),
                             width=int(w), height=int(h)), e.get("distortion_model", "radtan")

    cam0, model0 = cam_of(d["cam0"])
    cam1, model1 = cam_of(d["cam1"])
    T_rl = np.asarray(d["cam1"].get("T_cn_cnm1", np.eye(4)), np.float64)
    T_ci = np.asarray(d["cam0"].get("T_cam_imu", np.eye(4)), np.float64)
    rig = StereoRig(left=cam0, right=cam1,
                    R_rl=s(T_rl[:3, :3].astype(np.float32)), t_rl=s(T_rl[:3, 3].astype(np.float32)),
                    R_ci=s(T_ci[:3, :3].astype(np.float32)), t_ci=s(T_ci[:3, 3].astype(np.float32)))
    return rig, (model0, model1)


def load_kalibr_yaml(path: str, device=None):
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    return parse_kalibr_camchain(d, device)


def parse_imu_config(d: dict) -> ImuNoise:
    """The noise fields of a Kalibr imu_config.yaml (defaults where absent)."""
    return ImuNoise(
        gyro_noise=float(d.get("gyroscope_noise_density", 1.6e-4)),
        accel_noise=float(d.get("accelerometer_noise_density", 2.8e-3)),
        gyro_bias_walk=float(d.get("gyroscope_random_walk", 1.9e-5)),
        accel_bias_walk=float(d.get("accelerometer_random_walk", 8.6e-4)),
    )


def _distort_normalized(model: str, dist: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Apply the lens model to normalized coords, in float32 on the CPU."""
    x = torch.as_tensor(xy, dtype=torch.float32)
    k = torch.as_tensor(dist, dtype=torch.float32)
    if model in ("equidistant", "fisheye"):
        return distort_equidistant(k, x).numpy()
    return distort_radtan(k, x).numpy()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def compute_rectify_maps(rig: StereoRig, models=("radtan", "radtan")) -> RectifyMaps:
    """Rotations that align both cameras' x-axes with the baseline, a shared
    K_new (mean focal, image centre), and the inverse maps; the rectified
    rig (new intrinsics, identity R_rl, t_rl = (-baseline, 0, 0)) lives on
    the input rig's device."""
    K0 = _host(rig.left.K).astype(np.float64)
    K1 = _host(rig.right.K).astype(np.float64)
    R_rl = _host(rig.R_rl).astype(np.float64)
    t_rl = _host(rig.t_rl).astype(np.float64)
    H, W = rig.left.height, rig.left.width

    c1 = -R_rl.T @ t_rl                      # camera 1 centre in camera 0
    baseline = np.linalg.norm(c1)
    ex = c1 / baseline
    ey = np.cross(np.array([0.0, 0.0, 1.0]), ex)
    ey /= np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    R_rect0 = np.stack([ex, ey, ez])         # cam0 -> rectified
    R_rect1 = R_rect0 @ R_rl.T               # cam1 -> rectified

    f_new = float((K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1]) / 4.0)
    cx_new, cy_new = W / 2.0, H / 2.0

    def build_map(K_src, dist, model, R_rect):
        # rectified pixel -> rectified ray -> source ray -> distorted
        # normalized -> source pixel
        u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        rays = np.stack([(u - cx_new) / f_new, (v - cy_new) / f_new, np.ones_like(u)], -1)
        rays_src = rays @ R_rect
        xyn = rays_src[..., :2] / np.maximum(rays_src[..., 2:3], 1e-9)
        xyd = _distort_normalized(model, dist, xyn.reshape(-1, 2)).reshape(H, W, 2)
        mx = K_src[0, 0] * xyd[..., 0] + K_src[0, 2]
        my = K_src[1, 1] * xyd[..., 1] + K_src[1, 2]
        return mx.astype(np.float32), my.astype(np.float32)

    lx, ly = build_map(K0, _host(rig.left.dist), models[0], R_rect0)
    rx, ry = build_map(K1, _host(rig.right.dist), models[1], R_rect1)

    dev = rig.R_rl.device

    def s(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    cam_new = PinholeCamera(fx=s(f_new), fy=s(f_new), cx=s(cx_new), cy=s(cy_new),
                            dist=torch.zeros(4, dtype=torch.float32, device=dev),
                            width=W, height=H)
    rig_rect = StereoRig(left=cam_new, right=cam_new,
                         R_rl=torch.eye(3, dtype=torch.float32, device=dev),
                         t_rl=s([-baseline, 0.0, 0.0]), R_ci=rig.R_ci, t_ci=rig.t_ci)
    return RectifyMaps(left_x=lx, left_y=ly, right_x=rx, right_y=ry, rig_rectified=rig_rect)
