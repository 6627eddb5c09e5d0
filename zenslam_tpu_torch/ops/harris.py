"""Multi-scale Harris corner scoring — counterpart of
``zenslam_tpu/ops/harris.py`` (``harris_score``,
``harris_score_multiscale``). Dense (H, W) planes fed to the same grid
selection as FAST (``ops/fast.select_grid_keypoints``)."""

from __future__ import annotations

import functools

import torch

from zenslam_tpu_torch.ops.image import gaussian_blur
from zenslam_tpu_torch.utils.graphs import Program


@functools.partial(Program, copy_outputs=True)
def harris_score(img, k: float = 0.04, sigma_d: float = 1.0, sigma_i: float = 2.0):
    """Dense Harris response det(M) - k tr(M)² of the structure tensor M =
    G_{sigma_i} * [Ix², IxIy; IxIy, Iy²], central-difference gradients (with
    wrap-around, as the reference's roll) at scale sigma_d.
    A captured program: ``k``, ``sigma_d`` and ``sigma_i`` are keyed by value."""
    g = gaussian_blur(img, sigma_d)
    gx = 0.5 * (torch.roll(g, -1, 1) - torch.roll(g, 1, 1))
    gy = 0.5 * (torch.roll(g, -1, 0) - torch.roll(g, 1, 0))
    Ixx = gaussian_blur(gx * gx, sigma_i, radius=4)
    Iyy = gaussian_blur(gy * gy, sigma_i, radius=4)
    Ixy = gaussian_blur(gx * gy, sigma_i, radius=4)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


def upsample_nearest(r, f: int, H: int, W: int):
    """Nearest upsample by ``f`` on both axes, cropped to at most (H, W)."""
    return r.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)[:H, :W]


@functools.partial(Program, static_argnames=("n_scales",), copy_outputs=True)
def harris_score_multiscale(img, n_scales: int = 3, k: float = 0.04, threshold: float = 1e-7):
    """Max Harris response (constant ``k``) over ``n_scales`` octaves (coarse
    scales on 2x2 averages, nearest-upsampled back). (H, W) f32, 0 below
    ``threshold``.
    A captured program: ``k`` and ``threshold`` are keyed by value."""
    H, W = img.shape
    score = harris_score(img, k)
    cur = img
    for s in range(1, n_scales):
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2])
        score = torch.maximum(score, upsample_nearest(harris_score(cur, k), 1 << s, H, W))
    return torch.where(score > threshold, score, 0.0)
