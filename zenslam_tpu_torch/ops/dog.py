"""Difference-of-Gaussians scale-space extremum detector — counterpart of
``zenslam_tpu/ops/dog.py`` (``dog_score``): per octave a Gaussian ladder,
DoG planes, the 26-neighbour extremum test, a contrast threshold and the
edge-response rejection, all dense (H, W) planes; a score (|DoG| at
surviving extrema, 0 elsewhere) for the same grid selection as FAST."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from zenslam_tpu_torch.ops.harris import upsample_nearest
from zenslam_tpu_torch.ops.image import gaussian_blur
from zenslam_tpu_torch.utils.graphs import Program


def _win3(D, op: str):
    """3x3 window max or min (SAME, ±inf outside) of a (H, W) plane."""
    if op == "max":
        return F.max_pool2d(D[None, None], 3, stride=1, padding=1)[0, 0]
    return -F.max_pool2d(-D[None, None], 3, stride=1, padding=1)[0, 0]


def _octave_score(img, k: float, sigma0: float, n_dog: int, threshold: float,
                  edge_r: float):
    """Extremum score plane of one octave at this image's resolution."""
    planes = []
    sig_prev = 0.0
    g = img
    for i in range(n_dog + 1):
        sig = sigma0 * (k ** i)
        ds = math.sqrt(max(sig * sig - sig_prev * sig_prev, 1e-6))  # incremental blur
        g = gaussian_blur(g, ds, radius=max(2, int(3 * ds + 0.5)))
        planes.append(g)
        sig_prev = sig
    dog = [planes[i + 1] - planes[i] for i in range(n_dog)]

    score = torch.zeros_like(img)
    for i in range(1, n_dog - 1):
        D, up, down = dog[i], dog[i + 1], dog[i - 1]
        is_max = (D >= _win3(D, "max")) & (D > _win3(up, "max")) & (D > _win3(down, "max"))
        is_min = (D <= _win3(D, "min")) & (D < _win3(up, "min")) & (D < _win3(down, "min"))
        contrast = D.abs() > threshold
        # edge rejection (Lowe §4.1): tr²/det of the 2x2 Hessian of D
        dxx = torch.roll(D, -1, 1) + torch.roll(D, 1, 1) - 2 * D
        dyy = torch.roll(D, -1, 0) + torch.roll(D, 1, 0) - 2 * D
        dxy = 0.25 * (torch.roll(D, (-1, -1), (0, 1)) + torch.roll(D, (1, 1), (0, 1))
                      - torch.roll(D, (-1, 1), (0, 1)) - torch.roll(D, (1, -1), (0, 1)))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        not_edge = (det > 0) & (tr * tr * edge_r < (edge_r + 1.0) ** 2 * det)
        ok = (is_max | is_min) & contrast & not_edge
        score = torch.maximum(score, torch.where(ok, D.abs(), 0.0))
    return score


@functools.partial(Program, static_argnames=("n_octaves", "scales_per_octave", "sigma0",
                                            "threshold", "edge_r"), copy_outputs=True)
def dog_score(img, n_octaves: int = 3, scales_per_octave: int = 3, sigma0: float = 1.6,
              threshold: float = 0.01, edge_r: float = 10.0):
    """Dense DoG extremum score, max over octaves at full resolution (coarser
    octaves on 2x2 averages of the image cropped to even size, their scores
    nearest-upsampled and zero-padded back to (H, W)). (H, W) f32."""
    H, W = img.shape
    k = 2.0 ** (1.0 / scales_per_octave)
    n_dog = scales_per_octave + 2
    score = _octave_score(img, k, sigma0, n_dog, threshold, edge_r)
    cur = img
    for o in range(1, n_octaves):
        cur = cur[:cur.shape[0] // 2 * 2, :cur.shape[1] // 2 * 2]
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2])
        up = upsample_nearest(_octave_score(cur, k, sigma0, n_dog, threshold, edge_r),
                              1 << o, H, W)
        up = F.pad(up, (0, W - up.shape[1], 0, H - up.shape[0]))
        score = torch.maximum(score, up)
    return score
