"""SIFT-style 128-d float descriptors — counterpart of
``zenslam_tpu/ops/sift.py`` (``sift_descriptors``): a 4x4 grid x 8
orientation bins of Gaussian-weighted gradient histograms over a 16x16
lattice rotated by the intensity-centroid orientation, L2-normalised,
clipped at 0.2 and renormalised. Matching uses the L2 matcher
(``ops/match.match_descriptors_float``)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from zenslam_tpu_torch.ops.image import bilinear_sample, gaussian_blur
from zenslam_tpu_torch.ops.orb import orb_orientation
from zenslam_tpu_torch.utils.device import upload_constant
from zenslam_tpu_torch.utils.graphs import Program

_GRID = 4          # 4x4 spatial cells
_BINS = 8          # orientation bins
_SAMPLES = 16      # 16x16 sample lattice
_PATCH_HALF = 8.0  # the lattice spans [-8, 8) sample units


def _sample_offsets() -> np.ndarray:
    """(256, 2) f32 lattice offsets (x, y), cell-centred."""
    c = (np.arange(_SAMPLES) - _SAMPLES / 2 + 0.5).astype(np.float32)
    xx, yy = np.meshgrid(c, c)
    return np.stack([xx.reshape(-1), yy.reshape(-1)], -1)


def _cell_indicator() -> np.ndarray:
    """(16, 256) f32: the 4x4 cell each of the 256 samples belongs to."""
    cell = (np.arange(_SAMPLES) // (_SAMPLES // _GRID)).astype(np.int32)
    cy, cx = np.meshgrid(cell, cell, indexing="ij")
    ind = np.zeros((_GRID * _GRID, _SAMPLES * _SAMPLES), np.float32)
    ind[(cy * _GRID + cx).reshape(-1), np.arange(_SAMPLES * _SAMPLES)] = 1.0
    return ind


def _gauss_window() -> np.ndarray:
    """(256,) Gaussian spatial weight (σ = half the patch width)."""
    r2 = (_sample_offsets() ** 2).sum(-1)
    return np.exp(-r2 / (2.0 * _PATCH_HALF ** 2)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _host_tables() -> tuple:
    return _sample_offsets(), _cell_indicator(), _gauss_window()


def _tables(device):
    """(offsets, cell indicator, Gaussian window) on ``device``
    (``upload_constant`` uploads each once)."""
    return tuple(upload_constant(t, device) for t in _host_tables())


@functools.partial(Program, copy_outputs=True)
def sift_descriptors(img, xy, valid, scale: float = 1.0):
    """(N, 128) f32 descriptors at keypoints xy (N, 2); invalid rows zero.
    The pooling over cells is one f32 product with the (16, 256) indicator.
    A captured program: ``scale`` is keyed by value."""
    offsets, cell_ind, gauss_w = _tables(img.device)
    g = gaussian_blur(img, 1.2)
    theta = orb_orientation(g, xy)
    c, s = torch.cos(theta), torch.sin(theta)
    off = offsets * scale
    rot_x = c[:, None] * off[None, :, 0] - s[:, None] * off[None, :, 1]
    rot_y = s[:, None] * off[None, :, 0] + c[:, None] * off[None, :, 1]
    px = xy[:, 0:1] + rot_x                             # (N, 256)
    py = xy[:, 1:2] + rot_y

    def samp(dx, dy):
        return bilinear_sample(g, torch.stack([px + dx, py + dy], -1))

    gx = 0.5 * (samp(1.0, 0.0) - samp(-1.0, 0.0))
    gy = 0.5 * (samp(0.0, 1.0) - samp(0.0, -1.0))
    rx = c[:, None] * gx + s[:, None] * gy             # gradients in the keypoint frame
    ry = -s[:, None] * gx + c[:, None] * gy
    mag = torch.sqrt(rx * rx + ry * ry + 1e-12) * gauss_w[None, :]
    ang = torch.atan2(ry, rx)

    # soft orientation binning: a triangular window over the 8 bin centres
    centres = (torch.arange(_BINS, dtype=torch.float32, device=img.device)
               * (2 * math.pi / _BINS) - math.pi)
    d = torch.remainder(ang[..., None] - centres + math.pi, 2 * math.pi) - math.pi
    w_bin = torch.clamp(1.0 - d.abs() * (_BINS / (2 * math.pi)), min=0.0)
    contrib = mag[..., None] * w_bin                     # (N, 256, 8)
    pooled = torch.einsum("cs,nsb->ncb", cell_ind, contrib)
    desc = pooled.reshape(xy.shape[0], _GRID * _GRID * _BINS)

    n1 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = torch.clamp(desc / torch.clamp(n1, min=1e-9), max=0.2)
    n2 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(n2, min=1e-9)
    return torch.where(valid[:, None], desc, 0.0)
