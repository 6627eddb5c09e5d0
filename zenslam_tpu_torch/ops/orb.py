"""Oriented BRIEF 256-bit descriptors — counterpart of
``zenslam_tpu/ops/orb.py`` (the f32 gather path the reference runs off-TPU).

``ORB_PATTERN`` is drawn exactly as the reference draws it (numpy
``RandomState(1234)``), so both packages share one sampling pattern.
Orientation uses integral images over the 31x31 square; their cumulative
sums follow the blocked scan XLA lowers ``cumsum`` to on the CPU (``_scan``),
and the moment differences round as one fused multiply-add, so the moments
agree bit for bit with the reference there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zenslam_tpu_torch.ops.image import fma, gaussian_blur
from zenslam_tpu_torch.utils.device import upload_constant
from zenslam_tpu_torch.utils.graphs import Program

_PATCH_RADIUS = 15


def _make_pattern(n_bits: int = 256, radius: int = _PATCH_RADIUS, seed: int = 1234) -> np.ndarray:
    """(n_bits, 4) float32: (x1, y1, x2, y2) offsets, Gaussian σ=radius/2, clipped."""
    rs = np.random.RandomState(seed)
    pat = rs.normal(0.0, radius / 2.0, size=(n_bits, 4))
    return np.clip(pat, -radius + 1, radius - 1).astype(np.float32)


ORB_PATTERN = _make_pattern()

_SCAN_BASE = 16


def _sequential_cumsum(x):
    """Inclusive cumulative sum along dim 0, strictly left to right."""
    out = [x[0]]
    for i in range(1, x.shape[0]):
        out.append(out[-1] + x[i])
    return torch.stack(out)


def _scan(x, dim: int):
    """Inclusive cumulative sum along ``dim`` as a blocked scan: sequential
    sums inside blocks of 16, block totals scanned recursively, then added
    back as an exclusive prefix. Same association as XLA's CPU cumsum."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= _SCAN_BASE:
        out = _sequential_cumsum(x)
    else:
        m = -(-n // _SCAN_BASE) * _SCAN_BASE
        pad = torch.zeros((m - n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        blocks = torch.cat([x, pad]).reshape((m // _SCAN_BASE, _SCAN_BASE) + tuple(x.shape[1:]))
        local = _sequential_cumsum(blocks.movedim(1, 0)).movedim(0, 1)
        tot = _scan(local[:, -1], 0)
        excl = torch.cat([torch.zeros_like(tot[:1]), tot[:-1]])
        out = (local + excl[:, None]).reshape((m,) + tuple(x.shape[1:]))[:n]
    return out.movedim(0, dim)


def orb_moments(img):
    """The intensity-centroid moments (m10, m01), each (H, W), of the 31x31
    square around every pixel (zero outside the image), from integral
    images."""
    H, W = img.shape
    r = _PATCH_RADIUS
    xg = torch.arange(W, dtype=torch.float32, device=img.device)[None, :] * torch.ones(
        (H, 1), dtype=torch.float32, device=img.device)
    yg = torch.arange(H, dtype=torch.float32, device=img.device)[:, None] * torch.ones(
        (1, W), dtype=torch.float32, device=img.device)

    def box(Fm):
        S = _scan(_scan(Fm, 0), 1)
        P = torch.nn.functional.pad(S, (1, 0, 1, 0))
        P = torch.nn.functional.pad(P[None], (r, r, r, r), mode="replicate")[0]
        return (P[2 * r + 1:, 2 * r + 1:] - P[:H, 2 * r + 1:]
                - P[2 * r + 1:, :W] + P[:H, :W])

    bA = box(img)
    bAx = box(img * xg)
    bAy = box(img * yg)
    m10 = fma(-xg, bA, bAx)  # the reference's compiled form fuses these
    m01 = fma(-yg, bA, bAy)
    return m10, m01


@functools.partial(Program, copy_outputs=True)
def orb_orientation(img, xy):
    """Intensity-centroid orientation theta = atan2(m01, m10) per keypoint
    (``orb_moments``). img (H, W); xy (N, 2). Returns (N,) radians."""
    H, W = img.shape
    m10, m01 = orb_moments(img)
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    flat = yi * W + xi
    return torch.atan2(m01.reshape(-1)[flat], m10.reshape(-1)[flat])


def pack_bits(bits):
    """(N, 256) {0,1} -> (N, 8) int32 words, LSB first (word w, bit j =
    column 32w + j); same bit patterns as the reference's uint32 words."""
    n = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(n, 8, 32).to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


@functools.partial(Program, copy_outputs=True)
def orb_descriptors(img, xy, valid):
    """Steered-BRIEF descriptors on the f32 gather path.

    img (H, W) f32 (smoothed here, σ=2, r=4); xy (N, 2); valid (N,) bool.
    Returns (packed (N, 8) int32, invalid rows zero; angles (N,) f32)."""
    H, W = img.shape
    sm = gaussian_blur(img, sigma=2.0, radius=4)
    theta = orb_orientation(sm, xy)
    c, s = torch.cos(theta), torch.sin(theta)
    pat = upload_constant(ORB_PATTERN, img.device)
    sm_flat = sm.reshape(-1)

    def sample(px, py):
        qx = xy[:, 0:1] + px[None, :] * c[:, None] - py[None, :] * s[:, None]
        qy = xy[:, 1:2] + px[None, :] * s[:, None] + py[None, :] * c[:, None]
        xi = torch.clamp(torch.round(qx).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(qy).to(torch.int64), 0, H - 1)
        return sm_flat[yi * W + xi]

    v1 = sample(pat[:, 0], pat[:, 1])
    v2 = sample(pat[:, 2], pat[:, 3])
    bits = (v1 < v2) & valid[:, None]
    return pack_bits(bits), theta
