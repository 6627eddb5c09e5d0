"""FREAK-style retinal binary descriptors — counterpart of
``zenslam_tpu/ops/freak.py`` (``freak_descriptors``): 43 receptive fields
in 7 rings and the fovea, sampled from three pre-blurred planes (σ 1, 2.5,
5) at positions steered by the intensity-centroid orientation, compared over
256 coarse-to-fine pairs into packed words. Matching uses the same Hamming
matcher as ORB."""

from __future__ import annotations

import functools

import numpy as np
import torch

from zenslam_tpu_torch.ops.image import bilinear_sample, gaussian_blur
from zenslam_tpu_torch.ops.orb import orb_orientation, pack_bits
from zenslam_tpu_torch.utils.device import upload_constant
from zenslam_tpu_torch.utils.graphs import Program


def _retina_pattern() -> np.ndarray:
    """(43, 3) f32: (x, y, plane) of 7 rings x 6 staggered fields + fovea;
    ``plane`` indexes the blur ladder (0 = sharpest)."""
    radii = [20.0, 14.7, 10.8, 7.9, 5.8, 4.2, 3.1]
    pts = []
    for ring, r in enumerate(radii):
        phase = (np.pi / 6.0) if (ring % 2) else 0.0   # alternate rings stagger by 30°
        plane = 2 if ring < 2 else (1 if ring < 5 else 0)
        for j in range(6):
            a = phase + j * (np.pi / 3.0)
            pts.append((r * np.cos(a), r * np.sin(a), plane))
    pts.append((0.0, 0.0, 0))
    return np.asarray(pts, np.float32)


def _pair_selection(n_bits: int = 256) -> np.ndarray:
    """(n_bits, 2) int32 field pairs: all 903 pairs sorted by distance
    (descending, coarse first), taken at a uniform stride."""
    pat = _retina_pattern()
    pairs = []
    for i in range(len(pat)):
        for j in range(i + 1, len(pat)):
            pairs.append((np.hypot(pat[i, 0] - pat[j, 0], pat[i, 1] - pat[j, 1]), i, j))
    pairs.sort(key=lambda t: -t[0])
    idx = np.linspace(0, len(pairs) - 1, n_bits).round().astype(int)
    return np.asarray([[pairs[k][1], pairs[k][2]] for k in idx], np.int32)


_PLANE_SIGMAS = (1.0, 2.5, 5.0)
@functools.lru_cache(maxsize=1)
def _host_tables() -> tuple:
    pat = _retina_pattern()
    return pat[:, :2].copy(), pat[:, 2].astype(np.int64), _pair_selection().astype(np.int64)


def _tables(device):
    """(field offsets (43, 2), field planes (43,), pairs (256, 2)) on
    ``device`` (``upload_constant`` uploads each once)."""
    return tuple(upload_constant(t, device) for t in _host_tables())


@functools.partial(Program, copy_outputs=True)
def freak_descriptors(img, xy, valid):
    """(packed (N, 8) int32 words of 256-bit codes, invalid rows zero;
    θ (N,) f32)."""
    pat, plane_of, pairs = _tables(img.device)
    planes = [gaussian_blur(img, s, radius=max(2, int(2.5 * s))) for s in _PLANE_SIGMAS]
    theta = orb_orientation(planes[0], xy)
    c, s = torch.cos(theta), torch.sin(theta)
    rot_x = c[:, None] * pat[None, :, 0] - s[:, None] * pat[None, :, 1]
    rot_y = s[:, None] * pat[None, :, 0] + c[:, None] * pat[None, :, 1]
    pos = torch.stack([xy[:, 0:1] + rot_x, xy[:, 1:2] + rot_y], -1)   # (N, 43, 2)
    # every plane at the 43 positions, then each field's own plane
    samples = torch.stack([bilinear_sample(p, pos) for p in planes], -1)   # (N, 43, 3)
    fields = samples.gather(-1, plane_of.expand(xy.shape[0], -1)[..., None])[..., 0]
    bits = (fields[:, pairs[:, 0]] < fields[:, pairs[:, 1]]) & valid[:, None]
    return pack_bits(bits), theta
