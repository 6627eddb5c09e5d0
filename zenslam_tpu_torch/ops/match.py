"""Descriptor matching — counterpart of ``zenslam_tpu/ops/match.py``
(``unpack_bits``, ``hamming_matrix``, ``match_descriptors``, ``l2_matrix``,
``match_descriptors_float``, ``lsh_binarize``, ``radius_gate``,
``epipolar_gate``).

Hamming distances come from one product of unpacked bits:
hamming(a, b) = |a| + |b| - 2 a·b, exact in f32 (small integers). The float
(SIFT) family's squared L2 distances come from one product likewise, and
its LSH sign codes from one projection: these products must run in full f32
on the card (TF32 would flip cross-checks and sign bits), which is PyTorch's
default for matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zenslam_tpu_torch.ops.orb import pack_bits
from zenslam_tpu_torch.utils.device import upload_constant
from zenslam_tpu_torch.utils.graphs import Program

BIG = 1 << 20


def unpack_bits(packed):
    """(N, 8) int32 words -> (N, 256) float32 of {0,1}, LSB first."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], 256).to(torch.float32)


@functools.partial(Program, copy_outputs=True)
def hamming_matrix(packed_a, packed_b):
    """Full Hamming distance matrix (N, M) int32."""
    a = unpack_bits(packed_a)
    b = unpack_bits(packed_b)
    na = a.sum(-1)
    nb = b.sum(-1)
    ab = a @ b.T
    return (na[:, None] + nb[None, :] - 2.0 * ab).to(torch.int32)


def _select_matches(D, valid_a, valid_b, max_distance, ratio, cross_check, use_ratio,
                    gate_mask, big):
    """Row/column argmin match selection (argmin ties go to the first index),
    with Lowe's ratio test against each row's second best when
    ``use_ratio``."""
    invalid = (~valid_a[:, None]) | (~valid_b[None, :])
    if gate_mask is not None:
        invalid = invalid | (~gate_mask)
    D = torch.where(invalid, torch.full_like(D, big), D)
    idx_b = torch.argmin(D, dim=1).to(torch.int32)
    best = D.amin(dim=1)
    ok = best <= max_distance
    if use_ratio:
        # the second best: each row's best column set to ``big`` on a copy
        D2 = D.scatter(1, idx_b.long()[:, None], big)
        second = D2.amin(dim=1)
        ok = ok & (best.float() < ratio * second.float())
    if cross_check:
        back = torch.argmin(D, dim=0).to(torch.int32)
        ok = ok & (back[idx_b.long()] == torch.arange(D.shape[0], dtype=torch.int32,
                                                      device=D.device))
    idx_b = torch.where(ok, idx_b, -1)
    return idx_b, best, ok


@functools.partial(Program, static_argnames=("cross_check", "use_ratio"), copy_outputs=True)
def match_descriptors(packed_a, packed_b, valid_a, valid_b, max_distance: int = 64,
                      ratio: float = 0.8, cross_check: bool = True, use_ratio: bool = False,
                      gate_mask=None):
    """Match A to B descriptors, cross-checked and/or with Lowe's ratio test
    (``best < ratio * second``, when ``use_ratio``). gate_mask: optional (N,
    M) bool of allowed pairs. Returns (idx_b (N,) int32 or -1, dist (N,)
    int32, ok (N,) bool).
    A captured program: ``max_distance`` and ``ratio`` are keyed by value."""
    D = hamming_matrix(packed_a, packed_b)
    return _select_matches(D, valid_a, valid_b, max_distance, ratio, cross_check, use_ratio,
                           gate_mask, BIG)


@functools.partial(Program, copy_outputs=True)
def l2_matrix(desc_a, desc_b):
    """Full squared-L2 distance matrix (N, M) f32: |a|² + |b|² - 2 a·b,
    clamped at 0."""
    na = (desc_a * desc_a).sum(-1)
    nb = (desc_b * desc_b).sum(-1)
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * (desc_a @ desc_b.T), min=0.0)


@functools.partial(Program, static_argnames=("cross_check", "use_ratio"), copy_outputs=True)
def match_descriptors_float(desc_a, desc_b, valid_a, valid_b, max_distance: float = 0.35,
                            ratio: float = 0.8, cross_check: bool = True,
                            use_ratio: bool = False, gate_mask=None):
    """L2 matcher for float descriptors; the contract of
    ``match_descriptors`` with a Euclidean (not squared) ``max_distance``,
    the ratio test on Euclidean distances as Lowe's.
    A captured program: ``max_distance`` and ``ratio`` are keyed by value."""
    D = torch.sqrt(l2_matrix(desc_a, desc_b) + 1e-12)
    return _select_matches(D, valid_a, valid_b, max_distance, ratio, cross_check, use_ratio,
                           gate_mask, 1e9)


@functools.lru_cache(maxsize=None)
def _lsh_planes(dim: int = 128, bits: int = 256, seed: int = 77) -> np.ndarray:
    """(dim, bits) f32 random hyperplanes, the reference's numpy draw."""
    rs = np.random.RandomState(seed)
    return rs.normal(0.0, 1.0, size=(dim, bits)).astype(np.float32)


def _planes(dim: int, device) -> torch.Tensor:
    return upload_constant(_lsh_planes(dim), device)


@functools.partial(Program, copy_outputs=True)
def lsh_binarize(desc):
    """(N, D) float descriptors -> (N, 8) int32 words of 256 sign-of-
    projection bits (SimHash), the bit patterns of the reference's uint32
    words. Lets the float family flow through every binary consumer."""
    return pack_bits(desc @ _planes(desc.shape[-1], desc.device) > 0.0)


@functools.partial(Program, copy_outputs=True)
def radius_gate(xy_a, xy_b, radius: float):
    """(N, M) bool mask: ||a - b|| <= radius.
    A captured program: ``radius`` is keyed by value."""
    d2 = ((xy_a[:, None, :] - xy_b[None, :, :]) ** 2).sum(-1)
    return d2 <= radius * radius


@functools.partial(Program, copy_outputs=True)
def epipolar_gate(F, uv_a, uv_b, threshold: float):
    """(N, M) bool mask of pairs within epipolar distance.
    A captured program: ``threshold`` is keyed by value."""
    pa = torch.cat([uv_a, torch.ones_like(uv_a[..., :1])], dim=-1)
    pb = torch.cat([uv_b, torch.ones_like(uv_b[..., :1])], dim=-1)
    lines = pa @ F.T
    num = (lines @ pb.T).abs()
    den = torch.linalg.vector_norm(lines[:, :2], dim=-1, keepdim=True) + 1e-12
    return (num / den) <= threshold
