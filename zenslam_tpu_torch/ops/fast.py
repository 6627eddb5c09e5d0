"""FAST-9/16 scoring and occupancy-grid keypoint selection — counterpart of
``zenslam_tpu/ops/fast.py`` (``fast_score``, ``select_grid_keypoints``,
``detect_grid_keypoints``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from zenslam_tpu_torch.ops.image import maxpool3x3
from zenslam_tpu_torch.utils.graphs import Program

# Bresenham circle of radius 3 (the 16 offsets of FAST_9_16), (dy, dx).
_CIRCLE = np.array([
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
], np.int64)


def _shifted(img, dy: int, dx: int):
    """Shift image by (dy, dx) with edge replication."""
    H, W = img.shape
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[ys][:, xs]


@functools.partial(Program, static_argnames=("arc_length",), copy_outputs=True)
def fast_score(img, threshold: float = 10.0 / 255.0, arc_length: int = 9):
    """Dense FAST-N/16 score: sum over the qualifying arc of |I_c - I_p| - t
    where ≥ arc_length contiguous circle pixels are all brighter or all
    darker than the centre by t; 0 elsewhere. (H, W) f32.
    A captured program: ``threshold`` is keyed by value."""
    center = img
    ring_b = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    ring_d = torch.zeros_like(ring_b)
    score_b = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    score_d = torch.zeros_like(score_b)
    hi = center + threshold
    lo = center - threshold
    for k, (dy, dx) in enumerate(_CIRCLE):
        c = _shifted(img, int(dy), int(dx))
        b = c > hi
        d = c < lo
        ring_b = ring_b | (b.to(torch.int32) << k)
        ring_d = ring_d | (d.to(torch.int32) << k)
        diff = (c - center).abs() - threshold
        score_b = score_b + torch.where(b, diff, 0.0)
        score_d = score_d + torch.where(d, diff, 0.0)

    def has_run(ring):
        r = ring | (ring << 16)
        acc = r
        for k in range(1, arc_length):
            acc = acc & (r >> k)
        return (acc & 0xFFFF) != 0

    is_corner = has_run(ring_b) | has_run(ring_d)
    return torch.where(is_corner, torch.maximum(score_b, score_d), 0.0)


def _top_k_stable(x, k: int):
    """Exact top-k, ties to the lower index (the reference's top-k order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


@functools.partial(Program, static_argnames=("cell_size", "max_keypoints", "border", "subpixel"),
                   copy_outputs=True)
def select_grid_keypoints(score, existing_xy, existing_valid, cell_size: int = 16,
                          max_keypoints: int = 512, border: int = 16,
                          subpixel: bool = False):
    """NMS + one best per unoccupied cell + global top-K into a fixed table.
    Returns (xy (K, 2) f32, score (K,), valid (K,) bool)."""
    H, W = score.shape
    dev = score.device
    raw = score
    score = torch.where(score >= maxpool3x3(score), score, 0.0)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    score = torch.where(in_border, score, 0.0)

    gh, gw = H // cell_size, W // cell_size
    ex = torch.where(existing_valid[:, None], existing_xy, -1e6)
    ci = torch.clamp(torch.floor(ex[:, 1] / cell_size).to(torch.int64), 0, gh - 1)
    cj = torch.clamp(torch.floor(ex[:, 0] / cell_size).to(torch.int64), 0, gw - 1)
    occupancy = torch.zeros(gh * gw, dtype=torch.bool, device=dev)
    # set True where valid; invalid entries write False into a spare slot
    occ = torch.cat([occupancy, occupancy[:1]])
    occ.index_fill_(0, torch.where(existing_valid, ci * gw + cj, gh * gw), True)
    cell_free = ~occ[:gh * gw].reshape(gh, gw)

    s_cells = score[:gh * cell_size, :gw * cell_size].reshape(
        gh, cell_size, gw, cell_size).permute(0, 2, 1, 3).reshape(gh, gw, -1)
    best_in_cell = s_cells.amax(-1)
    best_idx = torch.argmax(s_cells, dim=-1)  # first maximum, as the reference
    by = best_idx // cell_size
    bx = best_idx % cell_size
    cy = torch.arange(gh, device=dev)[:, None] * cell_size + by
    cx = torch.arange(gw, device=dev)[None, :] * cell_size + bx
    cell_score = torch.where(cell_free, best_in_cell, 0.0).reshape(-1)
    cell_xy = torch.stack([cx, cy], dim=-1).reshape(-1, 2).to(torch.float32)

    k = min(max_keypoints, cell_score.shape[0])
    top_score, top_i = _top_k_stable(cell_score, k)
    top_xy = cell_xy[top_i]
    valid = top_score > 0.0
    if subpixel:
        xi = top_xy[:, 0].to(torch.int64)
        yi = top_xy[:, 1].to(torch.int64)

        def at(dy, dx):
            return raw[torch.clamp(yi + dy, 0, H - 1), torch.clamp(xi + dx, 0, W - 1)]

        def parab(lo, c, hi):
            den = lo - 2.0 * c + hi
            safe = torch.where(den < -1e-9, den, torch.ones_like(den))
            off = torch.where(den < -1e-9, 0.5 * (lo - hi) / safe, 0.0)
            return torch.clamp(off, -0.5, 0.5)

        c0 = at(0, 0)
        off = torch.stack([parab(at(0, -1), c0, at(0, 1)),
                           parab(at(-1, 0), c0, at(1, 0))], dim=-1)
        top_xy = top_xy + torch.where(valid[:, None], off, 0.0)
    if k < max_keypoints:
        pad = max_keypoints - k
        top_score = torch.cat([top_score, top_score.new_zeros(pad)])
        top_xy = torch.cat([top_xy, top_xy.new_zeros((pad, 2))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return top_xy, top_score, valid


@functools.partial(Program, static_argnames=("cell_size", "max_keypoints", "border", "subpixel"),
                   copy_outputs=True)
def detect_grid_keypoints(img, existing_xy, existing_valid,
                          threshold: float = 10.0 / 255.0, cell_size: int = 16,
                          max_keypoints: int = 512, mask_radius: float = 8.0,
                          border: int = 16, subpixel: bool = False):
    """FAST + NMS + one best per unoccupied cell + global top-K.
    ``mask_radius`` is kept for the reference's argument order and, as
    there, unused: occupied cells mask the existing keypoints.
    A captured program: ``threshold`` is keyed by value."""
    score = fast_score(img, threshold)
    return select_grid_keypoints(score, existing_xy, existing_valid,
                                 cell_size=cell_size, max_keypoints=max_keypoints,
                                 border=border, subpixel=subpixel)
