"""Ragged image pyramids and the f32 fallback pyramidal Lucas-Kanade —
counterpart of ``zenslam_tpu/ops/lk.py``.

A ragged pyramid is a tuple of per-level tensors, each at its TRUE size
(the reference pads levels to TPU tile alignment; nothing here needs that).

``lk_forward_backward`` is the gather-based f32 tracker the reference runs
off-TPU: Scharr gradients on full-size stacked buffers, ``_sample_clamped``
bilinear taps, a fixed iteration count with a convergence latch, every level
gating status. It is what the slice is compared against on the CPU. The
kernel path (``ops/lk_cuda.py``) follows the Pallas kernel's semantics
instead. ``pyramidal_lk`` is the one-direction tracker of the reference's
public API on the same core; like the reference's, it runs no kernel.
"""

from __future__ import annotations

import functools

import torch

from zenslam_tpu_torch.ops.image import _pyr_down, build_pyramid, scharr_gradients
from zenslam_tpu_torch.utils.device import resolve_device, upload_constant
from zenslam_tpu_torch.utils.graphs import Program


def ragged_level_sizes(H: int, W: int, levels: int):
    """True (h, w) per pyramid level (decimate-by-2 chain, level 0 = input)."""
    sizes = [(H, W)]
    for _ in range(levels - 1):
        h, w = sizes[-1]
        sizes.append(((h + 1) // 2, (w + 1) // 2))
    return tuple(sizes)


def build_ragged_pyramid_pair(img_l, img_r, levels: int, dtype=torch.float32):
    """Both stereo pyramids in one batched pass; returns (tuple_l, tuple_r) of
    ``levels + 1`` tensors at true level sizes, stored in ``dtype``."""
    cur = torch.stack([img_l, img_r])
    out_l, out_r = [], []
    for lvl in range(levels + 1):
        if lvl:
            cur = _pyr_down(cur)
        p = cur.to(dtype)
        out_l.append(p[0].contiguous())
        out_r.append(p[1].contiguous())
    return tuple(out_l), tuple(out_r)


def empty_ragged_pyramid(H: int, W: int, levels: int, dtype=torch.float32,
                         device=None):
    """Zero ragged pyramid with the shapes build_ragged_pyramid_pair makes,
    on ``device`` (default CUDA, raising when absent)."""
    device = resolve_device(device)
    return tuple(torch.zeros((h, w), dtype=dtype, device=device)
                 for h, w in ragged_level_sizes(H, W, levels + 1))


def ragged_to_stacked(levels_tuple, true_sizes=None):
    """Ragged levels -> ((L, H, W) f32 stack with each level top-left in a
    zero buffer, (L, 2) f32 sizes) — the fallback tracker's format. With
    ``true_sizes`` ((h, w) per level) each level is cropped to its size
    first, as the reference crops its padded levels."""
    if true_sizes is not None:
        levels_tuple = [p[:h, :w] for p, (h, w) in zip(levels_tuple, true_sizes)]
    H, W = levels_tuple[0].shape
    L = len(levels_tuple)
    ref = levels_tuple[0]
    stack = torch.zeros((L, H, W), dtype=torch.float32, device=ref.device)
    for i, p in enumerate(levels_tuple):
        stack[i, :p.shape[0], :p.shape[1]] = p.float()
    sizes = upload_constant(torch.tensor([[p.shape[0], p.shape[1]] for p in levels_tuple],
                                         dtype=torch.float32), ref.device)
    return stack, sizes


def stack_pyramid(pyr):
    """Tuple of (H/2^l, W/2^l) levels -> ((L, H, W) stack, (L, 2) sizes):
    every level at the top-left of a zero (H, W) slice, ``sizes`` its true
    (h, w)."""
    return ragged_to_stacked(pyr)


def stack_gradients(pyr):
    """Per-level Scharr gradients, computed at the true level shapes (so the
    borders are right) and stacked like ``stack_pyramid``: (gx, gy)."""
    grads = [scharr_gradients(p) for p in pyr]
    return (ragged_to_stacked([g[0] for g in grads])[0],
            ragged_to_stacked([g[1] for g in grads])[0])


def build_lk_pyramid(img, levels: int):
    """Image -> (stacked pyramid (levels + 1, H, W), sizes (levels + 1, 2))."""
    return stack_pyramid(build_pyramid(img, levels))


def build_lk_pyramid_pair(img_l, img_r, levels: int):
    """Both stereo pyramids in one batched pyrDown chain, stacked: returns
    (stack_l, stack_r, sizes)."""
    pyr_l, pyr_r = build_ragged_pyramid_pair(img_l, img_r, levels)
    stack_l, sizes = stack_pyramid(pyr_l)
    return stack_l, stack_pyramid(pyr_r)[0], sizes


def _window_offsets(radius: int, device):
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)  # (K, 2)


def _sample_clamped(img, xy, w, h, *more):
    """Bilinear sample with edge replication w.r.t. level bounds (w, h):
    coordinates clamp into [0, w-1.0001] x [0, h-1.0001]. img is the (H, W)
    buffer holding the level at its top-left. Each image in ``more`` (same
    shape) is sampled at the same points with the same weights, and a tuple
    is returned."""
    H, W = img.shape
    x = torch.minimum(torch.clamp(xy[..., 0], min=0.0), w - 1.0001)
    y = torch.minimum(torch.clamp(xy[..., 1], min=0.0), h - 1.0001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    corners = (y0i * W + x0i, y0i * W + x1i, y1i * W + x0i, y1i * W + x1i)
    ax, ay = 1 - wx, 1 - wy

    def sample(im):
        # torch.take: the same gather as advanced indexing, at a fraction of its cost
        flat = im.reshape(-1)
        v00, v01, v10, v11 = (torch.take(flat, i) for i in corners)
        return v00 * ax * ay + v01 * wx * ay + v10 * ax * wy + v11 * wx * wy

    if not more:
        return sample(img)
    return tuple(sample(im) for im in (img, *more))


def _lk_core(prev_stack, prev_gx, prev_gy, next_stack, sizes, pts, init_pts,
             valid, radius: int, iters: int, eps: float, min_eig_threshold: float):
    """Coarse-to-fine LK over stacked levels; positions and flows in
    full-resolution units. Returns (tracked, ok, err of the finest level)."""
    L = prev_stack.shape[0]
    offs = _window_offsets(radius, pts.device)
    n_win = offs.shape[0]
    flow = init_pts - pts
    ok = valid
    err = None
    for lvl in range(L - 1, -1, -1):
        scale = 1.0 / (2.0 ** lvl)
        h, w = sizes[lvl, 0], sizes[lvl, 1]
        prev_img, gx_img, gy_img, next_img = (
            prev_stack[lvl], prev_gx[lvl], prev_gy[lvl], next_stack[lvl])
        pts_l = pts * scale
        win = pts_l[:, None, :] + offs[None, :, :]
        Ip, gx, gy = _sample_clamped(prev_img, win, w, h, gx_img, gy_img)
        gxx = (gx * gx).sum(-1)
        gxy = (gx * gy).sum(-1)
        gyy = (gy * gy).sum(-1)
        det = gxx * gyy - gxy * gxy
        trace = gxx + gyy
        min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) * 0.5
        eig_ok = (min_eig / n_win) > min_eig_threshold
        det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        iG00 = gyy / det_safe
        iG01 = -gxy / det_safe
        iG11 = gxx / det_safe
        converged = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
        for _ in range(iters):
            flow_l = flow * scale
            Jp = _sample_clamped(next_img, win + flow_l[:, None, :], w, h)
            e = Ip - Jp
            bx = (e * gx).sum(-1)
            by = (e * gy).sum(-1)
            dx = iG00 * bx + iG01 * by
            dy = iG01 * bx + iG11 * by
            delta = torch.stack([dx, dy], dim=-1)
            step = torch.where((converged | ~eig_ok)[:, None], 0.0, delta)
            flow = flow + step / scale
            converged = converged | ((delta * delta).sum(-1) < eps * eps)
        flow_l = flow * scale
        if lvl == 0:  # only the finest level's residual is returned
            Jp = _sample_clamped(next_img, win + flow_l[:, None, :], w, h)
            err = (Ip - Jp).abs().mean(-1)
        tracked_l = pts_l + flow_l
        in_b = ((tracked_l[:, 0] >= 1.0) & (tracked_l[:, 0] < w - 1.0)
                & (tracked_l[:, 1] >= 1.0) & (tracked_l[:, 1] < h - 1.0))
        ok = ok & eig_ok & in_b
    tracked = torch.where(valid[:, None], pts + flow, pts)
    return tracked, ok & valid, err


@functools.partial(Program, static_argnames=("radius", "iters"), copy_outputs=True)
def lk_forward_backward(prev_pyramid, next_pyramid, pts, valid, init_pts=None,
                        radius: int = 10, iters: int = 10,
                        fb_threshold: float = 1.0):
    """Forward-backward consistency tracking on (stack, sizes) pyramids:
    track prev→next, then next→prev from the forward result (initialised at
    the original points); accept if the round trip lands within
    ``fb_threshold`` px. Returns (tracked (N,2), ok (N,), err (N,)).
    A captured program: ``fb_threshold`` is keyed by value."""
    prev_stack, sizes = prev_pyramid
    next_stack, _ = next_pyramid
    if init_pts is None:
        init_pts = pts
    pgx, pgy = scharr_gradients(prev_stack)
    ngx, ngy = scharr_gradients(next_stack)
    fwd, ok_f, err = _lk_core(prev_stack, pgx, pgy, next_stack, sizes, pts,
                              init_pts, valid, radius, iters, 0.01, 1e-7)
    bwd, ok_b, _ = _lk_core(next_stack, ngx, ngy, prev_stack, sizes, fwd,
                            pts, valid, radius, iters, 0.01, 1e-7)
    fb_err = torch.linalg.vector_norm(bwd - pts, dim=-1)
    ok = valid & ok_f & ok_b & (fb_err <= fb_threshold)
    return fwd, ok, err


def _is_levels(pyr) -> bool:
    return isinstance(pyr, (tuple, list)) and pyr[0].dim() == 2


@functools.partial(Program, static_argnames=("radius", "iters", "use_initial_flow"),
                   copy_outputs=True)
def pyramidal_lk(prev_pyramid, next_pyramid, pts, valid, init_pts=None, radius: int = 10,
                 iters: int = 10, eps: float = 0.01, min_eig_threshold: float = 1e-7,
                 use_initial_flow: bool = False):
    """Track ``pts`` (N, 2) from the prev to the next image through a
    Gaussian pyramid, coarse to fine. Pyramids are tuples of levels from
    ``ops.image.build_pyramid`` (stacked here, gradients at true level
    shapes) or (stack, sizes) pairs from ``build_lk_pyramid`` (gradients on
    the stacked buffers; each level's padding is masked by its bounds).
    ``init_pts`` seeds the flow only with ``use_initial_flow``. Returns
    (tracked (N, 2), status (N,) bool, err (N,) mean |residual| of the
    finest level).
    A captured program: ``eps`` and ``min_eig_threshold`` are keyed by value."""
    if _is_levels(prev_pyramid):
        prev_stack, sizes = stack_pyramid(prev_pyramid)
        prev_gx, prev_gy = stack_gradients(prev_pyramid)
    else:
        prev_stack, sizes = prev_pyramid
        prev_gx, prev_gy = scharr_gradients(prev_stack)
    next_stack = stack_pyramid(next_pyramid)[0] if _is_levels(next_pyramid) else next_pyramid[0]
    if init_pts is None or not use_initial_flow:
        init_pts = pts
    return _lk_core(prev_stack, prev_gx, prev_gy, next_stack, sizes, pts, init_pts, valid,
                    radius, iters, eps, min_eig_threshold)
