"""Ragged image pyramids and the f32 fallback pyramidal Lucas-Kanade —
counterpart of ``zenslam_tpu/ops/lk.py``.

A ragged pyramid is a tuple of per-level tensors, each at its TRUE size
(the reference pads levels to TPU tile alignment; nothing here needs that).

``lk_forward_backward`` is the gather-based f32 tracker the reference runs
off-TPU: Scharr gradients on full-size stacked buffers, ``_sample_clamped``
bilinear taps, a fixed iteration count with a convergence latch, every level
gating status. It is what the slice is compared against on the CPU. The
kernel path (``ops/lk_cuda.py``) follows the Pallas kernel's semantics
instead.
"""

from __future__ import annotations

import torch

from zenslam_tpu_torch.ops.image import _pyr_down, scharr_gradients


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
                         device="cpu"):
    """Zero ragged pyramid with the shapes build_ragged_pyramid_pair makes."""
    return tuple(torch.zeros((h, w), dtype=dtype, device=device)
                 for h, w in ragged_level_sizes(H, W, levels + 1))


def ragged_to_stacked(levels_tuple):
    """Ragged levels -> ((L, H, W) f32 stack with each level top-left in a
    zero buffer, (L, 2) f32 sizes) — the fallback tracker's format."""
    H, W = levels_tuple[0].shape
    L = len(levels_tuple)
    ref = levels_tuple[0]
    stack = torch.zeros((L, H, W), dtype=torch.float32, device=ref.device)
    for i, p in enumerate(levels_tuple):
        stack[i, :p.shape[0], :p.shape[1]] = p.float()
    sizes = torch.tensor([[p.shape[0], p.shape[1]] for p in levels_tuple],
                         dtype=torch.float32, device=ref.device)
    return stack, sizes


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
        scale = torch.tensor(1.0 / (2.0 ** lvl), dtype=torch.float32, device=pts.device)
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


def lk_forward_backward(prev_pyramid, next_pyramid, pts, valid, init_pts=None,
                        radius: int = 10, iters: int = 10,
                        fb_threshold: float = 1.0):
    """Forward-backward consistency tracking on (stack, sizes) pyramids:
    track prev→next, then next→prev from the forward result (initialised at
    the original points); accept if the round trip lands within
    ``fb_threshold`` px. Returns (tracked (N,2), ok (N,), err (N,))."""
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
