"""Kernel 1: fused forward+backward pyramidal LK on a ragged pyramid pair.

``lk_ragged`` is the counterpart of ``zenslam_tpu/ops/lk_pallas.py:
lk_ragged_pallas``. On CUDA tensors it launches the hand-written kernel in
``csrc/lk_fb.cu`` (or raises); on CPU tensors it runs ``lk_ragged_plain``,
the plain PyTorch version of the same function. ``lk_ragged.launches``
counts kernel launches.

Sampling semantics (both versions): each continuous tap coordinate is
clamped into [0, h-1] x [0, w-1] and interpolated with f32 weights, rows
first. The Pallas kernel rounds its selector weights and row products to
bf16 on a bf16 pyramid; these versions do not, so they differ from it by a
few hundredths of a pixel (see tests/test_torch_lk.py).
"""

from __future__ import annotations

import ctypes

import torch

from zenslam_tpu_torch.ops import cuda_build

MAX_LEVELS = 8
MAX_CUDA_RADIUS = 15  # csrc/lk_fb.cu: a thread owns one window column, <= 8 of its rows


class _LkPyramid(ctypes.Structure):
    _fields_ = [("level", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS)]


class _LkParams(ctypes.Structure):
    _fields_ = [("n_points", ctypes.c_int), ("levels", ctypes.c_int),
                ("radius", ctypes.c_int), ("iters", ctypes.c_int * MAX_LEVELS),
                ("eps", ctypes.c_float), ("min_eig_threshold", ctypes.c_float),
                ("fb_threshold", ctypes.c_float), ("do_backward", ctypes.c_int),
                ("bwd_levels", ctypes.c_int), ("compute_err", ctypes.c_int)]


def _lib():
    lib = cuda_build.load("lk_fb")
    if not getattr(lib, "_typed", False):
        lib.lk_fb_launch.argtypes = [
            _LkPyramid, _LkPyramid, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, _LkParams, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.lk_fb_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _pyramid_struct(levels):
    s = _LkPyramid()
    for i, p in enumerate(levels):
        s.level[i] = p.data_ptr()
        s.h[i] = p.shape[0]
        s.w[i] = p.shape[1]
    return s


def _normalise(prev_levels, next_levels, pts, valid, init_pts, iters, bwd_levels):
    levels = len(prev_levels)
    if len(next_levels) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"need 1..{MAX_LEVELS} levels in both pyramids")
    for a, b in zip(prev_levels, next_levels):
        if a.shape != b.shape or a.dim() != 2 or a.dtype != b.dtype:
            raise ValueError("pyramid levels must be matching 2-D tensors")
        if a.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"pyramid dtype {a.dtype} (bf16 or f32 only)")
    if pts.dim() != 2 or pts.shape[1] != 2 or pts.dtype != torch.float32:
        raise ValueError("pts must be (N, 2) float32")
    if valid.shape != (pts.shape[0],) or valid.dtype != torch.bool:
        raise ValueError("valid must be (N,) bool")
    if init_pts is None:
        init_pts = pts
    if init_pts.shape != pts.shape or init_pts.dtype != torch.float32:
        raise ValueError("init_pts must match pts")
    if isinstance(iters, int):
        iters = (iters,) * levels
    iters = tuple(int(i) for i in iters)
    if len(iters) != levels:
        raise ValueError("iters needs one count per level")
    if bwd_levels <= 0:
        bwd_levels = levels
    return levels, init_pts, iters, bwd_levels


def lk_ragged(prev_levels, next_levels, pts, valid, init_pts=None, radius: int = 10,
              iters=10, eps: float = 0.01, min_eig_threshold: float = 1e-7,
              fb_threshold: float = 1.0, do_backward: bool = True,
              bwd_levels: int = 0, compute_err: bool = True):
    """Fused forward(+backward) pyramidal LK on ragged level tuples.

    prev_levels/next_levels: tuples of (h_l, w_l) bf16 or f32 tensors, level
    0 first, at true sizes. pts/init_pts (N, 2) f32; valid (N,) bool.
    iters: int (uniform) or fine→coarse per-level tuple. bwd_levels: the
    backward pass refines only the finest k levels (0 = all). The kernel
    takes radius <= MAX_CUDA_RADIUS (the Pallas kernel's 32-row tile holds
    the 2r+3 template rows, so r <= 14 there).
    Returns (tracked (N, 2) f32, ok (N,) bool, err (N,) f32)."""
    levels, init_pts, iters, bwd_levels = _normalise(
        prev_levels, next_levels, pts, valid, init_pts, iters, bwd_levels)
    dev = pts.device
    if any(t.device != dev for t in (*prev_levels, *next_levels, valid, init_pts)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return lk_ragged_plain(prev_levels, next_levels, pts, valid, init_pts,
                               radius, iters, eps, min_eig_threshold,
                               fb_threshold, do_backward, bwd_levels, compute_err)
    if dev.type != "cuda":
        raise ValueError(f"lk_ragged runs on cuda or cpu, not {dev.type}")
    if not 0 <= radius <= MAX_CUDA_RADIUS:
        raise ValueError(f"the LK kernel takes radius 0..{MAX_CUDA_RADIUS}, not {radius}")
    prev_levels = tuple(p.contiguous() for p in prev_levels)
    next_levels = tuple(p.contiguous() for p in next_levels)
    pts_c = pts.contiguous()
    init_c = init_pts.contiguous()
    valid_c = valid.contiguous()
    n = pts.shape[0]
    out_xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_ok = torch.empty((n,), dtype=torch.bool, device=dev)
    out_err = torch.empty((n,), dtype=torch.float32, device=dev)
    params = _LkParams()
    params.n_points = n
    params.levels = levels
    params.radius = int(radius)
    for i, it in enumerate(iters):
        params.iters[i] = it
    params.eps = eps
    params.min_eig_threshold = min_eig_threshold
    params.fb_threshold = fb_threshold
    params.do_backward = int(bool(do_backward))
    params.bwd_levels = int(bwd_levels)
    params.compute_err = int(bool(compute_err))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _lib().lk_fb_launch(
            _pyramid_struct(prev_levels), _pyramid_struct(next_levels),
            pts_c.data_ptr(), init_c.data_ptr(), valid_c.data_ptr(), params,
            int(prev_levels[0].dtype == torch.bfloat16), out_xy.data_ptr(),
            out_ok.data_ptr(), out_err.data_ptr(), stream)
    cuda_build.check(status, "lk_fb")
    lk_ragged.launches += 1
    return out_xy, out_ok, out_err


lk_ragged.launches = 0


# --------------------------------------------------------------------------
# Plain PyTorch version: the same function, batched over points.

def _centre_in(px, py, h: int, w: int):
    return (px >= 1.0) & (py >= 1.0) & (px <= w - 2.0) & (py <= h - 2.0)


def _sample_grid(img, xs, ys):
    """Bilinear samples of a (h, w) f32 level on separable grids: xs (N, A),
    ys (N, B) continuous coordinates -> (N, B, A). Coordinates clamp into the
    level; rows interpolate first, then columns."""
    h, w = img.shape
    x = torch.clamp(xs, 0.0, float(w - 1))
    y = torch.clamp(ys, 0.0, float(h - 1))
    xf = torch.floor(x)
    yf = torch.floor(y)
    ax = (x - xf)[:, None, :]
    ay = (y - yf)[:, :, None]
    x0 = xf.to(torch.int64)
    y0 = yf.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(-1)
    r0 = (y0 * w)[:, :, None]
    r1 = (y1 * w)[:, :, None]
    c0 = x0[:, None, :]
    c1 = x1[:, None, :]
    m0 = (1.0 - ay) * flat[r0 + c0] + ay * flat[r1 + c0]
    m1 = (1.0 - ay) * flat[r0 + c1] + ay * flat[r1 + c1]
    return (1.0 - ax) * m0 + ax * m1


def _track_plain(src, dst, sx, sy, fx, fy, ok_in, lvls, iters, radius, eps,
                 min_eig_threshold, want_err, work):
    G = 2 * radius + 3
    n_win = float((2 * radius + 1) ** 2)
    dev = sx.device
    grid = torch.arange(G, dtype=torch.float32, device=dev)
    inner = grid[1:G - 1]
    ok = ok_in
    err = torch.zeros_like(sx)
    for lvl in lvls:
        simg = src[lvl].float()
        dimg = dst[lvl].float()
        h, w = simg.shape
        scale = torch.tensor(1.0 / (1 << lvl), dtype=torch.float32, device=dev)
        px = sx * scale
        py = sy * scale
        lvl_ok = _centre_in(px, py, h, w)
        S = _sample_grid(simg, grid[None, :] + ((px - radius) - 1.0)[:, None],
                         grid[None, :] + ((py - radius) - 1.0)[:, None])
        I = S[:, 1:G - 1, 1:G - 1]
        gx = (S[:, 1:G - 1, 2:] - S[:, 1:G - 1, :G - 2]) * 0.5
        gy = (S[:, 2:, 1:G - 1] - S[:, :G - 2, 1:G - 1]) * 0.5
        gxx = (gx * gx).sum((1, 2))
        gxy = (gx * gy).sum((1, 2))
        gyy = (gy * gy).sum((1, 2))
        det = gxx * gyy - gxy * gxy
        tr = gxx + gyy
        min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
        eig_ok = (min_eig / n_win) > min_eig_threshold
        det_s = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        iG00 = gyy / det_s
        iG01 = -gxy / det_s
        iG11 = gxx / det_s
        can = ok_in & lvl_ok & eig_ok
        conv = torch.zeros_like(can)
        if work is not None:
            work["grid_samples"] += sx.shape[0] * G * G
        for _ in range(iters[lvl]):
            if work is not None:  # the kernel samples only while can & ~conv
                work["window_samples"] += int((can & ~conv).sum()) * (G - 2) ** 2
            tx = (sx + fx) * scale
            ty = (sy + fy) * scale
            t_ok = _centre_in(tx, ty, h, w)
            J = _sample_grid(dimg, inner[None, :] + ((tx - radius) - 1.0)[:, None],
                             inner[None, :] + ((ty - radius) - 1.0)[:, None])
            e = I - J
            bx = (e * gx).sum((1, 2))
            by = (e * gy).sum((1, 2))
            dx = iG00 * bx + iG01 * by
            dy = iG01 * bx + iG11 * by
            act = can & ~conv & t_ok
            fx = fx + torch.where(act, dx / scale, 0.0)
            fy = fy + torch.where(act, dy / scale, 0.0)
            conv = conv | (dx * dx + dy * dy < eps * eps) | ~t_ok
        if lvl == 0:
            qx = sx + fx
            qy = sy + fy
            if want_err:
                if work is not None:
                    work["window_samples"] += sx.shape[0] * (G - 2) ** 2
                J = _sample_grid(dimg, inner[None, :] + ((qx - radius) - 1.0)[:, None],
                                 inner[None, :] + ((qy - radius) - 1.0)[:, None])
                err = (I - J).abs().sum((1, 2)) / n_win
            ok = can & _centre_in(qx, qy, h, w)
    return fx, fy, ok, err


def lk_ragged_plain(prev_levels, next_levels, pts, valid, init_pts=None,
                    radius: int = 10, iters=10, eps: float = 0.01,
                    min_eig_threshold: float = 1e-7, fb_threshold: float = 1.0,
                    do_backward: bool = True, bwd_levels: int = 0,
                    compute_err: bool = True, work: dict | None = None):
    """Plain PyTorch version of the ``csrc/lk_fb.cu`` kernel (any device).
    work: optional dict; when given, it accumulates the bilinear samples the
    kernel takes on these inputs ("grid_samples" for templates,
    "window_samples" for Newton steps and residuals)."""
    if work is not None:
        work.setdefault("grid_samples", 0)
        work.setdefault("window_samples", 0)
    levels, init_pts, iters, bwd_levels = _normalise(
        prev_levels, next_levels, pts, valid, init_pts, iters, bwd_levels)
    x0, y0 = pts[:, 0], pts[:, 1]
    fx = init_pts[:, 0] - x0
    fy = init_pts[:, 1] - y0
    args = (radius, eps, min_eig_threshold)
    fx, fy, okf, err = _track_plain(prev_levels, next_levels, x0, y0, fx, fy, valid,
                                    range(levels - 1, -1, -1), iters, *args,
                                    want_err=compute_err, work=work)
    ok_out = okf
    if do_backward:
        bl = min(bwd_levels, levels)
        bx, by, okb, _ = _track_plain(next_levels, prev_levels, x0 + fx, y0 + fy,
                                      -fx, -fy, okf, range(bl - 1, -1, -1), iters,
                                      *args, want_err=False, work=work)
        ex = fx + bx
        ey = fy + by
        ok_out = okf & okb & (ex * ex + ey * ey <= fb_threshold * fb_threshold)
    xy = torch.stack([torch.where(valid, x0 + fx, x0),
                      torch.where(valid, y0 + fy, y0)], dim=-1)
    return xy, ok_out & valid, err
