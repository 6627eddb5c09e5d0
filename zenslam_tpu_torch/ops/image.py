"""Image ops: gray conversion, Gaussian blur, pyrDown pyramid, bilinear
sampling and remap, CLAHE, Scharr gradients — counterpart of
``zenslam_tpu/ops/image.py``. Images are float tensors (H, W) or (B, H, W)
in [0, 1].

The separable filters are shift-and-add with reflect padding in the same tap
order as the reference. XLA's CPU backend contracts each tap's multiply-add
into a fused multiply-add; ``fma`` reproduces that rounding (in float64 on
the CPU, with one fused float32 op on CUDA), so the CPU results agree with
the reference bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from zenslam_tpu_torch.utils.graphs import Program


def rgb_to_gray(img):
    """(..., H, W, 3) uint8 or [0, 1] float -> (..., H, W) float32 in [0, 1]."""
    scale = 1.0 / 255.0 if img.dtype == torch.uint8 else 1.0
    img = img.to(torch.float32) * scale
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
    return torch.einsum("...c,c->...", img, w)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_pad(img, r: int, dim: int):
    """Reflect-pad the last (dim=-1) or second-to-last (dim=-2) axis by r."""
    if dim == -2:
        top = img[..., 1:r + 1, :].flip(-2)
        bot = img[..., -r - 1:-1, :].flip(-2)
        return torch.cat([top, img, bot], dim=-2)
    left = img[..., :, 1:r + 1].flip(-1)
    right = img[..., :, -r - 1:-1].flip(-1)
    return torch.cat([left, img, right], dim=-1)


def _fma_f64(a, b, c):
    """a*b + c rounded once to float32, emulated in float64 (the float64
    product of two float32 values is exact); ``a`` a float32 tensor or a
    float32-exact Python float."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    return (a * b.double() + c.double()).float()


def _fma_fused(a, b, c):
    """a*b + c as one fused float32 op on CUDA: ``add`` with a scalar
    ``alpha`` (``c + alpha * b``) or ``addcmul`` for two tensors."""
    if isinstance(a, torch.Tensor):
        return torch.addcmul(c, a, b)
    return torch.add(c, b, alpha=a)


def fma(a, b, c):
    """a*b + c rounded once to float32, as a fused multiply-add rounds it:
    the fused op on CUDA tensors, the float64 emulation on the CPU, where
    torch's kernels need not fuse."""
    if b.device.type == "cuda":
        return _fma_fused(a, b, c)
    return _fma_f64(a, b, c)


def _shift_add(x, kernel, n: int, dim: int):
    """Σ_i k_i·x[i:i+n] along ``dim`` as the reference's compiled form
    evaluates it: fma(k0, x0, k1·x1), then fma(k_i, x_i, acc)."""
    def tap(i):
        return x[..., i:i + n, :] if dim == -2 else x[..., :, i:i + n]

    k = [float(np.float32(v)) for v in kernel]   # the float32 weights
    acc = fma(k[0], tap(0), k[1] * tap(1))
    for i in range(2, len(k)):
        acc = fma(k[i], tap(i), acc)
    return acc


def _sep_filter2(img, krow, kcol):
    """Separable filter (rows with krow, then columns with kcol), reflect
    padding, as shift-and-add."""
    r = len(krow) // 2
    y = _shift_add(_reflect_pad(img, r, -2), krow, img.shape[-2], -2)
    c = len(kcol) // 2
    return _shift_add(_reflect_pad(y, c, -1), kcol, img.shape[-1], -1)


@functools.partial(Program, static_argnames=("sigma", "radius"), copy_outputs=True)
def gaussian_blur(img, sigma: float = 1.0, radius: int = 2):
    """Separable Gaussian blur with reflect padding. img: (H, W) or (B, H, W)."""
    k = _gaussian_kernel1d(sigma, radius)
    return _sep_filter2(img, k, k)


_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _down_matrix(n: int) -> np.ndarray:
    """(ceil(n/2), n) strided binomial operator: row i holds the 5-tap
    pyrDown kernel centred at column 2i, edges renormalised."""
    m = (n + 1) // 2
    D = np.zeros((m, n), np.float32)
    for i in range(m):
        c = 2 * i
        lo = max(c - 2, 0)
        hi = min(c + 3, n)
        w = _PYR_K[lo - (c - 2): 5 - ((c + 3) - hi)]
        D[i, lo:hi] = w / w.sum()
    return D


_DOWN_CACHE: dict = {}


def _down_tensor(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _DOWN_CACHE:
        _DOWN_CACHE[key] = torch.from_numpy(_down_matrix(n)).to(device)
    return _DOWN_CACHE[key]


def _pyr_down(img):
    """Blur with the pyrDown kernel and decimate by 2: D_h @ img @ D_wᵀ.
    img: (..., H, W) float32."""
    H, W = img.shape[-2], img.shape[-1]
    Dh = _down_tensor(H, img.device)
    Dw = _down_tensor(W, img.device)
    return torch.matmul(torch.matmul(Dh, img), Dw.T)


@functools.partial(Program, static_argnames=("levels",), copy_outputs=True)
def build_pyramid(img, levels: int = 4):
    """Gaussian pyramid, level 0 = input. Returns a tuple of tensors."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(_pyr_down(pyr[-1]))
    return tuple(pyr)


def bilinear_sample(img, xy, pad_value: float = 0.0):
    """Bilinearly sample img (H, W) at xy (..., 2) in (x, y) pixel
    coordinates, as a gather of the four corners; a corner outside the image
    contributes ``pad_value``."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)

    def at(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = torch.take(flat, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        return torch.where(valid, v, torch.full_like(v, pad_value))

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


@functools.partial(Program, copy_outputs=True)
def remap(img, map_x, map_y):
    """cv::remap analogue: out[i, j] = img(map_x[i, j], map_y[i, j]),
    bilinear, zero outside (the rectification maps of io/calibration.py)."""
    return bilinear_sample(img, torch.stack([map_x, map_y], dim=-1))


@functools.partial(Program, static_argnames=("grid", "nbins"), copy_outputs=True)
def clahe(img, clip_limit: float = 4.0, grid: int = 8, nbins: int = 256):
    """Contrast-limited adaptive histogram equalization (OpenCV's CLAHE):
    per-tile histogram, clip and redistribute the excess uniformly, CDF
    lookup, bilinear blend of the four neighbouring tiles' mappings.

    img: (H, W) float32 in [0, 1], H and W divisible by ``grid``. The bin is
    ``int(img * (nbins - 1))`` (truncation, as the reference), so the caller's
    scaling of 8-bit data decides the bins. Histograms are counted by
    ``index_add_`` of ones over (tile, bin): integer counts in f32, exact in
    any order of the atomics (``bincount`` would read its input's maximum
    back to the host on CUDA).
    A captured program: ``clip_limit`` is keyed by value."""
    H, W = img.shape
    th, tw = H // grid, W // grid
    q = torch.clamp((img * (nbins - 1)).to(torch.int64), 0, nbins - 1)
    tile = (torch.arange(H, device=img.device) // th)[:, None] * grid \
        + (torch.arange(W, device=img.device) // tw)[None, :]
    flat = (tile * nbins + q).reshape(-1)
    hist = torch.zeros(grid * grid * nbins, dtype=torch.float32, device=img.device)
    hist = hist.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                               device=img.device)).reshape(grid, grid, nbins)
    limit = clip_limit * (th * tw) / nbins
    excess = torch.clamp(hist - limit, min=0.0).sum(-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    lut = (cdf / cdf[..., -1:]).reshape(-1)   # (grid * grid * nbins) bin -> [0, 1]

    yy = (torch.arange(H, dtype=torch.float32, device=img.device) + 0.5) / th - 0.5
    xx = (torch.arange(W, dtype=torch.float32, device=img.device) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy), 0, grid - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xx), 0, grid - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]

    def lookup(ti, tj):
        return torch.take(lut, (ti[:, None] * grid + tj[None, :]) * nbins + q)

    return (lookup(y0, x0) * (1 - fy) * (1 - fx) + lookup(y0, x1) * (1 - fy) * fx
            + lookup(y1, x0) * fy * (1 - fx) + lookup(y1, x1) * fy * fx)


@functools.partial(Program, copy_outputs=True)
def scharr_gradients(img):
    """Scharr x/y gradients with reflect padding, scale 1/32."""
    smooth = np.array([3.0, 10.0, 3.0]) / 16.0
    diff = np.array([-1.0, 0.0, 1.0]) / 2.0
    gx = _sep_filter2(img, smooth, diff)
    gy = _sep_filter2(img, diff, smooth)
    return gx, gy


def maxpool3x3(score):
    """3x3 max over a (H, W) map with -inf outside (SAME window)."""
    return F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
