"""Kernel 2: ORB orientation + steered BRIEF on a smoothed bf16 image.

``orb_steered_brief`` is the counterpart of ``zenslam_tpu/ops/orb_pallas.py:
orb_pallas``; on CUDA tensors it launches ``csrc/orb.cu`` (or raises), on
CPU tensors it runs ``orb_steered_brief_plain``. ``orb_steered_brief.launches``
counts kernel launches. ``orb_descriptors_kernel`` is the counterpart of
``orb_descriptors_pallas``: blur + bf16 cast (plain torch), the kernel,
θ = atan2(s, c).
"""

from __future__ import annotations

import ctypes

import torch

from zenslam_tpu_torch.ops import cuda_build
from zenslam_tpu_torch.ops.image import gaussian_blur
from zenslam_tpu_torch.ops.orb import ORB_PATTERN, _PATCH_RADIUS, pack_bits
from zenslam_tpu_torch.utils.graphs import inline_programs

_PATTERNS: dict = {}


def _pattern(device) -> torch.Tensor:
    key = str(device)
    if key not in _PATTERNS:
        _PATTERNS[key] = torch.from_numpy(ORB_PATTERN).to(device).contiguous()
    return _PATTERNS[key]


def _lib():
    lib = cuda_build.load("orb")
    if not getattr(lib, "_typed", False):
        lib.orb_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.orb_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(sm, xy, valid, needs):
    if sm.dim() != 2 or sm.dtype != torch.bfloat16:
        raise TypeError("sm must be a (H, W) bfloat16 image")
    if xy.dim() != 2 or xy.shape[1] != 2 or xy.dtype != torch.float32:
        raise ValueError("xy must be (N, 2) float32")
    n = xy.shape[0]
    for name, m in (("valid", valid), ("needs", needs)):
        if m is not None and (m.shape != (n,) or m.dtype != torch.bool):
            raise ValueError(f"{name} must be (N,) bool")
    if any(t is not None and t.device != xy.device for t in (sm, valid, needs)):
        raise ValueError("all inputs must be on one device")


def orb_steered_brief(sm, xy, valid, needs=None):
    """Packed steered-BRIEF words and the orientation from a pre-smoothed
    bf16 image. sm (H, W) bf16; xy (N, 2) f32; valid (N,) bool; needs
    optional (N,) bool — rows with needs=False are skipped and UNDEFINED.
    Returns (packed (N, 8) int32, cos (N,), sin (N,))."""
    _check(sm, xy, valid, needs)
    dev = xy.device
    if dev.type == "cpu":
        return orb_steered_brief_plain(sm, xy, valid, needs)
    if dev.type != "cuda":
        raise ValueError(f"orb_steered_brief runs on cuda or cpu, not {dev.type}")
    H, W = sm.shape
    n = xy.shape[0]
    sm_c = sm.contiguous()
    xy_c = xy.contiguous()
    valid_c = valid.contiguous()
    needs_c = None if needs is None else needs.contiguous()
    words = torch.empty((n, 8), dtype=torch.int32, device=dev)
    cs = torch.empty((n, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _lib().orb_launch(
            sm_c.data_ptr(), H, W, xy_c.data_ptr(), valid_c.data_ptr(),
            None if needs_c is None else needs_c.data_ptr(),
            _pattern(dev).data_ptr(), n, words.data_ptr(), cs.data_ptr(), stream)
    cuda_build.check(status, "orb")
    orb_steered_brief.launches += 1
    return words, cs[:, 0], cs[:, 1]


orb_steered_brief.launches = 0


def orb_steered_brief_plain(sm, xy, valid, needs=None):
    """Plain PyTorch version of the ``csrc/orb.cu`` kernel (any device).
    Computes every row; ``needs`` only marks which rows the caller keeps."""
    H, W = sm.shape
    r = _PATCH_RADIUS
    dev = xy.device
    img = sm.float()
    flat = img.reshape(-1)
    xc, yc = xy[:, 0], xy[:, 1]
    xi = torch.round(xc).to(torch.int64)
    yi = torch.round(yc).to(torch.int64)
    d = torch.arange(-r, r + 1, device=dev)
    yy = yi[:, None, None] + d[None, :, None]
    xx = xi[:, None, None] + d[None, None, :]
    inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    v = torch.where(inside, flat[(yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))], 0.0)
    df = d.to(torch.float32)
    m10 = (df[None, None, :] * v).sum((1, 2))
    m01 = (df[None, :, None] * v).sum((1, 2))
    nrm = torch.sqrt(m10 * m10 + m01 * m01)
    good = nrm > 1e-12
    c = torch.where(good, m10 / torch.clamp(nrm, min=1e-12), 1.0)
    s = torch.where(good, m01 / torch.clamp(nrm, min=1e-12), 0.0)
    pat = _pattern(dev)

    def sample(px, py):
        qx = (xc[:, None] + px[None, :] * c[:, None]) - py[None, :] * s[:, None]
        qy = (yc[:, None] + px[None, :] * s[:, None]) + py[None, :] * c[:, None]
        kx = torch.clamp(torch.round(qx).to(torch.int64), 0, W - 1)
        ky = torch.clamp(torch.round(qy).to(torch.int64), 0, H - 1)
        return flat[ky * W + kx]

    v1 = sample(pat[:, 0], pat[:, 1])
    v2 = sample(pat[:, 2], pat[:, 3])
    bits = (v1 < v2) & valid[:, None]
    return pack_bits(bits), c, s


@inline_programs
def orb_descriptors_kernel(img, xy, valid, needs=None):
    """Counterpart of ``orb_descriptors_pallas``: blur (σ=2, r=4) and bf16
    cast in plain torch, then ``orb_steered_brief``. Returns (packed (N, 8)
    int32, θ (N,)); with ``needs``, rows outside ``needs & valid`` are
    undefined. A plain wrapper, as the reference's jitted one inlines its
    blur: the blur program runs inline."""
    sm = gaussian_blur(img, sigma=2.0, radius=4).to(torch.bfloat16)
    if needs is not None:
        need = needs & valid
        packed, c, s = orb_steered_brief(sm, xy, need, needs=need)
    else:
        packed, c, s = orb_steered_brief(sm, xy, valid)
    return packed, torch.atan2(s, c)
