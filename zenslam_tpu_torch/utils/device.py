"""The device rule of the package's entry points and constructors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    Never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "zenslam_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_CONSTANTS: dict = {}


def upload_constant(a, device) -> torch.Tensor:
    """The host array or CPU tensor ``a`` on ``device``, uploaded once per
    (value, device) and cached: every later call with an equal value returns
    the same tensor, which callers must not modify. A captured program
    (``pipeline/graphs.py``) thus reads the cached tensor, never a pinned
    host block freed after its capture. The upload to a CUDA device goes
    from pinned memory without blocking, so it does not synchronise."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    dev = torch.device(device)
    key = (str(dev), t.dtype, tuple(t.shape), t.contiguous().numpy().tobytes())
    hit = _CONSTANTS.get(key)
    if hit is None:
        if dev.type == "cuda":
            hit = t.pin_memory().to(dev, non_blocking=True)
        else:
            hit = t.to(dev, copy=True)
        _CONSTANTS[key] = hit
    return hit
