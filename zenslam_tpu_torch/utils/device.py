"""The device rule of the package's entry points and constructors, and the
host<->device copies that do not synchronise."""

from __future__ import annotations

import numpy as np
import torch

from zenslam_tpu_torch.utils import tracing


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
    (``utils/graphs.py``) thus reads the cached tensor, never a pinned
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


def upload(a: np.ndarray, device) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``. To a CUDA device it
    goes through a pinned block without blocking (the caching host
    allocator keeps the block until the copy has run), so it does not
    synchronise; on the CPU it is a copy of its own."""
    t = torch.from_numpy(np.ascontiguousarray(a)).reshape(np.shape(a))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


class HostCopy:
    """A device->host copy started now and read later. On CUDA the tensor is
    copied into pinned memory behind an event, and ``numpy()`` waits on that
    event only; on the CPU it holds a copy (the tensor may be a captured
    program's static output, which the next call overwrites). The wait is a
    ``hostio.wait`` span (``utils/tracing.py``) whose detail is the read's
    kind, serving ``frame`` (default: its parent's)."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf, self._event = t.clone(), None

    def numpy(self, kind: str = "read", frame=None) -> np.ndarray:
        with tracing.span("hostio.wait", kind, frame):
            if self._event is not None:
                self._event.synchronize()
        return self._buf.numpy()
