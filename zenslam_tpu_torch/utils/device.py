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


def upload_constant(a, device) -> torch.Tensor:
    """A copy of the host array or CPU tensor ``a`` on ``device``. A copy to
    a CUDA device goes from pinned memory without blocking, so it does not
    synchronise (the pinned block is not reused before the copy has run)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
