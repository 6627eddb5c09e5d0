"""Frozen least-time counts of the port's hand kernels, one file per kernel
(``<kernel>.py``: ``MATCH``, the substring of the kernel's name in a
device trace, and ``bound_s(config)``, the least seconds one launch can take
at the configuration's sizes), and the published peaks they divide by."""

from __future__ import annotations

import importlib

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound(nbytes: float, ops: float) -> float:
    """The least time of ``nbytes`` moved and ``ops`` float32 operations."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def kernel(name: str):
    """The count module of kernel ``name``."""
    return importlib.import_module(f"bench_port.roofline.{name}")


def share(trace: dict, name: str, config: dict):
    """Percent of the roofline that kernel ``name`` reached over a traced
    stretch: its launches times the least time of one, over the device time
    they took. None when the stretch holds no launch of it."""
    if not trace:
        return None
    mod = kernel(name)
    hits = [(n, s) for k, (n, s) in trace["kernels"].items() if mod.MATCH in k]
    launches = sum(n for n, _ in hits)
    seconds = sum(s for _, s in hits)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * mod.bound_s(config) / seconds
