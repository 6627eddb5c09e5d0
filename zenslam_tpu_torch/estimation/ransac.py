"""Fixed-iteration RANSAC sampling — counterpart of
``zenslam_tpu/estimation/ransac.py``.

The reference draws Gumbel noise from a JAX key inside the sampler; here the
noise is an input, so a test can hand in the reference's own draws and a run
on the card draws it from a ``torch.Generator`` (``gumbel``).
"""

from __future__ import annotations

import torch


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def ransac_sample_indices(noise, valid, n_sample: int):
    """Gumbel top-k sampling without replacement among valid entries.

    noise: (..., iters, n) Gumbel draws; valid: (..., n) bool. Returns
    (..., iters, n_sample) int64. Ties (fewer than n_sample valid entries)
    go to the lower index, as the reference's top-k orders them; callers
    mask on the valid count."""
    g = torch.where(valid[..., None, :], noise, float("-inf"))
    _, idx = torch.sort(g, dim=-1, descending=True, stable=True)
    return idx[..., :n_sample]


def best_hypothesis(scores):
    """argmax with the tie going to the lowest index, as int32 (the
    reference's ``best_hypothesis``)."""
    return torch.argmax(scores).to(torch.int32)


def take(x, i):
    """x[i] for a 0-d index tensor, kept on the device: indexing by a device
    scalar reads it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def gather_rows(x, idx):
    """x (..., n, d) gathered by idx (..., k, m) along n -> (..., k, m, d)."""
    k, m = idx.shape[-2], idx.shape[-1]
    flat = idx.reshape(idx.shape[:-2] + (k * m,))
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + (x.shape[-1],)))
    return out.reshape(idx.shape + (x.shape[-1],))
