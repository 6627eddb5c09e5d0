"""Masked-table slot allocation — counterpart of
``zenslam_tpu/frontend/tables.py`` (``insert_into_free_slots``,
``allocate_landmark_slots``), and the drop-mode row scatter the tables are
written with. Static shapes, no data-dependent sizes."""

from __future__ import annotations

import torch

_BIG = 1 << 30


def scatter_drop(arr, idx, vals, accumulate: bool = False):
    """arr with rows ``idx`` set (or added) to ``vals``; an index equal to
    len(arr) is dropped (it lands in a spare row that is cut off) — the
    reference's ``.at[idx].set(vals, mode="drop")``."""
    spare = torch.zeros_like(arr[:1])
    buf = torch.cat([arr, spare])
    if not torch.is_tensor(vals):
        vals = torch.full((), vals, dtype=arr.dtype, device=arr.device)  # no host copy
    buf.index_put_((idx.long(),), vals.to(arr.dtype).expand((idx.shape[0],) + arr.shape[1:]),
                   accumulate=accumulate)
    return buf[:-1]


def _rank_by_score_desc(score, valid):
    """Rank among VALID elements by descending score, ties by ascending
    index; invalid elements get _BIG. O(C²) comparison matrix."""
    c = score.shape[0]
    s = torch.where(valid, score, float("-inf"))
    idx = torch.arange(c, device=score.device)
    precedes = (s[None, :] > s[:, None]) | (
        (s[None, :] == s[:, None]) & (idx[None, :] < idx[:, None]))
    rank = (precedes & valid[None, :]).sum(1)
    return torch.where(valid, rank, _BIG)


def _slot_by_rank_from_mask(avail):
    """slot_by_rank[r] = index of the r-th available slot, -1 beyond."""
    n = avail.shape[0]
    a = avail.to(torch.int64)
    pos = torch.cumsum(a, 0) - a
    out = torch.full((n + 1,), -1, dtype=torch.int64, device=avail.device)
    out[torch.where(avail, pos, n)] = torch.arange(n, device=avail.device)
    return out[:n]


def insert_into_free_slots(slot_free, cand_score, cand_valid):
    """The r-th best valid candidate goes to the r-th free slot (ascending
    slot order). Returns (cand_slot (C,) int64 or -1, placed (C,) bool)."""
    n = slot_free.shape[0]
    n_free = slot_free.sum()
    slot_by_rank = _slot_by_rank_from_mask(slot_free)
    rank = _rank_by_score_desc(cand_score, cand_valid)
    placed = cand_valid & (rank < n_free)
    cand_slot = torch.where(placed, slot_by_rank[torch.clamp(rank, 0, n - 1)], -1)
    return cand_slot, placed


def allocate_landmark_slots(lm_valid, lm_last_seen, protect, cand_score, cand_valid):
    """Map slots for new landmarks: free slots first (ascending), then the
    stalest unprotected landmarks (smallest last_seen; equal staleness goes
    to the lower slot index). Returns (cand_slot or -1, placed)."""
    n = lm_valid.shape[0]
    c = cand_score.shape[0]
    dev = lm_valid.device
    free = (~lm_valid) & (~protect)
    n_free = free.sum()
    slot_by_rank = _slot_by_rank_from_mask(free)

    evictable = lm_valid & (~protect)
    staleness = torch.where(evictable, -lm_last_seen.to(torch.float32), float("-inf"))
    k = min(c, n)
    ev_stale, ev_idx = torch.sort(staleness, descending=True, stable=True)
    ev_stale, ev_idx = ev_stale[:k], ev_idx[:k]
    ev_ok = torch.isfinite(ev_stale)
    n_evict = ev_ok.sum()
    tgt = n_free + torch.arange(k, device=dev)
    buf = torch.cat([slot_by_rank, slot_by_rank.new_full((1,), -1)])
    buf[torch.where(tgt < n, tgt, n)] = torch.where(ev_ok, ev_idx, -1)
    slot_by_rank = buf[:n]

    n_avail = n_free + n_evict
    rank = _rank_by_score_desc(cand_score, cand_valid)
    placed = cand_valid & (rank < n_avail)
    cand_slot = torch.where(placed, slot_by_rank[torch.clamp(rank, 0, n - 1)], -1)
    placed = placed & (cand_slot >= 0)
    return cand_slot, placed
