"""Host-spill landmark archive with frustum-gated reload on revisit —
counterpart of ``zenslam_tpu/backend/map_archive.py``.

The live ``LandmarkMap`` is a fixed-capacity LRU table. Every keyframe the
system packs it into one int32 matrix (``_pack_live``) and the host archive
upserts it, keyed by (slot, generation): recycled slots turn their archived
rows dormant. Dormant landmarks that project into the current frustum are
re-inserted into the live table (``reload_into_map``) through the
front end's LRU allocator, with fresh generations.

The archive is host numpy with the reference's dtypes (uint32 descriptor
words, float32 for the SIFT family);
it is this package's own copy of that host code. A reload's candidates go
up in one pinned block of ``reload_max`` rows and its outcome comes back
through a pinned copy behind an event, so it does not synchronise; the
system runs its insert (``_reload_body``) as a captured program.
``reload_into_map`` and ``_pack_live`` are captured programs
(``utils/graphs.py``), as the reference jits them; the frame index and
``protect_recent`` are traced (Python ints go up as device scalars).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zenslam_tpu_torch.frontend.tables import allocate_landmark_slots, scatter_drop
from zenslam_tpu_torch.utils.device import HostCopy, upload
from zenslam_tpu_torch.utils.graphs import Program


@functools.partial(Program, scalar_argnames=("frame_idx", "protect_recent"), copy_outputs=True)
def reload_into_map(lmap, xyz, desc, valid, frame_idx, color=None, protect_recent: int = 2):
    """Insert (reload_max,)-padded archived landmarks into free or LRU slots;
    landmarks seen within ``protect_recent`` frames are not evicted. Returns
    (new_lmap, slots (R,) int64 or -1, placed (R,) bool)."""
    M = lmap.valid.shape[0]
    protect = lmap.valid & (lmap.last_seen >= frame_idx - protect_recent)
    score = torch.where(valid, 1.0, float("-inf"))
    slot, placed = allocate_landmark_slots(lmap.valid, lmap.last_seen, protect, score, valid)
    sl = torch.where(placed, slot, M)
    if color is None:
        color = torch.zeros(xyz.shape[0], dtype=torch.float32, device=xyz.device)
    lmap = lmap._replace(
        xyz=scatter_drop(lmap.xyz, sl, xyz), desc=scatter_drop(lmap.desc, sl, desc),
        valid=scatter_drop(lmap.valid, sl, placed),
        last_seen=scatter_drop(lmap.last_seen, sl, frame_idx),
        n_obs=scatter_drop(lmap.n_obs, sl, 1),
        generation=scatter_drop(lmap.generation, sl, 1, accumulate=True),
        color=scatter_drop(lmap.color, sl, color))
    return lmap, slot, placed


def _reload_body(lmap, cand):
    """``reload_into_map`` on a packed candidate block: ``cand`` is int32
    [frame index, then (R, 5 + D) rows of xyz, colour and the valid flag as
    f32 bit patterns and the descriptor (int32 words, or a float family's
    f32 bit patterns)]. Returns (new lmap, [slot (R), placed (R), new
    generation (R)] as f32)."""
    f32 = torch.float32
    rows = cand[1:].reshape(-1, 5 + lmap.desc[0].numel())
    R = rows.shape[0]
    meta = rows[:, :5].view(f32)
    desc = rows[:, 5:]
    if lmap.desc.is_floating_point():
        desc = desc.view(f32)
    desc = desc.reshape((R,) + lmap.desc.shape[1:])
    new_lmap, slot, placed = reload_into_map(lmap, meta[:, :3], desc, meta[:, 4] > 0.5, cand[0],
                                             color=meta[:, 3])
    aux = torch.cat([slot.to(f32), placed.to(f32),
                     new_lmap.generation[slot.clamp(min=0)].to(f32)])
    return new_lmap, aux


@functools.partial(Program, copy_outputs=True)
def _pack_live(lmap) -> torch.Tensor:
    """The live table as ONE (M, 6 + D) int32 matrix: valid, generation,
    xyz and colour as f32 bit patterns, then the descriptor (int32 words, or
    the f32 bit patterns of a float family's descriptor). An integer carrier
    keeps descriptor words that happen to be NaN patterns intact; its bytes
    equal the reference's uint32 matrix."""
    f32 = torch.float32
    meta = torch.cat([lmap.valid.to(f32)[:, None], lmap.generation.to(f32)[:, None],
                      lmap.xyz.to(f32), lmap.color.to(f32)[:, None]], dim=1)
    desc = lmap.desc
    if desc.is_floating_point():
        desc = desc.view(torch.int32)
    return torch.cat([meta.view(torch.int32), desc.reshape(desc.shape[0], -1)], dim=1)


class LandmarkArchive:
    """Growable host-side landmark store (numpy), owned by the system next
    to the keyframe DB. ``_slot_row``/``_slot_gen`` mirror the live table's
    occupancy, so a sync touches only the slots that changed."""

    def __init__(self, desc_shape=(8,), desc_dtype=np.uint32):
        self.xyz = np.zeros((0, 3), np.float32)
        self.color = np.zeros(0, np.float32)
        self.desc = np.zeros((0,) + tuple(desc_shape), desc_dtype)
        self.dormant = np.zeros(0, bool)       # True = not in the live map
        self._key_to_row = {}                  # (slot, generation) -> row
        self._row_key = []                     # row -> live key or None
        self._slot_row = None                  # (M,) archive row per slot, -1
        self._slot_gen = None                  # (M,) generation per slot, -1
        self.n_reloads = 0
        self.n_spills = 0
        self.reload_keys = set()               # (slot, gen) created by reload

    def __len__(self):
        return len(self.xyz)

    def _ensure_slot_maps(self, M: int):
        if self._slot_row is not None and len(self._slot_row) == M:
            return
        self._slot_row = np.full(M, -1, np.int64)
        self._slot_gen = np.full(M, -1, np.int64)
        for (slot, gen), row in self._key_to_row.items():
            self._slot_row[slot] = row
            self._slot_gen[slot] = gen

    def _displace(self, rows):
        """Mark archive rows dormant (their slot got a new occupant)."""
        rows = rows[rows >= 0]
        if not len(rows):
            return
        newly = ~self.dormant[rows]
        self.dormant[rows] = True
        self.n_spills += int(newly.sum())
        for r in rows:
            k = self._row_key[r]
            if k is not None:
                self._key_to_row.pop(k, None)
                self._row_key[int(r)] = None

    def sync(self, lmap) -> None:
        """Upsert the live map (one device->host copy)."""
        self.sync_packed(_pack_live(lmap).cpu().numpy())

    def sync_packed(self, arr: np.ndarray) -> None:
        """``sync`` from a fetched ``_pack_live`` matrix (int32 or uint32)."""
        arr = np.ascontiguousarray(arr).view(np.uint32)
        M = arr.shape[0]
        meta = np.ascontiguousarray(arr[:, :6]).view(np.float32)
        valid = meta[:, 0] > 0.5
        gen = meta[:, 1].astype(np.int64)
        xyz = meta[:, 2:5]
        col = meta[:, 5]
        draw = np.ascontiguousarray(arr[:, 6:])
        if self.desc.dtype != np.uint32:
            draw = draw.view(np.float32).astype(self.desc.dtype)
        desc = draw.reshape((M,) + self.desc.shape[1:])

        self._ensure_slot_maps(M)
        changed = valid & (gen != self._slot_gen)
        vanished = (~valid) & (self._slot_row >= 0)
        self._displace(self._slot_row[changed | vanished])
        self._slot_row[vanished] = -1
        self._slot_gen[vanished] = -1
        keep = valid & ~changed & (self._slot_row >= 0)
        if keep.any():
            self.xyz[self._slot_row[keep]] = xyz[keep]
        new_slots = np.nonzero(changed)[0]
        if len(new_slots):
            base = len(self.xyz)
            self.xyz = np.concatenate([self.xyz, xyz[new_slots]])
            self.desc = np.concatenate([self.desc, desc[new_slots]])
            self.color = np.concatenate([self.color, col[new_slots]])
            self.dormant = np.concatenate([self.dormant, np.zeros(len(new_slots), bool)])
            for i, sl in enumerate(new_slots):
                key = (int(sl), int(gen[sl]))
                self._key_to_row[key] = base + i
                self._row_key.append(key)
            self._slot_row[new_slots] = base + np.arange(len(new_slots))
            self._slot_gen[new_slots] = gen[new_slots]

    def reload(self, lmap, R_cw, t_cw, cam, frame_idx, reload_max: int = 128,
               radius: float = 50.0, margin: float = 0.0, insert=_reload_body):
        """Frustum-gated reload of dormant landmarks near the current pose,
        nearest first. Returns the updated LandmarkMap (the same object when
        nothing is reloaded). ``cam`` is the left PinholeCamera. ``insert``
        runs the insert as ``_reload_body`` does (the system passes its
        captured program, returning tensors of its own)."""
        if not self.dormant.any():
            return lmap
        rows = np.nonzero(self.dormant)[0]
        X = self.xyz[rows]
        pose = HostCopy(torch.cat([R_cw.detach().reshape(9),
                                   t_cw.detach().reshape(3)])).numpy("reload")
        R = pose[:9].reshape(3, 3).astype(np.float32)
        t = pose[9:].astype(np.float32)
        xc = X @ R.T + t
        z = xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = float(cam.fx) * xc[:, 0] / z + float(cam.cx)
            v = float(cam.fy) * xc[:, 1] / z + float(cam.cy)
        W, H = int(cam.width), int(cam.height)
        ok = (z > 0.1) & (np.linalg.norm(xc, axis=-1) < radius)
        if W > 0 and H > 0:
            ok &= (u >= -margin) & (u < W + margin) & (v >= -margin) & (v < H + margin)
        cand = rows[ok]
        if len(cand) == 0:
            return lmap
        order = np.argsort(np.linalg.norm(xc[ok], axis=-1))
        cand = cand[order][:reload_max]

        K = reload_max
        n = len(cand)
        # one pinned block of reload_max rows: [frame index, then per row xyz,
        # colour, valid (f32 bits) and the descriptor words]
        D = int(np.prod(self.desc.shape[1:]))
        block = np.zeros(1 + K * (5 + D), np.int32)
        block[0] = int(frame_idx)
        rows_b = block[1:].reshape(K, 5 + D)
        meta = rows_b[:, :5].view(np.float32)
        meta[:n, :3] = self.xyz[cand]
        meta[:n, 3] = self.color[cand]
        meta[:n, 4] = 1.0
        rows_b[:n, 5:] = self.desc[cand].reshape(n, D).view(np.int32)
        new_lmap, aux = insert(lmap, upload(block, lmap.xyz.device))
        # one fetch for the insert outcome (slot, placed, new generation)
        aux = HostCopy(aux).numpy("reload")
        slot_np = aux[:K].astype(np.int64)
        placed_np = aux[K:2 * K] > 0.5
        gen_np = aux[2 * K:].astype(np.int64)
        self._ensure_slot_maps(int(new_lmap.valid.shape[0]))
        for i, row in enumerate(cand):
            if placed_np[i]:
                sl = int(slot_np[i])
                # the evicted occupant of this slot goes dormant now: the slot
                # maps change here, so the next sync will not see it
                prev = self._slot_row[sl]
                if prev >= 0 and prev != row:
                    self._displace(np.asarray([prev]))
                key = (sl, int(gen_np[i]))
                self.dormant[row] = False
                self._key_to_row[key] = int(row)
                self._row_key[int(row)] = key
                self._slot_row[sl] = int(row)
                self._slot_gen[sl] = int(gen_np[i])
                self.n_reloads += 1
                self.reload_keys.add(key)
        return new_lmap
