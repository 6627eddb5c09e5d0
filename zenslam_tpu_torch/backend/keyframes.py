"""Keyframe database with covisibility — a fixed-capacity ring store;
counterpart of ``zenslam_tpu/backend/keyframes.py``.

Each keyframe keeps its feature table's rows (pixels, landmark slot and
generation, landmark position at keyframe time, right-image pixels,
descriptors). The same rows are the observations of the windowed BA.
Descriptors are int32 tensors holding the reference's uint32 bit patterns.
``kf_db_add`` and ``kf_db_update_poses`` are captured programs
(``utils/graphs.py``), as the reference jits them; the frame index is
traced (a Python int goes up as a device scalar: one capture serves every
frame).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zenslam_tpu_torch.backend.ba import BAProblem
from zenslam_tpu_torch.utils.device import resolve_device
from zenslam_tpu_torch.utils.graphs import Program


class KeyframeDB(NamedTuple):
    R: torch.Tensor          # (K, 3, 3) world->cam
    t: torch.Tensor          # (K, 3)
    kp_xy: torch.Tensor      # (K, N, 2) keypoint pixels at keyframe time
    kp_lm: torch.Tensor      # (K, N) int32 landmark slot (-1 none)
    kp_lm_gen: torch.Tensor  # (K, N) int32 landmark generation at observation
    kp_xyz: torch.Tensor     # (K, N, 3) landmark world position at keyframe time
    kp_valid: torch.Tensor   # (K, N) bool
    kp_uvr: torch.Tensor     # (K, N, 2) right-image pixels
    kp_stereo: torch.Tensor  # (K, N) bool
    kp_desc: torch.Tensor    # (K, N, 8) int32 packed ORB words
    frame_idx: torch.Tensor  # (K,) int32 source frame (-1 = empty slot)
    valid: torch.Tensor      # (K,) bool
    next_slot: torch.Tensor  # () int32 ring pointer


def kf_db_init(max_keyframes: int, max_keypoints: int, device=None) -> KeyframeDB:
    """Empty keyframe ring on ``device`` (default CUDA, raising when absent)."""
    device = resolve_device(device)
    K, N = max_keyframes, max_keypoints
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return KeyframeDB(
        R=torch.eye(3, dtype=f32, device=device).repeat(K, 1, 1), t=z(K, 3),
        kp_xy=z(K, N, 2), kp_lm=torch.full((K, N), -1, dtype=i32, device=device),
        kp_lm_gen=torch.full((K, N), -1, dtype=i32, device=device), kp_xyz=z(K, N, 3),
        kp_valid=z(K, N, dtype=b), kp_uvr=z(K, N, 2), kp_stereo=z(K, N, dtype=b),
        kp_desc=z(K, N, 8, dtype=i32), frame_idx=torch.full((K,), -1, dtype=i32, device=device),
        valid=z(K, dtype=b), next_slot=z(dtype=i32))


def _set_row(arr, s, value):
    """``arr`` with row ``s`` (a 0-d tensor) replaced by ``value`` (a tensor
    or a Python scalar, filled on the device: no host copy, no synchronise)."""
    v = (value.to(arr.dtype) if torch.is_tensor(value)
         else torch.full((), value, dtype=arr.dtype, device=arr.device))
    return arr.index_copy(0, s.reshape(1).long(), v.expand(arr.shape[1:]).unsqueeze(0))


@functools.partial(Program, scalar_argnames=("frame_idx",), copy_outputs=True)
def kf_db_add(db: KeyframeDB, R, t, kp_xy, kp_lm, kp_valid, kp_desc, frame_idx,
              kp_uvr=None, kp_stereo=None, kp_lm_gen=None, kp_xyz=None) -> KeyframeDB:
    """Insert a keyframe at the ring pointer (the oldest is evicted when full)."""
    s = db.next_slot
    if kp_uvr is None:
        kp_uvr = torch.zeros_like(kp_xy)
    if kp_stereo is None:
        kp_stereo = torch.zeros(kp_xy.shape[0], dtype=torch.bool, device=kp_xy.device)
    if kp_lm_gen is None:
        kp_lm_gen = torch.where(kp_lm >= 0, 0, -1).to(torch.int32)
    if kp_xyz is None:
        kp_xyz = torch.zeros((kp_xy.shape[0], 3), dtype=torch.float32, device=kp_xy.device)
    return db._replace(
        R=_set_row(db.R, s, R), t=_set_row(db.t, s, t),
        kp_xy=_set_row(db.kp_xy, s, kp_xy), kp_lm=_set_row(db.kp_lm, s, kp_lm),
        kp_lm_gen=_set_row(db.kp_lm_gen, s, kp_lm_gen),
        kp_xyz=_set_row(db.kp_xyz, s, kp_xyz), kp_valid=_set_row(db.kp_valid, s, kp_valid),
        kp_uvr=_set_row(db.kp_uvr, s, kp_uvr), kp_stereo=_set_row(db.kp_stereo, s, kp_stereo),
        kp_desc=_set_row(db.kp_desc, s, kp_desc),
        frame_idx=_set_row(db.frame_idx, s, frame_idx),
        valid=_set_row(db.valid, s, True),
        next_slot=((s + 1) % db.R.shape[0]).to(torch.int32))


@functools.partial(Program, copy_outputs=True)
def kf_db_update_poses(db: KeyframeDB, R, t) -> KeyframeDB:
    """Write back optimised poses (copied in: a graph with no kernel in it
    is never captured)."""
    return db._replace(R=R.clone(), t=t.clone())


def covisibility(db: KeyframeDB, max_landmarks: int, threshold: int = 15):
    """(K, K) shared-landmark counts (diagonal zero) and boolean edges
    (count >= threshold), all pairs at once by an indicator product."""
    K = db.kp_lm.shape[0]
    M = max_landmarks
    obs = db.kp_valid & (db.kp_lm >= 0)
    lm = torch.where(obs, db.kp_lm, M).long()          # M = dropped
    rows = torch.arange(K, device=lm.device)[:, None]
    ind = torch.zeros(K * (M + 1), dtype=torch.float32, device=lm.device)
    ind[(rows * (M + 1) + lm).reshape(-1)] = 1.0
    ind = ind.reshape(K, M + 1)[:, :M]
    shared = (ind @ ind.T).to(torch.int32)
    shared = shared * (1 - torch.eye(K, dtype=torch.int32, device=lm.device))
    shared = shared * (db.valid[:, None] & db.valid[None, :])
    return shared, shared >= threshold


def newest_first(frame_idx):
    """Slots ordered newest first, empty slots (-1) last; equal frames keep
    slot order (the reference's stable argsort)."""
    return torch.sort(-frame_idx, stable=True).indices


def recent_mask(db: KeyframeDB, n: int):
    """Mask of the n most recently added keyframes (by frame_idx)."""
    order = newest_first(db.frame_idx)
    mask = torch.zeros(db.valid.shape[0], dtype=torch.bool, device=db.valid.device)
    return mask.index_fill_(0, order[:n], True) & db.valid


def ba_problem_from_db(db: KeyframeDB, lmap_xyz, lmap_valid, rig, window_mask=None,
                       fix_mask=None, lmap_generation=None) -> BAProblem:
    """Flatten keyframe snapshots into a masked stereo BA problem: every
    keyframe keypoint with a live landmark gives a left observation, and a
    right one where its stereo match holds. ``window_mask`` selects the
    keyframes, ``fix_mask`` the gauge (default: the oldest selected one);
    with ``lmap_generation`` observations of recycled slots are dropped."""
    K, N = db.kp_lm.shape
    M = lmap_valid.shape[0]
    dev = db.kp_lm.device
    kf_sel = db.valid if window_mask is None else (db.valid & window_mask)
    has_lm = db.kp_valid & (db.kp_lm >= 0) & kf_sel[:, None]
    if lmap_generation is not None:
        cur_gen = lmap_generation[db.kp_lm.clamp(min=0).long()]
        has_lm = has_lm & (cur_gen == db.kp_lm_gen)
    obs_valid_l = has_lm.reshape(-1)
    obs_valid_r = (has_lm & db.kp_stereo).reshape(-1)
    obs_kf1 = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(N)
    obs_lm1 = db.kp_lm.reshape(-1).clamp(min=0)
    lm_obs = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    lm_obs.index_fill_(0, torch.where(obs_valid_l, obs_lm1, M).long(), True)
    if fix_mask is None:
        big = torch.full((), 2 ** 30, dtype=db.frame_idx.dtype, device=dev)
        oldest = torch.argmin(torch.where(kf_sel, db.frame_idx, big))
        fix_mask = torch.arange(K, device=dev) == oldest
    cam_l, cam_r = rig.left, rig.right
    return BAProblem(
        R=db.R, t=db.t, kf_valid=kf_sel, kf_fixed=fix_mask,
        xyz=lmap_xyz, lm_valid=lmap_valid & lm_obs[:M],
        obs_kf=torch.cat([obs_kf1, obs_kf1]), obs_lm=torch.cat([obs_lm1, obs_lm1]),
        obs_uv=torch.cat([db.kp_xy.reshape(-1, 2), db.kp_uvr.reshape(-1, 2)]),
        obs_cam=torch.cat([torch.zeros(K * N, dtype=torch.int32, device=dev),
                           torch.ones(K * N, dtype=torch.int32, device=dev)]),
        obs_valid=torch.cat([obs_valid_l, obs_valid_r]),
        fx=cam_l.fx, fy=cam_l.fy, cx=cam_l.cx, cy=cam_l.cy,
        fx_r=cam_r.fx, fy_r=cam_r.fy, cx_r=cam_r.cx, cy_r=cam_r.cy,
        R_rl=rig.R_rl, t_rl=rig.t_rl)
