"""The full keyframe SLAM system: the per-frame step plus the live back end —
counterpart of ``zenslam_tpu/pipeline/system.py``.

  per frame   : slam_step (pipeline/step.py), telemetry packed into one
                tensor and read by the host, optionally ``telemetry_lag``
                frames late
  per keyframe: snapshot into the KeyframeDB -> windowed Schur BA over the
                most recent keyframes -> pose and landmark write-back -> BoW
                loop-closure query and PnP verification -> on a loop: pose
                graph over all keyframes, correction carried to the live
                state; landmark spill to the host archive and frustum reload

Host control flow decides when (keyframe flags from telemetry); the math is
tensor code on the system's device. Device->host reads that the reference
starts with ``copy_to_host_async`` start here as copies into pinned memory
behind a CUDA event (``HostCopy``) and are waited on where they are read;
``SlamSystem.host_reads`` counts those waits by kind.

Randomness is injected: ``process_frame`` takes the front end's
``CascadeNoise`` and ``_keyframe_backend`` a ``BackendDraws``; without them
each draw comes from a ``torch.Generator`` seeded by the integer the
reference seeds its key with (13 and 7 for the vocabulary, ``frame_idx*16``
for the loop gate, ``n_frames`` for relocalisation). The archive sample of a
vocabulary retrain keeps the reference's numpy draw.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from zenslam_tpu_torch.backend.ba import bundle_adjust, bundle_adjust_cg
from zenslam_tpu_torch.backend.bow import (
    BowDatabase, bow_db_add, bow_db_init, bow_db_query, build_vocabulary,
    build_vocabulary_tree, descriptors_to_bow, generator_draw, load_vocabulary)
from zenslam_tpu_torch.backend.keyframes import (
    KeyframeDB, ba_problem_from_db, kf_db_add, kf_db_init, newest_first)
from zenslam_tpu_torch.backend.map_archive import LandmarkArchive, _pack_live
from zenslam_tpu_torch.backend.pose_graph import PoseGraph, optimize_pose_graph
from zenslam_tpu_torch.estimation.pnp import solve_pnp_ransac
from zenslam_tpu_torch.estimation.ransac import gumbel
from zenslam_tpu_torch.geometry.camera import StereoRig
from zenslam_tpu_torch.geometry.lie import se3_compose, se3_inverse
from zenslam_tpu_torch.ops.match import match_descriptors
from zenslam_tpu_torch.pipeline.state import (
    MotionModel, SlamConfig, SlamState, init_state, pack_telemetry, resolve_device,
    unpack_telemetry)
from zenslam_tpu_torch.pipeline.step import slam_step

LOOP_PNP_ITERS = 128  # RANSAC hypotheses per loop / reloc candidate


@dataclass
class BackendConfig:
    """Same fields and defaults as the reference's ``BackendConfig`` (see its
    comments for the reasons behind each default), so
    ``BackendConfig(**dataclasses.asdict(jax_bcfg))`` converts one."""

    max_keyframes: int = 64
    ba_window: int = 8
    ba_iterations: int = 6
    ba_every_kf: bool = True
    ba_solver: str = "auto"         # "dense", "cg", "auto" (cg above 16 keyframes); no "dist"
    dist_devices: int = 0
    enable_loop_closure: bool = True
    bow_levels: int = 2
    bow_branch: int = 64
    bow_words: int = 128
    bow_min_score: float = 0.35
    bow_min_frame_gap: int = 40
    bow_top_k: int = 3
    loop_min_inliers: int = 15
    loop_pnp_threshold: float = 8.0
    pose_graph_iterations: int = 15
    vocab_retrain_kfs: int = 8
    vocab_retrain_growth: float = 2.0
    vocab_file: str = ""
    enable_relocalization: bool = True
    reloc_lost_frames: int = 5
    reloc_min_inliers: int = 0
    reloc_cooldown: int = 10
    vocab_archive_sample: int = 4096
    max_edges: int = 256
    enable_map_spill: bool = True
    spill_reload_max: int = 128
    spill_radius: float = 50.0
    telemetry_lag: int = 0
    loop_resolve_lag: int = 1
    spill_resolve_lag: int = 1


def check_backend_supported(cfg: SlamConfig, bcfg: BackendConfig) -> None:
    """Raise NotImplementedError for settings this port does not run yet,
    naming the ROADMAP.md item that will port them."""
    if bcfg.ba_solver == "dist":
        raise NotImplementedError(
            "ba_solver='dist' is not ported to zenslam_tpu_torch yet, see ROADMAP.md "
            "Queue 1 item 17 (parallel/dist_ba.py)")
    if bcfg.ba_solver not in ("auto", "dense", "cg"):
        raise ValueError(f"unknown ba_solver {bcfg.ba_solver!r}")
    if cfg.descriptor == "sift":
        raise NotImplementedError(
            "descriptor='sift' is not ported to zenslam_tpu_torch yet (the back end "
            "needs ops/match.lsh_binarize), see ROADMAP.md Queue 1 item 12")


class HostCopy:
    """A device->host copy started now and read later. On CUDA the tensor is
    copied into pinned memory behind an event, and ``numpy()`` waits on that
    event only; on the CPU it holds the tensor."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


class KfSnap(NamedTuple):
    """Copies of everything the keyframe back end reads from a frame's state
    (the next ``slam_step`` keeps the unchanged fields' tensors, so a
    snapshot must not alias them)."""

    R_cw: torch.Tensor
    t_cw: torch.Tensor
    xy: torch.Tensor
    uv_r: torch.Tensor
    stereo_ok: torch.Tensor
    desc: torch.Tensor
    lm_idx: torch.Tensor
    valid: torch.Tensor
    kp_lm_gen: torch.Tensor
    kp_xyz: torch.Tensor
    track_id: torch.Tensor


class BackendDraws(NamedTuple):
    """Random draws of one keyframe's back end (None = the system's seeded
    generators): the k-means ``draw`` callable of a vocabulary (re)train
    (``backend.bow``), and the loop gate's PnP Gumbel noise (top_k,
    LOOP_PNP_ITERS, N)."""

    vocab: Optional[Callable] = None
    loop_noise: Optional[torch.Tensor] = None


@dataclass
class SlamSystem:
    """Host-side system state around the tensor math."""

    cfg: SlamConfig
    bcfg: BackendConfig
    rig: StereoRig
    state: SlamState
    kf_db: KeyframeDB
    bow_db: object
    device: torch.device = torch.device("cpu")
    archive: object = None
    vocab: object = None
    # pose-graph edges: host lists, tensors stacked when the graph runs
    edge_i: list = field(default_factory=list)
    edge_j: list = field(default_factory=list)
    edge_R: list = field(default_factory=list)
    edge_t: list = field(default_factory=list)
    edge_w: list = field(default_factory=list)
    last_kf_slot: int = -1
    n_loop_closures: int = 0
    n_ba_runs: int = 0
    n_relocs: int = 0
    n_vocab_trains: int = 0
    _lost_count: int = 0
    _reloc_cooldown: int = 0
    last_kf_snap: Optional[KfSnap] = None
    n_frames: int = 0
    n_keyframes: int = 0
    last_vocab_kfs: int = 0
    loop_debug: list = field(default_factory=list)
    reloc_debug: list = field(default_factory=list)    # one entry per reloc attempt
    # blocking host reads by kind (telemetry, loop, spill, reloc, reload)
    host_reads: Counter = field(default_factory=Counter)
    _tel_queue: list = field(default_factory=list)     # [(HostCopy, KfSnap, frame_idx)]
    _pending_loop: Optional[tuple] = None              # (HostCopy, kf_slot, frame_idx)
    _pending_spill: Optional[HostCopy] = None
    _pg_delta: Optional[tuple] = None                  # (R_old, t_old, R_new, t_new)


def bow_n_words(bcfg: BackendConfig) -> int:
    """Leaf-word count of the configured vocabulary shape."""
    return bcfg.bow_branch ** 2 if bcfg.bow_levels == 2 else bcfg.bow_words


def _train_vocab(bcfg: BackendConfig, desc, valid, draw: Callable):
    if bcfg.bow_levels == 2:
        return build_vocabulary_tree(desc, valid, branch=bcfg.bow_branch, iters=6, draw=draw)
    return build_vocabulary(desc, valid, n_words=bcfg.bow_words, iters=6, draw=draw)


def create_system(cfg: SlamConfig, bcfg: BackendConfig, rig: StereoRig, image_shape,
                  seed: int = 0, device=None) -> SlamSystem:
    """An empty system on ``device`` (default CUDA, raising when absent)."""
    check_backend_supported(cfg, bcfg)
    dev = resolve_device(device)
    sys = SlamSystem(
        cfg=cfg, bcfg=bcfg, rig=rig, device=dev,
        state=init_state(cfg, image_shape, seed=seed, device=dev),
        kf_db=kf_db_init(bcfg.max_keyframes, cfg.max_keypoints, device=dev),
        bow_db=bow_db_init(bcfg.max_keyframes, bow_n_words(bcfg), device=dev),
        archive=LandmarkArchive((8,), np.uint32))
    if bcfg.vocab_file:
        sys.vocab = load_vocabulary(bcfg.vocab_file, device=dev)
        sys.last_vocab_kfs = 1 << 30   # pre-trained: never retrain
    return sys


def _kf_snapshot(state: SlamState) -> KfSnap:
    f = state.features
    lm_clip = f.lm_idx.clamp(min=0).long()
    return KfSnap(
        R_cw=state.R_cw.clone(), t_cw=state.t_cw.clone(), xy=f.xy.clone(),
        uv_r=f.uv_r.clone(), stereo_ok=f.stereo_ok.clone(), desc=f.desc.clone(),
        lm_idx=f.lm_idx.clone(), valid=f.valid.clone(),
        kp_lm_gen=torch.where(f.lm_idx >= 0, state.lmap.generation[lm_clip], -1).to(torch.int32),
        kp_xyz=state.lmap.xyz[lm_clip], track_id=f.track_id.clone())


def _epoch_correct_snap(snap: KfSnap, R_old, t_old, R_new, t_new) -> KfSnap:
    """Carry a snapshot taken before a pose-graph correction into the
    corrected epoch: pose left-composed with T_new ∘ T_old⁻¹, landmark
    positions fixed in the camera frame (X' = R_newᵀ(R_old X + t_old − t_new))."""
    Ri, ti = se3_inverse(R_old, t_old)
    Rp, tp = se3_compose(R_new, t_new, Ri, ti)
    R2, t2 = se3_compose(Rp, tp, snap.R_cw, snap.t_cw)
    Rw = R_new.T @ R_old
    tw = R_new.T @ (t_old - t_new)
    return snap._replace(R_cw=R2, t_cw=t2, kp_xyz=snap.kp_xyz @ Rw.T + tw)


def _apply_pose_correction(state: SlamState, R_old, t_old, R_new, t_new) -> SlamState:
    """T_cur' = (T_kf_new ∘ T_kf_old⁻¹) ∘ T_cur."""
    Ri, ti = se3_inverse(R_old, t_old)
    Rd, td = se3_compose(R_new, t_new, Ri, ti)
    R_cur, t_cur = se3_compose(Rd, td, state.R_cw, state.t_cw)
    return state._replace(R_cw=R_cur, t_cw=t_cur)


def _windowed_ba(db: KeyframeDB, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig,
                 W: int, solver: str, iterations: int):
    """The windowed BA step: compact to the W newest keyframes and to the
    landmarks they reference (at most 4N), solve, write poses and landmarks
    back, and correct the live pose by the newest keyframe's change.
    Returns (R, t, lmap xyz, R_cur, t_cur, [rmse_before, rmse_after,
    n_dropped_obs])."""
    slots = newest_first(db.frame_idx)[:W]
    sub = KeyframeDB(*(x[slots] for x in db[:-1]), next_slot=db.next_slot)
    p = ba_problem_from_db(sub, lmap_xyz, lmap_valid, rig, lmap_generation=lmap_gen)
    M = lmap_xyz.shape[0]
    M_ba = min(M, 4 * db.kp_lm.shape[1])
    ref = torch.zeros(M + 1, dtype=torch.bool, device=lmap_xyz.device)
    ref.index_fill_(0, torch.where(p.obs_valid, p.obs_lm, M).long(), True)
    ref = ref[:M] & p.lm_valid
    sel = torch.sort((~ref).to(torch.uint8), stable=True).indices[:M_ba]  # referenced first
    inv = torch.full((M,), M_ba, dtype=torch.int32, device=lmap_xyz.device)
    inv[sel] = torch.arange(M_ba, dtype=torch.int32, device=lmap_xyz.device)
    new_obs_lm = inv[p.obs_lm.clamp(0, M - 1).long()]
    obs_ok = p.obs_valid & (new_obs_lm < M_ba)
    pc = p._replace(xyz=p.xyz[sel], lm_valid=ref[sel], obs_lm=new_obs_lm.clamp(0, M_ba - 1),
                    obs_valid=obs_ok)
    if solver == "cg":
        res = bundle_adjust_cg(pc, iterations=iterations)
    else:
        res = bundle_adjust(pc, iterations=iterations)
    R_old, t_old = sub.R[0], sub.t[0]          # newest keyframe at compact index 0
    new_R = db.R.index_copy(0, slots, res["R"])
    new_t = db.t.index_copy(0, slots, res["t"])
    refined = torch.where(ref[sel][:, None], res["xyz"], lmap_xyz[sel])
    new_xyz = lmap_xyz.index_copy(0, sel, refined)
    Ri, ti = se3_inverse(R_old, t_old)
    Rd, td = se3_compose(res["R"][0], res["t"][0], Ri, ti)
    R_cur, t_cur = se3_compose(Rd, td, R_cw, t_cw)
    n_dropped = (p.obs_valid & ~obs_ok).sum().to(torch.float32)
    rmse = torch.stack([res["rmse_before"], res["rmse_after"], n_dropped])
    return new_R, new_t, new_xyz, R_cur, t_cur, rmse


def _run_windowed_ba(sys: SlamSystem):
    """Windowed BA over the most recent keyframes, written back. Returns the
    (rmse_before, rmse_after, n_dropped_obs) device tensor, unread."""
    W = sys.bcfg.ba_window
    solver = sys.bcfg.ba_solver
    if solver == "auto":
        solver = "cg" if W > 16 else "dense"
    lmap = sys.state.lmap
    new_R, new_t, new_xyz, R_cur, t_cur, rmse = _windowed_ba(
        sys.kf_db, lmap.xyz, lmap.valid, lmap.generation, sys.state.R_cw, sys.state.t_cw,
        sys.rig, W=W, solver=solver, iterations=sys.bcfg.ba_iterations)
    sys.kf_db = sys.kf_db._replace(R=new_R, t=new_t)
    sys.state = sys.state._replace(R_cw=R_cur, t_cw=t_cur, lmap=lmap._replace(xyz=new_xyz))
    sys.n_ba_runs += 1
    return rmse


def _retrain_vocab(sys: SlamSystem, draw: Optional[Callable] = None):
    """Retrain the vocabulary over every stored keyframe's descriptors plus a
    fixed-size sample of archived landmark descriptors, and re-quantise the
    stored keyframes; the keyframe just added is left out of the rebuilt
    database (its histogram goes in with the loop gate right after)."""
    db = sys.kf_db
    K, N = db.kp_lm.shape
    dev = sys.device
    desc = db.kp_desc.reshape(K * N, db.kp_desc.shape[-1])
    valid = (db.kp_valid & db.valid[:, None]).reshape(K * N)
    n_s = sys.bcfg.vocab_archive_sample
    if n_s > 0 and sys.archive is not None and len(sys.archive) > 0:
        arch = sys.archive
        take = min(len(arch), n_s)
        sel = np.random.default_rng(sys.n_keyframes).choice(len(arch), take, replace=False)
        a_desc = np.zeros((n_s,) + arch.desc.shape[1:], arch.desc.dtype)
        a_desc[:take] = arch.desc[sel]
        a_valid = np.zeros(n_s, bool)
        a_valid[:take] = True
        desc = torch.cat([desc, torch.from_numpy(a_desc.view(np.int32)).to(dev)])
        valid = torch.cat([valid, torch.from_numpy(a_valid).to(dev)])
    sys.vocab = _train_vocab(sys.bcfg, desc, valid, draw or generator_draw(13, dev))
    sys.n_vocab_trains += 1
    hists = descriptors_to_bow(sys.vocab, db.kp_desc, db.kp_valid)
    keep = db.valid & (torch.arange(K, device=dev) != sys.last_kf_slot)
    hists = hists * keep[:, None]
    sys.bow_db = BowDatabase(
        hist=hists, frame_idx=torch.where(keep, db.frame_idx, -1).to(torch.int32), valid=keep,
        next_slot=torch.full((), sys.last_kf_slot, dtype=torch.int32, device=dev),
        doc_freq=(hists > 0).to(torch.float32).sum(0))
    sys.last_vocab_kfs = sys.n_keyframes


def _verify_candidates(db: KeyframeDB, cur_desc, cur_valid, cur_xy, slots, K_left,
                       pnp_threshold: float, noise):
    """Per candidate slot: cross-checked descriptor match of the current
    keypoints against the candidate's, then PnP of the current pixels against
    the candidate's landmark snapshot, seeded by its stored pose (all
    candidates in one batched RANSAC). Returns (n_corr, n_inliers, R, t)."""
    c_desc, c_valid, c_lm, c_xyz = (x[slots] for x in (db.kp_desc, db.kp_valid, db.kp_lm,
                                                        db.kp_xyz))
    X, ok_all = [], []
    for c in range(slots.shape[0]):
        idx, _, ok = match_descriptors(cur_desc, c_desc[c], cur_valid, c_valid[c],
                                       max_distance=64, cross_check=True)
        cl = idx.clamp(min=0).long()
        ok_all.append(ok & (c_lm[c][cl] >= 0))
        X.append(c_xyz[c][cl])
    X, corr_ok = torch.stack(X), torch.stack(ok_all)
    P = slots.shape[0]
    r = solve_pnp_ransac(noise, K_left.expand(P, 3, 3), X, cur_xy.expand(P, -1, -1), corr_ok,
                         threshold=pnp_threshold, R_init=db.R[slots], t_init=db.t[slots])
    return corr_ok.sum(-1), r["n_inliers"], r["R"], r["t"]


def _loop_query_verify(vocab, bow_db, db: KeyframeDB, kf_slot: int, frame_idx: int, K_left,
                       min_frame_gap: int, pnp_threshold: float, noise, top_k: int = 3):
    """The loop gate: BoW histogram of the keyframe -> TF-IDF query ->
    per-candidate match + PnP + measured edge T_new_old = T_pnp ∘ T_old⁻¹,
    and the keyframe's histogram added to the database. Returns (new bow
    db, one packed vector [scores, frames, slots, n_corr, n_inl, R (k·9),
    t (k·3)])."""
    hist = descriptors_to_bow(vocab, db.kp_desc[kf_slot], db.kp_valid[kf_slot])
    scores, frames, slots = bow_db_query(bow_db, hist, frame_idx, min_frame_gap=min_frame_gap,
                                         top_k=top_k)
    new_bow_db = bow_db_add(bow_db, hist, frame_idx)
    n_corr, n_inl, R, t = _verify_candidates(db, db.kp_desc[kf_slot], db.kp_valid[kf_slot],
                                             db.kp_xy[kf_slot], slots, K_left, pnp_threshold,
                                             noise)
    Ri, ti = se3_inverse(db.R[slots], db.t[slots])
    Rm, tm = se3_compose(R, t, Ri, ti)
    f32 = torch.float32
    packed = torch.cat([scores, frames.to(f32), slots.to(f32), n_corr.to(f32), n_inl.to(f32),
                        Rm.reshape(-1), tm.reshape(-1)])
    return new_bow_db, packed


def _reloc_query(vocab, bow_db, db: KeyframeDB, cur_desc, cur_valid, cur_xy, K_left,
                 pnp_threshold: float, noise, top_k: int = 3):
    """The relocalisation gate: the loop gate's arbiter pointed at the live
    frame, with no temporal exclusion. Returns [scores(k), slots(k),
    n_inl(k), R(k·9), t(k·3)]."""
    hist = descriptors_to_bow(vocab, cur_desc, cur_valid)
    scores, _, slots = bow_db_query(bow_db, hist, 1 << 30, min_frame_gap=0, top_k=top_k)
    _, n_inl, R, t = _verify_candidates(db, cur_desc, cur_valid, cur_xy, slots, K_left,
                                        pnp_threshold, noise)
    f32 = torch.float32
    return torch.cat([scores, slots.to(f32), n_inl.to(f32), R.reshape(-1), t.reshape(-1)])


def _gate_noise(seed: int, top_k: int, n: int, device):
    """Gumbel draws of a loop or reloc gate's PnP: (top_k, LOOP_PNP_ITERS, n)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return gumbel(g, (top_k, LOOP_PNP_ITERS, n), device)


def _try_relocalize(sys: SlamSystem, noise=None) -> bool:
    """Kidnap recovery: BoW-query the current frame, PnP-verify, and on
    success restart the tracker at the verified anchor (live map and
    feature table invalidated, motion model reset). One blocking read."""
    snap = _kf_snapshot(sys.state)
    k = sys.bcfg.bow_top_k
    if noise is None:
        noise = _gate_noise(sys.n_frames, min(k, sys.bcfg.max_keyframes), snap.xy.shape[0],
                            sys.device)
    packed = _reloc_query(sys.vocab, sys.bow_db, sys.kf_db, snap.desc, snap.valid, snap.xy,
                          sys.rig.left.K, sys.bcfg.loop_pnp_threshold, noise, top_k=k)
    sys.host_reads["reloc"] += 1
    arr = packed.cpu().numpy()
    k = min(k, sys.bcfg.max_keyframes)
    scores, slots, n_inl = arr[:k], arr[k:2 * k], arr[2 * k: 3 * k]
    best = int(np.argmax(n_inl))
    fired = not (n_inl[best] < sys.bcfg.loop_min_inliers or scores[best] < sys.bcfg.bow_min_score)
    sys.reloc_debug.append({"frame": sys.n_frames - 1, "slot": int(slots[best]),
                            "score": float(scores[best]), "n_inliers": int(n_inl[best]),
                            "fired": fired})
    if not fired:
        return False
    dev = sys.device
    R = torch.from_numpy(arr[3 * k + 9 * best: 3 * k + 9 * (best + 1)].reshape(3, 3).copy()).to(dev)
    t = torch.from_numpy(arr[12 * k + 3 * best: 12 * k + 3 * (best + 1)].copy()).to(dev)
    lmap = sys.state.lmap
    lmap = lmap._replace(valid=torch.zeros_like(lmap.valid),
                         generation=lmap.generation + lmap.valid.to(lmap.generation.dtype))
    feats = sys.state.features
    feats = feats._replace(valid=torch.zeros_like(feats.valid),
                           lm_idx=torch.full_like(feats.lm_idx, -1),
                           stereo_ok=torch.zeros_like(feats.stereo_ok))
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    sys.state = sys.state._replace(
        R_cw=R, t_cw=t, lmap=lmap, features=feats,
        motion=MotionModel(vel=z3, acc=z3.clone(), vel_ang=z3.clone(), acc_ang=z3.clone(),
                           n_updates=torch.zeros((), dtype=torch.int32, device=dev)))
    sys.n_relocs += 1
    return True


def _loop_issue(sys: SlamSystem, kf_slot: int, frame_idx: int, noise=None) -> HostCopy:
    """Run the loop gate and start the copy of its packed verdict."""
    bcfg = sys.bcfg
    k = min(bcfg.bow_top_k, bcfg.max_keyframes)
    if noise is None:
        noise = _gate_noise(frame_idx * 16, k, sys.kf_db.kp_lm.shape[1], sys.device)
    sys.bow_db, packed = _loop_query_verify(
        sys.vocab, sys.bow_db, sys.kf_db, kf_slot, frame_idx, sys.rig.left.K,
        bcfg.bow_min_frame_gap, bcfg.loop_pnp_threshold, noise, top_k=bcfg.bow_top_k)
    return HostCopy(packed)


def _try_loop_closure(sys: SlamSystem, kf_slot: int, frame_idx: int,
                      packed: Optional[HostCopy] = None) -> bool:
    """Read the loop gate's verdict; on the first candidate above the score
    gate with enough PnP inliers add a loop edge and run the pose graph."""
    bcfg = sys.bcfg
    if packed is None:
        packed = _loop_issue(sys, kf_slot, frame_idx)
    k = min(bcfg.bow_top_k, bcfg.max_keyframes)
    sys.host_reads["loop"] += 1
    p = packed.numpy()
    scores = p[0:k]
    frames = p[k:2 * k].astype(np.int64)
    slots = p[2 * k:3 * k].astype(np.int64)
    n_corr = p[3 * k:4 * k].astype(np.int64)
    n_inl = p[4 * k:5 * k].astype(np.int64)
    Rms = p[5 * k:5 * k + 9 * k].reshape(k, 3, 3)
    tms = p[5 * k + 9 * k:].reshape(k, 3)
    dbg = {"frame": frame_idx, "score": float(scores[0]), "cand_frame": int(frames[0]),
           "n_corr": 0, "n_inliers": 0, "fired": False}
    sys.loop_debug.append(dbg)
    pick = -1
    for c in range(k):
        if scores[c] < bcfg.bow_min_score:
            continue
        dbg["n_corr"] = max(dbg["n_corr"], int(n_corr[c]))
        dbg["n_inliers"] = max(dbg["n_inliers"], int(n_inl[c]))
        if n_inl[c] >= bcfg.loop_min_inliers:
            pick = c
            break
    if pick < 0:
        return False
    dbg["fired"] = True
    dbg["matched_frame"] = int(frames[pick])
    sys.edge_i.append(kf_slot)
    sys.edge_j.append(int(slots[pick]))
    sys.edge_R.append(Rms[pick].astype(np.float32))
    sys.edge_t.append(tms[pick].astype(np.float32))
    sys.edge_w.append(5.0)
    sys.n_loop_closures += 1
    _run_pose_graph(sys)
    return True


def _edge_tensor(x, device):
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _run_pose_graph(sys: SlamSystem):
    """Optimise all keyframe poses over odometry and loop edges (the first
    ``max_edges`` edges), then carry the correction to the keyframes'
    landmark snapshots, the live pose, the live map and the queued
    snapshots."""
    K = sys.bcfg.max_keyframes
    E = sys.bcfg.max_edges
    dev = sys.device
    n_e = min(len(sys.edge_i), E)
    edge_i = torch.zeros(E, dtype=torch.int32)
    edge_j = torch.zeros(E, dtype=torch.int32)
    edge_i[:n_e] = torch.tensor(sys.edge_i[:n_e], dtype=torch.int32)
    edge_j[:n_e] = torch.tensor(sys.edge_j[:n_e], dtype=torch.int32)
    edge_w = torch.zeros(E, dtype=torch.float32)
    edge_w[:n_e] = torch.tensor(sys.edge_w[:n_e], dtype=torch.float32)
    edge_valid = torch.arange(E) < n_e
    pad = E - n_e
    edge_R = torch.cat([torch.stack([_edge_tensor(r, dev) for r in sys.edge_R[:n_e]]),
                        torch.eye(3, device=dev).expand(pad, 3, 3)]) if n_e else \
        torch.eye(3, device=dev).repeat(E, 1, 1)
    edge_t = torch.cat([torch.stack([_edge_tensor(t, dev) for t in sys.edge_t[:n_e]]),
                        torch.zeros((pad, 3), device=dev)]) if n_e else \
        torch.zeros((E, 3), device=dev)
    db = sys.kf_db
    slot = sys.last_kf_slot
    R_old, t_old = db.R[slot], db.t[slot]
    # gauge: the oldest valid keyframe (none when the database is empty)
    big = torch.full((), 2 ** 30, dtype=db.frame_idx.dtype, device=dev)
    oldest = torch.argmin(torch.where(db.valid, db.frame_idx, big))
    fixed = (torch.arange(K, device=dev) == oldest) & db.valid.any()
    g = PoseGraph(R=db.R, t=db.t, node_valid=db.valid, node_fixed=fixed,
                  edge_i=edge_i.to(dev), edge_j=edge_j.to(dev), edge_R=edge_R, edge_t=edge_t,
                  edge_valid=edge_valid.to(dev), edge_weight=edge_w.to(dev))
    res = optimize_pose_graph(g, iterations=sys.bcfg.pose_graph_iterations)
    Rd = torch.einsum("kji,kjl->kil", res["R"], db.R)             # R_newᵀ R_old
    td = torch.einsum("kji,kj->ki", res["R"], db.t - res["t"])    # R_newᵀ(t_old − t_new)
    new_xyz = torch.einsum("kij,knj->kni", Rd, db.kp_xyz) + td[:, None, :]
    sys.kf_db = db._replace(R=res["R"], t=res["t"], kp_xyz=new_xyz)
    sys.state = _apply_pose_correction(sys.state, R_old, t_old, res["R"][slot], res["t"][slot])
    lmap = sys.state.lmap
    sys.state = sys.state._replace(lmap=lmap._replace(xyz=lmap.xyz @ Rd[slot].T + td[slot]))
    sys._pg_delta = (R_old, t_old, res["R"][slot], res["t"][slot])
    sys._tel_queue = [(packed, _epoch_correct_snap(s, *sys._pg_delta), fidx)
                      for packed, s, fidx in sys._tel_queue]


def _info(frame_idx, step_ms: float) -> dict:
    return {"ba": None, "loop": False, "frame": frame_idx, "step_ms": step_ms,
            "backend_ms": 0.0}


def process_frame(sys: SlamSystem, img_l, img_r, imu=None, noise=None):
    """One frame (two (H, W) images, numpy arrays or tensors) through the full
    system. Returns (telemetry or None while the lag queue fills, backend
    info). ``noise``: the front end's ``CascadeNoise`` (None: drawn from the
    state's generator). ``imu`` is not ported (ROADMAP Queue 1 item 11) and
    raises."""
    t0 = time.time()
    img_l = torch.as_tensor(img_l, dtype=torch.float32, device=sys.device)
    img_r = torch.as_tensor(img_r, dtype=torch.float32, device=sys.device)
    sys.state, tel = slam_step(sys.cfg, sys.rig, sys.state, img_l, img_r, noise=noise, imu=imu)
    packed = HostCopy(pack_telemetry(tel))
    sys.n_frames += 1
    L = sys.bcfg.telemetry_lag
    if L > 0:
        sys._tel_queue.append((packed, _kf_snapshot(sys.state), sys.n_frames - 1))
        if len(sys._tel_queue) <= L:
            return None, _info(None, (time.time() - t0) * 1000)
        packed, snap, frame_idx = sys._tel_queue.pop(0)
    else:
        snap, frame_idx = None, sys.n_frames - 1
    sys.host_reads["telemetry"] += 1
    tel = unpack_telemetry(packed.numpy())
    t1 = time.time()
    backend_info = _info(frame_idx, (t1 - t0) * 1000)
    # relocalisation watchdog on the (possibly lagged) pose_ok the host holds
    if (sys.bcfg.enable_relocalization and sys.bcfg.enable_loop_closure
            and sys.vocab is not None and sys.n_keyframes >= 4 and sys.n_frames >= 16):
        if sys._reloc_cooldown > 0:
            sys._reloc_cooldown -= 1
            sys._lost_count = 0
        else:
            lost = (not bool(tel.pose_ok)
                    or (sys.bcfg.reloc_min_inliers > 0
                        and int(tel.n_pose_inliers) < sys.bcfg.reloc_min_inliers))
            if not lost:
                sys._lost_count = 0
            else:
                sys._lost_count += 1
                if sys._lost_count >= sys.bcfg.reloc_lost_frames:
                    backend_info["reloc"] = _try_relocalize(sys)
                    sys._lost_count = 0
                    sys._reloc_cooldown = sys.bcfg.reloc_cooldown
    if bool(tel.is_keyframe):
        if snap is None:
            snap = _kf_snapshot(sys.state)
        _keyframe_backend(sys, snap, frame_idx, backend_info)
        backend_info["backend_ms"] = (time.time() - t1) * 1000
    return tel, backend_info


def flush_pipeline(sys: SlamSystem):
    """Drain the lagged-telemetry queue at sequence end; returns the remaining
    [(telemetry, backend info), …] in frame order, then resolves a pending
    loop gate and spill."""
    out = []
    while sys._tel_queue:
        packed, snap, frame_idx = sys._tel_queue.pop(0)
        sys.host_reads["telemetry"] += 1
        tel = unpack_telemetry(packed.numpy())
        info = _info(frame_idx, 0.0)
        if bool(tel.is_keyframe):
            t1 = time.time()
            _keyframe_backend(sys, snap, frame_idx, info)
            info["backend_ms"] = (time.time() - t1) * 1000
        out.append((tel, info))
    if sys._pending_loop is not None:
        packed, pslot, pframe = sys._pending_loop
        sys._pending_loop = None
        fired = _try_loop_closure(sys, pslot, pframe, packed=packed)
        if out:
            out[-1][1]["loop"] = fired
    flush_pending_spill(sys)
    return out


def flush_pending_spill(sys: SlamSystem):
    """Sync a deferred spill copy into the archive."""
    if sys._pending_spill is not None and sys.archive is not None:
        sys.host_reads["spill"] += 1
        sys.archive.sync_packed(sys._pending_spill.numpy())
        sys._pending_spill = None


def _keyframe_backend(sys: SlamSystem, snap: KfSnap, frame_idx: int, backend_info: dict,
                      draws: Optional[BackendDraws] = None):
    """All per-keyframe back-end work, in the reference's order. ``snap`` is
    the snapshot taken at the keyframe; corrections apply to the live
    ``sys.state``. ``backend_info["phases"]`` gets the host ms of each
    phase."""
    draws = draws or BackendDraws()
    phases = {}
    backend_info["phases"] = phases
    t_prev = [time.time()]

    def mark(name):
        t = time.time()
        phases[name] = (t - t_prev[0]) * 1000
        t_prev[0] = t

    # the previous keyframe's deferred spill, then the frustum reload
    if sys.bcfg.enable_map_spill and sys.archive is not None:
        flush_pending_spill(sys)
        if sys.archive.dormant.any():
            sys.host_reads["reload"] += 1
        sys.state = sys.state._replace(lmap=sys.archive.reload(
            sys.state.lmap, sys.state.R_cw, sys.state.t_cw, sys.rig.left, sys.n_frames,
            reload_max=sys.bcfg.spill_reload_max, radius=sys.bcfg.spill_radius))
        backend_info["spill"] = {"archived": len(sys.archive), "reloads": sys.archive.n_reloads}
    mark("spill_resolve")
    # the previous keyframe's deferred loop gate: a fired pose graph corrects
    # the epoch before this keyframe's snapshot enters the database
    if sys._pending_loop is not None:
        packed, pslot, pframe = sys._pending_loop
        sys._pending_loop = None
        fired = _try_loop_closure(sys, pslot, pframe, packed=packed)
        backend_info["loop"] = fired
        if fired:
            snap = _epoch_correct_snap(snap, *sys._pg_delta)
    mark("resolve")
    prev_slot = sys.last_kf_slot
    slot = sys.n_keyframes % sys.bcfg.max_keyframes   # host mirror of kf_db.next_slot
    sys.n_keyframes += 1
    sys.kf_db = kf_db_add(sys.kf_db, snap.R_cw, snap.t_cw, snap.xy, snap.lm_idx,
                          snap.valid & (snap.lm_idx >= 0), snap.desc, frame_idx,
                          kp_uvr=snap.uv_r, kp_stereo=snap.stereo_ok,
                          kp_lm_gen=snap.kp_lm_gen, kp_xyz=snap.kp_xyz)
    sys.last_kf_slot = slot
    sys.last_kf_snap = snap
    if prev_slot >= 0:
        Ri, ti = se3_inverse(sys.kf_db.R[prev_slot], sys.kf_db.t[prev_slot])
        Rm, tm = se3_compose(snap.R_cw, snap.t_cw, Ri, ti)
        sys.edge_i.append(slot)
        sys.edge_j.append(prev_slot)
        sys.edge_R.append(Rm)        # device tensors, stacked when the graph runs
        sys.edge_t.append(tm)
        sys.edge_w.append(1.0)
    mark("kf_add")
    pending_loop = None
    if sys.bcfg.enable_loop_closure:
        n_kfs = sys.n_keyframes
        if sys.vocab is None:
            sys.vocab = _train_vocab(sys.bcfg, snap.desc, snap.valid,
                                     draws.vocab or generator_draw(7, sys.device))
            sys.n_vocab_trains += 1
        elif (n_kfs >= sys.bcfg.vocab_retrain_kfs
              and n_kfs >= sys.last_vocab_kfs * sys.bcfg.vocab_retrain_growth):
            _retrain_vocab(sys, draws.vocab)
        pending_loop = _loop_issue(sys, slot, frame_idx, draws.loop_noise)
    mark("loop_issue")
    if sys.bcfg.ba_every_kf and prev_slot >= 0:
        backend_info["ba"] = _run_windowed_ba(sys)
    mark("ba_dispatch")
    if pending_loop is not None:
        if sys.bcfg.loop_resolve_lag > 0:
            sys._pending_loop = (pending_loop, slot, frame_idx)
        else:
            backend_info["loop"] = _try_loop_closure(sys, slot, frame_idx, packed=pending_loop)
    mark("resolve_sync")
    if sys.bcfg.enable_map_spill and sys.archive is not None:
        spill = HostCopy(_pack_live(sys.state.lmap))
        mark("spill_pack")
        sys._pending_spill = spill
        if sys.bcfg.spill_resolve_lag == 0:
            flush_pending_spill(sys)
            mark("spill_sync")


def run_system(sys: SlamSystem, left, right, imu=None):
    """Run a (T, H, W) stereo sequence (numpy arrays or tensors) through the
    full system; returns (telemetry stacked over frames as numpy, infos)."""
    if imu is not None:
        raise NotImplementedError(
            "imu is not ported to zenslam_tpu_torch yet, see ROADMAP.md Queue 1 item 11 (IMU/VIO)")
    tels, infos = [], []
    for t in range(left.shape[0]):
        tel, info = process_frame(sys, left[t], right[t])
        if tel is not None:
            tels.append(tel)
            infos.append(info)
    for tel, info in flush_pipeline(sys):
        tels.append(tel)
        infos.append(info)
    telem = type(tels[0])(*(np.stack([np.asarray(x) for x in xs]) for xs in zip(*tels)))
    return telem, infos
