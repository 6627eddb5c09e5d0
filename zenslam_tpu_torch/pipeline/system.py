"""The full keyframe SLAM system: the per-frame step plus the live back end —
counterpart of ``zenslam_tpu/pipeline/system.py``.

  per frame   : the captured step (pipeline/step.py:SlamStep, its state
                updated in place), telemetry packed into one tensor inside
                it and read by the host, optionally ``telemetry_lag`` frames
                late
  per keyframe: snapshot into the KeyframeDB -> windowed Schur BA over the
                most recent keyframes -> pose and landmark write-back -> BoW
                loop-closure query and PnP verification -> on a loop: pose
                graph over all keyframes, correction carried to the live
                state; landmark spill to the host archive and frustum reload

Host control flow decides when (keyframe flags from telemetry); the math is
tensor code on the system's device. As in the reference, where each piece is
one jitted fixed-shape program, every piece runs on CUDA as a captured
program (``utils/graphs.py``: one CUDA graph per static arguments and
shapes, replayed): the step, the keyframe snapshot (a ring of
``telemetry_lag + 1`` programs, one per queued frame, and one for immediate
use) and its epoch correction, the keyframe insert with its odometry edge,
the windowed BA (dense, CG and sharded), the loop and relocalisation gates,
the pose graph with the correction it carries to the database, the live
pose and the map, the spill's packing, the archive's reload
(``backend/map_archive.py``) and vocabulary training and retraining with
the re-quantisation. The programs whose outputs a system keeps past their
next call (the step's state, the queued snapshots) are the system's own,
made on first use; the others are shared, and what a caller keeps of them
is copied (``fresh``). The spill's packing and the first vocabulary are
the library's programs (``_pack_live``, the builders), whose outputs are
the caller's; the library functions that the system's programs call in
their bodies (the solvers, the keyframe and BoW functions) run inline
there, as jit inlines a nested jit (``utils/graphs.py``). What stays
eager is host work: the frustum gate and the archive's upserts (numpy),
the decisions, stacking the pose-graph edges, and ``slam_step`` itself
(the function the tests hold every program to). ``graphs.eager()`` runs
everything eagerly.

Device->host reads that the reference starts with ``copy_to_host_async``
start here as copies into pinned memory behind a CUDA event (``HostCopy``)
and are waited on where they are read; ``SlamSystem.host_reads`` counts
those waits by kind. Host values go up through pinned memory
(``utils/device.py:upload``), so the keyframe path does not synchronise.

With tracing on (``utils/tracing.py``) a frame is a ``frame`` span with
``frame.upload``, ``frame.noise``, ``frame.replay``, ``frame.snapshot``,
``hostio.wait`` and ``frame.backend`` inside, the back end's phases are
``backend.*`` spans, and each captured program stamps the device. A lagged
frame's telemetry wait and keyframe back end run inside a later call's
span and serve their own frame.

Randomness is injected: ``process_frame`` takes the front end's
``CascadeNoise`` and ``_keyframe_backend`` a ``BackendDraws``; without them
each draw comes from a ``torch.Generator`` seeded by the integer the
reference seeds its key with (13 and 7 for the vocabulary, ``frame_idx*16``
for the loop gate, ``n_frames`` for relocalisation); a captured vocabulary
training seeds its generator afresh on every call (``GeneratorDraw``). The
archive sample of a vocabulary retrain keeps the reference's numpy draw.
"""

from __future__ import annotations

import functools
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from zenslam_tpu_torch.backend.ba import ba_cost, bundle_adjust, bundle_adjust_cg
from zenslam_tpu_torch.backend.bow import (
    BowDatabase, GeneratorDraw, bow_db_add, bow_db_init, bow_db_query, build_vocabulary,
    build_vocabulary_tree, descriptors_to_bow, load_vocabulary)
from zenslam_tpu_torch.backend.keyframes import (
    KeyframeDB, ba_problem_from_db, kf_db_add, kf_db_init, newest_first)
from zenslam_tpu_torch.backend.map_archive import LandmarkArchive, _pack_live, _reload_body
from zenslam_tpu_torch.backend.pose_graph import PoseGraph, optimize_pose_graph
from zenslam_tpu_torch.estimation.pnp import solve_pnp_ransac
from zenslam_tpu_torch.estimation.ransac import gumbel
from zenslam_tpu_torch.geometry.camera import StereoRig
from zenslam_tpu_torch.geometry.lie import se3_compose, se3_inverse
from zenslam_tpu_torch.ops.match import lsh_binarize, match_descriptors
from zenslam_tpu_torch.parallel.dist_ba import (
    dist_bundle_adjust, make_ba_mesh, shard_ba_problem_device)
from zenslam_tpu_torch.utils import tracing
from zenslam_tpu_torch.utils.graphs import Program, fresh
from zenslam_tpu_torch.pipeline.state import (
    MotionModel, SlamConfig, SlamState, init_state, resolve_device, unpack_telemetry)
from zenslam_tpu_torch.pipeline.step import SlamStep
from zenslam_tpu_torch.utils.device import HostCopy, upload

LOOP_PNP_ITERS = 128  # RANSAC hypotheses per loop / reloc candidate
NOW = -1              # the snapshot ring's entry for a snapshot used at once


@dataclass
class BackendConfig:
    """Same fields and defaults as the reference's ``BackendConfig`` (see its
    comments for the reasons behind each default), so
    ``BackendConfig(**dataclasses.asdict(jax_bcfg))`` converts one."""

    max_keyframes: int = 64
    ba_window: int = 8
    ba_iterations: int = 6
    ba_every_kf: bool = True
    ba_solver: str = "auto"         # "dense", "cg", "auto" (cg above 16 keyframes), "dist"
    dist_devices: int = 0           # "dist" shards: 0 = one per rank of the group (1 on the card)
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
    """Raise ValueError for a back-end setting no solver answers to."""
    if bcfg.ba_solver not in ("auto", "dense", "cg", "dist"):
        raise ValueError(f"unknown ba_solver {bcfg.ba_solver!r}")


def _binary_codes(cfg: SlamConfig, desc):
    """Descriptors as the back end stores and matches them: the keyframe DB,
    the vocabulary and the loop and reloc matching are binary, so the float
    (SIFT) family crosses into them as LSH sign codes."""
    return lsh_binarize(desc) if cfg.descriptor == "sift" else desc


class KfSnap(NamedTuple):
    """Copies of everything the keyframe back end reads from a frame's state
    (the next step overwrites the state's buffers in place, so a snapshot
    must not alias them)."""

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
    # pose-graph edges (measurements as device tensors)
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
    step: Optional[SlamStep] = None                    # the captured step, made on first use
    snap_programs: Optional["SnapPrograms"] = None     # made on first use (``_snap_programs``)


def bow_n_words(bcfg: BackendConfig) -> int:
    """Leaf-word count of the configured vocabulary shape."""
    return bcfg.bow_branch ** 2 if bcfg.bow_levels == 2 else bcfg.bow_words


def _vocab_body(desc, valid, levels: int, branch: int, words: int, draw: Callable):
    """The configured vocabulary over packed descriptors: the builder's
    captured program (the reference's jitted ``build_vocabulary_tree`` /
    ``build_vocabulary``), inline inside the retrain's."""
    if levels == 2:
        return build_vocabulary_tree(desc, valid, branch=branch, iters=6, draw=draw)
    return build_vocabulary(desc, valid, n_words=words, iters=6, draw=draw)


def _vocab_shape(bcfg: BackendConfig) -> dict:
    return dict(levels=bcfg.bow_levels, branch=bcfg.bow_branch, words=bcfg.bow_words)


def _train_vocab(bcfg: BackendConfig, desc, valid, draw: Callable):
    """The first vocabulary, trained on one keyframe's descriptors by the
    builder's captured program (the caller's to keep)."""
    return _vocab_body(desc, valid, draw=draw, **_vocab_shape(bcfg))


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
        archive=(LandmarkArchive((128,), np.float32) if cfg.descriptor == "sift"
                 else LandmarkArchive((8,), np.uint32)))
    if bcfg.vocab_file:
        sys.vocab = load_vocabulary(bcfg.vocab_file, device=dev)
        sys.last_vocab_kfs = 1 << 30   # pre-trained: never retrain
    return sys


def _snapshot_body(R_cw, t_cw, f, generation, xyz, slot: int = NOW) -> KfSnap:
    """The keyframe snapshot of a frame's pose, feature table and the map
    rows it references. ``slot`` (static) names the snapshot ring's entry:
    each is a captured program of its own, whose outputs the next call of
    that entry (of the same system) overwrites."""
    lm_clip = f.lm_idx.clamp(min=0).long()
    return KfSnap(
        R_cw=R_cw.clone(), t_cw=t_cw.clone(), xy=f.xy.clone(),
        uv_r=f.uv_r.clone(), stereo_ok=f.stereo_ok.clone(), desc=f.desc.clone(),
        lm_idx=f.lm_idx.clone(), valid=f.valid.clone(),
        kp_lm_gen=torch.where(f.lm_idx >= 0, generation[lm_clip], -1).to(torch.int32),
        kp_xyz=xyz[lm_clip], track_id=f.track_id.clone())


def _kf_snapshot(state: SlamState) -> KfSnap:
    """The snapshot (the reference's ``_kf_snapshot``), as plain PyTorch."""
    return _snapshot_body(state.R_cw, state.t_cw, state.features, state.lmap.generation,
                          state.lmap.xyz)


def _snapshot(sys: SlamSystem, slot: int) -> KfSnap:
    """The live state's snapshot as ring entry ``slot``'s captured program:
    a queued frame's entry is its frame index mod ``telemetry_lag + 1``, so
    the entry is called again only after the frame has left the queue;
    ``NOW`` is for a snapshot used at once."""
    st = sys.state
    return _snap_programs(sys).snapshot(st.R_cw, st.t_cw, st.features, st.lmap.generation,
                                        st.lmap.xyz, slot=slot)


def _ring_slot(sys: SlamSystem, frame_idx: int) -> int:
    L = sys.bcfg.telemetry_lag
    return frame_idx % (L + 1) if L > 0 else NOW


def _epoch_correct_snap(snap: KfSnap, R_old, t_old, R_new, t_new, slot: int = NOW) -> KfSnap:
    """Carry a snapshot taken before a pose-graph correction into the
    corrected epoch: pose left-composed with T_new ∘ T_old⁻¹, landmark
    positions fixed in the camera frame (X' = R_newᵀ(R_old X + t_old − t_new)).
    ``slot`` (static) is the snapshot's ring entry, as in ``_snapshot_body``."""
    Ri, ti = se3_inverse(R_old, t_old)
    Rp, tp = se3_compose(R_new, t_new, Ri, ti)
    R2, t2 = se3_compose(Rp, tp, snap.R_cw, snap.t_cw)
    Rw = R_new.T @ R_old
    tw = R_new.T @ (t_old - t_new)
    return snap._replace(R_cw=R2, t_cw=t2, kp_xyz=snap.kp_xyz @ Rw.T + tw)


class SnapPrograms(NamedTuple):
    """A system's own snapshot and epoch-correction programs: their outputs
    wait in the telemetry queue while later frames call the programs again,
    so two systems must not share them (as each has its own step)."""

    snapshot: Program
    epoch: Program


def _snap_programs(sys: SlamSystem) -> SnapPrograms:
    if sys.snap_programs is None:
        sys.snap_programs = SnapPrograms(Program(_snapshot_body, static_argnames=("slot",)),
                                         Program(_epoch_correct_snap, static_argnames=("slot",)))
    return sys.snap_programs


def _epoch_correct(sys: SlamSystem, snap: KfSnap, frame_idx: int) -> KfSnap:
    """``snap`` (of frame ``frame_idx``) carried into the epoch of the last
    pose graph, by its ring entry's captured program."""
    return _snap_programs(sys).epoch(snap, *sys._pg_delta, slot=_ring_slot(sys, frame_idx))


def _kf_add_body(db: KeyframeDB, snap: KfSnap, kf_desc, ints, has_prev: bool):
    """The keyframe insert (the reference's jitted ``kf_db_add``) and, with
    ``has_prev``, the odometry edge to the previous keyframe, T_new ∘
    T_prev⁻¹. ``ints`` = [frame index, previous slot] on the device.
    Returns (new database[, edge R, edge t])."""
    db = kf_db_add(db, snap.R_cw, snap.t_cw, snap.xy, snap.lm_idx,
                   snap.valid & (snap.lm_idx >= 0), kf_desc, ints[0].to(torch.int32),
                   kp_uvr=snap.uv_r, kp_stereo=snap.stereo_ok, kp_lm_gen=snap.kp_lm_gen,
                   kp_xyz=snap.kp_xyz)
    if not has_prev:
        return (db,)
    prev = ints[1:2]
    Ri, ti = se3_inverse(db.R.index_select(0, prev)[0], db.t.index_select(0, prev)[0])
    Rm, tm = se3_compose(snap.R_cw, snap.t_cw, Ri, ti)
    return db, Rm, tm


_KF_ADD = Program(_kf_add_body, static_argnames=("has_prev",))


def _kf_add(sys: SlamSystem, snap: KfSnap, kf_desc, frame_idx: int, slot: int,
            prev_slot: int) -> None:
    """Insert the keyframe at ``slot`` and, unless ``prev_slot`` is
    negative, append the odometry edge to it, through one captured program
    (its outputs fresh: a caller may keep the previous database)."""
    has_prev = prev_slot >= 0
    ints = upload(np.array([frame_idx, max(prev_slot, 0)], np.int64), sys.device)
    sys.kf_db, *edge = fresh(_KF_ADD(sys.kf_db, snap, kf_desc, ints, has_prev=has_prev))
    if has_prev:
        _append_edge(sys, slot, prev_slot, *edge, 1.0)


def _append_edge(sys: SlamSystem, i: int, j: int, R, t, w: float) -> None:
    """Append the edge i -> j with its measurement (device tensors) and weight."""
    sys.edge_i.append(i)
    sys.edge_j.append(j)
    sys.edge_R.append(R)
    sys.edge_t.append(t)
    sys.edge_w.append(w)


def _apply_pose_correction(state: SlamState, R_old, t_old, R_new, t_new) -> SlamState:
    """T_cur' = (T_kf_new ∘ T_kf_old⁻¹) ∘ T_cur."""
    Ri, ti = se3_inverse(R_old, t_old)
    Rd, td = se3_compose(R_new, t_new, Ri, ti)
    R_cur, t_cur = se3_compose(Rd, td, state.R_cw, state.t_cw)
    return state._replace(R_cw=R_cur, t_cw=t_cur)


def _windowed_ba_body(db: KeyframeDB, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig,
                      W: int, solver: str, iterations: int, mesh=None):
    """The windowed BA step (the reference's ``_windowed_ba_jit``): compact
    to the W newest keyframes and to the landmarks they reference (at most
    4N, rounded up to a shard multiple for ``solver="dist"``, which shards
    them over ``mesh``), solve, write poses and landmarks back, and correct
    the live pose by the newest keyframe's change. Returns (R, t, lmap xyz,
    R_cur, t_cur, [rmse_before, rmse_after, n_dropped_obs])."""
    slots = newest_first(db.frame_idx)[:W]
    sub = KeyframeDB(*(x[slots] for x in db[:-1]), next_slot=db.next_slot)
    p = ba_problem_from_db(sub, lmap_xyz, lmap_valid, rig, lmap_generation=lmap_gen)
    M = lmap_xyz.shape[0]
    M_ba = min(M, 4 * db.kp_lm.shape[1])
    if solver == "dist":
        # the block-sharded landmark dimension must divide over the mesh
        n_sh = mesh.n_shards
        M_ba = min(M, -(-M_ba // n_sh) * n_sh)
        if M_ba % n_sh:
            raise ValueError(f"map capacity {M} not shardable over {n_sh}")
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
    if solver == "dist":
        # landmark blocks sharded over the mesh, Schur elimination per shard,
        # the reduced camera system all-reduced; the route-drop count is
        # discarded, as the reference does (ROADMAP "Reference faults")
        O = pc.obs_kf.shape[0]
        obs_per_shard = O if n_sh == 1 else min(O, 2 * (-(-O // n_sh)))
        ps, _n_route_drop = shard_ba_problem_device(pc, n_sh, obs_per_shard)
        res = dist_bundle_adjust(ps, mesh, iterations=iterations)
        _, rmse0 = ba_cost(pc)
        _, rmse1 = ba_cost(pc, res["R"], res["t"], res["xyz"])
        res = dict(res, rmse_before=rmse0, rmse_after=rmse1)
    elif solver == "cg":
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


_WINDOWED_BA = Program(_windowed_ba_body, static_argnames=("W", "solver", "iterations", "mesh"))
_RELOAD = Program(_reload_body)     # the archive reload's insert (the reference's jitted one)


def _reload_insert(lmap, cand):
    """The reload's insert as one captured program; fresh."""
    return fresh(_RELOAD(lmap, cand))


def _windowed_ba(db: KeyframeDB, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig,
                 W: int, solver: str, iterations: int, mesh=None):
    """``_windowed_ba_body`` as one captured program per (W, solver,
    iterations, mesh, shapes), as the reference jits it; the sharded
    solver's all-reduces on the one-rank group are captured with it.
    Returns fresh tensors (R, t, lmap xyz, R_cur, t_cur, [rmse_before,
    rmse_after, n_dropped_obs])."""
    return fresh(_WINDOWED_BA(db, lmap_xyz, lmap_valid, lmap_gen, R_cw, t_cw, rig, W=W,
                              solver=solver, iterations=iterations, mesh=mesh))


@functools.lru_cache(maxsize=4)
def _live_ba_mesh(n_shards: int, device: torch.device):
    """The mesh of the live ``ba_solver="dist"`` path: ``n_shards`` shards
    (0: one per rank), all on this rank. Cached per (n_shards, device), as
    the reference caches its mesh."""
    mesh = make_ba_mesh(n_shards or None, device=device)
    if mesh.local_shards != mesh.n_shards:
        raise ValueError("the live dist BA holds every shard on one rank; the default "
                         f"process group has {mesh.n_shards // mesh.local_shards} ranks")
    return mesh


def _run_windowed_ba(sys: SlamSystem):
    """Windowed BA over the most recent keyframes, written back. Returns the
    (rmse_before, rmse_after, n_dropped_obs) device tensor, unread."""
    W = sys.bcfg.ba_window
    solver = sys.bcfg.ba_solver
    if solver == "auto":
        solver = "cg" if W > 16 else "dense"
    mesh = _live_ba_mesh(sys.bcfg.dist_devices, sys.device) if solver == "dist" else None
    lmap = sys.state.lmap
    new_R, new_t, new_xyz, R_cur, t_cur, rmse = _windowed_ba(
        sys.kf_db, lmap.xyz, lmap.valid, lmap.generation, sys.state.R_cw, sys.state.t_cw,
        sys.rig, W=W, solver=solver, iterations=sys.bcfg.ba_iterations, mesh=mesh)
    sys.kf_db = sys.kf_db._replace(R=new_R, t=new_t)
    sys.state = sys.state._replace(R_cw=R_cur, t_cw=t_cur, lmap=lmap._replace(xyz=new_xyz))
    sys.n_ba_runs += 1
    return rmse


def _retrain_body(kp_desc, kp_valid, db_valid, db_frame_idx, sample, last_slot, levels: int,
                  branch: int, words: int, draw: Callable, sift: bool):
    """The retrain (``_retrain_vocab``'s device work): the vocabulary over
    every stored keyframe's descriptors and the archive ``sample`` (packed
    descriptors and their mask, or None), then every stored keyframe
    re-quantised into a rebuilt database without ``last_slot``'s. Returns
    (vocabulary, database)."""
    K, N = kp_valid.shape
    desc = kp_desc.reshape(K * N, kp_desc.shape[-1])
    valid = (kp_valid & db_valid[:, None]).reshape(K * N)
    if sample is not None:
        a_desc, a_valid = sample
        desc = torch.cat([desc, lsh_binarize(a_desc) if sift else a_desc])
        valid = torch.cat([valid, a_valid])
    vocab = _vocab_body(desc, valid, levels, branch, words, draw)
    hists = descriptors_to_bow(vocab, kp_desc, kp_valid)
    keep = db_valid & (torch.arange(K, device=kp_desc.device) != last_slot)
    hists = hists * keep[:, None]
    return vocab, BowDatabase(
        hist=hists, frame_idx=torch.where(keep, db_frame_idx, -1).to(torch.int32), valid=keep,
        next_slot=last_slot.clone(), doc_freq=(hists > 0).to(torch.float32).sum(0))


_RETRAIN = Program(_retrain_body, static_argnames=("levels", "branch", "words", "draw", "sift"))


def _retrain_vocab(sys: SlamSystem, draw: Optional[Callable] = None):
    """Retrain the vocabulary over every stored keyframe's descriptors plus a
    fixed-size sample of archived landmark descriptors, and re-quantise the
    stored keyframes; the keyframe just added is left out of the rebuilt
    database (its histogram goes in with the loop gate right after). The
    sample is drawn on the host and goes up from pinned memory; the rest is
    one captured program."""
    db = sys.kf_db
    dev = sys.device
    n_s = sys.bcfg.vocab_archive_sample
    sample = None
    if n_s > 0 and sys.archive is not None and len(sys.archive) > 0:
        arch = sys.archive
        take = min(len(arch), n_s)
        sel = np.random.default_rng(sys.n_keyframes).choice(len(arch), take, replace=False)
        a_desc = np.zeros((n_s,) + arch.desc.shape[1:], arch.desc.dtype)
        a_desc[:take] = arch.desc[sel]
        a_valid = np.zeros(n_s, bool)
        a_valid[:take] = True
        a_desc = a_desc.view(np.int32) if a_desc.dtype == np.uint32 else a_desc
        sample = (upload(a_desc, dev), upload(a_valid, dev))
    last = upload(np.array(sys.last_kf_slot, np.int32), dev)
    sys.vocab, sys.bow_db = fresh(_RETRAIN(
        db.kp_desc, db.kp_valid, db.valid, db.frame_idx, sample, last,
        draw=draw or GeneratorDraw(13, dev), sift=sys.cfg.descriptor == "sift",
        **_vocab_shape(sys.bcfg)))
    sys.n_vocab_trains += 1
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


def _loop_query_verify_body(vocab, bow_db, db: KeyframeDB, kf_slot, frame_idx, K_left,
                            min_frame_gap: int, pnp_threshold: float, noise, top_k: int = 3):
    """The loop gate: BoW histogram of the keyframe -> TF-IDF query ->
    per-candidate match + PnP + measured edge T_new_old = T_pnp ∘ T_old⁻¹,
    and the keyframe's histogram added to the database. ``kf_slot`` and
    ``frame_idx`` are 0-d device tensors. Returns (new bow db, one packed
    vector [scores, frames, slots, n_corr, n_inl, R (k·9), t (k·3)])."""
    row = kf_slot.reshape(1).long()
    desc, valid, xy = (x.index_select(0, row)[0] for x in (db.kp_desc, db.kp_valid, db.kp_xy))
    hist = descriptors_to_bow(vocab, desc, valid)
    scores, frames, slots = bow_db_query(bow_db, hist, frame_idx, min_frame_gap=min_frame_gap,
                                         top_k=top_k)
    new_bow_db = bow_db_add(bow_db, hist, frame_idx)
    n_corr, n_inl, R, t = _verify_candidates(db, desc, valid, xy, slots, K_left, pnp_threshold,
                                             noise)
    Ri, ti = se3_inverse(db.R[slots], db.t[slots])
    Rm, tm = se3_compose(R, t, Ri, ti)
    f32 = torch.float32
    packed = torch.cat([scores, frames.to(f32), slots.to(f32), n_corr.to(f32), n_inl.to(f32),
                        Rm.reshape(-1), tm.reshape(-1)])
    return new_bow_db, packed


_LOOP_GATE = Program(_loop_query_verify_body,
                     static_argnames=("min_frame_gap", "pnp_threshold", "top_k"))


def _loop_query_verify(vocab, bow_db, db: KeyframeDB, kf_slot: int, frame_idx: int, K_left,
                       min_frame_gap: int, pnp_threshold: float, noise, top_k: int = 3):
    """The loop gate as one captured program (the reference's jitted
    ``_loop_query_verify``); ``kf_slot`` and ``frame_idx`` reach it as 0-d
    device tensors, so each replay takes this call's. Returns fresh (new bow
    db, packed verdict)."""
    dev = db.R.device
    slot = torch.full((), kf_slot, dtype=torch.int64, device=dev)
    fidx = torch.full((), frame_idx, dtype=torch.int32, device=dev)
    return fresh(_LOOP_GATE(vocab, bow_db, db, slot, fidx, K_left, min_frame_gap=min_frame_gap,
                            pnp_threshold=pnp_threshold, noise=noise, top_k=top_k))


def _reloc_query_body(vocab, bow_db, db: KeyframeDB, cur_desc, cur_valid, cur_xy, K_left,
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


_RELOC_GATE = Program(_reloc_query_body, static_argnames=("pnp_threshold", "top_k"))


def _reloc_query(vocab, bow_db, db: KeyframeDB, cur_desc, cur_valid, cur_xy, K_left,
                 pnp_threshold: float, noise, top_k: int = 3):
    """The relocalisation gate as one captured program (the reference's
    ``_reloc_query_jit``). Returns a fresh packed verdict."""
    return fresh(_RELOC_GATE(vocab, bow_db, db, cur_desc, cur_valid, cur_xy, K_left,
                             pnp_threshold=pnp_threshold, noise=noise, top_k=top_k))


def _gate_noise(seed: int, top_k: int, n: int, device):
    """Gumbel draws of a loop or reloc gate's PnP: (top_k, LOOP_PNP_ITERS, n)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return gumbel(g, (top_k, LOOP_PNP_ITERS, n), device)


def _try_relocalize(sys: SlamSystem, noise=None) -> bool:
    """Kidnap recovery: BoW-query the current frame, PnP-verify, and on
    success restart the tracker at the verified anchor (live map and
    feature table invalidated, motion model reset). One blocking read."""
    snap = _snapshot(sys, NOW)
    k = sys.bcfg.bow_top_k
    if noise is None:
        noise = _gate_noise(sys.n_frames, min(k, sys.bcfg.max_keyframes), snap.xy.shape[0],
                            sys.device)
    packed = _reloc_query(sys.vocab, sys.bow_db, sys.kf_db, _binary_codes(sys.cfg, snap.desc),
                          snap.valid, snap.xy, sys.rig.left.K, sys.bcfg.loop_pnp_threshold,
                          noise, top_k=k)
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
    p = packed.numpy("loop")
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
    Rt = upload(np.concatenate([Rms[pick].reshape(-1), tms[pick]]).astype(np.float32), sys.device)
    _append_edge(sys, kf_slot, int(slots[pick]), Rt[:9].view(3, 3), Rt[9:], 5.0)
    sys.n_loop_closures += 1
    _run_pose_graph(sys)
    return True


def _pose_graph_body(R, t, valid, frame_idx, kp_xyz, edge_R, edge_t, edge_meta, slot, R_cw,
                     t_cw, lmap_xyz, iterations: int):
    """The pose graph (the reference's jitted ``optimize_pose_graph``) over
    the database's poses and the edge rows (``edge_meta`` = [i, j, weight,
    valid] per row), gauge the oldest valid keyframe, then the correction
    carried to the keyframes' landmark snapshots, the live pose and the live
    map by keyframe ``slot``'s change (a 0-d device tensor). Returns (R, t,
    kp_xyz, R_cw, t_cw, lmap xyz, R_old, t_old, R_new, t_new)."""
    K = R.shape[0]
    dev = R.device
    # gauge: the oldest valid keyframe (none when the database is empty)
    big = torch.full((), 2 ** 30, dtype=frame_idx.dtype, device=dev)
    oldest = torch.argmin(torch.where(valid, frame_idx, big))
    fixed = (torch.arange(K, device=dev) == oldest) & valid.any()
    g = PoseGraph(R=R, t=t, node_valid=valid, node_fixed=fixed,
                  edge_i=edge_meta[:, 0].to(torch.int32), edge_j=edge_meta[:, 1].to(torch.int32),
                  edge_R=edge_R, edge_t=edge_t, edge_valid=edge_meta[:, 3] > 0.5,
                  edge_weight=edge_meta[:, 2])
    res = optimize_pose_graph(g, iterations=iterations)
    row = slot.reshape(1)
    R_old, t_old = R.index_select(0, row)[0], t.index_select(0, row)[0]
    R_new, t_new = res["R"].index_select(0, row)[0], res["t"].index_select(0, row)[0]
    Rd = torch.einsum("kji,kjl->kil", res["R"], R)             # R_newᵀ R_old
    td = torch.einsum("kji,kj->ki", res["R"], t - res["t"])    # R_newᵀ(t_old − t_new)
    new_xyz = torch.einsum("kij,knj->kni", Rd, kp_xyz) + td[:, None, :]
    Ri, ti = se3_inverse(R_old, t_old)
    Rc, tc = se3_compose(R_new, t_new, Ri, ti)
    R_cur, t_cur = se3_compose(Rc, tc, R_cw, t_cw)
    lm_xyz = lmap_xyz @ Rd.index_select(0, row)[0].T + td.index_select(0, row)[0]
    return res["R"], res["t"], new_xyz, R_cur, t_cur, lm_xyz, R_old, t_old, R_new, t_new


_POSE_GRAPH = Program(_pose_graph_body, static_argnames=("iterations",))


def _edge_rows(sys: SlamSystem, n_e: int) -> tuple:
    """The first ``n_e`` edges' measurements stacked into ``max_edges``
    device rows (identity past ``n_e``); a restored system's host entries
    go up from pinned memory."""
    E, dev = sys.bcfg.max_edges, sys.device

    def stacked(xs):
        return torch.stack([x if torch.is_tensor(x) else upload(np.asarray(x, np.float32), dev)
                            for x in xs[:n_e]])

    R = torch.eye(3, device=dev).repeat(E, 1, 1)
    t = torch.zeros((E, 3), device=dev)
    R[:n_e] = stacked(sys.edge_R)
    t[:n_e] = stacked(sys.edge_t)
    return R, t


def _run_pose_graph(sys: SlamSystem):
    """Optimise all keyframe poses over odometry and loop edges (the first
    ``max_edges`` edges), then carry the correction to the keyframes'
    landmark snapshots, the live pose, the live map and the queued
    snapshots: one captured program, its edges' measurements stacked from
    the device tensors kept as each edge was appended and their indices
    and weights uploaded from pinned memory."""
    E = sys.bcfg.max_edges
    dev = sys.device
    n_e = min(len(sys.edge_i), E)
    meta = np.zeros((E, 4), np.float32)
    meta[:n_e, 0] = sys.edge_i[:n_e]
    meta[:n_e, 1] = sys.edge_j[:n_e]
    meta[:n_e, 2] = sys.edge_w[:n_e]
    meta[:n_e, 3] = 1.0
    db, lmap = sys.kf_db, sys.state.lmap
    R, t, kp_xyz, R_cur, t_cur, lm_xyz, *delta = fresh(_POSE_GRAPH(
        db.R, db.t, db.valid, db.frame_idx, db.kp_xyz, *_edge_rows(sys, n_e), upload(meta, dev),
        upload(np.array(sys.last_kf_slot, np.int64), dev), sys.state.R_cw, sys.state.t_cw,
        lmap.xyz, iterations=sys.bcfg.pose_graph_iterations))
    sys.kf_db = db._replace(R=R, t=t, kp_xyz=kp_xyz)
    sys.state = sys.state._replace(R_cw=R_cur, t_cw=t_cur, lmap=lmap._replace(xyz=lm_xyz))
    sys._pg_delta = tuple(delta)
    sys._tel_queue = [(packed, _epoch_correct(sys, s, fidx), fidx)
                      for packed, s, fidx in sys._tel_queue]


def _info(frame_idx, step_ms: float) -> dict:
    return {"ba": None, "loop": False, "frame": frame_idx, "step_ms": step_ms,
            "backend_ms": 0.0}


def process_frame(sys: SlamSystem, img_l, img_r, imu=None, noise=None):
    """One frame (two (H, W) images, numpy arrays or tensors) through the full
    system. Returns (telemetry or None while the lag queue fills, backend
    info). ``noise``: the front end's ``CascadeNoise`` (None: drawn from the
    state's generator). ``imu``: optional (gyro (S, 3), accel (S, 3), dts
    (S,), mask (S,)), arrays or tensors, the IMU samples of the interval
    ending at this frame (the VIO branch)."""
    with tracing.span("frame", frame=sys.n_frames):
        return _process_frame(sys, img_l, img_r, imu, noise)


def _process_frame(sys: SlamSystem, img_l, img_r, imu, noise):
    t0 = time.perf_counter()
    with tracing.span("frame.upload"):
        img_l = torch.as_tensor(img_l, dtype=torch.float32, device=sys.device)
        img_r = torch.as_tensor(img_r, dtype=torch.float32, device=sys.device)
    if sys.step is None:
        sys.step = SlamStep(sys.cfg, sys.rig)
    sys.state, _, packed = sys.step._run(sys.state, img_l, img_r, noise=noise, imu=imu)
    packed = HostCopy(packed)
    sys.n_frames += 1
    L = sys.bcfg.telemetry_lag
    if L > 0:
        frame = sys.n_frames - 1
        with tracing.span("frame.snapshot"):
            snap = _snapshot(sys, _ring_slot(sys, frame))
        sys._tel_queue.append((packed, snap, frame))
        if len(sys._tel_queue) <= L:
            return None, _info(None, (time.perf_counter() - t0) * 1000)
        packed, snap, frame_idx = sys._tel_queue.pop(0)
    else:
        snap, frame_idx = None, sys.n_frames - 1
    sys.host_reads["telemetry"] += 1
    tel = unpack_telemetry(packed.numpy("telemetry", frame_idx))
    t1 = time.perf_counter()
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
        with tracing.span("frame.backend", frame=frame_idx):
            if snap is None:
                snap = _snapshot(sys, NOW)
            _keyframe_backend(sys, snap, frame_idx, backend_info)
        backend_info["backend_ms"] = (time.perf_counter() - t1) * 1000
    return tel, backend_info


def flush_pipeline(sys: SlamSystem):
    """Drain the lagged-telemetry queue at sequence end; returns the remaining
    [(telemetry, backend info), …] in frame order, then resolves a pending
    loop gate and spill."""
    with tracing.span("flush"):
        return _flush_pipeline(sys)


def _flush_pipeline(sys: SlamSystem):
    out = []
    while sys._tel_queue:
        packed, snap, frame_idx = sys._tel_queue.pop(0)
        sys.host_reads["telemetry"] += 1
        tel = unpack_telemetry(packed.numpy("telemetry", frame_idx))
        info = _info(frame_idx, 0.0)
        if bool(tel.is_keyframe):
            t1 = time.perf_counter()
            with tracing.span("frame.backend", frame=frame_idx):
                _keyframe_backend(sys, snap, frame_idx, info)
            info["backend_ms"] = (time.perf_counter() - t1) * 1000
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
        sys.archive.sync_packed(sys._pending_spill.numpy("spill"))
        sys._pending_spill = None


def _keyframe_backend(sys: SlamSystem, snap: KfSnap, frame_idx: int, backend_info: dict,
                      draws: Optional[BackendDraws] = None):
    """All per-keyframe back-end work, in the reference's order. ``snap`` is
    the snapshot taken at the keyframe; corrections apply to the live
    ``sys.state``. Each phase is a ``backend.*`` span (``utils/tracing.py``)."""
    draws = draws or BackendDraws()
    # the previous keyframe's deferred spill, then the frustum reload
    with tracing.span("backend.spill_resolve"):
        if sys.bcfg.enable_map_spill and sys.archive is not None:
            flush_pending_spill(sys)
            if sys.archive.dormant.any():
                sys.host_reads["reload"] += 1
            sys.state = sys.state._replace(lmap=sys.archive.reload(
                sys.state.lmap, sys.state.R_cw, sys.state.t_cw, sys.rig.left, sys.n_frames,
                reload_max=sys.bcfg.spill_reload_max, radius=sys.bcfg.spill_radius,
                insert=_reload_insert))
            backend_info["spill"] = {"archived": len(sys.archive),
                                     "reloads": sys.archive.n_reloads}
    # the previous keyframe's deferred loop gate: a fired pose graph corrects
    # the epoch before this keyframe's snapshot enters the database
    with tracing.span("backend.resolve"):
        if sys._pending_loop is not None:
            packed, pslot, pframe = sys._pending_loop
            sys._pending_loop = None
            fired = _try_loop_closure(sys, pslot, pframe, packed=packed)
            backend_info["loop"] = fired
            if fired:
                snap = _epoch_correct(sys, snap, frame_idx)
    with tracing.span("backend.kf_add"):
        prev_slot = sys.last_kf_slot
        slot = sys.n_keyframes % sys.bcfg.max_keyframes   # host mirror of kf_db.next_slot
        sys.n_keyframes += 1
        kf_desc = _binary_codes(sys.cfg, snap.desc)
        _kf_add(sys, snap, kf_desc, frame_idx, slot, prev_slot)
        sys.last_kf_slot = slot
        # the snapshot's ring entry is called again telemetry_lag + 1 frames
        # on; the caller (the app's overlays) keeps this one longer
        sys.last_kf_snap = fresh(snap)
    pending_loop = None
    with tracing.span("backend.loop_issue"):
        if sys.bcfg.enable_loop_closure:
            n_kfs = sys.n_keyframes
            if sys.vocab is None:
                sys.vocab = _train_vocab(sys.bcfg, kf_desc, snap.valid,
                                         draws.vocab or GeneratorDraw(7, sys.device))
                sys.n_vocab_trains += 1
            elif (n_kfs >= sys.bcfg.vocab_retrain_kfs
                  and n_kfs >= sys.last_vocab_kfs * sys.bcfg.vocab_retrain_growth):
                _retrain_vocab(sys, draws.vocab)
            pending_loop = _loop_issue(sys, slot, frame_idx, draws.loop_noise)
    with tracing.span("backend.ba_dispatch"):
        if sys.bcfg.ba_every_kf and prev_slot >= 0:
            backend_info["ba"] = _run_windowed_ba(sys)
    with tracing.span("backend.resolve_sync"):
        if pending_loop is not None:
            if sys.bcfg.loop_resolve_lag > 0:
                sys._pending_loop = (pending_loop, slot, frame_idx)
            else:
                backend_info["loop"] = _try_loop_closure(sys, slot, frame_idx,
                                                         packed=pending_loop)
    if sys.bcfg.enable_map_spill and sys.archive is not None:
        # the packed table (``_pack_live``'s captured program; the caller's)
        # goes to the host behind an event, read a keyframe later at most
        with tracing.span("backend.spill_pack"):
            sys._pending_spill = HostCopy(_pack_live(sys.state.lmap))
        if sys.bcfg.spill_resolve_lag == 0:
            with tracing.span("backend.spill_sync"):
                flush_pending_spill(sys)


def run_system(sys: SlamSystem, left, right, imu=None):
    """Run a (T, H, W) stereo sequence (numpy arrays or tensors) through the
    full system; returns (telemetry stacked over frames as numpy, infos).
    imu: optional (gyro (T, S, 3), accel (T, S, 3), dts (T, S), mask (T, S))."""
    tels, infos = [], []
    for t in range(left.shape[0]):
        fi = None if imu is None else tuple(x[t] for x in imu)
        tel, info = process_frame(sys, left[t], right[t], imu=fi)
        if tel is not None:
            tels.append(tel)
            infos.append(info)
    for tel, info in flush_pipeline(sys):
        tels.append(tel)
        infos.append(info)
    telem = type(tels[0])(*(np.stack([np.asarray(x) for x in xs]) for xs in zip(*tels)))
    return telem, infos
