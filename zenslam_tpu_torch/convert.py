"""State carried across from the reference: configs, rigs and SLAM states
whose leaves are numpy arrays, converted to this package's tensors and back.

The input trees are the reference's NamedTuples after every leaf was made a
numpy array (done by the caller; nothing here imports JAX). Conversions:

- uint32 descriptor words become int32 tensors with the same bit patterns;
  the SIFT family's (N, 128) float32 descriptors stay float32 both ways;
- bfloat16 pyramid levels (``ml_dtypes.bfloat16`` numpy arrays, which
  ``torch.from_numpy`` refuses) go through a uint16 view;
- the reference pads ragged levels to TPU tile alignment: each level is
  cropped to its true size ``[:h, :w]``;
- the JAX PRNG key has no counterpart: the state gets ``seed`` and its
  frame counter as ``rng_step``. The keyline tables (``LineTable``,
  ``Line3dMap``, ``next_line_id``) and the VIO state (gravity ring, 3-pose
  history, velocity) carry over both ways.

The back end's tables (``KeyframeDB``, ``BowDatabase``, ``Vocabulary``,
``PoseGraph``, ``BAProblem``) convert field by field (``table_from_numpy``,
``table_to_numpy``), and a whole ``SlamSystem`` from an object with the
reference system's attributes and numpy leaves (``system_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

import copy
import dataclasses
from types import SimpleNamespace

from zenslam_tpu_torch.backend.bow import BowDatabase, Vocabulary
from zenslam_tpu_torch.backend.keyframes import KeyframeDB
from zenslam_tpu_torch.backend.map_archive import LandmarkArchive
from zenslam_tpu_torch.geometry.camera import PinholeCamera, StereoRig
from zenslam_tpu_torch.ops.lk import ragged_level_sizes
from zenslam_tpu_torch.pipeline.state import (
    FeatureTable, LandmarkMap, Line3dMap, LineTable, MotionModel, SlamConfig, SlamState,
    VioState, init_vio)
from zenslam_tpu_torch.pipeline.system import BackendConfig, KfSnap, SlamSystem
from zenslam_tpu_torch.utils.device import HostCopy


def config_from_dict(d) -> SlamConfig:
    """SlamConfig from a mapping of the reference's field names."""
    return SlamConfig(**dict(d))


def tensor_from_numpy(x, device, dtype=None):
    """A tensor copy of a numpy array: uint32 as int32 bit patterns, bfloat16
    through a 16-bit view."""
    a = np.array(x)  # a writable, contiguous copy (keeps 0-d arrays 0-d)
    if a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    elif a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _table(cls, src, device):
    """A NamedTuple of tensors from the same-named fields of ``src`` (the
    reference's leaves already carry this package's dtypes)."""
    return cls(*(tensor_from_numpy(getattr(src, name), device) for name in cls._fields))


def rig_from_numpy(tree, device) -> StereoRig:
    """StereoRig from a reference rig with numpy leaves."""
    def cam(c):
        return PinholeCamera(*(tensor_from_numpy(getattr(c, k), device, torch.float32)
                               for k in ("fx", "fy", "cx", "cy", "dist")),
                             width=int(np.asarray(c.width)), height=int(np.asarray(c.height)))

    return StereoRig(cam(tree.left), cam(tree.right),
                     *(tensor_from_numpy(getattr(tree, k), device, torch.float32)
                       for k in ("R_rl", "t_rl", "R_ci", "t_ci")))


def state_from_numpy(tree, device, image_shape=None, seed: int = 0,
                     pyramid_dtype=None) -> SlamState:
    """SlamState from a reference state with numpy leaves. image_shape (H, W)
    gives the true level sizes; by default the level-0 array's shape, which
    is exact when W is a multiple of 128 (>= 256) and H a multiple of 8
    (>= 32). pyramid_dtype: cast the levels (default: keep their dtype).
    seed: the generator seed when the tree carries none (a reference state);
    a tree from ``state_to_numpy`` keeps its own seed and counter."""
    levels = tuple(tree.prev_pyr_l)
    if image_shape is None:
        image_shape = np.asarray(levels[0]).shape
    sizes = ragged_level_sizes(int(image_shape[0]), int(image_shape[1]), len(levels))
    scalars = ("R_cw", "t_cw", "last_kf_R", "last_kf_t", "frames_since_kf",
               "frame_idx", "next_track_id", "next_line_id")
    return SlamState(
        features=_table(FeatureTable, tree.features, device),
        lmap=_table(LandmarkMap, tree.lmap, device),
        lines=_table(LineTable, tree.lines, device),
        line_map=_table(Line3dMap, tree.line_map, device),
        motion=_table(MotionModel, tree.motion, device),
        **{k: tensor_from_numpy(getattr(tree, k), device) for k in scalars},
        prev_pyr_l=tuple(tensor_from_numpy(np.asarray(p)[:h, :w], device, pyramid_dtype)
                         for p, (h, w) in zip(levels, sizes)),
        rng_seed=int(getattr(tree, "rng_seed", seed)),
        rng_step=int(getattr(tree, "rng_step", np.asarray(tree.frame_idx))),
        vio=(_table(VioState, tree.vio, device) if getattr(tree, "vio", None) is not None
             else init_vio(device=device)))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_np(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x


def _words(desc: np.ndarray) -> np.ndarray:
    """int32 descriptor words as the reference's uint32; float (SIFT)
    descriptors unchanged."""
    return desc.view(np.uint32) if desc.dtype == np.int32 else desc


def state_to_numpy(state: SlamState) -> SlamState:
    """The state with every tensor made a numpy array (descriptor words as
    uint32, float descriptors as float32, bf16 levels widened exactly to
    float32)."""
    out = _np(state)
    return out._replace(
        features=out.features._replace(desc=_words(out.features.desc)),
        lmap=out.lmap._replace(desc=_words(out.lmap.desc)),
        lines=out.lines._replace(desc=_words(out.lines.desc)),
        line_map=out.line_map._replace(desc=_words(out.line_map.desc)))


def backend_config_from_dict(d) -> BackendConfig:
    """BackendConfig from a mapping of the reference's field names (e.g.
    ``dataclasses.asdict(jax_bcfg)``)."""
    return BackendConfig(**dict(d))


def table_from_numpy(cls, tree, device):
    """A NamedTuple ``cls`` (KeyframeDB, BowDatabase, Vocabulary, PoseGraph,
    BAProblem, KfSnap, …) from the same-named fields of a reference table
    with numpy leaves. A flat vocabulary (one array) converts as a tensor."""
    if cls is Vocabulary and not hasattr(tree, "l1"):
        return tensor_from_numpy(tree, device)
    return _table(cls, tree, device)


def table_to_numpy(table):
    """A table with every tensor made a numpy array; int32 descriptor words
    (``KeyframeDB.kp_desc``, ``KfSnap.desc``) come back as uint32, a SIFT
    snapshot's float descriptors as float32."""
    out = _np(table)
    if isinstance(table, KeyframeDB):
        out = out._replace(kp_desc=_words(out.kp_desc))
    if isinstance(table, KfSnap):
        out = out._replace(desc=_words(out.desc))
    return out


def archive_copy(src) -> LandmarkArchive:
    """A LandmarkArchive with the state of ``src`` (the reference's archive
    or this package's), copied."""
    arch = LandmarkArchive(src.desc.shape[1:], src.desc.dtype)
    for k, v in vars(src).items():
        setattr(arch, k, copy.deepcopy(v))
    return arch


def system_from_numpy(src, device, image_shape, seed: int = 0) -> SlamSystem:
    """A SlamSystem from ``src``, an object with the reference SlamSystem's
    attributes whose array leaves (state, tables, vocabulary, edges, queued
    snapshots and packed reads) are numpy arrays. The configs may be the
    reference's (converted by field) or this package's."""
    cfg = config_from_dict(src.cfg._asdict())
    bcfg = backend_config_from_dict(dataclasses.asdict(src.bcfg))
    dev = torch.device(device)

    def t(x):
        return tensor_from_numpy(x, dev)

    def snap(x):
        return None if x is None else table_from_numpy(KfSnap, x, dev)

    rig = src.rig if isinstance(src.rig, StereoRig) else rig_from_numpy(src.rig, dev)
    sys = SlamSystem(
        cfg=cfg, bcfg=bcfg, rig=rig, device=dev,
        state=state_from_numpy(src.state, dev, image_shape=image_shape, seed=seed),
        kf_db=table_from_numpy(KeyframeDB, src.kf_db, dev),
        bow_db=table_from_numpy(BowDatabase, src.bow_db, dev),
        archive=None if src.archive is None else archive_copy(src.archive),
        vocab=None if src.vocab is None else table_from_numpy(Vocabulary, src.vocab, dev))
    sys.edge_i = [int(i) for i in src.edge_i]
    sys.edge_j = [int(j) for j in src.edge_j]
    sys.edge_R = [t(np.asarray(r, np.float32)) for r in src.edge_R]
    sys.edge_t = [t(np.asarray(x, np.float32)) for x in src.edge_t]
    sys.edge_w = [float(w) for w in src.edge_w]
    for name in ("last_kf_slot", "n_loop_closures", "n_ba_runs", "n_relocs", "_lost_count",
                 "_reloc_cooldown", "n_frames", "n_keyframes", "last_vocab_kfs"):
        setattr(sys, name, int(getattr(src, name)))
    sys.loop_debug = copy.deepcopy(list(src.loop_debug))
    sys.last_kf_snap = snap(src.last_kf_snap)
    sys._tel_queue = [(HostCopy(t(p)), snap(s), int(f)) for p, s, f in src._tel_queue]
    if src._pending_loop is not None:
        p, slot, frame = src._pending_loop
        sys._pending_loop = (HostCopy(t(p)), int(slot), int(frame))
    if src._pending_spill is not None:
        sys._pending_spill = HostCopy(t(src._pending_spill))
    if src._pg_delta is not None:
        sys._pg_delta = tuple(t(x) for x in src._pg_delta)
    return sys


def system_to_numpy(sys: SlamSystem) -> SimpleNamespace:
    """The system's tables, state and counters with numpy leaves (descriptor
    words as uint32), under the reference's attribute names."""
    return SimpleNamespace(
        state=state_to_numpy(sys.state), kf_db=table_to_numpy(sys.kf_db),
        bow_db=table_to_numpy(sys.bow_db),
        vocab=None if sys.vocab is None else table_to_numpy(sys.vocab),
        archive=None if sys.archive is None else archive_copy(sys.archive),
        edge_i=list(sys.edge_i), edge_j=list(sys.edge_j),
        edge_R=[np.asarray(_np(r)) for r in sys.edge_R],
        edge_t=[np.asarray(_np(x)) for x in sys.edge_t], edge_w=list(sys.edge_w),
        last_kf_slot=sys.last_kf_slot, n_loop_closures=sys.n_loop_closures,
        n_ba_runs=sys.n_ba_runs, n_relocs=sys.n_relocs, n_frames=sys.n_frames,
        n_keyframes=sys.n_keyframes, last_vocab_kfs=sys.last_vocab_kfs)
