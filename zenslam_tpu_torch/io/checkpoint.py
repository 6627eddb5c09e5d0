"""Checkpoint and resume of SLAM state and of the whole keyframe system —
counterpart of ``zenslam_tpu/io/checkpoint.py``.

- ``save_pytree`` / ``load_pytree``: a tree of NamedTuples, dicts, tuples and
  lists whose leaves are tensors or Python numbers (``SlamState``,
  ``KeyframeDB``, ``BowDatabase``, ...) to one ``.npz``. Loading is
  template-driven: the caller passes a structurally identical tree (e.g.
  from ``init_state``) and gets the saved leaves back in that structure, with
  the template's dtypes and devices. Leaf names and tensor shapes are
  checked against the template.
- ``save_system`` / ``load_system``: the live ``SlamSystem``: state (with
  the ``rng_seed`` / ``rng_step`` pair the per-frame generator is seeded
  from), keyframe DB, BoW database and vocabulary, pose-graph edges, host
  counters, the telemetry queue of a lagged system and the landmark archive.
  A deferred spill and a deferred loop verdict are resolved before writing,
  as the reference does. A resumed run reproduces an uninterrupted one bit
  for bit on the CPU.

bfloat16 tensors (the kernel path's pyramid) are stored as their int16 bit
patterns.
"""

from __future__ import annotations

import numpy as np
import torch

_FORMAT_VERSION = 1
_SCALAR_LEAVES = (bool, int, float, str, np.ndarray, np.generic)


def _flatten(tree, prefix: str = ""):
    """[(name, leaf)] in a fixed order; None leaves are skipped."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, *_SCALAR_LEAVES)):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in _flatten(v, f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}[{i}]")]
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__} at {prefix!r}")


def _rebuild(template, leaves):
    """``template`` with its leaves replaced, in order, from the iterator."""
    if template is None:
        return None
    if isinstance(template, (torch.Tensor, *_SCALAR_LEAVES)):
        return next(leaves)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves) for k, v in template.items()}
    return type(template)(_rebuild(v, leaves) for v in template)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()
    return np.asarray(x)


def _like(saved: np.ndarray, t):
    """The saved array as a leaf of the template leaf ``t``'s kind."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return torch.from_numpy(saved).view(torch.bfloat16).to(t.device)
        return torch.from_numpy(saved).to(device=t.device, dtype=t.dtype)
    if isinstance(t, (bool, np.bool_)):
        return bool(saved)
    if isinstance(t, int):
        return int(saved)
    if isinstance(t, float):
        return float(saved)
    if isinstance(t, str):
        return str(saved)
    return saved.astype(np.asarray(t).dtype)


def _payload(tree) -> dict:
    named = _flatten(tree)
    payload = {f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(named)}
    payload["__names__"] = np.asarray([n for n, _ in named])
    payload["__version__"] = np.asarray(_FORMAT_VERSION)
    return payload


def _restore(data, template):
    names = [str(s) for s in data["__names__"]]
    named = _flatten(template)
    t_names = [n for n, _ in named]
    if t_names != names:
        raise ValueError(f"checkpoint structure mismatch: missing="
                         f"{sorted(set(t_names) - set(names))} extra={sorted(set(names) - set(t_names))}")
    leaves = []
    for i, (name, t) in enumerate(named):
        saved = data[f"leaf_{i}"]
        if isinstance(t, torch.Tensor) and tuple(saved.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint structure mismatch: {name} has shape "
                             f"{tuple(saved.shape)}, the template {tuple(t.shape)}")
        leaves.append(_like(saved, t))
    return _rebuild(template, iter(leaves))


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors and numbers to ``path`` (.npz)."""
    np.savez(path, **_payload(tree))


def load_pytree(path: str, template):
    """Load a tree saved by :func:`save_pytree` into ``template``'s
    structure, dtypes and devices; raises ValueError on a structure or
    shape mismatch."""
    with np.load(path, allow_pickle=False) as data:
        return _restore(data, template)


_SCALARS = ("last_kf_slot", "n_loop_closures", "n_ba_runs", "n_frames", "n_keyframes",
            "last_vocab_kfs", "n_relocs", "n_vocab_trains", "_lost_count", "_reloc_cooldown")


def save_system(path: str, system) -> None:
    """Snapshot a ``SlamSystem`` (see the module docstring). Resolves the
    deferred spill and loop verdict first, so the saved system has none."""
    from zenslam_tpu_torch.backend.bow import Vocabulary
    from zenslam_tpu_torch.pipeline.system import _try_loop_closure, flush_pending_spill

    flush_pending_spill(system)
    if system._pending_loop is not None:
        packed, pslot, pframe = system._pending_loop
        system._pending_loop = None
        _try_loop_closure(system, pslot, pframe, packed=packed)

    queue = system._tel_queue
    payload = _payload({"state": system.state, "kf_db": system.kf_db, "bow_db": system.bow_db,
                        "tel_queue": [snap for _, snap, _ in queue]})
    payload["tel_queue_packed"] = np.stack([p.numpy() for p, _, _ in queue]) if queue \
        else np.zeros((0, 25), np.float32)
    payload["tel_queue_frame"] = np.asarray([f for _, _, f in queue], np.int64)
    if system.vocab is None:
        payload["vocab_kind"] = np.asarray("none")
    elif isinstance(system.vocab, Vocabulary):
        payload["vocab_kind"] = np.asarray("tree")
        payload["vocab_l1"] = _to_numpy(system.vocab.l1)
        payload["vocab_l2"] = _to_numpy(system.vocab.l2)
    else:
        payload["vocab_kind"] = np.asarray("flat")
        payload["vocab"] = _to_numpy(system.vocab)
    n_e = len(system.edge_i)
    payload["edge_i"] = np.asarray(system.edge_i, np.int32).reshape(n_e)
    payload["edge_j"] = np.asarray(system.edge_j, np.int32).reshape(n_e)
    payload["edge_R"] = (np.stack([_to_numpy(r) for r in system.edge_R]).astype(np.float32)
                         if n_e else np.zeros((0, 3, 3), np.float32))
    payload["edge_t"] = (np.stack([_to_numpy(t) for t in system.edge_t]).astype(np.float32)
                         if n_e else np.zeros((0, 3), np.float32))
    payload["edge_w"] = np.asarray(system.edge_w, np.float32).reshape(n_e)
    payload["scalars"] = np.asarray([getattr(system, k) for k in _SCALARS], np.int64)
    a = system.archive
    if a is not None:
        payload["archive_xyz"] = a.xyz
        payload["archive_desc"] = a.desc
        payload["archive_color"] = a.color
        payload["archive_dormant"] = a.dormant
        rk = np.full((len(a.xyz), 2), -1, np.int64)
        for row, key in enumerate(a._row_key):
            if key is not None:
                rk[row] = key
        payload["archive_row_key"] = rk
        payload["archive_counters"] = np.asarray([a.n_reloads, a.n_spills], np.int64)
        payload["archive_reload_keys"] = np.asarray(sorted(a.reload_keys), np.int64).reshape(-1, 2)
        if a._slot_row is not None:
            payload["archive_slot_row"] = a._slot_row
            payload["archive_slot_gen"] = a._slot_gen
    np.savez(path, **payload)


def load_system(path: str, cfg, bcfg, rig, image_shape, seed: int = 0, device=None):
    """Rebuild a ``SlamSystem`` from :func:`save_system` output on ``device``
    (default CUDA, raising when absent). ``cfg``, ``bcfg`` and ``rig`` must be
    the saved run's: static configuration is not serialised."""
    from zenslam_tpu_torch.backend.bow import Vocabulary
    from zenslam_tpu_torch.pipeline.system import HostCopy, _kf_snapshot, create_system

    system = create_system(cfg, bcfg, rig, image_shape, seed=seed, device=device)
    dev = system.device
    with np.load(path, allow_pickle=False) as data:
        frames = [int(f) for f in data["tel_queue_frame"]]
        snap = _kf_snapshot(system.state)
        restored = _restore(data, {"state": system.state, "kf_db": system.kf_db,
                                   "bow_db": system.bow_db, "tel_queue": [snap] * len(frames)})
        system.state = restored["state"]
        system.kf_db = restored["kf_db"]
        system.bow_db = restored["bow_db"]
        packed = data["tel_queue_packed"]
        system._tel_queue = [(HostCopy(torch.from_numpy(packed[i].copy())), s, f)
                             for i, (s, f) in enumerate(zip(restored["tel_queue"], frames))]
        kind = str(data["vocab_kind"])
        if kind == "tree":
            system.vocab = Vocabulary(l1=torch.from_numpy(data["vocab_l1"]).to(dev),
                                      l2=torch.from_numpy(data["vocab_l2"]).to(dev))
        elif kind == "flat":
            system.vocab = torch.from_numpy(data["vocab"]).to(dev)
        system.edge_i = [int(x) for x in data["edge_i"]]
        system.edge_j = [int(x) for x in data["edge_j"]]
        system.edge_R = [x for x in data["edge_R"]]
        system.edge_t = [x for x in data["edge_t"]]
        system.edge_w = [float(x) for x in data["edge_w"]]
        for k, v in zip(_SCALARS, data["scalars"]):
            setattr(system, k, int(v))
        if "archive_xyz" in data.files and system.archive is not None:
            a = system.archive
            a.xyz = np.array(data["archive_xyz"])
            a.desc = np.array(data["archive_desc"])
            a.color = np.array(data["archive_color"])
            a.dormant = np.array(data["archive_dormant"])
            rk = data["archive_row_key"]
            a._row_key = [None if rk[i, 0] < 0 else (int(rk[i, 0]), int(rk[i, 1]))
                          for i in range(len(rk))]
            a._key_to_row = {k: i for i, k in enumerate(a._row_key) if k is not None}
            a.n_reloads, a.n_spills = (int(c) for c in data["archive_counters"])
            a.reload_keys = {(int(x), int(y)) for x, y in data["archive_reload_keys"]}
            if "archive_slot_row" in data.files:
                a._slot_row = np.array(data["archive_slot_row"])
                a._slot_gen = np.array(data["archive_slot_gen"])
    return system
