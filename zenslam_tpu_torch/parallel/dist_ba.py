"""Sharded bundle adjustment over a ``torch.distributed`` process group —
counterpart of ``zenslam_tpu/parallel/dist_ba.py``.

The reference shards the landmark dimension over a JAX mesh (one shard per
device), eliminates landmarks locally per shard and assembles the reduced
camera system with one ``psum`` per LM iteration. Here a shard is a
contiguous block of landmarks and of the observations routed to them; each
rank of the process group holds ``n_shards // world_size`` consecutive
shards on its device, does the per-shard work locally, and the sum becomes
one ``all_reduce`` over the group (NCCL on CUDA, gloo on the CPU). One
process with 8 shards reproduces the reference's in-process 8-device mesh;
2 ranks x 2 shards its 2-process x 2-device run.

Layout (``BAMesh``):

- poses R/t, gauge masks, intrinsics: replicated on every rank;
- landmarks xyz/lm_valid: the rank's ``local_shards`` blocks of ``ms`` rows;
- observations: the rank's ``local_shards`` blocks of ``obs_per_shard``
  rows, each observation in its landmark's shard with a shard-LOCAL
  landmark index;
- per iteration: one ``all_reduce`` of (U, g_p, S_off, g_off), K²·36 + K·48
  floats, and one of the candidate's cost (plus one for the initial cost).

``dist_bundle_adjust`` and ``shard_ba_problem_device`` are captured programs
(``utils/graphs.py``), as the reference jits them: on CUDA a direct call
captures once per static arguments and shapes, the all-reduces inside the
graph, and replays; on every rank of a group at the same call. Their
outputs are the caller's. ``collectives`` counts the all-reduces a solve
makes, replays included.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from zenslam_tpu_torch.backend.ba import BAProblem, ba_cost, lm_schur
from zenslam_tpu_torch.utils.device import resolve_device
from zenslam_tpu_torch.utils.graphs import Program


class BAMesh(NamedTuple):
    """The map-shard layout: ``n_shards`` shards over the ranks of ``group``,
    ``local_shards`` consecutive ones on each rank, on ``device`` (the
    counterpart of the reference's 1-D ``Mesh`` with axis "m")."""

    group: object             # torch.distributed ProcessGroup
    n_shards: int
    local_shards: int
    device: torch.device


def make_ba_mesh(n_shards: int | None = None, group=None, device=None) -> BAMesh:
    """A mesh of ``n_shards`` shards (None: one per rank) over ``group``
    (None: the default group) on ``device`` (default CUDA, raising when
    absent). Without a default group, a one-rank group is created over a
    ``HashStore``: NCCL for a CUDA device, gloo for the CPU. A CUDA mesh
    needs an NCCL group (gloo would copy every reduction through the host)."""
    dev = resolve_device(device)
    if group is None:
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    store=dist.HashStore(), rank=0, world_size=1)
        group = dist.group.WORLD
    backend = dist.get_backend(group)
    if (dev.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {dev.type} mesh cannot reduce over a {backend!r} group "
                         "(NCCL for CUDA tensors, gloo for CPU tensors)")
    world = dist.get_world_size(group)
    n = world if n_shards is None else n_shards
    if n < world or n % world:
        raise ValueError(
            f"requested a {n}-shard mesh over {world} ranks: the shard count must be a "
            "multiple of the group's size — a silently different layout would mis-read "
            "shard-local landmark indices")
    return BAMesh(group=group, n_shards=n, local_shards=n // world, device=dev)


def shard_ba_problem(p: BAProblem, n_shards: int, obs_per_shard: int | None = None) -> BAProblem:
    """Host-side re-layout (numpy): pad M to a multiple of n_shards; route
    every observation to its landmark's shard with a shard-LOCAL landmark
    index; pad each shard's observation list to a common length.

    The returned problem's obs arrays have length n_shards * obs_per_shard,
    ordered by shard, and obs_lm holds LOCAL indices — consumed only by
    dist_bundle_adjust (bundle_adjust would misread them). Tensors go to
    ``p``'s device."""
    dev = p.xyz.device

    def host(x):
        return x.cpu().numpy()

    M = p.xyz.shape[0]
    M_pad = ((M + n_shards - 1) // n_shards) * n_shards
    ms = M_pad // n_shards

    xyz = np.zeros((M_pad, 3), np.float32)
    xyz[:M] = host(p.xyz)
    lm_valid = np.zeros(M_pad, bool)
    lm_valid[:M] = host(p.lm_valid)

    obs_kf = host(p.obs_kf)
    obs_lm = host(p.obs_lm)
    obs_uv = host(p.obs_uv)
    obs_cam = host(p.obs_cam)
    obs_ok = host(p.obs_valid)
    owner = obs_lm // ms
    counts = np.bincount(owner[obs_ok], minlength=n_shards)
    if obs_per_shard is None:
        obs_per_shard = int(counts.max()) if counts.size else 1
        obs_per_shard = max(obs_per_shard, 1)

    O_new = n_shards * obs_per_shard
    new_kf = np.zeros(O_new, np.int32)
    new_lm = np.zeros(O_new, np.int32)
    new_uv = np.zeros((O_new, 2), np.float32)
    new_cam = np.zeros(O_new, np.int32)
    new_ok = np.zeros(O_new, bool)
    for d in range(n_shards):
        sel = np.flatnonzero(obs_ok & (owner == d))[:obs_per_shard]
        base = d * obs_per_shard
        n = sel.size
        new_kf[base: base + n] = obs_kf[sel]
        new_lm[base: base + n] = obs_lm[sel] - d * ms  # shard-local index
        new_uv[base: base + n] = obs_uv[sel]
        new_cam[base: base + n] = obs_cam[sel]
        new_ok[base: base + n] = True

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    return p._replace(xyz=dev_t(xyz), lm_valid=dev_t(lm_valid), obs_kf=dev_t(new_kf),
                      obs_lm=dev_t(new_lm), obs_uv=dev_t(new_uv), obs_cam=dev_t(new_cam),
                      obs_valid=dev_t(new_ok))


@functools.partial(Program, static_argnames=("n_shards", "obs_per_shard"), copy_outputs=True)
def shard_ba_problem_device(p: BAProblem, n_shards: int, obs_per_shard: int):
    """Device-side counterpart of ``shard_ba_problem`` (the reference's
    ``shard_ba_problem_jit``), what the live ``ba_solver="dist"`` path uses:
    no host read.

    Routing: stable sort of the observations by owner shard (owner =
    obs_lm // ms, invalid rows -> n_shards so they sort last), rank within
    the shard by a searchsorted segment-start subtraction, scatter into the
    per-shard padded layout with shard-LOCAL landmark indices. Observations
    beyond ``obs_per_shard`` on a hot shard are dropped into a sink row (the
    reference's ``mode="drop"``). Requires M divisible by n_shards. Returns
    (problem, n_dropped), the count a 0-d int32 tensor left on the device."""
    M = p.xyz.shape[0]
    if M % n_shards:
        raise ValueError(f"M={M} not divisible by n_shards={n_shards}")
    ms = M // n_shards
    O = p.obs_kf.shape[0]
    dev = p.obs_kf.device
    owner = torch.where(p.obs_valid, p.obs_lm // ms, n_shards).to(torch.int32)
    so, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(so, torch.arange(n_shards, dtype=torch.int32, device=dev),
                               out_int32=True)
    rank = torch.arange(O, dtype=torch.int32, device=dev) - start[so.clamp(0, n_shards - 1).long()]
    keep = (so < n_shards) & (rank < obs_per_shard)
    O_new = n_shards * obs_per_shard
    # dropped rows land in the sink row O_new, cut off below
    dest = torch.where(keep, so * obs_per_shard + rank, O_new).long()

    def scat(src_sorted):
        out = torch.zeros((O_new + 1,) + src_sorted.shape[1:], dtype=src_sorted.dtype,
                          device=dev)
        return out.index_copy_(0, dest, src_sorted)[:O_new]

    lm_local = torch.where(keep, p.obs_lm[order] - so * ms, 0).to(torch.int32)
    ps = p._replace(obs_kf=scat(p.obs_kf[order]), obs_lm=scat(lm_local),
                    obs_uv=scat(p.obs_uv[order]), obs_cam=scat(p.obs_cam[order]),
                    obs_valid=scat(torch.ones(O, dtype=torch.bool, device=dev)))
    n_dropped = ((so < n_shards).sum() - keep.sum()).to(torch.int32)
    return ps, n_dropped


class _Collectives:
    """The sharded solver's all-reduces (``calls``) and the floats they
    reduce (``floats``), counted where each is issued; a captured
    program's replay adds what its capture issued."""

    calls = 0
    floats = 0


collectives = _Collectives()


def _all_reduce(x, mesh: BAMesh):
    collectives.calls += 1
    collectives.floats += x.numel()
    dist.all_reduce(x, group=mesh.group)
    return x


@functools.partial(Program, static_argnames=("mesh", "iterations", "refine_landmarks"),
                   copy_outputs=True)
def dist_bundle_adjust(p: BAProblem, mesh: BAMesh, iterations: int = 15,
                       huber_delta: float = 1.0, refine_landmarks: bool = True,
                       init_lambda: float = 1e-3):
    """Sharded LM-damped Schur BA. ``p`` holds this rank's
    ``mesh.local_shards`` shards (on one rank: the whole output of
    ``shard_ba_problem`` / ``shard_ba_problem_device`` with n_shards ==
    mesh.n_shards; across ranks: ``multihost.distribute_ba_problem``).
    Returns the same dict as the reference's (R, t, the rank's xyz block,
    cost_before, cost_after, n_accepted); every rank solves the identical
    all-reduced system, so R and t are replicated.

    The LM loop is ``backend/ba.py``'s ``lm_schur``, unrolled over a
    device-resident carry with the accept test a ``torch.where`` on the
    all-reduced costs: no host read. Its solve, ``cholesky_solve_or_zero``,
    symmetrises S + 1e-8 I and zeroes the step where the factorisation
    fails or is not finite — the reference's cholesky of S + 1e-8 I with
    non-finite steps zeroed gives the same answer on an SPD system and a
    zero step otherwise
    (tests/test_torch_backend.py::test_cholesky_failure_gives_zero_step).

    A captured program keyed, besides ``mesh``, ``iterations`` and
    ``refine_landmarks`` (the reference's static arguments), on
    ``huber_delta`` and ``init_lambda`` by value: callers pass one value of
    each (1.0 and 1e-3), so this costs no second capture in practice."""
    L = mesh.local_shards
    M_loc, O_loc = p.xyz.shape[0], p.obs_kf.shape[0]
    if M_loc % L or O_loc % L:
        raise ValueError(f"{M_loc} landmarks / {O_loc} observations do not split into "
                         f"{L} local shards")
    ms, ops = M_loc // L, O_loc // L
    # shard-local landmark indices -> indices into the rank's block
    shard = torch.arange(O_loc, dtype=torch.int32, device=p.R.device) // ops
    lp = p._replace(obs_lm=p.obs_lm + shard * ms)

    def cost_of(R, t, xyz):
        return _all_reduce(ba_cost(lp, R, t, xyz, huber_delta)[0].reshape(1), mesh)[0]

    def all_sum(*parts):
        # the one collective of an LM step: the reduced camera system's
        # parts, K²·36 + K·48 floats, in one buffer
        buf = _all_reduce(torch.cat([x.reshape(-1) for x in parts]), mesh)
        return [y.reshape(x.shape) for x, y in zip(parts, buf.split([x.numel() for x in parts]))]

    cost0 = cost_of(p.R, p.t, p.xyz)
    R, t, xyz, cost, n_acc = lm_schur(lp, cost0, cost_of, iterations, huber_delta,
                                      refine_landmarks, init_lambda, all_sum)
    return {"R": R, "t": t, "xyz": xyz, "cost_before": cost0, "cost_after": cost,
            "n_accepted": n_acc}
