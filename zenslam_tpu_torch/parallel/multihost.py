"""Multi-process execution of the sharded BA — counterpart of
``zenslam_tpu/parallel/multihost.py``.

``parallel/dist_ba.py`` does the math over a ``BAMesh``; this module adds
the process layer:

- ``init_multihost``: the ``torch.distributed`` bootstrap of one rank (NCCL
  on CUDA, gloo on the CPU) and the number of shards the rank holds (the
  counterpart of the reference's ``local_device_count``);
- ``global_ba_mesh``: the mesh over every rank's shards;
- ``distribute_ba_problem``: the rank's contiguous block of a host-
  replicated, shard-ordered problem (from ``shard_ba_problem``) on its
  device, poses and intrinsics replicated;
- ``gather_landmarks``: the landmark blocks of every rank, gathered back to
  every rank after the solve.

A rank per GPU is the deployment; N gloo processes on the CPU are the test
harness (NCCL refuses two ranks on one GPU). ``dist_bundle_adjust`` over
``global_ba_mesh()`` is a captured program on each rank, as on a one-rank
group: the first call warms up (creating the communicator) and captures
on every rank at once, since every rank calls with the same key; later
calls replay, the all-reduces inside each rank's graph. On the CPU each
rank runs the programs' buffer logic.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from zenslam_tpu_torch.backend.ba import BAProblem
from zenslam_tpu_torch.parallel.dist_ba import BAMesh, make_ba_mesh
from zenslam_tpu_torch.utils.device import resolve_device

# what init_multihost set up for this process: torch.distributed's default
# group is process state too, and global_ba_mesh() reads both
_RANK_SETUP: dict = {}


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None,
                   local_shards: int | None = None,
                   device=None) -> None:
    """Join an N-process group: ``coordinator_address`` "host:port" of rank
    0's store (``tcp://``; None: the ``MASTER_ADDR``/``MASTER_PORT``/
    ``RANK``/``WORLD_SIZE`` environment), on ``device`` (default CUDA,
    raising when absent: one GPU per rank, ``cuda:<process_id mod device
    count>``), over ``backend`` (default NCCL for CUDA, gloo for the CPU).
    ``local_shards`` (default 1) is the number of map shards this rank
    holds. A failed initialisation raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (process_id or 0) % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    _RANK_SETUP.update(local_shards=local_shards or 1, device=dev)


def global_ba_mesh() -> BAMesh:
    """The map-shard mesh over every rank's shards (world size x the
    ``local_shards`` given to ``init_multihost``)."""
    if not _RANK_SETUP:
        raise RuntimeError("global_ba_mesh() needs init_multihost() first")
    return make_ba_mesh(dist.get_world_size() * _RANK_SETUP["local_shards"],
                        device=_RANK_SETUP["device"])


def distribute_ba_problem(p: BAProblem, mesh: BAMesh) -> BAProblem:
    """This rank's part of a shard-ordered problem (see ``shard_ba_problem``,
    called with n_shards == mesh.n_shards), on the mesh's device: the
    rank's ``local_shards`` consecutive blocks of landmarks and
    observations, every other field replicated."""
    rank = dist.get_rank(mesh.group)
    sharded = {"xyz", "lm_valid", "obs_kf", "obs_lm", "obs_uv", "obs_cam", "obs_valid"}
    out = {}
    for name, val in p._asdict().items():
        if name in sharded:
            n = val.shape[0] // mesh.n_shards * mesh.local_shards
            val = val[rank * n:(rank + 1) * n]
        out[name] = val.to(mesh.device)
    return BAProblem(**out)


def gather_landmarks(xyz, mesh: BAMesh) -> np.ndarray:
    """All-gather every rank's landmark block (the ``xyz`` that
    ``dist_bundle_adjust`` returned on each rank) into one host array, in
    shard order, on every rank (poses are replicated already)."""
    parts = [torch.empty_like(xyz) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, xyz.contiguous(), group=mesh.group)
    return torch.cat(parts).cpu().numpy()
