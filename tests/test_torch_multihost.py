"""The port's multi-process sharded BA on the CPU: 2 processes x 2 shards,
``torch.distributed`` over gloo on 127.0.0.1 — the port's counterpart of
tests/test_multihost.py (2 processes x 2 virtual devices).

Each rank joins with ``init_multihost``, takes its block of the
shard-ordered problem (``distribute_ba_problem``), solves with the
reduced camera system all-reduced across the processes, and gathers the
landmarks back (``gather_landmarks``). ``dist_bundle_adjust`` is a captured
program (``utils/graphs.py``): on the CPU each rank runs its buffer logic,
collectives included. Checked: both ranks converge; ``t``
equal across ranks to 1e-6 and the gathered xyz identical; ``make_ba_mesh``
refuses 3 shards over 2 ranks; on each rank a second call with other
poses goes through the same capture, and both calls are bit-identical to
their ``graphs.eager()`` runs; and the 2-rank result, a one-process
4-shard port run and the reference's ``dist_bundle_adjust`` on
``make_ba_mesh(4)`` agree within 1e-4, on the problem of
tests/multihost_worker.py:make_problem (rebuilt here for both packages).

This file is also the worker: ``python tests/test_torch_multihost.py
<rank> <world> <port>``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def problem_arrays(n_shards: int) -> dict:
    """tests/multihost_worker.py:make_problem's arrays (K = 4 keyframes on a
    line, 4 landmarks a shard seen by every keyframe, poses and landmarks
    offset)."""
    rng = np.random.default_rng(0)
    K, M = 4, n_shards * 4
    fx = fy = 300.0
    cx = cy = 128.0
    X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-2, 2, M),
                  rng.uniform(4, 8, M)], -1).astype(np.float32)
    obs_kf, obs_lm, obs_uv, t_gt = [], [], [], []
    for k in range(K):
        t = np.array([0.2 * k, 0, 0], np.float32)
        t_gt.append(t)
        xc = X + t
        for m in range(M):
            obs_kf.append(k)
            obs_lm.append(m)
            obs_uv.append([fx * xc[m, 0] / xc[m, 2] + cx, fy * xc[m, 1] / xc[m, 2] + cy])
    kf_fixed = np.zeros(K, bool)
    kf_fixed[:2] = True
    return dict(K=K, M=M, O=len(obs_kf), fx=fx, fy=fy, cx=cx, cy=cy,
                t=np.stack(t_gt) + np.float32(0.01), kf_fixed=kf_fixed,
                xyz=X + np.float32(0.02), obs_kf=np.asarray(obs_kf, np.int32),
                obs_lm=np.asarray(obs_lm, np.int32), obs_uv=np.asarray(obs_uv, np.float32))


def port_problem(n_shards: int):
    import torch

    from zenslam_tpu_torch.backend.ba import make_ba_problem

    a = problem_arrays(n_shards)
    p = make_ba_problem(a["K"], a["M"], a["O"], a["fx"], a["fy"], a["cx"], a["cy"],
                        device="cpu")
    return p._replace(t=torch.from_numpy(a["t"]), kf_valid=torch.ones(a["K"], dtype=torch.bool),
                      kf_fixed=torch.from_numpy(a["kf_fixed"]), xyz=torch.from_numpy(a["xyz"]),
                      lm_valid=torch.ones(a["M"], dtype=torch.bool),
                      obs_kf=torch.from_numpy(a["obs_kf"]), obs_lm=torch.from_numpy(a["obs_lm"]),
                      obs_uv=torch.from_numpy(a["obs_uv"]),
                      obs_valid=torch.ones(a["O"], dtype=torch.bool))


def worker(rank: int, world: int, port: str) -> None:
    import torch

    from zenslam_tpu_torch.parallel import (
        dist_bundle_adjust, distribute_ba_problem, gather_landmarks, global_ba_mesh,
        init_multihost, make_ba_mesh, shard_ba_problem)
    from zenslam_tpu_torch.utils import graphs

    torch.set_num_threads(1)
    init_multihost(f"127.0.0.1:{port}", world, rank, local_shards=2, device="cpu")
    mesh = global_ba_mesh()
    assert (mesh.n_shards, mesh.local_shards) == (2 * world, 2), mesh
    try:
        make_ba_mesh(3, device="cpu")
    except ValueError:
        print(f"REFUSED_3 {rank}", flush=True)
    p = shard_ba_problem(port_problem(mesh.n_shards), mesh.n_shards)
    local = distribute_ba_problem(p, mesh)
    assert local.xyz.shape[0] == p.xyz.shape[0] // world
    res = dist_bundle_adjust(local, mesh, iterations=5)
    moved = local._replace(t=local.t + 0.01)
    again = dist_bundle_adjust(moved, mesh, iterations=5)
    held = graphs.graphs_held()
    with graphs.eager():
        same = [all(torch.equal(x[k], y[k]) for k in x)
                for x, y in ((res, dist_bundle_adjust(local, mesh, iterations=5)),
                             (again, dist_bundle_adjust(moved, mesh, iterations=5)))]
    print(f"CAPTURED {rank} held {held} calls {graphs.calls(dist_bundle_adjust)} "
          f"eager-identical {same}", flush=True)
    xyz = gather_landmarks(res["xyz"], mesh)
    cb, ca = float(res["cost_before"]), float(res["cost_after"])
    print("RESULT " + json.dumps({"rank": rank, "cost_before": cb, "cost_after": ca,
                                  "t": res["t"].tolist(), "xyz": xyz.tolist()}), flush=True)
    assert ca < cb * 1e-3, (cb, ca)
    assert np.isfinite(xyz).all()
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK {rank}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _results(runs):
    return [json.loads(next(line[7:] for line in out.splitlines() if line.startswith("RESULT ")))
            for _, out in runs]


def test_both_ranks_converge(runs):
    for i, (rc, out) in enumerate(runs):
        assert rc == 0, out[-3000:]
        assert f"MULTIHOST_OK {i}" in out and f"REFUSED_3 {i}" in out, out[-3000:]


def test_captured_solver_on_each_rank_matches_eager(runs):
    for i, (_, out) in enumerate(runs):
        assert f"CAPTURED {i} held 1 calls 2 eager-identical [True, True]" in out, out[-3000:]


def test_ranks_agree_and_match_single_process_and_reference(runs):
    import jax
    import jax.numpy as jnp
    import torch

    from zenslam_tpu.backend.ba import make_ba_problem as jmake
    from zenslam_tpu.parallel import dist_bundle_adjust as jdist_ba
    from zenslam_tpu.parallel import make_ba_mesh as jmesh
    from zenslam_tpu.parallel import shard_ba_problem as jshard
    from zenslam_tpu_torch.parallel import dist_bundle_adjust, make_ba_mesh, shard_ba_problem

    r0, r1 = _results(runs)
    t0, t1 = np.asarray(r0["t"]), np.asarray(r1["t"])
    np.testing.assert_allclose(t0, t1, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(r0["xyz"]), np.asarray(r1["xyz"]))

    torch.set_num_threads(2)
    one = dist_bundle_adjust(shard_ba_problem(port_problem(4), 4),
                             make_ba_mesh(4, device="cpu"), iterations=5)
    a = problem_arrays(4)
    jp = jmake(a["K"], a["M"], a["O"], a["fx"], a["fy"], a["cx"], a["cy"])._replace(
        t=jnp.asarray(a["t"]), kf_valid=jnp.ones(a["K"], bool),
        kf_fixed=jnp.asarray(a["kf_fixed"]), xyz=jnp.asarray(a["xyz"]),
        lm_valid=jnp.ones(a["M"], bool), obs_kf=jnp.asarray(a["obs_kf"]),
        obs_lm=jnp.asarray(a["obs_lm"]), obs_uv=jnp.asarray(a["obs_uv"]),
        obs_valid=jnp.ones(a["O"], bool))
    ref = jax.tree.map(np.asarray, jdist_ba(jshard(jp, 4), jmesh(4), iterations=5))
    np.testing.assert_allclose(one["t"].numpy(), ref["t"], atol=1e-4)
    np.testing.assert_allclose(t0, ref["t"], atol=1e-4)
    np.testing.assert_allclose(t0, one["t"].numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(r0["xyz"]), one["xyz"].numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["cost_before"], float(ref["cost_before"]), rtol=1e-4)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
