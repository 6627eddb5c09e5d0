"""Sharded-BA iteration time against the shard count — counterpart of
``scaling_bench.py``.

    python3 -m zenslam_tpu_torch.eval.scaling [--device cuda]

Times ``dist_bundle_adjust`` per LM iteration at 1, 2, 4 and 8 shards on a
fixed problem: K=32 keyframes, M=16384 landmarks, O=131072 observations (8
a landmark), the reference's draws (``make_problem``). The solver is timed
as a caller gets it, a captured program (``utils/graphs.py``; one CUDA
graph per shard count, as the reference times its jitted solver): each
shard count runs one untimed solve of 6 iterations, which captures it,
then 3 timed ones (replays), each ended by a synchronise; prints ms per
iteration, the cost before and after, and the reference's markdown table
with the speedup over one shard. ``graphs.eager()`` around ``time_solve``
times the eager form.

What the numbers mean on one card: ``make_ba_mesh(n)`` puts all n shards on
this process's one device (a one-rank group, NCCL on CUDA), so the table
measures the decomposition — per-shard blocks and landmark elimination, and
the one all-reduce of the reduced camera system an LM step — on a single
device. That is what the reference's virtual CPU mesh measures; it is not a
multi-GPU scaling figure. The run is on CUDA unless ``--device`` names
another device; with no card it raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

ITERATIONS = 6
REPEATS = 3
SHARDS = (1, 2, 4, 8)


def make_problem(K=32, M=16384, obs_per_lm=8, seed=0, device=None):
    """The reference's problem (``scaling_bench.py:make_problem``): the same
    numpy draws in the same order, so one seed gives the same arrays. Every
    landmark seen by ``obs_per_lm`` random keyframes with 0.3 px noise;
    translations perturbed by 0.01, landmarks by 0.02; keyframes 0 and 1
    fixed. On ``device`` (default CUDA, raising when absent)."""
    from zenslam_tpu_torch.backend.ba import make_ba_problem
    from zenslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx = cy = 256.0
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M),
                  rng.uniform(4, 12, M)], -1).astype(np.float32)
    t_gt = np.stack([np.array([0.1 * k, 0.02 * (k % 3), 0], np.float32)
                     for k in range(K)])
    obs_kf = rng.integers(0, K, (M, obs_per_lm)).astype(np.int32)
    O = M * obs_per_lm
    kf = obs_kf.reshape(-1)
    lm = np.repeat(np.arange(M, dtype=np.int32), obs_per_lm)
    xc = X[lm] + t_gt[kf]
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    t = t_gt + rng.normal(0, 0.01, t_gt.shape).astype(np.float32)
    xyz = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    p = make_ba_problem(K, M, O, fx, fy, cx, cy, device=dev)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return p._replace(t=up(t), kf_valid=up(np.ones(K, bool)), kf_fixed=up(fixed), xyz=up(xyz),
                      lm_valid=up(np.ones(M, bool)), obs_kf=up(kf), obs_lm=up(lm),
                      obs_uv=up(uv), obs_valid=up(np.ones(O, bool)))


def time_solve(ps, mesh, iterations: int = ITERATIONS, repeats: int = REPEATS):
    """One untimed ``dist_bundle_adjust`` of the sharded problem ``ps`` on
    ``mesh`` (on CUDA it captures the solver), then ``repeats`` timed ones
    (replays; eager calls under ``graphs.eager()``), each ended by a
    synchronise. Returns (ms per LM iteration, the last solve's result)."""
    from zenslam_tpu_torch.parallel import dist_bundle_adjust

    def solve():
        r = dist_bundle_adjust(ps, mesh, iterations=iterations)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return r

    res = solve()
    t0 = time.perf_counter()
    for _ in range(repeats):
        res = solve()
    return (time.perf_counter() - t0) / repeats / iterations * 1e3, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("zenslam_tpu_torch.eval.scaling",
                                 description="sharded-BA ms per LM iteration against the "
                                             "shard count (scaling_bench.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising when absent)")
    args = ap.parse_args(argv)

    import torch.distributed as tdist

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.parallel import make_ba_mesh, shard_ba_problem
    from zenslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    owned = not tdist.is_initialized()
    p = make_problem(device=dev)
    print(f"problem: K=32 M={p.xyz.shape[0]} O={p.obs_kf.shape[0]}; "
          f"{'card ' + card_line() if dev.type == 'cuda' else 'device ' + str(dev)}")
    rows = []
    try:
        for n in SHARDS:
            mesh = make_ba_mesh(n, device=dev)
            ms, res = time_solve(shard_ba_problem(p, n), mesh)
            rows.append((n, ms, float(res["cost_before"]), float(res["cost_after"])))
            print(f"shards={n}: {ms:8.2f} ms/iteration  cost "
                  f"{rows[-1][2]:.1f} -> {rows[-1][3]:.4f}")
    finally:
        if owned and tdist.is_initialized():   # the one-rank group make_ba_mesh made
            tdist.destroy_process_group()
    print(f"\n| shards (one {dev.type} device, captured solver) | ms/iteration | speedup |")
    print("|---|---|---|")
    for n, ms, _, _ in rows:
        print(f"| {n} | {ms:.2f} | {rows[0][1] / ms:.2f}x |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
