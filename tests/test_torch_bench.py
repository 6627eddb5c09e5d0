"""The port's benchmark tools on the CPU: ``zenslam_tpu_torch.eval.bench``
against the reference's ``bench.py`` and ``zenslam_tpu_torch.eval.scaling``
against its ``scaling_bench.py``.

- ``run_fps`` at 320x256 over 8 frames (2 untimed, seed 11) beside the
  reference's ``bench.run_fps`` on the same arguments: both free-running on
  the f32 path with their own RANSAC draws, so the bound is the slice
  test's free-running one (port ATE < 0.02 m and within 2 mm of the
  reference's, tests/test_torch_slice.py) over the frames the reference's
  ``slam_step`` returned inside ``bench.run_fps``; the last camera centre
  within 2 cm of the reference's (9.1 mm apart on a CPU run, each package
  8-10 mm from the truth); ``n_tracked`` and ``map_size`` within 2% (equal on
  that run);
- ``run_full_system_fps`` at 320x256 over 12 frames (4 untimed): its
  throwaway system is a plain ``process_frame`` / ``flush_pipeline`` loop
  over the same frames (each call recorded), and the timed system gives
  that loop's keyframe back-end runs on the timed frames, a median of its
  own ``backend_ms``, and ends in the loop's state, telemetry and keyframes
  bit for bit (a shared state would have seen the frames twice);
- ``make_problem(K=4, M=256)`` equal to the reference's array for array,
  and ``dist_bundle_adjust`` at 1 and 2 local shards on a one-rank gloo mesh
  within 1e-5 of the dense ``bundle_adjust`` (R and t);
- both modules' entry points raise without a card unless asked for the CPU.

The reference runs in one subprocess of its own, started with the module
and under way while the port runs: ``bench.py`` imports JAX and opts into
a compile cache at import (here off: ``ZENSLAM_CACHE_DIR`` empty), and
``scaling_bench.py`` forces 8 virtual XLA devices.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.backend.ba import bundle_adjust
from zenslam_tpu_torch.eval import bench, scaling
from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
from zenslam_tpu_torch.parallel import dist_bundle_adjust, make_ba_mesh, shard_ba_problem
from zenslam_tpu_torch.pipeline import system as psystem

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
W, H, T, WARM = 320, 256, 8, 2
SYS_T, SYS_WARM = 12, 4
PROBLEM = dict(K=4, M=256)

REFERENCE = f"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import bench
import zenslam_tpu.pipeline.step as step

tels, inner = [], step.slam_step

def spy(*args, **kwargs):
    out = inner(*args, **kwargs)
    tels.append(out[1])
    return out

step.slam_step = spy
fps, tel = bench.run_fps({W}, {H}, {T}, n_warmup={WARM}, seed=11)
import scaling_bench
p = scaling_bench.make_problem(**{PROBLEM!r})
np.savez(sys.argv[1], fps=fps, R=np.stack([np.asarray(t.R_cw) for t in tels]),
         t=np.stack([np.asarray(t.t_cw) for t in tels]), n_tracked=int(tel.n_tracked),
         map_size=int(tel.map_size),
         **{{"p_" + k: np.asarray(v) for k, v in p._asdict().items()}})
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's run_fps and make_problem in a process of its own,
    started before the module's first test (the full-system one, which runs
    meanwhile); yields a function that waits for it and returns its arrays."""
    d = tmp_path_factory.mktemp("bench")
    out = d / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", ZENSLAM_CACHE_DIR="")
    with open(d / "reference.log", "w") as log:
        p = subprocess.Popen([sys.executable, "-c", REFERENCE, str(out)], cwd=REPO, env=env,
                             stdout=log, stderr=subprocess.STDOUT)

    def wait():
        assert p.wait(timeout=600) == 0, (d / "reference.log").read_text()[-4000:]
        return dict(np.load(out))

    try:
        yield wait
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def _recorded(monkeypatch):
    """Record every process_frame and flush_pipeline output by system."""
    calls = {}
    inner_frame, inner_flush = psystem.process_frame, psystem.flush_pipeline

    def process_frame(sysm, *args, **kwargs):
        out = inner_frame(sysm, *args, **kwargs)
        calls.setdefault(id(sysm), (sysm, []))[1].append(out)
        return out

    def flush_pipeline(sysm):
        out = inner_flush(sysm)
        calls.setdefault(id(sysm), (sysm, []))[1].extend(out)
        return out

    monkeypatch.setattr(psystem, "process_frame", process_frame)
    monkeypatch.setattr(psystem, "flush_pipeline", flush_pipeline)
    return calls


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else _tree_equal(x, y)
               if isinstance(x, tuple) else x == y for x, y in zip(a, b))


def test_full_system_matches_plain_loop(monkeypatch):
    calls = _recorded(monkeypatch)
    rec = {}
    fps, med, n_kf = bench.run_full_system_fps(W, H, SYS_T, n_warmup=SYS_WARM, seed=11,
                                               device="cpu", record=rec)
    (loop, loop_rows), (timed, timed_rows) = calls.values()
    assert timed is rec["system"] and loop is not timed
    # the throwaway pass: every frame through process_frame, then the flush
    assert len(loop_rows) == len(timed_rows) == SYS_T + timed.bcfg.telemetry_lag

    def runs(rows):
        return [(i["frame"], i["backend_ms"]) for _, i in rows[SYS_WARM:] if i["backend_ms"] > 0]

    assert [f for f, _ in runs(timed_rows)] == [f for f, _ in runs(loop_rows)]
    assert n_kf == len(runs(loop_rows)) >= 1
    assert med == float(np.median([ms for _, ms in runs(timed_rows)]))
    assert np.isfinite(fps) and fps > 0
    tels = [tel for tel, _ in loop_rows if tel is not None]
    assert len(rec["tels"]) == len(tels) == SYS_T
    for a, b in zip(rec["tels"], tels):
        assert np.array_equal(a.R_cw, b.R_cw) and np.array_equal(a.t_cw, b.t_cw)
        assert bool(a.is_keyframe) == bool(b.is_keyframe)
    assert _tree_equal(timed.state, loop.state)
    assert _tree_equal(timed.kf_db, loop.kf_db)
    assert (timed.n_keyframes, timed.n_ba_runs) == (loop.n_keyframes, loop.n_ba_runs)


def _centres(R, t):
    return camera_positions(np.asarray(R), np.asarray(t))


def test_run_fps_matches_reference(reference):
    rec = {}
    fps, tel = bench.run_fps(W, H, T, n_warmup=WARM, seed=11, device="cpu", record=rec)
    assert np.isfinite(fps) and fps > 0
    assert len(rec["tels"]) == T and rec["launches"] == {"lk_fb": 0, "orb": 0}
    R = torch.stack([x.R_cw for x in rec["tels"]]).numpy()
    t = torch.stack([x.t_cw for x in rec["tels"]]).numpy()
    gt = camera_positions(rec["seq"].R_lw, rec["seq"].t_lw)
    ref = reference()
    assert ref["R"].shape == (T, 3, 3)
    ate_port = ate_rmse(_centres(R, t), gt)
    ate_ref = ate_rmse(_centres(ref["R"], ref["t"]), gt)
    assert ate_port < 0.02
    assert abs(ate_port - ate_ref) < 2e-3
    assert np.linalg.norm(_centres(R, t)[-1] - _centres(ref["R"], ref["t"])[-1]) < 0.02
    for name in ("n_tracked", "map_size"):
        assert abs(int(getattr(tel, name)) - int(ref[name])) <= 0.02 * int(ref[name]), name


def test_scaling_problem_matches_reference(reference):
    p = scaling.make_problem(**PROBLEM, device="cpu")
    ref = reference()
    assert p.obs_kf.shape == (PROBLEM["M"] * 8,)
    for k, v in p._asdict().items():
        np.testing.assert_array_equal(v.numpy(), ref["p_" + k], err_msg=k)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_dist_solve_matches_dense(n_shards):
    p = scaling.make_problem(**PROBLEM, device="cpu")
    dense = bundle_adjust(p, iterations=scaling.ITERATIONS)
    mesh = make_ba_mesh(n_shards, device="cpu")
    ms, r = scaling.time_solve(shard_ba_problem(p, n_shards), mesh, repeats=1)
    assert np.isfinite(ms) and ms > 0
    assert float(r["cost_after"]) < float(r["cost_before"])
    torch.testing.assert_close(r["R"], dense["R"], atol=1e-5, rtol=0)
    torch.testing.assert_close(r["t"], dense["t"], atol=1e-5, rtol=0)
    again = dist_bundle_adjust(shard_ba_problem(p, n_shards), mesh,
                               iterations=scaling.ITERATIONS)
    assert torch.equal(again["t"], r["t"])


@pytest.mark.parametrize("main", [bench.main, scaling.main], ids=["bench", "scaling"])
def test_entry_points_need_a_card_or_cpu(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
