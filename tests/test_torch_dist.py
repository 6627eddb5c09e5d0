"""The port's sharded BA (zenslam_tpu_torch.parallel.dist_ba) against the JAX
reference on the CPU (the reference on conftest's 8 virtual devices, the
port on a one-rank gloo group holding every shard):

- the host router and the device router give the reference's arrays
  exactly (8 shards; with room and starved to 2 observations a shard, the
  dropped count equal);
- ``dist_bundle_adjust`` at 8 shards against the reference's on
  ``make_ba_mesh(8)``, on ``tests/test_backend.py:synth_ba_problem`` cases
  (full BA with two fixed keyframes, so that the monocular scale is held;
  motion-only; the full case routed on the device): R and t within 1e-4,
  xyz within 1e-3 relative, costs within 1e-4 relative, and motion-only
  xyz bit-identical to its input;
- 1, 2 and 8 shards within 1e-4 of each other and within 5e-3 of the
  port's dense ``bundle_adjust`` (the reference test's bar);
- zero-weight rows (the router's padding) add nothing to BA's blocks;
- ``make_ba_mesh`` refuses a CUDA mesh over the gloo group;
- the port alone, dense against dist at 8 shards through ``run_system``
  on a short strafe, with the checks of tests/test_dist_ba.py's live test:
  same keyframes, rmse_after <= 1.05 rmse_before, frame and keyframe t
  within 2e-3.

(tests/test_torch_multihost.py runs the multi-rank case.)
"""

import jax
import numpy as np
import pytest
import torch

from zenslam_tpu.parallel import dist_ba as jdist
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.backend import ba
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.parallel import dist_ba
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.state import SlamConfig
from test_backend import synth_ba_problem

torch.set_num_threads(2)

CASES = {
    "full": dict(n_kf=4, n_lm=120, M_cap=128, K_cap=8, pose_noise=0.04, pix_noise=0.3,
                 n_fixed=2),
    "motion_only": dict(n_kf=3, n_lm=60, M_cap=64, K_cap=8, lm_noise=0.0, pix_noise=0.3),
}


def _port(jp):
    return ba.BAProblem(**{k: convert.tensor_from_numpy(np.asarray(v), "cpu")
                           for k, v in jp._asdict().items()})


def _problem(name, seed=42):
    jp, *_ = synth_ba_problem(np.random.default_rng(seed), **CASES[name])
    return jp, _port(jp)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return jdist.make_ba_mesh(8), dist_ba.make_ba_mesh(8, device="cpu")


def _assert_same(ps, js):
    for name in ps._fields:
        a, b = getattr(ps, name).numpy(), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_router_matches_reference(name):
    jp, pp = _problem(name)
    _assert_same(dist_ba.shard_ba_problem(pp, 8), jdist.shard_ba_problem(jp, 8))
    _assert_same(dist_ba.shard_ba_problem(pp, 8, obs_per_shard=3),
                 jdist.shard_ba_problem(jp, 8, obs_per_shard=3))


@pytest.mark.parametrize("obs_per_shard", [None, 2], ids=["room", "starved"])
def test_device_router_matches_reference(obs_per_shard):
    jp, pp = _problem("full")
    ops = obs_per_shard or jp.obs_kf.shape[0]
    ps, n_drop = dist_ba.shard_ba_problem_device(pp, 8, ops)
    js, j_drop = jdist.shard_ba_problem_jit(jp, 8, ops)
    _assert_same(ps, js)
    assert n_drop.dtype == torch.int32 and n_drop.shape == ()
    assert int(n_drop) == int(j_drop) == (0 if obs_per_shard is None
                                          else int(jp.obs_valid.sum()) - 16)
    with pytest.raises(ValueError, match="not divisible"):
        dist_ba.shard_ba_problem_device(pp._replace(xyz=pp.xyz[:-1]), 8, ops)


@pytest.mark.parametrize("case", ["full", "motion_only", "device_router"])
def test_dist_ba_matches_reference(case, mesh8):
    jmesh, pmesh = mesh8
    jp, pp = _problem("motion_only" if case == "motion_only" else "full")
    refine = case != "motion_only"
    if case == "device_router":
        O = jp.obs_kf.shape[0]
        js, _ = jdist.shard_ba_problem_jit(jp, 8, O)
        ps, _ = dist_ba.shard_ba_problem_device(pp, 8, O)
    else:
        js, ps = jdist.shard_ba_problem(jp, 8), dist_ba.shard_ba_problem(pp, 8)
    jr = jax.tree.map(np.asarray, jdist.dist_bundle_adjust(js, jmesh, iterations=12,
                                                           refine_landmarks=refine))
    pr = dist_ba.dist_bundle_adjust(ps, pmesh, iterations=12, refine_landmarks=refine)
    np.testing.assert_allclose(pr["R"].numpy(), jr["R"], atol=1e-4)
    np.testing.assert_allclose(pr["t"].numpy(), jr["t"], atol=1e-4)
    dx = np.linalg.norm(pr["xyz"].numpy() - jr["xyz"], axis=-1)
    assert (dx <= 1e-3 * np.maximum(np.linalg.norm(jr["xyz"], axis=-1), 1.0)).all()
    for k in ("cost_before", "cost_after"):
        np.testing.assert_allclose(float(pr[k]), float(jr[k]), rtol=1e-4)
    assert float(pr["cost_after"]) < float(pr["cost_before"]) / 4
    if not refine:
        assert torch.equal(pr["xyz"], ps.xyz)


@pytest.mark.parametrize("refine", [True, False], ids=["full", "motion_only"])
def test_shard_counts_agree_with_dense(refine):
    _, pp = _problem("full" if refine else "motion_only", seed=7)
    dense = ba.bundle_adjust(pp, iterations=12, refine_landmarks=refine)
    out = {}
    for n in (1, 2, 8):
        mesh = dist_ba.make_ba_mesh(n, device="cpu")
        assert (mesh.n_shards, mesh.local_shards) == (n, n)
        out[n] = dist_ba.dist_bundle_adjust(dist_ba.shard_ba_problem(pp, n), mesh,
                                            iterations=12, refine_landmarks=refine)
    for n in (1, 2):
        np.testing.assert_allclose(out[n]["t"].numpy(), out[8]["t"].numpy(), atol=1e-4)
        np.testing.assert_allclose(out[n]["R"].numpy(), out[8]["R"].numpy(), atol=1e-4)
    np.testing.assert_allclose(out[8]["t"].numpy(), dense["t"].numpy(), atol=5e-3)
    M = pp.xyz.shape[0]
    np.testing.assert_allclose(out[8]["xyz"].numpy()[:M], dense["xyz"].numpy(), atol=5e-3)


def test_padding_rows_add_nothing_to_the_blocks():
    """Zero-weight rows, such as the router's padding (keyframe 0, landmark
    0), go to sink rows cut off after the sums: the normal-equation blocks
    equal those of the problem without them, bit for bit."""
    _, p = _problem("full")
    pad = 3 * p.obs_kf.shape[0]
    uv = np.random.default_rng(3).uniform(0, 600, (pad, 2)).astype(np.float32)

    def lead(x, fill):
        return torch.cat([fill, x])

    padded = p._replace(
        obs_kf=lead(p.obs_kf, torch.zeros(pad, dtype=torch.int32)),
        obs_lm=lead(p.obs_lm, torch.zeros(pad, dtype=torch.int32)),
        obs_uv=lead(p.obs_uv, torch.from_numpy(uv)),
        obs_cam=lead(p.obs_cam, torch.zeros(pad, dtype=torch.int32)),
        obs_valid=lead(p.obs_valid, torch.zeros(pad, dtype=torch.bool)))
    for x, y in zip(ba._build_blocks(p, p.R, p.t, p.xyz, 1.0),
                    ba._build_blocks(padded, p.R, p.t, p.xyz, 1.0)):
        assert torch.equal(x, y)


def test_mesh_refuses_gloo_for_cuda_tensors():
    mesh = dist_ba.make_ba_mesh(device="cpu")
    assert mesh.n_shards == mesh.local_shards == 1
    assert torch.distributed.get_backend(mesh.group) == "gloo"
    with pytest.raises(ValueError, match="NCCL for CUDA"):
        dist_ba.make_ba_mesh(8, device="cuda")


def test_live_dist_matches_dense():
    """tests/test_dist_ba.py::TestLiveDistBackend's run (its 512x384 strafe)
    for the port alone: the two solvers' windows part by ~1e-6 (the order
    of the f32 sums), and so do the trajectories. (At 320x240 the windows
    part by ~1e-5 and the front end's pose of one later frame then parts by
    1.4 cm, a tracking decision, not the solve.)"""
    cfg = SlamConfig(max_keypoints=256, max_landmarks=2048, pnp_iters=128, rigid_iters=128,
                     kf_min_frames=2, kf_min_translation=0.04)
    seq = make_sequence(np.random.default_rng(11), n_frames=10, motion="strafe", speed=0.6,
                        device="cpu")
    results = {}
    for solver in ("dense", "dist"):
        s = psystem.create_system(
            cfg, psystem.BackendConfig(ba_every_kf=True, enable_loop_closure=False,
                                       ba_solver=solver, dist_devices=8),
            seq.rig, seq.left[0].shape, device="cpu")
        tel, infos = psystem.run_system(s, seq.left, seq.right)
        assert s.n_ba_runs >= 1
        runs = [i["ba"].numpy() for i in infos if i["ba"] is not None]
        assert all(r[1] <= r[0] * 1.05 for r in runs)
        results[solver] = (tel.t_cw, s.kf_db.t.numpy(), s.kf_db.valid.numpy())
    assert psystem._live_ba_mesh(8, torch.device("cpu")).n_shards == 8
    (t_dense, kf_dense, v), (t_dist, kf_dist, v2) = results["dense"], results["dist"]
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_allclose(t_dist, t_dense, atol=2e-3)
    np.testing.assert_allclose(kf_dist[v], kf_dense[v], atol=2e-3)
