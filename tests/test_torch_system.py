"""The port's full keyframe system (zenslam_tpu_torch.pipeline.system) against
the JAX reference on the CPU, plus its own guards.

One reference run of ``run_system`` on the 14-frame strafe sequence of
``tests/test_system.py`` (BA on, loop closure on; a small vocabulary that is
retrained at the 4th keyframe and loop gates loose enough to fire) serves:

- teacher-forced keyframe back end: the reference system is captured just
  before its 4th keyframe's back end (which resolves a fired loop gate and
  runs the pose graph, retrains the vocabulary, issues the next gate, runs
  the windowed BA and packs the spill), converted, and the port's back end
  runs on it with the reference's draws: keyframe DB poses and the live
  pose within 1e-4, the other keyframe DB fields, the vocabulary and the
  BoW database exact, map xyz within 1e-3 relative, the packed loop verdict
  (scores 1e-6, slots and counts exact, edge rotations 1e-4, translations
  1e-3 of their length);
- the reloc query on the captured system: same packed result;
- free running: the port's ``run_system`` on the same sequence gives the
  same keyframe frames and BA count, and a keyframe ATE within 2 mm.

Also: the orbit render, lagged telemetry bit-identical to synchronous with
the back end off, the runner's two modes, the demo, the once-unported
settings building a system, the CUDA default, no module of the port
importing JAX, and the live ``ba_solver="dist"`` windowed BA teacher-forced
on the captured system against the reference's at 8 shards.
"""

import copy
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenslam_tpu.pipeline.system as jsystem
from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.pipeline.state import SlamConfig as JaxConfig
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
from zenslam_tpu_torch.io import synthetic as port_synthetic
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.runner import run_sequence
from zenslam_tpu_torch.pipeline.state import SlamConfig
from zenslam_tpu_torch.utils import tracing
from test_torch_backend import reference_draw

torch.set_num_threads(2)
CFG = dict(max_keypoints=256, max_landmarks=2048, pnp_iters=128, rigid_iters=128,
           kf_min_frames=2, kf_min_translation=0.04)
BCFG = dict(bow_branch=16, vocab_retrain_kfs=4, vocab_archive_sample=512,
            bow_min_frame_gap=4, bow_min_score=0.0, loop_min_inliers=12)
CAPTURE_KF = 4           # the keyframe whose back end is teacher-forced


def _copy(tree):
    return jax.tree.map(np.array, tree)


def _numpy_system(js):
    """A copy of the reference system with numpy leaves (copies: the
    reference's next step donates its buffers)."""
    ns = SimpleNamespace(**{f.name: getattr(js, f.name) for f in dataclasses.fields(js)})
    for name in ("state", "kf_db", "bow_db", "vocab", "last_kf_snap", "rig"):
        v = getattr(js, name)
        setattr(ns, name, None if v is None else _copy(v))
    ns.edge_i, ns.edge_j, ns.edge_w = list(js.edge_i), list(js.edge_j), list(js.edge_w)
    ns.edge_R = [np.array(r) for r in js.edge_R]
    ns.edge_t = [np.array(t) for t in js.edge_t]
    ns.archive = copy.deepcopy(js.archive)
    ns.loop_debug = copy.deepcopy(js.loop_debug)
    ns._tel_queue = [(np.array(p), _copy(s), f) for p, s, f in js._tel_queue]
    if js._pending_loop is not None:
        p, slot, frame = js._pending_loop
        ns._pending_loop = (np.array(p), slot, frame)
    if js._pending_spill is not None:
        ns._pending_spill = np.array(js._pending_spill)
    if js._pg_delta is not None:
        ns._pg_delta = tuple(np.array(x) for x in js._pg_delta)
    return ns


def _loop_noise(frame_idx, k, n):
    """The reference loop gate's PnP draws: gumbel(fold_in(key, c))."""
    key = jax.random.PRNGKey(frame_idx * 16)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(key, c), (128, n))) for c in range(k)]))


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=14, motion="strafe", speed=0.6)


@pytest.fixture(scope="module")
def reference(seq):
    """The reference's free run, capturing the system around its
    CAPTURE_KF-th keyframe's back end."""
    cap = {}
    original = jsystem._keyframe_backend

    def spy(sys_, snap, frame_idx, info):
        if sys_.n_keyframes == CAPTURE_KF - 1:
            cap["before"] = _numpy_system(sys_)
            cap["snap"], cap["frame"] = _copy(snap), frame_idx
            cap["vocab_key"] = 13 if sys_.vocab is not None else 7
            original(sys_, snap, frame_idx, info)
            cap["after"] = _numpy_system(sys_)
            return
        original(sys_, snap, frame_idx, info)

    js = jsystem.create_system(JaxConfig(**CFG), jsystem.BackendConfig(**BCFG), seq.rig,
                               seq.left[0].shape)
    jsystem._keyframe_backend = spy
    try:
        tel, _ = jsystem.run_system(js, seq.left, seq.right)
    finally:
        jsystem._keyframe_backend = original
    return js, tel, cap


def _kf_ate(kf_db, seq):
    """Unaligned RMSE of keyframe camera centres vs groundtruth (as
    tests/test_loop_closure.py)."""
    fi, v = np.asarray(kf_db.frame_idx), np.asarray(kf_db.valid)
    R, t = np.asarray(kf_db.R)[v], np.asarray(kf_db.t)[v]
    est = np.einsum("kij,kj->ki", np.transpose(R, (0, 2, 1)), -t)
    gt = np.stack([-seq.R_lw[f].T @ seq.t_lw[f] for f in fi[v]])
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))


def test_capture_exercises_the_whole_back_end(reference):
    _, _, cap = reference
    before, after = cap["before"], cap["after"]
    assert before._pending_loop is not None and cap["vocab_key"] == 13
    assert after.n_loop_closures == before.n_loop_closures + 1   # the pose graph ran
    assert after.n_ba_runs == before.n_ba_runs + 1


def test_keyframe_backend_teacher_forced(seq, reference):
    _, _, cap = reference
    before, after, frame = cap["before"], cap["after"], cap["frame"]
    H, W = seq.left[0].shape
    ps = convert.system_from_numpy(before, "cpu", image_shape=(H, W))
    snap = convert.table_from_numpy(psystem.KfSnap, cap["snap"], "cpu")
    k = min(ps.bcfg.bow_top_k, ps.bcfg.max_keyframes)
    draws = psystem.BackendDraws(vocab=reference_draw(jax.random.PRNGKey(cap["vocab_key"])),
                                 loop_noise=_loop_noise(frame, k, CFG["max_keypoints"]))
    info = {}
    tracing.enable()
    try:
        psystem._keyframe_backend(ps, snap, frame, info, draws=draws)
        phases = {x.name for x in tracing.collect()["host"]}
    finally:
        tracing.disable()
    assert phases >= {"backend.spill_resolve", "backend.resolve", "backend.kf_add",
                      "backend.loop_issue", "backend.ba_dispatch", "backend.spill_pack"}
    assert info["loop"] is True
    out = convert.system_to_numpy(ps)
    for name in ("n_keyframes", "n_loop_closures", "n_ba_runs", "last_kf_slot", "last_vocab_kfs"):
        assert getattr(out, name) == getattr(after, name), name
    db, jdb = out.kf_db, after.kf_db
    np.testing.assert_allclose(db.R, jdb.R, atol=1e-4)
    np.testing.assert_allclose(db.t, jdb.t, atol=1e-4)
    np.testing.assert_allclose(db.kp_xyz, jdb.kp_xyz, atol=1e-3)
    for name in ("kp_xy", "kp_lm", "kp_lm_gen", "kp_valid", "kp_uvr", "kp_stereo", "kp_desc",
                 "frame_idx", "valid", "next_slot"):
        np.testing.assert_array_equal(getattr(db, name), getattr(jdb, name), err_msg=name)
    np.testing.assert_array_equal(out.vocab.l1, after.vocab.l1)
    np.testing.assert_array_equal(out.vocab.l2, after.vocab.l2)
    for name in psystem.BowDatabase._fields:
        np.testing.assert_array_equal(getattr(out.bow_db, name), getattr(after.bow_db, name),
                                      err_msg=name)
    np.testing.assert_allclose(out.state.R_cw, after.state.R_cw, atol=1e-4)
    np.testing.assert_allclose(out.state.t_cw, after.state.t_cw, atol=1e-4)
    xyz, jxyz = out.state.lmap.xyz, after.state.lmap.xyz
    assert (np.linalg.norm(xyz - jxyz, axis=-1)
            <= 1e-3 * np.maximum(np.linalg.norm(jxyz, axis=-1), 1.0)).all()
    p, jp = ps._pending_loop[0].numpy(), after._pending_loop[0]
    np.testing.assert_allclose(p[:k], jp[:k], atol=1e-6)                 # scores
    np.testing.assert_array_equal(p[k:5 * k], jp[k:5 * k])               # frames, slots, counts
    np.testing.assert_allclose(p[5 * k:14 * k], jp[5 * k:14 * k], atol=1e-4)   # edge rotations
    # edge translations: 1e-3 of their length (a PnP refined in f32 on ~200
    # inliers; one coordinate of one candidate differs by 1.6e-4 m over 0.25 m)
    t, jt = p[14 * k:].reshape(k, 3), jp[14 * k:].reshape(k, 3)
    assert (np.linalg.norm(t - jt, axis=-1) <= 1e-3 * np.linalg.norm(jt, axis=-1) + 1e-5).all()
    assert len(out.edge_i) == len(after.edge_i) and out.edge_j == after.edge_j
    assert len(out.archive) == len(after.archive)


def test_reloc_query_matches_reference(seq, reference):
    _, _, cap = reference
    after = cap["after"]
    H, W = seq.left[0].shape
    ps = convert.system_from_numpy(after, "cpu", image_shape=(H, W))
    jsnap = jsystem._kf_snapshot(jax.tree.map(jnp.asarray, after.state))
    snap = psystem._kf_snapshot(ps.state)
    k = min(ps.bcfg.bow_top_k, ps.bcfg.max_keyframes)
    key = jax.random.PRNGKey(after.n_frames)
    jp = np.asarray(jsystem._reloc_query_jit(
        jax.tree.map(jnp.asarray, after.vocab), jax.tree.map(jnp.asarray, after.bow_db),
        jax.tree.map(jnp.asarray, after.kf_db), jsnap.desc, jsnap.valid, jsnap.xy,
        jnp.asarray(after.rig.left.K), jnp.asarray(ps.bcfg.loop_pnp_threshold, jnp.float32),
        key, top_k=ps.bcfg.bow_top_k, pnp_iters=128))
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, c), (128, CFG["max_keypoints"]))) for c in range(k)]))
    p = psystem._reloc_query(ps.vocab, ps.bow_db, ps.kf_db, snap.desc, snap.valid, snap.xy,
                             ps.rig.left.K, ps.bcfg.loop_pnp_threshold, noise,
                             top_k=ps.bcfg.bow_top_k).numpy()
    np.testing.assert_allclose(p[:k], jp[:k], atol=1e-6)
    np.testing.assert_array_equal(p[k:3 * k], jp[k:3 * k])
    assert (jp[2 * k:3 * k] >= 12).any()                   # a real verification
    np.testing.assert_allclose(p[3 * k:], jp[3 * k:], atol=1e-4)


def test_windowed_dist_ba_teacher_forced(seq, reference):
    """The live ``ba_solver="dist"`` windowed BA at 8 shards on the captured
    system, against the reference's ``_windowed_ba_jit`` on its 8-device
    mesh: keyframe poses, the live pose and [rmse_before, rmse_after,
    dropped] within 1e-4, the map's xyz within 1e-3 relative. The window
    was adjusted at the previous keyframe, so its newest keyframe is moved
    by ~1 cm first (in both), to give the solve work."""
    from zenslam_tpu.parallel.dist_ba import make_ba_mesh

    before = copy.copy(reference[2]["before"])
    db = before.kf_db
    newest = int(np.argmax(np.where(db.valid, db.frame_idx, -1)))
    t = db.t.copy()
    t[newest] += np.array([0.01, -0.005, 0.004], np.float32)
    before.kf_db = db._replace(t=t)
    H, W = seq.left[0].shape
    ps = convert.system_from_numpy(before, "cpu", image_shape=(H, W))
    bc = ps.bcfg
    lm, st = ps.state.lmap, ps.state
    out = psystem._windowed_ba(ps.kf_db, lm.xyz, lm.valid, lm.generation, st.R_cw, st.t_cw,
                               ps.rig, W=bc.ba_window, solver="dist",
                               iterations=bc.ba_iterations,
                               mesh=psystem._live_ba_mesh(8, torch.device("cpu")))
    jdb, jst, jrig = (jax.tree.map(jnp.asarray, x) for x in (before.kf_db, before.state,
                                                             before.rig))
    jout = jsystem._windowed_ba_jit(jdb, jst.lmap.xyz, jst.lmap.valid, jst.lmap.generation,
                                    jst.R_cw, jst.t_cw, jrig,
                                    W=bc.ba_window, solver="dist", iterations=bc.ba_iterations,
                                    mesh=make_ba_mesh(8))
    (R, t, xyz, R_cur, t_cur, rmse), jo = (x.numpy() for x in out), [np.asarray(x) for x in jout]
    for a, b in zip((R, t, R_cur, t_cur, rmse), (jo[0], jo[1], jo[3], jo[4], jo[5])):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert rmse[1] < 0.5 * rmse[0] and rmse[2] == 0
    assert (np.linalg.norm(xyz - jo[2], axis=-1)
            <= 1e-3 * np.maximum(np.linalg.norm(jo[2], axis=-1), 1.0)).all()


def test_ba_window_sums_match_index_add(seq, reference, monkeypatch):
    """BA's block sums on a window of the system's own inputs (the captured
    system's windowed BA problem): the planned segment sums, which both
    devices run, are bit-identical to ``index_add_`` of the valid rows, by
    keyframe, by landmark and by (landmark, keyframe)."""
    from zenslam_tpu_torch.backend import ba

    problems = []
    solve = psystem.bundle_adjust

    def spy(p, **kw):
        problems.append(p)
        return solve(p, **kw)

    monkeypatch.setattr(psystem, "bundle_adjust", spy)
    H, W = seq.left[0].shape
    ps = convert.system_from_numpy(reference[2]["before"], "cpu", image_shape=(H, W))
    lm, st = ps.state.lmap, ps.state
    psystem._windowed_ba(ps.kf_db, lm.xyz, lm.valid, lm.generation, st.R_cw, st.t_cw, ps.rig,
                         W=ps.bcfg.ba_window, solver="dense", iterations=1)
    p = problems[0]
    K, M = p.R.shape[0], p.xyz.shape[0]
    r, w, kf, lm_i, Jp, Jl = ba._obs_jacobians(p, p.R, p.t, p.xyz, 1.0)
    Jp_w, Jl_w = Jp * w[:, None, None], Jl * w[:, None, None]
    keep = p.obs_valid
    assert 200 < int(keep.sum()) and K >= 3
    plans = ba.ba_plans(p)
    sums = ((plans.kf, K, kf, torch.einsum("oai,oaj->oij", Jp_w, Jp)),
            (plans.kf, K, kf, -torch.einsum("oai,oa->oi", Jp_w, r)),
            (plans.lm, M, lm_i, torch.einsum("oai,oaj->oij", Jl_w, Jl)),
            (plans.lm, M, lm_i, -torch.einsum("oai,oa->oi", Jl_w, r)),
            (plans.lm_kf, M * K, lm_i * K + kf, torch.einsum("oai,oaj->oij", Jp_w, Jl)))
    for plan, n, idx, v in sums:
        ref = torch.zeros((n,) + v.shape[1:]).index_add_(0, idx[keep], v[keep])
        assert torch.equal(ba.seg_sum(plan, v), ref)


def test_free_running_system(seq, reference):
    js, jtel, _ = reference
    prig = convert.rig_from_numpy(_copy(seq.rig), "cpu")
    ps = psystem.create_system(SlamConfig(**CFG), psystem.BackendConfig(**BCFG), prig,
                               seq.left[0].shape, device="cpu")
    tel, infos = psystem.run_system(ps, seq.left, seq.right)
    np.testing.assert_array_equal(tel.is_keyframe, np.asarray(jtel.is_keyframe))
    assert ps.n_ba_runs == js.n_ba_runs >= 3
    assert ps.n_loop_closures >= 1
    ate, jate = _kf_ate(ps.kf_db, seq), _kf_ate(_copy(js.kf_db), seq)
    assert abs(ate - jate) < 2e-3 and ate < 0.02
    gt = camera_positions(seq.R_lw, seq.t_lw)
    assert ate_rmse(camera_positions(tel.R_cw, tel.t_cw), gt) < 0.05
    runs = [np.asarray(i["ba"]) for i in infos if i["ba"] is not None]
    assert all(r[1] <= r[0] * 1.05 and r[2] == 0 for r in runs)
    assert ps.host_reads["telemetry"] == 14 and ps.host_reads["loop"] == ps.n_keyframes


def test_port_renders_the_reference_orbit():
    kw = dict(n_frames=6, width=160, height=120, motion="orbit", pixel_noise=0.01,
              orbit_radius=1.0)
    ref = make_sequence(np.random.default_rng(21), **kw)
    mine = port_synthetic.make_sequence(np.random.default_rng(21), device="cpu", **kw)
    np.testing.assert_array_equal(mine.left, ref.left)
    np.testing.assert_array_equal(mine.right, ref.right)
    np.testing.assert_array_equal(mine.R_lw, ref.R_lw)
    np.testing.assert_array_equal(mine.t_lw, ref.t_lw)
    # without noise the reference keeps its float64 render; the port's frames
    # are that render rounded to float32
    fwd = dict(n_frames=2, width=96, height=64, motion="forward")
    np.testing.assert_array_equal(
        port_synthetic.make_sequence(np.random.default_rng(2), device="cpu", **fwd).left,
        make_sequence(np.random.default_rng(2), **fwd).left.astype(np.float32))


@pytest.fixture(scope="module")
def small():
    seq = port_synthetic.make_sequence(np.random.default_rng(77), n_frames=12, width=320,
                                       height=256, motion="arc", device="cpu")
    cfg = SlamConfig(max_keypoints=128, max_landmarks=1024, pnp_iters=64, rigid_iters=64,
                     essential_iters=64, kf_min_frames=2, kf_min_translation=0.04)
    return seq, cfg


def test_lagged_telemetry_bit_identical(small):
    seq, cfg = small
    bc = dict(ba_every_kf=False, enable_loop_closure=False, enable_map_spill=False)
    s0 = psystem.create_system(cfg, psystem.BackendConfig(**bc), seq.rig, (256, 320),
                               device="cpu")
    tel0, _ = psystem.run_system(s0, seq.left, seq.right)
    s3 = psystem.create_system(cfg, psystem.BackendConfig(telemetry_lag=3, **bc), seq.rig,
                               (256, 320), device="cpu")
    tel3, infos3 = psystem.run_system(s3, seq.left, seq.right)
    for a, b in zip(tel0, tel3):
        np.testing.assert_array_equal(a, b)
    assert [i["frame"] for i in infos3] == list(range(12))
    assert int(tel3.is_keyframe.sum()) == int(np.asarray(s3.kf_db.valid).sum()) >= 2


def test_runner_modes_and_demo(small, capsys):
    seq, cfg = small
    st, tel = run_sequence(cfg, seq.rig, seq.left[:4], seq.right[:4], mode="stream",
                           device="cpu")
    st2, tel2 = run_sequence(cfg, seq.rig, seq.left[:4], seq.right[:4], mode="scan",
                             device="cpu")
    for a, b in zip(tel, tel2):
        np.testing.assert_array_equal(a, b)
    assert tel.t_cw.shape == (4, 3) and torch.equal(st.t_cw, st2.t_cw)
    with pytest.raises(ValueError):
        run_sequence(cfg, seq.rig, seq.left[:1], seq.right[:1], mode="batch", device="cpu")
    from zenslam_tpu_torch.pipeline import demo

    ate, fps = demo.main(3, device="cpu", width=192, height=128)
    assert np.isfinite(ate) and fps > 0 and "ATE" in capsys.readouterr().out


@pytest.mark.parametrize("bcfg,cfg,item", [
    (dict(ba_solver="dist", dist_devices=8), {}, "item 17"),
    ({}, dict(descriptor="sift"), None),
])
def test_unported_settings_raise(bcfg, cfg, item):
    """The settings that raised before their slices were ported now build
    a system: ``ba_solver="dist"`` (item 17) with its 8-shard live mesh on
    a one-rank gloo group, and the SIFT family; an unknown solver raises."""
    rig = port_synthetic.default_rig(64, 64, device="cpu")
    s = psystem.create_system(SlamConfig(**cfg), psystem.BackendConfig(**bcfg), rig, (64, 64),
                              device="cpu")
    if item == "item 17":
        mesh = psystem._live_ba_mesh(s.bcfg.dist_devices, s.device)
        assert (mesh.n_shards, mesh.local_shards, mesh.device) == (8, 8, torch.device("cpu"))
        assert torch.distributed.get_backend(mesh.group) == "gloo"
        with pytest.raises(ValueError, match="unknown ba_solver"):
            psystem.create_system(SlamConfig(), psystem.BackendConfig(ba_solver="sparse"), rig,
                                  (64, 64), device="cpu")
        return
    # the SIFT family is ported: float tables live, binary codes in the DB
    assert s.state.features.desc.shape == (512, 128)
    assert s.state.features.desc.dtype == torch.float32
    assert s.archive.desc.dtype == np.float32 and s.archive.desc.shape[1:] == (128,)
    assert s.kf_db.kp_desc.dtype == torch.int32 and s.kf_db.kp_desc.shape[-1] == 8


def test_create_system_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rig = port_synthetic.default_rig(64, 64, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psystem.create_system(SlamConfig(), psystem.BackendConfig(), rig, (64, 64))
    s = psystem.create_system(SlamConfig(), psystem.BackendConfig(), rig, (64, 64), device="cpu")
    assert s.kf_db.R.device.type == "cpu" and s.state.R_cw.device.type == "cpu"


def test_backend_config_converts_with_same_fields():
    ref = jsystem.BackendConfig(telemetry_lag=3, bow_branch=32)
    assert ([f.name for f in dataclasses.fields(psystem.BackendConfig)]
            == [f.name for f in dataclasses.fields(jsystem.BackendConfig)])
    assert psystem.BackendConfig() == convert.backend_config_from_dict(
        dataclasses.asdict(jsystem.BackendConfig()))
    assert convert.backend_config_from_dict(dataclasses.asdict(ref)).bow_branch == 32


def test_no_module_of_the_port_imports_jax():
    import zenslam_tpu_torch

    names = sorted(m.name for m in pkgutil.walk_packages(zenslam_tpu_torch.__path__,
                                                         "zenslam_tpu_torch."))
    assert {"zenslam_tpu_torch.pipeline.system", "zenslam_tpu_torch.backend.ba",
            "zenslam_tpu_torch.pipeline.demo", "zenslam_tpu_torch.app",
            "zenslam_tpu_torch.io.dataset", "zenslam_tpu_torch.io.checkpoint",
            "zenslam_tpu_torch.native.loader", "zenslam_tpu_torch.imu.preintegration",
            "zenslam_tpu_torch.imu.continuous", "zenslam_tpu_torch.imu.gravity",
            "zenslam_tpu_torch.imu.predictors", "zenslam_tpu_torch.estimation.fusion",
            "zenslam_tpu_torch.ops.lines", "zenslam_tpu_torch.pipeline.lines_step",
            "zenslam_tpu_torch.parallel.dist_ba", "zenslam_tpu_torch.parallel.multihost",
            "zenslam_tpu_torch.parallel.offline", "zenslam_tpu_torch.parallel.offline_worker",
            "zenslam_tpu_torch.io.bal", "zenslam_tpu_torch.eval.fulldress"} <= set(names)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['zenslam_tpu'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'zenslam_tpu')\n"
        "            and sys.modules[m] is not None]\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(Path(__file__).resolve().parents[1]))
