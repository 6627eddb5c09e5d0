"""The port's back end (zenslam_tpu_torch.backend) against the JAX reference
on the CPU, same inputs made from a seed:

- BA (dense Schur and CG) on a stereo window of 6 keyframes with a few
  hundred landmarks, plain, motion-only, two-keyframe gauge and trimmed:
  R and t within 1e-4, xyz within 1e-3 relative, n_accepted equal; and
  tests/test_bal.py's synthetic BAL subset, motion-only and full, dense and
  CG: R and t within 1e-4 and that test's own checks;
- keyframe DB: ring eviction, covisibility, recent_mask and the BA problem
  it builds are exact;
- pose graph: edge Jacobians within 1e-5 of JAX's jacfwd, the optimised
  poses within 1e-4;
- BoW: given the reference's draws the k-means centres are identical, tree
  and flat histograms exact, query scores within 1e-6 with identical slots
  (ties included), and a saved vocabulary loads in the other package;
- map archive: ``_pack_live`` bit-identical, and a sync / reload sequence
  leaves the same archive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.backend import ba as jba
from zenslam_tpu.backend import bow as jbow
from zenslam_tpu.backend import keyframes as jkf
from zenslam_tpu.backend import map_archive as jarch
from zenslam_tpu.backend import pose_graph as jpg
from zenslam_tpu.geometry.lie import se3_compose as jse3_compose
from zenslam_tpu.geometry.lie import se3_inverse as jse3_inverse
from zenslam_tpu.geometry.lie import so3_exp as jso3_exp
from zenslam_tpu.io.synthetic import default_rig as jdefault_rig
from zenslam_tpu.pipeline.state import empty_landmarks
from zenslam_tpu.pipeline.state import SlamConfig as JaxConfig
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.backend import ba, bow, keyframes, map_archive, pose_graph
from zenslam_tpu_torch.backend.bow import KmeansDraws, Vocabulary
from zenslam_tpu_torch.geometry import lie
from zenslam_tpu_torch.pipeline.state import LandmarkMap

torch.set_num_threads(2)
FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0
BASELINE = np.array([-0.11, 0.0, 0.0], np.float32)


def _t(x):
    return convert.tensor_from_numpy(np.asarray(x), "cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- BA --------

def _stereo_window(seed, n_kf=6, n_lm=240, K_cap=8, M_cap=256, n_fixed=1,
                   pix_noise=0.3, outliers=0.0):
    """A 6-keyframe stereo window: GT scene, left and right observations of
    every landmark in every keyframe (with pixel noise and optional gross
    outliers), poses and landmarks perturbed. Returns a numpy problem dict."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 10, n_lm)], -1).astype(np.float32)
    Rs, ts, okf, olm, ouv, ocam = [], [], [], [], [], []
    for k in range(n_kf):
        R = np.asarray(jso3_exp(jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32))))
        t = (np.array([0.3 * k, 0, 0]) + rng.normal(0, 0.02, 3)).astype(np.float32)
        Rs.append(R)
        ts.append(t)
        for cam in (0, 1):
            xc = X @ R.T + t + (BASELINE if cam else 0.0)
            uv = np.stack([FX * xc[:, 0] / xc[:, 2] + CX, FY * xc[:, 1] / xc[:, 2] + CY], -1)
            okf += [k] * n_lm
            olm += list(range(n_lm))
            ouv.append(uv + rng.normal(0, pix_noise, uv.shape))
            ocam += [cam] * n_lm
    uv = np.concatenate(ouv).astype(np.float32)
    if outliers:
        sel = rng.choice(len(uv), int(outliers * len(uv)), replace=False)
        uv[sel] += rng.uniform(30, 80, (len(sel), 2)).astype(np.float32)
    R0, t0 = np.stack(Rs), np.stack(ts)
    for k in range(n_fixed, n_kf):
        dR = np.asarray(jso3_exp(jnp.asarray(rng.normal(0, 0.03, 3).astype(np.float32))))
        R0[k] = dR @ R0[k]
        t0[k] = dR @ t0[k] + rng.normal(0, 0.03, 3).astype(np.float32)
    O = len(okf)

    def pad(a, n):
        return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)])

    return dict(
        R=np.concatenate([R0, np.tile(np.eye(3, dtype=np.float32), (K_cap - n_kf, 1, 1))]),
        t=pad(t0, K_cap), kf_valid=np.arange(K_cap) < n_kf, kf_fixed=np.arange(K_cap) < n_fixed,
        xyz=pad(X + rng.normal(0, 0.05, X.shape).astype(np.float32), M_cap),
        lm_valid=np.arange(M_cap) < n_lm, obs_kf=np.asarray(okf, np.int32),
        obs_lm=np.asarray(olm, np.int32), obs_uv=uv, obs_cam=np.asarray(ocam, np.int32),
        obs_valid=np.ones(O, bool),
        fx=np.float32(FX), fy=np.float32(FY), cx=np.float32(CX), cy=np.float32(CY),
        fx_r=np.float32(FX), fy_r=np.float32(FY), cx_r=np.float32(CX), cy_r=np.float32(CY),
        R_rl=np.eye(3, dtype=np.float32), t_rl=BASELINE)


# Iteration counts stop while each LM step still lowers the cost by more than
# f32 rounding: past that (step 4 of a window that converges in 3), accepting
# a step compares two costs equal to ~1e-6 relative, and the two packages'
# summation orders decide it either way.
BA_CASES = {
    "dense": dict(solver="dense", kw=dict(iterations=3)),
    "dense_motion_only": dict(solver="dense", kw=dict(iterations=8, refine_landmarks=False)),
    "dense_two_fixed": dict(solver="dense", n_fixed=2, kw=dict(iterations=3)),
    "dense_trim": dict(solver="dense", outliers=0.08, n_fixed=2,
                       kw=dict(iterations=4, trim_threshold=5.0)),
    "cg": dict(solver="cg", kw=dict(iterations=3, cg_iters=40)),
    "cg_motion_only": dict(solver="cg", kw=dict(iterations=6, refine_landmarks=False)),
}


@pytest.mark.parametrize("case", list(BA_CASES))
def test_bundle_adjust_matches_reference(case):
    c = BA_CASES[case]
    d = _stereo_window(7, n_fixed=c.get("n_fixed", 1), outliers=c.get("outliers", 0.0))
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    pp = ba.BAProblem(**{k: _t(v) for k, v in d.items()})
    jfn, pfn = ((jba.bundle_adjust, ba.bundle_adjust) if c["solver"] == "dense"
                else (jba.bundle_adjust_cg, ba.bundle_adjust_cg))
    jr, pr = _np(jfn(jp, **c["kw"])), pfn(pp, **c["kw"])
    np.testing.assert_allclose(pr["R"].numpy(), jr["R"], atol=1e-4)
    np.testing.assert_allclose(pr["t"].numpy(), jr["t"], atol=1e-4)
    dx = np.linalg.norm(pr["xyz"].numpy() - jr["xyz"], axis=-1)
    assert (dx <= 1e-3 * np.maximum(np.linalg.norm(jr["xyz"], axis=-1), 1.0)).all()
    assert int(pr["n_accepted"]) == int(jr["n_accepted"])
    np.testing.assert_allclose(float(pr["rmse_after"]), float(jr["rmse_after"]), rtol=1e-4,
                               atol=1e-5)
    assert float(pr["rmse_after"]) < float(pr["rmse_before"])
    if "trim_threshold" in c["kw"]:
        assert int(pr["n_trimmed"]) == int(jr["n_trimmed"]) > 0
    if c["kw"].get("refine_landmarks") is False:
        assert torch.equal(pr["xyz"], pp.xyz)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("refine", [False, True], ids=["motion_only", "full"])
def test_bal_subset_matches_reference(solver, refine):
    """tests/test_bal.py's synthetic BAL subset (monocular, 2 fixed cameras,
    perturbed poses; landmarks perturbed by 1 cm for full BA) at its 12
    iterations: R and t within 1e-4 of the reference, and that test's own
    checks. The problem converges to ~1e-5 px in 2-3 steps, after which
    accepting a step compares costs equal to f32 rounding, so n_accepted
    is not compared."""
    from zenslam_tpu.io import bal as jbal
    from zenslam_tpu_torch.io import bal as pbal

    jp, info = jbal.bal_subset_ba_problem(jbal.make_synthetic_bal(n_cameras=6, n_points=400,
                                                                  seed=7))
    pp, _ = pbal.bal_subset_ba_problem(pbal.make_synthetic_bal(n_cameras=6, n_points=400,
                                                               seed=7), device="cpu")
    if refine:
        d = np.random.default_rng(3).normal(0, 0.01, jp.xyz.shape).astype(np.float32)
        jp = jp._replace(xyz=jp.xyz + jnp.asarray(d))
        pp = pp._replace(xyz=pp.xyz + torch.from_numpy(d))
    jfn, pfn = ((jba.bundle_adjust, ba.bundle_adjust) if solver == "dense"
                else (jba.bundle_adjust_cg, ba.bundle_adjust_cg))
    jr, pr = _np(jfn(jp, iterations=12, refine_landmarks=refine)), \
        pfn(pp, iterations=12, refine_landmarks=refine)
    np.testing.assert_allclose(pr["R"].numpy(), jr["R"], atol=1e-4)
    np.testing.assert_allclose(pr["t"].numpy(), jr["t"], atol=1e-4)
    assert float(pr["rmse_after"]) < 0.5 * float(pr["rmse_before"])
    free = ~info["kf_fixed"]
    err = [np.linalg.norm(t[free] - info["t_gt"][free], axis=-1).sum()
           for t in (pp.t.numpy(), pr["t"].numpy())]
    assert err[1] < err[0]
    if not refine:
        assert torch.equal(pr["xyz"], pp.xyz)


def test_cholesky_failure_gives_zero_step():
    """An indefinite reduced system: the reference's NaN factor becomes a zero
    pose step; the port's cholesky_ex path does the same without raising."""
    S = torch.diag(torch.tensor([1.0, -1.0, 2.0]))
    assert torch.equal(ba.cholesky_solve_or_zero(S, torch.ones(3)), torch.zeros(3))
    x = ba.cholesky_solve_or_zero(torch.eye(3) * 2.0, torch.ones(3))
    np.testing.assert_allclose(x.numpy(), 0.5, rtol=1e-6)


# --------------------------------------------------------- keyframes --------

def _kf_inputs(rng, n_kf, N, M):
    out = []
    for f in range(n_kf):
        lm = rng.integers(-1, M, N).astype(np.int32)
        out.append(dict(
            R=np.asarray(jso3_exp(jnp.asarray(rng.normal(0, 0.1, 3).astype(np.float32)))),
            t=rng.normal(0, 1, 3).astype(np.float32),
            kp_xy=rng.uniform(0, 300, (N, 2)).astype(np.float32), kp_lm=lm,
            kp_valid=rng.random(N) < 0.8,
            kp_desc=rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32),
            frame_idx=3 * f + 1,
            kp_uvr=rng.uniform(0, 300, (N, 2)).astype(np.float32),
            kp_stereo=rng.random(N) < 0.6,
            kp_lm_gen=np.where(lm >= 0, rng.integers(0, 3, N), -1).astype(np.int32),
            kp_xyz=rng.normal(0, 3, (N, 3)).astype(np.float32)))
    return out


def test_keyframe_db_exact():
    rng = np.random.default_rng(3)
    K, N, M = 4, 24, 64
    jdb, pdb = jkf.kf_db_init(K, N), keyframes.kf_db_init(K, N, device="cpu")
    for a in _kf_inputs(rng, 6, N, M):          # 6 adds into 4 slots: ring eviction
        fi = a.pop("frame_idx")
        pos = ("R", "t", "kp_xy", "kp_lm", "kp_valid", "kp_desc")
        kw = ("kp_uvr", "kp_stereo", "kp_lm_gen", "kp_xyz")
        jdb = jkf.kf_db_add(jdb, *(jnp.asarray(a[k]) for k in pos), fi,
                            **{k: jnp.asarray(a[k]) for k in kw})
        pdb = keyframes.kf_db_add(pdb, *(_t(a[k]) for k in pos), fi, **{k: _t(a[k]) for k in kw})
    jn, pn = _np(jdb), convert.table_to_numpy(pdb)
    for name in keyframes.KeyframeDB._fields:
        np.testing.assert_array_equal(getattr(pn, name), getattr(jn, name), err_msg=name)
    assert sorted(pn.frame_idx.tolist()) == [7, 10, 13, 16]
    js, je = jkf.covisibility(jdb, M, threshold=3)
    ps, pe = keyframes.covisibility(pdb, M, threshold=3)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    for n in (1, 3, 6):
        np.testing.assert_array_equal(keyframes.recent_mask(pdb, n).numpy(),
                                      np.asarray(jkf.recent_mask(jdb, n)))
    jrig = jdefault_rig(320, 240)
    prig = convert.rig_from_numpy(_np(jrig), "cpu")
    xyz = rng.normal(0, 3, (M, 3)).astype(np.float32)
    lvalid = rng.random(M) < 0.9
    gen = rng.integers(0, 3, M).astype(np.int32)
    window = np.array([True, False, True, True])
    for kw in (dict(), dict(window_mask=window)):
        jp = jkf.ba_problem_from_db(jdb, jnp.asarray(xyz), jnp.asarray(lvalid), jrig,
                                    lmap_generation=jnp.asarray(gen),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
        pp = keyframes.ba_problem_from_db(pdb, _t(xyz), _t(lvalid), prig,
                                          lmap_generation=_t(gen),
                                          **{k: _t(v) for k, v in kw.items()})
        for name in ba.BAProblem._fields:
            np.testing.assert_array_equal(getattr(pp, name).numpy(), np.asarray(getattr(jp, name)),
                                          err_msg=name)


# -------------------------------------------------------- pose graph --------

def _ring_graph(seed, n=12, drift=0.02):
    """Odometry ring with drift plus one exact loop edge (as the reference's
    test builds it), with an invalid padding node and edge."""
    rng = np.random.default_rng(seed)
    R_gt, t_gt = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for k in range(1, n):
        R = np.asarray(jso3_exp(jnp.asarray([0, 0.03 * np.sin(k), 0], jnp.float32))) @ R_gt[-1]
        R_gt.append(R.astype(np.float32))
        t_gt.append((t_gt[-1] + np.array([-0.3, 0, 0])).astype(np.float32))
    ei, ej, eR, et, ew = [], [], [], [], []
    for k, (a, b) in enumerate([(k, k + 1) for k in range(n - 1)] + [(0, n - 1)]):
        Rj_inv, tj_inv = jse3_inverse(jnp.asarray(R_gt[b]), jnp.asarray(t_gt[b]))
        Rm, tm = jse3_compose(jnp.asarray(R_gt[a]), jnp.asarray(t_gt[a]), Rj_inv, tj_inv)
        if k < n - 1:
            Rm = jso3_exp(jnp.asarray(rng.normal(0, drift, 3).astype(np.float32))) @ Rm
            tm = tm + rng.normal(0, drift, 3).astype(np.float32)
        ei.append(a), ej.append(b), eR.append(np.asarray(Rm)), et.append(np.asarray(tm))
        ew.append(1.0 if k < n - 1 else 10.0)
    R0, t0 = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for k in range(n - 1):
        Rm_inv, tm_inv = jse3_inverse(jnp.asarray(eR[k]), jnp.asarray(et[k]))
        Rn, tn = jse3_compose(Rm_inv, tm_inv, jnp.asarray(R0[-1]), jnp.asarray(t0[-1]))
        R0.append(np.asarray(Rn)), t0.append(np.asarray(tn))
    E = len(ei) + 1
    return dict(
        R=np.concatenate([np.stack(R0), np.eye(3, dtype=np.float32)[None]]),
        t=np.concatenate([np.stack(t0), np.zeros((1, 3), np.float32)]),
        node_valid=np.arange(n + 1) < n, node_fixed=np.arange(n + 1) == 0,
        edge_i=np.asarray(ei + [0], np.int32), edge_j=np.asarray(ej + [0], np.int32),
        edge_R=np.concatenate([np.stack(eR), np.eye(3, dtype=np.float32)[None]]),
        edge_t=np.concatenate([np.stack(et), np.zeros((1, 3), np.float32)]),
        edge_valid=np.arange(E) < E - 1, edge_weight=np.asarray(ew + [0.0], np.float32))


def test_pose_graph_jacobians_match_jacfwd():
    g = _ring_graph(5)
    i, j = g["edge_i"], g["edge_j"]
    args = (g["R"][i], g["t"][i], g["R"][j], g["t"][j], g["edge_R"], g["edge_t"])
    z = jnp.zeros(6, jnp.float32)

    def edge_fn(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
        from zenslam_tpu.geometry.lie import se3_exp

        dRi, dti = se3_exp(xi_i)
        dRj, dtj = se3_exp(xi_j)
        Ri2, ti2 = jse3_compose(dRi, dti, Ri, ti)
        Rj2, tj2 = jse3_compose(dRj, dtj, Rj, tj)
        Rj_inv, tj_inv = jse3_inverse(Rj2, tj2)
        Rm_inv, tm_inv = jse3_inverse(Rm, tm)
        R_ij, t_ij = jse3_compose(Ri2, ti2, Rj_inv, tj_inv)
        return jpg._se3_log_smooth(*jse3_compose(Rm_inv, tm_inv, R_ij, t_ij))

    jac = jax.vmap(jax.jacfwd(edge_fn, argnums=(0, 1)), in_axes=(None, None, 0, 0, 0, 0, 0, 0))
    Ji, Jj = jac(z, z, *(jnp.asarray(a) for a in args))
    Pi, Pj = pose_graph.edge_jacobians(*(_t(a) for a in args))
    np.testing.assert_allclose(Pi.numpy(), np.asarray(Ji), atol=1e-5)
    np.testing.assert_allclose(Pj.numpy(), np.asarray(Jj), atol=1e-5)
    xi = np.random.default_rng(1).normal(0, 0.2, 6).astype(np.float32)
    np.testing.assert_allclose(lie.se3_log(*lie.se3_exp(_t(xi))).numpy(), xi, atol=1e-5)


def test_optimize_pose_graph_matches_reference():
    g = _ring_graph(6)
    jr = _np(jpg.optimize_pose_graph(jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
                                     iterations=15))
    pr = pose_graph.optimize_pose_graph(pose_graph.PoseGraph(**{k: _t(v) for k, v in g.items()}),
                                        iterations=15)
    np.testing.assert_allclose(pr["R"].numpy(), jr["R"], atol=1e-4)
    np.testing.assert_allclose(pr["t"].numpy(), jr["t"], atol=1e-4)
    assert int(pr["n_accepted"]) == int(jr["n_accepted"])
    assert float(pr["cost_after"]) < float(pr["cost_before"]) / 5
    assert torch.equal(pr["R"][0], _t(g["R"][0]))


# ---------------------------------------------------------------- BoW -------

def reference_draw(key):
    """A ``draw`` callable handing the port the reference's k-means draws for
    ``key``: the splits of ``build_vocabulary`` (flat: the key itself) and
    ``build_vocabulary_tree`` (k1 for level 1, split(k2, B) for level 2),
    then ``_kmeans_bits``' seed and per-step re-seed categoricals."""
    k1, k2 = jax.random.split(key)

    def one(k, w, n, iters):
        has_any = jnp.sum(w) > 0
        logits = jnp.where(has_any, jnp.where(w > 0, 0.0, -jnp.inf), 0.0)
        k, k0 = jax.random.split(k)
        seeds = jax.random.categorical(k0, logits, shape=(n,))
        re = jnp.stack([jax.random.categorical(kk, logits, shape=(n,))
                        for kk in jax.random.split(k, iters)])
        return seeds, re

    def draw(level, weight, n, iters):
        w = jnp.asarray(weight.cpu().numpy())
        if level == "l2":
            s, r = jax.vmap(lambda kk, ww: one(kk, ww, n, iters))(
                jax.random.split(k2, w.shape[0]), w)
        else:
            s, r = one(key if level == "flat" else k1, w, n, iters)
        return KmeansDraws(torch.from_numpy(np.array(s)).long().to(weight.device),
                           torch.from_numpy(np.array(r)).long().to(weight.device))

    return draw


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(9)
    # clustered descriptors: 12 centres, a few flipped bits each
    centres = rng.integers(0, 2 ** 32, (12, 8), dtype=np.uint32)
    desc = centres[rng.integers(0, 12, 700)]
    flips = rng.integers(0, 32, (700, 8, 3))
    for b in range(3):
        desc = desc ^ (np.uint32(1) << flips[:, :, b].astype(np.uint32))
    valid = rng.random(700) < 0.9
    return desc.astype(np.uint32), valid


def test_vocabulary_tree_identical_given_reference_draws(corpus):
    desc, valid = corpus
    key = jax.random.PRNGKey(13)
    jv = jbow.build_vocabulary_tree(key, jnp.asarray(desc), jnp.asarray(valid), branch=8, iters=6)
    pv = bow.build_vocabulary_tree(_t(desc), _t(valid), branch=8, iters=6,
                                   draw=reference_draw(key))
    np.testing.assert_array_equal(pv.l1.numpy(), np.asarray(jv.l1))
    np.testing.assert_array_equal(pv.l2.numpy(), np.asarray(jv.l2))
    q = desc[:300]
    qv = valid[:300]
    jh = np.asarray(jbow.descriptors_to_bow(jv, jnp.asarray(q), jnp.asarray(qv)))
    ph = bow.descriptors_to_bow(pv, _t(q), _t(qv)).numpy()
    np.testing.assert_array_equal(ph, jh)
    # batched quantisation: each row of a (2, N) batch equals its own call
    pb = bow.descriptors_to_bow(pv, _t(q.reshape(2, 150, 8)), _t(qv.reshape(2, 150))).numpy()
    for r in range(2):
        jr = np.asarray(jbow.descriptors_to_bow(jv, jnp.asarray(q[150 * r:150 * (r + 1)]),
                                                jnp.asarray(qv[150 * r:150 * (r + 1)])))
        np.testing.assert_array_equal(pb[r], jr)


def test_flat_vocabulary_identical_given_reference_draws(corpus):
    desc, valid = corpus
    key = jax.random.PRNGKey(4)
    jc = jbow.build_vocabulary(key, jnp.asarray(desc), jnp.asarray(valid), n_words=24, iters=5)
    pc = bow.build_vocabulary(_t(desc), _t(valid), n_words=24, iters=5, draw=reference_draw(key))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    jh = np.asarray(jbow.descriptors_to_bow(jc, jnp.asarray(desc), jnp.asarray(valid)))
    np.testing.assert_array_equal(bow.descriptors_to_bow(pc, _t(desc), _t(valid)).numpy(), jh)
    # an all-invalid corpus: all-zero centres in both
    none = np.zeros(700, bool)
    jz = jbow.build_vocabulary(key, jnp.asarray(desc), jnp.asarray(none), n_words=8, iters=2)
    pz = bow.build_vocabulary(_t(desc), _t(none), n_words=8, iters=2, draw=reference_draw(key))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))


def test_bow_database_query_matches_reference(corpus):
    desc, valid = corpus
    jc = jbow.build_vocabulary(jax.random.PRNGKey(2), jnp.asarray(desc), jnp.asarray(valid),
                               n_words=16, iters=4)
    pc = _t(np.asarray(jc))
    F = 6
    jdb, pdb = jbow.bow_db_init(F, 16), bow.bow_db_init(F, 16, device="cpu")
    frames = [0, 10, 20, 30, 40, 50, 60, 70]            # 8 adds into 6 slots
    for r, f in enumerate(frames):
        sl = slice(60 * r, 60 * r + 60)
        jh = jbow.descriptors_to_bow(jc, jnp.asarray(desc[sl]), jnp.asarray(valid[sl]))
        jdb = jbow.bow_db_add(jdb, jh, f)
        pdb = bow.bow_db_add(pdb, _t(np.asarray(jh)), f)
    for name in bow.BowDatabase._fields:
        np.testing.assert_array_equal(getattr(pdb, name).numpy(), np.asarray(getattr(jdb, name)))
    q = np.asarray(jbow.descriptors_to_bow(jc, jnp.asarray(desc[:60]), jnp.asarray(valid[:60])))
    for qf, gap, k in ((75, 30, 5), (75, 0, 6), (35, 15, 6), (1000, 40, 3)):
        js, jf, jsl = _np(jbow.bow_db_query(jdb, jnp.asarray(q), qf, min_frame_gap=gap, top_k=k))
        ps, pf, psl = bow.bow_db_query(pdb, _t(q), qf, min_frame_gap=gap, top_k=k)
        np.testing.assert_allclose(ps.numpy(), js, atol=1e-6)
        np.testing.assert_array_equal(psl.numpy(), jsl)     # excluded slots tie at -1
        np.testing.assert_array_equal(pf.numpy(), jf)


def test_vocabulary_file_crosses_packages(tmp_path, corpus):
    desc, valid = corpus
    key = jax.random.PRNGKey(1)
    jv = jbow.build_vocabulary_tree(key, jnp.asarray(desc), jnp.asarray(valid), branch=4, iters=2)
    jbow.save_vocabulary(str(tmp_path / "j.npz"), jv)
    pv = bow.load_vocabulary(str(tmp_path / "j.npz"), device="cpu")
    assert isinstance(pv, Vocabulary)
    np.testing.assert_array_equal(pv.l2.numpy(), np.asarray(jv.l2))
    bow.save_vocabulary(str(tmp_path / "p.npz"), pv)
    back = jbow.load_vocabulary(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(np.asarray(back.l1), np.asarray(jv.l1))
    flat = jbow.build_vocabulary(key, jnp.asarray(desc), jnp.asarray(valid), n_words=8, iters=2)
    bow.save_vocabulary(str(tmp_path / "f.npz"), _t(np.asarray(flat)))
    np.testing.assert_array_equal(np.asarray(jbow.load_vocabulary(str(tmp_path / "f.npz"))),
                                  np.asarray(flat))


# ------------------------------------------------------------ archive -------

def _live_map(seed, M=64, n=40):
    cfg = JaxConfig(max_landmarks=M)
    rng = np.random.default_rng(seed)
    lmap = empty_landmarks(cfg)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    desc[0, 0] = 0x7FC00001          # a NaN bit pattern in a descriptor word
    return lmap._replace(
        xyz=lmap.xyz.at[:n].set(jnp.asarray(rng.normal(0, 2, (n, 3)).astype(np.float32)
                                            + np.array([0, 0, 6], np.float32))),
        desc=lmap.desc.at[:n].set(jnp.asarray(desc)),
        valid=lmap.valid.at[:n].set(True), last_seen=lmap.last_seen.at[:n].set(5),
        color=lmap.color.at[:n].set(jnp.asarray(rng.random(n).astype(np.float32))))


def _plmap(jl):
    return convert.table_from_numpy(LandmarkMap, _np(jl), "cpu")


def test_pack_live_bit_identical():
    jl = _live_map(0)
    jp = np.asarray(jarch._pack_live(jl))
    pp = map_archive._pack_live(_plmap(jl)).numpy().view(np.uint32)
    np.testing.assert_array_equal(pp, jp)


def test_archive_sync_reload_sequence_matches_reference():
    jrig = jdefault_rig(128, 96)
    prig = convert.rig_from_numpy(_np(jrig), "cpu")
    jl = _live_map(1)
    ja, pa = jarch.LandmarkArchive(), map_archive.LandmarkArchive()
    pl = _plmap(jl)
    steps = [
        lambda l: l,
        lambda l: l._replace(generation=l.generation.at[3].add(1),
                             xyz=l.xyz.at[3].set(jnp.asarray([9.0, 9.0, 9.0]))),
        lambda l: l._replace(valid=jnp.zeros_like(l.valid), generation=l.generation + 1),
    ]
    for step in steps:
        jl = step(jl)
        pl = _plmap(jl)
        ja.sync(jl)
        pa.sync(pl)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jl2 = ja.reload(jl, jnp.asarray(R), jnp.asarray(t), jrig.left, frame_idx=10, reload_max=16)
    pl2 = pa.reload(pl, _t(R), _t(t), prig.left, frame_idx=10, reload_max=16)
    ja.sync(jl2)
    pa.sync(pl2)
    for name in ("xyz", "color", "desc", "dormant", "_slot_row", "_slot_gen"):
        np.testing.assert_array_equal(getattr(pa, name), getattr(ja, name), err_msg=name)
    assert pa.desc.dtype == np.uint32
    assert (pa._key_to_row, pa._row_key, pa.reload_keys) == (ja._key_to_row, ja._row_key,
                                                             ja.reload_keys)
    assert (pa.n_reloads, pa.n_spills) == (ja.n_reloads, ja.n_spills) and pa.n_reloads > 0
    out = convert.table_to_numpy(pl2)
    for name in LandmarkMap._fields:
        got = getattr(out, name)
        want = np.asarray(getattr(jl2, name))
        np.testing.assert_array_equal(got.view(want.dtype) if name == "desc" else got, want,
                                      err_msg=name)
