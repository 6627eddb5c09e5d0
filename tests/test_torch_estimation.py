"""Parity of the port's pose estimators with the JAX reference, given the
reference's own Gumbel draws (the port takes RANSAC noise as an input).

Tolerance: R within 1e-4, t within 1e-4 m, identical inlier masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.estimation import cascade as JCas
from zenslam_tpu.estimation import epipolar as JE
from zenslam_tpu.estimation import pnp as JPnP
from zenslam_tpu.estimation import rigid as JR
from zenslam_tpu.geometry.camera import project
from zenslam_tpu.geometry.lie import se3_apply, so3_exp
from zenslam_tpu.io.synthetic import default_rig
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation import cascade as PCas
from zenslam_tpu_torch.estimation import epipolar as PE
from zenslam_tpu_torch.estimation import pnp as PPnP
from zenslam_tpu_torch.estimation import rigid as PR

torch.set_num_threads(2)
TOL = 1e-4
ITERS = 64
N = 96


def _gumbel(key, iters, n=N):
    return torch.from_numpy(np.array(jax.random.gumbel(key, (iters, n))))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """Landmarks in front of a rig, a true pose, noisy/outlier observations."""
    rng = np.random.default_rng(0)
    rig = default_rig(320, 256)
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(2, 6, (N, 1))],
                       axis=1).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)))
    t = np.array([0.05, -0.02, 0.1], np.float32)
    xc = np.asarray(se3_apply(R, t, jnp.asarray(X)))
    uv = np.asarray(project(rig.left, jnp.asarray(xc)))
    uv = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
    out = rng.random(N) < 0.2
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2)).astype(np.float32)
    valid = rng.random(N) < 0.9
    return dict(rig=rig, X=X, R=R, t=t, xc=xc, uv=uv, valid=valid, rng=rng)


def _check(p, j, keys=("R", "t")):
    for k in keys:
        np.testing.assert_allclose(np.array(p[k]), np.asarray(j[k]), atol=TOL, rtol=0)
    np.testing.assert_array_equal(np.array(p["inliers"]), np.asarray(j["inliers"]))


def test_pnp(scene):
    s = scene
    key = jax.random.PRNGKey(1)
    K = s["rig"].left.K
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.zeros(3, np.float32)
    j = JPnP.solve_pnp_ransac(key, K, jnp.asarray(s["X"]), jnp.asarray(s["uv"]),
                              jnp.asarray(s["valid"]), threshold=3.0, iters=ITERS,
                              R_init=jnp.asarray(R0), t_init=jnp.asarray(t0))
    p = PPnP.solve_pnp_ransac(_gumbel(key, ITERS)[None], _t(K)[None], _t(s["X"])[None],
                              _t(s["uv"])[None], _t(s["valid"])[None], threshold=3.0,
                              R_init=_t(R0)[None], t_init=_t(t0)[None])
    p = {k: v[0].numpy() for k, v in p.items()}
    _check(p, j)
    assert p["n_inliers"] == int(j["n_inliers"]) and p["n_inliers"] > 40
    np.testing.assert_allclose(p["t"], s["t"], atol=0.02)


def test_rigid(scene):
    s = scene
    rng = np.random.default_rng(1)
    src = s["xc"] + rng.normal(0, 0.005, s["xc"].shape).astype(np.float32)
    out = rng.random(N) < 0.2
    src[out] += rng.uniform(-1, 1, (out.sum(), 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    j = JR.solve_rigid_ransac(key, jnp.asarray(src), jnp.asarray(s["X"]),
                              jnp.asarray(s["valid"]), threshold=0.05, iters=ITERS)
    p = PR.solve_rigid_ransac(_gumbel(key, ITERS), _t(src), _t(s["X"]), _t(s["valid"]),
                              threshold=0.05)
    _check({k: v.numpy() for k, v in p.items()}, j)


def test_essential_scaled(scene):
    s = scene
    rig = s["rig"]
    rng = np.random.default_rng(3)
    # previous frame at identity, current at (R, t): 2D-2D tracks + prior 3D
    pa = np.asarray(project(rig.left, jnp.asarray(s["X"])))
    pb = s["uv"].copy()
    pa = pa + rng.normal(0, 0.2, pa.shape).astype(np.float32)
    has3d = rng.random(N) < 0.7
    key = jax.random.PRNGKey(4)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    j = JE.estimate_2d2d_scaled(key, rig.left.K, jnp.asarray(pa), jnp.asarray(pb),
                                jnp.asarray(s["valid"]), jnp.asarray(s["X"]),
                                jnp.asarray(has3d), jnp.asarray(eye), jnp.asarray(zero),
                                threshold=1.5, iters=ITERS)
    p = PE.estimate_2d2d_scaled(_gumbel(key, ITERS), _t(rig.left.K), _t(pa), _t(pb),
                                _t(s["valid"]), _t(s["X"]), _t(has3d), _t(eye), _t(zero),
                                threshold=1.5)
    _check({k: v.numpy() for k, v in p.items()}, j)
    assert bool(p["ok"]) == bool(j["ok"])
    np.testing.assert_allclose(float(p["scale"]), float(j["scale"]), atol=TOL, rtol=0)


def test_cascade(scene):
    s = scene
    rig = s["rig"]
    prig = convert.rig_from_numpy(jax.tree.map(np.asarray, rig), "cpu")
    rng = np.random.default_rng(5)
    X, uv, valid = s["X"], s["uv"], s["valid"]
    uv1 = np.asarray(project(rig.right, se3_apply(rig.R_rl, rig.t_rl, jnp.asarray(s["xc"]))))
    valid1 = valid & (rng.random(N) < 0.8)
    src3d = X + rng.normal(0, 0.01, X.shape).astype(np.float32)
    valid3d = valid & (rng.random(N) < 0.7)
    pa = np.asarray(project(rig.left, jnp.asarray(X)))
    R_pred = np.eye(3, dtype=np.float32)
    t_pred = np.zeros(3, np.float32)
    key = jax.random.PRNGKey(6)
    ess = dict(p2a=pa, p2b=uv, valid2=valid, X2_prev_cam=X, has3d2=valid,
               R_prev=R_pred, t_prev=t_pred)
    j = JCas.estimate_pose_cascade(
        key, rig, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(X),
        jnp.asarray(uv1), jnp.asarray(valid1), jnp.asarray(src3d), jnp.asarray(X),
        jnp.asarray(valid3d), jnp.asarray(R_pred), jnp.asarray(t_pred),
        pnp_iters=ITERS, rigid_iters=ITERS, essential_iters=ITERS,
        **{k: jnp.asarray(v) for k, v in ess.items()})
    # the cascade's key chain (estimation/cascade.py): split into 3, fold_in 3
    k0, k1, k2 = jax.random.split(key, 3)
    noise = PCas.CascadeNoise(_gumbel(k0, ITERS), _gumbel(k1, ITERS), _gumbel(k2, ITERS),
                              _gumbel(jax.random.fold_in(key, 3), ITERS))
    p = PCas.estimate_pose_cascade(
        noise, prig, _t(X), _t(uv), _t(valid), _t(X), _t(uv1), _t(valid1), _t(src3d),
        _t(X), _t(valid3d), _t(R_pred), _t(t_pred), **{k: _t(v) for k, v in ess.items()})
    np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), atol=TOL)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), atol=TOL)
    np.testing.assert_array_equal(p.inliers0.numpy(), np.asarray(j.inliers0))
    assert (int(p.method), int(p.n_inliers), bool(p.ok)) == \
        (int(j.method), int(j.n_inliers), bool(j.ok))
