"""Parity of the port's IMU modules, pose fusion and fused cascade with the
JAX reference on the CPU, inputs from numpy seeds. Tolerances per test:

- ``preintegrate`` (64 rows, 10 valid, nonzero biases): every field within
  1e-5 absolute, ``cov`` within 1e-4 relative (elementwise, plus 1e-4 of
  its largest entry for the entries near zero);
- ``preintegrate_continuous``: lpm as ``preintegrate``; ugpm within 1e-4
  absolute (cov 1e-3 relative): its (T, T) GP solve in float32 lands
  2e-4-3e-3 from the float64 answer in either package on this input
  (scripts/torch_cpu_paths.py arc-parity), and the port must be within 1.5x
  of the reference's distance to it; ``overlap_window_mask`` identical;
- gravity ring and median: samples and estimates within 1e-6, slots and
  flags identical;
- predictors: 1e-5; ``make_imu`` / ``make_sequence(with_imu=True)``
  bit-identical; the port's ``make_distorted_sequence(with_imu=True)`` in
  the camchain's IMU frame within 1e-3 m/s²; ``fuse_poses``: 1e-5 and the
  same ``best``;
- the fused cascade given the reference's draws: R and t within 1e-4,
  method, inlier count and ok identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.estimation import cascade as JCas
from zenslam_tpu.estimation.fusion import PoseCandidate as JCand
from zenslam_tpu.estimation.fusion import fuse_poses as jfuse
from zenslam_tpu.geometry.camera import project
from zenslam_tpu.geometry.lie import se3_apply, so3_exp
from zenslam_tpu.imu import continuous as JC
from zenslam_tpu.imu import gravity as JG
from zenslam_tpu.imu import predictors as JPred
from zenslam_tpu.imu.preintegration import ImuIntegral as JIntegral
from zenslam_tpu.imu.preintegration import preintegrate as jpre
from zenslam_tpu.io import synthetic as jsyn
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation import cascade as PCas
from zenslam_tpu_torch.estimation.fusion import PoseCandidate, fuse_poses
from zenslam_tpu_torch.imu import continuous as PC
from zenslam_tpu_torch.imu import gravity as PG
from zenslam_tpu_torch.imu import predictors as PPred
from zenslam_tpu_torch.imu.preintegration import ImuIntegral, preintegrate
from zenslam_tpu_torch.io import synthetic as psyn

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_integral(p: ImuIntegral, j: JIntegral, atol=1e-5, cov_rtol=1e-4):
    for f in JIntegral._fields:
        a, b = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        if f == "cov":
            np.testing.assert_allclose(a, b, rtol=cov_rtol, atol=cov_rtol * np.abs(b).max(),
                                       err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)


def _imu_batch(seed, S=64, n_valid=10):
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0, 1.0, (S, 3)).astype(np.float32)
    accel = (rng.normal(0, 2.0, (S, 3)) + [0, 9.81, 0]).astype(np.float32)
    dts = (0.005 * rng.uniform(0.8, 1.2, S)).astype(np.float32)
    mask = np.zeros(S, bool)
    mask[:n_valid] = True
    gyro[n_valid:] = 999.0      # padding rows carry garbage
    accel[n_valid:] = -999.0
    bg = rng.normal(0, 0.02, 3).astype(np.float32)
    ba = rng.normal(0, 0.1, 3).astype(np.float32)
    return gyro, accel, dts, mask, bg, ba


@pytest.mark.parametrize("seed", [0, 1])
def test_preintegrate(seed):
    g, a, d, m, bg, ba = _imu_batch(seed)
    j = jpre(*(jnp.asarray(x) for x in (g, a, d, m)), bias_gyro=jnp.asarray(bg),
             bias_accel=jnp.asarray(ba))
    p = preintegrate(*(_t(x) for x in (g, a, d, m)), bias_gyro=_t(bg), bias_accel=_t(ba))
    _check_integral(p, j)
    assert float(np.asarray(j.cov).max()) > 0


def test_preintegrate_scattered_mask():
    """Valid rows anywhere in the batch: masked rows in between change nothing."""
    g, a, d, m, bg, ba = _imu_batch(3, n_valid=0)
    m[[2, 5, 6, 11, 40, 63]] = True
    g[m] = np.random.default_rng(4).normal(0, 0.5, (m.sum(), 3))
    j = jpre(*(jnp.asarray(x) for x in (g, a, d, m)))
    p = preintegrate(*(_t(x) for x in (g, a, d, m)))
    _check_integral(p, j)


def _smooth(T=240, dt=0.005, pad=16):
    ts = np.arange(T, dtype=np.float32) * dt
    gyro = np.stack([0.4 * np.sin(2 * np.pi * 0.8 * ts), 0.2 * np.cos(2 * np.pi * 0.5 * ts),
                     0.3 * np.sin(2 * np.pi * 0.3 * ts + 0.7)], -1)
    accel = np.stack([np.sin(2 * np.pi * 0.6 * ts), 0.5 * np.cos(2 * np.pi * 0.9 * ts),
                      9.8 + 0.3 * np.sin(2 * np.pi * 0.4 * ts)], -1)
    rng = np.random.default_rng(7)
    gyro = gyro + rng.normal(0, 0.05, gyro.shape)
    accel = accel + rng.normal(0, 0.3, accel.shape)
    perm = rng.permutation(T)
    cat = np.concatenate
    return (cat([ts[perm], np.full(pad, 777.0)]).astype(np.float32),
            cat([gyro[perm], np.full((pad, 3), 999.0)]).astype(np.float32),
            cat([accel[perm], np.full((pad, 3), 999.0)]).astype(np.float32),
            cat([np.ones(T, bool), np.zeros(pad, bool)]))


@pytest.mark.parametrize("method", ["lpm", "ugpm"])
def test_preintegrate_continuous(method):
    ts, g, a, m = _smooth()
    bg, ba = np.float32([0.01, -0.02, 0.0]), np.float32([0.05, 0.0, -0.1])
    j = JC.preintegrate_continuous(*(jnp.asarray(x) for x in (ts, g, a, m)), 0.4, 0.8,
                                   n_grid=64, method=method, bias_gyro=jnp.asarray(bg),
                                   bias_accel=jnp.asarray(ba))
    p = PC.preintegrate_continuous(*(_t(x) for x in (ts, g, a, m)), 0.4, 0.8, n_grid=64,
                                   method=method, bias_gyro=_t(bg), bias_accel=_t(ba))
    if method == "lpm":
        _check_integral(p, j)
    else:
        _check_integral(p, j, atol=1e-4, cov_rtol=1e-3)


def test_interp_masked():
    ts, g, _, m = _smooth()
    grid = np.linspace(0.3, 0.9, 50).astype(np.float32)
    np.testing.assert_allclose(
        PC.interp_masked(_t(ts), _t(g), _t(m), _t(grid)).numpy(),
        np.asarray(JC.interp_masked(*(jnp.asarray(x) for x in (ts, g, m, grid)))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("channel,noise_density", [(1, 1.6e-4), (2, 2.8e-3)])
def test_gp_posterior_mean(channel, noise_density):
    """At the hyperparameters ``ugpm`` picks for this input: the port within
    1.5x of the reference's distance to the float64 posterior mean."""
    ts, *chans, m = _smooth()
    x = chans[channel - 1]
    n, span = m.sum(), ts[m].max() - ts[m].min()
    hyper = np.float32([3 * span / n, max(np.where(m[:, None], x, 0).std(), 1e-3),
                        noise_density * np.sqrt(n / span)])
    grid = (0.4 + (np.arange(64) + 0.5) * 0.4 / 64).astype(np.float32)
    j = np.asarray(JC.gp_posterior_mean(*(jnp.asarray(v) for v in (ts, x, m, grid, *hyper))))
    p = PC.gp_posterior_mean(*(_t(v) for v in (ts, x, m, grid, *hyper))).numpy()
    exact = PC.gp_posterior_mean(*(_t(np.float64(v)) for v in (ts, x)), _t(m),
                                 *(_t(np.float64(v)) for v in (grid, *hyper))).numpy()
    assert np.abs(p - exact).max() <= 1.5 * np.abs(j - exact).max()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-3 * np.abs(exact).max())


def test_overlap_window_mask():
    ts = np.linspace(-10.0, 10.0, 201, dtype=np.float32)
    m = np.random.default_rng(0).random(201) < 0.8
    j = JC.overlap_window_mask(jnp.asarray(ts), jnp.asarray(m), 0.0, 0.5, overlap_factor=8.0)
    p = PC.overlap_window_mask(_t(ts), _t(m), 0.0, 0.5, overlap_factor=8.0)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("n_samples,capacity,gate", [
    (11, 64, False),   # odd count
    (12, 64, False),   # even count: the two middle values are averaged
    (23, 16, False),   # a wrapped ring
    (12, 64, True),    # every other sample fails the 6-15 m/s² gate
])
def test_gravity(n_samples, capacity, gate):
    rng = np.random.default_rng(n_samples + capacity)
    je, pe = JG.gravity_init(capacity), PG.gravity_init(capacity)
    for i in range(n_samples):
        p0, p1, p2 = (rng.normal(0, 1e-4, 3).astype(np.float32) for _ in range(3))
        dt01, dt12 = (np.float32(0.05 * rng.uniform(0.8, 1.2)) for _ in range(2))
        R = np.asarray(so3_exp(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32)))
        f = (R.T @ np.float32([0, 9.81, 0]) + rng.normal(0, 0.3, 3)).astype(np.float32)
        if gate and i % 2:
            f = f * np.float32(0.2)
        je = JG.gravity_add_sample(je, *(jnp.asarray(x) for x in (p0, p1, p2, dt01, dt12, R, f)))
        pe = PG.gravity_add_sample(pe, *(_t(x) for x in (p0, p1, p2, dt01, dt12, R, f)))
        np.testing.assert_allclose(pe.samples.numpy(), np.asarray(je.samples), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pe.valid.numpy(), np.asarray(je.valid))
        assert int(pe.next_slot) == int(je.next_slot)
        (gj, okj), (gp, okp) = JG.gravity_estimate(je), PG.gravity_estimate(pe)
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
        assert bool(okp) == bool(okj)
    assert bool(okp) == (not gate)


def test_predictors():
    rng = np.random.default_rng(2)
    g, a, d, m, bg, ba = _imu_batch(5)
    j_it = jpre(*(jnp.asarray(x) for x in (g, a, d, m)))
    p_it = preintegrate(*(_t(x) for x in (g, a, d, m)))
    R_cw = np.asarray(so3_exp(jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)))
    R_ci = np.asarray(so3_exp(jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32)))
    t_cw, t_ci, v, grav = (rng.normal(0, 1, 3).astype(np.float32) for _ in range(4))
    jR, jt = JPred.inertial_predict_pose(*(jnp.asarray(x) for x in (R_cw, t_cw, v, grav)),
                                         j_it, jnp.asarray(R_ci), jnp.asarray(t_ci))
    pR, pt = PPred.inertial_predict_pose(*(_t(x) for x in (R_cw, t_cw, v, grav)), p_it,
                                         _t(R_ci), _t(t_ci))
    np.testing.assert_allclose(pR.numpy(), np.asarray(jR), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    jv = JPred.propagate_velocity(jnp.asarray(v), jnp.asarray(grav), jnp.asarray(R_cw), j_it)
    pv = PPred.propagate_velocity(_t(v), _t(grav), _t(R_cw), p_it)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_make_imu_bit_identical():
    def pose_fn(t):
        w = np.array([0.1 * np.sin(t), 0.3 * t + 0.1, 0.05])
        th = np.linalg.norm(w)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0.0]])
        R_wc = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        c = np.array([0.4 * t, 0.1 * np.sin(2 * t), 0.2 * t * t])
        return R_wc.T, -R_wc.T @ c

    ts = np.arange(5, dtype=np.float64) * 0.05
    for noisy in (False, True):
        kw = [dict(rng=np.random.default_rng(3), gyro_noise=0.01, accel_noise=0.1)
              if noisy else {} for _ in range(2)]
        j = jsyn.make_imu(pose_fn, ts, 7, **kw[0])
        p = psyn.make_imu(pose_fn, ts, 7, **kw[1])
        for x, y in zip(p, j):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for R in (np.eye(3), np.asarray(so3_exp(jnp.asarray([0.3, -0.2, 0.1])), np.float64)):
        np.testing.assert_array_equal(psyn._np_so3_log(R), jsyn._np_so3_log(R))


def test_make_sequence_with_imu_bit_identical():
    kw = dict(n_frames=3, width=96, height=64, motion="arc", with_imu=True,
              imu_samples_per_frame=6, pixel_noise=0.01)
    j = jsyn.make_sequence(np.random.default_rng(11), **kw)
    p = psyn.make_sequence(np.random.default_rng(11), device="cpu", **kw)
    for f in ("gyro", "accel", "imu_dts", "imu_mask", "gravity_w", "R_lw", "t_lw"):
        assert getattr(p, f).dtype == getattr(j, f).dtype, f
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    np.testing.assert_array_equal(p.left, j.left.astype(np.float32))


def test_distorted_sequence_imu_in_camchain_frame():
    """make_distorted_sequence's IMU lies in the frame the camchain's
    T_cam_imu places (EuRoC's: about 90 degrees and 6.5 cm from cam0): on the
    strafe at constant orientation the gyro reads 0 and the accelerometer
    R_ic R_cw (a_w - g_w) = -R_ic R_cw g_w, within 1e-3 m/s²."""
    from pathlib import Path

    from zenslam_tpu_torch.io.calibration import load_kalibr_yaml

    camchain = Path(__file__).resolve().parents[1] / "options" / "euroc_camchain.yaml"
    rig, models = load_kalibr_yaml(str(camchain), device="cpu")
    seq = psyn.make_distorted_sequence(np.random.default_rng(9), rig, models, n_frames=3,
                                       motion="strafe", dt=0.05, speed=0.5, with_imu=True)
    R_ic = rig.R_ci.double().numpy().T
    assert np.abs(R_ic - np.eye(3)).max() > 0.5
    m = seq.imu_mask
    assert m[1:].all() and not m[0].any()
    np.testing.assert_array_equal(seq.gyro, 0.0)
    f = -R_ic @ seq.R_lw[0].astype(np.float64) @ seq.gravity_w.astype(np.float64)
    np.testing.assert_allclose(seq.accel[m], np.broadcast_to(f, seq.accel[m].shape), rtol=0,
                               atol=1e-3)


# ---- pose fusion: the four cases of tests/test_estimation.py::TestFusion ----

def _fusion_cases():
    R_good = np.asarray(so3_exp(jnp.asarray([0.0, 0.0, 0.1], jnp.float32)))
    R_bad = np.asarray(so3_exp(jnp.asarray([0.5, 0.5, 0.0], jnp.float32)))
    eye, nan = np.eye(3, dtype=np.float32), np.float32(np.nan)
    f32 = np.float32
    return {
        "tracks_best": (dict(R=np.stack([R_good, R_bad]), t=f32([[1, 0, 0], [5, 5, 5]]),
                             inlier_ratio=f32([0.9, 0.1]), mean_err=f32([0.5, 10.0]),
                             n_inliers=np.int32([80, 5]), is_line=np.array([False, False]),
                             valid=np.array([True, True])), None),
        "invalid_ignored": (dict(R=np.stack([eye] * 2), t=f32([[0, 0, 0], [9, 9, 9]]),
                                 inlier_ratio=f32([0.5, 0.99]), mean_err=f32([1.0, 0.01]),
                                 n_inliers=np.int32([50, 100]), is_line=np.array([False, True]),
                                 valid=np.array([True, False])), None),
        "nan_invalid": (dict(R=np.stack([eye, np.full((3, 3), nan)]),
                             t=np.stack([np.ones(3, f32), np.full(3, nan)]),
                             inlier_ratio=f32([0.9, 0.0]), mean_err=f32([0.5, nan]),
                             n_inliers=np.int32([80, 0]), is_line=np.array([False, False]),
                             valid=np.array([True, False])), None),
        "mixed_scales": (dict(R=np.stack([eye] * 2), t=f32([[1, 0, 0], [1.3, 0, 0]]),
                              inlier_ratio=f32([0.8, 0.8]), mean_err=f32([1.0, 0.05]),
                              n_inliers=np.int32([60, 60]), is_line=np.array([False, False]),
                              valid=np.array([True, True])), f32([3.0, 0.1])),
    }


@pytest.mark.parametrize("case", list(_fusion_cases()))
def test_fuse_poses(case):
    fields, scale = _fusion_cases()[case]
    for err_scale in ((2.0,) if scale is None else (2.0, scale)):
        j = jfuse(JCand(**{k: jnp.asarray(v) for k, v in fields.items()}),
                  err_scale=jnp.asarray(err_scale))
        p = fuse_poses(PoseCandidate(**{k: _t(v) for k, v in fields.items()}),
                       err_scale=err_scale if np.isscalar(err_scale) else _t(err_scale))
        for a, b in zip(p[:4], j[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        assert int(p[4]) == int(j[4])
        assert np.isfinite(p[1].numpy()).all()


# ---- the fused cascade (tests/test_torch_estimation.py's scene) ----------

N, ITERS = 96, 64


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    rig = jsyn.default_rig(320, 256)
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(2, 6, (N, 1))],
                       axis=1).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)))
    t = np.array([0.05, -0.02, 0.1], np.float32)
    xc = np.asarray(se3_apply(R, t, jnp.asarray(X)))
    uv = np.asarray(project(rig.left, jnp.asarray(xc))) + rng.normal(0, 0.3, (N, 2))
    out = rng.random(N) < 0.2
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    valid = rng.random(N) < 0.9
    uv1 = np.asarray(project(rig.right, se3_apply(rig.R_rl, rig.t_rl, jnp.asarray(xc))))
    valid1 = valid & (rng.random(N) < 0.8)
    src3d = X + rng.normal(0, 0.01, X.shape).astype(np.float32)
    valid3d = valid & (rng.random(N) < 0.7)
    pa = np.asarray(project(rig.left, jnp.asarray(X)))
    return dict(rig=rig, args=(X, uv.astype(np.float32), valid, X, uv1, valid1, src3d, X,
                               valid3d, np.eye(3, dtype=np.float32), t * 0.9),
                ess=dict(p2a=pa, p2b=uv.astype(np.float32), valid2=valid, X2_prev_cam=X,
                         has3d2=valid, R_prev=np.eye(3, dtype=np.float32),
                         t_prev=np.zeros(3, np.float32)))


@pytest.mark.parametrize("sigma,stereo", [(None, True), (None, False), (0.002, True),
                                          (0.5, False)])
def test_fused_cascade(scene, sigma, stereo):
    """With pred_sigma_p the prediction joins as a fifth candidate (0.002 m:
    it weighs in; 0.5 m: it barely does). Without stereo PnP cam0 fails, so
    the fusion's other members decide."""
    args = list(scene["args"])
    if not stereo:
        args[2] = np.zeros(N, bool)
    key = jax.random.PRNGKey(6)
    j = JCas.estimate_pose_cascade(
        key, scene["rig"], *(jnp.asarray(x) for x in args), pnp_iters=ITERS,
        rigid_iters=ITERS, essential_iters=ITERS, fuse=True,
        pred_sigma_p=None if sigma is None else jnp.float32(sigma),
        **{k: jnp.asarray(v) for k, v in scene["ess"].items()})
    k0, k1, k2 = jax.random.split(key, 3)

    def g(k):
        return torch.from_numpy(np.array(jax.random.gumbel(k, (ITERS, N))))

    noise = PCas.CascadeNoise(g(k0), g(k1), g(k2), g(jax.random.fold_in(key, 3)))
    prig = convert.rig_from_numpy(jax.tree.map(np.asarray, scene["rig"]), "cpu")
    p = PCas.estimate_pose_cascade(
        noise, prig, *(_t(x) for x in args), fuse=True,
        pred_sigma_p=None if sigma is None else torch.tensor(sigma, dtype=torch.float32),
        **{k: _t(v) for k, v in scene["ess"].items()})
    np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), rtol=0, atol=1e-4)
    assert (int(p.method), int(p.n_inliers), bool(p.ok)) == \
        (int(j.method), int(j.n_inliers), bool(j.ok))
    np.testing.assert_allclose(float(p.mean_err), float(j.mean_err), rtol=0, atol=1e-4)
