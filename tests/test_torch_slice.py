"""The port's per-frame step (zenslam_tpu_torch.pipeline.slam_step) against
the JAX reference's slam_step on the CPU (use_pallas_lk=False, the f32
fallback tracker), on a rendered 'strafe' sequence, plus the port's guards.

- teacher-forced: each frame starts both from the reference's state_t
  (converted), with the reference's own RANSAC draws; pose within 1e-4,
  telemetry counts equal, valid/lm_idx agreeing on >= 99% of slots,
  descriptors identical on >= 99% of rows;
- free-running: port ATE < 0.02 m and within 2 mm of the reference's;
- kernel path on the CPU (use_pallas_lk=True: the kernels' plain versions):
  pose_ok on every frame after the first, ATE < 0.02 m.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.eval.metrics import ate_rmse, camera_positions
from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.pipeline import SlamConfig as JaxConfig
from zenslam_tpu.pipeline import init_state as jax_init_state
from zenslam_tpu.pipeline.step import slam_step as jax_slam_step
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation.cascade import CascadeNoise
from zenslam_tpu_torch.io import synthetic as port_synthetic
from zenslam_tpu_torch.pipeline import SlamConfig, init_state, slam_step

torch.set_num_threads(2)
H, W, T = 256, 320, 8
CFG = dict(max_keypoints=128, max_landmarks=1024, pnp_iters=64, rigid_iters=64,
           essential_iters=64)
COUNTS = ("n_tracked", "n_detected", "n_stereo", "n_triangulated", "n_pose_inliers",
          "pose_method", "pose_ok", "is_keyframe", "map_size")


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=T, width=W, height=H,
                         motion="strafe")


@pytest.fixture(scope="module")
def jcfg():
    return JaxConfig(use_pallas_lk=False, **CFG)


@pytest.fixture(scope="module")
def prig(seq):
    return convert.rig_from_numpy(jax.tree.map(np.asarray, seq.rig), "cpu")


def _img(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _reference_noise(jcfg, key):
    """The reference's RANSAC draws for one frame: slam_step splits the state
    key, the cascade splits k_est into three and folds in 3."""
    _, k_est = jax.random.split(key)
    k0, k1, k2 = jax.random.split(k_est, 3)
    n = jcfg.max_keypoints

    def g(k, iters):
        return torch.from_numpy(np.array(jax.random.gumbel(k, (iters, n))))

    return CascadeNoise(g(k0, jcfg.pnp_iters), g(k1, jcfg.pnp_iters),
                        g(k2, jcfg.rigid_iters),
                        g(jax.random.fold_in(k_est, 3), jcfg.essential_iters))


def _positions(Rs, ts):
    return camera_positions(np.stack(Rs), np.stack(ts))


@pytest.fixture(scope="module")
def reference_run(seq, jcfg):
    """The reference's states before each frame (numpy) and its telemetry."""
    state = jax_init_state(jcfg, (H, W))
    states, tels = [], []
    for t in range(T):
        states.append(jax.tree.map(np.asarray, state))
        state, tel = jax_slam_step(jcfg, seq.rig, state, jnp.asarray(seq.left[t]),
                                   jnp.asarray(seq.right[t]))
        tels.append(jax.tree.map(np.asarray, tel))
    states.append(jax.tree.map(np.asarray, state))
    return states, tels


def test_port_renders_the_reference_sequence(seq):
    mine = port_synthetic.make_sequence(np.random.default_rng(11), n_frames=2, width=W,
                                        height=H, motion="strafe", device="cpu")
    np.testing.assert_array_equal(mine.left, seq.left[:2].astype(np.float32))
    np.testing.assert_array_equal(mine.right, seq.right[:2].astype(np.float32))
    np.testing.assert_array_equal(mine.t_lw, seq.t_lw[:2])


def test_teacher_forced(seq, jcfg, prig, reference_run):
    states, tels = reference_run
    pcfg = convert.config_from_dict(jcfg._asdict())
    for t in range(T):
        ps = convert.state_from_numpy(states[t], "cpu", image_shape=(H, W))
        new, tel = slam_step(pcfg, prig, ps, _img(seq.left[t]), _img(seq.right[t]),
                             noise=_reference_noise(jcfg, jnp.asarray(states[t].rng_key)))
        jt, js = tels[t], states[t + 1]
        np.testing.assert_allclose(tel.R_cw.numpy(), jt.R_cw, atol=1e-4, err_msg=f"frame {t}")
        np.testing.assert_allclose(tel.t_cw.numpy(), jt.t_cw, atol=1e-4, err_msg=f"frame {t}")
        for name in COUNTS:
            assert int(getattr(tel, name)) == int(getattr(jt, name)), (t, name)
        out = convert.state_to_numpy(new)
        f, jf = out.features, js.features
        assert (f.valid == jf.valid).mean() >= 0.99
        assert (f.lm_idx == jf.lm_idx).mean() >= 0.99
        assert (f.desc == jf.desc).all(-1).mean() >= 0.99
        assert (out.lmap.valid == js.lmap.valid).mean() >= 0.99


def test_free_running(seq, jcfg, prig, reference_run):
    _, tels = reference_run
    pcfg = convert.config_from_dict(jcfg._asdict())
    state = init_state(pcfg, (H, W), device="cpu")
    Rs, ts = [], []
    for t in range(T):
        state, tel = slam_step(pcfg, prig, state, _img(seq.left[t]), _img(seq.right[t]))
        Rs.append(tel.R_cw.numpy())
        ts.append(tel.t_cw.numpy())
    gt = camera_positions(seq.R_lw, seq.t_lw)
    ate_port = ate_rmse(_positions(Rs, ts), gt)
    ate_ref = ate_rmse(_positions([x.R_cw for x in tels], [x.t_cw for x in tels]), gt)
    assert ate_port < 0.02
    assert abs(ate_port - ate_ref) < 2e-3


def test_kernel_path_on_cpu(seq, prig):
    cfg = SlamConfig(use_pallas_lk=True, **CFG)
    state = init_state(cfg, (H, W), seed=3, device="cpu")
    assert state.prev_pyr_l[0].dtype == torch.bfloat16
    Rs, ts, ok = [], [], []
    for t in range(T):
        state, tel = slam_step(cfg, prig, state, _img(seq.left[t]), _img(seq.right[t]))
        Rs.append(tel.R_cw.numpy())
        ts.append(tel.t_cw.numpy())
        ok.append(bool(tel.pose_ok))
    assert all(ok[1:])
    assert ate_rmse(_positions(Rs, ts), camera_positions(seq.R_lw, seq.t_lw)) < 0.02


def test_convert_round_trip(reference_run):
    states, _ = reference_run
    ps = convert.state_from_numpy(states[3], "cpu", image_shape=(H, W), seed=5)
    back = convert.state_to_numpy(ps)
    np.testing.assert_array_equal(back.features.desc, states[3].features.desc)
    np.testing.assert_array_equal(back.lmap.xyz, states[3].lmap.xyz)
    again = convert.state_from_numpy(back, "cpu")
    for a, b in zip(jax.tree.leaves(ps), jax.tree.leaves(again)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    bf = convert.state_from_numpy(back, "cpu", pyramid_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.prev_pyr_l)


@pytest.mark.parametrize("field,value", [
    ("use_keylines", True), ("descriptor", "sift"),
    ("detector", "harris"), ("describe_refresh", 4), ("use_pose_fusion", True)])
def test_unported_config_raises(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_state(SlamConfig(**{field: value}), (64, 64), device="cpu")


def test_imu_input_raises(seq, prig):
    cfg = SlamConfig(**CFG)
    state = init_state(cfg, (H, W), device="cpu")
    with pytest.raises(NotImplementedError, match="IMU"):
        slam_step(cfg, prig, state, _img(seq.left[0]), _img(seq.right[0]),
                  imu=(torch.zeros(10, 3),) * 2 + (torch.zeros(10), torch.ones(10, dtype=torch.bool)))


def test_init_state_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(SlamConfig(), (64, 64))
    assert init_state(SlamConfig(), (64, 64), device="cpu").R_cw.device.type == "cpu"


def test_config_converts_with_same_fields(jcfg):
    assert SlamConfig._fields == JaxConfig._fields
    assert SlamConfig() == convert.config_from_dict(JaxConfig()._asdict())


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['zenslam_tpu'] = None\n"
        "import zenslam_tpu_torch, zenslam_tpu_torch.convert\n"
        "import zenslam_tpu_torch.pipeline.step, zenslam_tpu_torch.io.synthetic\n"
        "import zenslam_tpu_torch.eval.metrics, zenslam_tpu_torch.ops.lk_cuda\n"
        "import zenslam_tpu_torch.ops.orb_cuda\n"
        "new = [m for m in set(sys.modules) - before if sys.modules[m] is not None]\n"
        "assert not [m for m in new if m.split('.')[0] in ('jax', 'zenslam_tpu')]\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
