"""The port's VIO branch (zenslam_tpu_torch.pipeline.slam_step and
process_frame with ``imu=``) against the JAX reference on the CPU, on the
12-frame 320x240 'arc' with IMU (seed 11, 10 samples a frame, f32 gather
tracker, the reference's own RANSAC draws).

Both ``slam_step`` tests run from the reference's states of one run that
starts with gravity known, so the inertial prediction drives tracking from
frame 2 on (the unknown-gravity start runs in ``process_frame`` below).

- teacher-forced ``slam_step``: each frame starts both from the reference's
  state (VioState included) and draws. ``n_tracked``, ``gravity_ok`` and the
  gravity ring's count are equal on every frame, ``gravity_w`` within 1e-4.
  Pose within 1e-4 m on at least 8 of the 12 frames and within 3 mm on all:
  on the others PnP's 6-point DLT hypotheses (near-degenerate samples) differ
  between the two float implementations (scripts/torch_cpu_paths.py
  arc-parity measures them), the RANSAC
  winner's inlier mask differs, and the Huber polish converges to another
  minimum, as it does without IMU (a standing divergence, ROADMAP.md Queue
  3). ``v_world`` (a VO pose difference over the frame's IMU interval)
  within 1e-4 on the frames whose pose agrees to 1e-5, at least 6 of the
  12, and on the others within the body-position gap over that interval
  plus 1e-4;
- the VIO branch given the reference's pose: the same, with the cascade's
  output replaced by the reference's: pose, ``v_world``, ``gravity_w``,
  the ring and the 3-pose history within 1e-4 and every count equal on
  every frame;
- ``process_frame`` with IMU over the same frames (BA and loops off as
  tests/test_system.py::TestSystemVio), teacher-forced from the reference's
  converted system: n_tracked, keyframe decisions, pose_ok, keyframe count
  and the VIO ring and history counts equal every frame, poses and
  ``v_world`` as for ``slam_step``. (A free run cannot be held to 2 mm here: the PnP
  divergence's millimetres compound from frame 2 on.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.pipeline import SlamConfig as JaxConfig
from zenslam_tpu.pipeline import init_state as jax_init_state
from zenslam_tpu.pipeline.step import slam_step as jax_slam_step
from zenslam_tpu.pipeline import system as jsystem
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation.cascade import PoseEstimate
from zenslam_tpu_torch.pipeline import step as pstep
from zenslam_tpu_torch.pipeline import system as psystem

from test_torch_slice import _img, _reference_noise
from test_torch_system import _numpy_system

torch.set_num_threads(2)
H, W, T = 240, 320, 12
CFG = dict(max_keypoints=128, max_landmarks=1024, pnp_iters=64, rigid_iters=64,
           essential_iters=64)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=T, width=W, height=H,
                         motion="arc", with_imu=True)


@pytest.fixture(scope="module")
def jcfg():
    return JaxConfig(use_pallas_lk=False, **CFG)


@pytest.fixture(scope="module")
def prig(seq):
    return convert.rig_from_numpy(jax.tree.map(np.asarray, seq.rig), "cpu")


def _imu(seq, t, torch_=False):
    x = (seq.gyro[t], seq.accel[t], seq.imu_dts[t], seq.imu_mask[t])
    return tuple(torch.from_numpy(a) for a in x) if torch_ else x


@pytest.fixture(scope="module")
def reference(seq, jcfg):
    """The reference's states before each frame (numpy) and telemetry, from
    a state whose gravity is already known, so the inertial prediction
    drives tracking from frame 2 on."""
    state = jax_init_state(jcfg, (H, W))
    state = state._replace(vio=state.vio._replace(
        gravity_w=jnp.asarray(seq.gravity_w), gravity_ok=jnp.asarray(True)))
    states, tels = [], []
    for t in range(T):
        states.append(jax.tree.map(np.asarray, state))
        state, tel = jax_slam_step(jcfg, seq.rig, state, jnp.asarray(seq.left[t]),
                                   jnp.asarray(seq.right[t]), imu=_imu(seq, t))
        tels.append(jax.tree.map(np.asarray, tel))
    states.append(jax.tree.map(np.asarray, state))
    return states, tels


def _step(seq, jcfg, prig, states, t):
    pcfg = convert.config_from_dict(jcfg._asdict())
    ps = convert.state_from_numpy(states[t], "cpu", image_shape=(H, W))
    return pstep.slam_step(pcfg, prig, ps, _img(seq.left[t]), _img(seq.right[t]),
                           noise=_reference_noise(jcfg, jnp.asarray(states[t].rng_key)),
                           imu=_imu(seq, t, torch_=True))


def _pose_gap(R, t, jR, jt):
    """Largest elementwise gap of the pose (R and t) to the reference's."""
    return max(np.abs(np.asarray(R) - jR).max(), np.abs(np.asarray(t) - jt).max())


def _check_v_world(prig, seq, t, R, tr, jR, jt, v, jv):
    """``v_world`` within 1e-4 where the pose agrees to 1e-5; elsewhere
    within the body-position gap over the frame's IMU interval plus 1e-4
    (the VO velocity is that difference; both start from the same previous
    position). Returns whether the strict comparison ran."""
    d = _pose_gap(R, tr, jR, jt)
    if d < 1e-5:
        atol = 1e-4
    else:
        _, p = pstep._body_pose_world(prig, torch.as_tensor(np.array(R)),
                                      torch.as_tensor(np.array(tr)))
        _, jp = pstep._body_pose_world(prig, torch.from_numpy(np.array(jR)),
                                       torch.from_numpy(np.array(jt)))
        dt = float(np.sum(np.where(seq.imu_mask[t], seq.imu_dts[t], 0.0)))
        atol = float((p - jp).abs().max()) / max(dt, 1e-6) + 1e-4
    np.testing.assert_allclose(np.asarray(v), jv, rtol=0, atol=atol, err_msg=f"frame {t}")
    return d < 1e-5


def _vio_close(new, js, atol=1e-4):
    v, jv = new.vio, js.vio
    for f in ("gravity_w", "hist_p", "hist_R_wb", "hist_dt", "hist_f", "grav_samples"):
        np.testing.assert_allclose(getattr(v, f).numpy(), getattr(jv, f), rtol=0, atol=atol,
                                   err_msg=f)
    for f in ("gravity_ok", "grav_valid", "grav_next", "hist_n"):
        np.testing.assert_array_equal(getattr(v, f).numpy(), getattr(jv, f), err_msg=f)


def test_slam_step_teacher_forced_with_imu(seq, jcfg, prig, reference):
    states, tels = reference
    close, strict_v = [], []
    for t in range(T):
        new, tel = _step(seq, jcfg, prig, states, t)
        jt, js = tels[t], states[t + 1]
        assert int(tel.n_tracked) == int(jt.n_tracked), t
        assert bool(new.vio.gravity_ok) == bool(js.vio.gravity_ok), t
        assert int(new.vio.grav_valid.sum()) == int(js.vio.grav_valid.sum()), t
        np.testing.assert_allclose(new.vio.gravity_w.numpy(), js.vio.gravity_w, atol=1e-4)
        d = _pose_gap(tel.R_cw, tel.t_cw, jt.R_cw, jt.t_cw)
        assert d < 3e-3, (t, d)
        close.append(d < 1e-4)
        strict_v.append(_check_v_world(prig, seq, t, tel.R_cw, tel.t_cw, jt.R_cw, jt.t_cw,
                                       new.vio.v_world, js.vio.v_world))
    assert sum(close) >= 8, close
    assert sum(strict_v) >= 6, strict_v


def test_vio_branch_given_the_reference_pose(seq, jcfg, prig, reference, monkeypatch):
    states, tels = reference
    for t in range(T):
        jt, js = tels[t], states[t + 1]

        def forced(*args, **kwargs):
            N = jcfg.max_keypoints
            return PoseEstimate(
                R=torch.from_numpy(np.array(jt.R_cw)), t=torch.from_numpy(np.array(jt.t_cw)),
                ok=torch.tensor(bool(jt.pose_ok)), n_inliers=torch.tensor(int(jt.n_pose_inliers)),
                mean_err=torch.tensor(0.0), method=torch.tensor(int(jt.pose_method)),
                inliers0=torch.zeros(N, dtype=torch.bool))

        monkeypatch.setattr(pstep, "estimate_pose_cascade", forced)
        new, tel = _step(seq, jcfg, prig, states, t)
        for f in ("n_tracked", "n_detected", "n_stereo", "n_triangulated", "is_keyframe",
                  "map_size"):
            assert int(getattr(tel, f)) == int(getattr(jt, f)), (t, f)
        np.testing.assert_allclose(new.vio.v_world.numpy(), js.vio.v_world, rtol=0, atol=1e-4,
                                   err_msg=f"frame {t}")
        _vio_close(new, js)
    assert bool(states[-1].vio.gravity_ok) and int(states[-1].vio.hist_n) == 3


def test_process_frame_with_imu(seq, jcfg, prig):
    """Teacher-forced through the system: each frame the reference's system
    (converted) and draws go into the port's process_frame."""
    jb = jsystem.BackendConfig(ba_every_kf=False, enable_loop_closure=False)
    js = jsystem.create_system(jcfg, jb, seq.rig, (H, W))
    close, strict_v = [], []
    for t in range(T):
        ps = convert.system_from_numpy(_numpy_system(js), "cpu", image_shape=(H, W))
        noise = _reference_noise(jcfg, jnp.asarray(np.array(js.state.rng_key)))
        ptel, _ = psystem.process_frame(ps, _img(seq.left[t]), _img(seq.right[t]),
                                        imu=_imu(seq, t), noise=noise)
        jtel, _ = jsystem.process_frame(js, jnp.asarray(seq.left[t]), jnp.asarray(seq.right[t]),
                                        imu=tuple(jnp.asarray(x) for x in _imu(seq, t)))
        for f in ("n_tracked", "is_keyframe", "pose_ok"):
            assert int(getattr(ptel, f)) == int(getattr(jtel, f)), (t, f)
        assert ps.n_keyframes == js.n_keyframes, t
        v, jv = ps.state.vio, js.state.vio
        assert int(v.grav_valid.sum()) == int(np.asarray(jv.grav_valid).sum()), t
        assert int(v.hist_n) == int(jv.hist_n) and bool(v.gravity_ok) == bool(jv.gravity_ok)
        jR, jt = np.asarray(jtel.R_cw), np.asarray(jtel.t_cw)
        d = _pose_gap(ptel.R_cw, ptel.t_cw, jR, jt)
        assert d < 3e-3, (t, d)
        close.append(d < 1e-4)
        strict_v.append(_check_v_world(prig, seq, t, ptel.R_cw, ptel.t_cw, jR, jt,
                                       v.v_world, np.asarray(jv.v_world)))
    assert sum(close) >= 8, close
    assert sum(strict_v) >= 6, strict_v
    assert js.n_keyframes >= 2
