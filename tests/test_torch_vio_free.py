"""The port's own free VIO runs on the CPU held to the reference's
assertions: tests/test_vio.py::TestVioPipeline and TestImuBackendSelection,
on the same 16-frame 512x384 'arc' with IMU (seed 11) rendered by the port,
with the port's own random draws (tests/test_torch_vio_system.py holds
tests/test_system.py::TestSystemVio's).

- ``run_sequence`` with IMU: pose_ok after frame 0, ATE < 0.02 m, gravity
  observed and within 0.5 m/s² of the truth, the last velocity within 0.1
  m/s of the groundtruth's; the 'scan' mode (whole sequence and IMU copied
  first) gives the 'stream' mode's telemetry bit for bit (first 4 frames);
- ``imu_method`` 'lpm' and 'ugpm' on the first 8 frames: ATE < 0.05 m,
  pose_ok from frame 2.
"""

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline import SlamConfig, run_sequence

torch.set_num_threads(2)
CFG = SlamConfig(max_keypoints=256, max_landmarks=2048, pnp_iters=128, rigid_iters=128)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=16, motion="arc", with_imu=True,
                         device="cpu")


def _imu(seq, n=None):
    return tuple(x[:n] for x in (seq.gyro, seq.accel, seq.imu_dts, seq.imu_mask))


def _ate(tel, seq):
    n = len(tel.R_cw)
    return ate_rmse(camera_positions(tel.R_cw, tel.t_cw),
                    camera_positions(seq.R_lw[:n], seq.t_lw[:n]))


@pytest.fixture(scope="module")
def run(seq):
    return run_sequence(CFG, seq.rig, seq.left, seq.right, imu=_imu(seq), mode="scan",
                        device="cpu")


def test_tracks_gravity_and_velocity(run, seq):
    state, tel = run
    assert tel.pose_ok[1:].all()
    assert _ate(tel, seq) < 0.02
    assert bool(state.vio.gravity_ok)
    assert np.linalg.norm(state.vio.gravity_w.numpy() - seq.gravity_w) < 0.5
    dt = float(seq.timestamps[1] - seq.timestamps[0])
    P = camera_positions(seq.R_lw, seq.t_lw)
    assert np.linalg.norm(state.vio.v_world.numpy() - (P[-1] - P[-2]) / dt) < 0.1


def test_stream_mode_matches_scan(run, seq):
    _, tel_scan = run
    _, tel = run_sequence(CFG, seq.rig, seq.left[:4], seq.right[:4], imu=_imu(seq, 4),
                          device="cpu")
    for a, b in zip(tel, tel_scan):
        np.testing.assert_array_equal(a, b[:4])


@pytest.mark.parametrize("method", ["lpm", "ugpm"])
def test_continuous_backends_track(seq, method):
    _, tel = run_sequence(CFG._replace(imu_method=method), seq.rig, seq.left[:8],
                          seq.right[:8], imu=_imu(seq, 8), device="cpu")
    assert _ate(tel, seq) < 0.05
    assert tel.pose_ok[2:].all()
