"""The port's full system with IMU on the CPU held to the reference's
tests/test_system.py::TestSystemVio assertions, on its 16-frame 512x384
'arc' with IMU (seed 11) rendered by the port, with the port's own random
draws: ``run_system`` with IMU (BA and loops off) keeps pose_ok after frame
0, ATE < 0.02 m, observes gravity within 0.5 m/s² of the truth, and its ATE
is no worse than 1.2x the vision-only run's + 0.1 mm.
"""

import numpy as np
import torch

from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

from test_torch_vio_free import CFG, _ate, _imu

torch.set_num_threads(2)


def test_system_with_imu_not_worse_than_vision_only():
    seq = make_sequence(np.random.default_rng(11), n_frames=16, motion="arc", with_imu=True,
                        device="cpu")
    bcfg = BackendConfig(ba_every_kf=False, enable_loop_closure=False)
    shape = tuple(seq.left[0].shape)
    sys_v = create_system(CFG, bcfg, seq.rig, shape, device="cpu")
    tel_v, _ = run_system(sys_v, seq.left, seq.right, imu=_imu(seq))
    assert tel_v.pose_ok[1:].all()
    assert _ate(tel_v, seq) < 0.02
    assert bool(sys_v.state.vio.gravity_ok)
    assert np.linalg.norm(sys_v.state.vio.gravity_w.numpy() - seq.gravity_w) < 0.5
    sys_o = create_system(CFG, bcfg, seq.rig, shape, device="cpu")
    tel_o, _ = run_system(sys_o, seq.left, seq.right)
    assert _ate(tel_v, seq) <= _ate(tel_o, seq) * 1.2 + 1e-4
