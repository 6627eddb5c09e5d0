"""The port's loop closure on the CPU, on the workload of
tests/test_loop_closure.py::TestLoopClosure: its CFG and BackendConfigs and
the 64-frame 320x240 orbit (seed 21, pixel noise 0.01, radius 1.0). It
asserts what that test asserts: the loop fires at or after frame 48
anchored to a keyframe at or before frame 9 with >= 30 PnP inliers, no
mid-orbit candidate reaches 12 inliers, and the loop cuts keyframe ATE
below 0.75 of the no-loop run.

One run serves both sides. With BA off and no relocalisation, the back end
changes no pose until its first pose graph, so the keyframe database just
before that graph runs is the no-loop run's (bit-identical to a run with
``enable_loop_closure=False`` on this workload: 22 keyframes, same poses);
the test checks that no reloc fired and that the loop came at the last
keyframe, so the two sides hold the same keyframes.

The orbit is rendered by the port's f32 renderer (``device_render`` on the
CPU), which equals the reference's float64 host render to f32 rounding
(tests/test_torch_system.py::test_port_renders_the_reference_orbit) and
takes a fraction of its time.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline.state import SlamConfig
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

torch.set_num_threads(2)
CFG = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                 kf_min_translation=0.05)


def _kf_ate(s, seq):
    """Unaligned RMSE of keyframe camera centres against groundtruth."""
    fi, v = s.kf_db.frame_idx.numpy(), s.kf_db.valid.numpy()
    R, t = s.kf_db.R.numpy()[v], s.kf_db.t.numpy()[v]
    est = np.einsum("kij,kj->ki", np.transpose(R, (0, 2, 1)), -t)
    gt = np.stack([-seq.R_lw[f].T @ seq.t_lw[f] for f in fi[v]])
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))


@pytest.fixture(scope="module")
def runs():
    seq = make_sequence(np.random.default_rng(21), n_frames=64, width=320, height=240,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0, device="cpu",
                        device_render=True)
    bc = BackendConfig(ba_every_kf=False, enable_loop_closure=True, bow_branch=32, bow_top_k=5,
                       bow_min_score=0.20, bow_min_frame_gap=15, loop_min_inliers=12)
    before = []
    original = psystem._run_pose_graph

    def spy(s):
        if not before:
            before.append((s.kf_db, s.n_keyframes))
        return original(s)

    s = create_system(CFG, bc, seq.rig, (240, 320), device="cpu")
    psystem._run_pose_graph = spy
    try:
        run_system(s, seq.left, seq.right)
    finally:
        psystem._run_pose_graph = original
    assert before and s.n_relocs == 0
    off = SimpleNamespace(kf_db=before[0][0])
    assert before[0][1] == s.n_keyframes      # the loop came at the last keyframe
    return seq, off, s


def test_loop_fires_on_revisit(runs):
    _, _, sys_on = runs
    fired = [d for d in sys_on.loop_debug if d["fired"]]
    assert sys_on.n_loop_closures >= 1 and fired
    d = fired[0]
    assert d["matched_frame"] <= 9 and d["frame"] >= 48 and d["n_inliers"] >= 30, d


def test_mid_orbit_views_rejected(runs):
    _, _, sys_on = runs
    assert all(d["n_inliers"] < 12 for d in sys_on.loop_debug if not d["fired"])


def test_pose_graph_reduces_keyframe_ate(runs):
    seq, sys_off, sys_on = runs
    ate_off, ate_on = _kf_ate(sys_off, seq), _kf_ate(sys_on, seq)
    assert ate_on < 0.75 * ate_off, (ate_off, ate_on)
