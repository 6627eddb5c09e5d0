"""Keylines through the port alone on the CPU: tests/test_lines.py's
end-to-end assertions held by zenslam_tpu_torch (no JAX), on the
``with_lines`` corridor strafe (seed 11) at 256x384.

- ``run_sequence`` with keylines (8 frames, 256 keypoints): pose_ok after
  frame 0, >= 8 keylines on every frame after the first, >= 4 triangulated
  on some frame, >= 4 mapped at the end, ATE < 0.02 m, and more than 60% of
  the mapped endpoints within 10 cm of a corridor plane;
- the full system (10 frames, BA on every keyframe, loops off) with
  keylines off and on: >= 8 keylines in the telemetry, the scene export's
  ``lines`` (>= 4 segments, in the HTML too), and the ATE with keylines
  under max(1.5 x the ATE without, 0.02 m);
- the keyline tables through ``convert`` and back, and through
  ``save_pytree`` / ``load_pytree`` and ``save_system`` / ``load_system``,
  bit-exact.
"""

import numpy as np
import pytest
import torch

from zenslam_tpu_torch import convert
from zenslam_tpu_torch.analysis.scene_export import export_scene
from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
from zenslam_tpu_torch.io import checkpoint
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline import SlamConfig, init_state, run_sequence
from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

torch.set_num_threads(2)
H, W = 256, 384
BASE = dict(max_keypoints=256, max_landmarks=2048, pnp_iters=128, rigid_iters=128)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=10, width=W, height=H,
                         motion="strafe", with_lines=True, device="cpu")


def _gt(seq, n):
    return camera_positions(seq.R_lw[:n], seq.t_lw[:n])


def test_pipeline_with_keylines(seq):
    cfg = SlamConfig(use_keylines=True, **BASE)
    state, tel = run_sequence(cfg, seq.rig, seq.left[:8], seq.right[:8], device="cpu")
    assert tel.pose_ok[1:].all()
    assert (tel.n_lines[1:] >= 8).all()
    assert tel.n_line_triangulated.max() >= 4
    assert tel.line_map_size[-1] >= 4
    assert ate_rmse(camera_positions(tel.R_cw, tel.t_cw), _gt(seq, 8)) < 0.02
    # triangulated endpoints lie on the corridor's planes (wall z=6, floor
    # y=1.5, ceiling y=-1.2)
    pts = state.line_map.xyz[state.line_map.valid].reshape(-1, 3).numpy()
    d_plane = np.minimum(np.abs(pts[:, 2] - 6.0),
                         np.minimum(np.abs(pts[:, 1] - 1.5), np.abs(pts[:, 1] + 1.2)))
    assert len(pts) >= 8 and (d_plane < 0.10).mean() > 0.6


@pytest.fixture(scope="module")
def systems(seq):
    out = {}
    for lines_on in (False, True):
        cfg = SlamConfig(kf_min_frames=2, kf_min_translation=0.04, use_keylines=lines_on,
                         **BASE)
        s = create_system(cfg, BackendConfig(ba_every_kf=True, enable_loop_closure=False),
                          seq.rig, (H, W), device="cpu")
        tel, _ = run_system(s, seq.left, seq.right)
        out[lines_on] = (s, tel)
    return out


def test_system_run_exports_line3d_no_ate_regression(seq, systems, tmp_path):
    ates = {}
    for lines_on, (s, tel) in systems.items():
        est = camera_positions(tel.R_cw, tel.t_cw)
        ates[lines_on] = ate_rmse(est, _gt(seq, 10))
        if lines_on:
            assert int(tel.n_lines.max()) >= 8
            scene = export_scene(str(tmp_path), s, est, _gt(seq, 10))
            assert scene["lines"].shape[0] >= 4
            html = (tmp_path / "scene.html").read_text()
            assert '"lines": [[[' in html and "keylines" in html
        else:
            assert int(tel.n_lines.max()) == 0 and int(s.state.line_map.valid.sum()) == 0
    assert ates[True] < max(ates[False] * 1.5, 0.02), ates


def _same(a, b):
    la, lb = checkpoint._flatten(a), checkpoint._flatten(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def test_line_tables_convert_and_checkpoint(systems, tmp_path):
    s, _ = systems[True]
    state = s.state
    assert int(state.lines.valid.sum()) >= 8 and int(state.line_map.valid.sum()) >= 4
    back = convert.state_to_numpy(state)
    assert back.lines.desc.dtype == np.uint32 and back.line_map.desc.dtype == np.uint32
    _same(convert.state_from_numpy(back, "cpu"), state)

    path = tmp_path / "state.npz"
    checkpoint.save_pytree(str(path), state)
    _same(checkpoint.load_pytree(str(path), init_state(s.cfg, (H, W), device="cpu")), state)

    path = tmp_path / "system.npz"
    checkpoint.save_system(str(path), s)
    s2 = checkpoint.load_system(str(path), s.cfg, s.bcfg, s.rig, (H, W), device="cpu")
    _same(s2.state, s.state)
    _same(s2.kf_db, s.kf_db)
