"""Checkpoints of the port (zenslam_tpu_torch.io.checkpoint) on the CPU: a
state round trip is bit-exact, a structure mismatch raises, and a system
saved after frame 6 of 12, loaded and run on reproduces the uninterrupted
run bit for bit (with lagged telemetry, so the save also carries queued
frames and resolves a deferred spill; the reference's test_checkpoint
workload: the 12-frame 320x240 strafe, seed 5)."""

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.io.checkpoint import load_pytree, load_system, save_pytree, save_system
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline.runner import run_sequence
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state
from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

torch.set_num_threads(2)
CFG = SlamConfig(max_keypoints=256, max_landmarks=2048, pnp_iters=128, rigid_iters=128)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(5), n_frames=12, width=320, height=240,
                         motion="strafe", device="cpu")


def _leaves(tree):
    from zenslam_tpu_torch.io.checkpoint import _flatten

    return _flatten(tree)


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), name
        else:
            assert type(x) is type(y) and x == y, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_round_trip_bit_exact(seq, tmp_path, dtype):
    cfg = CFG._replace(use_pallas_lk=dtype == torch.bfloat16) if dtype == torch.bfloat16 else CFG
    state, _ = run_sequence(CFG, seq.rig, seq.left[:6], seq.right[:6], device="cpu")
    if dtype == torch.bfloat16:   # the kernel path's bf16 pyramid, stored as its bits
        state = state._replace(prev_pyr_l=tuple(p.to(dtype) for p in state.prev_pyr_l))
    p = str(tmp_path / "state.npz")
    save_pytree(p, state)
    template = init_state(cfg, seq.left[0].shape, device="cpu")
    template = template._replace(prev_pyr_l=tuple(p.to(dtype) for p in template.prev_pyr_l))
    restored = load_pytree(p, template)
    _assert_same(state, restored)
    assert restored.rng_step == 6


def test_structure_mismatch_raises(seq, tmp_path):
    state = init_state(CFG, seq.left[0].shape, device="cpu")
    p = str(tmp_path / "state.npz")
    save_pytree(p, state)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(p, {"not": "the same structure", "x": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(p, init_state(CFG._replace(max_keypoints=128), seq.left[0].shape,
                                  device="cpu"))


def _system_tree(s):
    return {"state": s.state, "kf_db": s.kf_db, "bow_db": s.bow_db, "vocab": s.vocab}


@pytest.mark.parametrize("lag", [2])
def test_resume_reproduces_uninterrupted_run(seq, tmp_path, lag):
    bcfg = BackendConfig(max_keyframes=8, ba_window=4, ba_iterations=4, enable_loop_closure=True,
                         bow_levels=1, bow_words=32, telemetry_lag=lag)
    shape = tuple(seq.left[0].shape)
    sys_a = create_system(CFG, bcfg, seq.rig, shape, device="cpu")
    tel_a, _ = run_system(sys_a, seq.left, seq.right)

    sys_b = create_system(CFG, bcfg, seq.rig, shape, device="cpu")
    from zenslam_tpu_torch.pipeline.system import process_frame

    tels_b = [process_frame(sys_b, seq.left[t], seq.right[t])[0] for t in range(6)]
    p = str(tmp_path / "sys.npz")
    save_system(p, sys_b)
    sys_c = load_system(p, CFG, bcfg, seq.rig, shape, device="cpu")
    for k in ("last_kf_slot", "n_ba_runs", "n_keyframes", "n_frames", "last_vocab_kfs"):
        assert getattr(sys_c, k) == getattr(sys_b, k), k
    assert len(sys_c._tel_queue) == lag
    _assert_same(_system_tree(sys_b), _system_tree(sys_c))
    assert sys_c.edge_i == sys_b.edge_i and sys_c.edge_w == sys_b.edge_w
    for x, y in zip(sys_c.edge_R + sys_c.edge_t, sys_b.edge_R + sys_b.edge_t):
        assert np.array_equal(x, np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y))
    assert np.array_equal(sys_c.archive.xyz, sys_b.archive.xyz)
    assert sys_c.archive._row_key == sys_b.archive._row_key

    tel_c, _ = run_system(sys_c, seq.left[6:], seq.right[6:])
    _assert_same(_system_tree(sys_a), _system_tree(sys_c))
    assert sys_c.n_ba_runs == sys_a.n_ba_runs and sys_c.n_keyframes == sys_a.n_keyframes
    n_b = sum(t is not None for t in tels_b)
    for f in ("R_cw", "t_cw", "n_tracked", "is_keyframe"):
        assert np.array_equal(getattr(tel_a, f)[n_b:], getattr(tel_c, f)), f
