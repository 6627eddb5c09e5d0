"""The captured programs (``zenslam_tpu_torch/pipeline/graphs.py``) on the
CPU, where a ``Program`` runs its function on its static buffers with the
buffer logic that replays CUDA graphs on a card (the card's counterparts
are in ``tests/test_torch_cuda.py``). At 96x128 with a small config:

- ``make_slam_step`` over 6 frames bit-identical to ``slam_step``, its state
  the program's own buffers from the second frame on (copied nowhere);
- a state replaced between calls (a pose correction, as the back end makes
  one) is honoured: the next frame equals ``slam_step`` from that state;
- the telemetry is the caller's to keep, and a state passed again after the
  step has overwritten it (donated) raises, while a copy of it runs;
- the rng host fields advance on every call, and a state built with another
  seed draws that seed's noise;
- the loop gate's host ints reach each call: two ``kf_slot``s (and frame
  indices) through one captured program give the two eager answers;
- the launch-count arithmetic of a replay on a stub (the capture's count
  added on every call, the warm-up and capture themselves counting
  nothing, ``eager()`` counting the function's own calls);
- ``upload_constant`` returns one cached tensor per value.
"""

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.backend.bow import bow_db_init
from zenslam_tpu_torch.backend.keyframes import kf_db_add, kf_db_init
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.ops import lk_cuda, orb_cuda
from zenslam_tpu_torch.pipeline import graphs
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.graphs import Program, eager, flatten
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state
from zenslam_tpu_torch.pipeline.step import make_slam_step, slam_step
from zenslam_tpu_torch.utils.device import upload_constant

torch.set_num_threads(2)

H, W = 96, 128
CFG = SlamConfig(max_keypoints=96, max_landmarks=384, pnp_iters=24, rigid_iters=24,
                 essential_iters=24)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(7), n_frames=6, width=W, height=H,
                         motion="arc", device="cpu")


def _frame(seq, t):
    return torch.from_numpy(seq.left[t]), torch.from_numpy(seq.right[t])


def _leaves(tree) -> list:
    out = []
    flatten(tree, out)
    return out


def _identical(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_captured_step_bit_identical_to_slam_step(seq):
    step = make_slam_step(CFG, seq.rig)
    a = b = init_state(CFG, (H, W), seed=4, device="cpu")
    for t in range(6):
        a_in = a
        a, ta = step(a, *_frame(seq, t))
        b, tb = slam_step(CFG, seq.rig, b, *_frame(seq, t))
        assert _identical(ta, tb) and _identical(a, b), t
        assert (a.rng_seed, a.rng_step) == (b.rng_seed, b.rng_step) == (4, t + 1)
        if t > 0:   # the state passed back is the program's buffers: updated in place
            assert all(x is y for x, y in zip(_leaves(a), _leaves(a_in)))
    assert int(tb.n_tracked) > 20
    assert len(step.program.captured) == 1


def test_replaced_state_is_honoured(seq):
    step = make_slam_step(CFG, seq.rig)
    a = init_state(CFG, (H, W), seed=1, device="cpu")
    for t in range(3):
        a, _ = step(a, *_frame(seq, t))
    R_new = torch.eye(3)
    t_new = torch.tensor([0.01, -0.02, 0.03])
    moved = psystem._apply_pose_correction(a, a.R_cw, a.t_cw, R_new @ a.R_cw, a.t_cw + t_new)
    ref = graphs.fresh(moved)     # the eager run's own copy: the call below reuses a's buffers
    a, ta = step(moved, *_frame(seq, 3))
    b, tb = slam_step(CFG, seq.rig, ref, *_frame(seq, 3))
    assert _identical(ta, tb) and _identical(a, b)


def test_donated_state_reuse_raises_and_telemetry_is_kept(seq):
    step = make_slam_step(CFG, seq.rig)
    s0 = init_state(CFG, (H, W), seed=2, device="cpu")
    s1, t1 = step(s0, *_frame(seq, 0))
    kept = graphs.fresh(s1)
    s2, _ = step(s1, *_frame(seq, 1))
    r1, rt1 = slam_step(CFG, seq.rig, s0, *_frame(seq, 0))
    assert _identical(t1, rt1)                       # untouched by the second call
    with pytest.raises(RuntimeError, match="donated"):
        step(s1, *_frame(seq, 2))                    # s1's buffers now hold s2
    want, _ = slam_step(CFG, seq.rig, kept, *_frame(seq, 1))
    again, _ = step(kept, *_frame(seq, 1))           # a copy is a state of its own
    assert _identical(again, want) and _identical(kept, r1)
    step(s2, *_frame(seq, 2))                        # the latest state still runs


def test_rng_host_fields_advance_per_call(seq):
    step = make_slam_step(CFG, seq.rig)
    s7 = init_state(CFG, (H, W), seed=7, device="cpu")
    s8 = init_state(CFG, (H, W), seed=8, device="cpu")
    out = {}
    for name, s in (("7", s7), ("8", s8)):
        for t in range(2):
            s, tel = step(s, *_frame(seq, t))
            assert s.rng_step == t + 1
        out[name] = tel
    ref = s8
    for t in range(2):
        ref, tb = slam_step(CFG, seq.rig, ref, *_frame(seq, t))
    assert _identical(out["8"], tb)
    assert len(step.program.captured) == 1


def _gate_inputs():
    g = torch.Generator().manual_seed(0)
    K, N, n_words = 6, 48, 16
    db = kf_db_init(K, N, device="cpu")
    for k in range(4):
        lm = torch.randint(-1, 200, (N,), generator=g, dtype=torch.int32)
        db = kf_db_add(db, torch.eye(3), torch.randn(3, generator=g) * 0.1,
                       torch.rand(N, 2, generator=g) * 100, lm, lm >= 0,
                       torch.randint(-2 ** 31, 2 ** 31 - 1, (N, 8), generator=g,
                                     dtype=torch.int32), 10 * k,
                       kp_xyz=torch.randn(N, 3, generator=g) + torch.tensor([0.0, 0.0, 4.0]))
    vocab = (torch.rand(n_words, 256, generator=g) > 0.5).to(torch.float32)
    bow = bow_db_init(K, n_words, device="cpu")
    noise = -torch.log(-torch.log(torch.rand(3, psystem.LOOP_PNP_ITERS, N, generator=g)
                                  .clamp(min=1e-30)))
    K_left = torch.tensor([[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]])
    return vocab, bow, db, K_left, noise


def test_loop_gate_takes_host_ints_per_call():
    vocab, bow, db, K_left, noise = _gate_inputs()
    got, want = [], []
    for slot, frame in ((1, 50), (3, 31)):
        args = (vocab, bow, db, slot, frame, K_left)
        kw = dict(min_frame_gap=5, pnp_threshold=8.0, noise=noise, top_k=3)
        got.append(psystem._loop_query_verify(*args, **kw))
        with eager():
            want.append(psystem._loop_query_verify(*args, **kw))
    for g_, w_ in zip(got, want):
        assert _identical(g_, w_)
    assert not torch.equal(got[0][1], got[1][1])      # the two calls' own verdicts
    assert int(got[1][0].frame_idx[int(bow.next_slot)]) == 31
    keys = [k for k in psystem._LOOP_GATE.captured
            if dict(k[0]) == dict(min_frame_gap=5, pnp_threshold=8.0, top_k=3)]
    assert len(keys) == 1                              # one program for both calls


def test_launch_counts_of_a_replay_on_a_stub(monkeypatch):
    monkeypatch.setattr(lk_cuda.lk_ragged, "launches", 10)
    monkeypatch.setattr(orb_cuda.orb_steered_brief, "launches", 3)
    calls = []

    def stub(x, k: int):
        calls.append(k)
        lk_cuda.lk_ragged.launches += 2 * k       # as the wrappers count their launches
        orb_cuda.orb_steered_brief.launches += k
        return (x * k,)

    prog = Program(stub, static_argnames=("k",))
    x = torch.arange(4.0)
    (y,) = prog(x, k=2)
    assert graphs.read_counters() == (14, 5)        # the first call counts once
    for n in range(1, 4):
        (y,) = prog(x + n, k=2)
        assert torch.equal(y, (x + n) * 2)
    assert graphs.read_counters() == (26, 11)       # 4 and 2 a call, however it ran
    (y,) = prog(x, k=1)                             # a new key: its own capture and count
    assert graphs.read_counters() == (28, 12) and len(prog.captured) == 2
    with eager():
        prog(x, k=3)
    assert graphs.read_counters() == (34, 15) and len(calls) == 6


def test_upload_constant_is_cached():
    a = upload_constant(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32), "cpu")
    b = upload_constant(torch.tensor([[1.0, 2.0], [3.0, 4.0]]), "cpu")
    c = upload_constant(np.array([[1.0, 2.0], [3.0, 5.0]], np.float32), "cpu")
    assert a is b and c is not a and float(c[1, 1]) == 5.0
    src = np.zeros(3, np.float32)
    d = upload_constant(src, "cpu")
    src[0] = 1.0                                    # the cache holds its own copy
    assert float(d[0]) == 0.0
