"""The captured programs (``zenslam_tpu_torch/utils/graphs.py``) on the
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

The keyframe path's programs, each against its ``eager()`` form, bit for
bit, with the trouble each has to handle:

- the snapshot ring: a system with ``telemetry_lag=3`` behind a stand-in
  step that overwrites its state in place, as the captured step does: a
  queued snapshot is unchanged until it leaves the queue three frames on,
  and ``last_kf_snap`` is unchanged after the next frames;
- two such systems of one shape, their frames alternating, each with a
  pose graph: each ends as its eager run alone (no snapshot of one reaches
  the other);
- the epoch correction of two queued snapshots of different ring entries,
  neither overwriting the other;
- the keyframe insert: two inserts with different frame indices through
  one captured program, a database kept from before the second insert
  untouched, the odometry edges;
- the pose graph, again after edges were appended past ``max_edges``;
- the spill's packing, and a reload with fewer than ``reload_max``
  candidates, twice through one program;
- vocabulary training and retraining from the same seed (two trains
  through one program draw alike), and an injected ``draw`` deciding the
  centres;
- the sharded windowed BA at 1 and 2 local shards on the one-rank gloo
  group.
"""

import contextlib

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.backend import bow
from zenslam_tpu_torch.backend.bow import bow_db_init
from zenslam_tpu_torch.backend.keyframes import kf_db_add, kf_db_init
from zenslam_tpu_torch.backend.map_archive import LandmarkArchive, _pack_live
from zenslam_tpu_torch.geometry.lie import so3_exp
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.ops import lk_cuda, orb_cuda
from zenslam_tpu_torch.utils import graphs
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.utils.graphs import Program, eager, flatten
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


# ------------------------------------------------- the keyframe path -------

N_KP, M_LM = 48, 128
SMALL = SlamConfig(max_keypoints=N_KP, max_landmarks=M_LM)


def _bcfg(**kw):
    base = dict(max_keyframes=6, ba_window=4, ba_iterations=2, ba_every_kf=False,
                enable_loop_closure=False, enable_map_spill=False, bow_branch=4,
                vocab_archive_sample=64, max_edges=8, pose_graph_iterations=3)
    base.update(kw)
    return psystem.BackendConfig(**base)


def _system(seq, **kw):
    return psystem.create_system(SMALL, _bcfg(**kw), seq.rig, (H, W), device="cpu")


def _rand_snap(g, frame: int) -> psystem.KfSnap:
    """A keyframe snapshot of random rows."""
    lm = torch.randint(-1, M_LM, (N_KP,), generator=g, dtype=torch.int32)
    return psystem.KfSnap(
        R_cw=so3_exp(torch.randn(3, generator=g) * 0.05), t_cw=torch.randn(3, generator=g) * 0.1,
        xy=torch.rand(N_KP, 2, generator=g) * 100, uv_r=torch.rand(N_KP, 2, generator=g) * 100,
        stereo_ok=torch.rand(N_KP, generator=g) > 0.3,
        desc=torch.randint(-2 ** 31, 2 ** 31 - 1, (N_KP, 8), generator=g, dtype=torch.int32),
        lm_idx=lm, valid=torch.rand(N_KP, generator=g) > 0.2,
        kp_lm_gen=torch.where(lm >= 0, 0, -1).to(torch.int32),
        kp_xyz=torch.randn(N_KP, 3, generator=g) + torch.tensor([0.0, 0.0, 4.0]),
        track_id=torch.arange(N_KP, dtype=torch.int32) + 100 * frame)


def _copy(tree):
    leaves = _leaves(tree)
    spec = flatten(tree, [])
    return graphs.unflatten(spec, iter([t.clone() for t in leaves]))


def _entries(program, **static) -> int:
    return sum(all(c.static.get(k) == v for k, v in static.items())
               for c in program.captured.values())


@pytest.fixture
def own_programs(monkeypatch):
    """The system's programs made anew for one test, so that the captured
    entries counted are the test's own (other test files in the same
    process capture their own shapes)."""
    for name in ("_KF_ADD", "_POSE_GRAPH", "_RELOAD", "_RETRAIN", "_WINDOWED_BA",
                 "build_vocabulary_tree"):
        old = getattr(psystem, name)
        monkeypatch.setattr(psystem, name,
                            Program(old.fn, old.static_argnames, old.donate_argnames,
                                    old.scalar_argnames, old.static_defaults,
                                    old.copy_outputs))


class _InPlaceStep:
    """Stands in for the captured step: frame t's pose, feature table and
    map rows written into the state's own tensors in place (as the captured
    step writes its buffers), keyframes on ``kf_frames``."""

    def __init__(self, kf_frames, seed: int = 1000):
        self.t, self.kf_frames, self.seed = 0, set(kf_frames), seed

    def _run(self, state, img_l, img_r, noise=None, imu=None):
        g = torch.Generator().manual_seed(self.seed + self.t)
        snap = _rand_snap(g, self.t)
        f = state.features
        for dst, src in ((f.xy, snap.xy), (f.uv_r, snap.uv_r), (f.stereo_ok, snap.stereo_ok),
                         (f.desc, snap.desc), (f.lm_idx, snap.lm_idx), (f.valid, snap.valid),
                         (f.track_id, snap.track_id), (state.R_cw, snap.R_cw),
                         (state.t_cw, snap.t_cw)):
            dst.copy_(src)
        state.lmap.xyz.copy_(torch.randn(M_LM, 3, generator=g))
        state.lmap.generation.copy_(torch.randint(0, 3, (M_LM,), generator=g, dtype=torch.int32))
        scalars = torch.zeros(13)
        scalars[6] = 1.0                                   # pose_ok
        scalars[8] = float(self.t in self.kf_frames)       # is_keyframe
        self.t += 1
        return state, None, torch.cat([scalars, snap.R_cw.reshape(-1), snap.t_cw])


def _ring_run(seq, n_frames: int, kf_frames, watch):
    """``n_frames`` of ``process_frame`` behind the in-place step; after
    each, ``watch(system, frame)``."""
    s = _system(seq, telemetry_lag=3)
    s.step = _InPlaceStep(kf_frames)
    for t in range(n_frames):
        psystem.process_frame(s, *_frame(seq, 0))
        watch(s, t)
    psystem.flush_pipeline(s)
    return s


def test_snapshot_ring_keeps_queued_and_keyframe_snapshots(seq, own_programs):
    kept, last, seen = {}, {}, []

    def watch(s, t):
        snap = s._tel_queue[-1][1]                      # this frame's, just queued
        assert _identical(snap, psystem._kf_snapshot(s.state)), t
        kept[t] = (snap, _copy(snap))
        for f, (obj, values) in kept.items():           # every snapshot still queued
            if t - f < 3:
                assert any(q[1] is obj for q in s._tel_queue)
                assert _identical(obj, values), (f, t)
        if s.last_kf_snap is not None:
            if not last or last["obj"] is not s.last_kf_snap:
                last.update(obj=s.last_kf_snap, values=_copy(s.last_kf_snap), at=t)
            else:
                seen.append(t - last["at"])
                assert _identical(last["obj"], last["values"]), t

    g_sys = _ring_run(seq, 9, (1, 3), watch)
    with eager():
        e_sys = _ring_run(seq, 9, (1, 3), lambda s, t: None)
    assert g_sys.n_keyframes == e_sys.n_keyframes == 2
    assert _identical(g_sys.kf_db, e_sys.kf_db) and _identical(g_sys.last_kf_snap,
                                                               e_sys.last_kf_snap)
    assert max(seen) >= 2                                 # kept over later frames
    assert _entries(g_sys.snap_programs.snapshot) == 4    # the ring: 4 queue entries


def _lanes_run(seq, lanes: dict, graphed: bool) -> dict:
    """Systems behind in-place steps (name: (step seed, keyframe frames)),
    their frames alternating; at frame 6 each appends a loop edge and runs
    the pose graph, which corrects its queued snapshots."""
    systems = {}
    for name, (seed, kf_frames) in lanes.items():
        systems[name] = s = _system(seq, telemetry_lag=3)
        s.step = _InPlaceStep(kf_frames, seed)
    with contextlib.nullcontext() if graphed else eager():
        for t in range(9):
            for name, s in systems.items():
                psystem.process_frame(s, *_frame(seq, 0))
                if t == 6:
                    g = torch.Generator().manual_seed(lanes[name][0])
                    psystem._append_edge(s, s.last_kf_slot, 0,
                                         so3_exp(torch.randn(3, generator=g) * 0.02),
                                         torch.randn(3, generator=g) * 0.05, 5.0)
                    psystem._run_pose_graph(s)
        for s in systems.values():
            psystem.flush_pipeline(s)
    return systems


def _kept(s):
    return (s.kf_db, s.last_kf_snap, s.edge_R, s.edge_t, s.state.R_cw, s.state.t_cw,
            s.state.lmap.xyz, s._pg_delta, s.edge_i, s.edge_j)


def test_two_systems_interleaved_keep_their_own_programs(seq, own_programs):
    lanes = {"a": (1000, (1, 3, 5)), "b": (5000, (2, 4, 5))}
    both = _lanes_run(seq, lanes, graphed=True)
    for name, lane in lanes.items():
        alone = _lanes_run(seq, {name: lane}, graphed=False)[name]
        assert both[name].n_keyframes == alone.n_keyframes == 3
        assert _identical(_kept(both[name]), _kept(alone)), name
    assert not _identical(both["a"].kf_db, both["b"].kf_db)
    assert both["a"].snap_programs is not both["b"].snap_programs


def test_epoch_correction_of_two_ring_entries(seq, own_programs):
    s = _system(seq, telemetry_lag=3)
    g = torch.Generator().manual_seed(5)
    snaps = {f: _rand_snap(g, f) for f in (6, 7)}
    s._pg_delta = (so3_exp(torch.randn(3, generator=g) * 0.1), torch.randn(3, generator=g),
                   so3_exp(torch.randn(3, generator=g) * 0.1), torch.randn(3, generator=g))
    got = {f: psystem._epoch_correct(s, x, f) for f, x in snaps.items()}
    with eager():
        want = {f: psystem._epoch_correct(s, x, f) for f, x in snaps.items()}
    for f in snaps:          # both kept: two ring entries, two programs
        assert _identical(got[f], want[f]) and not _identical(got[f], snaps[f])
    assert _entries(s.snap_programs.epoch, slot=6 % 4) == 1


def _insert(s, snap, frame):
    prev = s.last_kf_slot
    slot = s.n_keyframes % s.bcfg.max_keyframes
    s.n_keyframes += 1
    psystem._kf_add(s, snap, snap.desc, frame, slot, prev)
    s.last_kf_slot = slot


def test_keyframe_insert_takes_frame_index_per_call(seq, own_programs):
    g = torch.Generator().manual_seed(6)
    snaps = [_rand_snap(g, f) for f in range(3)]
    runs = {}
    for graphed in (True, False):
        s = _system(seq)
        dbs = []
        with contextlib.nullcontext() if graphed else eager():
            for snap, frame in zip(snaps, (4, 9, 15)):
                _insert(s, snap, frame)
                dbs.append((s.kf_db, _copy(s.kf_db)))
        runs[graphed] = (s, dbs)
    (gs, gdb), (es, edb) = runs[True], runs[False]
    for (a, _), (b, _) in zip(gdb, edb):
        assert _identical(a, b)                            # each insert's eager answer
    for a, values in gdb:                                  # the kept databases untouched
        assert _identical(a, values)
    assert [int(x) for x in gs.kf_db.frame_idx[:3]] == [4, 9, 15]
    assert gs.edge_i == es.edge_i == [1, 2] and gs.edge_j == [0, 1]
    assert all(torch.equal(x, y) for x, y in zip(gs.edge_R + gs.edge_t, es.edge_R + es.edge_t))
    assert _entries(psystem._KF_ADD, has_prev=True) == 1


def _graph_system(seq, g):
    s = _system(seq, telemetry_lag=3)
    for f in range(5):
        _insert(s, _rand_snap(g, f), 10 * f)
    return s


def test_pose_graph_with_edges_appended_after_capture(seq, own_programs):
    pair = {}
    for graphed in (True, False):
        g = torch.Generator().manual_seed(8)
        with contextlib.nullcontext() if graphed else eager():
            s = _graph_system(seq, g)
            s._tel_queue = [(None, _rand_snap(g, 40), 40)]
            outs = []
            for loops in ((4, 0), (4, 1), (3, 0), (4, 2), (2, 0)):   # 4 odometry + 5 > 8 edges
                psystem._append_edge(s, *loops, so3_exp(torch.randn(3, generator=g) * 0.02),
                                     torch.randn(3, generator=g) * 0.05, 5.0)
                psystem._run_pose_graph(s)
                outs.append(_copy((s.kf_db, s.state.R_cw, s.state.t_cw, s.state.lmap.xyz,
                                   s._pg_delta, s._tel_queue[0][1])))
            assert len(s.edge_i) > s.bcfg.max_edges
        pair[graphed] = outs
    assert len(pair[True][0][0].R) == 6
    for a, b in zip(pair[True], pair[False]):
        assert _identical(a, b)
    assert not _identical(pair[True][0], pair[True][1])   # the appended edges count
    assert _entries(psystem._POSE_GRAPH, iterations=3) == 1


def _archive_and_map(g):
    """A live map of 40 landmarks synced into an archive, then 30 of their
    slots recycled (dormant rows), and the map with those slots cleared."""
    lmap = init_state(SMALL, (H, W), device="cpu").lmap
    xyz = torch.randn(M_LM, 3, generator=g) * 0.5 + torch.tensor([0.0, 0.0, 3.0])
    lmap = lmap._replace(xyz=xyz, valid=torch.arange(M_LM) < 40,
                         desc=torch.randint(-2 ** 31, 2 ** 31 - 1, (M_LM, 8), generator=g,
                                            dtype=torch.int32),
                         color=torch.rand(M_LM, generator=g))
    arch = LandmarkArchive()
    arch.sync_packed(_pack_live(lmap).numpy())
    gone = (torch.arange(M_LM) < 30)
    lmap = lmap._replace(valid=lmap.valid & ~gone, generation=lmap.generation + gone.int())
    arch.sync_packed(_pack_live(lmap).numpy())
    return arch, lmap


def test_spill_pack_and_reload(seq, own_programs):
    cam = seq.rig.left
    out = {}
    for graphed in (True, False):
        g = torch.Generator().manual_seed(9)
        arch, lmap = _archive_and_map(g)
        with contextlib.nullcontext() if graphed else eager():
            packed = _pack_live(lmap)
            res = []
            for radius in (3.2, 50.0):      # fewer than reload_max candidates, then more
                lmap = arch.reload(lmap, torch.eye(3), torch.zeros(3), cam, 12, reload_max=16,
                                   radius=radius, insert=psystem._reload_insert)
                res.append((_copy(lmap), arch.n_reloads, arch.dormant.copy()))
                if len(res) == 1:
                    first = lmap
        assert _identical(first, res[0][0])     # the first reload's map, kept, untouched
        out[graphed] = packed, res
    assert torch.equal(out[True][0], _pack_live(_archive_and_map(
        torch.Generator().manual_seed(9))[1]))
    for (a, na, da), (b, nb, db) in zip(out[True][1], out[False][1]):
        assert _identical(a, b) and na == nb and np.array_equal(da, db)
    counts = [n for _, n, _ in out[True][1]]
    assert 0 < counts[0] < 16 and counts[1] > counts[0]
    assert len(psystem._RELOAD.captured) == 1


def _vocab_system(seq, g):
    s = _system(seq, vocab_archive_sample=32)
    for f in range(4):
        _insert(s, _rand_snap(g, f), 10 * f)
    s.archive.sync_packed(_pack_live(init_state(SMALL, (H, W), device="cpu").lmap._replace(
        valid=torch.ones(M_LM, dtype=torch.bool),
        desc=torch.randint(-2 ** 31, 2 ** 31 - 1, (M_LM, 8), generator=g,
                           dtype=torch.int32))).numpy())
    return s


def test_vocabulary_train_and_retrain(seq, own_programs):
    g = torch.Generator().manual_seed(10)
    desc = torch.randint(-2 ** 31, 2 ** 31 - 1, (N_KP, 8), generator=g, dtype=torch.int32)
    valid = torch.rand(N_KP, generator=g) > 0.1
    bc = _bcfg()
    twice = [psystem._train_vocab(bc, desc, valid, bow.GeneratorDraw(7, "cpu"))
             for _ in range(2)]
    with eager():
        want = psystem._train_vocab(bc, desc, valid, bow.GeneratorDraw(7, "cpu"))
    assert _identical(twice[0], want) and _identical(twice[1], want)
    other = psystem._train_vocab(bc, desc, valid, bow.GeneratorDraw(8, "cpu"))
    assert not _identical(other, want)

    def injected():      # a plain callable: what a test hands in for the reference's draws
        inner = bow.GeneratorDraw(99, "cpu")
        return lambda *a: inner(*a)

    got = psystem._train_vocab(bc, desc, valid, injected())
    with eager():
        assert _identical(got, psystem._train_vocab(bc, desc, valid, injected()))
    assert not _identical(got, want)
    out = {}
    for graphed in (True, False):
        s = _vocab_system(seq, torch.Generator().manual_seed(11))
        with contextlib.nullcontext() if graphed else eager():
            psystem._retrain_vocab(s)
        out[graphed] = (s.vocab, s.bow_db)
    assert _identical(out[True], out[False])
    assert out[True][1].next_slot.shape == () and int(out[True][1].next_slot) == 3
    assert not bool(out[True][1].valid[3])
    assert _entries(psystem.build_vocabulary_tree) == 3 and _entries(psystem._RETRAIN) == 1
    # three first trains: seeds 7, 8 and the injected draw


def _window_db(rig, g):
    """Six keyframes observing 40 of 128 landmarks each, projected through
    the rig with noise."""
    K, db = 6, kf_db_init(6, N_KP, device="cpu")
    X = torch.randn(M_LM, 3, generator=g) * torch.tensor([1.0, 0.7, 0.5]) + torch.tensor(
        [0.0, 0.0, 4.0])
    for k in range(K):
        R = so3_exp(torch.tensor([0.0, 0.02 * k, 0.0]))
        t = torch.tensor([-0.1 * k, 0.0, 0.0])
        lm = torch.randperm(M_LM, generator=g)[:N_KP].to(torch.int32)
        lm[40:] = -1
        xc = X[lm.long()] @ R.T + t
        uv = torch.stack([rig.left.fx * xc[:, 0] / xc[:, 2] + rig.left.cx,
                          rig.left.fy * xc[:, 1] / xc[:, 2] + rig.left.cy], -1)
        xr = xc @ rig.R_rl.T + rig.t_rl
        uvr = torch.stack([rig.right.fx * xr[:, 0] / xr[:, 2] + rig.right.cx,
                           rig.right.fy * xr[:, 1] / xr[:, 2] + rig.right.cy], -1)
        noise = torch.randn(N_KP, 2, generator=g) * 0.5
        db = kf_db_add(db, R, t + torch.randn(3, generator=g) * 0.01, uv + noise, lm, lm >= 0,
                       torch.zeros(N_KP, 8, dtype=torch.int32), 10 * k, kp_uvr=uvr + noise,
                       kp_stereo=lm >= 0, kp_xyz=X[lm.long()])
    return db, X + torch.randn(M_LM, 3, generator=g) * 0.02


def test_dist_window_one_and_two_shards(seq, own_programs):
    db, xyz = _window_db(seq.rig, torch.Generator().manual_seed(12))
    args = (db, xyz, torch.ones(M_LM, dtype=torch.bool), torch.zeros(M_LM, dtype=torch.int32),
            db.R[5], db.t[5], seq.rig)
    dense = psystem._windowed_ba(*args, W=4, solver="dense", iterations=2)
    for n in (1, 2):
        mesh = psystem._live_ba_mesh(n, torch.device("cpu"))
        kw = dict(W=4, solver="dist", iterations=2, mesh=mesh)
        got = [psystem._windowed_ba(*args, **kw) for _ in range(2)]
        with eager():
            want = psystem._windowed_ba(*args, **kw)
        assert _identical(got[0], want) and _identical(got[1], want)
        assert float(want[5][1]) < float(want[5][0])                  # rmse falls
        assert float((want[1] - dense[1]).abs().max()) < 5e-3
        assert _entries(psystem._WINDOWED_BA, solver="dist", mesh=mesh) == 1
