"""The port's spans, device stamps and counters (``zenslam_tpu_torch/
utils/tracing.py``) on the CPU, where a stamp writes the host clock into a
ring of the device ring's layout. At 96x128 with a small config:

- off, nothing is kept: no span, no stamp, the stamp count unchanged, and a
  span is the shared null context;
- the step's outputs and state are bit-identical with tracing on and off,
  through ``graphs.eager()`` and through the captured form;
- turning tracing on captures a program anew, and turning it off replays
  the graph made with it off;
- a system with ``telemetry_lag=2``: one captured step a frame, its stage
  stamps in order, tiling the step; every keyframe's ``frame.backend``
  span holds the back end's phases; the spans of a frame share its index
  across the lag (its telemetry wait and back end run in a later call);
- a wrapped ring counts what it lost (``dropped``);
- the clock fit maps the CPU's stamps onto the host clock exactly, and a
  linear device clock back onto it.

The card's test (``cuda``): the stamps replay inside the step's graph,
``%globaltimer`` is monotone within a replay, and each frame's step span
lies inside its ``frame.replay`` start to its telemetry wait's end, within
the fit's uncertainty. On the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tracing.py
"""

import contextlib

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state
from zenslam_tpu_torch.pipeline.step import make_slam_step
from zenslam_tpu_torch.utils import graphs, tracing
from zenslam_tpu_torch.utils.graphs import Program, flatten

torch.set_num_threads(2)

H, W = 96, 128
CFG = SlamConfig(max_keypoints=96, max_landmarks=384, pnp_iters=24, rigid_iters=24,
                 essential_iters=24)
STAGES = ["step.pyramid", "step.predict", "step.track", "step.detect", "step.describe",
          "step.associate", "step.rematch", "step.stereo", "step.estimate", "step.map",
          "step.keyframe"]
PHASES = {"backend.spill_resolve", "backend.resolve", "backend.kf_add", "backend.loop_issue",
          "backend.ba_dispatch", "backend.resolve_sync", "backend.spill_pack"}
LAG = 2
FRAMES = 8


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(7), n_frames=FRAMES, width=W, height=H,
                         motion="arc", device="cpu")


def _frame(seq, t):
    return torch.from_numpy(seq.left[t]), torch.from_numpy(seq.right[t])


def _system(seq):
    bcfg = psystem.BackendConfig(max_keyframes=6, ba_window=4, ba_iterations=2,
                                 enable_loop_closure=False, max_edges=8, telemetry_lag=LAG)
    return psystem.create_system(CFG, bcfg, seq.rig, (H, W), device="cpu")


def _identical(a, b) -> bool:
    la, lb = [], []
    flatten(a, la)
    flatten(b, lb)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture
def tracing_on():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


@pytest.fixture(scope="module")
def traced(seq):
    """A system's frames and flush with tracing on: (system, collect())."""
    tracing.enable()
    try:
        s = _system(seq)
        for t in range(FRAMES):
            psystem.process_frame(s, *_frame(seq, t))
        psystem.flush_pipeline(s)
        return s, tracing.collect()
    finally:
        tracing.disable()


def test_off_keeps_no_span_and_takes_no_stamp(seq):
    tracing.enable()
    tracing.disable()
    stamps = tracing.counters.stamps
    assert tracing.span("frame") is tracing.span("hostio.wait", "telemetry")
    s = _system(seq)
    for t in range(3):
        psystem.process_frame(s, *_frame(seq, t))
    got = tracing.collect()
    assert got["host"] == [] and got["device"] == [] and got["dropped"] == 0
    assert tracing.counters.stamps == stamps
    # the step's graph holds no stamp: its replays add none
    (entry,) = s.step.program.captured.values()
    assert entry.launches[graphs._counters().index((tracing.counters, "stamps"))] == 0


@pytest.mark.parametrize("form", ["captured", "eager"])
def test_step_bit_identical_with_tracing_on_and_off(seq, form):
    step = make_slam_step(CFG, seq.rig)
    out = {}
    for on in (False, True):
        if on:
            tracing.enable()
        try:
            s = init_state(CFG, (H, W), seed=3, device="cpu")
            tels = []
            with graphs.eager() if form == "eager" else contextlib.nullcontext():
                for t in range(3):
                    s, tel = step(s, *_frame(seq, t))
                    tels.append(tel)
            out[on] = (graphs.fresh(s) if form == "captured" else s, tels)
        finally:
            tracing.disable()
    assert _identical(out[False], out[True])
    assert len(step.program.captured) == (2 if form == "captured" else 0)


def test_tracing_on_captures_anew_and_off_replays_the_plain_graph():
    prog = Program(lambda x: (x * 2.0,))
    x = torch.arange(3.0)
    prog(x)
    assert len(prog.captured) == 1
    tracing.enable()
    try:
        prog(x)
        prog(x + 1)
        assert len(prog.captured) == 2
        got = tracing.collect()
    finally:
        tracing.disable()
    prog(x)
    assert len(prog.captured) == 2
    assert [s.name for s in got["device"]] == ["<lambda>", "<lambda>"]
    assert [(s.name, s.detail) for s in got["host"]] == [("graphs.capture", "<lambda>")]


def test_one_step_a_frame_its_stages_in_order_tiling_it(traced):
    _, got = traced
    dev = got["device"]
    steps = [i for i, s in enumerate(dev) if s.name == "_step_program"]
    assert [dev[i].frame for i in steps] == list(range(FRAMES))
    for i in steps:
        prog = dev[i]
        inner = [s for s in dev if s.parent == i]
        assert [s.name for s in inner] == ["slam_step", "step.pack"]
        body, pack = inner
        j = dev.index(body)
        stages = [s for s in dev if s.parent == j]
        assert [s.name for s in stages] == STAGES
        assert stages[0].start == body.start and stages[-1].end == body.end
        assert all(a.end == b.start for a, b in zip(stages, stages[1:]))
        assert all(s.start <= s.end for s in stages)
        assert prog.start <= body.start and pack.start == body.end and pack.end == prog.end
        assert all(s.frame == prog.frame for s in (body, pack, *stages))


def test_keyframe_phases_and_frames_across_the_lag(traced):
    s, got = traced
    host = got["host"]
    backends = [i for i, x in enumerate(host) if x.name == "frame.backend"]
    assert len(backends) == s.n_keyframes >= 2
    for i in backends:
        b = host[i]
        phases = [x for x in host if x.parent == i]
        assert {x.name for x in phases} >= PHASES
        assert all(x.frame == b.frame for x in phases)
        parent = host[b.parent]
        # a lagged keyframe's back end runs in the call LAG frames on, or in the flush
        assert (parent.name, parent.frame) in {("frame", b.frame + LAG), ("flush", -1)}
    frames = {x.frame: x for x in host if x.name == "frame"}
    assert sorted(frames) == list(range(FRAMES))
    waits = [x for x in host if x.name == "hostio.wait" and x.detail == "telemetry"]
    assert sorted(x.frame for x in waits) == list(range(FRAMES))
    for x in waits:
        parent = host[x.parent]
        assert parent.name == "flush" or parent.frame == x.frame + LAG
    for name in ("frame.upload", "frame.noise", "frame.replay", "frame.snapshot"):
        spans = [x for x in host if x.name == name]
        assert sorted(x.frame for x in spans) == list(range(FRAMES)), name
        assert all(host[x.parent] is frames[x.frame] for x in spans), name


def test_wrapped_rings_count_what_they_lost(tracing_on, monkeypatch):
    st = tracing._STATE
    monkeypatch.setattr(st, "host", tracing._HostRing(8))
    monkeypatch.setitem(st.rings, torch.device("cpu"),
                        tracing._DeviceRing(torch.device("cpu"), 8))
    tracing.reset()
    for k in range(10):
        with tracing.span("s", frame=k):
            pass
    for _ in range(6):
        tracing.begin("p", "cpu")
        tracing.end("p", "cpu")
    got = tracing.collect()
    assert got["dropped"] == 2 + 4
    assert [x.frame for x in got["host"]] == list(range(2, 10))
    assert [x.name for x in got["device"]] == ["p"] * 4


def test_fit_maps_cpu_stamps_onto_the_host_clock_exactly(traced):
    to_host, err = tracing.fit((10 ** 15, 10 ** 15, 0), (10 ** 15 + 7 * 10 ** 9,) * 2 + (0,))
    d = np.array([10 ** 15 + 1, 10 ** 15 + 123456789, 10 ** 15 + 7 * 10 ** 9 + 3])
    assert err == 0 and np.array_equal(to_host(d), d)
    # a device clock at 3 ns a host ns and 7 ns ahead, read back onto the host's
    h = np.array([5 * 10 ** 9, 6 * 10 ** 9, 9 * 10 ** 9])
    to_host, err = tracing.fit((3 * 10 ** 9 + 7, 10 ** 9, 20), (3 * 10 ** 10 + 7, 10 ** 10, 30))
    assert err == 30 and np.array_equal(to_host(3 * h + 7), h)
    # the CPU's stamps fall inside the host spans around them
    _, got = traced
    assert got["fit_ns"] == 0
    host, dev = got["host"], got["device"]
    replay = {x.frame: x for x in host if x.name == "frame.replay"}
    for x in dev:
        if x.name == "_step_program":
            r = replay[x.frame]
            assert r.start <= x.start <= x.end <= r.end


@pytest.mark.cuda
def test_stamps_replay_inside_the_step_graph_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    seq = make_sequence(np.random.default_rng(11), n_frames=12, width=512, height=384,
                        motion="arc", device_render=True, device=dev)
    bcfg = psystem.BackendConfig(telemetry_lag=3, enable_loop_closure=False)
    tracing.enable()
    try:
        s = psystem.create_system(SlamConfig(), bcfg, seq.rig, (384, 512), device=dev)
        for t in range(4):                     # the captures
            psystem.process_frame(s, seq.left[t], seq.right[t])
        torch.cuda.synchronize()
        tracing.reset()
        stamps = tracing.counters.stamps
        for t in range(4, 12):
            psystem.process_frame(s, seq.left[t], seq.right[t])
        psystem.flush_pipeline(s)
        got = tracing.collect()
    finally:
        tracing.disable()
    (entry,) = s.step.program.captured.values()
    assert entry.graph is not None
    per_replay = entry.launches[graphs._counters().index((tracing.counters, "stamps"))]
    assert per_replay == 2 + 2 + len(STAGES) + 1      # program, slam_step, stages, pack
    assert got["dropped"] == 0 and got["fit_ns"] < 1_000_000
    devs, host, err = got["device"], got["host"], got["fit_ns"]
    steps = [i for i, x in enumerate(devs) if x.name == "_step_program"]
    assert [devs[i].frame for i in steps] == list(range(4, 12))
    assert tracing.counters.stamps - stamps >= 8 * per_replay
    replay = {x.frame: x for x in host if x.name == "frame.replay"}
    wait = {x.frame: x for x in host if x.name == "hostio.wait" and x.detail == "telemetry"}
    for i in steps:
        prog = devs[i]
        body, pack = [x for x in devs if x.parent == i]
        stages = [x for x in devs if x.parent == devs.index(body)]
        assert [x.name for x in stages] == STAGES and pack.name == "step.pack"
        # the stamps of one replay, in the order they were taken
        times = [prog.start, body.start, *[x.end for x in stages], pack.end]
        assert all(a <= b for a, b in zip(times, times[1:])) and pack.end == prog.end
        assert replay[prog.frame].start - err <= prog.start
        assert prog.end <= wait[prog.frame].end + err
