"""The window's arithmetic, the trace's reduction, the no-JAX check and
the frozen roofline counts."""

import numpy as np
import pytest

from bench_port import roofline, run, trace


def _window(n=400, step=0.02, lag=3, stall_at=None, stall=0.5):
    """A closed loop of ``n`` calls: each returns the frame submitted ``lag``
    calls before; one call may stall."""
    t, sub, ret = 0.0, {}, {}
    for f in range(n):
        sub[f] = t
        t += step + (stall if f == stall_at else 0.0)
        if f >= lag:
            ret[f - lag] = t
    for f in range(n - lag, n):
        ret[f] = t
    return sub, ret, 0.0, t


def test_fps_is_over_the_whole_window():
    s = run.window_stats(*_window())
    assert s["fps"] == pytest.approx(400 / (400 * 0.02))
    stalled = run.window_stats(*_window(stall_at=100))
    assert stalled["fps"] == pytest.approx(400 / (400 * 0.02 + 0.5))


def test_p95_is_over_all_frames_and_a_stall_moves_it():
    s = run.window_stats(*_window())
    assert s["frame_p95_ms"] == pytest.approx(80.0)
    # a stall of 0.5 s delays the 4 frames in flight: 1% of frames, not p95
    assert run.window_stats(*_window(stall_at=100))["frame_p95_ms"] == pytest.approx(80.0)
    # stalls every 10 frames delay 40% of the frames: p95 moves
    sub, ret, t0, t1 = _window()
    for f in range(0, 400, 10):
        for g in range(f - 3, f + 1):
            if g in ret:
                ret[g] += 0.2
    assert run.window_stats(sub, ret, t0, t1 + 0.2)["frame_p95_ms"] > 200.0


def test_a_frame_that_never_comes_back_counts_to_the_window_end():
    sub, ret, t0, t1 = _window()
    del ret[10]
    s = run.window_stats(sub, ret, t0, t1)
    assert s["returned"] == 399
    assert s["latency_ms"].max() == pytest.approx((t1 - sub[10]) * 1e3)


def test_busy_is_a_union_not_a_sum():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("k3", 0.6, 0.7), ("k4", 3.0, 3.5)]
    host = [("bench.stretch", 0.0, 4.0), ("cudaGraphLaunch", 1.6, 2.9)]
    r = trace.reduce(dev, host, 0.0, 4.0)
    assert r["busy_s"] == pytest.approx(2.0)           # a sum would read 3.1
    assert r["window_s"] == pytest.approx(4.0)
    assert r["kernels"]["k2"] == (1, pytest.approx(1.0))
    assert r["idle_gaps"][0][0] == "bench.stretch/cudaGraphLaunch"
    assert r["idle_gaps"][0][1] == pytest.approx(1.5)
    # clipped to the stretch
    assert trace.reduce(dev, host, 0.5, 1.0)["busy_s"] == pytest.approx(0.5)


def test_the_profilers_own_idle_time_is_not_the_programs():
    dev = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0)]
    host = [("bench.stretch", 0.0, 4.0), ("Buffer Flush", 1.2, 1.5),
            ("Activity Buffer Request", 2.5, 3.4), ("cudaGraphLaunch", 1.0, 2.0)]
    r = trace.reduce(dev, host, 0.0, 4.0)
    # idle 2.0 s: 0.3 s of it the flush, 0.4 s the request (the part after the kernel)
    assert r["profiler_s"] == pytest.approx(0.7)
    assert r["window_s"] == pytest.approx(3.3)
    assert r["busy_s"] == pytest.approx(2.0)
    assert dict(r["idle_gaps"]) == {"bench.stretch/cudaGraphLaunch": pytest.approx(0.7),
                                    "bench.stretch (python)": pytest.approx(0.6)}


def test_frames_in_flight_during_the_traced_stretch_are_left_out():
    sub, ret, t0, t1 = _window(n=100)
    lat = run.untraced_latency(sub, ret, t1, (0.51, 1.01))
    # 25 submitted in it, and 4 submitted before it that came back in it
    assert len(lat) == len(sub) - 25 - 4
    assert len(run.untraced_latency(sub, ret, t1, None)) == len(sub)


def test_union_merges_and_sorts():
    assert trace.union([(2, 3), (0, 1), (0.5, 2.5)]) == [(0, 3)]
    assert trace.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["zenslam_tpu_torch", "zenslam_tpu_torch.ops"]) == []
    assert run.forbidden_modules(["numpy", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["zenslam_tpu.pipeline", "jax.numpy", "jaxlib", "flax"]) \
        == ["flax", "jax", "jaxlib", "zenslam_tpu"]


def test_frozen_roofline_counts_reproduce_the_1024_bounds():
    assert roofline.kernel("lk_fb").bound_s({}) * 1e3 == pytest.approx(0.00163, abs=5e-6)
    assert roofline.kernel("orb").bound_s({}) * 1e3 == pytest.approx(0.00029, abs=5e-6)
    cfg = {"slam": {"max_keypoints": 1024}}
    assert roofline.kernel("lk_fb").bound_s(cfg) == pytest.approx(
        2 * roofline.kernel("lk_fb").bound_s({}))


def test_roofline_share_reads_the_trace():
    one = roofline.kernel("orb").bound_s({})
    tr = {"kernels": {"orb_kernel(int)": (4, 4 * one * 10), "other": (9, 1.0)}}
    assert roofline.share(tr, "orb", {}) == pytest.approx(10.0)
    assert roofline.share(tr, "lk_fb", {}) is None
    assert roofline.share(None, "orb", {}) is None
