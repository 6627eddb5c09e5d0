"""The traffic generator: seams, schedules, the IMU, the seed."""

import numpy as np
import pytest
import torch

from bench_port import finder, scene, traffic


ORBIT = {"world": "room", "motion": "orbit", "orbit_radius": 1.5, "dt": 0.05, "pool_frames": 160,
         "schedule": "wrap", "pixel_noise": 0.0, "texture_seed": 2, "warmup_frames": 400,
         "trace_before_end_s": 5.0, "trace_frames": 60}


def _traffic(name):
    """A traffic mix's parameters: 'orbit' a room orbit of a lap per 160
    frames (8 s), 'slow-orbit' a lap per 600 (30 s), the kind of mix a VIO
    cell would read; otherwise the traffic file of that name."""
    if name == "orbit":
        return dict(ORBIT)
    if name == "slow-orbit":
        return dict(ORBIT, pool_frames=600)
    return finder.traffic(name)


def test_schedules():
    assert scene.schedule("wrap", 4, np.arange(9)).tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 0]
    assert scene.schedule("pingpong", 4, np.arange(9)).tolist() == [0, 1, 2, 3, 2, 1, 0, 1, 2]
    # consecutive frames are always neighbours in the pool
    for kind in ("wrap", "pingpong"):
        idx = scene.schedule(kind, 5, np.arange(40))
        steps = np.abs(np.diff(idx))
        assert set(steps.tolist()) <= ({1, 4} if kind == "wrap" else {1})


@pytest.mark.parametrize("name", ["orbit", "slow-orbit"])
def test_orbit_pool_wraps_seamlessly(name):
    tfc = _traffic(name)
    poses = scene.pose_fn(tfc)
    n, dt = tfc["pool_frames"], tfc["dt"]
    # the pose one step past the last pool frame is the first pool frame's
    R_end, t_end = poses(np.array([n * dt]))
    R0, t0 = poses(np.array([0.0]))
    np.testing.assert_allclose(R_end, R0, atol=1e-9)
    np.testing.assert_allclose(t_end, t0, atol=1e-9)
    # the IMU of pool frame 0 is the interval that ends the lap
    g0, a0, _ = scene.imu_samples(poses, np.array([0.0]), dt, 10)
    gN, aN, _ = scene.imu_samples(poses, np.array([n * dt]), dt, 10)
    np.testing.assert_allclose(g0, gN, atol=1e-5)
    np.testing.assert_allclose(a0, aN, atol=1e-3)


def test_pingpong_pool_continues_at_its_turns():
    tfc = finder.traffic("patrol")
    R, t = scene.pose_fn(tfc)(np.arange(tfc["pool_frames"]) * tfc["dt"])
    idx = scene.schedule("pingpong", tfc["pool_frames"], np.arange(2 * tfc["pool_frames"]))
    c = -(np.swapaxes(R, 1, 2) @ t[..., None])[..., 0][idx]
    # no jump at the turn larger than the largest step of the leg
    assert np.linalg.norm(np.diff(c, axis=0), axis=1).max() < 0.05


def test_imu_matches_the_program_generator():
    from zenslam_tpu_torch.io.synthetic import make_imu

    tfc = _traffic("slow-orbit")
    poses = scene.pose_fn(tfc)
    times = np.arange(4) * tfc["dt"]
    g, a, _, _ = make_imu(lambda x: tuple(v[0] for v in poses(np.array([x]))), times, 10)
    g1, a1, d1 = scene.imu_samples(poses, times, tfc["dt"], 10)
    np.testing.assert_allclose(g1[1:], g[1:], atol=1e-6)
    np.testing.assert_allclose(a1[1:], a[1:], atol=1e-5)
    assert d1.sum(1) == pytest.approx(np.full(4, tfc["dt"]))


def test_pool_from_the_seed():
    cfg = {"width": 48, "height": 32, "fx": 40.0, "fy": 40.0, "cx": 24.0, "cy": 16.0,
           "baseline": 0.1, "imu": {"samples_per_frame": 10}}
    tfc = dict(ORBIT, pool_frames=3, pixel_noise=0.01)
    a = traffic.build_pool(cfg, tfc, 2 ** 33 + 5, "cpu")
    b = traffic.build_pool(cfg, tfc, 2 ** 33 + 5, "cpu")
    c = traffic.build_pool(cfg, tfc, 7, "cpu")
    assert torch.equal(a.left, b.left) and torch.equal(a.right, b.right)
    assert not torch.equal(a.left, c.left)
    np.testing.assert_array_equal(a.R_cw, c.R_cw)     # the seed draws pixels, not the work
    assert a.left.shape == (3, 32, 48) and float(a.left.min()) >= 0.0
    assert a.imu[0].shape == (3, 10, 3)
