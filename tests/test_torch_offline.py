"""The port's offline chunked mode (zenslam_tpu_torch.parallel.offline) on the
CPU: ``split_chunks`` and ``stitch_chunks`` give the reference's outputs
exactly; the in-process chunker with one chunk is the serial run, with three
it stays within max(3x the serial ATE, 3 cm) (tests/test_offline.py's bar);
and two worker processes give the in-process chunker's stitched
trajectory within 5e-3 (the same chunks and seed; tests/test_offline.py's
bar). The reference test's wall-clock race between 1 and 2 workers is left
out here, where the other test workers share the cores; ``chip_smoke.py``
reports the wall times on the card.
"""

import numpy as np
import pytest
import torch

from zenslam_tpu.parallel import offline as joffline
from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
from zenslam_tpu_torch.io.synthetic import make_sequence
from zenslam_tpu_torch.parallel import offline
from zenslam_tpu_torch.pipeline import SlamConfig, run_sequence

torch.set_num_threads(2)
CFG = SlamConfig(max_keypoints=192, max_landmarks=2048, pnp_iters=64, rigid_iters=64)


@pytest.mark.parametrize("T,C,V", [(30, 3, 3), (64, 4, 2), (10, 1, 2), (17, 5, 3), (5, 4, 3),
                                   (100, 7, 1), (16, 3, 4), (3, 2, 2)])
def test_split_chunks_matches_reference(T, C, V):
    b = offline.split_chunks(T, C, V)
    assert b == joffline.split_chunks(T, C, V)
    assert b[0][0] == 0 and b[-1][1] == T
    for (s0, e0), (s1, e1) in zip(b, b[1:]):
        assert s1 == e0 - V and e1 > e0


@pytest.mark.parametrize("C,V", [(1, 3), (3, 3), (4, 2)])
def test_stitch_chunks_matches_reference(C, V):
    rng = np.random.default_rng(C * 10 + V)
    T = 20
    bounds = offline.split_chunks(T, C, V)
    results = []
    for s, e in bounds:
        n = e - s
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        M = int(rng.integers(5, 12))
        results.append((q.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
                        rng.normal(size=(M, 3)).astype(np.float32), rng.random(M) > 0.3,
                        rng.integers(-2 ** 31, 2 ** 31, (M, 8)).astype(np.int32)))
    out = offline.stitch_chunks(T, bounds, results, V)
    ref = joffline.stitch_chunks(T, bounds, results, V)
    assert out["bounds"] == ref["bounds"] and set(out) == set(ref)
    for k in ("R_cw", "t_cw", "map_xyz", "map_desc"):
        assert out[k].dtype == ref[k].dtype and np.array_equal(out[k], ref[k]), k


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=10, motion="arc", speed=0.5,
                         width=320, height=240, device="cpu")


@pytest.fixture(scope="module")
def serial(seq):
    return run_sequence(CFG, seq.rig, seq.left, seq.right, device="cpu")[1]


def test_single_chunk_is_serial(seq, serial):
    out = offline.run_offline_chunks(CFG, seq.rig, seq.left, seq.right, n_chunks=1,
                                     device="cpu")
    np.testing.assert_allclose(out["t_cw"], serial.t_cw, atol=1e-5)
    np.testing.assert_allclose(out["R_cw"], serial.R_cw, atol=1e-5)


def test_three_chunks_match_serial_ate(seq, serial):
    gt = camera_positions(seq.R_lw, seq.t_lw)
    ate_serial = ate_rmse(camera_positions(serial.R_cw, serial.t_cw), gt)
    out = offline.run_offline_chunks(CFG, seq.rig, seq.left, seq.right, n_chunks=3,
                                     overlap=4, device="cpu")
    ate_chunked = ate_rmse(camera_positions(out["R_cw"], out["t_cw"]), gt)
    assert ate_chunked < max(3.0 * ate_serial, 0.03), (ate_serial, ate_chunked)
    assert out["map_xyz"].shape[0] > 200 and np.isfinite(out["map_xyz"]).all()
    assert out["bounds"] == [(0, 6), (2, 8), (4, 10)]
    assert out["map_desc"].dtype == np.int32 and out["map_desc"].shape[1:] == (8,)


def test_two_workers_match_in_process(seq, tmp_path):
    out = offline.run_offline_multiprocess(CFG, seq.rig, seq.left, seq.right, n_workers=2,
                                           overlap=4, workdir=str(tmp_path), device="cpu",
                                           cpus_per_worker=1, timeout=300)
    ref = offline.run_offline_chunks(CFG, seq.rig, seq.left, seq.right, n_chunks=2,
                                     overlap=4, device="cpu")
    assert out["bounds"] == ref["bounds"] == [(0, 7), (3, 10)]
    np.testing.assert_allclose(out["t_cw"], ref["t_cw"], atol=5e-3)
    assert out["map_xyz"].shape == ref["map_xyz"].shape
