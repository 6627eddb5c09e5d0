"""The port's BAL harness (zenslam_tpu_torch.io.bal) against the reference's
on the CPU: ``make_synthetic_bal`` gives identical arrays for a seed;
``save_bal`` writes byte-identical files and ``load_bal`` reads either
package's file into identical arrays (and refuses a short header or
payload as the reference does); ``bal_subset_ba_problem`` gives the same
problem fields and the same ``info``, and raises on an empty subset."""

import dataclasses

import numpy as np
import pytest

from zenslam_tpu.io import bal as jbal
from zenslam_tpu_torch.io import bal


def _same_bal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


@pytest.mark.parametrize("n_cameras,n_points,seed", [(6, 400, 7), (3, 50, 1)])
def test_synthetic_save_load_identical(tmp_path, n_cameras, n_points, seed):
    data = bal.make_synthetic_bal(n_cameras=n_cameras, n_points=n_points, seed=seed)
    _same_bal(data, jbal.make_synthetic_bal(n_cameras=n_cameras, n_points=n_points, seed=seed))
    bal.save_bal(tmp_path / "port.txt", data)
    jbal.save_bal(tmp_path / "ref.txt", data)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    _same_bal(bal.load_bal(tmp_path / "ref.txt"), jbal.load_bal(tmp_path / "ref.txt"))
    assert bal.load_bal(tmp_path / "port.txt").num_observations == data.num_observations


def test_load_refuses_bad_files(tmp_path):
    for name, text in (("bad.txt", "3 2\n"), ("trunc.txt", "2 2 2\n0 0 1.0 2.0\n")):
        (tmp_path / name).write_text(text)
        with pytest.raises(ValueError):
            bal.load_bal(tmp_path / name)


@pytest.mark.parametrize("kw", [{}, dict(max_cameras=4, max_points=200, max_observations=800),
                                dict(max_cameras=5, max_points=300, min_point_obs=4,
                                     pose_sigma=0.05, seed=3)])
def test_subset_problem_matches_reference(kw):
    data = bal.make_synthetic_bal(n_cameras=6, n_points=400, seed=7)
    p, info = bal.bal_subset_ba_problem(data, device="cpu", **kw)
    jp, jinfo = jbal.bal_subset_ba_problem(data, **kw)
    for name in p._fields:
        a, b = getattr(p, name).numpy(), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert set(info) == set(jinfo)
    for k, v in jinfo.items():
        assert np.asarray(info[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(info[k], v, err_msg=k)
    with pytest.raises(ValueError, match="empty"):
        bal.bal_subset_ba_problem(data, max_cameras=4, max_points=100, max_observations=350,
                                  device="cpu")
