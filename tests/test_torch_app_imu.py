"""The port's application against the reference's on the CPU with the IMU
stream: the recipe as shipped, the folder's ``imu0/data.csv`` driving the
VIO branch, on tests/test_torch_app.py's 384x288 distorted strafe folder
(written by the reference, rectification and CLAHE on). The port prints
that the VIO branch is on, keeps pose_ok after frame 0, and matches the
reference's number of trajectory rows and keyframes, with ATE within 2 mm
of the reference's (and under 1 cm). The reference runs in a process of
its own while the port's run goes here.
"""

import contextlib
import io

import pytest
import torch

from test_torch_app import N_FRAMES, _ate, _options, _rows, export_reference, reference_app

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs_imu(tmp_path_factory):
    from zenslam_tpu_torch.app import main as port_main

    root = export_reference(tmp_path_factory.mktemp("app_imu"))
    data = root / "ref"
    with reference_app(root, "imu_ref") as wait:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert port_main(["--options-file", _options(root, data, "imu_port"),
                              "--no-scene", "--device", "cpu"]) == 0
        ref = wait()
    return ref, root / "imu_port", data, out.getvalue()


def test_app_with_imu_matches_reference(runs_imu):
    """The recipe as shipped: the folder's IMU stream drives the VIO branch."""
    ref, port, data, printed = runs_imu
    assert "IMU stream found — VIO branch enabled" in printed
    rr, pr = _rows(ref), _rows(port)
    assert len(pr) == len(rr) == N_FRAMES
    kf = [sum(r["is_keyframe"] == "True" for r in rows) for rows in (pr, rr)]
    assert kf[0] == kf[1] >= 3
    assert all(r["pose_ok"] == "True" for r in pr[1:])
    ate_p, ate_r = _ate(port, data), _ate(ref, data)
    assert ate_p < 0.01 and abs(ate_p - ate_r) < 2e-3, (ate_p, ate_r)
