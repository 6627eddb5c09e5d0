"""The port's application (python -m zenslam_tpu_torch.app) against the
reference's (python -m zenslam_tpu.app) on the CPU, end to end.

One 384x288 strafe sequence is rendered, lens-distorted (radtan) and
exported as an EuRoC-layout folder with a Kalibr camchain, once by each
package's writers (the two folders agree: camchain and groundtruth text
identical, images within one 8-bit level on >= 99.9% of pixels, the rest
from the remap's last bit). Both apps run the recipe's path on the
reference's folder, ``--no-imu``, with rectification and CLAHE on:

- same number of trajectory rows and keyframes, and ATE within 2 mm;
- the same telemetry columns and the same effective options, with the
  Kalibr IMU noise densities in the ``SlamConfig.imu_*`` fields;
- the port's checker (zenslam_tpu_torch.eval.check_run) passes on the
  port's run and fails on a corrupted trajectory.

The size: at 256x192 both packages track this sequence with frame-to-frame
pose noise far above 2 mm (the same in both), so two free runs with
different random draws cannot agree to 2 mm there; at 384x288 both do.

Also the guards: an IMU stream without --no-imu (item 11), --viz (item 18),
keylines (item 13), ba_solver dist (item 17), and no CUDA without --device.
"""

import csv
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from zenslam_tpu.io import synthetic as jsyn
from zenslam_tpu_torch.eval import check_run
from zenslam_tpu_torch.eval.metrics import ate_rmse
from zenslam_tpu_torch.io import synthetic as psyn
from zenslam_tpu_torch.io.dataset import Groundtruth

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
DIST = [-0.05, 0.01, 1e-4, -1e-4]
N_FRAMES = 14
W, H = 384, 288
IMU_NOISE = {"gyroscope_noise_density": 1.2e-4, "accelerometer_noise_density": 2.1e-3,
             "gyroscope_random_walk": 2.0e-5, "accelerometer_random_walk": 3.0e-4}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    jseq = jsyn.distort_sequence(jsyn.make_sequence(
        np.random.default_rng(5), n_frames=N_FRAMES, width=W, height=H, motion="strafe",
        speed=0.5), DIST)
    jsyn.export_dataset(jseq, str(root / "ref"))
    jsyn.write_kalibr_yaml(jseq, DIST, str(root / "ref" / "camchain.yaml"))
    pseq = psyn.distort_sequence(psyn.make_sequence(
        np.random.default_rng(5), n_frames=N_FRAMES, width=W, height=H, motion="strafe",
        speed=0.5, device="cpu"), DIST)
    psyn.export_dataset(pseq, str(root / "port"))
    psyn.write_kalibr_yaml(pseq, DIST, str(root / "port" / "camchain.yaml"))
    (root / "ref" / "imu_config.yaml").write_text(yaml.safe_dump(IMU_NOISE))
    return root


def _options(root: Path, data: Path, out: str, **folder) -> str:
    opts = {
        "folder": dict(root=str(data), output=str(root / out),
                       calibration_file=str(data / "camchain.yaml"),
                       imu_calibration_file=str(data / "imu_config.yaml"),
                       groundtruth_file=str(data / "groundtruth.csv"), **folder),
        "slam": {"use_clahe": True, "max_keypoints": 256, "max_landmarks": 2048,
                 "kf_min_frames": 2, "kf_min_translation": 0.04},
        "backend": {"ba_every_kf": True, "enable_loop_closure": True, "ba_window": 8,
                    "telemetry_lag": 3},
    }
    path = root / f"{out}.yaml"
    path.write_text(yaml.safe_dump(opts))
    return str(path)


def test_writers_agree(datasets):
    from zenslam_tpu_torch.native.loader import decode_png_gray

    ref, port = datasets / "ref", datasets / "port"
    for f in ("camchain.yaml", "groundtruth.csv"):
        assert (port / f).read_text() == (ref / f).read_text(), f
    for cam in ("cam0/data", "cam1/data"):
        names = sorted(os.listdir(ref / cam))
        assert names == sorted(os.listdir(port / cam)) and len(names) == N_FRAMES
        for n in names:
            a = decode_png_gray(str(port / cam / n)).astype(int)
            b = decode_png_gray(str(ref / cam / n)).astype(int)
            assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999


@pytest.fixture(scope="module")
def runs(datasets):
    from zenslam_tpu.app import main as ref_main
    from zenslam_tpu_torch.app import main as port_main

    data = datasets / "ref"
    assert ref_main(["--options-file", _options(datasets, data, "out_ref"), "--no-imu",
                     "--no-scene"]) == 0
    assert port_main(["--options-file", _options(datasets, data, "out_port"), "--no-imu",
                      "--device", "cpu"]) == 0
    return datasets / "out_ref", datasets / "out_port", data


def _rows(out: Path):
    with open(out / "frame_data.csv", newline="") as f:
        return list(csv.DictReader(f))


def _ate(out: Path, data: Path) -> float:
    ts, est = check_run.load_trajectory(str(out / "trajectory.csv"))
    gt = Groundtruth(str(data / "groundtruth.csv"))
    return ate_rmse(est, np.stack([gt.pose_at(t)[1] for t in ts]))


def test_app_matches_reference(runs):
    ref, port, data = runs
    rr, pr = _rows(ref), _rows(port)
    assert len(pr) == len(rr) == N_FRAMES
    assert list(pr[0]) == list(rr[0])
    kf = [sum(r["is_keyframe"] == "True" for r in rows) for rows in (pr, rr)]
    assert kf[0] == kf[1] >= 3
    assert (np.loadtxt(port / "trajectory.csv", delimiter=",").shape
            == np.loadtxt(ref / "trajectory.csv", delimiter=",").shape)
    ate_p, ate_r = _ate(port, data), _ate(ref, data)
    assert ate_p < 0.01 and abs(ate_p - ate_r) < 2e-3, (ate_p, ate_r)
    # the last telemetry_lag rows come from flush_pipeline, which times no step
    assert min(float(r["duration_step_ms"]) for r in pr[:-3]) > 0
    assert any(float(r["duration_backend_ms"]) > 0 for r in pr)
    eff = [yaml.safe_load((d / "effective_options.yaml").read_text()) for d in (port, ref)]
    for e in eff:
        e["folder"].pop("output")
    assert eff[0] == eff[1] and eff[0]["slam"]["use_clahe"] is True
    assert eff[0]["slam"]["imu_gyro_noise"] == IMU_NOISE["gyroscope_noise_density"]
    assert eff[0]["slam"]["imu_accel_bias_walk"] == IMU_NOISE["accelerometer_random_walk"]
    for f in ("scene.ply", "scene.html", "scene_3d.png"):
        assert (port / f).is_file()


def test_checker_passes_and_fails(runs, tmp_path):
    _, port, data = runs
    exp = json.loads((REPO / "options" / "euroc_mh_expected.json").read_text())
    # a 384x288 frame holds fewer features than the recipe's 752x480 one
    exp["min_tracked_mean"] = 100
    exp_path = tmp_path / "expected.json"
    exp_path.write_text(json.dumps(exp))
    assert check_run.main([str(port), "--expected", str(exp_path)]) == 0
    bad = tmp_path / "bad"
    bad.mkdir()
    for f in ("frame_data.csv", "effective_options.yaml"):
        (bad / f).write_text((port / f).read_text())
    ts, est = check_run.load_trajectory(str(port / "trajectory.csv"))
    rng = np.random.default_rng(0)
    with open(bad / "trajectory.csv", "w") as f:
        f.write("# timestamp, px, py, pz\n")
        for t in ts:
            f.write(f"{t:.9f}, {rng.random() * 5}, 0.0, 0.0\n")
    assert check_run.main([str(bad), "--expected", str(exp_path)]) == 1


@pytest.mark.parametrize("extra,folder,slam,backend,match", [
    ([], dict(imu_file="groundtruth.csv"), {}, {}, "item 11.*--no-imu"),
    (["--viz"], {}, {}, {}, "item 18"),
    (["--no-imu"], {}, dict(use_keylines=True), {}, "item 13"),
    (["--no-imu"], {}, {}, dict(ba_solver="dist"), "item 17"),
])
def test_unported_paths_raise(datasets, extra, folder, slam, backend, match):
    from zenslam_tpu_torch.app import main

    path = Path(_options(datasets, datasets / "ref", "out_guard", **folder))
    opts = yaml.safe_load(path.read_text())
    opts["slam"].update(slam)
    opts["backend"].update(backend)
    path.write_text(yaml.safe_dump(opts))
    with pytest.raises(NotImplementedError, match=match):
        main(["--options-file", str(path), "--device", "cpu", *extra])


def test_keylines_recipe_loads_and_system_raises():
    from zenslam_tpu_torch.config import load_options
    from zenslam_tpu_torch.pipeline.system import create_system

    opts = load_options(str(REPO / "options" / "euroc_mh_lines.yaml"))
    assert opts.slam.use_keylines and opts.slam.use_clahe
    rig = psyn.default_rig(64, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        create_system(opts.slam, opts.backend, rig, (64, 64), device="cpu")


def test_app_needs_cuda_unless_told(datasets, monkeypatch):
    from zenslam_tpu_torch.app import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--options-file", _options(datasets, datasets / "ref", "out_nocuda"), "--no-imu"])
    assert main(["--version"]) == 0
