"""The port's application (python -m zenslam_tpu_torch.app) against the
reference's (python -m zenslam_tpu.app) on the CPU, end to end.

One 384x288 strafe sequence with IMU is rendered, lens-distorted (radtan)
and exported as an EuRoC-layout folder with a Kalibr camchain and
``imu0/data.csv``, once by each package's writers (the two folders agree:
camchain, groundtruth and IMU text identical, images within one 8-bit level
on >= 99.9% of pixels, the rest from the remap's last bit). Both apps run
the recipe's path on the reference's folder with rectification and CLAHE
on, ``--no-imu`` (tests/test_torch_app_imu.py runs them with the IMU
stream):

- same number of trajectory rows and keyframes, and ATE within 2 mm;
- the same telemetry columns and the same effective options, with the
  Kalibr IMU noise densities in the ``SlamConfig.imu_*`` fields;
- the port's checker (zenslam_tpu_torch.eval.check_run) passes on the
  port's run and fails on a corrupted trajectory.

The reference's run goes in a subprocess of its own, started as soon as
its folder is written, while the port's runs here: the reference's time is
almost all XLA compiles.

The size: at 256x192 both packages track this sequence with frame-to-frame
pose noise far above 2 mm (the same in both), so two free runs with
different random draws cannot agree to 2 mm there; at 384x288 both do.

Also ``--viz`` on the port's run (the reference test's artifacts, the
trajectory unchanged), ``backend.ba_solver: dist`` against the dense
solver on the folder's first frames, and no CUDA without --device; and the
keylines recipe (options/euroc_mh_lines.yaml) builds a system that steps a
frame with keylines.
"""

import contextlib
import csv
import json
import os
import subprocess
import sys
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
DIST_TAKE = 4            # frames of the app's ba_solver: dist run (one BA run)
W, H = 384, 288
IMU_NOISE = {"gyroscope_noise_density": 1.2e-4, "accelerometer_noise_density": 2.1e-3,
             "gyroscope_random_walk": 2.0e-5, "accelerometer_random_walk": 3.0e-4}


def export_reference(root: Path) -> Path:
    """The reference's folder, the one both apps run on, under ``root``."""
    jseq = jsyn.distort_sequence(jsyn.make_sequence(
        np.random.default_rng(5), n_frames=N_FRAMES, width=W, height=H, motion="strafe",
        speed=0.5, with_imu=True), DIST)
    jsyn.export_dataset(jseq, str(root / "ref"))
    jsyn.write_kalibr_yaml(jseq, DIST, str(root / "ref" / "camchain.yaml"))
    (root / "ref" / "imu_config.yaml").write_text(yaml.safe_dump(IMU_NOISE))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return export_reference(tmp_path_factory.mktemp("app"))


@contextlib.contextmanager
def reference_app(root: Path, out: str, *extra):
    """The reference app on its folder in a process of its own, under way
    while the body runs; yields a function that waits for it and returns its
    output folder."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    opts = _options(root, root / "ref", out)
    with open(root / f"{out}.log", "w") as log:
        p = subprocess.Popen([sys.executable, "-m", "zenslam_tpu.app", "--options-file", opts,
                              "--no-scene", *extra], cwd=REPO, env=env, stdout=log,
                             stderr=subprocess.STDOUT)

    def wait() -> Path:
        assert p.wait(timeout=600) == 0, (root / f"{out}.log").read_text()[-4000:]
        return root / out

    try:
        yield wait
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference_run(root):
    with reference_app(root, "out_ref", "--no-imu") as wait:
        yield wait


@pytest.fixture(scope="module")
def datasets(root, reference_run):
    """Both writers' folders; the reference's run is under way meanwhile."""
    pseq = psyn.distort_sequence(psyn.make_sequence(
        np.random.default_rng(5), n_frames=N_FRAMES, width=W, height=H, motion="strafe",
        speed=0.5, with_imu=True, device="cpu"), DIST)
    psyn.export_dataset(pseq, str(root / "port"))
    psyn.write_kalibr_yaml(pseq, DIST, str(root / "port" / "camchain.yaml"))
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
    for f in ("camchain.yaml", "groundtruth.csv", "imu0/data.csv"):
        assert (port / f).read_text() == (ref / f).read_text(), f
    for cam in ("cam0/data", "cam1/data"):
        names = sorted(os.listdir(ref / cam))
        assert names == sorted(os.listdir(port / cam)) and len(names) == N_FRAMES
        for n in names:
            a = decode_png_gray(str(port / cam / n)).astype(int)
            b = decode_png_gray(str(ref / cam / n)).astype(int)
            assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999


@pytest.fixture(scope="module")
def runs(datasets, reference_run):
    from zenslam_tpu_torch.app import main as port_main

    data = datasets / "ref"
    assert port_main(["--options-file", _options(datasets, data, "out_port"), "--no-imu",
                      "--device", "cpu"]) == 0
    return reference_run(), datasets / "out_port", data


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


@pytest.mark.parametrize("case", ["viz", "dist"])
def test_viz_and_dist_runs(datasets, request, capsys, case):
    """``--viz`` writes the reference test's artifacts (tests/test_app.py's
    TestVizOverlays: diagnostics.html, >= 2 spatial and >= 1 temporal
    overlay PNGs of the stereo pair's geometry with green match markers)
    and leaves the trajectory of the fixture's run without it unchanged;
    ``backend.ba_solver: dist`` runs the app on the fixture's folder over
    the first DIST_TAKE frames (two keyframes, one BA run) within 2e-3 m of
    the dense run's trajectory on the same frames."""
    from zenslam_tpu_torch.app import main

    def run(out, backend, *extra):
        path = Path(_options(datasets, datasets / "ref", out))
        opts = yaml.safe_load(path.read_text())
        opts["backend"].update(backend)
        path.write_text(yaml.safe_dump(opts))
        return main(["--options-file", str(path), "--device", "cpu", "--no-imu", "--no-scene",
                     *extra])

    if case == "viz":
        _, port, _ = request.getfixturevalue("runs")
        assert run("out_viz", {}, "--viz") == 0
        out = datasets / "out_viz"
        assert "viz: timing plots written" in capsys.readouterr().out
        html = (out / "diagnostics.html").read_text()
        assert "spatial_" in html and "keyframes" in html
        viz = sorted(os.listdir(out / "viz"))
        spatial = [f for f in viz if f.startswith("spatial_")]
        temporal = [f for f in viz if f.startswith("temporal_")]
        assert len(spatial) >= 2 and len(temporal) >= 1
        assert all(f in html for f in spatial)
        import matplotlib.image as mpimg
        img = mpimg.imread(str(out / "viz" / spatial[-1]))
        assert img.shape[:2] == (H, 2 * W)
        rgb = img[..., :3]
        green = (rgb[..., 1] > 0.6) & (rgb[..., 0] < 0.5) & (rgb[..., 2] < 0.5)
        assert green.sum() > 50
        assert mpimg.imread(str(out / "viz" / temporal[-1])).shape[:2] == (H, W)
        assert (out / "trajectory.csv").read_text() == (port / "trajectory.csv").read_text()
        return
    trajectories = {}
    for out, bk in (("out_dist", dict(ba_solver="dist")), ("out_dense", dict(ba_solver="dense"))):
        capsys.readouterr()
        assert run(out, bk, "--take", str(DIST_TAKE)) == 0
        printed = capsys.readouterr().out
        assert "BA runs: 1," in printed, printed
        trajectories[out] = np.loadtxt(datasets / out / "trajectory.csv", delimiter=",")
    assert trajectories["out_dist"].shape == (DIST_TAKE, 4)
    np.testing.assert_allclose(trajectories["out_dist"], trajectories["out_dense"], atol=2e-3)


def test_keylines_recipe_loads_and_system_raises():
    """The keylines recipe's options build a system (it raised before
    keylines were ported), and a frame of the corridor with stripes goes
    through ``process_frame`` on the keyline branch. As shipped (CLAHE on)
    the detector finds no keyline there, in the reference too: after CLAHE
    no cell's perpendicular spread passes the 1.6 px gate. With CLAHE off
    the same options find and track them."""
    from zenslam_tpu_torch.config import load_options
    from zenslam_tpu_torch.pipeline.system import create_system, process_frame

    opts = load_options(str(REPO / "options" / "euroc_mh_lines.yaml"))
    assert opts.slam.use_keylines and opts.slam.use_clahe
    seq = psyn.make_sequence(np.random.default_rng(11), n_frames=2, width=256, height=192,
                             motion="strafe", with_lines=True, device="cpu")
    found = {}
    for clahe_on in (True, False):
        s = create_system(opts.slam._replace(use_clahe=clahe_on), opts.backend, seq.rig,
                          (192, 256), device="cpu")
        for t in range(2):
            process_frame(s, torch.from_numpy(seq.left[t]), torch.from_numpy(seq.right[t]))
        found[clahe_on] = (int(s.state.lines.valid.sum()), int(s.state.next_line_id))
    assert found[True] == (0, 0)
    assert found[False][0] >= 4 and found[False][1] >= 4, found


def test_app_needs_cuda_unless_told(datasets, monkeypatch):
    from zenslam_tpu_torch.app import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--options-file", _options(datasets, datasets / "ref", "out_nocuda"), "--no-imu"])
    assert main(["--version"]) == 0
