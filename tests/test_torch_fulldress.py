"""The full-dress run's pieces on the CPU: the photometric sequence, the
port's ``eval/fulldress.py`` against ``e2e_fulldress.py``, and
``scripts/trace_check.py``'s rigs through the port's ``slam_step``.

- ``make_sequence`` with ``exposure_jitter``, ``vignette`` and
  ``pixel_noise`` (4 frames of 96x128, one seed): the host render
  bit-identical to the reference's; on the device path the effects (in the
  dtypes numpy gives the reference) bit-identical given the reference's own
  device render of each view (the two frameworks' float32 ray-plane
  renders differ by a few 1e-5 with or without the effects, as since the
  port's first slice); the reference test's properties (corners darker
  than the centre, per-frame and per-camera gains) on the host frames.
- ``build_dataset(hard=True)`` at 128x160, 6 frames, in both packages:
  PNG names equal and pixels within one 8-bit level on >= 99.9%,
  ``groundtruth.csv``, ``imu0/data.csv`` and ``camchain.yaml`` identical;
  then the port's app on the port's folder on the CPU with the hard flags:
  exit 0, 6 trajectory rows, and the ATE that ``fulldress`` recomputes
  equal to ``eval/check_run.py``'s within 1e-6 mm.
- The four rigs of ``scripts/trace_check.py:52-71`` (96x128 default,
  128x160 CLAHE + fusion, 96x128 keylines, zero width/height metadata),
  one step each, as that script runs, on its random images with its IMU
  slice: finite poses (``chip_smoke.py``'s ``[rigs]`` steps two frames of
  each on the card). (A parity run of the reference's ``slam_step`` on the
  default rig costs ~18 s of XLA compiles here and is left out.)
"""

import importlib.util
import os
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from zenslam_tpu.io import synthetic as jsyn
from zenslam_tpu_torch.eval import check_run, fulldress
from zenslam_tpu_torch.io import synthetic as psyn
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state
from zenslam_tpu_torch.pipeline.step import slam_step

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SEQ = dict(n_frames=4, width=128, height=96, motion="arc", speed=0.5, **fulldress.PHOTOMETRIC)


def _reference_render(world, cam, R_cw, t_cw, height, width, device):
    """The reference's device render of a view, handed to the port's
    pipeline as a tensor on ``device``."""
    c = SimpleNamespace(**{k: float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy")})
    return torch.from_numpy(np.asarray(jsyn.render_view_device(
        world, c, np.asarray(R_cw, np.float32), np.asarray(t_cw, np.float32), height,
        width))).to(device)


@pytest.mark.parametrize("render", ["host", "device"])
def test_photometric_sequence_matches_reference(render, monkeypatch):
    dev = render == "device"
    ref = jsyn.make_sequence(np.random.default_rng(11), device_render=dev, **SEQ)
    if dev:
        monkeypatch.setattr(psyn, "render_view_device", _reference_render)
        mine = psyn.make_sequence(np.random.default_rng(11), device_render=True, device="cpu",
                                  **SEQ)
        assert mine.left.dtype == torch.float32
        np.testing.assert_array_equal(mine.left.numpy(), ref.left)
        np.testing.assert_array_equal(mine.right.numpy(), ref.right)
        return
    mine = psyn.make_sequence(np.random.default_rng(11), device="cpu", **SEQ)
    np.testing.assert_array_equal(mine.R_lw, ref.R_lw)
    np.testing.assert_array_equal(mine.t_lw, ref.t_lw)
    assert mine.left.dtype == ref.left.dtype == np.float32
    np.testing.assert_array_equal(mine.left, ref.left)
    np.testing.assert_array_equal(mine.right, ref.right)
    # tests/test_io.py's properties of the effects
    img = mine.left[0]
    assert img[:12, :12].mean() < img[40:56, 56:72].mean()     # corners darker
    assert np.std([f.mean() for f in mine.left]) > 0.01        # per-frame flicker
    ratio = np.log([l.mean() / r.mean() for l, r in zip(mine.left, mine.right)])
    assert np.std(ratio) > 0.05                                # per-camera gains


def _reference_fulldress():
    """``e2e_fulldress.py`` as a module (it sets a compile-cache variable
    when imported; the environment is restored after)."""
    with mock.patch.dict(os.environ):
        spec = importlib.util.spec_from_file_location("e2e_fulldress", REPO / "e2e_fulldress.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _png(path: Path) -> np.ndarray:
    from zenslam_tpu_torch.native.loader import decode_png_gray

    return decode_png_gray(str(path))


def test_hard_dataset_matches_reference_and_runs(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    _reference_fulldress().build_dataset(str(ref), 6, width=160, height=128, hard=True)
    fulldress.build_dataset(str(port), 6, width=160, height=128, hard=True, device="cpu")
    for f in ("groundtruth.csv", "imu0/data.csv", "camchain.yaml"):
        assert (ref / f).read_text() == (port / f).read_text(), f
    names = sorted(p.relative_to(ref) for p in ref.glob("cam*/data/*.png"))
    assert len(names) == 12
    assert names == sorted(p.relative_to(port) for p in port.glob("cam*/data/*.png"))
    d = np.concatenate([np.abs(_png(ref / n).astype(np.int32) - _png(port / n)).ravel()
                        for n in names])
    assert d.max() <= 255 and (d <= 1).mean() >= 0.999, (d.max(), (d <= 1).mean())

    opts = fulldress.write_options(str(port), hard=True)
    assert fulldress.run_app(opts, "cpu") == 0
    out = port / "output"
    rows = [l for l in (out / "trajectory.csv").read_text().splitlines() if not l.startswith("#")]
    assert len(rows) == 6
    ate, rpe = fulldress.trajectory_errors_mm(str(port), str(out))
    r = check_run.check(str(out))
    assert abs(ate - r["ate_mm"]) <= 1e-6 and abs(rpe - r["rpe_mm"]) <= 1e-6
    assert np.isfinite(ate)


RIGS = {   # scripts/trace_check.py:52-71: (H, W, SlamConfig fields, zero metadata, image seed)
    "default": (96, 128, {}, False, 0),
    "clahe_fusion": (128, 160, {"use_clahe": True, "use_pose_fusion": True}, False, 0),
    "keylines": (96, 128, {"use_keylines": True}, False, 0),
    "zero_wh": (96, 128, {}, True, 1),
}


@pytest.mark.parametrize("name", list(RIGS))
def test_trace_check_rigs(name):
    h, w, fields, zero, seed = RIGS[name]
    cfg = SlamConfig(**fields)
    rig = psyn.default_rig(width=w, height=h, device="cpu")
    if zero:
        rig = rig._replace(left=rig.left._replace(width=0, height=0))
    state = init_state(cfg, (h, w), device="cpu")
    rng = np.random.default_rng(seed)
    S = 8   # trace_check.py's IMU slice
    imu = (torch.zeros((S, 3)), torch.zeros((S, 3)), torch.full((S,), 0.005),
           torch.ones(S, dtype=torch.bool))
    il = torch.from_numpy(rng.random((h, w)).astype(np.float32))
    ir = torch.from_numpy(rng.random((h, w)).astype(np.float32))
    state, tel = slam_step(cfg, rig, state, il, ir, imu=imu)
    assert torch.isfinite(tel.R_cw).all() and torch.isfinite(tel.t_cw).all(), name
    assert int(state.frame_idx) == 1 and int(tel.n_detected) > 0
