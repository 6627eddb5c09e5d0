"""The port's ``--viz`` modules (zenslam_tpu_torch.analysis: overlays, style,
the plot mains) and the scene export without matplotlib, against the
reference's (zenslam_tpu.analysis) on the same seeded inputs. Both sides
are numpy and matplotlib, so no JAX program is compiled.

- the overlay arrays are bit-identical to the reference's: float and uint8
  images, points on and beyond the borders, empty inputs, shared / new /
  dead track ids;
- ``save_keyframe_overlays`` on a port ``KfSnap`` gives the reference's
  entries, and its 8-bit RGB PNGs decode (matplotlib's reader) to the
  reference's RGBA PNGs' RGB, pixel for pixel;
- ``export_viz_report`` writes the reference's document;
- the three plot mains on a CSV written by the port's ``TelemetryWriter``
  write the reference's files, each over 1000 bytes and, drawn by the same
  matplotlib, byte for byte;
- ``export_scene`` with matplotlib unimportable writes the PLY and HTML,
  prints one skip line and does not raise; the port's ``analysis`` package
  and its overlays import without matplotlib.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zenslam_tpu.analysis import overlays as jov
from zenslam_tpu_torch.analysis import overlays as pov
from zenslam_tpu_torch.pipeline.system import KfSnap

torch.set_num_threads(2)
H, W, N = 96, 128, 64


def _features(rng, n=N, spread=1.0):
    """A keyframe's feature table: points on and up to ``spread`` x 12 px
    beyond the image, stereo matches up to 40 px of disparity."""
    xy = np.stack([rng.uniform(-12 * spread, W + 12 * spread, n),
                   rng.uniform(-12 * spread, H + 12 * spread, n)], -1).astype(np.float32)
    uv_r = (xy - np.array([rng.uniform(0, 40), 0.0])).astype(np.float32)
    return xy, uv_r, rng.random(n) < 0.7, rng.random(n) < 0.85


def _images(rng, kind):
    imgs = rng.random((2, H, W)).astype(np.float32)
    return (imgs * 255).astype(np.uint8) if kind == "uint8" else imgs


@pytest.mark.parametrize("kind,n", [("float", N), ("uint8", N), ("float", 0)])
def test_spatial_overlay_identical(kind, n):
    rng = np.random.default_rng(1)
    left, right = _images(rng, kind)
    xy, uv_r, ok, valid = _features(rng, n)
    a = pov.draw_spatial_overlay(left, right, xy, uv_r, ok, valid)
    b = jov.draw_spatial_overlay(left, right, xy, uv_r, ok, valid)
    assert a.shape == (H, 2 * W, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    if n:
        assert (a != np.concatenate([jov._to_rgb(left), jov._to_rgb(right)], 1)).any()


@pytest.mark.parametrize("kind,n", [("float", N), ("uint8", N), ("float", 0)])
def test_temporal_overlay_identical(kind, n):
    """Track ids shared, new and dead between the two keyframes."""
    rng = np.random.default_rng(2)
    img, _ = _images(rng, kind)
    prev_xy, _, _, prev_valid = _features(rng, n)
    cur_xy = (prev_xy + rng.normal(0, 6, prev_xy.shape)).astype(np.float32)
    prev_id = np.arange(n, dtype=np.int32)
    cur_id = np.where(rng.random(n) < 0.6, prev_id, prev_id + 1000).astype(np.int32)
    cur_valid = rng.random(n) < 0.85
    args = (img, prev_xy, cur_xy, prev_id, cur_id, prev_valid, cur_valid)
    a, b = pov.draw_temporal_overlay(*args), jov.draw_temporal_overlay(*args)
    assert a.shape == (H, W, 3) and np.array_equal(a, b)


def _snap(rng):
    """A port KfSnap (CPU tensors) and the same drawn fields as numpy."""
    xy, uv_r, ok, valid = _features(rng, spread=0.5)
    track_id = rng.permutation(3 * N)[:N].astype(np.int32)
    fields = dict(xy=xy, uv_r=uv_r, stereo_ok=ok, valid=valid, track_id=track_id)
    zero = torch.zeros(())
    snap = KfSnap(**{k: torch.from_numpy(v) for k, v in fields.items()},
                  R_cw=zero, t_cw=zero, desc=zero, lm_idx=zero, kp_lm_gen=zero, kp_xyz=zero)
    return snap, SimpleNamespace(**fields)


def test_save_keyframe_overlays_matches_reference(tmp_path):
    import matplotlib.image as mpimg

    rng = np.random.default_rng(3)
    left, right = _images(rng, "float")
    (s0, r0), (s1, r1) = _snap(rng), _snap(rng)
    r1.track_id[:40] = r0.track_id[:40]                 # tracked across the gap
    s1 = s1._replace(track_id=torch.from_numpy(r1.track_id))
    entries = {}
    for name, mod, snaps in (("port", pov, (s0, s1)), ("ref", jov, (r0, r1))):
        d = tmp_path / name
        args = (torch.from_numpy(left), torch.from_numpy(right)) if name == "port" \
            else (left, right)
        entries[name] = [mod.save_keyframe_overlays(str(d), 7, *args, snaps[0]),
                         mod.save_keyframe_overlays(str(d), 9, *args, snaps[1], snaps[0])]
    assert entries["port"] == entries["ref"]
    assert entries["port"][1]["n_tracked_across"] > 0
    for e in entries["port"]:
        for key in ("spatial", "temporal"):
            if key not in e:
                continue
            mine = mpimg.imread(str(tmp_path / "port" / e[key]))
            ref = mpimg.imread(str(tmp_path / "ref" / e[key]))
            assert mine.shape[-1] == 3 and ref.shape[-1] == 4
            assert np.array_equal(np.round(mine * 255), np.round(ref[..., :3] * 255)), e[key]
    drawn = pov.draw_spatial_overlay(left, right, r1.xy, r1.uv_r, r1.stereo_ok, r1.valid)
    decoded = mpimg.imread(str(tmp_path / "port" / "spatial_00009.png"))
    assert np.array_equal(np.round(decoded * 255).astype(np.uint8), drawn)


def test_viz_report_identical(tmp_path):
    entries = [{"frame": 0, "spatial": "spatial_00000.png", "n_valid": 120, "n_stereo": 90},
               {"frame": 5, "spatial": "spatial_00005.png", "n_valid": 110, "n_stereo": 80,
                "temporal": "temporal_00005.png", "n_tracked_across": 70}]
    pngs = ["plots/timing_stacked.png"]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = pov.export_viz_report(str(tmp_path / "a"), entries, pngs)
    b = jov.export_viz_report(str(tmp_path / "b"), entries, pngs)
    assert open(a).read() == open(b).read()


def _write_csv(path, n=40, seed=3):
    """The reference test's telemetry (tests/test_analysis.py), written by
    the port's TelemetryWriter."""
    from zenslam_tpu_torch.io.telemetry import TelemetryWriter

    rng = np.random.default_rng(seed)
    w = TelemetryWriter(str(path))
    for i in range(n):
        tel = SimpleNamespace(
            R_cw=np.eye(3, dtype=np.float32), t_cw=np.asarray([0.1 * i, 0.0, 0.0], np.float32),
            n_tracked=int(200 + rng.integers(-30, 30)), n_detected=int(rng.integers(20, 80)),
            n_stereo=int(rng.integers(80, 150)), n_triangulated=int(rng.integers(30, 90)),
            n_pose_inliers=int(rng.integers(40, 120)), pose_method=int(rng.integers(0, 4)),
            pose_ok=True, tracked_ratio=float(rng.uniform(0.5, 0.95)),
            is_keyframe=bool(i % 8 == 0), map_size=int(300 + 12 * i))
        w.write(tel, timestamp=i * 0.05, duration_ms=float(rng.uniform(12, 25)),
                wait_ms=float(rng.uniform(1, 3)), step_ms=float(rng.uniform(8, 15)),
                backend_ms=float(rng.uniform(0, 6)) if i % 8 == 0 else 0.0)
    w.close()
    return path


@pytest.mark.parametrize("plot", ["plot_timing_breakdown", "plot_feature_metrics",
                                  "plot_detector_comparison"])
def test_plot_mains_match_reference(plot, tmp_path):
    import importlib

    pytest.importorskip("matplotlib")
    csv_path = _write_csv(tmp_path / "frame_data.csv")
    if plot == "plot_detector_comparison":
        other = _write_csv(tmp_path / "other.csv", seed=9)
        argv = ["--run", f"baseline={csv_path}", "--run", f"variant={other}"]
    else:
        argv = ["--csv", str(csv_path)]
    files = {}
    for pkg in ("zenslam_tpu_torch", "zenslam_tpu"):
        out = tmp_path / pkg
        main = importlib.import_module(f"{pkg}.analysis.{plot}").main
        assert main([*argv, "--output", str(out)]) == 0
        files[pkg] = sorted(p.name for p in out.iterdir())
        assert all((out / f).stat().st_size > 1000 for f in files[pkg])
    assert files["zenslam_tpu_torch"] == files["zenslam_tpu"] and len(files["zenslam_tpu"]) >= 3
    for f in files["zenslam_tpu"]:      # one matplotlib draws both: the same bytes
        assert (tmp_path / "zenslam_tpu_torch" / f).read_bytes() == \
            (tmp_path / "zenslam_tpu" / f).read_bytes(), f


def test_scene_export_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Also: the port's analysis package and its overlays import without
    matplotlib."""
    import importlib

    import zenslam_tpu_torch.analysis
    from zenslam_tpu_torch.analysis.scene_export import export_scene
    from zenslam_tpu_torch.io.synthetic import default_rig
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system

    s = create_system(SlamConfig(max_keypoints=64, max_landmarks=256), BackendConfig(),
                      default_rig(width=W, height=H, device="cpu"), (H, W), device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)     # import raises ImportError
    importlib.reload(zenslam_tpu_torch.analysis)
    importlib.reload(pov)
    scene = export_scene(str(tmp_path), s, est_positions=[np.zeros(3)],
                         gt_positions=[np.zeros(3)])
    printed = capsys.readouterr().out
    assert scene["png"] is False
    assert (tmp_path / "scene.ply").is_file() and (tmp_path / "scene.html").is_file()
    assert not (tmp_path / "scene_3d.png").exists()
    assert printed.count("scene: scene_3d.png skipped (") == 1, printed
