"""The port's IO, calibration, image ops, options, telemetry, formatters and
scene export (zenslam_tpu_torch) against the JAX reference on the CPU, on
the same numpy-seeded inputs.

Tolerances: quaternion and distortion functions 1e-6; bilinear_sample and
remap 1e-6; CLAHE on identical input 1e-5, after remap >= 99.9% of pixels
within 1e-5 and the rest within one LUT step; rectify maps 1e-3 px and the
rectified rig 1e-6; PNG decode, FolderReader frames (with skip/take and IMU
slices), telemetry CSV text, frame statistics, formatter strings, options
and the effective-options YAML identical; Groundtruth.pose_at 1e-6; scene
PLY and HTML of the same system identical.
"""

import os
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.analysis import scene_export as jscene
from zenslam_tpu.config import options as joptions
from zenslam_tpu.geometry import camera as jcam
from zenslam_tpu.geometry import lie as jlie
from zenslam_tpu.io import calibration as jcal
from zenslam_tpu.io import dataset as jdata
from zenslam_tpu.io import synthetic as jsyn
from zenslam_tpu.io import telemetry as jtel
from zenslam_tpu.native import loader as jnative
from zenslam_tpu.ops import image as jimage
from zenslam_tpu.pipeline.state import FrameTelemetry as JTel
from zenslam_tpu.utils import formatters as jfmt
from zenslam_tpu_torch.analysis import scene_export as pscene
from zenslam_tpu_torch.config import options as poptions
from zenslam_tpu_torch.geometry import camera as pcam
from zenslam_tpu_torch.geometry import lie as plie
from zenslam_tpu_torch.io import calibration as pcal
from zenslam_tpu_torch.io import dataset as pdata
from zenslam_tpu_torch.io import synthetic as psyn
from zenslam_tpu_torch.io import telemetry as ptel
from zenslam_tpu_torch.native import loader as pnative
from zenslam_tpu_torch.ops import image as pimage
from zenslam_tpu_torch.pipeline.state import unpack_telemetry
from zenslam_tpu_torch.utils import formatters as pfmt

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
CAMCHAIN = REPO / "options" / "euroc_camchain.yaml"


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32)


# --- geometry --------------------------------------------------------------

def test_quaternion_functions():
    rng = np.random.default_rng(0)
    q0, q1 = _random_rotations(rng, 64), _random_rotations(rng, 64)
    q1[:8] = -q0[:8]            # double cover
    q1[8:16] = q0[8:16]         # sin(theta) ~ 0: the lerp branch
    R = np.asarray(jlie.quat_to_rotmat(jnp.asarray(q0)))
    np.testing.assert_allclose(plie.quat_to_rotmat(_t(q0)).numpy(), R, atol=1e-6)
    np.testing.assert_allclose(plie.rotmat_to_quat(_t(R)).numpy(),
                               np.asarray(jlie.rotmat_to_quat(jnp.asarray(R))), atol=1e-6)
    for alpha in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            plie.quat_slerp(_t(q0), _t(q1), alpha).numpy(),
            np.asarray(jlie.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), alpha)), atol=1e-6)
    Ri, ti = plie.se3_identity()
    assert torch.equal(Ri, torch.eye(3)) and torch.equal(ti, torch.zeros(3))


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_distortion_functions(model):
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    dist = (np.array([-0.28, 0.074, 2e-4, 1.8e-5], np.float32) if model == "radtan"
            else np.array([0.02, -0.01, 0.004, -0.001], np.float32))
    fwd, inv = {"radtan": ("distort_radtan", "undistort_points_radtan"),
                "equidistant": ("distort_equidistant", "undistort_points_equidistant")}[model]
    for name in (fwd, inv):
        ref = np.asarray(getattr(jcam, name)(jnp.asarray(dist), jnp.asarray(xy)))
        got = getattr(pcam, name)(_t(dist), _t(xy)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_camera_functions():
    rng = np.random.default_rng(2)
    jrig = jsyn.default_rig(320, 240)
    prig = psyn.default_rig(320, 240, device="cpu")
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
    t = rng.normal(0, 0.3, 3).astype(np.float32)
    X = rng.uniform(-2, 2, (50, 3)).astype(np.float32) + np.float32([0, 0, 5])
    np.testing.assert_allclose(
        pcam.project_se3(prig.left, _t(R), _t(t), _t(X)).numpy(),
        np.asarray(jcam.project_se3(jrig.left, jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))),
        atol=1e-4)
    uv, d = X[:, :2] * 40 + 100, X[:, 2]
    np.testing.assert_allclose(
        pcam.backproject(prig.left, _t(uv), _t(d)).numpy(),
        np.asarray(jcam.backproject(jrig.left, jnp.asarray(uv), jnp.asarray(d))), atol=1e-6)
    for a, b in zip(pcam.camera_pose_to_world(_t(R), _t(t)),
                    jcam.camera_pose_to_world(jnp.asarray(R), jnp.asarray(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(pcam.right_from_left_extrinsics(prig, _t(R), _t(t)),
                    jcam.right_from_left_extrinsics(jrig, jnp.asarray(R), jnp.asarray(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert abs(float(prig.baseline) - float(jrig.baseline)) < 1e-7


# --- image ops -------------------------------------------------------------

def test_rgb_to_gray():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    for img in (u8, u8.astype(np.float32) / 255.0):
        np.testing.assert_allclose(pimage.rgb_to_gray(_t(img)).numpy(),
                                   np.asarray(jimage.rgb_to_gray(jnp.asarray(img))), atol=1e-6)


def test_bilinear_sample_and_remap():
    rng = np.random.default_rng(4)
    img = rng.random((48, 64), dtype=np.float32)
    xy = rng.uniform(-3, 67, (40, 30, 2)).astype(np.float32)   # some corners outside
    for pad in (0.0, 0.5):
        np.testing.assert_allclose(
            pimage.bilinear_sample(_t(img), _t(xy), pad).numpy(),
            np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), pad)),
            atol=1e-6)
    mx, my = xy[..., 0], xy[..., 1]
    np.testing.assert_allclose(
        pimage.remap(_t(img), _t(mx), _t(my)).numpy(),
        np.asarray(jimage.remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))), atol=1e-6)


def _u8_image(rng, h, w):
    """An 8-bit frame rescaled the app's way: f32 * f32(1/255)."""
    seq = jsyn.make_sequence(rng, n_frames=1, width=w, height=h, motion="strafe")
    u8 = np.clip(seq.left[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return u8, u8.astype(np.float32) * np.float32(1.0 / 255.0)


def test_clahe_identical_input():
    u8, img = _u8_image(np.random.default_rng(5), 192, 256)
    # CLAHE's bin is a truncation: every 8-bit value k rescaled by the f32
    # constant 1/255 lands back in bin k, in both packages
    k = torch.arange(256, dtype=torch.uint8)
    scaled = k.to(torch.float32) * (1.0 / 255.0)
    assert torch.equal((scaled * 255).to(torch.int64), k.to(torch.int64))
    assert np.array_equal(np.asarray((jnp.asarray(scaled.numpy()) * 255).astype(jnp.int32)),
                          k.numpy())
    ref = np.asarray(jimage.clahe(jnp.asarray(img), clip_limit=4.0))
    np.testing.assert_allclose(pimage.clahe(_t(img), clip_limit=4.0).numpy(), ref, atol=1e-5)
    # as the app runs it: a uint8 tensor rescaled by the f32 constant
    app_img = torch.from_numpy(u8).to(torch.float32) * (1.0 / 255.0)
    assert torch.equal(app_img, _t(img))


def test_clahe_after_remap():
    maps = jcal.compute_rectify_maps(*jcal.load_kalibr_yaml(str(CAMCHAIN)))
    u8, img = _u8_image(np.random.default_rng(6), 480, 752)
    jr = jimage.remap(jnp.asarray(img), jnp.asarray(maps.left_x), jnp.asarray(maps.left_y))
    pr = pimage.remap(_t(img), _t(maps.left_x), _t(maps.left_y))
    ref = np.asarray(jimage.clahe(jr))
    got = pimage.clahe(pr).numpy()
    d = np.abs(got - ref)
    lut_step = (4.0 + 1.0) / 256   # a clipped bin's count plus its redistributed share
    assert (d <= 1e-5).mean() >= 0.999, (d > 1e-5).mean()
    assert d.max() <= lut_step, d.max()


# --- calibration -----------------------------------------------------------

def test_camchain_and_rectify_maps():
    jrig, jmodels = jcal.load_kalibr_yaml(str(CAMCHAIN))
    prig, pmodels = pcal.load_kalibr_yaml(str(CAMCHAIN), device="cpu")
    assert pmodels == jmodels == ("radtan", "radtan")
    for a, b in ((prig.left, jrig.left), (prig.right, jrig.right)):
        assert (a.width, a.height) == (b.width, b.height) == (752, 480)
        for f in ("fx", "fy", "cx", "cy", "dist"):
            assert np.array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    for f in ("R_rl", "t_rl", "R_ci", "t_ci"):
        assert np.array_equal(getattr(prig, f).numpy(), np.asarray(getattr(jrig, f)))
    jm = jcal.compute_rectify_maps(jrig, jmodels)
    pm = pcal.compute_rectify_maps(prig, pmodels)
    for f in ("left_x", "left_y", "right_x", "right_y"):
        a, b = getattr(pm, f), getattr(jm, f)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (480, 752)
        np.testing.assert_allclose(a, b, atol=1e-3)
    jr, pr = jm.rig_rectified, pm.rig_rectified
    for f in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_allclose(getattr(pr.left, f).numpy(), np.asarray(getattr(jr.left, f)),
                                   atol=1e-6)
    for f in ("R_rl", "t_rl", "R_ci", "t_ci"):
        np.testing.assert_allclose(getattr(pr, f).numpy(), np.asarray(getattr(jr, f)), atol=1e-6)


def test_imu_config():
    d = {"gyroscope_noise_density": 1e-4, "accelerometer_noise_density": 2e-3,
         "accelerometer_random_walk": 1e-4}
    for cfg in (d, {}):
        assert tuple(pcal.parse_imu_config(cfg)) == tuple(jcal.parse_imu_config(cfg))


# --- native loader, dataset reader ------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writer_and_decoder(tmp_path, dtype):
    rng = np.random.default_rng(7)
    img = rng.integers(0, np.iinfo(dtype).max, (37, 53), dtype=dtype)
    jsyn.write_png_gray(str(tmp_path / "ref.png"), img)
    psyn.write_png_gray(str(tmp_path / "port.png"), img)
    assert (tmp_path / "ref.png").read_bytes() == (tmp_path / "port.png").read_bytes()
    got = pnative.decode_png_gray(str(tmp_path / "port.png"))
    assert got.dtype == dtype and np.array_equal(got, img)
    assert np.array_equal(got, jnative.decode_png_gray(str(tmp_path / "port.png")))


def _dataset(root: Path, rng, n=6, imu=True):
    (root / "cam0/data").mkdir(parents=True)
    (root / "cam1/data").mkdir(parents=True)
    t0 = 1_000_000_000
    for i in range(n):
        ts = t0 + i * 50_000_000
        psyn.write_png_gray(str(root / f"cam0/data/{ts}.png"),
                            rng.integers(0, 255, (20, 30), dtype=np.uint8))
        psyn.write_png_gray(str(root / f"cam1/data/{ts}.png"),
                            rng.integers(0, 255, (20, 30), dtype=np.uint8))
    if imu:
        (root / "imu0").mkdir()
        ks = np.arange(n * 10 + 1)
        rows = np.column_stack([t0 + ks * 5_000_000 + rng.integers(0, 900_000, ks.size),
                                rng.normal(0, 0.1, (ks.size, 6))])
        np.savetxt(str(root / "imu0/data.csv"), rows, delimiter=",",
                   fmt=["%d"] + ["%.9f"] * 6)


@pytest.mark.parametrize("skip,take", [(0, 0), (1, 3)])
def test_folder_reader(tmp_path, skip, take):
    _dataset(tmp_path, np.random.default_rng(8))
    kw = dict(root=str(tmp_path), skip_frames=skip, take_frames=take)
    jr, pr = jdata.FolderReader(**kw), pdata.FolderReader(**kw)
    assert pr.frame_index() == jr.frame_index()
    # the serial path divides by 255, the native prefetcher multiplies by
    # 1/255: each is compared with its own counterpart
    for frames, ref in ((list(pr.frames()), list(jr.frames())),
                        (list(pr.frames_prefetch()), list(jr.frames_prefetch()))):
        assert len(ref) == (take or 6 - skip)
        assert len(frames) == len(ref)
        for a, b in zip(frames, ref):
            assert a.timestamp == b.timestamp
            for f in ("left", "right", "imu_gyro", "imu_accel", "imu_dt", "imu_mask"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert sum(int(f.imu_mask.sum()) for f in ref) > 0


def test_pgm_and_npy(tmp_path):
    rng = np.random.default_rng(9)
    img16 = rng.integers(0, 65535, (5, 7), dtype=np.uint16)
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P5\n# comment\n7 5\n65535\n" + img16.astype(">u2").tobytes())
    assert np.array_equal(pdata._read_pgm(str(p)), jdata._read_pgm(str(p)))
    np.save(tmp_path / "b.npy", rng.random((4, 4), dtype=np.float32))
    for path in (str(p), str(tmp_path / "b.npy")):
        assert np.array_equal(pdata._decode_image(path), jdata._decode_image(path))


def test_groundtruth_pose_at(tmp_path):
    rng = np.random.default_rng(10)
    q = _random_rotations(rng, 8).astype(np.float64)
    rows = np.column_stack([np.arange(8) * 1e8, rng.normal(0, 1, (8, 3)), q])
    p = str(tmp_path / "gt.csv")
    np.savetxt(p, rows, delimiter=",")
    jg, pg = jdata.Groundtruth(p), pdata.Groundtruth(p)
    for t in (-0.1, 0.0, 0.05, 0.31, 0.7, 0.9):
        (Rj, pj), (Rp, pp) = jg.pose_at(t), pg.pose_at(t)
        np.testing.assert_allclose(Rp, np.asarray(Rj), atol=1e-6)
        assert pp.dtype == np.float32 and np.array_equal(pp, pj)


# --- telemetry, formatters, options -------------------------------------------

def test_telemetry_csv_and_stats(tmp_path):
    rng = np.random.default_rng(11)
    jw = jtel.TelemetryWriter(str(tmp_path / "ref.csv"))
    pw = ptel.TelemetryWriter(str(tmp_path / "port.csv"))
    for i in range(12):
        vec = np.concatenate([
            [rng.integers(0, 300), 20, 150, rng.integers(0, 80), rng.integers(0, 100),
             rng.integers(0, 4), rng.random() > 0.2, rng.random(), i % 4 == 0, 900 + i, 0, 0, 0],
            np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32))).ravel(),
            rng.normal(0, 1, 3)]).astype(np.float32)
        ptl = unpack_telemetry(vec)
        jtl = JTel(*(jnp.asarray(x) for x in ptl))
        kw = dict(timestamp=0.05 * i, duration_ms=float(rng.uniform(10, 150)), wait_ms=1.5,
                  step_ms=float(rng.uniform(5, 90)), backend_ms=float(i % 4 == 0) * 30.0)
        jw.write(jtl, **kw)
        pw.write(ptl, **kw)
    jw.close()
    pw.close()
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "ref.csv").read_text()
    assert text.splitlines()[0].split(",") == jtel.COLUMNS
    for slow in (100.0, 1e12):
        assert (ptel.analyze_frame_stats(str(tmp_path / "port.csv"), slow_ms=slow)
                == jtel.analyze_frame_stats(str(tmp_path / "ref.csv"), slow_ms=slow))


def test_formatters():
    rng = np.random.default_rng(12)
    Rs = [np.asarray(jlie.quat_to_rotmat(jnp.asarray(q))) for q in _random_rotations(rng, 20)]
    Rs += [np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)]   # gimbal lock
    for R in Rs:
        t = rng.normal(0, 2, 3)
        assert pfmt.euler_zyx_deg(R) == jfmt.euler_zyx_deg(R)
        assert pfmt.format_vec3(t) == jfmt.format_vec3(t)
        assert pfmt.format_pose(R, t, 4) == jfmt.format_pose(R, t, 4)


OPTION_FILES = sorted(p.name for p in (REPO / "options").glob("*.yaml"))


@pytest.mark.parametrize("name", OPTION_FILES)
def test_options_files_load_alike(name, tmp_path):
    path = str(REPO / "options" / name)
    jo, po = joptions.load_options(path), poptions.load_options(path)
    assert po.log_level == jo.log_level
    assert vars(po.folder) == vars(jo.folder)
    assert po.slam._asdict() == jo.slam._asdict()
    assert vars(po.backend) == vars(jo.backend)
    joptions.save_options(jo, str(tmp_path / "ref.yaml"))
    poptions.save_options(po, str(tmp_path / "port.yaml"))
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "ref.yaml").read_text()
    assert vars(poptions.load_options(str(tmp_path / "port.yaml")).backend) == vars(po.backend)


def test_partial_options(tmp_path):
    p = tmp_path / "p.yaml"
    p.write_text("slam:\n  fast_threshold: 0.1\n  unknown_key: 3\nfolder:\n  root: /data\n"
                 "backend:\n  telemetry_lag: 3\n")
    jo, po = joptions.load_options(str(p)), poptions.load_options(str(p))
    assert po.slam._asdict() == jo.slam._asdict() and po.slam.fast_threshold == 0.1
    assert vars(po.folder) == vars(jo.folder) and vars(po.backend) == vars(jo.backend)


# --- scene export ------------------------------------------------------------

def test_scene_export_of_the_same_system(tmp_path):
    """PLY and HTML of one system, given to the reference with numpy leaves
    and to the port as tensors, are identical files."""
    rng = np.random.default_rng(13)
    M, K = 300, 6
    lmap = dict(xyz=rng.normal(0, 2, (M, 3)).astype(np.float32),
                valid=rng.random(M) > 0.3, color=rng.random(M).astype(np.float32))
    kf = dict(valid=np.arange(8) < K, frame_idx=rng.permutation(8).astype(np.int32),
              R=np.stack([np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, .2, 3), jnp.float32)))
                          for _ in range(8)]), t=rng.normal(0, 1, (8, 3)).astype(np.float32))
    archive = SimpleNamespace(xyz=rng.normal(0, 2, (40, 3)).astype(np.float32),
                              color=rng.random(40).astype(np.float32),
                              dormant=rng.random(40) > 0.5)
    ref_sys = SimpleNamespace(state=SimpleNamespace(lmap=SimpleNamespace(**lmap)),
                              kf_db=SimpleNamespace(**kf), archive=_Archive(archive))
    port_sys = SimpleNamespace(
        state=SimpleNamespace(lmap=SimpleNamespace(**{k: _t(v) for k, v in lmap.items()})),
        kf_db=SimpleNamespace(**{k: _t(v) for k, v in kf.items()}), archive=_Archive(archive))
    est = rng.normal(0, 1, (10, 3))
    gt = est + rng.normal(0, 0.01, (10, 3))
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    js = jscene.collect_scene(ref_sys, est, gt)
    ps = pscene.collect_scene(port_sys, est, gt)
    for k in js:
        assert np.array_equal(ps[k], js[k]), k
    for mod, scene, d in ((jscene, js, "ref"), (pscene, ps, "port")):
        mod.export_ply(str(tmp_path / d / "scene.ply"), scene["points"], scene["colors"])
        mod.export_scene_html(str(tmp_path / d / "scene.html"), scene)
    for f in ("scene.ply", "scene.html"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "ref" / f).read_text()
    pts, rgb = pscene.read_ply(str(tmp_path / "port" / "scene.ply"))
    assert len(pts) == int(lmap["valid"].sum() + archive.dormant.sum())


class _Archive:
    def __init__(self, ns):
        self.xyz, self.color, self.dormant = ns.xyz, ns.color, ns.dormant

    def __len__(self):
        return len(self.xyz)
