"""``slam_step`` with the other detector and descriptor families against the
JAX reference's on the CPU (the f32 gather tracker), teacher-forced: each of
6 frames of a 240x320 'arc' sequence (seed 21) starts both from the
reference's state (converted) with the reference's RANSAC draws, for
(harris, sift) and (dog, freak) here and (fast, orb, describe_refresh=4) in
``tests/test_torch_families.py`` (``check_teacher_forced``; the three
reference compiles do not fit one file's time):

- every telemetry count equal on every frame but n_stereo and
  n_triangulated, which may differ by one: on (dog, freak) frame 1 a
  keypoint 19 px from the border leaves the coarsest level's in-bounds
  test of the f32 tracker at x = 0.99999988 level px in the port and
  inside it in the reference (a rounding tie of the fallback tracker, not
  of the families);
- valid and the map's valid equal on >= 99% of slots; lm_idx equal, or the
  landmarks it names within 1e-3 m of each other, on >= 99% of rows (on
  frame 0 two pairs of landmarks whose depth scores tie swap slots);
- descriptors to the family's bar: SIFT within 1e-4 per element on every
  row whose keypoint agrees within 1e-4 px and on >= 99% of rows (on
  (harris, sift) frame 4 the fallback tracker puts one keypoint 3.7e-3 px
  apart, and its descriptor differs by 6e-4), FREAK and ORB identical on
  >= 99% of rows with mean Hamming <= 1;
- pose within 1e-4 on >= 4 of 6 frames and within 3 mm on all (PnP's
  near-degenerate DLT samples differ between the float implementations, a
  standing divergence, ROADMAP.md Queue 3).

Under describe_refresh=4 the rows outside the refresh mask keep their
descriptor and invalid rows are zero, as in the reference.

Also ``python -m zenslam_tpu_torch.app --device cpu`` with an options file
whose ``slam:`` section picks the families, on a 6-frame exported folder.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.pipeline import SlamConfig as JaxConfig
from zenslam_tpu.pipeline import init_state as jax_init_state
from zenslam_tpu.pipeline.step import slam_step as jax_slam_step
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.pipeline import slam_step
from test_torch_slice import _reference_noise

torch.set_num_threads(2)
H, W, T = 240, 320, 6
CFG = dict(max_keypoints=128, max_landmarks=1024, pnp_iters=64, rigid_iters=64,
           essential_iters=64)
COUNTS = ("n_tracked", "n_detected", "n_pose_inliers", "pose_method", "pose_ok",
          "is_keyframe", "map_size")
STEREO_COUNTS = ("n_stereo", "n_triangulated")
FAMILIES = {"harris-sift": dict(detector="harris", descriptor="sift"),
            "dog-freak": dict(detector="dog", descriptor="freak")}


@functools.lru_cache(maxsize=1)
def _sequence():
    seq = make_sequence(np.random.default_rng(21), n_frames=T, width=W, height=H,
                        motion="arc")
    return seq, convert.rig_from_numpy(jax.tree.map(np.asarray, seq.rig), "cpu")


def _img(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _hamming(a, b):
    return np.unpackbits((np.ascontiguousarray(a) ^ np.ascontiguousarray(b)).view(np.uint8),
                         axis=-1).sum(-1)


def check_teacher_forced(family: dict):
    """The teacher-forced run of the module docstring for one family."""
    seq, prig = _sequence()
    jcfg = JaxConfig(use_pallas_lk=False, **CFG, **family)
    pcfg = convert.config_from_dict(jcfg._asdict())
    state = jax_init_state(jcfg, (H, W))
    pose_close = 0
    for t in range(T):
        before = jax.tree.map(np.asarray, state)
        state, jt = jax_slam_step(jcfg, seq.rig, state, jnp.asarray(seq.left[t]),
                                  jnp.asarray(seq.right[t]))
        jt, js = jax.tree.map(np.asarray, jt), jax.tree.map(np.asarray, state)
        ps = convert.state_from_numpy(before, "cpu", image_shape=(H, W))
        new, tel = slam_step(pcfg, prig, ps, _img(seq.left[t]), _img(seq.right[t]),
                             noise=_reference_noise(jcfg, jnp.asarray(before.rng_key)))
        for name in COUNTS:
            assert int(getattr(tel, name)) == int(getattr(jt, name)), (t, name)
        for name in STEREO_COUNTS:
            assert abs(int(getattr(tel, name)) - int(getattr(jt, name))) <= 1, (t, name)
        dR = np.abs(tel.R_cw.numpy() - jt.R_cw).max()
        dt = np.abs(tel.t_cw.numpy() - jt.t_cw).max()
        assert dR <= 3e-3 and dt <= 3e-3, (t, dR, dt)
        pose_close += dR <= 1e-4 and dt <= 1e-4
        out = convert.state_to_numpy(new)
        f, jf = out.features, js.features
        assert (f.valid == jf.valid).mean() >= 0.99
        xyz = out.lmap.xyz[np.maximum(f.lm_idx, 0)]
        jxyz = js.lmap.xyz[np.maximum(jf.lm_idx, 0)]
        same_lm = (f.lm_idx == jf.lm_idx) | (
            (f.lm_idx >= 0) & (jf.lm_idx >= 0) & (np.linalg.norm(xyz - jxyz, axis=-1) <= 1e-3))
        assert same_lm.mean() >= 0.99, (t, same_lm.mean())
        assert (out.lmap.valid == js.lmap.valid).mean() >= 0.99
        assert f.desc.dtype == jf.desc.dtype and f.desc.shape == jf.desc.shape
        if jcfg.descriptor == "sift":
            close = np.abs(f.desc - jf.desc).max(-1) <= 1e-4
            same_xy = np.abs(f.xy - jf.xy).max(-1) <= 1e-4
            assert close[same_xy].all() and close.mean() >= 0.99, t
        else:
            ham = _hamming(f.desc, jf.desc)
            assert (ham == 0).mean() >= 0.99 and ham.mean() <= 1.0, (t, ham.mean())
        assert (f.desc[~f.valid] == 0).all()
    assert pose_close >= 4
    assert int(tel.n_tracked) > 50


@pytest.mark.parametrize("family", list(FAMILIES))
def test_teacher_forced(family):
    check_teacher_forced(FAMILIES[family])


@pytest.mark.parametrize("slam", [dict(detector="dog", descriptor="freak"),
                                  dict(detector="harris", descriptor="sift",
                                       describe_refresh=4)])
def test_app_runs_the_families_on_the_cpu(tmp_path, slam):
    from zenslam_tpu_torch.app import main
    from zenslam_tpu_torch.io import synthetic as port_synthetic

    seq = port_synthetic.make_sequence(np.random.default_rng(5), n_frames=6, width=256,
                                       height=192, motion="strafe", device="cpu")
    port_synthetic.export_dataset(seq, str(tmp_path / "data"))
    opts = {"folder": dict(root=str(tmp_path / "data"), output=str(tmp_path / "out"),
                           groundtruth_file=str(tmp_path / "data" / "groundtruth.csv")),
            "slam": dict(max_keypoints=128, max_landmarks=1024, kf_min_frames=2, **slam)}
    path = tmp_path / "options.yaml"
    path.write_text(yaml.safe_dump(opts))
    assert main(["--options-file", str(path), "--device", "cpu", "--no-scene"]) == 0
    rows = (tmp_path / "out" / "trajectory.csv").read_text().strip().splitlines()
    assert len(rows) >= 6
