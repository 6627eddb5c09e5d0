"""The port's keylines (zenslam_tpu_torch.ops.lines, pipeline/lines_step.py
and slam_step with ``use_keylines``) against the JAX reference on the CPU.

- the port's ``with_lines`` corridor render equals the reference's (float32);
- ops on tests/test_lines.py's stripe images and on one frame of the
  ``with_lines`` corridor (384x512, seed 11): ``canonicalize_endpoints`` and
  ``point_segment_distance`` within 1e-6; ``detect_keylines`` with masks
  identical, endpoints within 1e-3 px and scores within 1e-3 relative on
  rows valid in both, with and without existing keylines to mask;
  ``keyline_descriptors`` on the detected rows and 256 random segments with
  >= 99% of rows identical and mean Hamming <= 1 (a sample within rounding
  of its patch mean flips a bit: one row of 320 on the corridor frame, a
  standing divergence);
- each ``lines_step`` function given the same inputs (the reference's state
  before frame 4 of the run below, the f32 gather tracker): tables and
  counts equal, endpoints and 3D points within 1e-3;
- ``slam_step`` with keylines, teacher-forced for 8 frames on the corridor
  (the reference's states and RANSAC draws, the PnPs' draws at the
  widened width max_keypoints + 2 max_keylines): pose within 1e-4 on >= 6
  frames and within 3 mm on all (PnP's near-degenerate DLT samples, a
  standing divergence, ROADMAP.md Queue 3); every telemetry count, lines
  included, equal on every frame; keyline valid / lm_idx equal on >= 99%
  of rows, descriptors on >= 99% of rows, ``line_map.xyz`` within 1e-3 m,
  each keypoint's landmark position within 1e-3 m on >= 99% of rows (on
  frame 0 two landmarks whose depths differ by 4e-7 m swap slots).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.geometry.camera import fundamental_from_rig as jax_fundamental
from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.ops import lines as jlines
from zenslam_tpu.ops.lk import build_ragged_pyramid_pair as jax_pyramid_pair
from zenslam_tpu.ops.lk_pallas import ragged_level_sizes
from zenslam_tpu.pipeline import SlamConfig as JaxConfig
from zenslam_tpu.pipeline import init_state as jax_init_state
from zenslam_tpu.pipeline import lines_step as jls
from zenslam_tpu.pipeline import step as jstep
from zenslam_tpu.pipeline.step import slam_step as jax_slam_step
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation.cascade import CascadeNoise
from zenslam_tpu_torch.geometry.camera import fundamental_from_rig
from zenslam_tpu_torch.io import synthetic as port_synthetic
from zenslam_tpu_torch.ops import lines as plines
from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
from zenslam_tpu_torch.pipeline import lines_step as pls
from zenslam_tpu_torch.pipeline import step as pstep

from test_torch_slice import _img

torch.set_num_threads(2)
H, W, T = 384, 512, 8
CFG = dict(max_keypoints=128, max_landmarks=1024, pnp_iters=64, rigid_iters=64,
           essential_iters=64, use_keylines=True)
COUNTS = ("n_tracked", "n_detected", "n_stereo", "n_triangulated", "n_pose_inliers",
          "pose_method", "pose_ok", "is_keyframe", "map_size", "n_lines",
          "n_line_triangulated", "line_map_size")


def _stripe(row=None, col=None, rng=None):
    """tests/test_lines.py's 128x128 stripe image."""
    rng = rng or np.random.default_rng(0)
    img = 0.45 + 0.1 * rng.random((128, 128)).astype(np.float32)
    if row is not None:
        img[row:row + 3, :] = 1.0
    if col is not None:
        img[:, col:col + 3] = 1.0
    return img


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=T, width=W, height=H,
                         motion="strafe", with_lines=True)


@pytest.fixture(scope="module")
def jcfg():
    return JaxConfig(use_pallas_lk=False, **CFG)


@pytest.fixture(scope="module")
def prig(seq):
    return convert.rig_from_numpy(jax.tree.map(np.asarray, seq.rig), "cpu")


def test_port_renders_the_reference_corridor_with_lines(seq):
    mine = port_synthetic.make_sequence(np.random.default_rng(11), n_frames=2, width=W,
                                        height=H, motion="strafe", with_lines=True,
                                        device="cpu")
    np.testing.assert_array_equal(mine.left, seq.left[:2].astype(np.float32))
    np.testing.assert_array_equal(mine.right, seq.right[:2].astype(np.float32))


def _images(seq):
    return {"stripe_row": _stripe(row=64), "stripe_col": _stripe(col=40),
            "stripe_cross": _stripe(row=30, col=90), "blank": np.full((128, 128), 0.5, np.float32),
            "corridor": np.asarray(seq.left[0], np.float32)}


def _hamming(a, b):
    x = np.bitwise_xor(a.view(np.uint32), b.view(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def test_geometry_helpers():
    rng = np.random.default_rng(3)
    ep = rng.uniform(-50, 50, (40, 2, 2)).astype(np.float32)
    ep[:5, 1, 0] = ep[:5, 0, 0]           # vertical: ties broken by dy
    p = rng.uniform(-60, 60, (30, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        plines.canonicalize_endpoints(torch.from_numpy(ep)).numpy(),
        np.asarray(jlines.canonicalize_endpoints(jnp.asarray(ep))))
    np.testing.assert_allclose(
        plines.point_segment_distance(torch.from_numpy(p), torch.from_numpy(ep)).numpy(),
        np.asarray(jlines.point_segment_distance(jnp.asarray(p), jnp.asarray(ep))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["stripe_row", "stripe_col", "stripe_cross", "blank",
                                  "corridor"])
def test_detect_and_describe(seq, name):
    img = _images(seq)[name]
    ex_ep, ex_valid = np.zeros((4, 2, 2), np.float32), np.zeros(4, bool)
    found = []
    for masked in (False, True):
        j = [np.array(x) for x in jlines.detect_keylines(
            jnp.asarray(img), jnp.asarray(ex_ep), jnp.asarray(ex_valid), max_keylines=64)]
        p = [x.numpy() for x in plines.detect_keylines(
            torch.from_numpy(img), torch.from_numpy(ex_ep), torch.from_numpy(ex_valid),
            max_keylines=64)]
        np.testing.assert_array_equal(p[2], j[2], err_msg=f"{name} masked={masked}")
        v = j[2]
        np.testing.assert_allclose(p[0][v], j[0][v], rtol=0, atol=1e-3)
        np.testing.assert_allclose(p[1][v], j[1][v], rtol=1e-3, atol=1e-3)
        found.append(int(v.sum()))
        # the second pass masks with the first pass's best lines
        ex_ep, ex_valid = j[0][:4].copy(), j[2][:4].copy()
    assert (found[0] > 0) == (name != "blank")

    # the detected rows and 256 random segments: a bit flips where a sample
    # lies within rounding of its patch mean (on the corridor, one of the 320
    # rows: a sample 6e-8 from the mean, positions 1.5e-5 px apart)
    rng = np.random.default_rng(5)
    ep = np.concatenate([j[0], rng.uniform(8, 120, (256, 2, 2)).astype(np.float32)])
    valid = np.concatenate([j[2], np.ones(256, bool)])
    jd = np.asarray(jlines.keyline_descriptors(jnp.asarray(img), jnp.asarray(ep),
                                               jnp.asarray(valid)))
    pd = plines.keyline_descriptors(torch.from_numpy(img), torch.from_numpy(ep),
                                    torch.from_numpy(valid)).numpy()
    ham = _hamming(pd, jd)
    assert (ham == 0).mean() >= 0.99 and ham.mean() <= 1.0, ham


def _reference_noise(jcfg, key):
    """The reference's RANSAC draws for one frame, the PnPs' at the cam0
    problem's width (keypoints plus keyline endpoints)."""
    _, k_est = jax.random.split(key)
    k0, k1, k2 = jax.random.split(k_est, 3)
    n, n_pnp = jcfg.max_keypoints, jcfg.max_keypoints + 2 * jcfg.max_keylines

    def g(k, iters, width):
        return torch.from_numpy(np.array(jax.random.gumbel(k, (iters, width))))

    return CascadeNoise(g(k0, jcfg.pnp_iters, n_pnp), g(k1, jcfg.pnp_iters, n_pnp),
                        g(k2, jcfg.rigid_iters, n),
                        g(jax.random.fold_in(k_est, 3), jcfg.essential_iters, n))


@pytest.fixture(scope="module")
def reference_run(seq, jcfg):
    state = jax_init_state(jcfg, (H, W))
    states, tels = [], []
    for t in range(T):
        states.append(jax.tree.map(np.asarray, state))
        state, tel = jax_slam_step(jcfg, seq.rig, state, jnp.asarray(seq.left[t]),
                                   jnp.asarray(seq.right[t]))
        tels.append(jax.tree.map(np.asarray, tel))
    states.append(jax.tree.map(np.asarray, state))
    return states, tels


def test_slam_step_teacher_forced(seq, jcfg, prig, reference_run):
    states, tels = reference_run
    pcfg = convert.config_from_dict(jcfg._asdict())
    close = 0
    for t in range(T):
        ps = convert.state_from_numpy(states[t], "cpu", image_shape=(H, W))
        new, tel = pstep.slam_step(pcfg, prig, ps, _img(seq.left[t]), _img(seq.right[t]),
                                   noise=_reference_noise(jcfg, jnp.asarray(states[t].rng_key)))
        jt, js = tels[t], states[t + 1]
        gap = max(np.abs(tel.R_cw.numpy() - jt.R_cw).max(),
                  np.abs(tel.t_cw.numpy() - jt.t_cw).max())
        assert gap < 3e-3, (t, gap)
        close += gap < 1e-4
        for name in COUNTS:
            assert int(getattr(tel, name)) == int(getattr(jt, name)), (t, name)
        out = convert.state_to_numpy(new)
        ln, jl = out.lines, js.lines
        assert (ln.valid == jl.valid).mean() >= 0.99, t
        assert (ln.lm_idx == jl.lm_idx).mean() >= 0.99, t
        assert (ln.desc == jl.desc).all(-1).mean() >= 0.99, t
        np.testing.assert_array_equal(out.line_map.valid, js.line_map.valid)
        v = js.line_map.valid
        np.testing.assert_allclose(out.line_map.xyz[v], js.line_map.xyz[v], rtol=0, atol=1e-3)
        assert int(out.next_line_id) == int(js.next_line_id)
        # keypoints' landmarks through their slots: two landmarks of depth
        # 5.9960113 / 5.9960117 m rank by 1/z within rounding on frame 0 and
        # swap slots, so the positions are compared, not the slot numbers
        f, jf = out.features, js.features
        xyz = np.where((f.lm_idx >= 0)[:, None], out.lmap.xyz[np.maximum(f.lm_idx, 0)], 0)
        jxyz = np.where((jf.lm_idx >= 0)[:, None], js.lmap.xyz[np.maximum(jf.lm_idx, 0)], 0)
        assert (np.abs(xyz - jxyz).max(-1) < 1e-3).mean() >= 0.99, t
    assert tels[-1].line_map_size >= 4 and (np.stack([x.n_lines for x in tels])[1:] >= 8).all()
    assert close >= 6, close


def test_lines_step_functions(seq, jcfg, prig, reference_run):
    """Each stage on the reference's state before frame 4 (live keylines
    with landmarks) and the frame's pyramids, in both packages."""
    states, _ = reference_run
    t = 4
    js = jax.tree.map(jnp.asarray, states[t])
    ps = convert.state_from_numpy(states[t], "cpu", image_shape=(H, W))
    pcfg = convert.config_from_dict(jcfg._asdict())
    il, ir = jnp.asarray(seq.left[t]), jnp.asarray(seq.right[t])
    tsizes = ragged_level_sizes(H, W, jcfg.pyramid_levels + 1)
    jl, jr = jax_pyramid_pair(il, ir, jcfg.pyramid_levels, dtype=jnp.float32)
    pl, pr = build_ragged_pyramid_pair(_img(seq.left[t]), _img(seq.right[t]),
                                       jcfg.pyramid_levels, dtype=torch.float32)
    R, tr = js.R_cw, js.t_cw
    pR, ptr = ps.R_cw, ps.t_cw

    def jlk(prev, nxt):
        return lambda pts, v, init_pts=None: jstep._lk_fb(jcfg, prev, nxt, tsizes, pts, v,
                                                           init_pts=init_pts)

    def plk(prev, nxt):
        return lambda pts, v, init_pts=None: pstep._lk_fb(pcfg, False, prev, nxt, pts, v,
                                                           init_pts=init_pts)

    def same(p, j, atol=1e-3):
        j = jax.tree.map(np.asarray, j)
        p = convert._np(p)
        for name, a, b in zip(j._fields, p, j):
            if name == "desc":
                assert (a.view(np.uint32) == b).all(-1).mean() >= 0.99, name
            elif b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)

    jlines_, jn = jax.jit(jls.line_temporal_track, static_argnums=(0, 4, 7))(
        jcfg, seq.rig, js.lines, js.line_map, jlk(js.prev_pyr_l, jl), R, tr, (H, W))
    plines_, pn = pls.line_temporal_track(pcfg, prig, ps.lines, ps.line_map,
                                          plk(ps.prev_pyr_l, pl), pR, ptr, (H, W))
    same(plines_, jlines_)
    assert int(pn) == int(jn) > 0

    jlines_, jn, jid = jax.jit(jls.line_detect_topup, static_argnums=0)(jcfg, il, jlines_,
                                                                 js.next_line_id)
    plines_, pn, pid = pls.line_detect_topup(pcfg, _img(seq.left[t]), plines_,
                                             ps.next_line_id)
    same(plines_, jlines_)
    assert (int(pn), int(pid)) == (int(jn), int(jid))

    jlines_ = jlines_._replace(desc=jlines.keyline_descriptors(il, jlines_.ep, jlines_.valid))
    plines_ = plines_._replace(desc=plines.keyline_descriptors(_img(seq.left[t]), plines_.ep,
                                                               plines_.valid))
    jlines_, jn = jax.jit(jls.line_associate, static_argnums=0)(jcfg, seq.rig, jlines_,
                                                              js.line_map, R, tr)
    plines_, pn = pls.line_associate(pcfg, prig, plines_, ps.line_map, pR, ptr)
    same(plines_, jlines_)
    assert int(pn) == int(jn)

    jlines_, jX, jok = jax.jit(jls.line_stereo_triangulate, static_argnums=(0, 3))(
        jcfg, seq.rig, jlines_, jlk(jl, jr), jax_fundamental(seq.rig))
    plines_, pX, pok = pls.line_stereo_triangulate(pcfg, prig, plines_, plk(pl, pr),
                                                   fundamental_from_rig(prig))
    same(plines_, jlines_)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert pok.any()
    np.testing.assert_allclose(pX.numpy()[pok.numpy()], np.asarray(jX)[np.asarray(jok)],
                               rtol=1e-3, atol=1e-3)

    jc = jls.line_pose_correspondences(jlines_, js.line_map)
    pc = pls.line_pose_correspondences(plines_, ps.line_map)
    np.testing.assert_array_equal(pc[2].numpy(), np.asarray(jc[2]))
    for a, b in zip(pc[:2], jc[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3)

    fi = jnp.asarray(states[t].frame_idx)
    jlines_, jmap, jn = jax.jit(jls.line_map_update, static_argnums=0)(jcfg, jlines_, js.line_map,
                                                                jX, jok, R, tr, fi)
    plines_, pmap, pn = pls.line_map_update(pcfg, plines_, ps.line_map, pX, pok, pR, ptr,
                                            ps.frame_idx)
    same(plines_, jlines_)
    same(pmap, jmap)
    assert int(pn) == int(jn)


