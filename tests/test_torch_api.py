"""The port's public API against the reference's, on the CPU: every name a
reference subpackage exports has its counterpart in the port's subpackage,
the port imports neither ``jax`` nor ``zenslam_tpu``, and the functions this
part of the API adds hold against the reference's on the same seeded
inputs (256x320 scenes, as tests/test_lk_pallas.py):

- ``triangulate_midpoint`` / ``triangulate_rectified``: 1e-5 relative
  (the midpoint on >= 90% of the points; on all, the port's distance to the
  float64 answer within 1e-5 or twice the reference's, which near-parallel
  rays make larger);
- ``triangulation_gates``: masks identical, except for points within 1e-5
  of a threshold;
- ``fundamental_8pt`` / ``essential_8pt``: 1e-4 after normalising scale
  and sign, on inlier matches;
- ``solve_fundamental_ransac``: identical inliers given the reference's
  Gumbel draws;
- ``pyramidal_lk`` (both pyramid forms, with and without initial flow):
  1e-3 px on the well-conditioned tracks, the rule of
  tests/test_torch_kernels.py::_points (>= 96 px from the border); the
  stacked pyramids and gradients 1e-6;
- ``empty_features`` / ``empty_landmarks``: equal fields;
- ``make_slam_step``: bit-identical to ``slam_step`` (the port alone);
- ``write_png_gray``: byte-identical files.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.estimation import epipolar as JE
from zenslam_tpu.estimation.ransac import best_hypothesis as j_best_hypothesis
from zenslam_tpu.geometry import triangulate as JT
from zenslam_tpu.geometry.camera import project
from zenslam_tpu.geometry.lie import se3_apply, so3_exp
from zenslam_tpu.io.synthetic import default_rig, smooth_texture
from zenslam_tpu.io.synthetic import write_png_gray as j_write_png_gray
from zenslam_tpu.ops import lk as JLK
from zenslam_tpu.ops.image import build_pyramid as j_build_pyramid
from zenslam_tpu.ops.image import remap as j_remap
from zenslam_tpu.pipeline import state as JS
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation import epipolar as PE
from zenslam_tpu_torch.estimation.ransac import best_hypothesis
from zenslam_tpu_torch.geometry import triangulate as PT
from zenslam_tpu_torch.io import synthetic as PSyn
from zenslam_tpu_torch.ops import lk as PLK
from zenslam_tpu_torch.pipeline import state as PS
from zenslam_tpu_torch.pipeline.step import make_slam_step, slam_step

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
H, W = 256, 320
SUBPACKAGES = sorted(p.parent.name for p in (ROOT / "zenslam_tpu").glob("*/__init__.py"))

# Reference entry points that the port keeps under its own names (none of
# them is exported by a reference __init__; ``ops`` exports the two kernel
# wrappers all the same).
RENAMED = {
    ("zenslam_tpu.pipeline.state", "resolve_use_pallas"):
        ("zenslam_tpu_torch.pipeline.state", "resolve_use_kernels"),
    ("zenslam_tpu.parallel.dist_ba", "shard_ba_problem_jit"):
        ("zenslam_tpu_torch.parallel.dist_ba", "shard_ba_problem_device"),
    ("zenslam_tpu.ops.lk_pallas", "lk_ragged_pallas"): ("zenslam_tpu_torch.ops", "lk_ragged"),
    ("zenslam_tpu.ops.orb_pallas", "orb_pallas"): ("zenslam_tpu_torch.ops", "orb_steered_brief"),
    ("zenslam_tpu.ops.orb_pallas", "orb_descriptors_pallas"):
        ("zenslam_tpu_torch.ops", "orb_steered_brief"),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _exports(sub: str) -> list:
    """The names the reference's ``zenslam_tpu/<sub>/__init__.py`` binds by
    its ``from ... import`` lines."""
    tree = ast.parse((ROOT / "zenslam_tpu" / sub / "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_every_reference_name(sub):
    port = importlib.import_module(f"zenslam_tpu_torch.{sub}")
    missing = [n for n in _exports(sub) if not hasattr(port, n)]
    assert not missing, f"zenslam_tpu_torch.{sub} lacks {missing}"


def test_exports_count_the_reference_names():
    counts = {s: len(_exports(s)) for s in ("ops", "geometry", "estimation", "backend", "eval",
                                            "frontend", "analysis")}
    assert counts == {"ops": 21, "geometry": 31, "estimation": 16, "backend": 21, "eval": 3,
                      "frontend": 2, "analysis": 5}
    assert "make_slam_step" in _exports("pipeline")


@pytest.mark.parametrize("ref,port", list(RENAMED.items()), ids=[r[1] for r in RENAMED])
def test_renamed_counterparts(ref, port):
    assert hasattr(importlib.import_module(ref[0]), ref[1])
    assert callable(getattr(importlib.import_module(port[0]), port[1]))


def test_analysis_exports_lazily_without_matplotlib():
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import zenslam_tpu_torch.analysis as a\n"
        "assert sorted(a.__all__) == ['PALETTE', 'apply_style', 'plot_detector_comparison',"
        " 'plot_feature_metrics', 'plot_timing_breakdown']\n"
        "try:\n"
        "    a.PALETTE\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('PALETTE imported without matplotlib')\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=str(ROOT))
    import zenslam_tpu_torch.analysis as pa

    style = importlib.import_module("zenslam_tpu_torch.analysis.style")
    ptb = importlib.import_module("zenslam_tpu_torch.analysis.plot_timing_breakdown")
    assert pa.PALETTE is style.PALETTE and pa.apply_style is style.apply_style
    # the name stays the main also after its module was imported, as in the reference
    assert pa.plot_timing_breakdown is ptb.main


def test_port_and_subpackages_import_neither_jax_nor_reference():
    subs = sorted(p.parent.name for p in (ROOT / "zenslam_tpu_torch").glob("*/__init__.py"))
    assert set(SUBPACKAGES) <= set(subs)
    code = (
        "import importlib, sys\n"
        "import zenslam_tpu_torch\n"
        f"for s in {subs!r}:\n"
        "    importlib.import_module('zenslam_tpu_torch.' + s)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'zenslam_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=str(ROOT))


# ---------------------------------------------------------------- geometry

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    jrig = default_rig(W, H)
    prig = convert.rig_from_numpy(jax.tree.map(np.asarray, jrig), "cpu")
    n = 64
    X = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(1.0, 8.0, (n, 1))],
                       axis=1).astype(np.float32)
    R_lw = np.asarray(so3_exp(jnp.asarray([0.03, -0.02, 0.01], jnp.float32)))
    t_lw = np.array([0.1, -0.05, 0.2], np.float32)
    R_rw = np.asarray(jrig.R_rl) @ R_lw
    t_rw = np.asarray(jrig.R_rl) @ t_lw + np.asarray(jrig.t_rl)
    uv_l = np.asarray(project(jrig.left, se3_apply(R_lw, t_lw, jnp.asarray(X))))
    uv_r = np.asarray(project(jrig.right, se3_apply(R_rw, t_rw, jnp.asarray(X))))
    uv_l = uv_l + rng.normal(0, 0.3, uv_l.shape).astype(np.float32)
    uv_r = uv_r + rng.normal(0, 0.3, uv_r.shape).astype(np.float32)
    return dict(jrig=jrig, prig=prig, X=X, R_lw=R_lw, t_lw=t_lw, R_rw=R_rw, t_rw=t_rw,
                uv_l=uv_l, uv_r=uv_r, rng=rng)


def _rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert (np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0)).all(), float(np.abs(a - b).max())


def test_triangulate_midpoint_and_rectified(scene):
    s, K = scene, np.asarray(scene["jrig"].left.K)
    args = (K, s["R_lw"], s["t_lw"], K, s["R_rw"], s["t_rw"], s["uv_l"], s["uv_r"])
    j = np.asarray(JT.triangulate_midpoint(*(jnp.asarray(a) for a in args)))
    p = PT.triangulate_midpoint(*(_t(a) for a in args)).numpy()
    # the rays of a distant point are near-parallel: where the reference's
    # own float32 answer is further than 1e-5 from the float64 one, the
    # port's distance to the float64 answer is held to twice the reference's
    exact = PT.triangulate_midpoint(*(_t(a).double() for a in args)).numpy()
    scale = np.maximum(np.abs(j), 1.0)
    ref_err = np.abs(j - exact).max(1, keepdims=True)
    assert (np.abs(p - exact) <= np.maximum(1e-5 * scale, 2 * ref_err)).all()
    assert (np.abs(p - j) <= 1e-5 * scale).all(1).mean() >= 0.9
    assert np.isfinite(j).all()
    fx, cx, cy, fy = (float(v) for v in (K[0, 0], K[0, 2], K[1, 2], K[1, 1]))
    b = float(np.linalg.norm(np.asarray(s["jrig"].t_rl)))
    rect = (fx, b, cx, cx, cy, fy)
    j = JT.triangulate_rectified(*rect, jnp.asarray(s["uv_l"]), jnp.asarray(s["uv_l"]) - 3.0)
    p = PT.triangulate_rectified(*rect, _t(s["uv_l"]), _t(s["uv_l"]) - 3.0)
    _rel(p.numpy(), j, 1e-5)
    zero = PT.triangulate_rectified(*rect, _t(s["uv_l"][:4]), _t(s["uv_l"][:4]))
    assert torch.isfinite(zero).all()


def _gate_margins(s, gates, X):
    """Each point's distance to its nearest gate threshold (float64)."""
    x_l = X @ s["R_lw"].T.astype(np.float64) + s["t_lw"]
    x_r = X @ s["R_rw"].T.astype(np.float64) + s["t_rw"]
    K = np.asarray(s["jrig"].left.K, np.float64)
    err_l = np.linalg.norm(x_l[:, :2] / x_l[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2] - s["uv_l"], axis=1)
    err_r = np.linalg.norm(x_r[:, :2] / x_r[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2] - s["uv_r"], axis=1)
    c_l = -s["R_lw"].T @ s["t_lw"]
    c_r = -s["R_rw"].T @ s["t_rw"]
    r0, r1 = X - c_l, X - c_r
    ang = np.degrees(np.arccos(np.clip((r0 * r1).sum(1) / (np.linalg.norm(r0, axis=1)
                                                             * np.linalg.norm(r1, axis=1)), -1, 1)))
    return np.min(np.abs(np.stack([
        x_l[:, 2] - 1e-6, x_r[:, 2] - 1e-6, x_l[:, 2] - gates.min_depth,
        x_l[:, 2] - gates.max_depth, err_l - gates.reprojection_threshold,
        err_r - gates.reprojection_threshold, ang - gates.min_parallax_deg,
        ang - gates.max_parallax_deg])), axis=0)


def test_triangulation_gates(scene):
    s = scene
    X = s["X"].copy()
    X[:6, 2] *= -1.0                       # behind both cameras
    X[6:10, 2] = 80.0                      # beyond max_depth, near-zero disparity
    X[10:14] += np.float32(0.05)           # off the observations: reprojection fails
    gates = PT.TriangulationGates()
    assert gates == PT.TriangulationGates(*JT.TriangulationGates())
    for g in (gates, gates._replace(min_depth=2.0, reprojection_threshold=0.6)):
        args = (s["R_lw"], s["t_lw"], X, s["uv_l"], s["uv_r"])
        j = np.asarray(JT.triangulation_gates(s["jrig"], *(jnp.asarray(a) for a in args),
                                              gates=JT.TriangulationGates(*g)))
        p = PT.triangulation_gates(s["prig"], *(_t(a) for a in args), gates=g).numpy()
        far = _gate_margins(s, g, X.astype(np.float64)) > 1e-5
        np.testing.assert_array_equal(p[far], j[far])
        assert not p[:14].any() and p.sum() > 20


# -------------------------------------------------------------- estimation

def _canon(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


@pytest.fixture(scope="module")
def matches(scene):
    """Pixel matches between the left view and a second pose, 30% outliers."""
    s, rng = scene, np.random.default_rng(5)
    R2 = np.asarray(so3_exp(jnp.asarray([0.0, 0.08, 0.0], jnp.float32))) @ s["R_lw"]
    t2 = s["t_lw"] + np.array([0.3, 0.0, 0.05], np.float32)
    X = s["X"]
    pa = np.array(project(s["jrig"].left, se3_apply(s["R_lw"], s["t_lw"], jnp.asarray(X))))
    pb = np.array(project(s["jrig"].left, se3_apply(R2, t2, jnp.asarray(X))))
    out = rng.random(len(X)) < 0.3
    pb[out] += rng.uniform(-30, 30, (out.sum(), 2)).astype(np.float32)
    valid = rng.random(len(X)) < 0.95
    return pa, pb, valid, out


def test_eight_point_solvers(matches, scene):
    """On the valid inlier matches (the refit's input): a least-squares fit
    through 30% outliers has a near-degenerate smallest eigenvector, where
    either float32 implementation is off by more than 1e-4."""
    pa, pb, valid, out = matches
    w = (valid & ~out).astype(np.float32)
    jF = JE.fundamental_8pt(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w))
    pF = PE.fundamental_8pt(_t(pa), _t(pb), _t(w))
    np.testing.assert_allclose(_canon(pF.numpy()), _canon(jF), atol=1e-4)
    K = np.asarray(scene["jrig"].left.K)
    na = (pa - K[:2, 2]) / K[[0, 1], [0, 1]]
    nb = (pb - K[:2, 2]) / K[[0, 1], [0, 1]]
    first = np.flatnonzero(~out)[:12]
    jE = JE.essential_8pt(jnp.asarray(na[first]), jnp.asarray(nb[first]))
    pE = PE.essential_8pt(_t(na[first]), _t(nb[first]))
    np.testing.assert_allclose(_canon(pE.numpy()), _canon(jE), atol=1e-4)


def test_solve_fundamental_ransac_given_reference_draws(matches):
    pa, pb, valid, _ = matches
    key, iters = jax.random.PRNGKey(4), 64
    j = JE.solve_fundamental_ransac(key, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid),
                                    threshold=2.0, iters=iters)
    noise = _t(jax.random.gumbel(key, (iters, len(pa))))
    p = PE.solve_fundamental_ransac(noise, _t(pa), _t(pb), _t(valid), threshold=2.0)
    np.testing.assert_array_equal(p["inliers"].numpy(), np.asarray(j["inliers"]))
    assert int(p["n_inliers"]) == int(j["n_inliers"]) > 30 and bool(p["ok"])
    assert abs(float(torch.linalg.det(p["F"].double()))) < 1e-6
    g = PE.solve_fundamental_ransac(None, _t(pa), _t(pb), _t(valid), iters=iters,
                                    generator=torch.Generator().manual_seed(0))
    assert int(g["n_inliers"]) >= int(j["n_inliers"]) - 2


def test_best_hypothesis_ties_to_lowest_index():
    scores = np.array([3, 7, 1, 7, 7], np.int32)
    assert int(best_hypothesis(_t(scores))) == int(j_best_hypothesis(jnp.asarray(scores))) == 1
    assert best_hypothesis(_t(scores)).dtype == torch.int32


# ------------------------------------------------------------------- LK

@pytest.fixture(scope="module")
def lk_pair():
    tex = smooth_texture(np.random.default_rng(7), H, W)
    my, mx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    img0 = jnp.asarray(tex)
    img1 = j_remap(img0, jnp.asarray(mx - 2.6), jnp.asarray(my + 1.7))
    return img0, img1


def test_stacked_pyramids(lk_pair):
    img0, img1 = lk_pair
    jl, jr, jsz = JLK.build_lk_pyramid_pair(img0, img1, 3)
    pl, pr, psz = PLK.build_lk_pyramid_pair(_t(img0), _t(img1), 3)
    for a, b in ((pl, jl), (pr, jr), (psz, jsz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    js, jsz = JLK.build_lk_pyramid(img0, 3)
    ps, psz = PLK.build_lk_pyramid(_t(img0), 3)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    levels = j_build_pyramid(img0, 3)
    jgx, jgy = JLK.stack_gradients(levels)
    pgx, pgy = PLK.stack_gradients(tuple(_t(x) for x in levels))
    np.testing.assert_allclose(pgx.numpy(), np.asarray(jgx), atol=1e-6)
    np.testing.assert_allclose(pgy.numpy(), np.asarray(jgy), atol=1e-6)


@pytest.mark.parametrize("form,with_init", [("levels", False), ("stack", True)])
def test_pyramidal_lk(lk_pair, form, with_init):
    img0, img1 = lk_pair
    rng = np.random.default_rng(11 + with_init)
    n = 24
    xy = np.stack([rng.uniform(96, W - 96, n), rng.uniform(96, H - 96, n)],
                  axis=1).astype(np.float32)
    valid = rng.random(n) > 0.1
    init = xy + np.array([2.6, -1.7], np.float32) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    if form == "levels":
        j0, j1 = j_build_pyramid(img0, 3), j_build_pyramid(img1, 3)
        p0, p1 = tuple(_t(x) for x in j0), tuple(_t(x) for x in j1)
    else:
        j0, j1 = JLK.build_lk_pyramid(img0, 3), JLK.build_lk_pyramid(img1, 3)
        p0, p1 = tuple(_t(x) for x in j0), tuple(_t(x) for x in j1)
    kw = dict(radius=7, iters=8, use_initial_flow=with_init)
    jt, jo, je = JLK.pyramidal_lk(j0, j1, jnp.asarray(xy), jnp.asarray(valid),
                                  init_pts=jnp.asarray(init), **kw)
    pt, po, pe = PLK.pyramidal_lk(p0, p1, _t(xy), _t(valid), init_pts=_t(init), **kw)
    jo = np.asarray(jo)
    np.testing.assert_array_equal(po.numpy(), jo)
    assert jo.sum() >= 0.8 * valid.sum()
    np.testing.assert_allclose(pt.numpy()[jo], np.asarray(jt)[jo], atol=1e-3)
    np.testing.assert_allclose(pe.numpy()[jo], np.asarray(je)[jo], atol=1e-4)
    np.testing.assert_allclose(pt.numpy()[jo] - xy[jo], np.broadcast_to([2.6, -1.7], xy[jo].shape),
                               atol=0.25)


# ------------------------------------------------------ tables and the step

@pytest.mark.parametrize("descriptor", ["orb", "sift"])
def test_empty_tables(descriptor):
    jc = JS.SlamConfig(max_keypoints=48, max_landmarks=96, descriptor=descriptor)
    pc = PS.SlamConfig(max_keypoints=48, max_landmarks=96, descriptor=descriptor)
    for jt, pt in ((JS.empty_features(jc), PS.empty_features(pc, device="cpu")),
                   (JS.empty_landmarks(jc), PS.empty_landmarks(pc, device="cpu"))):
        assert jt._fields == pt._fields
        for name, a, b in zip(jt._fields, jt, pt):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape) and (a == b.numpy()).all(), name
    state = PS.init_state(pc, (64, 64), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(state.features, PS.empty_features(pc, "cpu")))
    assert all(torch.equal(a, b) for a, b in zip(state.lmap, PS.empty_landmarks(pc, "cpu")))


def test_make_slam_step_bit_identical_to_slam_step():
    seq = PSyn.make_sequence(np.random.default_rng(5), n_frames=3, width=W, height=H,
                             motion="arc", device="cpu")
    cfg = PS.SlamConfig(max_keypoints=128, max_landmarks=512, pnp_iters=32, rigid_iters=32,
                        essential_iters=32)
    step = make_slam_step(cfg, seq.rig)
    a = b = PS.init_state(cfg, (H, W), seed=3, device="cpu")
    for t in range(3):
        img_l, img_r = torch.from_numpy(seq.left[t]), torch.from_numpy(seq.right[t])
        a, ta = step(a, img_l, img_r)
        b, tb = slam_step(cfg, seq.rig, b, img_l, img_r)
        for x, y in zip(ta, tb):
            assert torch.equal(x, y)
        assert all(torch.equal(x, y) for x, y in zip(a.features, b.features))
    assert int(ta.n_tracked) > 50


def test_write_png_gray_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (17, 23)).astype(np.uint8),
                rng.integers(0, 65536, (9, 31)).astype(np.uint16)):
        j_write_png_gray(str(tmp_path / "j.png"), img)
        PSyn.write_png_gray(str(tmp_path / "p.png"), img)
        assert (tmp_path / "j.png").read_bytes() == (tmp_path / "p.png").read_bytes()
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        PSyn.write_png_gray(str(tmp_path / "rgb.png"), np.zeros((4, 4, 3), np.uint8))
