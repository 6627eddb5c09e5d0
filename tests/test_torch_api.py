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

The reference's arguments: every parameter of every public top-level
function, and every field of every public NamedTuple or dataclass, of every
module of ``zenslam_tpu/`` (read by ``ast``) exists on the port's
counterpart or stands in ARG_RENAMED with its port name and a reason; and
the arguments that close that gap hold against the reference:

- the ratio-test matchers (Hamming and L2, ``use_ratio`` and
  ``cross_check`` on and off, with duplicate and near-duplicate rows):
  Hamming ``idx``, ``dist``, ``ok`` identical, L2 ``idx`` and ``ok``
  identical and ``dist`` within 1e-5;
- ``umeyama(with_scale=True)`` on noisy weighted similarity transforms,
  single and batched: R, t, s within 1e-5; without scale, s is 1 and (R,
  t) bit-identical to the rigid fit's;
- ``harris_score_multiscale(k=0.06)`` within 1e-6 of its maximum against
  the reference's per-scale ``harris_score`` at that k (the reference's
  ``harris_score_multiscale`` takes ``k`` and drops it;
  tests/test_torch_families.py holds the two at the default),
  ``detect_grid_keypoints``' ``mask_radius`` changing no output,
  ``ragged_to_stacked`` with ``true_sizes`` equal to the reference's on
  TPU-padded levels.
"""

import ast
import dataclasses
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.estimation import epipolar as JE
from zenslam_tpu.estimation import rigid as JR
from zenslam_tpu.estimation.ransac import best_hypothesis as j_best_hypothesis
from zenslam_tpu.geometry import triangulate as JT
from zenslam_tpu.geometry.camera import project
from zenslam_tpu.geometry.lie import se3_apply, so3_exp
from zenslam_tpu.io.synthetic import default_rig, smooth_texture
from zenslam_tpu.io.synthetic import write_png_gray as j_write_png_gray
from zenslam_tpu.ops import harris as JH
from zenslam_tpu.ops import lk as JLK
from zenslam_tpu.ops import match as JM
from zenslam_tpu.ops.image import build_pyramid as j_build_pyramid
from zenslam_tpu.ops.image import remap as j_remap
from zenslam_tpu.ops.lk_pallas import padded_level_shape
from zenslam_tpu.pipeline import state as JS
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.estimation import epipolar as PE
from zenslam_tpu_torch.estimation import rigid as PR
from zenslam_tpu_torch.estimation.ransac import best_hypothesis
from zenslam_tpu_torch.geometry import triangulate as PT
from zenslam_tpu_torch.io import synthetic as PSyn
from zenslam_tpu_torch.ops import fast as PF
from zenslam_tpu_torch.ops import harris as PH
from zenslam_tpu_torch.ops import lk as PLK
from zenslam_tpu_torch.ops import match as PM
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
    ("zenslam_tpu.ops.lk_pallas", "ragged_level_sizes"):
        ("zenslam_tpu_torch.ops.lk", "ragged_level_sizes"),
}

_NOISE = "randomness is injected: the caller's Gumbel draws replace the PRNG key"
_ITERS = "the hypothesis count is the first dimension of the injected noise"
_DRAW = "randomness is injected: the k-means seed draws replace the PRNG key"
_PALLAS = "a Pallas/TPU setting with no counterpart on the card"
# Reference parameters (and fields) the port names otherwise or leaves out:
# (reference function, parameter) -> (the port's name or None, the reason).
ARG_RENAMED = {
    **{(f"zenslam_tpu.estimation.{f}", "key"): ("noise", _NOISE) for f in (
        "cascade.estimate_pose_cascade", "epipolar.solve_fundamental_ransac",
        "epipolar.solve_essential_ransac", "epipolar.estimate_2d2d_scaled",
        "pnp.solve_pnp_ransac", "ransac.ransac_sample_indices", "rigid.solve_rigid_ransac")},
    **{(f"zenslam_tpu.estimation.{f}", "iters"): ("noise", _ITERS) for f in (
        "epipolar.solve_essential_ransac", "epipolar.estimate_2d2d_scaled",
        "pnp.solve_pnp_ransac", "ransac.ransac_sample_indices", "rigid.solve_rigid_ransac")},
    **{("zenslam_tpu.estimation.cascade.estimate_pose_cascade", f"{k}_iters"): ("noise", _ITERS)
       for k in ("pnp", "rigid", "essential")},
    ("zenslam_tpu.backend.bow.build_vocabulary", "key"): ("draw", _DRAW),
    ("zenslam_tpu.backend.bow.build_vocabulary_tree", "key"): ("draw", _DRAW),
    ("zenslam_tpu.pipeline.state.SlamState", "rng_key"):
        ("rng_seed", "a seed and a step count on the host stand for the JAX key"),
    ("zenslam_tpu.parallel.dist_ba.make_ba_mesh", "n_devices"):
        ("n_shards", "shards of one process group, not JAX devices"),
    ("zenslam_tpu.parallel.dist_ba.make_ba_mesh", "devices"):
        ("group", "a torch.distributed group (and a device) for the JAX device list"),
    ("zenslam_tpu.parallel.multihost.init_multihost", "platform"):
        ("backend", "the collective backend (nccl, gloo) for the JAX platform"),
    ("zenslam_tpu.parallel.multihost.init_multihost", "local_device_count"):
        ("local_shards", "shards per rank for JAX's local device count"),
    ("zenslam_tpu.parallel.offline.run_offline_multiprocess", "platform"):
        ("device", "the workers' torch device for the JAX platform"),
    ("zenslam_tpu.analysis.overlays.write_png", "arr"):
        ("img", "the port's overlays write through io/synthetic.py's PNG encoder"),
    ("zenslam_tpu.ops.lk_pallas.padded_level_shape", "h"):
        (None, "TPU tile padding; the port's pyramid levels are unpadded"),
    ("zenslam_tpu.ops.lk_pallas.padded_level_shape", "w"):
        (None, "TPU tile padding; the port's pyramid levels are unpadded"),
    ("zenslam_tpu.ops.lk_pallas.lk_ragged_pallas", "block"):
        (None, "points per Pallas program; the CUDA kernel runs a block per point"),
    ("zenslam_tpu.ops.lk_pallas.lk_ragged_pallas", "sizes"):
        (None, "the true sizes of TPU-padded levels; the port's levels are unpadded"),
    ("zenslam_tpu.ops.lk_pallas.lk_ragged_pallas", "unroll"): (None, _PALLAS),
    ("zenslam_tpu.ops.lk_pallas.lk_ragged_pallas", "interpret"): (None, _PALLAS),
    ("zenslam_tpu.ops.orb_pallas.orb_pallas", "block"): (None, _PALLAS),
    ("zenslam_tpu.ops.orb_pallas.orb_pallas", "interpret"): (None, _PALLAS),
    ("zenslam_tpu.ops.orb_pallas.orb_descriptors_pallas", "img"):
        ("sm", "the entry takes the smoothed bf16 image (orb_cuda.orb_descriptors_kernel "
               "takes img)"),
    ("zenslam_tpu.ops.orb_pallas.orb_descriptors_pallas", "interpret"): (None, _PALLAS),
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


def _ast_params(node) -> list:
    """The parameter names of a ``def``, or the annotated fields of a class
    (NamedTuple or dataclass) body."""
    if isinstance(node, ast.ClassDef):
        return [b.target.id for b in node.body
                if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            + [v for v in (a.vararg, a.kwarg) if v is not None]]


def _reference_api() -> list:
    """(dotted name, parameters) of every public top-level function and
    every public class with annotated fields in the modules of
    ``zenslam_tpu/``."""
    out = []
    for path in sorted((ROOT / "zenslam_tpu").rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                    and not node.name.startswith("_") and _ast_params(node)):
                out.append((f"{mod}.{node.name}", _ast_params(node)))
    return out


REFERENCE_API = _reference_api()


def _port_counterpart(name: str):
    """The port's object for a reference dotted name (RENAMED first), or
    None where the port has no module or name for it."""
    mod, attr = name.rsplit(".", 1)
    mod, attr = RENAMED.get((mod, attr), (mod.replace("zenslam_tpu", "zenslam_tpu_torch", 1),
                                          attr))
    try:
        return getattr(importlib.import_module(mod), attr, None)
    except ModuleNotFoundError:
        return None


def _port_params(obj) -> list:
    if obj is None:
        return []
    if isinstance(obj, type) and hasattr(obj, "_fields"):
        return list(obj._fields)
    if isinstance(obj, type) and dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    return list(inspect.signature(obj).parameters)


@pytest.mark.parametrize("name,params", REFERENCE_API, ids=[n for n, _ in REFERENCE_API])
def test_reference_arguments_have_counterparts(name, params):
    have = _port_params(_port_counterpart(name))
    missing = [p for p in params if p not in have and (name, p) not in ARG_RENAMED]
    assert not missing, f"the port's counterpart of {name} lacks {missing}"
    for p in params:
        if (name, p) in ARG_RENAMED:
            port_name, reason = ARG_RENAMED[(name, p)]
            assert reason and (port_name is None or port_name in have), (name, p)


def test_arg_renamed_rows_are_live():
    """Every ARG_RENAMED row names a reference parameter the port lacks."""
    api = dict(REFERENCE_API)
    assert len(api) > 250
    for (name, p) in ARG_RENAMED:
        assert p in api[name], (name, p)
        assert p not in _port_params(_port_counterpart(name)), (name, p)


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


# ------------------------------------------------- the reference's arguments

def _match_inputs(seed: int):
    """Descriptor sets with exact duplicates (ties) and near duplicates
    (close second bests): packed binary (64, 8) uint32 and float (64, 32)."""
    rng = np.random.default_rng(seed)
    n = 64
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    a[8:12] = a[0:4]                                        # duplicate rows of A
    b = a[rng.permutation(n)].copy()
    b ^= (rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
          & rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
          & rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32))
    b[20:24] = b[16:20]                                     # duplicate rows of B
    b[24:28] = b[28:32] ^ np.uint32(1)                      # near duplicates: 1 bit apart
    fa = rng.normal(0, 1, (n, 32)).astype(np.float32)
    fa /= np.linalg.norm(fa, axis=1, keepdims=True)
    fa[8:12] = fa[0:4]
    fb = fa[rng.permutation(n)] + rng.normal(0, 0.05, (n, 32)).astype(np.float32)
    fb[20:24] = fb[16:20]
    fb[24:28] = fb[28:32] + np.float32(1e-3)
    va, vb = rng.random(n) < 0.9, rng.random(n) < 0.9
    return a, b, fa, fb, va, vb


@pytest.mark.parametrize("use_ratio,cross_check", [(False, True), (True, True), (True, False),
                                                   (False, False)])
def test_ratio_matchers_match_reference(use_ratio, cross_check):
    a, b, fa, fb, va, vb = _match_inputs(17)
    kw = dict(ratio=0.8, cross_check=cross_check, use_ratio=use_ratio)
    j = JM.match_descriptors(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
                             max_distance=100, **kw)
    p = PM.match_descriptors(_t(a.view(np.int32)), _t(b.view(np.int32)), _t(va), _t(vb),
                             max_distance=100, **kw)
    for x, y in zip(p, j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    j = JM.match_descriptors_float(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(va),
                                   jnp.asarray(vb), max_distance=0.6, **kw)
    pf = PM.match_descriptors_float(_t(fa), _t(fb), _t(va), _t(vb), max_distance=0.6, **kw)
    np.testing.assert_array_equal(pf[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(pf[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(pf[1].numpy(), np.asarray(j[1]), atol=1e-5, rtol=0)
    n_ok = (int(p[2].sum()), int(pf[2].sum()))
    assert min(n_ok) > 10, n_ok
    if use_ratio:   # the duplicates' rows fail the test: their second best ties the best
        plain = PM.match_descriptors(_t(a.view(np.int32)), _t(b.view(np.int32)), _t(va),
                                     _t(vb), max_distance=100, cross_check=cross_check)
        assert int(p[2].sum()) < int(plain[2].sum())


def _similarity(rng, n: int, batch=()):
    """Noisy similarity-transformed points with weights: (src, dst, w)."""
    from zenslam_tpu_torch.geometry.lie import so3_exp as p_so3_exp

    w_rot = rng.normal(0, 0.6, batch + (3,)).astype(np.float32)
    R = p_so3_exp(_t(w_rot)).numpy()
    s = rng.uniform(0.5, 2.0, batch).astype(np.float32)
    t = rng.normal(0, 1, batch + (3,)).astype(np.float32)
    src = rng.normal(0, 1, batch + (n, 3)).astype(np.float32)
    dst = (s[..., None, None] * np.einsum("...ij,...nj->...ni", R, src) + t[..., None, :]
           + rng.normal(0, 0.01, batch + (n, 3))).astype(np.float32)
    w = rng.uniform(0.2, 1.0, batch + (n,)).astype(np.float32)
    return src, dst, w


def test_umeyama_with_scale_matches_reference():
    rng = np.random.default_rng(4)
    src, dst, w = _similarity(rng, 40)
    j_scaled = jax.jit(lambda a, b, c: JR.umeyama(a, b, c, with_scale=True))
    jR, jt, js = (np.asarray(x) for x in j_scaled(jnp.asarray(src), jnp.asarray(dst),
                                                   jnp.asarray(w)))
    R, t, s = (x.numpy() for x in PR.umeyama(_t(src), _t(dst), _t(w), with_scale=True))
    for a, b in ((R, jR), (t, jt), (s, js)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # batched: each problem as the reference solves it alone (vmapped)
    bs, bd, bw = _similarity(rng, 12, (3, 2))
    R, t, s = (x.numpy() for x in PR.umeyama(_t(bs), _t(bd), _t(bw), with_scale=True))
    assert R.shape == (3, 2, 3, 3) and t.shape == (3, 2, 3) and s.shape == (3, 2)
    j = jax.jit(jax.vmap(j_scaled))(*(jnp.asarray(x.reshape((6,) + x.shape[2:])) for x in (bs, bd, bw)))
    for a, b in zip((R, t, s), j):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape), atol=1e-5, rtol=0)
    # without scale: s is 1 and (R, t) the rigid fit, as the callers unpack it
    R, t, s = PR.umeyama(_t(bs), _t(bd), _t(bw))
    assert s.shape == (3, 2) and bool((s == 1).all())
    Rr, tr, sr = PR.umeyama(_t(bs), _t(bd), _t(bw), with_scale=False)
    assert torch.equal(R, Rr) and torch.equal(t, tr)
    jR, jt, js = jax.jit(JR.umeyama)(jnp.asarray(bs[1, 0]), jnp.asarray(bd[1, 0]),
                                     jnp.asarray(bw[1, 0]))
    assert float(js) == 1.0
    np.testing.assert_allclose(R[1, 0].numpy(), np.asarray(jR), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t[1, 0].numpy(), np.asarray(jt), atol=1e-5, rtol=0)


def test_harris_k_mask_radius_and_true_sizes(lk_pair):
    img = np.asarray(lk_pair[0])
    # k reaches every scale: the reference's per-scale harris_score at k=0.06
    k = 0.06
    ref = np.asarray(JH.harris_score(jnp.asarray(img), k=k))
    cur = jnp.asarray(img)
    for sc in range(1, 3):
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2])
        up = np.repeat(np.repeat(np.asarray(JH.harris_score(cur, k=k)), 1 << sc, 0), 1 << sc, 1)
        ref = np.maximum(ref, up[:H, :W])
    ref = np.where(ref > 1e-7, ref, 0.0)
    mine = PH.harris_score_multiscale(_t(img), k=k).numpy()
    scale = float(np.abs(ref).max())
    assert np.abs(mine - ref).max() <= 1e-6 * scale
    at_default = PH.harris_score_multiscale(_t(img)).numpy()
    assert np.abs(mine - at_default).max() > 1e-3 * scale       # k changed the response
    # mask_radius is accepted in the reference's position and changes nothing
    ex, ev = torch.zeros((32, 2)), torch.zeros(32, dtype=torch.bool)
    a = PF.detect_grid_keypoints(_t(img), ex, ev, 10.0 / 255.0, 16, 128, 8.0, 16, True)
    b = PF.detect_grid_keypoints(_t(img), ex, ev, 10.0 / 255.0, 16, 128, 2.0, 16, True)
    c = PF.detect_grid_keypoints(_t(img), ex, ev, max_keypoints=128, subpixel=True)
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))
    assert int(a[2].sum()) > 50
    # ragged_to_stacked crops TPU-padded levels (random texels in the
    # padding) to their true sizes, as the reference does
    tsz = PLK.ragged_level_sizes(H, W, 4)
    rng = np.random.default_rng(9)
    jl = [rng.random(padded_level_shape(h, w)).astype(np.float32) for h, w in tsz]
    assert any(x.shape != hw for x, hw in zip(jl, tsz))
    js, jsz = JLK.ragged_to_stacked([jnp.asarray(x) for x in jl], tsz)
    ps, psz = PLK.ragged_to_stacked(tuple(_t(x) for x in jl), tsz)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(psz.numpy(), np.asarray(jsz))
