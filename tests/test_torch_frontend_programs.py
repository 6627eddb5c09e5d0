"""The front end's, the IMU's, the estimators', the telemetry's and the
device render's library functions as captured programs (``utils/graphs.py``)
at their own entry points, on the CPU, where a ``Program`` runs its function
on its static buffers with the buffer logic that replays CUDA graphs on a
card (``chip_smoke.py`` ``[frontend]`` holds the same on the card). No JAX:
each program is held to its own ``graphs.eager()`` form, at small sizes
(64x96 images, 48 keypoints).

- every function that the reference jits there, called directly: two calls
  with other inputs (and other traced floats) through one capture, each
  bit-identical to its eager call; the first call's result, kept,
  unchanged by the second; the caller's inputs untouched;
- the traced floats (``preintegrate_continuous``'s ``t0``/``t1``,
  ``gravity_add_sample``'s ``dt01``/``dt12``) capture nothing new over three
  values;
- jit's nesting rule: an eager ``slam_step`` (keylines, fusion and IMU on)
  and a ``make_slam_step`` frame capture and call no front-end program;
- nothing left out: every ``jax.jit`` of the reference's ``ops/``,
  ``imu/``, ``estimation/``, ``pipeline/state.py`` and ``io/synthetic.py``
  (read as text), but the three Pallas entry points, is a ``Program`` at
  its port name with the reference's static arguments that the port keeps.
"""

import ast
import gc
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.estimation import cascade, epipolar, fusion, pnp, rigid
from zenslam_tpu_torch.estimation.ransac import gumbel
from zenslam_tpu_torch.geometry.camera import project
from zenslam_tpu_torch.geometry.lie import se3_apply, so3_exp
from zenslam_tpu_torch.imu import continuous, gravity, preintegration
from zenslam_tpu_torch.io import synthetic
from zenslam_tpu_torch.ops import dog, fast, freak, harris, image, lines, lk, match, orb, sift
from zenslam_tpu_torch.pipeline import state as pstate
from zenslam_tpu_torch.pipeline.step import make_slam_step, slam_step
from zenslam_tpu_torch.utils import graphs
from zenslam_tpu_torch.utils.graphs import Program, eager, flatten

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
H, W, N = 64, 96, 48
# the jitted Pallas entry points; their counterparts are the kernel wrappers
PALLAS = {("ops/lk_pallas.py", "lk_ragged_pallas"), ("ops/orb_pallas.py", "orb_pallas"),
          ("ops/orb_pallas.py", "orb_descriptors_pallas")}


def _leaves(tree) -> list:
    out = []
    flatten(tree, out)
    return out


def _identical(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return (flatten(a, []) == flatten(b, []) and len(la) == len(lb)
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)))


def _copy(tree):
    return graphs.unflatten(flatten(tree, []), iter([t.clone() for t in _leaves(tree)]))


def _gen(s: int) -> torch.Generator:
    return torch.Generator().manual_seed(s)


def _img(s: int):
    return torch.from_numpy(synthetic.smooth_texture(np.random.default_rng(s), H, W))


def _striped(s: int):
    """A texture with two bright bars and a dark one (keylines)."""
    img = 0.3 + 0.2 * _img(s)
    img[10 + 3 * s:14 + 3 * s, 8:88] = 0.9
    img[30:60, 20 + 5 * s:24 + 5 * s] = 0.9
    img[44 - s:47 - s, 30:90] = 0.05
    return img


def _xy(s: int, margin: float = 24.0):
    g = _gen(s + 40)
    lo = torch.tensor([margin, margin])
    return lo + torch.rand(N, 2, generator=g) * (torch.tensor([W, H]) - 2 * lo)


def _valid(s: int):
    return torch.arange(N) % 7 != s


def _desc(s: int, n: int = N):
    g = _gen(s + 60)
    centres = torch.randint(-2 ** 31, 2 ** 31 - 1, (6, 8), generator=g, dtype=torch.int32)
    flips = torch.randint(0, 32, (n, 8), generator=g, dtype=torch.int32)
    return centres[torch.randint(0, 6, (n,), generator=g)] ^ (1 << flips)


def _fdesc(s: int, n: int = N):
    d = torch.rand(n, 128, generator=_gen(s + 70))
    return d / d.norm(dim=-1, keepdim=True)


def _maps(s: int):
    g = _gen(s + 80)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                          torch.arange(W, dtype=torch.float32), indexing="ij")
    return u + torch.rand(H, W, generator=g) * 3 - 1.5, v + torch.rand(H, W, generator=g) - 0.5


def _pyr(s: int, shift: float = 0.0):
    img = torch.roll(_img(s), shifts=(0, int(shift)), dims=(0, 1))
    with eager():
        return image.build_pyramid(img, 2)


def _rig():
    return synthetic.default_rig(W, H, device="cpu")


def _scene(s: int, n: int = N):
    """Points 2-5 m ahead, two poses, pixels in the left camera of each."""
    g = _gen(s + 90)
    X = torch.stack([torch.rand(n, generator=g) * 4 - 2, torch.rand(n, generator=g) * 3 - 1.5,
                     torch.rand(n, generator=g) * 3 + 2], -1)
    R0, t0 = so3_exp(torch.tensor([0.01, 0.02, 0.0]) * s), torch.tensor([0.05 * s, 0.0, 0.0])
    R1 = so3_exp(torch.tensor([0.0, 0.05, 0.01])) @ R0
    t1 = t0 + torch.tensor([0.3, 0.02, 0.05])
    cam = _rig().left
    uv0 = project(cam, se3_apply(R0, t0, X))
    uv1 = project(cam, se3_apply(R1, t1, X)) + torch.randn(n, 2, generator=g) * 0.3
    uv1[::9] += 25.0                                     # outliers
    return X, R0, t0, R1, t1, uv0, uv1


def _imu(s: int, S: int = 12):
    g = _gen(s + 100)
    return (torch.randn(S, 3, generator=g) * 0.3,
            torch.randn(S, 3, generator=g) + torch.tensor([0.0, -9.81, 0.0]),
            torch.full((S,), 0.005) + torch.rand(S, generator=g) * 1e-3, torch.arange(S) < S - 2)


def _continuous(s: int):
    gyro, accel, _, mask = _imu(s, 24)
    ts = torch.linspace(0.0, 0.115, 24)[torch.randperm(24, generator=_gen(s))]
    return ts, gyro, accel, mask, 0.0125 + 0.001 * s, 0.0625 + 0.003 * s


def _gravity_est(s: int):
    g = _gen(s + 110)
    est = gravity.gravity_init(16, device="cpu")
    k = 10 + s
    return est._replace(samples=torch.randn(16, 3, generator=g) + torch.tensor([0, -9.8, 0]),
                        valid=torch.arange(16) < k,
                        next_slot=torch.tensor(k % 16, dtype=torch.int32))


def _gravity_args(s: int):
    g = _gen(s + 120)
    p0 = torch.randn(3, generator=g)
    v = torch.tensor([0.3, 0.0, 0.1])
    return (_gravity_est(s), p0, p0 + 0.05 * v, p0 + 0.1 * v + torch.tensor([0.0, 0.005, 0.0]),
            0.05 + 0.001 * s, 0.05 - 0.002 * s, so3_exp(torch.tensor([0.0, 0.1 * s, 0.0])),
            torch.tensor([0.1, -9.7, 0.2]))


def _tel(s: int):
    g = _gen(s + 130)
    ints = [torch.randint(0, 500, (), generator=g) for _ in range(6)]
    return pstate.FrameTelemetry(
        *ints[:5], pose_method=torch.tensor(s % 4, dtype=torch.int32),
        pose_ok=torch.tensor(True), tracked_ratio=torch.rand((), generator=g),
        is_keyframe=torch.tensor(s % 2 == 0), map_size=ints[5],
        n_lines=torch.tensor(3 * s), n_line_triangulated=torch.tensor(s),
        line_map_size=torch.tensor(2 * s), R_cw=so3_exp(torch.randn(3, generator=g) * 0.1),
        t_cw=torch.randn(3, generator=g))


def _rigid(s: int):
    X, R0, t0, *_ = _scene(s)
    dst = se3_apply(R0, t0, X) + torch.randn(N, 3, generator=_gen(s)) * 0.01
    dst[::11] += 1.0
    return gumbel(_gen(s + 1), (32, N), "cpu"), X, dst, _valid(s)


def _pnp(s: int):
    X, R0, t0, R1, t1, uv0, uv1 = _scene(s)
    K = _rig().left.K
    noise = gumbel(_gen(s + 2), (2, 32, N), "cpu")
    return (noise, torch.stack([K, K]), torch.stack([X, X]), torch.stack([uv0, uv1]),
            torch.stack([_valid(s), _valid(s + 1)]))


def _pnp_init(s: int):
    _, R0, t0, R1, t1, *_ = _scene(s)
    return dict(R_init=torch.stack([R0, R1]), t_init=torch.stack([t0, t1]))


def _cands(s: int):
    g = _gen(s + 140)
    M = 5
    return fusion.PoseCandidate(
        R=so3_exp(torch.randn(M, 3, generator=g) * 0.1), t=torch.randn(M, 3, generator=g) * 0.1,
        inlier_ratio=torch.rand(M, generator=g), mean_err=torch.rand(M, generator=g),
        n_inliers=torch.randint(0, 100, (M,), generator=g),
        is_line=torch.tensor([False, False, False, True, False]),
        valid=torch.tensor([True, True, s == 1, True, True]))


def _cascade(s: int):
    X, R0, t0, R1, t1, uv0, uv1 = _scene(s)
    rig = _rig()
    noise = cascade.draw_cascade_noise(_gen(s + 3), N, 16, 16, 16, "cpu")
    xr = se3_apply(rig.R_rl, rig.t_rl, se3_apply(R1, t1, X))
    uv_r = project(rig.right, xr)
    v = _valid(s)
    X_prev_cam = se3_apply(R0, t0, X)
    return (noise, rig, X, uv1, v, X, uv_r, v, X_prev_cam, se3_apply(R1, t1, X), v,
            R0, t0, uv0, uv1, v, X_prev_cam, v, R0, t0)


def _two_view(s: int):
    X, R0, t0, R1, t1, uv0, uv1 = _scene(s)
    return uv0, uv1, _valid(s)


def _essential(s: int):
    uv0, uv1, v = _two_view(s)
    return gumbel(_gen(s + 4), (32, N), "cpu"), _rig().left.K, uv0, uv1, v


def _recover(s: int):
    noise, K, uv0, uv1, v = _essential(s)
    with eager():
        E = epipolar.solve_essential_ransac(noise, K, uv0, uv1, v)["E"]
    return E, K, uv0, uv1, v


def _two_d(s: int):
    X, R0, t0, R1, t1, uv0, uv1 = _scene(s)
    noise, K, *_ = _essential(s)
    return noise, K, uv0, uv1, _valid(s), se3_apply(R0, t0, X), _valid(s + 2), R0, t0


def _world_arrays(s: int):
    world = synthetic.make_corridor_world(np.random.default_rng(s), tex_size=64)
    arrays = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (
        world.normals, world.offsets, world.origins, world.u_axes, world.v_axes,
        world.textures))
    return (*arrays, float(world.tex_scale))


def _render(s: int):
    cam = _rig().left
    R = so3_exp(torch.tensor([0.0, 0.05 * s, 0.0]))
    return (_world_arrays(s), float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), R,
            torch.tensor([0.1 * s, 0.0, 0.3]), H, W)


def _score(s: int):
    with eager():
        return fast.fast_score(_img(s), 0.02)


def _lines(s: int):
    img = _striped(s)
    with eager():
        ep, _, v = lines.detect_keylines(img, torch.zeros(4, 2, 2),
                                         torch.zeros(4, dtype=torch.bool), cell_size=16,
                                         max_keylines=8)
    return img, ep, v


GRID = dict(cell_size=8, max_keypoints=N, border=4)

# entry point -> (program, inputs of call a (seed 1) and b (seed 2: same
# shapes, other values and traced floats), keyword arguments)
CASES = {
    "gaussian_blur": (image.gaussian_blur, lambda s: (_img(s),), dict(sigma=1.5, radius=3)),
    "build_pyramid": (image.build_pyramid, lambda s: (_img(s),), dict(levels=3)),
    "remap": (image.remap, lambda s: (_img(s), *_maps(s)), {}),
    "clahe": (image.clahe, lambda s: (_img(s),), dict(clip_limit=3.0, grid=4)),
    "scharr_gradients": (image.scharr_gradients, lambda s: (_img(s),), {}),
    "fast_score": (fast.fast_score, lambda s: (_img(s),), dict(threshold=0.02)),
    "select_grid_keypoints": (fast.select_grid_keypoints, lambda s: (
        _score(s), _xy(s), _valid(s) & (torch.arange(N) < 8)), dict(GRID, subpixel=True)),
    "detect_grid_keypoints": (fast.detect_grid_keypoints, lambda s: (
        _img(s), _xy(s), _valid(s) & (torch.arange(N) < 8)), dict(GRID, threshold=0.02)),
    "orb_orientation": (orb.orb_orientation, lambda s: (_img(s), _xy(s)), {}),
    "orb_descriptors": (orb.orb_descriptors, lambda s: (_img(s), _xy(s), _valid(s)), {}),
    "hamming_matrix": (match.hamming_matrix, lambda s: (_desc(s), _desc(s + 5)), {}),
    "match_descriptors": (match.match_descriptors, lambda s: (
        _desc(s), _desc(s)[torch.randperm(N, generator=_gen(s))] ^ 1, _valid(s),
        _valid(s + 1)), dict(max_distance=80, use_ratio=True)),
    "l2_matrix": (match.l2_matrix, lambda s: (_fdesc(s), _fdesc(s + 5)), {}),
    "match_descriptors_float": (match.match_descriptors_float, lambda s: (
        _fdesc(s), _fdesc(s)[torch.randperm(N, generator=_gen(s))] + 0.01, _valid(s),
        _valid(s + 1)), dict(max_distance=0.5, cross_check=False, use_ratio=True)),
    "lsh_binarize": (match.lsh_binarize, lambda s: (_fdesc(s),), {}),
    "radius_gate": (match.radius_gate, lambda s: (_xy(s), _xy(s + 5), 20.0), {}),
    "epipolar_gate": (match.epipolar_gate, lambda s: (   # rectified: rows within 2 px
        torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.5 * s]]), _xy(s),
        _xy(s + 5), 2.0), {}),
    "pyramidal_lk (levels)": (lk.pyramidal_lk, lambda s: (
        _pyr(s), _pyr(s, 2.0), _xy(s), _valid(s)), dict(radius=4, iters=3)),
    "pyramidal_lk (stacked, initial flow)": (lk.pyramidal_lk, lambda s: (
        lk.stack_pyramid(_pyr(s)), lk.stack_pyramid(_pyr(s, 2.0)), _xy(s), _valid(s),
        _xy(s) + 1.5), dict(radius=4, iters=3, use_initial_flow=True)),
    "lk_forward_backward": (lk.lk_forward_backward, lambda s: (
        lk.stack_pyramid(_pyr(s)), lk.stack_pyramid(_pyr(s, 2.0)), _xy(s), _valid(s)),
        dict(radius=4, iters=3)),
    "harris_score": (harris.harris_score, lambda s: (_img(s),), {}),
    "harris_score_multiscale": (harris.harris_score_multiscale, lambda s: (_img(s),),
                                dict(n_scales=2)),
    "dog_score": (dog.dog_score, lambda s: (_img(s),), dict(n_octaves=2, threshold=0.002)),
    "sift_descriptors": (sift.sift_descriptors, lambda s: (_img(s), _xy(s), _valid(s)), {}),
    "freak_descriptors": (freak.freak_descriptors, lambda s: (_img(s), _xy(s), _valid(s)), {}),
    "detect_keylines": (lines.detect_keylines, lambda s: (
        _striped(s), torch.zeros(4, 2, 2), torch.zeros(4, dtype=torch.bool)),
        dict(cell_size=16, max_keylines=8)),
    "keyline_descriptors": (lines.keyline_descriptors, lambda s: _lines(s),
                            dict(n_along=16, n_perp=16)),
    "preintegrate": (preintegration.preintegrate, lambda s: _imu(s), {}),
    "preintegrate_continuous (lpm)": (continuous.preintegrate_continuous, _continuous,
                                      dict(n_grid=16)),
    "preintegrate_continuous (ugpm)": (continuous.preintegrate_continuous, _continuous,
                                       dict(n_grid=16, method="ugpm")),
    "gravity_add_sample": (gravity.gravity_add_sample, _gravity_args, {}),
    "gravity_estimate": (gravity.gravity_estimate, lambda s: (_gravity_est(s),), {}),
    "pack_telemetry": (pstate.pack_telemetry, lambda s: (_tel(s),), {}),
    "solve_rigid_ransac": (rigid.solve_rigid_ransac, _rigid, {}),
    "solve_pnp_ransac": (pnp.solve_pnp_ransac, _pnp, dict(refine_iters=3)),
    "solve_pnp_ransac (priors)": (pnp.solve_pnp_ransac, lambda s: (*_pnp(s), 3.0, 3, 2.0,
                                                                    *_pnp_init(s).values()), {}),
    "fuse_poses": (fusion.fuse_poses, lambda s: (_cands(s), torch.tensor(
        [3.0, 3.0, 0.1, 3.0, 0.1])), {}),
    "estimate_pose_cascade": (cascade.estimate_pose_cascade, _cascade,
                              dict(fuse=True, pred_sigma_p=0.05)),
    "solve_fundamental_ransac": (epipolar.solve_fundamental_ransac, lambda s: (
        gumbel(_gen(s + 5), (32, N), "cpu"), *_two_view(s)), {}),
    "solve_fundamental_ransac (default draw)": (epipolar.solve_fundamental_ransac, lambda s: (
        None, *_two_view(s)), dict(iters=32)),
    "solve_essential_ransac": (epipolar.solve_essential_ransac, _essential, {}),
    "recover_pose_from_essential": (epipolar.recover_pose_from_essential, _recover, {}),
    "estimate_2d2d_scaled": (epipolar.estimate_2d2d_scaled, _two_d, dict(min_inliers=6)),
    "_render_view_device": (synthetic._render_view_device, _render, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_is_a_program_held_to_eager(name):
    prog, make, kw = CASES[name]
    assert isinstance(prog, Program) and prog.copy_outputs
    a, b = make(1), make(2)
    a_in, b_in = _copy(a), _copy(b)
    got_a = prog(*a, **kw)
    kept = _copy(got_a)
    held = len(prog.captured)
    got_b = prog(*b, **kw)
    assert len(prog.captured) == held             # other values and floats: the same capture
    assert _identical(got_a, kept)                # the caller's result, untouched
    with eager():
        want_a, want_b = prog(*a, **kw), prog(*b, **kw)
    assert _identical(got_a, want_a) and _identical(got_b, want_b)
    assert not _identical(got_a, got_b)
    assert _identical(a, a_in) and _identical(b, b_in)    # the inputs, never written


def test_traced_floats_capture_once():
    ts, gyro, accel, mask, *_ = _continuous(1)
    prog, held = continuous.preintegrate_continuous, []
    for t0, t1 in ((0.01, 0.05), (0.0133, 0.0711), (0.02, 0.1)):
        got = prog(ts, gyro, accel, mask, t0, t1, n_grid=8)
        held.append(len(prog.captured))
        with eager():
            want = prog(ts, gyro, accel, mask, t0, t1, n_grid=8)
        assert _identical(got, want) and float(got.dt) == pytest.approx(t1 - t0, rel=1e-5)
    assert held[0] == held[1] == held[2]          # one capture for the three values
    args, prog, held = list(_gravity_args(1)), gravity.gravity_add_sample, []
    for dt01, dt12 in ((0.05, 0.05), (0.04, 0.06), (0.1 / 3, 0.0625)):
        args[4:6] = dt01, dt12
        got = prog(*args)
        held.append(len(prog.captured))
        with eager():
            assert _identical(got, prog(*args))
    assert held[0] == held[1] == held[2]


def _front_end() -> dict:
    """Every front-end program by name (the cases' programs)."""
    return {p.__name__: p for p, _, _ in CASES.values()}


def test_eager_step_and_captured_step_capture_no_front_end_program():
    seq = synthetic.make_sequence(np.random.default_rng(5), n_frames=2, width=128, height=96,
                                  motion="arc", with_imu=True, with_lines=True, device="cpu")
    cfg = pstate.SlamConfig(max_keypoints=64, max_landmarks=256, pnp_iters=16, rigid_iters=16,
                            essential_iters=16, use_keylines=True, max_keylines=8,
                            use_pose_fusion=True)
    front = _front_end()
    before = {k: (len(p.captured), graphs.calls(p)) for k, p in front.items()}
    gc.collect()                                  # earlier tests' dropped programs
    held = graphs.graphs_held()
    st = pstate.init_state(cfg, (96, 128), device="cpu")
    frames = [(torch.from_numpy(seq.left[t]), torch.from_numpy(seq.right[t]),
               tuple(torch.from_numpy(x[t]) for x in (seq.gyro, seq.accel, seq.imu_dts,
                                                      seq.imu_mask))) for t in range(2)]
    for left, right, imu in frames:
        st, _ = slam_step(cfg, seq.rig, st, left, right, imu=imu)
    assert graphs.graphs_held() == held           # eager: nothing captured anywhere
    step = make_slam_step(cfg, seq.rig)
    st2 = pstate.init_state(cfg, (96, 128), device="cpu")
    st2, tel = step(st2, *frames[0][:2], imu=frames[0][2])
    assert graphs.graphs_held() - held == len(step.program.captured) == 1
    assert {k: (len(p.captured), graphs.calls(p)) for k, p in front.items()} == before


def _reference_jits() -> list:
    """(file under zenslam_tpu/, function, static_argnames) of every
    ``jax.jit``-decorated function of the sliced reference modules."""
    ref = REPO / "zenslam_tpu"
    files = sorted(f for d in ("ops", "imu", "estimation") for f in (ref / d).glob("*.py"))
    files += [ref / "pipeline/state.py", ref / "io/synthetic.py"]
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if not isinstance(node, ast.FunctionDef):
                continue
            for dec in node.decorator_list:
                src = ast.unparse(dec)
                if "jit" not in src:
                    continue
                static = ()
                for kw in getattr(dec, "keywords", []):
                    if kw.arg == "static_argnames":
                        static = tuple(ast.literal_eval(kw.value))
                found.append((str(f.relative_to(ref)), node.name, static))
    return found


def test_every_reference_jit_is_a_program():
    found = _reference_jits()
    assert len(found) == 43 and PALLAS <= {(f, n) for f, n, _ in found}
    for f, name, static in found:
        if (f, name) in PALLAS:
            continue
        mod = importlib.import_module("zenslam_tpu_torch." + f[:-3].replace("/", "."))
        prog = getattr(mod, name)
        assert isinstance(prog, Program) and prog.copy_outputs, (f, name)
        kept = set(static) & set(prog.signature.parameters)
        assert kept <= set(prog.static_argnames), (f, name, static, prog.static_argnames)
