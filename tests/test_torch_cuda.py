"""The port's CUDA kernels on a card (marked ``cuda``; each test skips
without a CUDA device). This file imports neither JAX nor zenslam_tpu, so
it also runs where JAX is absent, with the repo's conftest (which imports
JAX) left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
as chip_smoke.py does at full size: LK |dxy| <= 0.01 px on rows ok in both
with flags agreeing on >= 99% of valid rows; ORB >= 99% rows identical and
cos/sin within 1e-5. The differences left are the order of f32 sums (block
reductions) and nvcc's FMA contraction, not the sampling arithmetic, which
the kernels share with the plain versions.

The back end has no hand kernel; its tests hold the port on the card
against the port on the CPU: dense BA and the pose graph within 1e-4, the
vocabulary tree identical given the same k-means draws, and a short
``run_system`` with ``telemetry_lag=3`` on the kernels. The keyline ops and
stages (``ops/lines.py``, ``pipeline/lines_step.py``) run on the card with
no synchronise and agree with the CPU (masks and tables identical, points
within 1e-3 px / 1e-4 m); ``slam_step`` with keylines launches 4 LK and 1
ORB per frame. The other detector and descriptor families (Harris, DoG,
SIFT, FREAK, the float matcher and the LSH codes) agree with the CPU with
no synchronise on the card, and ``describe_refresh=4`` launches 2 LK and 1
ORB per frame, the ORB kernel's ``needs`` rows bit-identical to a full pass;
the app runs a family on the card by default, and ``--viz`` there reads
each keyframe's overlay inputs in one synchronising copy. The CG solver
agrees with the CPU (R and t 1e-4, xyz 1e-3 relative, the same accepted
steps) with no synchronise. The sharded BA's device
router gives the CPU's arrays, and its 8-shard solve over a one-rank NCCL
group is within 1e-4 of the CPU's over gloo, with no synchronise. A
default-config ``slam_step`` makes no implicit synchronise; BA's planned
block sums repeat bit for bit and equal ``index_add_`` on the CPU; the
fused multiply-add of ``ops/image.py`` (what the blurs and ORB moments run
on CUDA) is bit-identical to its float64 emulation. The captured programs
(``utils/graphs.py``, CUDA graphs): ``make_slam_step`` over 8 frames at
512x384 bit-identical to its eager form with 2 LK + 1 ORB launches a frame
counted through the replays, the dense and CG windows bit-identical to
eager, and a capture that cannot succeed raises.
"""

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.backend import ba, bow, pose_graph
from zenslam_tpu_torch.geometry.lie import se3_compose, se3_inverse, so3_exp
from zenslam_tpu_torch.io.synthetic import make_sequence, smooth_texture
from zenslam_tpu_torch.ops import lk_cuda, orb_cuda
from zenslam_tpu_torch.ops.image import gaussian_blur
from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
from zenslam_tpu_torch.pipeline import SlamConfig, init_state, slam_step
from zenslam_tpu_torch.pipeline import system as psystem

LK_ARGS = dict(radius=10, iters=(5, 3, 3, 3), bwd_levels=1, compute_err=False,
               fb_threshold=1.0)
LK_MARGIN = 4  # texels the LK kernel stages around the target window (csrc/lk_fb.cu)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_lk_kernel_matches_plain(dev):
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(7), 384, 512)).to(dev)
    shifted = torch.roll(tex, shifts=(-2, 3), dims=(0, 1))
    p0, p1 = build_ragged_pyramid_pair(tex, shifted, 3, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    xy = torch.rand((256, 2), generator=g, device=dev) * torch.tensor([320.0, 192.0], device=dev) + 96
    valid = torch.rand(256, generator=g, device=dev) > 0.1
    init = xy + torch.tensor([3.0, -2.0], device=dev)
    n0 = lk_cuda.lk_ragged.launches
    tk, ok_k, _ = lk_cuda.lk_ragged(p0, p1, xy, valid, init_pts=init, **LK_ARGS)
    tp, ok_p, _ = lk_cuda.lk_ragged_plain(p0, p1, xy, valid, init_pts=init, **LK_ARGS)
    assert lk_cuda.lk_ragged.launches == n0 + 1
    both = ok_k & ok_p
    assert int(both.sum()) >= 0.8 * int(valid.sum())
    assert (ok_k == ok_p)[valid].float().mean().item() >= 0.99
    assert (tk - tp).abs()[both].max().item() <= 0.01
    assert torch.equal(tk[~valid], xy[~valid])


def _lk_compare(p0, p1, xy, valid, init=None, min_both=0.5, **kw):
    """Kernel vs plain on one input; returns (tracked, ok, err) of the plain version."""
    args = dict(LK_ARGS, **kw)
    n0 = lk_cuda.lk_ragged.launches
    tk, ok_k, ek = lk_cuda.lk_ragged(p0, p1, xy, valid, init_pts=init, **args)
    assert lk_cuda.lk_ragged.launches == n0 + 1
    tp, ok_p, ep = lk_cuda.lk_ragged_plain(p0, p1, xy, valid, init_pts=init, **args)
    both = ok_k & ok_p
    assert int(both.sum()) >= min_both * int(valid.sum())
    assert (ok_k == ok_p)[valid].float().mean().item() >= 0.99
    assert (tk - tp).abs()[both].max().item() <= 0.01
    assert torch.equal(tk[~valid], xy[~valid]) and not ok_k[~valid].any()
    if args["compute_err"]:
        assert (ek - ep).abs()[valid].max().item() <= 1e-4
    return tp, ok_p, ep


@pytest.mark.cuda
def test_lk_kernel_restages_target_patch(dev):
    """One level and a 10 px shift of a smooth texture: level-0 Newton steps
    move the window further than the staged margin, so the kernel re-stages."""
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(7), 192, 256)).to(dev)
    tex = gaussian_blur(tex, sigma=3.0, radius=6)
    shifted = torch.roll(tex, shifts=(-6, 10), dims=(0, 1))
    p0, p1 = build_ragged_pyramid_pair(tex, shifted, 0, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(3)
    xy = torch.rand((128, 2), generator=g, device=dev) * torch.tensor([160.0, 100.0], device=dev)
    xy = xy + torch.tensor([48.0, 46.0], device=dev)
    valid = torch.ones(128, dtype=torch.bool, device=dev)
    tp, ok_p, _ = _lk_compare(p0, p1, xy, valid, iters=(20,), bwd_levels=1)
    moved = (tp - xy).abs().max(-1).values[ok_p]
    assert int((moved > LK_MARGIN + 1).sum()) >= 32


@pytest.mark.cuda
def test_lk_kernel_near_borders(dev):
    """Points within r+2 px of the level-0 border and at the corners; the
    uniform points put many within r+2 px of the coarse levels' borders."""
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(8), 384, 512)).to(dev)
    shifted = torch.roll(tex, shifts=(-2, 3), dims=(0, 1))
    p0, p1 = build_ragged_pyramid_pair(tex, shifted, 3, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(4)
    W, H = 512.0, 384.0
    u = torch.rand((4, 32), generator=g, device=dev)
    band = torch.rand((4, 32), generator=g, device=dev) * 12.0
    edges = torch.cat([
        torch.stack([u[0] * (W - 1), band[0]], -1),               # top
        torch.stack([u[1] * (W - 1), (H - 1) - band[1]], -1),     # bottom
        torch.stack([band[2], u[2] * (H - 1)], -1),               # left
        torch.stack([(W - 1) - band[3], u[3] * (H - 1)], -1)])    # right
    corners = torch.tensor([[0.0, 0.0], [W - 1, 0.0], [0.0, H - 1], [W - 1, H - 1],
                            [1.0, 1.0], [W - 2, H - 2]], device=dev)
    inner = torch.rand((122, 2), generator=g, device=dev) * torch.tensor([W - 1, H - 1], device=dev)
    xy = torch.cat([edges, corners, inner])
    valid = torch.rand(xy.shape[0], generator=g, device=dev) > 0.1
    init = xy + torch.tensor([3.0, -2.0], device=dev)
    _lk_compare(p0, p1, xy, valid, init=init, min_both=0.3)


@pytest.mark.cuda
def test_lk_kernel_f32_err_all_levels_backward(dev):
    """compute_err=True, an f32 pyramid and bwd_levels=0 (backward over all levels)."""
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(9), 384, 512)).to(dev)
    shifted = torch.roll(tex, shifts=(1, -4), dims=(0, 1))
    p0, p1 = build_ragged_pyramid_pair(tex, shifted, 3, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(5)
    xy = torch.rand((256, 2), generator=g, device=dev) * torch.tensor([448.0, 320.0], device=dev)
    xy = xy + 32
    valid = torch.rand(256, generator=g, device=dev) > 0.1
    _lk_compare(p0, p1, xy, valid, compute_err=True, bwd_levels=0, min_both=0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lk_kernel_odd_width_levels(dev, dtype):
    """Level widths that are not whole 16-byte chunks (509, 255, ...): the
    kernel stages those levels texel by texel instead of by cp.async."""
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(12), 381, 509)).to(dev)
    shifted = torch.roll(tex, shifts=(-3, 2), dims=(0, 1))
    p0, p1 = build_ragged_pyramid_pair(tex, shifted, 3, dtype=dtype)
    assert p0[0].shape[1] % 4 != 0
    g = torch.Generator(device=dev).manual_seed(9)
    xy = torch.rand((128, 2), generator=g, device=dev) * torch.tensor([508.0, 380.0], device=dev)
    valid = torch.rand(128, generator=g, device=dev) > 0.1
    _lk_compare(p0, p1, xy, valid, compute_err=True, min_both=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [3, 15])
def test_lk_kernel_other_radii(dev, radius):
    """The kernel's 2- and 8-cells-a-thread builds (r = 10 uses 4); a radius
    past lk_cuda.MAX_CUDA_RADIUS raises."""
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(10), 384, 512)).to(dev)
    shifted = torch.roll(tex, shifts=(2, -3), dims=(0, 1))
    p0, p1 = build_ragged_pyramid_pair(tex, shifted, 3, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(8)
    xy = torch.rand((128, 2), generator=g, device=dev) * torch.tensor([320.0, 192.0], device=dev) + 96
    valid = torch.rand(128, generator=g, device=dev) > 0.1
    _lk_compare(p0, p1, xy, valid, radius=radius, min_both=0.5)
    with pytest.raises(ValueError):
        lk_cuda.lk_ragged(p0, p1, xy, valid, **dict(LK_ARGS, radius=lk_cuda.MAX_CUDA_RADIUS + 1))


def _orb_compare(sm, xy, valid):
    n0 = orb_cuda.orb_steered_brief.launches
    wk, ck, sk = orb_cuda.orb_steered_brief(sm, xy, valid)
    assert orb_cuda.orb_steered_brief.launches == n0 + 1
    wp, cp, sp = orb_cuda.orb_steered_brief_plain(sm, xy, valid)
    assert (wk == wp).all(-1)[valid].float().mean().item() >= 0.99
    assert not wk[~valid].any()
    assert (ck - cp).abs().max().item() <= 1e-5 and (sk - sp).abs().max().item() <= 1e-5
    return wk, ck, sk


@pytest.mark.cuda
def test_orb_kernel_near_edges(dev):
    """Keypoints within 21 px (the staged patch's radius) of every edge, at
    the corners, on half-pixel centres and just outside the image."""
    img = torch.from_numpy(smooth_texture(np.random.default_rng(4), 384, 512)).to(dev)
    sm = gaussian_blur(img, sigma=2.0, radius=4).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(6)
    W, H = 512.0, 384.0
    u = torch.rand((4, 48), generator=g, device=dev)
    band = torch.rand((4, 48), generator=g, device=dev) * 21.0
    xy = torch.cat([
        torch.stack([u[0] * (W - 1), band[0]], -1),
        torch.stack([u[1] * (W - 1), (H - 1) - band[1]], -1),
        torch.stack([band[2], u[2] * (H - 1)], -1),
        torch.stack([(W - 1) - band[3], u[3] * (H - 1)], -1),
        torch.tensor([[0.0, 0.0], [W - 1, 0.0], [0.0, H - 1], [W - 1, H - 1],
                      [0.5, 0.5], [W - 1.5, H - 1.5], [20.5, 2.5], [2.5, H - 21.5],
                      [-3.0, 40.0], [W + 2.0, H + 2.0]], device=dev)])
    valid = torch.rand(xy.shape[0], generator=g, device=dev) > 0.05
    _orb_compare(sm, xy, valid)


@pytest.mark.cuda
def test_orb_kernel_needs_rows_match_full_pass(dev):
    img = torch.from_numpy(smooth_texture(np.random.default_rng(5), 384, 512)).to(dev)
    sm = gaussian_blur(img, sigma=2.0, radius=4).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(7)
    xy = torch.rand((256, 2), generator=g, device=dev) * torch.tensor([511.0, 383.0], device=dev)
    valid = torch.rand(256, generator=g, device=dev) > 0.1
    needs = (torch.rand(256, generator=g, device=dev) < 0.3) & valid
    wk, ck, sk = _orb_compare(sm, xy, valid)
    wn, cn, sn = orb_cuda.orb_steered_brief(sm, xy, needs, needs=needs)
    assert torch.equal(wn[needs], wk[needs])
    assert torch.equal(cn[needs], ck[needs]) and torch.equal(sn[needs], sk[needs])


@pytest.mark.cuda
def test_orb_kernel_matches_plain(dev):
    img = torch.from_numpy(smooth_texture(np.random.default_rng(3), 384, 512)).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    xy = torch.rand((256, 2), generator=g, device=dev) * torch.tensor([512.0, 384.0], device=dev)
    valid = torch.rand(256, generator=g, device=dev) > 0.1
    sm = gaussian_blur(img, sigma=2.0, radius=4).to(torch.bfloat16)
    n0 = orb_cuda.orb_steered_brief.launches
    wk, ck, sk = orb_cuda.orb_steered_brief(sm, xy, valid)
    wp, cp, sp = orb_cuda.orb_steered_brief_plain(sm, xy, valid)
    assert orb_cuda.orb_steered_brief.launches == n0 + 1
    assert (wk == wp).all(-1)[valid].float().mean().item() >= 0.99
    assert not wk[~valid].any()
    assert (ck - cp).abs().max().item() <= 1e-5 and (sk - sp).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_slice_runs_on_kernels(dev):
    """A few frames at 512x384: 2 LK and 1 ORB launches per frame, poses ok."""
    seq = make_sequence(np.random.default_rng(11), n_frames=6, motion="strafe",
                        device_render=True, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=2048)
    state = init_state(cfg, (384, 512), device=dev)
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    oks = []
    for t in range(6):
        state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        oks.append(bool(tel.pose_ok))
    assert lk_cuda.lk_ragged.launches - lk0 == 12
    assert orb_cuda.orb_steered_brief.launches - orb0 == 6
    assert all(oks[1:])


@pytest.mark.cuda
def test_bench_run_fps_on_kernels(dev):
    """``eval/bench.py:run_fps`` on the card (its default device): 2 LK and
    1 ORB launches per timed frame, finite fps, pose_ok after frame 0."""
    from zenslam_tpu_torch.eval.bench import run_fps

    rec = {}
    fps, tel = run_fps(512, 384, 12, n_warmup=4, record=rec)
    assert rec["launches"] == {"lk_fb": 16, "orb": 8}
    assert np.isfinite(fps) and fps > 0
    assert all(bool(t.pose_ok) for t in rec["tels"][1:])


def _rot(rng, sigma):
    return so3_exp(torch.from_numpy(rng.normal(0, sigma, 3).astype(np.float32)))


def _ba_problem(dev, seed=7, n_kf=6, n_lm=240):
    """A 6-keyframe stereo window on ``dev`` (drawn on the CPU): every
    landmark seen left and right by every keyframe with 0.3 px noise, poses
    (but the first) and landmarks perturbed."""
    rng = np.random.default_rng(seed)
    p = ba.make_ba_problem(8, 256, 2 * n_kf * n_lm, 400.0, 400.0, 320.0, 240.0,
                           t_rl=[-0.11, 0.0, 0.0], device=dev)
    p = _to(p, "cpu")      # drawn on the CPU, returned on dev
    X = torch.from_numpy(np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm),
                                   rng.uniform(4, 10, n_lm)], -1).astype(np.float32))
    R, t, kf, lm, uv, cam = p.R.clone(), p.t.clone(), [], [], [], []
    for k in range(n_kf):
        Rk = _rot(rng, 0.05)
        tk = torch.tensor([0.3 * k, 0.0, 0.0]) + torch.from_numpy(
            rng.normal(0, 0.02, 3).astype(np.float32))
        for c in (0, 1):
            xc = X @ Rk.T + tk + (p.t_rl if c else 0.0)
            u = torch.stack([400 * xc[:, 0] / xc[:, 2] + 320, 400 * xc[:, 1] / xc[:, 2] + 240], -1)
            uv.append(u + torch.from_numpy(rng.normal(0, 0.3, u.shape).astype(np.float32)))
            kf += [k] * n_lm
            lm += list(range(n_lm))
            cam += [c] * n_lm
        if k:
            dR = _rot(rng, 0.03)
            Rk, tk = dR @ Rk, dR @ tk + torch.from_numpy(rng.normal(0, 0.03, 3).astype(np.float32))
        R[k], t[k] = Rk, tk
    xyz = p.xyz.clone()
    xyz[:n_lm] = X + torch.from_numpy(rng.normal(0, 0.05, X.shape).astype(np.float32))
    i32 = torch.int32
    return _to(p._replace(R=R, t=t, kf_valid=torch.arange(8) < n_kf, kf_fixed=torch.arange(8) < 1,
                          xyz=xyz, lm_valid=torch.arange(256) < n_lm,
                          obs_kf=torch.tensor(kf, dtype=i32), obs_lm=torch.tensor(lm, dtype=i32),
                          obs_uv=torch.cat(uv), obs_cam=torch.tensor(cam, dtype=i32),
                          obs_valid=torch.ones(len(kf), dtype=torch.bool)), dev)


def _to(tree, dev):
    return type(tree)(*(x.to(dev) for x in tree))


def _ring_graph(n=6, seed=3):
    """A ring of n poses: noisy odometry edges, one loop edge, node 0 fixed."""
    rng = np.random.default_rng(seed)
    Rg = [_rot(rng, 0.3) for _ in range(n)]
    tg = [torch.from_numpy(rng.normal(0, 1.0, 3).astype(np.float32)) for _ in range(n)]
    edges = [(k + 1, k) for k in range(n - 1)] + [(n - 1, 0)]
    ei, ej, eR, et = [], [], [], []
    for i, j in edges:
        Rij, tij = se3_compose(Rg[i], tg[i], *se3_inverse(Rg[j], tg[j]))
        ei.append(i), ej.append(j), eR.append(Rij), et.append(tij)
    R0 = torch.stack([Rg[0]] + [_rot(rng, 0.05) @ r for r in Rg[1:]])
    t0 = torch.stack([tg[0]] + [x + torch.from_numpy(rng.normal(0, 0.1, 3).astype(np.float32))
                                for x in tg[1:]])
    E = len(edges)
    return pose_graph.PoseGraph(
        R=R0, t=t0, node_valid=torch.ones(n, dtype=torch.bool),
        node_fixed=torch.arange(n) == 0, edge_i=torch.tensor(ei, dtype=torch.int32),
        edge_j=torch.tensor(ej, dtype=torch.int32), edge_R=torch.stack(eR), edge_t=torch.stack(et),
        edge_valid=torch.ones(E, dtype=torch.bool),
        edge_weight=torch.tensor([1.0] * (E - 1) + [5.0]))


@pytest.mark.cuda
def test_dense_ba_and_pose_graph_on_card_match_cpu(dev):
    p = _ba_problem(dev)
    cpu = ba.bundle_adjust(_to(p, "cpu"), iterations=3)
    gpu = ba.bundle_adjust(p, iterations=3)
    for k in ("R", "t"):
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() <= 1e-4, k
    rel = (gpu["xyz"].cpu() - cpu["xyz"]).norm(dim=-1) / cpu["xyz"].norm(dim=-1).clamp(min=1.0)
    assert rel.max().item() <= 1e-3
    assert int(gpu["n_accepted"]) == int(cpu["n_accepted"]) == 3
    assert float(gpu["rmse_after"]) < 0.5 * float(gpu["rmse_before"])
    g = _ring_graph()
    cpu = pose_graph.optimize_pose_graph(g, iterations=15)
    gpu = pose_graph.optimize_pose_graph(_to(g, dev), iterations=15)
    for k in ("R", "t"):
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() <= 1e-4, k
    assert float(gpu["cost_after"]) < float(gpu["cost_before"]) / 5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(iterations=3, cg_iters=40),
                                dict(iterations=6, refine_landmarks=False)],
                         ids=["full", "motion_only"])
def test_cg_ba_on_card_matches_cpu_without_syncs(dev, kw):
    """The matrix-free CG solver (``ba_solver="cg"``, and ``"auto"`` above
    16 keyframes) on the card against the CPU on the dense test's window,
    with no implicit synchronise after a warm-up call."""
    p = _ba_problem(dev)
    cpu = ba.bundle_adjust_cg(_to(p, "cpu"), **kw)
    ba.bundle_adjust_cg(p, **kw)
    gpu = _no_syncs(ba.bundle_adjust_cg, p, **kw)
    for k in ("R", "t"):
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() <= 1e-4, k
    rel = (gpu["xyz"].cpu() - cpu["xyz"]).norm(dim=-1) / cpu["xyz"].norm(dim=-1).clamp(min=1.0)
    assert rel.max().item() <= 1e-3
    assert int(gpu["n_accepted"]) == int(cpu["n_accepted"]) > 0
    assert float(gpu["rmse_after"]) < 0.5 * float(gpu["rmse_before"])
    if kw.get("refine_landmarks") is False:
        assert torch.equal(gpu["xyz"], p.xyz)


def _recording_draw(seed):
    """A CPU ``draw`` that keeps what it drew at each level, and one that
    hands the same draws back on a device, by level (a captured program
    runs its function twice, to warm up and to capture; the draws go up
    before it runs)."""
    draw, seen = bow.GeneratorDraw(seed, "cpu"), {}

    def record(level, weight, n, iters):
        seen[level] = draw(level, weight, n, iters)
        return seen[level]

    def replay_on(dev):
        on_dev = {level: _to(d, dev) for level, d in seen.items()}
        return lambda level, weight, n, iters: on_dev[level]

    return record, replay_on


@pytest.mark.cuda
def test_vocabulary_tree_on_card_identical_given_draws(dev):
    rng = np.random.default_rng(9)
    centres = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    desc = centres[rng.integers(0, 40, 4000)] ^ (
        np.uint32(1) << rng.integers(0, 32, (4000, 8)).astype(np.uint32))
    desc = torch.from_numpy(desc.view(np.int32))
    valid = torch.from_numpy(rng.random(4000) < 0.9)
    record, replay_on = _recording_draw(13)
    cpu = bow.build_vocabulary_tree(desc, valid, branch=16, iters=6, draw=record)
    gpu = bow.build_vocabulary_tree(desc.to(dev), valid.to(dev), branch=16, iters=6,
                                    draw=replay_on(dev))
    assert torch.equal(gpu.l1.cpu(), cpu.l1) and torch.equal(gpu.l2.cpu(), cpu.l2)
    q, qv = desc[:1024].reshape(4, 256, 8), valid[:1024].reshape(4, 256)
    assert torch.equal(bow.descriptors_to_bow(gpu, q.to(dev), qv.to(dev)).cpu(),
                       bow.descriptors_to_bow(cpu, q, qv))


@pytest.mark.cuda
def test_run_system_with_lag_on_card(dev):
    """12 frames at 512x384 through the full system, telemetry read 3 frames
    late: every frame comes back in order, the kernels run 2 LK + 1 ORB per
    frame, every keyframe after the first runs BA and no BA run worsens."""
    seq = make_sequence(np.random.default_rng(11), n_frames=12, motion="strafe", speed=0.6,
                        device_render=True, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=2048, kf_min_frames=2,
                     kf_min_translation=0.04)
    bcfg = psystem.BackendConfig(telemetry_lag=3, bow_branch=16, vocab_retrain_kfs=4)
    s = psystem.create_system(cfg, bcfg, seq.rig, (384, 512))
    assert s.device.type == "cuda"
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    tel, infos = psystem.run_system(s, seq.left, seq.right)
    assert lk_cuda.lk_ragged.launches - lk0 == 24
    assert orb_cuda.orb_steered_brief.launches - orb0 == 12
    assert [i["frame"] for i in infos] == list(range(12))
    assert s.host_reads["telemetry"] == 12
    assert s.n_keyframes == int(tel.is_keyframe.sum()) >= 3
    assert s.n_ba_runs == s.n_keyframes - 1
    runs = [i["ba"].cpu().numpy() for i in infos if i["ba"] is not None]
    assert all(r[1] <= 1.05 * r[0] and r[2] == 0 for r in runs)
    assert tel.pose_ok[1:].all() and np.isfinite(tel.t_cw).all()


def _imu_batch(seed, S=64, n_valid=10):
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0, 1.0, (S, 3)).astype(np.float32)
    accel = (rng.normal(0, 2.0, (S, 3)) + [0, 9.81, 0]).astype(np.float32)
    dts = (0.005 * rng.uniform(0.8, 1.2, S)).astype(np.float32)
    mask = np.arange(S) < n_valid
    gyro[n_valid:] = 999.0
    return [torch.from_numpy(x) for x in (gyro, accel, dts, mask,
                                          rng.normal(0, 0.02, 3).astype(np.float32),
                                          rng.normal(0, 0.1, 3).astype(np.float32))]


@pytest.mark.cuda
def test_preintegrate_on_card_matches_cpu_without_syncs(dev):
    """The hoisted preintegration on the card: every field within 1e-5 of
    the CPU's (cov 1e-5 of its largest entry), with no synchronise (the
    sync debug mode raises on one)."""
    from zenslam_tpu_torch.imu.preintegration import preintegrate

    g, a, d, m, bg, ba_ = _imu_batch(0)
    cpu = preintegrate(g, a, d, m, bias_gyro=bg, bias_accel=ba_)
    args = [x.to(dev) for x in (g, a, d, m, bg, ba_)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = preintegrate(*args[:4], bias_gyro=args[4], bias_accel=args[5])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f, x, y in zip(cpu._fields, card, cpu):
        scale = float(y.abs().max()) if f == "cov" else 1.0
        assert float((x.cpu() - y).abs().max()) <= 1e-5 * scale, f


@pytest.mark.cuda
def test_fuse_poses_and_vio_update_on_card_match_cpu_without_syncs(dev):
    """fuse_poses, the gravity ring and the step's VIO update on the card:
    within 1e-5 of the CPU, with no synchronise."""
    from zenslam_tpu_torch.estimation.fusion import PoseCandidate, fuse_poses
    from zenslam_tpu_torch.imu.preintegration import preintegrate
    from zenslam_tpu_torch.io.synthetic import default_rig
    from zenslam_tpu_torch.pipeline.state import init_vio
    from zenslam_tpu_torch.pipeline.step import _vio_update

    rng = np.random.default_rng(3)
    M = 5
    cands = PoseCandidate(
        R=so3_exp(torch.from_numpy(rng.normal(0, 0.1, (M, 3)).astype(np.float32))),
        t=torch.from_numpy(rng.normal(0, 0.1, (M, 3)).astype(np.float32)),
        inlier_ratio=torch.from_numpy(rng.random(M).astype(np.float32)),
        mean_err=torch.from_numpy(rng.random(M).astype(np.float32)),
        n_inliers=torch.from_numpy(rng.integers(0, 100, M)),
        is_line=torch.zeros(M, dtype=torch.bool), valid=torch.tensor([1, 1, 0, 1, 1]).bool())
    scales = torch.tensor([3.0, 3.0, 0.1, 3.0, 0.1])
    g, a, d, m, _, _ = _imu_batch(1)
    it = preintegrate(g, a, d, m)
    rig = default_rig(64, 64, device="cpu")
    R0 = so3_exp(torch.tensor([0.0, 0.1, 0.0]))
    vio = init_vio()
    for k in range(3):   # fill the history on the CPU
        vio = _vio_update(rig, vio, it, a, m, R0, torch.zeros(3), R0,
                          torch.tensor([0.01 * k, 0.0, 0.0]), torch.tensor(True))
    cpu = (fuse_poses(cands, err_scale=scales),
           _vio_update(rig, vio, it, a, m, R0, torch.zeros(3), R0,
                       torch.tensor([0.05, 0.0, 0.0]), torch.tensor(True)))
    on = (PoseCandidate(*(x.to(dev) for x in cands)), scales.to(dev),
          type(it)(*(x.to(dev) for x in it)), type(vio)(*(x.to(dev) for x in vio)),
          default_rig(64, 64, device=dev), a.to(dev), m.to(dev), R0.to(dev))
    z, t1, ok = (torch.zeros(3, device=dev), torch.tensor([0.05, 0.0, 0.0], device=dev),
                 torch.ones((), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = (fuse_poses(on[0], err_scale=on[1]),
                _vio_update(on[4], on[3], on[2], on[5], on[6], on[7], z, on[7], t1, ok))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, y in zip(card[0] + tuple(card[1]), cpu[0] + tuple(cpu[1])):
        assert x.dtype == y.dtype
        assert float((x.cpu().double() - y.double()).abs().max()) <= 1e-5


def _to(tree, dev):
    """A tree of NamedTuples / tuples with its tensors moved to ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, dev) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_to(x, dev) for x in tree)
    return tree


def _no_syncs(fn, *args, **kwargs):
    """fn(*args, **kwargs) with the sync debug mode raising on any
    synchronise."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _lines_seq():
    return make_sequence(np.random.default_rng(11), n_frames=4, motion="strafe",
                         with_lines=True, device="cpu")


@pytest.mark.cuda
def test_keyline_detection_on_card_matches_cpu_without_syncs(dev):
    """detect_keylines (with and without keylines to mask) and
    keyline_descriptors on the corridor with stripes: masks identical,
    endpoints within 1e-3 px, >= 99% of descriptor rows identical, no
    synchronise on the card."""
    from zenslam_tpu_torch.ops.lines import detect_keylines, keyline_descriptors

    img = torch.from_numpy(_lines_seq().left[0])
    ex = (torch.zeros((4, 2, 2)), torch.zeros(4, dtype=torch.bool))
    for masked in (False, True):
        cpu = detect_keylines(img, *ex, min_length=16.0)
        card = _no_syncs(detect_keylines, img.to(dev), *(x.to(dev) for x in ex),
                         min_length=16.0)
        v = cpu[2]
        assert torch.equal(card[2].cpu(), v) and int(v.sum()) >= 8
        assert float((card[0].cpu()[v] - cpu[0][v]).abs().max()) <= 1e-3
        ex = (cpu[0][:4].clone(), cpu[2][:4].clone())
    d_cpu = keyline_descriptors(img, cpu[0], cpu[2])
    d_card = _no_syncs(keyline_descriptors, img.to(dev), cpu[0].to(dev), cpu[2].to(dev))
    assert (d_card.cpu() == d_cpu).all(-1).float().mean() >= 0.99


@pytest.mark.cuda
def test_lines_step_on_card_matches_cpu_without_syncs(dev):
    """Each lines_step stage on the card against the CPU from the same state
    (three CPU frames with keylines) and the same endpoint tracks (a fixed
    stand-in for LK): tables identical, 3D points within 1e-4 m, no
    synchronise on the card."""
    from zenslam_tpu_torch.geometry.camera import fundamental_from_rig
    from zenslam_tpu_torch.pipeline import lines_step as LS

    seq = _lines_seq()
    cfg = SlamConfig(max_keypoints=256, max_landmarks=2048, use_keylines=True)
    state = init_state(cfg, (384, 512), device="cpu")
    for t in range(3):
        state, _ = slam_step(cfg, seq.rig, state, torch.from_numpy(seq.left[t]),
                             torch.from_numpy(seq.right[t]))
    img = torch.from_numpy(seq.left[3])

    def lk(shift):
        def fb(pts, valid, init_pts=None):
            p = pts if init_pts is None else init_pts
            return p + shift, valid.clone(), torch.zeros_like(p[:, 0])
        return fb

    def stages(st, rig, img, F, shifts):
        lines, _ = LS.line_temporal_track(cfg, rig, st.lines, st.line_map, lk(shifts[0]),
                                          st.R_cw, st.t_cw, (384, 512))
        lines, n_det, next_id = LS.line_detect_topup(cfg, img, lines, st.next_line_id)
        lines, _ = LS.line_associate(cfg, rig, lines, st.line_map, st.R_cw, st.t_cw)
        lines, X, tri = LS.line_stereo_triangulate(cfg, rig, lines, lk(shifts[1]), F)
        corr = LS.line_pose_correspondences(lines, st.line_map)
        lines, lmap, n_new = LS.line_map_update(cfg, lines, st.line_map, X, tri, st.R_cw,
                                                st.t_cw, st.frame_idx)
        return lines, lmap, X, tri, corr, (n_det, next_id, n_new)

    shifts = torch.tensor([[-2.0, 0.0], [-9.0, 0.0]])   # the stand-in tracks' flow
    cpu = stages(state, seq.rig, img, fundamental_from_rig(seq.rig), shifts)
    rig = _to(seq.rig, dev)
    # the step computes F once per frame, outside the keyline stages (its
    # 3x3 inverse synchronises); the inputs are copied to the card first
    card = _no_syncs(stages, _to(state, dev), rig, img.to(dev), fundamental_from_rig(rig),
                     shifts.to(dev))
    assert int(cpu[0].valid.sum()) >= 8
    for a, b in zip(card[:2], cpu[:2]):
        for x, y in zip(a, b):
            if y.dtype.is_floating_point:
                assert float((x.cpu() - y).abs().max()) <= 1e-4
            else:
                assert torch.equal(x.cpu(), y)
    assert torch.equal(card[3].cpu(), cpu[3])
    assert float((card[2].cpu() - cpu[2])[cpu[3]].abs().max()) <= 1e-4
    assert all(int(x) == int(y) for x, y in zip(card[5], cpu[5]))


@pytest.mark.cuda
def test_slam_step_with_keylines_on_kernels(dev):
    """Six frames of the corridor with stripes at 512x384 with keylines: 4 LK
    (keypoints and keyline endpoints, temporal and stereo) and 1 ORB launch
    per frame, poses ok, keylines tracked and mapped."""
    seq = make_sequence(np.random.default_rng(11), n_frames=6, motion="strafe",
                        with_lines=True, device_render=True, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=2048, use_keylines=True)
    state = init_state(cfg, (384, 512), device=dev)
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    oks, n_lines = [], []
    for t in range(6):
        state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        oks.append(bool(tel.pose_ok))
        n_lines.append(int(tel.n_lines))
    assert lk_cuda.lk_ragged.launches - lk0 == 24
    assert orb_cuda.orb_steered_brief.launches - orb0 == 6
    assert all(oks[1:]) and min(n_lines[1:]) >= 8, n_lines
    assert int(tel.line_map_size) >= 4


@pytest.mark.cuda
def test_family_ops_on_card_match_cpu_without_syncs(dev):
    """Harris and DoG score planes (within 1e-5 of the plane's maximum, masks
    identical on >= 99.9% of pixels), SIFT (1e-4), FREAK (>= 99% of rows
    identical), the L2 matrix (1e-4 relative) with the float matcher (>= 99%
    of matches identical) and the LSH codes (>= 99.9% of bits) on the card
    against the CPU, with no synchronise on the card (tables copied on a
    first call, as the step's first frame does)."""
    from zenslam_tpu_torch.ops import dog, freak, harris, match, sift

    img = torch.from_numpy(make_sequence(np.random.default_rng(21), n_frames=1, width=320,
                                         height=240, motion="arc", device="cpu").left[0])
    g = torch.Generator().manual_seed(4)
    xy = torch.rand((256, 2), generator=g) * torch.tensor([304.0, 224.0]) + 8.0
    valid = torch.rand(256, generator=g) > 0.1
    card = (img.to(dev), xy.to(dev), valid.to(dev))
    sift.sift_descriptors(*card), freak.freak_descriptors(*card)
    match.lsh_binarize(torch.zeros((1, 128), device=dev))
    for fn in (lambda i: harris.harris_score_multiscale(i, threshold=1e-7),
               lambda i: dog.dog_score(i, threshold=0.008)):
        cpu, gpu = fn(img), _no_syncs(fn, card[0]).cpu()
        assert (gpu - cpu).abs().max() <= 1e-5 * cpu.abs().max()
        assert ((gpu > 0) == (cpu > 0)).float().mean() >= 0.999 and int((cpu > 0).sum()) > 50
    d_cpu = sift.sift_descriptors(img, xy, valid)
    d_gpu = _no_syncs(sift.sift_descriptors, *card)
    assert (d_gpu.cpu() - d_cpu).abs().max() <= 1e-4
    f_cpu, _ = freak.freak_descriptors(img, xy, valid)
    f_gpu, _ = _no_syncs(freak.freak_descriptors, *card)
    assert (f_gpu.cpu() == f_cpu).all(-1).float().mean() >= 0.99
    a, b = d_cpu[:128], d_cpu[torch.randperm(128, generator=g)] + 0.02 * torch.randn(
        (128, 128), generator=g)
    D_cpu = match.l2_matrix(a, b)
    D_gpu = _no_syncs(match.l2_matrix, a.to(dev), b.to(dev)).cpu()
    assert ((D_gpu - D_cpu).abs() <= 1e-4 * D_cpu.abs().clamp(min=1e-2)).all()
    va, vb = valid[:128], valid[128:]
    m_cpu = match.match_descriptors_float(a, b, va, vb, max_distance=0.55)
    m_gpu = _no_syncs(match.match_descriptors_float, a.to(dev), b.to(dev), va.to(dev),
                      vb.to(dev), max_distance=0.55)
    assert (m_gpu[0].cpu() == m_cpu[0]).float().mean() >= 0.99 and int(m_cpu[2].sum()) > 20
    c_cpu = match.lsh_binarize(d_cpu)
    c_gpu = _no_syncs(match.lsh_binarize, d_cpu.to(dev)).cpu()
    bits = lambda w: np.unpackbits(w.numpy().view(np.uint8), axis=-1)  # noqa: E731
    assert (bits(c_gpu) == bits(c_cpu)).mean() >= 0.999


@pytest.mark.cuda
def test_describe_refresh_step_on_kernels(dev):
    """Six frames at 512x384 with describe_refresh=4: 2 LK and 1 ORB launch
    per frame, poses ok; on the last frame's table (ages staggered) the
    kernel's rows under the refresh mask are bit-identical to a full pass,
    and the merge keeps the other valid rows' descriptors."""
    from zenslam_tpu_torch.ops.orb_cuda import orb_descriptors_kernel
    from zenslam_tpu_torch.pipeline import step as pstep

    seq = make_sequence(np.random.default_rng(11), n_frames=6, motion="strafe",
                        device_render=True, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=2048, describe_refresh=4)
    state = init_state(cfg, (384, 512), device=dev)
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    oks = []
    for t in range(6):
        state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        oks.append(bool(tel.pose_ok))
    assert lk_cuda.lk_ragged.launches - lk0 == 12
    assert orb_cuda.orb_steered_brief.launches - orb0 == 6
    assert all(oks[1:])
    # the tracks here all start on frame 0; stagger their ages as a longer
    # run does, so the refresh mask takes some valid rows and not others
    feats = state.features
    feats = feats._replace(age=torch.arange(feats.age.shape[0], dtype=torch.int32,
                                            device=dev) % 7)
    needs = feats.valid & (feats.age % 4 == 0)
    assert 0 < int(needs.sum()) < int(feats.valid.sum())
    part, _ = orb_descriptors_kernel(seq.left[5], feats.xy, feats.valid, needs=needs)
    full, _ = orb_descriptors_kernel(seq.left[5], feats.xy, feats.valid)
    assert torch.equal(part[needs], full[needs])
    merged = pstep._describe(cfg, True, seq.left[5], feats)
    keep = feats.valid & ~needs
    assert torch.equal(merged[needs], full[needs]) and torch.equal(merged[keep], feats.desc[keep])
    assert not merged[~feats.valid].any()


@pytest.mark.cuda
def test_app_runs_a_family_on_card(dev, tmp_path):
    """``python -m zenslam_tpu_torch.app`` on the card by default with an
    options file whose ``slam:`` section picks (dog, freak) and
    describe_refresh=4 on a 6-frame exported folder: no ORB launch, 2 LK
    launches a frame, a trajectory row per frame."""
    import yaml

    from zenslam_tpu_torch.app import main
    from zenslam_tpu_torch.io.synthetic import export_dataset

    seq = make_sequence(np.random.default_rng(5), n_frames=6, width=256, height=192,
                        motion="strafe", device="cpu")
    export_dataset(seq, str(tmp_path / "data"))
    opts = {"folder": dict(root=str(tmp_path / "data"), output=str(tmp_path / "out"),
                           groundtruth_file=str(tmp_path / "data" / "groundtruth.csv")),
            "slam": dict(max_keypoints=128, max_landmarks=1024, kf_min_frames=2,
                         detector="dog", descriptor="freak", describe_refresh=4)}
    path = tmp_path / "options.yaml"
    path.write_text(yaml.safe_dump(opts))
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    assert main(["--options-file", str(path), "--no-scene"]) == 0
    assert lk_cuda.lk_ragged.launches - lk0 == 12
    assert orb_cuda.orb_steered_brief.launches == orb0
    rows = (tmp_path / "out" / "trajectory.csv").read_text().strip().splitlines()
    assert len(rows) >= 6


@pytest.mark.cuda
def test_app_viz_on_card(dev, tmp_path, monkeypatch):
    """``app --viz`` on the card by default on an 8-frame exported folder
    with ``telemetry_lag=3``: 2 LK + 1 ORB launches a frame, the report and
    the overlays written, and each ``save_keyframe_overlays`` call, given
    the keyframe's device images and snapshot, makes exactly one
    synchronising device-to-host copy."""
    import warnings

    import yaml

    from zenslam_tpu_torch.analysis import overlays
    from zenslam_tpu_torch.app import main
    from zenslam_tpu_torch.io.synthetic import export_dataset

    seq = make_sequence(np.random.default_rng(5), n_frames=8, width=256, height=192,
                        motion="strafe", device="cpu")
    export_dataset(seq, str(tmp_path / "data"))
    out = tmp_path / "out"
    opts = {"folder": dict(root=str(tmp_path / "data"), output=str(out)),
            "slam": dict(max_keypoints=128, max_landmarks=1024, kf_min_frames=2),
            "backend": dict(telemetry_lag=3)}
    path = tmp_path / "options.yaml"
    path.write_text(yaml.safe_dump(opts))
    inner, syncs = overlays.save_keyframe_overlays, []

    def counted(viz_dir, frame_idx, left, right, snap, prev_snap=None):
        assert left.is_cuda and right.is_cuda and snap.xy.is_cuda
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                entry = inner(viz_dir, frame_idx, left, right, snap, prev_snap)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        return entry

    monkeypatch.setattr(overlays, "save_keyframe_overlays", counted)
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    assert main(["--options-file", str(path), "--viz", "--no-scene"]) == 0
    assert lk_cuda.lk_ragged.launches - lk0 == 16
    assert orb_cuda.orb_steered_brief.launches - orb0 == 8
    viz = sorted(p.name for p in (out / "viz").iterdir())
    html = (out / "diagnostics.html").read_text()
    assert sum(f.startswith("spatial_") for f in viz) >= 2
    assert sum(f.startswith("temporal_") for f in viz) >= 1
    assert all(f in html for f in viz)
    assert syncs and all(n == 1 for n in syncs), syncs


@pytest.fixture(scope="module")
def ba_meshes():
    """8-shard meshes on one rank: NCCL on the card, gloo on the CPU."""
    import torch.distributed as tdist

    from zenslam_tpu_torch.parallel import dist_ba

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    made = not tdist.is_initialized()
    if made:
        cuda = dist_ba.make_ba_mesh(8, device=dev)
    else:
        cuda = dist_ba.make_ba_mesh(8, group=tdist.new_group(backend="nccl"), device=dev)
    cpu = dist_ba.make_ba_mesh(8, group=tdist.new_group(backend="gloo"), device="cpu")
    assert tdist.get_backend(cuda.group) == "nccl"
    yield cuda, cpu
    if made:
        tdist.destroy_process_group()


@pytest.mark.cuda
def test_dist_ba_on_card_matches_cpu_without_syncs(ba_meshes):
    """The device router on the card gives the CPU's arrays; the 8-shard
    solve over the one-rank NCCL mesh is within 1e-4 of the CPU's over
    gloo, and neither makes an implicit synchronise on the card."""
    from zenslam_tpu_torch.parallel import dist_ba

    cuda, cpu = ba_meshes
    p = _ba_problem(cuda.device)
    O = p.obs_kf.shape[0]
    for ops in (2 * -(-O // 8), 64):
        ps, n_drop = _no_syncs(dist_ba.shard_ba_problem_device, p, 8, ops)
        qs, q_drop = dist_ba.shard_ba_problem_device(_to(p, "cpu"), 8, ops)
        assert int(n_drop) == int(q_drop)
        for name in ps._fields:
            assert torch.equal(getattr(ps, name).cpu(), getattr(qs, name)), name
    ps, _ = dist_ba.shard_ba_problem_device(p, 8, 2 * -(-O // 8))
    dist_ba.dist_bundle_adjust(ps, cuda, iterations=1)       # the communicator's first use
    gpu = _no_syncs(dist_ba.dist_bundle_adjust, ps, cuda, iterations=4)
    cpu_r = dist_ba.dist_bundle_adjust(_to(ps, "cpu"), cpu, iterations=4)
    for k in ("R", "t"):
        assert (gpu[k].cpu() - cpu_r[k]).abs().max().item() <= 1e-4, k
    rel = (gpu["xyz"].cpu() - cpu_r["xyz"]).norm(dim=-1) / cpu_r["xyz"].norm(dim=-1).clamp(min=1.0)
    assert rel.max().item() <= 1e-3
    assert float(gpu["cost_after"]) < 0.1 * float(gpu["cost_before"])
    dense = ba.bundle_adjust(p, iterations=4)
    assert (gpu["t"] - dense["t"]).abs().max().item() <= 5e-3


@pytest.mark.cuda
def test_slam_step_makes_no_implicit_synchronise(dev):
    """A default-config ``slam_step`` on the card, after two warm-up frames,
    makes no implicit synchronise (22 a frame until the front end's
    constants, indexing and inverses were kept on the device and the pose
    recovery's SVD was made by hand)."""
    import warnings

    seq = make_sequence(np.random.default_rng(11), n_frames=6, motion="arc",
                        device_render=True, device=dev)
    cfg = SlamConfig()
    state = init_state(cfg, (384, 512), device=dev)
    for t in range(2):
        state, _ = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t in range(2, 6):
                state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = sorted({f"{w.filename}:{w.lineno}" for w in caught       # not the prototype notice
                    if "synchroniz" in str(w.message) and "prototype" not in str(w.message)})
    assert not sites, sites
    assert bool(tel.pose_ok)


@pytest.mark.cuda
def test_ba_planned_sums_repeat_on_card_and_match_cpu(dev):
    """BA's block sums on the card (``backend.ba.seg_sum``, by keyframe and
    by landmark): the same bits on every run, and the bits of
    ``index_add_`` on the CPU (both add each group's rows in row order)."""
    p = _ba_problem(dev)
    K, M = p.R.shape[0], p.xyz.shape[0]
    r, w, kf, lm, Jp, Jl = ba._obs_jacobians(p, p.R, p.t, p.xyz, 1.0)
    plans = ba.ba_plans(p)
    keep = p.obs_valid.cpu()
    for plan, idx, n, v in ((plans.kf, kf, K, torch.einsum("oai,oaj->oij", Jp * w[:, None, None], Jp)),
                            (plans.lm, lm, M, torch.einsum("oai,oa->oi", Jl * w[:, None, None], r))):
        outs = [ba.seg_sum(plan, v) for _ in range(20)]
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        ref = torch.zeros((n,) + v.shape[1:]).index_add_(0, idx.cpu()[keep], v.cpu()[keep])
        assert torch.equal(outs[0].cpu(), ref)


@pytest.mark.cuda
def test_fused_fma_bit_identical_to_float64_on_card(dev):
    """``ops/image.py:fma`` on CUDA (one fused float32 op) against its
    float64 emulation: no element differs over 4M random multiply-adds of
    each form (a scalar weight, two tensors), the blurs of a 1024x1024
    texture and the ORB moments."""
    from zenslam_tpu_torch.ops import image, orb

    g = torch.Generator(device=dev).manual_seed(3)
    a, b, c = (torch.randn(1 << 22, generator=g, device=dev) for _ in range(3))
    for w in (float(torch.tensor(0.1234567)), float(torch.tensor(1 / 3.0))):   # float32 weights
        assert int((image._fma_fused(w, b, c) != image._fma_f64(w, b, c)).sum()) == 0
    assert int((image._fma_fused(a, b, c) != image._fma_f64(a, b, c)).sum()) == 0
    tex = torch.from_numpy(smooth_texture(np.random.default_rng(9), 1024, 1024)).to(dev)
    fused = [gaussian_blur(tex, 2.0, 4), gaussian_blur(tex, 1.0, 2), *orb.orb_moments(tex)]
    saved = image.fma, orb.fma
    image.fma = orb.fma = image._fma_f64
    try:
        emulated = [gaussian_blur(tex, 2.0, 4), gaussian_blur(tex, 1.0, 2), *orb.orb_moments(tex)]
    finally:
        image.fma, orb.fma = saved
    assert [int((x != y).sum()) for x, y in zip(fused, emulated)] == [0, 0, 0, 0]


def _tree_identical(a, b) -> bool:
    from zenslam_tpu_torch.utils.graphs import flatten

    la, lb = [], []
    flatten(a, la)
    flatten(b, lb)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
def test_graphed_step_bit_identical_to_eager(dev):
    """``make_slam_step``'s captured step (a CUDA graph, its state updated
    in place) over 8 frames at 512x384 against the same step under
    ``graphs.eager()``: every state and telemetry tensor bit-identical, and
    the replays count 2 LK + 1 ORB launches a frame (16 / 8)."""
    from zenslam_tpu_torch.pipeline import make_slam_step
    from zenslam_tpu_torch.utils.graphs import eager

    seq = make_sequence(np.random.default_rng(11), n_frames=8, motion="strafe",
                        device_render=True, device=dev)
    cfg = SlamConfig()
    step = make_slam_step(cfg, seq.rig)
    ref, s = [], init_state(cfg, (384, 512), device=dev)
    with eager():
        for t in range(8):
            s, tel = step(s, seq.left[t], seq.right[t])
            ref.append((s, tel))
    lk0, orb0 = lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches
    s = init_state(cfg, (384, 512), device=dev)
    for t in range(8):
        s, tel = step(s, seq.left[t], seq.right[t])
        assert _tree_identical(s, ref[t][0]) and _tree_identical(tel, ref[t][1]), t
    assert lk_cuda.lk_ragged.launches - lk0 == 16
    assert orb_cuda.orb_steered_brief.launches - orb0 == 8
    assert step.program.captured and all(c.graph is not None
                                         for c in step.program.captured.values())


@pytest.mark.cuda
def test_graphed_windows_bit_identical_to_eager(dev):
    """The windowed BA as a captured program, dense (W=8) and CG (W=24), on
    a 16-frame system's inputs at 512x384: outputs bit-identical to the
    eager window, on the first replay and the next."""
    from zenslam_tpu_torch.utils.graphs import eager

    seq = make_sequence(np.random.default_rng(11), n_frames=16, motion="strafe",
                        device_render=True, device=dev)
    s = psystem.create_system(SlamConfig(), psystem.BackendConfig(), seq.rig, (384, 512),
                              device=dev)
    psystem.run_system(s, seq.left, seq.right)
    assert s.n_ba_runs >= 1
    lm = s.state.lmap
    args = (s.kf_db, lm.xyz, lm.valid, lm.generation, s.state.R_cw, s.state.t_cw, s.rig)
    for solver, W in (("dense", 8), ("cg", 24)):
        with eager():
            want = psystem._windowed_ba(*args, W=W, solver=solver, iterations=6)
        for _ in range(2):
            got = psystem._windowed_ba(*args, W=W, solver=solver, iterations=6)
            assert _tree_identical(got, want), solver
    keys = [k for k in psystem._WINDOWED_BA.captured if dict(k[0])["W"] in (8, 24)]
    assert len(keys) >= 2


@pytest.mark.cuda
def test_failed_capture_raises(dev):
    """A program whose function reads the device (``float`` of a tensor, a
    synchronise) cannot be captured: the call raises, nothing is kept, and
    nothing falls back to the eager form."""
    from zenslam_tpu_torch.utils.graphs import Program

    def reads_back(x):
        return (x + float(x.sum()),)

    prog = Program(reads_back)
    x = torch.arange(8.0, device=dev)
    with pytest.raises(RuntimeError):
        prog(x)
    assert not prog.captured
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 56.0
