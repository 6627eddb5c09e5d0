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
"""

import numpy as np
import pytest
import torch

from zenslam_tpu_torch.io.synthetic import make_sequence, smooth_texture
from zenslam_tpu_torch.ops import lk_cuda, orb_cuda
from zenslam_tpu_torch.ops.image import gaussian_blur
from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
from zenslam_tpu_torch.pipeline import SlamConfig, init_state, slam_step

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
