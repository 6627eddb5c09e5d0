"""The two kernel modules of the port (ops/lk_cuda.py, ops/orb_cuda.py).

On the CPU: each kernel's plain PyTorch version against the Pallas kernel it
replaces, run in interpret mode as tests/test_lk_pallas.py and
tests/test_orb_pallas.py run it, on the same bf16 inputs and with the
per-frame step's arguments.

Tolerances:
- LK: <= 0.05 px on rows ok in both, ok flags agreeing on >= 90% of valid
  rows. The Pallas kernel rounds its bilinear selector weights and row
  products to bf16; the port interpolates with f32 weights.
- ORB: mean Hamming <= 1 and median |dtheta| <= 1e-3 rad on computed rows.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.io.synthetic import smooth_texture
from zenslam_tpu.ops.image import remap
from zenslam_tpu.ops.lk import build_ragged_pyramid_pair
from zenslam_tpu.ops.lk_pallas import lk_ragged_pallas, ragged_level_sizes
from zenslam_tpu.ops.orb_pallas import orb_descriptors_pallas
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.ops import lk_cuda, orb_cuda
from zenslam_tpu_torch.ops.match import unpack_bits

torch.set_num_threads(2)
H, W = 384, 512
LK_ARGS = dict(radius=10, iters=(5, 3, 3, 3), bwd_levels=1, compute_err=False,
               fb_threshold=1.0)


@pytest.fixture(scope="module")
def pair():
    tex = smooth_texture(np.random.default_rng(7), H, W)
    my, mx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    img0 = jnp.asarray(tex)
    img1 = remap(img0, jnp.asarray(mx - 3.2), jnp.asarray(my + 2.1))
    r0, r1 = build_ragged_pyramid_pair(img0, img1, 3, dtype=jnp.bfloat16)
    tsz = ragged_level_sizes(H, W, 4)
    crop = lambda r: tuple(convert.tensor_from_numpy(np.asarray(p)[:h, :w], "cpu")
                           for p, (h, w) in zip(r, tsz))
    return r0, r1, tsz, crop(r0), crop(r1)


def _points(seed, n):
    """Points >= 96 px from the border: the remapped frame's zero band at its
    left/top edge reaches the coarse levels' windows closer in, and tracks
    started there can lock onto a wrong basin in either implementation."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(96, W - 96, n), rng.uniform(96, H - 96, n)],
                  axis=1).astype(np.float32)
    valid = rng.random(n) > 0.1
    init = (xy + np.array([3.2, -2.1], np.float32)
            + rng.normal(0, 0.7, (n, 2)).astype(np.float32))
    return xy, valid, init


@pytest.mark.parametrize("with_init", [False, True])
def test_lk_plain_matches_pallas(pair, with_init):
    r0, r1, tsz, p0, p1 = pair
    xy, valid, init = _points(11 + with_init, 24)
    # the reference takes init_pts=None as the points themselves
    # (lk_pallas.py:377-378): passing them keeps one compile for both cases
    tj, oj, ej = lk_ragged_pallas(
        r0, r1, jnp.asarray(xy), jnp.asarray(valid),
        init_pts=jnp.asarray(init if with_init else xy), block=8, sizes=tsz,
        unroll=True, interpret=True, **LK_ARGS)
    tp, op, ep = lk_cuda.lk_ragged(
        p0, p1, torch.from_numpy(xy), torch.from_numpy(valid),
        init_pts=torch.from_numpy(init) if with_init else None, **LK_ARGS)
    oj, op = np.asarray(oj), op.numpy()
    both = oj & op
    assert both.sum() >= 0.8 * valid.sum()
    assert (oj == op)[valid].mean() >= 0.9
    np.testing.assert_allclose(tp.numpy()[both], np.asarray(tj)[both], atol=0.05, rtol=0)
    np.testing.assert_array_equal(tp.numpy()[~valid], xy[~valid])
    assert not op[~valid].any()
    assert not ep.numpy().any()  # compute_err=False
    # the true shift is recovered
    assert np.median(np.linalg.norm(tp.numpy()[op] - xy[op] - [3.2, -2.1], axis=1)) < 0.1


def test_lk_plain_residual_and_uniform_iters(pair):
    """compute_err=True and the uniform-iters form are kept in the contract."""
    r0, r1, tsz, p0, p1 = pair
    xy, valid, _ = _points(13, 16)
    args = dict(radius=10, iters=5, compute_err=True, do_backward=False)
    tj, oj, ej = lk_ragged_pallas(r0, r1, jnp.asarray(xy), jnp.asarray(valid), block=8,
                                  sizes=tsz, unroll=True, interpret=True, **args)
    tp, op, ep = lk_cuda.lk_ragged(p0, p1, torch.from_numpy(xy), torch.from_numpy(valid),
                                   **args)
    both = np.asarray(oj) & op.numpy()
    assert both.sum() >= 0.8 * valid.sum()
    np.testing.assert_allclose(tp.numpy()[both], np.asarray(tj)[both], atol=0.05, rtol=0)
    np.testing.assert_allclose(ep.numpy()[both], np.asarray(ej)[both], atol=2e-3, rtol=0)


@pytest.mark.parametrize("with_needs", [False, True])
def test_orb_plain_matches_pallas(with_needs):
    img = smooth_texture(np.random.default_rng(3), H, W)
    rng = np.random.default_rng(21)
    xy = np.stack([rng.uniform(0, W, 96), rng.uniform(0, H, 96)], axis=1).astype(np.float32)
    valid = rng.random(96) > 0.1
    needs = rng.random(96) < 0.3 if with_needs else None
    dj, thj = orb_descriptors_pallas(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid),
                                     needs=None if needs is None else jnp.asarray(needs),
                                     interpret=True)
    dp, thp = orb_cuda.orb_descriptors_kernel(
        torch.from_numpy(img), torch.from_numpy(xy), torch.from_numpy(valid),
        needs=None if needs is None else torch.from_numpy(needs))
    rows = valid if needs is None else valid & needs
    ham = (unpack_bits(dp) != unpack_bits(torch.from_numpy(np.array(dj).view(np.int32)))
           ).sum(-1).numpy()[rows]
    dth = np.abs(np.angle(np.exp(1j * (np.asarray(thj) - thp.numpy()))))[rows]
    assert ham.mean() <= 1.0
    assert np.median(dth) <= 1e-3
    if needs is None:
        assert not dp.numpy()[~valid].any()


def test_wrappers_take_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch."""
    before = (lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches)
    lv = (torch.zeros(64, 64), torch.zeros(32, 32))
    lk_cuda.lk_ragged(lv, lv, torch.zeros(4, 2), torch.ones(4, dtype=torch.bool), iters=2)
    orb_cuda.orb_steered_brief(torch.zeros(64, 64, dtype=torch.bfloat16),
                               torch.full((4, 2), 30.0), torch.ones(4, dtype=torch.bool))
    assert (lk_cuda.lk_ragged.launches, orb_cuda.orb_steered_brief.launches) == before
    with pytest.raises(TypeError):
        orb_cuda.orb_steered_brief(torch.zeros(64, 64), torch.zeros(4, 2),
                                   torch.ones(4, dtype=torch.bool))


def test_build_sources_switch_the_library(tmp_path):
    """A source directory other than ``csrc/`` builds its own library, named
    after the source's content; the default stays ``csrc/``'s."""
    from zenslam_tpu_torch.ops import cuda_build

    here = cuda_build.library_path("lk_fb")
    (tmp_path / "lk_fb.cu").write_text("// another revision\n")
    other = cuda_build.library_path("lk_fb", tmp_path)
    assert other != here and other.parent == here.parent
    assert cuda_build.library_path("lk_fb", cuda_build.CSRC_DIR) == here
    (tmp_path / "lk_fb.cu").write_text((cuda_build.CSRC_DIR / "lk_fb.cu").read_text())
    assert cuda_build.library_path("lk_fb", tmp_path) == here
