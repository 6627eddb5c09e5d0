"""The port's other detector and descriptor families (ops/harris.py,
ops/dog.py, ops/sift.py, ops/freak.py and the float matcher and LSH codes
of ops/match.py) against the JAX reference's functions on the CPU, on one
240x320 frame of the 'arc' sequence (seed 21) and, for DoG, a 753-row frame
(odd sizes crop at each octave and pad back):

- Harris and DoG score planes within 1e-5 of the plane's maximum, nonzero
  masks identical on >= 99.9% of pixels, and ``select_grid_keypoints`` on
  each plane with >= 99% of keypoints identical within 1e-3 px;
- SIFT descriptors within 1e-4 per element (invalid rows zero);
- FREAK codes identical on >= 99% of rows with mean Hamming <= 1 (a field
  comparison of two equal bilinear samples may flip), θ within 1e-5;
- ``l2_matrix`` within 1e-4 relative, ``match_descriptors_float`` with
  identical matches, with and without a gate;
- ``_lsh_planes`` bit-identical, ``lsh_binarize`` codes identical on
  >= 99.9% of bits (a projection within rounding of 0 may flip);
- ``slam_step`` with (fast, orb, describe_refresh=4) teacher-forced as
  ``tests/test_torch_families_step.py`` holds the other families.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.ops import dog as jdog
from zenslam_tpu.ops import fast as jfast
from zenslam_tpu.ops import freak as jfreak
from zenslam_tpu.ops import harris as jharris
from zenslam_tpu.ops import match as jmatch
from zenslam_tpu.ops import sift as jsift
from zenslam_tpu_torch.ops import dog, fast, freak, harris, match, sift
from test_torch_families_step import check_teacher_forced

torch.set_num_threads(2)


def _frame(height, width, seed):
    seq = make_sequence(np.random.default_rng(seed), n_frames=1, width=width,
                        height=height, motion="arc")
    return np.asarray(seq.left[0], np.float32)


@pytest.fixture(scope="module")
def frame():
    return _frame(240, 320, 21)


@pytest.fixture(scope="module")
def frame753():
    return _frame(753, 96, 21)


@pytest.fixture(scope="module")
def keypoints():
    rng = np.random.default_rng(4)
    xy = rng.uniform([8.0, 8.0], [312.0, 232.0], (256, 2)).astype(np.float32)
    return xy, rng.random(256) > 0.1


def _unpacked(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1)


def _score(name, img):
    if name == "harris":
        return (np.asarray(jharris.harris_score_multiscale(jnp.asarray(img), threshold=1e-7)),
                harris.harris_score_multiscale(torch.from_numpy(img), threshold=1e-7).numpy())
    return (np.asarray(jdog.dog_score(jnp.asarray(img), threshold=0.008)),
            dog.dog_score(torch.from_numpy(img), threshold=0.008).numpy())


@pytest.mark.parametrize("name,image", [("harris", "frame"), ("dog", "frame"),
                                        ("dog", "frame753")])
def test_score_planes_and_grid_selection(name, image, request):
    img = request.getfixturevalue(image)
    ref, mine = _score(name, img)
    assert mine.shape == ref.shape == img.shape
    assert np.abs(mine - ref).max() <= 1e-5 * np.abs(ref).max()
    assert ((mine > 0) == (ref > 0)).mean() >= 0.999
    assert (ref > 0).sum() > 50
    rows = img.shape[0] // 16 * 16    # the reference's grid takes whole cells only
    ref, mine = ref[:rows], mine[:rows]
    ex = np.zeros((64, 2), np.float32)
    ex[:8] = [[40.0 + 32 * i, 48.0] for i in range(8)]
    ev = np.arange(64) < 8
    jxy, _, jv = jfast.select_grid_keypoints(jnp.asarray(ref), jnp.asarray(ex), jnp.asarray(ev),
                                             max_keypoints=256, subpixel=True)
    pxy, _, pv = fast.select_grid_keypoints(torch.from_numpy(mine), torch.from_numpy(ex),
                                            torch.from_numpy(ev), max_keypoints=256,
                                            subpixel=True)
    jxy, jv = np.asarray(jxy), np.asarray(jv)
    same = (np.abs(pxy.numpy() - jxy) <= 1e-3).all(-1) & (pv.numpy() == jv)
    assert same.mean() >= 0.99 and jv.sum() > 20


def test_sift_descriptors(frame, keypoints):
    xy, valid = keypoints
    ref = np.asarray(jsift.sift_descriptors(jnp.asarray(frame), jnp.asarray(xy),
                                            jnp.asarray(valid)))
    mine = sift.sift_descriptors(torch.from_numpy(frame), torch.from_numpy(xy),
                                 torch.from_numpy(valid)).numpy()
    assert mine.shape == (256, 128) and mine.dtype == np.float32
    np.testing.assert_allclose(mine, ref, atol=1e-4)
    assert (mine[~valid] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(mine[valid], axis=-1), 1.0, atol=1e-5)


def test_freak_descriptors(frame, keypoints):
    xy, valid = keypoints
    ref, ref_th = jfreak.freak_descriptors(jnp.asarray(frame), jnp.asarray(xy),
                                           jnp.asarray(valid))
    mine, th = freak.freak_descriptors(torch.from_numpy(frame), torch.from_numpy(xy),
                                       torch.from_numpy(valid))
    assert mine.shape == (256, 8) and mine.dtype == torch.int32
    ham = (_unpacked(np.asarray(ref)) != _unpacked(mine.numpy().view(np.uint32))).sum(-1)
    assert (ham == 0).mean() >= 0.99 and ham.mean() <= 1.0
    assert (mine.numpy()[~valid] == 0).all()
    np.testing.assert_allclose(th.numpy(), np.asarray(ref_th), atol=1e-5)


@pytest.fixture(scope="module")
def float_desc(frame, keypoints):
    xy, valid = keypoints
    return np.array(jsift.sift_descriptors(jnp.asarray(frame), jnp.asarray(xy),
                                           jnp.asarray(valid))), valid


@pytest.mark.parametrize("gated", [False, True])
def test_l2_matrix_and_float_matches(float_desc, gated):
    d, valid = float_desc
    rng = np.random.default_rng(8)
    a = d[:128]
    b = a[rng.permutation(128)] + rng.normal(0, 0.02, (128, 128)).astype(np.float32)
    D_ref = np.asarray(jmatch.l2_matrix(jnp.asarray(a), jnp.asarray(b)))
    D = match.l2_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (np.abs(D - D_ref) <= 1e-4 * np.maximum(np.abs(D_ref), 1e-2)).all()
    gate = rng.random((128, 128)) > 0.3 if gated else None
    va, vb = valid[:128], valid[128:]
    ref = jmatch.match_descriptors_float(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                                         jnp.asarray(vb), max_distance=0.55,
                                         gate_mask=None if gate is None else jnp.asarray(gate))
    mine = match.match_descriptors_float(torch.from_numpy(a), torch.from_numpy(b),
                                         torch.from_numpy(va), torch.from_numpy(vb),
                                         max_distance=0.55,
                                         gate_mask=None if gate is None else torch.from_numpy(gate))
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(mine[2].numpy(), np.asarray(ref[2]))
    assert int(mine[2].sum()) > 20
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-6)


def test_lsh_planes_and_codes(float_desc):
    np.testing.assert_array_equal(match._lsh_planes(), jmatch._lsh_planes())
    d, _ = float_desc
    ref = np.asarray(jmatch.lsh_binarize(jnp.asarray(d)))
    mine = match.lsh_binarize(torch.from_numpy(d))
    assert mine.shape == (256, 8) and mine.dtype == torch.int32
    assert (_unpacked(ref) == _unpacked(mine.numpy().view(np.uint32))).mean() >= 0.999


def test_teacher_forced_describe_refresh():
    check_teacher_forced(dict(describe_refresh=4))
