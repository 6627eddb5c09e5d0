"""The SIFT family through the port's keyframe system against the JAX
reference on the CPU. The float descriptors cross into the binary back end
(keyframe DB, vocabulary, loop and reloc matching) as LSH sign codes.

One reference ``run_system`` with ``descriptor="sift"`` on a 14-frame
240x320 strafe (the configs of ``tests/test_torch_system.py``: loop gates
loose enough to fire, a vocabulary retrained at the 4th keyframe) is
captured around its 4th keyframe's back end:

- that back end teacher-forced on the converted system with the reference's
  draws: the LSH codes stored in ``kf_db.kp_desc`` identical on >= 99.9% of
  bits, keyframe poses and the live pose within 1e-4, the same loop verdict
  (a pose graph runs in both), the float archive and the spill's packed
  descriptor bits identical;
- the reloc query of the captured system, the snapshot's descriptors
  crossing as LSH codes: scores within 1e-6, slots and inlier counts equal;
- a SIFT state and system through ``convert`` and both checkpoint formats:
  float (N, 128) tables, the float archive and the codes bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenslam_tpu.pipeline.system as jsystem
from zenslam_tpu.io.synthetic import make_sequence
from zenslam_tpu.ops.match import lsh_binarize as jax_lsh_binarize
from zenslam_tpu.pipeline.state import SlamConfig as JaxConfig
from zenslam_tpu_torch import convert
from zenslam_tpu_torch.io import checkpoint
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.state import init_state
from test_torch_backend import reference_draw
from test_torch_lines_system import _same
from test_torch_system import BCFG, _copy, _loop_noise, _numpy_system

torch.set_num_threads(2)
H, W = 240, 320
CFG = dict(max_keypoints=256, max_landmarks=2048, pnp_iters=128, rigid_iters=128,
           kf_min_frames=2, kf_min_translation=0.04, descriptor="sift")
CAPTURE_KF = 4


@pytest.fixture(scope="module")
def seq():
    return make_sequence(np.random.default_rng(11), n_frames=14, motion="strafe", speed=0.6,
                         width=W, height=H)


@pytest.fixture(scope="module")
def reference(seq):
    """The reference's SIFT system just before and after its CAPTURE_KF-th
    keyframe's back end, and the keyframe's snapshot."""
    cap = {}
    original = jsystem._keyframe_backend

    def spy(sys_, snap, frame_idx, info):
        capture = sys_.n_keyframes == CAPTURE_KF - 1
        if capture:
            cap["before"] = _numpy_system(sys_)
            cap["snap"], cap["frame"] = _copy(snap), frame_idx
        original(sys_, snap, frame_idx, info)
        if capture:
            cap["after"] = _numpy_system(sys_)

    js = jsystem.create_system(JaxConfig(**CFG), jsystem.BackendConfig(**BCFG), seq.rig, (H, W))
    jsystem._keyframe_backend = spy
    try:
        jsystem.run_system(js, seq.left, seq.right)
    finally:
        jsystem._keyframe_backend = original
    return cap


def _bits(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1)


def test_sift_keyframe_backend_teacher_forced(reference):
    before, after, frame = reference["before"], reference["after"], reference["frame"]
    assert before.vocab is not None and before._pending_loop is not None
    ps = convert.system_from_numpy(before, "cpu", image_shape=(H, W))
    assert ps.state.features.desc.dtype == torch.float32 and ps.archive.desc.dtype == np.float32
    snap = convert.table_from_numpy(psystem.KfSnap, reference["snap"], "cpu")
    k = min(ps.bcfg.bow_top_k, ps.bcfg.max_keyframes)
    draws = psystem.BackendDraws(vocab=reference_draw(jax.random.PRNGKey(13)),
                                 loop_noise=_loop_noise(frame, k, CFG["max_keypoints"]))
    info = {}
    psystem._keyframe_backend(ps, snap, frame, info, draws=draws)
    out = convert.system_to_numpy(ps)
    fired = after.n_loop_closures == before.n_loop_closures + 1
    assert info["loop"] is fired and fired
    assert out.n_loop_closures == after.n_loop_closures
    db, jdb = out.kf_db, after.kf_db
    assert db.kp_desc.dtype == np.uint32
    assert (_bits(db.kp_desc) == _bits(jdb.kp_desc)).mean() >= 0.999
    np.testing.assert_array_equal(db.valid, jdb.valid)
    np.testing.assert_allclose(db.R, jdb.R, atol=1e-4)
    np.testing.assert_allclose(db.t, jdb.t, atol=1e-4)
    np.testing.assert_allclose(out.state.R_cw, after.state.R_cw, atol=1e-4)
    np.testing.assert_allclose(out.state.t_cw, after.state.t_cw, atol=1e-4)
    assert ps.archive.desc.dtype == np.float32 and ps.archive.desc.shape[1:] == (128,)
    np.testing.assert_array_equal(ps.archive.desc, after.archive.desc)
    # the spill packs the float descriptors' bit patterns after the metadata
    spill, jspill = ps._pending_spill.numpy(), after._pending_spill
    assert spill.shape == jspill.shape == (CFG["max_landmarks"], 6 + 128)
    np.testing.assert_array_equal(spill[:, 6:].view(np.uint32), jspill[:, 6:])


def test_sift_reloc_query_crosses_as_lsh_codes(reference):
    after = reference["after"]
    ps = convert.system_from_numpy(after, "cpu", image_shape=(H, W))
    jsnap = jsystem._kf_snapshot(jax.tree.map(jnp.asarray, after.state))
    snap = psystem._kf_snapshot(ps.state)
    k = min(ps.bcfg.bow_top_k, ps.bcfg.max_keyframes)
    key = jax.random.PRNGKey(after.n_frames)
    jp = np.asarray(jsystem._reloc_query_jit(
        jax.tree.map(jnp.asarray, after.vocab), jax.tree.map(jnp.asarray, after.bow_db),
        jax.tree.map(jnp.asarray, after.kf_db), jax_lsh_binarize(jsnap.desc), jsnap.valid,
        jsnap.xy, jnp.asarray(after.rig.left.K),
        jnp.asarray(ps.bcfg.loop_pnp_threshold, jnp.float32), key,
        top_k=ps.bcfg.bow_top_k, pnp_iters=128))
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, c), (128, CFG["max_keypoints"]))) for c in range(k)]))
    p = psystem._reloc_query(ps.vocab, ps.bow_db, ps.kf_db,
                             psystem._binary_codes(ps.cfg, snap.desc), snap.valid, snap.xy,
                             ps.rig.left.K, ps.bcfg.loop_pnp_threshold, noise,
                             top_k=ps.bcfg.bow_top_k).numpy()
    np.testing.assert_allclose(p[:k], jp[:k], atol=1e-6)
    np.testing.assert_array_equal(p[k:3 * k], jp[k:3 * k])
    assert (jp[2 * k:3 * k] >= 12).any()


def test_sift_state_and_system_convert_and_checkpoint(reference, tmp_path):
    after = reference["after"]
    ps = convert.system_from_numpy(after, "cpu", image_shape=(H, W))
    state = ps.state
    assert state.features.desc.shape == (CFG["max_keypoints"], 128)
    back = convert.state_to_numpy(state)
    assert back.features.desc.dtype == np.float32 and back.lmap.desc.dtype == np.float32
    np.testing.assert_array_equal(back.features.desc, after.state.features.desc)
    np.testing.assert_array_equal(back.lmap.desc, after.state.lmap.desc)
    _same(convert.state_from_numpy(back, "cpu"), state)
    out = convert.system_to_numpy(ps)
    np.testing.assert_array_equal(out.kf_db.kp_desc, after.kf_db.kp_desc)
    np.testing.assert_array_equal(out.archive.desc, after.archive.desc)

    path = tmp_path / "state.npz"
    checkpoint.save_pytree(str(path), state)
    template = init_state(ps.cfg, (H, W), device="cpu")
    _same(checkpoint.load_pytree(str(path), template), state)

    path = tmp_path / "system.npz"
    checkpoint.save_system(str(path), ps)
    s2 = checkpoint.load_system(str(path), ps.cfg, ps.bcfg, ps.rig, (H, W), device="cpu")
    _same(s2.state, ps.state)
    _same(s2.kf_db, ps.kf_db)
    assert s2.archive.desc.dtype == np.float32
    np.testing.assert_array_equal(s2.archive.desc, ps.archive.desc)
    np.testing.assert_array_equal(s2.archive.xyz, ps.archive.xyz)
