"""The back end's public solvers as captured programs (``utils/graphs.py``)
on the CPU, where a ``Program`` runs its function on its static buffers
with the buffer logic that replays CUDA graphs on a card (``chip_smoke.py``
``[solvers]`` holds the same on the card). No JAX: each program is held to
its own ``graphs.eager()`` form. Small problems (a K=4 BA, a 5-node pose
graph, 48 descriptors).

- every public entry point that the reference jits, called directly: two
  calls with other inputs and other Python ints through one capture, each
  bit-identical to its eager call; the first call's result, kept, unchanged
  by the second; the caller's inputs untouched; the traced ints
  (``frame_idx``, ``query_frame_idx``, ``min_frame_gap``,
  ``protect_recent``) capture nothing new when they change;
- jit's nesting rule: the trim's two halves, and the solvers inside the
  system's windowed BA (dense, CG, sharded) and pose graph, capture
  nothing of their own, while the outer programs' calls equal the BA runs
  and pose graphs made;
- the builders' default ``draw`` (a ``GeneratorDraw(0)`` made on the
  inputs' device) draws as the eager default does, call after call.

The 2-rank gloo run through the captured form is in
``tests/test_torch_multihost.py``.
"""

import pytest
import torch

from zenslam_tpu_torch.backend import ba, bow, keyframes, map_archive, pose_graph
from zenslam_tpu_torch.eval.scaling import make_problem
from zenslam_tpu_torch.geometry.lie import so3_exp
from zenslam_tpu_torch.parallel import dist_ba
from zenslam_tpu_torch.pipeline import system as psystem
from zenslam_tpu_torch.pipeline.state import SlamConfig, init_state
from zenslam_tpu_torch.utils import graphs
from zenslam_tpu_torch.utils.graphs import Program, eager, flatten

torch.set_num_threads(2)

N_KP, M_LM, K_KF = 48, 64, 4


def _leaves(tree) -> list:
    out = []
    flatten(tree, out)
    return out


def _identical(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return (flatten(a, []) == flatten(b, []) and len(la) == len(lb)
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)))


def _copy(tree):
    leaves = _leaves(tree)
    return graphs.unflatten(flatten(tree, []), iter([t.clone() for t in leaves]))


def _ba_problem(seed: int):
    return make_problem(K=K_KF, M=M_LM, obs_per_lm=3, seed=seed, device="cpu")


def _mesh():
    return psystem._live_ba_mesh(2, torch.device("cpu"))


def _graph(seed: int) -> pose_graph.PoseGraph:
    g = torch.Generator().manual_seed(seed)
    n, ei, ej = 5, [1, 2, 3, 4, 4, 3], [0, 1, 2, 3, 0, 0]
    R = so3_exp(torch.randn(n, 3, generator=g) * 0.05)
    t = torch.randn(n, 3, generator=g) * 0.3
    E = len(ei)
    return pose_graph.PoseGraph(
        R=R, t=t, node_valid=torch.ones(n, dtype=torch.bool), node_fixed=torch.arange(n) == 0,
        edge_i=torch.tensor(ei, dtype=torch.int32), edge_j=torch.tensor(ej, dtype=torch.int32),
        edge_R=so3_exp(torch.randn(E, 3, generator=g) * 0.05),
        edge_t=torch.randn(E, 3, generator=g) * 0.3, edge_valid=torch.ones(E, dtype=torch.bool),
        edge_weight=torch.tensor([1.0] * (E - 1) + [5.0]))


def _desc(g, n: int = N_KP):
    centres = torch.randint(-2 ** 31, 2 ** 31 - 1, (6, 8), generator=g, dtype=torch.int32)
    flips = torch.randint(0, 32, (n, 8), generator=g, dtype=torch.int32)
    return centres[torch.randint(0, 6, (n,), generator=g)] ^ (1 << flips)


def _vocab(seed: int):
    g = torch.Generator().manual_seed(seed)
    with eager():
        return bow.build_vocabulary_tree(_desc(g), torch.ones(N_KP, dtype=torch.bool),
                                         branch=4, iters=2, draw=bow.GeneratorDraw(seed, "cpu"))


def _bow_db(seed: int):
    g = torch.Generator().manual_seed(seed)
    db = bow.bow_db_init(6, 16, device="cpu")
    with eager():
        for f in range(4):
            h = torch.rand(16, generator=g) * (torch.rand(16, generator=g) > 0.5)
            db = bow.bow_db_add(db, h / h.norm().clamp(min=1e-9), 10 * f + seed)
    return db


def _kf_db(seed: int):
    g = torch.Generator().manual_seed(seed)
    db = keyframes.kf_db_init(K_KF, N_KP, device="cpu")
    with eager():
        for f in range(2):
            db = keyframes.kf_db_add(db, *_kf_row(g), 5 * f)
    return db


def _kf_row(g) -> tuple:
    lm = torch.randint(-1, M_LM, (N_KP,), generator=g, dtype=torch.int32)
    return (so3_exp(torch.randn(3, generator=g) * 0.05), torch.randn(3, generator=g),
            torch.rand(N_KP, 2, generator=g) * 100, lm, lm >= 0, _desc(g))


def _lmap(seed: int):
    g = torch.Generator().manual_seed(seed)
    lmap = init_state(SlamConfig(max_keypoints=N_KP, max_landmarks=M_LM), (96, 128),
                      device="cpu").lmap
    return lmap._replace(xyz=torch.randn(M_LM, 3, generator=g),
                         valid=torch.rand(M_LM, generator=g) > 0.3, desc=_desc(g, M_LM),
                         last_seen=torch.randint(0, 20, (M_LM,), generator=g, dtype=torch.int32),
                         color=torch.rand(M_LM, generator=g))


def _reload_args(seed: int, frame: int):
    g = torch.Generator().manual_seed(seed + 100)
    return (_lmap(seed), torch.randn(16, 3, generator=g), _desc(g, 16),
            torch.rand(16, generator=g) > 0.2, frame)


def _sharded(seed: int):
    return dist_ba.shard_ba_problem(_ba_problem(seed), 2)


# entry point -> (program, inputs of call a, of call b (same shapes, other
# values and ints), keyword arguments); a lambda's seed picks the values
CASES = {
    "bundle_adjust": (ba.bundle_adjust, lambda s: (_ba_problem(s),), dict(iterations=3)),
    "bundle_adjust_trim": (ba.bundle_adjust, lambda s: (_ba_problem(s),),
                           dict(iterations=4, trim_threshold=1.0)),
    "bundle_adjust_motion_only": (ba.bundle_adjust, lambda s: (_ba_problem(s),),
                                  dict(iterations=3, refine_landmarks=False)),
    "bundle_adjust_cg": (ba.bundle_adjust_cg, lambda s: (_ba_problem(s),),
                         dict(iterations=2, cg_iters=6)),
    "dist_bundle_adjust": (dist_ba.dist_bundle_adjust, lambda s: (_sharded(s), _mesh()),
                           dict(iterations=3)),
    "shard_ba_problem_device": (dist_ba.shard_ba_problem_device,
                                lambda s: (_ba_problem(s), 2, 80), {}),
    "optimize_pose_graph": (pose_graph.optimize_pose_graph, lambda s: (_graph(s),),
                            dict(iterations=4)),
    "build_vocabulary": (bow.build_vocabulary, lambda s: (
        _desc(torch.Generator().manual_seed(s)), torch.arange(N_KP) % 7 != s % 7),
        dict(n_words=8, iters=2, draw=bow.GeneratorDraw(3, "cpu"))),
    "build_vocabulary_tree": (bow.build_vocabulary_tree, lambda s: (
        _desc(torch.Generator().manual_seed(s)), torch.arange(N_KP) % 5 != s % 5),
        dict(branch=4, iters=2, draw=bow.GeneratorDraw(3, "cpu"))),
    "descriptors_to_bow": (bow.descriptors_to_bow, lambda s: (
        _vocab(s), _desc(torch.Generator().manual_seed(s + 50)),
        torch.arange(N_KP) % 3 != s % 3), {}),
    "bow_db_add": (bow.bow_db_add, lambda s: (
        _bow_db(s), torch.rand(16, generator=torch.Generator().manual_seed(s)), 40 + 7 * s), {}),
    "bow_db_query": (bow.bow_db_query, lambda s: (
        _bow_db(s), torch.rand(16, generator=torch.Generator().manual_seed(s)), 35 + 4 * s,
        5 + 3 * s), dict(top_k=3)),
    "kf_db_add": (keyframes.kf_db_add, lambda s: (
        _kf_db(s), *_kf_row(torch.Generator().manual_seed(s)), 20 + 3 * s), {}),
    "kf_db_update_poses": (keyframes.kf_db_update_poses, lambda s: (
        _kf_db(s), so3_exp(torch.randn(K_KF, 3, generator=torch.Generator().manual_seed(s))),
        torch.randn(K_KF, 3)), {}),
    "reload_into_map": (map_archive.reload_into_map, lambda s: _reload_args(s, 18 + s), {}),
    "_pack_live": (map_archive._pack_live, lambda s: (_lmap(s),), {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_is_a_program_held_to_eager(name):
    prog, make, kw = CASES[name]
    assert isinstance(prog, Program) and prog.copy_outputs
    a, b = make(1), make(2)
    a_in, b_in = _copy(a), _copy(b)
    held = graphs.graphs_held()
    got_a = prog(*a, **kw)
    kept = _copy(got_a)
    assert graphs.graphs_held() - held <= 1
    held = graphs.graphs_held()
    got_b = prog(*b, **kw)
    assert graphs.graphs_held() == held           # other values and ints: the same capture
    assert _identical(got_a, kept)                # the caller's result, untouched
    with eager():
        want_a, want_b = prog(*a, **kw), prog(*b, **kw)
    assert _identical(got_a, want_a) and _identical(got_b, want_b)
    assert not _identical(got_a, got_b)
    assert _identical(a, a_in) and _identical(b, b_in)    # the inputs, never written


def test_traced_ints_reach_each_call():
    db = _bow_db(1)
    h = torch.rand(16, generator=torch.Generator().manual_seed(3))
    outs = [bow.bow_db_add(db, h, f) for f in (7, 8, 1 << 20)]
    assert [int(o.frame_idx[int(db.next_slot)]) for o in outs] == [7, 8, 1 << 20]
    held = graphs.graphs_held()
    for q, gap in ((31, 0), (31, 25), (12, 3)):
        got = bow.bow_db_query(db, h, q, min_frame_gap=gap, top_k=4)
        with eager():
            assert _identical(got, bow.bow_db_query(db, h, q, min_frame_gap=gap, top_k=4))
    assert graphs.graphs_held() - held <= 1


def _fresh_program(p: Program) -> Program:
    return Program(p.fn, p.static_argnames, p.donate_argnames, p.scalar_argnames,
                   p.static_defaults, p.copy_outputs)


def test_trim_halves_run_inline(monkeypatch):
    own = _fresh_program(ba.bundle_adjust)
    monkeypatch.setattr(ba, "bundle_adjust", own)       # what the trim calls for its halves
    p = _ba_problem(4)
    got = own(p, iterations=4, trim_threshold=1.0)
    assert len(own.captured) == 1 and graphs.calls(own) == 1
    assert graphs.calls(own, trim_threshold=1.0) == 1
    with eager():
        assert _identical(got, own(p, iterations=4, trim_threshold=1.0))
    assert len(own.captured) == 1


def _window_inputs():
    g = torch.Generator().manual_seed(12)
    db = keyframes.kf_db_init(6, N_KP, device="cpu")
    X = torch.randn(M_LM, 3, generator=g) * torch.tensor([1.0, 0.7, 0.5]) + torch.tensor(
        [0.0, 0.0, 4.0])
    rig = _rig()
    with eager():
        for k in range(6):
            R = so3_exp(torch.tensor([0.0, 0.02 * k, 0.0]))
            t = torch.tensor([-0.1 * k, 0.0, 0.0])
            lm = torch.randperm(M_LM, generator=g)[:N_KP].to(torch.int32)
            lm[40:] = -1
            xc = X[lm.long()] @ R.T + t
            uv = torch.stack([rig.left.fx * xc[:, 0] / xc[:, 2] + rig.left.cx,
                              rig.left.fy * xc[:, 1] / xc[:, 2] + rig.left.cy], -1)
            db = keyframes.kf_db_add(db, R, t + torch.randn(3, generator=g) * 0.01,
                                     uv + torch.randn(N_KP, 2, generator=g) * 0.5, lm, lm >= 0,
                                     torch.zeros(N_KP, 8, dtype=torch.int32), 10 * k,
                                     kp_xyz=X[lm.long()])
    return (db, X + torch.randn(M_LM, 3, generator=g) * 0.02, torch.ones(M_LM, dtype=torch.bool),
            torch.zeros(M_LM, dtype=torch.int32), db.R[5], db.t[5], rig)


def _rig():
    from zenslam_tpu_torch.io.synthetic import default_rig

    return default_rig(128, 96, device="cpu")


def test_system_programs_inline_the_solvers(monkeypatch):
    nested = {name: _fresh_program(getattr(psystem, name))
              for name in ("bundle_adjust", "bundle_adjust_cg", "dist_bundle_adjust",
                           "shard_ba_problem_device", "optimize_pose_graph")}
    for name, prog in nested.items():
        monkeypatch.setattr(psystem, name, prog)
    for name in ("_WINDOWED_BA", "_POSE_GRAPH"):
        monkeypatch.setattr(psystem, name, _fresh_program(getattr(psystem, name)))
    args = _window_inputs()
    runs = [dict(solver="dense"), dict(solver="cg"), dict(solver="dist", mesh=_mesh()),
            dict(solver="dense")]
    for kw in runs:
        got = psystem._windowed_ba(*args, W=4, iterations=2, **kw)
        with eager():
            assert _identical(got, psystem._windowed_ba(*args, W=4, iterations=2, **kw))
    assert graphs.calls(psystem._WINDOWED_BA) == len(runs)
    assert len(psystem._WINDOWED_BA.captured) == 3

    g = torch.Generator().manual_seed(8)
    bcfg = psystem.BackendConfig(max_keyframes=6, max_edges=8, pose_graph_iterations=3,
                                 enable_loop_closure=False, enable_map_spill=False)
    s = psystem.create_system(SlamConfig(max_keypoints=N_KP, max_landmarks=M_LM), bcfg, _rig(),
                              (96, 128), device="cpu")
    s.kf_db, s.last_kf_slot = args[0], 5
    n_graphs = 0
    for i, j in ((5, 0), (4, 1), (5, 2)):
        psystem._append_edge(s, i, j, so3_exp(torch.randn(3, generator=g) * 0.02),
                             torch.randn(3, generator=g) * 0.05, 5.0)
        psystem._run_pose_graph(s)
        n_graphs += 1
    assert graphs.calls(psystem._POSE_GRAPH) == n_graphs
    assert all(not prog.captured for prog in nested.values())   # inline: nothing of their own


def test_default_draw_is_the_eager_default():
    g = torch.Generator().manual_seed(21)
    desc, valid = _desc(g), torch.ones(N_KP, dtype=torch.bool)
    got = [bow.build_vocabulary_tree(desc, valid, branch=4, iters=2) for _ in range(2)]
    with eager():
        want = bow.build_vocabulary_tree(desc, valid, branch=4, iters=2)
        seeded = bow.build_vocabulary_tree(desc, valid, branch=4, iters=2,
                                           draw=bow.GeneratorDraw(0, "cpu"))
    assert _identical(got[0], want) and _identical(got[1], want) and _identical(want, seeded)
