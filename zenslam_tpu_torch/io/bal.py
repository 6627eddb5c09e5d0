"""Bundle-Adjustment-in-the-Large (BAL) problem IO + the reference's
subset-BA fixture harness — counterpart of ``zenslam_tpu/io/bal.py``.

The reference validates its Ceres back-end against BAL text problems
(`zenslam_tests/source/zenslam_tests.cpp:65-285`): it loads the standard BAL
text format (`load_bal_problem`, `zenslam_tests.cpp:65-107`), subselects a
small dense core of the co-observation graph, and — rather than fighting the
BAL camera convention — keeps only the *graph structure* and the point cloud:
GT poses are synthetic, observations are re-synthesized by projecting GT
landmarks through a fixed pinhole K, poses are perturbed, and motion-only BA
must shrink both RMSE and translation error (`run_bal_subset_lba_case`,
`zenslam_tests.cpp:109-285`).

This module reproduces that harness for the port's Schur BA
(`zenslam_tpu_torch.backend.ba.bundle_adjust`), fixed-capacity/masked
instead of map-of-structs. Parsing, writing and the synthetic fixture are
numpy and give the reference's files and arrays.

BAL text format (https://grail.cs.washington.edu/projects/bal/):

    n_cameras n_points n_observations
    cam_idx point_idx u v              (x n_observations)
    9 camera params, one per line      (x n_cameras: rodrigues(3) t(3) f k1 k2)
    3 point coords, one per line       (x n_points)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BalData:
    """Raw BAL problem arrays (numpy, host-side)."""

    cameras: np.ndarray   # (N, 9) float64: rodrigues(3), t(3), f, k1, k2
    points: np.ndarray    # (M, 3) float64
    obs_cam: np.ndarray   # (O,) int64
    obs_pt: np.ndarray    # (O,) int64
    obs_uv: np.ndarray    # (O, 2) float64

    @property
    def num_cameras(self) -> int:
        return len(self.cameras)

    @property
    def num_points(self) -> int:
        return len(self.points)

    @property
    def num_observations(self) -> int:
        return len(self.obs_cam)


def load_bal(path) -> BalData:
    """Parse a BAL text problem (≡ `load_bal_problem`,
    `zenslam_tests.cpp:65-107`). Whitespace-tolerant single-pass read."""
    with open(path) as f:
        tokens = f.read().split()
    if len(tokens) < 3:
        raise ValueError(f"invalid BAL header in {path}")
    n_cam, n_pt, n_obs = (int(t) for t in tokens[:3])
    need = 3 + 4 * n_obs + 9 * n_cam + 3 * n_pt
    if len(tokens) < need:
        raise ValueError(
            f"invalid BAL payload in {path}: need {need} tokens, have {len(tokens)}")
    obs = np.asarray(tokens[3 : 3 + 4 * n_obs], dtype=np.float64).reshape(n_obs, 4)
    off = 3 + 4 * n_obs
    cams = np.asarray(tokens[off : off + 9 * n_cam], np.float64).reshape(n_cam, 9)
    off += 9 * n_cam
    pts = np.asarray(tokens[off : off + 3 * n_pt], np.float64).reshape(n_pt, 3)
    return BalData(
        cameras=cams, points=pts,
        obs_cam=obs[:, 0].astype(np.int64), obs_pt=obs[:, 1].astype(np.int64),
        obs_uv=obs[:, 2:4].copy(),
    )


def save_bal(path, data: BalData) -> None:
    """Write a BalData back to BAL text (round-trip of `load_bal`)."""
    with open(path, "w") as f:
        f.write(f"{data.num_cameras} {data.num_points} {data.num_observations}\n")
        for c, p, (u, v) in zip(data.obs_cam, data.obs_pt, data.obs_uv):
            f.write(f"{c} {p} {u:.6e} {v:.6e}\n")
        for cam in data.cameras:
            for x in cam:
                f.write(f"{x:.16e}\n")
        for pt in data.points:
            for x in pt:
                f.write(f"{x:.16e}\n")


def bal_subset_ba_problem(
    bal: BalData,
    max_cameras: int = 8,
    max_points: int = 600,
    max_observations: int = 3000,
    min_camera_obs: int = 150,
    min_point_obs: int = 3,
    pose_sigma: float = 0.02,
    seed: int = 97531,
    device=None,
):
    """Build a masked `BAProblem` from a BAL co-observation subgraph, the way
    the reference's fixture does (`run_bal_subset_lba_case`,
    `zenslam_tests.cpp:109-285`):

    - keep observations with camera_id < max_cameras and point_id < max_points,
      up to max_observations (`:118-133`)
    - drop cameras with < min_camera_obs and points with < min_point_obs
      observations (`:135-159`)
    - synthetic GT poses: identity rotation, t_i = (0.10 i, 0.01 i, 0)
      (`:188-191`); landmark GT = BAL point scaled 0.02 and pushed in front of
      the cameras, z = 4 + |z|*0.02 (`:209-214`)
    - observations re-synthesized by pinhole projection of GT (`:226-241`,
      K = [500, 500, 320, 240] `:173-178`)
    - init poses = GT + N(0, pose_sigma) on translation (`:183-203`)
    - first two surviving cameras gauge-fixed (`:250-251`)

    Returns (problem on ``device``, default CUDA, raising when absent; info)
    where info carries GT arrays and the expected residual count for the
    fixture asserts.
    """
    import torch

    from zenslam_tpu_torch.backend.ba import make_ba_problem

    sel = (bal.obs_cam < max_cameras) & (bal.obs_pt < max_points)
    idx = np.nonzero(sel)[0][:max_observations]
    oc, op = bal.obs_cam[idx], bal.obs_pt[idx]

    cam_counts = np.bincount(oc, minlength=max_cameras)
    pt_counts = np.bincount(op, minlength=max_points)
    keep = (cam_counts[oc] >= min_camera_obs) & (pt_counts[op] >= min_point_obs)
    oc, op = oc[keep], op[keep]

    if len(oc) == 0:
        raise ValueError(
            "BAL subset is empty after the min-observation filters "
            f"(min_camera_obs={min_camera_obs}, min_point_obs={min_point_obs})")
    used_cams = np.unique(oc)          # sorted, ≡ std::set iteration order
    used_pts = np.unique(op)
    cam_slot = {int(c): i for i, c in enumerate(used_cams)}
    pt_slot = {int(p): i for i, p in enumerate(used_pts)}

    K = len(used_cams)
    M = len(used_pts)
    O = len(oc)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0

    t_gt = np.stack([
        [0.10 * float(c), 0.01 * float(c), 0.0] for c in used_cams
    ]).astype(np.float32)
    xyz_gt = np.stack([
        [bal.points[p, 0] * 0.02, bal.points[p, 1] * 0.02,
         4.0 + abs(bal.points[p, 2]) * 0.02] for p in used_pts
    ]).astype(np.float32)

    obs_kf = np.asarray([cam_slot[int(c)] for c in oc], np.int32)
    obs_lm = np.asarray([pt_slot[int(p)] for p in op], np.int32)
    xc = xyz_gt[obs_lm] + t_gt[obs_kf]       # R = I
    obs_uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                       fy * xc[:, 1] / xc[:, 2] + cy], -1).astype(np.float32)

    rng = np.random.default_rng(seed)
    t_init = t_gt + rng.normal(0.0, pose_sigma, t_gt.shape).astype(np.float32)

    kf_fixed = np.zeros(K, bool)
    kf_fixed[:2] = True                      # first two used cameras (`:250-251`)
    t_init[kf_fixed] = t_gt[kf_fixed]

    p = make_ba_problem(K, M, O, fx, fy, cx, cy, device=device)
    dev = p.R.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    p = p._replace(
        t=t(t_init),
        kf_valid=torch.ones(K, dtype=torch.bool, device=dev),
        kf_fixed=t(kf_fixed),
        xyz=t(xyz_gt),
        lm_valid=torch.ones(M, dtype=torch.bool, device=dev),
        obs_kf=t(obs_kf),
        obs_lm=t(obs_lm),
        obs_uv=t(obs_uv),
        obs_valid=torch.ones(O, dtype=torch.bool, device=dev),
    )
    info = {
        "t_gt": t_gt, "xyz_gt": xyz_gt, "kf_fixed": kf_fixed,
        "expected_residuals": O,
        "used_cameras": used_cams, "used_points": used_pts,
    }
    return p, info


def make_synthetic_bal(
    n_cameras: int = 6,
    n_points: int = 400,
    seed: int = 7,
    drop_fraction: float = 0.05,
) -> BalData:
    """Generate a small BAL-format problem with a dense co-observation graph
    (every camera sees ~all points). A fast, dependency-free fixture used
    alongside the reference's real checked-in BAL problems
    (`zenslam_tests/data/bal/problem-{21-11315,49-7776}-pre.txt` — present in
    its repo; only the Dubrovnik problem was stripped). Camera params and raw
    uv are present for format fidelity but — like the reference's harness —
    only the graph + point cloud are load-bearing."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 40.0, (n_points, 3))
    cams = np.zeros((n_cameras, 9))
    cams[:, 3] = 0.10 * np.arange(n_cameras)   # t_x
    cams[:, 4] = 0.01 * np.arange(n_cameras)   # t_y
    cams[:, 6] = 500.0                          # f
    oc, op, uv = [], [], []
    for c in range(n_cameras):
        visible = rng.random(n_points) >= drop_fraction
        for p in np.nonzero(visible)[0]:
            oc.append(c)
            op.append(int(p))
            uv.append(rng.normal(0.0, 200.0, 2))
    return BalData(
        cameras=cams, points=pts,
        obs_cam=np.asarray(oc), obs_pt=np.asarray(op),
        obs_uv=np.asarray(uv),
    )
