"""The per-frame SLAM step — counterpart of ``zenslam_tpu/pipeline/step.py:
slam_step``.

Stages, in the reference's order: pyramid pair → predict (IMU
preintegration and the inertial prediction when an IMU batch is given) →
temporal KLT → detector top-up (``cfg.detector``: FAST, multi-scale Harris
or DoG scores through one grid selection) → describe (``cfg.descriptor``:
ORB, SIFT or FREAK; with ``describe_refresh > 1`` only new detections and
every ``describe_refresh``-th frame of a track's age are described, the
other valid rows keep their descriptor) → associate → temporal rematch
(Hamming matches, L2 for SIFT) → stereo KLT and triangulation → keylines
(``use_keylines``: endpoint KLT, detection, description, association,
stereo; ``lines_step.py``) → pose cascade (keyline endpoints folded into
the cam0 PnP; fused when ``use_pose_fusion``) → map update → line map
update → keyframe decision → motion update → VIO update (velocity,
gravity) → telemetry.

On the kernel path (``resolve_use_kernels``) the KLT stages (two, four with
keylines) run ``ops/lk_cuda.lk_ragged`` and the ORB describe stage
``ops/orb_cuda`` (with ``describe_refresh > 1``, its ``needs``
compaction); otherwise the f32 gather fallbacks the reference runs off-TPU.
The reference's ``.at[].set(mode="drop")`` scatters become explicit masks:
dropped rows go to a spare row past the end of the table
(``frontend/tables.scatter_drop``).

With tracing on (``utils/tracing.py``) the step stamps the device at the
start of each stage (``step.pyramid`` with CLAHE, ``step.predict`` with the
IMU preintegration, ``step.track``, ``step.detect``, ``step.describe``,
``step.associate``, ``step.rematch``, ``step.stereo``, ``step.keylines``,
``step.estimate``, ``step.map`` with the line map, ``step.keyframe`` with the
motion update, ``step.vio``) inside a ``slam_step`` span, and the captured
step's packing is ``step.pack``: consecutive stamps tile the step.

``slam_step`` is the eager function; ``make_slam_step`` returns it as a
captured program (``SlamStep``, one CUDA graph per configuration and shape,
its state updated in place), as the reference returns its jitted step.
"""

from __future__ import annotations

import torch

from zenslam_tpu_torch.estimation.cascade import (
    CascadeNoise, draw_cascade_noise, estimate_pose_cascade)
from zenslam_tpu_torch.frontend.tables import (
    allocate_landmark_slots, insert_into_free_slots, scatter_drop as _scatter)
from zenslam_tpu_torch.geometry.camera import (
    StereoRig, essential_from_pose, fundamental_from_rig, project)
from zenslam_tpu_torch.geometry.lie import (
    rotation_angle, se3_apply, se3_compose, se3_inverse, so3_exp, so3_log)
from zenslam_tpu_torch.geometry.triangulate import epipolar_residual, triangulate_dlt
from zenslam_tpu_torch.imu.continuous import preintegrate_continuous
from zenslam_tpu_torch.imu.gravity import (
    GravityEstimator, gravity_add_sample, gravity_estimate)
from zenslam_tpu_torch.imu.predictors import inertial_predict_pose, propagate_velocity
from zenslam_tpu_torch.imu.preintegration import ImuNoise, preintegrate
from zenslam_tpu_torch.ops.dog import dog_score
from zenslam_tpu_torch.ops.fast import detect_grid_keypoints, select_grid_keypoints
from zenslam_tpu_torch.ops.freak import freak_descriptors
from zenslam_tpu_torch.ops.harris import harris_score_multiscale
from zenslam_tpu_torch.ops.image import clahe
from zenslam_tpu_torch.ops.lines import keyline_descriptors
from zenslam_tpu_torch.ops.lk import (
    build_ragged_pyramid_pair, lk_forward_backward, ragged_to_stacked)
from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
from zenslam_tpu_torch.ops.match import (
    epipolar_gate, match_descriptors, match_descriptors_float, radius_gate)
from zenslam_tpu_torch.ops.orb import orb_descriptors
from zenslam_tpu_torch.ops.orb_cuda import orb_descriptors_kernel
from zenslam_tpu_torch.ops.sift import sift_descriptors
from zenslam_tpu_torch.pipeline import lines_step as LS
from zenslam_tpu_torch.utils import tracing
from zenslam_tpu_torch.utils.graphs import Program, flatten, fresh, graphs_on, inline_programs
from zenslam_tpu_torch.pipeline.state import (
    FeatureTable, FrameTelemetry, MotionModel, SlamConfig, SlamState, VioState,
    frame_generator, pack_telemetry, pyramid_dtype, resolve_use_kernels)

_I32 = torch.int32


def _mark(n: int, idx, device):
    """(n,) bool with True at ``idx`` (indices equal to n dropped)."""
    return _scatter(torch.zeros(n, dtype=torch.bool, device=device), idx, True)


def _predict_pose(state: SlamState):
    """Constant-acceleration prediction: Δt = vel + ½·acc, ΔR = exp(...)."""
    mm = state.motion
    use_acc = (mm.n_updates >= 2).to(torch.float32)
    t_rel = mm.vel + 0.5 * use_acc * mm.acc
    R_rel = so3_exp(mm.vel_ang + 0.5 * use_acc * mm.acc_ang)
    R_pred, t_pred = se3_compose(R_rel, t_rel, state.R_cw, state.t_cw)
    ok = mm.n_updates >= 1
    return torch.where(ok, R_pred, state.R_cw), torch.where(ok, t_pred, state.t_cw)


def _lk_fb(cfg: SlamConfig, use_kernels: bool, prev_pyr, next_pyr, pts, valid,
           init_pts=None):
    """fwd-bwd KLT: the hand kernel (per-level schedule, shallow backward
    pass, no residual) or the f32 gather fallback."""
    if use_kernels:
        iters = (cfg.klt_iters,) + (cfg.klt_coarse_iters,) * (len(prev_pyr) - 1)
        return lk_ragged(prev_pyr, next_pyr, pts, valid, init_pts=init_pts,
                         radius=cfg.klt_radius, iters=iters,
                         bwd_levels=cfg.klt_bwd_levels, compute_err=False,
                         fb_threshold=cfg.fb_threshold)
    return lk_forward_backward(ragged_to_stacked(prev_pyr), ragged_to_stacked(next_pyr),
                               pts, valid, init_pts=init_pts, radius=cfg.klt_radius,
                               iters=cfg.klt_iters, fb_threshold=cfg.fb_threshold)


def _temporal_track(cfg, use_k, rig, state, pyr_l, R_pred, t_pred):
    """KLT prev-L → cur-L, initial flow from the projected landmark."""
    feats = state.features
    has_lm = (feats.lm_idx >= 0) & feats.valid
    lm_xyz = state.lmap.xyz[feats.lm_idx.clamp(min=0).long()]
    xc = se3_apply(R_pred, t_pred, lm_xyz)
    proj = project(rig.left, xc)
    H, W = pyr_l[0].shape
    proj_ok = (has_lm & (xc[:, 2] > 0.1) & (proj[:, 0] >= 0) & (proj[:, 0] < W)
               & (proj[:, 1] >= 0) & (proj[:, 1] < H))
    init_pts = torch.where(proj_ok[:, None], proj, feats.xy)
    tracked, ok, _ = _lk_fb(cfg, use_k, state.prev_pyr_l, pyr_l, feats.xy, feats.valid,
                            init_pts=init_pts)
    feats = feats._replace(
        xy=torch.where(ok[:, None], tracked, feats.xy),
        valid=ok,
        age=torch.where(ok, feats.age + 1, 0).to(_I32))
    return feats, ok.sum()


def _detect_topup(cfg, img_l, feats: FeatureTable, next_track_id):
    """Grid detection into free slots with fresh track ids; ``cfg.detector``
    picks the dense score ("harris", "dog", anything else FAST)."""
    grid = dict(cell_size=cfg.cell_size, max_keypoints=cfg.max_keypoints,
                border=cfg.detect_border, subpixel=cfg.subpixel_detect)
    if cfg.detector in ("harris", "dog"):
        score = (dog_score(img_l, threshold=cfg.dog_threshold) if cfg.detector == "dog"
                 else harris_score_multiscale(img_l, threshold=cfg.harris_threshold))
        det_xy, det_score, det_valid = select_grid_keypoints(score, feats.xy, feats.valid,
                                                             **grid)
    else:
        det_xy, det_score, det_valid = detect_grid_keypoints(
            img_l, feats.xy, feats.valid, threshold=cfg.fast_threshold, **grid)
    slot, placed = insert_into_free_slots(~feats.valid, det_score, det_valid)
    n = feats.xy.shape[0]
    sl = torch.where(placed, slot, n)
    n_placed = placed.sum()
    rank = torch.cumsum(placed.to(torch.int64), 0) - 1
    new_ids = (next_track_id + rank).to(_I32)
    feats = feats._replace(
        xy=_scatter(feats.xy, sl, det_xy),
        valid=_scatter(feats.valid, sl, placed),
        lm_idx=_scatter(feats.lm_idx, sl, -1),
        track_id=_scatter(feats.track_id, sl, new_ids),
        age=_scatter(feats.age, sl, 0),
        stereo_ok=_scatter(feats.stereo_ok, sl, False))
    return feats, n_placed, (next_track_id + n_placed).to(_I32)


def _compute_descriptors(cfg, use_k, img_l, feats: FeatureTable, needs=None):
    """Descriptors of the configured family ("sift", "freak", anything else
    ORB). ``needs``: optional (N,) bool of the rows the caller keeps; the ORB
    kernel skips the others and leaves them undefined, the other families
    compute every row."""
    if cfg.descriptor == "sift":
        return sift_descriptors(img_l, feats.xy, feats.valid)
    if cfg.descriptor == "freak":
        return freak_descriptors(img_l, feats.xy, feats.valid)[0]
    if use_k and cfg.orb_backend != "xla":
        return orb_descriptors_kernel(img_l, feats.xy, feats.valid, needs=needs)[0]
    return orb_descriptors(img_l, feats.xy, feats.valid)[0]


def _describe(cfg, use_k, img_l, feats: FeatureTable):
    """The describe stage. With ``describe_refresh > 1`` only the valid rows
    whose age is a multiple of it (new detections included) are computed;
    the other valid rows keep their descriptor and invalid rows are zeroed,
    as the every-frame path emits them."""
    if cfg.describe_refresh <= 1:
        return _compute_descriptors(cfg, use_k, img_l, feats)
    needs = feats.valid & (feats.age % cfg.describe_refresh == 0)
    computed = _compute_descriptors(cfg, use_k, img_l, feats, needs=needs)
    kept = torch.where(feats.valid[:, None], feats.desc, torch.zeros_like(feats.desc))
    return torch.where(needs[:, None], computed, kept)


def _match_desc(cfg, da, db, va, vb, gate_mask):
    """Cross-checked matches of the family: L2 for "sift", Hamming else."""
    if cfg.descriptor == "sift":
        return match_descriptors_float(da, db, va, vb, max_distance=cfg.float_match_distance,
                                       cross_check=True, gate_mask=gate_mask)
    return match_descriptors(da, db, va, vb, max_distance=cfg.landmark_match_distance,
                             cross_check=True, gate_mask=gate_mask)


def _stereo_and_triangulate(cfg, use_k, rig: StereoRig, pyr_l, pyr_r,
                            feats: FeatureTable, F_rig):
    """L→R KLT + epipolar gate + DLT triangulation in the left camera frame."""
    uv_r, st_ok, _ = _lk_fb(cfg, use_k, pyr_l, pyr_r, feats.xy, feats.valid)
    st_ok = st_ok & (epipolar_residual(F_rig, feats.xy, uv_r) < cfg.epipolar_threshold)
    eye = torch.eye(3, dtype=torch.float32, device=uv_r.device)
    zero = torch.zeros(3, dtype=torch.float32, device=uv_r.device)
    X_cam = triangulate_dlt(rig.left.K, eye, zero, rig.right.K, rig.R_rl, rig.t_rl,
                            feats.xy, uv_r)
    z = X_cam[:, 2]
    x_r = se3_apply(rig.R_rl, rig.t_rl, X_cam)
    err_l = torch.linalg.vector_norm(project(rig.left, X_cam) - feats.xy, dim=-1)
    err_r = torch.linalg.vector_norm(project(rig.right, x_r) - uv_r, dim=-1)
    disparity = ((feats.xy[:, 0] - rig.left.cx) - (uv_r[:, 0] - rig.right.cx)).abs()
    tri_ok = (st_ok & (z > cfg.min_depth) & (z < cfg.max_depth) & (x_r[:, 2] > 0)
              & (err_l < cfg.reprojection_threshold)
              & (err_r < cfg.reprojection_threshold)
              & (disparity >= cfg.min_disparity))
    return feats._replace(uv_r=uv_r, stereo_ok=st_ok), X_cam, tri_ok


def _associate_landmarks(cfg, rig: StereoRig, feats: FeatureTable, lmap, R_pred, t_pred):
    """Landmark-less keypoints ↔ map landmarks by descriptor within a
    projected radius, over the frustum-culled, unattached landmarks."""
    M = lmap.valid.shape[0]
    xc = se3_apply(R_pred, t_pred, lmap.xyz)
    proj = project(rig.left, xc)
    in_frustum = (xc[:, 2] > 0.1) & (
        torch.linalg.vector_norm(xc, dim=-1) < cfg.landmark_search_radius)
    m = float(cfg.frustum_margin)
    w, h = float(rig.left.width), float(rig.left.height)
    if w > 0 and h > 0:
        in_frustum = in_frustum & ((proj[:, 0] >= -m) & (proj[:, 0] < w + m)
                                   & (proj[:, 1] >= -m) & (proj[:, 1] < h + m))
    live = feats.valid & (feats.lm_idx >= 0)
    attached = _mark(M, torch.where(live, feats.lm_idx, M), xc.device)
    assignable = lmap.valid & in_frustum & (~attached)
    free_kp = feats.valid & (feats.lm_idx < 0)
    gate = radius_gate(feats.xy, proj, 20.0)
    idx, _, ok = _match_desc(cfg, feats.desc, lmap.desc, free_kp, assignable, gate)
    new_lm_idx = torch.where(ok & free_kp, idx, feats.lm_idx).to(_I32)
    return feats._replace(lm_idx=new_lm_idx), (ok & free_kp).sum()


def _temporal_rematch(cfg, rig: StereoRig, feats: FeatureTable, prev_desc, prev_xy,
                      prev_lm_idx, prev_valid, track2d_ok, R_prev, t_prev,
                      R_pred, t_pred, lmap):
    """Previous-frame keypoints whose KLT track died but carried a landmark
    are matched by descriptor against the current landmark-less keypoints
    under the epipolar gate of the predicted relative motion."""
    N = feats.xy.shape[0]
    M = lmap.valid.shape[0]
    lost = prev_valid & (prev_lm_idx >= 0) & (~track2d_ok)
    live = feats.valid & (feats.lm_idx >= 0)
    attached = _mark(M, torch.where(live, feats.lm_idx, M), feats.xy.device)
    lost = lost & (~attached[prev_lm_idx.clamp(min=0).long()])
    free = feats.valid & (feats.lm_idx < 0)
    Rpi, tpi = se3_inverse(R_prev, t_prev)
    R_rel, t_rel = se3_compose(R_pred, t_pred, Rpi, tpi)
    E = essential_from_pose(R_rel, t_rel)
    Kinv = torch.linalg.inv_ex(rig.left.K).inverse
    F = Kinv.T @ E @ Kinv
    gate = epipolar_gate(F, prev_xy, feats.xy, cfg.temporal_match_epipolar)
    idx, _, ok = _match_desc(cfg, prev_desc, feats.desc, lost, free, gate)
    tgt = torch.where(ok, idx, N)
    new_lm = _scatter(feats.lm_idx, tgt, torch.where(ok, prev_lm_idx, -1))
    return feats._replace(lm_idx=new_lm), ok.sum()


def _body_pose_world(rig: StereoRig, R_cw, t_cw):
    """Body (IMU) rotation R_wb and position p_w from the camera pose
    (T_iw = T_ci^-1 ∘ T_cw)."""
    Ric, tic = se3_inverse(rig.R_ci, rig.t_ci)
    R_iw, t_iw = se3_compose(Ric, tic, R_cw, t_cw)
    return se3_inverse(R_iw, t_iw)


def _preintegrate(cfg: SlamConfig, vio: VioState, gyro, accel, dts, mask):
    """The interval's ImuIntegral by ``cfg.imu_method``: the manifold scan
    ("basalt") or a continuous-time backend on midpoint timestamps rebuilt
    from the dts, on a grid as long as the padded batch."""
    noise = ImuNoise(gyro_noise=cfg.imu_gyro_noise, accel_noise=cfg.imu_accel_noise,
                     gyro_bias_walk=cfg.imu_gyro_bias_walk,
                     accel_bias_walk=cfg.imu_accel_bias_walk)
    if cfg.imu_method == "basalt":
        return preintegrate(gyro, accel, dts, mask, noise=noise, bias_gyro=vio.bias_gyro,
                            bias_accel=vio.bias_accel)
    d = torch.where(mask, dts, 0.0)
    return preintegrate_continuous(
        torch.cumsum(d, 0) - 0.5 * d, gyro, accel, mask, torch.zeros_like(d[0]), d.sum(),
        n_grid=int(gyro.shape[0]), method=cfg.imu_method, noise=noise,
        bias_gyro=vio.bias_gyro, bias_accel=vio.bias_accel)


def _vio_predict(rig: StereoRig, state: SlamState, integral, R_pred_cv, t_pred_cv):
    """The inertial prediction once gravity and velocity are observable,
    else the constant-velocity one."""
    vio = state.vio
    R_i, t_i = inertial_predict_pose(state.R_cw, state.t_cw, vio.v_world, vio.gravity_w,
                                     integral, rig.R_ci, rig.t_ci)
    use = vio.gravity_ok & (vio.hist_n >= 1) & (integral.dt > 0)
    return torch.where(use, R_i, R_pred_cv), torch.where(use, t_i, t_pred_cv)


def _vio_update(rig: StereoRig, vio: VioState, integral, accel, mask,
                R_cw_prev, t_cw_prev, R_cw, t_cw, pose_ok) -> VioState:
    """Post-estimation VIO bookkeeping: velocity from the VO pose difference
    (IMU-propagated fallback), the 3-pose history, a gravity sample from the
    central-difference VO acceleration, and the gravity re-estimate."""
    R_wb_now, p_now = _body_pose_world(rig, R_cw, t_cw)
    R_wb_prev, _ = _body_pose_world(rig, R_cw_prev, t_cw_prev)
    dt = integral.dt
    have_prev = vio.hist_n >= 1
    v_vo = (p_now - vio.hist_p[2]) / torch.clamp(dt, min=1e-6)
    v_imu = propagate_velocity(vio.v_world, vio.gravity_w, R_wb_prev, integral)
    v_new = torch.where(pose_ok & have_prev & (dt > 0), v_vo,
                        torch.where(vio.gravity_ok & (dt > 0), v_imu, vio.v_world))
    # mean specific force over the interval (bias-corrected); a where and a
    # sum, not boolean indexing, which would read the count back
    n_s = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    f_mean = torch.where(mask[:, None], accel, 0.0).sum(0) / n_s - vio.bias_accel
    hist_p = torch.cat([vio.hist_p[1:], p_now[None]])
    hist_R = torch.cat([vio.hist_R_wb[1:], R_wb_now[None]])
    hist_dt = torch.cat([vio.hist_dt[1:], dt[None]])
    hist_f = torch.cat([vio.hist_f[1:], f_mean[None]])
    est = GravityEstimator(samples=vio.grav_samples, valid=vio.grav_valid,
                           next_slot=vio.grav_next)
    new = gravity_add_sample(est, hist_p[0], hist_p[1], hist_p[2], hist_dt[0], hist_dt[1],
                             hist_R[1], 0.5 * (hist_f[0] + hist_f[1]))
    can_sample = (vio.hist_n >= 2) & pose_ok & (hist_dt > 0).all()
    est = GravityEstimator(*(torch.where(can_sample, a, b) for a, b in zip(new[:3], est[:3])))
    g, g_ok = gravity_estimate(est)
    return vio._replace(
        v_world=v_new, gravity_w=torch.where(g_ok, g, vio.gravity_w),
        gravity_ok=g_ok | vio.gravity_ok, grav_samples=est.samples, grav_valid=est.valid,
        grav_next=est.next_slot, hist_p=hist_p, hist_R_wb=hist_R, hist_dt=hist_dt,
        hist_f=hist_f, hist_n=torch.clamp(vio.hist_n + 1, max=3).to(_I32))


def _keyframe_decision(cfg, state: SlamState, R_cw, t_cw, n_inliers, tracked_ratio):
    first = state.frame_idx == 0
    Ri, ti = se3_inverse(state.last_kf_R, state.last_kf_t)
    R_rel, t_rel = se3_compose(R_cw, t_cw, Ri, ti)
    trans = torch.linalg.vector_norm(t_rel)
    rot_deg = torch.rad2deg(rotation_angle(R_rel))
    n_since = state.frames_since_kf
    motion_trigger = (trans >= cfg.kf_min_translation) | (rot_deg >= cfg.kf_min_rotation_deg)
    quality_trigger = ((tracked_ratio <= cfg.kf_min_tracked_ratio)
                       | (n_inliers < cfg.kf_min_inliers))
    gap_ok = n_since >= cfg.kf_min_frames
    forced = n_since >= cfg.kf_max_frames
    return first | forced | (gap_ok & (motion_trigger | quality_trigger))


@inline_programs
def slam_step(cfg: SlamConfig, rig: StereoRig, state: SlamState, img_l, img_r,
              noise: CascadeNoise | None = None, imu=None):
    """Process one stereo frame on the device its tensors live on. Returns
    (new_state, telemetry). The library programs it calls (``ops/``,
    ``imu/``, ``estimation/``) run inline, as in the reference's jitted
    step: an eager call captures nothing.

    img_l/img_r: (H, W) float32 in [0, 1]. noise: optional ``CascadeNoise``
    (Gumbel draws of the four RANSAC estimators); None draws them from the
    state's generator (seed, frame counter). imu: optional (gyro (S, 3),
    accel (S, 3), dts (S,), mask (S,)), the IMU samples of the interval
    ending at this frame; it turns on the VIO branch."""
    dev = img_l.device
    use_k = resolve_use_kernels(cfg, dev)
    N = cfg.max_keypoints
    tracing.begin("slam_step", dev)
    tracing.stage("step.pyramid", dev)
    if cfg.use_clahe:   # before the pyramid, detection and description
        img_l = clahe(img_l, clip_limit=cfg.clahe_clip)
        img_r = clahe(img_r, clip_limit=cfg.clahe_clip)
    pyr_l, pyr_r = build_ragged_pyramid_pair(img_l, img_r, cfg.pyramid_levels,
                                             dtype=pyramid_dtype(cfg, dev))
    F_rig = fundamental_from_rig(rig)

    # ---- PREDICT (IMU preintegration and the inertial prediction) ----------
    tracing.stage("step.predict", dev)
    R_pred, t_pred = _predict_pose(state)
    pred_sigma_p = None
    if imu is not None:
        gyro, accel, imu_dts = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                                for x in imu[:3])
        imu_mask = torch.as_tensor(imu[3], device=dev).to(torch.bool)
        integral = _preintegrate(cfg, state.vio, gyro, accel, imu_dts, imu_mask)
        R_pred, t_pred = _vio_predict(rig, state, integral, R_pred, t_pred)
        # 1-sigma position uncertainty of the prediction, the inertial
        # candidate's weight in pose fusion
        pred_sigma_p = torch.sqrt(torch.clamp(
            torch.diagonal(integral.cov[6:9, 6:9]).sum() / 3.0, min=1e-18))

    # ---- TRACK (temporal) --------------------------------------------------
    tracing.stage("step.track", dev)
    prev_xy = state.features.xy
    prev_lm_idx = state.features.lm_idx
    prev_desc = state.features.desc
    prev_feat_valid = state.features.valid
    feats, n_tracked = _temporal_track(cfg, use_k, rig, state, pyr_l, R_pred, t_pred)
    track2d_ok = feats.valid
    n_prev_valid = state.features.valid.sum()
    tracked_ratio = n_tracked / torch.clamp(n_prev_valid, min=1)

    # ---- DETECT top-up -----------------------------------------------------
    tracing.stage("step.detect", dev)
    feats, n_detected, next_track_id = _detect_topup(cfg, img_l, feats, state.next_track_id)

    # ---- DESCRIBE ----------------------------------------------------------
    tracing.stage("step.describe", dev)
    feats = feats._replace(desc=_describe(cfg, use_k, img_l, feats))

    # ---- ASSOCIATE lost landmarks ------------------------------------------
    tracing.stage("step.associate", dev)
    feats, _ = _associate_landmarks(cfg, rig, feats, state.lmap, R_pred, t_pred)

    # ---- TEMPORAL REMATCH --------------------------------------------------
    if cfg.use_temporal_rematch:
        tracing.stage("step.rematch", dev)
        feats, _ = _temporal_rematch(
            cfg, rig, feats, prev_desc, prev_xy, prev_lm_idx, prev_feat_valid,
            track2d_ok, state.R_cw, state.t_cw, R_pred, t_pred, state.lmap)

    # ---- STEREO + TRIANGULATE ----------------------------------------------
    tracing.stage("step.stereo", dev)
    feats, X_cam, tri_ok = _stereo_and_triangulate(cfg, use_k, rig, pyr_l, pyr_r,
                                                   feats, F_rig)

    # ---- KEYLINES (track / detect / describe / associate / stereo) ---------
    lines, line_map, next_line_id = state.lines, state.line_map, state.next_line_id
    zero = torch.zeros((), dtype=_I32, device=dev)
    n_lines = n_line_tri = line_map_size = zero
    if cfg.use_keylines:
        tracing.stage("step.keylines", dev)

        def lk_temporal(pts, v, init_pts=None):
            return _lk_fb(cfg, use_k, state.prev_pyr_l, pyr_l, pts, v, init_pts=init_pts)

        def lk_stereo(pts, v, init_pts=None):
            return _lk_fb(cfg, use_k, pyr_l, pyr_r, pts, v, init_pts=init_pts)

        lines, _ = LS.line_temporal_track(cfg, rig, lines, line_map, lk_temporal,
                                          R_pred, t_pred, tuple(pyr_l[0].shape))
        lines, _, next_line_id = LS.line_detect_topup(cfg, img_l, lines, next_line_id)
        lines = lines._replace(desc=keyline_descriptors(img_l, lines.ep, lines.valid))
        lines, _ = LS.line_associate(cfg, rig, lines, line_map, R_pred, t_pred)
        lines, X_line_ep, line_tri_ok = LS.line_stereo_triangulate(cfg, rig, lines,
                                                                   lk_stereo, F_rig)
        n_lines = lines.valid.sum()
        n_line_tri = line_tri_ok.sum()

    # ---- ESTIMATE (cascade) ------------------------------------------------
    tracing.stage("step.estimate", dev)
    lmap = state.lmap
    M = lmap.valid.shape[0]
    has_lm = feats.valid & (feats.lm_idx >= 0)
    X_w_lm = lmap.xyz[feats.lm_idx.clamp(min=0).long()]
    corr0 = has_lm & (feats.age > 0)
    corr1 = corr0 & feats.stereo_ok
    Rwp, twp = se3_inverse(R_pred, t_pred)
    X_w_cur = se3_apply(Rwp, twp, X_cam)
    corr3d = has_lm & tri_ok
    # keyline endpoints' 3D-2D pairs join the cam0 problem
    X0_est, uv0_est, v0_est = X_w_lm, feats.xy, corr0
    if cfg.use_keylines:
        Xl, uvl, vl = LS.line_pose_correspondences(lines, line_map)
        X0_est = torch.cat([X0_est, Xl])
        uv0_est = torch.cat([uv0_est, uvl])
        v0_est = torch.cat([v0_est, vl])
    n_pnp = X0_est.shape[0]
    ess_kwargs = {}
    if cfg.use_essential_fallback:
        prev_lm_xyz = lmap.xyz[prev_lm_idx.clamp(min=0).long()]
        ess_kwargs = dict(
            p2a=prev_xy, p2b=feats.xy, valid2=track2d_ok,
            X2_prev_cam=se3_apply(state.R_cw, state.t_cw, prev_lm_xyz),
            has3d2=track2d_ok & (prev_lm_idx >= 0),
            R_prev=state.R_cw, t_prev=state.t_cw,
            essential_threshold=cfg.essential_threshold)
    if noise is None:
        noise = draw_cascade_noise(frame_generator(state, dev), N, cfg.pnp_iters,
                                   cfg.rigid_iters, cfg.essential_iters, dev, n_pnp=n_pnp)
    expect = ((cfg.pnp_iters, n_pnp), (cfg.pnp_iters, n_pnp), (cfg.rigid_iters, N),
              (cfg.essential_iters, N))
    if tuple(tuple(x.shape) for x in noise) != expect:
        raise ValueError(f"noise shapes {[tuple(x.shape) for x in noise]} != {expect}")
    est = estimate_pose_cascade(
        noise, rig, X0_est, uv0_est, v0_est, X_w_lm, feats.uv_r, corr1,
        X_w_cur, X_w_lm, corr3d, R_pred, t_pred,
        pnp_threshold=cfg.pnp_threshold, rigid_threshold=cfg.rigid_threshold,
        min_inliers=cfg.min_inliers, fuse=cfg.use_pose_fusion, pred_sigma_p=pred_sigma_p,
        **ess_kwargs)
    R_cw, t_cw = est.R, est.t

    # ---- MAP UPDATE --------------------------------------------------------
    tracing.stage("step.map", dev)
    Rwc, twc = se3_inverse(R_cw, t_cw)
    X_w_new = se3_apply(Rwc, twc, X_cam)
    new_lm_cand = feats.valid & (feats.lm_idx < 0) & tri_ok
    live = feats.valid & (feats.lm_idx >= 0)
    protect = _mark(M, torch.where(live, feats.lm_idx, M), dev)
    cand_score = torch.where(new_lm_cand, 1.0 / torch.clamp(X_cam[:, 2], min=0.1),
                             float("-inf"))
    slot, placed = allocate_landmark_slots(lmap.valid, lmap.last_seen, protect,
                                           cand_score, new_lm_cand)
    sl = torch.where(placed, slot, M)
    H, W = img_l.shape
    xi = torch.clamp(feats.xy[:, 0], 0.0, W - 1.001)
    yi = torch.clamp(feats.xy[:, 1], 0.0, H - 1.001)
    x0 = torch.floor(xi).long()
    y0 = torch.floor(yi).long()
    fxs, fys = xi - x0, yi - y0
    imf = img_l.float()
    inten = (imf[y0, x0] * (1 - fxs) * (1 - fys) + imf[y0, x0 + 1] * fxs * (1 - fys)
             + imf[y0 + 1, x0] * (1 - fxs) * fys + imf[y0 + 1, x0 + 1] * fxs * fys)
    lmap = lmap._replace(
        xyz=_scatter(lmap.xyz, sl, X_w_new),
        desc=_scatter(lmap.desc, sl, feats.desc),
        valid=_scatter(lmap.valid, sl, placed),
        last_seen=_scatter(lmap.last_seen, sl, state.frame_idx),
        n_obs=_scatter(lmap.n_obs, sl, 1),
        generation=_scatter(lmap.generation, sl, 1, accumulate=True),
        color=_scatter(lmap.color, sl, inten))
    feats = feats._replace(lm_idx=torch.where(placed, slot, feats.lm_idx).to(_I32))
    obs = torch.where(feats.valid & (feats.lm_idx >= 0), feats.lm_idx, M)
    lmap = lmap._replace(last_seen=_scatter(lmap.last_seen, obs, state.frame_idx),
                         n_obs=_scatter(lmap.n_obs, obs, 1, accumulate=True))
    if cfg.landmark_ema > 0.0:
        a = cfg.landmark_ema
        refine = feats.valid & (feats.lm_idx >= 0) & tri_ok & (~placed)
        old_xyz = lmap.xyz[feats.lm_idx.clamp(min=0).long()]
        lmap = lmap._replace(xyz=_scatter(lmap.xyz, torch.where(refine, feats.lm_idx, M),
                                          (1.0 - a) * old_xyz + a * X_w_new))

    # ---- LINE MAP UPDATE ---------------------------------------------------
    if cfg.use_keylines:
        lines, line_map, _ = LS.line_map_update(cfg, lines, line_map, X_line_ep, line_tri_ok,
                                                R_cw, t_cw, state.frame_idx)
        line_map_size = line_map.valid.sum()

    # ---- KEYFRAME ----------------------------------------------------------
    tracing.stage("step.keyframe", dev)
    is_kf = _keyframe_decision(cfg, state, R_cw, t_cw, est.n_inliers, tracked_ratio)
    last_kf_R = torch.where(is_kf, R_cw, state.last_kf_R)
    last_kf_t = torch.where(is_kf, t_cw, state.last_kf_t)
    frames_since_kf = torch.where(is_kf, 0, state.frames_since_kf + 1).to(_I32)

    # ---- MOTION UPDATE (EMA (new + old) / 2) -------------------------------
    Rpi, tpi = se3_inverse(state.R_cw, state.t_cw)
    R_rel, t_rel = se3_compose(R_cw, t_cw, Rpi, tpi)
    mm = state.motion
    vel_obs = t_rel
    ang_obs = so3_log(R_rel)
    first = mm.n_updates == 0
    motion = MotionModel(
        vel=torch.where(first, vel_obs, 0.5 * (vel_obs + mm.vel)),
        vel_ang=torch.where(first, ang_obs, 0.5 * (ang_obs + mm.vel_ang)),
        acc=torch.where(first, mm.acc, 0.5 * ((vel_obs - mm.vel) + mm.acc)),
        acc_ang=torch.where(first, mm.acc_ang, 0.5 * ((ang_obs - mm.vel_ang) + mm.acc_ang)),
        n_updates=(mm.n_updates + 1).to(_I32))
    vio = state.vio
    if imu is not None:
        tracing.stage("step.vio", dev)
        vio = _vio_update(rig, vio, integral, accel, imu_mask, state.R_cw, state.t_cw,
                          R_cw, t_cw, est.ok)

    new_state = SlamState(
        features=feats, lmap=lmap, lines=lines, line_map=line_map, R_cw=R_cw, t_cw=t_cw,
        motion=motion, last_kf_R=last_kf_R, last_kf_t=last_kf_t, frames_since_kf=frames_since_kf,
        frame_idx=(state.frame_idx + 1).to(_I32), next_track_id=next_track_id,
        next_line_id=next_line_id,
        prev_pyr_l=pyr_l, rng_seed=state.rng_seed, rng_step=state.rng_step + 1, vio=vio)
    telem = FrameTelemetry(
        n_tracked=n_tracked, n_detected=n_detected,
        n_stereo=(feats.stereo_ok & feats.valid).sum(), n_triangulated=tri_ok.sum(),
        n_pose_inliers=est.n_inliers, pose_method=est.method, pose_ok=est.ok,
        tracked_ratio=tracked_ratio, is_keyframe=is_kf, map_size=lmap.valid.sum(),
        n_lines=n_lines, n_line_triangulated=n_line_tri, line_map_size=line_map_size,
        R_cw=R_cw, t_cw=t_cw)
    tracing.end("slam_step", dev)
    return new_state, telem


def _step_program(cfg: SlamConfig, rig: StereoRig, state: SlamState, img_l, img_r,
                  noise: CascadeNoise, imu):
    """The body of the captured step: ``slam_step`` with its noise given,
    and the telemetry also packed (``pack_telemetry``) inside the program
    (a stage of its own, up to the program's last node)."""
    new_state, tel = slam_step(cfg, rig, state, img_l, img_r, noise=noise, imu=imu)
    tracing.stage("step.pack", img_l.device)
    return new_state, tel, pack_telemetry(tel)


def _pnp_width(cfg: SlamConfig) -> int:
    """The cam0 PnP's width: the keypoints, plus two endpoints a keyline."""
    return cfg.max_keypoints + (2 * cfg.max_keylines if cfg.use_keylines else 0)


class SlamStep:
    """The per-frame step as a captured program (``utils/graphs.py``), the
    counterpart of the reference's jitted ``slam_step`` with
    ``donate_argnames=("state",)``: one CUDA graph per (config, rig, image
    shape, IMU batch shape or none), replayed on every later frame.

    The state is donated: the returned state is the program's own buffers,
    which the next call overwrites in place. Passed back, it is copied
    nowhere; a state the caller built or changed (``_replace``) is copied
    in. A state that the step returned before its latest call has been
    overwritten by that call, and passing it again raises, as the reference
    raises on a donated array; a state kept past the next call is copied
    first (``graphs.fresh``). The telemetry is returned fresh, a copy of the
    graph's static output that no later call touches.

    The host fields ``rng_seed`` and ``rng_step`` advance on every call, and
    the frame's RANSAC noise is drawn eagerly from them before the replay,
    as ``slam_step`` draws it: the draws are the eager form's, bit for bit.
    Under ``graphs.eager()`` it is ``slam_step``."""

    def __init__(self, cfg: SlamConfig, rig: StereoRig):
        self.cfg, self.rig = cfg, rig
        self.program = Program(_step_program, static_argnames=("cfg",),
                               donate_argnames=("state",))
        # data_ptr of each buffer of a state this step returned -> that
        # state's rng_step: a state on these buffers with another rng_step
        # was returned before the latest call
        self._issued: dict = {}

    def _buffers(self, state: SlamState) -> list:
        leaves = []
        flatten(state, leaves)
        return [t.data_ptr() for t in leaves if t.numel()]

    def _run(self, state: SlamState, img_l, img_r, noise: CascadeNoise | None = None, imu=None):
        """One frame: (new state, telemetry, the telemetry packed as
        ``pack_telemetry`` packs it), the last two the program's static
        outputs, which the next call overwrites."""
        cfg = self.cfg
        dev = img_l.device
        graphed = graphs_on()
        if graphed and any(self._issued.get(p, state.rng_step) != state.rng_step
                           for p in self._buffers(state)):
            raise RuntimeError(
                "this state was returned before the step's latest call, which has "
                "overwritten it in place (the state is donated): copy a state "
                "(graphs.fresh) to keep it past the next call")
        if noise is None:
            with tracing.span("frame.noise"):
                noise = draw_cascade_noise(frame_generator(state, dev), cfg.max_keypoints,
                                           cfg.pnp_iters, cfg.rigid_iters, cfg.essential_iters,
                                           dev, n_pnp=_pnp_width(cfg))
        if imu is not None:
            imu = (*(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in imu[:3]),
                   torch.as_tensor(imu[3], device=dev).to(torch.bool))
        with tracing.span("frame.replay"):
            new_state, tel, packed = self.program(cfg, self.rig,
                                                  state._replace(rng_seed=0, rng_step=0),
                                                  img_l, img_r, noise, imu)
        new_state = new_state._replace(rng_seed=state.rng_seed, rng_step=state.rng_step + 1)
        if graphed:
            self._issued.update(dict.fromkeys(self._buffers(new_state), new_state.rng_step))
        return new_state, tel, packed

    def run(self, state: SlamState, img_l, img_r, noise: CascadeNoise | None = None, imu=None):
        """One frame: (new state, telemetry, the telemetry packed as
        ``pack_telemetry`` packs it), the telemetry fresh. Arguments as
        ``slam_step``'s."""
        new_state, tel, packed = self._run(state, img_l, img_r, noise=noise, imu=imu)
        return (new_state, *fresh((tel, packed)))

    def __call__(self, state: SlamState, img_l, img_r, noise: CascadeNoise | None = None,
                 imu=None):
        """One frame: (new state, fresh telemetry)."""
        return self.run(state, img_l, img_r, noise=noise, imu=imu)[:2]


def make_slam_step(cfg: SlamConfig, rig: StereoRig) -> SlamStep:
    """Close over the config and rig: returns ``step(state, img_l, img_r)``,
    the captured ``slam_step(cfg, rig, state, img_l, img_r)`` (``SlamStep``),
    as the reference returns its jitted step."""
    return SlamStep(cfg, rig)
