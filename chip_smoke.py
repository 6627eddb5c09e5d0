#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--compare DIR ...]

Phases (each one fatal on failure):

1. device: name, count and the card's power limit (nvidia-smi);
2. build: both CUDA kernels from ``zenslam_tpu_torch/csrc`` (one nvcc per
   source, all in parallel, with those of every ``--compare`` directory),
   printing ptxas' register / shared-memory / spill lines; a kernel of this
   tree with a stack frame or spills fails the phase;
3. lk: the LK kernel against its plain PyTorch version on a rendered
   1024x1024 stereo pair, 512 detected points, the per-frame step's exact
   arguments (with and without init_pts); timed two ways (see below);
4. orb: the ORB kernel against its plain version, full and with a ~10%
   ``needs`` mask; timed likewise;
4a. fma: ``ops/image.py:fma``'s fused float32 op (what CUDA runs) against
   its float64 emulation (what the CPU runs) on frame 0: every element of
   the two Gaussian blurs and the Scharr gradients of its four pyramid
   levels and of the ORB moments, and the keypoints, descriptors and poses
   of FMA_FRAMES ``slam_step`` frames, must be bit-identical; the ORB
   smoothing blur's device ms both ways; the blurs are captured programs,
   and the multiply-add form is part of their key, so the float64 blurs
   must capture anew (the comparison would otherwise replay the fused
   graphs against themselves);
4b. api: the verify skill's library recipe through the port's public
   imports (``zenslam_tpu_torch.geometry``, ``.estimation``, ``.ops``,
   ``.pipeline``): a ``default_rig`` and 512 random points, each
   triangulation (DLT and rectified on the stereo pair, DLT and midpoint
   on the left and a second view 0.5 m away) within 1e-3 m of the truth,
   degenerate rows (behind the cameras, zero disparity) finite and
   rejected by ``triangulation_gates``, fundamental and essential RANSAC
   on noise-free matches with 30% outliers and the pose that
   ``recover_pose_from_essential`` gives within 1e-2, ``pyramidal_lk`` on
   frame 0 -> 1 within 1e-3 px of its CPU run on the tracks ok in both
   >= 96 px from the border, ``make_slam_step`` over API_FRAMES frames
   bit-identical to ``slam_step`` with 2 LK + 1 ORB launches a frame; the
   implicit synchronises of the new functions' second calls by line; the
   library calls (``pyramidal_lk``, ``build_pyramid``, the two-view
   solvers) run their captured programs;
4c. rigs: the captured step (``make_slam_step``) at
   ``scripts/trace_check.py``'s four rigs (RIGS:
   96x128 default, 128x160 with CLAHE and pose fusion, 96x128 with
   keylines, and the left camera's width/height metadata 0), RIG_FRAMES
   frames of the arc rendered on the card at each size with that script's
   IMU slice (8 zero samples, 5 ms apart): finite poses and both kernels
   launched in each; then the LK kernel (temporal, with init_pts, stereo)
   and the ORB kernel against their plain versions on the default rig's
   96x128 pyramids with the lk and orb phases' tolerances;
5. slice: ``slam_step`` alone through ``zenslam_tpu_torch.eval.bench``'s
   ``run_fps`` (``bench.py``'s counterpart), default SlamConfig, 40 frames
   of a 1024x1024 'arc' sequence rendered on the card (8 warm-up frames,
   then the measured frames; the counters at 0 before the call, the
   launches of the measured frames from the benchmark's record): exactly 2
   LK and 1 ORB launches per frame, pose_ok on >= 90% of frames, ATE <
   0.05 m; prints ms/frame, fps, peak memory;
5a. bench: the benchmark's secondary run, ``run_fps(512, 384, 60)``, with
   the slice phase's checks; prints fps beside the card's name; then the last
   frame again, eagerly from the state before it (a replay runs no Python
   hook), its telemetry bit-identical to the graphed frame's, and the LK
   kernel (that frame's temporal call with init_pts and its stereo call, on
   the 384x512 to 48x64 pyramids, with the step's arguments) and the ORB
   kernel (its describe call) against their plain versions with the lk and
   orb phases' tolerances;
6. system: the full keyframe system through ``eval/bench.py``'s
   ``run_full_system_fps``: ``create_system`` with the default SlamConfig
   and ``BackendConfig(telemetry_lag=3)``, ``process_frame`` over the
   80-frame sequence (a throwaway system over every frame and the flush
   first; then frames 0-9 untimed, frames 10-79 and ``flush_pipeline``
   timed up to a synchronise), with tracing on (``utils/tracing.py``;
   so are the system runs of system_cg, graphs and dist, whose back-end
   phases come from its ``backend.*`` spans and whose captures' ms from
   its ``graphs.capture`` spans). Prints ms/frame, fps, the median host
   ``backend_ms`` per keyframe and of each back-end phase, keyframes, BA runs, vocabulary trains, archive size, peak memory, ATE,
   pose_ok, launches, and the host syncs (the system's waits on its
   device->host copies by kind, and every implicit synchronise that
   ``torch.cuda.set_sync_debug_mode`` reports, by source line). Requires 2
   LK + 1 ORB launches per timed frame, >= 8 keyframes (the vocabulary
   retrain at 8 runs), a BA run on every keyframe after the first, each
   with rmse_after <= 1.05 rmse_before and no dropped observations,
   pose_ok >= 0.9 and ATE < 0.05 m, no implicit synchronise in the
   files of ROADMAP Queue 3 A's table (the step's 22 a frame before) and
   none in the keyframe back end (the retrain's 2 before its archive
   sample went up from pinned memory); float
   scatter-adds and BA's planned sums repeated 20 times (the planned ones
   bit-identical each time and to ``index_add_`` on the CPU). Two untimed
   repeats of the run's first REPEAT_FRAMES frames (one as it is, one
   under ``torch.use_deterministic_algorithms``; no flush) print how far
   each of their windows' rmse_before differs from the timed run's same
   window, and every window's robust cost, rmse and five worst residuals
   (keyframe, landmark, px) before and after BA. Then ``system_cg``: the
   same run with ``ba_window=24`` and ``ba_solver="auto"``, which resolves
   to the matrix-free CG solver above 16 keyframes (every window recorded
   as CG, the dense solver never called): the dense run's keyframe count, a
   BA run on every keyframe after the first with rmse_after <= 1.05
   rmse_before, ATE < 0.05 m, pose_ok >= 0.9, 2 LK + 1 ORB launches per
   timed frame, no implicit synchronise in ``backend/ba.py`` or
   ``system._windowed_ba``; the medians of ``ba_dispatch`` and
   ``backend_ms`` beside the dense run's, and one window on the last
   keyframe's inputs through both solvers (``torch.profiler`` kernels and
   busy ms, host ms, ``index_put_`` ms: under 10% of the CG window's busy
   time);
7. loop: the 64-frame 320x240 orbit of ``tests/test_loop_closure.py``
   (seed 21, pixel noise 0.01, radius 1.0, host render) through
   ``run_system`` twice, loop closure off and on with that test's configs:
   at least one loop closes, and the keyframe ATE with loops is below the
   one without; 2 LK + 1 ORB launches per frame in each run;
7a. graphs: the captured programs (``utils/graphs.py``: CUDA graphs,
   the default of the step, the system, the app and the benchmark, which
   the phases above and below run) held against the same code under
   ``graphs.eager()`` in one process: (a) the slice's 40 frames through
   ``make_slam_step`` eager, graphed, graphed, eager: every frame's state
   and telemetry bit-identical, host ms/frame, device busy ms, idle share,
   device kernels and graph launches a frame (``torch.profiler`` over
   PROFILE_FRAMES frames), the capture's ms (the first graphed run
   traced), peak memory, 2 LK + 1 ORB
   launches a frame counted through the replays, and the device time of
   the state's copy into its buffers; (b) the system phase's 80 frames
   through ``process_frame`` eager then graphed: the same keyframes, BA
   runs, loop verdicts, poses, keyframe database, edges, archive,
   vocabulary and BoW database, with ms/frame, the median ``backend_ms``
   and each back-end phase's median of each, and each system program's
   calls over the graphed run (``graphs.calls``) equal to the run's work:
   a snapshot a frame, an insert and a spill pack a keyframe, a window a
   BA run, a pose graph a loop, one first vocabulary and a retrain each
   later train; (c) one CG window (``ba_window`` 24) on (b)'s last inputs,
   with host ms, and the vocabulary's first train and retrain on (b)'s
   database eager, captured and replayed, with host ms; (d) the loop orbit
   with loops on: the same loops and program calls, then the epoch
   correction of two ring entries graphed against eager; (e) the first
   SPILL_FRAMES frames of the reference's slot-pressure orbit
   (``tests/test_map_spill.py``, a 384-slot map): more than 200 spills and
   some reloads, as that test asks, the reload program called;
   then each system program's captures' ms in the traced runs, and that
   the library programs the
   system's programs call in their functions (the solvers, the keyframe,
   BoW and reload functions) captured nothing over the phase: inline
   there, as jit inlines a nested jit; nor did the front end's, IMU's and
   estimators' programs, which the step and the eager ``slam_step`` run
   inline (no capture and no call of their own over the phase, and no
   capture by the eager slice runs). Where two eager runs part, graphed
   is held within their spread and the outputs are named;
8. kidnap: ``tests/test_place_recognition.py``'s kidnap run (112-frame
   448x336 orbit, frames 80-95 skipped, run up to frame KIDNAP_END; the
   test runs on to 111) for the port alone, relocalisation
   off and on, on the kernel path and on the f32 path that test runs: the
   kidnap breaks the run without reloc (tail revisit error > 1 m), 1-4
   relocalisations happen with it, on the f32 path one at or after the
   kidnap; prints each attempt;
9. app: the shipped EuRoC recipe through ``zenslam_tpu_torch.app.main`` on
   an APP_FRAMES-frame 752x480 EuRoC-layout dataset rendered through
   ``options/euroc_camchain.yaml`` (distorted radtan, 20 Hz frames, an
   ``imu0/data.csv`` at 200 Hz, 10 samples a frame, in the IMU frame that
   the camchain's ``T_cam_imu`` places; rectification, CLAHE, the native
   reader, telemetry, ``--no-scene``), run as shipped (the IMU stream drives
   the VIO branch) and again with ``--no-imu``, each checked
   by ``zenslam_tpu_torch.eval.check_run`` against
   ``options/euroc_mh_expected.json`` (ATE, RPE, mean tracked, problem-frame
   share; steady ms/frame and fps reported, no fps floor): 2 LK + 1 ORB
   launches per frame, a BA run per keyframe after the first; the IMU run's
   gravity within 0.5 m/s² of the truth in the SLAM world (the first
   rectified left camera) and its last velocity's error; the LK kernel
   against its plain version on the app's first pyramids; a checkpoint
   after frame APP_CKPT_FRAME of the IMU run (VioState included) loaded back
   bit-identical. Then ``app_viz``: the IMU run again with ``--viz`` and
   ``--save-vocab``, without ``--no-scene``: exit 0, 2 LK + 1 ORB launches
   per frame, the checker's ATE within 0.5 mm of the IMU run's, a spatial
   overlay PNG per keyframe and a temporal one per keyframe after the
   first, all named in ``diagnostics.html``, the last spatial PNG decoded
   (zlib) to 480 x 1504 x 3 with > 50 green marker pixels and equal to
   ``draw_spatial_overlay`` redrawn from its keyframe's snapshot and
   images, the ``viz: timing plots written`` or ``skipped`` line (skipped
   without matplotlib, as the scene PNG is), ``scene.ply`` and
   ``scene.html``; the host ms each keyframe spends in
   ``save_keyframe_overlays``; the saved vocabulary reloaded on the card
   identical, and a 20-frame run with ``backend.vocab_file`` set to it
   (``app_vocab``, 2 LK + 1 ORB launches per frame);
10. fulldress: ``e2e_fulldress.py``'s default dataset (1024x1024, radtan
   ``[-0.12, 0.035, 0.0006, -0.0004]``, 'arc' at speed 0.5, seed 11, IMU,
   rendered on the card), FULLDRESS_FRAMES frames through ``app.main`` with
   ``slam: {use_pose_fusion: true}`` and that script's backend, with the
   IMU stream and again with ``--no-imu``: ATE under the script's 100 mm,
   pose_ok share, gravity within 0.5 m/s² of the truth and the last
   velocity's error, how often the inertial candidate won the fusion,
   steady ms/frame of both runs, 2 LK + 1 ORB launches per frame, what the
   VIO branch adds to one ``slam_step`` (the state before the middle frame,
   rectified, with its IMU slice; device kernels and busy ms by
   ``torch.profiler``, host ms over COST_ROUNDS alternating pairs),
   and the implicit synchronises by source line, none of them in ``imu/``
   or ``estimation/fusion.py``; a third run (``fulldress_lines``) on that
   script's ``--hard`` dataset (``eval/fulldress.py:build_dataset(...,
   hard=True)``: pixel noise 0.02, per-camera exposure flicker σ 0.10,
   vignette 0.35) with its hard slam flags (CLAHE, pose fusion, keylines)
   and the IMU: ATE < 150 mm (the script's ``--hard`` bound), 4 LK + 1 ORB
   launches per frame;
11. lines: (a) the step (eager ``slam_step`` over the warm-up frames but
   the last, which captures it; the captured step after) with
   ``SlamConfig(use_keylines=True)`` on a
   1024x1024 strafe of the corridor with stripes rendered on the card,
   LINES_FRAMES frames (LINES_WARMUP warm-up, the implicit synchronises of
   which are reported by line, none allowed in ``ops/lines.py`` or
   ``pipeline/lines_step.py``), beside the same frames with keylines off:
   exactly 4 LK + 1 ORB launches per frame (2 + 1 off), pose_ok >= 0.9, ATE
   < 0.05 m, >= 8 keylines on every frame after the first, >= 4 mapped and
   more than 60% of their endpoints within 10 cm of a corridor plane; the
   LK kernel against its plain version on the last frame's two endpoint
   batches with the step's arguments (temporal with init_pts, stereo); what
   the keyline branch adds to that step (device kernels and busy ms by
   ``torch.profiler``, host ms over COST_ROUNDS alternating pairs); (b) the keylines
   recipe ``options/euroc_mh_lines.yaml`` through ``app.main`` on an
   APP_FRAMES-frame 752x480 folder of the corridor with stripes rendered
   through ``options/euroc_camchain.yaml`` with ``imu0/data.csv``: as
   shipped (``lines_app``), with CLAHE off (``lines_app_no_clahe``: the
   synthetic corridor keeps no keyline through CLAHE at this size) and
   ``options/euroc_mh.yaml`` on the same folder (``lines_app_base``): each
   passes ``eval/check_run.py`` against ``options/euroc_mh_expected.json``
   with a BA run per keyframe after the first, 4 LK + 1 ORB launches per
   frame with keylines (2 + 1 without), the ATE with keylines under
   max(1.5 x the base's, 20 mm), >= 8 keylines a frame with CLAHE off; and
   a checkpoint of the CLAHE-off keylines system after frame APP_CKPT_FRAME
   (its line tables populated) loaded back bit-identical;
12. families: (a) the step (warm-up as in lines) on the slice phase's first FAMILY_FRAMES
   frames (the same 8
   warm-up frames, the implicit synchronises of which are reported by
   line, then the measured frames with the counters at 0) for each run of
   FAMILIES, (harris, sift), (fast, sift), (dog, freak), (fast, freak),
   (dog, orb) and (fast, orb, describe_refresh=4), beside the default
   config: 2 LK launches per frame and 1 ORB for the ORB runs, pose_ok >=
   0.9, ATE < 0.05 m, and for the SIFT and FREAK runs with the FAST or
   Harris detector mean tracked > 0.5 x and ATE < max(2 x, 0.02 m) of the
   default run's (the bars of ``tests/test_float_family.py`` and
   ``tests/test_detector_matrix.py``); no implicit synchronise in
   ``ops/harris.py``, ``dog.py``, ``sift.py``, ``freak.py`` or the float
   matcher and LSH of ``ops/match.py``; matmuls in full f32; the refresh
   run's rows computed per frame, and the ORB kernel's ``needs`` rows on
   frame REFRESH_CHECK_FRAME bit-identical to a full pass; what each
   family adds to one step from its run's state before frame
   FAMILY_COST_FRAME (``torch.profiler`` kernels and busy ms, host ms over
   COST_ROUNDS alternating rounds); (b) ``TestFloatPathLoopClosure``'s workload
   (96-frame 320x240 orbit, seed 21) through ``run_system`` with SIFT
   (Harris) on the kernel path (2 LK and 0 ORB launches per frame), and
   SIFT and ORB (FAST) on the f32 path that test runs: a loop closes
   through the LSH crossing, SIFT's recall >= 0.5 x ORB's > 0;
13. dist: the sharded BA (``parallel/``) on a one-rank NCCL group, as
   ``__graft_entry__.py:dryrun_multichip`` drives it: (a) the solver alone
   on the dry run's stage-1 problem (K = 8 on an arc, 8 x 32 landmarks,
   seed 0), 8 LM steps with 1 and 8 shards against the dense solver, both
   captured programs as a caller gets them (the first call captures, the
   timed ones replay; host ms eager beside them): max |dt| and |dR| <
   5e-3, cost down > 10x, the shard counts within 1e-4, each bit-identical
   to its eager call, the group's backend ``nccl``, 1 + 2 x 8 collectives
   a replayed solve (counted by the capture) as the eager call makes; (b) the
   system phase's 80-frame run with ``ba_solver="dist"`` at one shard
   (``dist_devices=0``) and at 8, beside the system phase's dense run: the
   same keyframes and BA runs, every window's rmse_after <= 1.05
   rmse_before with no dropped observation, frame and keyframe poses within
   5e-2 of the dense run's, ATE < 0.05 m, pose_ok >= 0.9, 2 LK + 1 ORB
   launches per timed frame, no implicit synchronise in ``parallel/`` or
   on the lines of ``system._windowed_ba``; each run graphed (the window
   a captured program, its all-reduces inside the graph, one call a BA
   run) bit-identical to the same frames under ``graphs.eager()``; the
   route drops (read after the run, on the eager form), median
   ``backend_ms`` and ``ba_dispatch`` beside the dense run's and the
   eager run's, peak memory, and what one windowed BA costs on the last
   keyframe's inputs, dense and at 1 and 8 shards, eager and graphed
   (``torch.profiler`` kernels and busy ms, host ms); (c) the dry
   run's stage 3, the 64-frame 320x240 orbit (seed 21) with BA and loop
   closure, dense and at 1 and 8 shards: >= 3 BA runs and >= 1 loop each,
   the 1-shard run's poses within 5e-2 of the dense run's, the 8-shard
   run's gap and route drops printed, and on the f32 path, the one the dry
   run ran (the reference on the CPU runs no Pallas kernel), 8 shards
   within 5e-2 of dense; on the kernel path, at the first window where the
   dense and 8-shard runs part, teacher-forced, the 8-shard solver within
   1e-6 of the dense solver on the same observation rows, beside the
   dense solver on a permutation of its own rows; (d) the dry run's stage
   2, the 10-frame 192x144 strafe (seed 4), through 2 offline worker
   processes on the card and the in-process chunker (2 chunks, and 1: the
   serial run), on the kernel and the f32 path: the 2-worker stitch within
   5e-3 of the in-process one on both, and the dry run's check (the
   truth's sign, within 0.15 m) held, at a third of its bar, on the
   x-displacement that the images fix, dx + 6 m x the yaw change, of the
   stitch and the serial run (at 192x144 the 28 degree view of the wall 6 m
   ahead confuses a strafe with a yaw); the raw dx and the dry run's
   verdict on it printed; the 2 workers' wall time (reported);
13a. scaling: ``zenslam_tpu_torch.eval.scaling``'s problem (K=32, M=16384,
   O=131072, ``scaling_bench.py``'s draws) through ``dist_bundle_adjust``
   at 1 and 8 local shards of the one-rank group by its ``time_solve``
   (one untimed and three timed solves), captured and under
   ``graphs.eager()``: bit-identical, the cost falls at both, the 8-shard R
   and t within 5e-3 of the 1-shard solve; ms per LM iteration both ways,
   graphs held and peak memory printed;
13b. solvers: every public back-end entry point that the reference jits
   (``bundle_adjust``, ``bundle_adjust_cg``, ``dist_bundle_adjust``,
   ``shard_ba_problem_device``, ``optimize_pose_graph``, the vocabulary
   builders, ``descriptors_to_bow``, ``bow_db_add``, ``bow_db_query``,
   ``kf_db_add``, ``kf_db_update_poses``, ``reload_into_map``,
   ``_pack_live``) called directly, at the system's default sizes, the
   dense solver on ``io/bal.py``'s synthetic BAL subset motion-only and
   with perturbed landmarks and trim (``tests/test_bal.py``'s checks):
   captured against ``graphs.eager()``, bit-identical, the first call's
   output the caller's (unchanged by later calls), the inputs unwritten,
   other traced ints through the same capture; host ms of the first call
   (the capture) and of SOLVER_REPEATS calls each way, captures, graphs
   held and peak memory;
13c. frontend: every library function that the reference jits in its
   front end, IMU, estimators, telemetry and device render (the 40 of
   ``ops/``, ``imu/``, ``estimation/``, ``pipeline/state.py:pack_telemetry``
   and ``io/synthetic.py:_render_view_device``), called directly at the
   default ``SlamConfig``'s sizes on the 1024² frames (512 keypoints, an
   8192-slot map, keylines as ``options/euroc_mh_lines.yaml``, 200 Hz IMU
   against 20 Hz frames), as ``[solvers]`` holds the back end: bit-identical
   to ``graphs.eager()``, the first output unchanged by a second call with
   other values and other traced floats (``t0``/``t1``, ``dt01``/``dt12``)
   through the same capture, the inputs unwritten; host ms of the capture
   and of SOLVER_REPEATS calls each way, captures, graphs held, peak
   memory; no hand kernel launched;
14. the seconds of all phases, a ``kernels`` JSON line (``launches`` is the
   system phase's count, ``launches_by_path`` every path's), the
   nvidia-smi line, and last the result line ``{"ok": true, "device":
   {...}}``.

The step, the keyframe path's programs, the back end's public solvers and
the front end's library functions run as captured programs wherever
``process_frame``, ``make_slam_step``, ``eval/bench.py``,
``eval/scaling.py``, the app or a direct call run them (a program inside
another's function, the eager ``slam_step`` or a foreign CUDA-graph
capture such as ``time_device``'s runs inline); what calls ``slam_step`` itself
(fma, the lines and families warm-up frames whose implicit synchronises
are read, the re-run frames whose kernel inputs are recorded, the branch
costs) runs the eager function.

Each kernel is timed two ways, each as the median and min-max of
``REPEATS`` repeats per turn: ``ms`` is the time per wrapper call (CUDA
events around back-to-back calls: the host's shape checks and ctypes call
plus the kernel, what the main path pays), ``device_ms`` the device time per
launch (``DEVICE_CALLS`` calls captured in one CUDA graph and replayed
between CUDA events, so the host's work is not timed). With ``--compare
DIR`` (repeatable) the kernels built from ``DIR/lk_fb.cu`` and/or
``DIR/orb.cu`` (another revision's or a variant's, same C interface) are
checked against the plain versions and timed the same way, in turns: every
DIR, this tree twice, every DIR in reverse order.

``bound_ms`` is the larger of the bytes the kernel must move over HBM's rate
(the 32-byte sectors of the texels this run's data reads, each once, plus
the small inputs and outputs) and its f32 operations over the f32 peak.

It exits non-zero without a result when no CUDA device is present or when
the ``zenslam_tpu_torch`` package is not next to it. It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import functools
import inspect
import json
import os
import re
import subprocess
import sys
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_FRAMES = 40        # slice phase: frames of the rendered sequence it runs
N_WARMUP = 8
BENCH_W, BENCH_H, BENCH_FRAMES = 512, 384, 60   # bench phase: bench.py's secondary run
SYSTEM_FRAMES = 80   # system phase (bench.py:run_full_system_fps)
SYSTEM_WARMUP = 10
REPEAT_FRAMES = 40   # system phase: frames of the two untimed determinism repeats
CG_WINDOW = 24       # system_cg: a window above 16 keyframes, where "auto" picks CG
APP_FRAMES = 40      # app phase: the exported EuRoC-layout sequence
APP_CKPT_FRAME = 20  # app phase: the checkpoint round trip saves after this frame
FULLDRESS_FRAMES = 40
LINES_FRAMES = 24    # lines phase: slam_step with keylines on a 1024x1024 strafe
LINES_WARMUP = 8
FAMILIES = {         # families phase: run name -> SlamConfig fields
    "harris_sift": dict(detector="harris", descriptor="sift"),
    "fast_sift": dict(descriptor="sift"),
    "dog_freak": dict(detector="dog", descriptor="freak"),
    "fast_freak": dict(descriptor="freak"),
    "dog_orb": dict(detector="dog"),
    "fast_orb_refresh4": dict(describe_refresh=4),
}
FAMILY_FRAMES = 24        # families phase: frames of each run (the slice's first 24)
FAMILY_COST_FRAME = 20    # families phase: the step whose cost is measured
REFRESH_CHECK_FRAME = 16  # families phase: the step whose needs rows are checked
KIDNAP_END = 104          # kidnap phase: the last frame run + 1 (frames 96-103 after the jump)
SIZE = 1024
FMA_FRAMES = 4       # fma phase: slam_step frames compared between the two fma forms
API_FRAMES = 4       # api phase: make_slam_step frames against slam_step
RIGS = {             # rigs phase: scripts/trace_check.py's rigs, name -> (H, W, SlamConfig fields)
    "default": (96, 128, {}),
    "clahe_fusion": (128, 160, {"use_clahe": True, "use_pose_fusion": True}),
    "keylines": (96, 128, {"use_keylines": True}),
    "zero_wh": (96, 128, {}),          # the left camera's width/height metadata 0
}
RIG_FRAMES = 2
# the per-frame step's LK arguments (SlamConfig's defaults)
LK_STEP_ARGS = dict(radius=10, iters=(5, 3, 3, 3), bwd_levels=1, compute_err=False,
                    fb_threshold=1.0)
DIST_ITERS = 8       # dist phase: LM iterations of the solver-alone runs (the dry run's)
DIST_BAR = 5e-2      # dist phase: frame / keyframe t against the dense run (dry run stage 3)
STRAFE_WALL_Z = 6.0  # dist phase (d): the corridor's end wall (io/synthetic.py), m ahead
STRAFE_BAR = 0.05    # dist phase (d): yaw-corrected dx against the truth, m (dry run: 0.15)
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPEATS = 5          # timed repeats per turn
DEVICE_CALLS = 50    # wrapper calls captured in one CUDA graph
COST_ROUNDS = 5      # step_cost: alternating rounds of host timing
PROFILE_FRAMES = 3   # graphs phase: frames under torch.profiler, eager and graphed
SPILL_FRAMES = 16    # graphs phase: frames of the slot-pressure orbit (it reloads from frame 6)
SOLVER_REPEATS = 3   # solvers phase: timed calls each way after the first


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _events_ms(run, count: int) -> float:
    """ms per item of ``run()``, which does ``count`` items, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def time_calls(fn, reps: int, repeats: int = REPEATS, warmup: int = 3) -> list:
    """ms per call of ``fn`` (host + device), one value per repeat of
    ``reps`` back-to-back calls, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return [_events_ms(run, reps) for _ in range(repeats)]


def time_device(fn, calls: int = DEVICE_CALLS, repeats: int = REPEATS) -> list:
    """Device ms per launch of ``fn``, one value per repeat: ``calls``
    calls captured into one CUDA graph, replayed between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return [_events_ms(graph.replay, calls) for _ in range(repeats)]


def summary(ms: list) -> dict:
    """Median and [min, max] of repeated timings."""
    return {"median": float(np.median(ms)), "spread": [float(min(ms)), float(max(ms))]}


@contextlib.contextmanager
def kernels_from(csrc_dir):
    """Inside the block the wrappers launch the kernels built from
    ``csrc_dir`` (this tree's when None). A timing aid of this script: the
    package itself always loads ``csrc/``."""
    from zenslam_tpu_torch.ops import cuda_build

    if csrc_dir is None:
        yield
        return
    load = cuda_build.load
    cuda_build.load = lambda name: load(name, csrc_dir)
    try:
        yield
    finally:
        cuda_build.load = load


def compared(kernel: str, compare: list) -> list:
    """The --compare directories that hold ``kernel``'s source."""
    return [d for d in compare if (Path(d) / f"{kernel}.cu").is_file()]


def time_turns(fn, reps: int, dirs: list) -> dict:
    """Per-call and device times of ``fn`` with this tree's kernels ("new")
    and with those of each directory in ``dirs``, in turns: the directories,
    new, new, the directories in reverse order."""
    order = [*dirs, None, None, *dirs[::-1]]
    raw = {d or "new": {"call": [], "device": []} for d in order}
    for d in order:
        with kernels_from(d):
            raw[d or "new"]["device"] += time_device(fn)
            raw[d or "new"]["call"] += time_calls(fn, reps)
    return {who: {k: summary(v) for k, v in t.items()} for who, t in raw.items()}


def sector_bytes(mask, elem: int) -> int:
    """Bytes of the 32-byte sectors that hold the True texels of a (h, w)
    row-major image of ``elem``-byte texels."""
    import torch

    per = 32 // elem
    h, w = mask.shape
    pad = torch.nn.functional.pad(mask, (0, -w % per))
    return int(pad.reshape(h, -1, per).any(-1).sum()) * 32


def box_mask(h: int, w: int, lx, ly, side: int, hx=None, hy=None):
    """(h, w) bool mask of the union of boxes [lx, lx+side) x [ly, ly+side)
    (int tensors, one box per row), each cut at hx / hy (inclusive, default
    the box's end) and at the image."""
    import torch

    d = torch.arange(side, device=lx.device)
    xs = lx[:, None] + d
    ys = ly[:, None] + d
    okx = (xs < w) if hx is None else (xs <= hx[:, None]) & (xs < w)
    oky = (ys < h) if hy is None else (ys <= hy[:, None]) & (ys < h)
    keep = oky[:, :, None] & okx[:, None, :] & (xs >= 0)[:, None, :] & (ys >= 0)[:, :, None]
    idx = (ys.clamp(0, h - 1)[:, :, None] * w + xs.clamp(0, w - 1)[:, None, :])[keep]
    mask = torch.zeros(h * w, dtype=torch.bool, device=lx.device)
    mask[idx] = True
    return mask.reshape(h, w)


def report_times(tag: str, times: dict) -> None:
    for who, t in times.items():
        c, d = t["call"], t["device"]
        print(f"[{tag}] {who} kernel: device {d['median']:.5f} ms/launch "
              f"[{d['spread'][0]:.5f}, {d['spread'][1]:.5f}], per call "
              f"{c['median']:.5f} ms [{c['spread'][0]:.5f}, {c['spread'][1]:.5f}]")


def kernel_entry(times: dict, **fields) -> dict:
    new = times["new"]
    return dict(fields, ms=new["call"]["median"], ms_spread=new["call"]["spread"],
                device_ms=new["device"]["median"], device_ms_spread=new["device"]["spread"])


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, count, smi_line


def phase_build(compare: list):
    from zenslam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    dirs = [cuda_build.CSRC_DIR, *compare]
    names = [[k for k in ("lk_fb", "orb") if (Path(d) / f"{k}.cu").is_file()] for d in dirs]
    with ThreadPoolExecutor(len(dirs)) as pool:
        all_logs = list(pool.map(cuda_build.build, names, dirs))
    for name, text in all_logs[0].items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                print(f"[build] {name}: {line.strip()}")
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", text)
        require(frames and all(f == ("0", "0", "0") for f in frames),
                f"build: ptxas reports a stack frame or spills for {name}")
    for d, logs in zip(compare, all_logs[1:]):
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {d} {name}: {line.strip()}")
    print(f"[build] {sum(map(len, names))} sources in {time.perf_counter() - t0:.1f} s")


def render_inputs(dev):
    """The arc sequence on the card, and 512 FAST keypoints of frame 0."""
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.ops.fast import detect_grid_keypoints

    t0 = time.perf_counter()
    seq = make_sequence(np.random.default_rng(11), n_frames=SYSTEM_FRAMES, width=SIZE,
                        height=SIZE, motion="arc", speed=0.5, device_render=True,
                        device=dev)
    torch.cuda.synchronize()
    xy, _, valid = detect_grid_keypoints(
        seq.left[0], torch.zeros((512, 2), device=dev), torch.zeros(512, dtype=torch.bool, device=dev),
        max_keypoints=512, subpixel=True)
    require(int(valid.sum()) >= 400, f"only {int(valid.sum())} keypoints detected")
    print(f"[render] {SYSTEM_FRAMES} stereo frames {SIZE}x{SIZE} in "
          f"{time.perf_counter() - t0:.1f} s; {int(valid.sum())} keypoints")
    return seq, xy, valid


def lk_bytes(prev, nxt, xy, valid, tracked, ok, radius: int, bwd_levels: int) -> int:
    """Bytes of the pyramid sectors the LK kernel reads on these inputs. Per
    level: the template footprint of every valid point (exact), and the
    Newton window at its final flow scaled to the level (the steps before it
    move the window by a few texels); the backward pass likewise, around
    the forward result, for the rows that end ok."""
    import torch

    G, win = 2 * radius + 3, 2 * radius + 1

    def template(h, w, x, y):  # texels tap_lo(off) .. tap_hi(off + G - 1)
        out = []
        for c, n in ((x, w), (y, h)):
            off = (c - radius) - 1.0
            lo = torch.floor(off.clamp(0, n - 1)).long()
            hi = (torch.floor((off + (G - 1)).clamp(0, n - 1)).long() + 1).clamp(max=n - 1)
            out += [lo, hi]
        return out

    def window(h, w, x, y):  # texels floor(o) .. floor(o) + win + 2, clamped
        out = []
        for c, n in ((x, w), (y, h)):
            f = torch.floor((c - radius) - 1.0).long()
            lo = f.clamp(0, n - 1)
            hi = ((f + win + 1).clamp(0, n - 1) + 1).clamp(max=n - 1)
            out += [lo, hi]
        return out

    src, dst = xy[valid], tracked[valid]
    back_src, back_dst = tracked[ok], xy[ok]
    total = 0
    for lvl, (a, b) in enumerate(zip(prev, nxt)):
        h, w = a.shape
        sc = 1.0 / (1 << lvl)
        boxes = {0: [template(h, w, *(src * sc).unbind(-1))],
                 1: [window(h, w, *(dst * sc).unbind(-1))]}
        if lvl < bwd_levels:
            boxes[1].append(template(h, w, *(back_src * sc).unbind(-1)))
            boxes[0].append(window(h, w, *(back_dst * sc).unbind(-1)))
        for img, bs in boxes.items():
            mask = torch.zeros((h, w), dtype=torch.bool, device=xy.device)
            for lx, hx, ly, hy in bs:
                mask |= box_mask(h, w, lx, ly, G + 1, hx, hy)
            total += sector_bytes(mask, a.element_size())
    return total


def check_lk_cases(tag: str, cases: dict, xy, valid, args: dict) -> float:
    """The LK kernel against its plain version on each (prev pyramid, next
    pyramid, init_pts) case: max |dxy| <= 0.01 px on rows ok in both, ok
    flags agreeing on >= 99% of valid rows, invalid rows passed through.
    Returns the largest |dxy|."""
    import torch

    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged, lk_ragged_plain

    max_err = 0.0
    for name, (a, b, ip) in cases.items():
        tk, ok_k, _ = lk_ragged(a, b, xy, valid, init_pts=ip, **args)
        tp, ok_p, _ = lk_ragged_plain(a, b, xy, valid, init_pts=ip, **args)
        torch.cuda.synchronize()
        both = ok_k & ok_p
        agree = float((ok_k == ok_p)[valid].float().mean())
        d = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
        max_err = max(max_err, d)
        print(f"[{tag}] {name}: ok kernel {int(ok_k.sum())} plain {int(ok_p.sum())}, "
              f"flags agree {agree:.4f}, max |dxy| on ok-in-both {d:.2e} px")
        require(torch.isfinite(tk).all(), f"{tag} {name}: non-finite output")
        require(int(both.sum()) >= 0.5 * int(valid.sum()), f"{tag} {name}: too few tracks")
        require(d <= 0.01, f"{tag} {name}: |dxy| {d} > 0.01 px")
        require(agree >= 0.99, f"{tag} {name}: ok flags agree on {agree:.4f} < 0.99")
        inv = ~valid
        require(bool((tk[inv] == xy[inv]).all()) and not bool(ok_k[inv].any()),
                f"{tag} {name}: invalid rows not passed through")
    return max_err


def phase_lk(seq, xy, valid, dev, compare: list):
    import torch

    from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged, lk_ragged_plain

    bf16 = torch.bfloat16
    l0, l1 = build_ragged_pyramid_pair(seq.left[0], seq.left[1], 3, dtype=bf16)
    s0, r0 = build_ragged_pyramid_pair(seq.left[0], seq.right[0], 3, dtype=bf16)
    g = torch.Generator(device=dev).manual_seed(5)
    init = xy + 0.5 * torch.randn(xy.shape, generator=g, device=dev)
    args = LK_STEP_ARGS
    cases = {"temporal": (l0, l1, None), "temporal+init": (l0, l1, init),
             "stereo": (s0, r0, None)}
    max_err = check_lk_cases("lk", cases, xy, valid, args)

    dirs = compared("lk_fb", compare)
    tp, ok_p, _ = lk_ragged_plain(l0, l1, xy, valid, init_pts=init, **args)
    for d in dirs:
        with kernels_from(d):
            tk, ok_k, _ = lk_ragged(l0, l1, xy, valid, init_pts=init, **args)
        both = ok_k & ok_p
        print(f"[lk] {d} kernel vs plain (temporal+init): flags agree "
              f"{float((ok_k == ok_p)[valid].float().mean()):.4f}, max |dxy| on ok-in-both "
              f"{float((tk - tp).abs()[both].max()):.2e} px")

    work = {}
    lk_ragged_plain(l0, l1, xy, valid, init_pts=init, work=work, **args)
    times = time_turns(lambda: lk_ragged(l0, l1, xy, valid, init_pts=init, **args), 100, dirs)
    plain_ms = float(np.median(time_calls(
        lambda: lk_ragged_plain(l0, l1, xy, valid, init_pts=init, **args), 10, repeats=3)))
    n = xy.shape[0]
    nbytes = lk_bytes(l0, l1, xy, valid, tp, ok_p, args["radius"], args["bwd_levels"]) \
        + n * (8 + 8 + 1) + n * (8 + 1 + 4)
    # f32 ops per bilinear sample (clamp, floor, weights, 6 mul + 3 add) ~ 20;
    # per Newton cell +3 (residual, two FMAs); per template cell +8 (gradients, sums)
    ops = 20 * (work["grid_samples"] + work["window_samples"]) \
        + 3 * work["window_samples"] + 8 * work["grid_samples"]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    report_times("lk", times)
    print(f"[lk] plain {plain_ms:.3f} ms; bytes {nbytes} ({t_bytes:.5f} ms), samples {work} "
          f"({t_ops:.5f} ms), bound {max(t_bytes, t_ops):.5f} ms")
    return kernel_entry(times, name="lk_fb", route="cuda",
                        source="zenslam_tpu_torch/csrc/lk_fb.cu",
                        replaces="zenslam_tpu/ops/lk_pallas.py:95", max_abs_err=max_err,
                        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        library_ms=None)


def orb_bytes(sm, xy, valid, c, s) -> int:
    """Bytes of the image sectors the ORB kernel reads on these inputs: the
    31x31 moment window of every row and, for valid rows, the nearest pixel
    of each pattern endpoint rotated by (c, s)."""
    import torch

    from zenslam_tpu_torch.ops.orb_cuda import _pattern

    H, W = sm.shape
    r = 15
    xi = torch.round(xy[:, 0]).long()
    yi = torch.round(xy[:, 1]).long()
    mask = box_mask(H, W, xi - r, yi - r, 2 * r + 1).reshape(-1)
    pat = _pattern(xy.device)
    xc, yc, c, s = xy[valid, 0:1], xy[valid, 1:2], c[valid, None], s[valid, None]
    for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        kx = torch.round((xc + px * c) - py * s).long().clamp(0, W - 1)
        ky = torch.round((yc + px * s) + py * c).long().clamp(0, H - 1)
        mask[(ky * W + kx).reshape(-1)] = True
    return sector_bytes(mask.reshape(H, W), sm.element_size())


def check_orb(tag: str, sm, xy, valid) -> tuple:
    """The ORB kernel against its plain version on a smoothed bf16 image:
    >= 99% of valid rows identical, mean Hamming <= 1, median |dtheta| <=
    1e-4, invalid rows zero. Returns (the kernel's words, the plain
    version's (words, cos, sin), max |dtheta|)."""
    import torch

    from zenslam_tpu_torch.ops.match import unpack_bits
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief, orb_steered_brief_plain

    wk, ck, sk = orb_steered_brief(sm, xy, valid)
    wp, cp, sp = orb_steered_brief_plain(sm, xy, valid)
    torch.cuda.synchronize()
    ham = (unpack_bits(wk) != unpack_bits(wp)).sum(-1)[valid].float()
    dth = (torch.atan2(sk, ck) - torch.atan2(sp, cp)).abs()[valid]
    dth = torch.minimum(dth, 2 * np.pi - dth)
    same = float((ham == 0).float().mean())
    print(f"[{tag}] ORB on {int(valid.sum())} rows: rows identical {same:.4f}, mean Hamming "
          f"{float(ham.mean()):.4f}, median |dtheta| {float(dth.median()):.2e}, max "
          f"{float(dth.max()):.2e}")
    require(same >= 0.99, f"{tag}: {same:.4f} ORB rows identical < 0.99")
    require(float(ham.mean()) <= 1.0, f"{tag}: ORB mean Hamming > 1")
    require(float(dth.median()) <= 1e-4, f"{tag}: ORB median |dtheta| > 1e-4")
    require(not bool(wk[~valid].any()), f"{tag}: ORB invalid rows not all zero")
    return wk, (wp, cp, sp), float(dth.max())


def phase_orb(seq, xy, valid, dev, compare: list):
    import torch

    from zenslam_tpu_torch.ops.image import gaussian_blur
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief, orb_steered_brief_plain

    sm = gaussian_blur(seq.left[0], sigma=2.0, radius=4).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(6)
    needs = (torch.rand(xy.shape[0], generator=g, device=dev) < 0.1) & valid
    wk, (wp, cp, sp), dth_max = check_orb("orb", sm, xy, valid)
    wn, _, _ = orb_steered_brief(sm, xy, needs, needs=needs)
    torch.cuda.synchronize()
    require(bool((wn[needs] == wk[needs]).all()), "orb: needs rows differ from the full pass")
    print(f"[orb] needs mask: {int(needs.sum())} rows computed, bit-identical to the full pass")

    dirs = compared("orb", compare)
    for d in dirs:
        with kernels_from(d):
            wd, cd, sd = orb_steered_brief(sm, xy, valid)
        print(f"[orb] {d} kernel vs plain: rows identical "
              f"{float((wd == wp).all(-1)[valid].float().mean()):.4f}, max |dcos| "
              f"{float((cd - cp).abs().max()):.2e}, max |dsin| {float((sd - sp).abs().max()):.2e}")

    times = time_turns(lambda: orb_steered_brief(sm, xy, valid), 200, dirs)
    plain_ms = float(np.median(time_calls(
        lambda: orb_steered_brief_plain(sm, xy, valid), 20, repeats=3)))
    n = xy.shape[0]
    nbytes = orb_bytes(sm, xy, valid, cp, sp) + n * (8 + 1) + 256 * 16 + n * (32 + 8)
    # per keypoint: 961 moment taps x 4 ops, 512 rotated samples x 8 ops, 256 compares
    ops = n * (961 * 4 + 512 * 8 + 256)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    report_times("orb", times)
    print(f"[orb] plain {plain_ms:.3f} ms; bytes {nbytes} ({t_bytes:.5f} ms), ops {ops} "
          f"({t_ops:.5f} ms), bound {max(t_bytes, t_ops):.5f} ms")
    return kernel_entry(times, name="orb", route="cuda", source="zenslam_tpu_torch/csrc/orb.cu",
                        replaces="zenslam_tpu/ops/orb_pallas.py:56",
                        max_abs_err=dth_max, plain_ms=plain_ms,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                        library_ms=None)


@contextlib.contextmanager
def f64_fma():
    """Inside the block ``ops/image.py:fma`` is its float64 emulation on
    every device (the form the CPU runs), in the blurs and the ORB
    moments."""
    from zenslam_tpu_torch.ops import image, orb

    saved = image.fma, orb.fma
    image.fma = orb.fma = image._fma_f64
    try:
        yield
    finally:
        image.fma, orb.fma = saved


def phase_fma(seq, dev) -> None:
    """``[fma]``: ``ops/image.py:fma``'s fused float32 op (what CUDA runs)
    against its float64 emulation on the 1024x1024 arc frame: the elements
    that differ in every blur of the frame's pyramid levels (ORB's sigma 2
    radius 4, sigma 1 radius 2, Scharr), in the ORB moments and in the
    step's keypoints, descriptors and poses over FMA_FRAMES frames; the
    ORB smoothing blur's device ms both ways."""
    import torch

    from zenslam_tpu_torch.ops.image import gaussian_blur, scharr_gradients
    from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
    from zenslam_tpu_torch.ops.orb import orb_moments
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, slam_step
    from zenslam_tpu_torch.utils.graphs import graphs_held

    t0 = time.perf_counter()
    levels, _ = build_ragged_pyramid_pair(seq.left[0], seq.right[0], 3)

    def blurs() -> dict:
        out = {}
        for lvl, img in enumerate(levels):
            out[f"blur(2, 4) L{lvl}"] = gaussian_blur(img, 2.0, 4)
            out[f"blur(1, 2) L{lvl}"] = gaussian_blur(img, 1.0, 2)
            out[f"scharr L{lvl}"] = torch.stack(scharr_gradients(img))
        out["orb moments"] = torch.stack(orb_moments(gaussian_blur(seq.left[0], 2.0, 4)))
        return out

    cfg = SlamConfig()

    def steps() -> list:
        state = init_state(cfg, (SIZE, SIZE), seed=0, device=dev)
        rows = []
        for t in range(FMA_FRAMES):
            state, tel = slam_step(cfg, seq.rig, state, seq.left[t], seq.right[t])
            f = state.features
            rows.append({"xy": f.xy, "valid": f.valid, "desc": f.desc,
                         "pose": torch.cat([tel.R_cw.reshape(-1), tel.t_cw])})
        return rows

    held0 = graphs_held()
    fused, fused_steps = blurs(), steps()
    held1 = graphs_held()
    with f64_fma():
        emulated, emulated_steps = blurs(), steps()
    # the blurs are captured programs: the multiply-add form is part of every
    # program's key (utils/graphs.py:_settings), so the float64 blurs capture
    # anew instead of replaying the fused graphs
    new_fused, new_emulated = held1 - held0, graphs_held() - held1
    differ = {k: int((fused[k] != emulated[k]).sum()) for k in fused}
    n_el = sum(v.numel() for v in fused.values())
    step_differ = Counter()
    for a, b in zip(fused_steps, emulated_steps):
        for k in a:
            step_differ[k] += int((a[k] != b[k]).sum())
    img = seq.left[0]
    ms = {"fused": summary(time_device(lambda: gaussian_blur(img, 2.0, 4)))}
    with f64_fma():
        ms["float64"] = summary(time_device(lambda: gaussian_blur(img, 2.0, 4)))
    print(f"[fma] elements differing, fused vs float64, over {n_el} (blurs of 4 pyramid levels, "
          f"Scharr, ORB moments): {sum(differ.values())}; by output: "
          + ", ".join(f"{k} {v}" for k, v in differ.items()))
    print(f"[fma] slam_step over {FMA_FRAMES} frames, fused vs float64: elements differing "
          f"{dict(step_differ)}")
    print(f"[fma] captures by the blurs and the eager steps: fused {new_fused}, float64 "
          f"{new_emulated} (the multiply-add form is in each program's key: the float64 blurs "
          f"are captured anew, not the fused graphs replayed)")
    print(f"[fma] ORB smoothing blur (sigma 2, radius 4) on the 1024x1024 frame, device ms per "
          f"call (CUDA graph of {DEVICE_CALLS}): fused {ms['fused']['median']:.5f} "
          f"{ms['fused']['spread']}, float64 {ms['float64']['median']:.5f} "
          f"{ms['float64']['spread']}")
    print(f"[fma] phase {time.perf_counter() - t0:.1f} s")
    require(sum(differ.values()) == 0 and sum(step_differ.values()) == 0,
            f"fma: the fused op differs from the float64 form ({sum(differ.values())} blur "
            f"elements, step {dict(step_differ)})")
    require(new_emulated > 0, "fma: the float64 blurs captured nothing anew: the fused "
                              "graphs were replayed, the comparison compared them with "
                              "themselves")


def phase_api(seq, xy, valid, dev) -> dict:
    """``[api]``: the verify skill's library recipe through the port's
    public imports on the card (see the module docstring). Returns the
    launches of the ``make_slam_step`` run."""
    import torch

    from zenslam_tpu_torch.estimation import (
        recover_pose_from_essential, solve_essential_ransac, solve_fundamental_ransac)
    from zenslam_tpu_torch.estimation.ransac import gumbel
    from zenslam_tpu_torch.geometry import (
        project, se3_apply, so3_exp, triangulate_dlt, triangulate_midpoint,
        triangulate_rectified, triangulation_gates)
    from zenslam_tpu_torch.io.synthetic import default_rig
    from zenslam_tpu_torch.ops import build_pyramid, pyramidal_lk
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step, slam_step

    t0 = time.perf_counter()
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(12)
    rig = default_rig(SIZE, SIZE, device=dev)
    K = rig.left.K
    n = 512
    X = torch.stack([torch.rand(n, generator=g, device=dev) * 4 - 2,
                     torch.rand(n, generator=g, device=dev) * 4 - 2,
                     torch.rand(n, generator=g, device=dev) * 3 + 1.0], -1)
    R_lw = so3_exp(torch.tensor([0.02, -0.03, 0.01], dtype=f32, device=dev))
    t_lw = torch.tensor([0.1, -0.05, 0.2], dtype=f32, device=dev)
    R_rw, t_rw = rig.R_rl @ R_lw, rig.R_rl @ t_lw + rig.t_rl
    x_l = se3_apply(R_lw, t_lw, X)
    uv_l = project(rig.left, x_l)
    uv_r = project(rig.right, se3_apply(R_rw, t_rw, X))
    # a second view for the two-view solvers, 30% of its matches outliers
    R_b = so3_exp(torch.tensor([0.0, 0.06, 0.01], dtype=f32, device=dev)) @ R_lw
    t_b = t_lw + torch.tensor([0.5, 0.05, 0.1], dtype=f32, device=dev)
    uv_b0 = project(rig.left, se3_apply(R_b, t_b, X))
    out = torch.rand(n, generator=g, device=dev) < 0.3
    uv_b = torch.where(out[:, None], uv_b0 + (torch.rand((n, 2), generator=g, device=dev) * 60
                                              - 30), uv_b0)
    everything = torch.ones(n, dtype=torch.bool, device=dev)
    # degenerate rows for the gates: behind both cameras, zero disparity
    Xd = torch.cat([X[:8] * torch.tensor([1.0, 1.0, -1.0], device=dev), X[8:16]])
    uv_ld = torch.cat([uv_l[:8], uv_l[8:16]])
    uv_rd = torch.cat([uv_r[:8], uv_l[8:16]])
    fx, cx, cy, fy = K[0, 0], K[0, 2], K[1, 2], K[1, 1]
    b = torch.linalg.vector_norm(rig.t_rl)
    noise_f, noise_e = gumbel(g, (256, n), dev), gumbel(g, (256, n), dev)

    def library():
        X_dlt = triangulate_dlt(K, R_lw, t_lw, K, R_rw, t_rw, uv_l, uv_r)
        X_mid = triangulate_midpoint(K, R_lw, t_lw, K, R_rw, t_rw, uv_l, uv_r)
        x_rect = triangulate_rectified(fx, b, cx, cx, cy, fy, uv_l, uv_r)
        X_dlt_b = triangulate_dlt(K, R_lw, t_lw, K, R_b, t_b, uv_l, uv_b0)
        X_mid_b = triangulate_midpoint(K, R_lw, t_lw, K, R_b, t_b, uv_l, uv_b0)
        X_deg = triangulate_dlt(K, R_lw, t_lw, K, R_rw, t_rw, uv_ld, uv_rd)
        X_deg_mid = triangulate_midpoint(K, R_lw, t_lw, K, R_rw, t_rw, uv_ld, uv_rd)
        x_deg_rect = triangulate_rectified(fx, b, cx, cx, cy, fy, uv_ld, uv_rd)
        gates_ok = triangulation_gates(rig, R_lw, t_lw, X_dlt, uv_l, uv_r)
        gates_deg = triangulation_gates(rig, R_lw, t_lw, torch.cat([Xd[:8], X_deg[8:]]),
                                        uv_ld, uv_rd)
        res_f = solve_fundamental_ransac(noise_f, uv_l, uv_b, everything)
        res_e = solve_essential_ransac(noise_e, K, uv_l, uv_b, everything)
        R_e, t_e, n_good = recover_pose_from_essential(res_e["E"], K, uv_l, uv_b,
                                                        res_e["inliers"])
        return (X_dlt, X_mid, x_rect, X_dlt_b, X_mid_b, X_deg, X_deg_mid, x_deg_rect, gates_ok,
                gates_deg, res_f, res_e, R_e, t_e, n_good)

    library()           # the first call's one-time work is not recorded
    torch.cuda.synchronize()
    with implicit_syncs() as records:
        (X_dlt, X_mid, x_rect, X_dlt_b, X_mid_b, X_deg, X_deg_mid, x_deg_rect, gates_ok,
         gates_deg, res_f, res_e, R_e, t_e, n_good) = library()
    torch.cuda.synchronize()
    # R_b, t_b relative to the left view, as recoverPose gives it (|t| = 1)
    R_rel = R_b @ R_lw.T
    t_rel = t_b - R_rel @ t_lw
    t_rel = t_rel / torch.linalg.vector_norm(t_rel)
    errs = {"dlt": float((X_dlt - X).abs().max()),
            "rectified": float((x_rect - x_l).abs().max()),
            "dlt (left, second view)": float((X_dlt_b - X).abs().max()),
            "midpoint (left, second view)": float((X_mid_b - X).abs().max())}
    mid_stereo = float((X_mid - X).abs().max())
    rot_err = float((R_e - R_rel).abs().max())
    t_err = float((t_e - t_rel).abs().max())
    inl_f, inl_e = res_f["inliers"], res_e["inliers"]
    print(f"[api] triangulation of {n} points 1-4 m ahead, max |error| (m): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; midpoint on the 0.11 m stereo pair {mid_stereo:.2e} (its 1 - cos^2 of "
          f"near-parallel rays cancels in float32, in the reference too)")
    print(f"[api] degenerate rows (8 behind the cameras, 8 at zero disparity): outputs finite "
          f"{bool(torch.isfinite(X_deg).all() and torch.isfinite(X_deg_mid).all() and torch.isfinite(x_deg_rect).all())}, "
          f"gates pass {int(gates_deg.sum())} of 16; the good points pass "
          f"{int(gates_ok.sum())} of {n}")
    print(f"[api] fundamental RANSAC: {int(res_f['n_inliers'])} inliers, outliers among them "
          f"{int((inl_f & out).sum())}, inliers missed {int((~inl_f & ~out).sum())}; essential "
          f"RANSAC: {int(res_e['n_inliers'])} inliers ({int((inl_e & out).sum())} outliers), "
          f"recover_pose {int(n_good)} in front: max |dR| {rot_err:.2e}, max |dt| {t_err:.2e}")

    # pyramidal_lk on the rendered pair, card against the CPU
    p0, p1 = build_pyramid(seq.left[0], 3), build_pyramid(seq.left[1], 3)
    pyramidal_lk(p0, p1, xy, valid)
    torch.cuda.synchronize()
    with implicit_syncs() as lk_records:
        tk, ok_k, err_k = pyramidal_lk(p0, p1, xy, valid)
    torch.cuda.synchronize()
    cpu = [tuple(p.cpu() for p in pyr) for pyr in (p0, p1)]
    tc, ok_c, _ = pyramidal_lk(*cpu, xy.cpu(), valid.cpu())
    border = ((xy[:, 0] >= 96) & (xy[:, 0] < SIZE - 96) & (xy[:, 1] >= 96)
              & (xy[:, 1] < SIZE - 96)).cpu()
    both = ok_k.cpu() & ok_c & border
    lk_err = float((tk.cpu() - tc).abs()[both].max())
    print(f"[api] pyramidal_lk frame 0 -> 1, {int(valid.sum())} points: ok on the card "
          f"{int(ok_k.sum())}, on the CPU {int(ok_c.sum())}, flags agree "
          f"{float((ok_k.cpu() == ok_c)[valid.cpu()].float().mean()):.4f}; max |dxy| card vs "
          f"CPU {lk_err:.2e} px on {int(both.sum())} tracks ok in both, >= 96 px from the border")

    # make_slam_step against slam_step, 4 frames from the same state
    cfg = SlamConfig()
    step = make_slam_step(cfg, seq.rig)
    sa = init_state(cfg, (SIZE, SIZE), seed=0, device=dev)
    sb = init_state(cfg, (SIZE, SIZE), seed=0, device=dev)
    tels = []
    for t in range(API_FRAMES):
        sb, tb = slam_step(cfg, seq.rig, sb, seq.left[t], seq.right[t])
        tels.append(tb)
    reset_launches()
    same = True
    for t in range(API_FRAMES):
        sa, ta = step(sa, seq.left[t], seq.right[t])
        same &= all(torch.equal(x, y) for x, y in zip(ta, tels[t]))
    torch.cuda.synchronize()
    launches = read_launches()
    same &= all(torch.equal(x, y) for x, y in zip(sa.features, sb.features))
    print(f"[api] make_slam_step over {API_FRAMES} frames: telemetry and features "
          f"bit-identical to slam_step {same}, launches {launches}")
    from zenslam_tpu_torch.utils import graphs

    progs = {"pyramidal_lk": pyramidal_lk, "build_pyramid": build_pyramid,
             "solve_fundamental_ransac": solve_fundamental_ransac,
             "solve_essential_ransac": solve_essential_ransac,
             "recover_pose_from_essential": recover_pose_from_essential}
    api_calls = {k: graphs.calls(p) for k, p in progs.items()}
    print(f"[api] the library calls ran the captured programs (utils/graphs.py): calls "
          f"(replays) so far {api_calls}")
    sites = sync_sites(records) + sync_sites(lk_records)
    print(f"[api] implicit synchronises of the new functions (triangulation, gates, RANSAC, "
          f"recover_pose, pyramidal_lk; their second calls): {sum(sites.values())}; by line: "
          + (", ".join(f"{k} x{v}" for k, v in sites.most_common()) or "none"))
    print(f"[api] phase {time.perf_counter() - t0:.1f} s")
    require(all(v < 1e-3 for v in errs.values()), f"api: triangulation errors {errs}")
    require(bool(torch.isfinite(X_deg).all() and torch.isfinite(X_deg_mid).all()
                 and torch.isfinite(x_deg_rect).all()), "api: non-finite degenerate outputs")
    require(not bool(gates_deg.any()) and float(gates_ok.float().mean()) > 0.9,
            f"api: gates pass {int(gates_deg.sum())} degenerate rows, "
            f"{int(gates_ok.sum())} of {n} good ones")
    require(bool(res_f["ok"]) and int((~inl_f & ~out).sum()) <= 0.02 * n,
            f"api: fundamental RANSAC missed {int((~inl_f & ~out).sum())} inliers")
    require(rot_err < 1e-2 and t_err < 1e-2, f"api: recovered pose |dR| {rot_err}, |dt| {t_err}")
    require(lk_err <= 1e-3 and int(both.sum()) >= 0.8 * int((valid.cpu() & border).sum()),
            f"api: pyramidal_lk card vs CPU {lk_err} px on {int(both.sum())} tracks")
    require(same and launches == {"lk_fb": 2 * API_FRAMES, "orb": API_FRAMES},
            f"api: make_slam_step identical {same}, launches {launches}")
    require(all(v > 0 for v in api_calls.values()), f"api: not run captured: {api_calls}")
    return launches


def trace_imu(dev, samples: int = 8) -> tuple:
    """``scripts/trace_check.py``'s IMU slice: zero rates and forces, 5 ms
    apart, every sample valid."""
    import torch

    return (torch.zeros((samples, 3), device=dev), torch.zeros((samples, 3), device=dev),
            torch.full((samples,), 0.005, device=dev),
            torch.ones(samples, dtype=torch.bool, device=dev))


def phase_rigs(dev) -> tuple:
    """``[rigs]``: the captured step (``make_slam_step``, as the script runs
    the jitted ``slam_step``) at ``scripts/trace_check.py``'s off-default
    rigs (RIGS), each on RIG_FRAMES frames of the arc rendered on the card at
    its size, with that script's IMU slice: finite poses and both kernels
    launched; then both kernels against their plain versions on the default
    rig's 96x128 pyramids, whose coarse levels (24x32, 12x16) are narrower
    than LK's 21-texel window. Returns ({path: launches}, max LK |dxy|, max
    ORB |dtheta|)."""
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.ops.fast import detect_grid_keypoints
    from zenslam_tpu_torch.ops.image import gaussian_blur
    from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step

    t0 = time.perf_counter()
    paths, small = {}, None
    for name, (h, w, fields) in RIGS.items():
        seq = make_sequence(np.random.default_rng(11), n_frames=RIG_FRAMES, width=w, height=h,
                            motion="arc", speed=0.5, device_render=True, device=dev)
        rig = seq.rig
        if name == "zero_wh":
            rig = rig._replace(left=rig.left._replace(width=0, height=0))
        cfg = SlamConfig(**fields)
        state = init_state(cfg, (h, w), seed=0, device=dev)
        step = make_slam_step(cfg, rig)
        poses, ok = [], []
        reset_launches()
        for t in range(RIG_FRAMES):
            state, tel = step(state, seq.left[t], seq.right[t], imu=trace_imu(dev))
            poses.append(torch.cat([tel.R_cw.reshape(-1), tel.t_cw]))
            ok.append(tel.pose_ok)
        torch.cuda.synchronize()
        launches = read_launches()
        pose = torch.stack(poses).cpu().numpy()
        print(f"[rigs] {name} {w}x{h} {fields}: {RIG_FRAMES} frames with IMU, launches "
              f"{launches}, pose_ok {[bool(x) for x in ok]}, last t_cw "
              f"{np.array2string(pose[-1, 9:], precision=4)}")
        require(np.isfinite(pose).all(), f"rigs {name}: non-finite pose")
        require(launches["lk_fb"] > 0 and launches["orb"] > 0,
                f"rigs {name}: a kernel was not launched ({launches})")
        paths[f"rigs_{name}"] = launches
        small = seq if name == "default" else small
    h, w, _ = RIGS["default"]
    bf16 = torch.bfloat16
    l0, l1 = build_ragged_pyramid_pair(small.left[0], small.left[1], 3, dtype=bf16)
    s0, r0 = build_ragged_pyramid_pair(small.left[0], small.right[0], 3, dtype=bf16)
    print(f"[rigs] LK pyramid level shapes {[tuple(x.shape) for x in l0]}")
    n = 64
    xy, _, valid = detect_grid_keypoints(
        small.left[0], torch.zeros((n, 2), device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
        max_keypoints=n, subpixel=True)
    g = torch.Generator(device=dev).manual_seed(5)
    init = xy + 0.5 * torch.randn(xy.shape, generator=g, device=dev)
    lk_err = check_lk_cases("rigs", {"temporal": (l0, l1, None), "temporal+init": (l0, l1, init),
                                     "stereo": (s0, r0, None)}, xy, valid, LK_STEP_ARGS)
    sm = gaussian_blur(small.left[0], sigma=2.0, radius=4).to(bf16)
    _, _, orb_err = check_orb("rigs", sm, xy, valid)
    print(f"[rigs] phase {time.perf_counter() - t0:.1f} s")
    return paths, lk_err, orb_err


def arc_checks(tag: str, rec: dict, n_frames: int, n_warmup: int) -> tuple:
    """The checks of a ``run_fps`` run filled into ``rec``: finite poses, 2 LK
    + 1 ORB launches per timed frame, pose_ok on >= 90% of the frames after
    the first, ATE < 0.05 m. Returns (pose_ok share, ATE)."""
    import torch

    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions

    tels, seq, launches = rec["tels"], rec["seq"], rec["launches"]
    n = n_frames - n_warmup
    R = torch.stack([t.R_cw for t in tels]).cpu().numpy()
    tt = torch.stack([t.t_cw for t in tels]).cpu().numpy()
    pose_ok = torch.stack([t.pose_ok for t in tels]).cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(tt).all(), f"{tag}: non-finite pose")
    ate = ate_rmse(camera_positions(R, tt), camera_positions(seq.R_lw, seq.t_lw))
    ok_share = float(pose_ok[1:].mean())
    require(launches == {"lk_fb": 2 * n, "orb": n},
            f"{tag}: launches {launches} != 2 LK + 1 ORB per frame over {n} frames")
    require(ok_share >= 0.9, f"{tag}: pose_ok on {ok_share:.3f} < 0.9 of frames")
    require(ate < 0.05, f"{tag}: ATE {ate:.4f} m >= 0.05 m")
    return ok_share, ate


def phase_slice(dev):
    """``slam_step`` alone through ``eval/bench.py:run_fps`` at SIZE² over
    N_FRAMES frames."""
    import torch

    from zenslam_tpu_torch.eval.bench import run_fps

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rec = {}
    fps, tel = run_fps(SIZE, SIZE, N_FRAMES, N_WARMUP, device=dev, record=rec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    n = N_FRAMES - N_WARMUP
    ok_share, ate = arc_checks("slice", rec, N_FRAMES, N_WARMUP)
    print(f"[slice] {n} frames: {1e3 / fps:.2f} ms/frame, {fps:.2f} fps, peak "
          f"{peak:.1f} MiB; pose_ok {ok_share:.3f}, ATE {ate:.5f} m, "
          f"map {int(tel.map_size)}, launches {rec['launches']}")
    return rec["launches"]


def phase_bench(dev):
    """``[bench]``: ``eval/bench.py``'s secondary run, ``run_fps(512, 384,
    60)`` (the captured step), with the slice phase's checks; then both
    kernels against their plain versions on the last frame's inputs, as the
    step passed them (its two LK calls, temporal with init_pts and stereo,
    on the 384x512 to 48x64 pyramids; its ORB describe call), with the lk and
    orb phases' tolerances. A replay runs no Python, so the last frame runs
    again eagerly (``graphs.eager()``) from the state before it, its kernel
    calls recorded, and its telemetry must equal the graphed frame's bit for
    bit. The graphed last frame is then replayed from the same state under
    ``torch.profiler``: its trace must hold 2 LK and 1 ORB kernels, as many
    as the counters added. Returns (launches, max LK |dxy|, max ORB
    |dtheta|)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zenslam_tpu_torch.eval.bench import BASELINE_S_PER_FRAME, run_fps
    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.ops.image import gaussian_blur
    from zenslam_tpu_torch.pipeline import SlamConfig, slam_step, step
    from zenslam_tpu_torch.utils.graphs import eager
    from zenslam_tpu_torch.pipeline.state import pack_telemetry

    t0 = time.perf_counter()
    reset_launches()
    rec, lk_calls, orb_calls = {}, [], []
    fps, tel = run_fps(BENCH_W, BENCH_H, BENCH_FRAMES, device=dev, record=rec)
    ok_share, ate = arc_checks("bench", rec, BENCH_FRAMES, 8)
    print(f"[bench] run_fps({BENCH_W}, {BENCH_H}, {BENCH_FRAMES}): {fps:.2f} fps (vs_baseline "
          f"{fps * BASELINE_S_PER_FRAME:.3f}) on {card_line()}; pose_ok {ok_share:.3f}, ATE "
          f"{ate:.5f} m, tracked {int(tel.n_tracked)}, map {int(tel.map_size)}, launches "
          f"{rec['launches']}")
    seq, t = rec["seq"], BENCH_FRAMES - 1
    with eager(), recorded_calls(step, "lk_ragged", lk_calls), \
            recorded_calls(step, "orb_descriptors_kernel", orb_calls):
        _, tel_e = slam_step(SlamConfig(), seq.rig, rec["before_last"], seq.left[t], seq.right[t])
    same = torch.equal(pack_telemetry(tel_e), rec["packed"][-1])
    print(f"[bench] the last frame again, eagerly from the state before it: telemetry "
          f"{'bit-identical to' if same else 'DIFFERENT from'} the graphed frame's; "
          f"{len(lk_calls)} LK and {len(orb_calls)} ORB calls recorded")
    require(same and len(lk_calls) == 2 and len(orb_calls) == 1,
            f"bench: the eager last frame: telemetry identical {same}, {len(lk_calls)} LK and "
            f"{len(orb_calls)} ORB calls")
    torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, packed = rec["step"].run(rec["before_last"], seq.left[t], seq.right[t])
        torch.cuda.synchronize()
    seen = counted_on_device("bench: the last frame replayed", prof, before)
    same = torch.equal(packed, rec["packed"][-1])
    print(f"[bench] the last frame replayed from the state before it under torch.profiler: "
          f"hand kernels in the trace {seen} (= the counters' increase), telemetry "
          f"{'bit-identical to' if same else 'DIFFERENT from'} the run's")
    require(same and seen == {"lk_fb": 2, "orb": 1},
            f"bench: the replayed last frame: kernels {seen}, telemetry identical {same}")
    last = lk_calls[-2:]
    print(f"[bench] LK pyramid level shapes {[tuple(x.shape) for x in last[0][0][0]]}")
    lk_err = 0.0
    for args, kwargs in last:
        kw = dict(kwargs)
        init = kw.pop("init_pts", None)
        name = "last frame temporal+init" if init is not None else "last frame stereo"
        lk_err = max(lk_err, check_lk_cases("bench", {name: (args[0], args[1], init)},
                                            args[2], args[3], kw))
    require(sum(kw.get("init_pts") is not None for _, kw in last) == 1,
            "bench: the last frame's LK calls are not one temporal (init_pts) and one stereo")
    (img, xy, valid), kwargs = orb_calls[-1]
    needs = kwargs.get("needs")
    rows = valid if needs is None else valid & needs
    sm = gaussian_blur(img, sigma=2.0, radius=4).to(torch.bfloat16)
    print(f"[bench] ORB on the last frame's {tuple(sm.shape)} image, {xy.shape[0]} slots")
    _, _, orb_err = check_orb("bench", sm, xy, rows)
    print(f"[bench] phase {time.perf_counter() - t0:.1f} s")
    return rec["launches"], lk_err, orb_err


def reset_launches():
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief

    lk_ragged.launches = 0
    orb_steered_brief.launches = 0


def read_launches() -> dict:
    from zenslam_tpu_torch.eval.bench import kernel_launches

    return kernel_launches()


@contextlib.contextmanager
def implicit_syncs():
    """Inside the block, record every implicit synchronise that
    ``torch.cuda.set_sync_debug_mode`` reports; yields the list the
    records are appended to, in order."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def is_sync(w) -> bool:
    """Whether the warning record ``w`` reports a synchronise: not the
    one-time notice that ``set_sync_debug_mode`` is a prototype, which also
    says "synchronizing"."""
    text = str(w.message)
    return "synchroniz" in text and "prototype" not in text


# the files of ROADMAP Queue 3 A's table: the front end's synchronising
# lines, 22 a frame in [system] before they were removed
QUEUE3A_FILES = ("cascade.py", "epipolar.py", "rigid.py", "polar.py", "camera.py", "step.py",
                 "fast.py")


def queue3a_syncs(tag: str, records, n_frames: int) -> Counter:
    """Print, per frame and by line, the implicit synchronises among
    ``records`` in the files of ROADMAP Queue 3 A's table, and return
    them."""
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in records
                    if is_sync(w) and Path(w.filename).name in QUEUE3A_FILES)
    print(f"[{tag}] implicit synchronises per frame on the files of ROADMAP Queue 3 A's table: "
          + (", ".join(f"{k} {v / n_frames:.3f}" for k, v in sites.most_common()) or "none"))
    return sites


def sync_sites(records) -> Counter:
    """The synchronise records among ``records``, counted by source line
    (a package's ``__init__.py`` with its package's name)."""
    def site(w) -> str:
        path = Path(w.filename)
        name = f"{path.parent.name}/{path.name}" if path.name == "__init__.py" else path.name
        return f"{name}:{w.lineno}"

    return Counter(site(w) for w in records if is_sync(w))


@contextlib.contextmanager
def backend_spans(system_module, records, spans: list):
    """Note in ``spans`` the (start, end) of ``records`` over each keyframe
    back-end call made inside the block."""
    inner = system_module._keyframe_backend

    def spanned(*args, **kwargs):
        start = len(records)
        try:
            return inner(*args, **kwargs)
        finally:
            spans.append((start, len(records)))

    system_module._keyframe_backend = spanned
    try:
        yield
    finally:
        system_module._keyframe_backend = inner


CAPTURES: list = []     # (program, ms) of each capture in a traced block


@contextlib.contextmanager
def traced(spans: list):
    """Tracing (``utils/tracing.py``) on over the block and off after it: a
    program captured inside carries its device stamps, under a key of its
    own. ``spans`` then holds the block's host spans; its captures (their
    ``graphs.capture`` spans: warm-up + capture) are added to CAPTURES."""
    from zenslam_tpu_torch.utils import tracing

    tracing.enable()
    try:
        yield
        got = tracing.collect()
    finally:
        tracing.disable()
    require(got["dropped"] == 0, f"tracing: {got['dropped']} records lost to a wrapped ring")
    spans += got["host"]
    CAPTURES.extend((x.detail, (x.end - x.start) * 1e-6) for x in got["host"]
                    if x.name == "graphs.capture")


def backend_phases(spans, since: int = 0) -> dict:
    """Each keyframe back-end phase's host ms a keyframe: the ``backend.*``
    spans among ``spans`` that started at ``since`` (perf_counter ns) or
    later, by phase."""
    out = {}
    for x in spans:
        if x.name.startswith("backend.") and x.start >= since:
            out.setdefault(x.name[len("backend."):], []).append((x.end - x.start) * 1e-6)
    return out


def captures_of(program) -> list:
    """The ms of each capture of ``program`` in the traced blocks so far."""
    return [round(ms, 1) for name, ms in CAPTURES if name == program.__name__]


def phase_system(dev):
    import torch

    from zenslam_tpu_torch.eval.bench import run_full_system_fps
    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
    from zenslam_tpu_torch.pipeline import system

    rec, snap, spans, box, host = {}, {}, [], {}, []

    @contextlib.contextmanager
    def timed():
        """Around the timed frames: peak memory, keyframes and host reads
        from here on, the implicit synchronises by back-end call."""
        s = rec["system"]
        torch.cuda.reset_peak_memory_stats()
        snap.update(kf0=s.n_keyframes, reads0=Counter(s.host_reads), t0=time.perf_counter_ns())
        with implicit_syncs() as records, backend_spans(system, records, spans):
            box["records"] = records
            yield

    reset_launches()
    with traced(host):
        fps, _, _ = run_full_system_fps(SIZE, SIZE, SYSTEM_FRAMES, SYSTEM_WARMUP, device=dev,
                                        record=rec, around=timed())
    s, seq, tels, infos, records = (rec["system"], rec["seq"], rec["tels"], rec["infos"],
                                    box["records"])
    cfg, bcfg = s.cfg, s.bcfg
    in_backend = {i for a, b in spans for i in range(a, b)}
    back = sync_sites([r for i, r in enumerate(records) if i in in_backend])
    front = sync_sites([r for i, r in enumerate(records) if i not in in_backend])
    launches = rec["launches"]
    n = SYSTEM_FRAMES - SYSTEM_WARMUP
    timed_rows = infos[rec["n_warmup_rows"]:]
    n_kf = s.n_keyframes - snap["kf0"]
    backend = [i["backend_ms"] for i in timed_rows if i["backend_ms"] > 0]
    phases = backend_phases(host, snap["t0"])
    R = np.stack([t.R_cw for t in tels])
    tt = np.stack([t.t_cw for t in tels])
    pose_ok = np.array([float(t.pose_ok) for t in tels])
    require(len(tels) == SYSTEM_FRAMES, f"system: {len(tels)} telemetry rows != {SYSTEM_FRAMES}")
    require(np.isfinite(R).all() and np.isfinite(tt).all(), "system: non-finite pose")
    ate = ate_rmse(camera_positions(R, tt), camera_positions(seq.R_lw, seq.t_lw))
    ok_share = float(pose_ok[1:].mean())
    runs = [i["ba"].cpu().numpy() for i in infos if i["ba"] is not None]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    reads = Counter(s.host_reads)
    reads.subtract(snap["reads0"])
    print(f"[system] {n} frames (eval/bench.py:run_full_system_fps): {1e3 / fps:.2f} "
          f"ms/frame, {fps:.2f} fps, peak "
          f"{peak:.1f} MiB; backend_ms median {float(np.median(backend)):.2f} over "
          f"{len(backend)} keyframes (min {min(backend):.2f}, max {max(backend):.2f})")
    print(f"[system] phase medians (host ms a keyframe, backend.* spans): {phase_line(phases)}")
    print(f"[system] keyframes {s.n_keyframes} ({n_kf} timed), BA runs {s.n_ba_runs}, vocabulary "
          f"trains {s.n_vocab_trains}, loop closures {s.n_loop_closures}, relocs {s.n_relocs}, "
          f"archive {len(s.archive)} rows ({s.archive.n_reloads} reloads); pose_ok "
          f"{ok_share:.3f}, ATE {ate:.5f} m, launches {launches}")
    print(f"[system] BA rmse before/after/dropped: "
          + "; ".join(f"{a:.4f}/{b:.4f}/{int(c)}" for a, b, c in runs))
    print(f"[system] host reads of device->host copies over the timed frames: {dict(reads)} "
          f"({sum(reads.values()) / n:.3f} per frame; {n_kf} keyframes)")
    nb, nf = sum(back.values()), sum(front.values())
    print(f"[system] implicit synchronises in the keyframe back end: {nb} over {len(spans)} "
          f"keyframes ({nb / max(len(spans), 1):.3f} per keyframe); by line: "
          + ", ".join(f"{k} x{v}" for k, v in back.most_common()))
    print(f"[system] implicit synchronises outside it (the step, telemetry): {nf} "
          f"({nf / n:.3f} per frame); by line: "
          + ", ".join(f"{k} x{v}" for k, v in front.most_common(16)))
    left = queue3a_syncs("system", [r for i, r in enumerate(records) if i not in in_backend], n)
    repeat_system(seq, cfg, bcfg, runs)
    require(launches == {"lk_fb": 2 * n, "orb": n},
            f"system: launches {launches} != 2 LK + 1 ORB per frame over {n} frames")
    require(s.n_keyframes >= 8, f"system: {s.n_keyframes} keyframes < 8")
    require(s.n_vocab_trains >= 2, f"system: {s.n_vocab_trains} vocabulary trains (no retrain)")
    require(s.n_ba_runs == s.n_keyframes - 1 == len(runs),
            f"system: {s.n_ba_runs} BA runs for {s.n_keyframes} keyframes")
    require(all(np.isfinite(r).all() and r[1] <= 1.05 * r[0] and r[2] == 0 for r in runs),
            "system: a BA run raised its rmse by > 5% or dropped observations")
    require(ok_share >= 0.9, f"system: pose_ok on {ok_share:.3f} < 0.9 of frames")
    require(ate < 0.05, f"system: ATE {ate:.4f} m >= 0.05 m")
    require(not left, f"system: implicit synchronises left on Queue 3 A's lines {dict(left)}")
    require(nb == 0, f"system: {nb} implicit synchronises in the keyframe back end "
                     f"({dict(back)}); its programs upload from pinned memory")
    dense = {"R": R, "t": tt, "is_kf": np.array([bool(t.is_keyframe) for t in tels]),
             "kf_t": s.kf_db.t.cpu().numpy(), "kf_valid": s.kf_db.valid.cpu().numpy(),
             "n_keyframes": s.n_keyframes, "n_ba_runs": s.n_ba_runs, "backend_ms": backend,
             "ba_dispatch": phases["ba_dispatch"]}
    return launches, dense


def timed_system_run(s, seq) -> dict:
    """The system phase's frames through the system ``s`` by
    ``eval/bench.py:system_pass`` (SYSTEM_WARMUP frames untimed, the rest
    with ``flush_pipeline`` timed up to a synchronise), the implicit
    synchronises of the timed frames recorded. Returns the launches, seconds,
    frame poses ``R``, ``t``, keyframe flags, pose_ok share after frame 0,
    ATE, BA runs ([rmse before, after, dropped observations]), the timed
    keyframes' ``backend_ms`` and ``ba_dispatch`` host ms (its
    ``backend.ba_dispatch`` spans; the pass runs with tracing on), the
    pass's host spans and the records."""
    import torch

    from zenslam_tpu_torch.eval.bench import system_pass
    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions

    box, host = {}, []

    @contextlib.contextmanager
    def timed():
        torch.cuda.reset_peak_memory_stats()
        box["t0"] = time.perf_counter_ns()
        with implicit_syncs() as records:
            box["records"] = records
            yield

    rec = {}
    with traced(host):
        dt, backend = system_pass(s, seq.left, seq.right, SYSTEM_WARMUP, record=rec,
                                  around=timed())
    tels, infos = rec["tels"], rec["infos"]
    R = np.stack([t.R_cw for t in tels])
    tt = np.stack([t.t_cw for t in tels])
    return {"launches": rec["launches"], "dt": dt, "R": R, "t": tt, "tels": tels,
            "is_kf": np.array([bool(t.is_keyframe) for t in tels]),
            "pose_ok": float(np.array([float(t.pose_ok) for t in tels])[1:].mean()),
            "ate": ate_rmse(camera_positions(R, tt), camera_positions(seq.R_lw, seq.t_lw)),
            "runs": [i["ba"].cpu().numpy() for i in infos if i["ba"] is not None],
            "backend_ms": backend,
            "ba_dispatch": backend_phases(host, box["t0"])["ba_dispatch"],
            "spans": host, "records": box["records"]}


def window_syncs(records, path_part: str) -> Counter:
    """The implicit synchronises among ``records`` in files whose path holds
    ``path_part``, or on the lines of ``system._windowed_ba``, by line."""
    from zenslam_tpu_torch.pipeline import system

    src, first = inspect.getsourcelines(system._windowed_ba_body)
    here = Path(system.__file__).resolve()
    return Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in records if is_sync(w)
        and (path_part in w.filename
             or (Path(w.filename).resolve() == here and first <= w.lineno < first + len(src))))


def phase_system_cg(seq, dev, dense: dict) -> dict:
    """``[system_cg]``: the system phase's run with ``ba_window=CG_WINDOW``
    and ``ba_solver="auto"``, which resolves to the CG solver above 16
    keyframes; checked against the dense run and timed per window against
    the dense solver on the same inputs. Returns the launches."""
    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.utils import graphs
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system

    t0 = time.perf_counter()
    bcfg = BackendConfig(telemetry_lag=3, ba_window=CG_WINDOW)
    require(bcfg.ba_solver == "auto", f"system_cg: ba_solver {bcfg.ba_solver!r}")
    s = create_system(SlamConfig(), bcfg, seq.rig, (SIZE, SIZE))
    cg, dense_calls, windows = [], [], []
    replays0 = {k: graphs.calls(system._WINDOWED_BA, solver=k) for k in ("cg", "dense")}
    with recorded_calls(system, "bundle_adjust_cg", cg), \
            recorded_calls(system, "bundle_adjust", dense_calls), \
            recorded_calls(system, "_windowed_ba", windows, copy=True):
        run = timed_system_run(s, seq)
    replays = {k: graphs.calls(system._WINDOWED_BA, solver=k) - v for k, v in replays0.items()}
    launches, dt, pose_ok, ate, runs, backend, dispatch, records = (
        run[k] for k in ("launches", "dt", "pose_ok", "ate", "runs", "backend_ms", "ba_dispatch",
                         "records"))
    n = SYSTEM_FRAMES - SYSTEM_WARMUP
    solvers = Counter(kw["solver"] for _, kw in windows)
    in_ba = window_syncs(records, f"{os.sep}backend{os.sep}ba.py")
    print(f"[system_cg] ba_window {CG_WINDOW}, ba_solver 'auto': windows by solver "
          f"{dict(solvers)}, bundle_adjust_cg calls {len(cg)}, bundle_adjust calls "
          f"{len(dense_calls)} (Python calls: a captured window's warm-up and capture; its "
          f"replays make none), replays of the captured window by solver {replays}; {n} frames {dt / n * 1e3:.2f} ms/frame; keyframes "
          f"{s.n_keyframes} (dense {dense['n_keyframes']}), BA runs {s.n_ba_runs}; pose_ok "
          f"{pose_ok:.3f}, ATE {ate:.5f} m; launches {launches}")
    print(f"[system_cg] backend_ms median {float(np.median(backend)):.2f} (dense "
          f"{float(np.median(dense['backend_ms'])):.2f}), ba_dispatch median "
          f"{float(np.median(dispatch)):.3f} ms (dense "
          f"{float(np.median(dense['ba_dispatch'])):.3f}); implicit synchronises in the run "
          f"{len(sync_sites(records))} lines, in backend/ba.py and system.py:_windowed_ba: "
          f"{dict(in_ba) or 'none'}")
    print(f"[system_cg] BA rmse before/after/dropped: "
          + "; ".join(f"{a:.4f}/{b:.4f}/{int(c)}" for a, b, c in runs))
    a, kw = windows[-1]

    def window(solver: str, graphed: bool):
        fn = functools.partial(system._windowed_ba, *a, **dict(kw, solver=solver))
        if graphed:
            return fn
        return lambda: eager_call(fn)

    cost, by_op = step_cost({f"{k}{' graphed' if g else ''}": window(k, g)
                             for g in (False, True) for k in ("dense", "cg")})
    print(f"[system_cg] one windowed BA (the last keyframe's inputs, {int(s.kf_db.valid.sum())} "
          f"keyframes in a {CG_WINDOW}-slot window, {kw['iterations']} LM steps) on "
          f"{card_line()}: " + "; ".join(
              f"{k} {c[0]} device kernels and copies, device busy {c[1]:.3f} ms, host "
              f"{c[2]:.2f} ms" for k, c in cost.items())
          + f" (torch.profiler; host: medians of {COST_ROUNDS} alternating rounds)")
    for k, ops in by_op.items():
        print(f"[system_cg] {k}: device ms by operator (top 5): "
              + ", ".join(f"{op[:40]} {v:.3f}" for op, v in ops.most_common(5)))
    put = {k: by_op[k].get("aten::index_put_", 0.0) for k in ("dense", "cg")}
    print(f"[system_cg] one window's index_put_ device ms: " + ", ".join(
        f"{k} {put[k]:.3f} of {cost[k][1]:.3f} busy ({put[k] / cost[k][1]:.4f}), "
        f"segment_reduce {by_op[k].get('aten::segment_reduce', 0.0):.3f}, "
        f"mm {by_op[k].get('aten::mm', 0.0):.3f}" for k in put))
    print(f"[system_cg] phase {time.perf_counter() - t0:.1f} s")
    require(solvers == Counter(cg=s.n_ba_runs) and not dense_calls
            and replays == {"cg": s.n_ba_runs, "dense": 0},
            f"system_cg: windows by solver {dict(solvers)}, {len(cg)} CG calls, "
            f"{len(dense_calls)} dense calls, replays {replays} for {s.n_ba_runs} BA runs")
    require(launches == {"lk_fb": 2 * n, "orb": n},
            f"system_cg: launches {launches} != 2 LK + 1 ORB per frame over {n} frames")
    require(s.n_keyframes == dense["n_keyframes"],
            f"system_cg: {s.n_keyframes} keyframes, the dense run {dense['n_keyframes']}")
    require(s.n_ba_runs == s.n_keyframes - 1 == len(runs),
            f"system_cg: {s.n_ba_runs} BA runs for {s.n_keyframes} keyframes")
    require(all(np.isfinite(r).all() and r[1] <= 1.05 * r[0] for r in runs),
            "system_cg: a BA run raised its rmse by > 5%")
    require(ate < 0.05 and pose_ok >= 0.9, f"system_cg: ATE {ate:.4f} m, pose_ok {pose_ok:.3f}")
    require(not in_ba, f"system_cg: implicit synchronises in backend/ba.py or _windowed_ba "
                       f"{dict(in_ba)}")
    require(put["cg"] < 0.1 * cost["cg"][1],
            f"system_cg: index_put_ {put['cg']:.3f} ms of a CG window's {cost['cg'][1]:.3f}")
    return launches


@contextlib.contextmanager
def worst_residuals(system_module, windows: list):
    """Inside the block, append to ``windows``, for every windowed BA, its
    five worst observations before and after it (keyframe index in the
    window, 0 = newest; landmark index in the compacted problem; px) and
    [robust cost before, after, rmse before, after, accepted LM steps,
    observations]."""
    import torch

    from zenslam_tpu_torch.backend.ba import _residuals_and_weights

    inner = system_module.bundle_adjust

    def top5(p, R, t, xyz):
        r, _, good, *_ = _residuals_and_weights(p, R, t, xyz, 1.0)
        n = torch.where(good, torch.linalg.vector_norm(r, dim=-1), -1.0)
        v, i = torch.topk(n, 5)
        return [(int(p.obs_kf[j]), int(p.obs_lm[j]), round(float(x), 2))
                for j, x in zip(i.tolist(), v.tolist())]

    def logged(p, **kwargs):
        res = inner(p, **kwargs)
        windows.append((top5(p, p.R, p.t, p.xyz), top5(p, res["R"], res["t"], res["xyz"]),
                        [round(float(res[k]), 3) for k in ("cost_before", "cost_after",
                                                            "rmse_before", "rmse_after")]
                        + [int(res["n_accepted"]), int(p.obs_valid.sum())]))
        return res

    system_module.bundle_adjust = logged
    try:
        yield
    finally:
        system_module.bundle_adjust = inner


def run_windows(seq, cfg, bcfg, deterministic: bool = False):
    """One untimed system run over the first REPEAT_FRAMES frames, without
    the flush (so that each window is one the 80-frame run also solves,
    from the same state), eagerly (``graphs.eager()``: the residuals are
    read on the host inside each window): (the BA runs' [rmse_before,
    rmse_after, dropped], the five worst residuals of each window)."""
    import torch

    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.utils.graphs import eager
    from zenslam_tpu_torch.pipeline.system import create_system, process_frame

    windows, runs = [], []
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with eager(), worst_residuals(system, windows):
            s = create_system(cfg, bcfg, seq.rig, (SIZE, SIZE))
            infos = [process_frame(s, seq.left[t], seq.right[t])[1] for t in range(REPEAT_FRAMES)]
            runs = [i["ba"].cpu().numpy() for i in infos if i["ba"] is not None]
    finally:
        torch.use_deterministic_algorithms(False)
    return runs, windows


def scatter_determinism(dev) -> None:
    """Whether a float scatter-add gives the same bits on every run: 20
    repeats of ``index_add_``, of ``index_put_(accumulate=True)`` (what
    ``backend.ba.seg_add_`` uses on CUDA) and of BA's planned sums
    (``backend.ba.seg_sum``, the plan built once as BA builds it per
    window) over 60000 random (6, 6) rows into 16384 slots, as BA's block
    sums do, and of the planned sums into 24 slots (a window's keyframes,
    ~2500 rows each). The planned sums must repeat bit for bit and equal
    ``index_add_`` on the CPU."""
    import torch

    from zenslam_tpu_torch.backend.ba import seg_plan, seg_sum

    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, 16384, (60000,), device=dev, generator=g)
    kf = torch.randint(0, 24, (60000,), device=dev, generator=g)
    keep = torch.rand(60000, device=dev, generator=g) < 0.9
    vals = torch.randn(60000, 6, 6, device=dev, generator=g)
    planned = {"seg_sum (16384 slots)": (idx, seg_plan(16384, idx, keep)),
               "seg_sum (24 slots)": (kf, seg_plan(24, kf, keep))}
    for name, fn in (
            ("index_add_", lambda: torch.zeros(16384, 6, 6, device=dev).index_add_(0, idx, vals)),
            ("index_put_ accumulate", lambda: torch.zeros(16384, 6, 6, device=dev).index_put_(
                (idx,), vals, accumulate=True)),
            *((k, functools.partial(seg_sum, plan, vals)) for k, (_, plan) in planned.items())):
        outs = [fn() for _ in range(20)]
        same = sum(torch.equal(outs[0], o) for o in outs[1:])
        diff = float((torch.stack(outs) - outs[0]).abs().max())
        print(f"[system] {name}: {same} of 19 repeats bit-identical to the first, max |diff| "
              f"{diff:.3e}")
        if name in planned:
            groups = planned[name][0]
            cpu = torch.zeros(outs[0].shape).index_add_(0, groups[keep].cpu(), vals[keep].cpu())
            print(f"[system] {name} against index_add_ on the CPU: max |diff| "
                  f"{float((outs[0].cpu() - cpu).abs().max()):.3e}")
            require(same == 19 and torch.equal(outs[0].cpu(), cpu),
                    f"system: {name} not bit-identical over repeats or to index_add_ on the CPU")


def repeat_system(seq, cfg, bcfg, timed_runs):
    """Run the system's first REPEAT_FRAMES frames again, once as it is and
    once under ``torch.use_deterministic_algorithms``, and print how far
    each BA window's rmse_before differs from the timed run's same window,
    and each window's robust cost, rmse and five worst residuals before and
    after BA."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    scatter_determinism(seq.left.device)
    reps = {name: run_windows(seq, cfg, bcfg, det) for name, det in
            (("again", False), ("deterministic", True))}
    base = np.array([r[0] for r in timed_runs])
    for name, (runs, _) in reps.items():
        b = np.array([r[0] for r in runs])
        if not 0 < len(b) <= len(base):
            print(f"[system] repeat {name}: {len(b)} BA windows, the timed run {len(base)}")
            continue
        print(f"[system] repeat {name} ({REPEAT_FRAMES} frames): max |rmse_before - timed "
              f"run's| {float(np.abs(b - base[:len(b)]).max()):.3e} px over its {len(b)} "
              f"windows (the timed run's first {len(b)} of {len(base)})")
    for w, (before, after, stats) in enumerate(reps["again"][1]):
        print(f"[system] window {w}: robust cost, rmse before/after, accepted LM steps, "
              f"observations {stats}; worst residuals (kf, lm, px) before {before} after {after}")


def kf_ate(kf_db, seq) -> float:
    """Unaligned RMSE of keyframe camera centres against groundtruth (as
    tests/test_loop_closure.py:_kf_ate)."""
    fi, v = kf_db.frame_idx.cpu().numpy(), kf_db.valid.cpu().numpy()
    R, t = kf_db.R.cpu().numpy()[v], kf_db.t.cpu().numpy()[v]
    est = np.einsum("kij,kj->ki", np.transpose(R, (0, 2, 1)), -t)
    gt = np.stack([-seq.R_lw[f].T @ seq.t_lw[f] for f in fi[v]])
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))


@functools.lru_cache(maxsize=None)
def loop_orbit(dev):
    """``tests/test_loop_closure.py``'s 64-frame 320x240 orbit (seed 21,
    pixel noise 0.01, radius 1.0, host render), rendered once for the loop
    phase and the dist phase's (c)."""
    from zenslam_tpu_torch.io.synthetic import make_sequence

    return make_sequence(np.random.default_rng(21), n_frames=64, width=320, height=240,
                         motion="orbit", pixel_noise=0.01, orbit_radius=1.0, device=dev)


def phase_loop(dev):
    import torch

    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

    t0 = time.perf_counter()
    seq = loop_orbit(dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    configs = {
        "off": BackendConfig(ba_every_kf=False, enable_loop_closure=False),
        "on": BackendConfig(ba_every_kf=False, enable_loop_closure=True, bow_branch=32,
                            bow_top_k=5, bow_min_score=0.20, bow_min_frame_gap=15,
                            loop_min_inliers=12)}
    out, launches = {}, {}
    for name, bcfg in configs.items():
        s = create_system(cfg, bcfg, seq.rig, (240, 320))
        reset_launches()
        t1 = time.perf_counter()
        run_system(s, seq.left, seq.right)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches[name] = read_launches()
        out[name] = s
        print(f"[loop] loops {name}: 64 frames in {dt:.2f} s, keyframes {s.n_keyframes}, "
              f"loop closures {s.n_loop_closures}, keyframe ATE {kf_ate(s.kf_db, seq):.5f} m, "
              f"launches {launches[name]}")
        require(launches[name] == {"lk_fb": 128, "orb": 64},
                f"loop {name}: launches {launches[name]} != 2 LK + 1 ORB per frame")
    fired = [d for d in out["on"].loop_debug if d["fired"]]
    print(f"[loop] fired: {fired}; phase {time.perf_counter() - t0:.1f} s")
    ate_off, ate_on = kf_ate(out["off"].kf_db, seq), kf_ate(out["on"].kf_db, seq)
    require(out["on"].n_loop_closures >= 1, "loop: no loop closed")
    require(ate_on < ate_off, f"loop: keyframe ATE with loops {ate_on:.5f} m >= without "
                              f"{ate_off:.5f} m")
    total = Counter()
    for v in launches.values():
        total.update(v)
    return dict(total)


@contextlib.contextmanager
def captured_systems():
    """The systems ``create_system`` makes meanwhile (``app.main`` keeps its
    own), in order."""
    from zenslam_tpu_torch.pipeline import system as psystem

    created = []
    create = psystem.create_system

    def capture(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    psystem.create_system = capture
    try:
        yield created
    finally:
        psystem.create_system = create


def rectifying_rotation(rig) -> np.ndarray:
    """cam0 -> rectified cam0, as ``compute_rectify_maps`` builds it (the
    baseline becomes the x axis); identity for a rig already rectified."""
    R_rl = rig.R_rl.double().cpu().numpy()
    t_rl = rig.t_rl.double().cpu().numpy()
    c1 = -R_rl.T @ t_rl
    ex = c1 / np.linalg.norm(c1)
    ey = np.cross([0.0, 0.0, 1.0], ex)
    ey /= np.linalg.norm(ey)
    return np.stack([ex, ey, np.cross(ex, ey)])


def vio_errors(vio, seq, R_rect) -> tuple:
    """|g - g_true| (m/s²) and the last frame's |v - v_true| (m/s), the truth
    mapped into the SLAM world: the first frame's rectified left camera."""
    from zenslam_tpu_torch.eval.metrics import camera_positions

    R0 = R_rect @ seq.R_lw[0].astype(np.float64)
    g_err = float(np.linalg.norm(vio.gravity_w.cpu().numpy() - R0 @ seq.gravity_w))
    P = camera_positions(seq.R_lw, seq.t_lw)
    dt = float(seq.timestamps[-1] - seq.timestamps[-2])
    v_err = float(np.linalg.norm(vio.v_world.cpu().numpy() - R0 @ (P[-1] - P[-2]) / dt))
    return g_err, v_err


def run_app(tag: str, opts_path, out, dev, extra=(), no_scene: bool = True):
    """``app.main`` on an options file (``--no-scene`` unless ``no_scene``
    is False), its output printed under ``[tag]``; returns (launches, the
    checker's result, keyframes, BA runs, printed text)."""
    import io

    import torch

    from zenslam_tpu_torch import app
    from zenslam_tpu_torch.eval import check_run

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app.main(["--options-file", str(opts_path), "--device", str(dev),
                       *(["--no-scene"] if no_scene else []), *extra])
    torch.cuda.synchronize()
    launches = read_launches()
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            print(f"[{tag}] | {line}")
    require(rc == 0, f"{tag}: exit code {rc}")
    m = re.search(r"keyframes: (\d+), BA runs: (\d+), loop closures: (\d+)", text)
    require(m is not None, f"{tag}: no keyframe line")
    n_kf, n_ba, n_loops = (int(x) for x in m.groups())
    r = check_run.check(str(out))
    print(f"[{tag}] launches {launches}; keyframes {n_kf}, BA runs {n_ba}, loop closures "
          f"{n_loops}; steady {r.get('steady_ms', float('nan')):.2f} ms/frame, "
          f"{r.get('steady_fps', float('nan')):.2f} fps ({r.get('slow_frames')} frames over "
          f"100 ms) on {check_run.card_line()}")
    return launches, r, n_kf, n_ba, text


def phase_app(dev):
    """The shipped EuRoC recipe through the port's app: a synthetic
    EuRoC-layout dataset rendered through options/euroc_camchain.yaml
    (752x480, distorted radtan, strafe at 0.5 m/s, 20 Hz frames, pixel noise
    0.005, APP_FRAMES frames, an imu0/data.csv at 200 Hz), ``app.main`` with
    euroc_mh.yaml's slam and backend sections and ``calibration_file`` set,
    once ``--no-imu`` and once as shipped (IMU), each run checked by the
    port's checker against options/euroc_mh_expected.json; the LK kernel
    against its plain version on the app's first pyramids (rectified, CLAHE,
    752x480: levels 188 and 94 are not whole 16-byte chunks); a checkpoint
    of the IMU run saved after frame APP_CKPT_FRAME and loaded back,
    bit-identical. Returns ({run: launches}, LK max |dxy|)."""
    import tempfile
    from itertools import islice

    import torch
    import yaml

    from zenslam_tpu_torch import app
    from zenslam_tpu_torch.config import load_options
    from zenslam_tpu_torch.io import checkpoint
    from zenslam_tpu_torch.io.calibration import compute_rectify_maps, load_kalibr_yaml
    from zenslam_tpu_torch.io.dataset import FolderReader
    from zenslam_tpu_torch.io.synthetic import export_dataset, make_distorted_sequence
    from zenslam_tpu_torch.ops.fast import detect_grid_keypoints
    from zenslam_tpu_torch.ops.image import clahe, remap
    from zenslam_tpu_torch.ops.lk import build_ragged_pyramid_pair
    from zenslam_tpu_torch.pipeline.system import create_system, process_frame

    here = Path(__file__).resolve().parent
    camchain = here / "options" / "euroc_camchain.yaml"
    t0 = time.perf_counter()
    rig_raw, models = load_kalibr_yaml(str(camchain), device=dev)
    seq = make_distorted_sequence(np.random.default_rng(9), rig_raw, models,
                                  n_frames=APP_FRAMES, motion="strafe", dt=0.05, speed=0.5,
                                  pixel_noise=0.005, device_render=True, with_imu=True)
    launches, checked = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "mav0", Path(tmp) / "out"
        export_dataset(seq, str(root))
        t_export = time.perf_counter() - t0
        recipe = yaml.safe_load((here / "options" / "euroc_mh.yaml").read_text())
        opts_path = Path(tmp) / "euroc_mh.yaml"
        opts_path.write_text(yaml.safe_dump({
            "folder": {"root": str(root), "output": str(out), "calibration_file": str(camchain),
                       "groundtruth_file": str(root / "groundtruth.csv")},
            "slam": recipe["slam"], "backend": recipe["backend"]}))
        print(f"[app] exported {APP_FRAMES} stereo frames 752x480 (distorted radtan) and "
              f"{int(seq.imu_mask.sum())} IMU rows in {t_export:.1f} s; recipe slam "
              f"{recipe['slam']}, backend {recipe['backend']}, imu_file "
              f"{recipe['folder'].get('imu_file')}")
        for run, extra in (("app_no_imu", ("--no-imu",)), ("app", ())):
            with captured_systems() as created:
                launches[run], r, n_kf, n_ba, text = run_app(run, opts_path, out, dev, extra)
            checked[run] = r
            exp = r.get("exp", {})
            print(f"[{run}] checker: ATE {r.get('ate_mm', float('nan')):.1f} mm (bound "
                  f"{exp.get('ate_bound_mm')}), RPE {r.get('rpe_mm', float('nan')):.1f} mm "
                  f"(bound {exp.get('rpe_bound_mm')}), mean tracked "
                  f"{r.get('mean_tracked', 0):.1f} (min {exp.get('min_tracked_mean')}), "
                  f"problem-frame share {r.get('problem_fraction', 1):.3f} (max "
                  f"{exp.get('max_problem_frame_fraction')})")
            require(not r["failures"], f"{run}: checker failed: {r['failures']}")
            require(launches[run] == {"lk_fb": 2 * APP_FRAMES, "orb": APP_FRAMES},
                    f"{run}: launches {launches[run]} != 2 LK + 1 ORB per frame over "
                    f"{APP_FRAMES} frames")
            require(n_ba == n_kf - 1 and n_kf >= 3, f"{run}: {n_ba} BA runs for {n_kf} keyframes")
            require(("IMU stream found" in text) == (run == "app"),
                    f"{run}: the VIO branch was {'off' if run == 'app' else 'on'}")
        vio = created[-1].state.vio
        g_err, v_err = vio_errors(vio, seq, rectifying_rotation(rig_raw))
        print(f"[app] IMU run: gravity ok {bool(vio.gravity_ok)} with "
              f"{int(vio.grav_valid.sum())} samples, |g - g_true| {g_err:.4f} m/s^2 (bound 0.5), "
              f"last |v - v_gt| {v_err:.4f} m/s, in the SLAM world")
        require(bool(vio.gravity_ok) and g_err < 0.5, f"app: gravity error {g_err:.3f}")

        opts = load_options(str(opts_path))
        maps = compute_rectify_maps(rig_raw, models)
        mx = [torch.from_numpy(m).to(dev) for m in maps[:4]]

        def prep(frame):
            return (remap(app.upload(frame.left, dev), mx[0], mx[1]),
                    remap(app.upload(frame.right, dev), mx[2], mx[3]))

        frames = list(islice(FolderReader(str(root)).frames(), 2))
        (a0, b0), (a1, _) = (prep(f) for f in frames)
        a0, b0, a1 = (clahe(x, clip_limit=opts.slam.clahe_clip) for x in (a0, b0, a1))
        bf16 = torch.bfloat16
        L = opts.slam.pyramid_levels
        l0, l1 = build_ragged_pyramid_pair(a0, a1, L, dtype=bf16)
        s0, r0 = build_ragged_pyramid_pair(a0, b0, L, dtype=bf16)
        print(f"[app] LK pyramid level widths {[int(x.shape[1]) for x in l0]}")
        N = opts.slam.max_keypoints
        xy, _, valid = detect_grid_keypoints(
            a0, torch.zeros((N, 2), device=dev), torch.zeros(N, dtype=torch.bool, device=dev),
            max_keypoints=N, subpixel=True)
        g = torch.Generator(device=dev).manual_seed(5)
        init = xy + 0.5 * torch.randn(xy.shape, generator=g, device=dev)
        args = dict(radius=opts.slam.klt_radius, iters=(5, 3, 3, 3), bwd_levels=1,
                    compute_err=False, fb_threshold=1.0)
        lk_err = check_lk_cases("app", {"temporal": (l0, l1, None),
                                        "temporal+init": (l0, l1, init),
                                        "stereo": (s0, r0, None)}, xy, valid, args)

        ck = Path(tmp) / "system.npz"
        s = create_system(opts.slam, opts.backend, maps.rig_rectified, (480, 752), device=dev)
        for f in islice(FolderReader(str(root)).frames_prefetch(), APP_CKPT_FRAME):
            process_frame(s, *prep(f), imu=app.upload_imu(f, dev))
        checkpoint.save_system(str(ck), s)
        s2 = checkpoint.load_system(str(ck), opts.slam, opts.backend, maps.rig_rectified,
                                    (480, 752), device=dev)
        same, la = systems_identical(s, s2)
        n_vio = sum(n.startswith("['state'].vio.") for n, _ in la)
        vio = s.state.vio
        print(f"[app] checkpoint after frame {APP_CKPT_FRAME}: {len(la)} tensors and numbers "
              f"of state ({n_vio} of its VioState: {int(vio.grav_valid.sum())} gravity samples, "
              f"history {int(vio.hist_n)}), keyframe DB ({s.n_keyframes} keyframes), BoW DB, "
              f"vocabulary and telemetry queue ({len(s._tel_queue)}), {len(s.edge_i)} edges, "
              f"archive {len(s.archive)} rows: {'bit-identical' if same else 'DIFFERENT'} after "
              f"load_system ({ck.stat().st_size / 2 ** 20:.1f} MiB)")
        require(same and n_vio == 13, "app: checkpoint round trip on the card is not "
                                      "bit-identical or lacks the VioState")
        print(f"[app] phase {time.perf_counter() - t0:.1f} s")
        launches.update(phase_app_viz(opts_path, out, Path(tmp), dev, checked["app"]))
    return launches, lk_err


def read_png_rgb(path) -> np.ndarray:
    """An 8-bit RGB PNG with filter 0 on every row (what
    ``io/synthetic.py:write_png`` writes), decoded with the standard
    library: (H, W, 3) uint8."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    require(depth == 8 and color == 2, f"{path}: depth {depth}, colour type {color} (not RGB8)")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    require(not raw[:, 0].any(), f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def phase_app_viz(opts_path, app_out: Path, tmp: Path, dev, app_r: dict) -> dict:
    """``[app_viz]``: the app phase's folder and recipe through ``app.main``
    with ``--viz`` and ``--save-vocab``, without ``--no-scene`` (the card's
    machine may lack matplotlib: the scene PNG and the timing plots are then
    skipped, the rest written); then the saved vocabulary reloaded on the
    card and a 20-frame run with ``backend.vocab_file`` set to it
    (``[app_vocab]``). ``app_r``: the checker's result of the ``[app]`` run
    (as shipped, with IMU), whose output folder is ``app_out``. Returns
    {run: launches}."""
    import torch
    import yaml

    from zenslam_tpu_torch.analysis import overlays
    from zenslam_tpu_torch.backend.bow import load_vocabulary

    t0 = time.perf_counter()
    out, vocab_path = tmp / "out_viz", tmp / "vocab.npz"
    opts = yaml.safe_load(Path(opts_path).read_text())
    opts["folder"]["output"] = str(out)
    viz_opts = tmp / "euroc_mh_viz.yaml"
    viz_opts.write_text(yaml.safe_dump(opts))
    inner, calls = overlays.save_keyframe_overlays, []

    def timed(viz_dir, frame_idx, left, right, snap, prev_snap=None):
        t1 = time.perf_counter()
        entry = inner(viz_dir, frame_idx, left, right, snap, prev_snap)
        calls.append((frame_idx, left, right, snap, (time.perf_counter() - t1) * 1e3))
        return entry

    overlays.save_keyframe_overlays = timed
    try:
        with captured_systems() as created:
            launches, r, n_kf, n_ba, text = run_app(
                "app_viz", viz_opts, out, dev, ("--viz", "--save-vocab", str(vocab_path)),
                no_scene=False)
    finally:
        overlays.save_keyframe_overlays = inner
    require((out / "viz").is_dir() and calls, "app_viz: no overlay written")
    viz = sorted(p.name for p in (out / "viz").iterdir())
    spatial = [f for f in viz if f.startswith("spatial_")]
    temporal = [f for f in viz if f.startswith("temporal_")]
    report = (out / "diagnostics.html").read_text() if (out / "diagnostics.html").is_file() else ""
    frame_idx, left, right, snap, _ = calls[-1]
    png = read_png_rgb(out / "viz" / spatial[-1])
    rgb = png / 255.0
    green = int(((rgb[..., 1] > 0.6) & (rgb[..., 0] < 0.5) & (rgb[..., 2] < 0.5)).sum())
    redrawn = overlays.draw_spatial_overlay(*overlays.to_host(
        left, right, snap.xy, snap.uv_r, snap.stereo_ok, snap.valid))
    viz_line = [ln for ln in text.splitlines() if ln.startswith("viz: timing plots")]
    scene_line = [ln for ln in text.splitlines() if ln.startswith("scene")]
    traj = [np.loadtxt(d / "trajectory.csv", delimiter=",") for d in (app_out, out)]
    d_traj = float(np.abs(traj[0] - traj[1]).max()) if traj[0].shape == traj[1].shape \
        else float("inf")
    d_ate = abs(r.get("ate_mm", float("inf")) - app_r.get("ate_mm", float("nan")))
    ms = [c[-1] for c in calls]
    print(f"[app_viz] {len(spatial)} spatial and {len(temporal)} temporal PNGs for {n_kf} "
          f"keyframes; last {spatial[-1]} {png.shape}, {green} green marker pixels, "
          f"{'bit-identical to' if np.array_equal(png, redrawn) else 'DIFFERENT from'} "
          f"draw_spatial_overlay on frame {frame_idx}'s snapshot and images; {viz_line}; "
          f"{scene_line}")
    print(f"[app_viz] checker ATE {r.get('ate_mm', float('nan')):.4f} mm against [app]'s "
          f"{app_r.get('ate_mm', float('nan')):.4f} (|d| {d_ate:.4f}, bound 0.5), trajectory "
          f"max |d| {d_traj:.3e} m; save_keyframe_overlays host ms per keyframe median "
          f"{float(np.median(ms)):.2f} (min {min(ms):.2f}, max {max(ms):.2f}); steady "
          f"{r.get('steady_ms', float('nan')):.2f} ms/frame against [app]'s "
          f"{app_r.get('steady_ms', float('nan')):.2f}")
    require(launches == {"lk_fb": 2 * APP_FRAMES, "orb": APP_FRAMES},
            f"app_viz: launches {launches} != 2 LK + 1 ORB per frame over {APP_FRAMES} frames")
    require(not r["failures"], f"app_viz: checker failed: {r['failures']}")
    require(report and all(f in report for f in spatial), "app_viz: diagnostics.html missing or "
                                                          "not naming every spatial PNG")
    require(len(spatial) == len(calls) == n_kf and len(temporal) == n_kf - 1,
            f"app_viz: {len(spatial)} spatial / {len(temporal)} temporal PNGs for {n_kf} "
            "keyframes")
    require(png.shape == (480, 2 * 752, 3) and green > 50,
            f"app_viz: last overlay {png.shape} with {green} green pixels")
    require(np.array_equal(png, redrawn), "app_viz: the PNG is not the redrawn overlay")
    require(len(viz_line) == 1, "app_viz: no 'viz: timing plots written / skipped' line")
    require((out / "scene.ply").is_file() and (out / "scene.html").is_file(),
            "app_viz: scene.ply / scene.html missing")
    require(d_ate <= 0.5, f"app_viz: ATE {d_ate:.4f} mm from the [app] run (bound 0.5)")

    require("vocabulary saved:" in text, "app_viz: the run trained no vocabulary to save")
    vocab = load_vocabulary(str(vocab_path), device=dev)
    same = type(vocab) is type(created[-1].vocab) and all(
        torch.equal(a, b) for a, b in zip(vocab, created[-1].vocab))
    print(f"[app_viz] vocabulary {vocab_path.name} ({vocab_path.stat().st_size} bytes, "
          f"{type(vocab).__name__} of {[tuple(x.shape) for x in vocab]}) reloaded on the card: "
          f"{'identical to' if same else 'DIFFERENT from'} the run's")
    require(same, "app_viz: the reloaded vocabulary differs from the saved one")
    opts["folder"]["output"] = str(tmp / "out_vocab")
    opts["backend"]["vocab_file"] = str(vocab_path)
    vocab_opts = tmp / "euroc_mh_vocab.yaml"
    vocab_opts.write_text(yaml.safe_dump(opts))
    lv, rv, *_ = run_app("app_vocab", vocab_opts, tmp / "out_vocab", dev, ("--take", "20"))
    require(lv == {"lk_fb": 40, "orb": 20}, f"app_vocab: launches {lv}")
    print(f"[app_viz] phase {time.perf_counter() - t0:.1f} s")
    return {"app_viz": launches, "app_vocab": lv}


def systems_identical(s, s2) -> tuple:
    """Whether two systems (one saved, one loaded back) hold the same state,
    tables, vocabulary, telemetry queue, edges and archive, bit for bit;
    and the state trees' named leaves."""
    import torch

    from zenslam_tpu_torch.io import checkpoint

    trees = [{"state": x.state, "kf_db": x.kf_db, "bow_db": x.bow_db,
              "vocab": x.vocab, "queue": [q[1] for q in x._tel_queue]} for x in (s, s2)]
    la, lb = (checkpoint._flatten(t) for t in trees)
    same = [n for n, _ in la] == [n for n, _ in lb] and all(
        (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y))
        if isinstance(x, torch.Tensor) else x == y for (_, x), (_, y) in zip(la, lb))
    same &= all(np.array_equal(p.numpy(), q.numpy())
                for (p, _, _), (q, _, _) in zip(s._tel_queue, s2._tel_queue))
    same &= (s.edge_i == s2.edge_i and s.edge_j == s2.edge_j and s.edge_w == s2.edge_w
             and all(np.array_equal(checkpoint._to_numpy(x), y)
                     for x, y in zip(s.edge_R + s.edge_t, s2.edge_R + s2.edge_t)))
    a, b = s.archive, s2.archive
    same &= (all(np.array_equal(getattr(a, k), getattr(b, k))
                 for k in ("xyz", "desc", "color", "dormant", "_slot_row", "_slot_gen"))
             and a._row_key == b._row_key and a.reload_keys == b.reload_keys)
    return same, la


def vio_branch_cost(opts_path, k: int, dev, pairs: int = COST_ROUNDS) -> dict:
    """What the VIO branch adds to one ``slam_step``: a system of the options
    file runs frames 0..k-1 of its folder as the app does (rectified, with
    IMU); then frame k, rectified, is stepped from that state with its IMU
    slice and without: device kernels and copies and their busy ms
    (``torch.profiler``, one call each after a warm call), and host ms
    (perf_counter around the call and a synchronise, ``pairs`` alternating
    pairs, medians; ``step_cost``). Returns {name: (count, busy ms, ms)}."""
    from itertools import islice

    import torch

    from zenslam_tpu_torch import app
    from zenslam_tpu_torch.config import load_options
    from zenslam_tpu_torch.io.calibration import compute_rectify_maps, load_kalibr_yaml
    from zenslam_tpu_torch.io.dataset import FolderReader
    from zenslam_tpu_torch.ops.image import remap
    from zenslam_tpu_torch.pipeline.step import slam_step
    from zenslam_tpu_torch.pipeline.system import create_system, process_frame

    opts = load_options(str(opts_path))
    maps = compute_rectify_maps(*load_kalibr_yaml(opts.folder.calibration_file, device=dev))
    mx = [torch.from_numpy(m).to(dev) for m in maps[:4]]

    def prep(f):
        return (remap(app.upload(f.left, dev), mx[0], mx[1]),
                remap(app.upload(f.right, dev), mx[2], mx[3]), app.upload_imu(f, dev))

    frames = islice(FolderReader(opts.folder.root).frames(), k + 1)
    system = None
    for i, f in enumerate(frames):
        il, ir, imu = prep(f)
        if i == k:
            break
        if system is None:
            system = create_system(opts.slam, opts.backend, maps.rig_rectified,
                                   tuple(il.shape), device=dev)
        process_frame(system, il, ir, imu=imu)
    require(int(imu[3].sum()) > 0, "fulldress: the timed frame has no IMU samples")
    cost, _ = step_cost({name: functools.partial(slam_step, system.cfg, system.rig, system.state,
                                                 il, ir, imu=x)
                         for name, x in (("imu", imu), ("no_imu", None))}, pairs)
    return cost


def eager_call(fn):
    """``fn()`` with every captured program run eagerly (``graphs.eager()``)."""
    from zenslam_tpu_torch.utils.graphs import eager

    with eager():
        return fn()


def step_cost(steps: dict, pairs: int = COST_ROUNDS) -> tuple:
    """Each of two step functions {name: fn} measured alike: device kernels
    and copies and their busy ms (``torch.profiler``, one call each after a
    warm call), device ms by operator, and host ms (perf_counter around the
    call and a synchronise, ``pairs`` alternating pairs, medians). Returns
    ({name: (count, busy ms, ms)}, {name: Counter(operator: device ms)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out, ms, by_op = {}, {name: [] for name in steps}, {}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = (len(dev_events), sum(e.time_range.elapsed_us() for e in dev_events) / 1e3)
        by_op[name] = Counter({e.key: getattr(e, "device_time_total", 0.0) / 1e3
                               for e in prof.key_averages()})
    names = list(steps)
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            steps[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (*out[name], float(np.median(ms[name]))) for name in steps}, by_op


def phase_fulldress(dev):
    """e2e_fulldress.py's default dataset through the port's app with the
    IMU stream and pose fusion, and again ``--no-imu``; its ``--hard``
    dataset with the hard slam flags (see the module docstring). Returns
    the launches of the IMU run and of the hard run."""
    import tempfile

    import yaml

    from zenslam_tpu_torch.eval import fulldress

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        roots = {False: Path(tmp) / "fulldress", True: Path(tmp) / "fulldress_hard"}
        seqs = {}
        for hard, root in roots.items():
            t1 = time.perf_counter()
            seqs[hard] = fulldress.build_dataset(str(root), FULLDRESS_FRAMES, hard=hard,
                                                 device=dev)
            print(f"[fulldress] rendered, distorted and exported {FULLDRESS_FRAMES} stereo "
                  f"frames 1024x1024 with IMU"
                  f"{' and the photometric set ' + str(fulldress.PHOTOMETRIC) if hard else ''}"
                  f" in {time.perf_counter() - t1:.1f} s")
        seq = seqs[False]
        runs = {}
        fused = {"use_pose_fusion": True}
        with captured_systems() as created:
            for run, extra, slam, hard in (("fulldress", (), fused, False),
                                           ("fulldress_no_imu", ("--no-imu",), fused, False),
                                           ("fulldress_lines", (), fulldress.HARD_SLAM, True)):
                root = roots[hard]
                out = Path(tmp) / run
                opts_path = Path(tmp) / f"{run}.yaml"
                opts_path.write_text(yaml.safe_dump({
                    "folder": {"root": str(root), "output": str(out),
                               "calibration_file": str(root / "camchain.yaml"),
                               "groundtruth_file": str(root / "groundtruth.csv")},
                    "slam": slam,
                    "backend": {"ba_every_kf": True, "enable_loop_closure": True}}))
                with implicit_syncs() as records:
                    launches, r, n_kf, n_ba, _ = run_app(run, opts_path, out, dev, extra)
                with open(out / "frame_data.csv", newline="") as f:
                    rows = list(csv.DictReader(f))
                runs[run] = (launches, r, records, rows, created[-1])
        launches, r, records, rows, system = runs["fulldress"]
        ok = np.array([row["pose_ok"] == "True" for row in rows])
        inertial = sum(row["pose_method"] == "4" and row["pose_ok"] == "True" for row in rows)
        vio = system.state.vio
        g_err, v_err = vio_errors(vio, seq, rectifying_rotation(seq.rig))
        sites = sync_sites(records)
        in_vio = sync_sites([w for w in records if "/imu/" in w.filename
                             or w.filename.endswith("estimation/fusion.py")])
        print(f"[fulldress] ATE {r.get('ate_mm', float('nan')):.1f} mm (bound 100), RPE "
              f"{r.get('rpe_mm', float('nan')):.1f} mm; pose_ok {ok[1:].mean():.3f}; gravity "
              f"ok {bool(vio.gravity_ok)} with {int(vio.grav_valid.sum())} samples, "
              f"|g - g_true| {g_err:.4f} m/s^2; last |v - v_gt| {v_err:.4f} m/s; inertial "
              f"candidate won the fusion on {inertial} of {len(rows)} frames")
        steady = {k: v[1].get("steady_ms", float("nan")) for k, v in runs.items()}
        print(f"[fulldress] steady ms/frame with IMU {steady['fulldress']:.2f}, without "
              f"{steady['fulldress_no_imu']:.2f}")
        _, r_hard, _, rows_hard, _ = runs["fulldress_lines"]
        n_lines = [int(row["n_lines"]) for row in rows_hard]
        print(f"[fulldress_lines] e2e_fulldress.py's --hard dataset "
              f"({fulldress.PHOTOMETRIC}) and slam flags {fulldress.HARD_SLAM} with IMU: ATE "
              f"{r_hard.get('ate_mm', float('nan')):.1f} mm (bound 150), RPE "
              f"{r_hard.get('rpe_mm', float('nan')):.1f} mm, steady "
              f"{steady['fulldress_lines']:.2f} ms/frame; keylines per frame max "
              f"{max(n_lines)}, line map at the end {rows_hard[-1]['line_map_size']}")
        n = sum(sites.values())
        print(f"[fulldress] implicit synchronises in the IMU run: {n} ({n / len(rows):.3f} per "
              f"frame); by line: " + ", ".join(f"{k} x{v}" for k, v in sites.most_common(16)))
        print(f"[fulldress] of them in imu/ or estimation/fusion.py: {dict(in_vio)}")
        queue3a_syncs("fulldress", records, len(rows))
        k = FULLDRESS_FRAMES // 2
        cost = vio_branch_cost(Path(tmp) / "fulldress.yaml", k, dev)
        (k_imu, busy_imu, ms_imu), (k_plain, busy_plain, ms_plain) = cost["imu"], cost["no_imu"]
        print(f"[fulldress] one slam_step on frame {k} from the state before it, with IMU / "
              f"without: device "
              f"kernels and copies {k_imu} / {k_plain} (torch.profiler; the VIO branch adds "
              f"{k_imu - k_plain}), device busy {busy_imu:.3f} / {busy_plain:.3f} ms, host "
              f"{ms_imu:.2f} / {ms_plain:.2f} ms (median of {COST_ROUNDS} alternating pairs; the VIO "
              f"branch {ms_imu - ms_plain:.2f} ms)")
        for run, bound in (("fulldress", 100.0), ("fulldress_lines", 150.0)):
            ate = runs[run][1].get("ate_mm", float("inf"))
            require(ate < bound, f"{run}: ATE {ate} mm >= {bound} mm")
        require(bool(vio.gravity_ok) and g_err < 0.5, f"fulldress: gravity error {g_err:.3f}")
        require(not in_vio, f"fulldress: implicit synchronises in the VIO modules {in_vio}")
        for run, (lc, *_rest) in runs.items():
            k = 4 if run == "fulldress_lines" else 2
            require(lc == {"lk_fb": k * FULLDRESS_FRAMES, "orb": FULLDRESS_FRAMES},
                    f"{run}: launches {lc} != {k} LK + 1 ORB per frame")
    print(f"[fulldress] phase {time.perf_counter() - t0:.1f} s")
    return {"fulldress": launches, "fulldress_lines": runs["fulldress_lines"][0]}


@contextlib.contextmanager
def recorded_calls(module, name: str, calls: list, copy: bool = False):
    """Inside the block, the calls of ``module.name`` are appended to
    ``calls`` as (args, kwargs); with ``copy``, the arguments' tensors
    copied (``graphs.fresh``: a captured step's state is its buffers, which
    the next frame overwrites)."""
    from zenslam_tpu_torch.utils.graphs import fresh

    inner = getattr(module, name)

    def recorded(*args, **kwargs):
        calls.append((fresh(args), kwargs) if copy else (args, kwargs))
        return inner(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def corridor_plane_share(line_map) -> tuple:
    """(share of the mapped keyline endpoints within 10 cm of a corridor
    plane: wall z=6, floor y=1.5, ceiling y=-1.2; their count)."""
    pts = line_map.xyz[line_map.valid].reshape(-1, 3).cpu().numpy()
    d = np.minimum(np.abs(pts[:, 2] - 6.0),
                   np.minimum(np.abs(pts[:, 1] - 1.5), np.abs(pts[:, 1] + 1.2)))
    return (float((d < 0.10).mean()) if len(pts) else 0.0), len(pts)


def phase_lines(dev):
    """Keylines on the card (see the module docstring): (a) the step with
    ``use_keylines`` (``slam_step`` over the warm-up frames, the captured
    step from the last of them on) on a 1024x1024 strafe of the corridor with stripes;
    (b) the keylines recipe through ``app.main``. Returns {path: launches}."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step, slam_step
    from zenslam_tpu_torch.utils.graphs import fresh

    t0 = time.perf_counter()
    seq = make_sequence(np.random.default_rng(11), n_frames=LINES_FRAMES, width=SIZE,
                        height=SIZE, motion="strafe", with_lines=True, device_render=True,
                        device=dev)
    torch.cuda.synchronize()
    print(f"[lines] rendered {LINES_FRAMES} stereo frames {SIZE}x{SIZE} (strafe, corridor "
          f"with stripes) in {time.perf_counter() - t0:.1f} s")
    cfg_on = SlamConfig(use_keylines=True)
    n = LINES_FRAMES - LINES_WARMUP
    res = {}
    for name, cfg in (("lines", cfg_on), ("no_lines", SlamConfig())):
        state = init_state(cfg, (SIZE, SIZE), seed=0, device=dev)
        step = make_slam_step(cfg, seq.rig)
        tels = []
        with implicit_syncs() as records:
            for t in range(LINES_WARMUP):   # eager, the last one through its capture
                run = step if t == LINES_WARMUP - 1 else functools.partial(slam_step, cfg,
                                                                           seq.rig)
                state, tel = run(state, seq.left[t], seq.right[t])
                tels.append(tel)
            torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        for t in range(LINES_WARMUP, LINES_FRAMES - 1):
            state, tel = step(state, seq.left[t], seq.right[t])
            tels.append(tel)
        before_last = fresh(state)
        state, tel = step(state, seq.left[-1], seq.right[-1])
        tels.append(tel)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        R = torch.stack([x.R_cw for x in tels]).cpu().numpy()
        tt = torch.stack([x.t_cw for x in tels]).cpu().numpy()
        ate = ate_rmse(camera_positions(R, tt), camera_positions(seq.R_lw, seq.t_lw))
        res[name] = (read_launches(), dt / n * 1e3, tels, state, before_last, records, ate)
    launches, ms, tels, state, before_last, records, ate = res["lines"]
    ok = torch.stack([x.pose_ok for x in tels]).cpu().numpy()
    n_lines = torch.stack([x.n_lines for x in tels]).cpu().numpy()
    n_tri = torch.stack([x.n_line_triangulated for x in tels]).cpu().numpy()
    ok_share = float(ok[1:].mean())
    share, n_ep = corridor_plane_share(state.line_map)
    map_size = int(state.line_map.valid.sum())
    sites = sync_sites(records)
    in_lines = sync_sites([w for w in records if w.filename.endswith(
        ("ops/lines.py", "pipeline/lines_step.py"))])
    print(f"[lines] the captured step with keylines, {n} frames: {ms:.2f} ms/frame "
          f"({res['no_lines'][1]:.2f} with keylines off, same frames, same call) on "
          f"{card_line()}; pose_ok {ok_share:.3f}, ATE {ate:.5f} m (keylines off "
          f"{res['no_lines'][6]:.5f} m), launches {launches}")
    print(f"[lines] keylines per frame min/median/max after frame 0 {int(n_lines[1:].min())}/"
          f"{float(np.median(n_lines[1:])):.0f}/{int(n_lines.max())}, triangulated max "
          f"{int(n_tri.max())}, line map {map_size}; {share:.3f} of its {n_ep} endpoints within "
          f"10 cm of a corridor plane")
    n_sync = sum(sites.values())
    print(f"[lines] implicit synchronises over the {LINES_WARMUP} warm-up frames: {n_sync} "
          f"({n_sync / LINES_WARMUP:.3f} per frame); by line: "
          + ", ".join(f"{k} x{v}" for k, v in sites.most_common(16)))
    print(f"[lines] of them in ops/lines.py or pipeline/lines_step.py: {dict(in_lines)}")

    # the LK kernel against its plain version on the last frame's endpoint
    # batches, with the arguments the step passed
    from zenslam_tpu_torch.pipeline import step

    calls = []
    with recorded_calls(step, "lk_ragged", calls):
        slam_step(cfg_on, seq.rig, before_last, seq.left[-1], seq.right[-1])
    torch.cuda.synchronize()
    L2 = 2 * cfg_on.max_keylines
    ends = [c for c in calls if c[0][2].shape[0] == L2]
    require(len(calls) == 4 and len(ends) == 2, f"lines: {len(calls)} LK calls in a step, "
                                                 f"{len(ends)} of {L2} endpoints")
    lk_err = 0.0
    for name, (args, kwargs) in zip(("endpoints temporal+init", "endpoints stereo"), ends):
        kw = dict(kwargs)
        init = kw.pop("init_pts", None)
        require((name == "endpoints stereo") == (init is None), f"lines: {name} init_pts")
        lk_err = max(lk_err, check_lk_cases("lines", {name: (args[0], args[1], init)},
                                            args[2], args[3], kw))

    k = LINES_FRAMES - 1
    cost, by_op = step_cost({name: functools.partial(slam_step, c, seq.rig, before_last,
                                                     seq.left[k], seq.right[k])
                             for name, c in (("lines", cfg_on),
                                             ("no_lines", cfg_on._replace(use_keylines=False)))})
    added = by_op["lines"]
    added.subtract(by_op["no_lines"])
    print("[lines] device ms the keyline branch adds to that step, by operator "
          "(torch.profiler, top 8): " + ", ".join(f"{k[:48]} {v:.3f}" for k, v in
                                                  added.most_common(8)))
    (k_on, busy_on, ms_on), (k_off, busy_off, ms_off) = cost["lines"], cost["no_lines"]
    print(f"[lines] one slam_step on frame {k} from the state before it, keylines on / off: "
          f"device kernels and copies {k_on} / {k_off} (torch.profiler; the keyline branch "
          f"adds {k_on - k_off}), device busy {busy_on:.3f} / {busy_off:.3f} ms, host "
          f"{ms_on:.2f} / {ms_off:.2f} ms (median of {COST_ROUNDS} alternating pairs; the branch "
          f"{ms_on - ms_off:.2f} ms)")
    require(launches == {"lk_fb": 4 * n, "orb": n},
            f"lines: launches {launches} != 4 LK + 1 ORB per frame over {n} frames")
    require(res["no_lines"][0] == {"lk_fb": 2 * n, "orb": n},
            f"lines: keylines off launches {res['no_lines'][0]}")
    require(ok_share >= 0.9, f"lines: pose_ok on {ok_share:.3f} < 0.9 of frames")
    require(ate < 0.05, f"lines: ATE {ate:.4f} m >= 0.05 m")
    require(int(n_lines[1:].min()) >= 8, f"lines: {int(n_lines[1:].min())} keylines < 8")
    require(map_size >= 4, f"lines: line map {map_size} < 4")
    require(share > 0.6, f"lines: {share:.3f} <= 0.6 of the endpoints on a plane")
    require(not in_lines, f"lines: implicit synchronises in the keyline modules {in_lines}")
    paths = {"lines": launches}
    paths.update(phase_lines_app(dev))
    print(f"[lines] phase {time.perf_counter() - t0:.1f} s")
    return paths, lk_err


def phase_lines_app(dev):
    """(b): the keylines recipe (options/euroc_mh_lines.yaml) through
    ``app.main`` on an APP_FRAMES-frame 752x480 EuRoC-layout folder of the
    corridor with stripes rendered through options/euroc_camchain.yaml (with
    imu0/data.csv), as shipped, with CLAHE off, and euroc_mh.yaml on the same
    folder; each checked against options/euroc_mh_expected.json; the ATE
    with keylines under max(1.5 x the base recipe's, 20 mm); a checkpoint of
    the CLAHE-off keylines system after frame APP_CKPT_FRAME (line tables
    populated) loaded back bit-identical. Returns {run: launches}."""
    import tempfile
    from itertools import islice

    import torch
    import yaml

    from zenslam_tpu_torch import app
    from zenslam_tpu_torch.config import load_options
    from zenslam_tpu_torch.io import checkpoint
    from zenslam_tpu_torch.io.calibration import compute_rectify_maps, load_kalibr_yaml
    from zenslam_tpu_torch.io.dataset import FolderReader
    from zenslam_tpu_torch.io.synthetic import export_dataset, make_distorted_sequence
    from zenslam_tpu_torch.ops.image import remap
    from zenslam_tpu_torch.pipeline.system import create_system, process_frame

    here = Path(__file__).resolve().parent
    camchain = here / "options" / "euroc_camchain.yaml"
    t0 = time.perf_counter()
    rig_raw, models = load_kalibr_yaml(str(camchain), device=dev)
    seq = make_distorted_sequence(np.random.default_rng(9), rig_raw, models,
                                  n_frames=APP_FRAMES, motion="strafe", dt=0.05, speed=0.5,
                                  pixel_noise=0.005, device_render=True, with_imu=True,
                                  with_lines=True)
    launches, results = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mav0"
        export_dataset(seq, str(root))
        print(f"[lines_app] exported {APP_FRAMES} stereo frames 752x480 of the corridor with "
              f"stripes (distorted radtan) with IMU in {time.perf_counter() - t0:.1f} s")
        recipes = {}
        for run, name, clahe in (("lines_app", "euroc_mh_lines.yaml", None),
                                 ("lines_app_no_clahe", "euroc_mh_lines.yaml", False),
                                 ("lines_app_base", "euroc_mh.yaml", None)):
            recipe = yaml.safe_load((here / "options" / name).read_text())
            if clahe is not None:
                recipe["slam"]["use_clahe"] = clahe
            out = Path(tmp) / f"out_{run}"
            opts_path = Path(tmp) / f"{run}.yaml"
            opts_path.write_text(yaml.safe_dump({
                "folder": {"root": str(root), "output": str(out),
                           "calibration_file": str(camchain),
                           "groundtruth_file": str(root / "groundtruth.csv")},
                "slam": recipe["slam"], "backend": recipe["backend"]}))
            recipes[run] = opts_path
            launches[run], r, n_kf, n_ba, text = run_app(run, opts_path, out, dev)
            with open(out / "frame_data.csv", newline="") as f:
                rows = list(csv.DictReader(f))
            n_lines = [int(row["n_lines"]) for row in rows]
            results[run] = r
            print(f"[{run}] slam {recipe['slam']}: checker ATE "
                  f"{r.get('ate_mm', float('nan')):.1f} mm, RPE {r.get('rpe_mm', float('nan')):.1f}"
                  f" mm, failures {r['failures']}; keylines per frame mean "
                  f"{np.mean(n_lines):.1f} max {max(n_lines)}, line map at the end "
                  f"{rows[-1]['line_map_size']}")
            require(not r["failures"], f"{run}: checker failed: {r['failures']}")
            require("IMU stream found" in text, f"{run}: the VIO branch was off")
            require(n_ba == n_kf - 1 and n_kf >= 3, f"{run}: {n_ba} BA runs for {n_kf} keyframes")
            k = 4 if recipe["slam"].get("use_keylines") else 2
            require(launches[run] == {"lk_fb": k * APP_FRAMES, "orb": APP_FRAMES},
                    f"{run}: launches {launches[run]} != {k} LK + 1 ORB per frame")
            if run == "lines_app_no_clahe":
                require(np.mean(n_lines[1:]) >= 8, f"{run}: {np.mean(n_lines[1:]):.1f} "
                                                    "keylines a frame < 8")
        base = results["lines_app_base"]["ate_mm"]
        for run in ("lines_app", "lines_app_no_clahe"):
            ate = results[run]["ate_mm"]
            print(f"[{run}] ATE {ate:.1f} mm against the base recipe's {base:.1f} mm (bound "
                  f"max(1.5 x base, 20 mm) = {max(1.5 * base, 20.0):.1f} mm)")
            require(ate < max(1.5 * base, 20.0), f"{run}: ATE {ate:.1f} mm >= max(1.5 x "
                                                 f"{base:.1f}, 20) mm")

        opts = load_options(str(recipes["lines_app_no_clahe"]))
        maps = compute_rectify_maps(rig_raw, models)
        mx = [torch.from_numpy(m).to(dev) for m in maps[:4]]
        ck = Path(tmp) / "system.npz"
        s = create_system(opts.slam, opts.backend, maps.rig_rectified, (480, 752), device=dev)
        for f in islice(FolderReader(str(root)).frames_prefetch(), APP_CKPT_FRAME):
            process_frame(s, remap(app.upload(f.left, dev), mx[0], mx[1]),
                          remap(app.upload(f.right, dev), mx[2], mx[3]),
                          imu=app.upload_imu(f, dev))
        checkpoint.save_system(str(ck), s)
        s2 = checkpoint.load_system(str(ck), opts.slam, opts.backend, maps.rig_rectified,
                                    (480, 752), device=dev)
        same, la = systems_identical(s, s2)
        n_line = sum(n.startswith(("['state'].lines.", "['state'].line_map.",
                                   "['state'].next_line_id")) for n, _ in la)
        n_live = int(s.state.lines.valid.sum())
        n_map = int(s.state.line_map.valid.sum())
        print(f"[lines_app] checkpoint of the keylines system (CLAHE off) after frame "
              f"{APP_CKPT_FRAME}: {len(la)} tensors and numbers ({n_line} of the line tables: "
              f"{n_live} live keylines, {n_map} mapped, next id "
              f"{int(s.state.next_line_id)}): {'bit-identical' if same else 'DIFFERENT'} after "
              f"load_system")
        require(same and n_line == 14 and n_live > 0 and n_map > 0,
                "lines_app: checkpoint round trip is not bit-identical or lacks the line tables")
    print(f"[lines_app] phase {time.perf_counter() - t0:.1f} s")
    return launches


def phase_kidnap(dev):
    """tests/test_place_recognition.py::TestRelocalizationAfterKidnap's run
    for the port alone: the 112-frame 448x336 orbit (1.75 turns, seed 33,
    pixel noise 0.01; rendered on the card), frames 80-95 skipped and the
    run ended at KIDNAP_END (the tail revisit error on its last 3 frames
    against the same views 64 frames before), loops on
    with a frame gap that never fires, relocalisation off and on; once on
    the main (kernel) path and once on the f32 path the reference's test
    runs (``use_pallas_lk=False``: f32 pyramid, the gather LK, no kernel).
    Requires on both: the run without reloc broken (tail revisit error >
    1 m), 1-4 relocalisations with it; on the f32 path one of them at or
    after the kidnap. Prints each attempt (frame, chosen keyframe's frame,
    score, inliers) and the tail errors (the reference's own 0.35 m bound is
    red in the reference and is not applied)."""
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, process_frame

    t0 = time.perf_counter()
    n, jump, end = 112, 80, KIDNAP_END
    seq = make_sequence(np.random.default_rng(33), n_frames=n, width=448, height=336,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0,
                        orbit_revolutions=1.75, device_render=True, device=dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    order = list(range(0, jump)) + list(range(96, end))
    launches = Counter()
    for path, pcfg in (("kernel", cfg), ("f32", cfg._replace(use_pallas_lk=False))):
        out = {}
        for reloc in (False, True):
            bc = BackendConfig(ba_every_kf=False, enable_loop_closure=True,
                               enable_relocalization=reloc, reloc_lost_frames=1,
                               reloc_min_inliers=12, reloc_cooldown=10, bow_levels=2,
                               bow_branch=32, bow_min_score=0.20, bow_min_frame_gap=100000,
                               bow_top_k=3, loop_min_inliers=12, vocab_retrain_kfs=8)
            s = create_system(pcfg, bc, seq.rig, (336, 448), device=dev)
            centers = {}
            reset_launches()
            for fi in order:
                tel, _ = process_frame(s, seq.left[fi], seq.right[fi])
                centers[fi] = -tel.R_cw.T @ tel.t_cw
            torch.cuda.synchronize()
            if path == "kernel":
                launches.update(read_launches())
            err = float(np.mean([np.linalg.norm(centers[f] - centers[f - 64])
                                 for f in range(end - 3, end)]))
            kf_frames = s.kf_db.frame_idx.cpu().numpy()
            events = [dict(d, kf_frame=int(kf_frames[d["slot"]])) for d in s.reloc_debug]
            out[reloc] = (s, err, events)
            print(f"[kidnap] {path} path, reloc {'on' if reloc else 'off'}: relocs {s.n_relocs}, "
                  f"keyframes {s.n_keyframes}, tail revisit error {err:.4f} m; attempts "
                  f"(frame = frames processed, the kidnap at {jump}) {events}")
        (_, err_off, _), (s_on, err_on, events) = out[False], out[True]
        require(err_off > 1.0, f"kidnap {path}: without reloc the tail error {err_off:.3f} m "
                               "<= 1 m (the kidnap did not break the run)")
        require(1 <= s_on.n_relocs <= 4,
                f"kidnap {path}: {s_on.n_relocs} relocalisations (want 1-4)")
        after = [e for e in events if e["fired"] and e["frame"] >= jump]
        print(f"[kidnap] {path} path: {len(after)} relocalisation(s) at or after the kidnap; "
              f"tail error {err_off:.4f} m without reloc, {err_on:.4f} m with")
        if path == "f32":
            require(after, "kidnap f32: no relocalisation at or after the kidnap")
    print(f"[kidnap] phase {time.perf_counter() - t0:.1f} s")
    require(dict(launches) == {"lk_fb": 4 * len(order), "orb": 2 * len(order)},
            f"kidnap: launches {dict(launches)} on the kernel path")
    return dict(launches)


def family_run(cfg, seq, dev) -> dict:
    """The step over the slice phase's first FAMILY_FRAMES frames: N_WARMUP
    warm-up frames through ``slam_step``, the last of them through the
    captured step's capture (their implicit synchronises recorded), then
    every launch counter at 0 and the measured frames through the captured
    step, timed up to a synchronise. Returns the run's numbers, the states
    before FAMILY_COST_FRAME and REFRESH_CHECK_FRAME, and the rows under the
    refresh mask per measured frame."""
    import torch

    from zenslam_tpu_torch.eval.metrics import ate_rmse, camera_positions
    from zenslam_tpu_torch.pipeline import init_state, make_slam_step, slam_step
    from zenslam_tpu_torch.utils.graphs import fresh

    state = init_state(cfg, (SIZE, SIZE), seed=0, device=dev)
    step = make_slam_step(cfg, seq.rig)
    tels, before, rows = [], {}, []
    with implicit_syncs() as records:
        for t in range(N_WARMUP):
            run = step if t == N_WARMUP - 1 else functools.partial(slam_step, cfg, seq.rig)
            state, tel = run(state, seq.left[t], seq.right[t])
            tels.append(tel)
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for t in range(N_WARMUP, FAMILY_FRAMES):
        if t in (FAMILY_COST_FRAME, REFRESH_CHECK_FRAME):
            before[t] = fresh(state)
        state, tel = step(state, seq.left[t], seq.right[t])
        tels.append(tel)
        f = state.features   # ages and validity as the describe stage saw them
        rows.append((f.valid & (f.age % max(cfg.describe_refresh, 1) == 0)).sum())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    R = torch.stack([x.R_cw for x in tels]).cpu().numpy()
    tt = torch.stack([x.t_cw for x in tels]).cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(tt).all(), "families: non-finite pose")
    gt = camera_positions(seq.R_lw[:FAMILY_FRAMES], seq.t_lw[:FAMILY_FRAMES])
    n = FAMILY_FRAMES - N_WARMUP
    return dict(launches=launches, ms=dt / n * 1e3, records=records, before=before,
                ate=ate_rmse(camera_positions(R, tt), gt),
                pose_ok=float(torch.stack([x.pose_ok for x in tels[1:]]).float().mean()),
                tracked=float(torch.stack([x.n_tracked for x in tels[N_WARMUP:]])
                              .float().mean()),
                rows=torch.stack(rows).cpu().numpy())


def new_module_syncs(records) -> Counter:
    """The synchronise records inside the families' op modules and the float
    matcher and LSH functions of ``ops/match.py``."""
    from zenslam_tpu_torch.ops import match

    spans = []
    for fn in (match.l2_matrix, match.match_descriptors_float, match._planes,
               match.lsh_binarize):
        lines, first = inspect.getsourcelines(fn)
        spans.append((first, first + len(lines)))
    files = ("ops/harris.py", "ops/dog.py", "ops/sift.py", "ops/freak.py")
    return sync_sites([w for w in records if w.filename.endswith(files) or (
        w.filename.endswith("ops/match.py") and any(a <= w.lineno < b for a, b in spans))])


def check_refresh_needs(cfg, seq, state, k: int) -> tuple:
    """Step frame k from ``state`` with the step's ORB describe calls
    recorded: the kernel's ``needs`` rows against a full pass of the kernel
    on the same inputs, bit for bit. Returns (rows computed, valid rows)."""
    import torch

    from zenslam_tpu_torch.pipeline import slam_step, step

    calls = []
    with recorded_calls(step, "orb_descriptors_kernel", calls):
        slam_step(cfg, seq.rig, state, seq.left[k], seq.right[k])
    require(len(calls) == 1, f"families: {len(calls)} ORB describe calls in a refresh step")
    (img, xy, valid), kwargs = calls[0]
    needs = kwargs.get("needs")
    require(needs is not None, "families: the refresh step passed no needs mask")
    need = needs & valid
    part = step.orb_descriptors_kernel(img, xy, valid, needs=needs)
    full = step.orb_descriptors_kernel(img, xy, valid)
    torch.cuda.synchronize()
    same = all(torch.equal(p[need], f[need]) for p, f in zip(part, full))
    require(same, f"families: frame {k}'s needs rows differ from a full pass")
    return int(need.sum()), int(valid.sum())


def family_orbit(dev) -> dict:
    """``tests/test_place_recognition.py::TestFloatPathLoopClosure``'s
    workload through ``run_system``: SIFT (Harris detector) on the kernel
    path, then SIFT and ORB (FAST) on the f32 path, the one that test runs
    (on this rotation-heavy orbit the kernel path drifts, as the
    reference's Pallas path does: ROADMAP.md Queue 3): loops through the
    LSH crossing and SIFT's recall beside ORB's."""
    import torch

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

    t0 = time.perf_counter()
    seq = make_sequence(np.random.default_rng(21), n_frames=96, width=320, height=240,
                        motion="orbit", pixel_noise=0.01, orbit_radius=1.0,
                        orbit_revolutions=1.5, device=dev)
    bcfg = BackendConfig(ba_every_kf=False, enable_loop_closure=True, bow_levels=2,
                         bow_branch=32, bow_min_score=0.15, bow_min_frame_gap=30, bow_top_k=3,
                         loop_min_inliers=12, vocab_retrain_kfs=8)
    out = {}
    for desc, kernels in (("sift", True), ("sift", False), ("orb", False)):
        cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                         kf_min_translation=0.05, descriptor=desc,
                         detector="harris" if desc == "sift" else "fast",
                         use_pallas_lk=None if kernels else False)
        s = create_system(cfg, bcfg, seq.rig, (240, 320))
        reset_launches()
        t1 = time.perf_counter()
        run_system(s, seq.left, seq.right)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        eligible = [d for d in s.loop_debug if d["frame"] >= 96 / 1.5 * 1.1]
        recall = sum(d["fired"] for d in eligible) / max(len(eligible), 1)
        name = f"{desc}_{'kernels' if kernels else 'f32'}"
        out[name] = (s, recall, read_launches())
        print(f"[families] orbit {name}: 96 frames in {dt:.2f} s, keyframes {s.n_keyframes}, "
              f"loop closures {s.n_loop_closures}, recall {recall:.3f} over {len(eligible)} "
              f"eligible gates, keyframe ATE {kf_ate(s.kf_db, seq):.5f} m, "
              f"launches {out[name][2]}")
    (_, _, l_kern), (s_sift, r_sift, _), (_, r_orb, _) = out.values()
    require(l_kern == {"lk_fb": 192, "orb": 0}, f"families: SIFT orbit launches {l_kern}")
    require(s_sift.n_loop_closures >= 1, "families: no loop closed through the LSH crossing")
    require(r_orb > 0 and r_sift >= 0.5 * r_orb,
            f"families: SIFT recall {r_sift:.3f} < 0.5 x ORB's {r_orb:.3f}")
    print(f"[families] orbit phase {time.perf_counter() - t0:.1f} s")
    return {"families_orbit_sift": l_kern}


def phase_families(seq, dev):
    """The other detector and descriptor families (see the module
    docstring). Returns {path: launches}."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.pipeline import SlamConfig, slam_step

    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)
    print(f"[families] matmul allow_tf32 {tf32[0]}, float32 matmul precision {tf32[1]!r} "
          f"(cudnn allow_tf32 {tf32[2]}; no convolution on this path)")
    require(not tf32[0] and tf32[1] == "highest", f"families: matmuls not in full f32 {tf32}")
    n = FAMILY_FRAMES - N_WARMUP
    cfgs = {"default": SlamConfig(), **{k: SlamConfig(**v) for k, v in FAMILIES.items()}}
    runs = {name: family_run(cfg, seq, dev) for name, cfg in cfgs.items()}
    base = runs["default"]
    line = card_line()
    paths = {}
    for name, r in runs.items():
        cfg = cfgs[name]
        syncs = sync_sites(r["records"])
        n_sync = sum(syncs.values())
        print(f"[families] {name}: {n} frames {r['ms']:.2f} ms/frame on {line}; pose_ok "
              f"{r['pose_ok']:.3f}, ATE {r['ate']:.5f} m, mean tracked {r['tracked']:.1f}, "
              f"launches {r['launches']}; implicit synchronises over the {N_WARMUP} warm-up "
              f"frames {n_sync}: " + ", ".join(f"{k} x{v}" for k, v in syncs.most_common(8)))
        orb = n if cfg.descriptor == "orb" else 0
        require(r["launches"] == {"lk_fb": 2 * n, "orb": orb},
                f"families {name}: launches {r['launches']} != 2 LK + {orb // n} ORB per frame")
        require(r["pose_ok"] >= 0.9, f"families {name}: pose_ok {r['pose_ok']:.3f} < 0.9")
        require(r["ate"] < 0.05, f"families {name}: ATE {r['ate']:.4f} m >= 0.05 m")
        if cfg.descriptor in ("sift", "freak") and cfg.detector != "dog":
            # the reference tests' bars for a descriptor beside FAST/ORB; a DoG
            # run has the bars of test_detector_matrix.py's DoG cases above
            require(r["tracked"] > 0.5 * base["tracked"],
                    f"families {name}: mean tracked {r['tracked']:.1f} <= 0.5 x the default's")
            require(r["ate"] < max(2 * base["ate"], 0.02),
                    f"families {name}: ATE {r['ate']:.4f} m >= max(2 x default, 0.02 m)")
        inside = new_module_syncs(r["records"])
        require(not inside, f"families {name}: implicit synchronises in the new modules {inside}")
        if name != "default":
            paths[f"families_{name}"] = r["launches"]
    print("[families] implicit synchronises in ops/harris.py, dog.py, sift.py, freak.py and "
          "the float matcher and LSH of ops/match.py over every run's warm-up: none")

    ref = runs["fast_orb_refresh4"]
    rows = ref["rows"]
    k = REFRESH_CHECK_FRAME
    n_need, n_valid = check_refresh_needs(cfgs["fast_orb_refresh4"], seq, ref["before"][k], k)
    print(f"[families] describe_refresh=4: rows computed per frame min/median/max "
          f"{int(rows.min())}/{float(np.median(rows)):.0f}/{int(rows.max())} of "
          f"{SlamConfig().max_keypoints} slots (mean {float(rows.mean()):.1f}); frame {k}: the "
          f"kernel's {n_need} needs rows (of {n_valid} valid) bit-identical to a full pass; "
          f"ATE {ref['ate']:.5f} m beside {base['ate']:.5f} m at refresh 1")

    k = FAMILY_COST_FRAME
    cost, by_op = step_cost({name: functools.partial(slam_step, cfgs[name], seq.rig,
                                                     runs[name]["before"][k], seq.left[k],
                                                     seq.right[k]) for name in cfgs})
    kd, busy_d, ms_d = cost["default"]
    for name in FAMILIES:
        kn, busy, ms = cost[name]
        added = by_op[name]
        added.subtract(by_op["default"])
        print(f"[families] {name}: one slam_step on frame {k} from its run's state before it: "
              f"device kernels and copies {kn} (default {kd}, torch.profiler), device busy "
              f"{busy:.3f} ms (default {busy_d:.3f}), host {ms:.2f} ms (default {ms_d:.2f}; "
              f"medians of {COST_ROUNDS} alternating rounds); device ms it adds by operator (top 5): "
              + ", ".join(f"{op[:40]} {v:.3f}" for op, v in added.most_common(5)))
    paths.update(family_orbit(dev))
    print(f"[families] phase {time.perf_counter() - t0:.1f} s")
    return paths


def dist_problem(dev):
    """``__graft_entry__.py:dryrun_multichip``'s stage-1 problem: K = 8
    keyframes on an arc, 8 x 32 landmarks seen by 4 random keyframes each,
    poses and landmarks perturbed, seed 0."""
    import torch

    from zenslam_tpu_torch.backend.ba import make_ba_problem
    from zenslam_tpu_torch.geometry.lie import so3_exp

    rng = np.random.default_rng(0)
    K, M = 8, 8 * 32
    fx = fy = 300.0
    cx = cy = 128.0
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                  rng.uniform(4, 10, M)], -1).astype(np.float32)
    R_gt = [so3_exp(torch.tensor([0.0, 0.04 * k, 0.01 * k])).numpy() for k in range(K)]
    t_gt = [np.array([0.25 * k, 0.02 * k, 0], np.float32) for k in range(K)]
    obs_kf, obs_lm, obs_uv = [], [], []
    for m in range(M):
        for k in sorted(rng.choice(K, 4, replace=False)):
            xc = R_gt[k] @ X[m] + t_gt[k]
            if xc[2] <= 0.5:
                continue
            obs_kf.append(k)
            obs_lm.append(m)
            obs_uv.append([fx * xc[0] / xc[2] + cx, fy * xc[1] / xc[2] + cy])
    O = len(obs_kf)
    p = make_ba_problem(K, M, O, fx, fy, cx, cy, device=dev)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return p._replace(
        R=t(np.stack(R_gt)), t=t(np.stack(t_gt) + rng.normal(0, 0.02, (K, 3)).astype(np.float32)),
        kf_valid=t(np.ones(K, bool), torch.bool), kf_fixed=t(np.arange(K) < 2, torch.bool),
        xyz=t(X + rng.normal(0, 0.05, (M, 3)).astype(np.float32)),
        lm_valid=t(np.ones(M, bool), torch.bool), obs_kf=t(obs_kf, torch.int32),
        obs_lm=t(obs_lm, torch.int32), obs_uv=t(obs_uv), obs_valid=t(np.ones(O, bool), torch.bool))


def collectives_of(fn) -> tuple:
    """(``fn()``, the all-reduces it issued, the floats they reduced): the
    sharded solver's counters (``parallel/dist_ba.py:collectives``), which a
    replay advances by what its capture issued."""
    from zenslam_tpu_torch.parallel.dist_ba import collectives

    c0, f0 = collectives.calls, collectives.floats
    out = fn()
    return out, collectives.calls - c0, collectives.floats - f0


def dist_solver_alone(dev) -> None:
    """(a): the sharded solver alone on the dry run's stage-1 problem, 1 and 8
    shards on the one-rank NCCL mesh, against the dense solver: both
    solvers as a caller gets them, captured programs (the first call
    captures; the timed calls replay), each bit-identical to its eager
    call, the collectives a solve counted through the capture and equal to
    the eager call's."""
    import torch
    import torch.distributed as tdist

    from zenslam_tpu_torch.backend.ba import bundle_adjust
    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.parallel import dist_bundle_adjust, make_ba_mesh, shard_ba_problem

    p = dist_problem(dev)
    dense = bundle_adjust(p, iterations=DIST_ITERS)
    dense_ms = float(np.median(time_calls(lambda: bundle_adjust(p, iterations=DIST_ITERS), 5,
                                          repeats=3)))
    out = {}
    for n in (1, 8):
        mesh = make_ba_mesh(n, device=dev)
        backend = tdist.get_backend(mesh.group)
        require(backend == "nccl", f"dist: the {dev} mesh reduces over {backend!r}, not nccl")
        ps = shard_ba_problem(p, n)

        def solve():
            return dist_bundle_adjust(ps, mesh, iterations=DIST_ITERS)

        solve()                                              # the capture
        r, n_coll, n_floats = collectives_of(solve)          # a replay
        e, e_coll, e_floats = collectives_of(lambda: eager_call(solve))
        ms = float(np.median(time_calls(solve, 5, repeats=3)))
        eager_ms = float(np.median(time_calls(lambda: eager_call(solve), 5, repeats=3)))
        dt = float((r["t"] - dense["t"]).abs().max())
        dR = float((r["R"] - dense["R"]).abs().max())
        cb, ca = float(r["cost_before"]), float(r["cost_after"])
        print(f"[dist] solver alone, {n} shard(s) over a {backend} group of "
              f"{tdist.get_world_size(mesh.group)} rank: K=8 M={p.xyz.shape[0]} "
              f"O={p.obs_kf.shape[0]}, cost {cb:.4f} -> {ca:.6f}, vs dense max|dt| {dt:.2e} "
              f"max|dR| {dR:.2e}; {n_coll} collectives a solve, {n_floats} floats (counted by "
              f"the capture, added by the replay; eager {e_coll}, {e_floats}); captured "
              f"{ms:.2f} ms a solve, eager {eager_ms:.2f} (dense captured {dense_ms:.2f} ms; "
              f"host + device, CUDA events); bit-identical to eager: "
              f"{not parted(r, e)}; {card_line()}")
        require(n_coll == e_coll == 1 + 2 * DIST_ITERS and n_floats == e_floats,
                f"dist: {n_coll} collectives ({n_floats} floats) a replayed solve, eager "
                f"{e_coll} ({e_floats}), != 1 + 2 x {DIST_ITERS}")
        require(not parted(r, e), f"dist: {n} shards captured part from eager in {parted(r, e)}")
        require(dt < 5e-3 and dR < 5e-3, f"dist: {n} shards max|dt| {dt:.2e} max|dR| {dR:.2e} "
                                         "against the dense solver (bar 5e-3)")
        require(ca < cb / 10, f"dist: {n} shards cost {cb:.4f} -> {ca:.4f}, not a 10x drop")
        out[n] = r
    d = float((out[1]["t"] - out[8]["t"]).abs().max())
    print(f"[dist] 1 shard vs 8 shards: max|dt| {d:.2e}")
    require(d <= 1e-4, f"dist: 1 and 8 shards part by {d:.2e} > 1e-4")


@contextlib.contextmanager
def recorded_windows(system_module, windows: list):
    """Inside the block, append to ``windows`` the (arguments, keyword
    arguments, outputs) of every ``_windowed_ba`` call."""
    from zenslam_tpu_torch.utils.graphs import fresh

    window = system_module._windowed_ba

    def windowed(*args, **kwargs):
        kept = fresh(args)     # the step's state is its buffers, overwritten by the next frame
        out = window(*args, **kwargs)
        windows.append((kept, kwargs, out))
        return out

    system_module._windowed_ba = windowed
    try:
        yield
    finally:
        system_module._windowed_ba = window


def route_drops(windows: list) -> int:
    """The route-drop count summed over the recorded dist windows, read
    after the run: each window again under ``graphs.eager()`` (a replay
    calls no Python, so the router's count is caught on the eager form,
    which the graphed run equals bit for bit)."""
    import torch

    from zenslam_tpu_torch.pipeline import system

    route, drops = system.shard_ba_problem_device, []

    def routed(*args, **kwargs):
        ps, n = route(*args, **kwargs)
        drops.append(n)
        return ps, n

    system.shard_ba_problem_device = routed
    try:
        for args, kwargs, _ in windows:
            if kwargs.get("solver") == "dist":
                eager_call(functools.partial(system._windowed_ba_body, *args, **kwargs))
    finally:
        system.shard_ba_problem_device = route
    return int(torch.stack(drops).sum()) if drops else 0


def dist_system_run(seq, n_shards: int, dense: dict, tag: str) -> tuple:
    """(b): the system phase's run with ``ba_solver="dist"`` at ``n_shards``
    (0: one a rank), checked against the dense run; returns (launches, the
    last windowed BA's arguments and keyword arguments)."""
    import torch

    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system

    bcfg = BackendConfig(telemetry_lag=3, ba_solver="dist", dist_devices=n_shards)
    s = create_system(SlamConfig(), bcfg, seq.rig, (SIZE, SIZE))
    windows = []
    calls0 = program_calls(s)
    with recorded_windows(system, windows):
        run = timed_system_run(s, seq)
    replays = since_calls(calls0, s)
    launches, dt, R, tt, is_kf, pose_ok, ate, runs, backend, dispatch, records = (
        run[k] for k in ("launches", "dt", "R", "t", "is_kf", "pose_ok", "ate", "runs",
                         "backend_ms", "ba_dispatch", "records"))
    n = SYSTEM_FRAMES - SYSTEM_WARMUP
    n_drop = route_drops(windows)
    # the same frames with every program eager: the graphed run must equal it
    e_out, e_ms, _, _, e_x = graphed_system(seq, s.device, False, bcfg=bcfg)
    held_to_eager(tag, f"ba_solver dist, {n_shards or 1} shard(s), {SYSTEM_FRAMES} frames",
                  e_out, system_outputs(s, run["tels"]),
                  lambda: graphed_system(seq, s.device, False, bcfg=bcfg)[0])
    from zenslam_tpu_torch.utils import graphs

    mesh = system._live_ba_mesh(n_shards, s.device)
    captures = [round((x.end - x.start) * 1e-6, 1) for x in run["spans"]
                if x.name == "graphs.capture" and x.detail == system._WINDOWED_BA.__name__]
    print(f"[{tag}] graphed / eager: {dt / n * 1e3:.2f} ms/frame ({n} timed frames) / "
          f"{e_ms:.2f} ({SYSTEM_FRAMES} frames); ba_dispatch median "
          f"{float(np.median(dispatch)):.3f} / {float(np.median(e_x['phases']['ba_dispatch'])):.3f}"
          f" ms; the dist window's calls over the graphed run {replays['ba']} "
          f"({graphs.calls(system._WINDOWED_BA, solver='dist', mesh=mesh)} over the process), "
          f"the windowed BA's captures in the run {captures} ms")
    require(replays["ba"] == s.n_ba_runs,
            f"{tag}: {replays['ba']} dist window calls for {s.n_ba_runs} BA runs")
    kf_t, kf_v = s.kf_db.t.cpu().numpy(), s.kf_db.valid.cpu().numpy()
    both = kf_v & dense["kf_valid"]
    d_frames = float(np.abs(tt - dense["t"]).max())
    d_kf = float(np.abs(kf_t[both] - dense["kf_t"][both]).max())
    in_parallel = window_syncs(records, f"{os.sep}parallel{os.sep}")
    n_sync = len(sync_sites(records))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[{tag}] ba_solver dist, {mesh.n_shards} shard(s): {n} frames {dt / n * 1e3:.2f} "
          f"ms/frame, peak {peak:.1f} MiB; keyframes {s.n_keyframes} (dense "
          f"{dense['n_keyframes']}), BA runs {s.n_ba_runs} (dense {dense['n_ba_runs']}); "
          f"pose_ok {pose_ok:.3f}, ATE {ate:.5f} m; launches {launches}")
    print(f"[{tag}] against the dense run: max|dt| frames {d_frames:.3e} m, keyframes "
          f"{d_kf:.3e} m; route drops over the run {n_drop}; backend_ms median "
          f"{float(np.median(backend)):.2f} (dense {float(np.median(dense['backend_ms'])):.2f}), "
          f"ba_dispatch median {float(np.median(dispatch)):.3f} ms (dense "
          f"{float(np.median(dense['ba_dispatch'])):.3f}); implicit synchronises in the run "
          f"{n_sync} lines, in parallel/ and system.py:_windowed_ba: "
          f"{dict(in_parallel) or 'none'}")
    print(f"[{tag}] BA rmse before/after/dropped: "
          + "; ".join(f"{a:.4f}/{b:.4f}/{int(c)}" for a, b, c in runs))
    require(launches == {"lk_fb": 2 * n, "orb": n},
            f"{tag}: launches {launches} != 2 LK + 1 ORB per frame over {n} frames")
    require(s.n_keyframes == dense["n_keyframes"] and s.n_ba_runs == dense["n_ba_runs"]
            and np.array_equal(is_kf, dense["is_kf"]),
            f"{tag}: keyframes / BA runs differ from the dense run")
    require(all(np.isfinite(r).all() and r[1] <= 1.05 * r[0] and r[2] == 0 for r in runs),
            f"{tag}: a BA run raised its rmse by > 5% or dropped observations")
    require(d_frames < DIST_BAR and d_kf < DIST_BAR,
            f"{tag}: poses part from the dense run by {d_frames:.3e} / {d_kf:.3e} m")
    require(ate < 0.05 and pose_ok >= 0.9, f"{tag}: ATE {ate:.4f} m, pose_ok {pose_ok:.3f}")
    require(not in_parallel, f"{tag}: implicit synchronises in parallel/ or _windowed_ba "
                             f"{dict(in_parallel)}")
    return launches, windows[-1][:2]


def loop_run(seq, cfg, solver: str, n_shards: int = 8) -> tuple:
    """One run of the dry run's stage 3 (BA every keyframe, loop closure on)
    with ``solver``; returns (frame t_cw, the system, launches, the route
    drops summed after the run, every windowed BA's (arguments, keyword
    arguments, outputs))."""
    import torch

    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.pipeline.system import BackendConfig, create_system, run_system

    bc = BackendConfig(ba_every_kf=True, enable_loop_closure=True, ba_solver=solver,
                       dist_devices=n_shards, bow_branch=32, bow_top_k=5, bow_min_score=0.20,
                       bow_min_frame_gap=15, loop_min_inliers=12)
    s = create_system(cfg, bc, seq.rig, (240, 320))
    windows = []
    reset_launches()
    with recorded_windows(system, windows):
        tel, _ = run_system(s, seq.left, seq.right)
    torch.cuda.synchronize()
    launches = read_launches()
    return tel.t_cw, s, launches, route_drops(windows), windows


def loop_gap(a, b) -> tuple:
    """max |dt| of two loop runs over frames and over their common keyframes."""
    both = (a[1].kf_db.valid & b[1].kf_db.valid).cpu().numpy()
    kf_a, kf_b = a[1].kf_db.t.cpu().numpy(), b[1].kf_db.t.cpu().numpy()
    return float(np.abs(a[0] - b[0]).max()), float(np.abs(kf_a[both] - kf_b[both]).max())


def dist_loop(dev) -> dict:
    """(c): the dry run's stage 3, the 64-frame 320x240 orbit (seed 21) with
    BA and loop closure: on the kernel path dense and dist at 1 and 8
    shards, >= 3 BA runs and a loop in each and the 1-shard run within
    DIST_BAR of the dense one; on the f32 path (the one the dry run ran:
    the reference on the CPU runs no Pallas kernel) 8 shards within
    DIST_BAR of dense, the dry run's check; every gap and route-drop count
    printed. The kernel path's 8-shard run parts from the dense one by
    meters: ``window_witness`` holds the 8-shard solver to the dense solver
    on the same rows where they first part (see PERF.md)."""
    from zenslam_tpu_torch.pipeline import SlamConfig

    seq = loop_orbit(dev)
    cfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                     kf_min_translation=0.05)
    f32 = cfg._replace(use_pallas_lk=False)
    runs = {}
    for name, c, solver, n in (("dense", cfg, "dense", 0), ("dist1", cfg, "dist", 1),
                               ("dist8", cfg, "dist", 8), ("f32_dense", f32, "dense", 0),
                               ("f32_dist8", f32, "dist", 8)):
        t0 = time.perf_counter()
        runs[name] = t, s, launches, drops, _ = loop_run(seq, c, solver, n)
        print(f"[dist_loop] {name}: 64 frames in {time.perf_counter() - t0:.2f} s, keyframes "
              f"{s.n_keyframes}, BA runs {s.n_ba_runs}, loop closures {s.n_loop_closures}, "
              f"keyframe ATE {kf_ate(s.kf_db, seq):.5f} m, route drops {drops}, launches "
              f"{launches}")
        if name.startswith("f32"):
            continue
        require(np.isfinite(t).all() and s.n_ba_runs >= 3 and s.n_loop_closures >= 1,
                f"dist_loop {name}: {s.n_ba_runs} BA runs, {s.n_loop_closures} loops")
        require(launches == {"lk_fb": 128, "orb": 64},
                f"dist_loop {name}: launches {launches} != 2 LK + 1 ORB per frame")
    gaps = {name: loop_gap(runs[name], runs[base]) for name, base in (
        ("dist1", "dense"), ("dist8", "dense"), ("f32_dist8", "f32_dense"))}
    for name, (d_live, d_kf) in gaps.items():
        print(f"[dist_loop] {name} vs its dense run: max|dt| frames {d_live:.3e} m, keyframes "
              f"{d_kf:.3e} m")
    for name in ("dist1", "f32_dist8"):
        require(max(gaps[name]) < DIST_BAR,
                f"dist_loop: {name} parts from its dense run by {max(gaps[name]):.3e} m")
    window_witness(runs["dense"][4], runs["dist8"][4], dev)
    return runs["dist8"][2]


def window_witness(dense_windows: list, dist_windows: list, dev) -> None:
    """(c) on the kernel path, where the dense and 8-shard orbit runs part:
    the first window whose outputs part by more than 1e-5, teacher-forced
    on the dense run's inputs. The 8-shard solver must give, within 1e-6,
    what the dense solver gives on the same observation rows in the
    router's order; the dense solver on a seeded permutation of its own
    rows is printed beside, as is how many of the window's landmarks have
    a 3x3 block V with its least eigenvalue under 1e-6 of its largest (one
    view: the block's null direction is rounding, which the damping does
    not dominate)."""
    import torch

    from zenslam_tpu_torch.backend.ba import _build_blocks
    from zenslam_tpu_torch.pipeline import system

    def out_gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a[2][:5], b[2][:5]))

    first = next((i for i, (a, b) in enumerate(zip(dense_windows, dist_windows))
                  if out_gap(a, b) > 1e-5), None)
    if first is None:
        print("[dist_loop] kernel path: every dense and 8-shard window within 1e-5")
        return
    args, kwargs, _ = dense_windows[first]
    caught = {}
    solvers = (system.bundle_adjust, system.dist_bundle_adjust)

    def catch(name, fn):
        def caught_call(p, *a, **k):
            caught[name] = (p, a)
            return fn(p, *a, **k)
        return caught_call

    system.bundle_adjust = catch("dense", solvers[0])
    system.dist_bundle_adjust = catch("dist8", solvers[1])
    try:
        eager_call(functools.partial(system._windowed_ba, *args,
                                     **dict(kwargs, solver="dense", mesh=None)))
        eager_call(functools.partial(system._windowed_ba, *args,
                                     **dict(kwargs, solver="dist",
                                            mesh=system._live_ba_mesh(8, dev))))
    finally:
        system.bundle_adjust, system.dist_bundle_adjust = solvers
    pd, (ps8, (mesh,)) = caught["dense"][0], caught["dist8"]
    it = kwargs["iterations"]
    ops, ms = ps8.obs_kf.shape[0] // mesh.n_shards, ps8.xyz.shape[0] // mesh.n_shards
    shard = torch.arange(ps8.obs_kf.shape[0], device=dev) // ops
    obs = ("obs_kf", "obs_lm", "obs_uv", "obs_cam", "obs_valid")
    perm = torch.from_numpy(np.random.default_rng(0).permutation(pd.obs_kf.shape[0])).to(dev)
    res = {"dense": solvers[0](pd, iterations=it),
           "dist8": solvers[1](ps8, mesh, iterations=it),
           "dense, router's rows": solvers[0](pd._replace(**dict(
               {k: getattr(ps8, k) for k in obs},
               obs_lm=(ps8.obs_lm + shard * ms).to(torch.int32))), iterations=it),
           "dense, permuted rows": solvers[0](pd._replace(
               **{k: getattr(pd, k)[perm] for k in obs}), iterations=it)}

    def gap(a, b):
        return max(float((res[a][k] - res[b][k]).abs().max()) for k in ("R", "t"))

    V = _build_blocks(pd, pd.R, pd.t, pd.xyz, 1.0)[2][pd.lm_valid]
    ev = torch.linalg.eigvalsh(V.double())
    one_view = int((ev[:, 0] < 1e-6 * ev[:, 2].clamp(min=1e-30)).sum())
    print(f"[dist_loop] kernel path, window {first} (the first whose dense and 8-shard outputs "
          f"part), teacher-forced: {int(pd.kf_valid.sum())} keyframes, {V.shape[0]} landmarks, "
          f"{one_view} of them one-view; {it} LM steps, cost / accepted: " + "; ".join(
              f"{k} {float(r['cost_after']):.6f} / {int(r['n_accepted'])}"
              for k, r in res.items()))
    d_same = gap("dist8", "dense, router's rows")
    c8, cs = float(res["dist8"]["cost_after"]), float(res["dense, router's rows"]["cost_after"])
    print(f"[dist_loop] window {first}: max|d| of R and t, dist8 vs dense "
          f"{gap('dist8', 'dense'):.3e}, dense on permuted rows vs dense "
          f"{gap('dense, permuted rows', 'dense'):.3e}, dist8 vs dense on the router's rows "
          f"{d_same:.3e}")
    require(d_same <= 1e-6 and abs(c8 - cs) <= 1e-6 * abs(cs),
            f"dist_loop: window {first}, 8 shards part from the dense solver on the same rows by "
            f"{d_same:.3e} (costs {c8:.6f} / {cs:.6f})")


def dist_offline(dev) -> None:
    """(d): the dry run's stage 2, the 10-frame 192x144 strafe (seed 4),
    through 2 worker processes on the card and the in-process chunker, on
    the kernel path and on the f32 path (the one the dry run ran): the
    2-worker stitch within 5e-3 of the in-process chunker on both. The dry run's accuracy check, the truth's sign within 0.15 m, is
    held at STRAFE_BAR on the displacement the images fix. fx = 380 on a
    192-pixel sensor is a 28 degree view of a wall STRAFE_WALL_Z ahead, so
    a strafe error e and a yaw error -e / STRAFE_WALL_Z move the image
    alike; each frame's x error is -5.9 m x its yaw error in both packages
    on the CPU, and the reference's own stitch misses the raw 0.15 m bar on
    5 of 8 seeds (scripts/torch_dist_probe.py strafe, PERF.md). So dx +
    STRAFE_WALL_Z x the yaw change is held for the stitch and the serial
    run (one chunk, in process); the raw dx and the dry run's verdict on it
    are printed. The workers' wall time is reported: they share the card."""
    import tempfile

    from zenslam_tpu_torch.io.synthetic import make_sequence
    from zenslam_tpu_torch.parallel import run_offline_chunks, run_offline_multiprocess
    from zenslam_tpu_torch.pipeline import SlamConfig

    seq = make_sequence(np.random.default_rng(4), n_frames=10, width=192, height=144,
                        motion="strafe", speed=0.5, device=dev)
    cfg = SlamConfig(max_keypoints=192, max_landmarks=1024, pnp_iters=64, rigid_iters=64)

    def dx_yaw(R, t):
        """x-displacement of the camera centre and yaw change, last frame
        against the first."""
        c = np.einsum("kji,kj->ki", R, -t)
        yaw = np.arctan2(R[:, 2, 0], R[:, 2, 2])
        return float(c[-1, 0] - c[0, 0]), float(yaw[-1] - yaw[0])

    gt_dx, gt_dyaw = dx_yaw(seq.R_lw, seq.t_lw)
    gt_fixed = gt_dx + STRAFE_WALL_Z * gt_dyaw
    for path, c in (("kernel", cfg), ("f32", cfg._replace(use_pallas_lk=False))):
        with tempfile.TemporaryDirectory() as wd:
            t0 = time.perf_counter()
            out = run_offline_multiprocess(c, seq.rig, seq.left, seq.right, n_workers=2,
                                           overlap=3, workdir=wd, device=dev, pin_cpus=False)
            wall = time.perf_counter() - t0
        ref, serial = (run_offline_chunks(c, seq.rig, seq.left, seq.right, n_chunks=n,
                                          overlap=3, device=dev) for n in (2, 1))
        d = float(np.abs(out["t_cw"] - ref["t_cw"]).max())
        print(f"[dist_offline] {path} path, 2 worker processes on the card: bounds "
              f"{out['bounds']}, against the in-process chunker max|dt| {d:.3e} m; wall time "
              f"{wall:.2f} s (process start, CUDA context and 10 frames; reported, not a claim)")
        require(np.isfinite(out["t_cw"]).all() and d < 5e-3,
                f"dist_offline {path}: workers part from the in-process chunker by {d:.3e}")
        for name, o in (("2-worker stitch", out), ("serial, 1 chunk in process", serial)):
            dx, dyaw = dx_yaw(o["R_cw"], o["t_cw"])
            fixed = dx + STRAFE_WALL_Z * dyaw
            raw_ok = np.sign(dx) == np.sign(gt_dx) and abs(dx - gt_dx) < 0.15
            print(f"[dist_offline] {path} path, {name}: dx {dx:.4f} m, yaw change "
                  f"{dyaw * 1e3:.3f} mrad, dx + {STRAFE_WALL_Z:g} m x yaw {fixed:.4f} m (truth "
                  f"{gt_dx:.4f} / {gt_fixed:.4f}: error {fixed - gt_fixed:+.4f} m); the dry run's "
                  f"check on the raw dx {'holds' if raw_ok else 'misses'} (error "
                  f"{dx - gt_dx:+.4f} m)")
            require(np.sign(fixed) == np.sign(gt_fixed) and abs(fixed - gt_fixed) < STRAFE_BAR,
                    f"dist_offline {path} {name}: yaw-corrected dx {fixed:.4f} against the "
                    f"truth's {gt_fixed:.4f} (bar {STRAFE_BAR})")


def phase_dist(seq, dev, dense: dict) -> dict:
    """The sharded BA (see the module docstring). Returns {path: launches}."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.pipeline import system

    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    print(f"[dist] matmul allow_tf32 {tf32[0]}, float32 matmul precision {tf32[1]!r}")
    require(not tf32[0] and tf32[1] == "highest", f"dist: matmuls not in full f32 {tf32}")
    dist_solver_alone(dev)
    paths = {}
    for tag, n in (("dist", 0), ("dist8", 8)):
        paths[tag], (a, kw) = dist_system_run(seq, n, dense, tag)
    kw = dict(kw)
    windows = {"dense": dict(kw, solver="dense", mesh=None)}
    for n in (1, 8):
        windows[f"dist{n}"] = dict(kw, mesh=system._live_ba_mesh(n, dev))
    steps = {k: functools.partial(eager_call, functools.partial(system._windowed_ba, *a, **v))
             for k, v in windows.items()}
    steps.update({f"{k} graphed": functools.partial(system._windowed_ba, *a, **v)
                  for k, v in windows.items()})
    cost, by_op = step_cost(steps)
    print(f"[dist] one windowed BA (the last keyframe's inputs, {kw['iterations']} LM steps) on "
          f"{card_line()}: " + "; ".join(
              f"{k} {c[0]} device kernels and copies, device busy {c[1]:.3f} ms, host "
              f"{c[2]:.2f} ms" for k, c in cost.items())
          + f" (torch.profiler; host: medians of {COST_ROUNDS} alternating rounds)")
    for k, ops in by_op.items():
        print(f"[dist] {k}: device ms by operator (top 5): "
              + ", ".join(f"{op[:40]} {v:.3f}" for op, v in ops.most_common(5)))
    paths["dist_loop"] = dist_loop(dev)
    dist_offline(dev)
    print(f"[dist] phase {time.perf_counter() - t0:.1f} s")
    return paths


def phase_scaling(dev) -> dict:
    """``[scaling]``: ``eval/scaling.py``'s problem (K=32, M=16384,
    O=131072) through ``dist_bundle_adjust`` at 1 and 8 local shards of the
    one-rank NCCL group, by ``eval/scaling.py:time_solve`` (one untimed and
    three timed solves), captured (its default: the untimed solve captures,
    the timed ones replay) and under ``graphs.eager()``: the two
    bit-identical, the cost falls at both shard counts, and the 8-shard R
    and t are within 5e-3 of the 1-shard solve (the dry run's bar for the
    solver alone); graphs held and peak memory. Returns the launches (none:
    no kernel is on this path)."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.eval.scaling import ITERATIONS, REPEATS, make_problem, time_solve
    from zenslam_tpu_torch.parallel import make_ba_mesh, shard_ba_problem
    from zenslam_tpu_torch.utils.graphs import eager, graphs_held

    t0 = time.perf_counter()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    p = make_problem(device=dev)
    card = card_line()
    out = {}
    for n in (1, 8):
        ps, mesh = shard_ba_problem(p, n), make_ba_mesh(n, device=dev)
        ms, r = time_solve(ps, mesh)
        with eager():
            eager_ms, e = time_solve(ps, mesh)
        cb, ca = float(r["cost_before"]), float(r["cost_after"])
        print(f"[scaling] K=32 M={p.xyz.shape[0]} O={p.obs_kf.shape[0]}, {n} shard(s) on one "
              f"card: {ms:.3f} ms/iteration captured, {eager_ms:.3f} eager ({ITERATIONS} LM "
              f"steps, {REPEATS} timed solves each, after one untimed) on {card}; cost "
              f"{cb:.1f} -> {ca:.4f}; captured bit-identical to eager: {not parted(r, e)}")
        require(not parted(r, e), f"scaling: {n} shards captured part from eager in "
                                  f"{parted(r, e)}")
        require(np.isfinite(ca) and ca < cb, f"scaling: {n} shards cost {cb:.4f} -> {ca:.4f}")
        out[n] = r
    dR = float((out[8]["R"] - out[1]["R"]).abs().max())
    dt = float((out[8]["t"] - out[1]["t"]).abs().max())
    launches = read_launches()
    print(f"[scaling] 8 shards vs 1: max|dR| {dR:.2e}, max|dt| {dt:.2e} (bar 5e-3); graphs "
          f"held {graphs_held()}, peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; "
          f"launches {launches}; phase {time.perf_counter() - t0:.1f} s")
    require(dR < 5e-3 and dt < 5e-3, f"scaling: 8 shards part from 1 by dR {dR:.2e} dt {dt:.2e}")
    return launches


def ring_graph(dev, K: int = 64, E: int = 256, seed: int = 5):
    """A pose graph at the system's defaults (``max_keyframes`` 64,
    ``max_edges`` 256): K poses on a 4 m circle looking inward, perturbed,
    an odometry edge between neighbours and a loop edge every 8th node to
    the node 32 back, measured from the truth with noise; the rest of the
    E rows invalid; node 0 the gauge."""
    import torch

    from zenslam_tpu_torch.backend.pose_graph import PoseGraph
    from zenslam_tpu_torch.geometry.lie import se3_compose, se3_inverse, so3_exp

    g = torch.Generator().manual_seed(seed)
    yaw = torch.arange(K, dtype=torch.float32) * (2 * np.pi / K)
    R = so3_exp(torch.stack([torch.zeros(K), yaw, torch.zeros(K)], -1))
    t = torch.stack([4 * torch.sin(yaw), torch.zeros(K), 4 - 4 * torch.cos(yaw)], -1)
    t = -(R @ t[..., None])[..., 0]
    pairs = [(k, k - 1) for k in range(1, K)] + [(k, k - 32) for k in range(32, K, 8)]
    i = torch.tensor([a for a, _ in pairs])
    j = torch.tensor([b for _, b in pairs])
    Rj, tj = se3_inverse(R[j], t[j])
    Rm, tm = se3_compose(R[i], t[i], Rj, tj)
    n = len(pairs)
    Rm = so3_exp(torch.randn(n, 3, generator=g) * 0.002) @ Rm
    tm = tm + torch.randn(n, 3, generator=g) * 0.005
    eR = torch.eye(3).repeat(E, 1, 1)
    et = torch.zeros(E, 3)
    eR[:n], et[:n] = Rm, tm
    ei = torch.zeros(E, dtype=torch.int32)
    ej = torch.zeros(E, dtype=torch.int32)
    ei[:n], ej[:n] = i.to(torch.int32), j.to(torch.int32)
    R0 = so3_exp(torch.randn(K, 3, generator=g) * 0.01) @ R
    t0 = t + torch.randn(K, 3, generator=g) * 0.05
    return PoseGraph(R=R0.to(dev), t=t0.to(dev), node_valid=torch.ones(K, dtype=torch.bool,
                                                                         device=dev),
                     node_fixed=(torch.arange(K) == 0).to(dev), edge_i=ei.to(dev),
                     edge_j=ej.to(dev), edge_R=eR.to(dev), edge_t=et.to(dev),
                     edge_valid=(torch.arange(E) < n).to(dev),
                     edge_weight=torch.where(torch.arange(E) < K - 1, 1.0, 5.0).to(dev))


def clustered_desc(rng, n: int, centres: int = 200):
    """``n`` packed descriptors (int32 words) around ``centres`` random
    ones, three bits of each word flipped."""
    c = rng.integers(0, 2 ** 32, (centres, 8), dtype=np.uint32)
    d = c[rng.integers(0, centres, n)]
    for _ in range(3):
        d ^= np.uint32(1) << rng.integers(0, 32, (n, 8)).astype(np.uint32)
    return d.view(np.int32)


def solver_cases(dev) -> dict:
    """``[solvers]``' inputs: entry point -> (program, inputs, other inputs
    of the same shapes (other traced ints) or None, keyword arguments,
    check of the captured output or None), at the system's default sizes
    (64 keyframes of 512 keypoints, an 8192-slot map, 64 x 64 words) and on
    the BAL and dry-run problems."""
    import torch

    from zenslam_tpu_torch.backend import ba, bow, keyframes, map_archive, pose_graph
    from zenslam_tpu_torch.io.bal import bal_subset_ba_problem, make_synthetic_bal
    from zenslam_tpu_torch.parallel import dist_ba, make_ba_mesh, shard_ba_problem
    from zenslam_tpu_torch.pipeline import SlamConfig, init_state
    from zenslam_tpu_torch.utils.graphs import eager

    rng = np.random.default_rng(17)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # tests/test_bal.py:77-100 (motion-only) and :173-186 (landmarks perturbed), here with trim
    bal_p, info = bal_subset_ba_problem(make_synthetic_bal(), device=dev)
    free = ~info["kf_fixed"]
    t_err0 = np.linalg.norm(bal_p.t.cpu().numpy()[free] - info["t_gt"][free], axis=-1).sum()
    bal_full = bal_p._replace(xyz=bal_p.xyz + up(np.random.default_rng(3).normal(
        0, 0.01, tuple(bal_p.xyz.shape)).astype(np.float32)))
    lm_err0 = np.linalg.norm(bal_full.xyz.cpu().numpy() - info["xyz_gt"], axis=-1).mean()

    def motion_only(r):
        t_err = np.linalg.norm(r["t"].cpu().numpy()[free] - info["t_gt"][free], axis=-1).sum()
        return (float(r["rmse_after"]) < float(r["rmse_before"]) and t_err < t_err0
                and torch.equal(r["xyz"], bal_p.xyz)), f"t error {t_err0:.4f} -> {t_err:.4f}"

    def full(r):
        lm_err = np.linalg.norm(r["xyz"].cpu().numpy() - info["xyz_gt"], axis=-1).mean()
        return (float(r["rmse_after"]) < 0.5 * float(r["rmse_before"]) and lm_err < lm_err0), (
            f"rmse {float(r['rmse_before']):.4f} -> {float(r['rmse_after']):.4f}, landmark "
            f"error {lm_err0:.5f} -> {lm_err:.5f}, trimmed {int(r['n_trimmed'])}")

    dp = dist_problem(dev)
    mesh8 = make_ba_mesh(8, device=dev)
    O = dp.obs_kf.shape[0]

    def cost_falls(r):
        cb, ca = float(r["cost_before"]), float(r["cost_after"])
        return ca < cb, f"cost {cb:.4f} -> {ca:.6f}"

    # the BoW side at the system's defaults: 8 keyframes' 512 descriptors
    kf_desc = up(clustered_desc(rng, 8 * 512)).reshape(8, 512, 8)
    kf_valid = up(rng.random((8, 512)) < 0.9)
    flat_desc, flat_valid = kf_desc.reshape(-1, 8), kf_valid.reshape(-1)
    draw = bow.GeneratorDraw(13, dev)
    with eager():
        vocab = bow.build_vocabulary_tree(flat_desc, flat_valid, branch=64, iters=6, draw=draw)
        hists = bow.descriptors_to_bow(vocab, kf_desc, kf_valid)
        bdb = bow.bow_db_init(64, vocab.n_words, device=dev)
        for f in range(6):
            bdb = bow.bow_db_add(bdb, hists[f], 10 * f)

    def kf_row(seed):
        r = np.random.default_rng(seed)
        lm = up(r.integers(-1, 8192, 512).astype(np.int32))
        return (up(np.eye(3, dtype=np.float32)), up(r.normal(0, 1, 3).astype(np.float32)),
                up(r.uniform(0, 1024, (512, 2)).astype(np.float32)), lm, lm >= 0,
                up(clustered_desc(r, 512)))

    def kf_kw(seed):
        r = np.random.default_rng(seed + 1)
        return dict(kp_uvr=up(r.uniform(0, 1024, (512, 2)).astype(np.float32)),
                    kp_stereo=up(r.random(512) < 0.7),
                    kp_lm_gen=up(r.integers(0, 3, 512).astype(np.int32)),
                    kp_xyz=up(r.normal(0, 3, (512, 3)).astype(np.float32)))

    kdb = keyframes.kf_db_init(64, 512, device=dev)
    with eager():
        for f in range(5):
            kdb = keyframes.kf_db_add(kdb, *kf_row(f), 4 * f, **kf_kw(f))

    lmap = init_state(SlamConfig(), (SIZE, SIZE), device=dev).lmap
    lmap = lmap._replace(xyz=up(rng.normal(0, 3, (8192, 3)).astype(np.float32)),
                         valid=up(rng.random(8192) < 0.8), desc=up(clustered_desc(rng, 8192)),
                         last_seen=up(rng.integers(0, 60, 8192).astype(np.int32)),
                         color=up(rng.random(8192).astype(np.float32)))
    cand = (up(rng.normal(0, 3, (128, 3)).astype(np.float32)), up(clustered_desc(rng, 128)),
            up(rng.random(128) < 0.9))

    def placed(out):
        n = int(out[2].sum())
        return n > 0, f"{n} of 128 placed"

    return {
        "bundle_adjust (BAL, motion-only)": (
            ba.bundle_adjust, (bal_p,), None, dict(iterations=12, huber_delta=1.0,
                                                   refine_landmarks=False), motion_only),
        "bundle_adjust (BAL, landmarks perturbed, trim)": (
            ba.bundle_adjust, (bal_full,), None, dict(iterations=15, huber_delta=1.0,
                                                      trim_threshold=2.0), full),
        "bundle_adjust_cg (BAL, motion-only)": (
            ba.bundle_adjust_cg, (bal_p,), None, dict(iterations=12, cg_iters=40,
                                                      refine_landmarks=False), motion_only),
        "dist_bundle_adjust (dry run, 8 shards)": (
            dist_ba.dist_bundle_adjust, (shard_ba_problem(dp, 8), mesh8), None,
            dict(iterations=DIST_ITERS), cost_falls),
        "shard_ba_problem_device (dry run, 8 shards)": (
            dist_ba.shard_ba_problem_device, (dp, 8, 2 * -(-O // 8)), None, {}, None),
        "optimize_pose_graph (64 nodes, 256 edge rows)": (
            pose_graph.optimize_pose_graph, (ring_graph(dev),), None, dict(iterations=15),
            cost_falls),
        "build_vocabulary_tree (4096 rows, branch 64)": (
            bow.build_vocabulary_tree, (flat_desc, flat_valid), None,
            dict(branch=64, iters=6, draw=draw), None),
        "build_vocabulary (4096 rows, 128 words, default draw)": (
            bow.build_vocabulary, (flat_desc, flat_valid), None, dict(n_words=128, iters=6),
            None),
        "descriptors_to_bow (8 x 512)": (
            bow.descriptors_to_bow, (vocab, kf_desc, kf_valid), None, {}, None),
        "bow_db_add": (bow.bow_db_add, (bdb, hists[6], 60), (bdb, hists[7], 70), {}, None),
        "bow_db_query": (bow.bow_db_query, (bdb, hists[7], 70, 40), (bdb, hists[6], 55, 20),
                         dict(top_k=3), None),
        "kf_db_add (64 x 512)": (keyframes.kf_db_add, (kdb, *kf_row(10), 40), (
            kdb, *kf_row(11), 44), kf_kw(10), None),
        "kf_db_update_poses": (keyframes.kf_db_update_poses, (
            kdb, kdb.R.flip(0).contiguous(), kdb.t + 0.5), None, {}, None),
        "reload_into_map (8192 slots, 128 rows)": (
            map_archive.reload_into_map, (lmap, *cand, 61), (lmap, *cand, 75), {}, placed),
        "_pack_live (8192 slots)": (map_archive._pack_live, (lmap,), None, {}, None),
    }


def phase_solvers(dev) -> dict:
    """``[solvers]``: every public back-end entry point that the reference
    jits, called directly as a caller would, captured (``utils/graphs.py``)
    against ``graphs.eager()``: the first call (the capture), then
    SOLVER_REPEATS calls each way, host ms up to a synchronise; every output
    bit-identical to the eager call's, the first call's output unchanged by
    the later ones (the caller's), the inputs unchanged, other traced ints
    through the same capture; the BAL and solver checks of the reference's
    tests; captures, graphs held and peak memory. Returns the launches
    (none: no kernel is on this path)."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.utils.graphs import Program, eager, graphs_held

    t0 = time.perf_counter()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    card = card_line()
    held_start = graphs_held()

    def named(tree) -> dict:
        return {str(i): t for i, t in enumerate(tree_tensors(tree))}

    def host_ms(fn) -> tuple:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    for name, (prog, a, b, kw, check) in solver_cases(dev).items():
        require(isinstance(prog, Program) and prog.copy_outputs,
                f"solvers: {name} is not a program returning the caller's outputs")
        inputs = {k: v.clone() for k, v in named((a, b, kw)).items()}
        held0 = graphs_held()
        first, cap_ms = host_ms(lambda: prog(*a, **kw))
        kept = {k: v.clone() for k, v in named(first).items()}
        graphed = [host_ms(lambda: prog(*a, **kw)) for _ in range(SOLVER_REPEATS)]
        with eager():
            eager_runs = [host_ms(lambda: prog(*a, **kw)) for _ in range(SOLVER_REPEATS)]
        captures = graphs_held() - held0
        want = named(eager_runs[0][0])
        off = [parted(want, named(g)) for g, _ in graphed]
        extra = ""
        if b is not None:
            got_b = prog(*b, **kw)
            with eager():
                want_b = prog(*b, **kw)
            off.append(parted(named(want_b), named(got_b)))
            require(graphs_held() - held0 == captures, f"solvers: {name}: other traced ints "
                                                       "captured anew")
            extra = "; other traced ints through the same capture, bit-identical"
        require(not any(off), f"solvers: {name}: captured parts from eager in {off}")
        require(not parted(kept, named(first)),
                f"solvers: {name}: the first call's output changed under later calls")
        require(not parted(inputs, named((a, b, kw))), f"solvers: {name}: an input was written")
        ok, note = check(first) if check else (True, "")
        require(ok, f"solvers: {name}: {note}")
        g_ms = float(np.median([m for _, m in graphed]))
        e_ms = float(np.median([m for _, m in eager_runs]))
        first_is = "warm-up + capture" if captures else "a replay: an earlier phase captured it"
        print(f"[solvers] {name}: first call ({first_is}) {cap_ms:.2f} ms, captured "
              f"{g_ms:.3f} ms, eager {e_ms:.3f} ms a call (host, up to a synchronise, medians "
              f"of {SOLVER_REPEATS}); {len(want)} outputs bit-identical to eager, the first "
              f"kept unchanged, inputs unwritten{extra}; captures {captures}"
              + (f"; {note}" if note else ""))
    launches = read_launches()
    print(f"[solvers] graphs held {graphs_held()} ({graphs_held() - held_start} by this phase), "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; {card}; launches "
          f"{launches}; phase {time.perf_counter() - t0:.1f} s")
    return launches


def frontend_cases(seq, xy, valid, dev) -> dict:
    """``[frontend]``'s inputs: entry point -> (program, inputs, other
    inputs of the same shapes with other values and other traced floats,
    keyword arguments), at the default ``SlamConfig``'s sizes on the
    benchmark's 1024² frames (512 keypoints, an 8192-slot map, 128-row
    RANSAC noise), keylines as ``options/euroc_mh_lines.yaml`` (64 a
    frame) on the corridor with stripes, the IMU at 200 Hz against 20 Hz
    frames, the render at 1024²."""
    import torch

    from zenslam_tpu_torch.estimation import cascade, epipolar, fusion, pnp, rigid
    from zenslam_tpu_torch.estimation.ransac import gumbel
    from zenslam_tpu_torch.geometry.camera import fundamental_from_rig, project
    from zenslam_tpu_torch.geometry.lie import se3_apply, so3_exp
    from zenslam_tpu_torch.imu import continuous, gravity, preintegration
    from zenslam_tpu_torch.io import synthetic
    from zenslam_tpu_torch.ops import (
        dog, fast, freak, harris, image, lines, lk, match, orb, sift)
    from zenslam_tpu_torch.pipeline import SlamConfig, state as pstate
    from zenslam_tpu_torch.utils.device import upload
    from zenslam_tpu_torch.utils.graphs import eager

    cfg = SlamConfig()
    N, M = cfg.max_keypoints, cfg.max_landmarks
    rng = np.random.default_rng(23)
    g = torch.Generator(device=dev).manual_seed(23)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    img0, img1 = seq.left[0], seq.left[1]
    xy1 = xy + rand(N, 2) - 0.5
    valid1 = valid & (rand(N) > 0.1)
    lseq = synthetic.make_sequence(np.random.default_rng(11), n_frames=3, width=SIZE,
                                   height=SIZE, motion="strafe", with_lines=True,
                                   with_imu=True, device_render=True, device=dev)
    with eager():
        sm0, sm1 = image.gaussian_blur(img0, 2.0, 4), image.gaussian_blur(img1, 2.0, 4)
        pyr0, pyr1 = image.build_pyramid(img0, cfg.pyramid_levels), image.build_pyramid(
            img1, cfg.pyramid_levels)
        score0, score1 = fast.fast_score(img0), fast.fast_score(img1)
        desc0, desc1 = orb.orb_descriptors(img0, xy, valid)[0], orb.orb_descriptors(
            img1, xy1, valid1)[0]
        fd0, fd1 = sift.sift_descriptors(img0, xy, valid), sift.sift_descriptors(img1, xy1,
                                                                                 valid1)
        kl = [lines.detect_keylines(lseq.left[t], torch.zeros((64, 2, 2), device=dev),
                                    torch.zeros(64, dtype=torch.bool, device=dev),
                                    min_length=cfg.line_min_length) for t in (0, 1)]
    # the map side: 8192 slots of descriptors and projections
    lm_desc = up(clustered_desc(rng, M))
    lm_fd = rand(M, 128)
    lm_fd = lm_fd / lm_fd.norm(dim=-1, keepdim=True)
    proj, proj1 = rand(M, 2) * SIZE, rand(M, 2) * SIZE
    lm_valid, lm_valid1 = rand(M) > 0.3, rand(M) > 0.3
    with eager():
        gate, gate1 = match.radius_gate(xy, proj, 20.0), match.radius_gate(xy1, proj1, 20.0)
    require(cfg.landmark_match_distance == 64, "frontend: the match case's max_distance")
    F = fundamental_from_rig(seq.rig)
    H_, W_ = img0.shape
    v, u = torch.meshgrid(torch.arange(H_, dtype=torch.float32, device=dev),
                          torch.arange(W_, dtype=torch.float32, device=dev), indexing="ij")
    maps = [(u + rand(H_, W_) * 2 - 1, v + rand(H_, W_) * 2 - 1) for _ in range(2)]

    # IMU: 10 samples of 5 ms a frame (200 Hz against 20 Hz frames)
    def imu(t):
        return tuple(up(np.asarray(x[t], np.float32)) for x in (lseq.gyro, lseq.accel,
                                                                 lseq.imu_dts)) + (
            up(lseq.imu_mask[t]),)

    def cont(t, t0, t1):
        gy, ac, d, m = imu(t)
        d_np = np.where(lseq.imu_mask[t], lseq.imu_dts[t], 0.0).astype(np.float32)
        ts = up(np.cumsum(d_np) - 0.5 * d_np)
        return ts, gy, ac, m, t0, t1

    n_imu = lseq.gyro.shape[1]
    span = float(np.where(lseq.imu_mask[1], lseq.imu_dts[1], 0.0).sum())

    def grav_est(n):
        return gravity.GravityEstimator(
            samples=rand(64, 3) + torch.tensor([0.0, 9.8, 0.0], device=dev),
            valid=torch.arange(64, device=dev) < n,
            next_slot=torch.full((), n % 64, dtype=torch.int32, device=dev))

    def grav_args(k, dt01, dt12):
        p0 = rand(3)
        vel = torch.tensor([0.4, 0.0, 0.1], device=dev)
        R = so3_exp(torch.tensor([0.0, 0.05 * k, 0.0], device=dev))
        return (grav_est(20 + k), p0, p0 + dt01 * vel, p0 + (dt01 + dt12) * vel
                + torch.tensor([0.0, 0.01, 0.0], device=dev), dt01, dt12, R,
                torch.tensor([0.1, -9.7, 0.2], device=dev))

    def tel(k):
        ints = [torch.randint(0, 500, (), generator=g, device=dev) for _ in range(6)]
        return pstate.FrameTelemetry(
            *ints[:5], pose_method=torch.full((), k, dtype=torch.int32, device=dev),
            pose_ok=torch.ones((), dtype=torch.bool, device=dev), tracked_ratio=rand(),
            is_keyframe=torch.full((), k == 0, device=dev), map_size=ints[5],
            n_lines=torch.full((), 3 + k, device=dev), n_line_triangulated=ints[0] % 7,
            line_map_size=ints[1], R_cw=so3_exp(rand(3) * 0.1), t_cw=rand(3))

    # geometry: 512 points 2-5 m ahead, seen from two poses, 10% outliers
    rig = seq.rig
    K = rig.left.K

    def scene(k):
        X = torch.stack([rand(N) * 4 - 2, rand(N) * 3 - 1.5, rand(N) * 3 + 2], -1)
        R0 = so3_exp(torch.tensor([0.01, 0.02, 0.0], device=dev) * k)
        t0 = torch.tensor([0.05 * k, 0.0, 0.0], device=dev)
        R1 = so3_exp(torch.tensor([0.0, 0.05, 0.01], device=dev)) @ R0
        t1 = t0 + torch.tensor([0.3, 0.02, 0.05], device=dev)
        uv0 = project(rig.left, se3_apply(R0, t0, X))
        out = (rand(N) < 0.1)[:, None]
        uv1 = project(rig.left, se3_apply(R1, t1, X)) + (rand(N, 2) - 0.5) * 0.6
        uv1 = torch.where(out, uv1 + rand(N, 2) * 60 - 30, uv1)
        uv_r = project(rig.right, se3_apply(rig.R_rl, rig.t_rl, se3_apply(R1, t1, X)))
        return dict(X=X, R0=R0, t0=t0, R1=R1, t1=t1, uv0=uv0, uv1=uv1, uv_r=uv_r,
                    valid=rand(N) > 0.05)

    sc = [scene(1), scene(2)]

    def rigid_args(s):
        dst = se3_apply(s["R0"], s["t0"], s["X"]) + (rand(N, 3) - 0.5) * 0.02
        return gumbel(g, (cfg.rigid_iters, N), dev), s["X"], dst, s["valid"]

    def pnp_args(s):
        return (gumbel(g, (2, cfg.pnp_iters, N), dev), torch.stack([K, rig.right.K]),
                torch.stack([s["X"], s["X"]]), torch.stack([s["uv1"], s["uv_r"]]),
                torch.stack([s["valid"], s["valid"]]))

    def pnp_kw(s):
        return dict(threshold=cfg.pnp_threshold, R_init=torch.stack([s["R1"], s["R1"]]),
                    t_init=torch.stack([s["t1"], s["t1"]]))

    def cands():
        return fusion.PoseCandidate(
            R=so3_exp(rand(5, 3) * 0.1), t=rand(5, 3) * 0.2, inlier_ratio=rand(5),
            mean_err=rand(5) * 3, n_inliers=torch.randint(0, 400, (5,), generator=g,
                                                           device=dev),
            is_line=torch.zeros(5, dtype=torch.bool, device=dev),
            valid=torch.tensor([True, True, False, True, True], device=dev))

    scales = torch.tensor([3.0, 3.0, 0.1, 3.0, 0.1], device=dev)

    def cascade_args(s):
        noise = cascade.draw_cascade_noise(g, N, cfg.pnp_iters, cfg.rigid_iters,
                                           cfg.essential_iters, dev)
        Xc = se3_apply(s["R0"], s["t0"], s["X"])
        return (noise, rig, s["X"], s["uv1"], s["valid"], s["X"], s["uv_r"], s["valid"], Xc,
                se3_apply(s["R1"], s["t1"], s["X"]), s["valid"], s["R0"], s["t0"], s["uv0"],
                s["uv1"], s["valid"], Xc, s["valid"], s["R0"], s["t0"], rand() * 0.05)

    def ess(s):
        return gumbel(g, (cfg.essential_iters, N), dev), K, s["uv0"], s["uv1"], s["valid"]

    def recover(s):
        a = ess(s)
        with eager():
            E = epipolar.solve_essential_ransac(*a)["E"]
        return E, K, s["uv0"], s["uv1"], s["valid"]

    def two_d(s):
        noise = gumbel(g, (cfg.essential_iters, N), dev)
        return (noise, K, s["uv0"], s["uv1"], s["valid"], se3_apply(s["R0"], s["t0"], s["X"]),
                s["valid"], s["R0"], s["t0"])

    world = synthetic.make_corridor_world(np.random.default_rng(11))
    world_arrays = (*(upload(np.asarray(a, np.float32), dev) for a in (
        world.normals, world.offsets, world.origins, world.u_axes, world.v_axes,
        world.textures)), float(world.tex_scale))
    cam = [float(x) for x in (rig.left.fx, rig.left.fy, rig.left.cx, rig.left.cy)]

    def render(k):
        R = so3_exp(torch.tensor([0.0, 0.03 * k, 0.0], device=dev))
        return (world_arrays, *cam, R, torch.tensor([0.1 * k, 0.0, 0.5], device=dev), SIZE,
                SIZE)

    lk_kw = dict(radius=cfg.klt_radius, iters=cfg.klt_iters)
    grid = dict(cell_size=cfg.cell_size, max_keypoints=N, border=cfg.detect_border,
                subpixel=cfg.subpixel_detect)
    return {
        "gaussian_blur (sigma 2, radius 4)": (image.gaussian_blur, (img0,), (img1,),
                                              dict(sigma=2.0, radius=4)),
        "build_pyramid (4 levels)": (image.build_pyramid, (img0,), (img1,),
                                     dict(levels=cfg.pyramid_levels)),
        "remap (1024x1024 maps)": (image.remap, (img0, *maps[0]), (img1, *maps[1]), {}),
        "clahe (grid 8, clip 4)": (image.clahe, (img0,), (img1,),
                                   dict(clip_limit=cfg.clahe_clip)),
        "scharr_gradients": (image.scharr_gradients, (img0,), (img1,), {}),
        "fast_score": (fast.fast_score, (img0,), (img1,), dict(threshold=cfg.fast_threshold)),
        "select_grid_keypoints": (fast.select_grid_keypoints, (score0, xy, valid),
                                  (score1, xy1, valid1), grid),
        "detect_grid_keypoints": (fast.detect_grid_keypoints, (img0, xy, valid),
                                  (img1, xy1, valid1), dict(grid, threshold=cfg.fast_threshold)),
        "orb_orientation": (orb.orb_orientation, (sm0, xy), (sm1, xy1), {}),
        "orb_descriptors": (orb.orb_descriptors, (img0, xy, valid), (img1, xy1, valid1), {}),
        "hamming_matrix (512 x 8192)": (match.hamming_matrix, (desc0, lm_desc),
                                        (desc1, lm_desc.flip(0).contiguous()), {}),
        "match_descriptors (512 x 8192, radius gate)": (
            match.match_descriptors, (desc0, lm_desc, valid, lm_valid, 64, 0.8, True, False,
                                      gate),
            (desc1, lm_desc.flip(0).contiguous(), valid1, lm_valid1, 64, 0.8, True, False,
             gate1), {}),
        "l2_matrix (512 x 8192)": (match.l2_matrix, (fd0, lm_fd),
                                   (fd1, lm_fd.flip(0).contiguous()), {}),
        "match_descriptors_float (512 x 8192, ratio)": (
            match.match_descriptors_float, (fd0, lm_fd, valid, lm_valid),
            (fd1, lm_fd.flip(0).contiguous(), valid1, lm_valid1),
            dict(max_distance=cfg.float_match_distance, use_ratio=True)),
        "lsh_binarize (512 x 128)": (match.lsh_binarize, (fd0,), (fd1,), {}),
        "radius_gate (512 x 8192)": (match.radius_gate, (xy, proj, 20.0), (xy1, proj1, 20.0),
                                     {}),
        "epipolar_gate (512 x 512)": (match.epipolar_gate, (F, xy, xy1, 3.0),
                                      (F, xy1, xy, 3.0), {}),
        "pyramidal_lk (level tuples)": (lk.pyramidal_lk, (pyr0, pyr1, xy, valid),
                                        (pyr1, pyr0, xy1, valid1), {}),
        "pyramidal_lk (stacked)": (lk.pyramidal_lk, (lk.stack_pyramid(pyr0),
                                                     lk.stack_pyramid(pyr1), xy, valid),
                                   (lk.stack_pyramid(pyr1), lk.stack_pyramid(pyr0), xy1,
                                    valid1), lk_kw),
        "lk_forward_backward": (lk.lk_forward_backward, (lk.stack_pyramid(pyr0),
                                                         lk.stack_pyramid(pyr1), xy, valid),
                                (lk.stack_pyramid(pyr1), lk.stack_pyramid(pyr0), xy1, valid1),
                                lk_kw),
        "harris_score": (harris.harris_score, (img0,), (img1,), {}),
        "harris_score_multiscale": (harris.harris_score_multiscale, (img0,), (img1,),
                                    dict(threshold=cfg.harris_threshold)),
        "dog_score": (dog.dog_score, (img0,), (img1,), dict(threshold=cfg.dog_threshold)),
        "sift_descriptors": (sift.sift_descriptors, (img0, xy, valid), (img1, xy1, valid1), {}),
        "freak_descriptors": (freak.freak_descriptors, (img0, xy, valid), (img1, xy1, valid1),
                              {}),
        "detect_keylines (64, corridor with stripes)": (
            lines.detect_keylines, (lseq.left[0], kl[1][0], kl[1][2]),
            (lseq.left[1], kl[0][0], kl[0][2]), dict(min_length=cfg.line_min_length)),
        "keyline_descriptors (64)": (lines.keyline_descriptors, (lseq.left[0], kl[0][0],
                                                                 kl[0][2]),
                                     (lseq.left[1], kl[1][0], kl[1][2]), {}),
        f"preintegrate ({n_imu} samples)": (preintegration.preintegrate, imu(1), imu(2), {}),
        "preintegrate_continuous (lpm, traced t0/t1)": (
            continuous.preintegrate_continuous, cont(1, 0.0, span), cont(2, 0.0013, span - 0.004),
            dict(n_grid=n_imu)),
        "preintegrate_continuous (ugpm, traced t0/t1)": (
            continuous.preintegrate_continuous, cont(1, 0.0, span), cont(2, 0.0021, span - 0.003),
            dict(n_grid=n_imu, method="ugpm")),
        "gravity_add_sample (traced dt01/dt12)": (gravity.gravity_add_sample,
                                                  grav_args(0, 0.05, 0.05),
                                                  grav_args(1, 0.045, 0.0575), {}),
        "gravity_estimate": (gravity.gravity_estimate, (grav_est(30),), (grav_est(41),), {}),
        "pack_telemetry": (pstate.pack_telemetry, (tel(0),), (tel(1),), {}),
        "solve_rigid_ransac": (rigid.solve_rigid_ransac, rigid_args(sc[0]), rigid_args(sc[1]),
                               dict(threshold=cfg.rigid_threshold)),
        "solve_pnp_ransac (cam0 + cam1, priors)": (pnp.solve_pnp_ransac, pnp_args(sc[0]),
                                                   pnp_args(sc[1]), pnp_kw(sc[0])),
        "fuse_poses": (fusion.fuse_poses, (cands(), scales), (cands(), scales), {}),
        "estimate_pose_cascade (fused)": (cascade.estimate_pose_cascade, cascade_args(sc[0]),
                                          cascade_args(sc[1]), dict(fuse=True)),
        "solve_fundamental_ransac": (epipolar.solve_fundamental_ransac, (
            gumbel(g, (256, N), dev), sc[0]["uv0"], sc[0]["uv1"], sc[0]["valid"]), (
            gumbel(g, (256, N), dev), sc[1]["uv0"], sc[1]["uv1"], sc[1]["valid"]), {}),
        "solve_fundamental_ransac (default draw)": (
            epipolar.solve_fundamental_ransac, (None, sc[0]["uv0"], sc[0]["uv1"], sc[0]["valid"]),
            (None, sc[1]["uv0"], sc[1]["uv1"], sc[1]["valid"]), {}),
        "solve_essential_ransac": (epipolar.solve_essential_ransac, ess(sc[0]), ess(sc[1]),
                                   dict(threshold=cfg.essential_threshold)),
        "recover_pose_from_essential": (epipolar.recover_pose_from_essential, recover(sc[0]),
                                        recover(sc[1]), {}),
        "estimate_2d2d_scaled": (epipolar.estimate_2d2d_scaled, two_d(sc[0]), two_d(sc[1]),
                                 dict(threshold=cfg.essential_threshold)),
        "_render_view_device (1024x1024)": (synthetic._render_view_device, render(0),
                                            render(1), {}),
    }


def frontend_programs() -> dict:
    """The front end's, IMU's, estimators', telemetry's and render's
    programs (the reference's jits there) by name."""
    from zenslam_tpu_torch.estimation import cascade, epipolar, fusion, pnp, rigid
    from zenslam_tpu_torch.imu import continuous, gravity, preintegration
    from zenslam_tpu_torch.io import synthetic
    from zenslam_tpu_torch.ops import dog, fast, freak, harris, image, lines, lk, match, orb, sift
    from zenslam_tpu_torch.pipeline import state
    from zenslam_tpu_torch.utils.graphs import Program

    mods = (cascade, epipolar, fusion, pnp, rigid, continuous, gravity, preintegration,
            synthetic, dog, fast, freak, harris, image, lines, lk, match, orb, sift, state)
    return {f"{m.__name__.split('.')[-1]}.{k}": v for m in mods for k, v in vars(m).items()
            if isinstance(v, Program) and v.__module__ == m.__name__}


def phase_frontend(seq, xy, valid, dev) -> dict:
    """``[frontend]``: every library function that the reference jits in
    its front end, IMU, estimators, telemetry and device render, called
    directly as a caller would, captured (``utils/graphs.py``) against
    ``graphs.eager()``: the first call (the capture), then SOLVER_REPEATS
    calls each way, host ms up to a synchronise; every output bit-identical
    to the eager call's, the first call's output unchanged by a second call
    with other values (the caller's), the inputs unchanged, the other
    values and traced floats through the same capture; captures, graphs
    held and peak memory. Returns the launches (none: the hand kernels are
    not on this path)."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.utils.graphs import Program, eager, graphs_held

    t0 = time.perf_counter()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    card = card_line()
    held_start = graphs_held()
    cases = frontend_cases(seq, xy, valid, dev)
    progs = frontend_programs()
    covered = {p for p, *_ in cases.values()}
    require(len(progs) == 40 and all(p in covered for p in progs.values()),
            f"frontend: {len(progs)} programs, not driven: "
            f"{[k for k, p in progs.items() if p not in covered]}")

    def named(tree) -> dict:
        return {str(i): t for i, t in enumerate(tree_tensors(tree))}

    def host_ms(fn) -> tuple:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    rows = []
    for name, (prog, a, b, kw) in cases.items():
        require(isinstance(prog, Program) and prog.copy_outputs,
                f"frontend: {name} is not a program returning the caller's outputs")
        inputs = {k: v.clone() for k, v in named((a, b, kw)).items()}
        held0 = len(prog.captured)
        first, cap_ms = host_ms(lambda: prog(*a, **kw))
        kept = {k: v.clone() for k, v in named(first).items()}
        graphed = [host_ms(lambda: prog(*a, **kw)) for _ in range(SOLVER_REPEATS)]
        with eager():
            eager_runs = [host_ms(lambda: prog(*a, **kw)) for _ in range(SOLVER_REPEATS)]
        captures = len(prog.captured) - held0
        got_b = prog(*b, **kw)
        with eager():
            want_b = prog(*b, **kw)
        want = named(eager_runs[0][0])
        off = [parted(want, named(g)) for g, _ in graphed] + [parted(named(want_b),
                                                                     named(got_b))]
        require(len(prog.captured) - held0 == captures,
                f"frontend: {name}: other values (traced floats) captured anew")
        require(not any(off), f"frontend: {name}: captured parts from eager in {off}")
        require(not parted(kept, named(first)),
                f"frontend: {name}: the first call's output changed under a later call")
        require(parted(kept, named(got_b)),
                f"frontend: {name}: the other inputs gave the same output")
        require(not parted(inputs, named((a, b, kw))), f"frontend: {name}: an input was written")
        g_ms = float(np.median([m for _, m in graphed]))
        e_ms = float(np.median([m for _, m in eager_runs]))
        rows.append((name, cap_ms, g_ms, e_ms, captures))
        first_is = "warm-up + capture" if captures else "a replay: an earlier phase captured it"
        print(f"[frontend] {name}: first call ({first_is}) {cap_ms:.2f} ms, captured "
              f"{g_ms:.3f} ms, eager {e_ms:.3f} ms a call (host, up to a synchronise, medians "
              f"of {SOLVER_REPEATS}); {len(want)} outputs bit-identical to eager, the first "
              f"kept unchanged, inputs unwritten, other values through the same capture; "
              f"captures {captures}")
    # a caller's generator: registered with the graph, not reseeded, its
    # draws advancing call after call as eager ones do
    from zenslam_tpu_torch.estimation.epipolar import solve_fundamental_ransac

    fa = cases["solve_fundamental_ransac"][1][1:]
    gens = [torch.Generator(device=dev).manual_seed(5) for _ in range(2)]
    got = [solve_fundamental_ransac(None, *fa, generator=gens[0]) for _ in range(3)]
    with eager():
        want = [solve_fundamental_ransac(None, *fa, generator=gens[1]) for _ in range(3)]
    off = [parted(named(w), named(g)) for w, g in zip(want, got)]
    print(f"[frontend] solve_fundamental_ransac with a caller's generator, 3 calls each way: "
          f"bit-identical {not any(off)}, the calls' inliers {[int(g['n_inliers']) for g in got]}")
    require(not any(off), f"frontend: a caller's generator: captured parts from eager {off}")
    launches = read_launches()
    faster = [n for n, _, g_ms, e_ms, _ in rows if g_ms < e_ms]
    print(f"[frontend] captured faster than eager on {len(faster)} of {len(rows)} calls; sum of "
          f"host ms a call captured {sum(r[2] for r in rows):.2f}, eager "
          f"{sum(r[3] for r in rows):.2f}; first calls {sum(r[1] for r in rows) / 1e3:.2f} s")
    print(f"[frontend] graphs held {graphs_held()} ({graphs_held() - held_start} by this phase), "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; {card}; launches "
          f"{launches}; phase {time.perf_counter() - t0:.1f} s")
    require(launches == {"lk_fb": 0, "orb": 0}, f"frontend: hand kernels launched {launches}")
    return launches


def tree_tensors(tree) -> list:
    """The tensors of ``tree``, in ``graphs.flatten``'s order."""
    from zenslam_tpu_torch.utils.graphs import flatten

    leaves = []
    flatten(tree, leaves)
    return leaves


def same_bits(a, b) -> bool:
    """Whether two tensors (compared on their device, floats as their bit
    patterns) or two numpy arrays are identical."""
    import torch

    if not isinstance(a, torch.Tensor):
        return np.shape(a) == np.shape(b) and np.array_equal(a, b, equal_nan=True)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return torch.equal(a, b)


def parted(a: dict, b: dict) -> list:
    """The names whose values differ in any bit between two runs' outputs."""
    return [k for k in a if not same_bits(a[k], b[k])]


def _f64(x) -> np.ndarray:
    import torch

    return x.double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def held_to_eager(tag: str, what: str, e1: dict, g: dict, again) -> None:
    """Require the graphed run's outputs ``g`` bit-identical to the eager
    run's ``e1``; where they part, run eager ``again()`` and hold the graphed
    outputs within the spread of the two eager runs, naming them."""
    off = parted(e1, g)
    if not off:
        print(f"[{tag}] {what}: graphed bit-identical to eager ({len(e1)} outputs)")
        return
    e2 = again()
    spread = {k: float(np.max(np.abs(_f64(e2[k]) - _f64(e1[k])), initial=0.0))
              for k in off if np.shape(e1[k]) == np.shape(e2[k])}
    gap = {k: float(np.max(np.abs(_f64(g[k]) - _f64(e1[k])), initial=0.0))
           for k in off if np.shape(e1[k]) == np.shape(g[k])}
    print(f"[{tag}] {what}: graphed parts from eager on {off}; two eager runs part on "
          f"{parted(e1, e2)}; max |graphed - eager| {gap}, eager's own spread {spread}")
    require(all(k in spread and k in gap and gap[k] <= spread[k] for k in off),
            f"{tag}: graphed outside eager's own spread on {off}")


def slice_run(seq, dev, graphed: bool, states: bool) -> dict:
    """The slice's N_FRAMES frames through ``make_slam_step`` (graphed, or
    under ``graphs.eager()``): host ms/frame over the frames after N_WARMUP
    (up to a synchronise), every frame's packed telemetry and, with
    ``states``, every frame's state, copied."""
    import torch

    from zenslam_tpu_torch.pipeline import SlamConfig, init_state, make_slam_step
    from zenslam_tpu_torch.utils.graphs import eager, fresh

    cfg = SlamConfig()
    step = make_slam_step(cfg, seq.rig)
    s = init_state(cfg, (SIZE, SIZE), device=dev)
    out = {"tel": [], "state": []}
    with contextlib.nullcontext() if graphed else eager():
        for t in range(N_FRAMES):
            if t == N_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            s, _, p = step.run(s, seq.left[t], seq.right[t])
            out["tel"].append(p)
            if states:
                out["state"].append(fresh(s) if graphed else s)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3 / (N_FRAMES - N_WARMUP)
        out["step"], out["last"] = step, s
    return out


def hand_kernel_events(prof) -> dict:
    """The hand kernels' launches that a ``torch.profiler`` trace saw on the
    device, by kernel name (inside a graph replay too)."""
    import torch

    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"lk_fb": sum(bool(re.search(r"\blk_fb_kernel\b", n)) for n in names),
            "orb": sum(bool(re.search(r"\borb_kernel\b", n)) for n in names)}


def counted_on_device(tag: str, prof, before: dict) -> dict:
    """Require the hand kernels' events in ``prof`` to equal their counters'
    increase since ``before`` (the count of a replay is the one its capture
    recorded: this holds it to what ran). Returns the counts."""
    seen, counted = hand_kernel_events(prof), _since_counts(before)
    require(seen == counted, f"{tag}: the trace saw kernels {seen}, the counters rose by "
                             f"{counted}")
    return seen


def _since_counts(before: dict) -> dict:
    return {k: v - before[k] for k, v in read_launches().items()}


def profiled_frames(step, state, seq, first: int, n: int, graphed: bool) -> tuple:
    """(device busy ms, device events, graph launches, hand kernel launches)
    a frame over ``n`` frames of ``step`` from ``state`` (``torch.profiler``);
    the hand kernels' events in the trace must equal their counters'
    increase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zenslam_tpu_torch.utils.graphs import eager

    with contextlib.nullcontext() if graphed else eager():
        torch.cuda.synchronize()
        before = read_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for t in range(first, first + n):
                state, _ = step(state, seq.left[t], seq.right[t])
            torch.cuda.synchronize()
    kernels = counted_on_device(f"graphs: {'graphed' if graphed else 'eager'} frames", prof,
                                before)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    graph_launches = sum(e.count for e in prof.key_averages() if e.key == "cudaGraphLaunch")
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / n, len(events) / n,
            graph_launches / n, {k: v / n for k, v in kernels.items()})


def system_outputs(s, tels) -> dict:
    """What ``[graphs]`` holds two system runs to: every frame's pose and
    keyframe flag, the keyframe database, the BA runs, the loop verdicts,
    the pose-graph edges, the archive, the vocabulary and the BoW
    database."""
    out = {"R": np.stack([t.R_cw for t in tels]), "t": np.stack([t.t_cw for t in tels]),
           "is_kf": np.array([bool(t.is_keyframe) for t in tels]),
           "counts": np.array([s.n_keyframes, s.n_ba_runs, s.n_loop_closures, s.n_relocs,
                               s.n_vocab_trains, len(s.edge_i)]),
           "loop_scores": np.array([d["score"] for d in s.loop_debug], np.float64),
           "loop_fired": np.array([d["fired"] for d in s.loop_debug]),
           "edges": np.array([s.edge_i, s.edge_j, s.edge_w], np.float64).reshape(3, -1)}
    for k, a in zip(s.kf_db._fields, tree_tensors(s.kf_db)):
        out[f"kf_db.{k}"] = a
    for k, a in zip(s.bow_db._fields, tree_tensors(s.bow_db)):
        out[f"bow_db.{k}"] = a
    for i, a in enumerate(tree_tensors(s.vocab)):
        out[f"vocab.{i}"] = a
    for name in ("edge_R", "edge_t"):
        for i, a in enumerate(tree_tensors(getattr(s, name))):
            out[f"{name}.{i}"] = a
    if s.archive is not None:
        a = s.archive
        out.update({"archive.xyz": a.xyz, "archive.desc": a.desc, "archive.dormant": a.dormant,
                    "archive.counts": np.array([a.n_reloads, a.n_spills])})
    return out


def keyframe_programs(s) -> dict:
    """The system's captured programs by name: the shared ones, and the
    snapshot and epoch programs of system ``s`` (None until ``s`` makes
    them)."""
    from zenslam_tpu_torch.pipeline import system

    own = s.snap_programs
    return {"snapshot": own and own.snapshot, "epoch": own and own.epoch,
            "kf_add": system._KF_ADD, "ba": system._WINDOWED_BA, "loop_gate": system._LOOP_GATE,
            "reloc_gate": system._RELOC_GATE, "pose_graph": system._POSE_GRAPH,
            "spill_pack": system._pack_live, "reload": system._RELOAD,
            "vocab": (system.build_vocabulary_tree if s.bcfg.bow_levels == 2
                      else system.build_vocabulary),
            "retrain": system._RETRAIN}


def nested_programs() -> dict:
    """The library programs that the system's programs call in their
    functions (inline there, by jit's nesting rule): name -> program."""
    from zenslam_tpu_torch.backend.map_archive import reload_into_map
    from zenslam_tpu_torch.pipeline import system

    names = ("bundle_adjust", "bundle_adjust_cg", "dist_bundle_adjust", "shard_ba_problem_device",
             "optimize_pose_graph", "kf_db_add", "descriptors_to_bow", "bow_db_add",
             "bow_db_query")
    return dict({n: getattr(system, n) for n in names}, reload_into_map=reload_into_map)


def program_calls(s) -> dict:
    """Each program's calls so far (replays on the card, ``graphs.calls``),
    the snapshot and epoch programs ``s``'s own."""
    from zenslam_tpu_torch.utils import graphs

    return {k: 0 if prog is None else graphs.calls(prog)
            for k, prog in keyframe_programs(s).items()}


def since_calls(before: dict, s) -> dict:
    return {k: v - before[k] for k, v in program_calls(s).items()}


def held_program_calls(tag: str, s, calls: dict, frames: int) -> None:
    """Print each system program's calls over a graphed run of ``frames``
    frames and require them to match the work the run did: a snapshot a
    frame (with ``telemetry_lag``; else one a keyframe) and one a reloc
    attempt, an insert and a spill pack a keyframe, a BA window a BA run, a
    pose graph a loop, one first vocabulary and a retrain a later train,
    and a reload whenever the archive reloaded rows."""
    b = s.bcfg
    want = {"snapshot": (frames if b.telemetry_lag else s.n_keyframes) + len(s.reloc_debug),
            "kf_add": s.n_keyframes, "ba": s.n_ba_runs, "pose_graph": s.n_loop_closures,
            "spill_pack": s.n_keyframes if b.enable_map_spill else 0,
            "vocab": min(s.n_vocab_trains, 1), "retrain": max(s.n_vocab_trains - 1, 0)}
    print(f"[{tag}] program calls over the graphed run (replays; graphs.calls): {calls}; "
          f"archive reloads {s.archive.n_reloads}, relocs {s.n_relocs}")
    off = {k: (calls[k], v) for k, v in want.items() if calls[k] != v}
    require(not off, f"{tag}: program calls (made, expected) {off}")
    require(s.archive.n_reloads == 0 or calls["reload"] > 0,
            f"{tag}: no reload program call for {s.archive.n_reloads} reloaded rows")


PHASES = ("kf_add", "resolve", "loop_issue", "spill_pack", "spill_resolve", "ba_dispatch")


def phase_line(phases: dict) -> str:
    return ", ".join(f"{k} {float(np.median(phases[k])):.3f}" for k in PHASES if k in phases)


def graphed_system(seq, dev, graphed: bool, bcfg=None, frames=None, shape=(SIZE, SIZE),
                   cfg=None) -> tuple:
    """A system run over ``frames`` frames through ``process_frame`` and
    ``flush_pipeline`` (graphed, or under ``graphs.eager()``): (outputs,
    host ms/frame up to a synchronise, median ``backend_ms``, the system,
    {"phases": each back-end phase's host ms per keyframe (its ``backend.*``
    spans; the run has tracing on), "calls": each program's calls over the
    run})."""
    import torch

    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.utils.graphs import eager
    from zenslam_tpu_torch.pipeline.system import (
        BackendConfig, create_system, flush_pipeline, process_frame)

    frames = frames or SYSTEM_FRAMES
    s = create_system(cfg or SlamConfig(), bcfg or BackendConfig(telemetry_lag=3), seq.rig,
                      shape, device=dev)
    tels, backend, host = [], [], []
    calls0 = program_calls(s)
    with traced(host), contextlib.nullcontext() if graphed else eager():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [process_frame(s, seq.left[t], seq.right[t]) for t in range(frames)]
        rows += flush_pipeline(s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / frames
    for tel, info in rows:
        if tel is not None:
            tels.append(tel)
        if info["backend_ms"] > 0:
            backend.append(info["backend_ms"])
    return (system_outputs(s, tels), ms, float(np.median(backend)), s,
            {"phases": backend_phases(host), "calls": since_calls(calls0, s)})


@functools.lru_cache(maxsize=None)
def spill_orbit(dev):
    """``tests/test_map_spill.py``'s slot-pressure orbit: 36 frames of
    320x240 (seed 21, radius 1.0, host render)."""
    from zenslam_tpu_torch.io.synthetic import make_sequence

    return make_sequence(np.random.default_rng(21), n_frames=36, width=320, height=240,
                         motion="orbit", orbit_radius=1.0, device=dev)


def epoch_once(s) -> None:
    """The epoch correction, which the runs above reach only when a loop
    fires before their last keyframes: ``s``'s last keyframe snapshot
    carried by the change between its two newest keyframes' poses, through
    two ring entries graphed (twice each) and eager, bit-identical."""
    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.utils.graphs import fresh

    db, snap = s.kf_db, s.last_kf_snap
    s._pg_delta = tuple(fresh((db.R[0], db.t[0], db.R[1], db.t[1])))
    for frame in (8, 9):
        want = eager_call(lambda: system._epoch_correct(s, snap, frame))
        got = [fresh(system._epoch_correct(s, snap, frame)) for _ in range(2)]
        require(all(not parted(dict(enumerate(tree_tensors(want))),
                               dict(enumerate(tree_tensors(g)))) for g in got),
                f"graphs: the epoch correction of ring entry {frame % 4} parts from eager")
    print(f"[graphs] epoch correction, ring entries 0 and 1: graphed bit-identical to eager; "
          f"calls {program_calls(s)['epoch']}")


def vocab_once(s) -> None:
    """The vocabulary programs, which run once a system (the first train)
    or rarely (a retrain), on ``s``'s keyframe database: host ms of one
    call eager, its captures' ms in the traced system runs, and one
    replay, up to a synchronise (with tracing on, as ``s`` ran: the
    replay replays that run's capture)."""
    import torch

    from zenslam_tpu_torch.backend.bow import GeneratorDraw
    from zenslam_tpu_torch.pipeline import system

    db = s.kf_db
    slot = s.last_kf_slot
    calls = {"first train": lambda: system._train_vocab(s.bcfg, db.kp_desc[slot],
                                                        db.kp_valid[slot],
                                                        GeneratorDraw(7, s.device)),
             "retrain": lambda: system._retrain_vocab(s)}
    progs = {"first train": system.build_vocabulary_tree, "retrain": system._RETRAIN}
    for name, fn in calls.items():
        ms = {}
        with traced([]):
            for how in ("eager", "replay"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eager_call(fn) if how == "eager" else fn()
                torch.cuda.synchronize()
                ms[how] = (time.perf_counter() - t0) * 1e3
        print(f"[graphs] vocabulary {name}: eager {ms['eager']:.2f} ms, replay {ms['replay']:.2f} "
              f"ms (host, up to a synchronise); captures {captures_of(progs[name])} ms")


def phase_graphs(seq, dev) -> dict:
    """``[graphs]``: the captured programs (``utils/graphs.py``) held
    against the same code under ``graphs.eager()`` in one process, the order
    alternated; where two eager runs part, graphed within their spread.
    Returns the launches of its graphed runs."""
    import torch

    from zenslam_tpu_torch.eval.check_run import card_line
    from zenslam_tpu_torch.pipeline import SlamConfig
    from zenslam_tpu_torch.pipeline import system
    from zenslam_tpu_torch.utils import graphs
    from zenslam_tpu_torch.utils.graphs import eager
    from zenslam_tpu_torch.pipeline.system import BackendConfig

    t0 = time.perf_counter()
    card = card_line()
    nested0 = {k: len(p.captured) for k, p in nested_programs().items()}
    # the render is data set-up (make_sequence's, the orbits' here), not a nested call
    front = {k: p for k, p in frontend_programs().items() if k != "synthetic._render_view_device"}
    front0 = {k: (len(p.captured), graphs.calls(p)) for k, p in front.items()}
    eager_held = []
    # (a) the slice: eager, graphed, graphed, eager
    runs, peak, launches = [], {}, Counter()
    for i, graphed in enumerate((False, True, True, False)):
        torch.cuda.reset_peak_memory_stats()
        held0, host = graphs.graphs_held(), []
        before = read_launches()
        # the first graphed run traced, for its captures' ms (graphs.capture spans)
        with traced(host) if i == 1 else contextlib.nullcontext():
            runs.append(slice_run(seq, dev, graphed, states=i < 2))
        if not graphed:
            eager_held.append(graphs.graphs_held() - held0)
        if graphed:
            launches.update({k: v - before[k] for k, v in read_launches().items()})
        if i >= 2:      # the runs that keep no state copies
            peak[graphed] = torch.cuda.max_memory_allocated() / 2 ** 20
        if i == 1:
            capture = [round((x.end - x.start) * 1e-6, 1) for x in host
                       if x.name == "graphs.capture"]
            held = graphs.graphs_held() - held0
    e1, g1, g2, e2 = runs
    launches = dict(launches)
    def named(run) -> dict:
        out = {f"tel{t}": x for t, x in enumerate(run["tel"])}
        out.update({f"state{t}.{i}": a for t, st in enumerate(run["state"])
                    for i, a in enumerate(tree_tensors(st))})
        return out

    e1_out, g1_out = named(e1), named(g1)
    held_to_eager("graphs", f"slice {SIZE}x{SIZE}, {N_FRAMES} frames, every frame's state "
                            f"({len(tree_tensors(g1['last']))} tensors) and telemetry",
                  e1_out, g1_out, lambda: {**e1_out, **named(e2)})
    require(not parted(named(g2), g1_out), "graphs: the two graphed slice runs part")
    busy = {}
    for name, run, graphed in (("eager", e2, False), ("graphed", g2, True)):
        busy[name] = profiled_frames(run["step"], run["last"], seq, N_FRAMES - PROFILE_FRAMES,
                                     PROFILE_FRAMES, graphed)
    ms = {"eager": (e1["ms"], e2["ms"]), "graphed": (g1["ms"], g2["ms"])}
    for name in ("eager", "graphed"):
        b, n_ev, n_graph, per_frame = busy[name]
        host = float(np.mean(ms[name]))
        print(f"[graphs] slice {name}: host {ms[name][0]:.2f} / {ms[name][1]:.2f} ms/frame "
              f"({N_FRAMES - N_WARMUP} frames, two runs), device busy {b:.3f} ms/frame, idle "
              f"share {1 - b / host:.4f}, {n_ev:.0f} device kernels and copies a frame, "
              f"{n_graph:.1f} graph launches a frame (torch.profiler, {PROFILE_FRAMES} frames), hand "
              f"kernels a frame in the trace {per_frame} (= the counters' increase), peak "
              f"{peak[name == 'graphed']:.1f} MiB; {card}")
        require(per_frame == {"lk_fb": 2, "orb": 1},
                f"graphs: slice {name}: hand kernels a frame in the trace {per_frame}")
    print(f"[graphs] slice capture (warm-up + capture) {capture} ms, {held} graph(s) held by "
          f"the run; launches over the two graphed runs {launches}")
    # the donation: the new state copied into the state's buffers as the graph ends
    # (here every tensor of it; the step skips those it passed through unchanged)
    state = tree_tensors(g2["last"])
    src = [t.clone() for t in state]
    n_bytes = sum(t.numel() * t.element_size() for t in state)
    copy = summary(time_device(lambda: torch._foreach_copy_(state, src)))
    print(f"[graphs] the state's copy into its buffers ({len(state)} tensors, {n_bytes} bytes, "
          f"one _foreach_copy_): device {copy['median'] * 1e3:.2f} us {copy['spread']} ms, "
          f"bound {2 * n_bytes / PEAK_BYTES * 1e6:.2f} us (read + write at HBM's rate)")
    require(launches == {"lk_fb": 4 * N_FRAMES, "orb": 2 * N_FRAMES},
            f"graphs: slice launches {launches} != 2 LK + 1 ORB a frame over two graphed runs")

    # (b) the 80-frame system: eager, graphed
    e_sys, e_ms, e_back, _, e_x = graphed_system(seq, dev, False)
    g_sys, g_ms, g_back, gs, g_x = graphed_system(seq, dev, True)
    held_to_eager("graphs", f"system {SYSTEM_FRAMES} frames (keyframes, BA runs, loop "
                            "verdicts, poses, keyframe database, edges, archive, vocabulary, "
                            "BoW database)", e_sys, g_sys,
                  lambda: graphed_system(seq, dev, False)[0])
    print(f"[graphs] system eager / graphed: {e_ms:.2f} / {g_ms:.2f} ms/frame (22.19-22.59 "
          f"graphed on an H100 80GB HBM3 at 700 W with the keyframe path eager), backend_ms "
          f"median {e_back:.2f} / {g_back:.2f}; keyframes "
          f"{gs.n_keyframes}, BA runs {gs.n_ba_runs}, vocabulary trains {gs.n_vocab_trains}, "
          f"loop gates {len(gs.loop_debug)}; {card}")
    print(f"[graphs] system phase medians, host ms a keyframe, eager: {phase_line(e_x['phases'])}"
          f"; graphed: {phase_line(g_x['phases'])}")
    held_program_calls("graphs", gs, g_x["calls"], SYSTEM_FRAMES)

    # (c) one CG window on the graphed system's last inputs
    lm = gs.state.lmap
    args = (gs.kf_db, lm.xyz, lm.valid, lm.generation, gs.state.R_cw, gs.state.t_cw, gs.rig)
    kw = dict(W=CG_WINDOW, solver="cg", iterations=gs.bcfg.ba_iterations)

    def window(graphed):
        with contextlib.nullcontext() if graphed else eager():
            out = system._windowed_ba(*args, **kw)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                system._windowed_ba(*args, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        return {str(i): a for i, a in enumerate(tree_tensors(out))}, float(np.median(times))

    (we, we_ms), (wg, wg_ms) = window(False), window(True)
    held_to_eager("graphs", f"one CG window (ba_window {CG_WINDOW}, "
                            f"{int(gs.kf_db.valid.sum())} keyframes)", we, wg,
                  lambda: window(False)[0])
    print(f"[graphs] CG window host ms eager / graphed: {we_ms:.2f} / {wg_ms:.2f} (median of 3)")
    vocab_once(gs)

    # (d) the loop orbit, loops on ([loop]'s configs)
    orbit = loop_orbit(dev)
    lcfg = SlamConfig(max_keypoints=256, max_landmarks=4096, kf_min_frames=2,
                      kf_min_translation=0.05)
    lb = BackendConfig(ba_every_kf=False, enable_loop_closure=True, bow_branch=32,
                       bow_top_k=5, bow_min_score=0.20, bow_min_frame_gap=15,
                       loop_min_inliers=12)
    lo = dict(bcfg=lb, frames=64, shape=(240, 320), cfg=lcfg)
    g_loop, gl_ms, gl_back, gl, gl_x = graphed_system(orbit, dev, True, **lo)
    e_loop, el_ms, el_back, _, el_x = graphed_system(orbit, dev, False, **lo)
    held_to_eager("graphs", "loop orbit (64 frames, loops on)", e_loop, g_loop,
                  lambda: graphed_system(orbit, dev, False, **lo)[0])
    print(f"[graphs] loop orbit graphed / eager: {gl_ms:.2f} / {el_ms:.2f} ms/frame, backend_ms "
          f"median {gl_back:.2f} / {el_back:.2f}, loops {gl.n_loop_closures} at frames "
          f"{[d['frame'] for d in gl.loop_debug if d['fired']]}")
    print(f"[graphs] loop orbit phase medians, host ms a keyframe, eager: "
          f"{phase_line(el_x['phases'])}; graphed: {phase_line(gl_x['phases'])}")
    require(gl.n_loop_closures >= 1, "graphs: no loop closed on the graphed orbit")
    held_program_calls("graphs: loop orbit", gl, gl_x["calls"], 64)
    epoch_once(gs)

    # (e) the reference's slot-pressure orbit (tests/test_map_spill.py:
    # TestOrbitSlotPressure), where recycled landmarks are spilled and
    # reloaded: its first SPILL_FRAMES frames, past the test's bars
    sp = dict(bcfg=BackendConfig(ba_every_kf=False, enable_loop_closure=False,
                                 enable_map_spill=True, spill_reload_max=128),
              frames=SPILL_FRAMES, shape=(240, 320),
              cfg=SlamConfig(max_keypoints=256, max_landmarks=384, pnp_iters=128,
                             rigid_iters=128, kf_min_frames=2))
    g_sp, gs_ms, _, gsp, gsp_x = graphed_system(spill_orbit(dev), dev, True, **sp)
    e_sp, es_ms, _, _, _ = graphed_system(spill_orbit(dev), dev, False, **sp)
    held_to_eager("graphs", f"slot-pressure orbit ({SPILL_FRAMES} frames, spill and reload)",
                  e_sp, g_sp,
                  lambda: graphed_system(spill_orbit(dev), dev, False, **sp)[0])
    a = gsp.archive
    print(f"[graphs] slot-pressure orbit graphed / eager: {gs_ms:.2f} / {es_ms:.2f} ms/frame; "
          f"spills {a.n_spills}, reloads {a.n_reloads}, archive {len(a)} rows; phase medians "
          f"graphed: {phase_line(gsp_x['phases'])}")
    require(a.n_spills > 200 and a.n_reloads > 0,
            f"graphs: the slot-pressure orbit spilled {a.n_spills} and reloaded {a.n_reloads}")
    held_program_calls("graphs: slot-pressure orbit", gsp, gsp_x["calls"], SPILL_FRAMES)
    for name, prog in keyframe_programs(gs).items():
        print(f"[graphs] captures of {name} in the traced system runs (warm-up + capture, ms, "
              f"one a key; graphs.capture spans by program name): "
              f"{captures_of(prog) if prog is not None else []}")
    nested = {k: len(p.captured) - nested0[k] for k, p in nested_programs().items()}
    print(f"[graphs] captures of the library programs called inside the system's programs, "
          f"over this phase (inline there, as jit inlines a nested jit): {nested}")
    require(not any(nested.values()), f"graphs: a nested library program captured {nested}")
    front_new = {k: (len(p.captured) - front0[k][0], graphs.calls(p) - front0[k][1])
                 for k, p in front.items()}
    front_new = {k: v for k, v in front_new.items() if any(v)}
    print(f"[graphs] the front end's, IMU's and estimators' programs over this phase's step and "
          f"system runs (inline in the step, the system's programs and the eager slam_step): "
          f"captures and calls {front_new or 'none'}; captures by the eager slice runs "
          f"{eager_held}")
    require(not front_new, f"graphs: a front-end program captured or ran {front_new}")
    require(eager_held == [0, 0], f"graphs: the eager slam_step runs captured {eager_held}")
    print(f"[graphs] graphs held {graphs.graphs_held()}; phase {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[], metavar="DIR",
                    help="directory with another revision's (or a variant's) lk_fb.cu "
                         "and/or orb.cu to check and time beside this tree's kernels "
                         "(repeatable)")
    compare = ap.parse_args().compare
    try:
        import torch
        import zenslam_tpu_torch  # noqa: F401  (the package beside this script)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        name, count, smi_line = phase_device()
        phase_build(compare)
        dev = torch.device("cuda")
        seq, xy, valid = render_inputs(dev)
        lk = phase_lk(seq, xy, valid, dev, compare)
        orb = phase_orb(seq, xy, valid, dev, compare)
        phase_fma(seq, dev)
        paths = {"api": phase_api(seq, xy, valid, dev)}
        rig_paths, rigs_lk_err, rigs_orb_err = phase_rigs(dev)
        paths.update(rig_paths)
        paths["slice"] = phase_slice(dev)
        paths["bench"], bench_lk_err, bench_orb_err = phase_bench(dev)
        paths["system"], dense = phase_system(dev)
        paths["system_cg"] = phase_system_cg(seq, dev, dense)
        paths["loop"] = phase_loop(dev)
        paths["graphs"] = phase_graphs(seq, dev)
        paths["kidnap"] = phase_kidnap(dev)
        app_paths, app_lk_err = phase_app(dev)
        paths.update(app_paths)
        paths.update(phase_fulldress(dev))
        lines_paths, lines_lk_err = phase_lines(dev)
        paths.update(lines_paths)
        paths.update(phase_families(seq, dev))
        paths.update(phase_dist(seq, dev, dense))
        paths["scaling"] = phase_scaling(dev)
        paths["solvers"] = phase_solvers(dev)
        paths["frontend"] = phase_frontend(seq, xy, valid, dev)
        lk["max_abs_err"] = max(lk["max_abs_err"], app_lk_err, lines_lk_err, rigs_lk_err,
                                bench_lk_err)
        orb["max_abs_err"] = max(orb["max_abs_err"], rigs_orb_err, bench_orb_err)
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        import torch.distributed as tdist

        if tdist.is_initialized():     # the one-rank NCCL group of the dist phase
            tdist.destroy_process_group()
    for k in (lk, orb):
        k["launches"] = paths["system"][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    print(f"[chip_smoke] all phases in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "ms_spread", "device_ms", "device_ms_spread", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (lk, orb)]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
