#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereo_svo_tpu_torch) once on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one result line each, in order:
  0. device: CUDA required; card name, nvidia-smi name and power limit,
     torch/CUDA versions, the TF32 flags;
  1. build: the CUDA kernels from csrc/, timed;
  2. kernels: each of B1-B4 against its plain PyTorch version on the card
     at every shape a shipped path gives it: B1 and B2 per pyramid (one
     launch each writes every level's image plane, gx and gy planes) and
     B1/B2 one level at a time, exactly on every level of the 752x480 (4
     and 5 levels) and 1241x376 pyramids, level 0 equal to the frame, with
     a B2 row for every level (its one-level launch); B3 bit for bit
     at N=192 (P=8 KLT, P=4 alignment, and the K=3 template launches that
     sample a level's image, gx and gy together), at the epipolar-search
     shape (3,840 centres, P=8, 620x188), the affine-KLT big templates
     (N=192, P=16) and the KLT widths N=240 (KITTI) and N=2048 (stress);
     B4 at N=192, 240 (KITTI) and 2048 (stress level 1), P=4, within 1e-4
     relative with exact counts, bit-reproducible, one CUDA launch per
     call, and unchanged after calls at another width; align_levels (the
     whole alignment in one launch, align_rows) against the chain of ops,
     B3 and B4 it replaced, within ALIGN_TOL_REL of each output's largest
     entry, bit-reproducible, at the EuRoC, KITTI, stress and loop-edge
     shapes and over 8 problems (8 sequences; 8 edges), and refine_pose
     (the whole pose refinement in one launch, refine_rows) likewise
     against its chain of ops at the EuRoC, KITTI and stress widths and
     over 8 sequences, and klt_track (the whole KLT in one launch,
     klt_rows) against its chain of ops and B3 launches within
     KLT_TOL_PX and KLT_TOL_RES at the EuRoC, KITTI, stress and
     affine-warp shapes and
     over 8 sequences; each fused row with its graphed_us, the chain's
     chain_graphed_us (each captured alone as a CUDA graph, the mean of
     back-to-back replays: bench_kernels_torch.graphed_ms) and
     chain_kernel_nodes. Each row gives:
     ms and plain_ms (median CUDA-event pair around one call, 60 runs);
     device_us (torch.profiler device time of the kernel's own CUDA
     functions per call over 200 back-to-back calls, or an event pair
     around them where the profiler shows none: device_method);
     host_us (host clock over 200 back-to-back calls, no sync); bound_us
     (the larger of bytes / 3.35 TB/s and float32 operations / 67 TFLOP/s
     from the row's shapes, with bound_by); library_call, library_ms,
     library_device_us, library_host_us and library_max_abs_err (one
     PyTorch call computing the same function, timed alone as the kernel
     is; for B1 the copy_ of the frame and L-1 chained avg_pool2d calls,
     for B2 per pyramid one two-channel conv2d a level, each timed as one
     function; none for B4, library_reason says why); and, after the paths
     ran, launches_per_frame of the kernel on the path that gives it the
     shape (B1: 1.0 on every path; B2: 1.0 on phases 3-6 and per batched
     frame of phase 8, and on phase 7 one a frame plus K_loop's B2 nodes a
     loop call; or the run fails);
  3. main path: SvoConfig() as shipped (window BA on) over the 100-frame
     synthetic arc sequence (752×480, dt 0.08, seed 0) rendered on the
     card, through StereoSvo(cfg, device="cuda").new_image, which
     launches the step's frame graph once a frame, the bootstrap and
     keyframe frames included, its branches conditional nodes on the
     device (engine/graphed.py; phases 4-7b, 9, 10, 13 and 14 too); ATE
     and tracking gates, BA calls and acceptances, per-frame time;
  4. kitti_config() as shipped (epipolar search on) over 100 frames of the
     road scene on the kitti trajectory at 1241×376, dt 0.08, seed 0,
     rendered with 2×2 anti-aliasing; gates ATE ≤ max(0.25 m, 1.5 % of the
     travel), tracking, and epipolar recoveries > 0;
  5. stress_config() as shipped (2048 slots, 5 levels) over the phase-3
     sequence; gates ATE ≤ 0.02 m and tracking;
  6. SvoConfig(klt_affine_warp=True) over the first 50 frames of that
     sequence; gates ATE, tracking, and (feature, level) pairs tracked on
     warped templates > 0 (the step's n_warped metric);
  7. online loop closure at 752×480 on the EuRoC rig:
     SvoConfig(online_loop_every=1, kf_dist_ratio=0.05, loop_min_gap=15,
     loop_min_score=0.75) over the 60-frame out-and-back "loop" sequence
     (dt 0.25, seed 0) with tests/test_online_loop.py's drift injected
     before frame 30, then refine_trajectory on the final state; gates the
     keyframe frames, loop closures and offline edges equal to the JAX CPU
     reference, tail error and ATE within LOOP_TOL_M of it, tracking 1.0,
     one replay of graph K_loop per keyframe after the bootstrap, the
     online loop recorded into K_loop once and run eagerly only in the
     warm-up, and B2, B3 and align_levels among K_loop's kernel nodes
     beyond K's
     (its launches per online-loop call); reports the K_loop replays, the
     median online-loop keyframe frame, and for one eager call on the
     final state under torch.profiler its CUDA launches and device ms; per
     refine_trajectory call its kernel launches and host ms, and for one
     more call on the final state under torch.profiler its CUDA launches
     and device ms;
  7b. the same at 752×480 on tests/test_online_loop.py's rig (fx 760,
     baseline 0.25, a 3-keyframe window, a 12-slot bank), with
     online_loop_every=1 and the control at 0; gates loop closures and
     offline edges equal to the reference, none in the control, and the
     tail error below 0.75× the control's;
  8. batched-8 (bench.py's setup): SvoConfig(), 8 "planes" sequences of
     seeds 0-7 on the arc, 25 frames at dt 0.08, through
     run_sequence_batched on the graphed batched step
     (graphed.make_graphed_batched_step: each graph captured once for the
     whole batch, its phases vmapped over one stacked state, B1-B4 with
     the batch as their problem axis); gates ATE and tracking per
     sequence, no host sync on any batched frame, body B run once on
     each batched frame after the first, each sequence's keyframes equal and
     positions within BATCH_POS_TOL_M over the first BATCH_POS_FRAMES
     frames of its single graphed run (whose sequence 0 repeats phase 3's
     first 25 poses bit for bit), each batched graph's kernel nodes
     at most BATCH_NODE_RATIO times the single step's, and the batched
     graph P (also stress_config()'s) one B1 and one B2 node; reports the
     aggregate frames/s (the frames alone, and with the capture), the
     median of BATCH_STEADY_FRAMES host-timed steady batched frames,
     capture seconds and graph pool MB (and those of stress_config()'s
     batched graphs, captured alone), the nodes of both steps' graphs,
     kernel launches per batched frame, and the host launches and device
     ms of one more batched frame under torch.profiler.
  9. tracking loss and relocalisation: SvoConfig(kf_dist_ratio=0.05) over
     the first 48 frames of phase 7's sequence with frames 20-22 blacked
     out (zeros), as tests/test_engine.py sets it up; gates tracking_ok
     false exactly on those frames and true from the next real frame on,
     finite poses, the keyframe frames equal to the JAX CPU reference, tail
     error and ATE within BLACKOUT_TOL_M of it, no host sync on any
     frame (the failed ones included), and the rotated relocalisation
     variants computed on each frame after a failed one;
  10. the command-line app in-process: cli.main(--dataset synthetic
     --frames 60 --loop-closure --metrics-out ... --out ...) on the card,
     writing under build/; gates the summary's keys, ATE and tracking, one
     TUM line per frame that load_tum reads back (stamps i*0.1, ATE of the
     file's positions equal to the summary's), no host sync inside any
     new_image call of the frame loop; then checkpoint and resume: 30
     frames of phase
     3's sequence, utils/checkpoint.save, load into a fresh StereoSvo on
     the card, 30 more frames, whose poses must equal phase 3's bit for
     bit; reports the milliseconds of save and load;
  11. the global map: the final states of two of phase 8's sequences into
     parallel/mapping.build_global_map (20 poses, 384 landmarks), then
     detect_loop_edges and optimize_global_map over an nccl process group
     of world size 1 on the card; gates finite output, every valid
     keyframe moved by less than MAP_MAX_MOVE_M, and the sharded BA at
     world size 1 within MAP_BA_TOL of the single-process ba_iteration
     loop on the same inputs; reports launches, device ms and wall ms of
     the call and of its pose-graph and BA parts (phase 17 runs the same
     map over spawned ranks, one a GPU).
  12. graphed against eager: phase 3's frames through the eager step
     (engine/step.make_step, one host sync on every frame after the
     bootstrap) with phase 3's accounting; gates the two trajectories and
     every FrameOut field bit for bit equal over all 100 frames, keyframe
     frames included (else names the first frame and field that differ);
     reports frame ms median, p90, tracked-frame and keyframe-frame
     medians of both, host CUDA launches (kernels, graph launches, copies)
     and device ms of the bootstrap frame, one tracked frame and one
     keyframe frame of each under torch.profiler (the frame before it, or
     another step's bootstrap, in the profiler's warm-up step), whose
     device records of each hand-written kernel must equal the launch
     counters' gain on it, and a graphed keyframe frame and the graphed
     bootstrap at most KF_FRAME_MAX_HOST_LAUNCHES host launches; the
     nodes of each body (the kernel nodes by the function's name, read
     through libcuda; K_loop from phase 7's step) and of the frame graph
     F, graph P's of phases 3-5
     (SvoConfig(), kitti_config(), stress_config(): 2 kernel nodes, one B1
     and one B2, or the run fails), capture seconds and
     graph pool MB, and the device busy share of a replayed tracked frame
     (its records' device time over its own CUDA-event span in the trace,
     which must lie in (0, 1]) and keyframe frame.
  13. the hard scenes of tests/test_synthetic_hard.py (:78, 136, 150, 164,
     177): the cluttered scene of spheres, the in-plane spin, the moving
     object, motion blur and the photometric perturbation, 30 frames at dt
     0.12, each rendered on the card before its run, through StereoSvo
     (one graphed step per configuration, reset between scenes:
     shared_steps) at the test's 376x240 rig and under SvoConfig() at
     752x480; gates the reference test's (tracking >= 0.97, ATE below 0.03
     or 0.035 m) on every run at both sizes, and on the four
     deterministic scenes at both sizes the keyframe frames equal to the
     JAX CPU reference (PHASE13_REF) and ATE within LOOP_TOL_M of it (the
     perturbed frames' noise comes from a CUDA generator: gates only); B1
     and B2 once a frame, no host sync on any frame; reports per run
     tracking, ATE, keyframe frames, frame ms median and p90 (first frame
     apart), launches a frame of B1-B4;
  14. the long horizon of tests/test_mem_retention.py:78: its rig (8-slot
     bank, 3-keyframe window, kf_dist_ratio 0.04), 500 frames of the loop
     trajectory (t = 0.2 i) rendered on the card, through
     run_sequence_scan (the graphed step, each frame timed and its syncs
     counted), then the drift event (drift_event) and refine_trajectory;
     gates the reference test's checks (tracking > 0.97, >= 3 wraps of the
     bank, organic drift < 0.02 m, >= 1 edge, tail error after < 0.6x
     before, finite poses), wraps, keyframes and edges equal to
     PHASE14_REF and the tail errors within LOOP_TOL_M of it; reports
     tracked and keyframe frames' ms apart, refine_trajectory's wall ms and
     kernel launches.
  15. no host read between frames: phase 3's 100 frames through
     run_sequence_scan, and phase 8's batched-8 frames through
     run_sequence_batched, each under CUDA sync debug mode "error" from
     the first frame, the bootstrap included, to the last (a sync
     raises); gates the poses and flags bit for bit phase 12's eager run
     (batched: the eager batched step over the same frames) and each
     body's run counter (read once, after the run) against what the
     flags imply (one bootstrap, K and K_loop the keyframe frames after
     it, A_fail the frames after a failed one, B every other frame);
     reports frame ms from CUDA events (median, p90, the bootstrap apart),
     fps over the run, and, over SCAN_PROFILE_FRAMES steady frames of a
     fresh step in a process of its own, each graph launch timed by CUDA
     events and then under torch.profiler, the device's busy share and
     its idle time inside graph windows and between them (steady_split).
     Phase 12's profiled graphed frames also run in a process of their
     own (child).
  16. the benchmark entry points, each in a process of its own
     (BENCH_RUNS): bench_torch.py's default path (phase 3's 100 frames,
     with batched-8 at 25 frames and BENCH_LATENCY=1), BENCH_GEOM=kitti,
     BENCH_STRESS=1 and the default path twice more
     (BENCH_SKIP_BATCHED=1), then bench_kernels_torch.py; gates each bench
     line's accuracy gate "pass", finite positive frames/s, its timed runs
     under sync debug mode "error" (a host read raises) and bit for bit
     its warm-up run, one capture per path (batched and latency too),
     every kernel launched in its timed runs (the counters zeroed just
     before them and read just after, in the child), and
     the default path's ATE equal to phase 3's to the printed digits;
     every stage row (STAGE_ROWS) with finite eager and graphed ms, B1-B4
     among the kernel nodes of the rows that launch them (STAGE_B_NODES;
     the pyramid: one B1 and one B2 node) and the accounting finite;
     prints each child's JSON as a line of its own, then a summary with
     each default process's frames/s.
  17. the multi-rank paths, one rank a GPU over nccl, n the card count
     (1 on a machine with one GPU): (a) entry.dryrun_multichip(n), each
     rank reporting backend nccl, its tensors on cuda:r and B1-B4 launched
     inside it (the tiny configuration's bootstrap step, one tracked step,
     one sharded BA), then rank 0's two steps again in this process, every
     B1-B4 call recorded (kernel_calls) and held against its plain version
     at the dry run's own shapes (check_kernel_calls: B1-B3 exact, B4
     within 1e-4 of the largest entry) and the rank's tracked pose equal
     to the replay's; (b) phase 8's sequences split r::n over n ranks that
     parallel/mesh.spawn_local starts (sharded_rank), each rank's rendered
     on its card and run through run_sequence_batched: at n = 1 poses and
     flags bit for bit phase 8's (the same program on the same card),
     W7's tolerance (BATCH_POS_TOL_M) otherwise; (c) the global map of
     sequences MAP_SEQS, each state broadcast from its rank,
     detect_loop_edges and optimize_global_map over the kf group of the
     same ranks: every rank the same map, at n = 1 bit for bit phase 11's;
     (d) spawn_local with n + 1 ranks raises RuntimeError naming the card
     count and starts no process (touch_rank's file stays absent); reports
     spawn-to-ready s a rank, capture s, the rank's batched frames/s and
     optimize_global_map wall ms beside the nvidia-smi line, and rank 0's
     launches (the kernels line's launches_by_path "phase17_rank0").
Phase 2 also holds B2, B3 (K=3 and K=1) and B4 at the keyframe thumbnail
(120x188, N=192, P=4, the centres a keyframe's features give it) that
phase 7's edge measurements use.
Phase 2 also holds each kernel's problem axis (rows with "problems"): B1
and B2 per pyramid and B2 at level 0 over phase 8's 8 frames at 752x480,
B3 (K=1 at P=8 and P=4, K=3 at P=4) and B4 over its 8 sequences at N=192,
and B2, B3 and B4 over LOOP_EDGES=8 edges at the thumbnail (one pass of
measure_edges); each problem bit for bit its one-problem launch, the batch
against the plain problem-axis version (B4 within 1e-4 of the largest
entry), bound and library call for the whole batch.
Each of phases 3-11 and 13-15 (each run of phase 13), and each rank of
phase 17 (each part), zeroes the launch counters just before its run, reads
them just after, and fails unless every kernel of the paths (PATH_KERNELS:
B1-B3 and align_levels; B4 is off them) launched (the global map: B2, B3
and align_levels); a graphed step's frames launch their kernels inside the
frame graph, whose bodies count their runs on the device, and the counters
take each body's kernel nodes times its runs when they are zeroed or read
(graphed.settle, outside the frames). Each counts host
syncs on every frame of the run (CUDA sync debug mode) and fails unless
no frame has one, the bootstrap, keyframe frames with window BA, online
loop closure and epipolar recoveries included (phase 8: per batched
frame; phase 10 counts them inside the frame loop only; phase 15 raises
on the first); phase 12's eager run keeps one on every frame after the
bootstrap.
Then phase2_rows (every kernel row with its launches per frame), the
kernels JSON line (each kernel's main-path row, launches from phase 3),
the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no ok line.
Extra detail (build log, per-frame times) goes to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

from stereo_svo_tpu_torch.ops.kernels import KERNELS
from stereo_svo_tpu_torch.ops.kernels import counters as launch_counters

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, DT, SEED = 100, 0.08, 0
N_AFFINE_FRAMES = 50
ATE_GATE_M, TRACK_GATE = 0.02, 0.99        # bench.py:54-55
KITTI_ATE_FLOOR_M, KITTI_ATE_FRAC = 0.25, 0.015   # bench.py:529-536
# phases 7 and 7b: tests/test_online_loop.py's scenario at 752x480
LOOP_FRAMES, LOOP_DT, LOOP_INJECT_AT = 60, 0.25, 30
LOOP_DRIFT = [0.05, 0.02, -0.05, 0.004, -0.006, 0.003]
LOOP_KNOBS = dict(kf_dist_ratio=0.05, loop_min_gap=15, loop_min_score=0.75)
RIG_7B = dict(fx=760.0, fy=760.0, cx=376.0, cy=240.0, baseline=0.25,
              width=752, height=480)
# the JAX package on the CPU over the same frames and drift (recomputed by
# tests/test_torch_chip_reference.py); tail = mean position error of the
# last 5 frames
PHASE7_REF = dict(kf_frames=[0, 3, 6, 10, 16, 24, 28, 31, 34, 37, 41, 45, 51],
                  n_loop_closures=0, offline_edges=8,
                  tail_err_m=0.07580976188182831, ate_m=0.02633512466158519)
PHASE7B_REF = dict(kf_frames=[0, 3, 6, 9, 14, 24, 28, 31, 34, 37, 41, 45, 51],
                   n_loop_closures=3, offline_edges=8,
                   tail_err_m=0.02227490395307541,
                   control_tail_err_m=0.0713019147515297)
LOOP_TOL_M = 5e-3            # |card − reference| for tail error and ATE
BATCH, BATCH_FRAMES = 8, 25  # bench.py:376-429
LOOP_EDGES = 8               # SvoConfig().loop_max_edges: one pass of
                             # measure_edges in close_loops
# phase 8 against each sequence's single graphed run: positions over the
# first 8 frames (tests/test_torch_batched.py's tolerance: the batch sums
# in another float32 order), and the batched graphs' kernel nodes against
# the single step's
BATCH_POS_TOL_M, BATCH_POS_FRAMES = 2e-4, 8
BATCH_NODE_RATIO = 1.5
BATCH_STEADY_FRAMES = 10     # host-timed batched frames after the run
# phase 9: tests/test_engine.py's blackout scenario at 752x480: the first
# frames of phase 7's sequence with zeros for the blacked-out ones
BLACKOUT_FRAMES, BLACKOUT = 48, (20, 21, 22)
BLACKOUT_KNOBS = dict(kf_dist_ratio=0.05)  # a keyframe near every frame
# the JAX package on the CPU over the same frames (recomputed by
# tests/test_torch_chip_reference.py)
PHASE9_REF = dict(kf_frames=[0, 3, 6, 10, 16, 24, 25, 29, 32, 35, 38, 42,
                             47],
                  lost_frames=[20, 21, 22],
                  tail_err_m=0.016947779804468155,
                  ate_m=0.051268993614293136)
BLACKOUT_TOL_M = 5e-3        # |card − reference| for tail error and ATE
# phase 10: the command-line app, then checkpoint and resume
CLI_FRAMES, CLI_DT = 60, 0.1               # the CLI's synthetic sequence
CLI_SUMMARY_KEYS = {"frames", "fps", "keyframes", "tracking_ok_frac",
                    "mean_tracked", "loop_edges", "out", "ate_rmse_m",
                    "rpe_t_m", "rpe_r_rad"}
RESUME_AT, RESUME_FRAMES = 30, 60          # of phase 3's sequence
# phase 11: the global map of two of phase 8's sequences
MAP_MAX_MOVE_M = 0.05                      # tests/test_mapping.py:52
MAP_BA_TOL = 1e-6            # sharded BA at world size 1 against the
                             # single-process iterations (same sums)
# phase 13: tests/test_synthetic_hard.py's scenes (:78, 136, 150, 164,
# 177) at its rig (:16-25), and at SvoConfig()'s 752x480
HARD_CAM = dict(fx=240.0, fy=240.0, cx=188.0, cy=120.0, baseline=0.11,
                width=376, height=240)
HARD_CFG = dict(grid_rows=10, grid_cols=13, max_features=130, num_levels=3,
                align_levels=3, klt_levels=3, stereo_max_disp=64,
                kf_min_tracked=40, border_margin=10)
HARD_FRAMES, HARD_DT = 30, 0.12
HARD_SCENES = {                            # make_sequence's keywords
    "clutter": dict(kind="arc", scene_kind="clutter"),
    "spin": dict(kind="spin"),
    "dynamic": dict(kind="arc", scene_kind="dynamic"),
    "blur": dict(kind="arc", motion_blur=0.3),
    "perturb": dict(kind="arc", perturb=True),
}
HARD_ATE_GATES = {"clutter": 0.03, "spin": 0.03, "dynamic": 0.035,
                  "blur": 0.035, "perturb": 0.03}   # ATE below (m)
HARD_TRACK_GATE = 0.97                              # tracking_ok at least
# the JAX package on the CPU over JAX's frames (recomputed by
# tests/test_torch_chip_reference.py); "rig": the test rig, "full":
# SvoConfig(). The perturbed frames differ on the card (its noise comes
# from a CUDA generator): their values are for context only
PHASE13_REF = {
    "rig": {
        "clutter": dict(kf_frames=[0], tracking_ok=1.0,
                        ate_m=0.003137754628724664),
        "spin": dict(kf_frames=[0, 24], tracking_ok=1.0,
                     ate_m=0.0007039168008424132),
        "dynamic": dict(kf_frames=[0], tracking_ok=1.0,
                        ate_m=0.0037885874216592222),
        "blur": dict(kf_frames=[0, 13, 27], tracking_ok=1.0,
                     ate_m=0.000915613482409118),
        "perturb": dict(kf_frames=[0, 13, 27], tracking_ok=1.0,
                        ate_m=0.0013377972428845616)},
    "full": {
        "clutter": dict(kf_frames=[0], tracking_ok=1.0,
                        ate_m=0.0015770250223854838),
        "spin": dict(kf_frames=[0, 24], tracking_ok=1.0,
                     ate_m=0.0016611485355060318),
        "dynamic": dict(kf_frames=[0], tracking_ok=1.0,
                        ate_m=0.002007456973270958),
        "blur": dict(kf_frames=[0, 13, 27], tracking_ok=1.0,
                     ate_m=0.0027995674028161725),
        "perturb": dict(kf_frames=[0, 13, 27], tracking_ok=1.0,
                        ate_m=0.0016902561123829886)}}
# phase 14: tests/test_mem_retention.py:78, a 500-frame out-and-back run
# whose 8-slot bank wraps many times, then a drift event on the trajectory
# from frame LONG_DRIFT_AT and on the bank slots stamped from it, then
# refine_trajectory
LONG_CFG = dict(grid_rows=8, grid_cols=10, max_features=80, num_levels=3,
                align_levels=3, klt_levels=3, stereo_max_disp=48,
                kf_min_tracked=25, border_margin=10, max_keyframes=3,
                mem_keyframes=8, kf_dist_ratio=0.04, loop_min_gap=30,
                loop_min_score=0.75)
LONG_FRAMES, LONG_DT, LONG_DRIFT_AT = 500, 0.2, 300
LONG_DRIFT = [0.05, 0.02, -0.04, 0.004, -0.006, 0.003]
LONG_GATES = dict(tracking_ok=0.97, min_wraps=3.0, organic_m=0.02,
                  tail_ratio=0.6)        # the reference test's own
# the JAX package on the CPU over JAX's frames, as PHASE13_REF
PHASE14_REF = dict(tracking_ok=1.0, keyframes=112, wraps=14.0,
                   organic_m=0.011507759802043438,
                   offline_edges=8, tail_before_m=0.06774022430181503,
                   tail_after_m=0.028808007016777992)
# a graphed frame, a keyframe frame or the bootstrap, is one launch of the
# frame graph: the image copies, the launch and the FrameOut's clones, no
# eager kf_phase (~2,700 launches) or bootstrap (thousands)
KF_FRAME_MAX_HOST_LAUNCHES = 64
# the argument that runs a child process (child_main)
CHILD_FLAG = "--profile-graphed-frames"
# phase 16: the benchmark entry points, each run in a process of its own:
# (tag, script, its env knobs); the default path three times (the
# bimodality of steady frames across processes, PERF.md §7)
BENCH_RUNS = (("default", "bench_torch.py", {"BENCH_LATENCY": "1"}),
              ("kitti", "bench_torch.py", {"BENCH_GEOM": "kitti"}),
              ("stress", "bench_torch.py", {"BENCH_STRESS": "1"}),
              ("default_2", "bench_torch.py", {"BENCH_SKIP_BATCHED": "1"}),
              ("default_3", "bench_torch.py", {"BENCH_SKIP_BATCHED": "1"}),
              ("stages", "bench_kernels_torch.py", {}))
BENCH_TIMEOUT_S = 600
BENCH_VALID_RUNS = 5                       # bench_torch.py's default
# bench_kernels_torch.py's rows of SvoConfig() (no epipolar search) and
# the B1-B4 kernel nodes each must hold at least (the pyramid: exactly)
STAGE_ROWS = ("pyramid_ms", "fast_score_l0_ms", "detector_ms", "align_ms",
              "align_template_ms", "klt_ms", "klt_template_ms",
              "pose_refine_ms", "stereo_match_ms", "depth_filter_ms",
              "kf_insert_ms", "window_ba_ms", "full_step_ms", "reloc_ms",
              "stereo_refresh_ms", "rebuild_template_ms")
STAGE_B_NODES = {"align_ms": ("align_levels",),
                 "pose_refine_ms": ("refine_pose",),
                 "align_template_ms": ("sample_patches",),
                 "klt_ms": ("klt_track",),
                 "klt_template_ms": ("sample_patches",),
                 "rebuild_template_ms": ("sample_patches",),
                 "full_step_ms": ("halfsample", "gradients",
                                  "sample_patches", "align_levels",
                                  "klt_track", "refine_pose")}
STAGE_ACCOUNTING = ("per_op_sum_ms", "step_nonkf_ms",
                    "intra_frame_residual_ms", "kf_phase_ms", "kf_rate",
                    "model_frame_ms", "measured_frame_ms", "unaccounted_ms")
# phase 17: the multi-rank paths, one rank a GPU over nccl, each spawned
# call's time limit; the sequences (of phase 8's) whose global map phase 11
# and phase 17 build
MULTI_TIMEOUT_S = 300.0
MAP_SEQS = (0, 1)
# phase 15: the steady frames in torch.profiler's window, from frame
# SCAN_PROFILE_AT of phase 3's sequence (phase 8's: its last ones)
SCAN_PROFILE_AT, SCAN_PROFILE_FRAMES = 40, 20
N_TIMED = 60                               # event-pair timing repetitions
N_BACK = 200                               # back-to-back calls (device_us,
                                           # host_us)
# the runtime calls that launch a kernel, as torch.profiler names them
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")
GRAPH_KEYS = ("cudaGraphLaunch", "cuGraphLaunch")
COPY_KEYS = ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync")
MEM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12                    # H100 SXM, float32, no tensor
                                           # cores
# the kernels the paths launch (B4 keeps its phase-2 rows)
PATH_KERNELS = tuple(k for k, v in KERNELS.items() if v.on_path)
# align_levels against its plain version (the chain of ops, B3 and B4 on
# the card): the largest error within ALIGN_TOL_ABS (the pose's entries) or
# within ALIGN_TOL_REL of each output's largest entry (the cost)
ALIGN_TOL_ABS, ALIGN_TOL_REL = 1e-5, 1e-4
# klt_track against its plain version (the chain of ops and B3 launches on
# the card): the convergence flags and the warped count exact, the
# positions within KLT_TOL_PX and the mean residuals within KLT_TOL_RES of
# the problem's largest. The sums over each patch run in another order, and
# 18 dependent iterations through a feature's inverse Hessian carry that
# far where the Hessian is near singular (random points of a noisy frame:
# 9.4e-3 px and 1.7e-4 at most over 40 problems on an H100); an iteration
# stops once its step is below klt_conv_eps (0.03 px), so a position is
# defined only to that step
KLT_TOL_PX, KLT_TOL_RES = 0.03, 1e-3
LIBRARY_CALLS = {
    "halfsample": "copy_ of the frame, then L-1 chained "
                  "torch.nn.functional.avg_pool2d(x, 2) calls",
    "gradients": "torch.nn.functional.conv2d, both stencils as two output "
                 "channels (compared on the interior); per pyramid one such "
                 "call a level, timed as one function",
    "sample_patches": "torch.nn.functional.grid_sample(bilinear, border, "
                      "align_corners=True) on a grid built outside the "
                      "timed region (compared at interior centres)",
}
NO_LIBRARY_CALL = ("no single PyTorch call computes the sample, the Huber "
                   "weight and the normal equations together")


ROW_SUMMARY = ("name", "shape", "levels", "level", "per_pyramid", "use",
               "path", "problems",
               "launches_per_frame", "launches_per_loop_call",
               "max_abs_err", "ms", "plain_ms",
               "device_us", "host_us", "bound_us", "bound_by", "library_ms",
               "library_device_us", "library_host_us", "library_max_abs_err")


class SmokeFailure(RuntimeError):
    pass


def emit(tag: str, payload: dict) -> None:
    print(f"{tag} {json.dumps(payload, sort_keys=True)}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, n: int = N_TIMED, warmup: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``n`` runs, one CUDA-event pair
    around each run at an idle queue: the host's cost to issue the call
    plus the device's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def graphed_us(kernel, plain) -> dict:
    """A fused kernel's and its chain's µs, each call captured alone as a
    CUDA graph (bench_kernels_torch.graphed_ms: the mean of back-to-back
    replays), and the chain's kernel nodes: what each costs inside the
    frame graph, where the host is not on its path."""
    import torch
    import bench_kernels_torch
    stream = torch.cuda.Stream()
    ms, _, _ = bench_kernels_torch.graphed_ms(kernel, (), stream)
    chain_ms, kinds, _ = bench_kernels_torch.graphed_ms(plain, (), stream)
    return {"graphed_us": ms * 1e3, "chain_graphed_us": chain_ms * 1e3,
            "chain_kernel_nodes": kinds["kernel"]}


def align_bytes_flops(N: int, P: int, schedule) -> tuple:
    """The least bytes and the float32 operations of one alignment of N
    features of P x P pixels on the levels of ``schedule`` ((refresh
    passes, inner passes after each) a level): each level's template
    (patches and Jacobians) read once, each pass's taps (N (P+1)^2 distinct
    pixels of interior patches), the points, mask, pose in and 14 outputs;
    per term ~45 operations to transform, project, test and sample, a
    refresh pass samples three times and adds ~80 for the illumination
    fit, the weights, H and g, an inner pass ~20 for e, b and the cost."""
    terms = N * P * P
    nbytes, flops = 4.0 * (3 * N + 12 + 14) + N, 0.0
    for chunks, inner in schedule:
        passes = chunks * (1 + inner)
        nbytes += 4.0 * (7 * terms + passes * N * (P + 1) ** 2)
        flops += terms * chunks * (3 * 45 + 80 + inner * (45 + 20))
    return nbytes, flops


def device_us(fn, functions, n: int = N_BACK):
    """Device µs per call of ``fn()`` spent in the CUDA functions named in
    ``functions``: torch.profiler's key_averages over ``n`` back-to-back
    calls, the mean time of each function's launches times its launches
    per call (rounded: the profiler may drop a few records, never add
    one), summed over the functions a call launches; with the launches
    recorded per call. Where two profiles record no device time, an event
    pair around ``n`` back-to-back calls
    after a synchronised warm-up (launches per call then unknown).
    Returns (µs, launches per call, method)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):               # the first profile may record nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per_function = [
            (getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and any(f in e.key for f in functions)]
        if per_function and all(t > 0.0 for t, _ in per_function):
            return (sum(t / c * max(1, round(c / n))
                        for t, c in per_function),
                    sum(c for _, c in per_function) / n, "profiler")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / n, None, "events"


def host_us(fn, n: int = N_BACK) -> float:
    """Host µs per call of ``fn()`` over ``n`` back-to-back calls with no
    synchronisation: what the main path pays per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_us(nbytes: float, flops: float):
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e6, \
        "bytes" if t_bytes >= t_ops else "operations"


def footprint_pixels(h, w, uv, P) -> int:
    """Distinct pixels the bilinear taps of all patches read (the per-tap
    clamp of interp.bilinear): the input bytes B3/B4 need from this run's
    centres."""
    import torch
    from stereo_svo_tpu_torch.ops import interp
    pts = (uv.reshape(-1, 2)[:, None, :]
           + interp.patch_coords(P, uv.dtype, uv.device)).reshape(-1, 2)
    u = torch.clamp(pts[:, 0], 0.0, w - 1.000001)
    v = torch.clamp(pts[:, 1], 0.0, h - 1.000001)
    iu0 = torch.floor(u).long().clamp(0, w - 1)
    iv0 = torch.floor(v).long().clamp(0, h - 1)
    iu1 = torch.clamp(iu0 + 1, max=w - 1)
    iv1 = torch.clamp(iv0 + 1, max=h - 1)
    idx = torch.cat([iv0 * w + iu0, iv0 * w + iu1, iv1 * w + iu0,
                     iv1 * w + iu1])
    return int(torch.unique(idx).numel())


def _max_err(a, b):
    import torch
    if isinstance(a, (tuple, list)):
        errs = [_max_err(x, y) for x, y in zip(a, b)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    d = float(torch.max(torch.abs(a.float() - b.float())))
    scale = float(torch.max(torch.abs(b.float())))
    return d, d / max(scale, 1e-30)


def _grid(uv, P, h, w, K):
    """grid_sample's normalised (K, M, P², 2) grid of the patches' sample
    points (align_corners=True: -1 and 1 are the border pixel centres)."""
    import torch
    from stereo_svo_tpu_torch.ops import interp
    pts = (uv.reshape(-1, 2)[:, None, :]
           + interp.patch_coords(P, uv.dtype, uv.device))
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=uv.device)
    return (pts * scale - 1.0)[None].expand(K, -1, -1, -1).contiguous()


def check_kernels(device, frame, kitti_frame, thumb):
    """Phase 2: each kernel against its plain version on the card at every
    shape a shipped path gives it, with its bound, device, host, event and
    library-call times. ``thumb``: (keyframe thumbnail, its feature centres
    at thumbnail scale, their mask), the inputs of phase 7's edge
    measurements. Returns the rows; the first row of each kernel is its
    main-path row."""
    import torch
    import torch.nn.functional as F
    from stereo_svo_tpu_torch.ops import pyramid
    from stereo_svo_tpu_torch.ops.kernels import _build
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    img = frame.contiguous()
    H, W = img.shape
    rows = []

    def record(name, kernel, plain, tol_abs, tol_rel, shape, path,
               nbytes, flops, library=None, extra=None, outputs=None):
        """``library``: (the library call, timed alone; a function of its
        output giving the (library, kernel) values compared) or None.
        ``outputs``: what of the kernel's result is compared with the plain
        version (default: all of it)."""
        out, ref = kernel(), plain()
        if outputs is not None:
            out = outputs(out)
        torch.cuda.synchronize()
        err_abs, err_rel = _max_err(out, ref)
        ok = err_abs <= tol_abs or err_rel <= tol_rel
        dev_us, per_call, method = device_us(
            kernel, (KERNELS[name].function,))
        bound, bound_by = bound_us(nbytes, flops)
        row = {"name": name, "route": "cuda",
               "source": f"stereo_svo_tpu_torch/{KERNELS[name].source}",
               "replaces": KERNELS[name].replaces, "shape": shape,
               "path": path,
               "launches": None, "launches_per_frame": None,
               "max_abs_err": err_abs, "max_rel_err": err_rel,
               "tol_abs": tol_abs, "tol_rel": tol_rel,
               "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
               "device_us": dev_us, "device_method": method,
               "cuda_launches_per_call": per_call,
               "host_us": host_us(kernel), "bytes": nbytes, "flops": flops,
               "bound_us": bound, "bound_ms": bound / 1e3,
               "bound_by": bound_by, "library_call": LIBRARY_CALLS.get(name),
               "library_ms": None, "library_device_us": None,
               "library_host_us": None, "library_max_abs_err": None,
               **(extra or {})}
        if library is None:
            row["library_reason"] = NO_LIBRARY_CALL
        else:
            call, compared = library
            row["library_max_abs_err"] = _max_err(*compared(call()))[0]
            row["library_ms"] = cuda_ms(call)
            row["library_device_us"] = device_us(call, ("",))[0]
            row["library_host_us"] = host_us(call)
        emit("phase2", row)
        require(ok, f"{name} {shape}: kernel disagrees with its plain "
                    f"version (abs {err_abs}, rel {err_rel})")
        require(per_call is None or per_call <= 1.0,
                f"{name} {shape}: {per_call} CUDA launches per call, not 1")
        rows.append(row)

    def pyramid_case(image, path, levels, what):
        """B1/B2 exact on every level of a pyramid, each built one level at
        a time and in one launch; B1 and B2 timed per pyramid, B2 also at
        every level of a shape not timed before (its one-level launch)."""
        lv = image.contiguous()
        shapes = []
        for level in range(levels):
            shapes.append(list(lv.shape))
            for a, b in zip(pk.gradients(lv), pk.gradients_plain(lv)):
                e = _max_err(a, b)[0]
                require(e == 0.0, f"gradients, {what} level {level}: {e}")
            if level + 1 < levels:
                half = pk.halfsample(lv)
                e = _max_err(half, pk.halfsample_plain(lv))[0]
                require(e == 0.0, f"halfsample, {what} level {level}: {e}")
                lv = half
        before = pk.LAUNCHES["halfsample"]
        bufs = pk.pyramid(image, levels)
        torch.cuda.synchronize()
        require(pk.LAUNCHES["halfsample"] == before + 1,
                f"pyramid, {what}: {pk.LAUNCHES['halfsample'] - before} "
                f"B1 launches, not 1")
        require(torch.equal(bufs[0][0], image),
                f"pyramid, {what}: level 0 is not the frame")
        h, w = image.shape
        coarse = sum(a * b for a, b in shapes[1:])
        x = image[None, None]

        def library_chain():
            out = [torch.empty_like(image).copy_(image)]
            y = x
            for _ in range(levels - 1):
                y = F.avg_pool2d(y, 2)
                out.append(y[0, 0])
            return out

        def image_planes(bufs):
            return [b[0] for b in bufs]

        # every level's image plane against the plain chain: the same
        # additions in the same order, no fused multiply-add, so exact;
        # bytes: the frame read once, level 0 and every coarser level
        # written once
        record("halfsample", lambda: pk.pyramid(image, levels),
               lambda: pk.pyramid_plain(image, levels), 0.0, 0.0, [h, w],
               path, 4.0 * (2 * h * w + coarse), 4.0 * coarse,
               (library_chain,
                lambda y: (y, image_planes(pk.pyramid(image, levels)))),
               {"levels": levels, "levels_exact": shapes},
               outputs=image_planes)
        pyramid_gradients_case(image[None], path, levels,
                               {"levels_exact": shapes})
        for level, (lh, lw) in enumerate(shapes):
            if (lh, lw) not in level_rows:
                level_rows.add((lh, lw))
                gradients_case(pk.pyramid_plain(image, level + 1)[-1]
                               .contiguous(), path,
                               {"level": level, "levels_of": what})

    level_rows = set()     # level shapes with a B2 row

    def pyramid_gradients_case(frames, path, levels, extra=None):
        """B2 per pyramid on n frames (n,h,w): one launch writes every
        level's gx and gy from the image planes B1 wrote (once, before the
        timing); each level of each frame bit for bit gradients_plain, each
        frame its one-frame launch; the library call is one two-channel
        conv2d a level, chained, compared on each level's interior. Bytes:
        every level's image read once, gx and gy written once."""
        n, h, w = frames.shape
        flat = pk._launch_b1(frames, levels)
        bufs = pk.level_views(flat, h, w, levels)

        def kernel():
            pk._launch_b2_levels(flat, h, w, levels)
            return [(b[:, 1], b[:, 2]) for b in bufs]

        plain_levels = pk.pyramid_plain(frames, levels)
        kernel()
        for b in range(n if n > 1 else 0):
            one = pk.pyramid_op(frames[b], levels)
            require(torch.equal(flat[b], one),
                    f"gradients per pyramid: frame {b} differs from its "
                    f"one-frame launch")
        pixels = n * sum(sz[1] * sz[2] for sz, _, _ in pk._layout(
            h, w, levels)[1])
        x = [b[:, :1] for b in bufs]          # every level's image plane

        def library_chain():
            return [F.conv2d(y, stencil, padding=1) for y in x]

        record("gradients", kernel,
               lambda: [pk.gradients_plain(lv) for lv in plain_levels],
               0.0, 0.0, [n, h, w] if n > 1 else [h, w], path,
               4.0 * 3 * pixels, 4.0 * pixels,
               (library_chain,
                lambda y: ([g[:, :, 1:-1, 1:-1] for g in y],
                           [torch.stack(g, 1)[:, :, 1:-1, 1:-1]
                            for g in kernel()])),
               {"levels": levels, "per_pyramid": True,
                **({"problems": n, "each_problem_bit_equal": True}
                   if n > 1 else {}), **(extra or {})})

    # B2's library call: both central differences as two conv2d channels
    stencil = torch.zeros(2, 1, 3, 3, device=device)
    stencil[0, 0, 1, 0], stencil[0, 0, 1, 2] = -0.5, 0.5
    stencil[1, 0, 0, 1], stencil[1, 0, 2, 1] = -0.5, 0.5

    def gradients_case(image, path, extra=None):
        """B2 on one level, exact; the library call is a two-channel
        conv2d, compared on the interior."""
        h, w = image.shape
        x = image[None, None]
        record("gradients", lambda: pk.gradients(image),
               lambda: pk.gradients_plain(image), 0.0, 0.0, [h, w], path,
               4.0 * 3 * h * w, 4.0 * h * w,
               (lambda: F.conv2d(x, stencil, padding=1),
                lambda y: (y[0, :, 1:-1, 1:-1],
                           torch.stack(pk.gradients(image))[:, 1:-1, 1:-1])),
               extra)

    def patch_case(image, uv, P, path, use, K=1, extra=None):
        """B3 at centres ``uv`` on ``image`` (K = 3: the level's image, gx
        and gy in one launch): bit for bit the plain version."""
        h, w = image.shape
        src = image
        if K == 3:
            levels, gxs, gys = pyramid.build_with_gradients(image, 1)
            src = pyramid.level_planes(levels[0], gxs[0], gys[0])
        M, P2 = uv.numel() // 2, P * P
        half = (P - 1) / 2.0
        flat = uv.reshape(-1, 2)
        inner = ((flat[:, 0] >= half + 1) & (flat[:, 0] <= w - half - 3)
                 & (flat[:, 1] >= half + 1) & (flat[:, 1] <= h - half - 3))
        grid = _grid(uv, P, h, w, K)
        planes = src.reshape(K, 1, h, w)
        record("sample_patches", lambda: ak.sample_patches(src, uv, P),
               lambda: ak.sample_patches_plain(src, uv, P), 0.0, 0.0,
               [K, h, w, M, P], path,
               4.0 * (K * footprint_pixels(h, w, uv, P) + 2 * M
                      + K * M * P2),
               # per output: 4 operations for the tap coordinates, 9 for
               # the blend
               13.0 * K * M * P2,
               (lambda: F.grid_sample(planes, grid, mode="bilinear",
                                      padding_mode="border",
                                      align_corners=True),
                lambda y: (y[:, 0][:, inner], ak.sample_patches(
                    src, uv, P).reshape(K, M, P2)[:, inner])),
               {"use": use, "interior_centres": int(inner.sum()),
                **(extra or {})})

    def gn_case(image, N, path, use, uv_in=None, feature_mask=None,
                tol_rel=1e-4, extra=None):
        """B4 at N features, P=4, on ``image`` with (a, b) != (1, 0) and a
        per-pixel mask (times ``feature_mask`` where given); at ``uv_in``,
        or N centres drawn inside the image; bit-reproducible, also after a
        call at another width on the same stream."""
        P = 4
        h, w = image.shape
        if uv_in is None:
            uv_in = (torch.rand(N, 2, generator=gen)
                     * torch.tensor([w - 8.0, h - 8.0]) + 4.0).to(device)
        cur = ak.sample_patches_plain(image, uv_in, P)
        a_il = torch.tensor(1.3, device=device)
        b_il = torch.tensor(-7.0, device=device)
        tmpl = ((cur - b_il) / a_il
                + 6.0 * torch.randn(cur.shape, generator=gen).to(device))
        jac = torch.randn(N, P * P, 6, generator=gen).to(device) * 50.0
        mask = (torch.rand(N, P * P, generator=gen) > 0.2).float().to(device)
        if feature_mask is not None:
            mask = mask * feature_mask[:, None].float()
        args = (image, uv_in, tmpl.contiguous(), jac, mask, P, 8.0, a_il,
                b_il)
        kern = ak.gn_accumulate(*args)
        plain = ak.gn_accumulate_plain(*args)
        for a, b, name in zip(kern[3:], plain[3:], ("n_eff", "n_inl")):
            require(float(a) == float(b), f"gn_accumulate N={N} {name}: "
                                          f"{float(a)} vs {float(b)}")
        again = ak.gn_accumulate(*args)
        require(all(torch.equal(a, b) for a, b in zip(kern, again)),
                f"gn_accumulate N={N} is not bit-reproducible")
        gn_runs[N] = (args, kern)
        terms = N * P * P
        # H, g, cost: float32 sums of N·16 terms in two orders, so the
        # error is judged relative to each output's largest entry
        record("gn_accumulate", lambda: ak.gn_accumulate(*args)[:3],
               lambda: ak.gn_accumulate_plain(*args)[:3], 0.0, tol_rel,
               [h, w, N, P], path,
               4.0 * (footprint_pixels(h, w, uv_in, P) + 2 * N + terms * 8
                      + 2 + 45),
               # per term: 13 to sample, 6 for the residual and Huber
               # weight, 6 + 42 + 12 for Jw, H and g, 5 for cost and counts
               84.0 * terms, None,
               {"use": use, "a_b": [1.3, -7.0],
                "blocks": _build.load_library().svo_gn_blocks(N, P),
                "bit_reproducible": True, **(extra or {})})

    def centres(N, h, w, n_border=0):
        """N centres over the image and 2 px beyond it; the first
        ``n_border`` within 3 px of a corner side."""
        uv = (torch.rand(N, 2, generator=gen)
              * torch.tensor([w + 4.0, h + 4.0]) - 2.0)
        edge = torch.rand(n_border, 2, generator=gen) * 5.0 - 3.0
        uv[:n_border // 2] = edge[:n_border // 2]
        uv[n_border // 2:n_border] = (torch.tensor([w - 1.0, h - 1.0])
                                      + edge[n_border // 2:])
        return uv.to(device)

    gn_runs = {}
    kitti = kitti_frame.contiguous()
    half_img, half_kitti = pk.halfsample(img), pk.halfsample(kitti)
    uv192 = centres(192, H, W, n_border=48)
    # ---- main path (phase 3): the first row of each kernel ----
    pyramid_case(img, "phase3", 4, "752x480")
    patch_case(img, uv192, 8, "phase3", "KLT iterations")
    gn_case(img, 192, "phase3", "alignment refresh pass")
    patch_case(img, uv192, 4, "phase3", "alignment inner passes")
    patch_case(img, uv192, 4, "phase3", "alignment template", K=3)
    patch_case(img, uv192, 8, "phase3", "KLT template (keyframes)", K=3)
    # ---- the other paths' shapes ----
    pyramid_case(kitti, "phase4", 4, "1241x376")
    pyramid_case(img, "phase5", 5, "752x480 5-level")
    # epipolar search: 240 seeds x 16 probes on KITTI level 1 (620x188)
    patch_case(half_kitti, centres(240 * 16, *half_kitti.shape), 8,
               "phase4", "epipolar probes")
    patch_case(kitti, centres(240, *kitti.shape), 8, "phase4", "KITTI KLT")
    patch_case(img, centres(2048, H, W), 8, "phase5", "stress KLT")
    # affine KLT: oversized 16x16 templates at N=192 on the 752x480 level
    patch_case(img, uv192, 16, "phase6", "big templates")
    # alignment's refresh pass at the KITTI (level 0) and stress (level 1,
    # its finest alignment level) widths
    gn_case(kitti, 240, "phase4", "KITTI alignment")
    gn_case(half_img, 2048, "phase5", "stress alignment")
    # one launch per call leaves the ticket counter at 0 whatever the grid:
    # N = 192 → 2048 → 192 back to back repeats each first result
    outs = [ak.gn_accumulate(*gn_runs[N][0]) for N in (192, 2048, 192)]
    for out, N in zip(outs, (192, 2048, 192)):
        require(all(torch.equal(a, b) for a, b in zip(out, gn_runs[N][1])),
                f"gn_accumulate N={N} changed after a call at another width")
    emit("phase2_gn_alternation", {"widths": [192, 2048, 192],
                                   "bit_equal": True})
    # loop-edge measurement at the keyframe thumbnail: B2 on the thumbnail,
    # the template (K=3) and inner passes (K=1) of B3 and the refresh
    # passes of B4 at the features' centres scaled to it, P = loop_patch
    t_img, t_uv, t_mask = thumb
    edge = {"thumbnail": True}
    gradients_case(t_img, "phase7", edge)
    patch_case(t_img, t_uv, 4, "phase7", "loop template", K=3, extra=edge)
    patch_case(t_img, t_uv, 4, "phase7", "loop inner passes", extra=edge)
    gn_case(t_img, t_uv.shape[0], "phase7", "loop refresh pass", uv_in=t_uv,
            feature_mask=t_mask, tol_rel=4e-7, extra=edge)

    # ---- the problem axis: one launch for a batch (phase 8's B sequences
    # at the main path's shapes; LOOP_EDGES edges of one pass of
    # measure_edges at the thumbnail), each problem bit for bit its
    # one-problem launch ----
    def varied(image, n):
        """n frames of one shape: ``image`` shifted and lightly noised."""
        return torch.stack([
            torch.roll(image, 11 * b, dims=1)
            + torch.rand(image.shape, generator=gen).to(device) * b
            for b in range(n)]).contiguous()

    def each_problem(name, out, one, n, what):
        for b in range(n):
            require(torch.equal(out[b], one(b)),
                    f"{name} {what}: problem {b} differs from its "
                    f"one-problem launch")

    def batch_pyramid_case(frames, levels, path, use):
        n, h, w = frames.shape
        total, views, _ = pk._layout(h, w, levels)
        flat = pk.pyramid(frames, levels)
        singles = [pk.pyramid(frames[b], levels) for b in range(n)]
        for b in range(n):
            for lv in range(levels):
                require(torch.equal(flat[lv][b, 0], singles[b][lv][0]),
                        f"halfsample {use}: problem {b} level {lv} differs "
                        f"from its one-problem launch")
        coarse = sum(sz[1] * sz[2] for sz, _, _ in views[1:])
        x = frames[:, None]

        def library_chain():
            out = [torch.empty_like(frames).copy_(frames)]
            y = x
            for _ in range(levels - 1):
                y = F.avg_pool2d(y, 2)
                out.append(y[:, 0])
            return out

        def image_planes(bufs):
            return [b[:, 0] for b in bufs]

        record("halfsample", lambda: pk.pyramid(frames, levels),
               lambda: pk.pyramid_plain(frames, levels), 0.0, 0.0,
               [n, h, w], path, 4.0 * n * (2 * h * w + coarse),
               4.0 * n * coarse,
               (library_chain,
                lambda y: (y, image_planes(pk.pyramid(frames, levels)))),
               {"levels": levels, "problems": n, "use": use,
                "each_problem_bit_equal": True}, outputs=image_planes)

    def batch_gradients_case(frames, path, use):
        n, h, w = frames.shape
        out = pk.gradients_op(frames)
        each_problem("gradients", out,
                     lambda b: pk.gradients_op(frames[b]), n, use)
        record("gradients", lambda: pk.gradients_op(frames),
               lambda: torch.stack(pk.gradients_plain(frames), 1), 0.0, 0.0,
               [n, h, w], path, 4.0 * 3 * n * h * w, 4.0 * n * h * w,
               (lambda: F.conv2d(frames[:, None], stencil, padding=1),
                lambda y: (y[:, :, 1:-1, 1:-1],
                           pk.gradients_op(frames)[:, :, 1:-1, 1:-1])),
               {"problems": n, "use": use, "each_problem_bit_equal": True})

    def batch_patch_case(srcs, uv, P, path, use):
        """B3 over n problems: srcs (n,K,h,w), uv (n,M,2)."""
        n, K, h, w = srcs.shape
        M, P2 = uv.shape[1], P * P
        out = ak.sample_patches_op(srcs, uv, P)
        each_problem("sample_patches", out,
                     lambda b: ak.sample_patches_op(srcs[b], uv[b], P), n,
                     use)
        grid = torch.cat([_grid(uv[b], P, h, w, K) for b in range(n)])
        planes = srcs.reshape(n * K, 1, h, w)
        half = (P - 1) / 2.0
        inner = ((uv[..., 0] >= half + 1) & (uv[..., 0] <= w - half - 3)
                 & (uv[..., 1] >= half + 1) & (uv[..., 1] <= h - half - 3))
        inner_k = inner[:, None].expand(n, K, M).reshape(n * K, M)
        record("sample_patches", lambda: ak.sample_patches_op(srcs, uv, P),
               lambda: ak.sample_patches_batched_plain(srcs, uv, P), 0.0,
               0.0, [n, K, h, w, M, P], path,
               4.0 * sum(K * footprint_pixels(h, w, uv[b], P) + 2 * M
                         + K * M * P2 for b in range(n)),
               13.0 * n * K * M * P2,
               (lambda: F.grid_sample(planes, grid, mode="bilinear",
                                      padding_mode="border",
                                      align_corners=True),
                lambda y: (y[:, 0][inner_k], ak.sample_patches_op(
                    srcs, uv, P).reshape(n * K, M, P2)[inner_k])),
               {"problems": n, "use": use, "each_problem_bit_equal": True,
                "interior_centres": int(inner.sum())})

    def batch_gn_case(imgs, uv, path, use, feature_mask=None, tol_rel=1e-4):
        """B4 over n problems at (n,N,2) centres, P = 4."""
        P = 4
        n, h, w = imgs.shape
        N = uv.shape[1]
        cur = ak.sample_patches_batched_plain(imgs[:, None], uv, P)[:, 0]
        a_il = torch.linspace(0.9, 1.3, n, device=device)
        b_il = torch.linspace(-7.0, 3.0, n, device=device)
        tmpl = ((cur - b_il[:, None, None]) / a_il[:, None, None]
                + 6.0 * torch.randn(cur.shape, generator=gen).to(device))
        jac = torch.randn(n, N, P * P, 6, generator=gen).to(device) * 50.0
        mask = (torch.rand(n, N, P * P, generator=gen) > 0.2).float().to(
            device)
        if feature_mask is not None:
            mask = mask * feature_mask[..., None].float()
        args = (imgs, uv, tmpl.contiguous(), jac, mask)
        out = ak.gn_accumulate_op(*args, P, 8.0, a_il, b_il)
        each_problem("gn_accumulate", out, lambda b: ak.gn_accumulate_op(
            *(x[b] for x in args), P, 8.0, a_il[b], b_il[b]), n, use)
        plain = ak.gn_accumulate_batched_plain(*args, P, 8.0, a_il, b_il)
        require(torch.equal(out[:, 43:], plain[:, 43:]),
                f"gn_accumulate {use}: counts differ from the plain version")
        terms = n * N * P * P
        # H, g and cost (outputs 0-42): float32 sums of N·16 terms in two
        # orders, judged relative to the largest entry of all problems
        record("gn_accumulate",
               lambda: ak.gn_accumulate_op(*args, P, 8.0, a_il,
                                           b_il)[:, :43],
               lambda: ak.gn_accumulate_batched_plain(*args, P, 8.0, a_il,
                                                      b_il)[:, :43],
               0.0, tol_rel, [n, h, w, N, P], path,
               4.0 * (sum(footprint_pixels(h, w, uv[b], P)
                          for b in range(n)) + n * (2 * N + 2 + 45)
                      + terms * 8),
               84.0 * terms, None,
               {"problems": n, "use": use, "each_problem_bit_equal": True,
                "blocks_per_problem": _build.load_library().svo_gn_blocks(
                    N, P)})

    frames8 = varied(img, BATCH)
    uv8 = torch.stack([centres(192, H, W, n_border=48)
                       for _ in range(BATCH)])
    planes0 = pk.pyramid_with_gradients(frames8, 4)[0]     # (8,3,H,W)
    batch_pyramid_case(frames8, 4, "phase8", "8 frames, 752x480, 4 levels")
    pyramid_gradients_case(frames8, "phase8", 4,
                           {"use": "8 frames, 752x480, 4 levels"})
    batch_gradients_case(frames8, "phase8", "8 frames, 752x480 level 0")
    batch_patch_case(planes0[:, :1], uv8, 8, "phase8",
                     "8 sequences, KLT iterations")
    batch_patch_case(planes0[:, :1], uv8, 4, "phase8",
                     "8 sequences, alignment inner passes")
    batch_patch_case(planes0, uv8, 4, "phase8",
                     "8 sequences, alignment template")
    batch_gn_case(frames8, uv8, "phase8", "8 sequences, refresh pass")
    thumbs = varied(t_img, LOOP_EDGES)
    t_uv8 = torch.stack([t_uv + 0.37 * b for b in range(LOOP_EDGES)])
    t_mask8 = t_mask[None].expand(LOOP_EDGES, -1)
    t_planes = torch.cat([thumbs[:, None], pk.gradients_op(thumbs)], 1)
    batch_gradients_case(thumbs, "phase7",
                         f"{LOOP_EDGES} edges, thumbnail")
    batch_patch_case(t_planes, t_uv8, 4, "phase7",
                     f"{LOOP_EDGES} edges, loop template")
    batch_patch_case(t_planes[:, :1], t_uv8, 4, "phase7",
                     f"{LOOP_EDGES} edges, loop inner passes")
    batch_gn_case(thumbs, t_uv8, "phase7", f"{LOOP_EDGES} edges, loop "
                  f"refresh pass", feature_mask=t_mask8)

    align_rows(record, device, gen, img, kitti, thumb, edge)
    refine_rows(record, device, gen)
    klt_rows(record, device, gen, img, kitti)
    return rows


def align_rows(record, device, gen, img, kitti, thumb, edge):
    """Phase 2's rows of the fused alignment (align_levels_kernel): the
    whole of ops/align.align in one launch against its chain of ops, B3 and
    B4, at each path's shapes: a template of the frame at N centres (depths
    2-5 m) aligned to a brightened, noised copy of the frame from a
    perturbed pose; ``record`` is check_kernels' recorder."""
    import torch
    from stereo_svo_tpu_torch.backend import loop_closure
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.geometry import se3
    from stereo_svo_tpu_torch.ops import align, pyramid
    from stereo_svo_tpu_torch.ops.kernels import _build
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk

    H, W = img.shape
    t_img, t_uv, t_mask = thumb

    def align_problem(image, cam, acfg, uv, mask=None, thumb=False):
        """(target levels, template, T_init): the template of ``image`` at
        ``uv``, its target the image brightened (a, b) = (1.1, 3) with
        noise (sigma 2), so the cost stays well above rounding."""
        N = uv.shape[0]
        noise = torch.randn(image.shape, generator=gen).to(device)
        target = 1.1 * image + 3.0 + 2.0 * noise
        if thumb:
            levels = ((image,), *((g,) for g in pk.gradients(image)))
            target_levels = (target,)
        else:
            levels = pyramid.build_with_gradients(image, acfg.num_levels)
            target_levels = pyramid.build_with_gradients(
                target, acfg.num_levels)[0]
        z = (2.0 + 3.0 * torch.rand(N, generator=gen)).to(device)
        if mask is None:
            mask = torch.ones(N, dtype=torch.bool, device=device)
        tmpl = align.make_template(*levels, cam, acfg, uv, z, mask)
        xi = torch.tensor([0.004, -0.003, 0.006, 0.002, -0.001, 0.0015],
                          device=device)
        return target_levels, tmpl, se3.exp(xi)

    def interior(N, h, w, margin):
        return (torch.rand(N, 2, generator=gen)
                * torch.tensor([w - 2.0 * margin, h - 2.0 * margin])
                + margin).to(device)

    def extra_of(s, N, kernel, plain, use, extra):
        """A row's own keys: passes, block size, the kernel's and the
        chain's graphed µs."""
        return {"use": use, "levels": len(s.levels),
                "passes": sum(c * (1 + i) for c, i in s.schedule),
                "threads": _build.load_library().svo_align_threads(
                    N, s.patch),
                **graphed_us(kernel, plain),
                "bound_note": "latency: the passes depend on each other",
                **(extra or {})}

    def align_case(levels, tmpl, T_init, cam, acfg, path, use, extra=None):
        s = align.spec(cam, acfg)
        lv = [levels[i] for i in s.levels]
        N, P = tmpl.p_ref.shape[0], s.patch

        def kernel():
            return ak.align_levels(lv, tmpl.p_ref, tmpl.patches, tmpl.jac,
                                   tmpl.mask, T_init, s)

        def plain():
            T, st = align.align_plain(levels, tmpl, cam, acfg, T_init)
            return T, st["align_cost"], st["align_inlier_frac"]
        first, again = kernel(), kernel()
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                f"align_levels {use}: not bit-reproducible")
        nbytes, flops = align_bytes_flops(N, P, s.schedule)
        record("align_levels", kernel, plain, ALIGN_TOL_ABS, ALIGN_TOL_REL,
               [list(lv[0].shape), list(lv[-1].shape), N, P], path, nbytes,
               flops, None, extra_of(s, N, kernel, plain, use, dict(
                   bit_reproducible=True, **(extra or {}))))

    def batch_align_case(levels, tmpl, T_init, cam, acfg, n, path, use,
                         extra=None):
        """n problems: the levels brightened by 0.5 b in problem b (the
        template shared, expanded as a vmap leaves it) from n perturbed
        poses."""
        s = align.spec(cam, acfg)
        lv = [torch.stack([levels[i] + 0.5 * b for b in range(n)])
              for i in s.levels]
        xi = 0.004 * torch.randn(n, 6, generator=gen).to(device)
        Ts = torch.stack([se3.compose(se3.exp(xi[b]), T_init)
                          for b in range(n)])
        N, P = tmpl.p_ref.shape[0], s.patch

        def kernel():
            return torch.func.vmap(lambda T, *x: ak.align_levels(
                list(x), tmpl.p_ref, tmpl.patches, tmpl.jac, tmpl.mask, T,
                s))(Ts, *lv)

        def plain():
            T, st = torch.func.vmap(lambda T, *x: align.chain(
                list(x), tmpl.p_ref, tmpl.patches, tmpl.jac, tmpl.mask, T,
                s))(Ts, *lv)
            return T, st["align_cost"], st["align_inlier_frac"]
        out = kernel()
        for b in range(n):
            one = ak.align_levels([x[b] for x in lv], tmpl.p_ref,
                                  tmpl.patches, tmpl.jac, tmpl.mask, Ts[b],
                                  s)
            require(all(torch.equal(o[b], y) for o, y in zip(out, one)),
                    f"align_levels {use}: problem {b} differs from its "
                    f"one-problem launch")
        nbytes, flops = align_bytes_flops(N, P, s.schedule)
        record("align_levels", kernel, plain, ALIGN_TOL_ABS, ALIGN_TOL_REL,
               [n, list(lv[-1].shape[1:]), N, P], path, n * nbytes,
               n * flops, None, extra_of(s, N, kernel, plain, use, dict(
                   problems=n, each_problem_bit_equal=True, **(extra or {}))))

    euroc_cfg, kitti_cfg, stress_cfg = (SvoConfig(), kitti_config(),
                                        stress_config())
    eu = align_problem(img, euroc_cfg.camera, euroc_cfg,
                       interior(192, H, W, 24))
    align_case(*eu, euroc_cfg.camera, euroc_cfg, "phase3", "tracking")
    ki = align_problem(kitti, kitti_cfg.camera, kitti_cfg,
                       interior(240, *kitti.shape, 24))
    align_case(*ki, kitti_cfg.camera, kitti_cfg, "phase4", "KITTI tracking")
    st = align_problem(img, stress_cfg.camera, stress_cfg,
                       interior(2048, H, W, 24))
    align_case(*st, stress_cfg.camera, stress_cfg, "phase5",
               "stress tracking")
    cam_t, cfg_t = loop_closure._thumb_cfg(euroc_cfg)
    th = align_problem(t_img, cam_t, cfg_t, t_uv, mask=t_mask, thumb=True)
    align_case(*th, cam_t, cfg_t, "phase7", "loop edge", extra=edge)
    batch_align_case(*eu, euroc_cfg.camera, euroc_cfg, BATCH, "phase8",
                     "8 sequences, tracking")
    batch_align_case(*th, cam_t, cfg_t, LOOP_EDGES, "phase7",
                     f"{LOOP_EDGES} edges, loop edge", extra=edge)


def refine_bytes_flops(N: int, chunks: int, inner: int) -> tuple:
    """The least bytes and the float32 operations of one pose refinement
    of N features: the points, observations, sigmas, disparities, masks and
    the two poses read once, the pose, RMS error, count and inlier mask
    written once; per feature ~60 operations a pass for the residual and
    its weights, a refresh pass ~150 more for the Jacobians and the 27
    sums, an inner pass ~30 for g."""
    nbytes = 4.0 * (N * 8 + 24 + 14) + 3 * N
    passes = chunks * (1 + inner) + 1
    flops = N * (60.0 * passes + chunks * 150.0 + chunks * inner * 30.0)
    return nbytes, flops


def refine_rows(record, device, gen):
    """Phase 2's rows of the fused pose refinement (refine_pose_kernel):
    the whole of frontend/pose_refine.refine in one launch against its
    chain of ops (refine_plain), at each path's N and intrinsics: N points
    2-20 m in front of the camera, seen from a moved pose with 0.3-px noise,
    1 in 20 a 15-px outlier, sigmas 1 or 2, disparities with 0.2-px noise
    on 4 in 5 of them, a motion prior near the true pose; ``record`` is
    check_kernels' recorder."""
    import torch
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.frontend import pose_refine
    from stereo_svo_tpu_torch.geometry import camera, se3
    from stereo_svo_tpu_torch.ops.kernels import _build
    from stereo_svo_tpu_torch.ops.kernels import refine_kernel as rk

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(device)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def refine_problem(cfg, N):
        cam = cfg.camera
        margin = 24.0
        uv = rand(N, 2) * torch.tensor(
            [cam.width - 2 * margin, cam.height - 2 * margin],
            device=device) + margin
        X_w = camera.backproject(cam, uv, 2.0 + 18.0 * rand(N))
        T_true = se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.004, -0.003,
                                       0.002], device=device))
        x_c = se3.transform(T_true, X_w)
        uv_obs = camera.project(cam, x_c)[0] + 0.3 * randn(N, 2)
        uv_obs = uv_obs + 15.0 * (rand(N, 1) < 0.05)
        mask = rand(N) < 0.95
        sigma = torch.exp2((rand(N) < 0.5).float())
        disp = (cam.fx * cam.baseline / torch.clamp(x_c[:, 2], min=0.2)
                + 0.2 * randn(N))
        dmask = mask & (rand(N) > 0.2)
        T_prior = se3.compose(se3.exp(0.002 * randn(6)), T_true)
        T_init = se3.compose(se3.exp(0.01 * randn(6)), T_true)
        kw = dict(obs_sigma=sigma, T_prior=T_prior, disp_obs=disp,
                  disp_mask=dmask, obs_sigma_d=sigma)
        return cam, cfg, (T_init, X_w, uv_obs, mask), kw

    def flat(out):
        T, inl, st = out
        return T, st["refine_rms_px"], st["refine_inliers"], inl

    def extra_of(cfg, N, kernel, plain, use, extra):
        chunks, inner = rk._static(cfg.camera, cfg)[2]
        return {"use": use, "passes": chunks * (1 + inner) + 1,
                "threads": _build.load_library().svo_refine_threads(N),
                **graphed_us(kernel, plain),
                "bound_note": "latency: the passes depend on each other",
                **(extra or {})}

    def refine_case(prob, path, use):
        cam, cfg, args, kw = prob
        N = args[1].shape[0]

        def kernel():
            return flat(rk.refine_pose(cam, cfg, *args, **kw))

        def plain():
            return flat(pose_refine.refine_plain(cam, cfg, *args, **kw))
        first, again = kernel(), kernel()
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                f"refine_pose {use}: not bit-reproducible")
        nbytes, flops = refine_bytes_flops(N, *rk._static(cam, cfg)[2])
        record("refine_pose", kernel, plain, ALIGN_TOL_ABS, ALIGN_TOL_REL,
               [N], path, nbytes, flops, None, extra_of(
                   cfg, N, kernel, plain, use, dict(bit_reproducible=True)))

    def batch_refine_case(prob, n, path, use):
        """n problems from n initial poses, the rest shared (expanded, as a
        vmap leaves it)."""
        cam, cfg, args, kw = prob
        N = args[1].shape[0]
        Ts = torch.stack([se3.compose(se3.exp(0.01 * randn(6)), args[0])
                          for _ in range(n)])

        def kernel():
            return torch.func.vmap(lambda T: flat(rk.refine_pose(
                cam, cfg, T, *args[1:], **kw)))(Ts)

        def plain():
            return torch.func.vmap(lambda T: flat(pose_refine.refine_plain(
                cam, cfg, T, *args[1:], **kw)))(Ts)
        out = kernel()
        for b in range(n):
            one = flat(rk.refine_pose(cam, cfg, Ts[b], *args[1:], **kw))
            require(all(torch.equal(o[b], y) for o, y in zip(out, one)),
                    f"refine_pose {use}: problem {b} differs from its "
                    f"one-problem launch")
        nbytes, flops = refine_bytes_flops(N, *rk._static(cam, cfg)[2])
        record("refine_pose", kernel, plain, ALIGN_TOL_ABS, ALIGN_TOL_REL,
               [n, N], path, n * nbytes, n * flops, None, extra_of(
                   cfg, N, kernel, plain, use, dict(
                       problems=n, each_problem_bit_equal=True)))

    euroc_cfg, kitti_cfg, stress_cfg = (SvoConfig(), kitti_config(),
                                        stress_config())
    eu = refine_problem(euroc_cfg, euroc_cfg.max_features)
    refine_case(eu, "phase3", "tracking")
    refine_case(refine_problem(kitti_cfg, kitti_cfg.max_features), "phase4",
                "KITTI tracking")
    refine_case(refine_problem(stress_cfg, stress_cfg.max_features),
                "phase5", "stress tracking")
    batch_refine_case(eu, BATCH, "phase8", "8 sequences, tracking")


def klt_errors(out, ref, what: str) -> dict:
    """klt_track's (uv, ok, res, n_warped) against its plain version's at
    KLT_TOL_PX and KLT_TOL_RES, the flags and counts exact: the widest
    gaps."""
    import torch
    uv, ok, res, nw = out
    puv, pok, pres, pnw = ref
    require(torch.equal(ok, pok) and torch.equal(nw, pnw),
            f"klt_track {what}: convergence or warped count differs from "
            f"the plain version")
    fin = torch.isfinite(puv)
    require(torch.equal(torch.isfinite(uv), fin),
            f"klt_track {what}: finite positions differ")
    uv_gap = float((uv[fin] - puv[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    res_gap = float((res - pres).abs().max()) / max(
        float(pres.abs().max()), 1e-30) if res.numel() else 0.0
    require(uv_gap <= KLT_TOL_PX and res_gap <= KLT_TOL_RES,
            f"klt_track {what}: positions {uv_gap} px, residuals {res_gap} "
            f"of the largest from the plain version")
    return {"max_uv_err_px": uv_gap, "max_res_rel_err": res_gap}


def klt_bytes_flops(N: int, P: int, L: int, iters: int, B2: int) -> tuple:
    """The least bytes and the float32 operations of one KLT of N features:
    the template (patches, gradients, inverse Hessians, masks; the
    oversized patches where B2 > 1), the positions and edgelet terms read
    once, each feature's (P+1)² pixels of each level once, the outputs
    written once; per iteration and pixel ~30 operations (the sample, the
    illumination fit, g and |e|), per feature ~20 more."""
    P2 = P * P
    nbytes = 4.0 * (L * N * (3 * P2 + 4 + (B2 if B2 > 1 else 0))
                    + N * (2 + 2 + 4 + 4) + L * N * (P + 1) ** 2) \
        + 2.0 * N + L * N + 4.0 * N * 3 + N
    flops = L * iters * N * (30.0 * P2 + 20.0)
    return nbytes, flops


def klt_rows(record, device, gen, img, kitti):
    """Phase 2's rows of the fused KLT (klt_track_kernel): the whole of
    ops/klt.track in one launch against its chain of ops and B3 launches
    (track_plain), at each path's N and patch: templates of the frame at N
    interior points (1 in 20 masked), tracked in the frame brightened
    (a, b) = (1.1, 3) with noise (sigma 2) from 1.5-px perturbed positions,
    3 in 10 features edgelets along a direction of their own; the
    affine-warp row warps through A_inv = I + 0.03 noise, and one level in
    seven of big_ok is cleared; ``record`` is check_kernels' recorder."""
    import math

    import torch
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.ops import klt, pyramid
    from stereo_svo_tpu_torch.ops.kernels import klt_kernel as kk

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(device)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def klt_problem(image, cfg):
        N, L = cfg.max_features, cfg.klt_levels
        h, w = image.shape
        margin = 24.0
        uv = rand(N, 2) * torch.tensor([w - 2 * margin, h - 2 * margin],
                                       device=device) + margin
        tmpl = klt.make_template(*pyramid.build_with_gradients(
            image, cfg.num_levels), cfg, uv, rand(N) < 0.95)
        if cfg.klt_affine_warp:
            big_ok = tmpl.big_ok.clone()
            big_ok[:, 0::7] = False
            tmpl = tmpl._replace(big_ok=big_ok)
        target = 1.1 * image + 3.0 + 2.0 * randn(h, w)
        levels = pyramid.build_with_gradients(target, cfg.num_levels)[0][:L]
        ang = 2.0 * math.pi * rand(N)
        kw = dict(edge_dir=torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                  is_edgelet=rand(N) < 0.3,
                  A_inv=(torch.eye(2, device=device) + 0.03 * randn(N, 2, 2)
                         if cfg.klt_affine_warp else None))
        return levels, tmpl, cfg, uv + 1.5 * randn(N, 2), kw

    def extra_of(cfg, kernel, plain, use, extra):
        return {"use": use, "iterations": cfg.klt_levels * cfg.klt_max_iters,
                **graphed_us(kernel, plain),
                "bound_note": "latency: the iterations depend on each other",
                **(extra or {})}

    def cost(prob, n=1):
        levels, tmpl, cfg, _, _ = prob
        nbytes, flops = klt_bytes_flops(
            tmpl.mask.shape[-1], cfg.klt_patch, cfg.klt_levels,
            cfg.klt_max_iters, tmpl.big.shape[-1])
        return n * nbytes, n * flops

    def klt_case(prob, path, use):
        """The row compares the positions (recorded), klt_errors the
        rest."""
        levels, tmpl, cfg, uv0, kw = prob

        def kernel():
            return kk.klt_track(levels, tmpl, cfg, uv0, **kw)

        def plain():
            return klt.track_plain(levels, tmpl, cfg, uv0, **kw)
        first, again = kernel(), kernel()
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                f"klt_track {use}: not bit-reproducible")
        errs = klt_errors(first, plain(), use)
        record("klt_track", lambda: kernel()[0], lambda: plain()[0],
               KLT_TOL_PX, 0.0,
               [list(levels[0].shape), tmpl.mask.shape[-1], cfg.klt_patch],
               path, *cost(prob), None, extra_of(
                   cfg, kernel, plain, use, dict(
                       bit_reproducible=True, n_warped=int(first[3]),
                       converged=int(first[1].sum()), **errs)))

    def batch_klt_case(prob, n, path, use):
        """n problems from n perturbations of the initial positions, the
        rest shared (expanded, as a vmap leaves it)."""
        levels, tmpl, cfg, uv0, kw = prob
        uvs = torch.stack([uv0 + 0.3 * randn(*uv0.shape) for _ in range(n)])

        def kernel():
            return torch.func.vmap(lambda uv: kk.klt_track(
                levels, tmpl, cfg, uv, **kw))(uvs)

        def plain():
            return torch.func.vmap(lambda uv: klt.track_plain(
                levels, tmpl, cfg, uv, **kw))(uvs)
        out = kernel()
        for b in range(n):
            one = kk.klt_track(levels, tmpl, cfg, uvs[b], **kw)
            require(all(torch.equal(o[b], y) for o, y in zip(out, one)),
                    f"klt_track {use}: problem {b} differs from its "
                    f"one-problem launch")
        errs = klt_errors(out, plain(), use)
        record("klt_track", lambda: kernel()[0], lambda: plain()[0],
               KLT_TOL_PX, 0.0,
               [n, list(levels[0].shape), tmpl.mask.shape[-1],
                cfg.klt_patch], path, *cost(prob, n), None, extra_of(
                   cfg, kernel, plain, use, dict(
                       problems=n, each_problem_bit_equal=True, **errs)))

    eu = klt_problem(img, SvoConfig())
    klt_case(eu, "phase3", "tracking")
    klt_case(klt_problem(kitti, kitti_config()), "phase4", "KITTI tracking")
    klt_case(klt_problem(img, stress_config()), "phase5", "stress tracking")
    klt_case(klt_problem(img, SvoConfig(klt_affine_warp=True)), "phase6",
             "affine-warp tracking")
    batch_klt_case(eu, BATCH, "phase8", "8 sequences, tracking")


def count_syncs(fn):
    """fn() under CUDA sync debug mode ("warn"): (its result, the host
    syncs it made, {file:line: count} of where). Each synchronising call
    warns, a few µs of host time each."""
    import torch
    sites = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    for w in hits:
        key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    return out, len(hits), sites


def prof_launches(fn, warmup=None):
    """{"kernels", "graphs", "copies", "total", "device_ms", "by_kernel"}
    of ``fn()`` under torch.profiler: the host's kernel launches, graph
    launches and memory copies, the device time of every CUDA record (the
    kernels a replayed graph runs included), and the device's records of
    each hand-written kernel, by launch counter. ``warmup()``, when given,
    runs first, in the profiler's warm-up step, whose records are
    discarded: the first graph replayed in a trace was seen to lose some
    of its kernels' records on the H100."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from stereo_svo_tpu_torch.engine import graphed
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warmup else None) as p:
        if warmup:
            warmup()
            torch.cuda.synchronize()
            p.step()
        fn()
        torch.cuda.synchronize()
    ka = p.key_averages()
    # with a schedule each step is also a user annotation on the device's
    # timeline ("ProfilerStep#n"), spanning the step, and so is each
    # profiler range of a graphed step ("svo.step", "svo.step.launch"): no
    # kernel
    on_device = [e for e in ka
                 if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and not e.key.startswith(("ProfilerStep", "svo."))]

    def count(keys):
        return sum(e.count for e in ka if e.key in keys)
    out = {"kernels": count(LAUNCH_KEYS), "graphs": count(GRAPH_KEYS),
           "copies": count(COPY_KEYS)}
    out["total"] = sum(out.values())
    out["device_ms"] = sum(getattr(e, "self_device_time_total", 0.0)
                           for e in on_device) / 1e3
    # every record of the device: kernels, copies, memsets
    out["device_records"] = sum(e.count for e in on_device)
    out["by_kernel"] = dict.fromkeys(KERNELS, 0)
    for e in on_device:
        key = graphed.counter_of(e.key)
        if key is not None:
            out["by_kernel"][key] += e.count
    return out


class EagerSvo:
    """The eager step (engine/step.make_step) driven as StereoSvo drives
    the graphed one, with StereoSvo's trajectory() and metrics(): phase
    12's eager runs."""

    def __init__(self, cfg, device="cuda"):
        from stereo_svo_tpu_torch.engine import state as state_mod
        from stereo_svo_tpu_torch.engine import step as step_mod
        self._step = step_mod.make_step(cfg)
        self.state = state_mod.init_state(cfg, device)
        self._flags = step_mod.HostFlags(booted=False, tracking_ok=True)
        self.outs = []

    def new_image(self, left, right):
        self.state, out, self._flags = self._step(self.state, left, right,
                                                  self._flags)
        self.outs.append(out)
        return out

    def trajectory(self):
        import torch
        return torch.stack([o.T_wc for o in self.outs]).cpu().numpy()

    def metrics(self):
        import torch
        return {k: torch.stack([getattr(o, k) for o in self.outs]).cpu()
                .numpy() for k in self.outs[0]._fields if k != "T_wc"}


def drive(cfg, lefts, rights, gt, counters, before_frame=None,
          make_svo=None, want=(0, 0)):
    """One run of StereoSvo (or ``make_svo(cfg)``) over the frames with
    every launch counter set to 0 just before and read just after: gates'
    inputs and timings, and the StereoSvo. ``before_frame(i, svo)`` runs
    before frame i, outside the frame's timing and sync count. Host syncs
    are counted on every frame under CUDA sync debug mode and must be
    ``want`` (the bootstrap frame's, every other frame's): none on any
    frame of a graphed step."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.eval import ate

    svo = (make_svo or StereoSvo)(cfg, device="cuda")
    n = lefts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    events, per_frame, sync_sites = [], [], {}
    t_wall = time.perf_counter()
    for i in range(n):
        if before_frame is not None:
            before_frame(i, svo)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def frame():
            a.record()
            svo.new_image(lefts[i], rights[i])
            b.record()

        _, count, sites = count_syncs(frame)
        events.append((a, b))
        per_frame.append(count)
        for key, c in sites.items():
            sync_sites[key] = sync_sites.get(key, 0) + c
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    launches = read_counters(counters, "on this path")
    frame_ms = [a.elapsed_time(b) for a, b in events]
    traj, metrics = svo.trajectory(), svo.metrics()
    require(traj.shape == (n, 3, 4) and np.isfinite(traj).all(),
            "trajectory must be finite (N,3,4)")
    gt = gt.cpu().numpy()
    kf = metrics["kf_inserted"]
    ba_frames = kf & (np.arange(n) > 0)       # window BA runs on these
    steady = frame_ms[1:]
    out = {
        "frames": n, "image": list(lefts.shape[1:]),
        "ate_m": ate.ate_rmse(ate.positions(traj), ate.positions(gt)),
        "gt_travel_m": float(np.sum(np.linalg.norm(
            np.diff(ate.positions(gt), axis=0), axis=-1))),
        "tracking_ok": float(np.mean(metrics["tracking_ok"])),
        "keyframes": int(kf.sum()),
        "ba_calls": int(ba_frames.sum()) if cfg.use_ba else 0,
        "ba_accepted": int(metrics["ba_diag"][ba_frames, 5].sum())
        if cfg.use_ba else 0,
        "epi_recovered": int(metrics["n_epi_recovered"].sum()),
        "warped_templates": int(metrics["n_warped"].sum()),
        "frame_ms_median": statistics.median(steady),
        "frame_ms_p90": statistics.quantiles(steady, n=10)[8],
        "kf_frame_ms_median": statistics.median(
            [frame_ms[i] for i in np.nonzero(ba_frames)[0]] or [0.0]),
        "track_frame_ms_median": statistics.median(
            [frame_ms[i] for i in range(1, n) if not kf[i]] or [0.0]),
        "fps": 1000.0 * len(steady) / sum(steady),
        "fps_wall_incl_first": n / wall_s, "first_frame_ms": frame_ms[0],
        "launches": launches,
        "launches_per_frame": {k: v / n for k, v in launches.items()},
        "max_memory_allocated_mb":
            torch.cuda.max_memory_allocated() / 2**20,
        "host_syncs_per_frame": {str(c): per_frame.count(c)
                                 for c in sorted(set(per_frame))},
        "sync_sites": sync_sites,
    }
    require(per_frame[0] == want[0] and all(c == want[1]
                                            for c in per_frame[1:]),
            f"host syncs per frame {per_frame} (want {want[0]} on the "
            f"bootstrap, {want[1]} on every other frame): {sync_sites}")
    return out, frame_ms, metrics, svo


def inject_world_offset(state, D):
    """tests/test_online_loop.py's drift event: the window (current and
    template poses, window keyframes and the bank slots they own) moves by
    D ((3,4), cam→world side), older bank poses stay where they were."""
    import torch
    from stereo_svo_tpu_torch.frontend import keyframe
    from stereo_svo_tpu_torch.geometry import se3
    M = state.mem_valid.shape[0]
    owns = state.kf_valid & (state.mem_stamp[state.kf_mem] == state.kf_stamp)
    owned = (keyframe._one_hot(state.kf_mem, M) & owns[None]).any(1)
    Dinv = se3.inverse(D)
    return state._replace(
        T_cw=se3.compose(state.T_cw, Dinv), T_pw=se3.compose(state.T_pw, Dinv),
        kf_T_wk=torch.where(state.kf_valid[:, None, None],
                            se3.compose(D, state.kf_T_wk), state.kf_T_wk),
        mem_T_wk=torch.where(owned[:, None, None],
                             se3.compose(D, state.mem_T_wk), state.mem_T_wk))


@contextlib.contextmanager
def watch_calls(module, name, counters):
    """While the block runs, ``module.<name>`` (looked up at each call by
    its callers) is wrapped: per call, the launches each kernel counter
    gained, the host ms to issue it (no sync: the call makes none) and a
    CUDA-event pair around it; the last call's arguments are kept, their
    tensors cloned after the call (the graphed step's buffers they may lie
    in are overwritten by later frames)."""
    import torch
    orig = getattr(module, name)
    calls = []

    def keep(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(keep(v) for v in x))
        return x

    def wrapped(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            # recorded into a graph of the step: its replays run it
            calls.append({"capturing": True})
            return orig(*args, **kwargs)
        before = {k: v for c in counters for k, v in c.items()}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = orig(*args, **kwargs)
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        if calls:                        # only the last call's are kept
            calls[-1].pop("args", None)
            calls[-1].pop("kwargs", None)
        calls.append({"launches": {k: v - before[k] for c in counters
                                   for k, v in c.items()},
                      "host_ms": host_ms, "events": (a, b),
                      "capturing": False,
                      "args": tuple(keep(x) for x in args),
                      "kwargs": {k: keep(v) for k, v in kwargs.items()}})
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def tail_err(traj, gt, k: int = 5) -> float:
    """Mean position error (m) over the last k frames."""
    import numpy as np
    return float(np.linalg.norm(traj[-k:, :, 3] - gt[-k:, :, 3],
                                axis=1).mean())


def loop_run(cfg, lefts, rights, gt, counters, device):
    """A phase-7 run: StereoSvo over the loop sequence with the drift
    injected before frame LOOP_INJECT_AT. The online loop lives in the
    step's K_loop graph: its calls are watched, and it must be recorded
    into that graph once and run eagerly once (the warm-up), never inside
    a frame; its launches per call are K_loop's kernel nodes beyond K's.
    Returns (result dict, the StereoSvo)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.geometry import se3

    D = se3.exp(torch.tensor(LOOP_DRIFT, dtype=torch.float32, device=device))

    def inject(i, svo):
        if i == LOOP_INJECT_AT:
            svo.state = inject_world_offset(svo.state, D)

    with watch_calls(step_mod, "run_online_loop", counters) as calls:
        out, frame_ms, metrics, svo = drive(cfg, lefts, rights, gt, counters,
                                            before_frame=inject)
    traj, gt_np = svo.trajectory(), gt.cpu().numpy()
    step = svo._step
    out.update(kf_frames=np.nonzero(metrics["kf_inserted"])[0].tolist(),
               n_loop_closures=int(svo.state.n_loop_closures),
               tail_err_m=tail_err(traj, gt_np),
               loop_calls=step.replays["K_loop"],
               replays=dict(step.replays),
               online_loop_captured=sum(c["capturing"] for c in calls),
               online_loop_eager=sum(not c["capturing"] for c in calls),
               frame_ms_all=frame_ms)
    want = 1 if cfg.online_loop_every > 0 else 0
    require(out["online_loop_captured"] == out["online_loop_eager"] == want,
            f"the online loop ran {out['online_loop_eager']} times eagerly "
            f"and was captured {out['online_loop_captured']} times, want "
            f"{want} and {want} (the warm-up and graph K_loop)")
    if step.replays["K_loop"]:
        k, kl = step.kernel_nodes["K"], step.kernel_nodes["K_loop"]
        n_frames = lefts.shape[0]
        call_frames = [i for i in range(n_frames)
                       if metrics["kf_inserted"][i] and i > 0]
        out["loop_call"] = {
            "launches_per_call": {x: kl[x] - k[x] for x in kl},
            "kernel_nodes_K": k, "kernel_nodes_K_loop": kl,
            "kf_frame_ms_median": statistics.median(
                frame_ms[i] for i in call_frames)}
        missing = [x for x in ("gradients", "sample_patches",
                               "align_levels")
                   if out["loop_call"]["launches_per_call"][x] <= 0]
        require(not missing, f"an online-loop call launched no {missing}")
    return out, svo


def refine_run(cfg, svo, gt, counters):
    """refine_trajectory on a run's final state (host numpy at its end, so
    the host ms are its wall time): offline edges, launches of each
    kernel, host ms, and the refined trajectory's errors."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import loop_closure
    from stereo_svo_tpu_torch.eval import ate

    traj, gt_np = svo.trajectory(), gt.cpu().numpy()
    before = counted(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, _, n_edges = loop_closure.refine_trajectory(cfg, svo.state, traj)
    host_ms = (time.perf_counter() - t0) * 1e3
    require(np.isfinite(refined).all(), "refine_trajectory: not finite")
    after = counted(counters)
    return {"offline_edges": n_edges, "host_ms": host_ms,
            "kernel_launches": {k: after[k] - before[k] for k in after},
            "tail_err_m": tail_err(refined, gt_np),
            "ate_m": ate.ate_rmse(ate.positions(refined),
                                  ate.positions(gt_np))}


def batched_run(cfg, counters, device, traj3):
    """Phase 8: BATCH sequences of the planes scene (seeds 0 to BATCH-1) on
    the arc trajectory, BATCH_FRAMES frames at DT, through
    run_sequence_batched on the graphed batched step (every phase captured
    once for the whole batch, ``vmap``ped over one stacked state), with
    the launch counters zeroed just before and the host syncs of every
    batched frame counted. Then each sequence alone through one single
    graphed step (reset between sequences), the reference of its
    keyframes and positions; ``traj3``: phase 3's trajectory, which the
    single run of sequence 0 repeats bit for bit. Then BATCH_STEADY_FRAMES
    host-timed batched frames on the final states (the last images again)
    and one more under torch.profiler: host launches and device ms of one
    batched frame."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.config import stress_config
    from stereo_svo_tpu_torch.engine import graphed, runner
    from stereo_svo_tpu_torch.engine.state import init_state
    from stereo_svo_tpu_torch.eval import ate
    from stereo_svo_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    seqs = [synthetic.make_sequence(cfg.camera, BATCH_FRAMES, DT, kind="arc",
                                    seed=b, device=device)
            for b in range(BATCH)]
    lefts = torch.stack([q[0] for q in seqs])
    rights = torch.stack([q[1] for q in seqs])
    gt = seqs[0][2].cpu().numpy()      # one trajectory for every scene
    del seqs
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0

    # run_sequence_batched looks the step's maker up at each call
    make = runner.make_graphed_batched_step
    syncs, sites, made = [], {}, {}

    class Counted:
        """The batched step, its host syncs counted on every call."""

        def __init__(self, bstep):
            self.bstep = made["bstep"] = bstep

        def __getattr__(self, name):
            return getattr(self.bstep, name)

        def __call__(self, *args):
            made.setdefault("first_frame", time.perf_counter())
            out, n, where = count_syncs(lambda: self.bstep(*args))
            syncs.append(n)
            for key, v in where.items():
                sites[key] = sites.get(key, 0) + v
            return out

    def counted(c, B, dev):
        return Counted(make(c, B, dev))

    zero_counters(counters)
    runner.make_graphed_batched_step = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, outs = runner.run_sequence_batched(cfg, lefts, rights,
                                                   device=device)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        runner.make_graphed_batched_step = make
    wall_s, frames_s = t_end - t0, t_end - made["first_frame"]
    launches = read_counters(counters, "in the batch")
    bstep = made["bstep"]
    replays = dict(bstep.replays)
    traj = outs.T_wc.cpu().numpy()
    ok = outs.tracking_ok.cpu().numpy()
    kf = outs.kf_inserted.cpu().numpy()
    states = graphed._tree(states, iter([x.clone() for x in
                                         graphed._leaves(states)]))

    # each sequence alone on one single graphed step
    single = graphed.make_graphed_step(cfg, device)
    ref_traj, ref_kf = [], []
    for b in range(BATCH):
        single.load(init_state(cfg, device))
        poses, kfs = [], []
        for t in range(BATCH_FRAMES):
            _, o = single(single.state, lefts[b, t], rights[b, t])
            poses.append(o.T_wc.clone())
            kfs.append(o.kf_inserted.clone())
        ref_traj.append(torch.stack(poses).cpu().numpy())
        ref_kf.append(torch.stack(kfs).cpu().numpy())
    pos_err = [float(np.linalg.norm(
        traj[b, :, :, 3] - ref_traj[b][:, :, 3], axis=-1)[
            :BATCH_POS_FRAMES].max()) for b in range(BATCH)]
    pos_err_all = [float(np.linalg.norm(
        traj[b, :, :, 3] - ref_traj[b][:, :, 3], axis=-1).max())
        for b in range(BATCH)]
    kf_equal = [bool(np.array_equal(kf[b], ref_kf[b])) for b in range(BATCH)]
    single_nodes = single.nodes
    # the phases' bodies (not the flags body's bookkeeping or the frame
    # graph's own set nodes)
    ratio = {name: bstep.nodes[name]["kernel"] / single_nodes[name]["kernel"]
             for name in single_nodes if name not in ("flags", "F")}
    # what the batched graphs hold beyond the single step's: kernel nodes
    # by CUDA function, the largest differences first
    node_diff = {}
    for name in single.graphs:
        a = graphed.kernel_names(bstep.graphs[name])
        b = graphed.kernel_names(single.graphs[name])
        d = [(a.get(k, 0) - b.get(k, 0), k[:160]) for k in set(a) | set(b)]
        node_diff[name] = sorted((x for x in d if x[0]),
                                 key=lambda x: -abs(x[0]))[:15]

    def more():
        bstep(bstep.state, lefts[:, -1], rights[:, -1])
    steady = []
    for _ in range(BATCH_STEADY_FRAMES):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        more()
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t1) * 1e3)
    steady_ms = statistics.median(steady)
    prof = prof_launches(more, warmup=more)
    ates = [ate.ate_rmse(ate.positions(traj[b]), ate.positions(gt))
            for b in range(BATCH)]
    # the batched graphs of stress_config() (2048 slots): capture alone
    del single
    stress = graphed.make_graphed_batched_step(stress_config(), BATCH, device)
    stress8 = {"capture_seconds": stress.capture_seconds,
               "graph_pool_mb": stress.pool_bytes / 2**20,
               "nodes": stress.nodes,
               "kernel_nodes_P": stress.kernel_nodes["P"]}
    del stress
    out = {"config": "SvoConfig()", "batch": BATCH, "frames": BATCH_FRAMES,
           "scene": "planes", "traj": "arc", "seeds": list(range(BATCH)),
           "step": "graphed batched, vmapped phases "
                   "(engine/graphed.make_graphed_batched_step)",
           "render_seconds": render_s, "wall_seconds": wall_s,
           "capture_seconds": bstep.capture_seconds,
           "graph_pool_mb": bstep.pool_bytes / 2**20,
           "frames_seconds": frames_s,
           "fps_aggregate": BATCH * BATCH_FRAMES / frames_s,
           "fps_aggregate_incl_capture": BATCH * BATCH_FRAMES / wall_s,
           "steady_batched_frame_ms": steady_ms,
           "steady_batched_frame_ms_all": steady,
           "fps_steady": BATCH * 1e3 / steady_ms,
           "ate_m": ates, "ate_max_m": max(ates),
           "single_ate_m": [ate.ate_rmse(ate.positions(r), ate.positions(gt))
                            for r in ref_traj],
           "pos_err_vs_single_first8_m": pos_err,
           "pos_err_vs_single_all_m": pos_err_all,
           "keyframes_equal_single": kf_equal,
           "tracking_ok": ok.mean(1).tolist(),
           "keyframes": kf.sum(1).tolist(),
           "replays": replays,
           "nodes": bstep.nodes, "single_nodes": single_nodes,
           "kernel_nodes_P": bstep.kernel_nodes["P"],
           "kernel_node_ratio": ratio, "kernel_node_diff": node_diff,
           "host_syncs_per_batched_frame": {
               str(c): syncs.count(c) for c in sorted(set(syncs))},
           "sync_sites": sites, "launches": launches,
           "launches_per_batched_frame": {k: v / BATCH_FRAMES
                                          for k, v in launches.items()},
           "profiled_batched_frame": {k: prof[k] for k in (
               "kernels", "graphs", "copies", "total", "device_ms")},
           "stress_config_batched": stress8,
           "single_seq0_equals_phase3": bool(np.array_equal(
               ref_traj[0], traj3[:BATCH_FRAMES]))}
    require(all(c == 0 for c in syncs),
            f"host syncs per batched frame {syncs} (want 0 on every "
            f"batched frame): {sites}")
    require(replays["B"] == BATCH_FRAMES - 1,
            f"graph B replayed {replays['B']} times, want once a batched "
            f"frame after the bootstrap")
    require(max(ates) <= ATE_GATE_M, f"batched ATE {ates}")
    require(ok.mean(1).min() >= TRACK_GATE, f"batched tracking {ok.mean(1)}")
    require(all(kf_equal), f"keyframes differ from the single runs: "
                           f"{kf.tolist()} vs {[r.tolist() for r in ref_kf]}")
    require(max(pos_err) <= BATCH_POS_TOL_M,
            f"positions over the first {BATCH_POS_FRAMES} frames differ "
            f"from the single runs by {pos_err} m")
    require(all(r <= BATCH_NODE_RATIO for r in ratio.values()),
            f"batched graphs' kernel nodes / the single step's: {ratio}")
    for key, p in (("SvoConfig()", out["kernel_nodes_P"]),
                   ("stress_config()", stress8["kernel_nodes_P"])):
        require(p["halfsample"] == 1 and p["gradients"] == 1,
                f"batched graph P of {key}: {p}, not one B1 and one B2 "
                f"node for the batch")
    require(out["single_seq0_equals_phase3"],
            "the single run of sequence 0 differs from phase 3's frames")
    return out, states, (lefts, rights), {"T_wc": traj, "tracking_ok": ok,
                                          "kf_inserted": kf}


def graph_p_nodes(svo) -> dict:
    """Graph P's nodes by kind and its kernel nodes by launch counter, of
    a StereoSvo's graphed step."""
    return {"nodes": svo._step.nodes["P"],
            "kernel_nodes": svo._step.kernel_nodes["P"]}


def counted(counters) -> dict:
    """Every launch counter, after adding the graphed steps' body runs
    (graphed.settle: a step's frames launch its kernels inside one graph,
    whose bodies count their runs on the device; one read a step)."""
    from stereo_svo_tpu_torch.engine import graphed
    graphed.settle()
    return {k: v for counts in counters for k, v in counts.items()}


def zero_counters(counters) -> None:
    """Every launch counter to 0, the graphed steps' body runs so far
    settled first (they count for nothing)."""
    counted(counters)
    for counts in counters:
        for k in counts:
            counts[k] = 0


def read_counters(counters, what: str, needs=PATH_KERNELS) -> dict:
    """The launch counts since zero_counters; every kernel named in
    ``needs`` (by default every kernel the paths launch) must have
    launched on the path ``what``."""
    launches = counted(counters)
    missing = [k for k, v in launches.items() if v <= 0 and k in needs]
    require(not missing, f"kernels never launched {what}: {missing}")
    return launches


def blackout_run(cfg, lefts, rights, gt, counters):
    """Phase 9: StereoSvo over the frames with the BLACKOUT ones replaced
    by zeros. The rotated relocalisation variants run inside the step's
    A_fail graph: the watched function must be recorded into that graph
    once, and the graph replayed on each frame after a failed one. drive()
    holds every tracked frame, the failed ones included, to one host
    sync."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import loop_closure

    lefts, rights = lefts.clone(), rights.clone()
    for i in BLACKOUT:
        lefts[i] = 0.0
        rights[i] = 0.0
    with watch_calls(loop_closure, "rotated_descriptors", counters) as calls:
        out, frame_ms, metrics, svo = drive(cfg, lefts, rights, gt, counters)
    ok = metrics["tracking_ok"]
    out.update(
        lost_frames=np.nonzero(~ok)[0].tolist(),
        kf_frames=np.nonzero(metrics["kf_inserted"])[0].tolist(),
        tail_err_m=tail_err(svo.trajectory(), gt.cpu().numpy()),
        rotated_variant_calls=svo._step.replays["A_fail"],
        rotated_variants_captured=sum(c["capturing"] for c in calls),
        rotated_variants_eager=sum(not c["capturing"] for c in calls),
        n_alive_end=int((svo.state.status > 0).sum()),
        failed_frame_ms=[frame_ms[i] for i in BLACKOUT],
        recovery_frame_ms=frame_ms[BLACKOUT[-1] + 1])
    return out, frame_ms


def cli_run(counters, device):
    """Phase 10, first half: the command-line app in-process on the card,
    its output files under build/. Host syncs are counted inside every
    new_image call of the frame loop (the rest of main renders, exports
    and reads metrics, which sync by nature)."""
    import io

    import numpy as np
    import torch
    from stereo_svo_tpu_torch import cli
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.eval import ate
    from stereo_svo_tpu_torch.io import synthetic, trajectory

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    traj_path = os.path.join(out_dir, "chip_smoke_cli.tum")
    metrics_path = os.path.join(out_dir, "chip_smoke_cli_metrics.json")
    syncs, sites = [], {}
    new_image = StereoSvo.new_image

    def counted(self, left, right):
        out, n, where = count_syncs(lambda: new_image(self, left, right))
        syncs.append(n)
        for key, v in where.items():
            sites[key] = sites.get(key, 0) + v
        return out

    zero_counters(counters)
    stdout, stderr = io.StringIO(), io.StringIO()
    StereoSvo.new_image = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            cli.main(["--dataset", "synthetic", "--frames", str(CLI_FRAMES),
                      "--loop-closure", "--metrics-out", metrics_path,
                      "--out", traj_path, "--device", "cuda"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        StereoSvo.new_image = new_image
    launches = read_counters(counters, "by the CLI")
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    require(set(summary) == CLI_SUMMARY_KEYS, f"summary keys {set(summary)}")
    with open(metrics_path) as f:
        doc = json.load(f)
    require(doc["summary"] == summary and
            len(doc["tracking_ok"]) == CLI_FRAMES,
            "the metrics file does not hold the summary and one entry per "
            "frame")
    lines = open(traj_path).read().splitlines()
    ts, pos = trajectory.load_tum(traj_path)
    gt = torch.stack([synthetic.trajectory_pose(
        torch.tensor(i * CLI_DT, dtype=torch.float32, device=device), "arc")
        for i in range(CLI_FRAMES)]).cpu().numpy()
    file_ate = ate.ate_rmse(pos, ate.positions(gt))
    out = {"argv": "--dataset synthetic --frames 60 --loop-closure "
                   "--metrics-out ... --out ... --device cuda",
           "summary": summary, "wall_seconds": wall_s,
           "progress_lines": stderr.getvalue().strip().splitlines(),
           "tum_lines": len(lines), "tum_ate_m": file_ate,
           "launches": launches,
           "launches_per_frame": {k: v / CLI_FRAMES
                                  for k, v in launches.items()},
           "host_syncs_per_frame": {str(c): syncs.count(c)
                                    for c in sorted(set(syncs))},
           "sync_sites": sites}
    require(summary["frames"] == CLI_FRAMES and len(syncs) == CLI_FRAMES,
            f"{summary['frames']} frames, {len(syncs)} new_image calls")
    require(all(c == 0 for c in syncs),
            f"CLI host syncs per frame {syncs} (want 0 on every frame): "
            f"{sites}")
    require(summary["ate_rmse_m"] <= ATE_GATE_M,
            f"CLI ATE {summary['ate_rmse_m']} m above {ATE_GATE_M}")
    require(summary["tracking_ok_frac"] >= TRACK_GATE,
            f"CLI tracking_ok {summary['tracking_ok_frac']}")
    require(len(lines) == CLI_FRAMES and pos.shape == (CLI_FRAMES, 3)
            and np.allclose(ts, np.arange(CLI_FRAMES) * 0.1, atol=1e-6),
            "the TUM file does not hold one stamped line per frame")
    # the file keeps 6 decimals of each coordinate
    require(abs(file_ate - summary["ate_rmse_m"]) <= 2e-6,
            f"ATE of the TUM file {file_ate}, of the run "
            f"{summary['ate_rmse_m']}")
    return out


def resume_run(cfg, lefts, rights, traj3, counters):
    """Phase 10, second half: RESUME_AT frames, checkpoint.save, load into
    a fresh StereoSvo on the card, on to RESUME_FRAMES; the continued poses
    against the uninterrupted run's (phase 3's trajectory ``traj3``)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.utils import checkpoint, profiling

    path = os.path.join(ROOT, "build", "chip_smoke_checkpoint.npz")
    zero_counters(counters)
    first = StereoSvo(cfg, device="cuda")
    for i in range(RESUME_AT):
        first.new_image(lefts[i], rights[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, first.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    # the port's own harness on the card (CUDA events: the state is there)
    save_ms_time_fn = profiling.time_fn(checkpoint.save, path, first.state,
                                        iters=3, warmup=1) * 1e3
    resumed = StereoSvo(cfg, device="cuda")
    t0 = time.perf_counter()
    state = checkpoint.load(path, resumed.state)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    keys = checkpoint.key_paths(state)
    require(all(a.device.type == "cuda" and a.dtype == b.dtype
                and a.shape == b.shape
                for a, b in zip((v for _, v in checkpoint.flatten(state)),
                                (v for _, v in
                                 checkpoint.flatten(first.state)))),
            "the loaded state is not on the card with the saved dtypes")
    resumed.resume(state)
    for i in range(RESUME_AT, RESUME_FRAMES):
        resumed.new_image(lefts[i], rights[i])
    got = resumed.trajectory()
    launches = read_counters(counters, "by the checkpointed run")
    equal = bool(np.array_equal(got, traj3[RESUME_AT:RESUME_FRAMES]))
    out = {"frames_before": RESUME_AT, "frames_after":
           RESUME_FRAMES - RESUME_AT, "leaves": len(keys),
           "file_mb": os.path.getsize(path) / 2**20, "save_ms": save_ms,
           "save_ms_time_fn_median_of_3": save_ms_time_fn,
           "load_ms": load_ms, "launches": launches,
           "resumed_equals_phase3": equal,
           "max_abs_diff": float(np.abs(
               got - traj3[RESUME_AT:RESUME_FRAMES]).max())}
    require(equal, "the resumed run's poses differ from the uninterrupted "
                   f"run's (max {out['max_abs_diff']})")
    return out


def index_state(states, b: int):
    """Sequence b of a stacked (leading-B) state."""
    if isinstance(states, tuple):
        return type(states)(*(index_state(f, b) for f in states))
    return states[b]


def global_map_run(cfg, states, counters):
    """Phase 11: two sequences' final states as one global map, loop
    detection over it, then the pose graph and the sharded BA over an nccl
    process group of world size 1 on the card."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import ba, pose_graph
    from stereo_svo_tpu_torch.geometry import se3
    from stereo_svo_tpu_torch.parallel import dist_ba, mapping
    from stereo_svo_tpu_torch.parallel import mesh as mesh_mod

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    zero_counters(counters)
    gmap = mapping.build_global_map(cfg, [index_state(states, b)
                                          for b in MAP_SEQS])
    K, N = cfg.max_keyframes, cfg.max_features
    require(tuple(gmap.kf_T_wk.shape) == (2 * K, 3, 4)
            and tuple(gmap.obs_uv.shape) == (2 * K, 2 * N, 2)
            and not bool(gmap.obs_mask[:K, N:].any())
            and not bool(gmap.obs_mask[K:, :N].any()),
            "the global map is not block-diagonal (20 poses, 384 landmarks)")
    (graph, meas), detect_ms = wall_ms(
        lambda: mapping.detect_loop_edges(cfg, gmap))
    detect_launches = {k: v for c in counters for k, v in c.items()}

    t0 = time.perf_counter()
    mesh_mod.initialize_multihost(device="cuda", world_size=1, rank=0)
    mesh = mesh_mod.make(1, axis_name="kf")
    init_ms = (time.perf_counter() - t0) * 1e3
    try:
        def optimize():
            return mapping.optimize_global_map(mesh, cfg.camera, cfg, gmap,
                                               loop_edges=graph)

        # the first call pays for the nccl communicator (made at the first
        # all-reduce) and the first jacfwd at this size; the second is warm
        (refined, pg_cost), first_ms = wall_ms(optimize)
        with watch_calls(pose_graph, "optimize", counters) as pg_calls, \
                watch_calls(dist_ba, "bundle_adjust_sharded",
                            counters) as ba_calls:
            (again, _), opt_ms = wall_ms(optimize)
            ba_args, ba_kwargs = ba_calls[-1]["args"], ba_calls[-1]["kwargs"]
        repeats = bool(torch.equal(again.kf_T_wk, refined.kf_T_wk)
                       and torch.equal(again.X, refined.X))
        # the map is built from stored thumbnails: no pyramid, so no B1,
        # and from measured edges: no KLT and no pose refinement
        launches = read_counters(counters, "by the global map",
                                 needs=("gradients", "sample_patches",
                                        "align_levels"))
        opt_prof = prof_launches(optimize)
        ba_prof = prof_launches(
            lambda: dist_ba.bundle_adjust_sharded(*ba_args, **ba_kwargs))
        (T_ba, X_ba), ba_ms = wall_ms(
            lambda: dist_ba.bundle_adjust_sharded(*ba_args, **ba_kwargs))
    finally:
        mesh_mod.shutdown()

    # the same iterations in one process, no reduction
    _, cam, _, T_pg, valid, X, X_mask, obs_uv, obs_mask, disp, dmask = ba_args
    fixed = ba_kwargs["fixed_mask"]
    T_kw, X1 = se3.inverse(T_pg), X
    w_rows = ba.obs_weights(valid, X_mask, obs_mask, dmask)
    for _ in range(cfg.ba_iters):
        T_kw, X1, _ = ba.ba_iteration(cam, cfg, T_kw, X1, obs_uv,
                                      obs_uv[..., 0] - disp, w_rows, fixed,
                                      solver="direct")
    T_one = se3.inverse(T_kw)
    ba_diff = max(float((T_ba - T_one).abs().max()),
                  float((X_ba - X1).abs().max()))
    moved = [float(se3.distance(refined.kf_T_wk[k], gmap.kf_T_wk[k])[1])
             for k in torch.nonzero(gmap.kf_valid)[:, 0].tolist()]
    finite = bool(torch.isfinite(refined.kf_T_wk).all()
                  & torch.isfinite(refined.X).all()
                  & torch.isfinite(pg_cost))
    ev = lambda c: c["events"][0].elapsed_time(c["events"][1])  # noqa: E731
    out = {
        "sequences": [0, 1], "poses": 2 * K, "landmarks": 2 * N,
        "valid_keyframes": int(gmap.kf_valid.sum()),
        "live_landmarks": int(gmap.X_mask.sum()),
        "backend": "nccl", "world_size": 1,
        "multi_rank_nccl": "not run: this machine has one GPU; the "
                           "multi-rank check is the gloo CPU dry run of "
                           "tests/test_torch_parallel.py",
        "process_group_init_ms": init_ms,
        "loop_edges_accepted": int(graph.weight.sum()),
        "loop_edges_proposed": int(graph.weight.shape[0]),
        "detect_wall_ms": detect_ms, "detect_kernel_launches":
            detect_launches,
        "optimize_first_call_wall_ms": first_ms,
        "optimize_wall_ms": opt_ms, "optimize_repeats_bit_for_bit": repeats,
        "optimize_launches": opt_prof["kernels"],
        "optimize_device_ms": opt_prof["device_ms"],
        "pose_graph_host_ms": pg_calls[-1]["host_ms"],
        "pose_graph_event_ms": ev(pg_calls[-1]),
        "sharded_ba_host_ms": ba_calls[-1]["host_ms"],
        "sharded_ba_event_ms": ev(ba_calls[-1]),
        "sharded_ba_wall_ms": ba_ms, "sharded_ba_launches": ba_prof["kernels"],
        "sharded_ba_device_ms": ba_prof["device_ms"],
        "pose_graph_cost": float(pg_cost), "finite": finite,
        "max_keyframe_move_m": max(moved),
        "sharded_ba_vs_single_process_max_abs": ba_diff,
        "sharded_ba_bit_equal": bool(torch.equal(T_ba, T_one)
                                     and torch.equal(X_ba, X1)),
        "launches": launches}
    require(finite, "the refined map is not finite")
    require(max(moved) < MAP_MAX_MOVE_M,
            f"a keyframe moved {max(moved)} m (limit {MAP_MAX_MOVE_M})")
    require(ba_diff <= MAP_BA_TOL,
            f"sharded BA at world size 1 differs from the single-process "
            f"iterations by {ba_diff}")
    return out, {"kf_T_wk": refined.kf_T_wk.cpu().numpy(),
                 "X": refined.X.cpu().numpy()}


def _matched(tries) -> bool:
    """The device's records against the counts of the last try: each
    hand-written kernel's records against its counter's gain; for the
    frame graph also every record of the device (kernels, copies,
    memsets) against the nodes of the bodies that ran (their run
    counters' gain), the set nodes and the host's own launches and
    copies."""
    if not tries:
        return False
    p = tries[-1]
    return p["by_kernel"] == p["counted"] and (
        "records_expected" not in p
        or p["device_records"] == p["records_expected"])


def profile_frames(key, make, cfg, lefts, rights, counters, kinds) -> dict:
    """Phase 12's profiled frames of one step (``make``: StereoSvo or
    EagerSvo) over phase 3's frames: for each kind of frame ({kind: frame
    indices}), the first of up to three frames whose device records
    equal the counts (_matched), each after its previous frame in the
    profiler's warm-up step (frame 0: another step's bootstrap). Fails
    when a kind never matches."""
    import torch
    candidates = sorted((t, kind) for kind, ts in kinds.items() for t in ts)
    profiled = {}
    svo, done = make(cfg, device="cuda"), 0
    spare = make(cfg, device="cuda")    # the bootstrap's warm-up
    tries = {kind: [] for kind in kinds}
    for t, kind in candidates:
        if all(_matched(v) or len(v) == 3 for v in tries.values()):
            break
        if (0 < t < done + 1 or _matched(tries[kind])
                or len(tries[kind]) == 3):
            continue
        for i in range(done, t - 1):
            svo.new_image(lefts[i], rights[i])
        torch.cuda.synchronize()

        graph_step = svo._step if key == "graphed" else None
        runs0 = {}
        span = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def frame(t=t, svo=svo):
            zero_counters(counters)
            if graph_step:      # a read (no kernel) before the frame
                runs0.update(graph_step.replays)
            span[0].record()
            svo.new_image(lefts[t], rights[t])
            span[1].record()
        # the frame before, or another step's bootstrap before frame 0
        w, before = (t - 1, svo) if t else (0, spare)
        prof = prof_launches(frame, warmup=lambda w=w, svo=before:
                             svo.new_image(lefts[w], rights[w]))
        done = t + 1
        prof["frame_event_ms"] = span[0].elapsed_time(span[1])
        if graph_step:
            runs1 = graph_step.replays
            prof["body_runs"] = {g: runs1[g] - runs0[g]
                                 for g in graph_step.graphs}
            nodes = graph_step.nodes
            # F's own kernel nodes (the set nodes, the frame's stamps and
            # those around P and flags), each body's nodes, and the two
            # stamps inside each IF node that ran
            ifs = {b for op, b in graph_step._plan if op == "if"}
            prof["records_expected"] = (
                prof["kernels"] + prof["copies"] + nodes["F"]["kernel"]
                + sum(n * (nodes[g]["kernel"] + nodes[g]["memcpy"]
                           + nodes[g]["memset"] + 2 * (g in ifs))
                      for g, n in prof["body_runs"].items()))
        # the bootstrap aligns and refines nothing: no align_levels, no
        # refine_pose
        prof.update(frame=t, counted=read_counters(
            counters, f"on the {key} frame {t}", needs=PATH_KERNELS if t
            else ("halfsample", "gradients", "sample_patches")))
        tries[kind].append(prof)
    for kind, v in tries.items():
        require(_matched(v),
                f"{key} {kind} frames: the device's records of the "
                f"kernels never equalled the counts: "
                f"{[(p['frame'], p['device_records'], p.get('records_expected'), p['by_kernel'], p['counted']) for p in v]}")
        profiled[kind] = dict(v[-1], frames_tried=len(v))
    del spare
    return profiled


def graphed_vs_eager(cfg, lefts, rights, gt, counters, svo3, phase3,
                     loop_step):
    """Phase 12: phase 3's frames through the eager step with phase 3's
    accounting (drive(), one host sync on every frame after the
    bootstrap), against phase 3's graphed run; then the bootstrap frame, a
    tracked frame and a keyframe frame of each under torch.profiler, from
    runs of the frames before them (the bootstrap: after a bootstrap of
    another step of the same kind in the profiler's warm-up step). On
    those frames the device's records of each hand-written kernel must
    equal what the launch counters gained: for the graphed step, whose
    counters add each body's kernel nodes times its runs, this measures
    that a frame runs the kernels its counts claim. ``loop_step``: phase
    7's graphed step, whose K_loop nodes are reported beside phase 3's
    graphs. Returns (the result, the eager run's trajectory and
    metrics)."""
    import numpy as np

    eager, _, _, esvo = drive(cfg, lefts, rights, gt, counters,
                              make_svo=EagerSvo, want=(0, 1))
    g_traj, e_traj = svo3.trajectory(), esvo.trajectory()
    g_m, e_m = svo3.metrics(), esvo.metrics()
    first_diff = None
    for i in range(lefts.shape[0]):
        fields = [("T_wc", g_traj[i], e_traj[i])] + [
            (k, g_m[k][i], e_m[k][i]) for k in g_m]
        diff = [k for k, a, b in fields if not np.array_equal(a, b)]
        if diff:
            first_diff = {"frame": i, "fields": diff}
            break
    # tracked (non-keyframe) and keyframe frames from frame 6 on, each
    # profiled after its previous frame ran in the profiler's warm-up step;
    # the profiler may drop a record, never add one (device_us), so for
    # each kind the first of up to three frames whose records of every
    # kernel equal the counters' gain is kept
    kf = g_m["kf_inserted"]
    kinds = {"bootstrap": [0],
             "tracked": [i for i in range(6, len(kf)) if not kf[i]],
             "keyframe": [i for i in range(6, len(kf)) if kf[i]]}
    require(kinds["keyframe"], "phase 3 has no keyframe frame from frame 6")

    # the graphed frames are profiled in a process of their own: in this
    # one, after the earlier phases' profiles, the profiler was seen to
    # drop records inside the frame graph's bodies (PERF.md §7)
    profiled = {}
    for key, by_kind in (
            ("graphed", child({"task": "profile_frames", "kinds": kinds})),
            ("eager", profile_frames("eager", EagerSvo, cfg, lefts, rights,
                                     counters, kinds))):
        for kind, prof in by_kind.items():
            profiled.setdefault(kind, {})[key] = prof
    step = svo3._step
    keys = ("frame_ms_median", "frame_ms_p90", "track_frame_ms_median",
            "kf_frame_ms_median", "fps", "first_frame_ms", "launches",
            "host_syncs_per_frame")
    graph_nodes = dict(step.nodes, K_loop=loop_step.nodes["K_loop"])
    kernel_nodes = dict(step.kernel_nodes,
                        K_loop=loop_step.kernel_nodes["K_loop"])
    out = {"config": "SvoConfig()", "frames": int(lefts.shape[0]),
           "bit_for_bit": first_diff is None, "first_difference": first_diff,
           "graphed": {k: phase3[k] for k in keys},
           "eager": {k: eager[k] for k in keys},
           "profile": profiled,
           "graph_nodes": graph_nodes, "kernel_nodes": kernel_nodes,
           "K_loop_of": "phase 7's configuration (online_loop_every=1)",
           "replays": dict(step.replays),
           "capture_seconds": step.capture_seconds,
           "graph_pool_mb": step.pool_bytes / 2**20,
           "loop_capture_seconds": loop_step.capture_seconds,
           "loop_graph_pool_mb": loop_step.pool_bytes / 2**20}
    # the profiled frame's device time over its own CUDA-event span in the
    # same trace: a fast-band frame (PERF.md §7) is busy nearly all its
    # span, so another run's unprofiled median can fall below its traced
    # device time
    for kind in ("bootstrap", "tracked", "keyframe"):
        for key in ("graphed", "eager"):
            prof = profiled[kind][key]
            out[f"device_busy_share_{key}_{kind}_frame"] = \
                prof["device_ms"] / prof["frame_event_ms"]
    require(out["bit_for_bit"], f"graphed and eager runs differ first at "
                                f"{first_diff}")
    # a tracked frame's device work is the same on every frame; keyframe
    # frames differ (the window's fill), so their shares are not gated
    shares = {k: v for k, v in out.items()
              if k.startswith("device_busy") and k.endswith("tracked_frame")}
    require(all(0.0 < v <= 1.0 for v in shares.values()),
            f"device busy shares {shares}: not in (0, 1]")
    for kind in ("keyframe", "bootstrap"):
        host = profiled[kind]["graphed"]["total"]
        require(host <= KF_FRAME_MAX_HOST_LAUNCHES,
                f"a graphed {kind} frame made {host} host launches "
                f"(kernels, graph launches, copies), more than "
                f"{KF_FRAME_MAX_HOST_LAUNCHES}: the frame is not one launch "
                f"of the frame graph")
    return out, e_traj, e_m


@contextlib.contextmanager
def shared_steps():
    """While the block runs, StereoSvo and run_sequence_scan (which look
    runner.make_graphed_step up at each call) get one graphed step per
    configuration: made (captured) at its first use, reset to the initial
    state at every later one. Phase 13's scenes of a configuration share
    one capture. Yields the {configuration: step} dict."""
    from stereo_svo_tpu_torch.engine import runner
    make = runner.make_graphed_step
    steps = {}

    def shared(cfg, device):
        if cfg in steps:
            steps[cfg].reset()
        else:
            steps[cfg] = make(cfg, device)
        return steps[cfg]

    runner.make_graphed_step = shared
    try:
        yield steps
    finally:
        runner.make_graphed_step = make


def drift_event(traj, mem_valid, mem_stamp, mem_T_wk, D, at):
    """tests/test_mem_retention.py's drift event, in numpy: D ((3,4),
    applied on the world side) moves the trajectory from frame ``at`` and
    the valid bank slots stamped from ``at`` on. Returns the new
    trajectory and bank poses, and the slots moved."""
    import numpy as np

    def apply(T):
        out = np.array(T)
        out[..., :, :3] = np.einsum("ij,...jk->...ik", D[:, :3], T[..., :, :3])
        out[..., :, 3] = np.einsum("ij,...j->...i", D[:, :3],
                                   T[..., :, 3]) + D[:, 3]
        return out

    traj_p = np.array(traj)
    traj_p[at:] = apply(traj[at:])
    sel = mem_valid & (mem_stamp >= at)
    mem_p = np.array(mem_T_wk)
    mem_p[sel] = apply(mem_p[sel])
    return traj_p, mem_p, sel


def one_per_pyramid(run, what):
    """B1 and B2 launch once a frame (no online loop on these paths)."""
    per = {k: run["launches_per_frame"][k]
           for k in ("halfsample", "gradients")}
    require(all(v == 1.0 for v in per.values()),
            f"{what}: B1/B2 launches per frame {per}, not 1.0")


HARD_KEYS = ("tracking_ok", "ate_m", "keyframes", "kf_frames", "launches",
             "frame_ms_median", "frame_ms_p90", "track_frame_ms_median",
             "kf_frame_ms_median", "first_frame_ms", "host_syncs_per_frame",
             "launches_per_frame", "render_seconds")


def hard_scene_runs(configs, counters, device):
    """Phase 13: each scene of HARD_SCENES rendered on the card
    (synthetic.make_sequence, before its timed run), then driven through
    StereoSvo under each configuration of ``configs`` ({key: cfg}); the
    scenes of a configuration share one graphed step (shared_steps).
    drive() zeroes the counters before each run, holds its host syncs and
    times each frame. Returns {key: {scene: summary}} and the capture
    seconds of each configuration's step."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.io import synthetic

    out, capture = {}, {}
    with shared_steps() as steps:
        for key, cfg in configs.items():
            runs = {}
            for name, kw in HARD_SCENES.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lefts, rights, gt = synthetic.make_sequence(
                    cfg.camera, HARD_FRAMES, HARD_DT, seed=SEED,
                    device=device, **kw)
                torch.cuda.synchronize()
                render_s = time.perf_counter() - t0
                run, _, metrics, _ = drive(cfg, lefts, rights, gt, counters)
                run.update(kf_frames=np.nonzero(
                    metrics["kf_inserted"])[0].tolist(),
                    render_seconds=render_s)
                one_per_pyramid(run, f"phase 13 {key} {name}")
                runs[name] = {k: run[k] for k in HARD_KEYS}
                del lefts, rights
            out[key] = runs
            capture[key] = steps[cfg].capture_seconds
    return out, capture


def check_hard_scenes(runs):
    """Phase 13's gates: the reference test's on every run (the JAX
    reference meets them at both sizes); on the deterministic scenes the
    keyframe frames equal to PHASE13_REF and ATE within LOOP_TOL_M of it."""
    for key, by_scene in runs.items():
        for name, run in by_scene.items():
            what = f"phase 13 {key} {name}"
            gate = HARD_ATE_GATES[name]
            require(run["ate_m"] < gate,
                    f"{what}: ATE {run['ate_m']} m, gate {gate}")
            require(run["tracking_ok"] >= HARD_TRACK_GATE,
                    f"{what}: tracking_ok {run['tracking_ok']}")
            if name == "perturb":
                continue
            ref = PHASE13_REF[key][name]
            require(run["kf_frames"] == ref["kf_frames"],
                    f"{what}: keyframes {run['kf_frames']}, reference "
                    f"{ref['kf_frames']}")
            require(abs(run["ate_m"] - ref["ate_m"]) <= LOOP_TOL_M,
                    f"{what}: ATE {run['ate_m']} m, reference {ref['ate_m']}")


def long_horizon_run(cfg, counters, device):
    """Phase 14: LONG_FRAMES frames of the planes scene on the loop
    trajectory (t = LONG_DT·i) rendered on the card, through
    run_sequence_scan (the graphed step; each frame timed by a CUDA-event
    pair and its host syncs counted); the drift event on the trajectory and
    the bank (drift_event), then refine_trajectory, its wall ms and kernel
    launches apart. Counters zeroed just before the run and read just
    after."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.backend import loop_closure
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.geometry import se3
    from stereo_svo_tpu_torch.io import synthetic

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lefts, rights, gt = synthetic.make_sequence(
        cfg.camera, LONG_FRAMES, LONG_DT, kind="loop", seed=SEED,
        device=device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    gt = gt.cpu().numpy()

    make = runner.make_graphed_step
    events, syncs, sites = [], [], {}

    class Timed:
        """The graphed step, each frame timed and its syncs counted."""

        def __init__(self, step):
            self.step = step

        def __getattr__(self, name):
            return getattr(self.step, name)

        def __call__(self, *args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)

            def frame():
                a.record()
                out = self.step(*args)
                b.record()
                return out
            out, n, where = count_syncs(frame)
            events.append((a, b))
            syncs.append(n)
            for key, v in where.items():
                sites[key] = sites.get(key, 0) + v
            return out

    zero_counters(counters)
    runner.make_graphed_step = lambda c, d: Timed(make(c, d))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = runner.run_sequence_scan(cfg, lefts, rights,
                                               device=device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        runner.make_graphed_step = make
    launches = read_counters(counters, "on the long horizon")
    frame_ms = [a.elapsed_time(b) for a, b in events]
    traj = outs.T_wc.cpu().numpy()
    ok = outs.tracking_ok.cpu().numpy()
    kf = outs.kf_inserted.cpu().numpy()
    mem_valid = state.mem_valid.cpu().numpy()
    mem_stamp = state.mem_stamp.cpu().numpy()
    mem_next = int(state.mem_next)
    require(np.isfinite(traj).all(), "phase 14: trajectory not finite")

    D = se3.exp(torch.tensor(LONG_DRIFT, dtype=torch.float32,
                             device=device)).cpu().numpy()
    traj_p, mem_p, moved = drift_event(traj, mem_valid, mem_stamp,
                                       state.mem_T_wk.cpu().numpy(), D,
                                       LONG_DRIFT_AT)
    state_p = state._replace(mem_T_wk=torch.as_tensor(mem_p, device=device))
    before = counted(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, _, n_edges = loop_closure.refine_trajectory(cfg, state_p, traj_p)
    refine_ms = (time.perf_counter() - t0) * 1e3
    after = counted(counters)
    refine_launches = {k: after[k] - before[k] for k in after}
    tail = LONG_FRAMES - LONG_DRIFT_AT        # the frames the event moved
    track = [frame_ms[i] for i in range(1, LONG_FRAMES) if not kf[i]]
    kf_ms = [frame_ms[i] for i in range(1, LONG_FRAMES) if kf[i]]
    out = {
        "config": "SvoConfig(376x240 test rig, grid 8x10, 80 slots, "
                  "3 levels, max_keyframes=3, mem_keyframes=8, "
                  "kf_dist_ratio=0.04, loop_min_gap=30, "
                  "loop_min_score=0.75)",
        "frames": LONG_FRAMES, "dt": LONG_DT, "scene": "planes",
        "traj": "loop", "drift": LONG_DRIFT, "drift_at": LONG_DRIFT_AT,
        "render_seconds": render_s, "run_wall_seconds": wall_s,
        "tracking_ok": float(ok.mean()), "keyframes": int(kf.sum()),
        "mem_next": mem_next, "wraps": mem_next / cfg.mem_keyframes,
        "mem_stamp": mem_stamp.tolist(), "slots_moved": int(moved.sum()),
        "organic_m": float(np.linalg.norm(traj[:, :, 3] - gt[:, :, 3],
                                          axis=1).max()),
        "offline_edges": int(n_edges),
        "tail_before_m": tail_err(traj_p, gt, tail),
        "tail_after_m": tail_err(refined, gt, tail),
        "refined_finite": bool(np.isfinite(refined).all()),
        "refine_wall_ms": refine_ms, "refine_launches": refine_launches,
        "frame_ms_median": statistics.median(frame_ms[1:]),
        "frame_ms_p90": statistics.quantiles(frame_ms[1:], n=10)[8],
        "track_frame_ms_median": statistics.median(track),
        "track_frame_ms_p90": statistics.quantiles(track, n=10)[8],
        "kf_frame_ms_median": statistics.median(kf_ms),
        "kf_frame_ms_p90": statistics.quantiles(kf_ms, n=10)[8],
        "first_frame_ms": frame_ms[0],
        "launches": launches,
        "launches_per_frame": {k: v / LONG_FRAMES
                               for k, v in launches.items()},
        "host_syncs_per_frame": {str(c): syncs.count(c)
                                 for c in sorted(set(syncs))},
        "sync_sites": sites}
    require(all(c == 0 for c in syncs),
            f"phase 14: host syncs per frame {out['host_syncs_per_frame']} "
            f"(want 0 on every frame): {sites}")
    one_per_pyramid(out, "phase 14")
    missing = [k for k in ("gradients", "sample_patches", "align_levels")
               if refine_launches[k] <= 0]
    require(not missing, f"refine_trajectory launched no {missing}")
    return out


def check_long_horizon(run):
    """Phase 14's gates: the reference test's own, and parity with
    PHASE14_REF."""
    g = LONG_GATES
    require(run["tracking_ok"] > g["tracking_ok"],
            f"phase 14: tracking_ok {run['tracking_ok']}")
    require(run["wraps"] >= g["min_wraps"],
            f"phase 14: the bank wrapped {run['wraps']} times")
    require(run["organic_m"] < g["organic_m"],
            f"phase 14: organic drift {run['organic_m']} m")
    require(run["offline_edges"] >= 1, "phase 14: no loop edge accepted")
    require(run["tail_after_m"] < g["tail_ratio"] * run["tail_before_m"],
            f"phase 14: tail {run['tail_before_m']} -> "
            f"{run['tail_after_m']} m")
    require(run["refined_finite"], "phase 14: refined poses not finite")
    for key in ("wraps", "offline_edges", "keyframes"):
        require(run[key] == PHASE14_REF[key],
                f"phase 14: {key} {run[key]}, reference {PHASE14_REF[key]}")
    for key in ("tail_before_m", "tail_after_m"):
        require(abs(run[key] - PHASE14_REF[key]) <= LOOP_TOL_M,
                f"phase 14: {key} {run[key]}, reference "
                f"{PHASE14_REF[key]}")


def trace_busy(trace_path: str, frames: int) -> dict:
    """The device's records in a torch.profiler Chrome trace (kernels,
    copies, memsets): the time some record ran (busy, their union) and
    the span from the first to the last, in ms per frame over ``frames``
    frames."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    busy, start, end = 0.0, None, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in
                       ("kernel", "gpu_memcpy", "gpu_memset")):
        if start is None:
            start = a
        if end is None or a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = b if end is None else max(end, b)
    span = end - start if start is not None else 0.0
    return {"busy_per_frame_ms": busy / 1e3 / frames,
            "span_per_frame_ms": span / 1e3 / frames}


def profile_window(run_frames, warmup, frames: int, path: str) -> dict:
    """``run_frames()`` (``frames`` frames, no sync between them) under
    torch.profiler, ``warmup()`` in its warm-up step; the trace written to
    ``path`` and read by trace_busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as p:
        warmup()
        torch.cuda.synchronize()
        p.step()
        run_frames()
        torch.cuda.synchronize()
        p.step()
    return trace_busy(path, frames)


def graph_windows(run_frames, frames: int) -> dict:
    """``run_frames()`` (``frames`` frames, no sync between them) with each
    graph launch — a torch graph's replay, a frame graph's launch — between
    a CUDA-event pair, and the run between another: the run's span and the
    launches' windows on the device's clock, per frame."""
    import torch
    from stereo_svo_tpu_torch.engine import graphed
    pairs = []

    def timed(orig):
        def launch(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kwargs)
            b.record()
            pairs.append((a, b))
            return out
        return launch

    targets = [(torch.cuda.CUDAGraph, "replay")]
    if hasattr(graphed, "_FrameGraph"):       # trees before it: none
        targets.append((graphed._FrameGraph, "launch"))
    origs = [getattr(c, name) for c, name in targets]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for (c, name), orig in zip(targets, origs):
        setattr(c, name, timed(orig))
    try:
        a.record()
        run_frames()
        b.record()
        torch.cuda.synchronize()
    finally:
        for (c, name), orig in zip(targets, origs):
            setattr(c, name, orig)
    span = a.elapsed_time(b)
    window = sum(x.elapsed_time(y) for x, y in pairs)
    return {"frames": frames, "graph_launches_per_frame": len(pairs) / frames,
            "frame_ms": span / frames, "window_ms": window / frames}


def steady_split(drive_to, warmup, run_frames, frames: int,
                 trace_path: str) -> dict:
    """The idle split of ``frames`` steady frames: ``drive_to()`` brings
    the step to the frame before them (``warmup()``), ``run_frames()`` runs
    them with no sync. Twice: unprofiled, each graph launch timed by CUDA
    events (graph_windows: the frame's span and its graph windows), then
    under torch.profiler (profile_window: the device's busy time — the
    kernels' own durations; tracing stretches the idle time around the
    bodies a conditional node launches). Per frame: frame ms, busy ms and
    share, idle inside graph windows (windows less busy) and between them
    (span less windows), and the traced run's span."""
    import torch
    drive_to()
    warmup()
    torch.cuda.synchronize()
    timed = graph_windows(run_frames, frames)
    drive_to()
    traced = profile_window(run_frames, warmup, frames, trace_path)
    busy = traced["busy_per_frame_ms"]
    return dict(timed, busy_ms=busy,
                busy_share=busy / timed["frame_ms"],
                idle_inside_windows_ms=timed["window_ms"] - busy,
                idle_between_windows_ms=timed["frame_ms"]
                - timed["window_ms"],
                traced_frame_ms=traced["span_per_frame_ms"])


@contextlib.contextmanager
def frames_without_sync(runner, maker: str, events: list, made: dict):
    """While the block runs, ``runner.<maker>`` (looked up by the runner
    at each call) makes the step it made wrapped: CUDA sync debug mode
    "error" from its first frame on (a host sync raises), each frame
    between a CUDA-event pair. The step is ``made["step"]``, the host
    clock at its first frame ``made["t0"]``."""
    import torch
    make = getattr(runner, maker)

    class NoSync:
        def __init__(self, step):
            self.step = made["step"] = step

        def __getattr__(self, name):
            return getattr(self.step, name)

        def __call__(self, *args):
            if not events:
                torch.cuda.synchronize()
                made["t0"] = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.step(*args)
            b.record()
            events.append((a, b))
            return out

    setattr(runner, maker, lambda *a: NoSync(make(*a)))
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        setattr(runner, maker, make)


def runs_against_flags(runs: dict, ok, kf) -> dict:
    """Each body's run counter against what the FrameOut flags (T,) — or
    (B,T), the batch's conds over its sequences — imply; a mismatch
    fails."""
    import numpy as np
    ok, kf = np.atleast_2d(ok), np.atleast_2d(kf)
    T = ok.shape[1]
    want = {"flags": T, "boot": 1, "B": T - 1,
            "A_fail": int((~ok[:, :T - 1]).any(0).sum()),
            "K+K_loop": int(kf[:, 1:].any(0).sum())}
    got = {"flags": runs["flags"], "boot": runs["boot"], "B": runs["B"],
           "A_fail": runs["A_fail"],
           "K+K_loop": runs["K"] + runs["K_loop"]}
    require(got == want and runs["A_ok"] + runs["A_fail"] == T - 1,
            f"body runs {runs} against the flags: {got}, want {want}")
    return got


def scan_run(cfg, lefts, rights, counters, device, eager_traj,
             eager_metrics):
    """Phase 15, single: phase 3's frames through run_sequence_scan with
    CUDA sync debug mode "error" from the first frame to the last (one
    launch of the frame graph a frame; the images and the FrameOut copied
    on the device), counters zeroed just before and read just after; the
    poses and flags against phase 12's eager run bit for bit, each body's
    run counter against the flags, frame ms from CUDA events, fps over the
    run; then, in a process of its own, a fresh step's
    SCAN_PROFILE_FRAMES steady frames timed and under torch.profiler
    (steady_window)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine import runner

    events, made = [], {}
    zero_counters(counters)
    with frames_without_sync(runner, "make_graphed_step", events, made):
        state, outs = runner.run_sequence_scan(cfg, lefts, rights,
                                               device=device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - made["t0"]
    launches = read_counters(counters, "by run_sequence_scan")
    step = made["step"]
    T = lefts.shape[0]
    frame_ms = [a.elapsed_time(b) for a, b in events]
    traj = outs.T_wc.cpu().numpy()
    ok = outs.tracking_ok.cpu().numpy()
    kf = outs.kf_inserted.cpu().numpy()
    runs = step.replays
    require(np.array_equal(traj, eager_traj)
            and np.array_equal(ok, eager_metrics["tracking_ok"])
            and np.array_equal(kf, eager_metrics["kf_inserted"]),
            "phase 15: run_sequence_scan's poses or flags differ from the "
            "eager step's")
    against = runs_against_flags(runs, ok, kf)
    split = child({"task": "steady", "batch": 0})
    steady = frame_ms[1:]
    return {"config": "SvoConfig()", "frames": T,
            "path": "engine/runner.run_sequence_scan",
            "host_syncs": 0, "bit_for_bit_eager": True,
            "body_runs": runs, "body_runs_against_flags": against,
            "first_frame_ms": frame_ms[0],
            "frame_ms_median": statistics.median(steady),
            "frame_ms_p90": statistics.quantiles(steady, n=10)[8],
            "track_frame_ms_median": statistics.median(
                frame_ms[i] for i in range(1, T) if not kf[i]),
            "kf_frame_ms_median": statistics.median(
                [frame_ms[i] for i in range(1, T) if kf[i]] or [0.0]),
            "fps_events": 1000.0 * len(steady) / sum(steady),
            "fps_wall": T / wall_s, "wall_seconds": wall_s,
            "capture_seconds": step.capture_seconds,
            "launches": launches,
            "launches_per_frame": {k: v / T for k, v in launches.items()},
            "steady_window": split,
            "frame_ms_all": frame_ms}


def batched_scan_run(cfg, lefts, rights, counters, device):
    """Phase 15, batched: phase 8's (B,T) frames through
    run_sequence_batched with CUDA sync debug mode "error" from the first
    batched frame to the last; the poses and flags against the eager
    batched step (engine/step.make_batched_step) over the same frames bit
    for bit, the body runs against the flags (the batch's conds), batched
    frame ms from CUDA events, aggregate frames/s; then, in a process of
    its own, SCAN_PROFILE_FRAMES steady batched frames (steady_window)."""
    import numpy as np
    import torch
    from stereo_svo_tpu_torch.engine import runner
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.engine.state import init_states

    B, T = lefts.shape[:2]
    events, made = [], {}
    zero_counters(counters)
    with frames_without_sync(runner, "make_graphed_batched_step", events,
                             made):
        _, outs = runner.run_sequence_batched(cfg, lefts, rights,
                                              device=device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - made["t0"]
    launches = read_counters(counters, "by run_sequence_batched")
    bstep = made["step"]
    frame_ms = [a.elapsed_time(b) for a, b in events]
    traj = outs.T_wc.cpu().numpy()
    ok = outs.tracking_ok.cpu().numpy()
    kf = outs.kf_inserted.cpu().numpy()
    runs = bstep.replays
    eager = step_mod.make_batched_step(cfg)
    sts, e_traj, e_ok, e_kf = init_states(cfg, B, device), [], [], []
    for t in range(T):
        sts, o, _ = eager(sts, lefts[:, t], rights[:, t])
        e_traj.append(o.T_wc)
        e_ok.append(o.tracking_ok)
        e_kf.append(o.kf_inserted)
    equal = (np.array_equal(traj, torch.stack(e_traj, 1).cpu().numpy())
             and np.array_equal(ok, torch.stack(e_ok, 1).cpu().numpy())
             and np.array_equal(kf, torch.stack(e_kf, 1).cpu().numpy()))
    require(equal, "phase 15: run_sequence_batched's poses or flags differ "
                   "from the eager batched step's")
    against = runs_against_flags(runs, ok, kf)
    split = child({"task": "steady", "batch": B})
    steady = frame_ms[1:]
    return {"config": "SvoConfig()", "batch": B, "frames": T,
            "path": "engine/runner.run_sequence_batched",
            "host_syncs": 0, "bit_for_bit_eager_batched": True,
            "body_runs": runs, "body_runs_against_flags": against,
            "first_frame_ms": frame_ms[0],
            "frame_ms_median": statistics.median(steady),
            "frame_ms_p90": statistics.quantiles(steady, n=10)[8],
            "fps_aggregate_events": 1000.0 * B * len(steady) / sum(steady),
            "fps_aggregate_wall": B * T / wall_s, "wall_seconds": wall_s,
            "capture_seconds": bstep.capture_seconds,
            "launches": launches,
            "launches_per_batched_frame": {k: v / T
                                           for k, v in launches.items()},
            "steady_window": split,
            "frame_ms_all": frame_ms}


def bench_child(script: str, knobs: dict):
    """``python3 <script>`` from the repository root in a process of its
    own, with the env's BENCH_* knobs replaced by ``knobs``: (its JSON
    output, the seconds it took). Fails unless it exits 0."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"phase 16: {script} {knobs} exited {proc.returncode}: "
            f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    text = proc.stdout.strip()
    return json.loads(text if script != "bench_torch.py"
                      else text.splitlines()[-1]), seconds


def check_bench_line(tag: str, p: dict, phase3_ate: float) -> None:
    """Phase 16's gates on one bench_torch.py line."""
    import math
    what = f"phase 16 {tag}"
    require(p["accuracy_gate"] == "pass", f"{what}: {p['accuracy_gate']}")
    require(math.isfinite(p["value"]) and p["value"] > 0,
            f"{what}: frames/s {p['value']}")
    # a host read inside a timed run raises under sync debug mode
    # "error", a run that is not its warm-up run bit for bit raises; one
    # capture
    require(p["sync_debug_mode"] == "error"
            and p["n_timing_runs"] == BENCH_VALID_RUNS and p["captures"] == 1,
            f"{what}: sync debug mode {p['sync_debug_mode']}, "
            f"{p['n_timing_runs']} timed runs, {p['captures']} captures")
    # the counters zeroed just before the timed runs, read just after
    runs = {"": p["launches"]}
    if tag == "default":
        runs.update(batched8_=p["batched8_launches"],
                    latency_=p["latency_launches"])
    for key, counts in runs.items():
        missing = [k for k, v in counts.items()
                   if v <= 0 and k in PATH_KERNELS]
        require(not missing, f"{what}: kernels never launched in the "
                             f"{key}timed runs: {missing}")
    if tag.startswith("default"):
        # phase 3's frames on a step of the same configuration
        require(p["ate_rmse_m"] == round(phase3_ate, 4),
                f"{what}: ATE {p['ate_rmse_m']}, phase 3's {phase3_ate}")
    if tag == "default":
        require(math.isfinite(p["batched8_frames_per_s"])
                and p["batched8_frames_per_s"] > 0
                and p["batched8_captures"] == 1
                and p["latency_captures"] == 1,
                f"{what}: batched8 frames/s {p['batched8_frames_per_s']}, "
                f"captures {p['batched8_captures']} (batched) "
                f"{p['latency_captures']} (latency)")


def check_stage_table(t: dict) -> None:
    """Phase 16's gates on bench_kernels_torch.py's table."""
    import math
    for name in STAGE_ROWS:
        row = t.get(name)
        require(row is not None and all(
            math.isfinite(row[k]) and row[k] > 0
            for k in ("eager_ms", "graphed_ms")),
            f"phase 16 stages: row {name} {row}")
        for key in STAGE_B_NODES.get(name, ()):
            require(row["b_kernels"][key] > 0,
                    f"phase 16 stages: {name} holds no {key} node "
                    f"({row['b_kernels']})")
    pyr = t["pyramid_ms"]["b_kernels"]
    require(pyr["halfsample"] == 1 and pyr["gradients"] == 1
            and pyr["sample_patches"] == pyr["gn_accumulate"]
            == pyr["align_levels"] == 0,
            f"phase 16 stages: the pyramid's kernel nodes {pyr}, not one "
            f"B1 and one B2")
    acc = t["accounting"]
    require(acc["rows"] == "graphed_ms" and all(
        math.isfinite(acc[k]) for k in STAGE_ACCOUNTING),
        f"phase 16 stages: accounting {acc}")


def bench_entry_points(phase3_ate: float) -> dict:
    """Phase 16: bench_torch.py's paths and bench_kernels_torch.py, each in
    a process of its own (BENCH_RUNS), each child's JSON an earlier line;
    returns a summary."""
    out = {"seconds": {}}
    for tag, script, knobs in BENCH_RUNS:
        p, out["seconds"][tag] = bench_child(script, knobs)
        emit(f"phase16_{tag}", p)
        if script == "bench_torch.py":
            check_bench_line(tag, p, phase3_ate)
            out[tag] = {k: p.get(k) for k in (
                "value", "timing_spread_pct", "fps_runs",
                "bootstrap_frame_ms", "capture_s", "pool_mb", "ate_rmse_m",
                "batched8_frames_per_s", "batched8_pool_mb",
                "latency_p50_ms", "latency_device_p50_ms", "device")}
        else:
            check_stage_table(p)
            out[tag] = {"accounting": p["accounting"], "graphed_ms": {
                name: p[name]["graphed_ms"] for name in STAGE_ROWS}}
    out["default_fps_by_process"] = [out[t]["value"] for t in
                                     ("default", "default_2", "default_3")]
    return out


def kernel_calls(fn):
    """fn() with every call of the kernels' custom ops (``svo::pyramid``,
    ``svo::gradients``, ``svo::sample_patches``, ``svo::gn_accumulate``,
    ``svo::align_levels``, ``svo::refine_pose``, ``svo::klt_track``)
    recorded below vmap, where each op gets its
    problem axis: (fn's result, [(op, arguments, result)], each tensor a
    copy)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    def copy(x):
        if isinstance(x, (list, tuple)):
            return type(x)(copy(y) for y in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "svo":
                calls.append((func.name(), [copy(a) for a in args],
                              copy(out)))
            return out

    with Record():
        result = fn()
    return result, calls


def check_kernel_calls(calls) -> dict:
    """Each recorded kernel call's result against its plain version on the
    same arguments, at phase 2's tolerances: B1, B2 and B3 bit for bit;
    B4's H, g and cost within 1e-4 of the largest entry, its counts
    equal; align_levels within ALIGN_TOL_REL of the largest entry;
    klt_track's positions and residuals within KLT_TOL_PX and KLT_TOL_RES,
    its convergence flags and count equal. Returns,
    per kernel, its calls, their argument shapes and the largest errors;
    requires every kernel the path runs on the calls' device among them."""
    import torch
    from stereo_svo_tpu_torch.ops.kernels import align_kernel as ak
    from stereo_svo_tpu_torch.ops.kernels import klt_kernel as kk
    from stereo_svo_tpu_torch.ops.kernels import pyramid_kernel as pk
    from stereo_svo_tpu_torch.ops.kernels import refine_kernel as rk

    rows = {}

    def note(name, shape, out, ref, tol_rel=0.0, tol_abs=0.0):
        err_abs, err_rel = _max_err(out, ref)
        row = rows.setdefault(name, {"calls": 0, "shapes": [],
                                     "max_abs_err": 0.0, "max_rel_err": 0.0,
                                     "tol_abs": tol_abs, "tol_rel": tol_rel})
        row["calls"] += 1
        if shape not in row["shapes"]:
            row["shapes"].append(shape)
        row["max_abs_err"] = max(row["max_abs_err"], err_abs)
        row["max_rel_err"] = max(row["max_rel_err"], err_rel)
        require(err_abs <= tol_abs or err_rel <= tol_rel,
                f"{name} {shape}: kernel disagrees with its plain version "
                f"(abs {err_abs}, rel {err_rel})")

    def shape_of(a):
        if isinstance(a, (list, tuple)):
            return [shape_of(x) for x in a]
        return list(a.shape) if isinstance(a, torch.Tensor) else a

    for op, args, out in calls:
        shape = [shape_of(a) for a in args]
        if op == "svo::pyramid":
            img, levels = args
            h, w = img.shape[-2:]
            got = pk.level_views(out, h, w, levels)
            ref = pk.level_views(pk._pyramid_flat_plain(img, levels), h, w,
                                 levels)
            note("halfsample", shape, [b[..., 0, :, :] for b in got],
                 [b[..., 0, :, :] for b in ref])
            note("gradients", shape, [b[..., 1:, :, :] for b in got],
                 [b[..., 1:, :, :] for b in ref])
        elif op == "svo::gradients":
            note("gradients", shape, out,
                 torch.stack(pk.gradients_plain(args[0]), -3))
        elif op == "svo::sample_patches":
            note("sample_patches", shape, out,
                 ak.sample_patches_batched_plain(*args))
        elif op == "svo::gn_accumulate":
            ref = ak.gn_accumulate_batched_plain(*args)
            require(torch.equal(out[..., 43:], ref[..., 43:]),
                    f"gn_accumulate {shape}: counts differ from the plain "
                    f"version")
            note("gn_accumulate", shape, out[..., :43], ref[..., :43],
                 tol_rel=1e-4)
        elif op == "svo::align_levels":
            # the pose, cost and inlier share after every pass: float32
            # sums in another order than the chain's, judged relative
            note("align_levels", shape, out, ak.align_levels_plain(*args),
                 tol_rel=ALIGN_TOL_REL)
        elif op == "svo::refine_pose":
            # the pose and RMS error: float32 sums in another order than
            # the chain's, judged relative; the inliers and their count
            # exact
            ref = rk.refine_pose_plain(*args)
            require(torch.equal(out[1], ref[1]) and torch.equal(out[2],
                                                                ref[2]),
                    f"refine_pose {shape}: inliers differ from the plain "
                    f"version")
            note("refine_pose", shape, out[0], ref[0], tol_rel=ALIGN_TOL_REL)
        elif op == "svo::klt_track":
            # positions and residuals: float32 sums in another order than
            # the chain's (klt_errors); the flags and the count exact
            ref = kk.klt_track_plain(*args)
            klt_errors(out, ref, str(shape))
            fin = torch.isfinite(ref[0])
            note("klt_track", shape, out[0][fin], ref[0][fin],
                 tol_abs=KLT_TOL_PX)
    # on the CPU the alignment is the chain (B3 and B4), the KLT the chain
    # of B3 calls and the refinement its chain of ops; on the card one
    # align_levels, one klt_track and one refine_pose launch
    cpu = any(a.device.type == "cpu" for _, args, _ in calls for a in args
              if isinstance(a, torch.Tensor))
    missing = [k for k in KERNELS if k not in rows
               and k not in (("align_levels", "refine_pose", "klt_track")
                             if cpu else ("gn_accumulate",))]
    require(not missing, f"no recorded call of {missing}")
    return rows


def touch_rank(rank: int, n: int, path: str) -> None:
    """A rank that leaves a file behind: phase 17 (d) holds that a call
    which must raise started none."""
    with open(path, "w") as f:
        f.write(f"rank {rank} of {n}\n")


def sharded_rank(rank: int, n: int, cfg, n_seqs: int, frames: int,
                 dt: float, t_spawn: float) -> dict:
    """Phase 17 (b) and (c) in rank ``rank`` of ``n`` (a module-level
    function, so that parallel/mesh.spawn_local's children can import it),
    on the rank's device (mesh.rank_device: its card under nccl).

    (b) sequences ``rank::n`` of the n_seqs ``planes`` arcs (seeds 0 to
    n_seqs-1, ``frames`` frames at ``dt``), rendered on that device, through
    runner.run_sequence_batched's graphed batched step. (c) the final
    states of MAP_SEQS, each broadcast from the rank that ran it, into one
    global map, detect_loop_edges over it, and optimize_global_map over the
    kf group of all n ranks, twice (the first call pays for the group's
    communicator). Returns on the host: poses and flags, the map and its
    loop graph, the refined map, timings, and the launch counts of each
    part (0 on the CPU, where the kernels' plain versions run)."""
    import torch
    import torch.distributed as dist
    from stereo_svo_tpu_torch.engine import graphed, runner
    from stereo_svo_tpu_torch.io import synthetic
    from stereo_svo_tpu_torch.parallel import mapping
    from stereo_svo_tpu_torch.parallel import mesh as mesh_mod

    ready_s = time.time() - t_spawn
    device = mesh_mod.rank_device()
    counters = launch_counters()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def host(tree) -> dict:
        return {k: v.cpu().numpy() for k, v in tree._asdict().items()}

    # ---- (b): this rank's sequences through the graphed batched step ----
    mine = list(range(rank, n_seqs, n))
    seqs = [synthetic.make_sequence(cfg.camera, frames, dt, kind="arc",
                                    seed=b, device=device) for b in mine]
    lefts = torch.stack([q[0] for q in seqs])
    rights = torch.stack([q[1] for q in seqs])
    del seqs
    zero_counters(counters)
    # run_sequence_batched's two parts, so that the frames are timed apart
    # from the capture
    step = runner.make_graphed_batched_step(cfg, len(mine), device)
    t0 = time.perf_counter()
    states, outs = runner.run_frames_batched(step, lefts, rights)
    sync()
    frames_s = time.perf_counter() - t0
    launches_batched = counted(counters)

    # ---- (c): the global map of MAP_SEQS over the kf group ----
    zero_counters(counters)
    leaves = graphed._leaves(states)
    picked = []
    for s in MAP_SEQS:
        owner, b = s % n, s // n
        got = [x[b].clone() if owner == rank else torch.empty_like(x[0])
               for x in leaves]
        for t in got:
            dist.broadcast(t, src=owner)
        picked.append(graphed._tree(states, iter(got)))
    gmap = mapping.build_global_map(cfg, picked)
    graph, _ = mapping.detect_loop_edges(cfg, gmap)
    mesh = mesh_mod.make(n, axis_name="kf")

    def optimize():
        sync()
        t0 = time.perf_counter()
        out = mapping.optimize_global_map(mesh, cfg.camera, cfg, gmap,
                                          loop_edges=graph)
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    (refined, pg_cost), first_ms = optimize()
    (again, _), opt_ms = optimize()
    return {
        "rank": rank, "backend": dist.get_backend(), "device": str(device),
        "sequences": mine, "spawn_to_ready_s": ready_s,
        "capture_s": step.capture_seconds, "frames_s": frames_s,
        "batched_frames_per_s": frames / frames_s,
        "frames_per_s": len(mine) * frames / frames_s,
        "T_wc": outs.T_wc.cpu().numpy(),
        "tracking_ok": outs.tracking_ok.cpu().numpy(),
        "kf_inserted": outs.kf_inserted.cpu().numpy(),
        "launches_batched": launches_batched,
        "map": host(gmap), "loop_edges": host(graph),
        "kf_T_wk": refined.kf_T_wk.cpu().numpy(),
        "X": refined.X.cpu().numpy(), "pg_cost": float(pg_cost),
        "repeats": bool(torch.equal(again.kf_T_wk, refined.kf_T_wk)
                        and torch.equal(again.X, refined.X)),
        "optimize_first_call_wall_ms": first_ms,
        "optimize_wall_ms": opt_ms,
        "launches_map": counted(counters)}


def by_sequence(ranks, key: str, n_seqs: int):
    """The ranks' per-sequence rows of ``key`` in sequence order (rank r ran
    sequences r::n)."""
    import numpy as np
    out = [None] * n_seqs
    for r in ranks:
        for i, s in enumerate(r["sequences"]):
            out[s] = r[key][i]
    return np.stack(out)


def multi_rank_run(cfg, ref8: dict, ref11: dict, smi: str) -> dict:
    """Phase 17: the multi-rank paths with one rank a GPU over nccl, n the
    card count. (a) entry.dryrun_multichip(n), and its steps' kernel calls
    against their plain versions; (b) and (c) sharded_rank
    over n spawned ranks: phase 8's sequences split r::n through
    run_sequence_batched, then phase 11's global map over the kf group;
    (d) spawn_local with n + 1 ranks raises and starts no process.
    ``ref8``: phase 8's poses and flags on the host; ``ref11``: phase 11's
    refined map on the host."""
    import multiprocessing

    import numpy as np
    import torch
    from stereo_svo_tpu_torch import entry
    from stereo_svo_tpu_torch.parallel import mesh as mesh_mod

    n = torch.cuda.device_count()
    out = {"ranks": n, "device": smi}

    # (a) the dry run, then its rank 0's steps again in this process on the
    # same card, each kernel call held against its plain version at the
    # dry run's own shapes (the tiny configuration's pyramid, N and P)
    t0 = time.perf_counter()
    reports = entry.dryrun_multichip(n, timeout_s=MULTI_TIMEOUT_S)
    dryrun_s = time.perf_counter() - t0
    tiny, card = entry._tiny_cfg(), torch.device("cuda", 0)
    outs, calls = kernel_calls(lambda: entry._dryrun_steps(
        tiny, *entry._dryrun_frames(tiny, n, 0, card), card))
    pose_equal = bool(np.array_equal(outs.T_wc.cpu().numpy(),
                                     reports[0].pop("T_wc")))
    for rep in reports[1:]:
        rep.pop("T_wc")
    out["dryrun"] = {"wall_s": dryrun_s, "ranks": reports,
                     "rank0_pose_equals_replay": pose_equal,
                     "kernels_at_its_shapes": check_kernel_calls(calls)}
    del calls
    require(pose_equal, "phase 17 dry run: rank 0's tracked pose differs "
                        "from the same steps in this process")
    for r, rep in enumerate(reports):
        require(rep["backend"] == "nccl" and rep["device"] == f"cuda:{r}",
                f"phase 17 dry run: rank {r} ran on {rep['backend']}, "
                f"{rep['device']}")
        missing = [k for k, v in rep["launches"].items()
                   if v < 1 and k in PATH_KERNELS]
        require(not missing, f"phase 17 dry run: rank {r} never launched "
                             f"{missing}")

    # (b) and (c): phase 8's sequences split over the ranks, phase 11's map
    t_spawn = time.time()
    ranks = mesh_mod.spawn_local(
        sharded_rank, n, (cfg, BATCH, BATCH_FRAMES, DT, t_spawn),
        timeout_s=MULTI_TIMEOUT_S)
    wall_s = time.time() - t_spawn
    for r in ranks:
        require(r["backend"] == "nccl" and r["device"] == f"cuda:{r['rank']}",
                f"phase 17: rank {r['rank']} ran on {r['backend']}, "
                f"{r['device']}")
        read = {"batched": r["launches_batched"], "map": r["launches_map"]}
        # the map is built from stored thumbnails: no pyramid, so no B1,
        # and from measured edges: no KLT and no pose refinement
        missing = [k for k, v in read["batched"].items()
                   if v < 1 and k in PATH_KERNELS] + [
            k for k, v in read["map"].items()
            if v < 1 and k in PATH_KERNELS
            and k not in ("halfsample", "refine_pose", "klt_track")]
        require(not missing, f"phase 17: rank {r['rank']} never launched "
                             f"{missing}")
    traj = by_sequence(ranks, "T_wc", BATCH)
    ok = by_sequence(ranks, "tracking_ok", BATCH)
    kf = by_sequence(ranks, "kf_inserted", BATCH)
    pos_err = np.linalg.norm(traj[..., 3] - ref8["T_wc"][..., 3], axis=-1)
    flags_equal = bool(np.array_equal(ok, ref8["tracking_ok"])
                       and np.array_equal(kf, ref8["kf_inserted"]))
    map0 = ranks[0]
    maps_agree = all(np.array_equal(r["kf_T_wk"], map0["kf_T_wk"])
                     and np.array_equal(r["X"], map0["X"]) for r in ranks)
    map_diff = max(float(np.abs(map0["kf_T_wk"] - ref11["kf_T_wk"]).max()),
                   float(np.abs(map0["X"] - ref11["X"]).max()))
    out.update({
        "sharded_wall_s": wall_s, "sequences_by_rank": [
            r["sequences"] for r in ranks],
        "spawn_to_ready_s": [r["spawn_to_ready_s"] for r in ranks],
        "capture_s": [r["capture_s"] for r in ranks],
        "batched_frames_per_s": [r["batched_frames_per_s"] for r in ranks],
        "frames_per_s": [r["frames_per_s"] for r in ranks],
        "optimize_first_call_wall_ms": map0["optimize_first_call_wall_ms"],
        "optimize_wall_ms": map0["optimize_wall_ms"],
        "optimize_repeats_bit_for_bit": map0["repeats"],
        "trajectories_equal_phase8": bool(
            flags_equal and np.array_equal(traj, ref8["T_wc"])),
        "flags_equal_phase8": flags_equal,
        "pos_err_vs_phase8_first8_m": float(
            pos_err[:, :BATCH_POS_FRAMES].max()),
        "map_equal_phase11": bool(np.array_equal(map0["kf_T_wk"],
                                                 ref11["kf_T_wk"])
                                  and np.array_equal(map0["X"], ref11["X"])),
        "map_vs_phase11_max_abs": map_diff, "ranks_agree_on_map": maps_agree,
        "launches": {k: ranks[0]["launches_batched"][k]
                     + ranks[0]["launches_map"][k]
                     for k in ranks[0]["launches_batched"]},
        "launches_batched": ranks[0]["launches_batched"],
        "launches_map": ranks[0]["launches_map"]})
    if n == 1:
        # the same program on the same card as phases 8 and 11
        require(out["trajectories_equal_phase8"],
                f"phase 17: the rank's trajectories differ from phase 8's "
                f"(positions by {float(pos_err.max())} m)")
        require(out["map_equal_phase11"],
                f"phase 17: the rank's global map differs from phase 11's "
                f"by {map_diff}")
    else:
        # another batch composition: W7's tolerance
        require(flags_equal and out["pos_err_vs_phase8_first8_m"]
                <= BATCH_POS_TOL_M,
                f"phase 17: sequences split over {n} ranks against phase 8: "
                f"flags equal {flags_equal}, positions "
                f"{out['pos_err_vs_phase8_first8_m']} m")
    require(maps_agree and map0["repeats"],
            "phase 17: the ranks' global maps differ, or a call does not "
            "repeat")

    # (d) no fallback: more ranks than cards raises before a process starts
    marker = os.path.join(ROOT, "build", "chip_smoke_phase17_rank")
    if os.path.exists(marker):
        os.remove(marker)
    raised = None
    try:
        mesh_mod.spawn_local(touch_rank, n + 1, (marker,), timeout_s=60.0)
    except RuntimeError as e:
        raised = str(e)
    out["too_many_ranks"] = {"ranks": n + 1, "raised": raised,
                             "process_started": os.path.exists(marker)
                             or bool(multiprocessing.active_children())}
    require(raised is not None and f"this machine has {n}" in raised,
            f"phase 17: spawn_local with {n + 1} ranks on {n} cards did not "
            f"raise naming the card count: {raised}")
    require(not out["too_many_ranks"]["process_started"],
            "phase 17: spawn_local started a rank it had no card for")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import bench_torch
    from stereo_svo_tpu_torch.backend import loop_closure
    from stereo_svo_tpu_torch.config import (SvoConfig, kitti_config,
                                             stress_config)
    from stereo_svo_tpu_torch.engine import step as step_mod
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.io import synthetic
    from stereo_svo_tpu_torch.ops.kernels import _build
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    counters = launch_counters()
    detail = {}
    t_start = time.perf_counter()
    seconds, clock = {}, [t_start, "setup"]

    def mark(name):
        """Seconds since the previous mark go to the phase named then."""
        now = time.perf_counter()
        seconds[clock[1]] = now - clock[0]
        clock[:] = [now, name]

    # ---- phase 0: device ----
    smi = bench_torch.device_line(device)
    name = torch.cuda.get_device_name(0)
    phase0 = {"device_name": name, "nvidia_smi": smi,
              "device_count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit("phase0", phase0)
    require(not phase0["matmul_allow_tf32"] and not phase0["cudnn_allow_tf32"],
            "TF32 must stay off")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    detail["build_log"] = log.read_text() if log.exists() else ""
    emit("phase1", {"build_seconds": build_s,
                    "library": os.path.relpath(_build.library_path(), ROOT)})

    # ---- render the sequences on the card ----
    cfg = SvoConfig()
    kcfg = kitti_config()
    t0 = time.perf_counter()
    lefts, rights, gt = synthetic.make_sequence(
        cfg.camera, N_FRAMES, DT, kind="arc", seed=SEED, device=device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    require(tuple(lefts.shape) == (N_FRAMES, 480, 752), f"{lefts.shape}")
    t0 = time.perf_counter()
    # bench.py's KITTI sequence: the road scene on the kitti trajectory,
    # 2x2 anti-aliased
    k_lefts, k_rights, k_gt = bench_torch.render_sequence(
        kcfg.camera, N_FRAMES, "road", "kitti", seed=SEED, dt=DT,
        device=device)
    torch.cuda.synchronize()
    k_render_s = time.perf_counter() - t0
    require(tuple(k_lefts.shape) == (N_FRAMES, 376, 1241),
            f"{k_lefts.shape}")

    # phase 7's sequence, and the keyframe thumbnail its edge measurements
    # align: the bootstrap keyframe's (level 2 of frame 0) with its
    # features' centres at thumbnail scale
    lcfg = SvoConfig(online_loop_every=1, **LOOP_KNOBS)
    t0 = time.perf_counter()
    l_lefts, l_rights, l_gt = synthetic.make_sequence(
        lcfg.camera, LOOP_FRAMES, LOOP_DT, kind="loop", seed=SEED,
        device=device)
    torch.cuda.synchronize()
    l_render_s = time.perf_counter() - t0
    boot = StereoSvo(lcfg, device="cuda")
    boot.new_image(l_lefts[0], l_rights[0])
    scale = 1.0 / 2 ** lcfg.thumb_level
    thumb = (boot.state.mem_thumb[0], boot.state.mem_uv[0] * scale,
             boot.state.mem_mask[0])
    require(tuple(thumb[0].shape) == (120, 188), f"{thumb[0].shape}")

    # ---- phase 2: kernels against plain versions ----
    mark("phase2")
    rows = check_kernels(device, lefts[0], k_lefts[0], thumb)

    # ---- phase 3: the main path, SvoConfig() as shipped ----
    mark("phase3")
    phase3, frame_ms, metrics, svo3 = drive(cfg, lefts, rights, gt,
                                            counters)
    phase3.update(config="SvoConfig()", render_seconds=render_s)
    emit("phase3", phase3)
    detail.update(phase0=phase0, phase3=phase3, frame_ms=frame_ms,
                  n_tracked=metrics["n_tracked"].tolist(),
                  ba_diag=metrics["ba_diag"].tolist())
    require(phase3["ate_m"] <= ATE_GATE_M,
            f"ATE {phase3['ate_m']} m above {ATE_GATE_M}")
    require(phase3["tracking_ok"] >= TRACK_GATE,
            f"tracking_ok {phase3['tracking_ok']} below {TRACK_GATE}")
    require(phase3["ba_accepted"] >= 1, "no window BA call was accepted")

    # ---- phase 4: KITTI geometry ----
    mark("phase4")
    phase4, frame_ms, metrics, svo4 = drive(kcfg, k_lefts, k_rights, k_gt,
                                            counters)
    graph_p = {"kitti_config()": graph_p_nodes(svo4)}
    del svo4
    gate = max(KITTI_ATE_FLOOR_M, KITTI_ATE_FRAC * phase4["gt_travel_m"])
    phase4.update(config="kitti_config()", scene="road", traj="kitti",
                  aa=2, ate_gate_m=gate, render_seconds=k_render_s)
    emit("phase4", phase4)
    detail.update(phase4=phase4, phase4_frame_ms=frame_ms)
    require(phase4["ate_m"] <= gate, f"KITTI ATE {phase4['ate_m']} m above "
                                     f"{gate}")
    require(phase4["tracking_ok"] >= TRACK_GATE,
            f"KITTI tracking_ok {phase4['tracking_ok']}")
    require(phase4["epi_recovered"] > 0, "the epipolar search recovered "
                                         "no seed")
    del k_lefts, k_rights

    # ---- phase 5: stress ----
    mark("phase5")
    phase5, frame_ms, _, svo5 = drive(stress_config(), lefts, rights, gt,
                                      counters)
    graph_p["stress_config()"] = graph_p_nodes(svo5)
    del svo5
    phase5.update(config="stress_config()")
    emit("phase5", phase5)
    detail.update(phase5=phase5, phase5_frame_ms=frame_ms)
    require(phase5["ate_m"] <= ATE_GATE_M,
            f"stress ATE {phase5['ate_m']} m above {ATE_GATE_M}")
    require(phase5["tracking_ok"] >= TRACK_GATE,
            f"stress tracking_ok {phase5['tracking_ok']}")

    # ---- phase 6: affine-warped KLT templates ----
    mark("phase6")
    acfg = SvoConfig(klt_affine_warp=True)
    n6 = N_AFFINE_FRAMES
    phase6, frame_ms, _, _ = drive(acfg, lefts[:n6], rights[:n6], gt[:n6],
                                   counters)
    phase6.update(config="SvoConfig(klt_affine_warp=True)")
    emit("phase6", phase6)
    detail.update(phase6=phase6, phase6_frame_ms=frame_ms)
    require(phase6["ate_m"] <= ATE_GATE_M,
            f"affine ATE {phase6['ate_m']} m above {ATE_GATE_M}")
    require(phase6["tracking_ok"] >= TRACK_GATE,
            f"affine tracking_ok {phase6['tracking_ok']}")
    require(phase6["warped_templates"] > 0,
            "no feature was tracked on a warped template")

    # ---- phase 7: online and offline loop closure, EuRoC rig ----
    mark("phase7")
    phase7, svo7 = loop_run(lcfg, l_lefts, l_rights, l_gt, counters, device)
    phase7["refine"] = refine_run(lcfg, svo7, l_gt, counters)
    # one eager online-loop call on the final state under torch.profiler:
    # CUDA launches and device ms (what graph K_loop replays); then one
    # more refine_trajectory call (~19,000 launches)
    prof = prof_launches(lambda: step_mod.run_online_loop(lcfg, svo7.state))
    phase7["loop_call"].update(eager_profiled_launches=prof["kernels"],
                               eager_profiled_device_ms=prof["device_ms"])
    traj7 = svo7.trajectory()
    prof = prof_launches(lambda: loop_closure.refine_trajectory(
        lcfg, svo7.state, traj7))
    phase7["refine"].update(profiled_launches=prof["kernels"],
                            profiled_device_ms=prof["device_ms"],
                            profiled_by_kernel=prof["by_kernel"])
    phase7.update(config="SvoConfig(online_loop_every=1, kf_dist_ratio=0.05"
                         ", loop_min_gap=15, loop_min_score=0.75)",
                  scene="planes", traj="loop", dt=LOOP_DT,
                  inject_at=LOOP_INJECT_AT, drift=LOOP_DRIFT,
                  render_seconds=l_render_s, reference=PHASE7_REF,
                  tol_m=LOOP_TOL_M)
    detail["phase7_frame_ms"] = phase7.pop("frame_ms_all")
    emit("phase7", phase7)
    detail["phase7"] = phase7
    ref = PHASE7_REF
    require(phase7["kf_frames"] == ref["kf_frames"],
            f"keyframes {phase7['kf_frames']}, reference {ref['kf_frames']}")
    require(phase7["n_loop_closures"] == ref["n_loop_closures"],
            f"loop closures {phase7['n_loop_closures']}, reference "
            f"{ref['n_loop_closures']}")
    require(phase7["refine"]["offline_edges"] == ref["offline_edges"],
            f"offline edges {phase7['refine']['offline_edges']}, reference "
            f"{ref['offline_edges']}")
    for key in ("tail_err_m", "ate_m"):
        require(abs(phase7[key] - ref[key]) <= LOOP_TOL_M,
                f"{key} {phase7[key]}, reference {ref[key]}")
    require(phase7["tracking_ok"] == 1.0,
            f"tracking_ok {phase7['tracking_ok']}")
    require(phase7["loop_calls"] == len(ref["kf_frames"]) - 1,
            f"{phase7['loop_calls']} online-loop calls, want one per "
            f"keyframe after the bootstrap")

    # ---- phase 7b: a correction folded in, the test rig at 752x480 ----
    mark("phase7b")
    from stereo_svo_tpu_torch.config import CameraConfig
    rig = dict(camera=CameraConfig(**RIG_7B), max_keyframes=3,
               mem_keyframes=12, **LOOP_KNOBS)
    t0 = time.perf_counter()
    b_lefts, b_rights, b_gt = synthetic.make_sequence(
        rig["camera"], LOOP_FRAMES, LOOP_DT, kind="loop", seed=SEED,
        device=device)
    torch.cuda.synchronize()
    phase7b = {"render_seconds": time.perf_counter() - t0,
               "config": "SvoConfig(camera=CameraConfig(fx=760, fy=760, "
                         "cx=376, cy=240, baseline=0.25, width=752, "
                         "height=480), max_keyframes=3, mem_keyframes=12, "
                         "kf_dist_ratio=0.05, loop_min_gap=15, "
                         "loop_min_score=0.75)",
               "reference": PHASE7B_REF}
    for every, key in ((1, "online"), (0, "control")):
        bcfg = SvoConfig(online_loop_every=every, **rig)
        run, svo = loop_run(bcfg, b_lefts, b_rights, b_gt, counters, device)
        if every:
            run["refine"] = refine_run(bcfg, svo, b_gt, counters)
        detail[f"phase7b_{key}_frame_ms"] = run.pop("frame_ms_all")
        phase7b[key] = run
    emit("phase7b", phase7b)
    detail["phase7b"] = phase7b
    on, off = phase7b["online"], phase7b["control"]
    require(on["n_loop_closures"] == PHASE7B_REF["n_loop_closures"],
            f"loop closures {on['n_loop_closures']}, reference "
            f"{PHASE7B_REF['n_loop_closures']}")
    require(off["n_loop_closures"] == 0,
            f"{off['n_loop_closures']} loop closures in the control")
    require(on["tail_err_m"] < 0.75 * off["tail_err_m"],
            f"tail error {on['tail_err_m']} not below 0.75x the control's "
            f"{off['tail_err_m']}")
    require(on["refine"]["offline_edges"] == PHASE7B_REF["offline_edges"],
            f"offline edges {on['refine']['offline_edges']}, reference "
            f"{PHASE7B_REF['offline_edges']}")
    require(min(on["tracking_ok"], off["tracking_ok"]) >= TRACK_GATE,
            "phase 7b tracking_ok")
    del b_lefts, b_rights

    # ---- phase 8: batched-8 ----
    mark("phase8")
    phase8, states8, frames8, host8 = batched_run(cfg, counters, device,
                                                  svo3.trajectory())
    emit("phase8", phase8)
    detail["phase8"] = phase8

    # ---- phase 9: tracking loss and relocalisation ----
    mark("phase9")
    n9 = BLACKOUT_FRAMES
    phase9, frame_ms = blackout_run(SvoConfig(**BLACKOUT_KNOBS), l_lefts[:n9],
                                    l_rights[:n9], l_gt[:n9], counters)
    phase9.update(config="SvoConfig(kf_dist_ratio=0.05)", scene="planes",
                  traj="loop", dt=LOOP_DT, blackout=list(BLACKOUT),
                  reference=PHASE9_REF, tol_m=BLACKOUT_TOL_M)
    emit("phase9", phase9)
    detail.update(phase9=phase9, phase9_frame_ms=frame_ms)
    require(phase9["lost_frames"] == PHASE9_REF["lost_frames"]
            == list(BLACKOUT),
            f"tracking lost on {phase9['lost_frames']}, blacked out "
            f"{list(BLACKOUT)}")
    require(phase9["kf_frames"] == PHASE9_REF["kf_frames"],
            f"keyframes {phase9['kf_frames']}, reference "
            f"{PHASE9_REF['kf_frames']}")
    for key in ("tail_err_m", "ate_m"):
        require(abs(phase9[key] - PHASE9_REF[key]) <= BLACKOUT_TOL_M,
                f"{key} {phase9[key]}, reference {PHASE9_REF[key]}")
    # the variants are computed when the previous frame failed: on the
    # second and third blacked-out frames and on the recovery frame
    require(phase9["rotated_variant_calls"] == len(BLACKOUT),
            f"{phase9['rotated_variant_calls']} calls of the rotated "
            f"relocalisation variants, want {len(BLACKOUT)}")
    # recorded once into the A_fail graph (and run once in its warm-up)
    require(phase9["rotated_variants_captured"] == 1
            and phase9["rotated_variants_eager"] == 1,
            "the rotated relocalisation variants are not in the A_fail "
            "graph alone")
    del l_lefts, l_rights

    # ---- phase 10: the CLI, then checkpoint and resume ----
    mark("phase10")
    phase10 = {"cli": cli_run(counters, device)}
    phase10["checkpoint"] = resume_run(cfg, lefts, rights,
                                       svo3.trajectory(), counters)
    emit("phase10", phase10)
    detail["phase10"] = phase10

    # ---- phase 11: the global map over an nccl group of one ----
    mark("phase11")
    phase11, host11 = global_map_run(cfg, states8, counters)
    emit("phase11", phase11)
    detail["phase11"] = phase11

    # ---- phase 12: the graphed step against the eager one ----
    mark("phase12")
    phase12, e_traj, e_metrics = graphed_vs_eager(
        cfg, lefts, rights, gt, counters, svo3, phase3, svo7._step)
    # graph P (the pyramid: B1, then B2 on every level) of each
    # configuration's step: one node of each kernel
    phase12["graph_P"] = dict(graph_p, **{"SvoConfig()": graph_p_nodes(svo3)})
    for key, p in phase12["graph_P"].items():
        require(p["nodes"]["kernel"] == 2
                and p["kernel_nodes"]["halfsample"] == 1
                and p["kernel_nodes"]["gradients"] == 1,
                f"graph P of {key}: {p}, not one B1 and one B2 node")
    emit("phase12", phase12)
    detail["phase12"] = phase12

    # ---- phase 13: the hard scenes, at the test rig and at 752x480 ----
    mark("phase13")
    hard_cfg = SvoConfig(camera=CameraConfig(**HARD_CAM), **HARD_CFG)
    runs13, capture13 = hard_scene_runs({"rig": hard_cfg, "full": cfg},
                                        counters, device)
    phase13 = {"configs": {"rig": "SvoConfig(376x240 test rig, grid 10x13, "
                                  "130 slots, 3 levels)",
                           "full": "SvoConfig()"},
               "frames": HARD_FRAMES, "dt": HARD_DT, "seed": SEED,
               "scenes": HARD_SCENES, "ate_gates": HARD_ATE_GATES,
               "capture_seconds": capture13, "runs": runs13,
               "reference": PHASE13_REF, "tol_m": LOOP_TOL_M}
    emit("phase13", phase13)
    detail["phase13"] = phase13
    check_hard_scenes(runs13)

    # ---- phase 14: 500 frames, a wrapped bank, a drift event repaired ----
    mark("phase14")
    phase14 = long_horizon_run(
        SvoConfig(camera=CameraConfig(**HARD_CAM), **LONG_CFG), counters,
        device)
    phase14.update(reference=PHASE14_REF, tol_m=LOOP_TOL_M)
    emit("phase14", phase14)
    detail["phase14"] = phase14
    check_long_horizon(phase14)

    # ---- phase 15: run_sequence_scan and run_sequence_batched with no
    # host read from the first frame to the last ----
    mark("phase15")
    phase15 = {"scan": scan_run(cfg, lefts, rights, counters, device,
                                e_traj, e_metrics),
               "batched": batched_scan_run(cfg, *frames8, counters, device)}
    for key in ("scan", "batched"):
        detail[f"phase15_{key}_frame_ms"] = phase15[key].pop("frame_ms_all")
    emit("phase15", phase15)
    detail["phase15"] = phase15
    del frames8

    # ---- phase 16: the benchmark entry points ----
    mark("phase16")
    phase16 = bench_entry_points(phase3["ate_m"])
    emit("phase16", phase16)
    detail["phase16"] = phase16

    # ---- phase 17: the multi-rank paths, one rank a GPU over nccl ----
    mark("phase17")
    phase17 = multi_rank_run(cfg, host8, host11, smi)
    emit("phase17", phase17)
    detail["phase17"] = phase17
    mark("end")
    seconds["total"] = clock[0] - t_start
    emit("seconds", seconds)
    detail["seconds"] = seconds

    # launches of each row's kernel on the path that gives it its shape
    # (phase 8's per batched frame: its rows are the problem-axis launches)
    paths = {"phase3": phase3, "phase4": phase4, "phase5": phase5,
             "phase6": phase6, "phase7": phase7,
             "phase8": dict(phase8, launches_per_frame=phase8[
                 "launches_per_batched_frame"])}
    b1 = {k: p["launches_per_frame"]["halfsample"] for k, p in paths.items()}
    require(all(v == 1.0 for v in b1.values()),
            f"B1 launches per frame {b1}, not 1.0 (one per pyramid)")
    # B2: one launch per pyramid; phase 7's online-loop calls add K_loop's
    # B2 nodes beyond K's (the thumbnails of measure_edges) a call
    b2 = {k: p["launches_per_frame"]["gradients"] for k, p in paths.items()
          if k != "phase7"}
    loop_b2 = phase7["loop_calls"] * phase7["loop_call"][
        "launches_per_call"]["gradients"]
    b2["phase7"] = (phase7["launches"]["gradients"] - loop_b2) / \
        phase7["frames"]
    require(all(v == 1.0 for v in b2.values()),
            f"B2 launches per frame {b2} (phase 7: less its online-loop "
            f"calls' {loop_b2}), not 1.0 (one per pyramid)")
    for row in rows:
        path = paths[row["path"]]
        row["launches"] = path["launches"][row["name"]]
        row["launches_per_frame"] = path["launches_per_frame"][row["name"]]
        if row.get("thumbnail"):
            row["launches_per_loop_call"] = \
                phase7["loop_call"]["launches_per_call"][row["name"]]
    emit("phase2_rows", {"rows": [
        {k: r.get(k) for k in ROW_SUMMARY} for r in rows]})
    detail["kernels"] = rows
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)

    main_rows = {}
    for row in rows:                 # each kernel's first row: phase 3
        main_rows.setdefault(row["name"], row)
    by_path = {"phase3": phase3["launches"], "phase9": phase9["launches"],
               "phase10_cli": phase10["cli"]["launches"],
               "phase10_checkpoint": phase10["checkpoint"]["launches"],
               "phase11": phase11["launches"],
               "phase13_full_clutter": runs13["full"]["clutter"]["launches"],
               "phase14": phase14["launches"],
               "phase17_rank0": phase17["launches"]}
    # measured: each graph's kernel nodes of this kernel (read from the
    # libcuda), and on phase 12's profiled frame the device's records of it
    # beside the counters' gain
    print(json.dumps({"kernels": [
        dict({k: r[k] for k in ("name", "route", "source", "replaces",
                                "launches", "max_abs_err", "max_rel_err",
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_us", "host_us")},
             launches_by_path={p: v[r["name"]] for p, v in by_path.items()},
             graph_kernel_nodes={g: v[r["name"]] for g, v in
                                 phase12["kernel_nodes"].items()},
             profiled_frames={
                 f"{key}_{kind}": {"device_records": v["by_kernel"][r["name"]],
                                   "counted": v["counted"][r["name"]]}
                 for kind, p in phase12["profile"].items()
                 for key, v in p.items()})
        for r in main_rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def child(task: dict) -> dict:
    """Run ``task`` in a process of its own (child_main): the profiled
    frames of phase 12 and the steady windows of phase 15. In this
    process, after the earlier phases' profiles and steps, the profiler
    was seen to drop records inside the frame graph's bodies and to
    stretch kernels (PERF.md §7)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), CHILD_FLAG,
         json.dumps(task)], capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"child {task['task']}: "
                                  f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def steady_window(cfg, lefts, rights, B: int) -> dict:
    """steady_split of a fresh graphed step (B = 0) or graphed batched
    step over SCAN_PROFILE_FRAMES frames: phase 3's from frame
    SCAN_PROFILE_AT, or phase 8's last ones."""
    from stereo_svo_tpu_torch.engine import graphed
    if B:
        step = graphed.make_graphed_batched_step(cfg, B, "cuda")
        a0 = BATCH_FRAMES - SCAN_PROFILE_FRAMES
        frame = lambda t: step(step.state, lefts[:, t], rights[:, t])  # noqa: E731
    else:
        step = graphed.make_graphed_step(cfg, "cuda")
        a0 = SCAN_PROFILE_AT
        frame = lambda t: step(step.state, lefts[t], rights[t])  # noqa: E731
    n = SCAN_PROFILE_FRAMES

    def drive_to():
        step.reset()
        for t in range(a0 - 1):
            frame(t)

    def window():
        for t in range(a0, a0 + n):
            frame(t)
    return dict(steady_split(
        drive_to, lambda: frame(a0 - 1), window, n,
        os.path.join(ROOT, "build", f"chip_smoke_steady_{B}_trace.json")),
        first_frame=a0)


def child_main(task: dict) -> int:
    """The child process (``chip_smoke.py CHILD_FLAG '<task json>'``): the
    frames rendered again as phase 3 (and phase 8) render them, the task,
    one JSON line."""
    import torch
    sys.path.insert(0, ROOT)
    import stereo_svo_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from stereo_svo_tpu_torch.config import SvoConfig
    from stereo_svo_tpu_torch.engine.runner import StereoSvo
    from stereo_svo_tpu_torch.io import synthetic
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cfg = SvoConfig()
    if task.get("batch"):
        seqs = [synthetic.make_sequence(cfg.camera, BATCH_FRAMES, DT,
                                        kind="arc", seed=b, device=device)
                for b in range(task["batch"])]
        lefts = torch.stack([q[0] for q in seqs])
        rights = torch.stack([q[1] for q in seqs])
    else:
        lefts, rights, _ = synthetic.make_sequence(
            cfg.camera, N_FRAMES, DT, kind="arc", seed=SEED, device=device)
    if task["task"] == "profile_frames":
        out = profile_frames("graphed", StereoSvo, cfg, lefts, rights,
                             launch_counters(), task["kinds"])
    else:
        out = steady_window(cfg, lefts, rights, task["batch"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == [CHILD_FLAG]:
            sys.exit(child_main(json.loads(sys.argv[2])))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
