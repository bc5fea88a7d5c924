"""Drive the PyTorch/CUDA port on one GPU: build the splat kernels (forward
and gather VJP, each in its identity and SE2-warp form, and the
contrast-maximization ascent as one thread-block-cluster kernel) and the
native C++ I/O library, hold the kernels against their plain PyTorch
versions (at the event front-end's shapes and at the dataset generator's;
the ascent kernel step by step against the ascent loop on the card at
16,384 and 65,536 events), time the ascent kernel beside the loop it
replaces, run the L1 event front-end
slice (event stream -> EventWindowBuilder.step_window -> MCI -> ORB
extract), hold L2 tracking, duplicate fusion, the descriptor refresh and
local BA on the card against the CPU from the same map, run EVENT_ONLY end
to end (slam/event_system.EventSlam: L1 + MonoSlam tracking, mapping and
Schur BA) at DAVIS240 size and shakes density (4 M events/s), and then the
app layer: generate an EV-ETHZ sequence with io/synth_dataset (dot renderer
through the splat kernel), run apps/run_slam.main on it with the
configs/synth_ev_only.yaml settings and score the trajectory against ground
truth, and run MONOCULAR at the configs/synth_euroc_mono.yaml width
(752x480, 512 features) on a generated EuRoC sequence. Then the inertial
slice: the pipelined speculation (MonoSlam with and without it on rendered
frames, and a blank frame's rollback), the IMU stack on the card against
the CPU (preintegration, inertial init, the VI pose optimization, VI-BA),
IMU_MONOCULAR through run_slam.main at the configs/synth_euroc_vi.yaml
width on the same EuRoC sequence (with its IMU), and EVENT_IMU through
run_slam.main with the configs/synth_ev_imu.yaml settings on the generated
EV-ETHZ sequence (with its IMU). Then stereo, depth and place recognition:
the depth modules (stereo_match, the depth lookup, depth landmarks) and the
loop modules (Sim3 RANSAC, the f64 pose graph, BoW scoring) on the card
against the CPU, the reference's merge-after-loss scene through
MonoSlam(loop_words=...) on the card, STEREO, RGBD and IMU_STEREO through
run_slam.main with their configs/synth_euroc_*.yaml settings on one
generated corridor with a right camera and depth, and MONOCULAR with a
trained vocabulary at configs/synth_euroc_room_large.yaml on a generated
room loop of two turns, with the loop closer's gate decisions. Then event +
image and the continuous tracker: the forward kernel at _chunk_image's
shape (12,000 slots); EVENT_MONO's fixed-shape steps (the joint pose step
and write-back, the loop propagation, the known-pose init triangulation,
the joint local BA in float64), build_mci on one 65,536-event window and
the per-chunk step() on the card against the CPU; EventSlamContinuous on
the card against the CPU; and EVENT_MONO, EVENT_IMU_MONO and EVENT_ONLY
with Event.contTracking: 1 through run_slam.main with the
configs/synth_ev_*.yaml settings on the generated EV-ETHZ sequence, the
splat launches of each gated exactly (forward, VJP and ascent). Then the last modules: AKAZE and the
mixed ORB + AKAZE extraction on the card against the CPU; MONOCULAR with
Features.mode: 2 (MixedMonoSlam) through run_slam.run_sequence on the
generated corridor beside plain MONOCULAR; a checkpoint of a MonoSlam saved
and resumed on the card; 0.1 s of the generated shakes sequence written
into a ROS bag, read back and run through run_slam.main EVENT_ONLY; and the
scale-out: two gloo ranks sharing the card and one NCCL rank, each a
process of its own (``python3 chip_smoke.py --dist-worker ...``), through
the event-sharded splat (the forward kernel once per rank per call) and the
float64 landmark-sharded BA. Beside the splat kernels it builds the
status-free eigensolver (csrc/sym_eig.cu, one nvcc of its own, started
with the others) and holds it against torch.linalg.eigh on the card at
every call site's (n, batch), float32 and float64 (check_kernel_sym_eig),
and counts its launches per path and per step. The six one-dispatch
steps (the L1 window, the tracked image frame, local BA's LM loop, the
keyframe mapping step, the tracked inertial frame, VI-BA's LM loop) run on
the card as CUDA-graph replays (eorb_slam_tpu_torch/_graphs.py);
check_graphs_small holds each replay against its eager step bit for bit
across a key change and a map change and prints, eager against replayed,
the host-issued launches, device kernels, device ms and wall ms per step,
and EventSlam, MONOCULAR, IMU_MONOCULAR and that phase gate the
host-issued launches per tracked frame or MCI, per keyframe frame or MCI,
per tracked inertial frame and per L1 window (GRAPH_LAUNCH_MAX). The
event-image and continuous units (build_mci's candidates, the per-chunk
step, track advance and top-up, the pose-only solve, EVENT_MONO's five
joint steps) replay too: check_graphs_small records them through
EvImageSlam, EventSlamContinuous and EventWindowBuilder.step and holds each
replay against its eager step bit for bit, check_ev_image_small holds
build_mci's capture and replay at 65,536 events against the card's first
MCI, and the continuous app and EVENT_MONO gate their host-issued launches
per window and per paired tracked image. The feature-path units (extract,
undistort_points, track_frame, stereo_match) replay at every call site:
check_graphs_small records them through StereoSlam at 752x480 (uint8 and
float32 images, the narrow and the wide search) and holds each replay
against its eager step bit for bit, STEREO and RGBD gate their tracked
frames' host-issued launches, and the inertial app runs print the launches
of steps tracked before the IMU init (_PreInit). A
replay runs no Python, so it adds the hand kernels' launches counted at
capture: EventSlam holds each profiled step's counts against the kernels
the profiler saw run, and check_graph_nodes, at the end, holds every
graph the runners captured (each one some path replayed) to its counts
by the kernels among its nodes.

    python3 chip_smoke.py

Every phase raises on failure and the script then exits non-zero; the
read gates: a tracked frame or MCI reads at most its flags, with or
without a keyframe (READS_TRACK_MAX, READS_KF_MAX; an inertial keyframe
READS_INERTIAL_KF), an L1 window at most its metadata, and no other phase
reads more per step than READS_BEFORE. Output:
the card's name and power limit, the build times, the kernel-vs-plain
comparisons and times (by CUDA events around eager calls, and device only:
a CUDA-graph replay and the profiler's time by kernel name), the ascent's
time and launches per call (kernel and loop), the L1 slice's windows/s,
the L2 cuda-vs-cpu agreement, EventSlam's MCIs/s, real-time factor and ms
per MCI by phase,
the generator's events/s, the app runs with their accuracy, blocking host
reads per frame / MCI (torch's sync debug mode) by kind of step (tracked,
keyframe, other) with their commonest ``file:line`` sites, launches and
device time per frame, the splat launches of each app path, then one JSON line
describing the kernels and, last, the device line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

H, W = 180, 240
SIGMA, TRUNC = 1.0, 2.5
KERNEL_NS = (8192, 16384, 32768, 65536)
MAIN_N = 16384      # the L1 window's ascent (cm_sample) and the pair's timed shape
FWD_TOL = 1e-5      # x max|ref|: the plain version sums in f32, the kernel
#                     in fixed point (exact at 2^-32), in another order
GRAD_TOL = 1e-4     # x max|ref|: per-event sums of <= 36 f32 terms, and for
#                     dL/dparams a sum over all N events, in another order
CM_ITERS = 40       # BuilderConfig.cm_iters
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
F32_FLOPS = 67e12            # f32 outside the tensor cores, published
# operations per event that reaches the image: 12 Gaussians (sub, 2 mul, exp)
# and 36 taps (forward: product, add; VJP: 3 sums of product, add), plus
# ~20 for the SE2 warp and its chain rule
FWD_OPS, VJP_OPS = 12 * 4 + 36 * 2 + 20, 12 * 4 + 36 * 6 + 40
RATE = 4_000_000    # events/s after the in-image cut (shakes density)
WARM_S, RUN_S = 0.1, 0.25             # L1 slice
EV_WARM_S, EV_RUN_S, EV_PHASE_S = 0.2, 0.15, 0.085  # EventSlam
EV_PHASE_TIMED = 10      # MCIs of the phase pass under timers; the rest (~4)
#                          run under the profiler
PACKET = 40_000          # events per EventSlam.track_events call (10 ms)
L2_KW = dict(K=24, M=2048, P=8)          # EventSlam's defaults
L2_TRACK_AGREE = 0.98   # feat_lm equal on >= 98% of the features
L2_POSE_TOL = 1e-4      # Tcw max abs, cuda vs cpu
L2_COST_TOL = 1e-3      # BA cost, relative, f32, LM run to convergence
L2_COST_TOL_F64 = 1e-9  # BA cost, relative, f64, the main path's 8 iterations
BA_ITERS, BA_ITERS_CONVERGED = 8, 40
# configs/synth_ev_only.yaml
CAM = (199.0, 199.0, 120.0, 90.0)
SLICE_CFG = dict(img_w=W, img_h=H, l1_chunk_size=6000, l1_num_loop=4,
                 max_pixel_disp=3.0, min_ev_gen_rate=0.5)
MAX_KP = 256
# the dataset generator (io/synth_dataset): 6,000 dots x 4 sub-dots, splat
# sigma 1.1, and the event rates a shakes sequence must land between
GEN_DOTS, GEN_SIGMA = 6000, 1.1
GEN_S, GEN_SIM_HZ, GEN_FPS = 0.5, 150.0, 24.0
GEN_RATE_BAND = (1.0e6, 8.0e6)          # events per second of data
APP_ATE_MAX = 0.50      # ATE rmse / path length, EVENT_ONLY through run_slam: six card
#                         runs gave 0.087-0.278 (PERF.md section 6)
APP_MIN_ATE_N = 30
# EVENT_IMU's tracked share after init: its L2 (the reference's
# MonoInertialSlam over MCIs, a keyframe at most every 10 MCIs) loses
# windows that EventSlam's event cadence keeps; the JAX app on a CPU tracks
# 55 of 76 (72%) of the same generated 0.5 s (tools/vi_init_check.py),
# four card runs 72-87%. The gate sits below the reference's share by the
# run-to-run spread of the forward's atomics.
EVI_TRACK_MIN = 0.60
# MONOCULAR at the configs/synth_euroc_mono.yaml width
MONO_FRAMES, MONO_PROFILED = 40, 2
# IMU_MONOCULAR at the configs/synth_euroc_vi.yaml width on a generated
# room_01 (one of that file's sequences): VI_GEN_FRAMES frames of the room
# loop at 10 s per turn, box renderer. On the MONOCULAR phase's corridor the
# JAX app never initializes the IMU at this width (12 s tried, chi2/dof
# 88-559 against the 3.0 gate); on this sequence it does at frame
# VI_INIT_REF (the JAX app on a CPU, same generator and length:
# tools/vi_init_check.py); the port's own RANSAC draws initialize earlier on
# the card (PERF.md). VI_FRAMES are timed, then VI_EXTRA frames run under
# the sync counter and the profiler.
VI_GEN_FRAMES, VI_FRAMES, VI_EXTRA, VI_INIT_REF, VI_ROOM_S = 84, 60, 6, 71, 10.0
VI_READ_FRAMES = 1         # of the VI_EXTRA frames, under the blocking-read counter
# STEREO, RGBD and IMU_STEREO at the configs/synth_euroc_{stereo,rgbd,
# imu_stereo}.yaml width share one generated corridor_st_01 (cam1 at
# bf / fx = 0.11 m, depth0); each runs its frames through run_slam, then
# DEPTH_EXTRA more under the read counter and the profiler (STEREO and
# RGBD, whose tracked frames are gated by launches, STEREO_RGBD_EXTRA)
DEPTH_BASELINE = 0.11
DEPTH_GEN_FRAMES, DEPTH_FRAMES, IMU_STEREO_FRAMES, DEPTH_EXTRA = 66, 30, 64, 2
STEREO_RGBD_EXTRA = 4
# IMU_STEREO: the JAX app on a CPU initializes the IMU after frame
# IMU_STEREO_INIT_REF of this sequence (tools/vi_init_check.py --stereo
# --kind corridor); IMU_STEREO_FRAMES leaves ~20 inertial frames after it
IMU_STEREO_INIT_REF = 44
DEPTH_TOL = 1e-5           # stereo depth, relative, cuda vs cpu
DEPTH_POS_TOL = 1e-3       # depth landmarks, m, at up to 60 m (f32)
SIM3_TOL = 1e-4            # sim3_ransac R, t, s, max abs, cuda vs cpu
POSE_GRAPH_TOL_F64 = 1e-9  # optimize_pose_graph, float64, max abs
BOW_TOL = 1e-6             # L1 scores, cuda vs cpu (another summation order)
# a welded loop's kf_T and lm_pos, cuda vs cpu, max abs: f32 pose graph (15
# GN iterations) and a 10-iteration f32 BA after it (the CPU test holds JAX
# and the port to 1e-4 on the same map)
LOOP_CORRECT_TOL = 1e-4
APP_TRACK_MIN = 0.8        # tracked share after init, the image modes
# MONOCULAR with place recognition at configs/synth_euroc_room_large.yaml:
# LOOP_TURNS turns of the room loop, so the path revisits its start
LOOP_ROOM_S, LOOP_TURNS = 10.0, 2.0
# the pipelined check: box-rendered corridor frames at 320x240
PIPE_W, PIPE_H, PIPE_FX, PIPE_FRAMES, PIPE_BLANK = 320, 240, 195.0, 40, 24
PIPE_KW = dict(img_w=PIPE_W, img_h=PIPE_H, K=8, M=1024, N=256, max_frames_between_kf=4)
PIPE_PROFILED = 2          # its last frames, under the profiler
# the graph runner (eorb_slam_tpu_torch/_graphs.py): host-issued launches
# (HOST_LAUNCH_APIS, by the profiler) per steady step, a tracked frame or
# L2 MCI, an L1 window, a keyframe frame or MCI (the tracked frame's replay,
# the mapping step's replay and the eager culling) and a tracked inertial
# frame; check_graphs_small's recorded sequences
GRAPH_LAUNCH_MAX = {"frame": 100, "window": 50, "keyframe": 100, "vi frame": 100,
                    "continuous window": 150, "event-image frame": 150}
GRAPH_WINDOWS, GRAPH_STREAM_S = 9, 0.12     # L1 windows from this much stream
GRAPH_FRAMES, GRAPH_PROFILED = 20, 4        # corridor frames, the last profiled
# the keyframe mapping step at a second map capacity (landmarks), a key of
# its own: a MonoSlam run until it has made this many mapping steps
GRAPH_M2, GRAPH_KF2 = 2048, 3
# the inertial frame step: IMU windows of these sample counts (200 Hz at
# 20 and 40 fps: buckets of 16 and 8), each against the last keyframe and
# against a PoseImuPrior; VI-BA at the keyframe path's iterations (8 per
# keyframe, 24 after an init or a scale refinement) on a problem of
# GRAPH_VIBA (K, M)
GRAPH_IMU_S, GRAPH_VIBA_ITERS, GRAPH_VIBA = (10, 5), (8, 24), (16, 1024)
# the event-image and continuous units: build_mci's candidates and the
# per-chunk step through EventWindowBuilder.step on this much stream at the
# synth_ev_only width, twice (each builder's first chunk has no previous
# image; the second posts the pose prior after GRAPH_PRIOR_AFTER windows)
GRAPH_STEP_S, GRAPH_PRIOR_AFTER = 0.04, 1
# the feature-path units (extract, undistort_points, track_frame,
# stereo_match): StereoSlam frames of the rendered corridor pair at the
# synth_euroc_stereo width
GRAPH_STEREO_FRAMES = 6
# the profiled steps of EVENT_MONO's second run, every key met in the first
# (its images from this one on), and of the continuous app (the windows
# after CONT_PROFILED full images)
EV_STEADY_FROM, CONT_APP_PROFILED = 6, 3
# blocking host reads (_Syncs): a tracked frame or MCI reads at most its
# (2,) flags, whether or not it inserts a keyframe (the keyframe's
# triangulations and the inertial frame's prior decompose through the
# sym_eig kernel, which reads nothing back); an L1 window at most its
# metadata's HostCopy
READS_TRACK_MAX, READS_KF_MAX, READS_L1_MAX = 1, 1, 1
# the inertial app runs' steps tracked before the IMU init (their own
# eager preintegration around the feature units' replays): the
# PREINIT_PROFILED after the first PREINIT_SKIP (every key met by then)
# under the profiler, their launches logged by kind
PREINIT_SKIP, PREINIT_PROFILED = 4, 2
# the app phases' limits per step of each kind: the flags on a tracked
# frame, keyframe or not. An inertial keyframe frame reads besides where the
# reference reads too: the keyframe times for the IMU init's time span
# (vi_system.py:541; eorb_slam_tpu/slam/vi_system.py:620) and an inertial
# solve's cost, scale and gravity (vi_system.py:534, the init before it and
# the scale refinement after it; eorb_slam_tpu/slam/vi_system.py:633, :722)
READS_INERTIAL_KF = {"IMU_MONOCULAR": {"KF": 3, "KF VI": 3},
                     "IMU_STEREO": {"KF": 3, "KF VI": 3}}
READS_APP_MAX = {
    **{tag: {"track": READS_TRACK_MAX, "KF": READS_KF_MAX}
       for tag in ("MONOCULAR", "MONOCULAR mixed", "STEREO", "RGBD")},
    **{tag: {"track": READS_TRACK_MAX, "track VI": READS_TRACK_MAX, **kf}
       for tag, kf in READS_INERTIAL_KF.items()},
}
# every other phase's blocking reads per step of each kind (_frame_kind;
# " VI" once the IMU is initialised; per window for the continuous
# tracker) measured on the code before the frame path stopped copying host
# constants to the card, the same phases in one call on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md section 5). None may read more.
READS_BEFORE = {
    "MONOCULAR": {"track": 67.0, "KF": 108.0},
    "MONOCULAR mixed": {"track": 156.0, "KF": 197.0},
    "IMU_MONOCULAR": {"track": 68.0, "KF": 109.75, "track VI": 178.0, "KF VI": 463.5},
    "STEREO": {"track": 93.0, "KF": 152.0},
    "RGBD": {"track": 68.0, "KF": 127.0},
    "IMU_STEREO": {"track": 93.0, "KF": 152.0, "track VI": 180.78, "KF VI": 506.5},
    "MONOCULAR+loop": {"track": 67.0, "KF": 123.52},
    "EVENT_MONO": {"track": 158.33, "KF": 203.2},
    "EVENT_IMU_MONO": {"track": 166.0, "KF": 225.0},
    "EVENT_ONLY continuous": {"window": 27.0},
}
# check_vi_small: card against the CPU, f32 unless stated
VI_TOL_PRE = 1e-5          # integrate / merge / predict_state, max abs
VI_TOL_SCALE = 1e-4        # inertial_init, relative
VI_TOL_GRAV = 1e-4         # inertial_init, gravity direction angle (rad)
VI_TOL_POSE = 1e-4         # pose_inertial_optimization, Tcw max abs
VI_TOL_BA, VI_TOL_BA_F64 = 1e-3, 1e-9   # vi_bundle_adjust cost, relative
# the image-clock event modes and the continuous tracker, card against the
# CPU: the numpy event world of tests/test_event_slam.py (its camera and
# builder settings, 5 ascent iterations over a 16,384-slot window), the
# EvImageSlam of tests/test_torch_ev_image.py and the continuous tracker of
# tests/test_torch_event_continuous.py
EVW_CAM = (150.0, 150.0, 120.0, 90.0)
EVW_CFG = dict(img_w=W, img_h=H, l1_chunk_size=1500, l1_num_loop=3, min_chunk=400,
               max_chunk=4000, min_ev_gen_rate=0.01, cm_iters=5, max_window_events=16384,
               overlap=0.2)
EVI_KW = dict(img_w=W, img_h=H, max_kp=256, ev_max_kp=256, synch_window_s=0.2, K=12,
              M=1024, min_init_matches=30, min_track_inliers=8)
EVI_FRAMES, EVI_FPS, EVI_RATE = 18, 12.0, 100_000
CONT_KW = dict(n_tracks=256, min_init_matches=25, min_track_inliers=8, min_init_disp_px=3.0,
               kf_disp_px=6.0, K=12, M=1024)
CONT_EVENTS, CONT_PACKET = 64000, 8000
EV_STEP_TOL = 1e-4         # joint pose step / write-back, Tcw max abs, f32 GN
EV_PROP_TOL = 1e-5         # the loop propagation, max abs (no solve)
CONT_POSE_TOL = 2e-3       # continuous tracker, Tcw max abs per window
# build_mci's ascent, card vs CPU: params and contrasts agree (relative)
# step by step until the two first decide differently, and that decision
# is a tie: the new contrast within ASCENT_TIE (relative) of the best on
# both devices (eight f32 ulps; one ulp is 6e-8 to 1.2e-7 of the value)
ASCENT_TOL, ASCENT_TIE = 1e-5, 1e-6
# forward, VJP and ascent kernel launches of one build_mci: the 4
# candidates' forwards, and the ascent as one launch of its own kernel
MCI_FWD, MCI_VJP, MCI_ASCENT = 4, 0, 1
# the ascent kernel's call sites: step_window's cm_sample and build_mci's
# whole padded window
ASCENT_NS = (MAIN_N, 65536)
# EVENT_MONO / EVENT_IMU_MONO: the image tracker's generator seed of the app
# runs. The event map's birth follows the image map's one two-view RANSAC
# draw: with JAX's draws replayed the port births it as the reference does,
# and on the card seeds 0-9 birth it 9 / 10 times (EVENT_MONO; seed 0 does
# not) and 10 / 10 (EVENT_IMU_MONO): `tools/vi_init_check.py --package both`
# and `--seeds 0-9`, PERF.md section 6. Seed 1 is the first that births it
# in both modes, so the gated run drives the joint steps and event tracking.
EV_IMAGE_SEED = 1
CHUNK_N = 12000            # BuilderConfig.max_chunk: _chunk_image's padded width
CONT_PROFILED = 40         # continuous app: full images before the profiled window
REPO = os.path.dirname(os.path.abspath(__file__))


def _log(*a):
    print(*a, flush=True)


def _reset_counts():
    """Set the splat wrappers' launch counts (forward, VJP, ascent) to 0."""
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    hs.splat.launches = hs.splat.vjp_launches = hs.splat.ascent_launches = 0


def _counts():
    """(forward, VJP, ascent) kernel launches since the last _reset_counts."""
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    return hs.splat.launches, hs.splat.vjp_launches, hs.splat.ascent_launches


def _reset_eig():
    """Set the sym_eig wrapper's launch counts (by n) to 0."""
    from eorb_slam_tpu_torch.ops import hopper_linalg as hl

    hl.sym_eig.by_n = {}


def _eig_counts() -> dict:
    """sym_eig kernel launches by matrix size n since the last _reset_eig."""
    from eorb_slam_tpu_torch.ops import hopper_linalg as hl

    return dict(sorted(hl.sym_eig.by_n.items()))


def _runners() -> dict:
    """The port's graph runners (the reference's one-dispatch steps) by
    kind of step."""
    from eorb_slam_tpu_torch.event import builder, feature_tracks
    from eorb_slam_tpu_torch.geometry import camera
    from eorb_slam_tpu_torch.ops import frontend, stereo_match
    from eorb_slam_tpu_torch.optim import pose_only, schur_ba, vi_ba
    from eorb_slam_tpu_torch.slam import ev_image_system as evi
    from eorb_slam_tpu_torch.slam import local_mapping, tracking, vi_system

    return {"extract": frontend.extract, "undistort": camera.undistort_points,
            "track search": tracking.track_frame, "stereo match": stereo_match.stereo_match,
            "L1 window": builder.window_step, "tracked frame": tracking.track_image_frame,
            "local BA": schur_ba.bundle_adjust,
            "keyframe mapping": local_mapping.keyframe_mapping_step,
            "VI frame": vi_system.vi_frame_step, "VI-BA": vi_ba.vi_bundle_adjust,
            "MCI candidates": builder.make_candidates, "chunk step": builder.chunk_step,
            "track advance": feature_tracks.advance, "track top-up": feature_tracks.top_up,
            "pose-only": pose_only.pose_optimization, "joint local BA": evi.joint_local_ba,
            "loop propagation": evi.propagate_loop, "init triangulation": evi.init_triangulate,
            "joint pose": evi.joint_pose, "joint write-back": evi.joint_writeback}


def _captures() -> int:
    """Graph captures so far, all runners."""
    return sum(r.captures for r in _runners().values())


def _first_calls() -> int:
    """Keys met so far, all runners: a step that met a new key ran it
    eagerly (its warm-up call)."""
    return sum(len(r._warm) for r in _runners().values())


def _graph_stats() -> dict:
    """{kind: (captures, keys, replays, capture s, graph pool MB)} of each
    runner."""
    return {k: (r.captures, r.keys, r.replays, round(r.capture_s, 3), _pool_mb(r.pool))
            for k, r in _runners().items()}


def _window_launches(l1_num_loop):
    """(forward, VJP, ascent) kernel launches of one L1 window: a forward
    per chunk and per MCI candidate, no VJP, one ascent."""
    return l1_num_loop + 4, 0, 1


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=20, trials=7) -> float:
    """Median over trials of the mean time per call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def _device_ms(fn, reps=100, trials=5) -> float:
    """Device time per call with the host out of the way: ``reps`` calls
    captured in one CUDA graph (which also shows the call allocates through
    torch only, never synchronises and reads nothing back), replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def _profile(fn):
    """Run ``fn`` under torch.profiler. Returns (fn's result, {device
    activity name: (count, total device microseconds)}): kernels, memsets
    and copies as the card saw them (empty if ``fn`` launched nothing).
    CUDA activity alone records the device events that a trace with the
    CPU's ops beside them records (7,706-7,707 of 7,707 launches in
    tools/profile_cost.py on an H100 host) in about half the
    post-processing time (2 s against 4-5 s); with the CPU's on, one such
    run lost 167 of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, _activity(prof)


# the CUDA runtime and driver calls that issue work to the card from the
# host: a kernel launch or a graph launch (one cudaGraphLaunch replays a
# whole captured step)
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                    "cudaGraphLaunch", "cuGraphLaunch")


class _Per(dict):
    """{device activity name: (count, total device microseconds)}, in
    ``host`` the host-issued launches ({API name: count}, HOST_LAUNCH_APIS)
    and in ``copies`` the host-issued copies (cudaMemcpy*)."""

    host: dict
    copies: int

    @property
    def launches(self) -> int:
        """Host-issued launches: kernel launches and graph launches."""
        return sum(self.host.values())


def _profile_pure(fn, tries=3):
    """``_profile`` of a call that changes no state, with the splat counts
    set to 0 just before it, profiled again (``tries`` times in all) while
    the profiler recorded no device activity at all: two runs have
    recorded none around an ascent kernel that the counters saw launched
    (PERF.md section 6), and the next try recorded it."""
    for _ in range(tries):
        _reset_counts()
        out, per = _profile(fn)
        if per:
            break
    return out, per


def _activity(prof):
    """The device activity of a finished torch.profiler run, by name, with
    the host-issued launches beside it (_Per)."""
    from torch.autograd import DeviceType

    per = _Per()
    per.host, per.copies = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            per[e.key] = (e.count, float(us))
        elif e.key.startswith(HOST_LAUNCH_APIS):
            per.host[e.key] = per.host.get(e.key, 0) + e.count
        elif e.key.startswith("cudaMemcpy"):
            per.copies += e.count
    return per


def _matching(per, *words):
    """(count, total us) of the profiled device activities whose name holds
    every one of ``words``."""
    hit = [v for k, v in per.items() if all(w in k for w in words)]
    return sum(c for c, _ in hit), sum(us for _, us in hit)


# the hand kernels whose launches the wrappers count, by their names on the
# card: forward, VJP, ascent, sym_eig (any n)
HAND_KERNELS = ("splat_fwd_kernel", "splat_vjp_kernel", "splat_ascent_kernel",
                "sym_eig_kernel")


def _seen(per) -> tuple:
    """How many of each of HAND_KERNELS the profiler saw run on the card."""
    return tuple(_matching(per, k)[0] for k in HAND_KERNELS)


def _hand_counts() -> tuple:
    """The wrappers' counts of HAND_KERNELS so far (sym_eig summed over n),
    each graph replay's capture-time counts included."""
    return (*_counts(), sum(_eig_counts().values()))


def _kernel_events(n, seed):
    """Events as the main path makes them: mostly in the image, some up to
    3 px outside, some parked far away, +-inf from the DPose warp at z~0,
    and weight-0 (invalid) events."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-3, W + 2, n), rng.uniform(-3, H + 2, n)], 1)
    w = np.ones(n)
    kind = rng.random(n)
    w[kind < 0.15] = 0.0
    far = (kind >= 0.15) & (kind < 0.2)
    xy[far] = rng.choice([-1e6, 1e6], (far.sum(), 2))
    xy[(kind >= 0.2) & (kind < 0.215), 0] = np.inf
    xy[(kind >= 0.215) & (kind < 0.23), 1] = -np.inf
    w[(kind >= 0.2) & (kind < 0.23)] = 0.0
    w[(kind >= 0.23) & (kind < 0.26)] = -1.0
    return (torch.tensor(xy, dtype=torch.float32, device="cuda"),
            torch.tensor(w, dtype=torch.float32, device="cuda"))


def _se2_events(n, seed):
    """Unwarped events as the contrast-maximization ascent sees them: in the
    image, times relative to the end of a 12 ms window, 15% invalid, and a
    flow that moves an event by up to ~3 px."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1)
    t = np.sort(rng.uniform(-0.012, 0.0, n))
    valid = rng.random(n) < 0.85
    return (torch.tensor(xy, dtype=torch.float32, device="cuda"),
            torch.tensor(t, dtype=torch.float32, device="cuda"),
            torch.tensor(valid, device="cuda"),
            torch.tensor([1.5, 220.0, -130.0], device="cuda"))


def _held(got, ref, tol, what):
    """Max abs error of ``got`` over ``ref``'s finite entries; raises if the
    two are not finite in the same places or differ by more than
    tol * max|ref|."""
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin):
        raise RuntimeError(f"{what}: finiteness differs from the plain version")
    err = float((got[fin] - ref[fin]).abs().max())
    scale = float(ref[fin].abs().max())
    if not err <= tol * scale:
        raise RuntimeError(f"{what}: max abs {err} > {tol} * {scale}")
    return err


def _bits_equal(a, b) -> bool:
    """The same structure of tensors, bit for bit (a NaN equal to the same
    NaN)."""
    from eorb_slam_tpu_torch import _graphs

    la, lb = [], []
    if _graphs._flatten(a, la, "a") != _graphs._flatten(b, lb, "b"):
        return False
    bits = lambda t: t.reshape(-1).view(torch.uint8)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def _bound(n, n_active, se2, vjp):
    """(bound ms, "bytes" | "operations"): each input read once, each output
    written once, over the card's memory rate, against the operations of
    the ``n_active`` events that reach the image over its f32 rate."""
    events = (8 + 4 + 1) * n + 12 if se2 else (8 + 4) * n   # xy, t, mask, params | xy, w
    if vjp:
        nbytes = 4 * H * W + events + (12 if se2 else 12 * n)
    else:
        nbytes = events + 4 * H * W
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = n_active * (VJP_OPS if vjp else FWD_OPS) / F32_FLOPS
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _contrast_grad(splat_fn, params):
    """d(variance of the image)/dparams, as contrast_max._contrast forms it."""
    p = params.clone().requires_grad_(True)
    img = splat_fn(p)
    (g,) = torch.autograd.grad(torch.mean((img - torch.mean(img)) ** 2), p)
    return g


def check_kernel():
    """Both kernels, both forms, against their plain versions at every N;
    then their times. Returns one row per N."""
    from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable, warp_se2
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    center = (W / 2.0, H / 2.0)
    cfg = (H, W, SIGMA, TRUNC)
    rows = []
    for n in KERNEL_NS:
        # ---- identity form: forward, VJP (g_xy, g_w), determinism
        xy, w = _kernel_events(n, seed=n)
        ref = _splat_gauss_separable(xy, w, *cfg)
        got = hs.splat(xy, w, *cfg)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"N={n}: kernel output not finite")
        err = _held(got, ref, FWD_TOL, f"N={n} forward")
        g = torch.randn(H, W, device="cuda", generator=torch.Generator("cuda").manual_seed(n))
        xk, wk = xy.clone().requires_grad_(True), w.clone().requires_grad_(True)
        img_k = hs.splat(xk, wk, *cfg)
        gk = torch.autograd.grad(img_k, (xk, wk), g, retain_graph=True)
        gk2 = torch.autograd.grad(img_k, (xk, wk), g, retain_graph=True)
        xp, wp = xy.clone().requires_grad_(True), w.clone().requires_grad_(True)
        gp = torch.autograd.grad(_splat_gauss_separable(xp, wp, *cfg), (xp, wp), g)
        gerr = [_held(a, b, GRAD_TOL, f"N={n} VJP g_{name}")
                for a, b, name in zip(gk, gp, ("xy", "w"))]
        if not _bits_equal(gk, gk2):
            raise RuntimeError(f"N={n}: two VJP calls differ")
        if not _bits_equal(got, hs.splat(xy, w, *cfg)):
            raise RuntimeError(f"N={n}: two forward calls differ")

        # ---- SE2 form: forward, dL/dparams through the contrast, determinism
        sxy, st, sv, sp = _se2_events(n, seed=n + 1)
        sref = hs._splat_se2_plain(sxy, st, sv, sp, center, *cfg)
        sgot = hs.splat_se2(sxy, st, sv, sp, center, *cfg)
        sscale = float(sref.abs().max())
        n_flip = int(((sgot - sref).abs() > FWD_TOL * sscale).sum())
        serr = _held(sgot, sref, FWD_TOL, f"N={n} SE2 forward ({n_flip} px over: "
                                           f"tap flips if ~{np.exp(-3.125):.3f})")
        if not _bits_equal(sgot, hs.splat_se2(sxy, st, sv, sp, center, *cfg)):
            raise RuntimeError(f"N={n}: two SE2 forward calls differ")
        pk = _contrast_grad(lambda p: hs.splat_se2(sxy, st, sv, p, center, *cfg), sp)
        pp = _contrast_grad(lambda p: hs._splat_se2_plain(sxy, st, sv, p, center, *cfg), sp)
        perr = _held(pk, pp, GRAD_TOL, f"N={n} SE2 VJP dL/dparams")
        sq = sp.clone().requires_grad_(True)
        img_s = hs.splat_se2(sxy, st, sv, sq, center, *cfg)
        d1, = torch.autograd.grad(img_s, sq, g, retain_graph=True)
        d2, = torch.autograd.grad(img_s, sq, g, retain_graph=True)
        if not _bits_equal(d1, d2):
            raise RuntimeError(f"N={n}: two SE2 VJP calls differ: {d1} {d2}")

        # ---- times: CUDA events around eager calls of the wrappers (host
        # dispatch included; the VJP also as the main path reaches it, through
        # torch.autograd.grad), device only (graph replay), plain versions
        def dense_vjp():
            q = sp.clone().requires_grad_(True)
            out = _splat_gauss_separable(
                warp_se2(sxy, st, q, sxy.new_tensor(center)), sv.to(torch.float32), *cfg)
            return torch.autograd.grad(out, q, g)

        swarped = warp_se2(sxy, st, sp, sxy.new_tensor(center))
        order = [
            ("fwd_ms", lambda: hs.splat(xy, w, *cfg)),
            ("fwd_plain_ms", lambda: _splat_gauss_separable(xy, w, *cfg)),
            ("fwd_se2_ms", lambda: hs.splat_se2(sxy, st, sv, sp, center, *cfg)),
            ("fwd_se2_plain_ms", lambda: hs._splat_se2_plain(sxy, st, sv, sp, center, *cfg)),
            ("vjp_ms", lambda: hs._vjp_cuda(g, xy, None, w, None, (0.0, 0.0), *cfg,
                                            need_xy=True, need_w=True)),
            ("vjp_autograd_ms",
             lambda: torch.autograd.grad(img_k, (xk, wk), g, retain_graph=True)),
            ("vjp_plain_ms", lambda: hs._splat_vjp_plain(g, xy, w, *cfg)),
            ("vjp_se2_ms", lambda: hs._vjp_cuda(g, sxy, st, sv, sp, center, *cfg)),
            ("vjp_se2_autograd_ms",
             lambda: torch.autograd.grad(img_s, sq, g, retain_graph=True)),
            ("vjp_se2_plain_ms", lambda: hs._splat_se2_vjp_plain(g, sxy, st, sv, sp, center, *cfg)),
            ("vjp_se2_dense_ms", dense_vjp),
        ]
        t1 = {k: _time_ms(f) for k, f in order}
        t2 = {k: _time_ms(f) for k, f in reversed(order)}
        row = {k: float(np.mean([t1[k], t2[k]])) for k in t1}
        row["fwd_dev_ms"] = _device_ms(lambda: hs.splat(xy, w, *cfg))
        row["fwd_se2_dev_ms"] = _device_ms(lambda: hs.splat_se2(sxy, st, sv, sp, center, *cfg))
        row["vjp_dev_ms"] = _device_ms(lambda: hs._vjp_cuda(
            g, xy, None, w, None, (0.0, 0.0), *cfg, need_xy=True, need_w=True))
        row["vjp_se2_dev_ms"] = _device_ms(lambda: hs._vjp_cuda(g, sxy, st, sv, sp, center, *cfg))

        # the kernels' own time by name, and what else one call enqueues
        def both():
            for _ in range(20):
                hs.splat_se2(sxy, st, sv, sp, center, *cfg)
                hs._vjp_cuda(g, sxy, st, sv, sp, center, *cfg)
        _, per = _profile(both)
        prof_us = {k: _matching(per, k)[1] / 20 for k in
                   ("splat_fwd_kernel", "splat_fwd_finish_kernel", "splat_vjp_kernel",
                    "sum_partials_kernel", "Memset")}
        if min(prof_us["splat_fwd_kernel"], prof_us["splat_vjp_kernel"]) <= 0:
            raise RuntimeError(f"profiler saw no splat kernel time: {sorted(per)}")

        near = lambda p, v: int((v & (p[:, 0] > -3.5) & (p[:, 0] < W + 3.5)
                                 & (p[:, 1] > -3.5) & (p[:, 1] < H + 3.5)).sum())
        act, sact = near(xy, w != 0), near(swarped, sv)
        row.update(
            n=n, fwd_err=err, fwd_ref=float(ref.abs().max()), fwd_se2_err=serr,
            fwd_se2_ref=sscale, vjp_xy_err=gerr[0], vjp_w_err=gerr[1],
            vjp_se2_err=perr, vjp_se2_ref=float(pp.abs().max()), prof_us=prof_us,
            fwd_bound=_bound(n, act, False, False), fwd_se2_bound=_bound(n, sact, True, False),
            vjp_bound=_bound(n, act, False, True), vjp_se2_bound=_bound(n, sact, True, True))
        _log(f"splat N={n} identity: fwd max abs {err:.3e} (max|ref| {row['fwd_ref']:.3f}, "
             f"tol {FWD_TOL}x), VJP max abs xy {gerr[0]:.3e} w {gerr[1]:.3e} (tol "
             f"{GRAD_TOL}x), two forward and two VJP calls bit-equal | ms by events / "
             f"device only / plain / bound: fwd {row['fwd_ms']:.4f} / {row['fwd_dev_ms']:.5f} / "
             f"{row['fwd_plain_ms']:.4f} / {row['fwd_bound'][0]:.6f}; VJP "
             f"{row['vjp_ms']:.4f} (through autograd.grad {row['vjp_autograd_ms']:.4f}) / "
             f"{row['vjp_dev_ms']:.5f} / {row['vjp_plain_ms']:.4f} / "
             f"{row['vjp_bound'][0]:.6f}")
        _log(f"splat N={n} SE2: fwd max abs {serr:.3e} (max|ref| {sscale:.3f}, {n_flip} "
             f"px over tol), dL/dparams max abs {perr:.3e} (max|ref| "
             f"{row['vjp_se2_ref']:.3e}), forward and VJP bit-equal twice | fwd "
             f"{row['fwd_se2_ms']:.4f} / {row['fwd_se2_dev_ms']:.5f} / "
             f"{row['fwd_se2_plain_ms']:.4f} / {row['fwd_se2_bound'][0]:.6f}; VJP {row['vjp_se2_ms']:.4f} (through "
             f"autograd.grad {row['vjp_se2_autograd_ms']:.4f}) / "
             f"{row['vjp_se2_dev_ms']:.5f} / {row['vjp_se2_plain_ms']:.4f} (dense "
             f"autograd {row['vjp_se2_dense_ms']:.4f}) / {row['vjp_se2_bound'][0]:.6f} | "
             f"profiler us per call: { {k: round(v, 3) for k, v in prof_us.items()} }"
             )
        rows.append(row)

    # non-finite events: a NaN coordinate poisons the whole image in the
    # separable form, and the kernel does the same; the VJP is NaN exactly
    # where autograd through the separable form is not finite
    xy = torch.tensor([[10.0, 10.0], [float("nan"), 5.0], [float("inf"), 7.0],
                       [30.0, float("-inf")], [50.0, 60.0], [70.0, 80.0]], device="cuda")
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, float("inf"), float("nan")], device="cuda")
    got = hs.splat(xy, w, *cfg)
    ref = _splat_gauss_separable(xy, w, *cfg)
    if not (torch.isnan(got).all() and torch.isnan(ref).all()):
        raise RuntimeError("NaN event: kernel and plain version disagree")
    g = torch.randn(H, W, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    xk, wk = xy.clone().requires_grad_(True), w.clone().requires_grad_(True)
    gk = torch.autograd.grad(hs.splat(xk, wk, *cfg), (xk, wk), g)
    xp, wp = xy.clone().requires_grad_(True), w.clone().requires_grad_(True)
    gp = torch.autograd.grad(_splat_gauss_separable(xp, wp, *cfg), (xp, wp), g)
    for a, b, name in zip(gk, gp, ("xy", "w")):
        _held(a, b, GRAD_TOL, f"non-finite events, VJP g_{name}")
        if not torch.isnan(a[~torch.isfinite(b)]).all():
            raise RuntimeError(f"non-finite events, VJP g_{name}: not NaN")
    _log(f"non-finite events: image NaN in both; VJP NaN in the plain version's "
         f"{int((~torch.isfinite(gp[0])).sum())} + {int((~torch.isfinite(gp[1])).sum())} places")
    return rows


class _PlainPair:
    """Within it the pair's CUDA launchers are their plain versions, so
    contrast_max._ascent_loop on CUDA tensors runs the plain ascent on the
    card (the yardstick's plain_ms)."""

    def __enter__(self):
        from eorb_slam_tpu_torch.ops import hopper_splat as hs

        self.saved = hs._splat_cuda, hs._vjp_cuda
        hs._splat_cuda, hs._vjp_cuda = hs._splat_se2_plain, hs._splat_se2_vjp_plain
        return self

    def __exit__(self, *exc):
        from eorb_slam_tpu_torch.ops import hopper_splat as hs

        hs._splat_cuda, hs._vjp_cuda = self.saved


def _ascents_agree(sg, sc, what):
    """Two ascents' traces ((iters + 1, 4) float64: params and contrast of
    the start and of every trial point; a step is taken where the contrast
    rises) held step by step: params (in the ascent's scale) and contrasts
    within ASCENT_TOL relative until the two first decide differently, and
    that decision must be a tie, the trial within ASCENT_TIE (relative) of
    the best on both sides. Returns (the step where they part or None, the
    tie, the largest relative difference before it)."""
    unit = np.asarray([2.0 / max(H, W), 1.0, 1.0])   # the ascent's scale
    best_g, best_c, part, tie, err = sg[0, 3], sc[0, 3], None, 0.0, 0.0
    for k, (rg, rc) in enumerate(zip(sg, sc)):
        e_p = float(np.abs((rg[:3] - rc[:3]) / unit).max()
                    / max(float(np.abs(rc[:3] / unit).max()), 1e-30))
        e_c = abs(rg[3] - rc[3]) / abs(rc[3])
        err = max(err, e_p, e_c)
        if e_p > ASCENT_TOL or e_c > ASCENT_TOL:
            raise RuntimeError(f"{what}: step {k} before the two part: params {rg[:3]} / "
                               f"{rc[:3]}, contrast {rg[3]} / {rc[3]}")
        if k == 0:
            continue
        up_g, up_c = rg[3] > best_g, rc[3] > best_c
        if up_g != up_c:
            part = k
            tie = max(abs(rg[3] - best_g) / abs(best_g), abs(rc[3] - best_c) / abs(best_c))
            break
        best_g, best_c = (rg[3] if up_g else best_g), (rc[3] if up_c else best_c)
    if part is not None and tie > ASCENT_TIE:
        raise RuntimeError(f"{what}: the two decide step {part} differently, not at a tie: "
                           f"{tie:.3e} of the contrast > {ASCENT_TIE}")
    return part, tie, err


def _ascent_bound(n, n_active, n_grad):
    """(bound ms, "bytes" | "operations") of one ascent call: its inputs
    read once (xy, t and the mask, 13 bytes an event, and params0) and its
    outputs written once (5 floats and the trace), against the f32
    operations of CM_ITERS + 1 splats and n_grad gathers of the n_active
    events that reach the image."""
    nbytes = 13 * n + 12 + 20 + 16 * (CM_ITERS + 1)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = n_active * ((CM_ITERS + 1) * FWD_OPS + n_grad * VJP_OPS) / F32_FLOPS
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_kernel_ascent():
    """The ascent kernel (hopper_splat.splat_ascent_se2, as
    contrast_max.maximize_rt2d calls it on the card) against
    contrast_max._ascent_loop on the card (the pair's kernels) at both of
    its call sites' shapes, ASCENT_NS, through the two traces: held step by
    step until they first decide differently, which must be a tie; the SE2
    image at the kernel's own params against the plain version at FWD_TOL
    of max, and its contrast against the kernel's best; two calls the same
    bits; a NaN event the loop's result; one launch of the kernel and none
    of the pair's or of torch's cos / sin; the start contrast within one
    f32 ulp of the f64 variance of the forward kernel's image at the start.
    Then its times: device only (graph replay), by events, the loop on the
    card by events, the plain version (the loop through the pair's plain
    versions on the card), and the bound; the empty window's device time
    (N = 0 and 16: the design's floor) and the kernel's registers and
    shared memory. Returns one row per N."""
    from eorb_slam_tpu_torch.event import contrast_max as cm
    from eorb_slam_tpu_torch.event.tensorize import warp_se2
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    t_phase = time.perf_counter()
    center = (W / 2.0, H / 2.0)
    rows = []
    for n in ASCENT_NS:
        xy, t, valid, _ = _se2_events(n, seed=3)
        z = torch.zeros(3, device="cuda")
        kernel = lambda trace=None: cm._ascent_kernel(xy, t, valid, H, W, z, CM_ITERS, SIGMA,
                                                      1.0, trace=trace)
        loop = lambda trace=None: cm._ascent_loop(xy, t, valid, H, W, z, CM_ITERS, SIGMA, 1.0,
                                                  trace=trace)
        tk, tk2, tl = (torch.zeros((CM_ITERS + 1, 4), device="cuda") for _ in range(3))
        (p, best, c0), per = _profile_pure(lambda: kernel(tk))
        counts = _counts()
        p2, best2, c02 = kernel(tk2)
        loop(tl)
        torch.cuda.synchronize()
        sg, sc = tk.cpu().double().numpy(), tl.cpu().double().numpy()
        part, tie, step_err = _ascents_agree(sg, sc, f"ascent kernel N={n} against the loop")
        if not _bits_equal((tk, p, best, c0), (tk2, p2, best2, c02)):
            raise RuntimeError(f"N={n}: two ascent kernel calls differ")
        n_asc = _matching(per, "splat_ascent_kernel")[0]
        n_pair = _matching(per, "splat_fwd_kernel")[0] + _matching(per, "splat_vjp_kernel")[0]
        trig = _matching(per, "cos_kernel")[0] + _matching(per, "sin_kernel")[0]
        if counts != (0, 0, 1) or n_asc != 1 or n_pair or trig:
            raise RuntimeError(f"N={n}: the ascent launched {counts} (forward, VJP, ascent; "
                               f"profiler: {sorted(per)})")
        # the start contrast is the variance of the forward kernel's image at
        # the start (the same fixed-point sums, moments in f64): within one
        # f32 ulp of the f64 variance of that image
        img0 = hs.splat_se2(xy, t, valid, z, center, H, W, SIGMA, TRUNC).double()
        mean0 = img0.sum() / img0.numel()
        var0 = float((img0 * img0).sum() / img0.numel() - mean0 * mean0)
        c0_ulps = abs(float(c0) - var0) / float(np.spacing(np.float32(var0)))
        if not c0_ulps <= 1.0:
            raise RuntimeError(f"N={n}: the kernel's start contrast {float(c0)!r} is "
                               f"{c0_ulps:.2f} f32 ulps from the f64 variance {var0!r} of "
                               f"the forward kernel's image")
        # the image at the kernel's own params, kernel and plain, and its contrast
        img = hs.splat_se2(xy, t, valid, p, center, H, W, SIGMA, TRUNC)
        ref = hs._splat_se2_plain(xy, t, valid, p, center, H, W, SIGMA, TRUNC)
        err = _held(img, ref, FWD_TOL, f"N={n} SE2 image at the ascent kernel's params")
        c_ref = float(cm._variance(ref))
        if not abs(float(best) - c_ref) <= ASCENT_TOL * abs(c_ref):
            raise RuntimeError(f"N={n}: the kernel's best contrast {float(best)} is not the "
                               f"contrast at its params {c_ref}")
        # the work this run's data needed: events that reach the image at the
        # end, a gradient at the start and after every step taken but the last
        reach = warp_se2(xy, t, p, xy.new_tensor(center))
        act = int((valid & (reach[:, 0] > -TRUNC - 1) & (reach[:, 0] < W + TRUNC + 1)
                   & (reach[:, 1] > -TRUNC - 1) & (reach[:, 1] < H + TRUNC + 1)).sum())
        taken = [sg[k, 3] > sg[:k, 3].max() for k in range(1, CM_ITERS + 1)]
        n_grad = 1 + sum(taken[:-1])
        with _PlainPair():
            plain_ms = _time_ms(loop, reps=2, trials=3)
        row = dict(
            n=n, active=act, grads=n_grad, part=part, tie=tie, step_err=step_err, err=err,
            c0_ulps=c0_ulps, smem_bytes=hs.ascent_layout(n, H, W).smem_bytes,
            ref=float(ref.abs().max()), launches=counts, prof_launches=n_asc,
            prof_us=_matching(per, "splat_ascent_kernel")[1],
            dev_ms=_device_ms(kernel, reps=10, trials=3), ms=_time_ms(kernel, reps=5, trials=3),
            loop_ms=_time_ms(loop, reps=3, trials=3), plain_ms=plain_ms,
            bound=_ascent_bound(n, act, n_grad))
        _log(f"ascent kernel N={n} ({act} events reach the image, {sum(taken)} of {CM_ITERS} "
             f"steps taken, {n_grad} gradients): against the loop on the card "
             + ("every step agrees" if part is None else
                f"the steps agree until step {part}, a tie ({tie:.2e} of the contrast)")
             + f", max rel {step_err:.2e} (tol {ASCENT_TOL}); contrast {float(c0):.6f} -> "
             f"{float(best):.6f} (the start {c0_ulps:.2f} f32 ulps from the f64 variance of "
             f"the forward kernel's image); the SE2 image at its params max abs {err:.3e} (max|ref| "
             f"{row['ref']:.3f}, tol {FWD_TOL}x); the same bits twice; launches {counts} "
             f"(forward, VJP, ascent), profiler: splat_ascent_kernel x{n_asc} "
             f"{row['prof_us']:.1f} us | ms device only / by events / loop on the card / "
             f"plain (the loop through the plain pair) / bound ({row['bound'][1]}): "
             f"{row['dev_ms']:.4f} / {row['ms']:.4f} / {row['loop_ms']:.4f} / "
             f"{row['plain_ms']:.4f} / {row['bound'][0]:.6f}")
        rows.append(row)

    # the design's own floor: 41 serial steps of barriers on an empty
    # window (no event, and one block's worth); and the kernel as compiled
    floor = {}
    for n in (0, 16):
        xy, t, valid, _ = _se2_events(n, seed=3)
        z = torch.zeros(3, device="cuda")
        floor[n] = 1e3 * _device_ms(lambda: cm._ascent_kernel(xy, t, valid, H, W, z, CM_ITERS,
                                                              SIGMA, 1.0), reps=10, trials=3)
    attrs = hs.ascent_attrs()
    for row in rows:
        row.update(floor_us=floor, **attrs)
    _log(f"ascent kernel: {attrs['registers']} registers and {attrs['local_bytes']} bytes of "
         f"local memory a thread, {attrs['threads']} threads a block, dynamic shared memory a "
         f"block " + ", ".join(f"{r['smem_bytes']} at N={r['n']}" for r in rows)
         + f" | the empty window, device us: N=0 {floor[0]:.1f}, N=16 {floor[16]:.1f} "
         f"(device us at " + ", ".join(f"N={r['n']} {1e3 * r['dev_ms']:.1f}" for r in rows)
         + ")")

    # a NaN coordinate poisons every image: the contrast is NaN and no step
    # is taken, as in the loop
    xy, t, valid, _ = _se2_events(4096, seed=9)
    xy[7, 1] = float("nan")
    z = torch.zeros(3, device="cuda")
    got = cm._ascent_kernel(xy, t, valid, H, W, z, 5, SIGMA, 1.0)
    ref = cm._ascent_loop(xy, t, valid, H, W, z, 5, SIGMA, 1.0)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[0], z)
            and all(torch.isnan(x).item() for x in (*got[1:], *ref[1:]))):
        raise RuntimeError(f"NaN event: kernel {got}, loop {ref}")
    _log(f"ascent kernel, NaN event: params stay at the start, contrasts NaN, as in the loop; "
         f"phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def time_ascent():
    """contrast_max.maximize_rt2d at the main path's shape, N = MAIN_N: the
    kernel (one launch) and the loop it replaces on the card
    (contrast_max._ascent_loop through the pair's kernels) in one call, in
    turns (loop, kernel, kernel, loop), by the host clock around
    synchronised calls; every launch of each, by name."""
    from eorb_slam_tpu_torch.event import contrast_max
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    xy, t, valid, _ = _se2_events(MAIN_N, seed=3)
    z = torch.zeros(3, device="cuda")
    runs = {"kernel": lambda: contrast_max.maximize_rt2d(xy, t, valid, H, W, iters=CM_ITERS,
                                                          sigma=SIGMA),
            "loop": lambda: contrast_max._ascent_loop(xy, t, valid, H, W, z, CM_ITERS, SIGMA,
                                                       1.0)}
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    walls = {k: [] for k in runs}
    for k in ("loop", "kernel", "kernel", "loop"):
        for _ in range(3):
            t0 = time.perf_counter()
            runs[k]()
            torch.cuda.synchronize()
            walls[k].append(1e3 * (time.perf_counter() - t0))
    prof = {}
    for k, fn in runs.items():
        (p, c, c0), per = _profile_pure(fn)
        prof[k] = (per, _counts(), p, c, c0)
        if not (torch.isfinite(p).all() and float(c) >= float(c0)):
            raise RuntimeError(f"the {k} ascent went wrong: {p} {c0} -> {c}")
    # control: the plain SE2 forward launches torch's cos and sin kernels by those names
    _, plain_per = _profile_pure(lambda: hs._splat_se2_plain(
        xy, t, valid, z, (W / 2.0, H / 2.0), H, W, SIGMA, TRUNC))
    if not (_matching(plain_per, "cos_kernel")[0] and _matching(plain_per, "sin_kernel")[0]):
        raise RuntimeError(f"torch's cos/sin kernels not recognised by name: {sorted(plain_per)}")
    out = {}
    for k, (per, counts, p, c, c0) in prof.items():
        launches = sum(cnt for cnt, _ in per.values())
        dev_us = sum(us for _, us in per.values())
        trig = _matching(per, "cos_kernel")[0] + _matching(per, "sin_kernel")[0]
        by = {w: _matching(per, w)[0] for w in ("splat_ascent_kernel", "splat_fwd_kernel",
                                                "splat_vjp_kernel")}
        _log(f"maximize_rt2d N={MAIN_N} iters={CM_ITERS}, {k}: {np.median(walls[k]):.3f} ms per "
             f"call (host clock, synchronised; {len(walls[k])} calls in two turns "
             f"{min(walls[k]):.3f}-{max(walls[k]):.3f}), {launches} device launches per call, "
             f"{dev_us / 1e3:.3f} ms of device time; {by}, torch cos/sin kernels x{trig}; "
             f"counted (forward, VJP, ascent) {counts}; contrast {float(c0):.6f} -> {float(c):.6f}")
        # the counters are exact; the profiler may drop a record or two
        want = (0, 0, 1) if k == "kernel" else (1 + CM_ITERS, CM_ITERS, 0)
        if counts != want or trig or (k == "kernel" and by["splat_ascent_kernel"] != 1):
            raise RuntimeError(f"the {k} ascent launched {counts} (expected {want}), "
                               f"profiler {by}, cos/sin x{trig}")
        out[k] = dict(ms=float(np.median(walls[k])), launches=launches, device_ms=dev_us / 1e3)
    return out


def synth_stream(seconds, rate, seed):
    """Numpy event stream in the manner of bench.py (time_event_app): a 3D
    point cloud seen by a camera moving and yawing, projected with the
    synth_ev_only camera, with pixel noise and random polarity. ``rate`` is
    the rate of the in-image events that come out."""
    fx, fy, cx, cy = CAM
    rng = np.random.default_rng(seed)
    pts = np.concatenate(
        [rng.uniform(-2.2, 2.2, (300, 1)), rng.uniform(-1.6, 1.6, (300, 1)),
         rng.uniform(2.5, 6.0, (300, 1))], axis=1)

    def pose(t):
        pos = np.asarray([0.4 * t, 0.1 * np.sin(1.5 * t), 0.08 * t])
        a = 0.06 * np.sin(0.8 * t)                       # rotation about y
        R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ pos
        return T

    def draw(n):
        ts = np.sort(rng.uniform(0, seconds, n))
        idx = rng.integers(0, len(pts), n)
        # one pose per 2 ms bin; ts is sorted, so each bin is a slice
        n_bins = max(int(seconds * 500), 1)
        bins = np.clip((ts / seconds * n_bins).astype(int), 0, n_bins - 1)
        edges = np.searchsorted(bins, np.arange(n_bins + 1))
        pc = np.empty((n, 3))
        for k in range(n_bins):
            T = pose((k + 0.5) * seconds / n_bins)
            sl = slice(edges[k], edges[k + 1])
            pc[sl] = pts[idx[sl]] @ T[:3, :3].T + T[:3, 3]
        ev = np.zeros((n, 4))
        ev[:, 0] = ts
        ev[:, 1] = fx * pc[:, 0] / pc[:, 2] + cx
        ev[:, 2] = fy * pc[:, 1] / pc[:, 2] + cy
        ev[:, 1:3] += rng.normal(0, 0.25, (n, 2))
        ev[:, 3] = rng.choice([-1.0, 1.0], n)
        inb = (ev[:, 1] >= 0) & (ev[:, 1] < W) & (ev[:, 2] >= 0) & (ev[:, 2] < H)
        return ev[inb]

    frac = len(draw(20000)) / 20000.0
    return draw(int(round(seconds * rate / frac)))


def check_slice_small():
    """One window of a small stream on the card against the port's CPU path
    (which the CPU tests hold against the JAX package)."""
    from eorb_slam_tpu_torch.event import builder as eb

    ev = synth_stream(0.02, RATE, seed=11)
    cfg = dict(SLICE_CFG, l1_chunk_size=1000, cm_iters=5)
    cam = torch.tensor([*CAM, 0, 0, 0, 0, 0])
    out = {}
    for dev in ("cpu", "cuda"):
        b = eb.EventWindowBuilder(eb.BuilderConfig(**cfg), cam, device=dev)
        b.feed(ev)
        pi = b.step_window()
        if pi is None:
            raise RuntimeError("small stream gave no window")
        out[dev] = (pi.img.cpu().numpy(), pi.se2_params.cpu().numpy())
    (ic, mc), (ig, mg) = out["cpu"], out["cuda"]
    if int(mc[0]) != int(mg[0]):
        raise RuntimeError(f"winning candidate differs: cpu {mc[0]} cuda {mg[0]}")
    if not np.allclose(mg[1:5], mc[1:5], rtol=1e-3):
        raise RuntimeError(f"candidate scores differ: {mc[1:5]} vs {mg[1:5]}")
    diff = np.abs(ig - ic)
    # a tap crossing the 2.5 px truncation radius may flip on a last-ulp
    # difference of a warped coordinate: a few pixels, one tap each
    n_bad = int((diff > 1e-3).sum())
    if n_bad > 12 or diff.max() > np.exp(-3.125):
        raise RuntimeError(f"MCI differs: {n_bad} px > 1e-3, max {diff.max()}")
    fin = np.isfinite(mc[1:5])
    rel = np.abs(mg[1:5][fin] - mc[1:5][fin]) / np.abs(mc[1:5][fin])
    _log(f"slice, one small window, cuda vs cpu: best {int(mg[0])}, MCI max abs "
         f"{diff.max():.3e} ({n_bad} px > 1e-3), scores max rel {rel.max():.3e}")


def run_slice():
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.ops import frontend

    cfg = eb.BuilderConfig(**SLICE_CFG)
    per_window = _window_launches(cfg.l1_num_loop)
    ev = synth_stream(WARM_S + RUN_S, RATE, seed=5)
    t_split = WARM_S
    warm, run = ev[ev[:, 0] < t_split], ev[ev[:, 0] >= t_split]
    _log(f"stream: {len(ev)} events over {ev[-1, 0] - ev[0, 0]:.3f} s "
         f"({len(run) / RUN_S / 1e6:.3f} M ev/s in the timed part)")
    b = eb.EventWindowBuilder(cfg, torch.tensor([*CAM, 0, 0, 0, 0, 0]),
                              device="cuda")

    def drive(events, record):
        b.feed(events)
        while (pi := b.step_window()) is not None:
            feats = frontend.extract(pi.img * 255.0, max_kp=MAX_KP)
            record.append((pi, torch.isfinite(pi.img).all(),
                           feats.valid.sum(), feats.xy.shape, pi.img.shape))

    warm_rec = []
    drive(warm, warm_rec)
    torch.cuda.synchronize()
    if not warm_rec:
        raise RuntimeError("warm-up produced no window")

    _reset_counts()
    rec = []
    t0 = time.perf_counter()
    drive(run, rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()

    n_win = len(rec)
    if n_win == 0:
        raise RuntimeError("the slice produced no window")
    if not all(bool(fin) for _, fin, _, _, _ in rec):
        raise RuntimeError("an MCI is not finite")
    n_kp = [int(k) for _, _, k, _, _ in rec]
    if min(n_kp) <= 0:
        raise RuntimeError(f"a window has no valid keypoint: {n_kp}")
    if any(s != (MAX_KP, 2) for _, _, _, s, _ in rec) or \
            any(s != (H, W) for _, _, _, _, s in rec):
        raise RuntimeError("unexpected output shapes")
    if counts != tuple(n_win * c for c in per_window):
        raise RuntimeError(f"{counts} forward, VJP and ascent launches for {n_win} "
                           f"windows, expected {per_window} per window")
    data_s = rec[-1][0].ts - warm_rec[-1][0].ts
    b._resolve_window_meta(block=True)
    _log(f"slice: {n_win} windows in {wall:.3f} s wall = {n_win / wall:.3f} "
         f"windows/s; {data_s:.4f} s of data -> real-time x {data_s / wall:.4f}; "
         f"keypoints per window min {min(n_kp)} median {int(np.median(n_kp))}; "
         f"forward, VJP and ascent launches {counts} ({per_window} per window); final "
         f"chunk size {b.chunk_size}; winners "
         f"{ {k: sum(int(r[0].se2_params[0]) == i for r in rec) for i, k in enumerate(eb.KINDS)} }")
    return dict(windows=n_win, wall_s=wall, data_s=data_s, launches=counts)


def _cam(device="cpu"):
    return torch.tensor([*CAM, 0, 0, 0, 0, 0], dtype=torch.float32, device=device)


FUSE_TABLES = ("kf_feat_lm", "obs_kf", "obs_feat", "obs_valid", "lm_valid",
               "lm_nobs", "lm_desc_pm1")


def _inject_duplicates(m: dict, a: int, b: int, n_simple: int = 8):
    """Edit a map (numpy arrays by field) so that keyframes ``a`` and ``b``
    hold duplicate landmarks: ``n_simple`` clones of landmarks both see, bound
    to b's features, and two groups whose candidate pairs tie exactly in
    descriptor distance. In each group landmarks L1, L2 (features of a, 1 px
    apart) both match, at distance 0, two features of b that share ONE
    landmark X: in the first group L1 and L2 outnumber X and win, so the tied
    pairs share the loser; in the second X outnumbers them and wins both, and
    both losers write its one free column. These are the repeated-index
    scatters of fuse_duplicates. Returns (map, [group]) with each group's
    landmarks ``l``, features ``fa`` / ``fb`` and ``x``."""
    m = {k: v.copy() for k, v in m.items()}
    rng = np.random.default_rng(7)
    free = list(np.flatnonzero(~m["lm_valid"])[::-1])
    in_a = {int(l): i for i, l in enumerate(m["kf_feat_lm"][a])
            if l >= 0 and m["kf_feat_valid"][a, i] and m["lm_valid"][l]}
    shared = [(int(l), in_a[int(l)], i) for i, l in enumerate(m["kf_feat_lm"][b])
              if l >= 0 and m["kf_feat_valid"][b, i] and int(l) in in_a]
    # the tie groups take the landmarks with the fewest observations (but 2
    # left once b's is dropped), so that X can outnumber them
    tied = sorted((e for e in shared[n_simple:] if m["lm_nobs"][e[0]] >= 3),
                  key=lambda e: m["lm_nobs"][e[0]])[:4]
    if len(shared) < n_simple or len(tied) < 4:
        raise RuntimeError(f"keyframes {a} and {b} share only {len(shared)} landmarks")

    def drop_obs(lm, kf, feat):
        col = np.flatnonzero(m["obs_valid"][lm] & (m["obs_kf"][lm] == kf)
                             & (m["obs_feat"][lm] == feat))
        m["obs_valid"][lm, col[:1]] = False
        m["lm_nobs"][lm] = m["obs_valid"][lm].sum()

    def new_landmark(pos, desc, obs):
        lm = free.pop()
        m["lm_pos"][lm], m["lm_desc_pm1"][lm] = pos, desc
        m["lm_valid"][lm], m["lm_first_kf"][lm] = True, obs[0][0]
        m["obs_valid"][lm] = False
        for c, (kf, feat) in enumerate(obs):
            m["obs_kf"][lm, c], m["obs_feat"][lm, c] = kf, feat
            m["obs_valid"][lm, c] = True
            m["kf_feat_lm"][kf, feat] = lm
        m["lm_nobs"][lm] = len(obs)
        return lm

    for lm, fa, fb in shared[:n_simple]:
        drop_obs(lm, b, fb)
        new_landmark(m["lm_pos"][lm] * (1 + 1e-3), m["lm_desc_pm1"][lm], [(b, fb)])
    other = int([k for k in np.flatnonzero(m["kf_valid"]) if k not in (a, b)][0])
    spare = list(np.flatnonzero(m["kf_feat_valid"][other] & (m["kf_feat_lm"][other] < 0)))
    P = m["obs_kf"].shape[1]
    groups = []
    for g in range(2):
        (l1, fa1, fb1), (l2, fa2, fb2) = tied[2 * g: 2 * g + 2]
        drop_obs(l1, b, fb1)
        drop_obs(l2, b, fb2)
        m["kf_xy"][a, fa2] = m["kf_xy"][a, fa1] + np.float32([1.0, 0.0])
        m["lm_pos"][l2] = m["lm_pos"][l1]
        d1, d2 = ((rng.integers(0, 2, 256) * 2 - 1).astype(np.int8) for _ in range(2))
        m["kf_desc_pm1"][a, fa1] = m["kf_desc_pm1"][b, fb1] = d1
        m["kf_desc_pm1"][a, fa2] = m["kf_desc_pm1"][b, fb2] = d2
        obs = [(b, fb1), (b, fb2)]
        if g == 1:      # one observation more than L1 and L2, one column free
            extra = int(max(m["lm_nobs"][l1], m["lm_nobs"][l2])) + 1 - len(obs)
            extra = min(extra, P - 1 - len(obs), len(spare))
            obs += [(other, int(spare.pop())) for _ in range(extra)]
        x = new_landmark(m["lm_pos"][l1], d1, obs)
        groups.append(dict(l=(l1, l2), fa=(fa1, fa2), fb=(fb1, fb2), x=x))
    return m, groups


def check_l2_small():
    """L2 on the card against the CPU: EventSlam runs on the CPU until it
    has a map, the map crosses to the card through convert.py, and one new
    frame's features are tracked (tracking.track_frame) and the map
    bundle-adjusted (local_mapping.local_ba) on both devices; then, with
    duplicates injected, fuse_duplicates, update_landmark_descriptors and
    local_ba with the refresh: every integer table and the descriptors
    equal."""
    from eorb_slam_tpu_torch import convert
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.geometry import camera
    from eorb_slam_tpu_torch.ops import frontend
    from eorb_slam_tpu_torch.slam import event_system, local_mapping, system, tracking

    ev = synth_stream(0.3, RATE, seed=13)
    cfg = eb.BuilderConfig(**dict(SLICE_CFG, l1_chunk_size=1000, cm_iters=5))
    slam = event_system.EventSlam(_cam(), cfg, max_kp=MAX_KP, device="cpu", **L2_KW)
    slam.builder.feed(ev)
    while not (slam.l2.state == system.OK and slam.l2.n_kf >= 3):
        pi = slam.builder.step_window()
        if pi is None:
            raise RuntimeError(f"L2 on the CPU built no map: {slam.stats}")
        slam._track_mci(pi)
    pi = slam.builder.step_window()
    if pi is None:
        raise RuntimeError("no window left for the L2 comparison")
    l2 = slam.l2
    feats = frontend.extract(pi.img * 255.0, max_kp=MAX_KP)
    frame = (camera.undistort_points(l2.cam, feats.xy), feats.octave,
             feats.desc_pm1, feats.valid)
    T_pred = l2.velocity @ l2.T_last
    kf_free = l2._ba_window()
    host_map = convert.map_state_to_numpy(l2.map)
    maps = {dev: convert.map_state_from_numpy(host_map, dev) for dev in ("cpu", "cuda")}
    track = {}
    for dev, m in maps.items():
        res = tracking.track_frame(m, _cam(dev), *(x.to(dev) for x in frame),
                                   T_pred.to(dev), img_w=W, img_h=H)
        track[dev] = (res.feat_lm.cpu().numpy(), res.Tcw.cpu().numpy(),
                      int(res.n_inliers))
    (lc, Tc, nc), (lg, Tg, ng) = track["cpu"], track["cuda"]
    agree = float((lc == lg).mean())
    dT = float(np.abs(Tg - Tc).max())

    def ba_cost(dtype, iters):
        """local_ba's (cost0, cost) on each device, the map cast to dtype."""
        out = {}
        for dev, m in maps.items():
            m = m._replace(kf_T=m.kf_T.to(dtype), lm_pos=m.lm_pos.to(dtype),
                           kf_xy=m.kf_xy.to(dtype))
            _, c0, c1 = local_mapping.local_ba(m, _cam(dev).to(dtype), kf_free.to(dev),
                                               iters=iters, refresh_desc=False)
            out[dev] = (float(c0), float(c1))
        rel = abs(out["cuda"][1] - out["cpu"][1]) / max(abs(out["cpu"][1]), 1e-12)
        return out, rel

    # f32 LM is not converged after the main path's 8 iterations on a young
    # map, and the two devices' last-bit differences send it down different
    # paths (1e-2 apart seen); run to convergence, and hold the 8-iteration
    # run in f64, where the devices must agree to rounding
    c32, dcost32 = ba_cost(torch.float32, BA_ITERS)
    cconv, dcost = ba_cost(torch.float32, BA_ITERS_CONVERGED)
    c64, dcost64 = ba_cost(torch.float64, BA_ITERS)
    _log(f"L2 cuda vs cpu from one map ({l2.n_kf} KFs, "
         f"{int(host_map['lm_valid'].sum())} landmarks): feat_lm equal on "
         f"{agree:.4f} of features (inliers cpu {nc} cuda {ng}); Tcw max abs "
         f"{dT:.3e}; BA cost f32 {BA_ITERS_CONVERGED} iters cpu "
         f"{cconv['cpu'][1]:.6f} cuda {cconv['cuda'][1]:.6f} rel diff {dcost:.3e}; "
         f"f64 {BA_ITERS} iters rel diff {dcost64:.3e}; f32 {BA_ITERS} iters cpu "
         f"{c32['cpu'][0]:.4f} -> {c32['cpu'][1]:.4f}, cuda {c32['cuda'][0]:.4f} -> "
         f"{c32['cuda'][1]:.4f}, rel diff {dcost32:.3e} (not gated)")
    # duplicate fusion, the medoid refresh, and local BA with the refresh.
    # Fusion and the refresh are integer logic on f32 gates: equal tables.
    # The BA runs in f64 for the gate (f32 LM after 8 iterations parts ways
    # across devices, see above, and may prune another observation); the
    # f32 run is reported.
    order = l2._kf_order
    dup_map, _ = _inject_duplicates(host_map, order[-1], order[-2])
    fuse = {}
    for dev in ("cpu", "cuda"):
        m = convert.map_state_from_numpy(dup_map, dev)
        n_fused = 0
        for nb in order[-4:-1]:
            m, nf = local_mapping.fuse_duplicates(m, _cam(dev), order[-1], nb)
            n_fused += int(nf)
        m_ref = local_mapping.update_landmark_descriptors(m)
        f64 = torch.float64
        m_ba64, _, _ = local_mapping.local_ba(
            m._replace(kf_T=m.kf_T.to(f64), lm_pos=m.lm_pos.to(f64), kf_xy=m.kf_xy.to(f64)),
            _cam(dev).to(f64), kf_free.to(dev), iters=BA_ITERS, refresh_desc=True)
        m_ba32, _, _ = local_mapping.local_ba(m, _cam(dev), kf_free.to(dev),
                                              iters=BA_ITERS, refresh_desc=True)
        fuse[dev] = (n_fused, *(convert.map_state_to_numpy(x)
                                for x in (m, m_ref, m_ba64, m_ba32)))
    n_fused = fuse["cpu"][0]
    two_obs = int((fuse["cpu"][1]["lm_nobs"][fuse["cpu"][1]["lm_valid"]] == 2).sum())
    moved = int((fuse["cpu"][2]["lm_desc_pm1"] != fuse["cpu"][1]["lm_desc_pm1"]).any(1).sum())
    diff32 = sum(int((fuse["cpu"][4][k] != fuse["cuda"][4][k]).sum()) for k in FUSE_TABLES)
    _log(f"L2 fusion cuda vs cpu: {n_fused} landmarks fused on the CPU, "
         f"{fuse['cuda'][0]} on the card (8 clones and 2 groups of tied pairs injected: 12 "
         f"candidate merges); descriptor refresh moved {moved} descriptors, {two_obs} landmarks "
         f"with 2 observations (tied medoid scores); tables after fusion, after the "
         f"refresh and after f64 local_ba with the refresh compared; f32 local_ba: "
         f"{diff32} table entries differ (not gated)")
    if fuse["cuda"][0] != n_fused or n_fused < 6:
        raise RuntimeError(f"fused {n_fused} on the CPU, {fuse['cuda'][0]} on the card")
    for stage, i in (("fuse_duplicates", 1), ("update_landmark_descriptors", 2),
                     ("local_ba f64 with refresh", 3)):
        for k in FUSE_TABLES:
            if not np.array_equal(fuse["cpu"][i][k], fuse["cuda"][i][k]):
                raise RuntimeError(f"{stage}: {k} differs between cpu and cuda")
    if moved == 0 or two_obs == 0:
        raise RuntimeError("the descriptor refresh had nothing to decide")

    if nc < 10:
        raise RuntimeError(f"the CPU tracked only {nc} inliers: no real test")
    if agree < L2_TRACK_AGREE:
        raise RuntimeError(f"feat_lm agrees on {agree} < {L2_TRACK_AGREE}")
    if not dT <= L2_POSE_TOL:
        raise RuntimeError(f"Tcw differs by {dT} > {L2_POSE_TOL}")
    if not dcost <= L2_COST_TOL:
        raise RuntimeError(f"BA cost differs by rel {dcost} > {L2_COST_TOL}")
    if not dcost64 <= L2_COST_TOL_F64:
        raise RuntimeError(f"f64 BA cost differs by rel {dcost64} > {L2_COST_TOL_F64}")
    return dict(agree=agree, dT=dT, dcost=dcost)


def run_event_slam():
    """EventSlam end to end on the card at the synth_ev_only width, through
    EventSlam.track_events: 0.2 s of warm-up (L2 must initialize), 0.15 s
    timed, then 0.085 s more window by window: 10 MCIs with synchronised
    per-phase timers, the rest under the profiler."""
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.slam import event_system, system

    cfg = eb.BuilderConfig(**SLICE_CFG)
    per_window = _window_launches(cfg.l1_num_loop)
    ev = synth_stream(EV_WARM_S + EV_RUN_S + EV_PHASE_S, RATE, seed=5)
    t_run, t_phase = EV_WARM_S, EV_WARM_S + EV_RUN_S
    warm = ev[ev[:, 0] < t_run]
    run = ev[(ev[:, 0] >= t_run) & (ev[:, 0] < t_phase)]
    phase = ev[ev[:, 0] >= t_phase]
    # no device given: the entry point runs on the card
    slam = event_system.EventSlam(_cam(), cfg, max_kp=MAX_KP, **L2_KW)
    if not (slam.builder.device.type == slam.l2.device.type == "cuda"):
        raise RuntimeError("EventSlam without a device did not go to the card")

    def drive(events, rec):
        """Push the stream through the user entry point in sensor-sized
        packets; record each MCI's result and whether the L2 pose prior was
        already posted when its packet went in (once posted it stays)."""
        for k in range(0, len(events), PACKET):
            prior = slam.builder.pose_prior is not None
            rec += [(r, prior) for r in slam.track_events(events[k:k + PACKET])]

    warm_rec = []
    drive(warm, warm_rec)
    torch.cuda.synchronize()
    if not any(r["state"] == system.OK for r, _ in warm_rec):
        raise RuntimeError(f"L2 did not initialize in the warm-up: {slam.stats}")

    _reset_counts()
    rec = []
    t0 = time.perf_counter()
    drive(run, rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, vjp_launches, asc_launches = counts = _counts()
    n = len(rec)
    if n == 0:
        raise RuntimeError("the timed part produced no MCI")
    n_ok = sum(r["state"] == system.OK for r, _ in rec)
    n_prior = sum(prior for _, prior in rec)
    # best_kind as the builder reports it: one window late
    winners = {k: sum(r["mci_kind"] == k for r, _ in rec) for k in eb.KINDS}
    data_s = rec[-1][0]["ts"] - warm_rec[-1][0]["ts"]

    # per-phase split: the same loop with synchronised timers, mapping
    # timed inside MonoSlam._insert_keyframe
    t_map = []
    insert = slam.l2._insert_keyframe

    def timed_insert(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        insert(*a, **k)
        torch.cuda.synchronize()
        t_map.append(time.perf_counter() - t)

    slam.l2._insert_keyframe = timed_insert
    slam.builder.feed(phase)
    t_step, t_l2 = [], []
    # blocking reads of both passes, one step per step_window ("L1") and
    # per L2 call ("L2 track", "L2 KF" or "L2 other": _frame_kind)
    kinds = []
    l2_kind = lambda r: "L2 " + _frame_kind(r)
    with _Syncs() as sy:
        while len(t_step) < EV_PHASE_TIMED:
            torch.cuda.synchronize()
            t = time.perf_counter()
            pi = slam.builder.step_window()
            torch.cuda.synchronize()
            sy.mark()
            kinds.append(None if pi is None else "L1")
            if pi is None:
                break
            t_step.append(time.perf_counter() - t)
            t = time.perf_counter()
            r = slam._track_mci(pi)
            torch.cuda.synchronize()
            t_l2.append(time.perf_counter() - t)
            sy.mark()
            kinds.append(l2_kind(r))
        slam.l2._insert_keyframe = insert
        # what is left of the stream under the profiler, L1 and L2 apart:
        # device launches and device time per MCI
        prof = {"L1": [], "L2": []}
        # host-issued launches of each profiled step, by kind ("capture"
        # where the step captured a graph), and the hand kernels it counted
        # (the wrappers', and each replay's capture-time counts) beside those
        # the profiler saw run on the card
        host, held = [], []

        def profiled(fn, kind_of):
            c0, k0 = _captures(), _hand_counts()
            out, per = _profile(fn)
            sy.mark()
            kind = "capture" if _captures() != c0 else kind_of(out)
            host.append((kind, per.launches))
            held.append((kind, tuple(b - a for a, b in zip(k0, _hand_counts())), _seen(per),
                         bool(per)))
            return out, per

        while True:
            pi, per = profiled(slam.builder.step_window, lambda _: "L1")
            kinds.append(None if pi is None else "L1")
            if pi is None:
                host.pop()
                held.pop()
                break
            prof["L1"].append(per)
            r, per = profiled(lambda: slam._track_mci(pi), l2_kind)
            prof["L2"].append(per)
            kinds.append(l2_kind(r))
    reads = _Reads(sy, kinds)
    if not prof["L1"]:
        raise RuntimeError("no window was left for the profiled pass")
    per_mci = {k: (sum(c for per in v for c, _ in per.values()) / len(v),
                   sum(us for per in v for _, us in per.values()) / len(v) / 1e3)
               for k, v in prof.items()}
    if not t_step:
        raise RuntimeError("the phase pass produced no MCI")
    n_ph = len(t_step)
    ms_step = 1e3 * sum(t_step) / n_ph
    ms_map = 1e3 * sum(t_map) / n_ph
    ms_track = 1e3 * sum(t_l2) / n_ph - ms_map

    traj = slam.trajectory_twc()
    l2 = slam.l2
    n_lm = int(l2.map.lm_valid.sum())
    _log(f"EventSlam: {n} MCIs in {wall:.3f} s wall = {n / wall:.3f} MCIs/s; "
         f"{data_s:.4f} s of data -> real-time x {data_s / wall:.4f}; "
         f"{n_ok}/{n} timed MCIs OK, {n_prior} with the L2 pose prior set; "
         f"forward, VJP and ascent launches {counts} ({per_window} per window); "
         f"winners {winners}")
    _log(f"EventSlam phases over {n_ph} MCIs (synchronised): step_window "
         f"{ms_step:.2f} ms, process_image tracking {ms_track:.2f} ms, "
         f"keyframe mapping {ms_map:.2f} ms per MCI ({len(t_map)} keyframes, "
         f"{1e3 * sum(t_map) / max(len(t_map), 1):.2f} ms each)")
    _log(f"EventSlam under torch.profiler over {len(prof['L1'])} MCIs: step_window "
         f"{per_mci['L1'][0]:.0f} device launches and {per_mci['L1'][1]:.2f} ms of "
         f"device time per MCI; L2 (tracking and mapping) {per_mci['L2'][0]:.0f} "
         f"launches and {per_mci['L2'][1]:.2f} ms per MCI")
    _log(f"EventSlam under torch.profiler: host-issued launches per step (kind, "
         f"launches): {host}")
    _log(f"EventSlam under torch.profiler: hand kernels {HAND_KERNELS} per step, counted "
         f"and seen run (kind, counted, seen, recorded): {held}")
    off = [h for h in held if h[3] and h[1] != h[2]]
    if off:
        raise RuntimeError(f"EventSlam: the hand kernels counted differ from those the "
                           f"profiler saw run: {off}")
    replays = [c for kd, c, _, rec in held if kd == "L1" and rec]
    if len(replays) < 2 or any(c != (*per_window, 0) for c in replays):
        raise RuntimeError(f"EventSlam: {len(replays)} replayed windows held against the "
                           f"profiler, counting {replays}; expected at least 2, each "
                           f"{per_window} and no sym_eig")
    reads.log("EventSlam (speculation on)", "MCI")
    reads.at_most("EventSlam", {"L1": READS_L1_MAX, "L2 track": READS_TRACK_MAX,
                                "L2 KF": READS_KF_MAX})
    over = [(kd, c) for kd, c in host
            if c > {"L1": GRAPH_LAUNCH_MAX["window"], "L2 track": GRAPH_LAUNCH_MAX["frame"],
                    "L2 KF": GRAPH_LAUNCH_MAX["keyframe"]}.get(kd, c)]
    kf_host = [c for kd, c in host if kd == "L2 KF"]
    _log(f"EventSlam under torch.profiler: host-issued launches per keyframe MCI {kf_host}")
    if over:
        raise RuntimeError(f"EventSlam: host-issued launches above {GRAPH_LAUNCH_MAX} "
                           f"(window, tracked MCI, keyframe MCI): {over}")
    _log(f"EventSlam map: {l2.n_kf} keyframes, {n_lm} landmarks, "
         f"{l2.stats['lost']} lost windows, {l2.kf_culled} KFs culled, "
         f"{len(traj)} trajectory poses; stats {slam.stats}")
    if l2.n_kf < 2:
        raise RuntimeError(f"the L2 map holds {l2.n_kf} keyframes")
    if n_ok < 0.8 * n:
        raise RuntimeError(f"only {n_ok}/{n} timed MCIs tracked")
    if not traj or not all(np.isfinite(T).all() for _, T in traj):
        raise RuntimeError("a trajectory pose is not finite")
    if counts != tuple(n * c for c in per_window):
        raise RuntimeError(f"{counts} forward, VJP and ascent launches for {n} windows, "
                           f"expected {per_window} per window")
    if n_prior == 0:
        raise RuntimeError("no timed window ran with the L2 pose prior")
    return dict(mcis=n, wall_s=wall, data_s=data_s, launches=launches,
                vjp_launches=vjp_launches, ascent_launches=asc_launches)


def check_kernel_generator():
    """The forward kernel at the shapes the dataset generator gives it
    (identity form, sigma 1.1): the shakes scene's 24,000 projected sub-dots
    with the 0/1 f32 weights the renderer really passes, and 6,000 dots with
    f32 amplitude weights. Returns one row per shape."""
    from eorb_slam_tpu_torch.io import synth_dataset as sd

    scene = sd.make_scene("shakes", W, H, CAM[0], n_dots=GEN_DOTS, seed=0)
    T = torch.tensor(sd.make_trajectory("shakes", GEN_S)(0.1), dtype=torch.float32,
                     device="cuda")
    dots = torch.tensor(scene.dots, device="cuda")
    pc = dots @ T[:3, :3].T + T[:3, 3]
    uv = torch.stack([CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2],
                      CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]], 1).contiguous()
    ok = (pc[:, 2] > 0.3) & (uv[:, 0] >= -3) & (uv[:, 0] < W + 3) \
        & (uv[:, 1] >= -3) & (uv[:, 1] < H + 3)
    amp = torch.tensor(scene.amp, device="cuda")
    shapes = [("renderer", uv, ok.to(torch.float32)),
              ("amplitudes", uv[::4].contiguous(), (amp * ok)[::4].contiguous())]
    return [_identity_row(f"the generator's shape ({name})", xy, w, GEN_SIGMA)
            for name, xy, w in shapes]


def _identity_row(what, xy, w, sigma):
    """The identity-form forward on the card at one call site's shape: held
    against the plain version at FWD_TOL, timed by events, by graph replay
    and plain, beside its bound. Active events: weight != 0, within the
    taps' reach of the image."""
    from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    n, cfg = xy.shape[0], (H, W, sigma, TRUNC)
    ref = _splat_gauss_separable(xy, w, *cfg)
    got = hs.splat(xy, w, *cfg)
    torch.cuda.synchronize()
    err = _held(got, ref, FWD_TOL, f"splat at {what} N={n}")
    r = TRUNC + 1.0
    act = int(((w != 0) & (xy[:, 0] > -r) & (xy[:, 0] < W + r)
               & (xy[:, 1] > -r) & (xy[:, 1] < H + r)).sum())
    row = dict(n=n, err=err, ref=float(ref.abs().max()), active=act,
               ms=_time_ms(lambda: hs.splat(xy, w, *cfg)),
               dev_ms=_device_ms(lambda: hs.splat(xy, w, *cfg)),
               plain_ms=_time_ms(lambda: _splat_gauss_separable(xy, w, *cfg)),
               bound=_bound(n, act, False, False))
    _log(f"splat at {what}: N={n} ({act} active), sigma {sigma}, identity form: max abs "
         f"{err:.3e} (max|ref| {row['ref']:.3f}, tol {FWD_TOL}x) | ms by events / device "
         f"only / plain / bound (12N + 4HW bytes): {row['ms']:.4f} / {row['dev_ms']:.5f} / "
         f"{row['plain_ms']:.4f} / {row['bound'][0]:.6f}")
    return row


def _settings_with_root(config: str, root: str, out_dir: str, fmt: str = None,
                        extra: str = "", name: str = None) -> str:
    """A copy of ``configs/<config>`` that differs in ``DS.Paths.root`` (and,
    where given, ``DS.format`` and the ``extra`` lines appended) only,
    written to ``out_dir/<name or config>``."""
    with open(os.path.join(REPO, "configs", config)) as f:
        text = f.read()
    text, n = re.subn(r'(?m)^DS\.Paths\.root:.*$', f'DS.Paths.root: "{root}"', text)
    if n != 1:
        raise RuntimeError(f"{config}: expected one DS.Paths.root line, found {n}")
    if fmt is not None:
        text, n = re.subn(r'(?m)^DS\.format:.*$', f'DS.format: "{fmt}"', text)
        if n != 1:
            raise RuntimeError(f"{config}: expected one DS.format line, found {n}")
    text += extra
    path = os.path.join(out_dir, name or config)
    with open(path, "w") as f:
        f.write(text)
    return path


def run_generate(work: str):
    """io/synth_dataset.write_ev_ethz on the card: the shakes trajectory at
    the synth_ev_only camera, loaded back through io/datasets."""
    from eorb_slam_tpu_torch.io import datasets, synth_dataset as sd
    from eorb_slam_tpu_torch.ops import hopper_splat

    root = os.path.join(work, "ev_ethz")
    scene = sd.make_scene("shakes", W, H, CAM[0], n_dots=GEN_DOTS, seed=0)
    pose = sd.make_trajectory("shakes", GEN_S)
    hopper_splat.splat.launches = 0
    t0 = time.perf_counter()
    sd.write_ev_ethz(root, "shakes_01", scene, pose, GEN_S, fps=GEN_FPS,
                     sim_hz=GEN_SIM_HZ, contrast=0.25, verbose=False)
    wall = time.perf_counter() - t0
    launches = hopper_splat.splat.launches
    # one for the gain calibration, one per simulation step (both ends), one
    # per image
    poses = 1 + (int(round(GEN_S * GEN_SIM_HZ)) + 1) + int(GEN_S * GEN_FPS)
    t0 = time.perf_counter()
    seq = datasets.load_sequence("ev_ethz", root, "shakes_01", ts_factor=1.0)
    t_load = time.perf_counter() - t0
    ev = seq.events.events
    rate = len(ev) / GEN_S
    _log(f"generate: shakes_01, {GEN_S} s of data in {wall:.2f} s wall: {len(ev)} "
         f"events ({rate / 1e6:.3f} M events per second of data), {seq.n_frames} "
         f"images, {len(seq.imu.ts)} IMU rows, {len(seq.gt_ts)} GT rows; "
         f"{launches} forward splat launches for {poses} rendered poses "
         f"({launches / GEN_S:.0f} per second of data); loaded back in "
         f"{t_load:.2f} s, timestamps {ev.dtype}")
    if launches != poses:
        raise RuntimeError(f"{launches} splat launches for {poses} rendered poses")
    if ev.dtype != np.float64 or ev.shape[1] != 4 or np.any(np.diff(ev[:, 0]) < 0):
        raise RuntimeError(f"events came back as {ev.dtype} {ev.shape}, or unsorted")
    if not GEN_RATE_BAND[0] <= rate <= GEN_RATE_BAND[1]:
        raise RuntimeError(f"event rate {rate} outside {GEN_RATE_BAND}")
    if seq.n_frames != int(GEN_S * GEN_FPS) or seq.gt_pose.shape != (int(GEN_S * 100), 7):
        raise RuntimeError(f"{seq.n_frames} images, GT {seq.gt_pose.shape}")
    img = seq.image(0)
    if img.shape != (H, W) or not (np.isfinite(img).all() and img.max() > 0.2):
        raise RuntimeError("a rendered image is empty or not finite")
    return dict(root=root, launches=launches, events=len(ev), wall_s=wall)


def run_app_event_only(work: str, data_root: str):
    """apps/run_slam.main with the configs/synth_ev_only.yaml settings (only
    DS.Paths.root differs) on the generated sequence, no --device: the
    system goes to the card; scored against ground truth with --eval."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam import event_system, system

    settings = _settings_with_root("synth_ev_only.yaml", data_root, work)
    states, queues = [], []
    track_mci = event_system.EventSlam._track_mci

    def recording(self, pi):
        res = track_mci(self, pi)
        states.append(res["state"])
        queues.append(self.builder._q is not None)
        return res

    event_system.EventSlam._track_mci = recording
    _reset_counts()
    try:
        t0 = time.perf_counter()
        (out,) = run_slam.main([settings, "--sequence", "shakes_01", "--eval",
                                "--out", os.path.join(work, "results_ev")])
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
    finally:
        event_system.EventSlam._track_mci = track_mci
    launches, vjp, asc = _counts()
    st, ev = out["stats"], out.get("eval", {})
    n = st["mci"]
    first_ok = states.index(system.OK) if system.OK in states else n
    after = states[first_ok:]
    n_ok = sum(s == system.OK for s in after)
    with open(out["trajectory_file"]) as f:
        header = f.readline()
    path_len = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    ate_frac = ev.get("ate_rmse", float("inf")) / max(path_len, 1e-12)
    data_s = GEN_S
    _log(f"run_slam EVENT_ONLY on {out['device']}: {n} MCIs from {out['iterations']} "
         f"chunks in {out['wall_s']:.3f} s wall = {n / out['wall_s']:.3f} MCIs/s "
         f"(real-time x {data_s / out['wall_s']:.4f}; main() with parse and "
         f"evaluation {t_main:.3f} s); avg_track_ms {out['avg_track_ms']:.2f} per "
         f"chunk; initialised at MCI {first_ok}, then {n_ok}/{len(after)} tracked; "
         f"splat launches {launches} forward + {vjp} VJP + {asc} ascent for "
         f"{st['windows']} windows; native queue "
         f"{'in use' if queues and all(queues) else 'NOT in use'}")
    _log(f"run_slam EVENT_ONLY accuracy: ATE rmse {ev.get('ate_rmse')} m over "
         f"{ev.get('ate_n')} poses (Sim3-aligned, scale {ev.get('ate_scale')}), path "
         f"{path_len:.4f} m -> {100 * ate_frac:.2f}% of the path; piecewise APE "
         f"{ev.get('ape_piecewise', {}).get('ape_pct')}%; RPE trans "
         f"{ev.get('rpe_trans_rmse')} rot {ev.get('rpe_rot_rmse')}; stats {st}")
    if out["device"] != "cuda":
        raise RuntimeError(f"run_slam ran on {out['device']}")
    if not (queues and all(queues)):
        raise RuntimeError("EventWindowBuilder did not use the native event queue")
    if not after or n_ok < 0.8 * len(after):
        raise RuntimeError(f"only {n_ok}/{len(after)} windows tracked after init")
    per_window = _window_launches(SLICE_CFG["l1_num_loop"])
    if (launches, vjp, asc) != tuple(st["windows"] * c for c in per_window):
        raise RuntimeError(f"{(launches, vjp, asc)} launches for {st['windows']} windows, "
                           f"expected {per_window} per window")
    if not header.startswith("# tracking:"):
        raise RuntimeError(f"TUM file starts with {header!r}")
    if not (np.isfinite(ev.get("ate_rmse", np.inf)) and ev["ate_n"] >= APP_MIN_ATE_N):
        raise RuntimeError(f"evaluate gave {ev}")
    if not ate_frac <= APP_ATE_MAX:
        raise RuntimeError(f"ATE is {ate_frac} of the path > {APP_ATE_MAX}")
    return dict(launches=launches, vjp_launches=vjp, ascent_launches=asc, mcis=n,
                wall_s=out["wall_s"], ate_frac=ate_frac)


def run_app_monocular(work: str):
    """MONOCULAR at the configs/synth_euroc_mono.yaml width (752x480, fx 458,
    20 fps, 512 features): the corridor trajectory through the textured-box
    renderer, written in EuRoC layout, then run_slam.run_sequence +
    evaluate; then a few more frames under the profiler."""
    from eorb_slam_tpu_torch._host import to_device
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.io import config, datasets, synth_dataset as sd
    from eorb_slam_tpu_torch.slam import system

    root = os.path.join(work, "euroc")
    st = config.load_settings(_settings_with_root("synth_euroc_mono.yaml", root, work))
    Wm, Hm, fx, fps = st.cam.width, st.cam.height, st.cam.fx, st.cam.fps
    n_all = MONO_FRAMES + MONO_PROFILED
    t0 = time.perf_counter()
    scene = sd.make_scene("corridor", Wm, Hm, fx, n_dots=10)
    sd.write_euroc(root, "corridor_01", scene, sd.make_trajectory("corridor", 30.0),
                   duration=n_all / fps, fps=fps, verbose=False,
                   renderer=sd.make_box_renderer("corridor", Wm, Hm, fx))
    t_gen = time.perf_counter() - t0
    seq = datasets.load_sequence(st.dataset.format, root, "corridor_01",
                                 ts_factor=st.dataset.ts_factor)
    if seq.n_frames != n_all or seq.image(0).shape != (Hm, Wm):
        raise RuntimeError(f"{seq.n_frames} frames of {seq.image(0).shape}")

    states, t_map, kinds = [], [], []
    process, insert = system.MonoSlam.process_image, system.MonoSlam._insert_keyframe
    sy = _Syncs()

    def recording(self, img, ts, **kw):
        res = process(self, img, ts, **kw)
        sy.mark()
        states.append(res["state"])
        kinds.append(_frame_kind(res))
        return res

    def timed_insert(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        insert(self, *a, **kw)
        torch.cuda.synchronize()
        t_map.append(time.perf_counter() - t)

    system.MonoSlam.process_image = recording
    system.MonoSlam._insert_keyframe = timed_insert
    try:
        with sy:
            slam, out = run_slam.run_sequence(
                st, seq, out_dir=os.path.join(work, "results_mono"),
                max_frames=MONO_FRAMES, verbose=False)
            torch.cuda.synchronize()
    finally:
        system.MonoSlam.process_image = process
        system.MonoSlam._insert_keyframe = insert
    reads = _Reads(sy, kinds)
    ev = run_slam.evaluate(seq, out["trajectory_file"], monocular=True)
    stats = out["stats"]
    first_ok = states.index(system.OK) if system.OK in states else len(states)
    after = states[first_ok:]
    n_ok = sum(s == system.OK for s in after)
    ms_frame = out["avg_track_ms"]
    ms_map = 1e3 * sum(t_map) / max(len(states), 1)
    # launches per frame, by the profiler, on the frames that follow
    per_frame, host = [], []
    for i in range(MONO_FRAMES, n_all):
        img = (seq.image(i) * 255.0).astype(np.uint8)
        c0 = _captures()
        r, per = _profile(lambda: slam.process_image(to_device(img, slam.device),
                                                     float(seq.image_ts[i])))
        per_frame.append((sum(c for c, _ in per.values()),
                          sum(us for _, us in per.values()) / 1e3))
        host.append(("capture" if _captures() != c0 else _frame_kind(r), per.launches))
    path_len = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    _log(f"run_slam MONOCULAR {Wm}x{Hm}, N={slam.map.N}, on {slam.device}: "
         f"{len(states)} frames (generated in {t_gen:.2f} s) in {out['wall_s']:.3f} s "
         f"wall = {len(states) / out['wall_s']:.3f} frames/s; {ms_frame:.2f} ms per "
         f"frame, of which keyframe mapping {ms_map:.2f} ms ({len(t_map)} keyframes, "
         f"{1e3 * sum(t_map) / max(len(t_map), 1):.2f} ms each, synchronised) and "
         f"extraction + tracking {ms_frame - ms_map:.2f} ms; initialised at frame "
         f"{first_ok}, then {n_ok}/{len(after)} tracked; {stats.get('fuse_steps', 0)} "
         f"mapping steps ran fuse_duplicates ({stats.get('fused', 0)} landmarks fused), "
         f"{stats.get('refresh_steps', 0)} the descriptor refresh")
    _log(f"run_slam MONOCULAR under torch.profiler, {len(per_frame)} frames: "
         f"{np.mean([c for c, _ in per_frame]):.0f} device launches and "
         f"{np.mean([t for _, t in per_frame]):.2f} ms of device time per frame "
         f"(per frame: {[c for c, _ in per_frame]}); host-issued launches per frame "
         f"(kind, launches): {host}")
    reads.log("run_slam MONOCULAR", "frame")
    reads.not_above("MONOCULAR", "frame")
    reads.at_most("MONOCULAR", READS_APP_MAX["MONOCULAR"])
    _log(f"run_slam MONOCULAR accuracy: ATE rmse {ev.get('ate_rmse')} over "
         f"{ev.get('ate_n')} poses (Sim3-aligned), path {path_len:.4f} m -> "
         f"{100 * ev.get('ate_rmse', np.inf) / max(path_len, 1e-12):.3f}% of the path; "
         f"stats {stats}")
    if slam.device.type != "cuda" or not (slam.fuse_enabled and slam.desc_refresh):
        raise RuntimeError("MONOCULAR did not run on the card with fusion and refresh on")
    if slam.map.N != 512 or (slam.img_w, slam.img_h) != (752, 480):
        raise RuntimeError(f"not the full width: N={slam.map.N} {slam.img_w}x{slam.img_h}")
    if not after or n_ok < 0.8 * len(after):
        raise RuntimeError(f"only {n_ok}/{len(after)} frames tracked after init")
    if any(kd == "track" and c > GRAPH_LAUNCH_MAX["frame"] for kd, c in host):
        raise RuntimeError(f"host-issued launches per tracked frame above "
                           f"{GRAPH_LAUNCH_MAX['frame']}: {host}")
    if any(kd == "KF" and c > GRAPH_LAUNCH_MAX["keyframe"] for kd, c in host):
        raise RuntimeError(f"host-issued launches per keyframe frame above "
                           f"{GRAPH_LAUNCH_MAX['keyframe']}: {host}")
    if stats.get("fuse_steps", 0) < 1 or stats.get("refresh_steps", 0) < 1:
        raise RuntimeError(f"no mapping step ran fusion and the refresh: {stats}")
    if not (np.isfinite(ev.get("ate_rmse", np.inf)) and ev["ate_n"] >= 0.8 * len(after)):
        raise RuntimeError(f"evaluate gave {ev}")
    return dict(frames=len(states), wall_s=out["wall_s"], root=root,
                ate_frac=ev["ate_rmse"] / max(path_len, 1e-12), first_ok=first_ok,
                tracked=n_ok / max(len(after), 1), reads=reads)


_TORCH_DIR = os.path.dirname(torch.__file__)


def _site(frame) -> str:
    """``file:line`` of the innermost frame at or above ``frame`` that is
    neither torch's nor the warnings module's: the line that made the call."""
    while frame is not None:
        fn = frame.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn.endswith(os.sep + "warnings.py")):
            if fn.startswith(REPO + os.sep):
                fn = os.path.relpath(fn, REPO)
            return f"{fn}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


class _Syncs:
    """Counts, while active, the host's blocking reads of the card: torch's
    sync debug mode warns at every synchronising CUDA call (a read of a
    device value, a copy from or to pageable memory), and a HostCopy read
    counts where its copy had not landed yet. Each read is kept under the
    ``file:line`` that made it (a HostCopy wait under its reader's line,
    tagged ``HostCopy``). ``mark()`` closes one step: ``steps`` holds the
    reads of each step, ``sites`` their tally by site, ``eig`` the sym_eig
    kernel launches of each step."""

    def __enter__(self):
        from eorb_slam_tpu_torch import _host
        from eorb_slam_tpu_torch.ops import hopper_linalg as hl

        self.steps, self.sites, self.eig, self.captures = [], [], [], []
        self._cur = {}
        self._hl = hl
        self._eig0 = sum(hl.sym_eig.by_n.values())
        self._cap0 = _captures()
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                self._hit(_site(sys._getframe(1)))

        warnings.showwarning = show
        self._numpy = _host.HostCopy.numpy

        def numpy(hc):
            if not hc.ready():
                self._hit(_site(sys._getframe(1)) + " HostCopy")
            return self._numpy(hc)

        _host.HostCopy.numpy = numpy
        # the harness's own torch.cuda.synchronize calls (timers, profiler)
        # are not the program's reads: they run with the debug mode off
        self._sync = torch.cuda.synchronize

        def quiet_sync(*a):
            torch.cuda.set_sync_debug_mode(0)
            self._sync(*a)
            torch.cuda.set_sync_debug_mode("warn")

        torch.cuda.synchronize = quiet_sync
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _hit(self, site):
        self._cur[site] = self._cur.get(site, 0) + 1

    def mark(self):
        self.steps.append(sum(self._cur.values()))
        self.sites.append(self._cur)
        self._cur = {}
        now = sum(self._hl.sym_eig.by_n.values())
        self.eig.append(now - self._eig0)
        self._eig0 = now
        now = _captures()
        self.captures.append(now - self._cap0)
        self._cap0 = now

    def top(self, idx=None, k=8) -> str:
        """The ``k`` commonest sites of the steps ``idx`` (all by default),
        as ``file:line xcount`` per step."""
        idx = range(len(self.steps)) if idx is None else list(idx)
        tally = {}
        for i in idx:
            for s, c in self.sites[i].items():
                tally[s] = tally.get(s, 0) + c
        per = max(len(idx), 1)
        best = sorted(tally.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return ", ".join(f"{s} x{c / per:.2f}" for s, c in best) or "none"

    def __exit__(self, *exc):
        from eorb_slam_tpu_torch import _host

        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = self._sync
        _host.HostCopy.numpy = self._numpy
        self._cm.__exit__(*exc)
        return False


def _frame_kind(out) -> str:
    """What one frame step did, from the dict its entry point returned:
    "KF" where it inserted a keyframe, "track" where it tracked without
    one, else "other" (initialisation, a lost frame, a relocalisation, a
    new map)."""
    if out.get("kf"):
        return "KF"
    if out.get("state") == 1 and not ({"reloc", "new_map", "n_pts"} & out.keys()):
        return "track"
    return "other"


def _step_kind(res, keys) -> str:
    """The kind of a step that returned ``res`` and began with the runners'
    (captures, first calls) at ``keys``: "capture" where it captured a
    graph, "first call" where it met a new key (run eagerly), else
    _frame_kind."""
    if _captures() != keys[0]:
        return "capture"
    if _first_calls() != keys[1]:
        return "first call"
    return _frame_kind(res)


class _PreInit:
    """Inside an inertial app run, the steps that track before the IMU
    init: the PREINIT_PROFILED that follow the first PREINIT_SKIP of them
    run under the profiler. ``rows`` holds (index among such steps, kind,
    host-issued launches, device kernels, device ms) of each."""

    def __init__(self):
        self.seen, self.rows = 0, []

    def __call__(self, pre_init: bool, step):
        """``step()``, under the profiler where due."""
        if not pre_init or len(self.rows) >= PREINIT_PROFILED:
            return step()
        self.seen += 1
        if self.seen <= PREINIT_SKIP:
            return step()
        keys = (_captures(), _first_calls())
        res, per = _profile(step)
        self.rows.append((self.seen - 1, _step_kind(res, keys), per.launches,
                          sum(c for c, _ in per.values()),
                          round(sum(us for _, us in per.values()) / 1e3, 3)))
        return res

    def log(self, tag, unit):
        _log(f"run_slam {tag} {unit}s tracked before the IMU init, under torch.profiler in "
             f"the app run (index among them, kind, host-issued launches, device kernels, "
             f"device ms): {self.rows}")


class _Reads:
    """A finished _Syncs's steps split by the kind of each step (None: a
    step that is no frame and no MCI)."""

    def __init__(self, sy, kinds):
        # a step that captured a graph (its key's second call) is a kind of
        # its own: torch.cuda.graph drains the card when a capture begins
        self.sy = sy
        self.kinds = [k if k is None or not c else "capture"
                      for k, c in zip(kinds, sy.captures)]

    def at(self, kind):
        return [i for i, k in enumerate(self.kinds) if k == kind]

    def of(self, kind):
        return [self.sy.steps[i] for i in self.at(kind)]

    def mean(self, kind):
        v = self.of(kind)
        return float(np.mean(v)) if v else float("nan")

    def log(self, tag, unit):
        """One line per kind: the mean, each step, and the sites; then the
        graph captures of these steps."""
        _log(f"{tag} graph captures: {sum(self.sy.captures)} in "
             f"{sum(1 for c in self.sy.captures if c)} {unit}s")
        for kind in dict.fromkeys(k for k in self.kinds if k is not None):
            v = self.of(kind)
            _log(f"{tag} blocking reads per {kind} {unit}: {self.mean(kind):.2f} over "
                 f"{len(v)} (each: {v}); sites per {unit}: {self.sy.top(self.at(kind))}")
            e = [self.sy.eig[i] for i in self.at(kind)]
            if any(e):
                _log(f"{tag} sym_eig launches per {kind} {unit}: {np.mean(e):.2f} "
                     f"(each: {e})")

    def at_most(self, tag, limits):
        """Raise unless every step of each kind in ``limits`` reads at most
        its limit."""
        over = {k: v for k, lim in limits.items() for v in [self.of(k)] if v and max(v) > lim}
        if over:
            raise RuntimeError(f"{tag}: blocking reads above {limits}: {over}")

    def not_above(self, tag, unit):
        """Print reads per step of each kind before -> now, and raise where
        a kind's mean rose above READS_BEFORE[tag]."""
        before = READS_BEFORE[tag]
        _log(f"{tag} blocking reads per {unit}, before -> after: " + ", ".join(
            f"{k} {b:.2f} -> {self.mean(k):.2f}" for k, b in before.items()))
        rose = {k: self.mean(k) for k, b in before.items() if self.mean(k) > b}
        if rose:
            raise RuntimeError(f"{tag}: blocking reads rose above {before}: {rose}")


def _pipe_frames(n=PIPE_FRAMES):
    """``n`` corridor frames through the box renderer on the card, as uint8
    device images, with their ground-truth Tcw."""
    from eorb_slam_tpu_torch.io import synth_dataset as sd

    render = sd.make_box_renderer("corridor", PIPE_W, PIPE_H, PIPE_FX)
    pose = sd.make_trajectory("corridor", 10.0)
    out = []
    for i in range(n):
        Tcw = np.asarray(pose(i / 20.0), np.float32)
        out.append((i / 20.0, (render(Tcw) * 255.0).to(torch.uint8), Tcw))
    return out


def _ate_vs(traj, gt, with_scale=True):
    """(rmse, n, scale) of a trajectory against {ts: Twc} ground truth."""
    from eorb_slam_tpu_torch.evals import ate

    est = [(t, T) for t, T in traj if round(t, 6) in gt]
    r, n, s, _, _ = ate.ate_rmse(est, [(t, gt[round(t, 6)]) for t, _ in est],
                                 with_scale=with_scale)
    return r, n, s


def check_pipelined_small():
    """MonoSlam on the card with the pipelined speculation and without it,
    on the same rendered corridor frames (tests/test_pipelined.py's gates),
    then with one blank frame: the rollback recovers and leaves no duplicate
    timestamp. Blocking host reads per frame for both modes."""
    from eorb_slam_tpu_torch.slam import system

    frames = _pipe_frames()
    gt = {round(t, 6): np.linalg.inv(Tcw) for t, _, Tcw in frames}
    cam = np.asarray([PIPE_FX, PIPE_FX, PIPE_W / 2, PIPE_H / 2, 0, 0, 0, 0, 0], np.float32)

    def run(pipelined, blank=None):
        slam = system.MonoSlam(cam, pipelined=pipelined, **PIPE_KW)
        kinds, launches = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Syncs() as sy:
            for i, (ts, img, _) in enumerate(frames):
                img = torch.zeros_like(img) if i == blank else img
                if i < PIPE_FRAMES - PIPE_PROFILED:
                    out = slam.process_image(img, ts)
                else:
                    out, per = _profile(lambda: slam.process_image(img, ts))
                    launches.append(sum(c for c, _ in per.values()))
                sy.mark()
                kinds.append(_frame_kind(out))
            slam.flush_pipeline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traj = slam.trajectory_twc()
        return slam, traj, _ate_vs(traj, gt), _Reads(sy, kinds), launches, wall

    s_sync, traj_s, (r_s, n_s, _), reads_s, launch_s, wall_s = run(False)
    s_pipe, traj_p, (r_p, n_p, _), reads_p, launch_p, wall_p = run(True)
    s_blank, traj_b, (r_b, n_b, _), reads_b, _, _ = run(True, PIPE_BLANK)
    ts_b = [t for t, _ in traj_b]
    # every frame once tracking (skip the two init frames), keyframe
    # frames included: the mean this check has always printed
    steady = lambda r: float(np.mean(r.sy.steps[3:]))
    _log(f"pipelined MonoSlam {PIPE_W}x{PIPE_H}, {PIPE_FRAMES} frames on the card: sync "
         f"{n_s} tracked, {s_sync.stats['kf']} KFs, ATE {r_s:.5f}, {steady(reads_s):.2f} "
         f"blocking reads per frame, {wall_s:.3f} s (sync debug mode on); speculative {n_p} "
         f"tracked, {s_pipe.stats['kf']} KFs, ATE {r_p:.5f}, {steady(reads_p):.2f} blocking "
         f"reads per frame, {wall_p:.3f} s; blank frame {PIPE_BLANK}: {n_b} tracked, ATE "
         f"{r_b:.5f}, lost {s_blank.stats['lost']}, final state {s_blank.state}, "
         f"{len(ts_b) - len(set(ts_b))} duplicate timestamps")
    for mode, r, la in (("sync", reads_s, launch_s), ("speculative", reads_p, launch_p),
                        ("blank frame", reads_b, None)):
        r.log(f"pipelined MonoSlam {mode}", "frame")
        if la:
            _log(f"pipelined MonoSlam {mode}: the last {PIPE_PROFILED} frames under "
                 f"torch.profiler: {la} device launches")
    for mode, r in (("sync", reads_s), ("speculative", reads_p)):
        r.at_most(f"pipelined MonoSlam {mode}",
                  {"track": READS_TRACK_MAX, "KF": READS_KF_MAX})
    if not n_p >= n_s - 2:
        raise RuntimeError(f"speculation tracked {n_p} frames, sync {n_s}")
    if abs(s_pipe.stats["kf"] - s_sync.stats["kf"]) > 3:
        raise RuntimeError(f"KFs {s_pipe.stats['kf']} vs {s_sync.stats['kf']}")
    if not r_p < max(0.05, 2.0 * r_s + 0.01):
        raise RuntimeError(f"speculative ATE {r_p} vs sync {r_s}")
    if s_blank.state != system.OK or len(ts_b) != len(set(ts_b)) or n_b < PIPE_FRAMES - 10:
        raise RuntimeError(f"no recovery after the blank frame: {s_blank.stats}")
    return dict(reads_sync=steady(reads_s), reads_pipe=steady(reads_p))


# ------------------------------------------------------------- the graphs

def _cloned(x, where="x"):
    """``x`` (a tensor, or tuples, lists or NamedTuples of them) with every
    tensor cloned."""
    from eorb_slam_tpu_torch import _graphs

    leaves = []
    spec = _graphs._flatten(x, leaves, where)
    return _graphs._unflatten(spec, (t.clone() for t in leaves))


def _call_of(unit, a, k) -> dict:
    """The call ``unit(*a, **k)``'s arguments by name, every tensor outside
    the runner's static arguments cloned."""
    bound = unit._sig.bind(*a, **k)
    bound.apply_defaults()
    return {n: v if n in unit.static else _cloned(v, n) for n, v in bound.arguments.items()}


def _pool_mb(pool):
    """MB of the card's memory in the segments of graph pool ``pool``, or
    None where the allocator's snapshot does not name pools."""
    segs = torch.cuda.memory_snapshot()
    if pool is None or not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == tuple(pool)) / 2**20


def _step_cost(fn, reps=3):
    """(host-issued launches and copies, device kernels, device ms, of which
    device copies) of one ``fn()`` under the profiler (again, up to three
    tries, while the profiler recorded no device activity at all: a replay
    of the track top-up once recorded none), and its wall ms by the host
    clock (mean of ``reps`` calls, each ending in
    torch.cuda.synchronize())."""
    for _ in range(3):
        _, per = _profile(fn)
        if per:
            break
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    # copies and fills are not kernels, also where a graph runs them as
    # kernels of their own (memcpy32_post, memset32)
    kernels = sum(c for k, (c, _) in per.items()
                  if not k.lower().startswith(("memcpy", "memset")))
    return dict(host=per.launches, copies=per.copies, kernels=kernels,
                dev_ms=sum(us for _, us in per.values()) / 1e3,
                copy_dev_ms=_matching(per, "Memcpy")[1] / 1e3,
                wall_ms=float(np.mean(walls)), apis=dict(per.host)), per


def _copy_in_cost(unit, kw, reps=20):
    """(tensors, MB, host us) of one copy-in of the call ``unit(**kw)``:
    each tensor outside the static arguments copied into a buffer of its
    shape and strides, as a replay copies it into its static input (no
    copy skipped)."""
    from eorb_slam_tpu_torch import _graphs

    leaves = []
    for n, v in kw.items():
        if n not in unit.static:
            _graphs._flatten(v, leaves, n)
    bufs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
            for t in leaves]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for b, t in zip(bufs, leaves):
            b.copy_(t)
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return len(leaves), sum(t.numel() * t.element_size() for t in leaves) / 2**20, host_us


def _replayed(kind, unit, calls):
    """Each recorded eager call of ``unit`` (arguments by name, outputs)
    again eagerly and through a fresh GraphRunner of the same function:
    raise unless every output of every call is the recorded one, bit for
    bit. Returns the fresh runner."""
    from eorb_slam_tpu_torch import _graphs

    g = _graphs.GraphRunner(unit.fn, static=unit.static)
    eager_off, graph_off = [], []
    for i, (kw, want) in enumerate(calls):
        if not _bits_equal(unit.fn(**kw), want):
            eager_off.append(i)
        if not _bits_equal(g(**kw), want):
            graph_off.append(i)
    torch.cuda.synchronize()
    _log(f"graphs {kind}: {len(calls)} calls, {g.captures} captures of {g.keys} keys, "
         f"{g.replays} replays; eager again differs at calls {eager_off}, the graphs "
         f"at {graph_off}")
    if eager_off:
        raise RuntimeError(f"{kind}: the eager step does not repeat at calls {eager_off}")
    if graph_off:
        raise RuntimeError(f"{kind}: a replay differs from the eager step at {graph_off}")
    return g


def _eager(fn, kw):
    """``fn(**kw)`` with every runner it calls inline, as in a capture: the
    whole step eager."""
    from eorb_slam_tpu_torch import _graphs

    with _graphs.capturing():
        return fn(**kw)


def _report_costs(kind, g, kw, eager_reps=3):
    """Print one step's cost eagerly (the runners it calls inline too) and
    replayed (the call ``g(**kw)``; the eager wall ms a mean of
    ``eager_reps`` calls); returns both."""
    eager, per_e = _step_cost(lambda: _eager(g.fn, kw), reps=eager_reps)
    graph, per_g = _step_cost(lambda: g(**kw))
    n, mb, host_us = _copy_in_cost(g, kw)
    # the device activities whose counts differ, eager against replayed
    differ = {k[:60]: (per_e.get(k, (0, 0))[0], per_g.get(k, (0, 0))[0])
              for k in set(per_e) | set(per_g)
              if per_e.get(k, (0, 0))[0] != per_g.get(k, (0, 0))[0]}
    _log(f"graphs {kind} per step, eager -> replay: host-issued launches "
         f"{eager['host']} -> {graph['host']}, device kernels {eager['kernels']} -> "
         f"{graph['kernels']}, device ms {eager['dev_ms']:.3f} -> {graph['dev_ms']:.3f}, "
         f"wall ms {eager['wall_ms']:.3f} -> {graph['wall_ms']:.3f}; replay's launch calls "
         f"{graph['apis']}, host-issued copies {graph['copies']} ({graph['copy_dev_ms']:.4f} "
         f"device ms); copy-in of its {n} input tensors ({mb:.3f} MB) {host_us:.1f} us of "
         f"host time; {g.captures} captures in {1e3 * g.capture_s:.1f} ms, graph pool "
         f"{_pool_mb(g.pool)} MB; device activities counted apart (eager, replay): "
         f"{dict(sorted(differ.items())[:12])}")
    return dict(eager=eager, graph=graph, copy_in=dict(tensors=n, mb=mb, host_us=host_us))


def _vi_frame_calls(unit, slam, m_old, imgs) -> list:
    """Calls of the inertial frame step on ``slam``'s corridor (its map and
    the earlier ``m_old``, its last frames ``imgs``), each with its eager
    outputs: IMU windows of GRAPH_IMU_S samples (a bucket each, as
    MonoInertialSlam pads them), against the last keyframe and against the
    PoseImuPrior that a step against the keyframe emitted (three keys, each
    captured on its second call, the first replayed once more on another
    map)."""
    from eorb_slam_tpu_torch.imu import preintegration as pre_mod
    from eorb_slam_tpu_torch.slam import vi_system

    dev = slam.cam.device
    calib = pre_mod.make_calib(device=dev)
    z3 = torch.zeros(3, device=dev)
    rng = np.random.default_rng(7)
    m_new = slam.map
    calls, prior = [], None
    # (samples, against the prior, map, image): each key's first call is
    # eager, its second captures and replays on another map or image; the
    # first key's third call replays on inputs other than the capture's
    big, small = GRAPH_IMU_S
    plan = [(big, False, m_new, 0), (big, False, m_old, 1), (big, False, m_new, 1),
            (big, True, m_new, 0), (big, True, m_old, 1),
            (small, True, m_new, 1), (small, True, m_new, 0)]
    for S, use_prior, m, k in plan:
        chunk = vi_system.ImuChunk(
            gyro=rng.normal(0, 0.05, (S, 3)).astype(np.float32),
            acc=(rng.normal(0, 0.2, (S, 3)) + [0, 0, 9.81]).astype(np.float32),
            dts=np.full(S, 1.0 / 200.0, np.float32))
        kfs = torch.nonzero(m.kf_valid).flatten().tolist()
        kw = dict(img=imgs[k], cam_params=slam.cam, m=m,
                  **dict(zip(("gyro", "acc", "dts", "imu_ok"),
                             vi_system._chunk_tensors(chunk, dev, pad=True))),
                  T_last=slam.T_last, vel=z3, bg=z3, ba=z3,
                  pre_since_kf=pre_mod.identity_preintegrated(device=dev),
                  T_kf=m.kf_T[kfs[-1]], vel_kf=z3, prior=prior if use_prior else None,
                  ref_T=m.kf_T[kfs[0]], calib=calib, min_inl_retry=slam.min_track_inliers,
                  max_kp=m.N, img_w=PIPE_W, img_h=PIPE_H)
        out = unit.fn(**kw)
        if not use_prior:
            prior = _cloned(out[12])
        calls.append((_call_of(unit, (), kw), _cloned(out)))
    buckets = sorted({(kw["gyro"].shape[0], kw["prior"] is not None) for kw, _ in calls})
    _log(f"graphs VI frame: {len(calls)} steps, (IMU bucket, prior) keys {buckets}")
    return calls


def _vi_ba_calls(unit) -> list:
    """VI-BA calls at each of GRAPH_VIBA_ITERS iterations on problems of
    GRAPH_VIBA (K, M), new states each, each with its eager outputs; every
    key replayed once, the first twice."""
    K, M = GRAPH_VIBA
    calls = []
    for i, iters in enumerate(GRAPH_VIBA_ITERS):
        for seed in range(3 if i == 0 else 2):
            p = _vi_ba_problem(K, M, 10 * i + seed, "cuda", torch.float32)
            calls.append((_call_of(unit, (p,), dict(iters=iters)), unit.fn(p, iters=iters)))
    return calls


def _recorder(unit, calls):
    """``unit``'s eager function, each call's arguments (by name, tensors
    cloned) and its outputs appended to ``calls``. Inside another runner's
    capture it runs inline and records nothing (a capture computes no
    values)."""
    from eorb_slam_tpu_torch import _graphs

    def rec(*a, **k):
        out = unit.fn(*a, **k)
        if not _graphs._nested():
            calls.append((_call_of(unit, a, k), _cloned(out)))
        return out
    return rec


def _feature_unit_calls(units) -> dict:
    """Recorded eager calls of the feature-path units on the card, each
    with its outputs, by kind: StereoSlam as the app builds
    it from configs/synth_euroc_stereo.yaml (752x480, N 512) through its
    entry point on GRAPH_STEREO_FRAMES frames of the rendered corridor
    pair, its left images uint8 and its right ones float32 (as _frame_args
    makes them: two keys of extract); then every recorded search again
    with the wide re-search's window and ratio (a key of its own)."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.geometry import camera
    from eorb_slam_tpu_torch.io import config, synth_dataset as sd
    from eorb_slam_tpu_torch.ops import frontend, stereo_match
    from eorb_slam_tpu_torch.slam import tracking
    from eorb_slam_tpu_torch.slam.system import OK

    st = config.load_settings(os.path.join(REPO, "configs", "synth_euroc_stereo.yaml"))
    slam = run_slam.build_system(st)
    render = sd.make_box_renderer("corridor", st.cam.width, st.cam.height, st.cam.fx)
    pose = sd.make_trajectory("corridor", 10.0)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -DEPTH_BASELINE
    sites = {"extract": (frontend, "extract"), "undistort": (camera, "undistort_points"),
             "stereo match": (stereo_match, "stereo_match"),
             "track search": (tracking, "track_frame")}
    calls = {k: [] for k in sites}
    for kind, (mod, name) in sites.items():
        setattr(mod, name, _recorder(units[kind], calls[kind]))
    try:
        for i in range(GRAPH_STEREO_FRAMES):
            Tcw = np.asarray(pose(i / st.cam.fps), np.float32)
            slam.process_stereo((render(Tcw) * 255.0).to(torch.uint8),
                                render(T_rl @ Tcw) * 255.0, i / st.cam.fps)
    finally:
        for kind, (mod, name) in sites.items():
            setattr(mod, name, units[kind])
    unit = units["track search"]
    for kw, _ in list(calls["track search"]):
        wide = dict(kw, search_radius=tracking.WIDE_RADIUS, nn_ratio=tracking.WIDE_NN_RATIO)
        calls["track search"].append((wide, _cloned(unit.fn(**wide))))
    dtypes = sorted({str(kw["img"].dtype) for kw, _ in calls["extract"]})
    radii = sorted({kw["search_radius"] for kw, _ in calls["track search"]})
    _log(f"graphs feature units: StereoSlam {slam.img_w}x{slam.img_h}, N={slam.map.N}, "
         f"{GRAPH_STEREO_FRAMES} frames, state {slam.state}; calls by kind "
         f"{ {k: len(c) for k, c in calls.items()} }; images {dtypes}, search radii {radii}")
    if slam.state != OK or len(calls["track search"]) < 6 or len(dtypes) != 2:
        raise RuntimeError(f"the stereo corridor gave no replayable calls: state "
                           f"{slam.state}, images {dtypes}, calls {len(calls['track search'])}")
    return calls


EVENT_UNITS = ("joint pose", "joint write-back", "joint local BA", "init triangulation",
               "loop propagation", "track advance", "track top-up", "pose-only",
               "MCI candidates", "chunk step")


def _event_unit_calls(units) -> dict:
    """Recorded eager calls of the event-image and continuous units on the
    card, each with its outputs, by kind (EVENT_UNITS): the joint pose
    step, its write-back, the joint local BA and the known-pose init
    triangulation through EvImageSlam on check_ev_image_small's event world
    (one more joint local BA on its final maps, each init call again with
    its two frames swapped), and the loop
    propagation, which none of its frames reaches, on its maps under three
    corrections; track advance, top-up and the pose-only solve through
    EventSlamContinuous on check_continuous_small's stream; then build_mci's
    candidates and the per-chunk step through EventWindowBuilder.step at
    the synth_ev_only width, with two builders (each one's first chunk has
    no previous image; the second posts the L2 pose prior after
    GRAPH_PRIOR_AFTER windows). Both event paths' builders record the
    candidates and chunk steps at their own widths (keys of their own)."""
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.event import feature_tracks as ft
    from eorb_slam_tpu_torch.geometry import lie
    from eorb_slam_tpu_torch.optim import pose_only
    from eorb_slam_tpu_torch.slam import ev_image_system as evi
    from eorb_slam_tpu_torch.slam import event_continuous as ec

    calls = {k: [] for k in EVENT_UNITS}
    sites = [(eb, "make_candidates", "MCI candidates"), (eb, "chunk_step", "chunk step"),
             (ft, "advance", "track advance"), (ft, "top_up", "track top-up"),
             (pose_only, "pose_optimization", "pose-only"),
             (evi, "joint_local_ba", "joint local BA"),
             (evi, "init_triangulate", "init triangulation"), (evi, "joint_pose", "joint pose"),
             (evi, "joint_writeback", "joint write-back")]
    for mod, name, kind in sites:
        setattr(mod, name, _recorder(units[kind], calls[kind]))
    cam = np.asarray([*EVW_CAM, 0, 0, 0, 0, 0], np.float32)
    try:
        world = _EvWorld(seed=5)
        slam = evi.EvImageSlam(cam, eb.BuilderConfig(**EVW_CFG), device="cuda", **EVI_KW)
        ev = world.events(0.0, EVI_FRAMES / EVI_FPS, int(EVI_RATE * EVI_FRAMES / EVI_FPS))
        last = 0.0
        for t in np.arange(EVI_FRAMES) / EVI_FPS:
            slam.track_ev_mono(ev[(ev[:, 0] > last) & (ev[:, 0] <= t)],
                               world.frame(float(t), "cuda"), float(t))
            last = t
        # one more joint local BA over the final maps, as a keyframe runs it
        evi._joint_local_ba_step(slam.im.map, slam.ev.map, slam.cam, *slam._last_gauge[1:],
                                 slam._last_gauge[0], slam.im._ba_window(),
                                 slam.ev._ba_window())
        undo = _fixed_twoview(seed=7)
        try:
            cont = ec.EventSlamContinuous(cam, eb.BuilderConfig(**EVW_CFG), device="cuda",
                                          **CONT_KW)
            stream = _EvWorld(seed=5).events(0.0, 2.4, 160000)[:CONT_EVENTS]
            for k in range(0, len(stream), CONT_PACKET):
                cont.track_events(stream[k:k + CONT_PACKET])
        finally:
            undo()
        stream = synth_stream(GRAPH_STEP_S, RATE, seed=27)
        for with_prior in (False, True):
            bld = eb.EventWindowBuilder(eb.BuilderConfig(**SLICE_CFG), _cam())
            bld.feed(stream)
            while bld.step() is not None:
                if with_prior and bld.stats["windows"] == GRAPH_PRIOR_AFTER \
                        and bld.pose_prior is None:
                    T1 = lie.se3_exp(torch.tensor([0.01, 0.0, 0.02, 0.0, 0.01, 0.0],
                                                  device="cuda"))
                    bld.set_pose_prior(torch.eye(4, device="cuda"), T1,
                                       torch.tensor(4.0, device="cuda"))
    finally:
        for mod, name, kind in sites:
            setattr(mod, name, units[kind])
    st = slam.stats
    _log(f"graphs event units: EvImageSlam {EVI_FRAMES} frames (joint inits "
         f"{st['joint_inits']}, joint frames {st['joint_frames']}, joint BAs "
         f"{st['joint_bas']}), EventSlamContinuous {cont.l2.n_kf} keyframes, "
         f"{cont.stats['windows']} windows; the builders {bld.stats}")
    unit = units["init triangulation"]
    for kw, _ in list(calls["init triangulation"][:2]):
        kw = dict(kw, d1=kw["d2"], v1=kw["v2"], xy1=kw["xy2"], T1=kw["T2"], d2=kw["d1"],
                  v2=kw["v1"], xy2=kw["xy1"], T2=kw["T1"])
        calls["init triangulation"].append((kw, _cloned(unit.fn(**kw))))
    unit = units["loop propagation"]
    im, ev_m = slam.im.map, slam.ev.map
    c, s_ = np.cos(0.1), np.sin(0.1)
    bridge = evi._bridge(np.asarray([[c, -s_, 0], [s_, c, 0], [0, 0, 1]]),
                         np.asarray([0.05, -0.02, 0.1]), 1.3, ev_m.kf_T)
    for a in (0.1, 0.2, 0.3):
        G = lie.se3_exp(torch.tensor([0.5 * a, -0.2, 0.1, 0.0, a, 0.0], device="cuda"))
        kw = dict(ev_map=ev_m, im_kf_ts=im.kf_ts, im_kf_valid=im.kf_valid, T_before=im.kf_T,
                  T_after=im.kf_T @ G, Rm=bridge[0], tm=bridge[1], sm=bridge[2])
        calls["loop propagation"].append((_call_of(unit, (), kw), _cloned(unit.fn(**kw))))
    short = {k: len(v) for k, v in calls.items() if len(v) < 3}
    if short:
        raise RuntimeError(f"event units with fewer than 3 calls to replay: {short}")
    return calls


def check_graphs_small():
    """The graph runner against the eager steps on the card. Each of the
    six units (the L1 window, the tracked image frame, local BA's LM loop,
    the keyframe mapping step, the tracked inertial frame, VI-BA's LM loop)
    is recorded eagerly, then every recorded call runs eagerly again and
    through a fresh GraphRunner: every output bit-equal. The window
    sequence changes its chunk bucket and then gains the L2 pose prior
    (have_dpose), each a new key; the frames, the BAs and the mapping steps
    cross keyframes (a map the runner copies in anew), a float64 BA is a key
    of its own and so is the mapping step at a second map capacity. The
    frames, the BAs and the mapping steps come through MonoSlam's entry
    point, the windows through step_window; the inertial frame
    runs on that MonoSlam's maps and frames with IMU windows of two buckets,
    against the last keyframe and against the PoseImuPrior its own step
    emitted (each a key); VI-BA at 8 and 24 iterations. Per kind of step:
    host-issued launches, device kernels, device ms and wall ms, eager
    against replayed; the replayed window's splat counts against the
    profiler's kernels; the host time of a replay's copy-in (every input
    tensor copied, none skipped). Then MonoSlam with speculation, through
    the module's runners: host-issued launches per tracked frame and per
    keyframe frame within GRAPH_LAUNCH_MAX."""
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.geometry import lie
    from eorb_slam_tpu_torch.optim import schur_ba
    from eorb_slam_tpu_torch.slam import local_mapping, system, tracking

    units = _runners()

    # L1 windows at the EventSlam width, eagerly through step_window
    w_calls = []
    bld = eb.EventWindowBuilder(eb.BuilderConfig(**SLICE_CFG), _cam())
    bld.feed(synth_stream(GRAPH_STREAM_S, RATE, seed=21))
    eb.window_step = _recorder(units["L1 window"], w_calls)
    try:
        for i in range(GRAPH_WINDOWS):
            bld._resolve_window_meta(block=True)
            if i == GRAPH_WINDOWS // 3:
                bld.chunk_size = SLICE_CFG["l1_chunk_size"] // 2    # a smaller bucket
            if i == 2 * GRAPH_WINDOWS // 3:
                T1 = lie.se3_exp(torch.tensor([0.01, 0.0, 0.02, 0.0, 0.01, 0.0],
                                              device="cuda"))
                bld.set_pose_prior(torch.eye(4, device="cuda"), T1,
                                   torch.tensor(4.0, device="cuda"))
            if bld.step_window() is None:
                raise RuntimeError(f"the stream ran out after {i} windows")
    finally:
        eb.window_step = units["L1 window"]
    buckets = [(kw["chunks"].shape[1], kw["have_dpose"]) for kw, _ in w_calls]
    _log(f"graphs L1 window: (chunk bucket, have_dpose) of each window {buckets}")
    if len({b for b, _ in buckets}) < 2 or not (not buckets[0][1] and buckets[-1][1]):
        raise RuntimeError(f"the window sequence changed no key: {buckets}")
    g = _replayed("L1 window", units["L1 window"], w_calls)
    kw = w_calls[-1][0]
    _, per = _profile_pure(lambda: g(**kw))
    counted = _counts()
    seen = _seen(per)[:3]
    windows = _report_costs("L1 window", g, kw)
    _log(f"graphs L1 window: one replay counted {counted} forward, VJP and ascent "
         f"launches; the profiler saw {seen} such kernels")
    if counted != seen or counted != _window_launches(SLICE_CFG["l1_num_loop"]):
        raise RuntimeError(f"a replayed window counted {counted}, ran {seen}")
    del w_calls, bld

    # MonoSlam on the rendered corridor, synchronous: its tracked frames,
    # its keyframes' mapping steps and their local BAs
    f_calls, b_calls, k_calls = [], [], []
    frames = _pipe_frames(GRAPH_FRAMES)
    cam = np.asarray([PIPE_FX, PIPE_FX, PIPE_W / 2, PIPE_H / 2, 0, 0, 0, 0, 0], np.float32)
    slam = system.MonoSlam(cam, pipelined=False, **PIPE_KW)
    tracking.track_image_frame = _recorder(units["tracked frame"], f_calls)
    schur_ba.bundle_adjust = _recorder(units["local BA"], b_calls)
    local_mapping.keyframe_mapping_step = _recorder(units["keyframe mapping"], k_calls)
    try:
        for ts, img, _ in frames:
            slam.process_image(img, ts)
        # the mapping step at a second map capacity: a key of its own (its
        # frames and BAs go through the module's runners, unrecorded)
        tracking.track_image_frame = units["tracked frame"]
        schur_ba.bundle_adjust = units["local BA"]
        slam2 = system.MonoSlam(cam, pipelined=False, **dict(PIPE_KW, M=GRAPH_M2))
        n1 = len(k_calls)
        for ts, img, _ in frames:
            slam2.process_image(img, ts)
            if len(k_calls) - n1 >= GRAPH_KF2:
                break
    finally:
        tracking.track_image_frame = units["tracked frame"]
        schur_ba.bundle_adjust = units["local BA"]
        local_mapping.keyframe_mapping_step = units["keyframe mapping"]
    maps = 1 + sum(not _bits_equal(f_calls[i - 1][0]["m"], f_calls[i][0]["m"])
                   for i in range(1, len(f_calls)))
    caps = sorted({kw["m"].M for kw, _ in k_calls})
    _log(f"graphs tracked frame: {len(f_calls)} frames over {maps} maps "
         f"({slam.stats['kf']} keyframes); keyframe mapping: {len(k_calls)} steps at map "
         f"capacities {caps}")
    if maps < 2 or len(b_calls) < 2:
        raise RuntimeError(f"{maps} maps and {len(b_calls)} BAs: no map change to replay")
    if len(caps) < 2 or n1 < 3 or len(k_calls) - n1 < 2:
        raise RuntimeError(f"keyframe mapping steps {n1} and {len(k_calls) - n1} at map "
                           f"capacities {caps}: no replay at two capacities")
    # a float64 problem: a key of its own, twice
    p64 = schur_ba.BAProblem(*[torch.from_numpy(x).to("cuda")
                               for x in _ba_problem_np(np.float64)])
    for _ in range(3):
        b_calls.append((_call_of(units["local BA"], (p64,), dict(iters=4)),
                        schur_ba._bundle_adjust(p64, iters=4)))
    vi_calls = _vi_frame_calls(units["VI frame"], slam, f_calls[0][0]["m"],
                               [img for _, img, _ in frames[-2:]])
    viba_calls = _vi_ba_calls(units["VI-BA"])
    out = {"L1 window": windows}
    for kind, calls in (("tracked frame", f_calls), ("local BA", b_calls),
                        ("keyframe mapping", k_calls), ("VI frame", vi_calls),
                        ("VI-BA", viba_calls)):
        g = _replayed(kind, units[kind], calls)
        # the inertial steps take ~1 s eagerly: one timed eager call, and
        # VI-BA's at the per-keyframe 8 iterations
        at = {"local BA": -4, "VI-BA": 2}.get(kind, -1)
        out[kind] = _report_costs(kind, g, calls[at][0],
                                  eager_reps=1 if kind.startswith("VI") else 3)
    del f_calls, b_calls, k_calls, vi_calls, viba_calls

    # the event-image and continuous units, each step's last recorded call
    # timed: the joint steps at EvImageSlam's sizes, the track units and
    # the pose-only solve at the continuous tracker's, the candidates and
    # the chunk step at the synth_ev_only width
    for kind, calls in _event_unit_calls(units).items():
        g = _replayed(kind, units[kind], calls)
        out[kind] = _report_costs(kind, g, calls[-1][0])
    # the feature-path units at the synth_euroc_stereo width, each step's
    # last recorded call timed (the search: its last wide call)
    for kind, calls in _feature_unit_calls(units).items():
        g = _replayed(kind, units[kind], calls)
        out[kind] = _report_costs(kind, g, calls[-1][0])
    # a continuous window, eagerly, by unit: l1_num_loop chunk steps and
    # track advances, the window's candidates, a top-up and one or two
    # pose-only solves, against the replays that take their place
    L = SLICE_CFG["l1_num_loop"]
    per = {k: (out[k]["eager"]["host"], out[k]["graph"]["host"]) for k in
           ("chunk step", "track advance", "MCI candidates", "track top-up", "pose-only")}
    n = {"chunk step": L, "track advance": L, "MCI candidates": 1, "track top-up": 1,
         "pose-only": 2}
    _log(f"graphs continuous window by unit, host-issued launches eager -> replay "
         f"(count x per call): " + ", ".join(
             f"{k} {n[k]} x ({e} -> {r})" for k, (e, r) in per.items())
         + f"; in all {sum(n[k] * e for k, (e, _) in per.items())} -> "
         f"{sum(n[k] * r for k, (_, r) in per.items())} with two pose-only solves, the "
         f"glue between them apart")

    # the module's runners on a speculating MonoSlam: tracked frames
    slam = system.MonoSlam(cam, pipelined=True, **PIPE_KW)
    kinds, costs = [], []
    for i, (ts, img, _) in enumerate(frames):
        c0 = _captures()
        if i < len(frames) - GRAPH_PROFILED:
            res = slam.process_image(img, ts)
        else:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res, per = _profile(lambda: slam.process_image(img, ts))
            costs.append((per.launches, 1e3 * (time.perf_counter() - t)))
        kinds.append("capture" if _captures() != c0 else _frame_kind(res))
    slam.flush_pipeline()
    tracked = [c for c, kd in zip(costs, kinds[-GRAPH_PROFILED:]) if kd == "track"]
    kf = [c for c, kd in zip(costs, kinds[-GRAPH_PROFILED:]) if kd == "KF"]
    _log(f"graphs MonoSlam {PIPE_W}x{PIPE_H} speculative, the last {GRAPH_PROFILED} frames "
         f"under torch.profiler (kind, host-issued launches, wall ms with the profiler): "
         f"{list(zip(kinds[-GRAPH_PROFILED:], costs))}")
    if not tracked:
        raise RuntimeError(f"no profiled frame was a tracked frame: {kinds}")
    if max(c for c, _ in tracked) > GRAPH_LAUNCH_MAX["frame"]:
        raise RuntimeError(f"host-issued launches per tracked frame {tracked}, above "
                           f"{GRAPH_LAUNCH_MAX['frame']}")
    if kf and max(c for c, _ in kf) > GRAPH_LAUNCH_MAX["keyframe"]:
        raise RuntimeError(f"host-issued launches per keyframe frame {kf}, above "
                           f"{GRAPH_LAUNCH_MAX['keyframe']}")
    if windows["graph"]["host"] > GRAPH_LAUNCH_MAX["window"]:
        raise RuntimeError(f"host-issued launches per replayed window "
                           f"{windows['graph']['host']}, above {GRAPH_LAUNCH_MAX['window']}")
    return out


def _kernel_nodes(raw_graph: int) -> list:
    """The function names of the kernel nodes of the cudaGraph_t
    ``raw_graph`` (CUDA driver API: cuGraphGetNodes, cuGraphNodeGetType,
    cuGraphKernelNodeGetParams_v2, cuFuncGetName or cuKernelGetName)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUresult {rc}")

    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(vp(raw_graph), None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(vp(raw_graph), nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:         # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func, grid and block dims, shared
        # bytes, kernelParams, extra, kern, ctx
        params = (ctypes.c_byte * 128)()
        ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), params), "cuGraphKernelNodeGetParams")
        func = vp.from_buffer(params, 0).value
        kern = vp.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(kern)), "cuKernelGetName")
        names.append(name.value.decode())
    return names


def check_graph_nodes():
    """Every graph the module's runners captured in this run. Each replay
    on the main path and the app paths launched one of them and added its
    capture-time counts to the hand kernels' launches; raise unless the
    kernel nodes of each graph hold exactly the hand kernels its counts
    say (by name, sym_eig summed over n), every keyframe mapping graph
    holds its triangulations' sym_eig nodes, and the main and app paths
    captured a mapping, an inertial frame, a VI-BA, an MCI candidates, a
    chunk step, a track advance and top-up, a pose-only, a joint pose and a
    joint write-back graph."""
    from eorb_slam_tpu_torch import _graphs

    held, off = {}, []
    for kind, runner in _runners().items():
        for entry in runner._entries.values():
            by = {a: d for (_, a), d in zip(_graphs._COUNTERS, entry.counts)}
            counted = (by["launches"], by["vjp_launches"], by["ascent_launches"],
                       sum(by["by_n"].values()))
            names = _kernel_nodes(entry.graph.raw_graph())
            nodes = tuple(sum(k in nm for nm in names) for k in HAND_KERNELS)
            held.setdefault(kind, []).append((counted, len(names)))
            if nodes != counted:
                off.append((kind, counted, nodes))
            # the mapping step triangulates against its 4 partners, each
            # through the sym_eig kernel, inside its one graph
            if kind == "keyframe mapping" and nodes[3] < 4:
                off.append((kind, counted, nodes))
    _log(f"graph nodes: every captured graph's kernel nodes hold the hand kernels "
         f"{HAND_KERNELS} its replays count: by kind, (count, kernel nodes) of each graph "
         f"{held}")
    if off:
        raise RuntimeError(f"graphs whose kernel nodes differ from their counts, or a "
                           f"mapping graph without its triangulations' sym_eig nodes (kind, "
                           f"counted, nodes): {off}")
    missing = [k for k in ("keyframe mapping", "VI frame", "VI-BA", "MCI candidates",
                           "chunk step", "track advance", "track top-up", "pose-only",
                           "joint pose", "joint write-back") if k not in held]
    if missing:
        raise RuntimeError(f"no path captured a graph of {missing}")


# ------------------------------------------------------------- the IMU stack

_OMEGA = np.asarray([0.12, -0.2, 0.35])
_G_W = np.asarray([0.0, 0.0, -9.81])


def _imu_state(t):
    """tests/test_imu.py's analytic trajectory: (R, p, v) at time t."""
    from eorb_slam_tpu_torch.geometry import lie

    R = lie.so3_exp(torch.tensor(_OMEGA * t, dtype=torch.float32)).numpy()
    p = np.asarray([np.sin(t), 0.5 * np.cos(2 * t), 0.1 * t])
    v = np.asarray([np.cos(t), -np.sin(2 * t), 0.1])
    return R, p, v


def _imu_window(t0, t1, bg=np.zeros(3), ba=np.zeros(3), hz=200.0):
    """Ideal gyro/acc samples on [t0, t1) plus biases, as f32 numpy."""
    n = int(round((t1 - t0) * hz))
    ts = t0 + np.arange(n) / hz
    acc = np.stack([_imu_state(t)[0].T @ (np.asarray([-np.sin(t), -2 * np.cos(2 * t), 0.0])
                                          - _G_W) for t in ts]) + ba
    gyro = np.tile(_OMEGA, (n, 1)) + bg
    return (gyro.astype(np.float32), acc.astype(np.float32),
            np.full(n, 1.0 / hz, np.float32), np.ones(n, bool))


def _kf_pre_stack(kf_times, calib, device, bg=np.zeros(3), ba=np.zeros(3)):
    from eorb_slam_tpu_torch.imu import preintegration as pre

    out = [pre.identity_preintegrated(device=device)]
    z = torch.zeros(3, device=device)
    for a, b in zip(kf_times[:-1], kf_times[1:]):
        w = [torch.from_numpy(x).to(device) for x in _imu_window(a, b, bg, ba)]
        out.append(pre.integrate(*w, z, z, calib.to(device)))
    return pre.stack(out)


def _vi_ba_problem(K, M, seed, device, dtype):
    """tests/test_imu.py's VI-BA problem (every landmark seen by every
    keyframe, two fixed gauge poses, perturbed states) at K keyframes and M
    landmarks."""
    from eorb_slam_tpu_torch import convert
    from eorb_slam_tpu_torch.geometry import lie
    from eorb_slam_tpu_torch.imu import preintegration as pre
    from eorb_slam_tpu_torch.optim import schur_ba, vi_ba

    rng = np.random.default_rng(seed)
    kf_times = np.arange(K) * 0.35 + 0.2
    Tcw = np.zeros((K, 4, 4), np.float32)
    vel = np.zeros((K, 3), np.float32)
    for k, t in enumerate(kf_times):
        R, p, v = _imu_state(t)
        Twb = np.eye(4, dtype=np.float32)
        Twb[:3, :3], Twb[:3, 3] = R, p
        Tcw[k] = np.linalg.inv(Twb)
        vel[k] = v
    lm = np.concatenate([rng.uniform(-4, 4, (M, 2)), rng.uniform(5, 12, (M, 1))], 1)
    pc = np.einsum("kij,mj->mki", Tcw[:, :3, :3], lm) + Tcw[:, :3, 3][None]
    uv = np.stack([458.0 * pc[..., 0] / pc[..., 2] + 376.0,
                   457.0 * pc[..., 1] / pc[..., 2] + 240.0], -1)
    valid = (pc[..., 2] > 0.2) & (np.abs(uv[..., 0] - 376) < 450) & (np.abs(uv[..., 1] - 240) < 300)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    for k in range(2, K):
        xi = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        Tcw[k] = lie.se3_exp(torch.from_numpy(xi)).numpy() @ Tcw[k]
        vel[k] += rng.normal(0, 0.05, 3).astype(np.float32)
    lm = lm + rng.normal(0, 0.03, lm.shape)
    calib = pre.make_calib()
    stack = _kf_pre_stack(kf_times, calib, "cpu")
    f = lambda x: torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)  # noqa: E731
    visual = schur_ba.BAProblem(
        cam_params=f([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0]), kf_T=f(Tcw),
        kf_fixed=torch.tensor([True, True] + [False] * (K - 2), device=device),
        kf_valid=torch.ones(K, dtype=torch.bool, device=device), lm_pos=f(lm),
        lm_valid=torch.ones(M, dtype=torch.bool, device=device),
        obs_kf=torch.arange(K, dtype=torch.int32, device=device).repeat(M, 1),
        obs_uv=f(uv), obs_inv_sigma=f(np.ones((M, K))),
        obs_valid=torch.from_numpy(valid).to(device))
    pre_d = pre.Preintegrated(*(x.to(device=device, dtype=dtype) for x in
                                convert.pre_from_numpy(convert.pre_to_numpy(stack))))
    return vi_ba.VIBAProblem(
        visual=visual, Tbc=f(np.eye(4)), kf_vel=f(vel), kf_bg=f(np.zeros((K, 3))),
        kf_ba=f(np.zeros((K, 3))), pre=pre_d,
        edge_valid=torch.tensor([False] + [True] * (K - 1), device=device),
        g=f(_G_W), prev=None)


def check_vi_small():
    """The IMU stack on the card against the CPU from the same seeded
    inputs (the states cross through convert.py): preintegration with
    masked padding, merge and predict_state; inertial_init to convergence;
    the motion-only VI pose optimization at the main path's 512 features;
    VI-BA converged in f32 and at the main path's 8 iterations in f64."""
    from eorb_slam_tpu_torch import convert
    from eorb_slam_tpu_torch.geometry import lie
    from eorb_slam_tpu_torch.imu import preintegration as pre
    from eorb_slam_tpu_torch.optim import inertial, vi_ba

    devs = ("cpu", "cuda")
    cpu, gpu = devs
    calib = pre.make_calib()
    t0 = time.perf_counter()
    # preintegration, merge, predict_state
    g, a, d, o = _imu_window(0.3, 0.8, bg=np.asarray([0.02, -0.01, 0.015]))
    pad = 28
    g = np.concatenate([g, np.full((pad, 3), 99.0, np.float32)])
    a = np.concatenate([a, np.full((pad, 3), -99.0, np.float32)])
    d = np.concatenate([d, np.full(pad, 0.01, np.float32)])
    o = np.concatenate([o, np.zeros(pad, bool)])
    out = {}
    for dev in devs:
        z = torch.zeros(3, device=dev)
        c = calib.to(dev)
        p1 = pre.integrate(*(torch.from_numpy(x).to(dev) for x in (g, a, d, o)), z, z, c)
        p2 = pre.integrate(*(torch.from_numpy(x).to(dev) for x in _imu_window(0.8, 1.1)), z, z, c)
        pm = pre.merge(p1, p2)
        R0, p0, v0 = (torch.as_tensor(np.asarray(x, np.float32)).to(dev) for x in _imu_state(0.3))
        ps = pre.predict_state(R0, p0, v0, pm, torch.full((3,), 0.01, device=dev), z)
        out[dev] = [x.cpu().numpy() for x in (*p1, *pm, *ps)]
    err_pre = max(float(np.abs(x - y).max()) for x, y in zip(out[cpu], out[gpu]))

    # inertial_init: 8 keyframes, vision frame rotated and scaled by 1/2.5
    K = 8
    kf_times = np.arange(K) * 0.4 + 0.1
    R_vw = lie.so3_exp(torch.tensor([0.25, -0.15, 0.0])).numpy()
    Twb = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k, t in enumerate(kf_times):
        R, p, _ = _imu_state(t)
        Twb[k, :3, :3], Twb[k, :3, 3] = R_vw @ R, (R_vw @ p) / 2.5
    stack = convert.pre_to_numpy(_kf_pre_stack(kf_times, calib, "cpu",
                                               bg=np.asarray([0.01, -0.02, 0.005]),
                                               ba=np.asarray([0.05, -0.03, 0.08])))
    ev = np.asarray([False] + [True] * (K - 1))
    init = {}
    for dev in devs:
        r = inertial.inertial_init(torch.from_numpy(Twb).to(dev),
                                   convert.pre_from_numpy(stack, dev),
                                   torch.from_numpy(ev).to(dev), prior_gyro=1e2,
                                   prior_acc=1.0, iters=60)
        init[dev] = (float(r.scale), r.g.cpu().numpy().astype(np.float64), float(r.cost))
    d_scale = abs(init[gpu][0] - init[cpu][0]) / init[cpu][0]
    gc, gg = init[cpu][1], init[gpu][1]
    d_grav = float(np.arccos(np.clip(gc @ gg / np.linalg.norm(gc) / np.linalg.norm(gg), -1, 1)))

    # pose_inertial_optimization at 512 matched features
    rng = np.random.default_rng(3)
    N = 512
    Tcw = {}
    for t in (0.5, 0.75):
        R, p, v = _imu_state(t)
        M_ = np.eye(4, dtype=np.float32)
        M_[:3, :3], M_[:3, 3] = R, p
        Tcw[t] = (np.linalg.inv(M_).astype(np.float32), v.astype(np.float32))
    lm = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(5, 10, (N, 1))], 1).astype(np.float32)
    pc = lm @ Tcw[0.75][0][:3, :3].T + Tcw[0.75][0][:3, 3]
    uv = (np.stack([458.0 * pc[:, 0] / pc[:, 2] + 376.0, 457.0 * pc[:, 1] / pc[:, 2] + 240.0], 1)
          + rng.normal(0, 0.4, (N, 2))).astype(np.float32)
    uv[:20] += 40.0
    T0 = lie.se3_exp(torch.tensor([0.02, -0.03, 0.01, 0.015, -0.02, 0.025])).numpy() @ Tcw[0.75][0]
    win = convert.pre_to_numpy(pre.integrate(*(torch.from_numpy(x) for x in _imu_window(0.5, 0.75)),
                                             torch.zeros(3), torch.zeros(3), calib))
    pose = {}
    for dev in devs:
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)  # noqa: E731
        r = vi_ba.pose_inertial_optimization(
            f([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0]), f(T0), f(Tcw[0.75][1] + 0.05),
            f(np.zeros(3)), f(np.zeros(3)), f(lm), f(uv), f(np.ones(N)),
            torch.ones(N, dtype=torch.bool, device=dev), f(Tcw[0.5][0]), f(Tcw[0.5][1]),
            convert.pre_from_numpy(win, dev), f(np.eye(4)))
        pose[dev] = (r[0].cpu().numpy(), int(r[5]))
    d_pose = float(np.abs(pose[gpu][0] - pose[cpu][0]).max())

    # VI-BA: converged in f32; the main path's 8 iterations in f64
    def ba_cost(dtype, iters):
        c = {dev: vi_ba.vi_bundle_adjust(_vi_ba_problem(16, 1024, 0, dev, dtype), iters=iters)
             for dev in devs}
        c = {dev: (float(r.cost0), float(r.cost)) for dev, r in c.items()}
        return c, abs(c[gpu][1] - c[cpu][1]) / abs(c[cpu][1])

    c32, d32 = ba_cost(torch.float32, 40)
    c64, d64 = ba_cost(torch.float64, 8)
    _log(f"IMU stack cuda vs cpu ({time.perf_counter() - t0:.1f} s): integrate (100 samples + "
         f"{pad} masked) / merge / predict_state max abs {err_pre:.3e}; inertial_init (K={K}, "
         f"60 iters) scale cpu {init[cpu][0]:.6f} cuda {init[gpu][0]:.6f} rel "
         f"{d_scale:.3e}, gravity angle {d_grav:.3e} rad, cost cpu {init[cpu][2]:.5f} cuda "
         f"{init[gpu][2]:.5f}; pose_inertial_optimization (N={N}) Tcw max abs {d_pose:.3e}, "
         f"inliers cpu {pose[cpu][1]} cuda {pose[gpu][1]}; vi_bundle_adjust K=16 M=1024 "
         f"f32 40 iters cost cpu {c32[cpu][1]:.5f} cuda {c32[gpu][1]:.5f} rel {d32:.3e} "
         f"(from {c32[cpu][0]:.2f}), f64 8 iters rel {d64:.3e}")
    for what, got, tol in (("preintegration", err_pre, VI_TOL_PRE),
                           ("inertial_init scale", d_scale, VI_TOL_SCALE),
                           ("inertial_init gravity", d_grav, VI_TOL_GRAV),
                           ("pose_inertial_optimization Tcw", d_pose, VI_TOL_POSE),
                           ("vi_bundle_adjust f32 cost", d32, VI_TOL_BA),
                           ("vi_bundle_adjust f64 cost", d64, VI_TOL_BA_F64)):
        if not got <= tol:
            raise RuntimeError(f"{what}: cuda vs cpu {got} > {tol}")
    if not (abs(init[cpu][0] - 2.5) < 0.05 and pose[cpu][1] > 400):
        raise RuntimeError(f"the IMU problems were not solved: {init[cpu]}, {pose[cpu]}")


def run_app_imu_monocular(work: str):
    """IMU_MONOCULAR through run_slam.main with the configs/synth_euroc_vi.yaml
    settings (only DS.Paths.root differs) on a generated room_01 (with its
    IMU) at 752x480, 512 features, K=32, M=4096, no --device: the card. Then
    VI_EXTRA more frames: half under the blocking-read counter, half under
    the profiler."""
    from eorb_slam_tpu_torch._host import to_device
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.io import config, synth_dataset as sd
    from eorb_slam_tpu_torch.slam import vi_system

    root = os.path.join(work, "euroc_vi")
    settings = _settings_with_root("synth_euroc_vi.yaml", root, work)
    st = config.load_settings(settings)
    Wv, Hv, fx, fps = st.cam.width, st.cam.height, st.cam.fx, st.cam.fps
    t0 = time.perf_counter()
    sd.write_euroc(root, "room_01", sd.make_scene("room", Wv, Hv, fx, n_dots=10),
                   sd.make_trajectory("room", VI_ROOM_S),
                   duration=VI_GEN_FRAMES / fps, fps=fps, verbose=False,
                   renderer=sd.make_box_renderer("room", Wv, Hv, fx))
    t_gen = time.perf_counter() - t0
    states, inits, t_map, slams, kinds = [], [], [], [], []
    process = vi_system.MonoInertialSlam.process_image_imu
    insert = vi_system.MonoInertialSlam._insert_keyframe
    run_seq = run_slam.run_sequence
    sy, pre = _Syncs(), _PreInit()

    def recording(self, img, ts, imu, **kw):
        res = pre(not self.imu_initialized and self.state == vi_system.OK,
                  lambda: process(self, img, ts, imu, **kw))
        sy.mark()
        states.append(res["state"])
        inits.append(self.imu_initialized)
        kinds.append(_frame_kind(res) + (" VI" if self.imu_initialized else ""))
        return res

    def timed_insert(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        insert(self, *a, **kw)
        torch.cuda.synchronize()
        t_map.append(time.perf_counter() - t)

    def keep(st, seq, **kw):
        slam, out = run_seq(st, seq, **kw)
        slams.append((slam, seq))
        return slam, out

    vi_system.MonoInertialSlam.process_image_imu = recording
    vi_system.MonoInertialSlam._insert_keyframe = timed_insert
    run_slam.run_sequence = keep
    try:
        with sy:
            (out,) = run_slam.main([settings, "--sequence", "room_01", "--eval",
                                    "--max-frames", str(VI_FRAMES),
                                    "--out", os.path.join(work, "results_vi")])
            torch.cuda.synchronize()
    finally:
        vi_system.MonoInertialSlam.process_image_imu = process
        vi_system.MonoInertialSlam._insert_keyframe = insert
        run_slam.run_sequence = run_seq
    app_reads = _Reads(sy, kinds)
    slam, seq = slams[0]
    ev = out.get("eval", {})
    sim3 = run_slam.evaluate(seq, out["trajectory_file"], monocular=True)
    n = len(states)
    first_ok = states.index(vi_system.OK) if vi_system.OK in states else n
    after = states[first_ok:]
    n_ok = sum(s == vi_system.OK for s in after)
    init_at = inits.index(True) if True in inits else None
    ms_frame = out["avg_track_ms"]
    ms_map = 1e3 * sum(t_map) / max(n, 1)
    # blocking reads, then launches and device time, per frame
    dt_frame = float(np.median(np.diff(seq.image_ts)))
    reads, per_frame, host = [], [], []
    for k, i in enumerate(range(VI_FRAMES, VI_FRAMES + VI_EXTRA)):
        img = to_device((seq.image(i) * 255.0).astype(np.uint8), slam.device)
        t, t_prev = float(seq.image_ts[i]), float(seq.image_ts[i - 1])
        chunk = run_slam._imu_chunk(seq, t_prev, t)
        if k < VI_READ_FRAMES:
            with _Syncs() as sy:
                slam.process_image_imu(img, t, chunk)
                sy.mark()
            reads.append(sy.steps[0])
        else:
            c0 = _captures()
            r, per = _profile(lambda: slam.process_image_imu(img, t, chunk))
            per_frame.append((sum(c for c, _ in per.values()),
                              sum(us for _, us in per.values()) / 1e3))
            host.append(("capture" if _captures() != c0 else
                         _frame_kind(r) + (" VI" if slam.imu_initialized else ""),
                         per.launches))
    data_s = n * dt_frame
    path_len = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    _log(f"run_slam IMU_MONOCULAR {slam.img_w}x{slam.img_h}, N={slam.map.N}, K={slam.map.K}, "
         f"M={slam.map.M}, on {out['device']}: room_01 ({VI_GEN_FRAMES} frames generated "
         f"in {t_gen:.2f} s); {n} frames in {out['wall_s']:.3f} s wall = "
         f"{n / out['wall_s']:.3f} frames/s (real-time x {data_s / out['wall_s']:.4f}); "
         f"{ms_frame:.2f} ms per frame, of which keyframe mapping (with VI-BA / IMU init) "
         f"{ms_map:.2f} ms ({len(t_map)} keyframes, "
         f"{1e3 * sum(t_map) / max(len(t_map), 1):.2f} ms each, synchronised); initialised "
         f"at frame {first_ok}, then {n_ok}/{len(after)} tracked; IMU initialised at frame "
         f"{init_at} (the JAX app on the CPU, same data: frame {VI_INIT_REF}); scale applied "
         f"{slam.scale_applied:.4f}; {len(slam.pending_world_transforms)} world transforms")
    app_reads.log("run_slam IMU_MONOCULAR (the app run)", "frame")
    app_reads.not_above("IMU_MONOCULAR", "frame")
    app_reads.at_most("IMU_MONOCULAR", READS_APP_MAX["IMU_MONOCULAR"])
    pre.log("IMU_MONOCULAR", "frame")
    _log(f"run_slam IMU_MONOCULAR per frame after the init: {np.mean(reads):.1f} blocking "
         f"reads (each frame: {reads}); under torch.profiler "
         f"{np.mean([c for c, _ in per_frame]):.0f} device launches and "
         f"{np.mean([t for _, t in per_frame]):.2f} ms of device time (per frame: "
         f"{[(c, round(t, 2)) for c, t in per_frame]}); host-issued launches per frame "
         f"(kind, launches): {host}")
    _log(f"run_slam IMU_MONOCULAR accuracy: ATE SE3 (scale fixed at 1) {ev.get('ate_rmse')} m "
         f"over {ev.get('ate_n')} poses; Sim3 {sim3.get('ate_rmse')} m, fitted scale "
         f"{sim3.get('ate_scale')}; path {path_len:.4f} m; stats {out['stats']}")
    if out["device"] != "cuda" or slam.map.N != 512 or (slam.img_w, slam.img_h) != (752, 480) \
            or (slam.map.K, slam.map.M) != (32, 4096):
        raise RuntimeError(f"not the full width on the card: {out['device']} N={slam.map.N}")
    if not after or n_ok < 0.8 * len(after):
        raise RuntimeError(f"only {n_ok}/{len(after)} frames tracked after init")
    if not slam.imu_initialized:
        raise RuntimeError("the IMU did not initialize")
    if not (np.isfinite(ev.get("ate_rmse", np.inf)) and np.isfinite(sim3.get("ate_rmse", np.inf))):
        raise RuntimeError(f"evaluate gave {ev} / {sim3}")
    vi_host = [c for kd, c in host if kd == "track VI"]
    if not vi_host or max(vi_host) > GRAPH_LAUNCH_MAX["vi frame"]:
        raise RuntimeError(f"host-issued launches per tracked inertial frame {vi_host}: none "
                           f"profiled, or above {GRAPH_LAUNCH_MAX['vi frame']} ({host})")
    return dict(frames=n, wall_s=out["wall_s"], reads=app_reads)


def run_app_event_imu(work: str, data_root: str):
    """EVENT_IMU through run_slam.main with the configs/synth_ev_imu.yaml
    settings on the generated shakes sequence (its imu.txt), no --device:
    the card; scored with --eval."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam import event_inertial

    settings = _settings_with_root("synth_ev_imu.yaml", data_root, work)
    rec, slams, pre = [], [], _PreInit()
    track_mci = event_inertial.EventInertialSlam._track_mci
    run_seq = run_slam.run_sequence
    OK = event_inertial.slam_system.OK

    def recording(self, pi):
        res = pre(not self.l2.imu_initialized and self.l2.state == OK,
                  lambda: track_mci(self, pi))
        rec.append(res)
        return res

    def keep(st, seq, **kw):
        slam, out = run_seq(st, seq, **kw)
        slams.append((slam, seq))
        return slam, out

    event_inertial.EventInertialSlam._track_mci = recording
    run_slam.run_sequence = keep
    _reset_counts()
    try:
        (out,) = run_slam.main([settings, "--sequence", "shakes_01", "--eval",
                                "--out", os.path.join(work, "results_evimu")])
        torch.cuda.synchronize()
    finally:
        event_inertial.EventInertialSlam._track_mci = track_mci
        run_slam.run_sequence = run_seq
    launches, vjp, asc = _counts()
    slam, seq = slams[0]
    # --eval scores an inertial mode with the scale fixed; until the IMU
    # initializes the map has the monocular gauge, so the gate is Sim3
    st, se3 = out["stats"], out.get("eval", {})
    ev = run_slam.evaluate(seq, out["trajectory_file"], monocular=True)
    n = st["mci"]
    states = [r["state"] for r in rec]
    first_ok = states.index(OK) if OK in states else n
    after = states[first_ok:]
    n_ok = sum(s == OK for s in after)
    path_len = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    ate_frac = ev.get("ate_rmse", float("inf")) / max(path_len, 1e-12)
    last_ts = rec[-1]["ts"] if rec else -np.inf
    # run_sequence pushes the IMU rows in (first event, last chunk's end]
    evs = seq.events.events
    pushed = int(((seq.imu.ts > evs[0, 0]) & (seq.imu.ts <= evs[seq.events.cursor - 1, 0])).sum())
    left_early = int((slam.imu._ts <= last_ts).sum())
    _log(f"run_slam EVENT_IMU on {out['device']}: {n} MCIs from {out['iterations']} chunks in "
         f"{out['wall_s']:.3f} s wall = {n / out['wall_s']:.3f} MCIs/s (real-time x "
         f"{GEN_S / out['wall_s']:.4f}); initialised at MCI {first_ok}, then {n_ok}/"
         f"{len(after)} tracked; imu_initialized {slam.imu_initialized} (not gated); splat "
         f"launches {launches} forward + {vjp} VJP + {asc} ascent for {st['windows']} "
         f"windows; IMU samples "
         f"{slam.imu.popped} taken by {n} MCI windows, {len(slam.imu)} left after the last "
         f"MCI ({left_early} of them not later than it), {pushed} pushed")
    _log(f"run_slam EVENT_IMU accuracy: ATE rmse {ev.get('ate_rmse')} m over {ev.get('ate_n')} "
         f"poses (Sim3-aligned, scale {ev.get('ate_scale')}), path {path_len:.4f} m -> "
         f"{100 * ate_frac:.2f}% of the path; SE3 (scale fixed at 1, --eval) "
         f"{se3.get('ate_rmse')} m; stats {st}")
    pre.log("EVENT_IMU", "MCI")
    if out["device"] != "cuda":
        raise RuntimeError(f"run_slam ran on {out['device']}")
    if not after or n_ok < EVI_TRACK_MIN * len(after):
        raise RuntimeError(f"only {n_ok}/{len(after)} windows tracked after init")
    per_window = _window_launches(SLICE_CFG["l1_num_loop"])
    if (launches, vjp, asc) != tuple(st["windows"] * c for c in per_window):
        raise RuntimeError(f"{(launches, vjp, asc)} launches for {st['windows']} windows, "
                           f"expected {per_window} per window")
    if left_early or slam.imu.popped + len(slam.imu) != pushed or slam.imu.popped == 0:
        raise RuntimeError("the IMU buffer did not hand out every sample up to the last MCI")
    if not (np.isfinite(ev.get("ate_rmse", np.inf)) and ev["ate_n"] >= APP_MIN_ATE_N):
        raise RuntimeError(f"evaluate gave {ev}")
    if not ate_frac <= APP_ATE_MAX:
        raise RuntimeError(f"ATE is {ate_frac} of the path > {APP_ATE_MAX}")
    return dict(launches=launches, vjp_launches=vjp, ascent_launches=asc, mcis=n,
                wall_s=out["wall_s"])


# ------------------------------------------------- stereo, depth and loops


def _ids_equal(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if not np.array_equal(a, b):
        raise RuntimeError(f"{what}: {int((a != b).sum())} of {a.size} entries differ")


def check_depth_small():
    """The depth modules on the card against the CPU from the same inputs:
    stereo_match on a rendered corridor pair at the synth_euroc_stereo width
    (752x480, 512 features per image, baseline 0.11 m), depth_from_depthmap
    on that frame's depth map, create_depth_landmarks into a map."""
    from eorb_slam_tpu_torch.geometry import camera as cam_mod
    from eorb_slam_tpu_torch.io import synth_dataset as sd
    from eorb_slam_tpu_torch.ops import frontend, stereo_match
    from eorb_slam_tpu_torch.slam import local_mapping, map_state

    Wd, Hd, fx = 752, 480, 458.0
    cam = torch.tensor([fx, fx, Wd / 2, Hd / 2, 0, 0, 0, 0, 0], dtype=torch.float32)
    render = sd.make_box_renderer("corridor", Wd, Hd, fx)
    Tcw = np.asarray(sd.make_trajectory("corridor", 10.0)(1.0), np.float32)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -DEPTH_BASELINE
    img_l, depth_map = render.with_depth(Tcw)
    img_r = render(T_rl @ Tcw)
    fl = frontend.extract(img_l * 255.0, max_kp=512)
    fr = frontend.extract(img_r * 255.0, max_kp=512)
    xy_l, xy_r = cam_mod.undistort_points(cam.cuda(), fl.xy), cam_mod.undistort_points(cam.cuda(), fr.xy)
    args = (xy_l, fl.octave, fl.desc_pm1, fl.valid, xy_r, fr.octave, fr.desc_pm1, fr.valid)
    t0 = time.perf_counter()
    out = {d: stereo_match.stereo_match(*(a.to(d) for a in args), fx, DEPTH_BASELINE)
           for d in ("cuda", "cpu")}
    (dg, ug, okg), (dc, uc, okc) = out["cuda"], out["cpu"]
    _ids_equal(okg, okc, "stereo_match matched set")
    _ids_equal(ug, uc, "stereo_match u_right")
    ok = okc.numpy()
    rel = float(np.max(np.abs(dg.cpu().numpy()[ok] - dc.numpy()[ok]) / dc.numpy()[ok]))
    if rel > DEPTH_TOL or ok.sum() < 100:
        raise RuntimeError(f"stereo depth rel err {rel} over {ok.sum()} matches")
    dmg, vg = stereo_match.depth_from_depthmap(fl.xy, depth_map, fl.valid)
    dmc, vc = stereo_match.depth_from_depthmap(fl.xy.cpu(), depth_map.cpu(), fl.valid.cpu())
    _ids_equal(dmg, dmc, "depth_from_depthmap depth")
    _ids_equal(vg, vc, "depth_from_depthmap valid")
    maps = {}
    for d in ("cuda", "cpu"):
        m = map_state.empty_map(K=8, M=2048, N=512, P=8, device=d)
        m = map_state.insert_keyframe(
            m, 3, torch.from_numpy(Tcw).to(d), 1.0, xy_l.to(d), fl.octave.to(d),
            fl.angle.to(d), fl.desc_pm1.to(d), fl.valid.to(d),
            torch.full((512,), -1, dtype=torch.int32, device=d))
        maps[d] = local_mapping.create_depth_landmarks(m, cam.to(d), 3, dc.to(d))
    (mg, ng), (mc, nc) = maps["cuda"], maps["cpu"]
    for k in ("lm_valid", "kf_feat_lm", "obs_kf", "obs_feat", "obs_valid", "lm_nobs"):
        _ids_equal(getattr(mg, k), getattr(mc, k), f"create_depth_landmarks {k}")
    pos_err = float((mg.lm_pos.cpu() - mc.lm_pos).abs().max())
    if pos_err > DEPTH_POS_TOL or int(ng) != int(nc) or int(nc) < 100:
        raise RuntimeError(f"create_depth_landmarks: {int(ng)} vs {int(nc)}, pos {pos_err}")
    _log(f"depth modules cuda vs cpu (752x480 corridor pair, baseline {DEPTH_BASELINE} m): "
         f"stereo_match {int(ok.sum())} of {int(fl.valid.sum())} left features matched, the "
         f"same set and u_right, depth rel err {rel:.2e}; depth_from_depthmap equal "
         f"({int(vc.sum())} with depth); create_depth_landmarks {int(nc)} landmarks, tables "
         f"equal, positions {pos_err:.2e}; {time.perf_counter() - t0:.2f} s")


def _dot_scene(seed, n):
    """tests/test_loop_closing.py's dot scene at 240x180 (fx 200), rendered
    with the plain splat on the CPU: float images in [0,255]."""
    from eorb_slam_tpu_torch.event import tensorize

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(6, 12, n)], 1)
    amp = torch.tensor(rng.uniform(0.3, 1.0, n), dtype=torch.float32)

    def render(x, y=0.0):
        pc = pts - np.asarray([x, y, 0.0])
        uv = np.stack([200.0 * pc[:, 0] / pc[:, 2] + 120.0,
                       200.0 * pc[:, 1] / pc[:, 2] + 90.0], 1).astype(np.float32)
        ok = (pc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < 240) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < 180)
        img = tensorize.splat_gauss(torch.from_numpy(uv), torch.from_numpy(ok), amp,
                                    180, 240, sigma=1.2)
        return tensorize.normalize_to_image(img) * 255.0

    return render


def _circle_map():
    """tests/test_loop_closing.py's closed circle of 10 keyframes on the
    CPU (752x480, fx 458): nine on a circle of radius 4 looking inward with
    a drift of (0.02, 0, 0.01 m; 0.004, 0, -0.004 rad) per step, and a tenth
    that revisits the first's view through drifted duplicate landmarks.
    Returns (map, cam, descriptors)."""
    from eorb_slam_tpu_torch.geometry import camera, lie
    from eorb_slam_tpu_torch.slam import map_state

    rng = np.random.default_rng(7)
    K, N, M = 10, 96, 300
    cam = camera.make_pinhole(458.0, 457.0, 376.0, 240.0)
    T_gt = []
    for k in range(K - 1):
        a = 2 * np.pi * k / (K - 1)
        c = np.array([4.0 * np.cos(a), 4.0 * np.sin(a), 0.0])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        Rwc = np.stack([x, np.cross(z, x), z], 1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = Rwc.T, -Rwc.T @ c
        T_gt.append(T)
    T_gt = np.stack(T_gt + T_gt[:1])
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (M, 2)), rng.uniform(-1.5, 1.5, (M, 1))],
                         1).astype(np.float32)
    descs = (rng.integers(0, 2, (M, 256)) * 2 - 1).astype(np.int8)
    T_est, err = T_gt.copy(), np.eye(4, dtype=np.float32)
    step = lie.se3_exp(torch.tensor([0.02, 0.0, 0.01, 0.004, 0.0, -0.004])).numpy()
    for k in range(1, K):
        err = err @ step
        T_est[k] = T_gt[k] @ err
    m = map_state.empty_map(K=16, M=512, N=N, P=12, device="cpu")
    lm_pos, lm_valid = m.lm_pos.clone(), m.lm_valid.clone()
    lm_pos[:M], lm_valid[:M] = torch.from_numpy(pts), True
    vis0 = (np.arange(N) - N // 2) % M
    pc = pts[vis0] @ T_gt[K - 1][:3, :3].T + T_gt[K - 1][:3, 3]
    Twc = np.linalg.inv(T_est[K - 1])
    dup = M + np.arange(N)
    lm_pos[dup] = torch.from_numpy((pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32))
    lm_valid[dup] = True
    first = m.lm_first_kf.clone()
    first[dup] = K - 1
    m = m._replace(lm_pos=lm_pos, lm_valid=lm_valid, lm_first_kf=first)
    for k in range(K):
        vis = (np.arange(N) + (k % (K - 1)) * M // (K - 1) - N // 2) % M
        lm_ids = dup if k == K - 1 else vis
        pc = pts[vis] @ T_gt[k][:3, :3].T + T_gt[k][:3, 3]
        uv = camera.pinhole_project_linear(cam, torch.from_numpy(pc))
        m = map_state.insert_keyframe(
            m, k, torch.from_numpy(T_est[k]), float(k), uv, torch.zeros(N, dtype=torch.int32),
            torch.zeros(N), torch.from_numpy(descs[vis]), torch.ones(N, dtype=torch.bool),
            torch.from_numpy(lm_ids.astype(np.int32)))
    return m, cam, descs


def check_loop_closure_small():
    """A loop closed on the card and on the CPU from one map (the circle of
    tests/test_loop_closing.py and tests/test_torch_loop_closing.py):
    LoopCloser.detect_and_correct four times with the reference's
    consistency gate of 3, the Sim3 minimal sets from one numpy generator
    on both devices. Gates: the chain rejects the first two queries, the
    third welds (verify, projection check, pose graph, landmark correction,
    fusion across the weld, the 10-iteration BA), the fourth is in the
    cooldown, on both devices; the welded map's integer tables equal and
    kf_T / lm_pos within LOOP_CORRECT_TOL."""
    from eorb_slam_tpu_torch.geometry import sim3_solver
    from eorb_slam_tpu_torch.retrieval import bow
    from eorb_slam_tpu_torch.slam import loop_closing, map_state

    t0 = time.perf_counter()
    m_cpu, cam, descs = _circle_map()
    words = bow.train_vocab(torch.from_numpy(descs), 32, iters=3)
    draw = sim3_solver._draw_minimal_sets
    out = {}
    try:
        for d in ("cuda", "cpu"):
            rng = np.random.default_rng(3)

            def fixed_sets(generator, probs, n_hyp, _rng=rng):
                p = probs.double().cpu().numpy()
                p = p / p.sum() if p.sum() > 0 else None
                return torch.from_numpy(_rng.choice(len(probs), (n_hyp, 3), p=p))

            sim3_solver._draw_minimal_sets = fixed_sets
            m = map_state.MapState(*(x.to(d) for x in m_cpu))
            lc = loop_closing.LoopCloser(cam, words, Kmax=16, min_inliers=15,
                                         consistency_required=3, sparse_words_per_kf=96,
                                         device=d)
            lc.min_candidate_gap = 5
            for k in range(9):
                lc.add_keyframe(m, k)
            calls = []
            for call in range(4):
                m2, info = lc.detect_and_correct(m, 9, run_gba=call < 3)
                calls.append((info, m2 if info.detected else None))
            out[d] = (calls, lc.last_fuse_count)
    finally:
        sim3_solver._draw_minimal_sets = draw
    got = {d: [i.detected for i, _ in out[d][0]] for d in out}
    info = {d: [(i.matched, i.n_inliers, round(i.scale, 5)) for i, _ in out[d][0]] for d in out}
    welded = {d: next((m for _, m in out[d][0] if m is not None), None) for d in out}
    if got["cuda"] != [False, False, True, False] or got["cpu"] != got["cuda"] \
            or welded["cuda"] is None:
        raise RuntimeError(f"loop closure: detected {got}, (candidate, inliers, scale) {info}")
    for k in ("kf_feat_lm", "obs_valid", "lm_valid"):
        _ids_equal(getattr(welded["cuda"], k), getattr(welded["cpu"], k), f"welded {k}")
    errs = {k: float((getattr(welded["cuda"], k).cpu() - getattr(welded["cpu"], k)).abs().max())
            for k in ("kf_T", "lm_pos")}
    moved = float((welded["cpu"].kf_T - m_cpu.kf_T).abs().max())
    _log(f"loop closure cuda vs cpu (circle of 10 keyframes, 752x480): detected "
         f"{got['cuda']} on both; (candidate, Sim3 inliers, scale) cuda {info['cuda']}, cpu "
         f"{info['cpu']}; fused across the weld cuda {out['cuda'][1]} cpu {out['cpu'][1]}; "
         f"the weld moved kf_T by {moved:.4f}; welded kf_T max abs {errs['kf_T']:.2e}, lm_pos "
         f"{errs['lm_pos']:.2e} (tol {LOOP_CORRECT_TOL}); integer tables equal; "
         f"{time.perf_counter() - t0:.2f} s")
    if max(errs.values()) > LOOP_CORRECT_TOL or info["cuda"] != info["cpu"] \
            or out["cuda"][1] != out["cpu"][1] or moved < 1e-3:
        raise RuntimeError(f"loop closure: cuda vs cpu {errs}, {info}, fused "
                           f"{out['cuda'][1]} / {out['cpu'][1]}, moved {moved}")


def check_loop_small():
    """Place recognition and loop closing on the card against the CPU:
    sim3_ransac with fixed minimal sets, optimize_pose_graph in float64 (the
    sim3 and 4-DoF charts), BoW quantization, scores and top-k (flat and
    2-level), a loop closed on one map (check_loop_closure_small); then
    tests/test_loop_closing.py's merge-after-loss scene through
    MonoSlam(loop_words=...) on the card: the stored map is found by its
    BoW index and welded in (map_merges >= 1)."""
    from eorb_slam_tpu_torch.geometry import lie, sim3_solver
    from eorb_slam_tpu_torch.ops import frontend
    from eorb_slam_tpu_torch.optim import pose_graph
    from eorb_slam_tpu_torch.retrieval import bow
    from eorb_slam_tpu_torch.slam import system

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    # Sim3 RANSAC, 30% outliers, the same minimal sets on both devices
    N = 512
    P = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(3, 8, (N, 1))], 1)
    R = lie.so3_exp(torch.tensor([0.05, 0.1, -0.05])).numpy()
    Q = 1.3 * P @ R.T + [0.2, 0.1, -0.3]
    out = rng.random(N) < 0.3
    Q[out] += rng.normal(0, 1.0, (out.sum(), 3))
    sets = torch.from_numpy(rng.integers(0, N, (128, 3)))
    draw = sim3_solver._draw_minimal_sets
    sim3_solver._draw_minimal_sets = lambda g, probs, n: sets.to(probs.device)
    try:
        res = {d: sim3_solver.sim3_ransac(
            torch.tensor(P, dtype=torch.float32, device=d),
            torch.tensor(Q, dtype=torch.float32, device=d),
            torch.ones(N, dtype=torch.bool, device=d), None,
            torch.full((N,), 9.21, device=d), _cam(d), _cam(d)) for d in ("cuda", "cpu")}
    finally:
        sim3_solver._draw_minimal_sets = draw
    _ids_equal(res["cuda"].inliers, res["cpu"].inliers, "sim3_ransac inliers")
    s_err = max(float((getattr(res["cuda"], k).cpu() - getattr(res["cpu"], k)).abs().max())
                for k in ("R", "t", "s"))
    if s_err > SIM3_TOL or int(res["cpu"].n_inliers) < 0.8 * (~out).sum():
        raise RuntimeError(f"sim3_ransac: R/t/s err {s_err}, {int(res['cpu'].n_inliers)} inliers")
    # pose graph, float64: a drifted loop of 24 keyframes with a loop edge
    K, E = 24, 64
    ang = 2 * np.pi * np.arange(K) / K
    T = [lie.se3_exp(torch.tensor([3 * np.cos(a), 3 * np.sin(a), 0.0, 0.0, 0.0, a],
                                  dtype=torch.float64)) for a in ang]
    T_gt = torch.stack(T)
    drift = lie.se3_exp(torch.tensor([0.01, -0.005, 0.01, 0.002, 0.003, -0.002],
                                     dtype=torch.float64))
    T_est, acc = [T_gt[0]], torch.eye(4, dtype=torch.float64)
    for k in range(1, K):
        acc = acc @ drift
        T_est.append(T_gt[k] @ acc)
    T_est = torch.stack(T_est)
    pairs = [(k, k + 1) for k in range(K - 1)] + [(K - 1, 0)]
    ei = torch.zeros(E, dtype=torch.int32)
    ej = torch.zeros(E, dtype=torch.int32)
    ew = torch.zeros(E, dtype=torch.float64)
    eT = torch.eye(4, dtype=torch.float64).repeat(E, 1, 1)
    for n, (i, j) in enumerate(pairs):
        ei[n], ej[n], ew[n] = i, j, 1.0
        eT[n] = T_gt[j] @ torch.linalg.inv(T_gt[i])
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    pg_err = {}
    for chart in ("sim3", "4dof"):
        g = {d: pose_graph.PoseGraph(
            R=T_est[:, :3, :3].to(d), t=T_est[:, :3, 3].to(d),
            s=torch.ones(K, dtype=torch.float64, device=d),
            kf_valid=torch.ones(K, dtype=torch.bool, device=d), fixed=fixed.to(d),
            edge_i=ei.to(d), edge_j=ej.to(d), edge_R=eT[:, :3, :3].to(d),
            edge_t=eT[:, :3, 3].to(d), edge_s=torch.ones(E, dtype=torch.float64, device=d),
            edge_w=ew.to(d)) for d in ("cuda", "cpu")}
        o = {d: pose_graph.optimize_pose_graph(g[d], iters=15, chart=chart) for d in g}
        pg_err[chart] = max(float((getattr(o["cuda"], k).cpu() - getattr(o["cpu"], k)).abs().max())
                            for k in ("R", "t", "s"))
        moved = float((o["cpu"].t - g["cpu"].t).abs().max())
        if pg_err[chart] > POSE_GRAPH_TOL_F64 or moved < 1e-3:
            raise RuntimeError(f"pose graph {chart}: cuda vs cpu {pg_err[chart]}, moved {moved}")
    # BoW: a flat and a 2-level vocabulary from random descriptors
    descs = torch.from_numpy(rng.integers(0, 2, (2048, 256)).astype(np.int8) * 2 - 1)
    words = bow.train_vocab(descs.cuda(), 256, iters=4)
    voc = bow.train_hier_vocab(descs.cuda(), K1=16, K2=16, iters=4)
    frames = [descs[rng.choice(2048, 512, replace=False)] for _ in range(12)]
    valid = torch.from_numpy(rng.random(512) > 0.05)
    bow_err, bres = 0.0, {}
    for d in ("cuda", "cpu"):
        db = bow.empty_database(16, 256, d)
        sdb = bow.empty_sparse_database(16, 512, d)
        w, v = words.to(d), bow.HierVocab(*(x.to(d) for x in voc))
        for i, f in enumerate(frames[:10]):
            db = bow.add_keyframe(db, i, bow.quantize(f.to(d), valid.to(d), w)[1])
            sdb = bow.sparse_add_keyframe(sdb, i, *bow.quantize_hier(f.to(d), valid.to(d), v))
        q = frames[0]
        wid, bq = bow.quantize(q.to(d), valid.to(d), w)
        hid, hw = bow.quantize_hier(q.to(d), valid.to(d), v)
        row = bow.sparse_bow_row(hid, hw)
        excl = torch.zeros(16, dtype=torch.bool, device=d)
        bres[d] = (wid, hid, bow.detect_candidates(db, bq, excl, top_k=4),
                  bow.sparse_detect_candidates(sdb, *row, excl, top_k=4),
                  bow.all_scores(db, bq), bow.sparse_all_scores(sdb, *row))
    (wg, hg, dg, sg, ag, sag), (wc, hc, dc, sc, ac, sac) = bres["cuda"], bres["cpu"]
    _ids_equal(wg, wc, "quantize word ids")
    _ids_equal(hg, hc, "quantize_hier word ids")
    for (sa, ia), (sb, ib), what in ((dg, dc, "detect_candidates"),
                                     (sg, sc, "sparse_detect_candidates")):
        _ids_equal(ia, ib, f"{what} top-k")
        bow_err = max(bow_err, float((sa.cpu() - sb).abs().max()))
    bow_err = max(bow_err, float((ag.cpu() - ac).abs().max()),
                  float((sag.cpu() - sac).abs().max()))
    if bow_err > BOW_TOL or int(dc[1][0]) != 0:
        raise RuntimeError(f"BoW scores differ by {bow_err}, or the revisit ranks {dc[1]}")
    t_mods = time.perf_counter() - t0
    check_loop_closure_small()
    # the merge-after-loss scene on the card
    render = _dot_scene(8, 300)
    cam = np.asarray([200.0, 200.0, 120.0, 90.0, 0, 0, 0, 0, 0], np.float32)
    f0 = frontend.extract(render(0.0).cuda(), max_kp=256)
    slam = system.MonoSlam(cam, img_w=240, img_h=180, N=256, K=32, M=4096,
                           min_init_matches=30, min_track_inliers=8,
                           max_frames_between_kf=2, loop_min_gap=99,
                           loop_words=bow.train_vocab(f0.desc_pm1, 32, iters=3))
    slam.lost_grace = 2
    frames = [(render(float(x)), 0.1 * i) for i, x in enumerate(np.arange(0.0, 1.4, 0.04))]
    frames += [(torch.zeros(180, 240), 10.0 + 0.1 * k) for k in range(6)]
    frames += [(render(float(x), 0.05), 20.0 + 0.1 * i)
               for i, x in enumerate(np.arange(0.3, 1.5, 0.06))]
    frames = [(img.cuda(), ts) for img, ts in frames]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stored = 0
    for img, ts in frames:
        slam.process_image(img, ts)
        stored = max(stored, slam.atlas.n_maps())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    _log(f"loop modules cuda vs cpu: sim3_ransac {int(res['cpu'].n_inliers)} of {N} inliers, the "
         f"same set, R/t/s {s_err:.2e}; optimize_pose_graph f64 (K={K}, 15 iterations) sim3 "
         f"{pg_err['sim3']:.2e}, 4dof {pg_err['4dof']:.2e}; BoW word ids and top-k equal, "
         f"scores {bow_err:.2e}; {t_mods:.2f} s")
    _log(f"merge-after-loss scene on {slam.device}, 240x180: {len(frames)} frames in "
         f"{wall:.2f} s; {stored} maps at the most, map_merges {slam.map_merges}, "
         f"{slam.atlas.n_maps()} map(s) left, {slam.n_kf} keyframes, lost {slam.stats['lost']}, "
         f"final state {slam.state}")
    if slam.device.type != "cuda" or stored < 2 or slam.map_merges < 1 \
            or slam.atlas.n_maps() != 1 or slam.state != system.OK:
        raise RuntimeError(f"no merge after the loss: {slam.stats}")


class _LoopLog:
    """The eorb.loop gate decisions while active."""

    def __enter__(self):
        import logging

        rec = self.lines = []

        class H(logging.Handler):
            def emit(self, r):
                rec.append(r.getMessage())

        self._h = H()
        logging.getLogger("eorb.loop").addHandler(self._h)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("eorb.loop").removeHandler(self._h)
        return False


def _run_app_image(work, config, root, seq, cls, method, frames, extra, step, tag):
    """run_slam.main with configs/<config> (only DS.Paths.root differs) on
    `seq`, with --eval and no --device: the card. Each `cls.method` call is
    recorded (state, IMU initialized); the splat counters are zeroed before
    the run and read after it. Then `extra` more frames through
    ``step(slam, seq, i)``: half under the blocking-read counter, half under
    the profiler."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam.system import OK

    settings = _settings_with_root(config, root, work)
    rec, slams, kinds = [], [], []
    fn, run_seq = getattr(cls, method), run_slam.run_sequence
    sy, pre = _Syncs(), _PreInit()

    def recording(self, *a, **kw):
        res = pre(getattr(self, "imu_initialized", True) is False and self.state == OK,
                  lambda: fn(self, *a, **kw))
        sy.mark()
        rec.append((res["state"], bool(getattr(self, "imu_initialized", False)),
                    bool(res.get("new_map")), self.map_merges))
        kinds.append(_frame_kind(res) + (" VI" if rec[-1][1] else ""))
        return res

    def keep(st, s, **kw):
        slam, out = run_seq(st, s, **kw)
        slams.append((slam, s))
        return slam, out

    setattr(cls, method, recording)
    run_slam.run_sequence = keep
    _reset_counts()
    try:
        with _LoopLog() as loop_log, sy:
            (out,) = run_slam.main([settings, "--sequence", seq, "--eval",
                                    "--max-frames", str(frames),
                                    "--out", os.path.join(work, f"results_{tag}")])
            torch.cuda.synchronize()
    finally:
        setattr(cls, method, fn)
        run_slam.run_sequence = run_seq
    app_reads = _Reads(sy, kinds)
    launches = _counts()
    slam, sq = slams[0]
    sim3 = run_slam.evaluate(sq, out["trajectory_file"], monocular=True)
    reads, per_frame = [], []
    for k, i in enumerate(range(frames, frames + extra)):
        if k < extra // 2:
            with _Syncs() as sy:
                step(slam, sq, i)
                sy.mark()
            reads.append(sy.steps[0])
        else:
            keys = (_captures(), _first_calls())
            res, per = _profile(lambda: step(slam, sq, i))
            kind = _step_kind(res, keys)
            if kind in ("track", "KF") and getattr(slam, "imu_initialized", False):
                kind += " VI"
            per_frame.append((sum(c for c, _ in per.values()),
                              sum(us for _, us in per.values()) / 1e3, per.launches, kind))
    states = [s for s, *_ in rec]
    not_ok = [i for i, s in enumerate(states) if s != OK]
    new_maps = [i for i, (_, _, nm, _) in enumerate(rec) if nm]
    merged = [i for i in range(1, len(rec)) if rec[i][3] > rec[i - 1][3]]
    first_ok = states.index(OK) if OK in states else len(states)
    n_ok = sum(s == OK for s in states[first_ok:])
    imu_at = [i for i, (_, ini, _, _) in enumerate(rec) if ini]
    dt = float(np.median(np.diff(sq.image_ts)))
    ev = out.get("eval", {})
    path = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    n = len(rec)
    r = dict(
        frames=n, wall_s=out["wall_s"], fps=n / out["wall_s"], rt=n * dt / out["wall_s"],
        ms=out["avg_track_ms"], first_ok=first_ok, n_ok=n_ok, n_after=n - first_ok,
        imu_at=imu_at[0] if imu_at else None, ate=ev.get("ate_rmse"),
        ate_scale=ev.get("ate_scale"), ate_sim3=sim3.get("ate_rmse"),
        sim3_scale=sim3.get("ate_scale"), path=path, reads=float(np.mean(reads)),
        app_reads=app_reads,
        launches_frame=float(np.mean([c for c, _, _, _ in per_frame])),
        device_ms=float(np.mean([t for _, t, _, _ in per_frame])), splat=launches,
        loop_lines=loop_log.lines, device=out["device"], stats=out["stats"])
    _log(f"run_slam {tag} {slam.img_w}x{slam.img_h}, N={slam.map.N}, K={slam.map.K}, "
         f"M={slam.map.M}, on {out['device']}: {seq}, {n} frames in {out['wall_s']:.3f} s "
         f"wall = {r['fps']:.3f} frames/s (real-time x {r['rt']:.4f}), {r['ms']:.2f} ms per "
         f"frame; initialised at frame {first_ok}, then {n_ok}/{n - first_ok} tracked"
         + (f"; IMU initialised at frame {r['imu_at']}, scale applied "
            f"{slam.scale_applied:.4f}" if hasattr(slam, "imu_initialized") else "")
         + f"; frames not OK {not_ok}, new maps at {new_maps}, merges at {merged}; loops "
         f"{slam.loops_closed}, {len(loop_log.lines)} eorb.loop lines; splat launches "
         f"{launches[0]} forward + {launches[1]} VJP + {launches[2]} ascent")
    app_reads.log(f"run_slam {tag} (the app run)", "frame")
    app_reads.not_above(tag, "frame")
    if tag in READS_APP_MAX:
        app_reads.at_most(tag, READS_APP_MAX[tag])
    if pre.rows:
        pre.log(tag, "frame")
    _log(f"run_slam {tag} per frame after the run ({extra} frames): {r['reads']:.1f} blocking "
         f"reads (each: {reads}); under torch.profiler {r['launches_frame']:.0f} device "
         f"launches and {r['device_ms']:.2f} ms of device time (each, with the host-issued "
         f"launches and the kind of step: "
         f"{[(c, round(t, 2), h, kd) for c, t, h, kd in per_frame]})")
    _log(f"run_slam {tag} accuracy: ATE --eval {r['ate']} m (scale {r['ate_scale']}) over "
         f"{ev.get('ate_n')} poses; Sim3 {r['ate_sim3']} m, fitted scale {r['sim3_scale']}; "
         f"path {path:.4f} m; stats {out['stats']}")
    if out["device"] != "cuda" or slam.map.N != 512 or (slam.img_w, slam.img_h) != (752, 480):
        raise RuntimeError(f"{tag}: not the full width on the card")
    if n_ok < APP_TRACK_MIN * max(n - first_ok, 1) or first_ok >= n:
        raise RuntimeError(f"{tag}: only {n_ok}/{n - first_ok} frames tracked after init")
    if launches != (0, 0, 0):
        raise RuntimeError(f"{tag}: the splat kernels ran on this path: {launches}")
    if not (np.isfinite(r["ate"] or np.inf) and np.isfinite(r["ate_sim3"] or np.inf)):
        raise RuntimeError(f"{tag}: evaluate gave {ev} / {sim3}")
    if tag in ("STEREO", "RGBD"):
        # a tracked frame: the feature units' replays and the eager glue
        # around them
        tracked = [h for _, _, h, kd in per_frame if kd == "track"]
        if not tracked or max(tracked) > GRAPH_LAUNCH_MAX["frame"]:
            raise RuntimeError(f"{tag}: host-issued launches per tracked frame {tracked}, "
                               f"none profiled or above {GRAPH_LAUNCH_MAX['frame']}")
    return slam, r


def run_generate_depth(work: str):
    """One EuRoC corridor_st_01 at the synth_euroc_stereo width for the three
    depth modes: cam0, cam1 at bf / fx = 0.11 m to the right, 16-bit depth0,
    IMU, ground truth; box renderer on the card."""
    from eorb_slam_tpu_torch.io import config, synth_dataset as sd

    root = os.path.join(work, "euroc_depth")
    st = config.load_settings(os.path.join(REPO, "configs", "synth_euroc_stereo.yaml"))
    Wd, Hd, fx, fps = st.cam.width, st.cam.height, st.cam.fx, st.cam.fps
    baseline = st.cam.bf / st.cam.fx
    if abs(baseline - DEPTH_BASELINE) > 1e-3:
        raise RuntimeError(f"synth_euroc_stereo.yaml baseline {baseline}")
    t0 = time.perf_counter()
    sd.write_euroc(root, "corridor_st_01", sd.make_scene("corridor", Wd, Hd, fx, n_dots=10),
                   sd.make_trajectory("corridor", 10.0), duration=DEPTH_GEN_FRAMES / fps,
                   fps=fps, verbose=False, stereo_baseline=baseline, write_depth=True,
                   renderer=sd.make_box_renderer("corridor", Wd, Hd, fx))
    _log(f"generate: corridor_st_01 {Wd}x{Hd}, {DEPTH_GEN_FRAMES} frames with cam1 "
         f"(baseline {baseline:.4f} m) and depth0 in {time.perf_counter() - t0:.2f} s")
    return root


def _frame_args(slam, seq, i, right=False, depth=False):
    from eorb_slam_tpu_torch._host import to_device

    args = [to_device((seq.image(i) * 255.0).astype(np.uint8), slam.device)]
    if right:
        args.append(to_device((seq.image_right(i) * 255.0).astype(np.float32), slam.device))
    if depth:
        args.append(to_device(seq.depth(i).astype(np.float32), slam.device))
    return args + [float(seq.image_ts[i])]


def run_app_stereo(work: str, root: str):
    """STEREO through run_slam.main with configs/synth_euroc_stereo.yaml."""
    from eorb_slam_tpu_torch.slam import rgbd_stereo

    slam, r = _run_app_image(
        work, "synth_euroc_stereo.yaml", root, "corridor_st_01", rgbd_stereo.StereoSlam,
        "process_stereo", DEPTH_FRAMES, STEREO_RGBD_EXTRA,
        lambda s, q, i: s.process_stereo(*_frame_args(s, q, i, right=True)), "STEREO")
    _check_metric(slam, r, "STEREO")
    return r


def run_app_rgbd(work: str, root: str):
    """RGBD through run_slam.main with configs/synth_euroc_rgbd.yaml."""
    from eorb_slam_tpu_torch.slam import rgbd_stereo

    slam, r = _run_app_image(
        work, "synth_euroc_rgbd.yaml", root, "corridor_st_01", rgbd_stereo.RgbdSlam,
        "process_rgbd", DEPTH_FRAMES, STEREO_RGBD_EXTRA,
        lambda s, q, i: s.process_rgbd(*_frame_args(s, q, i, depth=True)), "RGBD")
    _check_metric(slam, r, "RGBD")
    return r


def run_app_imu_stereo(work: str, root: str):
    """IMU_STEREO through run_slam.main with configs/synth_euroc_imu_stereo.yaml:
    the IMU must initialize; after it, frames run the left-only inertial step
    and the right image is extracted at keyframes only."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam import local_mapping, rgbd_stereo

    def step(s, q, i):
        img_l, img_r, t = _frame_args(s, q, i, right=True)
        return s.process_stereo_imu(img_l, img_r, t,
                                    run_slam._imu_chunk(q, float(q.image_ts[i - 1]), t))

    # keyframes whose right image was extracted and matched in the keyframe
    # step (the deferral), and the landmarks their stereo depth founded
    deferred, insert = [], rgbd_stereo.StereoInertialSlam._insert_keyframe
    create = local_mapping.create_depth_landmarks

    def counted(self, f, *a, **kw):
        if f.depth is None and self._pending_right is not None:
            deferred.append(None)
        return insert(self, f, *a, **kw)

    def founding(*a, **kw):
        m, n_new = create(*a, **kw)
        if deferred and deferred[-1] is None:
            deferred[-1] = n_new          # read after the run
        return m, n_new

    rgbd_stereo.StereoInertialSlam._insert_keyframe = counted
    local_mapping.create_depth_landmarks = founding
    try:
        slam, r = _run_app_image(
            work, "synth_euroc_imu_stereo.yaml", root, "corridor_st_01",
            rgbd_stereo.StereoInertialSlam, "process_stereo_imu", IMU_STEREO_FRAMES,
            DEPTH_EXTRA, step, "IMU_STEREO")
    finally:
        rgbd_stereo.StereoInertialSlam._insert_keyframe = insert
        local_mapping.create_depth_landmarks = create
    deferred = [-1 if n is None else int(n) for n in deferred]
    _log(f"run_slam IMU_STEREO: {len(deferred)} keyframes with the right image extracted and "
         f"matched in the keyframe step (the deferral), founding {deferred} depth landmarks")
    if not slam.imu_initialized:
        raise RuntimeError("IMU_STEREO: the IMU did not initialize")
    if not deferred or min(deferred) <= 0:
        raise RuntimeError(f"IMU_STEREO: deferred stereo keyframes {deferred}")
    _check_metric(slam, r, "IMU_STEREO")
    return r


def _check_metric(slam, r, tag):
    """A depth mode is metric: --eval keeps the scale at 1, and the Sim3 fit
    finds a scale near 1."""
    if r["ate_scale"] != 1.0 or not 0.8 < (r["sim3_scale"] or 0.0) < 1.25:
        raise RuntimeError(f"{tag}: eval scale {r['ate_scale']}, Sim3 scale {r['sim3_scale']}")


def run_app_loop(work: str):
    """MONOCULAR with place recognition through run_slam.main with
    configs/synth_euroc_room_large.yaml (752x480, 512 features, K=96,
    M=8192, a 4,096-word vocabulary trained on 6 of the sequence's frames):
    a generated room_01 of LOOP_TURNS turns of the 10 s room loop, so the
    path revisits its start. Prints the loop closer's gate decisions."""
    from eorb_slam_tpu_torch.io import config, synth_dataset as sd
    from eorb_slam_tpu_torch.slam import loop_closing, system

    root = os.path.join(work, "euroc_loop")
    st = config.load_settings(os.path.join(REPO, "configs", "synth_euroc_room_large.yaml"))
    Wl, Hl, fx, fps = st.cam.width, st.cam.height, st.cam.fx, st.cam.fps
    n = int(round(LOOP_TURNS * LOOP_ROOM_S * fps))
    t0 = time.perf_counter()
    sd.write_euroc(root, "room_01", sd.make_scene("room", Wl, Hl, fx, n_dots=10),
                   sd.make_trajectory("room", LOOP_ROOM_S), duration=(n + DEPTH_EXTRA) / fps,
                   fps=fps, verbose=False, renderer=sd.make_box_renderer("room", Wl, Hl, fx))
    _log(f"generate: room_01 {Wl}x{Hl}, {n + DEPTH_EXTRA} frames ({LOOP_TURNS} turns of "
         f"{LOOP_ROOM_S} s) in {time.perf_counter() - t0:.2f} s")
    passes = []
    detect = loop_closing.LoopCloser.detect_and_correct

    def counted(self, m, q, **kw):
        m, info = detect(self, m, q, **kw)
        passes.append(info)
        return m, info

    loop_closing.LoopCloser.detect_and_correct = counted
    try:
        slam, r = _run_app_image(
            work, "synth_euroc_room_large.yaml", root, "room_01", system.MonoSlam,
            "process_image", n, DEPTH_EXTRA,
            lambda s, q, i: s.process_image(*_frame_args(s, q, i)), "MONOCULAR+loop")
    finally:
        loop_closing.LoopCloser.detect_and_correct = detect
    lc = slam.loop_closer
    for line in r["loop_lines"]:
        _log(f"  eorb.loop: {line}")
    cands = [(i.query, i.matched, i.n_inliers) for i in passes if i.matched >= 0]
    _log(f"run_slam MONOCULAR+loop: vocabulary {lc.words.V} words (K1 {lc.words.K1}, K2 "
         f"{lc.words.K2}); {lc._kf_count} keyframes entered the database, "
         f"{int(lc.db.valid.sum())} are in it now, {slam.n_kf} active; "
         f"{len(passes)} detection passes, {len(cands)} with a candidate (query, candidate, "
         f"Sim3 inliers: {cands}); {len(r['loop_lines'])} gate decisions logged; loops "
         f"closed {slam.loops_closed}, maps merged {slam.map_merges}")
    if not lc.hier or (slam.map.K, slam.map.M) != (96, 8192):
        raise RuntimeError("not the synth_euroc_room_large vocabulary and capacities")
    if not passes or int(lc.db.valid.sum()) == 0:
        raise RuntimeError("place recognition never ran")
    if not cands or not r["loop_lines"]:
        raise RuntimeError(f"no detection pass of {len(passes)} yielded a loop candidate")
    return r


# ------------------------------- event + image, and the continuous tracker


def check_kernel_chunk():
    """The forward kernel as ``_chunk_image`` calls it: identity form, one
    chunk of 6,000 in-image events padded to CHUNK_N slots with weight-0
    rows (the valid mask as the weight), sigma 1."""
    from eorb_slam_tpu_torch.event import builder as eb

    ev = synth_stream(0.002, RATE, seed=21)[:6000]
    pad, valid, _ = eb._pad_events(ev, CHUNK_N)
    xy = torch.tensor(pad[:, 1:3], device="cuda").contiguous()
    w = torch.tensor(valid, device="cuda").to(torch.float32)
    return _identity_row("_chunk_image's shape", xy, w, SIGMA)


# the status-free eigensolver (ops/hopper_linalg.sym_eig, csrc/sym_eig.cu)
# at its call sites' (n, batch): the triangulations' 4x4 AtA over a
# frame's features and the two-view hypotheses, the 8-point fits' 9x9,
# relocalization's 12x12, the marginalized prior's 15x15 (batch 1) and a
# small batch of those; each in float32 and float64
EIG_SHAPES = ((4, 512), (4, 4096), (9, 256), (12, 64), (15, 1), (15, 8))
EIG_ROW_BATCH = {4: 512, 9: 256, 12: 64, 15: 1}   # the kernels line's row per n
EIG_CASES = ("spd", "rank n-1", "1e2 I", "indefinite", "1e8 spread")
# held against the plain version (torch.linalg.eigh) on the card: the
# eigenvalues to EIG_TOL x max|w|, ||V diag(w) V^T - A|| to EIG_TOL x ||A||,
# ||V^T V - I|| to EIG_TOL, and every eigenvector whose gap to the others
# is at least EIG_GAP x ||A|| to |<v, v_ref>| >= 1 - EIG_VEC; float64 at
# EIG_TOL_F64 throughout (Frobenius norms)
EIG_TOL, EIG_TOL_F64, EIG_GAP, EIG_VEC = 1e-5, 1e-12, 1e-3, 1e-4
F64_FLOPS = 34e12          # float64 outside the tensor cores, H100 SXM, published
# what the kernel replaces: the status-checked torch calls, standing for the
# reference's decompositions
EIG_REPLACES = ("eorb_slam_tpu_torch/optim/linalg.py:53 torch.linalg.eigh and :60 "
                "torch.linalg.svd (status read on the host), for jnp.linalg.eigh "
                "(eorb_slam_tpu/geometry/triangulation.py:42, "
                "eorb_slam_tpu/optim/marginalize.py:96) and jnp.linalg.svd "
                "(eorb_slam_tpu/optim/marginalize.py:36)")
# the paths that must have run the kernel, and at which n: the keyframes'
# triangulations (4), the two-view init's 8-point fits (9), the inertial
# frame's prior (15)
EIG_PATHS_NEED = {"EventSlam": (4,), "MONOCULAR": (4, 9), "IMU_MONOCULAR": (4, 15)}
# the operations an eigendecomposition with vectors needs: ~EIG_OPS n^3
# (Householder tridiagonalization and implicit QR), or, for a member that is
# nearly diagonal already, the Jacobi rotations it took at EIG_ROT_OPS n
# each (two rows and two columns of S and two of V, 4 operations an entry),
# whichever is less; over the card's rate for the operands' type
EIG_OPS = 9
EIG_ROT_OPS = 16


def _eig_matrices(n, batch, dtype, seed):
    """``batch`` exactly symmetric n x n matrices on the card, member i of
    case EIG_CASES[i % 5], and the same with the last member NaN where
    batch > 5 (else None). Returns (finite, with a NaN member)."""
    rng = np.random.default_rng(seed)
    out = np.empty((batch, n, n))
    for i in range(batch):
        case = EIG_CASES[i % len(EIG_CASES)]
        if case == "spd":
            X = rng.normal(size=(n + 3, n))
            M = X.T @ X
        elif case == "rank n-1":             # a consistent DLT's AtA
            M = (lambda X: X.T @ X)(rng.normal(size=(n - 1, n)) * rng.uniform(0.5, 50.0))
        elif case == "1e2 I":                # identity_prior's information
            M = 1e2 * np.eye(n)
        elif case == "indefinite":           # Sim3's N
            X = rng.normal(size=(n, n))
            M = X + X.T
        else:                                # px^2 beside m^2 information
            Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
            M = (Q * np.logspace(0.0, 8.0, n)) @ Q.T
        out[i] = 0.5 * (M + M.T)
    A = torch.tensor(out, dtype=dtype, device="cuda")
    if batch <= len(EIG_CASES):
        return A, None
    A_nan = A.clone()
    A_nan[-1, 0, 1] = float("nan")
    return A, A_nan


def _eig_held(A, w, V, w_ref, tol, what):
    """The worst of each measure over the members (float64 on the card):
    eigenvalues against ``w_ref`` relative to max|w_ref|, the
    reconstruction relative to ||A||, V^T V - I, and 1 - |cos| of the
    eigenvectors with a gap >= EIG_GAP ||A|| against ``V_ref``'s."""
    A, w, V = A.double(), w.double(), V.double()
    n = A.shape[-1]
    wr, Vr = w_ref
    wr, Vr = wr.double(), Vr.double()
    nA = torch.linalg.matrix_norm(A)
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    e_w = ((w - wr).abs().amax(-1) / wr.abs().amax(-1)).max()
    e_rec = (torch.linalg.matrix_norm(V @ torch.diag_embed(w) @ V.mT - A) / nA).max()
    e_orth = torch.linalg.matrix_norm(V.mT @ V - eye).max()
    dw = torch.where(eye > 0, torch.inf, (wr[..., :, None] - wr[..., None, :]).abs())
    sel = dw.amin(-1) >= EIG_GAP * nA[:, None]
    e_vec = torch.where(sel, 1.0 - (V * Vr).sum(-2).abs(), 0.0).max()
    abs_w = (w - wr).abs().max()
    out = dict(w=float(e_w), rec=float(e_rec), orth=float(e_orth), vec=float(e_vec),
               abs_w=float(abs_w), checked=int(sel.sum()))
    vec_tol = EIG_VEC if tol == EIG_TOL else tol
    if not (out["w"] <= tol and out["rec"] <= tol and out["orth"] <= tol
            and out["vec"] <= vec_tol):
        raise RuntimeError(f"sym_eig {what}: {out} against tol {tol} (vectors {vec_tol})")
    return out


def check_kernel_sym_eig():
    """The eigensolver kernel at every (n, batch) of EIG_SHAPES, float32 and
    float64, on every EIG_CASES matrix and one NaN member, against
    torch.linalg.eigh on the card (the plain version); the same bits twice;
    its times (graph replay, events), the plain version's and
    torch.linalg.eigh's alone (library_ms), and its bound from the
    operations these inputs need. Returns one row per (n, batch, dtype)."""
    from eorb_slam_tpu_torch.ops import hopper_linalg as hl
    from eorb_slam_tpu_torch.optim import linalg

    rows = []
    for n, batch in EIG_SHAPES:
        for dtype in (torch.float32, torch.float64):
            tol = EIG_TOL if dtype == torch.float32 else EIG_TOL_F64
            what = f"n={n} x {batch} {str(dtype)[6:]}"
            # batch 1: each case alone, and a NaN matrix alone
            if batch == 1:
                A5, _ = _eig_matrices(n, len(EIG_CASES), dtype, seed=100 * n + batch)
                sets = [A5[k:k + 1] for k in range(len(EIG_CASES))]
                worst = [_eig_held(A, *hl.sym_eig(A), linalg._eigh_plain(A), tol, what)
                         for A in sets]
                A = sets[0]
                nan_A = torch.full_like(A, float("nan"))
                wn, Vn = hl.sym_eig(nan_A)
                nan_ok = bool(torch.isnan(wn).all() and torch.isnan(Vn).all())
                A_timed = A
            else:
                A, A_nan = _eig_matrices(n, batch, dtype, seed=100 * n + batch)
                w, V = hl.sym_eig(A_nan)
                fin = torch.isfinite(w).all(-1) & torch.isfinite(V).flatten(1).all(-1)
                nan_ok = bool(torch.isnan(w[-1]).all() and torch.isnan(V[-1]).all()
                              and fin[:-1].all())
                worst = [_eig_held(A[:-1], w[:-1], V[:-1],
                                   tuple(x[:-1] for x in linalg._eigh_plain(A_nan)), tol,
                                   what)]
                A_timed = A_nan
            if not nan_ok:
                raise RuntimeError(f"sym_eig {what}: NaN not exactly in the NaN member")
            w1, V1 = hl.sym_eig(A_timed)
            w2, V2 = hl.sym_eig(A_timed)
            torch.cuda.synchronize()
            as_int = torch.int32 if dtype == torch.float32 else torch.int64
            if not (torch.equal(w1.view(as_int), w2.view(as_int))
                    and torch.equal(V1.view(as_int), V2.view(as_int))):
                raise RuntimeError(f"sym_eig {what}: two calls differ")
            rot = torch.zeros(A_timed.shape[0], dtype=torch.int32, device="cuda")
            hl._sym_eig_cuda(A_timed.contiguous(), rot)
            n_rot = int(rot.sum())
            size = A_timed.element_size()
            nbytes = A_timed.shape[0] * (2 * n * n + n) * size
            by_bytes = nbytes / HBM_BYTES_PER_S
            # what the function needs on these operands, at their type's rate
            ops = float(torch.clamp(rot.double() * (EIG_ROT_OPS * n),
                                    max=EIG_OPS * n ** 3).sum())
            by_ops = ops / (F32_FLOPS if dtype == torch.float32 else F64_FLOPS)
            A_lib = torch.nan_to_num(A_timed, nan=0.0)
            row = dict(n=n, batch=batch, dtype=str(dtype)[6:],
                       err=max(x["abs_w"] for x in worst),
                       **{k: max(x[k] for x in worst) for k in ("w", "rec", "orth", "vec")},
                       checked=sum(x["checked"] for x in worst),
                       rotations=n_rot / A_timed.shape[0],
                       ms=_time_ms(lambda: hl.sym_eig(A_timed)),
                       dev_ms=_device_ms(lambda: hl.sym_eig(A_timed)),
                       plain_ms=_time_ms(lambda: linalg._eigh_plain(A_timed)),
                       library_ms=_time_ms(lambda: torch.linalg.eigh(A_lib)),
                       bound=(1e3 * max(by_bytes, by_ops),
                              "bytes" if by_bytes >= by_ops else "operations"))
            _log(f"sym_eig {what}: eigenvalues {row['w']:.2e} of max|w| (max abs "
                 f"{row['err']:.3e}), reconstruction {row['rec']:.2e} of ||A||, "
                 f"orthogonality {row['orth']:.2e}, eigenvectors (gap >= {EIG_GAP} ||A||, "
                 f"{row['checked']} checked) 1 - |cos| <= {row['vec']:.2e} (tol {tol}); NaN "
                 f"member exact, same bits twice; {row['rotations']:.1f} rotations per "
                 f"matrix | ms by events / device only / plain / torch.linalg.eigh / bound: "
                 f"{row['ms']:.4f} / {row['dev_ms']:.5f} / {row['plain_ms']:.4f} / "
                 f"{row['library_ms']:.4f} / {row['bound'][0]:.6f} ({row['bound'][1]})")
            rows.append(row)
    return rows


class _EvWorld:
    """The EventWorld of tests/test_event_slam.py in numpy: a cloud of 3D
    points, a camera moving and yawing, events sampled from the points'
    projections with pixel noise and random polarity."""

    def __init__(self, n_points=260, seed=5):
        rng = np.random.default_rng(seed)
        self.pts = np.concatenate([rng.uniform(-2.2, 2.2, (n_points, 1)),
                                   rng.uniform(-1.6, 1.6, (n_points, 1)),
                                   rng.uniform(2.5, 6.0, (n_points, 1))], 1).astype(np.float32)
        self.rng = rng

    def pose(self, t):
        pos = np.asarray([0.5 * t, 0.12 * np.sin(1.5 * t), 0.1 * t])
        c, s = np.cos(0.08 * np.sin(0.8 * t)), np.sin(0.08 * np.sin(0.8 * t))
        R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)   # yaw about y
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ pos
        return T

    def _project(self, T, p):
        fx, fy, cx, cy = EVW_CAM
        pc = p @ T[:3, :3].T + T[:3, 3]
        return pc, np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)

    def events(self, t0, t1, n, noise_px=0.25):
        ts = np.sort(self.rng.uniform(t0, t1, n))
        idx = self.rng.integers(0, len(self.pts), n)
        n_bins = max(int((t1 - t0) * 1000), 1)
        bins = np.clip(((ts - t0) / (t1 - t0) * n_bins).astype(int), 0, n_bins - 1)
        ev = np.zeros((n, 4))
        ev[:, 0] = ts
        for b in np.unique(bins):
            sl = bins == b
            _, uv = self._project(self.pose(t0 + (b + 0.5) * (t1 - t0) / n_bins),
                                  self.pts[idx[sl]])
            ev[sl, 1:3] = uv
        ev[:, 1:3] += self.rng.normal(0, noise_px, (n, 2))
        ev[:, 3] = self.rng.choice([-1.0, 1.0], n)
        inb = (ev[:, 1] >= 0) & (ev[:, 1] < W) & (ev[:, 2] >= 0) & (ev[:, 2] < H)
        return ev[inb]

    def frame(self, t, device):
        """The APS frame in [0,255] on ``device``: blobs at the projections."""
        from eorb_slam_tpu_torch.event import tensorize

        pc, uv = self._project(self.pose(t), self.pts)
        ok = (pc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < H)
        img = tensorize.splat_gauss(torch.tensor(uv, dtype=torch.float32, device=device),
                                    torch.tensor(ok, device=device),
                                    torch.ones(len(uv), device=device), H, W, sigma=1.2)
        return tensorize.normalize_to_image(img) * 255.0


def _maps_to(state, device, dtype=None):
    """A map from numpy onto ``device``; float fields in ``dtype`` if given."""
    from eorb_slam_tpu_torch import convert

    m = convert.map_state_from_numpy(state, device)
    if dtype is None:
        return m
    return m._replace(**{k: v.to(dtype) for k, v in m._asdict().items()
                         if v.dtype == torch.float32})


def _max_abs(a, b):
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def check_ev_image_small():
    """EVENT_MONO's fixed-shape steps on the card against the CPU, from one
    state: EvImageSlam runs on the card over the event world's frames until
    its event map is born by the joint init; its maps and last frames go to
    numpy, and each step runs on both devices from there. Then build_mci on
    one 65,536-event window, and the per-chunk step() over a few chunks."""
    from eorb_slam_tpu_torch import convert
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.slam import ev_image_system as evi

    t_phase = time.perf_counter()
    world = _EvWorld(seed=5)
    cam_np = np.asarray([*EVW_CAM, 0, 0, 0, 0, 0], np.float32)
    tri_calls = []
    tri = evi.init_triangulate

    def rec_tri(*a):
        r = tri(*a)
        tri_calls.append(([x.cpu().numpy() for x in a], int(r[-1])))
        return r

    evi.init_triangulate = rec_tri
    try:
        slam = evi.EvImageSlam(cam_np, eb.BuilderConfig(**EVW_CFG), device="cuda", **EVI_KW)
        ev = world.events(0.0, EVI_FRAMES / EVI_FPS, int(EVI_RATE * EVI_FRAMES / EVI_FPS))
        last = 0.0
        for t in np.arange(EVI_FRAMES) / EVI_FPS:
            slam.track_ev_mono(ev[(ev[:, 0] > last) & (ev[:, 0] <= t)],
                               world.frame(float(t), "cuda"), float(t))
            last = t
    finally:
        evi.init_triangulate = tri
    torch.cuda.synchronize()
    st = slam.stats
    _log(f"EvImageSlam on the card, {EVI_FRAMES} frames of the event world: image KFs "
         f"{st['im']['kf']}, event KFs {st['ev']['kf']}, joint inits {st['joint_inits']}, "
         f"joint frames {st['joint_frames']}, joint BAs {st['joint_bas']}")
    if slam.joint_inits < 1 or slam.ev.n_kf < 2 or slam.im.last_track is None \
            or slam.ev.last_track is None:
        raise RuntimeError(f"no joint state to compare from: {st}")

    im_np = convert.map_state_to_numpy(slam.im.map)
    ev_np = convert.map_state_to_numpy(slam.ev.map)
    tr_i, f_i, tr_e, f_e = (slam.im.last_track, slam.im.last_frame, slam.ev.last_track,
                            slam.ev.last_frame)
    frame_np = [x.cpu().numpy() for x in (tr_i.feat_lm, f_i.xy_ud, f_i.octave,
                                           tr_e.feat_lm, f_e.xy_ud, f_e.octave)]
    Tcw0 = tr_i.Tcw.cpu().numpy()
    T_last = (slam.im.T_last.cpu().numpy(), slam.ev.T_last.cpu().numpy())
    ref_slot = slam.im._kf_ref()
    free = (slam.im._ba_window().cpu().numpy(), slam.ev._ba_window().cpu().numpy())
    c, s_ = np.cos(0.1), np.sin(0.1)
    bridge = (np.asarray([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32),
              np.asarray([0.05, -0.02, 0.1], np.float32), 1.3)
    G = np.eye(4, dtype=np.float32)
    G[:3, :3] = np.asarray([[np.cos(0.3), 0, np.sin(0.3)], [0, 1, 0],
                            [-np.sin(0.3), 0, np.cos(0.3)]], np.float32)
    G[:3, 3] = [0.5, -0.2, 0.1]
    (tri_args, _) = max(tri_calls, key=lambda c: c[1])
    res = {}
    for d in ("cuda", "cpu"):
        cam = torch.tensor(cam_np, device=d)
        im, ev_m = _maps_to(im_np, d), _maps_to(ev_np, d)
        fr = [torch.from_numpy(x).to(d) for x in frame_np]
        Tj, flags = evi._joint_pose_step(cam, im.lm_pos, ev_m.lm_pos, *fr, *bridge,
                                         torch.from_numpy(Tcw0).to(d))
        wb = evi._joint_writeback(Tj, *(torch.from_numpy(x).to(d) for x in T_last), *bridge,
                                  im.kf_T[ref_slot])
        prop = evi._propagate_loop_to_event(ev_m, im.kf_ts, im.kf_valid, im.kf_T,
                                            im.kf_T @ torch.from_numpy(G).to(d), *bridge)
        tr = evi._init_triangulate_known_poses(*(torch.from_numpy(x).to(d) for x in tri_args))
        im64, ev64 = _maps_to(im_np, d, torch.float64), _maps_to(ev_np, d, torch.float64)
        ba = evi._joint_local_ba_step(im64, ev64, cam, np.eye(3), np.zeros(3), 1.0,
                                      *(torch.from_numpy(x).to(d) for x in free))
        res[d] = (Tj, flags, wb, prop, tr, ba)
    (Tg, fg, wbg, pg, trg, bag), (Tc, fc, wbc, pc, trc, bac) = res["cuda"], res["cpu"]
    e_pose = _max_abs(Tg, Tc)
    e_wb = max(_max_abs(a, b) for a, b in zip(wbg, wbc))
    e_prop = max(_max_abs(pg.kf_T, pc.kf_T), _max_abs(pg.lm_pos, pc.lm_pos))
    okc = trc[3].cpu().numpy()
    pts_c = trc[2].cpu().numpy()[okc]
    e_tri = float((np.abs(trg[2].cpu().numpy()[okc] - pts_c).max(1)
                   / np.maximum(np.linalg.norm(pts_c, axis=1), 1e-9)).max()) if okc.any() else 0.0
    kv = [m.kf_valid.cpu().numpy() for m in (bac[0], bac[1])]
    e_ba = max(_max_abs(bag[0].kf_T[kv[0]], bac[0].kf_T[kv[0]]),
               _max_abs(bag[1].kf_T[kv[1]], bac[1].kf_T[kv[1]]))
    e_cost = float(np.abs(bag[2].cpu().numpy() - bac[2].numpy()).max()
                   / max(float(bac[2].abs().max()), 1e-30))
    _log(f"EVENT_MONO steps cuda vs cpu: joint pose flags {fg.cpu().numpy().tolist()} / "
         f"{fc.numpy().tolist()}, Tcw max abs {e_pose:.2e}; write-back {e_wb:.2e} (tol "
         f"{EV_STEP_TOL}); loop propagation {e_prop:.2e} (tol {EV_PROP_TOL}); init "
         f"triangulation {int(trg[4])} / {int(trc[4])} points, match and flags equal: "
         f"{bool(torch.equal(trg[0].cpu(), trc[0]) and torch.equal(trg[3].cpu(), trc[3]))}, "
         f"positions {e_tri:.2e} of their distance; joint local BA float64 cost "
         f"{bac[2].numpy().tolist()}, rel {e_cost:.2e}, kf_T {e_ba:.2e}")
    if not torch.equal(fg.cpu(), fc) or e_pose > EV_STEP_TOL or e_wb > EV_STEP_TOL:
        raise RuntimeError(f"joint pose step: flags {fg} / {fc}, {e_pose}, {e_wb}")
    if e_prop > EV_PROP_TOL:
        raise RuntimeError(f"loop propagation {e_prop}")
    if not (torch.equal(trg[0].cpu(), trc[0]) and torch.equal(trg[3].cpu(), trc[3])) \
            or e_tri > 1e-3:
        raise RuntimeError(f"init triangulation: {int(trg[4])} / {int(trc[4])}, {e_tri}")
    if e_cost > L2_COST_TOL_F64 or e_ba > POSE_GRAPH_TOL_F64:
        raise RuntimeError(f"joint local BA float64: cost {e_cost}, kf_T {e_ba}")

    # build_mci on one 65,536-event window, with the pose prior in. The
    # contrast-maximization ascent accepts a step only if the contrast rises
    # (contrast_max.maximize_rt2d, as the reference): where a step leaves it
    # equal to the last bit, the two devices' roundings decide, and the
    # ascents part to another point of the same contrast. So: the two
    # ascents (the card's kernel and the CPU's loop, through their traces)
    # are held step by step up to where they part, which must be such a
    # tie; if they never part, the card's MCI is held against the CPU's at
    # the forward tolerance, else against the plain version of the card's
    # winner on the card's inputs and the SE2 score against the plain one at
    # the card's parameters. Always: the same winner, each of the four
    # candidate splats recomputed on the CPU from what the card gave it, and
    # the scores of the candidates the ascent does not touch within 1e-5
    # relative; and a second builder on the card gives the same bits.
    from eorb_slam_tpu_torch.event import contrast_max, tensorize

    win = synth_stream(0.03, RATE, seed=23)
    scores, mcis, kinds, se2, calls, steps = {}, {}, {}, {}, [], {}
    # the candidates eagerly (the module's runner would replay them without
    # calling the splats and the ascent that this check records)
    make = eb.make_candidates
    ascents = (contrast_max._ascent_kernel, contrast_max._ascent_loop)
    splats = (tensorize.splat_gauss, tensorize.splat_gauss_se2)

    def rec_make(*a, **kw):
        out = make.fn(*a, **kw)
        scores[a[0].device.type] = out[2].cpu().numpy()
        return out

    def traced(fn):
        """The ascent, its trace (the start and each step's trial) kept."""
        def run(xy, t, valid, H_, W_, params0, iters, sigma, lr):
            tr = torch.zeros((iters + 1, 4), device=xy.device)
            out = fn(xy, t, valid, H_, W_, params0, iters, sigma, lr, trace=tr)
            steps[xy.device.type] = tr.cpu().double().numpy()
            return out
        return run

    def recorder(fn):
        def rec(*a, **kw):
            out = fn(*a, **kw)
            if not mcis:         # the card's build_mci, the first of the two
                calls.append((fn, a, kw, out))
            return out
        return rec

    eb.make_candidates = rec_make
    contrast_max._ascent_kernel, contrast_max._ascent_loop = (traced(f) for f in ascents)
    tensorize.splat_gauss, tensorize.splat_gauss_se2 = (recorder(f) for f in splats)
    try:
        for d in ("cuda", "cpu"):
            b = eb.EventWindowBuilder(eb.BuilderConfig(**SLICE_CFG), torch.tensor(
                [*CAM, 0, 0, 0, 0, 0]), device=d)
            cap = b.cfg.max_window_events
            b.set_pose_prior(*(torch.from_numpy(im_np["kf_T"][k]).to(d) for k in (0, 1)),
                             torch.tensor(2.0, device=d))
            pi = b.build_mci(win)
            mcis[d], kinds[d], se2[d] = pi.img, pi.best_kind, pi.se2_params.cpu().numpy()
            if b.stats["ev_truncated"] != len(win) - cap:
                raise RuntimeError(f"build_mci kept {b.stats} of {len(win)} events")
    finally:
        eb.make_candidates = make
        contrast_max._ascent_kernel, contrast_max._ascent_loop = ascents
        tensorize.splat_gauss, tensorize.splat_gauss_se2 = splats

    # the two ascents, step by step: (params, contrast) of the start and of
    # each step's trial point, from the card's kernel and the CPU's loop
    sg, sc = steps["cuda"], steps["cpu"]
    part, tie, asc_err = _ascents_agree(sg, sc, "build_mci's ascent, cuda vs cpu")

    # the candidates in _make_candidates' order: hist, (the ascent), se2,
    # dpose, klt2d
    cand = [calls[0]] + calls[-3:]
    raw_err, raw_cpu = [], []
    for k, (fn, a, kw, out) in enumerate(cand):
        ref = fn(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in a), **kw)
        raw_cpu.append(ref)
        raw_err.append(_held(out.cpu(), ref, FWD_TOL, f"build_mci candidate {eb.KINDS[k]}"))
    best = eb.KINDS.index(kinds["cuda"])
    mci_err = _held(mcis["cuda"].cpu(), tensorize.normalize_to_image(raw_cpu[best]),
                    FWD_TOL, "build_mci MCI against the plain version of its winner")
    fin = np.isfinite(scores["cpu"])
    rel = np.abs(scores["cuda"][fin] - scores["cpu"][fin]) / np.abs(scores["cpu"][fin])
    gap = float((mcis["cuda"].cpu() - mcis["cpu"]).abs().max())
    se2_k = eb.KINDS.index("se2")
    if part is None:
        dev_err = _held(mcis["cuda"].cpu(), mcis["cpu"], FWD_TOL, "build_mci MCI cuda vs cpu")
        rel_held = rel.max()
    else:
        # the SE2 score on the CPU from the card's SE2 image
        se2_cpu = float(tensorize.patch_std_mean(raw_cpu[se2_k][None])[0])
        rel_se2 = abs(scores["cuda"][se2_k] - se2_cpu) / abs(se2_cpu)
        rel_held = max(rel_se2, max((r for k, r in zip(np.flatnonzero(fin), rel)
                                     if k != se2_k), default=0.0))
    # the card's build_mci is the same bits on a second builder, through the
    # module's candidates runner: its key's eager call, capture and replay
    b = eb.EventWindowBuilder(eb.BuilderConfig(**SLICE_CFG), torch.tensor(
        [*CAM, 0, 0, 0, 0, 0]), device="cuda")
    b.set_pose_prior(*(torch.from_numpy(im_np["kf_T"][k]).cuda() for k in (0, 1)),
                     torch.tensor(2.0, device="cuda"))
    r0 = eb.make_candidates.replays
    again = [b.build_mci(win).img for _ in range(3)]
    replayed = eb.make_candidates.replays - r0
    if not all(_bits_equal(a, mcis["cuda"]) for a in again) or replayed < 2:
        raise RuntimeError(f"build_mci on the card: a second builder's MCIs differ, or "
                           f"{replayed} of its 3 calls replayed")
    _log(f"build_mci cuda vs cpu, {len(win)} events into {cap} slots, {CM_ITERS} ascent "
         f"steps: " + (f"the ascents agree at every step (max rel {asc_err:.2e}, tol "
                       f"{ASCENT_TOL}); the MCI cuda vs cpu max abs {dev_err:.2e} (tol "
                       f"{FWD_TOL}x max)" if part is None else
                       f"the ascents agree (max rel {asc_err:.2e}, tol {ASCENT_TOL}) until "
                       f"step {part}, a tie ({tie:.2e} of the contrast, tol {ASCENT_TIE}) "
                       f"that the devices' roundings decide apart; final contrasts "
                       f"{sg[-1, 3]!r} / {sc[-1, 3]!r}; the MCIs part by {gap:.2e} of max "
                       f"(not gated)") +
         f"; best {kinds['cuda']} / {kinds['cpu']}, scores {scores['cuda'].tolist()} / "
         f"{scores['cpu'].tolist()}, max rel {rel_held:.2e} (tol 1e-5"
         + ("" if part is None else ", SE2 against the plain score of the card's image")
         + f"); bit-equal on a second builder on the card, eagerly, captured and "
         f"replayed ({replayed} replays of 3 calls); the four candidate splats "
         f"against their plain versions on the card's inputs, max abs "
         f"{[f'{e:.2e}' for e in raw_err]}, the MCI {mci_err:.2e}; SE2 params "
         f"{se2['cuda'].tolist()} / {se2['cpu'].tolist()}")
    if kinds["cuda"] != kinds["cpu"] or not np.array_equal(np.isfinite(scores["cuda"]), fin) \
            or rel_held > 1e-5:
        raise RuntimeError(f"build_mci: {kinds}, scores {scores}")

    # step() over a few chunks: chunk images and the adapted chunk sizes (5
    # ascent steps: the window's build_mci is held above)
    stream = synth_stream(0.012, RATE, seed=25)
    out = {}
    for d in ("cuda", "cpu"):
        b = eb.EventWindowBuilder(eb.BuilderConfig(**dict(SLICE_CFG, l1_chunk_size=4000,
                                                          cm_iters=5)),
                                  torch.tensor([*CAM, 0, 0, 0, 0, 0]), device=d)
        b.feed(stream)
        seq = []
        while (pi := b.step()) is not None:
            seq.append((pi.reconst_stat, pi.best_kind, b.chunk_size, pi.img.cpu().numpy()))
        out[d] = (seq, dict(b.stats))
    (sg, stg), (sc, stc) = out["cuda"], out["cpu"]
    e_chunk = [float(np.abs(a[3] - b[3]).max()) for a, b in zip(sg, sc) if a[0] == 0]
    _log(f"step() cuda vs cpu: {len(sg)} / {len(sc)} images, stats {stg} / {stc}, chunk "
         f"sizes {[x[2] for x in sg]} / {[x[2] for x in sc]}, kinds "
         f"{[x[1] for x in sg]}, chunk images max abs {max(e_chunk):.2e}; phase "
         f"{time.perf_counter() - t_phase:.1f} s")
    if [x[:3] for x in sg] != [x[:3] for x in sc] or stg != stc or not e_chunk \
            or max(e_chunk) > FWD_TOL or not any(x[0] for x in sg):
        raise RuntimeError(f"step(): {[x[:3] for x in sg]} / {[x[:3] for x in sc]}")


def _fixed_twoview(seed):
    """Two-view RANSAC inputs that do not depend on the device: minimal sets
    from one numpy generator, and the minimal-set fits computed on the CPU
    (float32 eigensolves differ across LAPACK builds; ROADMAP Queue 3).
    Returns a function that installs them and gives back an undo."""
    from eorb_slam_tpu_torch.geometry import twoview

    saved = {k: getattr(twoview, k) for k in ("_sample_minimal_sets", "_fit_E_batch",
                                              "_fit_H_batch")}
    rng = np.random.default_rng(seed)

    def sample(generator, valid, iters, k):
        idx = np.flatnonzero(valid.cpu().numpy())
        if len(idx) < k:
            idx = np.arange(valid.shape[0])
        sets = np.stack([rng.choice(idx, k, replace=False) for _ in range(iters)])
        return torch.from_numpy(sets).to(valid.device)

    def on_cpu(fn):
        return lambda x1, x2: fn(x1.cpu(), x2.cpu()).to(x1.device)

    twoview._sample_minimal_sets = sample
    twoview._fit_E_batch = on_cpu(saved["_fit_E_batch"])
    twoview._fit_H_batch = on_cpu(saved["_fit_H_batch"])
    return lambda: [setattr(twoview, k, v) for k, v in saved.items()]


def check_continuous_small():
    """The continuous tracker (EventSlamContinuous) on the card against the
    CPU on tests/test_torch_event_continuous.py's stream, on which the
    reference initializes: the same states and keyframe decisions per
    window, poses within CONT_POSE_TOL; and its splat launches on the card,
    one forward per chunk past the gen-rate gate and MCI_FWD forward +
    MCI_ASCENT ascent per window."""
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.slam import event_continuous as ec

    t_phase = time.perf_counter()
    cfg = dict(EVW_CFG)
    stream = _EvWorld(seed=5).events(0.0, 2.4, 160000)[:CONT_EVENTS]
    cam = np.asarray([*EVW_CAM, 0, 0, 0, 0, 0], np.float32)
    out = {}
    for d in ("cuda", "cpu"):
        undo = _fixed_twoview(seed=7)
        try:
            slam = ec.EventSlamContinuous(cam, eb.BuilderConfig(**cfg), device=d, **CONT_KW)
            _reset_counts()
            log = []
            t0 = time.perf_counter()
            for k in range(0, len(stream), CONT_PACKET):
                res = slam.track_events(stream[k:k + CONT_PACKET])
                log.append(([(r["state"], r.get("kf"), r["mci_kind"]) for r in res],
                            slam.l2.n_kf, slam.l2.T_last.cpu().numpy()))
            wall = time.perf_counter() - t0
        finally:
            undo()
        out[d] = (log, dict(slam.stats), wall, _counts())
    (lg, sg, wg, lnch), (lc, sc, wc, _) = out["cuda"], out["cpu"]
    e_pose = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(lg, lc))
    want = (sg["chunks"] - sg["idle"] + MCI_FWD * sg["windows"], MCI_VJP * sg["windows"],
            MCI_ASCENT * sg["windows"])
    _log(f"continuous tracker cuda vs cpu, {len(stream)} events: per window "
         f"{[x for a in lg for x in a[0]]}; KFs {sg['l2_kf']} / {sc['l2_kf']}, landmarks "
         f"{sg['l2_lm']} / {sc['l2_lm']}, poses max abs {e_pose:.2e} (tol {CONT_POSE_TOL}); "
         f"{wg:.2f} s on the card, {wc:.2f} s on the CPU; card launches (forward, VJP, ascent) "
         f"{lnch} for {sg['chunks']} chunks ({sg['idle']} idle) and {sg['windows']} "
         f"windows; phase {time.perf_counter() - t_phase:.1f} s")
    if [(a[0], a[1]) for a in lg] != [(a[0], a[1]) for a in lc] or e_pose > CONT_POSE_TOL:
        raise RuntimeError(f"continuous tracker: cuda {[(a[0], a[1]) for a in lg]} cpu "
                           f"{[(a[0], a[1]) for a in lc]}, poses {e_pose}")
    keys = ("chunks", "windows", "idle", "l2_kf", "l2_tiny", "l2_full", "l2_topped")
    if any(sg[k] != sc[k] for k in keys) or sg["l2_kf"] < 3:
        raise RuntimeError(f"continuous tracker stats: {sg} / {sc}")
    if lnch != want:
        raise RuntimeError(f"continuous tracker: {lnch} splat launches, expected {want}")


def _run_app_event_image(work, root, config, tag):
    """run_slam.main with configs/<config> (only DS.Paths.root differs) on
    the generated shakes_01, no --device (the card), --eval, with the
    blocking reads counted per image and the last image under the profiler;
    for EVENT_MONO then the same run again, its images from EV_STEADY_FROM
    on under the profiler (_event_image_steady; tools/ab_event.py profiles
    both modes' images in turns against another checkout).
    Gates: cuda; the image map with >= 2 keyframes and the tracked share
    after its init; the Sim3 ATE; no fusion error, and the fused file
    written when fusion found a chain; the splat launches MCI_FWD, MCI_VJP
    and MCI_ASCENT per synch MCI; the event map born (>= 2 keyframes) and a joint frame
    after it; in EVENT_MONO's second run a paired tracked image (both
    trackers tracked without a keyframe, the joint solve accepted, no new
    key) at most GRAPH_LAUNCH_MAX["event-image frame"] host-issued launches
    each, and at least one. The image tracker's generator is seeded with
    EV_IMAGE_SEED (see there)."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam import ev_image_system as evi
    from eorb_slam_tpu_torch.slam.system import OK

    settings = _settings_with_root(config, root, work)
    rec, slams, prof, kinds = [], [], [], []
    track, run_seq = evi.EvImageSlam.track_ev_mono, run_slam.run_sequence
    n_images = int(GEN_S * GEN_FPS)

    build = run_slam.build_system

    def keep(st, s, **kw):
        slam, out = run_seq(st, s, **kw)
        slams.append((slam, s))
        return slam, out

    def seeded(*a, **kw):
        slam = build(*a, **kw)
        slam.im.generator.manual_seed(EV_IMAGE_SEED)
        return slam

    with _Syncs() as sy:
        def recording(self, *a, **kw):
            if len(rec) == n_images - 1:       # the last image, under the profiler
                keys, ev_ok = (_captures(), _first_calls()), self.ev.state == OK
                res, per = _profile(lambda: track(self, *a, **kw))
                prof.append((per, self.ev.state, _image_kind(res, keys, ev_ok)))
            else:
                res = track(self, *a, **kw)
            sy.mark()
            rec.append((self.im.state, self.ev.state, (res["event"] or {}).get("n")))
            im, evr = res["image"] or {}, res["event"] or {}
            kinds.append("KF" if im.get("kf") or evr.get("kf") else _frame_kind(im))
            return res

        evi.EvImageSlam.track_ev_mono = recording
        run_slam.run_sequence, run_slam.build_system = keep, seeded
        _reset_counts()
        try:
            (out,) = run_slam.main([settings, "--sequence", "shakes_01", "--eval",
                                    "--out", os.path.join(work, f"results_{tag}")])
            torch.cuda.synchronize()
        finally:
            evi.EvImageSlam.track_ev_mono = track
            run_slam.run_sequence, run_slam.build_system = run_seq, build
    launches = _counts()
    slam, seq = slams[0]
    windows = slam.builder.stats["windows"]
    chains = slam.fused_trajectory().get("chains", 0)
    per, ev_state_prof, kind_prof = prof[0] if prof else ({}, None, None)
    prof = (sum(c for c, _ in per.values()), sum(us for _, us in per.values()) / 1e3,
            getattr(per, "launches", 0))
    st = out["stats"]
    ev = run_slam.evaluate(seq, out["trajectory_file"], monocular=True)
    states = [a for a, _, _ in rec]
    first_ok = states.index(OK) if OK in states else len(states)
    after = states[first_ok:]
    n_ok = sum(s_ == OK for s_ in after)
    path = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    ate_frac = ev.get("ate_rmse", float("inf")) / max(path, 1e-12)
    reads = sy.steps[first_ok + 1:-1] or sy.steps
    # by kind, the init images and the profiled last image left out
    app_reads = _Reads(sy, [k if first_ok < i < len(kinds) - 1 else None
                            for i, k in enumerate(kinds)])
    n = len(rec)
    r = dict(frames=n, fps=n / out["wall_s"], wall_s=out["wall_s"], windows=windows,
             launches=launches, reads=float(np.mean(reads)), app_reads=app_reads,
             launches_frame=prof[0],
             device_ms=prof[1], ate_frac=ate_frac, first_ok=first_ok, n_ok=n_ok,
             chains=chains, stats=st)
    _log(f"run_slam {tag} on {out['device']}, image tracker seed {EV_IMAGE_SEED}: {n} images "
         f"in {out['wall_s']:.3f} s wall = "
         f"{r['fps']:.3f} frames/s (real-time x {n / GEN_FPS / out['wall_s']:.4f}); image map "
         f"initialised at image {first_ok}, then {n_ok}/{len(after)} tracked; event states "
         f"{[b for _, b, _ in rec]}, joint-init matches {[c for _, _, c in rec]}; {windows} "
         f"synch MCIs, splat launches {launches[0]} forward + {launches[1]} VJP + {launches[2]} "
         f"ascent; blocking "
         f"reads per image after the init {r['reads']:.1f} (each: {reads}); the last image "
         f"under torch.profiler (event state after it {ev_state_prof}, kind {kind_prof}): "
         f"{prof[2]} host-issued launches, {prof[0]} device kernels, {prof[1]:.2f} ms of "
         f"device time")
    app_reads.log(f"run_slam {tag}", "image")
    app_reads.not_above(tag, "image")
    _log(f"run_slam {tag} result: image KFs {st['im']['kf']}, event KFs {st['ev']['kf']}, "
         f"joint inits {st['joint_inits']}, joint frames {st['joint_frames']}, joint BAs "
         f"{st['joint_bas']}, gauge reseeds {st['gauge_reseeds']}; Sim3 ATE "
         f"{ev.get('ate_rmse')} m over {ev.get('ate_n')} poses, path {path:.4f} m -> "
         f"{100 * ate_frac:.2f}% of the path; fusion: {chains} chains, file "
         f"{'written' if 'fused_trajectory_file' in out else 'not written'}, error "
         f"{out.get('fusion_error')}")
    if out["device"] != "cuda":
        raise RuntimeError(f"{tag}: run_slam ran on {out['device']}")
    if st["im"]["kf"] < 2 or not after or n_ok < APP_TRACK_MIN * len(after):
        raise RuntimeError(f"{tag}: image map {st['im']}, {n_ok}/{len(after)} tracked")
    if st["ev"]["kf"] < 2 or st["joint_frames"] < 1:
        raise RuntimeError(f"{tag}: event map {st['ev']}, joint frames {st['joint_frames']}")
    if not (np.isfinite(ev.get("ate_rmse", np.inf)) and ate_frac <= APP_ATE_MAX):
        raise RuntimeError(f"{tag}: ATE {ev}")
    if "fusion_error" in out or (chains > 0) != ("fused_trajectory_file" in out):
        raise RuntimeError(f"{tag}: fusion {out.get('fusion_error')}, chains {chains}")
    if launches != (MCI_FWD * windows, MCI_VJP * windows, MCI_ASCENT * windows) or windows < 1:
        raise RuntimeError(f"{tag}: {launches} splat launches for {windows} synch MCIs, "
                           f"expected {(MCI_FWD, MCI_VJP, MCI_ASCENT)} each")

    if tag == "EVENT_MONO":
        r["host_launches_frame"] = _event_image_steady(settings, work, tag)
    return slam, r


def _image_kind(res, keys, ev_ok) -> str:
    """The kind of an image-clock step that returned ``res``, begun with
    the runners' (captures, first calls) at ``keys`` and the event tracker
    tracking where ``ev_ok``: "capture" where it met a new key, "KF",
    "paired" where both trackers tracked without a keyframe and the joint
    solve was accepted, else the image tracker's kind (_frame_kind)."""
    im, evr, joint = res["image"] or {}, res["event"] or {}, res["joint"]
    if (_captures(), _first_calls()) != keys:
        return "capture"
    if im.get("kf") or evr.get("kf"):
        return "KF"
    if (ev_ok and _frame_kind(im) == _frame_kind(evr) == "track" and joint is not None
            and not joint.get("rejected")):
        return "paired"
    return _frame_kind(im)


def _event_image_steady(settings, work, tag):
    """The image-clock app run again on the same data (every key met and
    captured in the first run), its images from EV_STEADY_FROM on under the
    profiler. Prints (image, kind, host-issued launches) of each: "paired"
    where both trackers tracked without a keyframe from a tracked state and
    the joint solve was accepted, "capture" where the image met a new key,
    else the image tracker's kind (_frame_kind) or "KF". Returns the paired
    images' launches, gated at GRAPH_LAUNCH_MAX["event-image frame"]; at
    least one must be seen. (EVENT_IMU_MONO's image side runs the inertial
    tracker's eager path until its IMU initializes: not gated, and profiled
    by tools/ab_event.py only.)"""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam import ev_image_system as evi
    from eorb_slam_tpu_torch.slam.system import OK

    track, build = evi.EvImageSlam.track_ev_mono, run_slam.build_system
    host = []

    def seeded(*a, **kw):
        slam = build(*a, **kw)
        slam.im.generator.manual_seed(EV_IMAGE_SEED)
        return slam

    def profiled(self, *a, **kw):
        i = profiled.n
        profiled.n += 1
        if i < EV_STEADY_FROM:
            return track(self, *a, **kw)
        keys, ev_ok = (_captures(), _first_calls()), self.ev.state == OK
        res, per = _profile(lambda: track(self, *a, **kw))
        host.append((i, _image_kind(res, keys, ev_ok), per.launches))
        return res

    profiled.n = 0
    evi.EvImageSlam.track_ev_mono = profiled
    run_slam.build_system = seeded
    try:
        run_slam.main([settings, "--sequence", "shakes_01",
                       "--out", os.path.join(work, f"results_{tag}_steady")])
        torch.cuda.synchronize()
    finally:
        evi.EvImageSlam.track_ev_mono, run_slam.build_system = track, build
    paired = [c for _, kind, c in host if kind == "paired"]
    limit = GRAPH_LAUNCH_MAX["event-image frame"]
    _log(f"run_slam {tag} again, images {EV_STEADY_FROM}- under torch.profiler (image, kind, "
         f"host-issued launches): {host}; paired tracked images {paired} (gate {limit})")
    if not paired or max(paired) > limit:
        raise RuntimeError(f"{tag}: host-issued launches per paired tracked image {paired}, "
                           f"none or above {limit}: {host}")
    return paired


def run_app_event_mono(work: str, root: str):
    t0 = time.perf_counter()
    _, r = _run_app_event_image(work, root, "synth_ev_mono.yaml", "EVENT_MONO")
    _log(f"run_app_event_mono: {time.perf_counter() - t0:.1f} s")
    return r


def run_app_event_imu_mono(work: str, root: str):
    """As run_app_event_mono with configs/synth_ev_imu_mono.yaml: the IMU
    rows go to the image tracker per image. The IMU init waits for 1.5 s of
    keyframes, more than the sequence holds: its state is printed, not
    gated."""
    t0 = time.perf_counter()
    slam, r = _run_app_event_image(work, root, "synth_ev_imu_mono.yaml", "EVENT_IMU_MONO")
    _log(f"run_app_event_imu_mono: imu_initialized {slam.im.imu_initialized}, scale_applied "
         f"{slam.im.scale_applied} (not gated: the init needs "
         f"{slam.im.min_time_imu_init} s); {time.perf_counter() - t0:.1f} s")
    return r


def run_app_event_continuous(work: str, root: str):
    """run_slam.main with configs/synth_ev_only.yaml and ``Event.contTracking:
    1`` written into the copy, on the generated shakes_01, no --device, with
    --eval (skipped when no trajectory was written). Gates: cuda, the run
    reaches its end, every full image is a window and every tiny one a
    chunk, and the splat launches: one forward per chunk past the gen-rate
    gate plus MCI_FWD forward and MCI_ASCENT ascent per window. Accuracy is printed, not gated (the
    reference's tracker does not initialize on this data). Blocking reads
    are counted per window (from one full image to the next), and the
    CONT_APP_PROFILED windows after CONT_PROFILED full images run under the
    profiler: a window that inserts no keyframe and captures no graph issues
    at most GRAPH_LAUNCH_MAX["continuous window"] launches from the host."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.slam import event_continuous as tec
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    settings = _settings_with_root("synth_ev_only.yaml", root, work)
    with open(settings) as f:
        text = f.read()
    text, n_sub = re.subn(r"(?m)^Event\.contTracking:.*$", "Event.contTracking: 1", text)
    if n_sub != 1:
        raise RuntimeError(f"synth_ev_only.yaml: {n_sub} Event.contTracking lines")
    with open(settings, "w") as f:
        f.write(text)
    process = tec.ContinuousEventTracker.process_event_image
    # the windows after CONT_PROFILED full images, each under a profiler of
    # its own: (window, kind, device activity); a window runs from one full
    # image's L2 step to the next one's, the builder's chunk steps and MCI
    # between them
    profs, cur = [], {}
    with _Syncs() as sy:
        def windowed(self, img, ts, full=True):
            r = process(self, img, ts, full=full)
            if full:
                sy.mark()
                k = len(sy.steps)
                if cur:
                    torch.cuda.synchronize()
                    cur["prof"].stop()
                    kind = ("KF" if r.get("kf") else "capture"
                            if (_captures(), _first_calls()) != cur["keys"] else "window")
                    profs.append((k, kind, _activity(cur.pop("prof"))))
                    cur.clear()
                if CONT_PROFILED <= k < CONT_PROFILED + CONT_APP_PROFILED:
                    torch.cuda.synchronize()
                    cur.update(prof=profile(activities=[ProfilerActivity.CUDA]),
                               keys=(_captures(), _first_calls()))
                    cur["prof"].start()
            return r

        tec.ContinuousEventTracker.process_event_image = windowed
        _reset_counts()
        try:
            (out,) = run_slam.main([settings, "--sequence", "shakes_01", "--eval",
                                    "--out", os.path.join(work, "results_cont")])
            torch.cuda.synchronize()
        finally:
            tec.ContinuousEventTracker.process_event_image = process
    launches = _counts()
    st, ev = out["stats"], out.get("eval", {})
    if st["windows"] <= CONT_PROFILED + CONT_APP_PROFILED:
        raise RuntimeError(f"continuous: {st['windows']} windows, not all profiled")
    # device kernels and ms, and host-issued launches, of each profiled window
    wins = [(k, kind, sum(c for c, _ in per.values()), sum(us for _, us in per.values()) / 1e3,
             per.launches, dict(per.host)) for k, kind, per in profs]
    win_prof = (float(np.mean([w[2] for w in wins])), float(np.mean([w[3] for w in wins])))
    gated = [w[4] for w in wins if w[1] == "window"]
    reads = sy.steps[1:]
    want = (st["chunks"] - st["idle"] + MCI_FWD * st["windows"], MCI_VJP * st["windows"],
            MCI_ASCENT * st["windows"])
    ate = (f"Sim3 ATE {ev.get('ate_rmse')} m over {ev.get('ate_n')} poses"
           if ev.get("ate_n", 0) >= APP_MIN_ATE_N else "ATE not printed (fewer than "
           f"{APP_MIN_ATE_N} poses)")
    _log(f"run_slam EVENT_ONLY continuous on {out['device']}: {out['iterations']} event "
         f"chunks, {st['chunks']} builder chunks ({st['idle']} idle), {st['windows']} windows "
         f"in {out['wall_s']:.3f} s wall ({st['windows'] / out['wall_s']:.3f} windows/s, real-"
         f"time x {GEN_S / out['wall_s']:.4f}); tiny {st['l2_tiny']}, full {st['l2_full']}; "
         f"keyframes {st['l2_kf']}, tracked poses {out['tracked_poses']}, lost "
         f"{st['l2_lost']}; {ate}; splat launches (forward, VJP, ascent) {launches} (expected "
         f"{want}); blocking reads per window {float(np.mean(reads)):.1f} "
         f"(each: {reads}); windows {CONT_PROFILED + 1}-{CONT_PROFILED + CONT_APP_PROFILED} "
         f"under torch.profiler: {win_prof[0]:.0f} device kernels and {win_prof[1]:.2f} ms of "
         f"device time per window; {time.perf_counter() - t0:.1f} s")
    _log(f"run_slam EVENT_ONLY continuous under torch.profiler, per window (window, kind, "
         f"device kernels, device ms, host-issued launches, launch calls): {wins}")
    _log(f"run_slam EVENT_ONLY continuous sites per window: "
         f"{sy.top(range(1, len(sy.steps)))}")
    _Reads(sy, [None] + ["window"] * len(reads)).not_above("EVENT_ONLY continuous", "window")
    if out["device"] != "cuda" or out["iterations"] < 1:
        raise RuntimeError(f"continuous: {out['device']}, {out['iterations']} chunks")
    if st["l2_full"] != st["windows"] or st["l2_tiny"] != st["chunks"] - st["windows"]:
        raise RuntimeError(f"continuous: stats {st}")
    if launches != want:
        raise RuntimeError(f"continuous: {launches} splat launches, expected {want}")
    if not all(w[2] for w in wins):
        raise RuntimeError(f"continuous: a profiled window launched nothing: {wins}")
    limit = GRAPH_LAUNCH_MAX["continuous window"]
    if not gated or max(gated) > limit:
        raise RuntimeError(f"continuous: host-issued launches per window without a "
                           f"keyframe or a capture {gated}, none or above {limit}: {wins}")
    return dict(launches=launches, windows=st["windows"], reads=float(np.mean(reads)),
                launches_window=win_prof[0], device_ms_window=win_prof[1],
                host_launches_window=gated, stats=st)


# ------------------------------------- mixed features, checkpoint, rosbag, scale-out

AKAZE_LVL_TOL = 1e-5       # scale-space level images, x max|ref|, cuda vs cpu
AKAZE_XY_SHARE = 0.98      # keypoints equal, share of the reference's valid slots
AKAZE_BIT_SHARE = 0.995    # descriptor bits equal on the shared keypoints
MIXED_KP = 256             # extract_mixed's budget at 240x180 (half ORB, half AKAZE)
CKPT_FRAMES, CKPT_MORE = 15, 5
CKPT_TOL = 1e-4            # T_last of the resumed system against the original, max abs
BAG_S = 0.1                # seconds of the generated shakes sequence in the bag
BAG_CHUNKS = 6             # EVENT_ONLY chunks run from the bag
BAG_EV_PER_MSG = 10000     # events per dvs_msgs/EventArray message
DIST_N, DIST_WORLD = 65536, 2
DIST_BA_ITERS = 10
DIST_BA_TOL = 1e-6         # f64 dist BA against the single-process solve, max abs


def _bits_of(desc):
    """(N,8) int32 words -> (N,256) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    return (((desc[..., None] >> shifts) & 1) != 0).reshape(desc.shape[0], -1)


def _hold_features(got, ref, what):
    """Keypoints equal in >= AKAZE_XY_SHARE of ``ref``'s valid slots, bits
    in >= AKAZE_BIT_SHARE on the shared keypoints. Returns both shares."""
    v = ref.valid.cpu()
    same = (got.xy.cpu() == ref.xy.cpu()).all(1) & v & got.valid.cpu()
    xy_share = float(same.sum()) / max(int(v.sum()), 1)
    bits = (_bits_of(got.desc.cpu()) == _bits_of(ref.desc.cpu()))[same]
    bit_share = float(bits.float().mean()) if bool(same.any()) else 0.0
    if int(v.sum()) < 40 or xy_share < AKAZE_XY_SHARE or bit_share < AKAZE_BIT_SHARE:
        raise RuntimeError(f"{what}: {int(v.sum())} valid, keypoints equal in "
                           f"{xy_share:.4f}, bits in {bit_share:.5f}")
    return xy_share, bit_share


def check_akaze_small():
    """ops/akaze and frontend.extract_mixed on the card against the CPU on
    one rendered 240x180 corridor image (uint8, as the apps ship frames):
    the nonlinear scale space's level images, extract_akaze's keypoints and
    MLDB bits, and both halves of extract_mixed with its channel array;
    then the mixed extraction's time, launches and device time."""
    from eorb_slam_tpu_torch.io import synth_dataset as sd
    from eorb_slam_tpu_torch.ops import akaze, frontend

    render = sd.make_box_renderer("corridor", W, H, EVW_CAM[0])
    img = (render(np.asarray(sd.make_trajectory("corridor", 10.0)(1.0), np.float32))
           * 255.0).to(torch.uint8)
    cpu = img.cpu()
    lv_c = akaze.nonlinear_scale_space(img.float() / 255.0)
    lv_h = akaze.nonlinear_scale_space(cpu.float() / 255.0)
    lvl_err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(lv_c, lv_h))
    if not lvl_err <= AKAZE_LVL_TOL:
        raise RuntimeError(f"AKAZE level images differ by {lvl_err} x max|ref|")
    n_ak = MIXED_KP // 2
    ak = _hold_features(akaze.extract_akaze(img, max_kp=n_ak),
                        akaze.extract_akaze(cpu, max_kp=n_ak), "extract_akaze")
    (fc, chc), (fh, chh) = (frontend.extract_mixed(x, max_kp=MIXED_KP) for x in (img, cpu))
    if not torch.equal(chc.cpu(), chh) or int(chh.sum()) != MIXED_KP - n_ak:
        raise RuntimeError("extract_mixed's channel arrays differ")
    halves = {name: _hold_features(frontend.Features(*[f[sl] for f in fc]),
                                   frontend.Features(*[f[sl] for f in fh]), name)
              for name, sl in (("ORB half", slice(0, n_ak)),
                               ("AKAZE half", slice(n_ak, None)))}
    ms = _time_ms(lambda: frontend.extract_mixed(img, max_kp=MIXED_KP), reps=3, trials=3)
    ms_ak = _time_ms(lambda: akaze.extract_akaze(img, max_kp=n_ak), reps=3, trials=3)
    _, per = _profile(lambda: frontend.extract_mixed(img, max_kp=MIXED_KP))
    launches = sum(c for c, _ in per.values())
    dev_ms = sum(us for _, us in per.values()) / 1e3
    _log(f"AKAZE {W}x{H} cuda vs cpu: level images within {lvl_err:.3e} x max|ref| (tol "
         f"{AKAZE_LVL_TOL}); extract_akaze({n_ak}) keypoints equal {ak[0]:.4f}, bits "
         f"{ak[1]:.5f}; extract_mixed({MIXED_KP}) ORB half {halves['ORB half']}, AKAZE "
         f"half {halves['AKAZE half']} (keypoint share, bit share); extract_mixed "
         f"{ms:.2f} ms by events ({launches} launches, {dev_ms:.3f} ms of device time), "
         f"extract_akaze {ms_ak:.2f} ms")
    return dict(ms=ms, launches=launches, dev_ms=dev_ms)


def run_app_mixed(work: str, mono: dict):
    """MONOCULAR with mixed ORB + AKAZE features: the synth_euroc_mono.yaml
    settings with ``Features.mode: 2`` (MixedMonoSlam, not pipelined) on the
    corridor run_app_monocular generated, through run_slam.run_sequence +
    evaluate, its Sim3 ATE beside plain MONOCULAR's on the same frames; the
    valid AKAZE slots per frame; then the profiled frames."""
    from eorb_slam_tpu_torch._host import to_device
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.io import config, datasets
    from eorb_slam_tpu_torch.ops import frontend
    from eorb_slam_tpu_torch.slam import system

    root = mono["root"]
    st = config.load_settings(_settings_with_root(
        "synth_euroc_mono.yaml", root, work, extra="Features.mode: 2\n",
        name="synth_euroc_mixed.yaml"))
    seq = datasets.load_sequence(st.dataset.format, root, "corridor_01",
                                 ts_factor=st.dataset.ts_factor)
    states, ak_valid, kinds = [], [], []
    process, extract = system.MixedMonoSlam.process_image, frontend.extract_mixed
    sy = _Syncs()

    def recording(self, img, ts, **kw):
        res = process(self, img, ts, **kw)
        sy.mark()
        states.append(res["state"])
        kinds.append(_frame_kind(res))
        return res

    def counting(img, **kw):
        feats, ch = extract(img, **kw)
        ak_valid.append((feats.valid & (ch == 1)).sum())   # read after the run
        return feats, ch

    system.MixedMonoSlam.process_image = recording
    frontend.extract_mixed = counting
    _reset_counts()
    try:
        with sy:
            slam, out = run_slam.run_sequence(
                st, seq, out_dir=os.path.join(work, "results_mixed"),
                max_frames=MONO_FRAMES, verbose=False)
            torch.cuda.synchronize()
    finally:
        system.MixedMonoSlam.process_image = process
        frontend.extract_mixed = extract
    reads = _Reads(sy, kinds)
    splats = _counts()
    ev = run_slam.evaluate(seq, out["trajectory_file"], monocular=True)
    first_ok = states.index(system.OK) if system.OK in states else len(states)
    after = states[first_ok:]
    n_ok = sum(s == system.OK for s in after)
    slots = [int(v) for v in ak_valid]
    per_frame = []
    for i in range(MONO_FRAMES, MONO_FRAMES + MONO_PROFILED):
        img = (seq.image(i) * 255.0).astype(np.uint8)
        _, per = _profile(lambda: slam.process_image(to_device(img, slam.device),
                                                     float(seq.image_ts[i])))
        per_frame.append((sum(c for c, _ in per.values()),
                          sum(us for _, us in per.values()) / 1e3))
    path_len = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
    ate_frac = ev.get("ate_rmse", np.inf) / max(path_len, 1e-12)
    _log(f"run_slam MONOCULAR mixed (Features.mode 2, {type(slam).__name__}, pipelined "
         f"{slam.pipelined}) {slam.img_w}x{slam.img_h}, N={slam.map.N}, on {slam.device}: "
         f"{len(states)} frames in {out['wall_s']:.3f} s wall = "
         f"{len(states) / out['wall_s']:.3f} frames/s; initialised at frame {first_ok} "
         f"(ORB: {mono['first_ok']}), then {n_ok}/{len(after)} tracked (ORB: "
         f"{mono['tracked']:.3f}); Sim3 ATE {100 * ate_frac:.3f}% of a {path_len:.4f} m "
         f"path over {ev.get('ate_n')} poses (ORB on the same frames: "
         f"{100 * mono['ate_frac']:.3f}%); valid AKAZE slots per frame min/mean/max "
         f"{min(slots)}/{np.mean(slots):.1f}/{max(slots)} of {slam.map.N // 2}; splat "
         f"launches {splats}; stats {out['stats']}")
    _log(f"run_slam MONOCULAR mixed under torch.profiler, {len(per_frame)} frames: "
         f"{np.mean([c for c, _ in per_frame]):.0f} device launches and "
         f"{np.mean([t for _, t in per_frame]):.2f} ms of device time per frame")
    reads.log("run_slam MONOCULAR mixed", "frame")
    reads.not_above("MONOCULAR mixed", "frame")
    reads.at_most("MONOCULAR mixed", READS_APP_MAX["MONOCULAR mixed"])
    if type(slam) is not system.MixedMonoSlam or slam.pipelined:
        raise RuntimeError(f"Features.mode 2 built {type(slam).__name__}")
    if slam.device.type != "cuda" or (slam.img_w, slam.img_h, slam.map.N) != (752, 480, 512):
        raise RuntimeError(f"not the full width on the card: {slam.img_w}x{slam.img_h}")
    if splats != (0, 0, 0):
        raise RuntimeError(f"the mixed path launched the splat {splats} times")
    if not after or n_ok < APP_TRACK_MIN * len(after):
        raise RuntimeError(f"only {n_ok}/{len(after)} frames tracked after init")
    if not (np.isfinite(ate_frac) and ev["ate_n"] >= 0.8 * len(after)) or min(slots) < 40:
        raise RuntimeError(f"evaluate gave {ev}; AKAZE slots {slots}")
    return dict(frames=len(states), wall_s=out["wall_s"], ate_frac=ate_frac, reads=reads)


def check_checkpoint(work: str):
    """io/checkpoint on the card: the pipelined MonoSlam (as the MONOCULAR
    app builds it) on CKPT_FRAMES rendered corridor frames, save_slam,
    load_slam into a fresh system (map arrays and generator state
    bit-equal), then both go on CKPT_MORE frames: the same states, T_last
    within CKPT_TOL."""
    from eorb_slam_tpu_torch.io import checkpoint
    from eorb_slam_tpu_torch.slam import map_state, system

    frames = _pipe_frames(CKPT_FRAMES + CKPT_MORE)
    cam = np.asarray([PIPE_FX, PIPE_FX, PIPE_W / 2, PIPE_H / 2, 0, 0, 0, 0, 0], np.float32)
    slam = system.MonoSlam(cam, pipelined=True, **PIPE_KW)
    for ts, img, _ in frames[:CKPT_FRAMES]:
        slam.process_image(img, ts)
    path = os.path.join(work, "ckpt", "monoslam.npz")
    t0 = time.perf_counter()
    checkpoint.save_slam(path, slam)
    t_save = time.perf_counter() - t0
    fresh = system.MonoSlam(cam, pipelined=True, **PIPE_KW)
    t0 = time.perf_counter()
    checkpoint.load_slam(path, fresh)
    t_load = time.perf_counter() - t0
    if slam.state != system.OK or fresh.state != slam.state or fresh._kf_order != slam._kf_order:
        raise RuntimeError(f"restored state {fresh.state} / {fresh._kf_order}, "
                           f"saved {slam.state} / {slam._kf_order}")
    def same(a, b):   # bit for bit, NaN included
        return a.device == b.device and torch.equal(a.contiguous().view(torch.uint8),
                                                    b.contiguous().view(torch.uint8))

    for a, b in zip(slam.atlas.maps, fresh.atlas.maps):
        for field in map_state.MapState._fields:
            if not same(getattr(a, field), getattr(b, field)):
                raise RuntimeError(f"map field {field} not restored bit for bit")
    if not (same(slam.generator.get_state(), fresh.generator.get_state())
            and same(slam.T_last, fresh.T_last)):
        raise RuntimeError("generator state or T_last not restored bit for bit")
    steps = []
    for ts, img, _ in frames[CKPT_FRAMES:]:
        r1, r2 = slam.process_image(img, ts), fresh.process_image(img, ts)
        steps.append((r1["state"], r2["state"], r1.get("kf"), r2.get("kf")))
    slam.flush_pipeline()
    fresh.flush_pipeline()
    err = float((slam.T_last - fresh.T_last).abs().max())
    _log(f"checkpoint on the card: MonoSlam after {CKPT_FRAMES} frames ({slam.n_kf} KFs, "
         f"{slam.stats['lm']} landmarks): save_slam {t_save:.3f} s "
         f"({os.path.getsize(path) / 1e6:.2f} MB), load_slam {t_load:.3f} s; maps and "
         f"generator bit-equal; {CKPT_MORE} more frames (state, kf) original/resumed "
         f"{steps}; T_last max abs {err:.3e} (tol {CKPT_TOL})")
    if any(a != b or c != d for a, b, c, d in steps) or not err <= CKPT_TOL:
        raise RuntimeError("the resumed system parted from the original")
    return dict(save_s=t_save, load_s=t_load, err=err)


def check_rosbag(work: str, data_root: str):
    """io/rosbag: the first BAG_S s of the generated shakes sequence (its
    images, IMU and events) written into a bag by the port's writer, loaded
    back by load_sequence("rosbag") and held against the text loader's
    arrays, then run_slam.main EVENT_ONLY (synth_ev_only.yaml with DS.format
    rosbag) from the bag for BAG_CHUNKS chunks: 8 forward, 0 VJP and 1
    ascent launch per window."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.io import datasets, rosbag

    txt = datasets.load_sequence("ev_ethz", data_root, "shakes_01", ts_factor=1.0)
    ev = txt.events.events
    t_end = float(ev[0, 0]) + BAG_S
    ev = ev[ev[:, 0] <= t_end]
    n_img = int(np.sum(txt.image_ts <= t_end))
    imu_sel = txt.imu.ts <= t_end
    imgs = [np.round(txt.image(i) * 255.0).astype(np.uint8) for i in range(n_img)]
    msgs = [("/dvs/image_raw", "sensor_msgs/Image", float(txt.image_ts[i]),
             rosbag.encode_image(float(txt.image_ts[i]), imgs[i])) for i in range(n_img)]
    msgs += [("/dvs/imu", "sensor_msgs/Imu", float(t), rosbag.encode_imu(float(t), g, a))
             for t, g, a in zip(txt.imu.ts[imu_sel], txt.imu.gyro[imu_sel],
                                txt.imu.acc[imu_sel])]
    msgs += [("/dvs/events", "dvs_msgs/EventArray", float(ev[k, 0]),
              rosbag.encode_event_array(ev[k:k + BAG_EV_PER_MSG], H, W))
             for k in range(0, len(ev), BAG_EV_PER_MSG)]
    msgs.sort(key=lambda m: m[2])
    bag_root = os.path.join(work, "bag")
    os.makedirs(bag_root)
    t0 = time.perf_counter()
    rosbag.write_bag(os.path.join(bag_root, "shakes_01.bag"), msgs)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = datasets.load_sequence("rosbag", bag_root, "shakes_01", ts_factor=1.0)
    t_read = time.perf_counter() - t0
    got = seq.events.events
    checks = {
        "images": seq.n_frames == n_img and all(
            np.array_equal(np.round(seq.image(i) * 255.0).astype(np.uint8), imgs[i])
            for i in range(n_img)),
        "image_ts": np.abs(seq.image_ts - txt.image_ts[:n_img]).max() <= 2e-9,
        "imu": (np.array_equal(seq.imu.gyro, txt.imu.gyro[imu_sel])
                and np.array_equal(seq.imu.acc, txt.imu.acc[imu_sel])
                and np.abs(seq.imu.ts - txt.imu.ts[imu_sel]).max() <= 2e-9),
        "events": (got.shape == ev.shape and np.array_equal(got[:, 1:3], ev[:, 1:3])
                   and np.array_equal(got[:, 3], (ev[:, 3] > 0).astype(np.float64))
                   and np.abs(got[:, 0] - ev[:, 0]).max() <= 2e-9),
    }
    settings = _settings_with_root("synth_ev_only.yaml", bag_root, work, fmt="rosbag",
                                   name="synth_ev_only_bag.yaml")
    _reset_counts()
    (out,) = run_slam.main([settings, "--sequence", "shakes_01", "--max-frames",
                            str(BAG_CHUNKS), "--out", os.path.join(work, "results_bag")])
    torch.cuda.synchronize()
    launches, vjp, asc = _counts()
    windows = out["stats"]["windows"]
    per_window = _window_launches(SLICE_CFG["l1_num_loop"])
    _log(f"rosbag: {BAG_S} s of shakes_01 ({len(ev)} events in "
         f"{-(-len(ev) // BAG_EV_PER_MSG)} messages, {n_img} images, {int(imu_sel.sum())} "
         f"IMU rows) written in {t_write:.3f} s "
         f"({os.path.getsize(os.path.join(bag_root, 'shakes_01.bag')) / 1e6:.2f} MB), "
         f"read back in {t_read:.3f} s, against the text loader {checks}; run_slam "
         f"EVENT_ONLY from the bag on {out['device']}: {out['iterations']} chunks, "
         f"{windows} windows, {launches} + {vjp} + {asc} splat launches (forward, VJP, "
         f"ascent), stats {out['stats']}")
    if not all(checks.values()):
        raise RuntimeError(f"the bag's sequence differs from the text loader's: {checks}")
    if out["device"] != "cuda" or windows < 1:
        raise RuntimeError(f"run_slam from the bag ran {windows} windows on {out['device']}")
    if (launches, vjp, asc) != tuple(windows * c for c in per_window):
        raise RuntimeError(f"{(launches, vjp, asc)} launches for {windows} windows, "
                           f"expected {per_window} per window")
    return dict(launches=launches, vjp_launches=vjp, ascent_launches=asc, windows=windows)


def _ba_problem_np(dtype, K=8, M=256, P=4, seed=0):
    """A landmark-major BA problem as numpy leaves (BAProblem order): K
    poses on a line, two fixed, M points 4-8 m away, P noisy observations
    each, the landmarks perturbed by 2 cm."""
    rng = np.random.default_rng(seed)
    lm = np.concatenate([rng.uniform(-2, 2, (M, 2)), rng.uniform(4, 8, (M, 1))], 1)
    Ts = np.tile(np.eye(4), (K, 1, 1))
    Ts[:, 0, 3] = -0.25 * np.arange(K)
    obs_kf = rng.integers(0, K, (M, P)).astype(np.int32)
    pc = np.einsum("mpij,mj->mpi", Ts[obs_kf][..., :3, :3], lm) + Ts[obs_kf][..., :3, 3]
    uv = np.stack([458.0 * pc[..., 0] / pc[..., 2] + 376.0,
                   457.0 * pc[..., 1] / pc[..., 2] + 240.0], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    cam = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0])
    return (cam.astype(dtype), Ts.astype(dtype), np.asarray([True, True] + [False] * (K - 2)),
            np.ones(K, bool), (lm + rng.normal(0, 0.02, lm.shape)).astype(dtype),
            np.ones(M, bool), obs_kf, uv.astype(dtype), np.ones((M, P), dtype),
            pc[..., 2] > 0.1)


def _dist_inputs():
    """The sharded splat's events: the main path's mix (_kernel_events) at
    DIST_N, the weight's sign as polarity, nonzero weight as validity."""
    xy, w = _kernel_events(DIST_N, seed=17)
    ev = torch.zeros((DIST_N, 4), device="cuda")
    ev[:, 1:3], ev[:, 3] = xy, w
    return xy, w != 0, w, ev


def _dist_worker(init_file: str, world: int, rank: int, out: str, backend: str) -> int:
    """One rank of check_dist: the sharded splat and window scores, counted,
    and (gloo) the f64 landmark-sharded BA; results to out/rank<r>.npz."""
    import torch.distributed as dist

    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from eorb_slam_tpu_torch.ops import hopper_splat as hs
    from eorb_slam_tpu_torch.optim import schur_ba
    from eorb_slam_tpu_torch.parallel import dist_ba, dist_splat, multihost

    multihost.init(f"file://{init_file}", num_processes=world, process_id=rank,
                   backend=backend)
    mesh = multihost.global_mesh()
    xy, valid, pol, ev = _dist_inputs()
    res = {"backend": np.asarray(dist.get_backend(mesh.group)),
           "device": np.asarray(str(mesh.device))}
    hs.splat.launches = 0
    acc = dist_splat.splat_gauss_sharded(mesh, xy, valid, pol, H, W, sigma=SIGMA,
                                         use_polarity=True)
    res["splat_launches"] = hs.splat.launches
    hs.splat.launches = 0
    win, rate = dist_splat._window_scores_sharded(mesh, ev, valid, 0.012, H, W, SIGMA)
    res["win_launches"] = hs.splat.launches
    res.update(splat=acc.cpu().numpy(), win=win.cpu().numpy(), rate=rate.cpu().numpy())
    res["sharded_ms"] = _time_ms(lambda: dist_splat.splat_gauss_sharded(
        mesh, xy, valid, pol, H, W, sigma=SIGMA, use_polarity=True), reps=10, trials=3)
    if backend == "gloo":
        p = dist_ba.shard_problem(schur_ba.BAProblem(*_ba_problem_np(np.float64)), mesh)
        r = dist_ba.dist_bundle_adjust(p, mesh, iters=DIST_BA_ITERS)
        res.update(ba_kf_T=r.kf_T.cpu().numpy(), ba_lm_pos=r.lm_pos.cpu().numpy(),
                   ba_cost0=r.cost0.cpu().numpy(), ba_cost=r.cost.cpu().numpy())
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    return 0


def check_dist(work: str):
    """parallel/ on the card: DIST_WORLD gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one GPU) and one NCCL rank of a world of one, each
    a process of its own. splat_gauss_sharded and _window_scores_sharded at
    DIST_N events on 240x180 against the single-process kernel at FWD_TOL
    (atomics, another summation order), exactly one forward kernel launch
    per rank per call; dist_bundle_adjust in float64 against the
    single-process bundle_adjust at the same iterations (converged). Then
    the per-rank kernel call at its shape (N / world), timed."""
    from eorb_slam_tpu_torch.ops import hopper_splat as hs
    from eorb_slam_tpu_torch.optim import schur_ba

    runs = {}
    for tag, world in (("gloo", DIST_WORLD), ("nccl", 1)):
        d = os.path.join(work, f"dist_{tag}")
        os.makedirs(d)
        runs[tag] = (d, world, [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             os.path.join(d, "init"), str(world), str(r), d, tag],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    res = {}
    try:
        for tag, (d, world, procs) in runs.items():
            for p in procs:
                log = p.communicate(timeout=300)[0]
                if p.returncode != 0:
                    raise RuntimeError(f"dist worker ({tag}) exited {p.returncode}:\n"
                                       f"{log[-3000:]}")
            res[tag] = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(world)]
    finally:   # a rank that failed leaves its peers waiting in a collective
        for _, _, procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    xy, valid, pol, ev = _dist_inputs()
    w_ev = (pol * valid).contiguous()
    ref = hs.splat(xy, w_ev, H, W, SIGMA, TRUNC).cpu().numpy()
    ref_win = hs.splat(xy, valid.to(torch.float32), H, W, SIGMA, TRUNC).cpu().numpy()
    n = float(valid.sum())
    errs, launches = [], {}
    for tag, ranks in res.items():
        launches[tag] = sum(int(r["splat_launches"]) + int(r["win_launches"]) for r in ranks)
        for r in ranks:
            if (int(r["splat_launches"]), int(r["win_launches"])) != (1, 1):
                raise RuntimeError(f"{tag}: {int(r['splat_launches'])} + "
                                   f"{int(r['win_launches'])} kernel launches for two calls")
            if str(r["backend"]) != tag or not str(r["device"]).startswith("cuda"):
                raise RuntimeError(f"a rank ran {r['backend']} on {r['device']}")
            for got, want in ((r["splat"], ref), (r["win"], ref_win)):
                err = float(np.abs(got - want).max())
                if not err <= FWD_TOL * float(np.abs(want).max()):
                    raise RuntimeError(f"{tag}: sharded splat off by {err}")
                errs.append(err)
            if abs(float(r["rate"]) - n / 0.012 / (H * W)) > 1e-5 * n / 0.012 / (H * W):
                raise RuntimeError(f"{tag}: rate {float(r['rate'])}")
    prob = schur_ba.BAProblem(*[torch.from_numpy(x).to("cuda")
                                for x in _ba_problem_np(np.float64)])
    single = schur_ba.bundle_adjust(prob, iters=DIST_BA_ITERS)
    gloo = res["gloo"]
    ba_err = max(max(float(np.abs(r["ba_kf_T"] - single.kf_T.cpu().numpy()).max())
                     for r in gloo),
                 float(np.abs(np.concatenate([r["ba_lm_pos"] for r in gloo])
                              - single.lm_pos.cpu().numpy()).max()))
    cost0, cost = float(gloo[0]["ba_cost0"]), float(gloo[0]["ba_cost"])
    row = _identity_row(f"dist_splat's per-rank block ({DIST_WORLD} ranks)",
                        xy[: DIST_N // DIST_WORLD].contiguous(),
                        w_ev[: DIST_N // DIST_WORLD].contiguous(), SIGMA)
    _log(f"dist on the card: {DIST_WORLD} gloo ranks on cuda:0 and 1 NCCL rank, "
         f"splat_gauss_sharded + _window_scores_sharded at N={DIST_N}: max abs "
         f"{max(errs):.3e} against the single-process kernel (max|ref| "
         f"{np.abs(ref).max():.3f}, tol {FWD_TOL}x), forward launches gloo "
         f"{launches['gloo']}, nccl {launches['nccl']} (one per rank per call); one "
         f"sharded call {float(gloo[0]['sharded_ms']):.3f} ms (gloo, rank 0) and "
         f"{float(res['nccl'][0]['sharded_ms']):.3f} ms (NCCL world 1) by events; "
         f"dist_bundle_adjust f64 {DIST_BA_ITERS} iterations, cost {cost0:.2f} -> "
         f"{cost:.6f} (single {float(single.cost):.6f}), max abs {ba_err:.3e} against "
         f"the single-process solve (tol {DIST_BA_TOL})")
    if not (ba_err <= DIST_BA_TOL and cost < cost0 / 5.0):
        raise RuntimeError(f"dist BA off by {ba_err}, cost {cost0} -> {cost}")
    return dict(row=row, launches=launches["gloo"], launches_nccl=launches["nccl"],
                err=max(errs + [row["err"]]))


def main() -> int:
    t_start = time.perf_counter()
    faulthandler.enable()   # a crash in native code prints where Python was
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from eorb_slam_tpu_torch import _build
    from eorb_slam_tpu_torch.io import native
    from eorb_slam_tpu_torch.ops import hopper_linalg, hopper_splat

    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    _log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    # every build at once: g++ on the native I/O library, one nvcc per
    # kernel source
    t0 = time.perf_counter()
    builds = [threading.Thread(target=f) for f in (native.get_lib, hopper_linalg.build)]
    for b in builds:
        b.start()
    hopper_splat.build()
    t_nvcc = time.perf_counter() - t0
    for b in builds:
        b.join()
    hopper_linalg.build()         # raises here if its build failed
    for name in ("splat", "sym_eig"):
        info = _build.BUILD_INFO[name]
        _log(f"build: {name} kernels (nvcc {info['seconds']:.2f} s) -> {info['path']}")
        if info["log"].strip():
            _log(info["log"].strip())
    _log(f"build: splat kernels in {t_nvcc:.2f} s; with the sym_eig kernel and the "
         f"native I/O library (g++) {time.perf_counter() - t0:.2f} s in all")
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"the native I/O library did not build: {native.BUILD_ERROR}")
    _log(f"build: native I/O library -> {lib._name}")

    phase_s = {}
    # sym_eig launches by n of each phase that drives a path through its
    # entry points: the counts set to 0 just before it, read just after
    eig_paths = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    def path(name, fn, *a):
        _reset_eig()
        out = fn(*a)
        eig_paths[name] = _eig_counts()
        return out

    rows = check_kernel()
    gen_rows = check_kernel_generator()
    chunk_row = check_kernel_chunk()
    eig_rows = timed("check_kernel_sym_eig", check_kernel_sym_eig)
    asc_rows = timed("check_kernel_ascent", check_kernel_ascent)
    asc_times = time_ascent()
    check_slice_small()
    run_slice()
    check_l2_small()
    timed("check_graphs_small", check_graphs_small)
    res = path("EventSlam", run_event_slam)
    path("pipelined MonoSlam", check_pipelined_small)
    check_vi_small()
    check_depth_small()
    check_loop_small()
    timed("check_akaze_small", check_akaze_small)
    timed("check_ev_image_small", check_ev_image_small)
    timed("check_continuous_small", check_continuous_small)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        gen = run_generate(work)
        app = path("EVENT_ONLY", run_app_event_only, work, gen["root"])
        app_ei = path("EVENT_IMU", run_app_event_imu, work, gen["root"])
        app_em = timed("run_app_event_mono", path, "EVENT_MONO", run_app_event_mono, work,
                       gen["root"])
        app_eim = timed("run_app_event_imu_mono", path, "EVENT_IMU_MONO",
                        run_app_event_imu_mono, work, gen["root"])
        app_cont = timed("run_app_event_continuous", path, "EVENT_ONLY continuous",
                         run_app_event_continuous, work, gen["root"])
        mono = path("MONOCULAR", run_app_monocular, work)
        timed("run_app_mixed", path, "MONOCULAR mixed", run_app_mixed, work, mono)
        timed("check_checkpoint", path, "checkpoint", check_checkpoint, work)
        bag_res = timed("check_rosbag", path, "rosbag", check_rosbag, work, gen["root"])
        dist_res = timed("check_dist", check_dist, work)
        path("IMU_MONOCULAR", run_app_imu_monocular, work)
        depth_root = run_generate_depth(work)
        path("STEREO", run_app_stereo, work, depth_root)
        path("RGBD", run_app_rgbd, work, depth_root)
        path("IMU_STEREO", run_app_imu_stereo, work, depth_root)
        path("MONOCULAR+loop", run_app_loop, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _log(f"graph runners over the whole run (captures, keys, replays, capture s): "
         f"{_graph_stats()}")
    check_graph_nodes()
    _log(f"sym_eig launches by n per path: {eig_paths}")
    for name, ns in EIG_PATHS_NEED.items():
        missing = [n for n in ns if not eig_paths[name].get(n)]
        if missing:
            raise RuntimeError(f"{name}: the sym_eig kernel never ran at n = {missing}")

    # the pair's times at the SE2 form and 16,384 events, errors the worst
    # over every N; the ascent kernel's at its two call sites' shapes. A
    # row's `launches` counts its kernel in the EventSlam phase,
    # `launches_run_slam` in the app's EVENT_ONLY, `launches_event_imu` in
    # EVENT_IMU's, `launches_event_mono`, `launches_event_imu_mono` and
    # `launches_continuous` in the image-clock modes' and the continuous
    # tracker's through the app, `launches_rosbag` in EVENT_ONLY's from the
    # bag. The forward's remaining call sites per window are the chunk
    # images and the four candidates; the VJP has none left (the ascent was
    # its only caller); the ascent kernel runs once per window (16,384: the
    # L1 window's cm_sample) or per synch MCI / continuous window (65,536).
    # The last three forward rows time it at the generator's, _chunk_image's
    # (one identity forward per chunk, 12,000: the measured forward
    # launches less MCI_FWD per window) and dist_splat's shapes (one per
    # rank per call, at N / world).
    _log(f"new phases, wall s: {phase_s}; chip_smoke.py so far "
         f"{time.perf_counter() - t_start:.1f} s")
    main_row = next(r for r in rows if r["n"] == MAIN_N)
    gen_row = gen_rows[0]
    dist_row = dist_res["row"]
    common = dict(route="cuda", source="eorb_slam_tpu_torch/csrc/splat.cu",
                  replaces="eorb_slam_tpu/ops/pallas_splat.py:60", library_ms=None)
    # the forward launches of a phase less build_mci's MCI_FWD per window
    chunk_site = lambda r: r["launches"][0] - MCI_FWD * r["windows"]
    _log(f"_chunk_image launches (forward less {MCI_FWD} per window): EVENT_MONO "
         f"{chunk_site(app_em)}, EVENT_IMU_MONO {chunk_site(app_eim)}, continuous "
         f"{chunk_site(app_cont)}")
    paths = lambda a: dict(launches_event_mono=app_em["launches"][a],
                           launches_event_imu_mono=app_eim["launches"][a],
                           launches_continuous=app_cont["launches"][a])
    window_paths = lambda key: dict(launches=res[key], launches_run_slam=app[key],
                                    launches_event_imu=app_ei[key],
                                    launches_rosbag=bag_res[key])
    fwd_err = max(max(r["fwd_err"], r["fwd_se2_err"]) for r in rows)
    vjp_err = max(max(r["vjp_xy_err"], r["vjp_w_err"], r["vjp_se2_err"]) for r in rows)
    asc_paths = {MAIN_N: window_paths("ascent_launches"), KERNEL_NS[-1]: dict(
        launches=app_em["launches"][2], **paths(2))}
    _log(json.dumps({"kernels": [
        dict(common, name="splat_gauss", n=MAIN_N, form="se2",
             **window_paths("launches"), **paths(0),
             max_abs_err=fwd_err,
             ms=main_row["fwd_se2_ms"], device_ms=main_row["fwd_se2_dev_ms"],
             plain_ms=main_row["fwd_se2_plain_ms"],
             bound_ms=main_row["fwd_se2_bound"][0], bound_by=main_row["fwd_se2_bound"][1]),
        dict(common, name="splat_gauss_vjp", n=MAIN_N, form="se2",
             **window_paths("vjp_launches"), **paths(1),
             max_abs_err=vjp_err,
             ms=main_row["vjp_se2_ms"], device_ms=main_row["vjp_se2_dev_ms"],
             plain_ms=main_row["vjp_se2_plain_ms"],
             bound_ms=main_row["vjp_se2_bound"][0], bound_by=main_row["vjp_se2_bound"][1]),
        *(dict(common, name="splat_ascent_se2", n=r["n"], form="se2", **asc_paths[r["n"]],
               max_abs_err=r["err"], max_rel_step=r["step_err"], part=r["part"],
               ms=r["ms"], device_ms=r["dev_ms"], plain_ms=r["plain_ms"],
               loop_ms=r["loop_ms"], loop_host_ms=asc_times["loop"]["ms"] if r["n"] == MAIN_N
               else None, host_ms=asc_times["kernel"]["ms"] if r["n"] == MAIN_N else None,
               bound_ms=r["bound"][0], bound_by=r["bound"][1], c0_ulps=r["c0_ulps"],
               floor_ms={str(k): v / 1e3 for k, v in r["floor_us"].items()},
               registers=r["registers"], local_bytes=r["local_bytes"],
               smem_bytes=r["smem_bytes"])
          for r in asc_rows),
        # the same forward kernel as the dataset generator calls it
        dict(common, name="splat_gauss (generator: identity form, sigma 1.1)",
             n=gen_row["n"], form="identity", launches=gen["launches"],
             max_abs_err=max(r["err"] for r in gen_rows),
             ms=gen_row["ms"], device_ms=gen_row["dev_ms"], plain_ms=gen_row["plain_ms"],
             bound_ms=gen_row["bound"][0], bound_by=gen_row["bound"][1]),
        # _chunk_image: one identity splat per chunk of the continuous tracker
        dict(common, name="splat_gauss (_chunk_image: identity form)", n=CHUNK_N,
             form="identity", launches=chunk_site(app_cont),
             launches_event_mono=chunk_site(app_em),
             launches_event_imu_mono=chunk_site(app_eim),
             launches_continuous=chunk_site(app_cont),
             max_abs_err=chunk_row["err"], ms=chunk_row["ms"],
             device_ms=chunk_row["dev_ms"], plain_ms=chunk_row["plain_ms"],
             bound_ms=chunk_row["bound"][0], bound_by=chunk_row["bound"][1]),
        # dist_splat: the identity form once per rank per call on its block;
        # launches of the gloo ranks (two calls each) and of the NCCL rank
        dict(common, name="splat_gauss (dist_splat: identity form, per rank)",
             n=DIST_N // DIST_WORLD, form="identity", launches=dist_res["launches"],
             launches_nccl=dist_res["launches_nccl"], max_abs_err=dist_res["err"],
             ms=dist_row["ms"], device_ms=dist_row["dev_ms"],
             plain_ms=dist_row["plain_ms"], bound_ms=dist_row["bound"][0],
             bound_by=dist_row["bound"][1]),
        # the eigensolver at each n's call-site shape (float32); launches
        # in all the paths' runs and per path; library_ms torch.linalg.eigh
        *(dict(name="sym_eig", route="cuda", source="eorb_slam_tpu_torch/csrc/sym_eig.cu",
               replaces=EIG_REPLACES, n=r["n"], batch=r["batch"], dtype=r["dtype"],
               launches=sum(c.get(r["n"], 0) for c in eig_paths.values()),
               **{f"launches_{k}": c[r["n"]] for k, c in eig_paths.items() if c.get(r["n"])},
               max_abs_err=r["err"], max_rel_w=r["w"], max_rel_rec=r["rec"],
               ms=r["ms"], device_ms=r["dev_ms"], plain_ms=r["plain_ms"],
               library_ms=r["library_ms"], rotations=r["rotations"],
               bound_ms=r["bound"][0], bound_by=r["bound"][1])
          for r in eig_rows
          if r["dtype"] == "float32" and EIG_ROW_BATCH.get(r["n"]) == r["batch"]),
    ]}))
    _log(f"gpu: {gpu}")
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        a = sys.argv[2:]
        sys.exit(_dist_worker(a[0], int(a[1]), int(a[2]), a[3], a[4]))
    sys.exit(main())
