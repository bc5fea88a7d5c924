"""Drive the PyTorch/CUDA port on one GPU: build the splat kernel, hold it
against its plain PyTorch version, run the L1 event front-end slice (event
stream -> EventWindowBuilder.step_window -> MCI -> ORB extract), hold L2
tracking and local BA on the card against the CPU from the same map, then
run EVENT_ONLY end to end (slam/event_system.EventSlam: L1 + MonoSlam
tracking, mapping and Schur BA) at DAVIS240 size and shakes density
(4 M events/s) with the configs/synth_ev_only.yaml settings.

    python3 chip_smoke.py

Every phase raises on failure and the script then exits non-zero. Output:
the card's name and power limit, the kernel's build time, the kernel-vs-
plain comparisons and times, the L1 slice's windows/s, the L2 cuda-vs-cpu
agreement, EventSlam's MCIs/s, real-time factor and ms per MCI by phase,
then one JSON line describing the kernels and, last, the device line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 180, 240
SIGMA, TRUNC = 1.0, 2.5
KERNEL_NS = (8192, 32768, 65536)
FWD_TOL = 1e-5      # x max|ref|: f32 atomics sum in a run-dependent order
GRAD_TOL = 1e-4     # x max|ref|
RATE = 4_000_000    # events/s after the in-image cut (shakes density)
WARM_S, RUN_S = 0.1, 0.25             # L1 slice
EV_WARM_S, EV_RUN_S, EV_PHASE_S = 0.2, 0.4, 0.1   # EventSlam
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


def _log(*a):
    print(*a, flush=True)


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


def check_kernel():
    from eorb_slam_tpu_torch.event.tensorize import _splat_gauss_separable
    from eorb_slam_tpu_torch.ops import hopper_splat

    rows = []
    for n in KERNEL_NS:
        xy, w = _kernel_events(n, seed=n)
        ref = _splat_gauss_separable(xy, w, H, W, SIGMA, TRUNC)
        got = hopper_splat.splat(xy, w, H, W, SIGMA, TRUNC)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"N={n}: kernel output not finite")
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if err > FWD_TOL * scale:
            raise RuntimeError(f"N={n}: forward max abs {err} > {FWD_TOL} * {scale}")

        g = torch.randn(H, W, device="cuda", generator=torch.Generator("cuda").manual_seed(n))
        xk = xy.clone().requires_grad_(True)
        wk = w.clone().requires_grad_(True)
        gk = torch.autograd.grad(hopper_splat.splat(xk, wk, H, W, SIGMA, TRUNC),
                                 (xk, wk), g)
        xp = xy.clone().requires_grad_(True)
        wp = w.clone().requires_grad_(True)
        gp = torch.autograd.grad(_splat_gauss_separable(xp, wp, H, W, SIGMA, TRUNC),
                                 (xp, wp), g)
        gerr = []
        for a, b, name in zip(gk, gp, ("xy", "w")):
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin):
                raise RuntimeError(f"N={n}: grad {name} finiteness differs")
            e = float((a[fin] - b[fin]).abs().max())
            s = float(b[fin].abs().max())
            if e > GRAD_TOL * s:
                raise RuntimeError(f"N={n}: grad {name} max abs {e} > {GRAD_TOL} * {s}")
            gerr.append(e)

        ms = _time_ms(lambda: hopper_splat.splat(xy, w, H, W, SIGMA, TRUNC))
        plain_ms = _time_ms(lambda: _splat_gauss_separable(xy, w, H, W, SIGMA, TRUNC))
        ms2 = _time_ms(lambda: hopper_splat.splat(xy, w, H, W, SIGMA, TRUNC))
        plain_ms2 = _time_ms(lambda: _splat_gauss_separable(xy, w, H, W, SIGMA, TRUNC))
        row = dict(n=n, max_abs_err=err, max_ref=scale, grad_xy_err=gerr[0],
                   grad_w_err=gerr[1], ms=float(np.median([ms, ms2])),
                   plain_ms=float(np.median([plain_ms, plain_ms2])))
        _log(f"splat N={n}: fwd max abs {err:.3e} (max|ref| {scale:.3f}, tol "
             f"{FWD_TOL}x), grad max abs xy {gerr[0]:.3e} w {gerr[1]:.3e}; "
             f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
             f"(kernel, plain, kernel, plain: {ms:.4f} {plain_ms:.4f} {ms2:.4f} "
             f"{plain_ms2:.4f})")
        rows.append(row)

    # a NaN coordinate poisons the whole image in the separable form; the
    # kernel does the same
    xy = torch.tensor([[10.0, 10.0], [float("nan"), 5.0]], device="cuda")
    w = torch.ones(2, device="cuda")
    got = hopper_splat.splat(xy, w, H, W, SIGMA, TRUNC)
    ref = _splat_gauss_separable(xy, w, H, W, SIGMA, TRUNC)
    if not (torch.isnan(got).all() and torch.isnan(ref).all()):
        raise RuntimeError("NaN event: kernel and plain version disagree")
    return rows


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
    from eorb_slam_tpu_torch.ops import frontend, hopper_splat

    cfg = eb.BuilderConfig(**SLICE_CFG)
    splats_per_window = cfg.l1_num_loop + 4 + 1 + 2 * cfg.cm_iters
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

    hopper_splat.splat.launches = 0
    rec = []
    t0 = time.perf_counter()
    drive(run, rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hopper_splat.splat.launches

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
    if launches != n_win * splats_per_window:
        raise RuntimeError(f"{launches} splat launches for {n_win} windows, "
                           f"expected {splats_per_window} per window")
    data_s = rec[-1][0].ts - warm_rec[-1][0].ts
    b._resolve_window_meta(block=True)
    _log(f"slice: {n_win} windows in {wall:.3f} s wall = {n_win / wall:.3f} "
         f"windows/s; {data_s:.4f} s of data -> real-time x {data_s / wall:.4f}; "
         f"keypoints per window min {min(n_kp)} median {int(np.median(n_kp))}; "
         f"splat launches {launches} ({splats_per_window} per window); final "
         f"chunk size {b.chunk_size}; winners "
         f"{ {k: sum(int(r[0].se2_params[0]) == i for r in rec) for i, k in enumerate(eb.KINDS)} }")
    return dict(windows=n_win, wall_s=wall, data_s=data_s, launches=launches)


def _cam(device="cpu"):
    return torch.tensor([*CAM, 0, 0, 0, 0, 0], dtype=torch.float32, device=device)


def check_l2_small():
    """L2 on the card against the CPU: EventSlam runs on the CPU until it
    has a map, the map crosses to the card through convert.py, and one new
    frame's features are tracked (tracking.track_frame) and the map
    bundle-adjusted (local_mapping.local_ba) on both devices."""
    from eorb_slam_tpu_torch import convert
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.geometry import camera
    from eorb_slam_tpu_torch.ops import frontend
    from eorb_slam_tpu_torch.slam import event_system, local_mapping, system, tracking

    ev = synth_stream(0.3, RATE, seed=13)
    cfg = eb.BuilderConfig(**dict(SLICE_CFG, l1_chunk_size=1000, cm_iters=5))
    slam = event_system.EventSlam(_cam(), cfg, max_kp=MAX_KP, **L2_KW)
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
    EventSlam.track_events: 0.2 s of warm-up (L2 must initialize), 0.4 s
    timed, then 0.1 s more window by window with synchronised per-phase
    timers."""
    from eorb_slam_tpu_torch.event import builder as eb
    from eorb_slam_tpu_torch.ops import hopper_splat
    from eorb_slam_tpu_torch.slam import event_system, system

    cfg = eb.BuilderConfig(**SLICE_CFG)
    splats_per_window = cfg.l1_num_loop + 4 + 1 + 2 * cfg.cm_iters
    ev = synth_stream(EV_WARM_S + EV_RUN_S + EV_PHASE_S, RATE, seed=5)
    t_run, t_phase = EV_WARM_S, EV_WARM_S + EV_RUN_S
    warm = ev[ev[:, 0] < t_run]
    run = ev[(ev[:, 0] >= t_run) & (ev[:, 0] < t_phase)]
    phase = ev[ev[:, 0] >= t_phase]
    slam = event_system.EventSlam(_cam("cuda"), cfg, max_kp=MAX_KP,
                                  device="cuda", **L2_KW)

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

    hopper_splat.splat.launches = 0
    rec = []
    t0 = time.perf_counter()
    drive(run, rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hopper_splat.splat.launches
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
    while True:
        torch.cuda.synchronize()
        t = time.perf_counter()
        pi = slam.builder.step_window()
        torch.cuda.synchronize()
        if pi is None:
            break
        t_step.append(time.perf_counter() - t)
        t = time.perf_counter()
        slam._track_mci(pi)
        torch.cuda.synchronize()
        t_l2.append(time.perf_counter() - t)
    slam.l2._insert_keyframe = insert
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
         f"splat launches {launches} ({splats_per_window} per window); "
         f"winners {winners}")
    _log(f"EventSlam phases over {n_ph} MCIs (synchronised): step_window "
         f"{ms_step:.2f} ms, process_image tracking {ms_track:.2f} ms, "
         f"keyframe mapping {ms_map:.2f} ms per MCI ({len(t_map)} keyframes, "
         f"{1e3 * sum(t_map) / max(len(t_map), 1):.2f} ms each)")
    _log(f"EventSlam map: {l2.n_kf} keyframes, {n_lm} landmarks, "
         f"{l2.stats['lost']} lost windows, {l2.kf_culled} KFs culled, "
         f"{len(traj)} trajectory poses; stats {slam.stats}")
    if l2.n_kf < 2:
        raise RuntimeError(f"the L2 map holds {l2.n_kf} keyframes")
    if n_ok < 0.8 * n:
        raise RuntimeError(f"only {n_ok}/{n} timed MCIs tracked")
    if not traj or not all(np.isfinite(T).all() for _, T in traj):
        raise RuntimeError("a trajectory pose is not finite")
    if launches != n * splats_per_window:
        raise RuntimeError(f"{launches} splat launches for {n} windows, "
                           f"expected {splats_per_window} per window")
    if n_prior == 0:
        raise RuntimeError("no timed window ran with the L2 pose prior")
    return dict(mcis=n, wall_s=wall, data_s=data_s, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from eorb_slam_tpu_torch import _build
    from eorb_slam_tpu_torch.ops import hopper_splat

    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    _log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    hopper_splat.build()
    info = _build.BUILD_INFO["splat"]
    _log(f"build: splat kernel in {time.perf_counter() - t0:.2f} s "
         f"(nvcc {info['seconds']:.2f} s) -> {info['path']}")
    if info["log"].strip():
        _log(info["log"].strip())

    rows = check_kernel()
    check_slice_small()
    run_slice()
    check_l2_small()
    res = run_event_slam()

    top = rows[-1]      # ms and plain_ms at the largest N, 65,536 events
    _log(json.dumps({"kernels": [{
        "name": "splat_gauss",
        "route": "cuda",
        "source": "eorb_slam_tpu_torch/csrc/splat.cu",
        "replaces": "eorb_slam_tpu/ops/pallas_splat.py:60",
        "launches": res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
    }]}))
    _log(f"gpu: {gpu}")
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
