"""Unified dataset-driven SLAM runner — the app layer of the port.

PyTorch port of ``eorb_slam_tpu/apps/run_slam.py``. One YAML settings file
drives everything, like the reference's ``fmt_ev_ethz`` / ``fmt_euroc``
mains: per image timestamp (or, in the event-only modes, per fixed-size
event chunk: System::TrackEvent), dispatch on the sensor config to the right
pipeline, time every iteration, and save TUM trajectories with the
timing-stats header.

Every sensor mode runs: EVENT_ONLY through the discrete tracker
(slam/event_system.EventSlam) or, with ``Event.contTracking: 1`` (the
loader's default), the continuous one (slam/event_continuous.py);
MONOCULAR with ORB features; IMU_MONOCULAR
(slam/vi_system.MonoInertialSlam); EVENT_IMU
(slam/event_inertial.EventInertialSlam); STEREO, RGBD and IMU_STEREO
(slam/rgbd_stereo.py); and the image-clock event modes EVENT_MONO and
EVENT_IMU_MONO (slam/ev_image_system.EvImageSlam and
event_inertial.EvImageInertialSlam), which also write the fused event +
image trajectory. The image modes close loops and merge maps when the
settings configure a vocabulary (``make_vocab``: a DBoW2 text file, or one
trained on the sequence's own frames). MONOCULAR with ``Features.mode:
2`` runs mixed ORB + AKAZE features (slam/system.MixedMonoSlam); any other
mode runs ORB, as the reference app does. The system runs on the card
unless ``--device`` says otherwise; without a card it raises rather than
carrying on on the CPU.

Usage:
    python -m eorb_slam_tpu_torch.apps.run_slam <settings.yaml> [--out DIR]
        [--max-frames N] [--eval] [--sequence NAME] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch._host import resolve_device, to_device
from eorb_slam_tpu_torch.io import config as cfg_mod
from eorb_slam_tpu_torch.io import datasets, trajectory
from eorb_slam_tpu_torch.io.config import SensorConfig


def make_vocab(st: cfg_mod.Settings, seq=None, device=None):
    """Load or train the place-recognition vocabulary (the reference loads
    ORBvoc.txt in System::System) on ``device`` (None: the card). Returns a
    bow.HierVocab, or None when the settings configure no vocabulary. A
    configured vocabulary that cannot be set up raises: a run that was
    meant to close loops never goes on without them."""
    from eorb_slam_tpu_torch.retrieval import bow

    device = resolve_device(device)
    if st.vocab.path:
        return bow.load_vocab_text_hier(st.vocab.path, device=device)
    if st.vocab.train_words <= 0:
        return None
    if seq is None or seq.n_frames == 0:
        raise ValueError("Vocabulary.trainWords is set, but there are no frames "
                         "to train the vocabulary on")
    from eorb_slam_tpu_torch.ops import frontend

    descs = []
    idxs = np.linspace(0, seq.n_frames - 1, min(st.vocab.train_frames, seq.n_frames),
                       dtype=int)
    for i in idxs:
        img = (seq.image(int(i)) * 255.0).astype(np.uint8)
        f = frontend.extract(to_device(img, device), max_kp=512)
        descs.append(f.desc_pm1[f.valid])
    k1 = max(8, int(np.sqrt(st.vocab.train_words)))
    k2 = max(8, st.vocab.train_words // k1)
    return bow.train_hier_vocab(torch.cat(descs), K1=k1, K2=k2, iters=4)


def build_system(st: cfg_mod.Settings, loop_words=None, device=None):
    """System::System equivalent: construct the pipeline for the sensor
    config on ``device`` (None: the card)."""
    from eorb_slam_tpu_torch.event import builder as ev_builder
    from eorb_slam_tpu_torch.imu import preintegration as pre_mod

    device = resolve_device(device)
    s = st.sensor
    cam = st.cam.params_array()
    kw = dict(
        img_w=st.cam.width or 240, img_h=st.cam.height or 180,
        N=min(max(st.features.n_features, 128), 1024),
        K=st.slam.max_keyframes, M=st.slam.max_landmarks,
        local_window=st.slam.local_window,
        max_frames_between_kf=st.slam.max_frames_between_kf,
        device=device,
    )
    if loop_words is not None:
        kw["loop_words"] = loop_words
    calib = pre_mod.make_calib(
        Tbc=st.imu.Tbc, gyro_noise=st.imu.noise_gyro, acc_noise=st.imu.noise_acc,
        gyro_walk=st.imu.walk_gyro, acc_walk=st.imu.walk_acc, freq=st.imu.freq,
    )
    ev_cfg = ev_builder.BuilderConfig(
        img_w=st.cam.width or 240, img_h=st.cam.height or 180,
        l1_chunk_size=st.event.l1_chunk_size,
        l1_num_loop=st.event.l1_num_loop,
        min_ev_gen_rate=st.event.min_ev_gen_rate,
        max_pixel_disp=st.event.max_pixel_disp,
        sigma=st.event.sigma,
    )
    if s is SensorConfig.MONOCULAR:
        if st.features.mode == 2:  # mixed ORB + AKAZE (Features.mode: 2)
            from eorb_slam_tpu_torch.slam.system import MixedMonoSlam

            return MixedMonoSlam(cam, **kw)
        from eorb_slam_tpu_torch.slam.system import MonoSlam

        # pipelined: the per-frame decision read overlaps the next frame's
        # work (host decisions trail one frame), as in the reference app
        return MonoSlam(cam, pipelined=True, **kw)
    baseline = st.cam.bf / max(st.cam.fx, 1e-9)
    if s is SensorConfig.STEREO:
        from eorb_slam_tpu_torch.slam.rgbd_stereo import StereoSlam

        return StereoSlam(cam, baseline=baseline, **kw)
    if s is SensorConfig.RGBD:
        from eorb_slam_tpu_torch.slam.rgbd_stereo import RgbdSlam

        return RgbdSlam(cam, **kw)
    if s is SensorConfig.IMU_MONOCULAR:
        from eorb_slam_tpu_torch.slam.vi_system import MonoInertialSlam

        return MonoInertialSlam(cam, calib, **kw)
    if s is SensorConfig.IMU_STEREO:
        from eorb_slam_tpu_torch.slam.rgbd_stereo import StereoInertialSlam

        return StereoInertialSlam(cam, calib, baseline=baseline, **kw)
    if s is SensorConfig.EVENT_ONLY:
        if st.event.continuous:
            from eorb_slam_tpu_torch.slam.event_continuous import EventSlamContinuous

            return EventSlamContinuous(cam, ev_cfg, device=device)
        from eorb_slam_tpu_torch.slam.event_system import EventSlam

        return EventSlam(cam, ev_cfg, device=device)
    if s is SensorConfig.EVENT_IMU:
        from eorb_slam_tpu_torch.slam.event_inertial import EventInertialSlam

        return EventInertialSlam(cam, calib, ev_cfg, device=device)
    # the image tracker of the image-clock event modes carries the loop
    # closer; a loop correction moves the event map with it
    ev_im_kw = {} if loop_words is None else {"loop_words": loop_words}
    if s is SensorConfig.EVENT_MONO:
        from eorb_slam_tpu_torch.slam.ev_image_system import EvImageSlam

        return EvImageSlam(cam, ev_cfg, img_w=st.cam.width, img_h=st.cam.height,
                           max_kp=kw["N"], device=device, **ev_im_kw)
    if s is SensorConfig.EVENT_IMU_MONO:
        from eorb_slam_tpu_torch.slam.event_inertial import EvImageInertialSlam

        return EvImageInertialSlam(cam, calib, cfg=ev_cfg, img_w=st.cam.width,
                                   img_h=st.cam.height, max_kp=kw["N"], device=device,
                                   **ev_im_kw)
    raise ValueError(f"unsupported sensor config: {s}")


def _imu_chunk(seq: datasets.Sequence, t0: float, t1: float):
    """The sequence's IMU samples in (t0, t1], with boundary-bridging dts."""
    from eorb_slam_tpu_torch.slam.vi_system import ImuChunk

    if seq.imu is None:
        return ImuChunk(gyro=np.zeros((0, 3), np.float32),
                        acc=np.zeros((0, 3), np.float32),
                        dts=np.zeros(0, np.float32))
    i0 = int(np.searchsorted(seq.imu.ts, t0, side="right"))
    i1 = int(np.searchsorted(seq.imu.ts, t1, side="right"))
    ts = seq.imu.ts[i0:i1]
    dts = np.diff(ts, prepend=t0).astype(np.float32)
    return ImuChunk(gyro=seq.imu.gyro[i0:i1].astype(np.float32),
                    acc=seq.imu.acc[i0:i1].astype(np.float32),
                    dts=np.clip(dts, 1e-5, 0.1))


def run_sequence(
    st: cfg_mod.Settings,
    seq: datasets.Sequence,
    out_dir: str = "results",
    max_frames: Optional[int] = None,
    pace: bool = False,
    verbose: bool = True,
    device=None,
):
    """One sequence through the pipeline; returns (slam, result dict)."""
    loop_words = make_vocab(st, seq, device) if st.sensor.is_image() else None
    slam = build_system(st, loop_words=loop_words, device=device)
    s = st.sensor
    main_timer = trajectory.SmartTimer("tracking")
    t_wall0 = time.perf_counter()

    if s in (SensorConfig.EVENT_ONLY, SensorConfig.EVENT_IMU):
        # event-clock loop: fixed-size chunks (System::TrackEvent)
        if seq.events is None:
            raise ValueError("event mode needs an event stream")
        chunk_n = st.event.l1_chunk_size * st.event.l1_num_loop
        n_chunks = 0
        last_t = float(seq.events.events[0, 0]) if len(seq.events) else 0.0
        while not seq.events.exhausted:
            chunk = seq.events.next_chunk_count(chunk_n)
            if len(chunk) == 0:
                break
            t_hi = float(chunk[-1, 0])
            if s is SensorConfig.EVENT_IMU and seq.imu is not None:
                sel = (seq.imu.ts > last_t) & (seq.imu.ts <= t_hi)
                slam.grab_imu(seq.imu.ts[sel], seq.imu.gyro[sel], seq.imu.acc[sel])
            main_timer.tic()
            slam.track_events(chunk)
            main_timer.toc()
            last_t = t_hi
            n_chunks += 1
            if max_frames is not None and n_chunks >= max_frames:
                break
        n_iter = n_chunks
    else:
        # image-clock loop (fmt_ev_ethz main loop)
        n = seq.n_frames if max_frames is None else min(seq.n_frames, max_frames)
        last_t = None
        for i in range(n):
            t = float(seq.image_ts[i])
            t_prev = last_t if last_t is not None else t - 1.0 / max(st.cam.fps, 1.0)
            # the loader serves [0,1]; FAST thresholds are 8-bit units. A
            # uint8 frame keeps the host-to-device copy small; extract casts
            # on the device.
            img = (seq.image(i) * 255.0).astype(np.uint8)
            main_timer.tic()
            dev = slam.device
            if s is SensorConfig.IMU_MONOCULAR:
                slam.process_image_imu(to_device(img, dev), t,
                                       _imu_chunk(seq, t_prev, t))
            elif s is SensorConfig.STEREO:
                # the right image goes as float [0,255], unquantized, as the
                # reference app passes it
                img_r = (seq.image_right(i) * 255.0).astype(np.float32)
                slam.process_stereo(to_device(img, dev), to_device(img_r, dev), t)
            elif s is SensorConfig.IMU_STEREO:
                img_r = (seq.image_right(i) * 255.0).astype(np.float32)
                slam.process_stereo_imu(to_device(img, dev), to_device(img_r, dev),
                                        t, _imu_chunk(seq, t_prev, t))
            elif s is SensorConfig.RGBD:
                slam.process_rgbd(to_device(img, dev),
                                  to_device(seq.depth(i).astype(np.float32), dev), t)
            elif s in (SensorConfig.EVENT_MONO, SensorConfig.EVENT_IMU_MONO):
                # the events in (last image, this image]
                ev = (seq.events.next_chunk_until(t) if seq.events is not None
                      else np.zeros((0, 4)))
                imu = (_imu_chunk(seq, t_prev, t) if s is SensorConfig.EVENT_IMU_MONO
                       else None)
                slam.track_ev_mono(ev, img, t, imu=imu)
            else:
                slam.process_image(to_device(img, dev), t)
            main_timer.toc()
            last_t = t
            if pace:
                sleep = 1.0 / max(st.cam.fps, 1.0) - main_timer.deltas[-1]
                if sleep > 0:
                    time.sleep(sleep)
            if verbose and i % 50 == 0:
                print(f"[{seq.name}] frame {i}/{n}", file=sys.stderr)
        n_iter = n

    wall = time.perf_counter() - t_wall0
    os.makedirs(out_dir, exist_ok=True)
    traj = slam.trajectory_twc()
    out = {
        "sequence": seq.name,
        "iterations": n_iter,
        "wall_s": wall,
        "tracked_poses": len(traj),
        "avg_track_ms": main_timer.average * 1e3,
        "stats": dict(slam.stats),
    }
    if traj:
        ts = np.asarray([x for x, _ in traj])
        Twc = np.stack([T for _, T in traj])
        path = os.path.join(out_dir, f"{seq.name}_{s.name.lower()}.txt")
        trajectory.save_tum(path, ts, Twc, timers=(main_timer,))
        out["trajectory_file"] = path
    # FuseEventORB on the way out (System::Shutdown). Fusion is
    # post-processing of a finished run: as in the reference, a failure is
    # reported in the result instead of discarding the run
    if hasattr(slam, "fused_trajectory"):
        try:
            fused = slam.fused_trajectory()
            if fused.get("chains", 0) > 0:
                ts = np.asarray([x for x, _ in fused["fused"]])
                Twc = np.stack([T for _, T in fused["fused"]])
                path = os.path.join(out_dir, f"{seq.name}_fused.txt")
                trajectory.save_tum(path, ts, Twc, timers=(main_timer,))
                out["fused_trajectory_file"] = path
        except Exception as e:
            out["fusion_error"] = str(e)
    return slam, out


def evaluate(seq: datasets.Sequence, traj_file: str, monocular: bool = True):
    """Score a saved trajectory against the sequence GT (the reference's
    evaluate_ate_scale.py / my_eval_ape.py protocol)."""
    from eorb_slam_tpu_torch.evals import ate, kitti_odom, rpe
    from eorb_slam_tpu_torch.io.trajectory import load_tum, tum_to_mats

    if seq.gt_ts is None:
        return {"error": "no ground truth in sequence"}
    rows = load_tum(traj_file)
    ts_e, Twc_e = tum_to_mats(rows)
    est = list(zip(ts_e.tolist(), Twc_e))
    gt_rows = np.concatenate([seq.gt_ts[:, None], seq.gt_pose], axis=1)
    ts_g, Twc_g = tum_to_mats(gt_rows)
    gt = list(zip(ts_g.tolist(), Twc_g))
    out = {}
    r, n, scale, _, _ = ate.ate_rmse(est, gt, with_scale=monocular)
    out["ate_rmse"] = r
    out["ate_n"] = n
    out["ate_scale"] = scale
    out["ape_piecewise"] = {
        k: v for k, v in rpe.ate_piecewise(est, gt, with_scale=monocular).items()
        if k != "pieces"
    }
    rp = rpe.rpe(est, gt, delta=1, scale_norm=monocular)
    out["rpe_trans_rmse"] = rp["trans_rmse"]
    out["rpe_rot_rmse"] = rp["rot_rmse"]
    # KITTI-devkit sub-sequence odometry metrics when enough overlap exists
    ia, ib = ate.associate(ts_e, ts_g, 0.02)
    if len(ia) >= 50:
        ko = kitti_odom.kitti_odom_eval(Twc_g[ib], Twc_e[ia])
        if ko["n_subseq"]:
            out["kitti_t_err_pct"] = ko["t_err_pct"]
            out["kitti_r_err_deg_per_100m"] = ko["r_err_deg_per_100m"]
    return out


@contextlib.contextmanager
def _profile(out_dir: Optional[str]):
    """``torch.profiler`` over the block; the chrome trace and the table of
    operators by device time go into ``out_dir``. No-op without one."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=50))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("settings", help="YAML settings file (reference format)")
    p.add_argument("--out", default="results")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--sequence", default=None,
                   help="override DS target sequence name")
    p.add_argument("--eval", action="store_true", dest="do_eval")
    p.add_argument("--pace", action="store_true",
                   help="sleep to dataset frame rate (real-time pacing)")
    p.add_argument("--device", default=None,
                   help="default: the card (raises without one); 'cpu' runs "
                        "the system on the CPU")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the first "
                        "sequence into DIR (trace.json for chrome://tracing "
                        "and key_averages.txt)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    st = cfg_mod.load_settings(args.settings)
    seqs = list(st.dataset.sequences) or [""]
    if args.sequence is not None:
        seqs = [args.sequence]
    elif st.dataset.seq_target >= 0:
        seqs = [seqs[st.dataset.seq_target]]

    results = []
    for i, name in enumerate(seqs):
        seq = datasets.load_sequence(
            st.dataset.format, st.dataset.root, name,
            ts_factor=st.dataset.ts_factor,
        )
        with _profile(args.profile if i == 0 else None):
            slam, out = run_sequence(
                st, seq, out_dir=args.out, max_frames=args.max_frames,
                pace=args.pace, device=device,
            )
        out["device"] = str(slam.device)
        if args.do_eval and "trajectory_file" in out:
            out["eval"] = evaluate(
                seq, out["trajectory_file"],
                monocular=st.sensor.is_monocular() and not st.sensor.is_inertial(),
            )
        print(out)
        results.append(out)
    return results


if __name__ == "__main__":
    main()
