"""Event-inertial SLAM: EVENT_IMU.

PyTorch port of the first half of ``eorb_slam_tpu/slam/event_inertial.py``
(the reference's IMU_Manager wired into the event trackers): the "IMU
manager" is a host-side sample buffer sliced at each event-frame timestamp,
and the L2 event tracker IS the inertial pipeline (slam/vi_system.
MonoInertialSlam over the MCIs), so preintegration, the staged gravity/scale
initialization, dead-reckoning and VI local BA come from the one shared
implementation. The L1 window runs through the builder (and the splat
kernels on the card) exactly as in EVENT_ONLY.

EVENT_IMU_MONO (``EvImageInertialSlam``): the image clock and the synch
event MCIs of ``ev_image_system.EvImageSlam``, with the inertial pipeline as
the image tracker; each world transform the IMU init or a scale refinement
applies to the image map is replayed on the event map, so the identity
bridge of a joint init stays exact (ApplyScaleAndRotationEvSynch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch.event import builder as ev_builder
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.ops import frontend
from eorb_slam_tpu_torch.slam import ev_image_system
from eorb_slam_tpu_torch.slam import map_state as ms
from eorb_slam_tpu_torch.slam import system as slam_system
from eorb_slam_tpu_torch.slam.vi_system import ImuChunk, MonoInertialSlam


class ImuBuffer:
    """Timestamped IMU sample queue sliced into inter-frame chunks
    (IMU_Manager's per-channel queue + preintegrateIMU window logic)."""

    def __init__(self):
        self._ts = np.zeros(0, np.float64)
        self._gyro = np.zeros((0, 3), np.float32)
        self._acc = np.zeros((0, 3), np.float32)
        self._last_t: Optional[float] = None
        self.popped = 0           # samples handed out in windows so far

    def __len__(self) -> int:
        return len(self._ts)

    def push(self, ts: np.ndarray, gyro: np.ndarray, acc: np.ndarray):
        self._ts = np.concatenate([self._ts, np.asarray(ts, np.float64)])
        self._gyro = np.concatenate(
            [self._gyro, np.asarray(gyro, np.float32).reshape(-1, 3)])
        self._acc = np.concatenate(
            [self._acc, np.asarray(acc, np.float32).reshape(-1, 3)])

    def push_chunk(self, t1: float, chunk: ImuChunk):
        """Append a pre-sliced chunk whose samples end at ``t1`` (uniform
        spacing assumed from chunk.dts)."""
        n = chunk.gyro.shape[0]
        if n == 0:
            return
        ts = t1 - np.cumsum(chunk.dts[::-1])[::-1] + chunk.dts
        self.push(ts, chunk.gyro, chunk.acc)

    def window(self, t1: float) -> ImuChunk:
        """Pop all samples with ts <= t1 into one chunk; the first sample's
        dt spans from the previous window's end."""
        sel = self._ts <= t1
        ts = self._ts[sel]
        gyro = self._gyro[sel]
        acc = self._acc[sel]
        self._ts = self._ts[~sel]
        self._gyro = self._gyro[~sel]
        self._acc = self._acc[~sel]
        self.popped += len(ts)
        t_prev = self._last_t if self._last_t is not None else (
            float(ts[0]) - (float(ts[1] - ts[0]) if len(ts) > 1 else 0.005)
            if len(ts) else t1
        )
        self._last_t = t1
        if len(ts) == 0:
            return ImuChunk(gyro=np.zeros((0, 3), np.float32),
                            acc=np.zeros((0, 3), np.float32),
                            dts=np.zeros(0, np.float32))
        dts = np.diff(ts, prepend=t_prev).astype(np.float32)
        dts = np.clip(dts, 1e-5, 0.1)
        return ImuChunk(gyro=gyro, acc=acc, dts=dts)


class EventInertialSlam:
    """EVENT_IMU mode: event windows + IMU, no intensity images (reference
    System::TrackEvent with IMU measurements). The L2 tracker over MCIs is a
    full monocular-inertial pipeline, so the event map becomes metric and
    gravity-aligned once the IMU initializes. L1 and L2 run on ``device``:
    the card when it is None."""

    def __init__(
        self,
        cam_params,
        calib: pre_mod.ImuCalib,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        max_kp: int = 256,
        K: int = 24,
        M: int = 2048,
        P: int = 8,
        min_init_matches: int = 30,
        min_track_inliers: int = 8,
        min_kf_imu_init: int = 5,
        min_time_imu_init: float = 1.0,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg or ev_builder.BuilderConfig()
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params,
                                                     device=device)
        self.device = self.builder.device
        self.max_kp = max_kp
        self.imu = ImuBuffer()
        self.l2 = MonoInertialSlam(
            cam_params, calib,
            img_w=self.cfg.img_w, img_h=self.cfg.img_h,
            K=K, M=M, N=max_kp, P=P,
            min_init_matches=min_init_matches,
            min_init_triangulated=max(15, min_init_matches * 3 // 4),
            min_track_inliers=min_track_inliers,
            min_kf_imu_init=min_kf_imu_init,
            min_time_imu_init=min_time_imu_init,
            seed=seed,
            device=device,
        )
        # no fuse over MCIs (the reference's event mapper has none, and
        # coarse event features make duplicate-merging harmful to the VI
        # estimate)
        self.l2.fuse_enabled = False
        self._T_prev_mci: Optional[torch.Tensor] = None
        self.n_mci = 0
        self.n_tracked = 0

    def grab_imu(self, ts: np.ndarray, gyro: np.ndarray, acc: np.ndarray):
        """EvTrackManager::grabImuData."""
        self.imu.push(ts, gyro, acc)

    def track_events(self, events) -> list[dict]:
        """Push a raw (n,4) [t, x, y, p] event chunk and run L1/L2 until the
        buffer is drained. Returns the L2 result of every completed MCI."""
        self.builder.feed(events)
        out = []
        while (pi := self.builder.step_window()) is not None:
            out.append(self._track_mci(pi))
        return out

    def _track_mci(self, pi: ev_builder.PoseImage) -> dict:
        self.n_mci += 1
        img = pi.img * 255.0
        chunk = self.imu.window(pi.ts)
        if self.l2.imu_initialized and self.l2.state == slam_system.OK:
            res = self.l2.process_image_imu(img, pi.ts, chunk, max_kp=self.max_kp)
        else:
            feats = frontend.extract(img, max_kp=self.max_kp)
            xy_ud = cam_mod.undistort_points(self.l2.cam, feats.xy)
            f = slam_system.FrameInput(pi.ts, xy_ud, feats.octave, feats.angle,
                                       feats.desc_pm1, feats.valid)
            res = self.l2.process_features_imu(f, chunk)
        res = dict(res, ts=pi.ts, mci_kind=pi.best_kind,
                   imu_init=self.l2.imu_initialized)

        if self.l2.state == slam_system.OK:
            self.n_tracked += 1
            # the PoseDepthInfo feedback stays on the device
            T_cur = self.l2.T_last
            if self._T_prev_mci is not None:
                self.builder.set_pose_prior(
                    self._T_prev_mci, T_cur, self._median_scene_depth(T_cur))
            self._T_prev_mci = T_cur
        return res

    def _median_scene_depth(self, Tcw: torch.Tensor) -> torch.Tensor:
        """KeyFrame::ComputeSceneMedianDepth over the event map, as a device
        scalar."""
        m = self.l2.map
        return ms.median_scene_depth(m.lm_pos, m.lm_valid, Tcw)

    def trajectory_twc(self):
        return self.l2.trajectory_twc()

    @property
    def imu_initialized(self) -> bool:
        return self.l2.imu_initialized

    @property
    def stats(self):
        s = dict(self.builder.stats)
        s.update(mci=self.n_mci, tracked=self.n_tracked,
                 **{f"l2_{k}": v for k, v in self.l2.stats.items()})
        return s


class EvImageInertialSlam(ev_image_system.EvImageSlam):
    """EVENT_IMU_MONO mode: the image clock, synch event MCIs and the IMU on
    the image tracker (System::TrackEvMono routing the IMU to Tracking); the
    event map follows the image map's rescales. Runs on ``device``: the
    card when it is None."""

    def __init__(self, cam_params, calib: pre_mod.ImuCalib, *,
                 min_kf_imu_init: int = 6, min_time_imu_init: float = 1.5,
                 **kw):
        super().__init__(cam_params, **kw)
        slam_kw = {k: v for k, v in kw.items()
                   if k in ("K", "M", "P", "min_init_matches", "min_track_inliers",
                            "local_window", "seed", "loop_words")}
        # the inertial pipeline replaces the visual image tracker (built
        # without the loop handoff's opt-in, as the reference's)
        self.im = MonoInertialSlam(
            cam_params, calib, img_w=self.im.img_w, img_h=self.im.img_h,
            N=self.max_kp, min_kf_imu_init=min_kf_imu_init,
            min_time_imu_init=min_time_imu_init, device=self.device, **slam_kw,
        )
        self._scale_seen = 1.0

    def _track_image(self, img, ts: float, imu=None):
        if imu is None:
            imu = ImuChunk(gyro=np.zeros((0, 3), np.float32),
                           acc=np.zeros((0, 3), np.float32),
                           dts=np.zeros(0, np.float32))
        feats = frontend.extract(self._frame_tensor(img), max_kp=self.max_kp)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        f = slam_system.FrameInput(ts, xy_ud, feats.octave, feats.angle,
                                   feats.desc_pm1, feats.valid)
        res = self.im.process_features_imu(f, imu)
        # replay the image map's world transforms on the event map under a
        # locked (joint-init) gauge; without one the stored pairs mix
        # scales and are dropped
        for Ryw, s in self.im.pending_world_transforms:
            if self._gauge_locked and self.ev.n_kf >= 2:
                self._apply_world_transform_to_event(Ryw, s)
        self.im.pending_world_transforms.clear()
        if self.im.scale_applied != self._scale_seen:
            self._gauge_pairs.clear()
            self._scale_seen = self.im.scale_applied
        return res

    def _apply_world_transform_to_event(self, Ryw: np.ndarray, s: float):
        """world' = s Ryw world on the event map: Rcw' = Rcw Ryw^T,
        tcw' = s tcw, lm' = s Ryw lm (Map::ApplyScaledRotation), on the
        trajectory too."""
        m = self.ev.map
        R = torch.as_tensor(np.asarray(Ryw, np.float32)).to(m.kf_T.device)
        kf_T = m.kf_T.clone()
        kf_T[:, :3, :3] = m.kf_T[:, :3, :3] @ R.T
        kf_T[:, :3, 3] *= s
        self.ev.map = m._replace(kf_T=kf_T, lm_pos=s * (m.lm_pos @ R.T))
        Tl = self.ev.T_last.clone()
        Tl[:3, :3] = self.ev.T_last[:3, :3] @ R.T
        Tl[:3, 3] *= s
        self.ev.T_last = Tl
        self.ev.velocity = self.ev._eye4()
        self.ev._rescale_trajectory(s, Ryw)
