"""Event SLAM pipeline: L1 window builder + L2 tracker over MCIs.

PyTorch port of ``eorb_slam_tpu/slam/event_system.py`` (reference
EvTrackManager + EvAsynchTracker + EvLocalMapping): a host loop over the L1
builder's windows (event/builder.EventWindowBuilder.step_window), each
motion-compensated image (MCI) tracked by the same SLAM core as the image
pipeline (slam/system.MonoSlam) on its own map tensors.

The L2 -> L1 feedback (reference PoseDepthInfo) stays on the device: after
each tracked MCI the pose pair and the median scene depth are posted to the
builder, whose next DPose candidate motion-compensates with them.

The L2 tracker speculates one MCI ahead (``pipelined=True``, as the
reference's): the decision on an MCI is read while the next window is built,
and after a keyframe the MCI in flight keeps its predicted pose.
"""

from __future__ import annotations

from typing import Optional

import torch

from eorb_slam_tpu_torch.event import builder as ev_builder
from eorb_slam_tpu_torch.slam import map_state as ms
from eorb_slam_tpu_torch.slam import system as slam_system


class EventSlam:
    """Event-only SLAM (EVENT_ONLY mode; reference System::TrackEvent). L1
    and L2 run on ``device``: the card when it is None, as for the builder."""

    def __init__(
        self,
        cam_params,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        max_kp: int = 256,
        K: int = 24,
        M: int = 2048,
        P: int = 8,
        min_init_matches: int = 40,
        min_track_inliers: int = 10,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg or ev_builder.BuilderConfig()
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params,
                                                     device=device)
        self.device = self.builder.device
        self.max_kp = max_kp
        self.l2 = slam_system.MonoSlam(
            cam_params,
            img_w=self.cfg.img_w,
            img_h=self.cfg.img_h,
            K=K, M=M, N=max_kp, P=P,
            min_init_matches=min_init_matches,
            min_init_triangulated=max(15, min_init_matches * 3 // 4),
            min_track_inliers=min_track_inliers,
            seed=seed,
            # the per-MCI decision read overlaps the next window's work
            pipelined=True,
            # event-KF cadence: MCIs decorrelate far faster than camera
            # frames, so keyframes land every few windows (the reference's
            # needNewKeyFrame fires at MCI rate)
            max_frames_between_kf=3,
            kf_inlier_ratio=0.8,
            device=device,
        )
        # no SearchInNeighbors/Fuse over MCIs (the reference's event-side
        # mapper has none), and short event KF chains are stored, not reset
        self.l2.fuse_enabled = False
        self.l2.min_kf_store = 4
        self._T_prev_mci: Optional[torch.Tensor] = None
        self.n_mci = 0
        self.n_tracked = 0

    # ---------------------------------------------------------------- input

    def track_events(self, events) -> list[dict]:
        """System::TrackEvent: push a raw (n,4) [t, x, y, p] event chunk and
        run L1/L2 until the buffer is drained. Returns the L2 result of every
        completed MCI."""
        self.builder.feed(events)
        out = []
        while (pi := self.builder.step_window()) is not None:
            out.append(self._track_mci(pi))
        return out

    # ------------------------------------------------------------------ L2

    def _track_mci(self, pi: ev_builder.PoseImage) -> dict:
        self.n_mci += 1
        res = self.l2.process_image(pi.img * 255.0, pi.ts, max_kp=self.max_kp)
        res = dict(res, ts=pi.ts, mci_kind=pi.best_kind)
        if self.l2.state == slam_system.OK:
            self.n_tracked += 1
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

    # --------------------------------------------------------------- output

    def trajectory_twc(self):
        return self.l2.trajectory_twc()

    @property
    def stats(self):
        s = dict(self.builder.stats)
        s.update(mci=self.n_mci, tracked=self.n_tracked,
                 **{f"l2_{k}": v for k, v in self.l2.stats.items()})
        return s
