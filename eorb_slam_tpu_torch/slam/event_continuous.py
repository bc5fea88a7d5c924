"""Continuous event tracker: persistent feature tracks instead of per-MCI
descriptor matching (EVENT_ONLY with ``Event.contTracking: 1``).

PyTorch port of ``eorb_slam_tpu/slam/event_continuous.py`` (reference
EvAsynchTrackerU: per event image trackLastFeatures ->
checkTrackedMapPoints -> detectAndFuseNewFeatures -> estimateCurrentPose ->
localMapping -> reconstIniMap, with the track-driven mapping of
EvLocalMapping). A feature track owns one slot for life and the slot index
IS the feature index in every keyframe (event/feature_tracks.py): the
landmark a track observes is a per-slot int, so matching is free, and
triangulation between keyframes is row-aligned.

Track rebirth cannot alias old keyframe rows: a reseeded slot carries
``birth_kf = -1`` until the next keyframe adopts it, and aligned
triangulation between keyframes a > b only takes rows with
``0 <= birth_kf <= seq(b)``.

The L1 side is ``EventWindowBuilder.step``: one identity splat per chunk and
the window's MCI through ``build_mci`` (the splat kernels on the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch.event import builder as ev_builder
from eorb_slam_tpu_torch.event import feature_tracks as ft
from eorb_slam_tpu_torch.geometry import lie, twoview
from eorb_slam_tpu_torch.optim import pose_only
from eorb_slam_tpu_torch.slam import local_mapping, map_state
from eorb_slam_tpu_torch.slam import system as slam_system


class ContinuousEventTracker(slam_system.MonoSlam):
    """L2 tracker over the stream of event images (tiny frames + MCIs).

    MonoSlam's map, atlas, trajectory and recovery plumbing, with detection
    and matching replaced by persistent KLT feature tracks. Runs on
    ``device``: the card when it is None."""

    def __init__(
        self,
        cam_params,
        img_w: int = 240,
        img_h: int = 180,
        n_tracks: int = 256,
        K: int = 24,
        M: int = 2048,
        P: int = 8,
        min_init_matches: int = 40,
        min_init_disp_px: float = 4.0,
        min_track_inliers: int = 10,
        kf_disp_px: float = 8.0,
        seed: int = 0,
        **kw,
    ):
        super().__init__(
            cam_params, img_w=img_w, img_h=img_h, K=K, M=M, N=n_tracks, P=P,
            min_init_matches=min_init_matches,
            min_init_triangulated=max(15, min_init_matches * 3 // 4),
            min_track_inliers=min_track_inliers, seed=seed, **kw,
        )
        self.n_tracks = n_tracks
        self.min_init_disp_px = min_init_disp_px
        self.kf_disp_px = kf_disp_px
        self.tracks = ft.empty_tracks(n_tracks, self.device)
        self.prev_img: Optional[torch.Tensor] = None
        # init reference snapshot (reconstIniMap's two-view baseline)
        self._ref_xy: Optional[torch.Tensor] = None
        self._ref_valid: Optional[torch.Tensor] = None
        self._ref_ts: float = 0.0
        self.stats.update(tiny=0, full=0, topped=0)

    # ----------------------------------------------------------------- input

    def process_event_image(self, img: torch.Tensor, ts: float, full: bool = True):
        """One event image through the continuous pipeline. ``full=False``
        marks a tiny frame (reconst_stat 0): KLT continuity only, no pose or
        keyframe work."""
        # trackLastFeatures: advance every live track
        if self.prev_img is not None:
            self.tracks, _ = ft.advance(self.tracks, self.prev_img, img)
        self.prev_img = img
        if not full:
            self.stats["tiny"] += 1
            return {"state": self.state, "tiny": True}
        self.stats["full"] += 1
        self.stats["frames"] += 1

        if self.state == slam_system.NOT_INITIALIZED:
            out = self._try_initialize_tracks(img, ts)
        else:
            out = self._track_tracks(img, ts)

        # detectAndFuseNewFeatures: top up the dead slots (not while an init
        # baseline accumulates: reseeded rows would alias the snapshot)
        if self.state != slam_system.NOT_INITIALIZED or self._ref_xy is None:
            self.tracks, n_new = ft.top_up(self.tracks, img)
            self.stats["topped"] += int(n_new)
        return out

    # ------------------------------------------------------------------ init

    def _reset_init_ref(self, img: torch.Tensor, ts: float):
        self.tracks, _ = ft.top_up(ft.empty_tracks(self.n_tracks, self.device), img)
        self._ref_xy = self.tracks.xy
        self._ref_valid = self.tracks.valid
        self._ref_ts = ts

    def _try_initialize_tracks(self, img: torch.Tensor, ts: float):
        if self._ref_xy is None:
            self._reset_init_ref(img, ts)
            return {"state": self.state, "n": 0}

        alive = self.tracks.valid & self._ref_valid
        # one read: the surviving rows and their displacement since the
        # snapshot
        disp = torch.linalg.norm(self.tracks.xy - self._ref_xy, dim=-1)
        packed = torch.stack([alive.to(disp.dtype), disp]).cpu().numpy()
        alive_np = packed[0] > 0.5
        n_alive = int(alive_np.sum())
        if n_alive < self.min_init_matches:
            self._reset_init_ref(img, ts)
            return {"state": self.state, "n": n_alive}
        if float(np.median(packed[1][alive_np])) < self.min_init_disp_px:
            return {"state": self.state, "n": n_alive}   # keep accumulating

        # two-view reconstruction over row-aligned correspondences
        res = twoview.reconstruct_two_views(
            self.cam, self._ref_xy, self.tracks.xy, alive, self.generator,
            min_triangulated=self.min_init_triangulated,
        )
        if not bool(res.success):
            return {"state": self.state, "n": n_alive}
        return self._create_initial_map(res, alive, ts)

    def _create_initial_map(self, res, alive, ts: float):
        """initMap (EvAsynchTrackerU::reconstIniMap + initMap): two
        slot-aligned founding keyframes, the median-depth gauge, init BA."""
        good = (res.is_triangulated & alive).cpu().numpy()
        pts = res.pts3d.cpu().numpy()
        med = float(np.median(pts[good, 2])) if good.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_s = self._dev(pts * scale)
        T2 = res.Tcw2.cpu().numpy().copy()
        T2[:3, 3] *= scale

        N = self.n_tracks
        dev = self.device
        no_lm = torch.full((N,), -1, dtype=torch.int32, device=dev)
        zeros = torch.zeros(N, dtype=torch.int32, device=dev)
        desc = self.tracks.desc_pm1
        m = map_state.insert_keyframe(
            self.map, 0, self._eye4(), self._ref_ts, self._ref_xy, zeros,
            zeros.to(torch.float32), desc, self._ref_valid, no_lm)
        m = map_state.insert_keyframe(
            m, 1, self._dev(T2), ts, self.tracks.xy, zeros,
            zeros.to(torch.float32), desc, self.tracks.valid, no_lm)
        feat_ids = torch.arange(N, dtype=torch.int32, device=dev)
        m, lm_ids = map_state.alloc_landmarks(
            m, pts_s, desc, res.is_triangulated & alive, 0, feat_ids, 1, feat_ids)
        self.map = m
        self.n_kf = 2

        kf_free = torch.zeros(self.map.K, dtype=torch.bool, device=dev)
        kf_free[1] = True
        self.map, _, _ = local_mapping.local_ba(self.map, self.cam, kf_free, iters=10,
                                                refresh_desc=self.desc_refresh)
        # re-pin the monocular gauge after the init BA (as MonoSlam)
        lmv = self.map.lm_valid.cpu().numpy()
        if lmv.any():
            s2 = 1.0 / max(float(np.median(self.map.lm_pos.cpu().numpy()[lmv, 2])), 1e-6)
            kf_T = self.map.kf_T.clone()
            kf_T[1, :3, 3] *= s2
            self.map = self.map._replace(lm_pos=self.map.lm_pos * s2, kf_T=kf_T)

        # adopt the tracks: landmark links, birth at KF0 (the snapshot's
        # survivors) or KF1. birth_kf is the monotone keyframe SEQUENCE id
        # (slots are reused after culling, so slot indices do not order)
        seq0, seq1 = int(self.kf_seq[0]), int(self.kf_seq[1])
        tr = self.tracks
        self.tracks = tr._replace(
            lm=torch.where(lm_ids >= 0, lm_ids, tr.lm),
            birth_kf=torch.where(tr.valid & alive, seq0,
                                 torch.where(tr.valid, seq1, tr.birth_kf)).to(torch.int32),
        )
        self._ref_xy = None
        self._ref_valid = None
        self.state = slam_system.OK
        self.T_last = self.map.kf_T[1]
        self.velocity = self._eye4()
        self.frames_since_kf = 0
        n_lm = int(self.map.lm_valid.sum())
        self.n_inliers_ref = n_lm
        self._log_pose(ts, self.T_last)
        self.stats["kf"] = 2
        self.stats["lm"] = n_lm
        return {"state": self.state, "n_pts": n_lm}

    # ----------------------------------------------------------------- track

    def _lm_observations(self):
        tr = self.tracks
        has = tr.valid & (tr.lm >= 0)
        lm_idx = torch.where(has, tr.lm, 0).long()
        return self.map.lm_pos[lm_idx], has & self.map.lm_valid[lm_idx]

    def _solve_pose(self, T0, pts_w, obs_ok, inv_sigma):
        """Pose-only GN from ``T0``; one read of (inliers, finite)."""
        Tcw, inl, n_inl = pose_only.pose_optimization(
            self.cam, T0, pts_w, self.tracks.xy, inv_sigma, obs_ok)
        n, finite = (float(x) for x in torch.stack(
            [n_inl.to(torch.float32), torch.isfinite(Tcw).all().to(torch.float32)]).cpu())
        return Tcw, inl, int(n), bool(finite)

    def _track_tracks(self, img: torch.Tensor, ts: float):
        """estimateCurrentPose: motion-model prediction + pose-only GN over
        the tracks' landmark observations (matching is the slot identity),
        KLT-quality-weighted."""
        pts_w, obs_ok = self._lm_observations()
        inv_sigma = 0.5 + self.tracks.quality
        Tcw, inl, n, finite = self._solve_pose(self.velocity @ self.T_last, pts_w,
                                               obs_ok, inv_sigma)
        if n < self.min_track_inliers:
            Tcw, inl, n, finite = self._solve_pose(self.T_last, pts_w, obs_ok, inv_sigma)
            if n < self.min_track_inliers:
                return self._lost_tracks(img, ts, n)
        if not finite:
            return self._lost_tracks(img, ts, 0)

        # checkTrackedMapPoints: detach tracks whose observation is an
        # outlier under the solved pose (the track drifted off its landmark)
        self.tracks = self.tracks._replace(
            lm=torch.where(obs_ok & ~inl, -1, self.tracks.lm))

        self.lost_frames = 0
        self.state = slam_system.OK
        self.velocity = Tcw @ lie.se3_inv(self.T_last)
        self.T_last = Tcw
        self.frames_since_kf += 1
        self._log_pose(ts, Tcw)

        out = {"state": self.state, "n_inliers": n, "kf": False}
        if self._need_kf(n):
            self._insert_track_keyframe(ts, Tcw)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def _need_kf(self, n_inl: int) -> bool:
        """Keyframe by the median track displacement since the last keyframe
        (EvAsynchTrackerU::localMapping), or Tracking's inlier-ratio and
        frame-count rules."""
        last = self._kf_order[-1]
        tr = self.tracks
        both = (tr.valid & self.map.kf_feat_valid[last] & (tr.birth_kf >= 0)
                & (tr.birth_kf <= int(self.kf_seq[last])))
        d = torch.linalg.norm(tr.xy - self.map.kf_xy[last], dim=-1)
        packed = torch.stack([both.to(d.dtype), d]).cpu().numpy()
        both_np = packed[0] > 0.5
        if both_np.sum() >= 8 and float(np.median(packed[1][both_np])) > self.kf_disp_px:
            return True
        return (n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
                or self.frames_since_kf >= self.max_frames_between_kf)

    def _insert_track_keyframe(self, ts: float, Tcw: torch.Tensor):
        slot = self._alloc_kf_slot()
        N = self.n_tracks
        tr = self.tracks
        zeros = torch.zeros(N, dtype=torch.int32, device=self.device)
        self.map = map_state.insert_keyframe(
            self.map, slot, Tcw, ts, tr.xy, zeros, zeros.to(torch.float32),
            tr.desc_pm1, tr.valid, torch.where(tr.valid, tr.lm, -1))
        # aligned triangulation against the recent keyframes: row i of both
        # is the same physical track iff it was born at or before the older
        # one (a rebirth bumps birth_kf, so no aliasing)
        order = self._kf_order
        for back in range(1, min(3, len(order)) + 1):
            kf_b = order[-back]
            tr = self.tracks
            slot_ok = (tr.valid & (tr.birth_kf >= 0)
                       & (tr.birth_kf <= int(self.kf_seq[kf_b])))
            self.map, lm_ids = local_mapping.create_new_landmarks_aligned(
                self.map, self.cam, slot, kf_b, slot_ok)
            self.tracks = tr._replace(lm=torch.where(lm_ids >= 0, lm_ids, tr.lm))
        self._kf_order.append(slot)
        self.kf_seq[slot] = self._kf_seq_next
        self._kf_seq_next += 1
        self.last_kf_slot = slot
        # adopt the fresh tracks into this keyframe
        tr = self.tracks
        self.tracks = tr._replace(birth_kf=torch.where(
            tr.valid & (tr.birth_kf < 0), int(self.kf_seq[slot]), tr.birth_kf
        ).to(torch.int32))
        self.frames_since_kf = 0

        self.map, _, _ = local_mapping.local_ba(self.map, self.cam, self._ba_window(),
                                                refresh_desc=self.desc_refresh)
        self._cull_keyframes()
        # drop the links to landmarks that the BA or the culling removed
        lm = self.tracks.lm
        gone = (lm >= 0) & ~self.map.lm_valid[torch.clamp(lm, min=0).long()]
        self.tracks = self.tracks._replace(lm=torch.where(gone, -1, lm))
        self.T_last = self.map.kf_T[slot]
        _, obs_ok = self._lm_observations()
        counts = torch.stack([obs_ok.sum(), self.map.lm_valid.sum()]).cpu().numpy()
        self.n_inliers_ref = int(counts[0])
        self.stats["kf"] = self.n_kf
        self.stats["lm"] = int(counts[1])

    # -------------------------------------------------------------- recovery

    def _lost_tracks(self, img: torch.Tensor, ts: float, n_inl: int):
        """Track-loss recovery: keep the finished keyframe chain in the
        atlas and start a fresh disconnected segment (fusion stitches the
        chains at output time)."""
        self.stats["lost"] += 1
        self.lost_frames += 1
        if self.lost_frames <= self.lost_grace:
            self.state = slam_system.RECENTLY_LOST
            self._log_pose(ts, None)
            return {"state": self.state, "n_inliers": n_inl}
        self._freeze_trajectory()
        if self.n_kf < 5:
            self.atlas.reset_active()
        else:
            self.atlas.create_new_map()
        self.state = slam_system.NOT_INITIALIZED
        self.n_kf = 0
        self.lost_frames = 0
        self.T_last = self._eye4()
        self.velocity = self._eye4()
        self.n_inliers_ref = 0
        self._reset_init_ref(img, ts)
        return {"state": self.state, "n_inliers": n_inl, "new_map": True}


class EventSlamContinuous:
    """Event-only SLAM in continuous-tracking mode (EvAsynchTrackerU,
    selected by ``Event.contTracking``): the per-chunk L1 builder and the
    continuous L2 tracker. Runs on ``device``: the card when it is None."""

    def __init__(self, cam_params, cfg: Optional[ev_builder.BuilderConfig] = None,
                 n_tracks: int = 256, seed: int = 0, device=None, **tracker_kw):
        self.cfg = cfg or ev_builder.BuilderConfig()
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params, device=device)
        self.device = self.builder.device
        self.l2 = ContinuousEventTracker(
            cam_params, img_w=self.cfg.img_w, img_h=self.cfg.img_h,
            n_tracks=n_tracks, seed=seed, device=self.device, **tracker_kw,
        )
        self._T_prev_mci: Optional[torch.Tensor] = None

    def track_events(self, events) -> list[dict]:
        """Push a raw (n,4) [t, x, y, p] event chunk and run every buffered
        chunk through L1 and L2. Returns the L2 result of every MCI."""
        self.builder.feed(events)
        out = []
        while (pi := self.builder.step()) is not None:
            full = pi.reconst_stat == 1
            res = self.l2.process_event_image(pi.img * 255.0, pi.ts, full=full)
            if not full:
                continue
            out.append(dict(res, ts=pi.ts, mci_kind=pi.best_kind))
            if self.l2.state == slam_system.OK:
                # the PoseDepthInfo feedback stays on the device
                T_cur = self.l2.T_last
                if self._T_prev_mci is not None:
                    self.builder.set_pose_prior(
                        self._T_prev_mci, T_cur, self._median_scene_depth(T_cur))
                self._T_prev_mci = T_cur
        return out

    def _median_scene_depth(self, Tcw: torch.Tensor) -> torch.Tensor:
        """KeyFrame::ComputeSceneMedianDepth over the event map, as a device
        scalar."""
        m = self.l2.map
        return map_state.median_scene_depth(m.lm_pos, m.lm_valid, Tcw)

    def trajectory_twc(self):
        return self.l2.trajectory_twc()

    @property
    def stats(self):
        s = dict(self.builder.stats)
        s.update({f"l2_{k}": v for k, v in self.l2.stats.items()})
        return s
