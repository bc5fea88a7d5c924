"""Monocular SLAM system facade: host orchestration over tensor steps.

PyTorch port of the synchronous path of ``eorb_slam_tpu/slam/system.py``
(reference System + the Tracking state machine + the LocalMapping thread):
the host keeps small Python/numpy state (mode, keyframe order, cursors,
trajectory log) and every compute step — extraction, init matching,
two-view reconstruction, tracking, triangulation, local BA — runs on the
system's device (the card unless ``device`` says otherwise). One (2,) read per frame carries the tracking
decision; a mapping step's stats and the keyframe-redundancy ranking travel
to the host behind pinned non-blocking copies and are read at the next
keyframe.

With ``pipelined=True`` (what EventSlam and the MONOCULAR app build, as the
reference does) the tracking decision trails one frame: the frame's pose is
taken as tracked, its (2,) flags go to the host in the background, and the
next frame resolves them; a frame that did not track rolls the speculation
back and is replayed synchronously.

With ``loop_words`` (a vocabulary) place recognition runs inline at every
keyframe: the loop closer's BoW database, loop detection and correction
(slam/loop_closing.py), the BoW keyframe-database relocalization, and the
cross-map merge of a stored Atlas map (``_try_map_merge``). Frames with
metric depth (``FrameInput.depth``: stereo, RGB-D) found landmarks from it
at every keyframe (slam/rgbd_stereo.py).

``MixedMonoSlam`` runs the same pipeline over mixed ORB + AKAZE features
(``Features.mode: 2``).

States: NOT_INITIALIZED -> OK -> (RECENTLY_LOST -> LOST handling).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch._host import HostCopy, resolve_device, to_device
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie, sim3_solver, twoview
from eorb_slam_tpu_torch.ops import frontend, matching
from eorb_slam_tpu_torch.slam import atlas as atlas_mod
from eorb_slam_tpu_torch.slam import local_mapping, loop_closing, map_state
from eorb_slam_tpu_torch.slam import relocalization, tracking
from eorb_slam_tpu_torch.utils.logging import every_n, get_logger

NOT_INITIALIZED = 0
OK = 1
LOST = 2
RECENTLY_LOST = 3


@dataclasses.dataclass
class FrameInput:
    """Pre-extracted features for one frame (undistorted coords)."""

    ts: float
    xy_ud: torch.Tensor       # (N,2)
    octave: torch.Tensor      # (N,)
    angle: torch.Tensor       # (N,)
    desc_pm1: torch.Tensor    # (N,256) int8
    valid: torch.Tensor       # (N,)
    # per-feature metric depth (stereo match / RGB-D lookup); <=0 or
    # non-finite = unknown. None for monocular frames (Frame::mvDepth)
    depth: Optional[torch.Tensor] = None


class MonoSlam:
    """Monocular ORB-SLAM-class pipeline over fixed-capacity map tensors."""

    def __init__(
        self,
        cam_params,
        img_w: int = 752,
        img_h: int = 480,
        K: int = 32,
        M: int = 4096,
        N: int = 512,
        P: int = 8,
        local_window: int = 5,
        min_init_matches: int = 80,
        min_init_triangulated: Optional[int] = None,
        min_track_inliers: int = 15,
        kf_inlier_ratio: float = 0.7,
        max_frames_between_kf: int = 10,
        seed: int = 0,
        loop_words=None,
        loop_min_gap: int = 8,
        pipelined: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cam = torch.as_tensor(cam_params, dtype=torch.float32).to(self.device)
        self.img_w, self.img_h = img_w, img_h
        self.atlas = atlas_mod.Atlas(K=K, M=M, N=N, P=P, device=self.device)
        self.state = NOT_INITIALIZED
        # keyframe lifecycle (KeyFrameCulling + slot reuse): the active
        # keyframes are an ordered list of slots (temporal order); capacity
        # K is a window, not a run-length limit
        self._kf_order: list[int] = []
        # per-slot keyframe sequence id (monotone over the run; -1 = free):
        # slots are reused after culling, so slot indices do not order in
        # time (the continuous tracker's track births compare these)
        self.kf_seq = np.full(K, -1, np.int64)
        self._kf_seq_next = 0        # keyframes ever declared (monotone)
        self.last_kf_slot = -1
        self.kf_culled = 0
        self.cull_redundancy = 0.9   # >=90% of obs seen in >=3 other KFs
        self.kf_protect_recent = 3   # never cull the newest KFs
        self.cull_enabled = True     # periodic redundancy culling
        # fusion and the descriptor refresh only run at >= 320 px: on the
        # coarse features of small event images they merge distinct
        # landmarks and let the medoid hop between unstable observations
        self.fuse_enabled = img_w >= 320
        self.desc_refresh = img_w >= 320
        self.local_window = local_window
        self.min_init_matches = min_init_matches
        self.min_init_triangulated = (
            min_init_triangulated
            if min_init_triangulated is not None
            else max(50, min_init_matches // 2)
        )
        self.min_track_inliers = min_track_inliers
        self.kf_inlier_ratio = kf_inlier_ratio
        self.max_frames_between_kf = max_frames_between_kf
        self.generator = torch.Generator(self.device).manual_seed(seed)

        self._init_frame: Optional[FrameInput] = None
        self.T_last = self._eye4()
        self.velocity = self._eye4()  # T_curr @ inv(T_last)
        self.frames_since_kf = 0
        self.n_inliers_ref = 0
        self.trajectory: list = []    # (ts, T_rel or None, ref slot)
        self.stats = {"kf": 0, "lm": 0, "frames": 0, "lost": 0}
        self.last_frame: Optional[FrameInput] = None
        self.last_track = None
        # pipelined tracking: the frame in flight is (frame, result, its
        # flags' HostCopy, the (T_last, velocity) it was predicted from)
        self.pipelined = pipelined
        self._pipe = None
        # failure recovery (reference RECENTLY_LOST grace + CreateMapInAtlas)
        self.lost_frames = 0
        self.lost_grace = 5
        # maps smaller than this are RESET on irrecoverable loss instead of
        # stored in the Atlas
        self.min_kf_store = 10
        self._traj_frozen: list = []
        self._last_kf_ts: Optional[float] = None  # host cache, no device read
        # inline place recognition (the reference's LoopClosing thread),
        # gated by a minimum number of active keyframes; loop welds and
        # Atlas merges are counted (the speculation reads both)
        self.loop_closer = None
        self.loop_min_gap = loop_min_gap
        if loop_words is not None:
            self.loop_closer = loop_closing.LoopCloser(
                self.cam, loop_words, Kmax=K, sparse_words_per_kf=N,
                img_w=img_w, img_h=img_h,
                # small sensors carry fewer trackable features per frame:
                # the projection-verify quorum scales with N, floor 20
                proj_verify_min=max(20, min(40, N // 12)), device=self.device,
            )
        # BoW databases of stored (lost) maps, keyed by atlas index: the
        # retrieval side of cross-map merging
        self._stored_dbs: dict = {}
        self.loops_closed = 0
        self.map_merges = 0
        # handoff to a paired event tracker (EvImageSlam): on a loop
        # correction the pre-correction keyframe poses, the LoopInfo and the
        # slots' validity and timestamps at correction time are stashed for
        # the event map to follow the weld. Only when a consumer opted in
        # (loop_correction_consumer = True), so that a standalone MonoSlam
        # holds no copy of the pre-correction poses.
        self.last_loop_correction = None
        self.loop_correction_consumer = False
        # the mapping step's stats and the next culling pass's redundancy
        # ranking travel to the host in the background (HostCopy) and are
        # read at the next keyframe
        self._pending_map_stats: Optional[HostCopy] = None
        self._pending_redundancy: Optional[HostCopy] = None

    def _eye4(self) -> torch.Tensor:
        return torch.eye(4, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- map/atlas

    @property
    def map(self) -> map_state.MapState:
        return self.atlas.current

    @map.setter
    def map(self, m: map_state.MapState) -> None:
        self.atlas.current = m

    # -------------------------------------------------- keyframe lifecycle

    @property
    def n_kf(self) -> int:
        return len(self._kf_order)

    @n_kf.setter
    def n_kf(self, v: int) -> None:
        """Assigning n_kf = v declares slots 0..v-1 active in temporal order
        (the init paths, which always build into a fresh map)."""
        self._kf_order = list(range(v))
        self._renumber_kf_seq()
        self.last_kf_slot = self._kf_order[-1] if self._kf_order else -1

    def _renumber_kf_seq(self) -> None:
        """Fresh sequence ids for the active slots, in temporal order."""
        self.kf_seq[:] = -1
        for s in self._kf_order:
            self.kf_seq[s] = self._kf_seq_next
            self._kf_seq_next += 1

    def _kf_ref(self) -> int:
        return self._kf_order[-1] if self._kf_order else 0

    def _alloc_kf_slot(self) -> int:
        """Next free keyframe slot; culls a keyframe to make room when the
        map is at capacity."""
        active = set(self._kf_order)
        K = self.map.K
        if len(active) < K:
            for s in range(K):
                if s not in active:
                    return s
        slot = self._cull_keyframes(force=True)
        assert slot is not None and slot >= 0
        return slot

    def _cull_keyframes(self, force: bool = False):
        """KeyFrameCulling: remove the most redundant keyframe if
        >= `cull_redundancy` of its observations are covered by >= 3 other
        keyframes. With force=True a slot is ALWAYS freed (the oldest
        non-origin KF goes if none is redundant). Returns the slot or None."""
        order = self._kf_order
        if not force and not self.cull_enabled:
            return None
        if not force and len(order) <= max(self.kf_protect_recent + 1, 3):
            return None
        if self._pending_redundancy is not None:
            # prefetched at the last keyframe insertion; not cleared on read
            # (a periodic and a forced cull in one insertion share it)
            packed = self._pending_redundancy.numpy()
        else:
            frac, total = map_state.keyframe_redundancy(self.map)
            packed = torch.cat([frac, total.to(torch.float32)]).cpu().numpy()
        frac, total = packed[: self.map.K], packed[self.map.K:]
        protect = self.kf_protect_recent
        if force:
            protect = min(protect, max(len(order) - 2, 0))
        cand = order[1 : len(order) - protect]
        if not cand:
            if not force:
                return None
            cand = order[1:] or order[:1]
        best_frac, best_slot = max((frac[s], s) for s in cand)
        redundant = best_frac >= self.cull_redundancy or total[best_slot] == 0
        if not redundant:
            if not force:
                return None
            best_slot = cand[0]
        self._resolve_trajectory_refs(best_slot)
        self._on_cull_keyframe(best_slot)
        self.map = map_state.remove_keyframe(self.map, best_slot)
        self._pending_redundancy = None   # ranking is stale once a KF left
        order.remove(best_slot)
        self.kf_seq[best_slot] = -1
        self.kf_culled += 1
        self.stats["kf_culled"] = self.kf_culled
        self.stats["kf"] = self.n_kf
        if self.loop_closer is not None:
            self.loop_closer.remove_keyframe(best_slot)
        return best_slot

    def _on_cull_keyframe(self, slot: int) -> None:
        """Subclass hook fired before KF `slot` is erased (the inertial
        system merges the preintegration chain across the gap here)."""

    def _resolve_trajectory_refs(self, slot: int) -> None:
        """Trajectory entries are stored relative to a reference KF slot;
        before that slot is culled/reused, bake them into absolute poses
        (ref == -2 marks an absolute Tcw entry), on the device."""
        hit = [i for i, (_, T_rel, ref) in enumerate(self.trajectory)
               if ref == slot and T_rel is not None]
        if not hit:
            return
        baked = (torch.stack([self._dev(self.trajectory[i][1]) for i in hit])
                 @ self.map.kf_T[slot])
        for j, i in enumerate(hit):
            self.trajectory[i] = (self.trajectory[i][0], baked[j], -2)

    def _dev(self, x) -> torch.Tensor:
        # non_blocking: a host array is staged at once, the device stream
        # is not drained for it
        return torch.as_tensor(x, dtype=torch.float32).to(self.device,
                                                          non_blocking=True)

    # ---------------------------------------------------------------- input

    def process_image(self, img: torch.Tensor, ts: float,
                      max_kp: Optional[int] = None):
        if max_kp is None:
            max_kp = self.map.N  # frame capacity == extraction budget
        if self.state == OK and type(self)._track is MonoSlam._track:
            # fused path: extraction + prediction + tracking in one call
            ref = self._kf_ref()
            res, feats, xy_ud, flags, vel_new, T_rel = tracking.track_image_frame(
                img, self.cam, self.map, self.velocity, self.T_last,
                self.map.kf_T[ref], max_kp=max_kp,
                img_w=self.img_w, img_h=self.img_h,
            )
            f = FrameInput(ts, xy_ud, feats.octave, feats.angle,
                           feats.desc_pm1, feats.valid)
            self.stats["frames"] += 1
            if self.pipelined:
                return self._speculate(f, res, flags, vel_new, T_rel, ref)
            return self._track_post(f, res, flags, fused=(vel_new, T_rel, ref))
        self.flush_pipeline()
        feats = frontend.extract(img, max_kp=max_kp)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        return self.process_features(
            FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        )

    # ------------------------------------------------- pipelined tracking

    def _speculate(self, f, res, flags, vel_new, T_rel, ref):
        """Advance the pose state for this frame WITHOUT reading its flags,
        then resolve the PREVIOUS frame's decisions: their copy to the host
        ran behind this frame's work, so the read does not stall it."""
        prev = self._pipe
        saved = (self.T_last, self.velocity)
        self.velocity = vel_new
        self.T_last = res.Tcw
        self.trajectory.append((f.ts, T_rel, ref))
        self._pipe = (f, res, HostCopy(flags), saved)
        out = {"state": self.state, "pipelined": True, "n_inliers": -1}
        if prev is not None:
            out = self._resolve_speculation(prev, successor=True)
        return out

    def flush_pipeline(self):
        """Resolve any in-flight speculation (call before reading the
        trajectory or the stats)."""
        if self._pipe is not None:
            prev, self._pipe = self._pipe, None
            return self._resolve_speculation(prev, successor=False)
        return None

    def _resolve_speculation(self, pend, successor: bool):
        f, res, flags, saved = pend
        n_inl, finite = (float(x) for x in flags.numpy())
        n_inl = int(n_inl)
        if n_inl >= self.min_track_inliers and finite:
            # prediction confirmed: commit the host-side bookkeeping
            self.last_frame = f
            self.last_track = res
            self.lost_frames = 0
            self.frames_since_kf += 1
            need_kf = (
                n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
                or self.frames_since_kf >= self.max_frames_between_kf
                or self._need_kf_extra(f)
            )
            out = {"state": self.state, "n_inliers": n_inl, "kf": False}
            if need_kf:
                T_spec, vel_spec = self.T_last, self.velocity
                welds0 = self.loops_closed + self.map_merges
                self._insert_keyframe(f, res, n_inl)
                corrected = (self.loops_closed + self.map_merges) != welds0
                if successor and not corrected:
                    # the KF's refined pose must not clobber the newer
                    # in-flight frame's speculated pose
                    self.T_last, self.velocity = T_spec, vel_spec
                elif successor and corrected:
                    # a loop/merge moved the map under the in-flight
                    # speculation: drop it and reprocess its frame
                    # synchronously against the corrected map
                    succ = self._pipe
                    self._pipe = None
                    if succ is not None:
                        if self.trajectory:
                            self.trajectory.pop()
                        self._track(succ[0])
                out.update(kf=True, n_lm=self.stats["lm"])
            return out
        # misprediction: this frame did NOT track. Unwind every speculative
        # trajectory entry at or after it, restore the pre-frame state and
        # run the synchronous recovery; a successor speculation was
        # predicted from the bad pose, so its frame is replayed too.
        for _ in range(1 + (1 if successor else 0)):
            if self.trajectory:
                self.trajectory.pop()
        succ_f = self._pipe[0] if (successor and self._pipe) else None
        self._pipe = None
        self.T_last, self.velocity = saved
        out = self._track(f)
        if succ_f is not None:
            out = self._track(succ_f)
        return out

    def process_features(self, f: FrameInput):
        self.stats["frames"] += 1
        if self.state == NOT_INITIALIZED:
            return self._try_initialize(f)
        return self._track(f)

    # ----------------------------------------------------------------- init

    def _try_initialize(self, f: FrameInput):
        if self._init_frame is None:
            self._init_frame = f
            return {"state": self.state, "n": 0}
        ref = self._init_frame

        m12, _ = tracking.match_for_initialization(
            ref.desc_pm1, ref.valid, ref.xy_ud,
            f.desc_pm1, f.valid, f.xy_ud,
        )
        matched = m12 >= 0
        n = int(matched.sum())
        if n < self.min_init_matches:
            # too few matches: slide the reference frame
            self._init_frame = f
            return {"state": self.state, "n": n}

        idx2 = torch.where(matched, m12, 0).long()
        res = twoview.reconstruct_two_views(
            self.cam, ref.xy_ud, f.xy_ud[idx2], matched, self.generator,
            min_triangulated=self.min_init_triangulated,
        )
        if not bool(res.success):
            return {"state": self.state, "n": n}

        # initial map: median-depth normalization (reference
        # CreateInitialMapMonocular scales by inverse median depth)
        good = res.is_triangulated.cpu().numpy()
        pts = res.pts3d.cpu().numpy()
        med_depth = float(np.median(pts[good, 2]))
        scale = 1.0 / max(med_depth, 1e-6)
        pts_s = self._dev(pts * scale)
        T2 = res.Tcw2.cpu().numpy().copy()
        T2[:3, 3] *= scale

        N = ref.xy_ud.shape[0]
        dev = self.device
        feat_ids = torch.arange(N, dtype=torch.int32, device=dev)
        no_lm = torch.full((N,), -1, dtype=torch.int32, device=dev)
        m = self.map
        m = map_state.insert_keyframe(
            m, 0, self._eye4(), ref.ts, ref.xy_ud, ref.octave,
            ref.angle, ref.desc_pm1, ref.valid, no_lm,
        )
        m = map_state.insert_keyframe(
            m, 1, self._dev(T2), f.ts, f.xy_ud, f.octave,
            f.angle, f.desc_pm1, f.valid, no_lm,
        )
        ok = res.is_triangulated & matched
        m, _ = map_state.alloc_landmarks(
            m, pts_s, ref.desc_pm1, ok, 0, feat_ids, 1, idx2,
        )
        self.map = m
        self.n_kf = 2

        # init BA: optimize KF1 + landmarks, KF0 fixed (gauge)
        kf_free = torch.zeros(self.map.K, dtype=torch.bool, device=dev)
        kf_free[1] = True
        self.map, _, _ = local_mapping.local_ba(
            self.map, self.cam, kf_free, iters=10,
            refresh_desc=self.desc_refresh,
        )
        # re-normalize scale after init BA (the monocular scale gauge is
        # free with a single fixed pose); every active KF translation scales
        lmv = self.map.lm_valid.cpu().numpy()
        depths = self.map.lm_pos.cpu().numpy()[lmv, 2]
        s2 = 1.0 / max(float(np.median(depths)), 1e-6)
        kf_T2 = self.map.kf_T.cpu().numpy().copy()
        kf_T2[:, :3, 3] *= s2
        self.map = self.map._replace(
            lm_pos=self.map.lm_pos * s2, kf_T=self._dev(kf_T2))

        self.state = OK
        self.T_last = self.map.kf_T[1]
        self.velocity = self._eye4()
        self.frames_since_kf = 0
        self.n_inliers_ref = int(ok.sum())
        self._last_kf_ts = f.ts
        self._log_pose(f.ts, self.T_last)
        self.stats["kf"] = 2
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.map, 0)
            self.loop_closer.add_keyframe(self.map, 1)
        self.stats["lm"] = int(self.map.lm_valid.sum())
        return {"state": self.state, "n": n, "n_pts": self.stats["lm"]}

    # ---------------------------------------------------------------- track

    def _track(self, f: FrameInput):
        res = tracking.track_frame(
            self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
            self.velocity @ self.T_last, img_w=self.img_w, img_h=self.img_h,
        )
        return self._track_post(f, res, tracking.track_flags(res))

    def _track_post(self, f: FrameInput, res, flags, fused=None):
        self.last_frame = f
        n_inl, finite = (float(x) for x in flags.cpu().numpy())
        n_inl = int(n_inl)

        if n_inl < self.min_track_inliers:
            # wider re-search around the last pose (the motion model may be
            # off; reference falls back to TrackReferenceKeyFrame)
            res = tracking.track_frame(
                self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
                self.T_last, img_w=self.img_w, img_h=self.img_h,
                search_radius=40.0, nn_ratio=0.95,
            )
            n_inl, finite = (float(x) for x in
                             tracking.track_flags(res).cpu().numpy())
            n_inl = int(n_inl)
            if n_inl < self.min_track_inliers:
                return self._handle_lost(f, n_inl)
            fused = None

        if not finite:
            # a degenerate GN solve must not poison T_last / the trajectory
            return self._handle_lost(f, 0)

        self.last_track = res
        self.lost_frames = 0
        self.state = OK
        Tcw = res.Tcw
        if fused is not None and fused[2] == self._kf_ref():
            self.velocity, T_rel, ref = fused
        else:
            ref = self._kf_ref()
            self.velocity = Tcw @ lie.se3_inv(self.T_last)
            T_rel = Tcw @ lie.se3_inv(self.map.kf_T[ref])
        self.T_last = Tcw
        self.frames_since_kf += 1
        # the trajectory entry stays on the device; readers pull in batch
        self.trajectory.append((f.ts, T_rel, ref))

        # keyframe policy (simplified NeedNewKeyFrame; capacity never gates
        # insertion — KeyFrameCulling frees slots)
        need_kf = (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
            or self._need_kf_extra(f)
        )
        out = {"state": self.state, "n_inliers": n_inl, "kf": False}
        if need_kf:
            self._insert_keyframe(f, res, n_inl)
            # n_lm lags one keyframe: the mapping stats are read at the next
            # drain so tracking never waits for the BA
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def _need_kf_extra(self, f) -> bool:
        """Extra sensor-specific KF triggers (the inertial system forces a
        KF on elapsed time)."""
        return False

    # ------------------------------------------------------------- recovery

    def _handle_lost(self, f: FrameInput, n_inl: int):
        """Graded recovery: RECENTLY_LOST attempts relocalization for a grace
        window, then the Atlas resets a tiny active map or stores it and
        starts fresh (CreateMapInAtlas)."""
        self._drain_mapping()
        self.stats["lost"] += 1
        self.lost_frames += 1

        T_rel, n_rel = self._relocalize(f)
        if T_rel is not None:
            self.state = OK
            self.lost_frames = 0
            self.velocity = self._eye4()
            self.T_last = T_rel
            self._log_pose(f.ts, T_rel)
            return {"state": self.state, "n_inliers": n_rel, "reloc": True}

        if self.lost_frames <= self.lost_grace:
            self.state = RECENTLY_LOST
            # retry from the LAST pose, not an extrapolation of it
            self.velocity = self._eye4()
            self._log_pose(f.ts, None)
            return {"state": self.state, "n_inliers": n_inl}

        # irrecoverable: multi-map recovery
        self._freeze_trajectory()
        if self.n_kf < self.min_kf_store:
            self.atlas.reset_active()
        else:
            old_active = self.atlas.active
            self.atlas.create_new_map()
            if self.loop_closer is not None:
                # stash the lost map's BoW index for cross-map merging
                self._stored_dbs[old_active] = self.loop_closer.db
                self.loop_closer.db = self.loop_closer.fresh_db()
        self.state = NOT_INITIALIZED
        self.n_kf = 0
        self.lost_frames = 0
        self._init_frame = f
        self.T_last = self._eye4()
        self.velocity = self._eye4()
        self.n_inliers_ref = 0
        return {"state": self.state, "n_inliers": n_inl, "new_map": True}

    def _relocalize(self, f: FrameInput):
        """Relocalization: BoW keyframe-database candidates + PnP RANSAC
        per candidate when a vocabulary is loaded (KeyFrameDatabase::
        DetectRelocalizationCandidates), else global landmark matching +
        PnP RANSAC (the vocabulary-less fallback)."""
        if self.loop_closer is not None and len(self._kf_order) >= 2:
            T, n = self._relocalize_kfdb(f)
            if T is not None:
                return T, n
        m = self.map
        if int(m.lm_valid.sum()) < 30:
            return None, 0
        feat_lm, _ = matching.match_nnratio(
            f.desc_pm1, f.valid, m.lm_desc_pm1, m.lm_valid,
            pair_mask=None, max_dist=matching.TH_LOW, nn_ratio=0.75,
            mutual=True,
        )
        matched = feat_lm >= 0
        min_inl = max(self.min_track_inliers, 12)
        if int(matched.sum()) < min_inl:
            return None, 0
        pts = m.lm_pos[torch.where(matched, feat_lm, 0).long()]
        res = relocalization.pnp_ransac(
            self.cam, pts, f.xy_ud, matched, self.generator,
            min_inliers=min_inl,
        )
        if not bool(res.ok):
            return None, int(res.n_inliers)
        return res.Tcw, int(res.n_inliers)

    def _relocalize_kfdb(self, f: FrameInput):
        """Query the loop closer's BoW database with the lost frame, then
        PnP against each candidate keyframe's landmarks (best first)."""
        m = self.map
        lc = self.loop_closer
        bq = lc.frame_query(f.desc_pm1, f.valid)
        scores, idx = lc.query_db(bq, torch.zeros(m.K, dtype=torch.bool,
                                                  device=self.device), top_k=3)
        packed = torch.cat([scores, idx.to(scores.dtype)]).cpu().numpy()
        scores, idx = packed[:3], packed[3:].astype(np.int64)
        min_inl = max(self.min_track_inliers, 12)
        for rank in range(len(idx)):
            if not np.isfinite(scores[rank]) or scores[rank] <= 0:
                continue
            cand = int(idx[rank])
            vc = m.kf_feat_valid[cand] & (m.kf_feat_lm[cand] >= 0)
            j, _ = matching.match_nnratio(
                f.desc_pm1, f.valid, m.kf_desc_pm1[cand], vc,
                max_dist=matching.TH_LOW, nn_ratio=0.75, mutual=True,
            )
            matched = f.valid & (j >= 0)
            if int(matched.sum()) < min_inl:
                continue
            lm = m.kf_feat_lm[cand][torch.clamp(j, min=0).long()]
            pts = m.lm_pos[torch.clamp(lm, min=0).long()]
            res = relocalization.pnp_ransac(
                self.cam, pts, f.xy_ud, matched, self.generator, min_inliers=min_inl,
            )
            if bool(res.ok):
                return res.Tcw, int(res.n_inliers)
        return None, 0

    # --------------------------------------------------------- trajectory

    def _pull_trajectory_rows(self) -> dict:
        """Every device-resident trajectory row in ONE transfer."""
        ent = self.trajectory
        idx = [i for i, (_, T_rel, _) in enumerate(ent) if T_rel is not None]
        if not idx:
            return {}
        arr = torch.stack([self._dev(ent[i][1]) for i in idx]).cpu().numpy()
        return dict(zip(idx, arr))

    def _freeze_trajectory(self):
        """Resolve all relative trajectory entries against the CURRENT map's
        keyframes before switching maps (they reference its slots)."""
        kf_T = self.map.kf_T.cpu().numpy()
        rows = self._pull_trajectory_rows()
        for i, (ts, T_rel, ref) in enumerate(self.trajectory):
            if T_rel is not None:
                Tcw = rows[i] if ref == -2 else rows[i] @ kf_T[ref]
                self._traj_frozen.append((ts, np.linalg.inv(Tcw)))
        self.trajectory = []

    def _ba_window(self) -> torch.Tensor:
        """(K,) bool mask of poses the local BA may move: the newest
        `local_window` keyframes, minus at least TWO older keyframes kept
        fixed so the monocular scale gauge is pinned."""
        order = self._kf_order
        kf_free = np.zeros(self.map.K, bool)
        for s in order[max(2, len(order) - self.local_window):]:
            kf_free[s] = True
        return torch.from_numpy(kf_free).to(self.device, non_blocking=True)

    def _mapping_slots(self, slot: int, tri, fuse_nb, ts: float):
        """The keyframe mapping step's slot () and its triangulation (4,)
        and fusion (3,) partners as int64, and the timestamp () in
        kf_ts's dtype, on the device in one copy that does not wait for the
        device queue (the reference passes them as device arrays)."""
        ts_dtype = torch.empty(0, dtype=self.map.kf_ts.dtype).numpy().dtype
        ints = np.asarray([slot, *tri, *fuse_nb], np.int64)
        t = to_device(np.concatenate([ints.view(np.uint8),
                                      np.asarray([ts], ts_dtype).view(np.uint8)]),
                      self.device)
        n = ints.nbytes
        idx = t[:n].view(torch.int64)
        return idx[0], idx[1:1 + len(tri)], idx[1 + len(tri):], \
            t[n:].view(self.map.kf_ts.dtype)[0]

    # -------------------------------------------------------------- mapping

    def _drain_mapping(self):
        """The previous mapping step's deferred host work: read its stats
        and run the postponed KeyFrameCulling pass."""
        if self._pending_map_stats is None:
            return
        st = self._pending_map_stats.numpy()
        self._pending_map_stats = None
        self.stats["lm"] = int(st[0])
        if self.fuse_enabled:
            self.stats["fused"] = self.stats.get("fused", 0) + int(st[1])
        self.stats["ba"] = {
            "opt_kf": int(st[4]), "fixed_kf": int(st[5]),
            "edges": int(st[6]), "cost0": float(st[2]), "cost": float(st[3]),
        }
        log = get_logger("eorb.mapping")
        if log.isEnabledFor(20) and every_n("lba", 5):
            log.info("LBA kf=%d opt=%d fixed=%d edges=%d cost %.1f->%.1f lm=%d",
                     self.n_kf, int(st[4]), int(st[5]), int(st[6]),
                     float(st[2]), float(st[3]), int(st[0]))
        self._cull_keyframes()

    def _insert_keyframe(self, f: FrameInput, res: tracking.TrackResult,
                         n_inl: Optional[int] = None):
        self._last_kf_ts = f.ts
        self._drain_mapping()
        slot = self._alloc_kf_slot()
        order = self._kf_order
        # triangulation partners: the 4 most recent keyframes, padded with
        # `slot` (self-pairs are no-ops)
        tri = [order[-k] if k <= len(order) else slot for k in range(1, 5)]
        fuse_nb = list(order[-4:-1]) if self.fuse_enabled else []
        fuse_nb += [slot] * (3 - len(fuse_nb))

        self._kf_order.append(slot)
        self.kf_seq[slot] = self._kf_seq_next
        self._kf_seq_next += 1
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        # an n_inl from flags already on the host saves a device read
        self.n_inliers_ref = int(res.n_inliers) if n_inl is None else int(n_inl)

        slot_t, tri_t, fuse_t, ts_t = self._mapping_slots(slot, tri, fuse_nb, f.ts)
        self.last_kf_slot_t = slot_t
        self.map, T_new, stats = local_mapping.keyframe_mapping_step(
            self.map, self.cam, slot_t, res.Tcw, ts_t, f.xy_ud, f.octave,
            f.angle, f.desc_pm1, f.valid, res.feat_lm, tri_t, fuse_t,
            self._ba_window(), do_fuse=self.fuse_enabled,
            refresh_desc=self.desc_refresh,
        )
        # stereo / RGB-D: features with metric depth and no landmark yet
        # found depth landmarks, then the window is adjusted again
        if f.depth is not None:
            self.map, _ = local_mapping.create_depth_landmarks(
                self.map, self.cam, slot, f.depth)
            self.map, _, _ = local_mapping.local_ba(self.map, self.cam,
                                                    self._ba_window())
        self.T_last = T_new
        self.stats["kf"] = self.n_kf
        # mapping steps that ran duplicate fusion / the descriptor refresh
        self.stats["fuse_steps"] = (
            self.stats.get("fuse_steps", 0) + int(self.fuse_enabled))
        self.stats["refresh_steps"] = (
            self.stats.get("refresh_steps", 0) + int(self.desc_refresh))
        # stats and the next cull's redundancy ranking go to the host in the
        # background; the next keyframe reads them
        self._pending_map_stats = HostCopy(stats)
        frac, total = map_state.keyframe_redundancy(self.map)
        self._pending_redundancy = HostCopy(
            torch.cat([frac, total.to(torch.float32)]))
        if self.loop_closer is None:
            return
        # place recognition + loop correction on every new keyframe (the
        # reference's LoopClosing::Run), on a drained, culled map
        self._drain_mapping()
        self.loop_closer.add_keyframe(self.map, slot)
        if len(self._kf_order) >= self.loop_min_gap:
            T_before = self.map.kf_T
            self.map, info = self.loop_closer.detect_and_correct(
                self.map, slot, order=self._kf_order)
            if info.detected:
                self.loops_closed += 1
                self.T_last = self.map.kf_T[slot]
                self.velocity = self._eye4()
                self.stats["loops"] = self.loops_closed
                if self.loop_correction_consumer:
                    # validity and timestamps go WITH the poses: a map merge
                    # in the same insertion can validate slots whose
                    # T_before rows are stale, and the consumer anchors only
                    # on slots valid at correction time
                    self.last_loop_correction = (
                        T_before, info, self.map.kf_valid, self.map.kf_ts)
        if self._stored_dbs and self.n_kf >= 4:
            self._try_map_merge(slot)

    def _try_map_merge(self, q: int):
        """Cross-map common-region detection + Sim3 weld (LoopClosing::
        MergeLocal): query the stored maps' BoW indexes with the new KF; on
        a hit, Sim3-RANSAC the two KFs' landmark pairs, verify by
        projection, and merge the stored map into the active one."""
        m = self.map
        lc = self.loop_closer
        bq = lc.frame_query(m.kf_desc_pm1[q], m.kf_feat_valid[q])
        no_kf = torch.zeros(m.K, dtype=torch.bool, device=self.device)
        for idx in list(self._stored_dbs):
            scores, cand_idx = lc.query_db(bq, no_kf, top_k=1, db=self._stored_dbs[idx])
            score, cand = (float(x) for x in
                           torch.cat([scores, cand_idx.to(scores.dtype)]).cpu())
            if not np.isfinite(score) or score <= 0:
                continue
            cand = int(cand)
            sto = self.atlas.maps[idx]
            vq = m.kf_feat_valid[q] & (m.kf_feat_lm[q] >= 0)
            vc = sto.kf_feat_valid[cand] & (sto.kf_feat_lm[cand] >= 0)
            j, _ = matching.match_nnratio(m.kf_desc_pm1[q], vq,
                                          sto.kf_desc_pm1[cand], vc, nn_ratio=0.75)
            valid = vq & (j >= 0)
            if int(valid.sum()) < 15:
                continue
            lm_q = torch.clamp(m.kf_feat_lm[q], min=0).long()
            lm_c = torch.clamp(sto.kf_feat_lm[cand][torch.clamp(j, min=0).long()],
                               min=0).long()
            p1 = lie.se3_apply(m.kf_T[q], m.lm_pos[lm_q])
            p2 = lie.se3_apply(sto.kf_T[cand], sto.lm_pos[lm_c])
            res = sim3_solver.sim3_ransac(
                p1, p2, valid, self.generator,
                px_threshold=torch.full((p1.shape[0],), 9.21, device=self.device),
                cam_params1=self.cam, cam_params2=self.cam,
            )
            if int(res.n_inliers) < 20:
                continue
            # projection verification through the measured Sim3 (the same
            # second gate as in-map loops)
            n_proj = int(loop_closing._projection_verify(
                self.cam, sto.kf_T[cand], m.kf_T[q],
                sto.kf_feat_lm[cand], sto.kf_feat_valid[cand], sto.kf_desc_pm1[cand],
                sto.lm_pos, sto.lm_desc_pm1,
                m.kf_xy[q], m.kf_desc_pm1[q], m.kf_feat_valid[q],
                res.R, res.t, res.s, float(self.img_w), float(self.img_h),
            ))
            if n_proj < lc.proj_verify_min:
                continue
            # res maps query cam -> candidate cam; stored world -> active
            # world is Twq o S^-1 o T_cand
            Rq, tq = m.kf_T[q][:3, :3], m.kf_T[q][:3, 3]
            one = torch.ones((), dtype=torch.float32, device=self.device)
            Tc = sto.kf_T[cand]
            S_total = lie.sim3_mul(Rq.T, -Rq.T @ tq, one, *lie.sim3_mul(
                *lie.sim3_inv(res.R, res.t, res.s), Tc[:3, :3], Tc[:3, 3], one))
            self.map = self.atlas.merge(idx, *S_total)
            # merged KFs landed in arbitrary free slots: rebuild the
            # temporal order from timestamps
            kv = self.map.kf_valid.cpu().numpy()
            ts_all = self.map.kf_ts.cpu().numpy()
            slots = np.flatnonzero(kv)
            self._kf_order = [int(s) for s in slots[np.argsort(ts_all[slots])]]
            self._renumber_kf_seq()
            self.last_kf_slot = self._kf_order[-1] if self._kf_order else -1
            self.stats["kf"] = self.n_kf
            # atlas indices shifted after the deletion; re-key the stashes
            del self._stored_dbs[idx]
            self._stored_dbs = {(i - 1 if i > idx else i): d
                                for i, d in self._stored_dbs.items()}
            self.map_merges += 1
            self.stats["map_merges"] = self.map_merges
            return

    # ------------------------------------------------------------- output
    #
    # Each frame stores its pose RELATIVE to the current reference keyframe
    # (reference FrameInfo + SaveTrajectoryEuRoC); absolute poses are
    # recomposed at output time from the keyframe's latest pose, so BA
    # refinements correct the whole trajectory.

    def _log_pose(self, ts: float, Tcw):
        if Tcw is None:
            self.trajectory.append((ts, None, -1))
            return
        ref = self._kf_ref()
        T_rel = (Tcw @ lie.se3_inv(self.map.kf_T[ref])).cpu().numpy()
        self.trajectory.append((ts, T_rel, ref))

    def _rescale_trajectory(self, s: float, Ryw=None):
        """Apply a map world transform (gravity rotation ``Ryw`` + scale
        ``s``) to the stored trajectory entries, on the device.

        RELATIVE entries (ref >= 0) recompose against the transformed
        keyframe poses, so only their translation scales (T_rel' = Sim3(s)
        T_rel Sim3(s)^-1). ABSOLUTE entries (ref == -2, baked at keyframe
        culls) carry the full pose and need both factors: R' = R Ryw^T,
        t' = s t."""
        idx = [i for i, (_, T_rel, _) in enumerate(self.trajectory)
               if T_rel is not None]
        if not idx:
            return
        T = torch.stack([self._dev(self.trajectory[i][1]) for i in idx])
        t = T[:, :3, 3] * s
        R = T[:, :3, :3]
        if Ryw is not None:
            absolute = torch.tensor([self.trajectory[i][2] == -2 for i in idx]
                                    ).to(self.device, non_blocking=True)
            R = torch.where(absolute[:, None, None],
                            R @ self._dev(Ryw).transpose(0, 1), R)
        T = lie.se3(R, t)
        for j, i in enumerate(idx):
            ts, _, ref = self.trajectory[i]
            self.trajectory[i] = (ts, T[j], ref)

    def trajectory_twc(self):
        """[(ts, Twc 4x4)] for evaluation (camera-to-world). Entries from
        earlier Atlas maps were frozen at map-switch time; current-map
        entries recompose against the latest keyframe poses."""
        self.flush_pipeline()
        self._drain_mapping()
        kf_T = self.map.kf_T.cpu().numpy()
        rows = self._pull_trajectory_rows()
        out = list(self._traj_frozen)
        for i, (ts, T_rel, ref) in enumerate(self.trajectory):
            if T_rel is not None:
                Tcw = rows[i] if ref == -2 else rows[i] @ kf_T[ref]
                out.append((ts, np.linalg.inv(Tcw)))
        out.sort(key=lambda e: e[0])
        return out


class MixedMonoSlam(MonoSlam):
    """Monocular SLAM over mixed ORB + AKAZE features (the reference's
    ``Features.mode: 2`` MixedFrame pipeline, include/MixedFrame.h).

    Frame slots are channel-partitioned (the first ``orb_frac`` ORB, the
    rest AKAZE / MLDB-256); matching and BA downstream are channel-agnostic,
    because both descriptors share the 256-bit +-1 layout (see
    ops/frontend.extract_mixed). Every frame takes the synchronous path:
    the fused ORB tracking call and the speculation do not apply."""

    def __init__(self, cam_params, orb_frac: float = 0.5, **kw):
        super().__init__(cam_params, **kw)
        self.orb_frac = orb_frac
        self.last_channel: Optional[torch.Tensor] = None

    def process_image(self, img: torch.Tensor, ts: float,
                      max_kp: Optional[int] = None):
        if max_kp is None:
            max_kp = self.map.N
        feats, channel = frontend.extract_mixed(img, max_kp=max_kp,
                                                orb_frac=self.orb_frac)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        self.last_channel = channel
        return self.process_features(
            FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        )
