"""Monocular-inertial SLAM system (IMU_MONOCULAR mode).

PyTorch port of ``eorb_slam_tpu/slam/vi_system.py``: the monocular
orchestrator plus the reference's inertial machinery (PreintegrateIMU,
PredictStateIMU, the staged InitializeIMU of LocalMapping, IMU_Manager):

- per-frame preintegration windows merged into per-keyframe factors,
- IMU dead-reckoning as the motion model once initialized,
- one-shot inertial initialization (gravity dir, metric scale, biases,
  velocities) followed by gravity-aligning + rescaling the whole map,
- visual-inertial local BA (optim/vi_ba.py) after each keyframe.

Bias handling is first-order: preintegrations keep the bias they were
integrated at and are corrected through their bias Jacobians at use.

The per-frame step once the IMU is initialized (``_vi_frame_step``) is one
fused jitted dispatch in the JAX package, with the wide re-search under
``lax.cond``. Here both searches run as one batch of two settings and the
re-search is selected on the device (``tracking.track_frame_with_retry``),
so the step's one blocking read is its packed flags, and on the card the
step is one CUDA-graph replay (``vi_frame_step``). Its IMU window is padded
to a power-of-two bucket of at least 8 samples with the pad masked off, as
the JAX package pads it: the window's length is part of the graph's key,
and the bucket keeps the keys few. A masked sample integrates with dt = 0
and keeps the rotation, so a padded window gives the unpadded window's
bits.

Before the IMU init a frame's window is preintegrated and merged into the
keyframe window as one dispatch (``preintegrate_frame``, the window padded
the same way); the keyframe's inertial-state write (``write_kf_imu_state``)
and the inertial solves (``optim/inertial``) are graph runners too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch._host import to_device
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.ops import frontend
from eorb_slam_tpu_torch.optim import inertial, marginalize, schur_ba, vi_ba
from eorb_slam_tpu_torch.slam import map_state, tracking
from eorb_slam_tpu_torch.slam.system import OK, RECENTLY_LOST, FrameInput, MonoSlam


@dataclasses.dataclass
class ImuChunk:
    """IMU samples between the previous and current frame."""

    gyro: np.ndarray   # (S,3)
    acc: np.ndarray    # (S,3)
    dts: np.ndarray    # (S,)


def _stack_identity_pre(K: int, device) -> pre_mod.Preintegrated:
    return pre_mod.stack([pre_mod.identity_preintegrated(device=device)] * K)


def _write_kf_imu_state(pre_kf, kf_vel, kf_bg, kf_ba, slot, pre_window,
                        vel, bg, ba):
    """The per-KF inertial-state writes (copies; the inputs stay as they
    were). ``slot`` is an int or a 0-d int64 tensor (the graph's form,
    written with ``index_copy``: indexing by a 0-d tensor reads it on the
    host)."""
    pre = pre_mod.Preintegrated(*(map_state._set_row(f, slot, x)
                                  for f, x in zip(pre_kf, pre_window)))
    return (pre, *(map_state._set_row(t, slot, x)
                   for t, x in ((kf_vel, vel), (kf_bg, bg), (kf_ba, ba))))


# the reference's @jax.jit _write_kf_imu_state: one graph on the card, the
# slot a device tensor
write_kf_imu_state = _graphs.GraphRunner(_write_kf_imu_state)


def _imu_predict(T_last, vel, pre_last, bg, ba, Tbc):
    """PredictStateIMU: body-frame forward integration of the last
    inter-frame preintegration, returned as (T_pred, motion-model velocity,
    body velocity)."""
    Twb = pre_mod.Twb_from_Tcw(T_last, Tbc)
    R2, p2, v2 = pre_mod.predict_state(Twb[:3, :3], Twb[:3, 3], vel, pre_last, bg, ba)
    T_pred = pre_mod.Tcw_from_Twb(lie.se3(R2, p2), Tbc)
    return T_pred, T_pred @ lie.se3_inv(T_last), v2


def imu_bucket(S: int) -> int:
    """The padded length of an ``S``-sample IMU window: the least power of
    two >= ``S``, and at least 8 (the JAX package's buckets)."""
    cap = 8
    while cap < S:
        cap *= 2
    return cap


def _chunk_tensors(imu: ImuChunk, device, pad: bool = False):
    """(gyro, acc, dts, valid) on ``device``, in one host-to-device copy
    that does not wait for the device queue; with ``pad``, padded to
    :func:`imu_bucket` samples, the pad masked off."""
    S = int(imu.gyro.shape[0])
    packed = np.zeros((imu_bucket(S) if pad else S, 8), np.float32)
    packed[:S, 0:3] = np.asarray(imu.gyro, np.float32).reshape(S, 3)
    packed[:S, 3:6] = np.asarray(imu.acc, np.float32).reshape(S, 3)
    packed[:S, 6] = np.asarray(imu.dts, np.float32).reshape(S)
    packed[:S, 7] = 1.0
    t = to_device(packed, device)
    return t[:, 0:3], t[:, 3:6], t[:, 6], t[:, 7] > 0


def _preintegrate_frame(gyro, acc, dts, imu_ok, pre_since_kf: pre_mod.Preintegrated,
                        calib: pre_mod.ImuCalib):
    """A frame's IMU window preintegrated at zero bias and the keyframe
    window extended by it: (pre_frame, pre_since_kf_new). Before the IMU
    init one replay (``preintegrate_frame``), after it inside the inertial
    frame step."""
    z3 = torch.zeros(3, dtype=torch.float32, device=gyro.device)
    pre = pre_mod.integrate(gyro, acc, dts, imu_ok, z3, z3, calib)
    return pre, pre_mod.merge(pre_since_kf, pre)


# the reference's integrate (one lax.scan) and merge as one dispatch: on
# the card one graph per IMU bucket (the window padded as the inertial
# frame step pads it)
preintegrate_frame = _graphs.GraphRunner(_preintegrate_frame)


def _vi_frame_step(
    img: torch.Tensor,           # (H,W) uint8/float
    cam_params: torch.Tensor,
    m,
    gyro, acc, dts, imu_ok,      # the IMU window since the last frame (padded)
    T_last: torch.Tensor,        # (4,4) last frame pose
    vel, bg, ba,
    pre_since_kf: pre_mod.Preintegrated,   # KF -> last frame window
    T_kf: torch.Tensor, vel_kf: torch.Tensor,
    prior: Optional[marginalize.PoseImuPrior],
    ref_T: torch.Tensor,         # (4,4) trajectory reference KF pose
    calib: pre_mod.ImuCalib,
    min_inl_retry: int,          # wide re-search threshold
    max_kp: int = 512, img_w: int = 752, img_h: int = 480,
):
    """The inertial per-frame step: preintegrate the inter-frame IMU window
    -> PredictStateIMU -> ORB extraction -> projection matching (with the
    wide re-search when too few inliers) -> motion-only visual-inertial
    optimization -> packed host flags.

    ``prior`` selects the reference's per-frame optimizer alternation: None
    = PoseInertialOptimizationLastKeyFrame against (T_kf, vel_kf) over the
    accumulated KF->frame window; a PoseImuPrior =
    PoseInertialOptimizationLastFrame against the marginal prior carried
    from the previous frame over the frame->frame window. Both emit the next
    frame's prior.

    Returns (res, feats, xy_ud, flags, vel_mm, T_rel, T_pred, pre_frame,
    pre_since_kf_new, vel_out, bg_out, ba_out, next_prior)."""
    # 1. preintegrate the inter-frame window (zero-bias integration; the
    # bias enters through the stored Jacobians at every use site)
    pre, pre_since2 = _preintegrate_frame(gyro, acc, dts, imu_ok, pre_since_kf, calib)

    # 2. PredictStateIMU
    Twb = pre_mod.Twb_from_Tcw(T_last, calib.Tbc)
    R2, p2, v2 = pre_mod.predict_state(Twb[:3, :3], Twb[:3, 3], vel, pre, bg, ba)
    T_pred = pre_mod.Tcw_from_Twb(lie.se3(R2, p2), calib.Tbc)

    # 3. extraction + projection tracking, with the wide re-search chosen
    # on the device where the first search keeps too few inliers
    feats = frontend.extract(img, max_kp=max_kp)
    xy_ud = cam_mod.undistort_points(cam_params, feats.xy)
    res = tracking.track_frame_with_retry(
        m, cam_params, xy_ud, feats.octave, feats.desc_pm1, feats.valid,
        T_pred, min_inl_retry, img_w=img_w, img_h=img_h,
    )

    # 4. motion-only VI optimization
    matched = res.feat_lm >= 0
    pts_w = m.lm_pos[torch.where(matched, res.feat_lm, 0).long()]
    inv_sigma = frontend.inv_sigma(feats.octave)
    if prior is not None:
        Tcw, vel_o, bg_o, ba_o, inlier, n_vi, next_prior = \
            marginalize.pose_inertial_optimization_last_frame(
                cam_params, res.Tcw, v2, bg, ba, pts_w, xy_ud, inv_sigma,
                matched, prior, pre, calib.Tbc,
            )
    else:
        Tcw, vel_o, bg_o, ba_o, inlier, n_vi, H = vi_ba.pose_inertial_optimization(
            cam_params, res.Tcw, v2, bg, ba, pts_w, xy_ud, inv_sigma, matched,
            T_kf, vel_kf, pre_since2, calib.Tbc, return_H=True,
        )
        next_prior = marginalize.PoseImuPrior(Tcw, vel_o, bg_o, ba_o, H)

    feat_lm = torch.where(inlier, res.feat_lm, -1)
    res = res._replace(Tcw=Tcw, feat_lm=feat_lm, inlier=inlier, n_inliers=n_vi)
    flags = torch.stack([n_vi.to(torch.float32),
                         torch.isfinite(Tcw).all().to(torch.float32)])
    vel_mm = Tcw @ lie.se3_inv(T_last)
    T_rel = Tcw @ lie.se3_inv(ref_T)
    return (res, feats, xy_ud, flags, vel_mm, T_rel, T_pred,
            pre, pre_since2, vel_o, bg_o, ba_o, next_prior)


# the tracked inertial frame as one dispatch, as the reference's jit with
# static max_kp, img_w, img_h and use_prior: on the card one CUDA graph per
# key. ``prior`` None or a PoseImuPrior is the input structure (the
# reference's use_prior), so each IMU bucket has up to two keys
vi_frame_step = _graphs.GraphRunner(
    _vi_frame_step, static=("min_inl_retry", "max_kp", "img_w", "img_h"))


def _gravity_rotation(g_est: np.ndarray) -> np.ndarray:
    """Rotation (3,3) f32 taking the estimated gravity onto (0,0,-9.81)."""
    g_tgt = np.asarray([0.0, 0.0, -pre_mod.GRAVITY])
    v = np.cross(g_est, g_tgt)
    s_ang = np.linalg.norm(v) / (np.linalg.norm(g_est) * pre_mod.GRAVITY)
    c_ang = g_est @ g_tgt / (np.linalg.norm(g_est) * pre_mod.GRAVITY)
    if s_ang > 1e-8:
        axis = v / np.linalg.norm(v)
        return lie.so3_exp(torch.tensor(axis * np.arctan2(s_ang, c_ang),
                                        dtype=torch.float32)).numpy()
    return np.eye(3, dtype=np.float32)


class MonoInertialSlam(MonoSlam):
    """Monocular + IMU pipeline."""

    def __init__(self, cam_params, calib: pre_mod.ImuCalib,
                 min_kf_imu_init: int = 6, min_time_imu_init: float = 1.5,
                 max_kf_dt: float = 0.5, **kw):
        super().__init__(cam_params, **kw)
        dev = self.device
        self.calib = calib.to(dev)
        self.min_kf_imu_init = min_kf_imu_init
        self.min_time_imu_init = min_time_imu_init
        # inertial modes force a KF on elapsed time so preintegration
        # factors stay short and scale/gravity remain well-conditioned
        self.max_kf_dt = max_kf_dt

        K = self.map.K
        self.pre_kf = _stack_identity_pre(K, dev)      # factor: kf_prev[k] -> k
        # temporal predecessor slot per KF slot (-1 = chain head). Slots are
        # reused after keyframe culling, so the inertial chain is explicit.
        self.kf_prev = np.full(K, -1, np.int32)
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        self.kf_vel, self.kf_bg, self.kf_ba = z(K, 3), z(K, 3), z(K, 3)

        self.imu_initialized = False
        self._init_kf_count = 0
        self.bg, self.ba, self.vel = z(3), z(3), z(3)  # vel: current body velocity
        self.pre_since_kf = pre_mod.identity_preintegrated(device=dev)
        self.pre_last_frame = pre_mod.identity_preintegrated(device=dev)
        # marginal prior on the last frame's 15-dof state; None = the map
        # changed since the last frame -> the next frame optimizes against
        # the last KEYFRAME instead
        self._prior: Optional[marginalize.PoseImuPrior] = None
        self._T_pred: Optional[torch.Tensor] = None
        self.scale_applied = 1.0
        # world transforms (Ryw, s) applied by IMU init / scale refinement,
        # queued for a paired event tracker to replay on ITS map
        self.pending_world_transforms: list = []
        self._last_refine_s = 1.0
        # consecutive frames where the IMU prediction failed but a plain
        # visual search succeeded; at 3 the refinement is pulled forward
        self._imu_inconsistent = 0
        # init convergence gate (chi2 per residual dof)
        self.imu_init_max_chi2 = 3.0
        self._init_scale_hist: list = []
        self._refine_scale_hist: list = []
        # stereo/RGB-D inertial variants fix the (already metric) scale
        self._imu_fix_scale = False

    # ---------------------------------------------------------------- input

    def process_image_imu(self, img, ts: float, imu: ImuChunk,
                          max_kp: Optional[int] = None):
        """One camera frame + its IMU window from a RAW image. Initialized
        and tracking: the inertial frame step; otherwise extraction and the
        staged init path."""
        if not (self.imu_initialized and self.state == OK):
            feats = frontend.extract(img, max_kp=max_kp or self.map.N)
            xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
            return self.process_features_imu(
                FrameInput(ts, xy_ud, feats.octave, feats.angle,
                           feats.desc_pm1, feats.valid), imu)

        self.stats["frames"] += 1
        last = self._kf_order[-1]
        ref = self._kf_ref()
        (res, feats, xy_ud, flags, vel_mm, T_rel, T_pred, pre, pre_since2,
         vel_o, bg_o, ba_o, next_prior) = vi_frame_step(
            img, self.cam, self.map, *_chunk_tensors(imu, self.device, pad=True),
            self.T_last, self.vel, self.bg, self.ba,
            self.pre_since_kf, self.map.kf_T[last], self.kf_vel[last],
            self._prior, self.map.kf_T[ref], self.calib, self.min_track_inliers,
            max_kp=max_kp or self.map.N, img_w=self.img_w, img_h=self.img_h,
        )
        f = FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        self.last_frame = f
        # the IMU window is consumed whatever the tracking outcome
        # (dead-reckoning and the next KF factor both need it)
        self.pre_last_frame = pre
        self.pre_since_kf = pre_since2
        self._T_pred = T_pred

        n_inl, finite = (float(x) for x in flags.cpu().numpy())
        n_inl = int(n_inl)
        if not finite:
            self._prior = None
            return self._handle_lost(f, 0)
        if n_inl < max(6, self.min_track_inliers // 2):
            self._prior = None
            return self._handle_lost(f, n_inl)

        self.last_track = res
        self.lost_frames = 0
        self.state = OK
        self.velocity = vel_mm
        self.T_last = res.Tcw
        self.vel, self.bg, self.ba = vel_o, bg_o, ba_o
        self._prior = next_prior
        self.frames_since_kf += 1
        self.trajectory.append((ts, T_rel, ref))

        need_kf = (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
            or self._need_kf_extra(f)
        )
        out = {"state": self.state, "n_inliers": n_inl, "kf": False}
        if need_kf:
            self._insert_keyframe(f, res, n_inl)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def process_features_imu(self, f: FrameInput, imu: ImuChunk):
        """One frame with the IMU samples since the previous frame."""
        if imu.gyro.shape[0] > 0:
            pre, self.pre_since_kf = preintegrate_frame(
                *_chunk_tensors(imu, self.device, pad=True), self.pre_since_kf,
                self.calib)
        else:
            pre = pre_mod.identity_preintegrated(device=self.device)
            self.pre_since_kf = pre_mod.merge(self.pre_since_kf, pre)
        self.pre_last_frame = pre
        return self.process_features(f)

    # ------------------------------------------------------ overridden hooks

    def _try_initialize(self, f: FrameInput):
        ref_before = self._init_frame
        out = super()._try_initialize(f)
        if self.state == OK:
            # founding keyframes created: the window accumulated since the
            # reference frame is the KF0 -> KF1 inertial factor
            self.pre_kf = pre_mod.put(self.pre_kf, 1, self.pre_since_kf)
            self.kf_prev[:] = -1
            self.kf_prev[1] = 0
            self.pre_since_kf = pre_mod.identity_preintegrated(device=self.device)
        elif self._init_frame is f and ref_before is not f:
            # the reference frame was replaced: restart the window
            self.pre_since_kf = pre_mod.identity_preintegrated(device=self.device)
        return out

    def _track(self, f: FrameInput):
        if not self.imu_initialized:
            return super()._track(f)
        return self._track_inertial(f)

    def _track_inertial(self, f: FrameInput):
        """Per-frame tracking once the IMU is initialized, from features:
        IMU dead-reckoning prediction, projection matching, then motion-only
        visual-inertial optimization of the 15-dof frame state against the
        last keyframe (reference PoseInertialOptimizationLastKeyFrame)."""
        prev_ts = self.last_frame.ts if self.last_frame is not None else None
        self.last_frame = f
        T_last0 = self.T_last
        T_pred, vel_mm, v2 = _imu_predict(
            self.T_last, self.vel, self.pre_last_frame, self.bg, self.ba,
            self.calib.Tbc,
        )
        self._T_pred = T_pred
        self.velocity = vel_mm
        self.vel = v2

        def search(T, wide):
            kw = dict(search_radius=40.0, nn_ratio=0.95) if wide else {}
            return tracking.track_frame(
                self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
                T, img_w=self.img_w, img_h=self.img_h, **kw)

        res = search(T_pred, False)
        n_vis = int(res.n_inliers)
        if n_vis < self.min_track_inliers:
            res = search(T_pred, True)
            n_vis = int(res.n_inliers)
        if n_vis < self.min_track_inliers:
            # the IMU prediction itself may be the problem (a weakly
            # determined init leaves scale/velocity inconsistent with the
            # map): retry from the last pose, and on success repair the
            # inertial state instead of going lost
            res_v = search(T_last0, True)
            n_vv = int(res_v.n_inliers)
            if n_vv >= self.min_track_inliers and bool(torch.isfinite(res_v.Tcw).all()):
                self._imu_inconsistent += 1
                Tcw = res_v.Tcw
                self.last_track = res_v
                self.lost_frames = 0
                self.state = OK
                ref = self._kf_ref()
                self.velocity = Tcw @ lie.se3_inv(T_last0)
                T_rel = Tcw @ lie.se3_inv(self.map.kf_T[ref])
                self.T_last = Tcw
                # world velocity from the visual pose delta (finite
                # difference): the IMU-propagated one just proved wrong
                dtf = max(f.ts - prev_ts, 1e-3) if prev_ts is not None else 1e-1
                Cw0 = -T_last0[:3, :3].T @ T_last0[:3, 3]
                Cw1 = -Tcw[:3, :3].T @ Tcw[:3, 3]
                self.vel = (Cw1 - Cw0) / dtf
                self.frames_since_kf += 1
                self.trajectory.append((f.ts, T_rel, ref))
                if self._imu_inconsistent >= 3:
                    # persistent disagreement: re-estimate scale/gravity/
                    # biases over the full chain now
                    self._scale_refinement()
                    self._imu_inconsistent = 0
                out = {"state": self.state, "n_inliers": n_vv, "kf": False,
                       "visual_rescue": True}
                if (n_vv < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
                        or self.frames_since_kf >= self.max_frames_between_kf):
                    self._insert_keyframe(f, res_v, n_vv)
                    out.update(kf=True, n_lm=self.stats["lm"])
                return out

        # motion-only VI refinement against the last keyframe's state, over
        # the accumulated KF->frame preintegration window
        last = self._kf_order[-1]
        matched = res.feat_lm >= 0
        pts_w = self.map.lm_pos[torch.where(matched, res.feat_lm, 0).long()]
        Tcw, vel, bg, ba, inlier, n_vi = vi_ba.pose_inertial_optimization(
            self.cam, res.Tcw, self.vel, self.bg, self.ba,
            pts_w, f.xy_ud, frontend.inv_sigma(f.octave), matched,
            self.map.kf_T[last], self.kf_vel[last], self.pre_since_kf,
            self.calib.Tbc,
        )
        n_inl = int(n_vi)
        if not bool(torch.isfinite(Tcw).all()):
            return self._handle_lost(f, 0)
        # with an inertial factor the pose stays usable below the visual
        # threshold
        if n_inl < max(6, self.min_track_inliers // 2):
            return self._handle_lost(f, n_inl)

        res = res._replace(Tcw=Tcw, feat_lm=torch.where(inlier, res.feat_lm, -1),
                           inlier=inlier, n_inliers=n_vi)
        self.last_track = res
        self.lost_frames = 0
        self._imu_inconsistent = 0
        self.state = OK
        ref = self._kf_ref()
        self.velocity = Tcw @ lie.se3_inv(self.T_last)
        T_rel = Tcw @ lie.se3_inv(self.map.kf_T[ref])
        self.T_last = Tcw
        self.vel, self.bg, self.ba = vel, bg, ba
        self.frames_since_kf += 1
        self.trajectory.append((f.ts, T_rel, ref))

        need_kf = (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
            or self._need_kf_extra(f)
        )
        out = {"state": self.state, "n_inliers": n_inl, "kf": False}
        if need_kf:
            self._insert_keyframe(f, res, n_inl)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def _handle_lost(self, f: FrameInput, n_inl: int):
        """Inertial RECENTLY_LOST: dead-reckon on the IMU prediction through
        the dropout instead of freezing (reference PredictStateIMU branch),
        then fall back to the visual recovery path."""
        self._prior = None
        if (self.imu_initialized and self.lost_frames < self.lost_grace
                and self._T_pred is not None):
            self.stats["lost"] += 1
            self.lost_frames += 1
            self.state = RECENTLY_LOST
            self.T_last = self._T_pred
            self._log_pose(f.ts, self._T_pred)
            return {"state": self.state, "n_inliers": n_inl, "dead_reckoned": True}
        return super()._handle_lost(f, n_inl)

    def _need_kf_extra(self, f) -> bool:
        # host-cached timestamp: no device read per frame
        if self.n_kf == 0 or self._last_kf_ts is None:
            return False
        return (f.ts - self._last_kf_ts) >= self.max_kf_dt

    def _insert_keyframe(self, f: FrameInput, res, n_inl=None):
        prev_slot = self._kf_order[-1] if self._kf_order else -1
        pre_window = self.pre_since_kf
        super()._insert_keyframe(f, res, n_inl)  # allocates the slot, local BA
        # the map changed -> the next frame re-anchors on the keyframe state
        self._prior = None
        slot = self.last_kf_slot
        self.pre_kf, self.kf_vel, self.kf_bg, self.kf_ba = write_kf_imu_state(
            self.pre_kf, self.kf_vel, self.kf_bg, self.kf_ba, self.last_kf_slot_t,
            pre_window, self.vel, self.bg, self.ba,
        )
        self.kf_prev[slot] = prev_slot
        self.pre_since_kf = pre_mod.identity_preintegrated(device=self.device)

        if not self.imu_initialized:
            self._maybe_initialize_imu()
        else:
            self._vi_local_ba()
            # staged scale/gravity refinement while the map is young: every
            # keyframe until the correction settles at 1
            since_init = self._kf_seq_next - self._init_kf_count
            if since_init <= 16 or abs(self._last_refine_s - 1.0) > 0.05:
                self._scale_refinement()

    def _on_cull_keyframe(self, slot: int) -> None:
        """Stitch the inertial chain across the culled keyframe: the
        successor inherits the merged preintegration (reference
        IMU::Preintegrated::MergePrevious on KeyFrameCulling)."""
        succ = np.flatnonzero(self.kf_prev == slot)
        if succ.size:
            n = int(succ[0])
            merged = pre_mod.merge(pre_mod.take(self.pre_kf, slot),
                                   pre_mod.take(self.pre_kf, n))
            self.pre_kf = pre_mod.put(self.pre_kf, n, merged)
            self.kf_prev[n] = self.kf_prev[slot]
        self.kf_prev[slot] = -1

    def _imu_chain_masks(self, free_slots=None):
        """(edge_valid, prev) on the device for the active inertial chain,
        and the number of live edges; with `free_slots`, only edges whose
        newer endpoint is free."""
        K = self.map.K
        ev = np.zeros(K, bool)
        for s in self._kf_order:
            ev[s] = self.kf_prev[s] >= 0
        if free_slots is not None:
            in_free = np.zeros(K, bool)
            in_free[list(free_slots)] = True
            ev &= in_free
        n_edges = int((ev & (self.kf_prev >= 0)).sum())
        return (to_device(ev, self.device),
                to_device(self.kf_prev.astype(np.int64), self.device), n_edges)

    # ----------------------------------------------------------- imu stages

    def _body_poses(self) -> torch.Tensor:
        return pre_mod.Twb_from_Tcw(self.map.kf_T, self.calib.Tbc)

    def _apply_world_transform(self, Twb, res, Ryw_np: np.ndarray, s: float):
        """Gravity-align + rescale the map, the trajectory and the inertial
        state by (Ryw, s) from an inertial solve."""
        K = self.map.K
        Ryw = to_device(Ryw_np, self.device)
        Twb2, lm2, vel2 = inertial.apply_scaled_rotation(
            Twb, self.map.lm_pos, res.vel, Ryw, res.scale)
        self.map = self.map._replace(
            kf_T=pre_mod.Tcw_from_Twb(Twb2, self.calib.Tbc), lm_pos=lm2)
        self._rescale_trajectory(s, Ryw_np)
        self.kf_vel = vel2
        self.bg, self.ba = res.bg, res.ba
        self.kf_bg = res.bg[None].repeat(K, 1)
        self.kf_ba = res.ba[None].repeat(K, 1)
        self.vel = vel2[self._kf_order[-1]]
        self.T_last = self._transform_inflight_pose(Ryw, res.scale)
        self.pending_world_transforms.append((Ryw_np.astype(np.float32), s))

    def _solve_readback(self, res):
        """(cost, scale, g) of an inertial solve in one read."""
        h = torch.cat([res.cost[None], res.scale[None], res.g]).cpu().numpy()
        return float(h[0]), float(h[1]), h[2:5]

    def _maybe_initialize_imu(self):
        if self.n_kf < self.min_kf_imu_init:
            return
        order = self._kf_order
        ts = self.map.kf_ts.cpu().numpy()
        if ts[order[-1]] - ts[order[0]] < self.min_time_imu_init:
            return

        Twb = self._body_poses()
        edge_valid, prev, n_edges = self._imu_chain_masks()
        res = inertial.inertial_init(
            Twb, self.pre_kf, edge_valid, prior_gyro=1e2, prior_acc=1e6,
            iters=60, fix_scale=self._imu_fix_scale, prev=prev,
        )
        cost, scale, g_est = self._solve_readback(res)
        if not np.isfinite(cost) or scale < 1e-3:
            return
        # convergence gate: a weakly determined solve returns an arbitrary
        # scale whose application destroys the visual map; reject it and
        # retry at the next keyframe with more baseline
        chi2_dof = cost / max(9 * n_edges, 1)
        self._init_scale_hist.append(scale)
        if chi2_dof > self.imu_init_max_chi2:
            return
        self._apply_world_transform(Twb, res, _gravity_rotation(g_est), scale)
        self.velocity = self._eye4()
        self.imu_initialized = True
        self._init_kf_count = self._kf_seq_next
        self.scale_applied = scale
        self._vi_local_ba(full=True)

    def _transform_inflight_pose(self, Ryw: torch.Tensor, s) -> torch.Tensor:
        """The IN-FLIGHT frame pose through the gravity-align/rescale world
        transform (reference Map::ApplyScaledRotation + UpdateFrameIMU):
        rewinding T_last to the last keyframe would leave the next
        prediction behind the camera."""
        Tbc = self.calib.Tbc
        Twb_f = pre_mod.Twb_from_Tcw(self.T_last, Tbc)
        Rwb = Ryw @ Twb_f[:3, :3]
        pwb = s * (Ryw @ Twb_f[:3, 3])
        return pre_mod.Tcw_from_Twb(lie.se3(lie.project_so3(Rwb), pwb), Tbc)

    def _scale_refinement(self):
        """Re-estimate (scale, gravity dir, biases, velocities) over all
        keyframes and re-apply, once more baseline has accumulated."""
        Twb = self._body_poses()
        edge_valid, prev, n_edges = self._imu_chain_masks()
        res = inertial.inertial_init(
            Twb, self.pre_kf, edge_valid, prior_gyro=1.0, prior_acc=1e4,
            iters=40, fix_scale=self._imu_fix_scale, prev=prev,
        )
        cost, s, g_est = self._solve_readback(res)
        # wide sanity window only: a refit over more baseline regularly has
        # to correct a poor first init by several x
        if not np.isfinite(s) or not (0.1 < s < 10.0):
            return
        # the same convergence gate as the first init
        if cost / max(9 * n_edges, 1) > self.imu_init_max_chi2:
            return
        self._last_refine_s = s
        self._apply_world_transform(Twb, res, _gravity_rotation(g_est), s)
        self.scale_applied *= s
        # re-solve structure+poses with inertial factors at the new scale
        self._vi_local_ba(full=True)

    def _vi_local_ba(self, full: bool = False):
        m = self.map
        order = self._kf_order
        lo = 1 if full else max(1, len(order) - self.local_window)
        free_slots = order[lo:]
        kf_free = np.zeros(m.K, bool)
        kf_free[free_slots] = True

        obs_kf = m.obs_kf.long()
        obs_feat = m.obs_feat.long()
        visual = schur_ba.BAProblem(
            cam_params=self.cam,
            kf_T=m.kf_T,
            kf_fixed=to_device(~kf_free, self.device),
            kf_valid=m.kf_valid,
            lm_pos=m.lm_pos,
            lm_valid=m.lm_valid,
            obs_kf=m.obs_kf,
            obs_uv=m.kf_xy[obs_kf, obs_feat],
            obs_inv_sigma=frontend.inv_sigma(m.kf_octave[obs_kf, obs_feat]),
            obs_valid=m.obs_valid & m.kf_valid[obs_kf],
        )
        edge_valid, prev, _ = self._imu_chain_masks(free_slots)
        prob = vi_ba.VIBAProblem(
            visual=visual, Tbc=self.calib.Tbc, kf_vel=self.kf_vel,
            kf_bg=self.kf_bg, kf_ba=self.kf_ba, pre=self.pre_kf,
            edge_valid=edge_valid, g=pre_mod.gravity_w(m.kf_T), prev=prev,
        )
        # the reference's FullInertialBA runs 100 iterations at init; full
        # solves get a deeper budget than the per-KF local refinement
        res = vi_ba.vi_bundle_adjust(prob, iters=24 if full else 8)
        new_obs_valid = m.obs_valid & (res.obs_inlier | (m.lm_nobs[:, None] <= 2))
        self.map = m._replace(
            kf_T=res.kf_T, lm_pos=res.lm_pos, obs_valid=new_obs_valid,
            lm_nobs=new_obs_valid.sum(dim=1, dtype=torch.int32),
        )
        self.kf_vel, self.kf_bg, self.kf_ba = res.kf_vel, res.kf_bg, res.kf_ba
        last = order[-1]
        self.T_last = res.kf_T[last]
        self.vel = res.kf_vel[last]
        self.bg = res.kf_bg[last]
        self.ba = res.kf_ba[last]
