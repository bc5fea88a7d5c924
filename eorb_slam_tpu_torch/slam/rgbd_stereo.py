"""Stereo, RGB-D and stereo-inertial SLAM systems.

PyTorch port of ``eorb_slam_tpu/slam/rgbd_stereo.py``: the reference's
STEREO / RGBD / IMU_STEREO sensor configurations (Frame::
ComputeStereoMatches / ComputeStereoFromRGBD; Tracking::
StereoInitialization).

Metric depth enters the map at two points: initialization builds the map
from ONE frame's depth-founded landmarks (no two-view RANSAC, no scale
gauge), and every new keyframe turns its unmatched depth-valid features
into landmarks (local_mapping.create_depth_landmarks, in
MonoSlam._insert_keyframe). Tracking is the monocular project-match-
optimize step. Images are (H,W) tensors on the system's device, uint8 or
float in [0,255].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.ops import frontend, stereo_match
from eorb_slam_tpu_torch.slam import local_mapping, map_state
from eorb_slam_tpu_torch.slam.system import OK, FrameInput, MonoSlam
from eorb_slam_tpu_torch.slam.vi_system import ImuChunk, MonoInertialSlam


class _DepthInitMixin:
    """Single-frame depth initialization shared by the stereo / RGB-D /
    stereo-inertial systems (replaces the two-view monocular init)."""

    min_init_depth_points: int = 60

    def _try_initialize(self, f: FrameInput):
        if f.depth is None:
            return super()._try_initialize(f)
        n_ok = int((f.valid & (f.depth > 0) & torch.isfinite(f.depth)).sum())
        if n_ok < self.min_init_depth_points:
            return {"state": self.state, "n": n_ok}

        # founding keyframe at the origin; a landmark per depth-valid feature
        N = f.xy_ud.shape[0]
        self.map = map_state.insert_keyframe(
            self.map, 0, self._eye4(), f.ts, f.xy_ud, f.octave, f.angle,
            f.desc_pm1, f.valid,
            torch.full((N,), -1, dtype=torch.int32, device=self.device))
        self.map, n_new = local_mapping.create_depth_landmarks(
            self.map, self.cam, 0, f.depth)
        self.n_kf = 1
        self.state = OK
        self.T_last = self._eye4()
        self.velocity = self._eye4()
        self.frames_since_kf = 0
        self.n_inliers_ref = int(n_new)
        self._log_pose(f.ts, self.T_last)
        self.stats["kf"] = 1
        self.stats["lm"] = int(self.map.lm_valid.sum())
        return {"state": self.state, "n": n_ok, "n_pts": self.stats["lm"]}


def _stereo_depth(slam, xy_l, oct_l, desc_l, valid_l, img_r, max_kp):
    """Extract the right image and match it against the left features."""
    fr = frontend.extract(img_r, max_kp=max_kp)
    xy_r = cam_mod.undistort_points(slam.cam, fr.xy)
    depth, _, _ = stereo_match.stereo_match(
        xy_l, oct_l, desc_l, valid_l, xy_r, fr.octave, fr.desc_pm1, fr.valid,
        slam.fx, slam.baseline)
    return depth


class StereoSlam(_DepthInitMixin, MonoSlam):
    """Rectified-stereo pipeline (STEREO mode). ``baseline`` in meters; the
    right camera shares the intrinsics (a rectified pair)."""

    def __init__(self, cam_params, baseline: float, **kw):
        super().__init__(cam_params, **kw)
        # the rig's fx and baseline as Python floats: the stereo matcher's key
        self.fx = float(cam_params[0])
        self.baseline = float(baseline)

    def make_stereo_frame(self, img_l: torch.Tensor, img_r: torch.Tensor,
                          ts: float, max_kp: Optional[int] = None) -> FrameInput:
        max_kp = max_kp or self.map.N  # frame capacity == extraction budget
        fl = frontend.extract(img_l, max_kp=max_kp)
        xy_l = cam_mod.undistort_points(self.cam, fl.xy)
        depth = _stereo_depth(self, xy_l, fl.octave, fl.desc_pm1, fl.valid,
                              img_r, max_kp)
        return FrameInput(ts, xy_l, fl.octave, fl.angle, fl.desc_pm1, fl.valid,
                          depth=depth)

    def process_stereo(self, img_l, img_r, ts: float,
                       max_kp: Optional[int] = None):
        return self.process_features(self.make_stereo_frame(img_l, img_r, ts, max_kp))


class RgbdSlam(_DepthInitMixin, MonoSlam):
    """RGB-D pipeline (RGBD mode): depth sampled at the keypoints."""

    def __init__(self, cam_params, max_depth: float = 40.0, **kw):
        super().__init__(cam_params, **kw)
        self.max_depth = float(max_depth)

    def make_rgbd_frame(self, img: torch.Tensor, depth_map: torch.Tensor,
                        ts: float, max_kp: Optional[int] = None) -> FrameInput:
        ft = frontend.extract(img, max_kp=max_kp or self.map.N)
        xy_ud = cam_mod.undistort_points(self.cam, ft.xy)
        # depth is sampled at the DISTORTED keypoint: that is where the
        # sensor measured it
        d, ok = stereo_match.depth_from_depthmap(
            ft.xy, depth_map.to(torch.float32), ft.valid)
        d = torch.where(ok & (d <= self.max_depth), d, -1.0)
        return FrameInput(ts, xy_ud, ft.octave, ft.angle, ft.desc_pm1, ft.valid,
                          depth=d)

    def process_rgbd(self, img, depth_map, ts: float,
                     max_kp: Optional[int] = None):
        return self.process_features(self.make_rgbd_frame(img, depth_map, ts, max_kp))


class StereoInertialSlam(_DepthInitMixin, MonoInertialSlam):
    """Stereo + IMU (IMU_STEREO mode): the metric stereo init and the
    inertial machinery of MonoInertialSlam. Stereo depth already fixes the
    scale, so the inertial init estimates gravity and biases at a fixed
    scale (LocalMapping::InitializeIMU with bFixedScale)."""

    def __init__(self, cam_params, calib, baseline: float, **kw):
        super().__init__(cam_params, calib, **kw)
        self.fx = float(cam_params[0])
        self.baseline = float(baseline)
        self._imu_fix_scale = True
        # right image of the in-flight frame (deferred stereo depth at KFs)
        self._pending_right = None

    make_stereo_frame = StereoSlam.make_stereo_frame

    def process_stereo_imu(self, img_l, img_r, ts: float, imu: ImuChunk,
                           max_kp: Optional[int] = None):
        """Once the IMU is initialized and tracking, a frame runs the
        left-only inertial frame step: tracking never consumes stereo
        depth, so the right image's extraction and the stereo match wait
        for ``_insert_keyframe`` and are paid at keyframe rate. Before
        that, both images are extracted and matched every frame."""
        if self.imu_initialized and self.state == OK:
            self._pending_right = (img_r, max_kp)
            try:
                return self.process_image_imu(img_l, ts, imu, max_kp=max_kp)
            finally:
                self._pending_right = None
        f = self.make_stereo_frame(img_l, img_r, ts, max_kp)
        return self.process_features_imu(f, imu)

    def _insert_keyframe(self, f: FrameInput, res, n_inl=None):
        if f.depth is None and self._pending_right is not None:
            # deferred stereo depth: extract the right image and match it
            # now, so the new KF still founds metric landmarks
            img_r, max_kp = self._pending_right
            f = dataclasses.replace(f, depth=_stereo_depth(
                self, f.xy_ud, f.octave, f.desc_pm1, f.valid, img_r,
                max_kp or self.map.N))
        super()._insert_keyframe(f, res, n_inl)

    def _try_initialize(self, f: FrameInput):
        out = _DepthInitMixin._try_initialize(self, f)
        if self.state == OK:
            # single-KF init: the preintegration window now spans KF0 only
            self.pre_since_kf = pre_mod.identity_preintegrated(device=self.device)
        return out
