"""Per-frame tracking: project-match-optimize.

PyTorch port of ``eorb_slam_tpu/slam/tracking.py`` (reference
Tracking::TrackWithMotionModel + TrackLocalMap): the local-map selection is
a frustum + window mask over ALL landmarks, and the (N_feat x M_landmarks)
Hamming matrix is one matmul.

Stages:
 1. project all landmarks with the predicted pose,
 2. admissibility mask (valid, in front, in image, search window, octave),
 3. masked NN-ratio descriptor matching,
 4. motion-only pose optimization (4x10 GN with outlier reclassification),
 5. inlier count for the keyframe policy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch._host import constant
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.ops import frontend, matching
from eorb_slam_tpu_torch.optim import pose_only
from eorb_slam_tpu_torch.slam.map_state import MapState


class TrackResult(NamedTuple):
    Tcw: torch.Tensor        # (4,4) optimized pose
    feat_lm: torch.Tensor    # (N,) int32 landmark id per feature (-1 = none)
    inlier: torch.Tensor     # (N,) bool — survived pose optimization
    n_matched: torch.Tensor  # () int32 matches fed to the optimizer
    n_inliers: torch.Tensor  # () int32


# the projection search's window and ratio test, and the wide re-search's
# after too few inliers (the reference's lax.cond branch)
NARROW_RADIUS, NARROW_NN_RATIO = 15.0, 0.9
WIDE_RADIUS, WIDE_NN_RATIO = 40.0, 0.95


class _Projection(NamedTuple):
    """The landmarks as one predicted pose sees them (track_frame's stages
    1 and 1b), shared by every search from that pose."""

    uv: torch.Tensor          # (M,2) projected pixels
    vis: torch.Tensor         # (M,) bool in view, in range, in front
    has_obs: torch.Tensor     # (M,) bool has a usable observation
    pred_level: torch.Tensor  # (M,) int32 predicted pyramid level


def _project(m: MapState, cam_params: torch.Tensor, T_pred: torch.Tensor,
             img_w: int, img_h: int) -> _Projection:
    # 1. project landmarks
    pc = lie.se3_apply(T_pred, m.lm_pos)                   # (M,3)
    uv = cam_mod.pinhole_project_linear(cam_params, pc)    # (M,2)
    vis = (
        m.lm_valid
        & (pc[..., 2] > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
    )

    # 1b. landmark quality attributes on the fly from the observation table
    # (MapPoint::UpdateNormalAndDepth + PredictScale + Frame::isInFrustum):
    # mean viewing direction, scale-corrected distance bounds, predicted level
    obs_kf = m.obs_kf.long()
    Rk = m.kf_T[:, :3, :3]
    kf_C = -torch.einsum("kij,kj->ki", Rk.transpose(1, 2), m.kf_T[:, :3, 3])
    obs_ok = m.obs_valid & m.kf_valid[obs_kf]               # (M,P)
    d_obs = m.lm_pos[:, None, :] - kf_C[obs_kf]             # (M,P,3)
    dist_obs = torch.linalg.norm(d_obs, dim=-1)
    oct_obs = m.kf_octave[obs_kf, m.obs_feat.long()]
    level_dist = dist_obs * 1.2 ** oct_obs.to(torch.float32)
    dmax = torch.amax(torch.where(obs_ok, level_dist, 0.0), dim=1)
    dmin = dmax / 1.2**7
    normal = torch.sum(
        torch.where(obs_ok[..., None], d_obs / (dist_obs[..., None] + 1e-9), 0.0),
        dim=1)
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-9)
    has_obs = obs_ok.any(dim=1) & (dmax > 1e-6)

    C_pred = -T_pred[:3, :3].T @ T_pred[:3, 3]
    v = m.lm_pos - C_pred
    dist = torch.linalg.norm(v, dim=-1)
    cos_view = torch.sum(v / (dist[:, None] + 1e-9) * normal, dim=-1)
    in_range = (dist >= 0.8 * dmin) & (dist <= 1.3 * dmax) & (cos_view > 0.5)
    vis = vis & (~has_obs | in_range)
    pred_level = torch.clamp(
        torch.floor(torch.log(torch.clamp(dmax, min=1e-6)
                              / torch.clamp(dist, min=1e-6))
                    / math.log(1.2) + 0.5), 0, 7).to(torch.int32)
    return _Projection(uv, vis, has_obs, pred_level)


def _search(m, cam_params, xy_ud, octave, desc_pm1, feat_valid, T_pred,
            proj: _Projection, search_radius, max_dist, nn_ratio) -> TrackResult:
    """Stages 2-5 from one projection. ``search_radius`` and ``nn_ratio``
    are Python floats, or 0-dim float32 tensors (one setting of a batch
    under ``torch.func.vmap``): the same float32 values either way."""
    # 2. admissible pairs: window scaled by feature octave, and the
    # feature's level within +-1 of the predicted one
    scale = 1.2 ** octave.to(torch.float32)
    r = search_radius * scale                               # (N,)
    d2 = torch.sum((xy_ud[:, None, :] - proj.uv[None, :, :]) ** 2, dim=-1)
    level_ok = (torch.abs(octave[:, None] - proj.pred_level[None, :]) <= 1) \
        | ~proj.has_obs[None, :]
    pair = (d2 <= (r[:, None] ** 2)) & proj.vis[None, :] & level_ok

    # 3. matching
    feat_lm, dist = matching.match_nnratio(
        desc_pm1, feat_valid, m.lm_desc_pm1, proj.vis, pair_mask=pair,
        max_dist=max_dist, nn_ratio=nn_ratio, mutual=False,
    )
    matched = feat_lm >= 0

    # drop duplicate matches to the same landmark: keep the features at the
    # per-landmark minimum distance (a scatter-min, order-free)
    lm_safe = torch.where(matched, feat_lm, 0).long()
    per_lm_best = torch.full((m.M,), matching.BIG, dtype=dist.dtype,
                             device=dist.device).scatter_reduce(
        0, lm_safe, torch.where(matched, dist, matching.BIG), reduce="amin")
    keep = matched & (dist <= per_lm_best[lm_safe])
    feat_lm = torch.where(keep, feat_lm, -1)
    matched = keep

    # 4. pose optimization over the matched subset
    pts_w = m.lm_pos[torch.where(matched, feat_lm, 0).long()]
    inv_sigma = frontend.inv_sigma(octave)
    Tcw, inlier, n_inl = pose_only.pose_optimization(
        cam_params, T_pred, pts_w, xy_ud, inv_sigma, matched
    )
    feat_lm = torch.where(inlier, feat_lm, -1)
    return TrackResult(
        Tcw=Tcw,
        feat_lm=feat_lm,
        inlier=inlier,
        n_matched=matched.sum(dtype=torch.int32),
        n_inliers=n_inl,
    )


def _track_frame(
    m: MapState,
    cam_params: torch.Tensor,
    xy_ud: torch.Tensor,        # (N,2) undistorted feature coords
    octave: torch.Tensor,       # (N,)
    desc_pm1: torch.Tensor,     # (N,256) int8
    feat_valid: torch.Tensor,   # (N,)
    T_pred: torch.Tensor,       # (4,4) motion-model / predicted pose
    img_w: int = 752,
    img_h: int = 480,
    search_radius: float = NARROW_RADIUS,
    max_dist: int = matching.TH_HIGH,
    nn_ratio: float = NARROW_NN_RATIO,
) -> TrackResult:
    proj = _project(m, cam_params, T_pred, img_w, img_h)
    return _search(m, cam_params, xy_ud, octave, desc_pm1, feat_valid, T_pred,
                   proj, search_radius, max_dist, nn_ratio)


# one dispatch per search, as the reference's jit with static img_w, img_h;
# the search's window, distance and ratio are Python numbers here, so they
# are in the key too (two settings: the narrow search and the wide one). The
# map is copied into the graph's buffers at every call.
track_frame = _graphs.GraphRunner(
    _track_frame, static=("img_w", "img_h", "search_radius", "max_dist", "nn_ratio"))


def track_frame_with_retry(
    m: MapState,
    cam_params: torch.Tensor,
    xy_ud: torch.Tensor,
    octave: torch.Tensor,
    desc_pm1: torch.Tensor,
    feat_valid: torch.Tensor,
    T_pred: torch.Tensor,
    min_inl_retry: int,
    img_w: int = 752,
    img_h: int = 480,
) -> TrackResult:
    """``track_frame``, and where its inliers fall short of
    ``min_inl_retry`` the wide re-search (radius WIDE_RADIUS, ratio
    WIDE_NN_RATIO) in its place, chosen on the device: what the reference's
    ``lax.cond`` computes, with no host read.

    The landmarks are projected once; the two searches run as one batch of
    two settings under ``torch.func.vmap``, so the wide one rides in the
    narrow one's launches (the Hamming matrix, which no setting changes, is
    computed once), and each field is picked by ``torch.where``."""
    dev = xy_ud.device
    proj = _project(m, cam_params, T_pred, img_w, img_h)
    radius = constant((NARROW_RADIUS, WIDE_RADIUS), torch.float32, dev)
    ratio = constant((NARROW_NN_RATIO, WIDE_NN_RATIO), torch.float32, dev)

    def search(r, q):
        return tuple(_search(m, cam_params, xy_ud, octave, desc_pm1, feat_valid,
                             T_pred, proj, r, matching.TH_HIGH, q))

    both = torch.func.vmap(search)(radius, ratio)
    wide = both[4][0] < min_inl_retry
    return TrackResult(*(torch.where(wide, x[1], x[0]) for x in both))


def track_flags(res: TrackResult) -> torch.Tensor:
    """The per-frame host decisions packed into ONE (2,) float32 read:
    [n_inliers, all-finite(Tcw)]."""
    return torch.stack([res.n_inliers.to(torch.float32),
                        torch.isfinite(res.Tcw).all().to(torch.float32)])


def _track_image_frame(
    img: torch.Tensor,          # (H,W) uint8/float
    cam_params: torch.Tensor,
    m: MapState,
    velocity: torch.Tensor,     # (4,4) motion model
    T_last: torch.Tensor,       # (4,4)
    ref_T: torch.Tensor,        # (4,4) reference KF pose (trajectory entry)
    max_kp: int = 512,
    img_w: int = 752,
    img_h: int = 480,
):
    """The full per-frame image step: extract -> undistort -> motion-model
    predict -> project/match/pose-optimize -> packed host flags + the
    relative-pose trajectory entry. Returns
    (res, feats, xy_ud, flags, vel_new, T_rel)."""
    feats = frontend.extract(img, max_kp=max_kp)
    xy_ud = cam_mod.undistort_points(cam_params, feats.xy)
    T_pred = velocity @ T_last
    res = track_frame(
        m, cam_params, xy_ud, feats.octave, feats.desc_pm1, feats.valid,
        T_pred, img_w=img_w, img_h=img_h,
    )
    vel_new = res.Tcw @ lie.se3_inv(T_last)
    T_rel = res.Tcw @ lie.se3_inv(ref_T)
    return res, feats, xy_ud, track_flags(res), vel_new, T_rel


# the tracked image frame as one dispatch, as the reference's jit with
# static max_kp, img_w, img_h: on the card one CUDA graph per key (the image
# and the map's shapes), whose map inputs are copied in again whenever the
# map tensors were replaced
track_image_frame = _graphs.GraphRunner(
    _track_image_frame, static=("max_kp", "img_w", "img_h"))


def match_for_initialization(
    desc1_pm1, valid1, xy1, desc2_pm1, valid2, xy2,
    window: float = 100.0,
):
    """Frame-to-frame matching for monocular init: spatial window + NN ratio
    0.9 + mutual check (reference ORBmatcher::SearchForInitialization)."""
    pair = matching.window_mask(xy1, xy2, window)
    return matching.match_nnratio(
        desc1_pm1, valid1, desc2_pm1, valid2,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=0.9, mutual=True,
    )
