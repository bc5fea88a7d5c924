"""Local mapping: new-landmark triangulation and local BA with culling.

PyTorch port of the event path of ``eorb_slam_tpu/slam/local_mapping.py``
(reference LocalMapping::ProcessNewKeyFrame -> MapPointCulling ->
CreateNewMapPoints -> local BA): ``create_new_landmarks``,
``keyframe_mapping_step`` and ``local_ba``. Duplicate fusion
(``fuse_duplicates``), the medoid descriptor refresh
(``update_landmark_descriptors``) and the depth / slot-aligned landmark
makers are not ported yet; the event tracker runs without them (sensors
narrower than 320 px), and asking for them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import torch

from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie, triangulation
from eorb_slam_tpu_torch.ops import frontend, matching
from eorb_slam_tpu_torch.optim import schur_ba
from eorb_slam_tpu_torch.slam import map_state as ms


def create_new_landmarks(
    m: ms.MapState,
    cam_params: torch.Tensor,
    kf_a,                # new keyframe slot
    kf_b,                # reference keyframe slot
    max_epipolar_px: float = 2.0,
    min_parallax_cos: float = 0.9998,
):
    """Triangulate new landmarks between two keyframes
    (LocalMapping::CreateNewMapPoints): match features not yet bound to a
    landmark under an epipolar gate, DLT-triangulate, apply cheirality/
    parallax/reprojection checks, then prefix-sum allocate.

    Returns (MapState, n_new () int32)."""
    Ta = m.kf_T[kf_a]
    Tb = m.kf_T[kf_b]
    free_a = m.kf_feat_valid[kf_a] & (m.kf_feat_lm[kf_a] < 0)
    free_b = m.kf_feat_valid[kf_b] & (m.kf_feat_lm[kf_b] < 0)
    ray_a = cam_mod.pinhole_unproject_linear(cam_params, m.kf_xy[kf_a])
    ray_b = cam_mod.pinhole_unproject_linear(cam_params, m.kf_xy[kf_b])

    # epipolar gate from the known relative pose: x_b^T E x_a = 0
    Tba = Tb @ lie.se3_inv(Ta)
    E = lie.hat(lie.se3_trans(Tba)) @ lie.se3_rot(Tba)
    l_b = torch.einsum("ij,aj->ai", E, ray_a)                 # lines in b
    num = torch.einsum("ai,bi->ab", l_b, ray_b)               # (Na,Nb)
    f2 = cam_params[0] * cam_params[1]
    d2 = num**2 / (l_b[:, 0] ** 2 + l_b[:, 1] ** 2 + 1e-12)[:, None] * f2
    pair = d2 <= max_epipolar_px**2

    match_ab, _ = matching.match_nnratio(
        m.kf_desc_pm1[kf_a], free_a, m.kf_desc_pm1[kf_b], free_b,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=0.8, mutual=True,
    )
    okm = match_ab >= 0
    idx_b = torch.where(okm, match_ab, 0).long()

    pts = triangulation.triangulate_dlt(Ta[None], Tb[None], ray_a, ray_b[idx_b])
    inv_s_a = cam_params[0] * frontend.inv_sigma(m.kf_octave[kf_a])
    inv_s_b = cam_params[0] * frontend.inv_sigma(m.kf_octave[kf_b][idx_b])
    ok_tri, _ = triangulation.triangulation_checks(
        Ta[None], Tb[None], ray_a, ray_b[idx_b], pts,
        min_parallax_cos=min_parallax_cos,
        inv_sigma1=inv_s_a, inv_sigma2=inv_s_b,
    )
    ok = okm & ok_tri
    m, lm_ids = ms.alloc_landmarks(
        m, pts, m.kf_desc_pm1[kf_a], ok, kf_a,
        torch.arange(m.N, dtype=torch.int32, device=pts.device), kf_b, idx_b,
    )
    return m, (lm_ids >= 0).sum(dtype=torch.int32)


def keyframe_mapping_step(
    m: ms.MapState,
    cam_params: torch.Tensor,
    slot,                          # new keyframe slot
    Tcw: torch.Tensor,
    ts,
    xy: torch.Tensor,
    octave: torch.Tensor,
    angle: torch.Tensor,
    desc_pm1: torch.Tensor,
    feat_valid: torch.Tensor,
    feat_lm: torch.Tensor,
    tri_partners: Sequence[int],   # older KF slots (padding = `slot`)
    fuse_partners: Sequence[int],  # covisible neighbors (fusion only)
    kf_free: torch.Tensor,         # (K,) bool local-BA window
    iters: int = 8,
    do_fuse: bool = True,
    refresh_desc: bool = True,
):
    """The per-keyframe mapping pass: KF insertion, multi-partner
    triangulation and local BA with culling (LocalMapping::Run minus
    KeyFrameCulling, which is host policy).

    Returns (MapState, Tcw_optimized, stats (7,) float32 =
    [n_lm, n_fused, cost0, cost, opt_kf, fixed_kf, edges]). Padded partners
    equal to `slot` are no-ops (zero baseline fails the parallax gate)."""
    if do_fuse:
        raise NotImplementedError(
            "duplicate fusion (fuse_duplicates) is not ported yet")
    m = ms.insert_keyframe(
        m, slot, Tcw, ts, xy, octave, angle, desc_pm1, feat_valid, feat_lm
    )
    for ref_slot in tri_partners:
        m, _ = create_new_landmarks(m, cam_params, slot, ref_slot)

    m, c0, c1 = local_ba(m, cam_params, kf_free, iters=iters,
                         refresh_desc=refresh_desc)
    # BA telemetry (the reference's Local*BA out-params), packed into the
    # one stats read
    n_edges = (m.obs_valid & m.lm_valid[:, None] & m.kf_valid[m.obs_kf.long()]).sum()
    f32 = torch.float32
    stats = torch.stack([
        m.lm_valid.sum().to(f32),
        torch.zeros((), dtype=f32, device=c0.device), c0, c1,
        (kf_free & m.kf_valid).sum().to(f32),
        (~kf_free & m.kf_valid).sum().to(f32),
        n_edges.to(f32),
    ])
    return m, m.kf_T[slot], stats


def local_ba(
    m: ms.MapState,
    cam_params: torch.Tensor,
    kf_free: torch.Tensor,   # (K,) bool — poses to optimize (rest fixed)
    iters: int = 8,
    refresh_desc: bool = True,
):
    """Local bundle adjustment directly over the map arrays (the
    landmark-major obs table IS the BAProblem), then outlier-observation
    pruning and landmark culling. Returns (MapState, cost0, cost)."""
    if refresh_desc:
        raise NotImplementedError(
            "the landmark descriptor refresh (update_landmark_descriptors) "
            "is not ported yet")
    obs_kf = m.obs_kf.long()
    obs_feat = m.obs_feat.long()
    obs_uv = m.kf_xy[obs_kf, obs_feat]                        # (M,P,2)
    inv_sigma = frontend.inv_sigma(m.kf_octave[obs_kf, obs_feat])
    prob = schur_ba.BAProblem(
        cam_params=cam_params,
        kf_T=m.kf_T,
        kf_fixed=~kf_free,
        kf_valid=m.kf_valid,
        lm_pos=m.lm_pos,
        lm_valid=m.lm_valid,
        obs_kf=m.obs_kf,
        obs_uv=obs_uv,
        obs_inv_sigma=inv_sigma,
        obs_valid=m.obs_valid & m.kf_valid[obs_kf],
    )
    res = schur_ba.bundle_adjust(prob, iters=iters)

    # write back + prune outlier observations; keep the founding pair even
    # if flagged, so fresh landmarks do not starve at once
    new_obs_valid = m.obs_valid & (res.obs_inlier | (m.lm_nobs[:, None] <= 2))
    m = m._replace(kf_T=res.kf_T, lm_pos=res.lm_pos, obs_valid=new_obs_valid)

    # landmark culling: fewer than 2 surviving observations -> invalid, and
    # feature links to culled landmarks are cleared
    nobs = m.obs_valid.sum(1, dtype=torch.int32)
    lm_valid = m.lm_valid & (nobs >= 2)
    link_ok = (m.kf_feat_lm >= 0) & lm_valid[torch.clamp(m.kf_feat_lm, min=0).long()]
    m = m._replace(lm_valid=lm_valid, lm_nobs=nobs,
                   kf_feat_lm=torch.where(link_ok, m.kf_feat_lm, -1))
    return m, res.cost0, res.cost
