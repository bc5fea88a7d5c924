"""Local mapping: new-landmark triangulation, duplicate fusion, and local
BA with culling and the descriptor refresh.

PyTorch port of ``eorb_slam_tpu/slam/local_mapping.py`` (reference
LocalMapping::ProcessNewKeyFrame -> MapPointCulling -> CreateNewMapPoints
-> SearchInNeighbors -> local BA): ``create_new_landmarks``,
``fuse_duplicates``, ``keyframe_mapping_step``,
``update_landmark_descriptors``, ``local_ba``, the stereo / RGB-D
``create_depth_landmarks`` and the continuous tracker's slot-aligned
``create_new_landmarks_aligned``.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch import _graphs
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
    Ta = ms.row(m.kf_T, kf_a)
    Tb = ms.row(m.kf_T, kf_b)
    free_a = ms.row(m.kf_feat_valid, kf_a) & (ms.row(m.kf_feat_lm, kf_a) < 0)
    free_b = ms.row(m.kf_feat_valid, kf_b) & (ms.row(m.kf_feat_lm, kf_b) < 0)
    ray_a = cam_mod.pinhole_unproject_linear(cam_params, ms.row(m.kf_xy, kf_a))
    ray_b = cam_mod.pinhole_unproject_linear(cam_params, ms.row(m.kf_xy, kf_b))

    # epipolar gate from the known relative pose: x_b^T E x_a = 0
    Tba = Tb @ lie.se3_inv(Ta)
    E = lie.hat(lie.se3_trans(Tba)) @ lie.se3_rot(Tba)
    l_b = torch.einsum("ij,aj->ai", E, ray_a)                 # lines in b
    num = torch.einsum("ai,bi->ab", l_b, ray_b)               # (Na,Nb)
    f2 = cam_params[0] * cam_params[1]
    d2 = num**2 / (l_b[:, 0] ** 2 + l_b[:, 1] ** 2 + 1e-12)[:, None] * f2
    pair = d2 <= max_epipolar_px**2

    match_ab, _ = matching.match_nnratio(
        ms.row(m.kf_desc_pm1, kf_a), free_a, ms.row(m.kf_desc_pm1, kf_b), free_b,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=0.8, mutual=True,
    )
    okm = match_ab >= 0
    idx_b = torch.where(okm, match_ab, 0).long()

    pts = triangulation.triangulate_dlt(Ta[None], Tb[None], ray_a, ray_b[idx_b])
    inv_s_a = cam_params[0] * frontend.inv_sigma(ms.row(m.kf_octave, kf_a))
    inv_s_b = cam_params[0] * frontend.inv_sigma(ms.row(m.kf_octave, kf_b)[idx_b])
    ok_tri, _ = triangulation.triangulation_checks(
        Ta[None], Tb[None], ray_a, ray_b[idx_b], pts,
        min_parallax_cos=min_parallax_cos,
        inv_sigma1=inv_s_a, inv_sigma2=inv_s_b,
    )
    ok = okm & ok_tri
    m, lm_ids = ms.alloc_landmarks(
        m, pts, ms.row(m.kf_desc_pm1, kf_a), ok, kf_a,
        torch.arange(m.N, dtype=torch.int32, device=pts.device), kf_b, idx_b,
    )
    return m, (lm_ids >= 0).sum(dtype=torch.int32)


def create_new_landmarks_aligned(
    m: ms.MapState,
    cam_params: torch.Tensor,
    kf_a,                      # new keyframe slot
    kf_b,                      # older keyframe slot
    slot_ok: torch.Tensor,     # (N,) bool: feature row is the SAME track
    min_parallax_cos: float = 0.9998,
):
    """Triangulate landmarks between two keyframes whose feature arrays are
    slot-ALIGNED (the continuous tracker's layout: one feature track = one
    row, event/feature_tracks.py). The correspondence is the row index, no
    descriptor matching (the track-driven CreateNewMapPoints of
    EvLocalMapping). Returns (MapState, lm_ids (N,) int32, -1 = none)."""
    Ta = ms.row(m.kf_T, kf_a)
    Tb = ms.row(m.kf_T, kf_b)
    ray_a = cam_mod.pinhole_unproject_linear(cam_params, ms.row(m.kf_xy, kf_a))
    ray_b = cam_mod.pinhole_unproject_linear(cam_params, ms.row(m.kf_xy, kf_b))
    ok_in = (slot_ok & ms.row(m.kf_feat_valid, kf_a) & ms.row(m.kf_feat_valid, kf_b)
             & (ms.row(m.kf_feat_lm, kf_a) < 0))
    pts = triangulation.triangulate_dlt(Ta[None], Tb[None], ray_a, ray_b)
    ok_tri, _ = triangulation.triangulation_checks(
        Ta[None], Tb[None], ray_a, ray_b, pts,
        min_parallax_cos=min_parallax_cos,
        inv_sigma1=cam_params[0] * frontend.inv_sigma(ms.row(m.kf_octave, kf_a)),
        inv_sigma2=cam_params[0] * frontend.inv_sigma(ms.row(m.kf_octave, kf_b)),
    )
    ok = ok_in & ok_tri & torch.isfinite(pts).all(dim=-1)
    feat_ids = torch.arange(m.N, dtype=torch.int32, device=pts.device)
    return ms.alloc_landmarks(m, pts, ms.row(m.kf_desc_pm1, kf_a), ok, kf_a, feat_ids,
                              kf_b, feat_ids)


def create_depth_landmarks(
    m: ms.MapState,
    cam_params: torch.Tensor,
    slot,                  # keyframe slot
    depth: torch.Tensor,   # (N,) metric depth per feature (<=0 = unknown)
):
    """Create landmarks directly from per-feature depth (stereo / RGB-D;
    the stereo branch of Tracking::CreateNewKeyFrame / StereoInitialization):
    features with a valid depth and no landmark are unprojected at that
    depth and inserted. Both founding observation rows point at
    (slot, feat), as in the reference: the duplicated row (a 2x-weighted
    residual in BA) keeps a one-view landmark clear of the
    min-two-observations culling rule.

    Returns (MapState, n_new () int32)."""
    T = ms.row(m.kf_T, slot)
    rays = cam_mod.pinhole_unproject_linear(cam_params, ms.row(m.kf_xy, slot))  # (N,3)
    pts_w = lie.se3_apply(lie.se3_inv(T), rays * depth[:, None])
    ok = (ms.row(m.kf_feat_valid, slot) & (ms.row(m.kf_feat_lm, slot) < 0) & (depth > 0)
          & torch.isfinite(depth) & torch.isfinite(pts_w).all(dim=-1))
    feat_ids = torch.arange(m.N, dtype=torch.int32, device=depth.device)
    m, lm_ids = ms.alloc_landmarks(
        m, pts_w, ms.row(m.kf_desc_pm1, slot), ok, slot, feat_ids, slot, feat_ids)
    return m, (lm_ids >= 0).sum(dtype=torch.int32)


def fuse_duplicates(
    m: ms.MapState,
    cam_params: torch.Tensor,
    kf_a,                # new keyframe slot
    kf_b,                # covisible neighbor slot
    search_px: float = 3.0,
):
    """Merge duplicate landmarks between two keyframes
    (LocalMapping::SearchInNeighbors + ORBmatcher::Fuse): project the
    neighbor's landmarks into the new keyframe; where a landmark-bearing
    feature of A descriptor-matches a projected landmark of B that is a
    DIFFERENT landmark, the two are duplicates of one 3D point. The one with
    more observations wins (MapPoint::Replace), the loser's observations are
    rewired into the winner's row and every feature link is redirected.

    Hamming distances are integers, so two candidate pairs often tie; where
    tied pairs share a winner or a loser, the pair later in feature order
    wins every write (``scatter_set_last``), on the CPU and on the card
    alike, which is what XLA's CPU scatter does in the reference.

    Returns (MapState, n_fused () int32)."""
    M, P = m.obs_kf.shape
    dev = m.obs_kf.device
    Ta = ms.row(m.kf_T, kf_a)
    la = ms.row(m.kf_feat_lm, kf_a)
    lb = ms.row(m.kf_feat_lm, kf_b)
    la_c = torch.clamp(la, min=0).long()
    lb_c = torch.clamp(lb, min=0).long()
    va = ms.row(m.kf_feat_valid, kf_a) & (la >= 0) & m.lm_valid[la_c]
    vb = ms.row(m.kf_feat_valid, kf_b) & (lb >= 0) & m.lm_valid[lb_c]

    # project B's landmarks into A's image; gate candidate pairs by pixel
    # distance to A's features
    pc = lie.se3_apply(Ta, m.lm_pos[lb_c])
    uv = cam_mod.pinhole_project_linear(cam_params, pc)
    vb = vb & (pc[:, 2] > 0.05) & torch.isfinite(uv).all(dim=-1)
    d2 = ((ms.row(m.kf_xy, kf_a)[:, None, :] - uv[None, :, :]) ** 2).sum(-1)
    pair = d2 <= search_px**2

    j, dist = matching.match_nnratio(
        ms.row(m.kf_desc_pm1, kf_a), va, ms.row(m.kf_desc_pm1, kf_b), vb,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=0.8, mutual=True,
    )
    lb_j = lb[torch.clamp(j, min=0).long()]
    lbj_c = torch.clamp(lb_j, min=0).long()
    dup = (j >= 0) & va & (la != lb_j)
    # 3D consistency: duplicates of one physical point sit close in space;
    # without this gate coarse features merge distinct nearby landmarks
    pos_a = m.lm_pos[la_c]
    z_a = lie.se3_apply(Ta, pos_a)[:, 2]
    d3 = torch.linalg.norm(pos_a - m.lm_pos[lbj_c], dim=-1)
    dup = dup & (d3 <= 0.03 * torch.clamp(z_a, min=1e-3))

    # winner = more observations (MapPoint::Replace keeps higher nObs)
    a_wins = m.lm_nobs[la_c] >= m.lm_nobs[lbj_c]
    w_c = torch.where(a_wins, la_c, lbj_c)
    l_c = torch.where(a_wins, lbj_c, la_c)

    # keep one merge per loser and per winner (best descriptor distance),
    # and never merge a landmark that is simultaneously a winner elsewhere
    d_eff = torch.where(dup, dist, matching.BIG)
    inf = torch.full((M,), matching.BIG, dtype=d_eff.dtype, device=dev)
    best_l = inf.scatter_reduce(0, l_c, d_eff, reduce="amin", include_self=True)
    best_w = inf.scatter_reduce(0, w_c, d_eff, reduce="amin", include_self=True)
    keep = dup & (d_eff <= best_l[l_c]) & (d_eff <= best_w[w_c])
    # targets carry one spare row M that takes every dropped update
    win_mask = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    win_mask.index_fill_(0, torch.where(keep, w_c, M), True)
    keep = keep & ~win_mask[l_c]

    # move the loser's valid observations into the winner's free columns
    occ_w = m.obs_valid[w_c].sum(1)                               # (N,)
    lrow_valid = m.obs_valid[l_c] & keep[:, None]                 # (N,P)
    tgt = occ_w[:, None] + torch.cumsum(lrow_valid, dim=1) - 1
    ok_move = lrow_valid & (tgt >= 0) & (tgt < P)
    row_idx = torch.where(ok_move, w_c[:, None], M).reshape(-1)
    col_idx = torch.clamp(tgt, 0, P - 1).reshape(-1)

    def spare(t):
        return torch.cat([t, t[:1]])

    def move(table, values):
        return ms._flat_set_last(spare(table), row_idx, col_idx,
                                 values.reshape(-1))

    obs_kf = move(m.obs_kf, m.obs_kf[l_c])[:M]
    obs_feat = move(m.obs_feat, m.obs_feat[l_c])[:M]
    obs_valid = move(m.obs_valid, torch.ones_like(ok_move))

    # kill the losers: invalidate their rows, redirect every feature link
    dead = torch.where(keep, l_c, M)
    gone = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    gone.index_fill_(0, dead, True)
    gone = gone[:M]
    obs_valid = obs_valid[:M] & ~gone[:, None]
    remap = ms.scatter_set_last(
        torch.arange(M + 1, dtype=torch.int32, device=dev), dead, w_c)[:M]
    kf_feat_lm = torch.where(
        m.kf_feat_lm >= 0, remap[torch.clamp(m.kf_feat_lm, min=0).long()], -1)

    m = m._replace(
        obs_kf=obs_kf, obs_feat=obs_feat, obs_valid=obs_valid,
        lm_valid=m.lm_valid & ~gone, kf_feat_lm=kf_feat_lm,
        lm_nobs=obs_valid.sum(1, dtype=torch.int32),
    )
    return m, keep.sum(dtype=torch.int32)


def _keyframe_mapping_step(
    m: ms.MapState,
    cam_params: torch.Tensor,
    slot,                          # () int64 new keyframe slot
    Tcw: torch.Tensor,
    ts,                            # () timestamp, kf_ts's dtype
    xy: torch.Tensor,
    octave: torch.Tensor,
    angle: torch.Tensor,
    desc_pm1: torch.Tensor,
    feat_valid: torch.Tensor,
    feat_lm: torch.Tensor,
    tri_partners,                  # (4,) int64 older KF slots (padding = `slot`)
    fuse_partners,                 # (3,) int64 covisible neighbors (fusion only)
    kf_free: torch.Tensor,         # (K,) bool local-BA window
    iters: int = 8,
    do_fuse: bool = True,
    refresh_desc: bool = True,
):
    """The per-keyframe mapping pass: KF insertion, multi-partner
    triangulation, duplicate fusion, and local BA with culling and the
    descriptor refresh (LocalMapping::Run minus KeyFrameCulling, which is
    host policy).

    The slots and the timestamp are device tensors, as the reference's
    are, and every row of a slot is gathered without a host read; eagerly
    (what CPU tensors run) they may also be ints, sequences of ints and a
    float. Returns (MapState, Tcw_optimized, stats (7,) float32 =
    [n_lm, n_fused, cost0, cost, opt_kf, fixed_kf, edges]). Padded partners
    equal to `slot` are no-ops (zero baseline fails the parallax gate;
    self-fusion only merges genuine in-frame duplicates)."""
    m = ms.insert_keyframe(
        m, slot, Tcw, ts, xy, octave, angle, desc_pm1, feat_valid, feat_lm
    )
    for ref_slot in tri_partners:
        m, _ = create_new_landmarks(m, cam_params, slot, ref_slot)

    n_fused = torch.zeros((), dtype=torch.int32, device=m.obs_kf.device)
    if do_fuse:
        for nb in fuse_partners:
            m, nf = fuse_duplicates(m, cam_params, slot, nb)
            n_fused = n_fused + nf

    # local BA's own runner runs inline inside this step's capture
    m, c0, c1 = local_ba(m, cam_params, kf_free, iters=iters,
                         refresh_desc=refresh_desc)
    # BA telemetry (the reference's Local*BA out-params), packed into the
    # one stats read
    n_edges = (m.obs_valid & m.lm_valid[:, None] & m.kf_valid[m.obs_kf.long()]).sum()
    f32 = torch.float32
    stats = torch.stack([
        m.lm_valid.sum().to(f32),
        n_fused.to(f32), c0, c1,
        (kf_free & m.kf_valid).sum().to(f32),
        (~kf_free & m.kf_valid).sum().to(f32),
        n_edges.to(f32),
    ])
    return m, ms.row(m.kf_T, slot), stats


# the keyframe mapping step as one dispatch, as the reference's jit with
# static iters, do_fuse and refresh_desc: on the card one CUDA graph per key
# (the map's and the frame's shapes), local BA's LM loop captured inside it
keyframe_mapping_step = _graphs.GraphRunner(
    _keyframe_mapping_step, static=("iters", "do_fuse", "refresh_desc"))


def update_landmark_descriptors(m: ms.MapState) -> ms.MapState:
    """Recompute each landmark's representative descriptor as the MEDOID of
    its observed descriptors (least mean Hamming distance to the others;
    MapPoint::ComputeDistinctiveDescriptors). Without it the founding
    descriptor goes stale as the viewpoint changes. The +-1 products are
    integers in f32, exact with TF32 off; equal scores (always so with two
    observations) keep the first column."""
    P = m.obs_kf.shape[1]
    d = m.kf_desc_pm1[m.obs_kf.long(), m.obs_feat.long()]      # (M,P,256)
    valid = m.obs_valid                                        # (M,P)
    df = d.float()
    dist = (256.0 - df @ df.transpose(1, 2)) * 0.5             # (M,P,P)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    sums = torch.where(pair_ok, dist, 0.0).sum(-1)
    cnt = pair_ok.sum(-1)
    score = torch.where(valid & (cnt > 0), sums / torch.clamp(cnt, min=1), 1e9)
    # first column among the least scores: argmin's tie order is not promised
    cols = torch.arange(P, device=score.device)
    least = score == score.min(dim=1, keepdim=True).values
    best = torch.where(least, cols, P).min(dim=1).values       # (M,)
    new_desc = torch.gather(
        d, 1, best[:, None, None].expand(-1, 1, d.shape[2]))[:, 0]
    has = valid.any(dim=1)
    return m._replace(
        lm_desc_pm1=torch.where(has[:, None], new_desc, m.lm_desc_pm1))


def local_ba(
    m: ms.MapState,
    cam_params: torch.Tensor,
    kf_free: torch.Tensor,   # (K,) bool — poses to optimize (rest fixed)
    iters: int = 8,
    refresh_desc: bool = True,
):
    """Local bundle adjustment directly over the map arrays (the
    landmark-major obs table IS the BAProblem), then outlier-observation
    pruning, landmark culling and (``refresh_desc``) the medoid descriptor
    refresh. Returns (MapState, cost0, cost)."""
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
    if refresh_desc:
        # gated off for small sensors by the caller: on blurry event-image
        # features the medoid hops between unstable observations
        m = update_landmark_descriptors(m)
    return m, res.cost0, res.cost
