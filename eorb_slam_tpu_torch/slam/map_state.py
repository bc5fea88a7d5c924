"""Fixed-capacity tensor map state.

PyTorch port of ``eorb_slam_tpu/slam/map_state.py``: keyframes, landmarks and
a landmark-major observation table in pre-allocated tensors with validity
masks. Capacities (static): K keyframes, M landmarks, N features/frame, P
observations/landmark. Every function is functional: it returns new tensors
and leaves its inputs as they were. A keyframe slot is an int or a 0-d
int64 tensor (what the keyframe mapping step's graph takes): a tensor slot
is read and written by ``index_select`` / ``index_copy`` (:func:`row`),
never by indexing with it, which would read it on the host.

Scatters with repeated indices. The JAX functions write "no-op" updates
(the old value back) to a dummy index, slot 0, for every masked-out entry,
and several real updates can share a target too. XLA's CPU scatter keeps
the LAST update in index order, so e.g. ``alloc_landmarks`` on a fresh map
with ``ok = [T, F, F, T, ...]`` hands candidate 0 the id 0 while
``lm_valid[0]`` stays False (a reference defect, reproduced on purpose).
``index_put_`` with duplicate indices is undefined on CUDA, so every such
``.at[].set`` goes through :func:`scatter_set_last`, which picks the same
update deterministically on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MapState(NamedTuple):
    # --- keyframes
    kf_T: torch.Tensor          # (K,4,4) Tcw
    kf_valid: torch.Tensor      # (K,) bool
    kf_ts: torch.Tensor         # (K,) float32 timestamp
    kf_xy: torch.Tensor         # (K,N,2) undistorted pixel coords
    kf_octave: torch.Tensor     # (K,N) int32
    kf_angle: torch.Tensor      # (K,N) float32
    kf_desc_pm1: torch.Tensor   # (K,N,256) int8
    kf_feat_valid: torch.Tensor  # (K,N) bool
    kf_feat_lm: torch.Tensor    # (K,N) int32 landmark id or -1
    # --- landmarks
    lm_pos: torch.Tensor        # (M,3)
    lm_valid: torch.Tensor      # (M,) bool
    lm_desc_pm1: torch.Tensor   # (M,256) int8 representative descriptor
    lm_nobs: torch.Tensor       # (M,) int32
    lm_first_kf: torch.Tensor   # (M,) int32
    # --- observation table (landmark-major, feeds BA directly)
    obs_kf: torch.Tensor        # (M,P) int32
    obs_feat: torch.Tensor      # (M,P) int32
    obs_valid: torch.Tensor     # (M,P) bool

    @property
    def K(self):
        return self.kf_T.shape[0]

    @property
    def M(self):
        return self.lm_pos.shape[0]

    @property
    def N(self):
        return self.kf_xy.shape[1]

    @property
    def P(self):
        return self.obs_kf.shape[1]


def empty_map(K: int = 32, M: int = 4096, N: int = 512, P: int = 8,
              device=None) -> MapState:
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MapState(
        kf_T=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=z(K, torch.bool),
        kf_ts=z(K, f32),
        kf_xy=z((K, N, 2), f32),
        kf_octave=z((K, N), i32),
        kf_angle=z((K, N), f32),
        kf_desc_pm1=z((K, N, 256), torch.int8),
        kf_feat_valid=z((K, N), torch.bool),
        kf_feat_lm=torch.full((K, N), -1, dtype=i32, device=device),
        lm_pos=z((M, 3), f32),
        lm_valid=z(M, torch.bool),
        lm_desc_pm1=z((M, 256), torch.int8),
        lm_nobs=z(M, i32),
        lm_first_kf=z(M, i32),
        obs_kf=z((M, P), i32),
        obs_feat=z((M, P), i32),
        obs_valid=z((M, P), torch.bool),
    )


def scatter_set_last(target: torch.Tensor, index: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``target.at[index].set(values)`` along dim 0 where ``index`` (C,) may
    repeat: each target row takes the update with the LARGEST position in
    ``index`` among those aimed at it (what XLA's CPU scatter keeps), the
    others are dropped. Deterministic on every device: the winning position
    per row is a ``scatter_reduce(amax)``, then one gather. Indices must lie
    in ``[0, target.shape[0])``. Returns a new tensor."""
    index = index.long()
    values = values.to(target.dtype).expand((index.shape[0],) + target.shape[1:])
    pos = torch.arange(index.shape[0], device=index.device)
    win = torch.full((target.shape[0],), -1, dtype=torch.long,
                     device=index.device)
    win = win.scatter_reduce(0, index, pos, reduce="amax", include_self=True)
    hit = (win >= 0).view((-1,) + (1,) * (target.dim() - 1))
    return torch.where(hit, values[win.clamp(min=0)], target)


def _flat_set_last(target: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """``target.at[rows, cols].set(values)`` on a 2-D target, with
    :func:`scatter_set_last` semantics for repeated (row, col) pairs."""
    flat = rows.long() * target.shape[1] + cols.long()
    return scatter_set_last(target.reshape(-1), flat, values).view(target.shape)


def row(t: torch.Tensor, slot) -> torch.Tensor:
    """``t[slot]`` for a keyframe slot given as an int or as a 0-d int64
    tensor. A tensor slot is gathered with ``index_select``: torch's
    indexing would read a 0-d tensor's value on the host."""
    if isinstance(slot, torch.Tensor):
        return t.index_select(0, slot.reshape(1))[0]
    return t[slot]


def _set_row(t: torch.Tensor, slot, value) -> torch.Tensor:
    """A copy of ``t`` with row ``slot`` (an int or a 0-d int64 tensor) set
    to ``value`` (a tensor or a Python number)."""
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1)
        if isinstance(value, torch.Tensor):
            return t.index_copy(0, idx, value.to(t.dtype).expand(t.shape[1:])[None])
        return t.index_fill(0, idx, value)
    out = t.clone()
    if isinstance(value, torch.Tensor):
        out[slot] = value
    else:
        # a Python number is filled in on the device: assigned, it would be
        # copied from the host with a synchronising copy
        out.select(0, slot).fill_(value)
    return out


def _full_idx(like: torch.Tensor, v) -> torch.Tensor:
    """A keyframe slot (int or 0-d tensor) broadcast to ``like``'s shape as
    an int64 index, with no host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.long().expand(like.shape)
    return torch.full(like.shape, v, dtype=torch.long, device=like.device)


def insert_keyframe(
    m: MapState,
    slot,
    Tcw: torch.Tensor,
    ts,
    xy: torch.Tensor,
    octave: torch.Tensor,
    angle: torch.Tensor,
    desc_pm1: torch.Tensor,
    feat_valid: torch.Tensor,
    feat_lm: torch.Tensor,
) -> MapState:
    """Write a frame into keyframe slot `slot` and register its landmark
    observations into the obs table (KeyFrame construction +
    MapPoint::AddObservation). Each observed landmark gets the observation
    in its first free column; a full row overwrites its oldest (by keyframe
    timestamp) observation."""
    dev = m.kf_T.device
    m = m._replace(
        kf_T=_set_row(m.kf_T, slot, Tcw),
        kf_valid=_set_row(m.kf_valid, slot, True),
        kf_ts=_set_row(m.kf_ts, slot, ts),
        kf_xy=_set_row(m.kf_xy, slot, xy),
        kf_octave=_set_row(m.kf_octave, slot, octave),
        kf_angle=_set_row(m.kf_angle, slot, angle),
        kf_desc_pm1=_set_row(m.kf_desc_pm1, slot, desc_pm1),
        kf_feat_valid=_set_row(m.kf_feat_valid, slot, feat_valid),
        kf_feat_lm=_set_row(m.kf_feat_lm, slot, feat_lm),
    )
    N = feat_lm.shape[0]
    has_lm = (feat_lm >= 0) & feat_valid
    lm_idx = torch.where(has_lm, feat_lm, 0).long()
    row_valid = m.obs_valid[lm_idx]                              # (N,P)
    # first False (0 if full); torch has no argmin over bool
    first_free = torch.argmin(row_valid.to(torch.int8), dim=1)
    full = row_valid.all(dim=1)
    obs_ts = m.kf_ts[m.obs_kf[lm_idx].long()]                    # (N,P)
    oldest = torch.argmin(torch.where(row_valid, obs_ts, torch.inf), dim=1)
    cursor = torch.where(full, oldest, first_free)
    feat_ids = torch.arange(N, dtype=torch.int32, device=dev)
    m = m._replace(
        obs_kf=_flat_set_last(m.obs_kf, lm_idx, cursor, torch.where(
            has_lm, _full_idx(has_lm, slot), m.obs_kf[lm_idx, cursor])),
        obs_feat=_flat_set_last(m.obs_feat, lm_idx, cursor, torch.where(
            has_lm, feat_ids, m.obs_feat[lm_idx, cursor])),
        obs_valid=_flat_set_last(m.obs_valid, lm_idx, cursor, torch.where(
            has_lm, True, m.obs_valid[lm_idx, cursor])),
    )
    return m._replace(lm_nobs=m.obs_valid.sum(1, dtype=torch.int32))


def alloc_landmarks(
    m: MapState,
    new_pos: torch.Tensor,      # (C,3) candidate positions
    new_desc: torch.Tensor,     # (C,256) int8
    new_ok: torch.Tensor,       # (C,) bool — candidate accepted
    kf_a,                       # keyframe slot of view A
    feat_a: torch.Tensor,       # (C,) int feature idx in view A
    kf_b,
    feat_b: torch.Tensor,
):
    """Prefix-sum slot allocation of new landmarks into free lm slots
    (LocalMapping::CreateNewMapPoints' `new MapPoint`): candidate i takes
    the (rank_i)-th free slot; overflow candidates are dropped by mask.

    Returns (new MapState, lm_ids (C,) int32 — assigned id or -1)."""
    M = m.M
    dev = m.lm_pos.device
    i32 = torch.int32
    free = ~m.lm_valid
    free_rank = torch.cumsum(free.to(i32), 0, dtype=i32) - 1     # (M,)
    n_free = free.sum(dtype=i32)
    cand_rank = torch.cumsum(new_ok.to(i32), 0, dtype=i32) - 1  # (C,)
    take = new_ok & (cand_rank < n_free)

    # rank -> slot map: free slots scatter their index to their rank
    slot_of_rank = scatter_set_last(
        torch.zeros(M, dtype=i32, device=dev),
        torch.where(free, free_rank, M - 1),
        torch.arange(M, dtype=i32, device=dev))
    cand_slot = slot_of_rank[torch.clamp(cand_rank, 0, M - 1).long()]
    cand_slot = torch.where(take, cand_slot, 0).long()
    ka = _full_idx(feat_a, kf_a)
    kb = _full_idx(feat_b, kf_b)
    tk = take[:, None]

    def put(t, v):
        return scatter_set_last(t, cand_slot, v)

    m = m._replace(
        lm_pos=put(m.lm_pos, torch.where(tk, new_pos, m.lm_pos[cand_slot])),
        lm_valid=put(m.lm_valid, torch.where(take, True, m.lm_valid[cand_slot])),
        lm_desc_pm1=put(m.lm_desc_pm1,
                        torch.where(tk, new_desc, m.lm_desc_pm1[cand_slot])),
        lm_first_kf=put(m.lm_first_kf,
                        torch.where(take, ka, m.lm_first_kf[cand_slot])),
        lm_nobs=put(m.lm_nobs, torch.where(take, 2, m.lm_nobs[cand_slot])),
    )
    # the two founding observations (obs slots 0 and 1), and a fresh
    # validity row clearing any stale observations of a culled landmark
    zeros = torch.zeros_like(cand_slot)
    ones = torch.ones_like(cand_slot)
    obs_kf = _flat_set_last(m.obs_kf, cand_slot, zeros, torch.where(
        take, ka, m.obs_kf[cand_slot, 0]))
    obs_kf = _flat_set_last(obs_kf, cand_slot, ones, torch.where(
        take, kb, obs_kf[cand_slot, 1]))
    obs_feat = _flat_set_last(m.obs_feat, cand_slot, zeros, torch.where(
        take, feat_a.to(i32), m.obs_feat[cand_slot, 0]))
    obs_feat = _flat_set_last(obs_feat, cand_slot, ones, torch.where(
        take, feat_b.to(i32), obs_feat[cand_slot, 1]))
    fresh_row = torch.arange(m.P, device=dev) < 2
    obs_valid = put(m.obs_valid, torch.where(tk, fresh_row[None, :],
                                             m.obs_valid[cand_slot]))
    m = m._replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_valid=obs_valid)

    lm_ids = torch.where(take, cand_slot.to(i32), -1)
    # back-link the founding features in both keyframes (the second write
    # reads the ORIGINAL table, as the reference does)
    feat_a, feat_b = feat_a.long(), feat_b.long()
    kf_feat_lm = _flat_set_last(m.kf_feat_lm, ka, feat_a, torch.where(
        take, lm_ids, m.kf_feat_lm[ka, feat_a]))
    kf_feat_lm = _flat_set_last(kf_feat_lm, kb, feat_b, torch.where(
        take, lm_ids, m.kf_feat_lm[kb, feat_b]))
    return m._replace(kf_feat_lm=kf_feat_lm), lm_ids


def remove_keyframe(m: MapState, slot) -> MapState:
    """Erase keyframe `slot`: invalidate the KF row, drop its observations,
    cull landmarks that fall below two observations, and clear stale
    feature->landmark links everywhere (KeyFrame::SetBadFlag +
    MapPoint::EraseObservation). The slot becomes reusable."""
    m = m._replace(
        kf_valid=_set_row(m.kf_valid, slot, False),
        kf_feat_valid=_set_row(m.kf_feat_valid, slot, False),
        kf_feat_lm=_set_row(m.kf_feat_lm, slot, -1),
        obs_valid=m.obs_valid & (m.obs_kf != slot),
    )
    nobs = m.obs_valid.sum(1, dtype=torch.int32)
    lm_valid = m.lm_valid & (nobs >= 2)
    m = m._replace(lm_nobs=nobs, lm_valid=lm_valid)
    link_ok = lm_valid[torch.clamp(m.kf_feat_lm, min=0).long()] & (m.kf_feat_lm >= 0)
    return m._replace(kf_feat_lm=torch.where(link_ok, m.kf_feat_lm, -1))


def keyframe_redundancy(m: MapState) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-keyframe redundancy statistics for KeyFrameCulling: (frac (K,),
    total (K,)) — the fraction of each KF's landmark observations whose
    landmark has >= 4 observations, and the KF's observation count."""
    K = m.K
    nobs = m.obs_valid.sum(1, dtype=torch.int32)
    live = m.obs_valid & m.lm_valid[:, None]
    # dead observations go to an extra row K that is sliced off
    kf_of_obs = torch.where(live, m.obs_kf, K).reshape(-1).long()
    well_seen = (nobs[:, None] >= 4) & live
    z = torch.zeros(K + 1, dtype=torch.int32, device=m.obs_kf.device)
    total = z.index_add(0, kf_of_obs, live.reshape(-1).to(torch.int32))[:K]
    red = z.index_add(0, kf_of_obs, well_seen.reshape(-1).to(torch.int32))[:K]
    frac = red.to(torch.float32) / torch.clamp(total, min=1).to(torch.float32)
    return frac, total


def median_scene_depth(lm_pos: torch.Tensor, lm_valid: torch.Tensor,
                       Tcw: torch.Tensor) -> torch.Tensor:
    """Masked median landmark depth in the given camera (KeyFrame::
    ComputeSceneMedianDepth), as a device scalar; 1.0 below 8 landmarks."""
    z = (lm_pos @ Tcw[:3, :3].T)[:, 2] + Tcw[2, 3]
    ok = lm_valid & (z > 1e-3)
    n = ok.sum()
    zs = torch.sort(torch.where(ok, z, torch.inf)).values
    # a gather, not an index by a 0-dim tensor (which reads it on the host)
    med = zs.gather(0, torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0,
                                   z.shape[0] - 1).view(1))[0]
    return torch.where(n >= 8, med, 1.0)
