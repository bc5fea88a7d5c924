"""Atlas: multi-map container for lost-tracking recovery and map merging.

PyTorch port of ``eorb_slam_tpu/slam/atlas.py`` (reference Atlas): a list of
MapState values on one device (the card unless ``device`` says otherwise) +
an active index. ``create_new_map`` stores the active map and starts a fresh
one, ``reset_active`` empties it, and ``merge`` welds a stored map into the
active one through a Sim3 (LoopClosing::MergeLocal), copying its keyframes
and landmarks into free slots with their observation indices re-based.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from eorb_slam_tpu_torch._host import resolve_device
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.slam import map_state as ms


class Atlas:
    def __init__(self, K: int = 32, M: int = 4096, N: int = 512, P: int = 8,
                 device=None):
        self.caps = (K, M, N, P)
        self.device = resolve_device(device)
        self.maps: List[ms.MapState] = [ms.empty_map(K, M, N, P, self.device)]
        self.active = 0

    @property
    def current(self) -> ms.MapState:
        return self.maps[self.active]

    @current.setter
    def current(self, m: ms.MapState) -> None:
        self.maps[self.active] = m

    def n_maps(self) -> int:
        return len(self.maps)

    def create_new_map(self) -> ms.MapState:
        """Tracking lost with an established map: keep it, start fresh
        (reference Tracking::CreateMapInAtlas)."""
        self.maps.append(ms.empty_map(*self.caps, self.device))
        self.active = len(self.maps) - 1
        return self.current

    def reset_active(self) -> ms.MapState:
        self.maps[self.active] = ms.empty_map(*self.caps, self.device)
        return self.current

    def merge(self, stored_idx: int, R, t, s) -> ms.MapState:
        """Weld stored map `stored_idx` into the active map.

        (R,t,s): the Sim3 taking stored-map world coordinates into the
        active map's. Keyframes land in free KF slots and landmarks in free
        landmark slots (as many as fit), observation indices re-based. The
        duplicate fusion of the reference's MergeLocal is left to the next
        local BA's culling, as in the JAX package. The stored map leaves
        the Atlas."""
        act = self.maps[self.active]
        sto = self.maps[stored_idx]
        K, M, _, _ = self.caps
        dev = act.kf_T.device

        a_kf, a_lm = act.kf_valid.cpu().numpy(), act.lm_valid.cpu().numpy()
        s_kf = np.flatnonzero(sto.kf_valid.cpu().numpy())
        s_lm = np.flatnonzero(sto.lm_valid.cpu().numpy())
        free_kf, free_lm = np.flatnonzero(~a_kf), np.flatnonzero(~a_lm)
        n_kf = min(len(s_kf), len(free_kf))
        n_lm = min(len(s_lm), len(free_lm))
        if n_kf == 0:
            return act

        kf_map = np.full(K, -1, np.int64)
        kf_map[s_kf[:n_kf]] = free_kf[:n_kf]
        lm_map = np.full(M, -1, np.int64)
        lm_map[s_lm[:n_lm]] = free_lm[:n_lm]

        def idx(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        R, t, s = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in (R, t, s))
        lm_new_pos = lie.sim3_apply(R, t, s, sto.lm_pos)
        # keyframe pose re-expression: x_cam = Rcw x_s + tcw with
        # x_s = S^-1(x_a) = si Ri x_a + ti is x_cam = si (Rcw Ri) x_a +
        # (Rcw ti + tcw); projection is invariant to an overall scale, so
        # the SE3 form is [Rcw Ri | (Rcw ti + tcw) / si]
        Ri, ti, si = lie.sim3_inv(R, t, s)
        Rcw, tcw = sto.kf_T[:, :3, :3], sto.kf_T[:, :3, 3]
        T_new = lie.se3(Rcw @ Ri[None], ((Rcw @ ti[None, :, None])[:, :, 0] + tcw) / si)

        src_kf, dst_kf = idx(s_kf[:n_kf]), idx(free_kf[:n_kf])
        src_lm, dst_lm = idx(s_lm[:n_lm]), idx(free_lm[:n_lm])
        lm_map_t, kf_map_t = idx(lm_map), idx(kf_map)
        feat_lm_re = torch.where(
            sto.kf_feat_lm >= 0,
            lm_map_t[torch.clamp(sto.kf_feat_lm, min=0).long()], -1).to(torch.int32)
        obs_kf_re = kf_map_t[torch.clamp(sto.obs_kf, min=0).long()].to(torch.int32)
        obs_ok = sto.obs_valid & (obs_kf_re >= 0)
        first_kf = torch.clamp(
            kf_map_t[torch.clamp(sto.lm_first_kf[src_lm], min=0).long()], min=0)

        def put(a, dst, v):
            out = a.clone()
            out[dst] = v.to(a.dtype)
            return out

        new = act._replace(
            kf_T=put(act.kf_T, dst_kf, T_new[src_kf]),
            kf_valid=put(act.kf_valid, dst_kf, torch.ones_like(dst_kf, dtype=torch.bool)),
            kf_ts=put(act.kf_ts, dst_kf, sto.kf_ts[src_kf]),
            kf_xy=put(act.kf_xy, dst_kf, sto.kf_xy[src_kf]),
            kf_octave=put(act.kf_octave, dst_kf, sto.kf_octave[src_kf]),
            kf_angle=put(act.kf_angle, dst_kf, sto.kf_angle[src_kf]),
            kf_desc_pm1=put(act.kf_desc_pm1, dst_kf, sto.kf_desc_pm1[src_kf]),
            kf_feat_valid=put(act.kf_feat_valid, dst_kf, sto.kf_feat_valid[src_kf]),
            kf_feat_lm=put(act.kf_feat_lm, dst_kf, feat_lm_re[src_kf]),
            lm_pos=put(act.lm_pos, dst_lm, lm_new_pos[src_lm]),
            lm_valid=put(act.lm_valid, dst_lm, torch.ones_like(dst_lm, dtype=torch.bool)),
            lm_desc_pm1=put(act.lm_desc_pm1, dst_lm, sto.lm_desc_pm1[src_lm]),
            lm_nobs=put(act.lm_nobs, dst_lm, sto.lm_nobs[src_lm]),
            lm_first_kf=put(act.lm_first_kf, dst_lm, first_kf),
            obs_kf=put(act.obs_kf, dst_lm, torch.clamp(obs_kf_re[src_lm], min=0)),
            obs_feat=put(act.obs_feat, dst_lm, sto.obs_feat[src_lm]),
            obs_valid=put(act.obs_valid, dst_lm, obs_ok[src_lm]),
        )
        self.maps[self.active] = new
        del self.maps[stored_idx]
        if stored_idx < self.active:
            self.active -= 1
        return self.current
