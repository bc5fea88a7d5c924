"""Loop closing: detection, Sim3 verification, essential-graph correction.

PyTorch port of ``eorb_slam_tpu/slam/loop_closing.py`` (reference
LoopClosing: NewDetectCommonRegions = BoW retrieval + Sim3Solver RANSAC +
projection verification; CorrectLoop = Sim3 propagation + essential-graph
optimization + a global BA). It runs inline in the mapping cadence:
retrieval is retrieval/bow.py, verification geometry/sim3_solver.py,
correction optim/pose_graph.py and the final BA the Schur engine of
local_mapping.local_ba. The gate decisions are logged on ``eorb.loop``.

The reference's gates are reproduced as they are, defects included
(ROADMAP.md Queue 3): the drift gate reads the float32 keyframe
timestamps, the minScore floor is 0.75 x the weakest covisible score, and
the path between the two keyframes counts only the keyframes still alive.

Randomness: the Sim3 RANSAC draws from the closer's own generator (seed 7,
as the reference's key) through ``sim3_solver._draw_minimal_sets``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eorb_slam_tpu_torch._host import resolve_device
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie, sim3_solver
from eorb_slam_tpu_torch.ops import matching
from eorb_slam_tpu_torch.optim import pose_graph
from eorb_slam_tpu_torch.retrieval import bow
from eorb_slam_tpu_torch.slam import covisibility, local_mapping
from eorb_slam_tpu_torch.slam import map_state as ms
from eorb_slam_tpu_torch.utils.logging import get_logger


class LoopInfo(NamedTuple):
    detected: bool
    query: int
    matched: int
    n_inliers: int
    scale: float


def _projection_verify(
    cam, kf_T_cand, kf_T_query,
    lm_ids_c, feat_valid_c, desc_c, lm_pos, lm_desc,
    xy_q, desc_q, feat_valid_q,
    R, t, s,
    img_w, img_h,
):
    """The reference's second geometric gate (SearchByProjection with Scw):
    project the candidate's landmarks into the query frame through the
    candidate's pose and the relative Sim3, and count the descriptor
    matches within 10 px. Landmark descriptor rows that are still all-zero
    fall back to the candidate KF's own feature descriptor. Returns the
    count as a 0-d tensor."""
    valid_c = feat_valid_c & (lm_ids_c >= 0)
    ids = torch.clamp(lm_ids_c, min=0).long()
    p_c = lie.se3_apply(kf_T_cand, lm_pos[ids])       # candidate cam coords
    p_q = ((p_c - t) @ R) / s                          # query cam = S^-1 p_c
    uv = cam_mod.pinhole_project_linear(cam, p_q)
    vis = (valid_c & (p_q[:, 2] > 0.05)
           & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
           & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
    pair = matching.window_mask(uv, xy_q, 10.0)
    lm_d = lm_desc[ids]
    lm_set = torch.any(lm_d != 0, dim=-1)
    lm_d = torch.where(lm_set[:, None], lm_d, desc_c)
    j, _ = matching.match_nnratio(lm_d, vis, desc_q, feat_valid_q, pair_mask=pair,
                                  max_dist=matching.TH_HIGH, mutual=True)
    return torch.sum((j >= 0) & vis)


class LoopCloser:
    """Keeps the BoW keyframe database and runs detection + correction,
    on the card unless ``device`` says otherwise.

    min_score / consistency gates follow the reference's
    NewDetectCommonRegions; the covisibility group of the query is excluded
    from retrieval."""

    def __init__(self, cam_params, words_pm1, Kmax: int,
                 min_inliers: int = 20, nn_ratio: float = 0.75,
                 max_edges: int = 256, consistency_required: int = 3,
                 sparse_words_per_kf: int = 512,
                 proj_verify_min: int = 40,
                 img_w: int = 752, img_h: int = 480, device=None):
        self.device = resolve_device(device)
        self.cam = torch.as_tensor(cam_params, dtype=torch.float32).to(self.device)
        # vocabulary: a flat (V,256) codebook, or a 2-level HierVocab with
        # a sparse index at real-vocabulary scale
        self.hier = isinstance(words_pm1, bow.HierVocab)
        if self.hier:
            self.words = bow.HierVocab(*(x.to(self.device) for x in words_pm1))
        else:
            self.words = torch.as_tensor(words_pm1).to(self.device)
        self._Kmax = int(Kmax)
        self._Nw = int(sparse_words_per_kf)
        self.db = self.fresh_db()
        self.min_inliers = int(min_inliers)
        self.nn_ratio = float(nn_ratio)
        self.max_edges = int(max_edges)
        self.proj_verify_min = int(proj_verify_min)
        self.img_w, self.img_h = int(img_w), int(img_h)
        self.generator = torch.Generator(self.device).manual_seed(7)
        # temporal-consistency chaining: a loop fires only after
        # `consistency_required` consecutive keyframes retrieve candidates
        # from one covisibility-consistent group
        self.consistency_required = int(consistency_required)
        self._chains: list[tuple[set, int]] = []
        # post-correction cooldown (keyframes)
        self.cooldown_kfs = 10
        self._kf_count = 0
        self._last_loop_kfc = -(1 << 30)
        self.last_fuse_count = 0
        # temporal-separation gate: candidates inserted within this many
        # keyframes of the query are sequential neighbours, not revisits
        self.min_candidate_gap = 15
        self._added_at: dict = {}

    # -------------------------------------------------- vocabulary dispatch

    def fresh_db(self):
        if self.hier:
            return bow.empty_sparse_database(self._Kmax, self._Nw, self.device)
        return bow.empty_database(self._Kmax, int(self.words.shape[0]), self.device)

    def frame_query(self, desc_pm1, feat_valid):
        """Opaque per-frame BoW query object for `query_db`."""
        if self.hier:
            return bow.sparse_bow_row(*bow.quantize_hier(desc_pm1, feat_valid, self.words))
        return bow.quantize(desc_pm1, feat_valid, self.words)[1]

    def query_db(self, q, exclude_mask, top_k: int = 3, db=None):
        db = self.db if db is None else db
        if self.hier:
            return bow.sparse_detect_candidates(db, q[0], q[1], exclude_mask, top_k=top_k)
        return bow.detect_candidates(db, q, exclude_mask, top_k=top_k)

    def add_keyframe(self, m: ms.MapState, slot: int) -> None:
        self._kf_count += 1
        self._added_at[slot] = self._kf_count
        if self.hier:
            wid, w = bow.quantize_hier(m.kf_desc_pm1[slot], m.kf_feat_valid[slot],
                                       self.words)
            self.db = bow.sparse_add_keyframe(self.db, slot, wid, w)
            return
        _, bw = bow.quantize(m.kf_desc_pm1[slot], m.kf_feat_valid[slot], self.words)
        self.db = bow.add_keyframe(self.db, slot, bw)

    def remove_keyframe(self, slot: int) -> None:
        """Drop a culled keyframe from the retrieval database (the slot will
        be reused; stale rows would resurface as false candidates)."""
        self._added_at.pop(slot, None)
        if self.hier:
            self.db = bow.sparse_erase_keyframe(self.db, slot)
            return
        self.db = bow.erase_keyframe(self.db, slot)

    # ------------------------------------------------------------- detection

    def detect(self, m: ms.MapState, query: int):
        """Returns (candidate_slot, score) or (None, 0)."""
        q = self.frame_query(m.kf_desc_pm1[query], m.kf_feat_valid[query])
        cov_mask = covisibility.covisibility_mask(m, query)
        exclude = cov_mask.clone()
        exclude[query] = True
        # exclude temporal neighbours (see min_candidate_gap)
        q_at = self._added_at.get(query, self._kf_count)
        near = [s for s, at in self._added_at.items()
                if abs(q_at - at) < self.min_candidate_gap and s < m.K]
        if near:
            exclude[near] = True
        scores, idx = self.query_db(q, exclude, top_k=3)
        s_all = (bow.sparse_all_scores(self.db, q[0], q[1]) if self.hier
                 else bow.all_scores(self.db, q))
        # one read: the top scores, their slots, every score, the group
        packed = torch.cat([scores, idx.to(scores.dtype), s_all,
                            cov_mask.to(scores.dtype)]).cpu().numpy()
        scores, idx = packed[:3], packed[3:6].astype(np.int64)
        s_all, cov = packed[6:6 + m.K], packed[6 + m.K:] > 0
        if not np.isfinite(scores[0]) or scores[0] <= 0:
            return None, 0.0
        # minScore gate (DetectNBestCandidates): a true revisit resembles
        # the query nearly as much as the query's weakest covisible
        # neighbour does; the floor is 0.75 x that score, as the reference
        # relaxed it
        cov[query] = False               # the query itself has no db row
        cov_scores = s_all[cov & np.isfinite(s_all)]
        min_cov = float(cov_scores.min()) if len(cov_scores) else 0.0
        if scores[0] < 0.75 * min_cov:
            get_logger("eorb.loop").warning(
                "cand REJECT-minscore q=%d c=%d score=%.3f min_cov=%.3f",
                query, int(idx[0]), float(scores[0]), min_cov)
            return None, 0.0
        return int(idx[0]), float(scores[0])

    def verify(self, m: ms.MapState, query: int, cand: int):
        """Descriptor-match the two KFs' landmark-bearing features and run
        Sim3 RANSAC on the paired 3D points (DetectCommonRegionsFromBoW +
        Sim3Solver::iterate)."""
        vq = m.kf_feat_valid[query] & (m.kf_feat_lm[query] >= 0)
        vc = m.kf_feat_valid[cand] & (m.kf_feat_lm[cand] >= 0)
        j, _ = matching.match_nnratio(m.kf_desc_pm1[query], vq, m.kf_desc_pm1[cand],
                                      vc, nn_ratio=self.nn_ratio)
        lm_q = m.kf_feat_lm[query]
        lm_c = m.kf_feat_lm[cand][torch.clamp(j, min=0).long()]
        valid = vq & (j >= 0)
        p1 = lie.se3_apply(m.kf_T[query], m.lm_pos[torch.clamp(lm_q, min=0).long()])
        p2 = lie.se3_apply(m.kf_T[cand], m.lm_pos[torch.clamp(lm_c, min=0).long()])
        res = sim3_solver.sim3_ransac(
            p1, p2, valid, self.generator,
            px_threshold=torch.full((p1.shape[0],), 9.21, device=p1.device),
            cam_params1=self.cam, cam_params2=self.cam,
        )
        return res, valid

    # ------------------------------------------------------------ correction

    def correct(self, m: ms.MapState, query: int, cand: int,
                res: sim3_solver.Sim3RansacResult,
                run_gba: bool = True, order=None):
        """Build the essential graph, apply the loop constraint, optimize,
        and propagate the corrections to keyframes and landmarks.

        `order`: active keyframe slots in temporal order (slots are reused
        after culling, so slot order is not insertion order)."""
        K = m.K
        dev = m.kf_T.device
        kf_valid = m.kf_valid.cpu().numpy()
        R0, t0 = m.kf_T[:, :3, :3], m.kf_T[:, :3, 3]
        s0 = torch.ones(K, dtype=torch.float32, device=dev)

        # edges (host-assembled, fixed capacity): the sequential spanning
        # chain, strong covisibility edges (strongest first), the loop edge
        C = covisibility.shared_counts(m).cpu().numpy()
        ei, ej = [], []
        valid_slots = (np.asarray(order, np.int64) if order is not None
                       else np.flatnonzero(kf_valid))
        for a, b in zip(valid_slots[:-1], valid_slots[1:]):
            ei.append(a)
            ej.append(b)
        strong = np.argwhere(np.triu(C, 1) >= 100)
        if len(strong):
            strong = strong[np.argsort(-C[strong[:, 0], strong[:, 1]])]
        room = self.max_edges - len(ei) - 1
        if len(strong) > room:
            get_logger("eorb.loop").warning(
                "essential graph: dropping %d weakest covisibility edges "
                "(capacity %d)", len(strong) - room, self.max_edges)
        for a, b in strong[:room]:
            ei.append(a)
            ej.append(b)
        E = self.max_edges
        edge_i = np.zeros(E, np.int32)
        edge_j = np.zeros(E, np.int32)
        edge_w = np.zeros(E, np.float32)
        n = min(len(ei), E - 1)
        edge_i[:n], edge_j[:n], edge_w[:n] = ei[:n], ej[:n], 1.0
        # loop edge with the RANSAC-measured relative Sim3: S_cand<-query
        edge_i[n], edge_j[n], edge_w[n] = query, cand, 1.0
        ei_t = torch.from_numpy(edge_i).to(dev)
        ej_t = torch.from_numpy(edge_j).to(dev)
        eR, et, es = pose_graph.relative_sim3(
            R0[ei_t.long()], t0[ei_t.long()], s0[ei_t.long()],
            R0[ej_t.long()], t0[ej_t.long()], s0[ej_t.long()])
        eR, et, es = eR.clone(), et.clone(), es.clone()
        eR[n], et[n], es[n] = res.R, res.t, res.s

        fixed = np.zeros(K, bool)
        fixed[cand] = True  # hold the loop KF (the reference fixes pLoopKF)
        g = pose_graph.PoseGraph(
            R=R0, t=t0, s=s0, kf_valid=m.kf_valid,
            fixed=torch.from_numpy(fixed).to(dev),
            edge_i=ei_t, edge_j=ej_t, edge_R=eR, edge_t=et, edge_s=es,
            edge_w=torch.from_numpy(edge_w).to(dev),
        )
        g_opt = pose_graph.optimize_pose_graph(g, iters=15, chart="sim3")
        lm_new = pose_graph.correct_landmarks(
            m.lm_pos, torch.clamp(m.lm_first_kf, min=0), m.lm_valid,
            g.R, g.t, g.s, g_opt.R, g_opt.t, g_opt.s)
        # Sim3 -> SE3: Tcw = [R | t/s] (essential-graph pose recovery)
        T_new = lie.se3(g_opt.R, g_opt.t / g_opt.s[:, None])
        T_new = torch.where(m.kf_valid[:, None, None], T_new, m.kf_T)
        m = m._replace(kf_T=T_new, lm_pos=lm_new)

        # SearchAndFuse across the weld: under the corrected poses the loop
        # revealed duplicated structure; merge it between the two sides'
        # best covisible groups
        n_fused = 0
        q_group = [query] + [int(s) for s in np.argsort(-C[query])[:2]
                             if C[query][s] >= 15]
        c_group = [cand] + [int(s) for s in np.argsort(-C[cand])[:2]
                            if C[cand][s] >= 15]
        for a in q_group:
            for b in c_group:
                if a == b:
                    continue
                m, nf = local_mapping.fuse_duplicates(m, self.cam, a, b, search_px=6.0)
                n_fused += int(nf)
        self.last_fuse_count = n_fused

        if run_gba:
            m, _, _ = local_mapping.local_ba(
                m, self.cam, kf_free=m.kf_valid & ~torch.from_numpy(fixed).to(dev),
                iters=10)
        return m

    def _consistent(self, m: ms.MapState, cand: int) -> bool:
        """Advance the temporal-consistency chains with this candidate's
        covisibility group; True once a chain reaches the required length."""
        C = covisibility.shared_counts(m).cpu().numpy()
        group = set(np.flatnonzero(C[cand] >= 15).tolist()) | {cand}
        hit = 1
        for g, c in self._chains:
            if g & group:
                hit = max(hit, c + 1)
        self._chains = ([(group, hit)]
                        + [(g, c) for g, c in self._chains[:4] if not (g & group)])
        return hit >= self.consistency_required

    def detect_and_correct(self, m: ms.MapState, query: int,
                           run_gba: bool = True, order=None):
        log = get_logger("eorb.loop")
        if self._kf_count - self._last_loop_kfc < self.cooldown_kfs:
            return m, LoopInfo(False, query, -1, 0, 1.0)
        cand, score = self.detect(m, query)
        if cand is None:
            self._chains = []
            return m, LoopInfo(False, query, -1, 0, 1.0)
        if not self._consistent(m, cand):
            log.warning("cand REJECT-chain q=%d c=%d", query, cand)
            return m, LoopInfo(False, query, cand, 0, 1.0)
        res, _ = self.verify(m, query, cand)
        n_inl = int(res.n_inliers)
        if n_inl < self.min_inliers:
            log.warning("cand REJECT-sim3 q=%d c=%d inl=%d", query, cand, n_inl)
            return m, LoopInfo(False, query, cand, n_inl, 1.0)
        # second gate: projection verification through the measured Sim3
        n_proj = int(_projection_verify(
            self.cam, m.kf_T[cand], m.kf_T[query],
            m.kf_feat_lm[cand], m.kf_feat_valid[cand], m.kf_desc_pm1[cand],
            m.lm_pos, m.lm_desc_pm1,
            m.kf_xy[query], m.kf_desc_pm1[query], m.kf_feat_valid[query],
            res.R, res.t, res.s, float(self.img_w), float(self.img_h),
        ))
        if n_proj < self.proj_verify_min:
            log.warning("cand REJECT-proj q=%d c=%d inl=%d proj=%d",
                        query, cand, n_inl, n_proj)
            return m, LoopInfo(False, query, cand, n_inl, 1.0)
        # correction-necessity gate: a Sim3 that agrees with the current
        # relative estimate carries no correction and is not welded
        T_qc = (m.kf_T[cand] @ lie.se3_inv(m.kf_T[query])).cpu().numpy()
        R_m, t_m, s_m = (x.cpu().numpy() for x in (res.R, res.t, res.s))
        kf_valid = m.kf_valid.cpu().numpy()
        kf_ts = m.kf_ts.cpu().numpy()          # float32, as the reference
        kf_T = m.kf_T.cpu().numpy()
        dR = R_m @ T_qc[:3, :3].T
        ang = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        dt = float(np.linalg.norm(t_m - T_qc[:3, 3]))
        t_mag = max(float(np.linalg.norm(T_qc[:3, 3])), 1e-6)
        ds = abs(float(np.log(max(float(s_m), 1e-6))))
        consistent = (ang < np.deg2rad(3.0) and dt < max(0.05, 0.10 * t_mag)
                      and ds < 0.05)
        # drift-plausibility gate: a genuine loop's correction is bounded by
        # the drift over the path between the two keyframes
        ts_q, ts_c = float(kf_ts[query]), float(kf_ts[cand])
        lo, hi = min(ts_c, ts_q), max(ts_c, ts_q)
        between = np.flatnonzero(kf_valid & (kf_ts >= lo) & (kf_ts <= hi))
        between = between[np.argsort(kf_ts[between])]
        path = 0.0
        if len(between) >= 2:
            R = kf_T[between, :3, :3]
            t = kf_T[between, :3, 3]
            centres = -np.einsum("kji,kj->ki", R, t)   # camera centres -R^T t
            path = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
        implausible = dt > max(0.05, 0.25 * path)
        log.warning(
            "loop %s q=%d(ts %.2f) c=%d(ts %.2f) inl=%d ang=%.2fdeg "
            "dt=%.3f tmag=%.3f path=%.3f ds=%.3f s=%.3f",
            ("SKIP-consistent" if consistent else
             "REJECT-implausible" if implausible else "WELD"),
            query, ts_q, cand, ts_c, n_inl, np.rad2deg(ang), dt, t_mag,
            path, ds, float(s_m))
        if consistent or implausible:
            return m, LoopInfo(False, query, cand, n_inl, float(s_m))
        self._chains = []
        m = self.correct(m, query, cand, res, run_gba=run_gba, order=order)
        self._last_loop_kfc = self._kf_count
        return m, LoopInfo(True, query, cand, n_inl, float(s_m))
