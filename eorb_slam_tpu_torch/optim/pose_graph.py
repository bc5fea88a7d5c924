"""Essential-graph (pose-graph) optimization over Sim3 / SE3 / 4-DoF.

PyTorch port of ``eorb_slam_tpu/optim/pose_graph.py`` (reference
OptimizeEssentialGraph, its 6-DoF merge variant and
OptimizeEssentialGraph4DoF: g2o LM over relative-pose edges).

Fixed-capacity edge arrays (edge_i, edge_j, measured relative Sim3, weight)
and one masked Gauss-Newton engine. Vertices are world->camera Sim3s
(R,t,s); the update is a left-multiplicative tangent step exp(xi) . S in
one of three charts:
  - 'sim3': xi in R^7 (rho, phi, sigma)              -- mono loop closing
  - 'se3' : xi in R^7 with the sigma column zeroed  -- stereo/RGBD/merges
  - '4dof': xi = (tx,ty,tz,yaw), world-z yaw only    -- visual-inertial
The residual per edge is [t_err, so3_log(R_err), log(s_err)] of
S_err = S_meas_ji * (S_j S_i^-1)^-1. K is small, so the normal equations
are one dense (nK,nK) solve; the Jacobian is ``torch.func.jacfwd`` of the
whole stacked residual, as the reference takes ``jax.jacfwd``. The
iterations are a Python loop of fixed length with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch.geometry import lie


class PoseGraph(NamedTuple):
    # vertices: world->camera Sim3 per KF slot
    R: torch.Tensor          # (K,3,3)
    t: torch.Tensor          # (K,3)
    s: torch.Tensor          # (K,)
    kf_valid: torch.Tensor   # (K,) bool
    fixed: torch.Tensor      # (K,) bool -- held constant (loop origin KF)
    # edges: measured S_ji (maps cam_i -> cam_j), fixed capacity E
    edge_i: torch.Tensor     # (E,) int32
    edge_j: torch.Tensor     # (E,) int32
    edge_R: torch.Tensor     # (E,3,3)
    edge_t: torch.Tensor     # (E,3)
    edge_s: torch.Tensor     # (E,)
    edge_w: torch.Tensor     # (E,) weight (0 = invalid)


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """S_ji = S_j * S_i^-1 for world->cam Sim3s."""
    Rii, tii, sii = lie.sim3_inv(Ri, ti, si)
    return lie.sim3_mul(Rj, tj, sj, Rii, tii, sii)


def _edge_residuals(g: PoseGraph, R, t, s):
    ei, ej = g.edge_i.long(), g.edge_j.long()
    Rji, tji, sji = relative_sim3(R[ei], t[ei], s[ei], R[ej], t[ej], s[ej])
    # S_err = S_meas * S_ji^-1  (identity when estimate matches measurement)
    Rinv, tinv, sinv = lie.sim3_inv(Rji, tji, sji)
    Re, te, se = lie.sim3_mul(g.edge_R, g.edge_t, g.edge_s, Rinv, tinv, sinv)
    r = torch.cat([te, lie.so3_log(Re), torch.log(se)[..., None]], dim=-1)
    return r * g.edge_w[:, None]                                  # (E,7)


def _apply_delta(xi, R0, t0, s0, chart: str):
    """exp(xi) . S for the chart's (K,n) tangent."""
    if chart == "se3":
        xi = torch.cat([xi[:, :6], torch.zeros_like(xi[:, 6:])], dim=-1)
    elif chart == "4dof":
        # (tx,ty,tz, yaw): rotate about world z only, no scale
        z = torch.zeros_like(xi[:, 3:4])
        xi = torch.cat([xi[:, :3], z, z, xi[:, 3:4], z], dim=-1)
    dR, dt, ds = lie.sim3_exp(xi)
    return lie.sim3_mul(dR, dt, ds, R0, t0, s0)


def optimize_pose_graph(g: PoseGraph, iters: int = 20, chart: str = "sim3",
                        damping: float = 1e-6) -> PoseGraph:
    """Masked GN over the whole graph. Returns the graph with updated
    vertices (edges unchanged)."""
    K = g.R.shape[0]
    n_param = 4 if chart == "4dof" else 7
    free = g.kf_valid & ~g.fixed                                   # (K,)
    free_cols = free.repeat_interleave(n_param)                    # (K*n,)
    eye = torch.eye(K * n_param, dtype=g.t.dtype, device=g.t.device)
    pin = free_cols[:, None] & free_cols[None, :]
    R, t, s = g.R, g.t, g.s
    for _ in range(iters):
        def res_of(xi_flat, R=R, t=t, s=s):
            Rn, tn, sn = _apply_delta(xi_flat.reshape(K, n_param), R, t, s, chart)
            return _edge_residuals(g, Rn, tn, sn).reshape(-1)

        xi0 = torch.zeros(K * n_param, dtype=t.dtype, device=t.device)
        J = torch.func.jacfwd(res_of)(xi0)                         # (7E, K*n)
        r = res_of(xi0)
        J = J * free_cols[None, :]
        # fixed/invalid rows pinned to identity so the solve stays well-posed
        H = torch.where(pin, J.T @ J + damping * eye, eye)
        b = -(J.T @ r) * free_cols
        dx, info = torch.linalg.solve_ex(H, b)
        dx = torch.where(info != 0, torch.nan, dx).reshape(K, n_param)
        Rn, tn, sn = _apply_delta(dx, R, t, s, chart)
        Rn = lie.project_so3(Rn)
        R = torch.where(free[:, None, None], Rn, R)
        t = torch.where(free[:, None], tn, t)
        s = torch.where(free, sn, s)
    return g._replace(R=R, t=t, s=s)


def correct_landmarks(
    lm_pos: torch.Tensor,      # (M,3) world positions
    lm_ref_kf: torch.Tensor,   # (M,) reference KF per landmark
    lm_valid: torch.Tensor,
    R_old, t_old, s_old,       # (K,...) pre-correction Scw
    R_new, t_new, s_new,       # (K,...) post-correction Scw
) -> torch.Tensor:
    """Propagate pose-graph corrections to landmarks through their reference
    keyframe: x' = S_new_wc(S_old_cw(x)) (CorrectLoop's map-point update)."""
    k = lm_ref_kf.long()
    p_cam = lie.sim3_apply(R_old[k], t_old[k], s_old[k], lm_pos)
    Rni, tni, sni = lie.sim3_inv(R_new[k], t_new[k], s_new[k])
    p_new = lie.sim3_apply(Rni, tni, sni, p_cam)
    return torch.where(lm_valid[:, None], p_new, lm_pos)
