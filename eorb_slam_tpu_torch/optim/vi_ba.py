"""Visual-inertial bundle adjustment: 15-dof states, Schur landmarks.

PyTorch port of ``eorb_slam_tpu/optim/vi_ba.py`` (reference
``Optimizer::{LocalInertialBA, FullInertialBA}``): each keyframe state is
(pose 6, velocity 3, gyro bias 3, acc bias 3); landmarks are Schur-
eliminated exactly as in the visual engine (optim/schur_ba.py, whose
reduced (K,K,6,6) camera system embeds into the pose block of the
(K,K,15,15) VI system); 9-dim preintegration factors and bias random-walk
factors couple consecutive keyframes.

Jacobians: the visual part is analytic (shared with schur_ba); each
inertial edge's Jacobian over the 30 perturbation dofs of its two endpoint
states is forward-mode autodiff, as in the JAX package (``jax.jacfwd``
under ``jax.vmap`` over the edges). Here the edge residual is written for a
leading edge dimension and ``torch.func.jacfwd`` differentiates all edges
at once with respect to ONE (15,) perturbation per endpoint, shared by
every edge: edge k depends only on its own endpoints, so row block k of
that Jacobian is edge k's own. The per-edge whitening factors depend on the
preintegrations alone and are formed once per call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.imu.preintegration import _mv
from eorb_slam_tpu_torch.optim import inertial, linalg, robust, schur_ba
from eorb_slam_tpu_torch.optim.marginalize import _GATES, _solve


class VIBAProblem(NamedTuple):
    visual: schur_ba.BAProblem           # poses in kf_T are Tcw
    Tbc: torch.Tensor                    # (4,4)
    kf_vel: torch.Tensor                 # (K,3) body velocity per KF
    kf_bg: torch.Tensor                  # (K,3)
    kf_ba: torch.Tensor                  # (K,3)
    pre: pre_mod.Preintegrated           # batched (K,...); slot k: prev[k] -> k
    edge_valid: torch.Tensor             # (K,) bool
    g: torch.Tensor                      # (3,) gravity in world
    # temporal predecessor slot per keyframe (-1 = none); None = arange-1
    # (slots are reused after keyframe culling: the chain is explicit)
    prev: Optional[torch.Tensor] = None


class VIBAResult(NamedTuple):
    kf_T: torch.Tensor
    kf_vel: torch.Tensor
    kf_bg: torch.Tensor
    kf_ba: torch.Tensor
    lm_pos: torch.Tensor
    obs_inlier: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor


class _Edges(NamedTuple):
    """Per-edge constants: endpoint slots and whitening factors."""

    k: torch.Tensor       # (K,) newer endpoint
    a: torch.Tensor       # (K,) older endpoint (clamped predecessor)
    w: torch.Tensor       # (K,) 1 for a live edge, else 0
    L_in: torch.Tensor    # (K,9,9) floored_info_chol of the 9x9 block
    L_rw: torch.Tensor    # (K,6,6) Cholesky of the walk block's information


def _edges(p: VIBAProblem) -> _Edges:
    K = p.visual.kf_T.shape[0]
    dev = p.visual.kf_T.device
    ks = torch.arange(K, device=dev)
    prev = ks - 1 if p.prev is None else p.prev.to(torch.int64)
    Cw = p.pre.C[:, 9:15, 9:15] + torch.eye(6, dtype=p.pre.C.dtype, device=dev) * 1e-12
    return _Edges(ks, torch.clamp(prev, min=0),
                  (p.edge_valid & (prev >= 0)).to(p.visual.kf_T.dtype),
                  inertial.floored_info_chol(p.pre.C[:, :9, :9]),
                  inertial.chol_of_inverse(Cw))


def _edge_residual(T1, T2, v1, v2, bg1, ba1, pre, L_in, Tbc, g, dx1, dx2):
    """Whitened inertial residual of an edge (a -> k) with perturbations
    dx = (xi 6, dv 3, dbg 3, dba 3) applied on each endpoint; the pose
    perturbation is left-multiplicative on Tcw, as in schur_ba, so the
    assembled blocks share one coordinate system. Batched over leading
    dims."""
    T1 = inertial.se3_exp_b(dx1[..., :6]) @ T1
    T2 = inertial.se3_exp_b(dx2[..., :6]) @ T2
    Twb1 = pre_mod.Twb_from_Tcw(T1, Tbc)
    Twb2 = pre_mod.Twb_from_Tcw(T2, Tbc)
    return inertial.whitened_inertial_residual(
        Twb1[..., :3, :3], Twb1[..., :3, 3], v1 + dx1[..., 6:9],
        bg1 + dx1[..., 9:12], ba1 + dx1[..., 12:15],
        Twb2[..., :3, :3], Twb2[..., :3, 3], v2 + dx2[..., 6:9], pre, g, L=L_in,
    )


def _bias_rw_residual(bg1, ba1, bg2, ba2, L_rw, dx1, dx2):
    """Whitened bias random-walk residuals (EdgeGyroRW/EdgeAccRW); the
    information comes from the preintegration's walk block."""
    dbg = (bg2 + dx2[..., 9:12]) - (bg1 + dx1[..., 9:12])
    dba = (ba2 + dx2[..., 12:15]) - (ba1 + dx1[..., 12:15])
    return _mv(L_rw.transpose(-1, -2), torch.cat([dbg, dba], -1))


def _residual_fn(dx1, dx2, T1, T2, v1, v2, bg1, ba1, bg2, ba2, pre, L_in, L_rw,
                 Tbc, g):
    return torch.cat([
        _edge_residual(T1, T2, v1, v2, bg1, ba1, pre, L_in, Tbc, g, dx1, dx2),
        _bias_rw_residual(bg1, ba1, bg2, ba2, L_rw, dx1, dx2),
    ], -1)


def _edge_args(p: VIBAProblem, e: _Edges, kf_T, kf_vel, kf_bg, kf_ba):
    a = e.a
    return (kf_T[a], kf_T, kf_vel[a], kf_vel, kf_bg[a], kf_ba[a], kf_bg, kf_ba,
            p.pre, e.L_in, e.L_rw)


def _inertial_cost(p: VIBAProblem, e: _Edges, kf_T, kf_vel, kf_bg, kf_ba):
    K = kf_T.shape[0]
    z = torch.zeros(K, 15, dtype=kf_T.dtype, device=kf_T.device)
    r = _residual_fn(z, z, *_edge_args(p, e, kf_T, kf_vel, kf_bg, kf_ba),
                     p.Tbc, p.g) * e.w[:, None]
    return torch.sum(r * r)


def _inertial_system(p: VIBAProblem, e: _Edges, kf_T, kf_vel, kf_bg, kf_ba):
    """H contributions (K,K,15,15) and rhs (K,15) of every inertial +
    bias-RW edge, and their total cost."""
    K = kf_T.shape[0]
    dtype = kf_T.dtype
    z = torch.zeros(15, dtype=dtype, device=kf_T.device)
    args = _edge_args(p, e, kf_T, kf_vel, kf_bg, kf_ba)

    def r_aux(d1, d2):
        r = _residual_fn(d1, d2, *args, p.Tbc, p.g)          # (K,15)
        return r, r

    (J1, J2), r = torch.func.jacfwd(r_aux, argnums=(0, 1), has_aux=True)(z, z)
    w = e.w
    r = r * w[:, None]
    J1 = J1 * w[:, None, None]
    J2 = J2 * w[:, None, None]

    # scatter by one-hot products (an accumulating index_put is
    # order-dependent on the card)
    eye = torch.eye(K, dtype=dtype, device=kf_T.device)
    Oa, Ok = eye[e.a], eye[e.k]                          # (edge, slot)

    def blk(Oi, Ji, Oj, Jj):
        JJ = torch.einsum("erx,ery->exy", Ji, Jj)
        return torch.einsum("ei,ej,exy->ijxy", Oi, Oj, JJ)

    H = blk(Oa, J1, Oa, J1) + blk(Oa, J1, Ok, J2) + blk(Ok, J2, Oa, J1) \
        + blk(Ok, J2, Ok, J2)
    b = -(torch.einsum("ei,erx,er->ix", Oa, J1, r)
          + torch.einsum("ei,erx,er->ix", Ok, J2, r))
    return H, b, torch.sum(r * r)


def _vi_cost(p: VIBAProblem, e: _Edges, kf_T, kf_vel, kf_bg, kf_ba, lm_pos):
    _, _, chi2, _, pc = schur_ba._residuals_and_weights(p.visual, kf_T, lm_pos, True)
    # cheirality violations score a large penalty under the STATIC validity
    # instead of vanishing from the sum
    pv = p.visual
    valid_static = pv.obs_valid & pv.lm_valid[:, None] & pv.kf_valid[pv.obs_kf.long()]
    c = robust.huber_cost(chi2, robust.CHI2_MONO)
    c = torch.where(pc[..., 2] > 0.0, c, 1e6)
    return torch.sum(c * valid_static) + _inertial_cost(p, e, kf_T, kf_vel, kf_bg, kf_ba)


def _vi_bundle_adjust(p: VIBAProblem, iters: int = 8,
                      lam0: float = 1e-4) -> VIBAResult:
    """Levenberg-Marquardt over poses, velocities, biases and (Schur-
    eliminated) landmarks; accept/reject and damping stay on the device."""
    kf_T = p.visual.kf_T
    dtype, dev = kf_T.dtype, kf_T.device
    K = kf_T.shape[0]
    e = _edges(p)
    I15 = torch.eye(15, dtype=dtype, device=dev)
    ar = torch.arange(K, device=dev)
    free = (p.visual.kf_valid & ~p.visual.kf_fixed).to(dtype)
    mask2 = free[:, None] * free[None, :]

    def build_and_solve(kf_T, kf_vel, kf_bg, kf_ba, lm_pos, lam):
        vis = p.visual._replace(kf_T=kf_T, lm_pos=lm_pos)
        S6, b6, Wf, Vinv, b_l = schur_ba._schur_pieces(vis, kf_T, lm_pos, lam, True)
        H, b, _ = _inertial_system(p, e, kf_T, kf_vel, kf_bg, kf_ba)
        H = H.clone()
        H[:, :, :6, :6] += S6
        b = b.clone()
        b[:, :6] += b6
        # damping + gauge masking (fixed/invalid states -> identity rows)
        diag_scale = torch.clamp(
            torch.diagonal(H[ar, ar], dim1=-2, dim2=-1).sum(-1)[:, None, None] / 15.0,
            min=1e-6)
        H[ar, ar] += lam * I15[None] * diag_scale
        H = H * mask2[:, :, None, None]
        H[ar, ar] += I15[None] * (1.0 - free)[:, None, None]
        b = b * free[:, None]
        Hd = H.permute(0, 2, 1, 3).reshape(K * 15, K * 15)
        dx = linalg.solve_spd_jacobi(Hd, b.reshape(-1)).reshape(K, 15) * free[:, None]
        dx_l = schur_ba._backsub_landmarks(vis, Wf, Vinv, b_l, dx[:, :6])
        return dx, dx_l

    kf_vel, kf_bg, kf_ba, lm_pos = p.kf_vel, p.kf_bg, p.kf_ba, p.visual.lm_pos
    lam = torch.full((), lam0, dtype=dtype, device=dev)
    cost0 = cost = _vi_cost(p, e, kf_T, kf_vel, kf_bg, kf_ba, lm_pos)
    for _ in range(iters):
        dx, dx_l = build_and_solve(kf_T, kf_vel, kf_bg, kf_ba, lm_pos, lam)
        kf_T_n = lie.se3_project(lie.se3_exp(dx[:, :6]) @ kf_T)
        vel_n = kf_vel + dx[:, 6:9]
        bg_n = kf_bg + dx[:, 9:12]
        ba_n = kf_ba + dx[:, 12:15]
        lm_n = lm_pos + dx_l
        c_n = _vi_cost(p, e, kf_T_n, vel_n, bg_n, ba_n, lm_n)
        acc = c_n < cost
        kf_T = torch.where(acc, kf_T_n, kf_T)
        kf_vel = torch.where(acc, vel_n, kf_vel)
        kf_bg = torch.where(acc, bg_n, kf_bg)
        kf_ba = torch.where(acc, ba_n, kf_ba)
        lm_pos = torch.where(acc, lm_n, lm_pos)
        lam = torch.where(acc, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e4))
        cost = torch.where(acc, c_n, cost)
    _, _, chi2f, validf, _ = schur_ba._residuals_and_weights(p.visual, kf_T, lm_pos, True)
    inlier = validf & (chi2f <= robust.CHI2_MONO)
    return VIBAResult(kf_T, kf_vel, kf_bg, kf_ba, lm_pos, inlier, cost0, cost)


# VI-BA as one dispatch, as the reference's jit with static iters: on the
# card one CUDA graph per key (the problem's shapes and the iterations)
vi_bundle_adjust = _graphs.GraphRunner(_vi_bundle_adjust, static=("iters", "lam0"))


def pose_inertial_optimization(
    cam_params: torch.Tensor,
    Tcw0: torch.Tensor,          # (4,4) current-frame pose init
    vel0: torch.Tensor, bg0: torch.Tensor, ba0: torch.Tensor,
    pts_w: torch.Tensor,         # (N,3) matched landmarks (fixed)
    uv_obs: torch.Tensor,        # (N,2)
    inv_sigma: torch.Tensor,     # (N,)
    obs_valid: torch.Tensor,     # (N,)
    Tcw_ref: torch.Tensor,       # (4,4) last KF pose (fixed)
    vel_ref: torch.Tensor,
    pre: pre_mod.Preintegrated,
    Tbc: torch.Tensor,
    g: Optional[torch.Tensor] = None,
    iters: int = 10,
    return_H: bool = False,
):
    """Motion-only VI optimization of the current frame's 15-dof state
    against fixed map points + one inertial factor to the reference frame
    (reference Optimizer::PoseInertialOptimizationLastKeyFrame). Returns
    (Tcw, vel, bg, ba, inlier, n_inliers), plus the final 15x15 information
    when ``return_H`` (it seeds the marginal PoseImuPrior)."""
    dtype, dev = Tcw0.dtype, Tcw0.device
    if g is None:
        g = pre_mod.gravity_w(Tcw0)
    Twb_ref = pre_mod.Twb_from_Tcw(Tcw_ref, Tbc)
    L_in = inertial.floored_info_chol(pre.C[:9, :9])
    I15 = torch.eye(15, dtype=dtype, device=dev)

    def residuals(theta, Tcw, vel, bg, ba, w_obs):
        T = inertial.se3_exp_b(theta[:6]) @ Tcw
        v = vel + theta[6:9]
        bgc = bg + theta[9:12]
        bac = ba + theta[12:15]
        pc = lie.se3_apply(T, pts_w)
        uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
        r_vis = (uv_obs - uv_hat) * inv_sigma[..., None] * w_obs[..., None]
        Twb = pre_mod.Twb_from_Tcw(T, Tbc)
        r_in = inertial.whitened_inertial_residual(
            Twb_ref[:3, :3], Twb_ref[:3, 3], vel_ref, bgc, bac,
            Twb[:3, :3], Twb[:3, 3], v, pre, g, L=L_in,
        )
        # soft prior keeping biases near their propagated values
        r_b = torch.cat([(bgc - bg0) * 1e2, (bac - ba0) * 1e1])
        r = torch.cat([r_vis.reshape(-1), r_in, r_b])
        return r, r

    jac = torch.func.jacfwd(residuals, has_aux=True)
    z = torch.zeros(15, dtype=dtype, device=dev)
    st = (Tcw0, vel0, bg0, ba0)
    # 4 re-weighting rounds with a shrinking chi2 gate
    for chi2_th in _GATES:
        pc = lie.se3_apply(st[0], pts_w)
        uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
        r = (uv_obs - uv_hat) * inv_sigma[..., None]
        chi2 = torch.sum(r * r, dim=-1)
        w_rob = torch.sqrt(robust.huber_weight(chi2, chi2_th))
        w_obs = w_rob * (obs_valid & (pc[..., 2] > 0)).to(dtype)
        for _ in range(iters // 4 + 1):
            Tcw, vel, bg, ba = st
            J, r0 = jac(z, *st, w_obs)
            dx = _solve(J.T @ J + I15 * 1e-6, -J.T @ r0)
            st = (lie.se3_project(lie.se3_exp(dx[:6]) @ Tcw), vel + dx[6:9],
                  bg + dx[9:12], ba + dx[12:15])
    Tcw, vel, bg, ba = st
    pc = lie.se3_apply(Tcw, pts_w)
    uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
    chi2 = torch.sum(((uv_obs - uv_hat) * inv_sigma[..., None]) ** 2, dim=-1)
    inlier = obs_valid & (pc[..., 2] > 0) & (chi2 <= robust.CHI2_MONO)
    out = (Tcw, vel, bg, ba, inlier, inlier.sum(dtype=torch.int32))
    if not return_H:
        return out
    w_obs = torch.sqrt(robust.huber_weight(chi2, robust.CHI2_MONO)) * inlier.to(dtype)
    J, _ = jac(z, *st, w_obs)
    return out + (J.T @ J,)
