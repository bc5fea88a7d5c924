"""Schur marginalization tools and the marginalized pose-IMU prior.

PyTorch port of ``eorb_slam_tpu/optim/marginalize.py`` (reference
``Optimizer::Marginalize`` / ``Condition`` / ``Sparsify`` and the
``ConstraintPoseImu`` / ``EdgePriorPoseImu`` prior of
``Optimizer::PoseInertialOptimizationLastFrame``).

The Schur tools work on a dense (N,N) information matrix with fixed block
bounds. ``pose_inertial_optimization_last_frame`` is the two-frame
estimator: [last frame 15-dof | current frame 15-dof] with the prior on the
last frame, then the last frame Schur-marginalized out of the final Hessian
to give the next frame's prior. Its Jacobian is ``torch.func.jacfwd`` of the
residual function, as JAX's is ``jax.jacfwd`` (a single pose goes through
the Lie functions as a batch of one, see optim/inertial.py); the prior's
square-root information depends on the prior alone and is formed once per
call.

Degenerate decompositions give NaN, as in JAX, through
``optim/linalg.eigh_or_nan`` and ``pinv_sym``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.imu.preintegration import _mv
from eorb_slam_tpu_torch.optim import inertial, linalg, robust


def marginalize(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Marginalize block [start, end] (inclusive) out of information matrix
    H; the result keeps H's shape with the marginalized rows/cols zeroed."""
    n = H.shape[0]
    keep = torch.cat([torch.arange(0, start, device=H.device),
                      torch.arange(end + 1, n, device=H.device)])
    marg = torch.arange(start, end + 1, device=H.device)
    Hkk = H[keep][:, keep]
    Hkm = H[keep][:, marg]
    Hmm = H[marg][:, marg]
    Hs = Hkk - Hkm @ linalg.pinv_sym(Hmm) @ Hkm.T
    out = torch.zeros_like(H)
    out[keep[:, None], keep[None, :]] = Hs
    return out


def condition(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Zero rows/cols of block [start, end] (condition on its value)."""
    i = torch.arange(H.shape[0], device=H.device)
    on = ((i < start) | (i > end)).to(H.dtype)
    return H * on[:, None] * on[None, :]


def sparsify(H: torch.Tensor, start1: int, end1: int,
             start2: int, end2: int) -> torch.Tensor:
    """Remove the information link between blocks 1 and 2:
    H' = Hac + Hbc - Hc."""
    Hac = marginalize(H, start2, end2)
    Hbc = marginalize(H, start1, end1)
    Hc = marginalize(Hac, start1, end1)
    return Hac + Hbc - Hc


class PoseImuPrior(NamedTuple):
    """Marginal prior on one frame's 15-dof VI state: linearization point +
    information matrix. State order: [se3(6), vel(3), bg(3), ba(3)]."""

    Tcw: torch.Tensor   # (4,4)
    vel: torch.Tensor   # (3,)
    bg: torch.Tensor    # (3,)
    ba: torch.Tensor    # (3,)
    H: torch.Tensor     # (15,15) information


def _sqrt_info(H: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root via eigh (a marginalized information matrix
    can be rank-deficient, where Cholesky would fail)."""
    w, V = linalg.eigh_or_nan(0.5 * (H + H.transpose(-1, -2)))
    w = torch.clamp(w, min=0.0)
    return (V * torch.sqrt(w)[..., None, :]) @ V.transpose(-1, -2)


def prior_residual(prior: PoseImuPrior, Tcw: torch.Tensor, vel: torch.Tensor,
                   bg: torch.Tensor, ba: torch.Tensor,
                   sqrt_info: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whitened 15-dim prior residual sqrt(H) @ [log(T Tcw_prior^-1), dv,
    dbg, dba] (EdgePriorPoseImu::computeError). ``sqrt_info`` is
    ``_sqrt_info(prior.H)`` when already known."""
    dT = Tcw @ lie.se3_inv(prior.Tcw)
    r = torch.cat([lie.se3_log(dT[None])[0], vel - prior.vel, bg - prior.bg, ba - prior.ba])
    if sqrt_info is None:
        sqrt_info = _sqrt_info(prior.H)
    return _mv(sqrt_info, r)


def identity_prior(Tcw: torch.Tensor, vel: torch.Tensor, bg: torch.Tensor,
                   ba: torch.Tensor, weight: float = 1e2) -> PoseImuPrior:
    """Cold-start prior: a scaled identity information."""
    return PoseImuPrior(Tcw, vel, bg, ba,
                        torch.eye(15, dtype=Tcw.dtype, device=Tcw.device) * weight)


# the 4 re-weighting rounds' chi2 gates (JAX makes them an f32 array; a
# Python float meets a float32 tensor as the same f32 value)
_GATES = (robust.CHI2_MONO * 4, robust.CHI2_MONO * 2, robust.CHI2_MONO,
          robust.CHI2_MONO)


def _solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LU solve without reading the error flag back (NaN/inf rows where H
    is singular, as JAX's solve)."""
    return torch.linalg.solve_ex(H, b)[0]


def pose_inertial_optimization_last_frame(
    cam_params: torch.Tensor,
    Tcw0: torch.Tensor, vel0: torch.Tensor,
    bg0: torch.Tensor, ba0: torch.Tensor,
    pts_w: torch.Tensor, uv_obs: torch.Tensor,
    inv_sigma: torch.Tensor, obs_valid: torch.Tensor,
    prior: PoseImuPrior,
    pre: pre_mod.Preintegrated,
    Tbc: torch.Tensor,
    g: Optional[torch.Tensor] = None,
    iters: int = 10,
):
    """Motion-only VI optimization of [last frame | current frame] with a
    marginalized prior on the last frame; the last frame is then Schur-
    marginalized out of the final Hessian to produce the next prior.

    Returns (Tcw, vel, bg, ba, inlier, n_inliers, next_prior)."""
    dtype, dev = Tcw0.dtype, Tcw0.device
    if g is None:
        g = pre_mod.gravity_w(Tcw0)
    L_in = inertial.floored_info_chol(pre.C[:9, :9])
    S_prior = _sqrt_info(prior.H)
    I30 = torch.eye(30, dtype=dtype, device=dev)

    def residuals(theta, TcwL, velL, bgL, baL, Tcw, vel, bg, ba, w_obs):
        # theta: [last 15 | current 15]
        TL = inertial.se3_exp_b(theta[:6]) @ TcwL
        vL = velL + theta[6:9]
        bgL2 = bgL + theta[9:12]
        baL2 = baL + theta[12:15]
        T = inertial.se3_exp_b(theta[15:21]) @ Tcw
        v = vel + theta[21:24]
        bgc = bg + theta[24:27]
        bac = ba + theta[27:30]
        pc = lie.se3_apply(T, pts_w)
        uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
        r_vis = (uv_obs - uv_hat) * inv_sigma[..., None] * w_obs[..., None]
        TwbL = pre_mod.Twb_from_Tcw(TL, Tbc)
        Twb = pre_mod.Twb_from_Tcw(T, Tbc)
        r_in = inertial.whitened_inertial_residual(
            TwbL[:3, :3], TwbL[:3, 3], vL, bgL2, baL2,
            Twb[:3, :3], Twb[:3, 3], v, pre, g, L=L_in,
        )
        # gyro/acc bias random walk between the two frames
        r_rw = torch.cat([(bgc - bgL2) * 1e2, (bac - baL2) * 1e1])
        r_pr = prior_residual(prior, TL, vL, bgL2, baL2, sqrt_info=S_prior)
        r = torch.cat([r_vis.reshape(-1), r_in, r_rw, r_pr])
        return r, r

    jac = torch.func.jacfwd(residuals, has_aux=True)
    z = torch.zeros(30, dtype=dtype, device=dev)
    st = (prior.Tcw, prior.vel, prior.bg, prior.ba, Tcw0, vel0, bg0, ba0)
    for chi2_th in _GATES:
        Tcw = st[4]
        pc = lie.se3_apply(Tcw, pts_w)
        uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
        r = (uv_obs - uv_hat) * inv_sigma[..., None]
        chi2 = torch.sum(r * r, dim=-1)
        w_rob = torch.sqrt(robust.huber_weight(chi2, chi2_th))
        w_obs = w_rob * (obs_valid & (pc[..., 2] > 0)).to(dtype)
        for _ in range(iters // 4 + 1):
            TcwL, velL, bgL, baL, Tcw, vel, bg, ba = st
            J, r0 = jac(z, *st, w_obs)
            dx = _solve(J.T @ J + I30 * 1e-6, -J.T @ r0)
            st = (lie.se3_project(lie.se3_exp(dx[:6]) @ TcwL), velL + dx[6:9],
                  bgL + dx[9:12], baL + dx[12:15],
                  lie.se3_project(lie.se3_exp(dx[15:21]) @ Tcw), vel + dx[21:24],
                  bg + dx[24:27], ba + dx[27:30])
    TcwL, velL, bgL, baL, Tcw, vel, bg, ba = st

    # final Hessian at the solution, last frame marginalized out -> new prior
    pc = lie.se3_apply(Tcw, pts_w)
    uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
    chi2 = torch.sum(((uv_obs - uv_hat) * inv_sigma[..., None]) ** 2, dim=-1)
    inlier = obs_valid & (pc[..., 2] > 0) & (chi2 <= robust.CHI2_MONO)
    w_obs = torch.sqrt(robust.huber_weight(chi2, robust.CHI2_MONO)) * inlier.to(dtype)
    J, _ = jac(z, *st, w_obs)
    Hm = marginalize(J.T @ J, 0, 14)
    next_prior = PoseImuPrior(Tcw, vel, bg, ba, Hm[15:, 15:])
    return (Tcw, vel, bg, ba, inlier, inlier.sum(dtype=torch.int32), next_prior)
