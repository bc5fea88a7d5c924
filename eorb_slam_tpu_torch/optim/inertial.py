"""Inertial residuals + inertial-only initialization optimization.

PyTorch port of ``eorb_slam_tpu/optim/inertial.py``:
- ``inertial_residual`` = ``EdgeInertial`` (9-dim preintegration residual),
- ``linear_alignment`` = closed-form visual-inertial alignment (the seed),
- ``inertial_init`` = ``Optimizer::InertialOptimization`` (gravity
  direction, scale, biases, velocities with poses fixed), one damped GN
  over a packed parameter vector. Its Jacobian is ``torch.func.jacfwd`` of
  the residual function, as the JAX package takes ``jax.jacfwd``: the
  parameter count (3K+9) is small next to the residual work.

Both solves are jitted in the JAX package (``inertial_init`` with static
``iters`` and ``fix_scale``); here they are graph runners
(``_graphs.GraphRunner``) over ``_linear_alignment`` and
``_inertial_init``: on the card each key is captured once and replayed, one
dispatch per attempt. The init's priors are Python numbers and so part of
its key (the IMU init and the scale refinement are two keys); inside the
init's capture the linear alignment runs inline.

The residual functions are pure (no in-place writes, no reads to the host,
no Python branch on a tensor's value), so ``torch.func`` can transform them.
Every accept/reject of the LM loop stays on the device. Rotations and
medians are evaluated with at least one batch dimension: under
``torch.func.jvp``, arithmetic between a 0-dim tensor and a Python float
gives a float64 tangent (torch 2.x), which then fails in a float32 matmul.

All poses here are body-in-world (Rwb, pwb); camera poses convert with
imu.preintegration.Twb_from_Tcw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.imu.preintegration import _mv
from eorb_slam_tpu_torch.optim import linalg

# Measurement-noise floor added to the 9x9 preintegration covariance before
# whitening: the inertial residual contains VISUALLY-estimated poses whose
# errors (~1 mrad rotation, ~1 cm position, ~2 cm/s velocity) dwarf the raw
# IMU noise (see the JAX module for the measurement behind it).
_COV_FLOOR_DIAG = (1e-6, 4e-4, 1e-4)      # per (R, V, P) block of 3


def _block3(values, dtype, device) -> torch.Tensor:
    """The vector (v0,v0,v0, v1,v1,v1, ...), filled on the device."""
    return torch.cat([torch.full((3,), v, dtype=dtype, device=device) for v in values])


def chol_of_inverse(C: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L of inv(C), batched; NaN where C is singular or
    inv(C) is not positive definite (JAX's inverse and Cholesky give NaN
    there, torch's raise and read the error flag back to the host)."""
    inv, info = torch.linalg.inv_ex(C)
    L, info2 = torch.linalg.cholesky_ex(inv)
    bad = (info != 0) | (info2 != 0)
    return torch.where(bad[..., None, None], torch.nan, L)


def floored_info_chol(C9: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L of inv(C + floor); whitening is r -> L^T r."""
    floor = torch.diag(_block3(_COV_FLOOR_DIAG, C9.dtype, C9.device))
    return chol_of_inverse(0.5 * (C9 + C9.transpose(-1, -2)) + floor)


def se3_exp_b(xi: torch.Tensor) -> torch.Tensor:
    """``lie.se3_exp`` evaluated with at least one batch dimension (see the
    module docstring); same values."""
    return lie.se3_exp(xi.reshape(-1, 6)).reshape(xi.shape[:-1] + (4, 4))


def gravity_from_dir(rwg: torch.Tensor) -> torch.Tensor:
    """2-dof gravity direction: g = Rwg @ (0,0,-9.81), Rwg = Exp([a,b,0])
    (reference ``VertexGDir``)."""
    x = torch.cat([rwg, torch.zeros_like(rwg[..., :1])], -1)
    Rwg = lie.so3_exp(x.reshape(-1, 3)).reshape(x.shape[:-1] + (3, 3))
    return _mv(Rwg, pre_mod.gravity_w(rwg))


def inertial_residual(
    Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2,
    pre: pre_mod.Preintegrated, g: torch.Tensor, scale=1.0,
):
    """9-dim (er, ev, ep) residual of one preintegrated IMU factor (batched
    over leading dims). With ``scale`` != 1 this is ``EdgeInertialGS``."""
    if Rwb1.dim() == 2 and Rwb2.dim() == 2:      # one factor: batch of one
        one = [x[None] for x in (Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2)]
        pre1 = pre_mod.Preintegrated(*(f[None] for f in pre))
        return inertial_residual(*one, pre1, g, scale)[0]
    dR, dV, dP = pre_mod.delta_corrected(pre, bg, ba)
    t = pre.dt[..., None]
    R1T = Rwb1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ Rwb2)
    ev = _mv(R1T, scale * (vwb2 - vwb1) - g * t) - dV
    ep = _mv(R1T, scale * (pwb2 - pwb1 - vwb1 * t) - 0.5 * g * t * t) - dP
    return torch.cat([er, ev, ep], -1)


def whitened_inertial_residual(
    Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2, pre, g, scale=1.0, L=None,
):
    """``L^T r`` with L = floored_info_chol(pre.C[:9,:9]); pass ``L`` when it
    is already known (it depends on the preintegration alone)."""
    r = inertial_residual(Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2,
                          pre, g, scale)
    if L is None:
        L = floored_info_chol(pre.C[..., :9, :9])
    return _mv(L.transpose(-1, -2), r)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a vector, as shape (1,): the two
    middle values averaged for an even count (``jnp.nanmedian``); NaN when
    all are NaN. Built from sort and gather, so ``torch.func`` transforms
    it."""
    nan = torch.isnan(x)
    n = (~nan).sum(dim=0, keepdim=True)
    xs = torch.sort(torch.where(nan, torch.inf, x)).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=x.shape[0] - 1)
    med = 0.5 * xs[lo] + 0.5 * xs[hi]
    return torch.where(n > 0, med, torch.full_like(med, torch.nan))


def _pred(prev: Optional[torch.Tensor], K: int, device) -> torch.Tensor:
    if prev is None:
        return torch.arange(K, dtype=torch.int64, device=device) - 1
    return prev.to(torch.int64)


def _linear_alignment(
    Twb: torch.Tensor,                  # (K,4,4) body poses in vision frame
    pre_stack: pre_mod.Preintegrated,   # batched (K,...)
    edge_valid: torch.Tensor,           # (K,) bool
    prev: Optional[torch.Tensor] = None,  # (K,) temporal predecessor slot
):
    """Closed-form visual-inertial alignment (Martinelli-style). With
    w_k := s v_k the preintegrated deltas are LINEAR in (s, g, w_0..w_K-1):

      ev: Ra^T w_b - Ra^T w_a - t Ra^T g                  = dV
      ep: s Ra^T (p_b - p_a) - t Ra^T w_a - t^2/2 Ra^T g  = dP

    solved as masked normal equations with two IRLS re-weightings. Returns
    (s, g (3,), vel (K,3))."""
    K = Twb.shape[0]
    dtype, dev = Twb.dtype, Twb.device
    R = Twb[:, :3, :3]
    p = Twb[:, :3, 3]
    n_var = 4 + 3 * K
    prev = _pred(prev, K, dev)
    edge_valid = edge_valid & (prev >= 0)
    a = torch.clamp(prev, min=0)
    RaT = R[a].transpose(-1, -2)                               # (K,3,3)
    t = pre_stack.dt[:, None, None]
    dp = p - p[a]

    eye = torch.eye(K, dtype=dtype, device=dev)
    # w blocks: column 4 + 3*idx + j of row i holds Ra_T[i, j] at idx = a/k
    w_a = torch.einsum("kij,kl->kilj", RaT, eye[a]).reshape(K, 3, 3 * K)
    w_b = torch.einsum("kij,kl->kilj", RaT, eye).reshape(K, 3, 3 * K)
    zcol = torch.zeros(K, 3, 1, dtype=dtype, device=dev)
    A_ev = torch.cat([zcol, -t * RaT, w_b - w_a], -1)
    A_ep = torch.cat([_mv(RaT, dp)[..., None], -0.5 * t * t * RaT, -t * w_a], -1)
    w = edge_valid.to(dtype)
    A = torch.cat([A_ev, A_ep], 1) * w[:, None, None]          # (K,6,n_var)
    b = torch.cat([pre_stack.dV, pre_stack.dP], 1) * w[:, None]  # (K,6)

    I = torch.eye(n_var, dtype=dtype, device=dev)

    def solve(Aw, bw):
        Af = Aw.reshape(-1, n_var)
        bf = bw.reshape(-1)
        # tiny Tikhonov keeps unconstrained w_k (invalid slots) at zero;
        # Jacobi equilibration for the mixed column scales
        return linalg.solve_spd_jacobi(Af.T @ Af + I * 1e-6, Af.T @ bf)

    # IRLS: a single corrupted visual edge must not dominate the fit
    x = solve(A, b)
    for _ in range(2):
        r = torch.einsum("kij,j->ki", A, x) - b
        rn = torch.linalg.norm(r, dim=1)
        med = nanmedian(torch.where(edge_valid, rn, torch.nan))
        delta = 2.0 * torch.nan_to_num(med, nan=1.0) + 1e-6
        wr = torch.sqrt(torch.clamp(delta / torch.clamp(rn, min=1e-12), max=1.0))
        x = solve(A * wr[:, None, None], b * wr[:, None])
    s = x[0]
    g = x[1:4]
    vel = x[4:].reshape(K, 3) / torch.clamp(torch.abs(s), min=1e-6) * torch.sign(s)
    return s, g, vel


# the reference's @jax.jit linear_alignment: one graph per key on the card
linear_alignment = _graphs.GraphRunner(_linear_alignment)


class InertialInitResult(NamedTuple):
    vel: torch.Tensor     # (K,3) body velocities
    bg: torch.Tensor      # (3,)
    ba: torch.Tensor      # (3,)
    rwg: torch.Tensor     # (2,) gravity direction params
    g: torch.Tensor       # (3,) gravity in world
    scale: torch.Tensor   # ()
    cost0: torch.Tensor
    cost: torch.Tensor


def _inertial_init(
    Twb: torch.Tensor,                 # (K,4,4) body poses (fixed)
    pre_stack: pre_mod.Preintegrated,  # batched (K,...); slot k = prev[k] -> k
    edge_valid: torch.Tensor,          # (K,) bool
    prior_gyro: float = 1e2,
    prior_acc: float = 1e10,
    iters: int = 40,
    fix_scale: bool = False,
    prev: Optional[torch.Tensor] = None,
) -> InertialInitResult:
    """Estimate (velocities, biases, gravity dir, scale) with poses fixed,
    seeded by ``linear_alignment``. The reference stages its priors
    (priorG/priorA 1e2/1e10 -> 1/1e5 -> 0/0); the callers pass them."""
    K = Twb.shape[0]
    dtype, dev = Twb.dtype, Twb.device
    Rwb = Twb[:, :3, :3]
    pwb = Twb[:, :3, 3]
    prev = _pred(prev, K, dev)
    edge_valid = edge_valid & (prev >= 0)
    a = torch.clamp(prev, min=0)

    s_lin, g_lin, v0 = linear_alignment(Twb, pre_stack, edge_valid, prev)
    s_lin = torch.clamp(torch.abs(s_lin), 1e-3, 1e4)
    # gravity direction params from the linear g estimate
    g_dir = g_lin / torch.clamp(torch.linalg.norm(g_lin), min=1e-8)
    ez = pre_mod.gravity_w(g_dir) / pre_mod.GRAVITY
    axis = torch.linalg.cross(ez, g_dir)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.dot(ez, g_dir)
    ang = torch.atan2(sin_a, cos_a)
    axis = axis / torch.clamp(sin_a, min=1e-8)
    rwg0 = torch.where(sin_a > 1e-6, (axis * ang)[:2], 0.0)

    info_L = floored_info_chol(pre_stack.C[:, :9, :9])          # (K,9,9)
    info_LT = info_L.transpose(-1, -2)
    sq_prior = torch.sqrt(_block3((prior_gyro, prior_acc), dtype, dev))

    def residuals(theta):
        vel = theta[: 3 * K].reshape(K, 3)
        bg = theta[3 * K: 3 * K + 3]
        ba = theta[3 * K + 3: 3 * K + 6]
        rwg = theta[3 * K + 6: 3 * K + 8]
        s = torch.ones_like(theta[3 * K + 8]) if fix_scale else torch.exp(theta[3 * K + 8])
        g = gravity_from_dir(rwg)
        r = inertial_residual(Rwb[a], pwb[a], vel[a], bg, ba,
                              Rwb, pwb, vel, pre_stack, g, scale=s)
        r = _mv(info_LT, r) * edge_valid[:, None]               # (K,9)
        # robust kernel per edge, thresholded RELATIVE to the median edge
        # chi2 (an absolute gate would freeze the solve far from convergence)
        chi2 = torch.sum(r * r, dim=1)
        med = nanmedian(torch.where(edge_valid, chi2, torch.nan))
        gate = 9.0 * torch.nan_to_num(med, nan=1e6) + 1e-6
        w_rob = torch.sqrt(torch.clamp(gate / torch.clamp(chi2, min=1e-12), max=1.0))
        r = r * w_rob[:, None]
        return torch.cat([r.reshape(-1), sq_prior * theta[3 * K: 3 * K + 6]])

    def with_value(theta):
        r = residuals(theta)
        return r, r

    def cost(theta):
        r = residuals(theta)
        return torch.sum(r * r)

    theta = torch.cat([v0.reshape(-1), torch.zeros(6, dtype=dtype, device=dev),
                       rwg0, torch.log(s_lin)[None]])
    jac = torch.func.jacfwd(with_value, has_aux=True)
    lam = torch.full((), 1e-2, dtype=dtype, device=dev)
    c0 = c = cost(theta)
    for _ in range(iters):
        J, r = jac(theta)
        H = J.T @ J
        b = -J.T @ r
        d = torch.diagonal(H)
        dx = linalg.solve_spd_jacobi(H + torch.diag(lam * torch.clamp(d, min=1e-8)), b)
        theta_new = theta + dx
        c_new = cost(theta_new)
        accept = c_new < c
        theta = torch.where(accept, theta_new, theta)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e6))
        c = torch.where(accept, c_new, c)
    rwg = theta[3 * K + 6: 3 * K + 8]
    s = torch.ones_like(theta[3 * K + 8]) if fix_scale else torch.exp(theta[3 * K + 8])
    return InertialInitResult(
        vel=theta[: 3 * K].reshape(K, 3), bg=theta[3 * K: 3 * K + 3],
        ba=theta[3 * K + 3: 3 * K + 6], rwg=rwg, g=gravity_from_dir(rwg),
        scale=s, cost0=c0, cost=c,
    )


# the reference's jit with static iters and fix_scale, and the priors the
# port passes as Python numbers: on the card one graph per key (the IMU
# init and the scale refinement), the GN loop unrolled in it
inertial_init = _graphs.GraphRunner(
    _inertial_init, static=("prior_gyro", "prior_acc", "iters", "fix_scale"))


def apply_scaled_rotation(
    Twb: torch.Tensor, lm_pos: torch.Tensor, vel: torch.Tensor,
    Ryw: torch.Tensor, scale,
):
    """Gravity-align + rescale the map after IMU init (reference
    Map::ApplyScaledRotation): world' = Ryw @ world, positions scaled by
    ``scale``; body orientations rotated."""
    R2 = torch.einsum("ij,kjl->kil", Ryw, Twb[:, :3, :3])
    p2 = scale * torch.einsum("ij,kj->ki", Ryw, Twb[:, :3, 3])
    Twb2 = lie.se3(lie.project_so3(R2), p2)
    lm2 = scale * torch.einsum("ij,mj->mi", Ryw, lm_pos)
    vel2 = scale * torch.einsum("ij,kj->ki", Ryw, vel)
    return Twb2, lm2, vel2
