"""Masked Levenberg-Marquardt bundle adjustment with Schur landmark elimination.

PyTorch port of ``eorb_slam_tpu/optim/schur_ba.py`` (the test-only
``_schur_pieces_ref`` is not ported). Observations are landmark-major, a
fixed ``(M, P)`` table, so the Schur products are dense contractions:

  V_m     = sum_p  Jl^T W Jl                      (M,3,3)
  U_k     = sum over obs of camera k Jp^T W Jp    (K,6,6)
  S      -= Y W^T  scattered at (k_p,k_q)         (K,K,6,6)

and the reduced camera system is solved dense (6K x 6K). The per-
observation quantities keep the JAX package's flat ``(coeff, M*P)`` layout,
so both packages sum the same terms.

The sharded variant takes a ``torch.distributed`` process group where the
JAX package takes a ``shard_map`` axis name: each rank holds a block of the
landmark axis, and the reduced camera system and the cost are all-reduced
where JAX psums them (parallel/dist_ba.py). Without a group no collective
runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.geometry import camera as cam
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.optim import linalg, robust


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. K = pose slots, M = landmark slots,
    P = obs slots per landmark."""

    cam_params: torch.Tensor    # (9,) shared pinhole intrinsics (linear part)
    kf_T: torch.Tensor          # (K,4,4) Tcw
    kf_fixed: torch.Tensor      # (K,) bool — pose held constant
    kf_valid: torch.Tensor      # (K,) bool — slot in use
    lm_pos: torch.Tensor        # (M,3) world points
    lm_valid: torch.Tensor      # (M,) bool
    obs_kf: torch.Tensor        # (M,P) int pose index per observation
    obs_uv: torch.Tensor        # (M,P,2) undistorted pixel observations
    obs_inv_sigma: torch.Tensor  # (M,P) sqrt information (1/sigma_octave)
    obs_valid: torch.Tensor     # (M,P) bool


class BAResult(NamedTuple):
    kf_T: torch.Tensor
    lm_pos: torch.Tensor
    obs_inlier: torch.Tensor    # (M,P) bool — chi2 gate after optimization
    cost0: torch.Tensor         # robust cost before
    cost: torch.Tensor          # robust cost after


def _adj3x3(a, b, c, d, e, f, g, h, i):
    """Adjugate rows and determinant of [[a,b,c],[d,e,f],[g,h,i]]."""
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    return ((A11, A12, A13), (A21, A22, A23), (A31, A32, A33)), det


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate) of (...,3,3); zero for
    (near-)singular blocks."""
    adj, det = _adj3x3(*(A[..., r, c] for r in range(3) for c in range(3)))
    bad = torch.abs(det) < 1e-12
    det_safe = torch.where(bad, 1.0, det)
    inv = torch.stack([torch.stack(row, dim=-1) for row in adj], dim=-2)
    inv = inv / det_safe[..., None, None]
    return torch.where(bad[..., None, None], 0.0, inv)


def _inv3x3_cols(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a (3,3,N) stack (batch axis last); zero for
    (near-)singular blocks."""
    adj, det = _adj3x3(*(A[r, c] for r in range(3) for c in range(3)))
    bad = torch.abs(det) < 1e-12
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    inv = torch.stack([torch.stack(row) for row in adj])
    return inv * inv_det[None, None, :]


def _residuals_and_weights(p: BAProblem, kf_T, lm_pos, use_huber: bool):
    """Per-observation residual, robust weight, chi2. Shapes (M,P,...)."""
    T_obs = kf_T[p.obs_kf]                                   # (M,P,4,4)
    pts = lm_pos[:, None, :].expand(p.obs_uv.shape[:2] + (3,))
    pc = lie.se3_apply(T_obs, pts)
    uv_hat = cam.pinhole_project_linear(p.cam_params, pc)
    r = (p.obs_uv - uv_hat) * p.obs_inv_sigma[..., None]
    chi2 = torch.sum(r * r, dim=-1)
    valid = (p.obs_valid & p.lm_valid[:, None] & p.kf_valid[p.obs_kf]
             & (pc[..., 2] > 0.0))
    w = valid.to(r.dtype)
    if use_huber:
        w = robust.huber_weight(chi2, robust.CHI2_MONO) * w
    return r, w, chi2, valid, pc


def _robust_cost(chi2, valid, use_huber: bool):
    c = robust.huber_cost(chi2, robust.CHI2_MONO) if use_huber else chi2
    return torch.sum(c * valid)


def _schur_pieces(p: BAProblem, kf_T, lm_pos, lam, use_huber: bool):
    """Schur pieces (S, b_s, Wf, Vinv, b_l): S (K,K,6,6) carries U on the
    diagonal and -Y W^T off it, b_s (K,6) is the reduced RHS, Wf (K*6,3,M)
    the pose-landmark cross block for back-substitution, Vinv (3,3,M) and
    b_l (3,M) the landmark blocks. Jacobians are the closed-form pinhole
    forms (reference EdgeSE3ProjectXYZ::linearizeOplus), elementwise."""
    K = kf_T.shape[0]
    M, P = p.obs_uv.shape[:2]
    MP = M * P
    dtype = kf_T.dtype

    kf_flat = torch.cat([kf_T[:, :3, :3].reshape(K, 9), kf_T[:, :3, 3]], dim=1)
    obs_kf_f = p.obs_kf.reshape(MP).long()
    Tg = kf_flat[obs_kf_f]                                   # (MP,12)
    R = [Tg[:, i] for i in range(9)]
    t0, t1, t2 = Tg[:, 9], Tg[:, 10], Tg[:, 11]

    X0 = torch.repeat_interleave(lm_pos[:, 0], P)
    Y0 = torch.repeat_interleave(lm_pos[:, 1], P)
    Z0 = torch.repeat_interleave(lm_pos[:, 2], P)
    x = R[0] * X0 + R[1] * Y0 + R[2] * Z0 + t0
    y = R[3] * X0 + R[4] * Y0 + R[5] * Z0 + t1
    z = R[6] * X0 + R[7] * Y0 + R[8] * Z0 + t2

    fx, fy, cx, cy = (p.cam_params[0], p.cam_params[1],
                      p.cam_params[2], p.cam_params[3])
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    xz = x * iz
    yz = y * iz
    s = p.obs_inv_sigma.reshape(MP)
    rA = (p.obs_uv[..., 0].reshape(MP) - (fx * xz + cx)) * s
    rB = (p.obs_uv[..., 1].reshape(MP) - (fy * yz + cy)) * s
    chi2 = rA * rA + rB * rB
    valid = (p.obs_valid.reshape(MP)
             & torch.repeat_interleave(p.lm_valid, P)
             & p.kf_valid[obs_kf_f]
             & (z > 0))
    w = valid.to(dtype)
    if use_huber:
        w = robust.huber_weight(chi2, robust.CHI2_MONO) * w

    # residual Jacobians J = -d(uv_hat)/d(state) * inv_sigma; pose tangent
    # xi = [t, omega], T <- exp(xi) T, so d pc/d xi = [I | -hat(pc)]
    a = fx * iz
    b = fy * iz
    ns = -s
    one = torch.ones_like(xz)
    zero = torch.zeros_like(xz)
    # zero pose Jacobian for fixed cameras: they contribute only to V, b_l
    cf = (~p.kf_fixed)[obs_kf_f].to(dtype)
    nsc = ns * cf
    JpA = torch.stack([
        nsc * a, zero, nsc * a * -xz,
        nsc * -fx * xz * yz, nsc * fx * (one + xz * xz), nsc * -fx * yz,
    ])
    JpB = torch.stack([
        zero, nsc * b, nsc * b * -yz,
        nsc * -fy * (one + yz * yz), nsc * fy * xz * yz, nsc * fy * xz,
    ])
    JlA = torch.stack([(ns * a) * (R[j] - xz * R[6 + j]) for j in range(3)])
    JlB = torch.stack([(ns * b) * (R[3 + j] - yz * R[6 + j]) for j in range(3)])

    # landmark blocks: V (3,3,M), b_l (3,M) — contraction over p only
    V9 = w * (JlA[:, None] * JlA[None] + JlB[:, None] * JlB[None])   # (3,3,MP)
    V = V9.reshape(3, 3, M, P).sum(-1)
    b_l = -(w * (JlA * rA + JlB * rB)).reshape(3, M, P).sum(-1)
    trV = V[0, 0] + V[1, 1] + V[2, 2]
    eye3 = torch.eye(3, dtype=dtype, device=V.device)
    V_d = V + (lam * torch.clamp(trV / 3.0, min=1e-6)) * eye3[:, :, None]
    lm_free = p.lm_valid.to(dtype)
    Vinv = _inv3x3_cols(V_d) * lm_free[None, None, :]

    # camera blocks: one product against the one-hot assignment — each
    # residual row has support on exactly one 6-wide pose block (a
    # comparison, where F.one_hot reads its classes' range on the CPU)
    O2 = (obs_kf_f[:, None] == torch.arange(K, device=obs_kf_f.device)).to(dtype)  # (MP,K)
    Up = w * (JpA[:, None] * JpA[None] + JpB[:, None] * JpB[None])   # (6,6,MP)
    U = (Up.reshape(36, MP) @ O2).T.reshape(K, 6, 6)
    bj = -(w * (JpA * rA + JpB * rB))                             # (6,MP)
    b_c = (bj @ O2).T                                             # (K,6)

    # cross block Wf[(k,j),l,m] = sum_p onehot * (w Jp^T Jl)
    WB = w * (JpA[:, None] * JlA[None] + JpB[:, None] * JlB[None])   # (6,3,MP)
    Wf = torch.einsum(
        "wmp,mpk->kwm", WB.reshape(18, M, P), O2.reshape(M, P, K)
    ).reshape(K * 6, 3, M)
    Y = torch.einsum("axm,xym->aym", Wf, Vinv)                   # (K6,3,M)

    Yf = Y.reshape(K * 6, 3 * M)
    S_flat = -(Yf @ Wf.reshape(K * 6, 3 * M).T)                   # (K6,K6)
    S = S_flat.reshape(K, 6, K, 6).permute(0, 2, 1, 3).contiguous()
    ar = torch.arange(K, device=S.device)
    S = S.index_put((ar, ar), U, accumulate=True)

    # reduced rhs: b_s = b_c - Y b_l
    b_s = b_c - (Yf @ b_l.reshape(3 * M)).reshape(K, 6)
    return S, b_s, Wf, Vinv, b_l


def _solve_cameras(p: BAProblem, S, b_s, lam):
    """Damp + gauge-mask the reduced system, dense solve."""
    K = S.shape[0]
    dtype = S.dtype
    ar = torch.arange(K, device=S.device)
    eye6 = torch.eye(6, dtype=dtype, device=S.device)
    diag_scale = torch.clamp(
        torch.diagonal(S[ar, ar], dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0,
        min=1e-6,
    )
    S = S.index_put((ar, ar), lam * eye6[None] * diag_scale, accumulate=True)

    # mask fixed/invalid cameras: identity row/col, zero rhs
    free = (p.kf_valid & ~p.kf_fixed).to(dtype)
    mask2 = free[:, None] * free[None, :]
    S = S * mask2[:, :, None, None]
    S = S.index_put((ar, ar), eye6[None] * (1.0 - free)[:, None, None],
                    accumulate=True)
    b_s = b_s * free[:, None]

    S_dense = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dx_c = linalg.solve_spd_jacobi(S_dense, b_s.reshape(-1)).reshape(K, 6)
    return dx_c * free[:, None]


def _backsub_landmarks(p: BAProblem, Wf, Vinv, b_l, dx_c):
    """Landmark update dx_l = Vinv (b_l - W^T dx_c). Returns (M,3)."""
    corr = torch.einsum("alm,a->lm", Wf, dx_c.reshape(-1))
    lm_free = p.lm_valid.to(dx_c.dtype)
    dx_l = torch.einsum("ijm,jm->mi", Vinv, b_l - corr)
    return dx_l * lm_free[:, None]


def _build_and_solve(p: BAProblem, kf_T, lm_pos, lam, use_huber: bool,
                     group=None):
    """One damped GN step: returns (dx_cam (K,6), dx_lm (M,3)).

    With ``group`` (a process group over landmark blocks) the reduced
    camera system is all-reduced, so every rank solves the same global
    system; back-substitution stays local."""
    S, b_s, Wf, Vinv, b_l = _schur_pieces(p, kf_T, lm_pos, lam, use_huber)
    if group is not None:
        dist.all_reduce(S, group=group)
        dist.all_reduce(b_s, group=group)
    dx_c = _solve_cameras(p, S, b_s, lam)
    dx_l = _backsub_landmarks(p, Wf, Vinv, b_l, dx_c)
    return dx_c, dx_l


def _lm_loop(p: BAProblem, iters: int, lam0: float, group=None) -> BAResult:
    """Levenberg-Marquardt loop with per-iteration accept/reject on the
    device: lambda halves on success, grows x10 on failure (bounded), the
    state reverts on failure (g2o's OptimizationAlgorithmLevenberg). With
    ``group``, ``p`` is this rank's landmark block: the cost and the reduced
    camera system are all-reduced, so every rank takes the same
    accept/reject decision and the same pose update."""
    dtype = p.kf_T.dtype
    use_huber = True

    # cost accounting uses the STATIC validity (no cheirality gate): a step
    # that pushes points behind the camera must read as a huge cost, and a
    # NaN step gives a NaN cost that `cost_new < cost` rejects
    valid_static = p.obs_valid & p.lm_valid[:, None] & p.kf_valid[p.obs_kf]

    def total_cost(kf_T, lm_pos):
        _, _, chi2, _, pc = _residuals_and_weights(p, kf_T, lm_pos, use_huber)
        c = robust.huber_cost(chi2, robust.CHI2_MONO)
        c = torch.where(pc[..., 2] > 0.0, c, 1e6)   # cheirality penalty
        c = torch.sum(c * valid_static)
        if group is not None:
            dist.all_reduce(c, group=group)
        return c

    kf_T, lm_pos = p.kf_T, p.lm_pos
    lam = torch.full((), lam0, dtype=dtype, device=kf_T.device)
    cost0 = cost = total_cost(kf_T, lm_pos)
    for _ in range(iters):
        dx_c, dx_l = _build_and_solve(p, kf_T, lm_pos, lam, use_huber, group)
        kf_T_new = lie.se3_project(lie.se3_exp(dx_c) @ kf_T)
        lm_new = lm_pos + dx_l
        cost_new = total_cost(kf_T_new, lm_new)
        accept = cost_new < cost
        kf_T = torch.where(accept, kf_T_new, kf_T)
        lm_pos = torch.where(accept, lm_new, lm_pos)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e4))
        cost = torch.where(accept, cost_new, cost)

    _, _, chi2_f, valid_f, _ = _residuals_and_weights(p, kf_T, lm_pos, use_huber)
    inlier = valid_f & (chi2_f <= robust.CHI2_MONO)
    return BAResult(kf_T, lm_pos, inlier, cost0, cost)


def _bundle_adjust(p: BAProblem, iters: int = 10, lam0: float = 1e-4) -> BAResult:
    """Single-device Levenberg-Marquardt BA (see `_lm_loop`)."""
    return _lm_loop(p, iters, lam0)


# single-device BA as one dispatch, as the reference's jit with static
# iters: on the card one CUDA graph per key (the problem's shapes). The
# sharded loop (parallel/dist_ba) all-reduces through its group and stays
# eager
bundle_adjust = _graphs.GraphRunner(_bundle_adjust, static=("iters", "lam0"))
