"""Relocalization: batched PnP RANSAC + pose refinement.

PyTorch port of ``eorb_slam_tpu/slam/relocalization.py`` (reference MLPnP
RANSAC + PoseOptimization polish): all hypotheses at once — minimal 6-point
sets solved by normalized DLT (null vector of A^T A), the rotation block
re-projected onto SO(3) by SVD, inliers scored with one batched
reprojection, and the best hypothesis refined by the pose-only GN.

Randomness: the minimal sets come from :func:`_draw_hypotheses`, which
draws from an explicit ``torch.Generator`` (parity tests replace it with
``jax.random.choice``'s draws). Degenerate hypotheses come out as NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.optim import pose_only
from eorb_slam_tpu_torch.optim.linalg import eigh_or_nan, svd_or_nan


def _dlt_pose(pts3d: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """Batched 6+ point DLT on normalized image coords: (...,n,3), (...,n,2)
    -> Tcw (...,4,4). Solves min |A p| over the 12 entries of [R|t], then
    projects onto SE(3): R <- U diag(1,1,det(UV^T)) V^T, the translation
    rescaled by the mean singular value."""
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)
    zeros = torch.zeros_like(X)
    u, v = xy_norm[..., 0:1], xy_norm[..., 1:2]
    rows_u = torch.cat([X, zeros, -u * X], dim=-1)             # (...,n,12)
    rows_v = torch.cat([zeros, X, -v * X], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                    # (...,2n,12)
    _, vecs = eigh_or_nan(A.transpose(-1, -2) @ A)
    P = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    # cheirality: points must have positive depth on average
    depth_sign = torch.sign(torch.mean((X @ P[..., 2, :, None])[..., 0], dim=-1))
    P = P * torch.where(depth_sign == 0, 1.0, depth_sign)[..., None, None]
    U, S, Vt = svd_or_nan(P[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    scale = torch.mean(S, dim=-1) * d
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1.0, scale)[..., None]
    return lie.se3(R, t)


class RelocResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _draw_hypotheses(generator: torch.Generator, probs: torch.Tensor,
                     n_hyp: int, k: int) -> torch.Tensor:
    """(n_hyp, k) indices drawn with replacement with probabilities
    ``probs`` (uniform where all are zero)."""
    probs = torch.where(probs.sum() > 0, probs, torch.ones_like(probs))
    idx = torch.multinomial(probs, n_hyp * k, replacement=True,
                            generator=generator)
    return idx.view(n_hyp, k)


def pnp_ransac(
    cam_params: torch.Tensor,
    pts3d: torch.Tensor,     # (N,3) world points of candidate matches
    uv: torch.Tensor,        # (N,2) observed (undistorted) pixels
    valid: torch.Tensor,     # (N,) bool
    generator: torch.Generator,
    px_threshold: float = 5.991,
    n_hyp: int = 256,
    min_inliers: int = 15,
) -> RelocResult:
    N = pts3d.shape[0]
    xy_norm = cam_mod.pinhole_unproject_linear(cam_params, uv)[:, :2]
    probs = valid.to(torch.float32) / torch.clamp(valid.sum(), min=1)
    idx = _draw_hypotheses(generator, probs, n_hyp, 6)
    Th = _dlt_pose(pts3d[idx], xy_norm[idx])                    # (H,4,4)

    def score(T):                                              # (...,4,4)
        pc = (T[..., :3, :3] @ pts3d.T).transpose(-1, -2) + T[..., None, :3, 3]
        uv_p = cam_mod.pinhole_project_linear(cam_params, pc)
        e2 = torch.sum((uv_p - uv) ** 2, dim=-1)
        return valid & (e2 < px_threshold) & (pc[..., 2] > 0.05)

    inls = score(Th)
    best = torch.argmax(inls.sum(dim=1))
    T0, inl0 = Th[best], inls[best]
    # GN polish on inliers (reference: PoseOptimization after PnP)
    T_ref, _, _ = pose_only.pose_optimization(
        cam_params, lie.se3_project(T0), pts3d, uv,
        torch.ones(N, dtype=torch.float32, device=pts3d.device), inl0,
    )
    inl_ref = score(T_ref)
    better = inl_ref.sum() >= inl0.sum()
    Tcw = torch.where(better, T_ref, T0)
    inl = torch.where(better, inl_ref, inl0)
    n = inl.sum(dtype=torch.int32)
    return RelocResult(Tcw=Tcw, inliers=inl, n_inliers=n, ok=n >= min_inliers)
