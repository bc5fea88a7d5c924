"""Closed-form Sim3/SE3 alignment + batched RANSAC.

PyTorch port of ``eorb_slam_tpu/geometry/sim3_solver.py`` (reference
Sim3Solver: Horn's quaternion method on 3-point minimal sets inside a RANSAC
loop with reprojection-error inlier checks). All hypotheses are evaluated at
once: the minimal sets are gathered into an (H,3,3) batch, Horn's closed
form runs batched (a 4x4 symmetric eigendecomposition per hypothesis), and
the inliers come from one batched projection of every correspondence
against every hypothesis.

Randomness: the minimal sets come from :func:`_draw_minimal_sets`, which
draws from an explicit ``torch.Generator`` (parity tests replace it with
``jax.random.choice``'s draws). Degenerate hypotheses come out as NaN and
score no inliers (``optim/linalg.eigh_or_nan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.optim.linalg import eigh_or_nan


def _horn_rotation(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Horn's closed-form rotation: R such that Q ~ R P (centered inputs).
    P, Q: (...,N,3) centered, w: (...,N) weights. Returns (...,3,3)."""
    M = (w[..., :, None] * P).transpose(-1, -2) @ Q                # (...,3,3)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    _, vecs = eigh_or_nan(N)
    return lie.quat_to_mat(vecs[..., :, -1])   # max eigenvalue; q = (w,x,y,z)


def umeyama(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor | None = None,
            with_scale: bool = True):
    """Weighted closed-form Sim3 (R, t, s) minimizing sum w |Q - (sRP+t)|^2
    (Sim3Solver::ComputeSim3). P, Q (...,N,3), w (...,N); batched over the
    leading dims."""
    if w is None:
        w = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cp = (w[..., None] * P).sum(-2) / wsum
    cq = (w[..., None] * Q).sum(-2) / wsum
    P0, Q0 = P - cp[..., None, :], Q - cq[..., None, :]
    R = _horn_rotation(P0, Q0, w)
    RP0 = (R @ P0.transpose(-1, -2)).transpose(-1, -2)
    num = (w * (Q0 * RP0).sum(-1)).sum(-1)
    den = torch.clamp((w * (P0 * P0).sum(-1)).sum(-1), min=1e-12)
    s = num / den if with_scale else torch.ones_like(num)
    t = cq - s[..., None] * (R @ cp[..., None])[..., 0]
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor        # (3,3) best hypothesis, refined on inliers
    t: torch.Tensor        # (3,)
    s: torch.Tensor        # ()
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def _draw_minimal_sets(generator: torch.Generator, probs: torch.Tensor,
                       n_hyp: int) -> torch.Tensor:
    """(n_hyp, 3) indices drawn with replacement with probabilities
    ``probs`` (uniform where all are zero)."""
    probs = torch.where(probs.sum() > 0, probs, torch.ones_like(probs))
    idx = torch.multinomial(probs, n_hyp * 3, replacement=True,
                            generator=generator)
    return idx.view(n_hyp, 3)


def sim3_ransac(
    pts1: torch.Tensor,       # (N,3) points in KF1 camera frame
    pts2: torch.Tensor,       # (N,3) matched points in KF2 camera frame
    valid: torch.Tensor,      # (N,) bool
    generator: torch.Generator,
    px_threshold: torch.Tensor,  # (N,) per-match pixel threshold (9.21*sigma2)
    cam_params1: torch.Tensor,
    cam_params2: torch.Tensor,
    n_hyp: int = 128,
    with_scale: bool = True,
) -> Sim3RansacResult:
    """Batched-hypothesis Sim3 RANSAC between two matched 3D point sets,
    scored by symmetric reprojection error in both cameras (Sim3Solver::
    iterate + CheckInliers)."""
    probs = valid.to(torch.float32) / torch.clamp(valid.sum(), min=1)
    idx = _draw_minimal_sets(generator, probs, n_hyp).to(pts1.device)
    Rh, th, sh = umeyama(pts1[idx], pts2[idx], with_scale=with_scale)  # (H,..)

    uv1_obs = cam_mod.pinhole_project_linear(cam_params1, pts1)
    uv2_obs = cam_mod.pinhole_project_linear(cam_params2, pts2)

    def score(R, t, s):                       # (...,3,3) -> (...,N) inliers
        p2 = s[..., None, None] * (pts1 @ R.transpose(-1, -2)) + t[..., None, :]
        uv2 = cam_mod.pinhole_project_linear(cam_params2, p2)
        Ri, ti, si = lie.sim3_inv(R, t, s)
        p1 = si[..., None, None] * (pts2 @ Ri.transpose(-1, -2)) + ti[..., None, :]
        uv1 = cam_mod.pinhole_project_linear(cam_params1, p1)
        e1 = torch.sum((uv1 - uv1_obs) ** 2, -1)
        e2 = torch.sum((uv2 - uv2_obs) ** 2, -1)
        return (valid & (e1 < px_threshold) & (e2 < px_threshold)
                & (p2[..., 2] > 0) & (p1[..., 2] > 0))

    inls = score(Rh, th, sh)                  # (H,N)
    best = torch.argmax(inls.sum(dim=1))      # first of the most inliers
    inl = inls[best]
    # refine on inliers with the weighted closed form
    R, t, s = umeyama(pts1, pts2, inl.to(pts1.dtype), with_scale=with_scale)
    inl_ref = score(R, t, s)
    better = inl_ref.sum() >= inl.sum()
    R = torch.where(better, R, Rh[best])
    t = torch.where(better, t, th[best])
    s = torch.where(better, s, sh[best])
    inl = torch.where(better, inl_ref, inl)
    return Sim3RansacResult(R=R, t=t, s=s, inliers=inl,
                            n_inliers=inl.sum(dtype=torch.int32))
