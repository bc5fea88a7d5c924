"""Batched two-view triangulation + quality checks.

PyTorch port of ``eorb_slam_tpu/geometry/triangulation.py``: DLT through the
smallest eigenvector of the 4x4 normal matrix, batched over every leading
dimension (the JAX package vmaps; here poses and rays broadcast).
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch._host import scalar
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.optim.linalg import eigh_or_nan


def triangulate_dlt(T1: torch.Tensor, T2: torch.Tensor,
                    ray1: torch.Tensor, ray2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of normalized-ray correspondences.

    T1, T2: (...,4,4) world->camera poses; ray1, ray2: (...,3) unit-z rays.
    All broadcast together. Returns world points (...,3)."""
    P1 = T1[..., :3, :]
    P2 = T2[..., :3, :]
    rows = torch.broadcast_tensors(
        ray1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        ray1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        ray2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        ray2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    )
    A = torch.stack(rows, dim=-2)                       # (...,4,4)
    AtA = A.transpose(-1, -2) @ A
    _, v = eigh_or_nan(AtA)
    X = v[..., :, 0]
    w4 = X[..., 3]
    w_safe = torch.where(torch.abs(w4) < 1e-12, 1e-12, w4)
    return X[..., :3] / w_safe[..., None]


def triangulation_checks(
    T1, T2, ray1, ray2, pts_w,
    min_parallax_cos: float = 0.9998,
    max_reproj_err2: float = 5.991,
    inv_sigma1=1.0, inv_sigma2=1.0,
):
    """Cheirality + parallax + reprojection gates (reference
    TwoViewReconstruction::CheckRT): positive depth in both views, parallax
    cos below ``min_parallax_cos``, squared reprojection error below chi2."""
    pc1 = lie.se3_apply(T1, pts_w)
    pc2 = lie.se3_apply(T2, pts_w)
    pos = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

    c1 = lie.se3_trans(lie.se3_inv(T1))
    c2 = lie.se3_trans(lie.se3_inv(T2))
    d1 = pts_w - c1
    d2 = pts_w - c2
    cos_par = torch.sum(d1 * d2, dim=-1) / (
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1) + 1e-12
    )
    good_par = cos_par < min_parallax_cos

    z1 = torch.where(torch.abs(pc1[..., 2]) < 1e-9, 1e-9, pc1[..., 2])
    z2 = torch.where(torch.abs(pc2[..., 2]) < 1e-9, 1e-9, pc2[..., 2])
    inv_sigma1 = scalar(inv_sigma1, pts_w)[..., None]
    inv_sigma2 = scalar(inv_sigma2, pts_w)[..., None]
    e1 = (pc1[..., :2] / z1[..., None] - ray1[..., :2]) * inv_sigma1
    e2 = (pc2[..., :2] / z2[..., None] - ray2[..., :2]) * inv_sigma2
    err1 = torch.sum(e1 * e1, dim=-1)
    err2 = torch.sum(e2 * e2, dim=-1)
    good_err = (err1 < max_reproj_err2) & (err2 < max_reproj_err2)
    return pos & good_par & good_err, cos_par
