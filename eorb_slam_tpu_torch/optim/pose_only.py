"""Motion-only pose optimization (tracking inner loop).

PyTorch port of ``eorb_slam_tpu/optim/pose_only.py`` (reference
Optimizer::PoseOptimization): 4 rounds x 10 Gauss-Newton iterations over the
current frame's map-point matches, Huber(sqrt(5.991)) in the first two
rounds, per-round outlier re-classification at chi2 > 5.991; outliers leave
the normal equations but are re-tested every round. Fixed shapes: N
observation slots with a validity mask, and no host read inside. On the
card a call is one CUDA-graph replay (``pose_optimization``, a graph runner
with static ``rounds`` and ``iters_per_round``, the reference's jit); inside
another step's capture it runs inline.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.optim import linalg, reprojection, robust


def _gn_step(cam_params, Tcw, pts_w, uv_obs, inv_sigma, weight_mask, use_huber):
    """One Gauss-Newton step on a single pose. Returns (dx, chi2_per_obs)."""
    r, J_pose, _ = reprojection.mono_residual_jac(
        cam_params, Tcw, pts_w, uv_obs, inv_sigma
    )
    chi2 = torch.sum(r * r, dim=-1)
    w = weight_mask
    if use_huber:
        w = robust.huber_weight(chi2, robust.CHI2_MONO) * w
    JW = J_pose * w[:, None, None]
    H = torch.einsum("nij,nik->jk", JW, J_pose)
    b = -torch.einsum("nij,ni->j", JW, r)
    # Levenberg damping for safety on degenerate geometry
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    H = H + 1e-6 * eye * torch.clamp(torch.trace(H) / 6.0, min=1.0)
    dx = linalg.solve_spd_jacobi(H, b)
    # degenerate systems (all weights zero / rank-deficient geometry) must
    # not emit NaN steps — the pose simply stays put
    dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
    return dx, chi2


def _pose_optimization(
    cam_params: torch.Tensor,
    Tcw0: torch.Tensor,
    pts_w: torch.Tensor,
    uv_obs: torch.Tensor,
    inv_sigma: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 4,
    iters_per_round: int = 10,
):
    """Optimize a single pose against fixed 3D points.

    Returns (Tcw (4,4), inlier_mask (N,) bool, num_inliers () int32)."""
    valid_f = valid.to(Tcw0.dtype)
    Tcw, inlier = Tcw0, valid_f
    for ri in range(rounds):
        use_huber = ri < rounds - 2  # final rounds: plain least squares
        w = inlier * valid_f
        for _ in range(iters_per_round):
            dx, _ = _gn_step(cam_params, Tcw, pts_w, uv_obs, inv_sigma, w,
                             use_huber)
            Tcw = lie.se3_exp(dx) @ Tcw
        # re-classify ALL valid observations (outliers can come back)
        r = reprojection.mono_residual(cam_params, Tcw, pts_w, uv_obs, inv_sigma)
        chi2 = torch.sum(r * r, dim=-1)
        pos = reprojection.depth_positive(Tcw, pts_w)
        inlier = ((chi2 <= robust.CHI2_MONO) & pos).to(Tcw0.dtype)
    Tcw = lie.se3_project(Tcw)
    inlier_mask = (inlier > 0.5) & valid
    return Tcw, inlier_mask, torch.sum(inlier_mask.to(torch.int32))


# the pose-only solve as one dispatch (the reference's jit): on the card one
# CUDA graph per key; inline inside the tracked-frame, inertial-frame and
# joint-pose captures
pose_optimization = _graphs.GraphRunner(
    _pose_optimization, static=("rounds", "iters_per_round"))
