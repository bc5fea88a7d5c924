"""Monocular reprojection residuals with analytic Jacobians.

PyTorch port of ``eorb_slam_tpu/optim/reprojection.py``. Pose convention:
``Tcw`` maps world to camera, updates are LEFT-multiplied increments
``Tcw <- exp(dx) @ Tcw`` with tangent ``dx = [rho, phi]``, so
d(pc)/d(rho) = I and d(pc)/d(phi) = -hat(pc). Observations are undistorted,
so the linear (K-only) projection is used.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch.geometry import camera as cam
from eorb_slam_tpu_torch.geometry import lie


def transform_points(Tcw: torch.Tensor, pts_w: torch.Tensor) -> torch.Tensor:
    """World points (...,3) into camera frame given Tcw (...,4,4)."""
    return lie.se3_apply(Tcw, pts_w)


def mono_residual(cam_params, Tcw, pts_w, uv_obs, inv_sigma):
    """Residual (N,2) = inv_sigma * (uv_obs - proj(pc))."""
    pc = transform_points(Tcw, pts_w)
    uv_hat = cam.pinhole_project_linear(cam_params, pc)
    return (uv_obs - uv_hat) * inv_sigma[..., None]


def mono_residual_jac(cam_params, Tcw, pts_w, uv_obs, inv_sigma):
    """Residual (N,2) + J_pose (N,2,6) + J_point (N,2,3), analytic
    Jacobians of the *residual* (minus the projection Jacobian)."""
    pc = transform_points(Tcw, pts_w)
    uv_hat = cam.pinhole_project_linear(cam_params, pc)
    r = (uv_obs - uv_hat) * inv_sigma[..., None]

    Jproj = cam.pinhole_project_jac_point(cam_params, pc)  # (N,2,3)
    I3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dx = torch.cat([I3, -lie.hat(pc)], dim=-1)         # (N,3,6)
    J_pose = -(Jproj @ dpc_dx) * inv_sigma[..., None, None]
    R = lie.se3_rot(Tcw)
    J_point = -(Jproj @ R) * inv_sigma[..., None, None]
    return r, J_pose, J_point


def depth_positive(Tcw, pts_w) -> torch.Tensor:
    """Validity gate: point in front of the camera (cheirality)."""
    return transform_points(Tcw, pts_w)[..., 2] > 0.0
