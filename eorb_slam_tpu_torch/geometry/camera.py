"""Batched pinhole camera model (radial-tangential distortion).

PyTorch port of the pinhole half of ``eorb_slam_tpu/geometry/camera.py``
(lines 26-142). A camera is a parameter vector
``[fx, fy, cx, cy, k1, k2, p1, p2, k3]`` (9,); every op is a pure function
over ``(...,3)`` / ``(...,2)`` tensors. The Kannala-Brandt-8 model and the
rectify maps are not ported yet.
"""

from __future__ import annotations

import torch


def make_pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                 device=None):
    return torch.tensor([fx, fy, cx, cy, k1, k2, p1, p2, k3],
                        dtype=torch.float32, device=device)


def K_matrix(params: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zero, cx]),
        torch.stack([zero, fy, cy]),
        torch.stack([zero, zero, one]),
    ])


def pinhole_distort_normalized(params, xy):
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def pinhole_undistort_normalized(params, xy_d, iters: int = 20):
    """Invert distortion by a fixed number of fixed-point iterations."""
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = (xy_d[..., 0] - dx) / radial
        yn = (xy_d[..., 1] - dy) / radial
        xy = torch.stack([xn, yn], dim=-1)
    return xy


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, 1e-9, z)


def pinhole_project(params, pts3d):
    """Project camera-frame 3D points (...,3) to distorted pixels (...,2).
    Points behind the camera give garbage; callers mask with z > 0."""
    xy = pts3d[..., :2] / _safe_z(pts3d[..., 2])[..., None]
    xyd = pinhole_distort_normalized(params, xy)
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return torch.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], dim=-1)


def pinhole_project_linear(params, pts3d):
    """Project with K only (no distortion) — for pre-undistorted points."""
    z_safe = _safe_z(pts3d[..., 2])
    x = pts3d[..., 0] / z_safe
    y = pts3d[..., 1] / z_safe
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def pinhole_unproject(params, uv):
    """Distorted pixel (...,2) -> unit-z ray (...,3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xn = (uv[..., 0] - cx) / fx
    yn = (uv[..., 1] - cy) / fy
    xy = pinhole_undistort_normalized(params, torch.stack([xn, yn], dim=-1))
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def pinhole_unproject_linear(params, uv):
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xn = (uv[..., 0] - cx) / fx
    yn = (uv[..., 1] - cy) / fy
    return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)


def pinhole_project_jac_point(params, pts3d):
    """d(pixel)/d(point) for the linear model: (...,2,3)."""
    fx, fy = params[0], params[1]
    x, y = pts3d[..., 0], pts3d[..., 1]
    iz = 1.0 / _safe_z(pts3d[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def undistort_points(params, uv):
    """Distorted observed pixels -> undistorted pixels (linear model)."""
    return pinhole_project_linear(params, pinhole_unproject(params, uv))
