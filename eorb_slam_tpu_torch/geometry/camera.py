"""Batched camera models: radial-tangential pinhole and Kannala-Brandt-8
fisheye.

PyTorch port of ``eorb_slam_tpu/geometry/camera.py``. A camera is a
parameter vector, every op a pure function over ``(...,3)`` / ``(...,2)``
tensors:
- pinhole: ``[fx, fy, cx, cy, k1, k2, p1, p2, k3]`` (9,)
- KB8 fisheye: ``[fx, fy, cx, cy, k1, k2, k3, k4]`` (8,)

Model dispatch is static (separate functions).
"""

from __future__ import annotations

import math

import torch

from eorb_slam_tpu_torch import _graphs

PINHOLE = 0
FISHEYE_KB8 = 1


def make_pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                 device=None):
    return torch.tensor([fx, fy, cx, cy, k1, k2, p1, p2, k3],
                        dtype=torch.float32, device=device)


def make_kb8(fx, fy, cx, cy, k1=0.0, k2=0.0, k3=0.0, k4=0.0, device=None):
    return torch.tensor([fx, fy, cx, cy, k1, k2, k3, k4],
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


def _undistort_points(params, uv):
    """Distorted observed pixels -> undistorted pixels (linear model)."""
    return pinhole_project_linear(params, pinhole_unproject(params, uv))


# one dispatch per call, as the reference's jit (no static arguments): the
# 20-step fixed-point loop is ~100 launches run eagerly
undistort_points = _graphs.GraphRunner(_undistort_points)


def build_rectify_map(params, w: int, h: int, model: int = PINHOLE):
    """Per-pixel undistortion lookup (H,W,2) as a numpy array: raw sensor
    pixel -> undistorted pixel in the SAME linear intrinsics. The event
    loaders apply it per event at load. Computed on ``params``' device, once
    per calibration.

    model: PINHOLE (radial-tangential) or FISHEYE_KB8."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=params.device),
        torch.arange(w, dtype=torch.float32, device=params.device),
        indexing="ij",
    )
    uv = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    if model == FISHEYE_KB8:
        out = pinhole_project_linear(params, kb8_unproject(params, uv))
    else:
        out = undistort_points(params, uv)
    return out.reshape(h, w, 2).cpu().numpy()


# ------------------------------------------------------------------------ KB8


def kb8_project(params, pts3d):
    """KB8 fisheye projection (reference src/CameraModels/KannalaBrandt8.cpp)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    r = torch.sqrt(x * x + y * y)
    r_safe = torch.where(r < 1e-9, 1e-9, r)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r_safe
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(params, uv, iters: int = 10):
    """Pixel -> unit-z ray via Newton inversion of the theta polynomial
    (as reference KannalaBrandt8::unproject)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, 0.0, math.pi / 2.0 + 0.4)

    theta = theta_d_c
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d_c
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.where(df.abs() < 1e-9, 1e-9, df)
    far = theta_d > 1e-9
    scale = torch.where(far, torch.tan(theta) / torch.where(far, theta_d, 1.0), 1.0)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac_point(params, pts3d):
    """d(pixel)/d(point) for KB8 of one point (3,) by forward-mode autodiff
    (vmapped by the caller)."""
    return torch.func.jacfwd(lambda p: kb8_project(params, p))(pts3d)


# ------------------------------------------------------------------- dispatch


def project(model: int, params, pts3d):
    if model == PINHOLE:
        return pinhole_project(params, pts3d)
    return kb8_project(params, pts3d)


def unproject(model: int, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def kb8_triangulate_matches(
    params1, params2, Trl, uv1, uv2, valid,
    max_reproj_px: float = 2.0, min_parallax_cos: float = 0.9998,
):
    """Stereo-fisheye triangulation of matched keypoints between two
    NON-rectified KB8 cameras (reference KannalaBrandt8::TriangulateMatches:
    unproject both rays, DLT-triangulate with the extrinsic Trl, gate by
    parallax and per-view reprojection error).

    Trl: (4,4) pose of the LEFT camera in the RIGHT camera's frame
    (x_r = Trl x_l). Returns (pts3d in LEFT cam frame (N,3), depth (N,),
    ok (N,))."""
    from eorb_slam_tpu_torch.geometry import triangulation

    rays1 = kb8_unproject(params1, uv1)                     # (N,3) unit-z
    rays2 = kb8_unproject(params2, uv2)
    T1 = torch.eye(4, dtype=uv1.dtype, device=uv1.device)
    pts = triangulation.triangulate_dlt(T1[None], Trl[None], rays1, rays2)
    z1 = pts[:, 2]
    pc2 = pts @ Trl[:3, :3].T + Trl[:3, 3]
    z2 = pc2[:, 2]
    e1 = torch.linalg.norm(kb8_project(params1, pts) - uv1, dim=-1)
    e2 = torch.linalg.norm(kb8_project(params2, pc2) - uv2, dim=-1)
    # parallax between the two rays expressed in one frame
    r2_in_1 = rays2 @ Trl[:3, :3]
    cosp = torch.sum(rays1 * r2_in_1, dim=-1) / (
        torch.linalg.norm(rays1, dim=-1) * torch.linalg.norm(r2_in_1, dim=-1)
        + 1e-12
    )
    ok = (
        valid & (z1 > 1e-3) & (z2 > 1e-3)
        & (e1 <= max_reproj_px) & (e2 <= max_reproj_px)
        & (cosp < min_parallax_cos)
        & torch.isfinite(pts).all(dim=-1)
    )
    return pts, z1, ok
