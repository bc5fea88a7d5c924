"""Lie-group operations: SO(3), SE(3), Sim(3), quaternions.

PyTorch port of ``eorb_slam_tpu/geometry/lie.py``. Broadcast-friendly: every
op accepts leading batch dimensions. Angles near zero use Taylor expansions
guarded with ``torch.where`` (singular operands are clamped BEFORE the
singular op so autograd stays finite).

Conventions (same as the reference package):
- rotations stored as 3x3 matrices ``R`` (x_cam = R @ x_w + t),
- quaternions stored ``[w, x, y, z]`` (Hamilton),
- se3 tangent ordered ``[rho(3), phi(3)]`` = (translation, rotation),
- sim3 tangent ordered ``[rho(3), phi(3), sigma(1)]``.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch._host import constant, scalar

_EPS = 1e-8
_SMALL2 = 1e-10  # squared-angle Taylor-guard threshold (theta < 1e-5)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: v (...,3) -> skew matrix (...,3,3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) skew -> (...,3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _or1(small, x):
    """``x`` with 1 where ``small``. The 1 is a tensor, not a Python scalar:
    ``torch.func.jvp`` gives a 0-dim ``where`` of a scalar and a tensor a
    float64 tangent, which then meets float32 in a matmul."""
    return torch.where(small, torch.ones_like(x), x)


def _safe_theta(t2):
    """sqrt(t2) whose gradient is finite at t2=0 (clamp BEFORE sqrt)."""
    small = t2 < _SMALL2
    return small, torch.sqrt(_or1(small, t2))


def _sinc_sq(t2):
    """sin(theta)/theta as a function of theta^2, AD-safe at 0."""
    small, th = _safe_theta(t2)
    return torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)


def _cosc_sq(t2):
    """(1-cos(theta))/theta^2 as a function of theta^2, AD-safe at 0."""
    small, th = _safe_theta(t2)
    return torch.where(
        small, 0.5 - t2 / 24.0,
        (1.0 - torch.cos(th)) / _or1(small, t2),
    )


def _sinc(x):
    return _sinc_sq(x * x)


def _cosc(x):
    return _cosc_sq(x * x)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector (...,3) -> rotation matrix (...,3,3)."""
    t2 = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    a = _sinc_sq(t2)[..., None, None]
    b = _cosc_sq(t2)[..., None, None]
    return _eye3(phi, K.shape) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> rotation vector (...,3), via the
    quaternion route (stable near 0 and near pi)."""
    return quat_log(quat_from_mat(R))


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr of SO(3): exp(phi + dphi) ~ exp(phi) exp(Jr dphi)."""
    t2 = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    small, ts = _safe_theta(t2)
    a = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (ts - torch.sin(ts)) / _or1(small, ts * t2))
    b = _cosc_sq(t2)
    return _eye3(phi, K.shape) - b[..., None, None] * K + a[..., None, None] * K2


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    t2 = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    small, ts = _safe_theta(t2)
    # coefficient c = 1/theta^2 - (1+cos)/(2 theta sin)
    c = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        1.0 / _or1(small, t2)
        - (1.0 + torch.cos(ts)) / (2.0 * ts * torch.sin(ts) + 1e-38),
    )
    return _eye3(phi, K.shape) + 0.5 * K + c[..., None, None] * K2


# ----------------------------------------------------------------- quaternions


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) [w,x,y,z].

    Shepperd's branchless method: all four candidate quaternions, keep the
    one with the largest diagonal combination (first on ties, as argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
    )
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4cand,4comp)
    gidx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cands, -2, gidx)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-38)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) [w,x,y,z] -> rotation matrix (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (...,3)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1)
    small = vn2 < 1e-18
    vn = torch.sqrt(_or1(small, vn2))   # clamp BEFORE sqrt
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-9), theta / vn)
    return v * scale[..., None]


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions; t broadcastable."""
    t = scalar(t, q0)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    # margin must be representable in f32 (1 - 1e-9 rounds to exactly 1.0)
    small = dot > 1.0 - 1e-6
    # clamp BEFORE arccos: its derivative blows up at dot=1
    theta = torch.arccos(torch.where(small, 0.5, dot))
    sin_theta = torch.sin(theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_theta)
    w1 = torch.where(small, t, torch.sin(t * theta) / sin_theta)
    q = w0 * q0 + w1 * q1
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-38)


# ------------------------------------------------------------------------ SE3
# An SE3 is a (...,4,4) homogeneous matrix; helpers build/split them.


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from R (...,3,3), t (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # the [0,0,0,1] row is cached on the device: a copy from the host per
    # call would drain the stream
    bottom = constant((0.0, 0.0, 0.0, 1.0), R.dtype, R.device).expand(batch + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def se3_rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def se3_trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_identity(batch: tuple = (), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch) + (4, 4))


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R = se3_rot(T)
    t = se3_trans(T)
    Rt = R.transpose(-1, -2)
    return se3(Rt, -(Rt @ t[..., None])[..., 0])


def se3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points p (...,3) by T (...,4,4)."""
    return (se3_rot(T) @ p[..., None])[..., 0] + se3_trans(T)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent (...,6) [rho, phi] -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t2 = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    small, ts = _safe_theta(t2)
    b = _cosc_sq(t2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (ts - torch.sin(ts)) / _or1(small, ts * t2))
    V = _eye3(xi, K.shape) + b[..., None, None] * K + c[..., None, None] * K2
    t = (V @ rho[..., None])[..., 0]
    return se3(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> tangent (...,6) [rho, phi]."""
    phi = so3_log(se3_rot(T))
    t2 = torch.sum(phi * phi, dim=-1)
    K = hat(phi)
    K2 = K @ K
    small, ts = _safe_theta(t2)
    # V^{-1} = I - K/2 + c K^2
    c = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - ts * torch.cos(ts / 2.0) / (2.0 * torch.sin(ts / 2.0) + 1e-38))
        / _or1(small, t2),
    )
    Vinv = _eye3(T, K.shape) - 0.5 * K + c[..., None, None] * K2
    rho = (Vinv @ se3_trans(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


# ----------------------------------------------------------------------- Sim3
# Sim3 represented as (R (...,3,3), t (...,3), s (...)): x -> s R x + t.


def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_mul(R1, t1, s1, R2, t2, s2):
    return (
        R1 @ R2,
        s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1,
        s1 * s2,
    )


def sim3_exp(xi: torch.Tensor):
    """sim3 tangent (...,7) [rho, phi, sigma] -> (R, t, s), closed-form W."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = torch.exp(sigma)
    K = hat(phi)
    K2 = K @ K

    t2 = torch.sum(phi * phi, dim=-1)
    s2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-5
    small_th, th_s = _safe_theta(t2)

    sig_s = torch.where(small_sig, 1.0, sigma)

    # W = A I + B K + C K^2 with  A = int_0^1 e^{sigma u} du,
    # B = (1/theta)   int e^{sigma u} sin(u theta) du,
    # C = (1/theta^2)(A - int e^{sigma u} cos(u theta) du).
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + s2 / 6.0, (s - 1.0) / sig_s)

    den = s2 + t2
    den_s = torch.where(den < 1e-12, 1.0, den)
    sin_t, cos_t = torch.sin(th_s), torch.cos(th_s)
    t2_s = torch.where(small_th, 1.0, t2)

    I1 = (s * (sig_s * sin_t - th_s * cos_t) + th_s) / den_s
    I2 = (s * (sig_s * cos_t + th_s * sin_t) - sig_s) / den_s
    B_gen = I1 / th_s
    C_gen = (A - I2) / t2_s

    # theta->0, general sigma limits
    B_small_th = (s * (sig_s - 1.0) + 1.0) / s2.clamp(min=1e-12)
    C_small_th = (s * (s2 - 2.0 * sig_s + 2.0) - 2.0) / torch.where(
        small_sig, 1.0, 2.0 * sig_s * s2
    )
    B_small_th = torch.where(small_sig, 0.5 + sigma / 3.0, B_small_th)
    C_small_th = torch.where(small_sig, 1.0 / 6.0 + sigma / 12.0, C_small_th)

    # sigma->0, general theta limits
    B_small_sig = _cosc_sq(t2)
    C_small_sig = torch.where(
        small_th, 1.0 / 6.0, (th_s - torch.sin(th_s)) / (th_s * t2 + 1e-38)
    )

    B = torch.where(small_th, B_small_th, torch.where(small_sig, B_small_sig, B_gen))
    C = torch.where(small_th, C_small_th, torch.where(small_sig, C_small_sig, C_gen))

    W = (A[..., None, None] * _eye3(xi, K.shape) + B[..., None, None] * K
         + C[..., None, None] * K2)
    t = (W @ rho[..., None])[..., 0]
    return R, t, s


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """Re-project a near-rotation onto SO(3) (via quaternion round-trip)."""
    return quat_to_mat(quat_from_mat(R))


def se3_project(T: torch.Tensor) -> torch.Tensor:
    """Re-project the rotation block of an SE3 onto the manifold."""
    return se3(project_so3(se3_rot(T)), se3_trans(T))


def interpolate_se3(T0: torch.Tensor, T1: torch.Tensor, alpha) -> torch.Tensor:
    """Geodesic interpolation between two SE3s (slerp on rotation, lerp on t).

    ``alpha`` may carry a batch (e.g. one value per event): the result then
    has that batch, which is what the JAX package gets by vmapping."""
    alpha = scalar(alpha, T0)
    q0, q1 = quat_from_mat(se3_rot(T0)), quat_from_mat(se3_rot(T1))
    q = quat_slerp(q0, q1, alpha[..., None])
    t = (1.0 - alpha[..., None]) * se3_trans(T0) + alpha[..., None] * se3_trans(T1)
    return se3(quat_to_mat(q), t)
