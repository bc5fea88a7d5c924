"""On-manifold IMU preintegration (Forster et al.).

PyTorch port of ``eorb_slam_tpu/imu/preintegration.py`` (reference
``IMU::Preintegrated``, src/IMU/ImuTypes.cc): a window of samples with a
validity mask is integrated sample by sample; the state order is (R, V, P) +
(bg, ba) as in the reference's 15x15 covariance layout. Everything stays
float32, as in the JAX package.

Bias updates do not re-run the integration: first-order bias Jacobians
(JRg, JVg, JVa, JPg, JPa) give corrected deltas in closed form
(``delta_corrected``), mirroring ``GetDeltaRotation/Velocity/Position``.

A ``Preintegrated`` may carry leading batch dimensions (one per keyframe
slot); ``stack``, ``take`` and ``put`` build, read and write such stacks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eorb_slam_tpu_torch.geometry import lie

GRAVITY = 9.81


def gravity_w(like: torch.Tensor) -> torch.Tensor:
    """World gravity (0, 0, -9.81) with ``like``'s dtype and device, made
    on the device (no host-to-device copy)."""
    return (torch.arange(3, device=like.device) == 2).to(like.dtype) * -GRAVITY


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (...,n,m) @ (...,m) -> (...,n)."""
    return (A @ x[..., None])[..., 0]


class ImuCalib(NamedTuple):
    """IMU calibration (reference ``IMU::Calib``)."""

    Tbc: torch.Tensor        # (4,4) camera pose in body frame: p_b = Tbc p_c
    gyro_noise: torch.Tensor  # () discrete sigma
    acc_noise: torch.Tensor   # ()
    gyro_walk: torch.Tensor   # () discrete random-walk sigma
    acc_walk: torch.Tensor    # ()

    def to(self, device) -> "ImuCalib":
        return ImuCalib(*(t.to(device) for t in self))


def make_calib(Tbc=None, gyro_noise=1.7e-4, acc_noise=2e-3,
               gyro_walk=1.9e-5, acc_walk=3e-3, freq=200.0,
               device=None) -> ImuCalib:
    """Continuous-time densities -> discrete sigmas at ``freq`` (the
    reference multiplies by sqrt(freq) when parsing its YAML). ``device``
    None keeps the calibration on the CPU; the systems move it to theirs."""
    f32 = torch.float32
    sf = torch.sqrt(torch.tensor(freq, dtype=f32))
    Tbc = torch.eye(4, dtype=f32) if Tbc is None else torch.as_tensor(Tbc, dtype=f32)
    return ImuCalib(
        Tbc=Tbc,
        gyro_noise=torch.tensor(gyro_noise, dtype=f32) * sf,
        acc_noise=torch.tensor(acc_noise, dtype=f32) * sf,
        gyro_walk=torch.tensor(gyro_walk, dtype=f32) / sf,
        acc_walk=torch.tensor(acc_walk, dtype=f32) / sf,
    ).to(device)


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames (leading batch dims allowed)."""

    dt: torch.Tensor      # () total time
    dR: torch.Tensor      # (3,3)
    dV: torch.Tensor      # (3,)
    dP: torch.Tensor      # (3,)
    C: torch.Tensor       # (15,15) covariance, order (R,V,P,bg,ba)
    JRg: torch.Tensor     # (3,3) d dR / d bg
    JVg: torch.Tensor     # (3,3)
    JVa: torch.Tensor     # (3,3)
    JPg: torch.Tensor     # (3,3)
    JPa: torch.Tensor     # (3,3)
    bg0: torch.Tensor     # (3,) gyro bias used during integration
    ba0: torch.Tensor     # (3,) acc bias used during integration


def identity_preintegrated(bg0=None, ba0=None, device=None) -> Preintegrated:
    f32 = torch.float32

    def z(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    return Preintegrated(
        dt=z(), dR=torch.eye(3, dtype=f32, device=device), dV=z(3), dP=z(3),
        C=z(15, 15), JRg=z(3, 3), JVg=z(3, 3), JVa=z(3, 3), JPg=z(3, 3),
        JPa=z(3, 3),
        bg0=z(3) if bg0 is None else torch.as_tensor(bg0, dtype=f32).to(device),
        ba0=z(3) if ba0 is None else torch.as_tensor(ba0, dtype=f32).to(device),
    )


def stack(pres) -> Preintegrated:
    """A sequence of Preintegrated -> one with a leading batch dimension."""
    return Preintegrated(*(torch.stack(f) for f in zip(*pres)))


def take(pre: Preintegrated, k) -> Preintegrated:
    """Entry ``k`` of a stacked Preintegrated."""
    return Preintegrated(*(f[k] for f in pre))


def put(pre: Preintegrated, k: int, one: Preintegrated) -> Preintegrated:
    """A copy of the stack ``pre`` with entry ``k`` replaced by ``one``."""
    out = []
    for f, x in zip(pre, one):
        f = f.clone()
        f[k] = x
        out.append(f)
    return Preintegrated(*out)


def integrate(
    gyro: torch.Tensor,   # (S,3)
    acc: torch.Tensor,    # (S,3)
    dts: torch.Tensor,    # (S,)
    valid: torch.Tensor,  # (S,) bool — masked samples change nothing
    bg0: torch.Tensor,
    ba0: torch.Tensor,
    calib: ImuCalib,
) -> Preintegrated:
    """Integrate a masked window of IMU samples.

    Mirrors ``IMU::Preintegrated::IntegrateNewMeasurement``: position and
    velocity first with the *old* dR, then the covariance propagation
    C <- A C A^T + B Nga B^T, the bias Jacobians, and finally the rotation
    update dR <- dR Exp((w-bg) dt). Samples are midpoint-averaged with
    their in-window predecessor first (the reference's PreintegrateIMU
    interpolates consecutive measurements the same way).

    The JAX package scans the samples; here a host loop runs them (on the
    card inside a captured graph: ``vi_system.preintegrate_frame`` and
    ``vi_frame_step``). A masked
    sample integrates with dt = 0 and its rotation update is discarded with
    ``torch.where`` (in the JAX scan it re-projects dR onto SO(3), a
    last-ulp change)."""
    f32 = torch.float32
    dev = gyro.device
    gyro, acc, dts = gyro.to(f32), acc.to(f32), dts.to(f32)
    bg0 = torch.as_tensor(bg0, dtype=f32).to(dev)
    ba0 = torch.as_tensor(ba0, dtype=f32).to(dev)
    prev_ok = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), valid[:-1]])
    gyro = torch.where(prev_ok[:, None],
                       0.5 * (gyro + torch.cat([gyro[:1], gyro[:-1]])), gyro)
    acc = torch.where(prev_ok[:, None],
                      0.5 * (acc + torch.cat([acc[:1], acc[:-1]])), acc)
    Nga = torch.diag(torch.cat([calib.gyro_noise.expand(3) ** 2,
                                calib.acc_noise.expand(3) ** 2])).to(dev)
    Nwalk = torch.cat([calib.gyro_walk.expand(3) ** 2,
                       calib.acc_walk.expand(3) ** 2]).to(dev)
    I3 = torch.eye(3, dtype=f32, device=dev)
    Z3 = torch.zeros(3, 3, dtype=f32, device=dev)

    pre = identity_preintegrated(bg0, ba0, device=dev)
    for i in range(gyro.shape[0]):
        ok = valid[i]
        dt = torch.where(ok, dts[i], 0.0)
        w = torch.where(ok, gyro[i] - bg0, 0.0)
        a = torch.where(ok, acc[i] - ba0, 0.0)
        dR, dV, dP = pre.dR, pre.dV, pre.dP
        ahat = lie.hat(a)

        # position/velocity with the old rotation
        dRa = dR @ a
        dP_new = dP + dV * dt + 0.5 * dRa * dt * dt
        dV_new = dV + dRa * dt

        # A (9x9) / B (9x6) blocks for the (R,V,P) noise propagation
        dRi = lie.so3_exp(w * dt)
        Jr = lie.so3_right_jacobian(w * dt)
        dRah = dR @ ahat
        A = torch.cat([
            torch.cat([dRi.T, Z3, Z3], 1),
            torch.cat([-dRah * dt, I3, Z3], 1),
            torch.cat([((-0.5 * dR) @ ahat) * dt * dt, I3 * dt, I3], 1),
        ])
        B = torch.cat([
            torch.cat([Jr * dt, Z3], 1),
            torch.cat([Z3, dR * dt], 1),
            torch.cat([Z3, 0.5 * dR * dt * dt], 1),
        ])
        C9 = A @ pre.C[:9, :9] @ A.T + B @ Nga @ B.T
        Cw = pre.C[9:, 9:] + torch.diag(Nwalk) * dt
        C = torch.block_diag(C9, Cw)

        # bias Jacobians (update order mirrors the reference)
        dRahJ = dRah @ pre.JRg
        JPa = pre.JPa + pre.JVa * dt - 0.5 * dR * dt * dt
        JPg = pre.JPg + pre.JVg * dt - 0.5 * dRahJ * dt * dt
        JVa = pre.JVa - dR * dt
        JVg = pre.JVg - dRahJ * dt
        JRg = dRi.T @ pre.JRg - Jr * dt

        dR_new = torch.where(ok, lie.project_so3(dR @ dRi), dR)
        pre = Preintegrated(
            dt=pre.dt + dt, dR=dR_new, dV=dV_new, dP=dP_new, C=C,
            JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
            bg0=pre.bg0, ba0=pre.ba0,
        )
    return pre


def merge(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Compose consecutive preintegrations (reference ``MergePrevious``).

    Assumes both were integrated with the same bias. The covariance is
    composed to first order through the state transition of the second
    segment acting on the first segment's covariance."""
    dR = lie.project_so3(p1.dR @ p2.dR)
    dV = p1.dV + _mv(p1.dR, p2.dV)
    dP = p1.dP + p1.dV * p2.dt[..., None] + _mv(p1.dR, p2.dP)

    t2 = p2.dt[..., None, None]
    JRg = p2.dR.transpose(-1, -2) @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * t2 + p1.dR @ p2.JPg
    JPa = p1.JPa + p1.JVa * t2 + p1.dR @ p2.JPa

    # state transition of the segment-2 deltas w.r.t. the segment-1 state
    R1T = p1.dR.transpose(-1, -2)
    I3 = torch.eye(3, dtype=p1.C.dtype, device=p1.C.device).expand(p1.dR.shape)
    Z3 = torch.zeros_like(I3)
    A = torch.cat([
        torch.cat([p2.dR.transpose(-1, -2), Z3, Z3], -1),
        torch.cat([-p1.dR @ lie.hat(p2.dV) @ R1T, I3, Z3], -1),
        torch.cat([-p1.dR @ lie.hat(p2.dP) @ R1T, I3 * t2, I3], -1),
    ], -2)
    C9 = A @ p1.C[..., :9, :9] @ A.transpose(-1, -2) + p2.C[..., :9, :9]
    Cw = p1.C[..., 9:, 9:] + p2.C[..., 9:, 9:]
    Zc = torch.zeros(C9.shape[:-1] + (6,), dtype=C9.dtype, device=C9.device)
    C = torch.cat([torch.cat([C9, Zc], -1),
                   torch.cat([Zc.transpose(-1, -2), Cw], -1)], -2)
    return Preintegrated(
        dt=p1.dt + p2.dt, dR=dR, dV=dV, dP=dP, C=C,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        bg0=p1.bg0, ba0=p1.ba0,
    )


def delta_corrected(pre: Preintegrated, bg: torch.Tensor, ba: torch.Tensor):
    """First-order bias-corrected deltas (reference GetDeltaRotation/
    Velocity/Position). Broadcasts over leading batch dimensions."""
    dbg = bg - pre.bg0
    dba = ba - pre.ba0
    dR = pre.dR @ lie.so3_exp(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return dR, dV, dP


def information_9(pre: Preintegrated) -> torch.Tensor:
    """9x9 information of the (R,V,P) deltas (reference
    GetInformationMatrix keeps the 9x9 block and symmetrizes); NaN where the
    block is singular, as JAX's inverse gives."""
    from eorb_slam_tpu_torch.optim import linalg

    C = 0.5 * (pre.C[..., :9, :9] + pre.C[..., :9, :9].transpose(-1, -2))
    C = C + torch.eye(9, dtype=C.dtype, device=C.device) * 1e-10
    info = linalg.inv_or_nan(C)
    return 0.5 * (info + info.transpose(-1, -2))


def predict_state(
    Rwb: torch.Tensor, pwb: torch.Tensor, vwb: torch.Tensor,
    pre: Preintegrated, bg: torch.Tensor, ba: torch.Tensor,
    g: Optional[torch.Tensor] = None,
):
    """IMU dead-reckoning (reference Tracking::PredictStateIMU): propagate
    the body state through the window."""
    if g is None:
        g = gravity_w(Rwb)
    dR, dV, dP = delta_corrected(pre, bg, ba)
    t = pre.dt[..., None]
    Rwb2 = lie.project_so3(Rwb @ dR)
    vwb2 = vwb + g * t + _mv(Rwb, dV)
    pwb2 = pwb + vwb * t + 0.5 * g * t * t + _mv(Rwb, dP)
    return Rwb2, pwb2, vwb2


def Twb_from_Tcw(Tcw: torch.Tensor, Tbc: torch.Tensor) -> torch.Tensor:
    """Body-in-world pose from camera-from-world. Convention: p_b = Tbc p_c,
    p_c = Tcw p_w, so Twb = (Tbc @ Tcw)^-1."""
    return lie.se3_inv(Tbc @ Tcw)


def Tcw_from_Twb(Twb: torch.Tensor, Tbc: torch.Tensor) -> torch.Tensor:
    return lie.se3_inv(Twb @ Tbc)
