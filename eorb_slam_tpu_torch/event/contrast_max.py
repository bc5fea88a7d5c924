"""Contrast maximization by gradient ascent through the splat.

PyTorch port of ``eorb_slam_tpu/event/contrast_max.py``: the warp, the
Gaussian splat and the contrast objective are one differentiable function
and autograd supplies the gradient. Warp and splat are one kernel
(``tensorize.splat_gauss_se2``) and its backward is one kernel that returns
``dL/dparams``, so an ascent step is two kernel calls and a few small
reductions. The ascent keeps the accept/reject decision on the device
(``torch.where``), so the loop never waits on the host.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch.event import tensorize


def _contrast(params, xy, t_rel, valid, center, H, W, sigma):
    """``center`` is (cx, cy) as Python floats; ``xy``, ``t_rel`` and
    ``valid`` are contiguous. Every event weighs 1 (no polarity)."""
    img = tensorize.splat_gauss_se2(xy, t_rel, params, center, valid, H, W,
                                    sigma=sigma)
    # variance objective (mean-square of the mean-removed image): sharper
    # motion-compensated images concentrate mass -> higher variance
    mu = torch.mean(img)
    return torch.mean((img - mu) ** 2)


def maximize_rt2d(
    xy: torch.Tensor,       # (N,2) event pixel coords
    t_rel: torch.Tensor,    # (N,) relative time in the window (seconds)
    valid: torch.Tensor,    # (N,)
    H: int,
    W: int,
    params0: torch.Tensor = None,   # (3,) [omega, vx, vy] init
    iters: int = 60,
    sigma: float = 1.0,
    lr: float = 1.0,
):
    """Estimate (omega, vx, vy) maximizing the warped-image contrast.

    Returns (params, contrast_final, contrast_initial). Normalized-gradient
    ascent with per-parameter scaling and step-halving on non-improvement.
    Runs 1 + 2*iters forward splats and ``iters`` backward passes."""
    dt, dev = xy.dtype, xy.device
    # what the 1 + 2*iters splats share is made once: contiguous copies of
    # (possibly strided) inputs and the centre
    xy, t_rel, valid = xy.contiguous(), t_rel.contiguous(), valid.contiguous()
    center = (W / 2.0, H / 2.0)
    if params0 is None:
        params0 = torch.zeros(3, dtype=dt, device=dev)

    def f(p):
        return _contrast(p, xy, t_rel, valid, center, H, W, sigma)

    def grad(p):
        p = p.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(f(p), p)
        return g

    # parameter scales: a rotation of 1 rad/s moves corner pixels ~H/2 px/s
    scale = torch.tensor([2.0 / max(H, W), 1.0, 1.0], dtype=dt, device=dev)

    with torch.no_grad():
        p = params0
        best = f(params0)
        c0 = best
        step = torch.tensor(lr, dtype=dt, device=dev)
        for _ in range(iters):
            g = grad(p) * scale * scale  # preconditioned ascent direction
            gn = torch.linalg.norm(g / scale)
            p_new = p + step * g / torch.clamp(gn, min=1e-12)
            c_new = f(p_new)
            better = c_new > best
            p = torch.where(better, p_new, p)
            best = torch.where(better, c_new, best)
            step = torch.where(better, step * 1.1, step * 0.5)
    return p, best, c0


def fit_rt2d_points(
    prev_pts: torch.Tensor,   # (Np,2) KLT reference corners
    cur_pts: torch.Tensor,    # (Np,2) tracked positions
    valid: torch.Tensor,      # (Np,) bool
    dt,                       # () time between the two point sets (seconds)
    center: torch.Tensor,     # (2,) rotation center (image center)
):
    """Closed-form (omega, vx, vy) flow fit from matched points: small-angle
    least squares of flow = dt * [-omega*(y-cy) + vx, omega*(x-cx) + vy]
    against the measured displacements. Returns ((3,) params, () n_used)."""
    w = valid.to(prev_pts.dtype)
    d = cur_pts - prev_pts                                   # (Np,2)
    rx = prev_pts[:, 0] - center[0]
    ry = prev_pts[:, 1] - center[1]
    dt = torch.clamp(torch.as_tensor(dt, dtype=prev_pts.dtype,
                                     device=prev_pts.device), min=1e-9)
    zero = torch.zeros_like(rx)
    one = torch.ones_like(rx)
    # rows: [ -ry 1 0 ; rx 0 1 ] * dt, stacked per point
    A = torch.stack([
        torch.stack([-ry, one, zero], dim=-1),
        torch.stack([rx, zero, one], dim=-1),
    ], dim=1) * dt                                           # (Np,2,3)
    Aw = A * w[:, None, None]
    Hm = torch.einsum("nij,nik->jk", Aw, A)
    b = torch.einsum("nij,ni->j", Aw, d)
    Hm = Hm + 1e-9 * torch.eye(3, dtype=Hm.dtype, device=Hm.device) * torch.clamp(
        torch.trace(Hm) / 3.0, min=1.0
    )
    # solve_ex: no error check, so no wait on the device for its status
    params, _ = torch.linalg.solve_ex(Hm, b)
    params = torch.where(torch.isfinite(params).all(), params,
                         torch.zeros_like(params))
    return params, torch.sum(valid.to(torch.int32))
