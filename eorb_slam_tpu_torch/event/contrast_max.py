"""Contrast maximization by gradient ascent through the splat.

PyTorch port of ``eorb_slam_tpu/event/contrast_max.py``. On the TPU the
whole ascent is one XLA program (a ``fori_loop`` of ``jax.grad`` steps). On
the card it is one kernel launch: ``ops/hopper_splat.splat_ascent_se2``
runs every step in one thread-block cluster, the image in the cluster's
shared memory, each trial image splatted and gathered for its gradient
between two cluster barriers. On CPU tensors it is
:func:`_ascent_loop`, the same ascent written as the kernel runs it, with
no autograd: the contrast's cotangent in closed form feeds the plain SE2
VJP, and the accepted trial's image becomes the current one, so ``iters``
steps splat 1 + iters times. The accept/reject decision stays on the
device (``torch.where``), so the loop never waits on the host.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch._host import constant, scalar
from eorb_slam_tpu_torch.event import tensorize
from eorb_slam_tpu_torch.ops import hopper_splat

_TRUNC = 2.5   # tensorize.splat_gauss_se2's stencil 5, halved


def _variance(img):
    # variance objective (mean-square of the mean-removed image): sharper
    # motion-compensated images concentrate mass -> higher variance
    mu = torch.mean(img)
    return torch.mean((img - mu) ** 2)


def _contrast(params, xy, t_rel, valid, center, H, W, sigma):
    """``center`` is (cx, cy) as Python floats; ``xy``, ``t_rel`` and
    ``valid`` are contiguous. Every event weighs 1 (no polarity)."""
    return _variance(tensorize.splat_gauss_se2(xy, t_rel, params, center, valid,
                                               H, W, sigma=sigma))


def _cotangent(img):
    """d _variance(img) / d img in closed form, as autograd forms it:
    2 (img - mu) / HW, less its mean over the image (the path through
    mu)."""
    gd = ((img - torch.mean(img)) * 2.0) * (1.0 / img.numel())
    return gd - gd.sum() / img.numel()


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
    On CUDA tensors one launch of the ascent kernel; on CPU tensors
    :func:`_ascent_loop`."""
    # contiguous copies of (possibly strided) inputs
    xy, t_rel, valid = xy.contiguous(), t_rel.contiguous(), valid.contiguous()
    if params0 is None:
        params0 = torch.zeros(3, dtype=xy.dtype, device=xy.device)
    ascent = _ascent_kernel if xy.is_cuda else _ascent_loop
    return ascent(xy, t_rel, valid, H, W, params0.contiguous(), iters, sigma, lr)


def _ascent_kernel(xy, t_rel, valid, H, W, params0, iters, sigma, lr, trace=None):
    """The ascent as one launch of ``hopper_splat.splat_ascent_se2``."""
    return hopper_splat.splat_ascent_se2(xy, t_rel, valid, params0, (W / 2.0, H / 2.0),
                                         H, W, iters, sigma, _TRUNC, lr, trace=trace)


def _ascent_loop(xy, t_rel, valid, H, W, params0, iters, sigma, lr, trace=None):
    """The ascent as the kernel runs it, through the pair: the plain
    versions on CPU tensors, the pair's kernels on CUDA tensors (the
    kernel's yardstick). Each step: the gradient at the current point from
    the current image's closed-form cotangent, the preconditioned and
    normalized step, the trial image and its contrast, and the accept
    test; the accepted trial's image becomes the current one. ``trace``
    ((iters + 1, 4)), if given, receives (omega, vx, vy, contrast) of the
    start and of every trial point."""
    dt, dev = xy.dtype, xy.device
    center = (W / 2.0, H / 2.0)

    def image(p):
        return tensorize.splat_gauss_se2(xy, t_rel, p, center, valid, H, W, sigma=sigma)

    # parameter scales: a rotation of 1 rad/s moves corner pixels ~H/2 px/s
    scale = constant((2.0 / max(H, W), 1.0, 1.0), dt, dev)

    with torch.no_grad():
        p, img = params0, image(params0)
        best = c0 = _variance(img)
        step = torch.full((), lr, dtype=dt, device=dev)
        if trace is not None:
            trace[0, :3], trace[0, 3] = p, c0
        for k in range(iters):
            g = hopper_splat.splat_se2_vjp(_cotangent(img), xy, t_rel, valid, p, center,
                                           H, W, sigma, _TRUNC)
            g = g * scale * scale  # preconditioned ascent direction
            gn = torch.linalg.norm(g / scale)
            p_new = p + step * g / torch.clamp(gn, min=1e-12)
            img_new = image(p_new)
            c_new = _variance(img_new)
            if trace is not None:
                trace[k + 1, :3], trace[k + 1, 3] = p_new, c_new
            better = c_new > best
            p = torch.where(better, p_new, p)
            img = torch.where(better, img_new, img)
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
    dt = torch.clamp(scalar(dt, prev_pts), min=1e-9)
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
