"""Event tensorization: Gaussian-splat histograms, motion-compensated
images (MCI), and contrast/focus metrics.

PyTorch port of ``eorb_slam_tpu/event/tensorize.py``. Events are
fixed-shape ``(N,4)`` float tensors ``[ts, x, y, p]`` with validity masks.
The splat is differentiable w.r.t. the warped event coordinates, which is
what makes contrast maximization a plain gradient ascent
(event/contrast_max.py).
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch._host import scalar
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.ops import hopper_splat


def _splat_gauss_separable(
    xy: torch.Tensor, w_ev: torch.Tensor, H: int, W: int,
    sigma: float, trunc: float,
) -> torch.Tensor:
    """Separable-Gaussian splat as two weight matrices and one product.

    G(dx,dy) = gx(dx)·gy(dy), so the image is ``A^T B`` with
    A[n,h] = w_n·gy(h−y_n), B[n,w] = gx(w−x_n). This is the plain version of
    the forward CUDA kernel (ops/hopper_splat.py): the CPU path and the
    reference the kernel is checked against on the card. Autograd through it
    is the independent reference of the gather VJP."""
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    dy = torch.arange(H, dtype=xy.dtype, device=xy.device)[None, :] - xy[:, 1:2]
    dx = torch.arange(W, dtype=xy.dtype, device=xy.device)[None, :] - xy[:, 0:1]
    A = torch.exp(-dy * dy * inv2s2) * (torch.abs(dy) <= trunc)
    A = A * w_ev[:, None]
    B = torch.exp(-dx * dx * inv2s2) * (torch.abs(dx) <= trunc)
    return A.transpose(0, 1) @ B


def splat_gauss(
    xy: torch.Tensor,        # (N,2) continuous pixel coords of the events
    valid: torch.Tensor,     # (N,) bool
    pol: torch.Tensor,       # (N,) +-1 polarity
    H: int,
    W: int,
    sigma: float = 1.0,
    stencil: int = 5,
    use_polarity: bool = False,
) -> torch.Tensor:
    """Accumulate each event as a truncated 2D Gaussian (reference
    ``EvImConverter::ev2im_gauss``). Returns (H,W) float; differentiable
    w.r.t. ``xy``. Dispatches to the splat kernel's wrapper, which runs the
    CUDA kernel on the card and the separable form on the CPU."""
    w_ev = (pol if use_polarity else torch.ones_like(xy[:, 0])) * valid.to(xy.dtype)
    trunc = stencil / 2.0  # matches the reference's truncated 3-sigma window
    return hopper_splat.splat(xy.contiguous(), w_ev.contiguous(), H, W,
                              sigma, trunc)


def splat_gauss_se2(
    xy: torch.Tensor,        # (N,2) UNWARPED pixel coords of the events
    t_rel: torch.Tensor,     # (N,) event times the warp multiplies
    params: torch.Tensor,    # (3,) [omega, vx, vy], on the events' device
    center,                  # (cx, cy) as two Python floats
    valid: torch.Tensor,     # (N,) bool
    H: int,
    W: int,
    sigma: float = 1.0,
    stencil: int = 5,
) -> torch.Tensor:
    """``splat_gauss(warp_se2(xy, t_rel, params, center), valid, ...)``
    without polarity, the warp fused into the splat kernel: no warped
    coordinates or weights reach device memory. Differentiable w.r.t.
    ``params`` (the contrast-maximization ascent's gradient). ``xy``,
    ``t_rel`` and ``valid`` must be contiguous."""
    return hopper_splat.splat_se2(xy, t_rel, valid, params, center, H, W,
                                  sigma, stencil / 2.0)


def normalize_to_image(acc: torch.Tensor) -> torch.Tensor:
    """Scale accumulator to [0,1] (the reference normalizes to 8-bit)."""
    lo = torch.amin(acc)
    hi = torch.amax(acc)
    return (acc - lo) / torch.clamp(hi - lo, min=1e-12)


# ------------------------------------------------------------------- warps


def warp_se2(xy: torch.Tensor, t_rel: torch.Tensor, params: torch.Tensor,
             center: torch.Tensor):
    """2D rotation+translation flow warp: each event is rotated by
    ``omega * t_rel`` about ``center`` and shifted by ``v * t_rel``.
    params = [omega, vx, vy]."""
    w, vx, vy = params[0], params[1], params[2]
    a = w * t_rel
    ca, sa = torch.cos(a), torch.sin(a)
    rel = xy - center
    x = ca * rel[:, 0] - sa * rel[:, 1] + center[0] - vx * t_rel
    y = sa * rel[:, 0] + ca * rel[:, 1] + center[1] - vy * t_rel
    return torch.stack([x, y], dim=1)


def warp_se3_depth(
    xy: torch.Tensor,          # (N,2) undistorted pixel coords
    t_rel: torch.Tensor,       # (N,) in [0,1] relative timestamp in window
    T0: torch.Tensor,          # (4,4) Tcw at window start
    T1: torch.Tensor,          # (4,4) Tcw at window end
    cam_params: torch.Tensor,
    depth,                     # scalar median depth OR (N,) per-event depth
):
    """Warp events to the window-END frame through an SE3 interpolation
    and a constant/median scene depth. Returns (pixels (N,2), depth in the
    end frame (N,))."""
    rays = cam_mod.pinhole_unproject_linear(cam_params, xy)   # (N,3)
    depth = scalar(depth, xy)
    pts_c = rays * depth.expand(xy.shape[0])[:, None]

    # camera pose at each event time, point to world (batched over events)
    T_t = lie.interpolate_se3(T0, T1, t_rel)                   # (N,4,4)
    Twc = lie.se3_inv(T_t)
    pts_w = lie.se3_apply(Twc, pts_c)
    # reproject into the window-end camera
    pts_1 = lie.se3_apply(T1, pts_w)
    return cam_mod.pinhole_project_linear(cam_params, pts_1), pts_1[..., 2]


def warp_se3_depthmap(
    xy: torch.Tensor,
    t_rel: torch.Tensor,
    T0: torch.Tensor,
    T1: torch.Tensor,
    cam_params: torch.Tensor,
    depth_map: torch.Tensor,   # (H,W) per-pixel depth, <=0 marks holes
    default_depth,             # scalar fallback for holes
):
    """Per-pixel-depth variant of :func:`warp_se3_depth`: each event
    unprojects through the depth at its nearest pixel; holes fall back to
    ``default_depth``."""
    H, W = depth_map.shape
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    d = depth_map[yi, xi]
    d = torch.where(d > 0, d, scalar(default_depth, d))
    return warp_se3_depth(xy, t_rel, T0, T1, cam_params, d)


# ------------------------------------------------------------- focus metrics


def image_std(img: torch.Tensor, valid_mask=None) -> torch.Tensor:
    """Global contrast: population STD of the (optionally masked) image."""
    if valid_mask is None:
        return torch.std(img, correction=0)
    w = valid_mask.to(img.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(img * w) / n
    return torch.sqrt(torch.sum(w * (img - mu) ** 2) / n)


def patch_std_mean(img: torch.Tensor, patch: int = 30) -> torch.Tensor:
    """Mean of patchwise STDs — the MCI selection score. Takes (H,W) or a
    batch (...,H,W) and returns one score per image."""
    H, W = img.shape[-2:]
    ph = H // patch
    pw = W // patch
    crop = img[..., : ph * patch, : pw * patch]
    tiles = crop.reshape(*img.shape[:-2], ph, patch, pw, patch)
    mu = torch.mean(tiles, dim=(-3, -1))
    mu2 = torch.mean(tiles * tiles, dim=(-3, -1))
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    return torch.mean(torch.sqrt(var), dim=(-2, -1))


def event_gen_rate(n_events, t_span, n_pixels) -> torch.Tensor:
    """Events per pixel per second (reference calcEventGenRate)."""
    t_span = torch.as_tensor(t_span, dtype=torch.float32)
    return n_events / (torch.clamp(t_span, min=1e-9) * n_pixels)
