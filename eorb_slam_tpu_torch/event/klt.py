"""Pyramidal Lucas-Kanade tracking, batched over points.

PyTorch port of ``eorb_slam_tpu/event/klt.py``: the inverse-compositional
formulation — per-point template gradients and the 2x2 Gauss-Newton Hessian
are computed once from the reference image, then each pyramid level runs a
fixed number of update iterations with all points in lockstep. Factor-2
pyramid via average pooling.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch._host import constant


def _bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img (H,W) at continuous (x,y) points (...,2); zero padding."""
    H, W = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi, w):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return torch.where(inb, v, 0.0) * w

    return (
        tap(y0i, x0i, (1 - fx) * (1 - fy))
        + tap(y0i, x0i + 1, fx * (1 - fy))
        + tap(y0i + 1, x0i, (1 - fx) * fy)
        + tap(y0i + 1, x0i + 1, fx * fy)
    )


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Factor-2 average-pool downsample."""
    H, W = img.shape
    h2, w2 = H // 2, W // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(dim=(1, 3))


class KLTResult(NamedTuple):
    xy: torch.Tensor       # (N,2) tracked positions in the current image
    ok: torch.Tensor       # (N,) bool — converged, in-bounds, good NCC
    err: torch.Tensor      # (N,) mean abs photometric residual
    ncc: torch.Tensor      # (N,) template/patch normalized cross-correlation


def track(
    img_ref: torch.Tensor,    # (H,W) float
    img_cur: torch.Tensor,    # (H,W)
    xy0: torch.Tensor,        # (N,2) points in the reference image
    valid: torch.Tensor,      # (N,)
    guess: torch.Tensor = None,  # (N,2) initial positions in cur (def: xy0)
    win: int = 11,
    levels: int = 3,
    iters: int = 8,
    min_ncc: float = 0.5,
) -> KLTResult:
    H, W = img_ref.shape
    dt, dev = img_ref.dtype, img_ref.device
    if guess is None:
        guess = xy0
    half = win // 2
    rng = torch.arange(-half, half + 1, dtype=dt, device=dev)
    oy, ox = torch.meshgrid(rng, rng, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)  # (w2,2)
    ex = constant((1.0, 0.0), dt, dev)
    ey = constant((0.0, 1.0), dt, dev)

    pyr_ref = [img_ref]
    pyr_cur = [img_cur]
    for _ in range(levels - 1):
        pyr_ref.append(downsample2(pyr_ref[-1]))
        pyr_cur.append(downsample2(pyr_cur[-1]))

    d = (guess - xy0) / (2.0 ** (levels - 1))   # displacement at coarsest
    p_ref = xy0

    for lv in range(levels - 1, -1, -1):
        Ir = pyr_ref[lv]
        Ic = pyr_cur[lv]
        s = 2.0 ** lv
        pr = p_ref / s                                       # (N,2)

        # template patch + gradients at the reference position
        pts = pr[:, None, :] + offs[None, :, :]              # (N,w2,2)
        T = _bilinear(Ir, pts)                               # (N,w2)
        gx = 0.5 * (_bilinear(Ir, pts + ex) - _bilinear(Ir, pts - ex))
        gy = 0.5 * (_bilinear(Ir, pts + ey) - _bilinear(Ir, pts - ey))
        Hxx = torch.sum(gx * gx, dim=1)
        Hxy = torch.sum(gx * gy, dim=1)
        Hyy = torch.sum(gy * gy, dim=1)
        det = Hxx * Hyy - Hxy * Hxy
        inv_ok = det > 1e-6
        det_s = torch.where(inv_ok, det, 1.0)

        for _ in range(iters):
            cur = (pr + d)[:, None, :] + offs[None, :, :]
            r = _bilinear(Ic, cur) - T                       # (N,w2)
            bx = torch.sum(gx * r, dim=1)
            by = torch.sum(gy * r, dim=1)
            dx = (Hyy * bx - Hxy * by) / det_s
            dy = (Hxx * by - Hxy * bx) / det_s
            step = torch.stack([dx, dy], dim=-1)
            step = torch.where(inv_ok[:, None], step, 0.0)
            d = d - step
        if lv > 0:
            d = d * 2.0

    xy = xy0 + d
    # final residual + validity
    I = _bilinear(pyr_cur[0], xy[:, None, :] + offs[None, :, :])
    T0 = _bilinear(pyr_ref[0], xy0[:, None, :] + offs[None, :, :])
    err = torch.mean(torch.abs(I - T0), dim=1)
    # quality gate: normalized cross-correlation between template and the
    # tracked patch — 0 for vanished or occluded targets
    muI = torch.mean(I, dim=1, keepdim=True)
    muT = torch.mean(T0, dim=1, keepdim=True)
    ncc = torch.sum((I - muI) * (T0 - muT), dim=1) / (
        torch.sqrt(torch.sum((I - muI) ** 2, dim=1)
                   * torch.sum((T0 - muT) ** 2, dim=1)) + 1e-9
    )
    inb = (
        (xy[:, 0] >= half) & (xy[:, 0] < W - half)
        & (xy[:, 1] >= half) & (xy[:, 1] < H - half)
    )
    ok = valid & inb & (ncc >= min_ncc)
    return KLTResult(xy=xy, ok=ok, err=err, ncc=ncc)


def median_displacement(res: KLTResult, xy0: torch.Tensor) -> torch.Tensor:
    """Median pixel displacement of good tracks (NaN if none) — drives the
    adaptive event window size.

    Matches ``jnp.nanmedian``: on an even count it averages the two middle
    values (``torch.nanmedian`` returns the lower one). Computed on the
    device without reading the count back."""
    disp = torch.linalg.norm(res.xy - xy0, dim=-1)
    disp = torch.where(res.ok, disp, torch.inf)
    srt, _ = torch.sort(disp)
    n = torch.sum(res.ok)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=disp.shape[0] - 1)
    mid = srt.index_select(0, torch.stack([lo, hi]))  # no host read of n
    return torch.where(n > 0, 0.5 * (mid[0] + mid[1]), torch.nan)
