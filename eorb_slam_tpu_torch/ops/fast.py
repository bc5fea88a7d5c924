"""Dense vectorized FAST-9/16 corner detection + grid-uniform selection.

PyTorch port of ``eorb_slam_tpu/ops/fast.py``: a dense corner-score map from
whole-image shifts, 3x3 NMS, then the top-K response per fixed grid cell and
a global top-K — the quad-tree's spatially uniform distribution with static
shapes.

Ties: ``jax.lax.top_k`` returns the lower index first among equal values,
and event images have many equal FAST scores. ``torch.topk`` promises no
order on ties, so selection here is a STABLE descending sort, which keeps
the lower index first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle radius 3 (dy, dx), OpenCV pixel order (starting top, clockwise)
CIRCLE = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
ARC = 9
BORDER = 3


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """(H,W,16): the 16 circle neighbors of every pixel (zero border junk)."""
    return torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in CIRCLE],
        dim=-1,
    )


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 score map (H,W). 0 where not a corner.

    Score = max over 9-arcs of (min over arc of |neighbor-center|), kept
    where it exceeds ``threshold``."""
    h, w = img.shape
    d = _circle_stack(img) - img[..., None]      # (H,W,16)

    def arc_reduce(x, op):
        acc = x
        for k in range(1, ARC):
            acc = op(acc, torch.roll(x, -k, dims=-1))
        return acc

    arc_min = arc_reduce(d, torch.minimum)       # min over window starting at idx
    arc_max = arc_reduce(d, torch.maximum)

    score_bright = torch.amax(arc_min, dim=-1)
    score_dark = torch.amax(-arc_max, dim=-1)
    score = torch.maximum(score_bright, score_dark)
    score = torch.where(score > threshold, score, 0.0)

    # kill the border (circle reads wrapped junk there)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    return torch.where(inb, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima in 3x3 windows (-inf padding)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def detect_grid(
    img: torch.Tensor,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 32,
    per_cell: int = 4,
    max_kp: int = 1024,
    border: int = 16,
):
    """FAST + NMS + per-cell top-K + global top-max_kp, with the low
    threshold's scores used in cells where the high threshold found nothing.

    Returns (xy (max_kp,2) float32, resp (max_kp,), valid (max_kp,) bool).
    Coordinates are (x, y) at this level's scale."""
    s_hi = nms3x3(fast_score(img, threshold))
    s_lo = nms3x3(fast_score(img, min_threshold))
    return select_grid(s_hi, s_lo, cell=cell, per_cell=per_cell,
                       max_kp=max_kp, border=border)


def _top_k_stable(v: torch.Tensor, k: int):
    """Top-k along the last dim; among equal values the lower index first
    (the order of ``jax.lax.top_k``)."""
    vs, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vs[..., :k], idx[..., :k]


def select_grid(
    s_hi: torch.Tensor,
    s_lo: torch.Tensor | None = None,
    cell: int = 32,
    per_cell: int = 4,
    max_kp: int = 1024,
    border: int = 16,
):
    """Grid-uniform top-K selection from a response map: per-cell
    top-`per_cell`, then global top-`max_kp`."""
    h, w = s_hi.shape
    dev = s_hi.device
    gh, gw = h // cell, w // cell
    hh, ww = gh * cell, gw * cell

    def cellify(s):
        return s[:hh, :ww].reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(
            gh, gw, cell * cell
        )

    c_hi = cellify(s_hi)
    if s_lo is not None:
        has_hi = torch.any(c_hi > 0, dim=-1, keepdim=True)
        c = torch.where(has_hi, c_hi, cellify(s_lo))
    else:
        c = c_hi

    # mask the image border margin (too close to the edge for descriptors)
    idx_in_cell = torch.arange(cell * cell, device=dev)
    cy = idx_in_cell // cell
    cx = idx_in_cell % cell
    gy = torch.arange(gh, device=dev)[:, None, None]
    gx = torch.arange(gw, device=dev)[None, :, None]
    abs_y = gy * cell + cy[None, None, :]
    abs_x = gx * cell + cx[None, None, :]
    inb = (
        (abs_y >= border) & (abs_y < h - border)
        & (abs_x >= border) & (abs_x < w - border)
    )
    c = torch.where(inb, c, 0.0)

    # top-k per cell
    v, i = _top_k_stable(c, per_cell)                        # (gh,gw,per_cell)
    kp_y = (gy * cell + (i // cell)).reshape(-1)
    kp_x = (gx * cell + (i % cell)).reshape(-1)
    resp = v.reshape(-1)

    # global top max_kp by response
    n = resp.shape[0]
    if n < max_kp:
        pad = max_kp - n
        resp = torch.cat([resp, torch.zeros(pad, dtype=resp.dtype, device=dev)])
        kp_x = torch.cat([kp_x, torch.zeros(pad, dtype=kp_x.dtype, device=dev)])
        kp_y = torch.cat([kp_y, torch.zeros(pad, dtype=kp_y.dtype, device=dev)])
    rv, ri = _top_k_stable(resp, max_kp)
    xy = torch.stack([kp_x[ri], kp_y[ri]], dim=-1).to(torch.float32)
    return xy, rv, rv > 0.0
