"""AKAZE features: nonlinear diffusion scale space, Hessian detection, and
MLDB binary descriptors.

PyTorch port of ``eorb_slam_tpu/ops/akaze.py``, the reference's AKAZE
channel (``AKAZEextractor`` wrapping ``cv::AKAZE``, include/MixedFrame.h)
used by the mixed feature mode (``Features.mode: 2``):

- the nonlinear scale space runs a fixed number of explicit Perona-Malik
  (g2 conductivity) diffusion steps per pyramid level;
- the contrast parameter k is a gradient-energy statistic of the image
  (no histogram percentile);
- detection is the scale-normalized determinant of Hessian with 3x3 NMS and
  the shared grid-uniform selector (ops/fast.select_grid);
- MLDB samples a rotated 24x24 patch per keypoint, mean-pools it into
  2x2 / 3x3 / 4x4 grids over three channels (intensity, rotated gradient
  dx', dy') and compares all intra-grid cell pairs: 486 bits, of which a
  fixed random 256 are kept, so descriptors pack into the same (K,8) word /
  +-1 int8 layout the Hamming matcher uses.

Every stencil sums its taps in the JAX package's order (row-major, zero
taps skipped): 48 explicit diffusion steps per image amplify any
reordering of a step's f32 sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from eorb_slam_tpu_torch.ops import fast, orb, pyramid

# --------------------------------------------------------- derivatives

_SCHARR_X = np.asarray([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32.0


def _scharr(img: torch.Tensor):
    """Scharr x/y first derivatives (AKAZE's derivative filter)."""
    return _conv2(img, _SCHARR_X), _conv2(img, _SCHARR_X.T)


def _conv2(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Small 2-D correlation with zero padding, as shift-and-add of the
    taps in row-major order (zero taps skipped)."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    h, w = img.shape
    x = F.pad(img, (pw, pw, ph, ph))
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            kv = float(k[i, j])
            if kv == 0.0:
                continue
            out = out + kv * x[i:i + h, j:j + w]
    return out


def _pad_edge(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Replicate one row (dim 0) or column (dim 1) on each side."""
    first, last = x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([first, x, last], dim=dim)


# ------------------------------------------------- nonlinear scale space


def contrast_k(img: torch.Tensor) -> torch.Tensor:
    """Contrast factor for the g2 conductivity: sqrt(2 E[|grad|^2]) over
    the significant gradients of the lightly blurred image (a fixed-shape
    stand-in for AKAZE's 70th gradient percentile). 0-dim tensor."""
    gx, gy = _scharr(pyramid.gaussian_blur(img, ksize=5, sigma=1.0))
    m2 = gx * gx + gy * gy
    w = (m2 > 1e-6).to(torch.float32)
    mean = torch.sum(m2 * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.sqrt(2.0 * mean) + 1e-6


def diffuse(img: torch.Tensor, k: torch.Tensor, steps: int,
            dt: float = 0.2) -> torch.Tensor:
    """``steps`` explicit Perona-Malik steps with g2 conductivity (dt <=
    0.25 for stability); the divergence of g grad(L) from axis-aligned
    half-point fluxes with replicated borders."""
    L = img
    for _ in range(steps):
        gx, gy = _scharr(L)
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))
        gl, gu = _pad_edge(L, 1), _pad_edge(L, 0)
        gpx, gpy = _pad_edge(g, 1), _pad_edge(g, 0)
        flux_e = 0.5 * (gpx[:, 2:] + g) * (gl[:, 2:] - L)
        flux_w = 0.5 * (gpx[:, :-2] + g) * (gl[:, :-2] - L)
        flux_s = 0.5 * (gpy[2:, :] + g) * (gu[2:, :] - L)
        flux_n = 0.5 * (gpy[:-2, :] + g) * (gu[:-2, :] - L)
        L = L + dt * (flux_e + flux_w + flux_s + flux_n)
    return L


def nonlinear_scale_space(
    img: torch.Tensor, n_levels: int = pyramid.N_LEVELS,
    steps_per_level: int = 6,
) -> list[torch.Tensor]:
    """Per-pyramid-level nonlinearly diffused images: level l is the 1.2^l
    downscale, seeded from the previous diffused level and diffused
    ``steps_per_level`` more steps (edges survive, flat regions smooth)."""
    levels = pyramid.build_pyramid(img, n_levels)
    k = contrast_k(img)
    out = []
    L = None
    for base in levels:
        seed = base if L is None else pyramid.resize_bilinear(L, base.shape)
        L = diffuse(seed, k, steps_per_level)
        out.append(L)
    return out


# -------------------------------------------------------------- detection


def hessian_response(L: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized determinant of Hessian (AKAZE's detector)."""
    gx, gy = _scharr(L)
    Lxx, Lxy = _scharr(gx)
    _, Lyy = _scharr(gy)
    return (sigma**4) * (Lxx * Lyy - Lxy * Lxy)


# ------------------------------------------------------------ descriptors

_PATCH = 24           # sampled patch side (level pixels)
_GRIDS = (2, 3, 4)    # MLDB subdivision grids
_N_RAW_BITS = sum(3 * g * g * (g * g - 1) // 2 for g in _GRIDS)  # 486


@functools.lru_cache()
def _mldb_layout():
    """Sampling offsets (S,2), cell ids per grid, the cell pairs per grid,
    and the fixed random 256-of-486 bit subset (OpenCV AKAZE_MLDB
    descriptor_size semantics). The JAX package's numpy, seed 42."""
    half = _PATCH / 2.0
    ys, xs = np.mgrid[0:_PATCH, 0:_PATCH]
    offs = np.stack([xs - half + 0.5, ys - half + 0.5], axis=-1).reshape(-1, 2)
    cells = []
    for g in _GRIDS:
        cell = np.minimum((offs + half) // (_PATCH / g), g - 1)
        cells.append((cell[:, 1] * g + cell[:, 0]).astype(np.int32))
    pairs = []
    for g in _GRIDS:
        n = g * g
        pairs.append(np.asarray(
            [(i, j) for i in range(n) for j in range(i + 1, n)], np.int32
        ))
    rng = np.random.default_rng(42)
    subset = np.sort(rng.choice(_N_RAW_BITS, 256, replace=False)).astype(
        np.int32
    )
    return offs.astype(np.float32), cells, pairs, subset


@functools.lru_cache(maxsize=None)
def _mldb_tables(device: torch.device):
    """``_mldb_layout`` on ``device``: offsets (S,2), per grid the cell of
    each sample (S,) and the compared cell pairs (P,2), and the bit subset
    (256,); copied there once (never written in place)."""
    offs_np, cells, pairs, subset = _mldb_layout()
    return (torch.from_numpy(offs_np).to(device),
            [torch.from_numpy(c).long().to(device) for c in cells],
            [torch.from_numpy(p).long().to(device) for p in pairs],
            torch.from_numpy(subset).long().to(device))


def mldb_describe(L: torch.Tensor, xy: torch.Tensor,
                  angle: torch.Tensor) -> torch.Tensor:
    """(N,8) int32 (uint32 bit pattern) MLDB-256 descriptors from one
    diffused level."""
    offs, cell_ids, pair_ids, subset = _mldb_tables(L.device)   # offs (S,2)
    ca, sa = torch.cos(angle), torch.sin(angle)            # (N,)

    rx = ca[:, None] * offs[None, :, 0] - sa[:, None] * offs[None, :, 1]
    ry = sa[:, None] * offs[None, :, 0] + ca[:, None] * offs[None, :, 1]
    h, w = L.shape
    xx = torch.clamp(torch.round(xy[:, 0:1] + rx).to(torch.int64), 0, w - 1)
    yy = torch.clamp(torch.round(xy[:, 1:2] + ry).to(torch.int64), 0, h - 1)
    val = L[yy, xx]                                        # (N,S) intensity
    gx_im, gy_im = _scharr(L)
    gx = gx_im[yy, xx]
    gy = gy_im[yy, xx]
    # rotate gradients into the keypoint frame
    dx = ca[:, None] * gx + sa[:, None] * gy
    dy = -sa[:, None] * gx + ca[:, None] * gy
    chans = torch.stack([val, dx, dy], dim=1)              # (N,3,S)

    bits = []
    for g, cid, pi in zip(_GRIDS, cell_ids, pair_ids):     # cid (S,), pi (P,2)
        one_hot = F.one_hot(cid, g * g).to(L.dtype)        # (S,C)
        counts = one_hot.sum(dim=0)                        # (C,)
        means = torch.einsum("nks,sc->nkc", chans, one_hot) / counts  # (N,3,C)
        cmp = means[..., pi[:, 0]] > means[..., pi[:, 1]]  # (N,3,P)
        bits.append(cmp.reshape(cmp.shape[0], -1))
    raw = torch.cat(bits, dim=1)                           # (N,486)
    sel = raw[:, subset]                                   # (N,256)
    return orb.pack_bits(sel)


@functools.lru_cache(maxsize=None)
def _disk_window(radius: int, device: torch.device):
    """The disk's x and y offsets and Gaussian weights on ``device``, copied
    there once (never written in place)."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    keep = (xs**2 + ys**2) <= radius * radius
    w_np = np.exp(-(xs**2 + ys**2) / (2.0 * (0.5 * radius) ** 2)) * keep
    return (torch.from_numpy(xs[keep]).to(device), torch.from_numpy(ys[keep]).to(device),
            torch.from_numpy(w_np[keep].astype(np.float32)).to(device))


def gradient_orientation(L: torch.Tensor, xy: torch.Tensor,
                         radius: int = 6) -> torch.Tensor:
    """Dominant gradient direction in a disk window: the Gaussian-weighted
    gradient mean (AKAZE's main orientation, simplified from the
    sliding-wedge vote; the same first moment)."""
    gx_im, gy_im = _scharr(L)
    ox, oy, wv = _disk_window(radius, L.device)
    h, w = L.shape
    xx = torch.clamp(xy[:, 0:1].to(torch.int64) + ox[None, :], 0, w - 1)
    yy = torch.clamp(xy[:, 1:2].to(torch.int64) + oy[None, :], 0, h - 1)
    mx = torch.sum(gx_im[yy, xx] * wv[None, :], dim=1)
    my = torch.sum(gy_im[yy, xx] * wv[None, :], dim=1)
    return torch.atan2(my, mx)


# ------------------------------------------------------------- extraction


def extract_akaze(
    img: torch.Tensor,
    max_kp: int = 512,
    n_levels: int = pyramid.N_LEVELS,
    threshold: float = 1e-4,
    cell: int = 32,
    per_cell: int = 5,
    steps_per_level: int = 6,
):
    """img (H,W) [0,255] (uint8 or float) -> frontend.Features with MLDB-256
    descriptors (the same fixed-capacity layout as ORB extraction)."""
    from eorb_slam_tpu_torch.ops import frontend

    img = img.to(torch.float32) / 255.0  # diffusion stability + threshold scale
    space = nonlinear_scale_space(img, n_levels, steps_per_level)
    quotas = frontend.level_quotas(max_kp, n_levels)
    scales = pyramid.scale_factors(n_levels)

    parts = []
    for l, (L, quota) in enumerate(zip(space, quotas)):
        if quota <= 0:
            continue
        resp = hessian_response(L, sigma=1.0 + 0.4 * l)
        resp = fast.nms3x3(torch.where(resp > threshold, resp, 0.0))
        xy, r, valid = fast.select_grid(
            resp, None, cell=cell, per_cell=per_cell, max_kp=quota,
            border=_PATCH // 2 + 2,
        )
        ang = gradient_orientation(L, xy)
        desc = mldb_describe(L, xy, ang)
        parts.append((
            xy * float(scales[l]), ang,
            torch.full((quota,), l, dtype=torch.int32, device=img.device),
            r, desc, valid,
        ))

    xy, angle, octave, response, desc, valid = (
        torch.cat(field) for field in zip(*parts))
    desc_pm1 = orb.unpack_pm1(desc) * valid[:, None].to(torch.int8)
    return frontend.Features(xy, angle, octave, response, desc, desc_pm1, valid)
