"""Oriented BRIEF descriptors: intensity-centroid orientation + steered
binary tests, bit-packed to 8 words of 32 bits per keypoint.

PyTorch port of ``eorb_slam_tpu/ops/orb.py``, with the same 256-pair
pattern (numpy, seed 1234), so descriptors are bit-identical to the JAX
package's for the same image and keypoints.

Word type: the JAX package packs into ``uint32``; torch has no shift for
``uint32``, so the words here are ``int32`` holding the same bit pattern
(``np.asarray(desc).view(np.uint32)`` gives the JAX words back).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH_R = 15          # orientation patch radius (31x31), as in the reference
DESC_BITS = 256
DESC_WORDS = 8        # 32-bit words


@functools.lru_cache(maxsize=None)
def _orientation_mask():
    """Circular mask + coordinate grids for the 31x31 orientation patch."""
    r = PATCH_R
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (ys**2 + xs**2 <= r**2).astype(np.float32)
    return mask, (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234):
    """(256,4) int32 test pairs (x1,y1,x2,y2), Gaussian sigma=patch/5, clipped."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_R + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(DESC_BITS, 4))
    pts = np.clip(np.round(pts), -PATCH_R + 2, PATCH_R - 2).astype(np.int32)
    # avoid degenerate identical pairs
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] += 1
    return pts


def gather_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """Gather (N, 2r+1, 2r+1) patches centered at integer keypoints xy (N,2);
    centers are clamped so the patch stays inside the image."""
    h, w = img.shape
    x = torch.clamp(xy[:, 0].to(torch.int64), radius, w - 1 - radius)
    y = torch.clamp(xy[:, 1].to(torch.int64), radius, h - 1 - radius)
    d = torch.arange(-radius, radius + 1, device=img.device)
    yy = y[:, None, None] + d[None, :, None]
    xx = x[:, None, None] + d[None, None, :]
    return img[yy, xx]


@functools.lru_cache(maxsize=None)
def _orientation_grids(device: torch.device):
    """The (31,31) masked x and y grids on ``device``, copied there once
    (never written in place)."""
    _, mx, my = _orientation_mask()
    return torch.from_numpy(mx).to(device), torch.from_numpy(my).to(device)


@functools.lru_cache(maxsize=None)
def _brief_pattern_f32(device: torch.device) -> torch.Tensor:
    """The (256,4) test pattern as float32 on ``device``, copied there once
    (never written in place)."""
    return torch.from_numpy(brief_pattern().astype(np.float32)).to(device)


def orientations(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians) per keypoint (N,)."""
    mx, my = _orientation_grids(img.device)
    patches = gather_patches(img, xy, PATCH_R)          # (N,31,31)
    m10 = torch.sum(patches * mx, dim=(-2, -1))
    m01 = torch.sum(patches * my, dim=(-2, -1))
    return torch.atan2(m01, m10)


def describe(img_blur: torch.Tensor, xy: torch.Tensor,
             angle: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF descriptors (N, 8) int32 (uint32 bit pattern) from a
    blurred image level; rotated pattern points are rounded half-to-even
    and read nearest-neighbour."""
    pat = _brief_pattern_f32(img_blur.device)
    ca, sa = torch.cos(angle), torch.sin(angle)          # (N,)

    def rot(px, py):
        rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        return torch.round(rx).to(torch.int64), torch.round(ry).to(torch.int64)

    h, w = img_blur.shape
    x0 = xy[:, 0].to(torch.int64)[:, None]
    y0 = xy[:, 1].to(torch.int64)[:, None]

    def sample(dx, dy):
        xx = torch.clamp(x0 + dx, 0, w - 1)
        yy = torch.clamp(y0 + dy, 0, h - 1)
        return img_blur[yy, xx]                          # (N,256)

    rx1, ry1 = rot(pat[:, 0], pat[:, 1])
    rx2, ry2 = rot(pat[:, 2], pat[:, 3])
    return pack_bits(sample(rx1, ry1) < sample(rx2, ry2))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) bool -> (N,8) int32 words, little-endian within each word
    (the uint32 bit pattern of the JAX package's packing)."""
    bits = bits.to(torch.int64).reshape(-1, DESC_WORDS, 32)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device))
    words = torch.sum(bits * weights, dim=-1)           # [0, 2^32)
    # same 32 bits as int32 (two's complement)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_pm1(desc: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """(N,8) 32-bit words -> (N,256) in {-1,+1}: Hamming distance becomes a
    matmul, d_ham(a,b) = (256 - a_pm1 . b_pm1) / 2."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., None] >> shifts) & 1
    bits = bits.reshape(desc.shape[0], DESC_BITS)
    return (bits * 2 - 1).to(dtype)
