"""Image pyramid + separable Gaussian blur.

PyTorch port of ``eorb_slam_tpu/ops/pyramid.py``: 8 levels, scale factor
1.2, bilinear downsampling, 7x7 sigma=2 Gaussian blur before descriptor
sampling.

The JAX package resizes with ``jax.image.resize(..., "bilinear")``, whose
default ``antialias=True`` widens the triangle kernel by the downscale
factor. ``F.interpolate(mode="bilinear")`` is a different function, so the
resize here builds the same weight matrices as JAX's ``scale_and_translate``
and applies them as two small matrix products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

N_LEVELS = 8
SCALE_FACTOR = 1.2


def level_shapes(h: int, w: int, n_levels: int = N_LEVELS, scale: float = SCALE_FACTOR):
    """Static per-level (h, w)."""
    return [
        (max(int(round(h / scale**l)), 16), max(int(round(w / scale**l)), 16))
        for l in range(n_levels)
    ]


def scale_factors(n_levels: int = N_LEVELS, scale: float = SCALE_FACTOR):
    return np.asarray([scale**l for l in range(n_levels)], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of an antialiased triangle resize, as
    ``jax._src.image.scale.compute_weight_mat`` builds them (translation 0)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale)
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, np.float32(1.0)),
        np.float32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, shape) -> torch.Tensor:
    """(H,W) -> ``shape`` with JAX's antialiased bilinear resize."""
    h, w = img.shape
    ho, wo = shape
    out = img
    if ho != h:
        out = _resize_weights(h, ho, img.device).transpose(0, 1) @ out
    if wo != w:
        out = out @ _resize_weights(w, wo, img.device)
    return out


def build_pyramid(img: torch.Tensor, n_levels: int = N_LEVELS,
                  scale: float = SCALE_FACTOR) -> list[torch.Tensor]:
    """img (H,W) float32 in [0,255] -> list of (h_l, w_l) levels."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


@functools.lru_cache(maxsize=None)
def _gauss_kernel(ksize: int, sigma: float):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2 * sigma**2))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate padding, as shift-and-add of
    the 7 taps in the same order as the JAX package."""
    k = _gauss_kernel(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, pad, pad), mode="replicate")[0, 0]
    x = sum(k[i] * x[i:i + h] for i in range(ksize))
    x = F.pad(x[None, None], (pad, pad, 0, 0), mode="replicate")[0, 0]
    x = sum(k[i] * x[:, i:i + w] for i in range(ksize))
    return x
