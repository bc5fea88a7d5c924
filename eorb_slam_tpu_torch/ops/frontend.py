"""Full ORB feature extraction: pyramid -> FAST -> orientation -> descriptors.

PyTorch port of ``eorb_slam_tpu/ops/frontend.py``: one call per image
producing fixed-capacity keypoint tensors with octave bookkeeping
(``extract``, one graph replay per image on the card), and the mixed ORB +
AKAZE extraction (``extract_mixed``). Per-level keypoint budgets are
geometric in 1/scale, as in the reference ORBextractor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.ops import fast, orb, pyramid


class Features(NamedTuple):
    xy: torch.Tensor        # (K,2) float32 — level-0 pixel coords (distorted)
    angle: torch.Tensor     # (K,) float32 radians
    octave: torch.Tensor    # (K,) int32 pyramid level
    response: torch.Tensor  # (K,) float32 FAST score
    desc: torch.Tensor      # (K,8) int32 packed rBRIEF (uint32 bit pattern)
    desc_pm1: torch.Tensor  # (K,256) int8 {-1,+1} for matmul matching
    valid: torch.Tensor     # (K,) bool

    @property
    def capacity(self):
        return self.xy.shape[0]


def level_quotas(max_kp: int, n_levels: int = pyramid.N_LEVELS,
                 scale: float = pyramid.SCALE_FACTOR):
    """Per-level keypoint budgets, geometric in 1/scale."""
    inv = 1.0 / scale
    total = (1 - inv**n_levels) / (1 - inv)
    quotas = [int(round(max_kp * inv**l / total)) for l in range(n_levels)]
    quotas[-1] = max_kp - sum(quotas[:-1])
    return quotas


def inv_sigma(octave: torch.Tensor, scale: float = pyramid.SCALE_FACTOR):
    """Per-octave inverse scale used for measurement information."""
    return (1.0 / scale) ** octave.to(torch.float32)


def _extract(
    img: torch.Tensor,
    max_kp: int = 1024,
    n_levels: int = pyramid.N_LEVELS,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 32,
    per_cell: int = 5,
) -> Features:
    """img (H,W) [0,255] (uint8 or float) -> Features with capacity max_kp."""
    img = img.to(torch.float32)
    levels = pyramid.build_pyramid(img, n_levels)
    quotas = level_quotas(max_kp, n_levels)
    scales = pyramid.scale_factors(n_levels)

    parts = []
    for l, (img_l, quota) in enumerate(zip(levels, quotas)):
        if quota <= 0:
            continue
        xy, resp, valid = fast.detect_grid(
            img_l,
            threshold=threshold,
            min_threshold=min_threshold,
            cell=cell,
            per_cell=per_cell,
            max_kp=quota,
            border=orb.PATCH_R + 1,
        )
        ang = orb.orientations(img_l, xy)
        desc = orb.describe(pyramid.gaussian_blur(img_l), xy, ang)
        parts.append((
            xy * float(scales[l]), ang,
            torch.full((quota,), l, dtype=torch.int32, device=img.device),
            resp, desc, valid,
        ))

    xy, angle, octave, response, desc, valid = (
        torch.cat(field) for field in zip(*parts))
    desc_pm1 = orb.unpack_pm1(desc)
    # zero invalid descriptors so matmul matching can't pick them up via
    # accidental agreement (their distance is forced by the valid mask too)
    desc_pm1 = desc_pm1 * valid[:, None].to(torch.int8)
    return Features(xy, angle, octave, response, desc, desc_pm1, valid)


# one dispatch per image, as the reference's jit with static max_kp,
# n_levels, cell, per_cell; the FAST thresholds are Python floats here, so
# they are in the key too. The image's dtype is part of the key (a uint8
# frame and a float32 one are two graphs).
extract = _graphs.GraphRunner(
    _extract, static=("max_kp", "n_levels", "threshold", "min_threshold", "cell",
                      "per_cell"))


def extract_mixed(
    img: torch.Tensor,
    max_kp: int = 1024,
    orb_frac: float = 0.5,
    **akaze_kw,
):
    """Mixed ORB + AKAZE extraction (reference MixedFrame, Features.mode 2):
    one fixed-capacity Features whose first ``round(orb_frac*max_kp)`` slots
    are ORB keypoints and the rest AKAZE (MLDB-256), plus a (K,) int32
    channel array (0 = ORB, 1 = AKAZE). Both descriptors share the 256-bit
    +-1 layout, so matching needs no per-point type dispatch; a random
    cross-channel pair lies ~10 sigma from any match threshold."""
    from eorb_slam_tpu_torch.ops import akaze

    n_orb = int(round(max_kp * orb_frac))
    n_ak = max_kp - n_orb
    f_orb = extract(img, max_kp=n_orb)
    f_ak = akaze.extract_akaze(img, max_kp=n_ak, **akaze_kw)
    cat = Features(*[torch.cat([a, b]) for a, b in zip(f_orb, f_ak)])
    channel = torch.cat([
        torch.zeros(n_orb, dtype=torch.int32, device=img.device),
        torch.ones(n_ak, dtype=torch.int32, device=img.device),
    ])
    return cat, channel
