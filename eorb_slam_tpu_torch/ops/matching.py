"""Descriptor matching as matmul-shaped reductions.

PyTorch port of ``eorb_slam_tpu/ops/matching.py``: one core primitive, a
masked Hamming distance matrix from {-1,+1}-unpacked descriptors, followed
by masked top-2 reductions. Every search variant of the reference becomes a
boolean mask on the distance matrix.

The JAX package computes the Hamming product as an int8 matmul into int32.
``torch.matmul`` has no int8/int32 kernel on CUDA, so the +-1 product runs
in float32: every partial sum is an integer of magnitude <= 256, exact in
f32 in any summation order (and under TF32, whose inputs +-1/0 are exact),
so the distances are the same integers. ``argmin`` ties go to the first
index on both sides.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch.ops.fast import _top_k_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 10_000  # sentinel distance for masked pairs (> any Hamming distance)


def hamming_matrix(desc1_pm1: torch.Tensor, desc2_pm1: torch.Tensor) -> torch.Tensor:
    """(N,256)x(M,256) {-1,+1} int8 -> (N,M) int32 Hamming distances."""
    dot = (desc1_pm1.to(torch.float32) @ desc2_pm1.to(torch.float32).T).to(torch.int32)
    return torch.div(256 - dot, 2, rounding_mode="floor")


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns.

    Returns (best_idx (N,), best_d (N,), second_d (N,))."""
    d = torch.where(mask, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], BIG)
    second_d = torch.amin(d2, dim=1)
    return best_idx, best_d, second_d


def mutual_filter(best12: torch.Tensor, best21: torch.Tensor) -> torch.Tensor:
    """Cross-check: keep match i->j only if j->i. (N,) bool."""
    return best21[best12] == torch.arange(best12.shape[0], device=best12.device)


def rotation_consistency(
    angles1: torch.Tensor,
    angles2: torch.Tensor,
    best12: torch.Tensor,
    matched: torch.Tensor,
    keep_bins: int = 3,
) -> torch.Tensor:
    """ORB-SLAM's 30-bin rotation histogram check: keep only matches whose
    angle difference falls into the `keep_bins` most popular bins (ties to
    the lower bin, as ``lax.top_k``)."""
    dtheta = torch.remainder(angles1 - angles2[best12], 2 * torch.pi)
    bins = torch.floor(dtheta / (2 * torch.pi) * HISTO_LENGTH).to(torch.int64)
    bins = torch.clamp(bins, 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device)
    hist = hist.index_add(0, bins, matched.to(torch.int32))
    _, top = _top_k_stable(hist, keep_bins)
    in_top = torch.any(bins[:, None] == top[None, :], dim=1)
    return matched & in_top


def match_nnratio(
    desc1_pm1: torch.Tensor,
    valid1: torch.Tensor,
    desc2_pm1: torch.Tensor,
    valid2: torch.Tensor,
    pair_mask: torch.Tensor | None = None,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.75,
    mutual: bool = True,
):
    """Generic masked NN-ratio matcher.

    Returns (match12 (N,) int32 — index into 2 or -1, dist (N,) int32)."""
    dist = hamming_matrix(desc1_pm1, desc2_pm1)
    mask = valid1[:, None] & valid2[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    best12, d1, d2 = masked_best2(dist, mask)
    ok = (d1 <= max_dist) & (d1 <= nn_ratio * d2)
    if mutual:
        best21 = torch.argmin(torch.where(mask, dist, BIG).T, dim=1)
        ok = ok & mutual_filter(best12, best21)
    return (torch.where(ok, best12.to(torch.int32), -1),
            torch.where(ok, d1, BIG))


def window_mask(xy1: torch.Tensor, xy2: torch.Tensor, radius: float) -> torch.Tensor:
    """(N,M) bool: pairs within a pixel search window (projection search)."""
    d2 = torch.sum((xy1[:, None, :] - xy2[None, :, :]) ** 2, dim=-1)
    return d2 <= radius * radius


def level_mask(lv1: torch.Tensor, lv2: torch.Tensor, max_diff: int = 1) -> torch.Tensor:
    """(N,M) bool: pyramid-level compatibility gate."""
    return torch.abs(lv1[:, None] - lv2[None, :]) <= max_diff


def channel_mask(ch1: torch.Tensor, ch2: torch.Tensor) -> torch.Tensor:
    """(N,M) bool: same-descriptor-channel gate for mixed ORB/AKAZE frames."""
    return ch1[:, None] == ch2[None, :]
