"""Covisibility graph as dense tensor math.

PyTorch port of ``eorb_slam_tpu/slam/covisibility.py``. The reference's
per-keyframe pointer graph (weighted edges between keyframes sharing >= 15
map points) becomes one matmul: with A (M,K) the landmark-observed-by-
keyframe indicator gathered from the observation table, the shared-point
count matrix is A^T A, recomputed on demand, always consistent with the map.
The counts are small integers held in f32, so the product is exact.
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch.ops.fast import _top_k_stable
from eorb_slam_tpu_torch.slam import map_state as ms

MIN_SHARED = 15  # reference KeyFrame::UpdateConnections threshold


def obs_indicator(m: ms.MapState) -> torch.Tensor:
    """(M,K) float: landmark m observed by keyframe k."""
    M, P = m.obs_kf.shape
    K = m.kf_valid.shape[0]
    rows = torch.arange(M, device=m.obs_kf.device).repeat_interleave(P)
    cols = torch.where(m.obs_valid, m.obs_kf, 0).reshape(-1).long()
    vals = (m.obs_valid & m.lm_valid[:, None]).reshape(-1).float()
    A = torch.zeros(M * K, dtype=torch.float32, device=m.obs_kf.device)
    A = A.scatter_reduce(0, rows * K + cols, vals, reduce="amax",
                         include_self=True)
    return A.view(M, K)


def shared_counts(m: ms.MapState) -> torch.Tensor:
    """(K,K) number of landmarks shared by each KF pair (diag = own count)."""
    A = obs_indicator(m)
    C = A.T @ A
    valid2 = m.kf_valid[:, None] & m.kf_valid[None, :]
    return torch.where(valid2, C, 0.0)


def covisible_neighbors(m: ms.MapState, kf, top_k: int = 10):
    """Best covisible KFs of `kf` (GetBestCovisibilityKeyFrames). Equal
    counts keep the lower slot first, as ``jax.lax.top_k`` does."""
    row = shared_counts(m)[kf].clone()
    row[kf] = 0.0
    w, idx = _top_k_stable(row, top_k)
    return idx, w


def covisibility_mask(m: ms.MapState, kf,
                      min_shared: float = MIN_SHARED) -> torch.Tensor:
    """(K,) bool — KFs connected to `kf` (incl. itself). Used to exclude the
    covisibility group from loop-candidate retrieval."""
    mask = shared_counts(m)[kf] >= min_shared
    mask[kf] = True
    return mask
