"""Rectified stereo feature matching -> per-feature metric depth.

PyTorch port of ``eorb_slam_tpu/ops/stereo_match.py`` (reference
Frame::ComputeStereoMatches): the row-band, disparity-band and octave
admissibility is a dense (Nl,Nr) pair mask over the descriptor Hamming
matrix (the +-1 product of ``matching.match_nnratio``), followed by the
reference's median-distance prune. ``depth_from_depthmap`` is the RGB-D
lookup (Frame::ComputeStereoFromRGBD).
"""

from __future__ import annotations

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.ops import matching


def _stereo_match(
    xy_l: torch.Tensor,       # (Nl,2) undistorted left keypoints
    oct_l: torch.Tensor,      # (Nl,)
    desc_l: torch.Tensor,     # (Nl,256) int8 +-1
    valid_l: torch.Tensor,    # (Nl,)
    xy_r: torch.Tensor,       # (Nr,2) undistorted right keypoints
    oct_r: torch.Tensor,
    desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    fx: float,
    baseline: float,
    min_depth: float = 0.3,
    max_depth: float = 60.0,
):
    """Returns (depth (Nl,), u_right (Nl,), matched (Nl,) bool).

    depth < 0 where unmatched. Admissible pairs: same pyramid level +-1,
    |row difference| <= 2*1.2^octave px, disparity within the depth band.
    ``bf`` is float32(fx) * baseline in float32, as the reference computes
    it from its traced fx and baseline."""
    bf = torch.full((), fx, dtype=torch.float32, device=xy_l.device) * baseline
    min_disp = bf / max_depth
    max_disp = bf / min_depth

    row_tol = 2.0 * 1.2 ** oct_l.to(torch.float32)                # (Nl,)
    d_row = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])        # (Nl,Nr)
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]                    # (Nl,Nr)
    oct_ok = torch.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    pair = ((d_row <= row_tol[:, None]) & (disp >= min_disp)
            & (disp <= max_disp) & oct_ok)

    m_lr, dist = matching.match_nnratio(
        desc_l, valid_l, desc_r, valid_r,
        pair_mask=pair, max_dist=matching.TH_HIGH, nn_ratio=0.9, mutual=True,
    )
    matched = m_lr >= 0

    # distance-statistic prune (dist > 1.5*1.4*median over the matched set
    # goes): the median is the sorted entry at index n_matched // 2, as the
    # reference picks it (torch.median takes the lower middle)
    d_sorted = torch.sort(torch.where(matched, dist, matching.BIG)).values
    n_m = matched.sum()
    # a gather, not an index by a 0-dim tensor (which reads it on the host)
    med = d_sorted.gather(0, torch.clamp(torch.div(n_m, 2, rounding_mode="floor"),
                                         0, dist.shape[0] - 1).view(1))[0]
    matched = matched & (dist <= 1.5 * 1.4 * torch.clamp(med, min=1))

    idx_r = torch.where(matched, m_lr, 0).long()
    disp_m = xy_l[:, 0] - xy_r[idx_r, 0]
    ok = matched & (disp_m > 1e-3)
    depth = torch.where(ok, bf / torch.clamp(disp_m, min=1e-3), -1.0)
    u_right = torch.where(ok, xy_r[idx_r, 0], -1.0)
    return depth, u_right, ok


# one dispatch per stereo pair, as the reference's jit; the rig's fx and
# baseline and the depth band are Python floats here, so they are the key
stereo_match = _graphs.GraphRunner(
    _stereo_match, static=("fx", "baseline", "min_depth", "max_depth"))


def depth_from_depthmap(
    xy: torch.Tensor,          # (N,2) keypoint coords (pixel)
    depth_map: torch.Tensor,   # (H,W) metric depth, <=0 = invalid
    valid: torch.Tensor,       # (N,)
):
    """RGB-D depth lookup at keypoint locations. The coordinates round half
    to even (``torch.round``, as ``jnp.round``) and are clipped into the
    image before the gather."""
    H, W = depth_map.shape
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    d = depth_map[yi, xi]
    ok = valid & (d > 0) & torch.isfinite(d)
    return torch.where(ok, d, -1.0), ok
