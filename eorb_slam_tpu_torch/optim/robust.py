"""Robust losses and chi-square gates shared by all solvers.

PyTorch port of ``eorb_slam_tpu/optim/robust.py``: Huber kernels with the
reference's fixed chi2 thresholds (sqrt(5.991) for mono reprojection edges,
sqrt(7.815) for stereo). Those constants carry accuracy — keep them verbatim.
"""

import math

import torch

# 95% chi-square quantiles used by ORB-SLAM3-style gating.
CHI2_MONO = 5.991       # 2-DoF reprojection
CHI2_STEREO = 7.815     # 3-DoF stereo reprojection
HUBER_MONO = math.sqrt(CHI2_MONO)
HUBER_STEREO = math.sqrt(CHI2_STEREO)


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel given squared error chi2: 1 inside
    the inlier region, delta/|e| outside."""
    chi2_safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / chi2_safe))


def huber_cost(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """rho(chi2): quadratic inside, linear outside."""
    delta = math.sqrt(delta2)
    e = torch.sqrt(torch.clamp(chi2, min=0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * e - delta2)
