"""KITTI odometry evaluation protocol.

Reference parity: ``evaluation/kitti-odom-eval/eval_odom.py`` (the reference
vendors the standard KITTI devkit protocol). Metrics: average translation
error (%) and rotation error (deg/m) over sub-sequences of length
100..800 m, sampled every ``step`` frames, plus whole-sequence ATE.

Pure numpy — this is an offline scoring tool, not a device kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length; poses (N,4,4) camera-to-world."""
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _last_frame_from_len(dist: np.ndarray, i: int, length: float) -> int:
    j = np.searchsorted(dist, dist[i] + length)
    return int(j) if j < len(dist) else -1


def _rot_err_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) * 0.5
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def seq_errors(
    poses_gt: np.ndarray,
    poses_est: np.ndarray,
    lengths: Tuple[float, ...] = LENGTHS,
    step: int = 10,
) -> List[Tuple[int, float, float, float]]:
    """Per-(start, length) errors: (first_frame, r_err deg/m, t_err ratio,
    length m). Mirrors calcSequenceErrors of the KITTI devkit."""
    dist = trajectory_distances(poses_gt)
    errs = []
    for i in range(0, len(poses_gt), step):
        for L in lengths:
            j = _last_frame_from_len(dist, i, L)
            if j < 0:
                continue
            d_gt = np.linalg.inv(poses_gt[i]) @ poses_gt[j]
            d_est = np.linalg.inv(poses_est[i]) @ poses_est[j]
            err = np.linalg.inv(d_est) @ d_gt
            t_err = np.linalg.norm(err[:3, 3]) / L
            r_err = _rot_err_deg(err[:3, :3]) / L
            errs.append((i, r_err, t_err, L))
    return errs


def kitti_odom_eval(
    poses_gt: np.ndarray,
    poses_est: np.ndarray,
    lengths: Tuple[float, ...] = LENGTHS,
    step: int = 10,
) -> Dict[str, object]:
    """Score an estimated trajectory the KITTI way.

    Returns dict with: ``t_err_pct`` average translation error in percent,
    ``r_err_deg_per_100m``, per-length breakdown, and whole-sequence
    ``ate_rmse`` (SE3-aligned)."""
    errs = seq_errors(poses_gt, poses_est, lengths, step)
    if errs:
        t_avg = float(np.mean([e[2] for e in errs])) * 100.0
        r_avg = float(np.mean([e[1] for e in errs])) * 100.0
    else:
        t_avg = r_avg = float("nan")
    by_len = {}
    for L in lengths:
        sel = [e for e in errs if e[3] == L]
        if sel:
            by_len[L] = {
                "t_err_pct": float(np.mean([e[2] for e in sel])) * 100.0,
                "r_err_deg_per_100m": float(np.mean([e[1] for e in sel]))
                * 100.0,
                "n": len(sel),
            }

    # whole-sequence ATE with SE3 (no-scale) alignment, as the devkit add-on
    from eorb_slam_tpu_torch.evals.ate import umeyama_align

    src = poses_est[:, :3, 3]
    dst = poses_gt[:, :3, 3]
    s, R, t = umeyama_align(src, dst, with_scale=False)
    aligned = (s * (R @ src.T)).T + t
    ate = float(np.sqrt(np.mean(np.sum((aligned - dst) ** 2, axis=1))))

    return {
        "t_err_pct": t_avg,
        "r_err_deg_per_100m": r_avg,
        "by_length": by_len,
        "ate_rmse": ate,
        "n_subseq": len(errs),
    }


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI pose file: each line 12 floats = 3x4 row-major cam-to-world."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out
