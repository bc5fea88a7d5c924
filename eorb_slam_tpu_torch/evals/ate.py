"""Absolute trajectory error with Horn/Umeyama alignment (optional scale).

Reimplements the evaluation math of the reference's offline tools
(evaluation/evaluate_ate_scale.py `align`, evaluation/eorb-slam-utils/
my_eval_ape.py): timestamp association, similarity alignment, RMSE.
Used both by tests (accuracy gates) and by the benchmark protocol.
"""

from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association. Returns index pairs (ia, ib)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, bestd = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(ts_b):
                d = abs(ts_b[jj] - t)
                if d <= bestd:
                    best, bestd = jj, d
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Find (s, R, t) minimizing ||dst - (s R src + t)||^2.

    src, dst: (N,3). Returns (s, R (3,3), t (3,))."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est: list[tuple[float, np.ndarray]],
    gt: list[tuple[float, np.ndarray]],
    with_scale: bool = True,
    max_dt: float = 0.02,
):
    """ATE RMSE between estimated and ground-truth (ts, Twc 4x4) lists.

    Monocular convention: Sim3 alignment (with_scale=True), like
    evaluate_ate_scale.py. Returns (rmse, n_associated, s, R, t)."""
    ts_e = np.asarray([t for t, _ in est])
    ts_g = np.asarray([t for t, _ in gt])
    p_e = np.asarray([T[:3, 3] for _, T in est])
    p_g = np.asarray([T[:3, 3] for _, T in gt])
    ia, ib = associate(ts_e, ts_g, max_dt)
    if len(ia) < 3:
        return float("inf"), len(ia), 1.0, np.eye(3), np.zeros(3)
    s, R, t = umeyama_align(p_e[ia], p_g[ib], with_scale)
    err = p_g[ib] - (s * (R @ p_e[ia].T).T + t)
    rmse = float(np.sqrt((err**2).sum(axis=1).mean()))
    return rmse, len(ia), s, R, t
