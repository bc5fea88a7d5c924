"""Relative pose error and piecewise APE for (possibly disconnected) trajectories.

Reimplements the semantics of the reference's offline evaluators
(evaluation/eorb-slam-utils/my_eval_rpe.py, my_eval_ape.py and
evaluation/tum_tools/evaluate_rpe.py): pairwise relative-pose errors with
per-pair scale normalization for monocular runs, and absolute trajectory
error computed piecewise over disconnected tracking segments (each segment
aligned independently), which is how event-only runs with re-initializations
are scored (reference my_eval_ape.py `eval_est_file` loops over
`read_dosconn_graph_list` pieces).

Host-side numpy: evaluation is offline, not a TPU hot path.
"""

from __future__ import annotations

import numpy as np

from eorb_slam_tpu_torch.evals.ate import associate, umeyama_align


def _rot_angle(R: np.ndarray) -> float:
    """Rotation angle (rad) of a 3x3 rotation matrix."""
    c = (np.trace(R) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def rpe(
    est: list[tuple[float, np.ndarray]],
    gt: list[tuple[float, np.ndarray]],
    delta: int = 1,
    max_dt: float = 0.02,
    scale_norm: bool = False,
):
    """Relative pose error over frame-index deltas.

    For each associated pair (i, i+delta): error = inv(rel_gt) @ rel_est
    with rel = inv(Twc_i) @ Twc_{i+delta} (reference evaluate_rpe.ominus).
    ``scale_norm`` rescales each estimated relative translation to the
    ground-truth length before differencing (my_eval_rpe.scale) — the
    monocular convention where global scale is unobservable.

    est/gt: lists of (ts, Twc 4x4). Returns dict with trans/rot RMSE +
    per-pair arrays.
    """
    ts_e = np.asarray([t for t, _ in est])
    ts_g = np.asarray([t for t, _ in gt])
    ia, ib = associate(ts_e, ts_g, max_dt)
    if len(ia) < delta + 1:
        return {"trans_rmse": float("inf"), "rot_rmse": float("inf"),
                "n": 0, "trans": np.zeros(0), "rot": np.zeros(0)}
    Te = [np.asarray(est[i][1], np.float64) for i in ia]
    Tg = [np.asarray(gt[j][1], np.float64) for j in ib]
    terr, rerr = [], []
    for k in range(len(Te) - delta):
        rel_e = np.linalg.inv(Te[k]) @ Te[k + delta]
        rel_g = np.linalg.inv(Tg[k]) @ Tg[k + delta]
        if scale_norm:
            ne = np.linalg.norm(rel_e[:3, 3])
            ng = np.linalg.norm(rel_g[:3, 3])
            if ne > 1e-12:
                rel_e = rel_e.copy()
                rel_e[:3, 3] *= ng / ne
        err = np.linalg.inv(rel_g) @ rel_e
        terr.append(np.linalg.norm(err[:3, 3]))
        rerr.append(_rot_angle(err[:3, :3]))
    terr = np.asarray(terr)
    rerr = np.asarray(rerr)
    return {
        "trans_rmse": float(np.sqrt((terr**2).mean())),
        "rot_rmse": float(np.sqrt((rerr**2).mean())),
        "trans_median": float(np.median(terr)),
        "rot_median": float(np.median(rerr)),
        "n": len(terr),
        "trans": terr,
        "rot": rerr,
    }


def break_pieces(
    est: list[tuple[float, np.ndarray]],
    th_ts: float = 1.0,
    th_reset: float = 1e-4,
):
    """Split a trajectory into disconnected tracking segments.

    A new piece starts on (a) a timestamp jump > ``th_ts`` seconds, or (b) a
    re-initialization — the pose snapping back to identity mid-run within
    ``th_reset`` (reference mmisc.break_pose_graph semantics; event trackers
    restart their local frame at identity after a loss).
    """
    pieces: list[list[tuple[float, np.ndarray]]] = []
    cur: list[tuple[float, np.ndarray]] = []
    for k, (t, T) in enumerate(est):
        is_iden = (
            np.abs(np.asarray(T)[:3, 3]).max() < th_reset
            and np.abs(np.asarray(T)[:3, :3] - np.eye(3)).max() < th_reset
        )
        jump = cur and (t - cur[-1][0]) > th_ts
        reset = cur and len(cur) > 1 and is_iden
        if jump or reset:
            pieces.append(cur)
            cur = []
        cur.append((t, T))
    if cur:
        pieces.append(cur)
    return pieces


def ate_piecewise(
    est: list[tuple[float, np.ndarray]],
    gt: list[tuple[float, np.ndarray]],
    with_scale: bool = True,
    max_dt: float = 0.02,
    th_ts: float = 1.0,
    min_piece: int = 3,
):
    """Piecewise APE: align each disconnected segment to GT independently
    and pool the per-point errors (reference my_eval_ape.eval_est_file).

    Returns dict with pooled rmse/mean/median, per-piece stats, the matched
    ground-truth trajectory length, and APE as a percentage of it.
    """
    pieces = break_pieces(est, th_ts=th_ts)
    errs: list[np.ndarray] = []
    piece_stats = []
    traj_len = 0.0
    dur = 0.0
    for piece in pieces:
        if len(piece) < min_piece:
            continue
        ts_e = np.asarray([t for t, _ in piece])
        ts_g = np.asarray([t for t, _ in gt])
        p_e = np.asarray([T[:3, 3] for _, T in piece])
        p_g = np.asarray([T[:3, 3] for _, T in gt])
        ia, ib = associate(ts_e, ts_g, max_dt)
        if len(ia) < min_piece:
            continue
        s, R, t = umeyama_align(p_e[ia], p_g[ib], with_scale)
        e = p_g[ib] - (s * (R @ p_e[ia].T).T + t)
        e = np.linalg.norm(e, axis=1)
        errs.append(e)
        seg = p_g[ib]
        traj_len += float(np.linalg.norm(np.diff(seg, axis=0), axis=1).sum())
        dur += float(ts_g[ib[-1]] - ts_g[ib[0]])
        piece_stats.append({
            "t0": float(ts_e[0]), "t1": float(ts_e[-1]),
            "n": len(ia), "rmse": float(np.sqrt((e**2).mean())),
            "scale": s,
        })
    if not errs:
        return {"rmse": float("inf"), "n": 0, "pieces": [],
                "traj_len": 0.0, "ape_pct": float("inf"), "duration": 0.0}
    all_e = np.concatenate(errs)
    rmse = float(np.sqrt((all_e**2).mean()))
    return {
        "rmse": rmse,
        "mean": float(all_e.mean()),
        "median": float(np.median(all_e)),
        "n": int(len(all_e)),
        "pieces": piece_stats,
        "traj_len": traj_len,
        "duration": dur,
        # APE % of matched trajectory length (my_eval_ape prints ape/len)
        "ape_pct": float(100.0 * rmse / traj_len) if traj_len > 0 else float("inf"),
    }
