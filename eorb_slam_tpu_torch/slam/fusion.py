"""Event-ORB trajectory fusion (System::FuseEventORB -> MergeVisualEvent).

PyTorch port of ``eorb_slam_tpu/slam/fusion.py``: the event tracker's
keyframe chains are welded into the image trajectory's gauge by one Sim3
pose graph (optim/pose_graph.py) over the union of image poses and event
poses. Each disconnected event chain is first Sim3-initialized against the
interpolated image trajectory (Umeyama on paired camera centres: each
monocular event chain carries its own gauge), then tied in with sequential
odometry edges (its internal shape) and anchor edges to the interpolated
image poses at its timestamps. Image vertices are held fixed: the image map
is the gauge master.

The bookkeeping is host numpy, as in the reference; the solve runs on
``device`` (the card unless the caller says otherwise), float32 as the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from eorb_slam_tpu_torch._host import resolve_device
from eorb_slam_tpu_torch.evals.ate import umeyama_align
from eorb_slam_tpu_torch.evals.rpe import break_pieces
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.optim import pose_graph as pg


def interpolate_tcw(traj: list, t: float):
    """SE3-interpolated world->camera pose at time ``t`` from a sorted
    (ts, Twc) list (MyOptimizer::findNearestPose), float32 as the
    reference's. Returns None outside the time span."""
    ts = np.asarray([x for x, _ in traj])
    if len(ts) == 0 or t < ts[0] - 1e-9 or t > ts[-1] + 1e-9:
        return None
    j = int(np.clip(np.searchsorted(ts, t), 1, len(ts) - 1))
    t0, t1 = float(ts[j - 1]), float(ts[j])
    T0 = np.linalg.inv(np.asarray(traj[j - 1][1], np.float64))
    T1 = np.linalg.inv(np.asarray(traj[j][1], np.float64))
    if t1 - t0 < 1e-9:
        return T0.astype(np.float32)
    a = (t - t0) / (t1 - t0)
    return lie.interpolate_se3(
        torch.from_numpy(T0.astype(np.float32)), torch.from_numpy(T1.astype(np.float32)),
        float(np.clip(a, 0.0, 1.0)),
    ).numpy()


def _chain_gauge(chain, im_traj):
    """Initial Sim3 (s, R, t: event world -> image world) of one event
    chain, from Umeyama over camera centres paired by interpolation."""
    src, dst = [], []
    for ts, Twc_e in chain:
        Tcw_i = interpolate_tcw(im_traj, ts)
        if Tcw_i is None:
            continue
        src.append(np.asarray(Twc_e, np.float64)[:3, 3])
        dst.append(np.linalg.inv(Tcw_i)[:3, 3])
    if len(src) < 3:
        return None
    src, dst = np.asarray(src), np.asarray(dst)
    if np.linalg.norm(src - src[0], axis=1).max() < 1e-6:
        return None
    s, R, t = umeyama_align(src, dst, with_scale=True)
    if not np.isfinite(s) or s < 1e-9:
        return None
    return s, R, t


def fuse_event_orb(
    im_traj: list,
    ev_traj: list,
    chain_gap_s: float = 1.0,
    anchor_weight: float = 1.0,
    odo_weight: float = 4.0,
    iters: int = 15,
    device=None,
):
    """Fuse an event trajectory (possibly disconnected chains) into the
    image trajectory's gauge by one joint Sim3 pose-graph solve.

    im_traj / ev_traj: [(ts, Twc 4x4)]. Returns a dict with the fused
    [(ts, Twc)] (union, sorted by ts), the kind of each entry, the
    per-chain gauges and the counts."""
    if len(im_traj) < 2:
        return {"fused": list(ev_traj), "chains": 0, "anchored": 0}

    # image-pose vertices, all fixed (gauge master)
    verts_R, verts_t, fixed, vert_ts = [], [], [], []
    for ts, Twc in im_traj:
        Tcw = np.linalg.inv(np.asarray(Twc, np.float64))
        verts_R.append(Tcw[:3, :3])
        verts_t.append(Tcw[:3, 3])
        fixed.append(True)
        vert_ts.append((ts, "im"))
    n_im = len(im_traj)
    ts_im = np.asarray([x for x, _ in im_traj])

    chains = [c for c in break_pieces(ev_traj, th_ts=chain_gap_s) if len(c) >= 3]
    edges = []  # (i, j, R_ji, t_ji, w)
    gauges = []
    n_anchor = 0
    for chain in chains:
        g = _chain_gauge(chain, im_traj)
        if g is None:
            continue
        s_g, R_g, t_g = g
        gauges.append({"scale": s_g, "n": len(chain)})
        prev_idx = prev_Tcw = None
        for ts, Twc_e in chain:
            # the event pose in the image gauge: the camera centre maps as
            # C' = s R C + t, the orientation as R_cw' = R_cw R_g^T
            Tcw_e = np.linalg.inv(np.asarray(Twc_e, np.float64))
            C2 = s_g * R_g @ np.asarray(Twc_e, np.float64)[:3, 3] + t_g
            R2 = Tcw_e[:3, :3] @ R_g.T
            Tcw2 = np.eye(4)
            Tcw2[:3, :3] = R2
            Tcw2[:3, 3] = -R2 @ C2
            idx = len(verts_R)
            verts_R.append(R2)
            verts_t.append(Tcw2[:3, 3])
            fixed.append(False)
            vert_ts.append((ts, "ev"))
            # (a) sequential odometry edge preserving the chain's shape
            if prev_idx is not None:
                rel = Tcw2 @ np.linalg.inv(prev_Tcw)
                edges.append((prev_idx, idx, rel[:3, :3], rel[:3, 3], odo_weight))
            # (b) anchor edge: the interpolated image pose relative to the
            # bracketing image vertex k (the addEventVertexPose constraint)
            Tcw_i = interpolate_tcw(im_traj, ts)
            if Tcw_i is not None:
                k = int(np.clip(np.searchsorted(ts_im, ts) - 1, 0, n_im - 1))
                Tcw_k = np.linalg.inv(np.asarray(im_traj[k][1], np.float64))
                rel = np.asarray(Tcw_i, np.float64) @ np.linalg.inv(Tcw_k)
                edges.append((k, idx, rel[:3, :3], rel[:3, 3], anchor_weight))
                n_anchor += 1
            prev_idx, prev_Tcw = idx, Tcw2

    if not edges or len(verts_R) == n_im:
        return {"fused": list(im_traj), "chains": 0, "anchored": 0}

    dev = resolve_device(device)
    K, E = len(verts_R), len(edges)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    g = pg.PoseGraph(
        R=f32(np.stack(verts_R)), t=f32(np.stack(verts_t)), s=f32(np.ones(K)),
        kf_valid=torch.ones(K, dtype=torch.bool, device=dev),
        fixed=torch.from_numpy(np.asarray(fixed)).to(dev),
        edge_i=torch.from_numpy(np.asarray([e[0] for e in edges], np.int32)).to(dev),
        edge_j=torch.from_numpy(np.asarray([e[1] for e in edges], np.int32)).to(dev),
        edge_R=f32(np.stack([e[2] for e in edges])),
        edge_t=f32(np.stack([e[3] for e in edges])),
        edge_s=f32(np.ones(E)),
        edge_w=f32([e[4] for e in edges]),
    )
    g2 = pg.optimize_pose_graph(g, iters=iters, chart="sim3")

    # one read of the solved vertices
    R, t, s = (x.cpu().numpy().astype(np.float64) for x in (g2.R, g2.t, g2.s))
    fused = []
    for k, (ts, kind) in enumerate(vert_ts):
        Tcw = np.eye(4)
        Tcw[:3, :3] = R[k]
        Tcw[:3, 3] = t[k] / max(s[k], 1e-12)   # Sim3 -> SE3 (unit-scale Twc)
        fused.append((ts, np.linalg.inv(Tcw), kind))
    fused.sort(key=lambda x: x[0])
    return {
        "fused": [(ts, T) for ts, T, _ in fused],
        "kinds": [k for _, _, k in fused],
        "chains": len(gauges),
        "gauges": gauges,
        "anchored": n_anchor,
        "n_vertices": K,
        "n_edges": E,
    }
