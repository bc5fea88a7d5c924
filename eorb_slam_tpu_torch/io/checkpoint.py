"""Checkpoint / resume of the full SLAM state.

PyTorch port of ``eorb_slam_tpu/io/checkpoint.py``. The reference's
SaveAtlas/LoadAtlas are commented out (reference src/System.cc), so live
checkpointing is a capability of this system. The map is a handful of
fixed-shape tensors (slam/map_state.MapState) plus scalar host state, so a
checkpoint is one compressed ``.npz`` per atlas with a small JSON of host
state; restore is bit-for-bit, giving an exact mid-sequence resume.

The file format is the JAX package's: ``FORMAT_VERSION`` 1, the
``__meta__`` JSON and one ``map{i}.<field>`` array per MapState field, so a
file written by either package loads in the other at the atlas level. The
system's random state is its ``torch.Generator``'s, stored under
``host.generator`` (the JAX package stores its PRNG key as ``host.key``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch._host import HostCopy, resolve_device
from eorb_slam_tpu_torch.slam import atlas as atlas_mod
from eorb_slam_tpu_torch.slam import map_state as ms

FORMAT_VERSION = 1

_INIT_FRAME_FIELDS = ("xy_ud", "octave", "angle", "desc_pm1", "valid")


def _norm_path(path: str) -> str:
    # np.savez_compressed appends ".npz" to extension-less paths; mirror that
    # here so save/load agree for any spelling of the checkpoint name.
    return path if path.endswith(".npz") else path + ".npz"


def _map_to_arrays(m: ms.MapState, prefix: str, out: dict) -> None:
    for field, arr in zip(ms.MapState._fields, m):
        out[f"{prefix}{field}"] = arr.cpu().numpy()


def _map_from_arrays(data, prefix: str, device) -> ms.MapState:
    return ms.MapState(*[torch.from_numpy(np.array(data[f"{prefix}{field}"])).to(device)
                         for field in ms.MapState._fields])


def save_atlas(
    path: str,
    atlas: atlas_mod.Atlas,
    extra: Optional[dict] = None,
    extra_arrays: Optional[dict] = None,
):
    """Write every map in the atlas + host bookkeeping to ``path`` (.npz)."""
    arrays: dict = dict(extra_arrays or {})
    for i, m in enumerate(atlas.maps):
        _map_to_arrays(m, f"map{i}.", arrays)
    meta = {
        "version": FORMAT_VERSION,
        "n_maps": len(atlas.maps),
        "active": atlas.active,
        "caps": list(atlas.caps),
        # the JAX atlas's per-map flag; no map of either package sets it
        "imu_initialized": [False] * len(atlas.maps),
        "extra": extra or {},
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = _norm_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, with_arrays: bool = False, device=None):
    """Returns (Atlas on ``device`` (None: the card), extra dict[, raw
    arrays])."""
    device = resolve_device(device)
    data = np.load(_norm_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")
    K, M, N, P = meta["caps"]
    atlas = atlas_mod.Atlas(K=K, M=M, N=N, P=P, device=device)
    atlas.maps = [_map_from_arrays(data, f"map{i}.", device)
                  for i in range(meta["n_maps"])]
    atlas.active = meta["active"]
    if with_arrays:
        return atlas, meta["extra"], data
    return atlas, meta["extra"]


def save_slam(path: str, slam) -> None:
    """Checkpoint a MonoSlam-family system: map + trajectory + all host
    state needed for an exact resume, including the generator state (the
    next stochastic op, init RANSAC or relocalization, would otherwise
    diverge), the RECENTLY_LOST grace counter, the pending init frame (a
    checkpoint taken in NOT_INITIALIZED keeps its reference frame), and
    the last mapping step's stats and keyframe-redundancy ranking that the
    next keyframe reads."""
    slam.flush_pipeline()    # resolve in-flight speculative tracking
    rows = slam._pull_trajectory_rows()
    extra = {
        "state": slam.state,
        "n_kf": slam.n_kf,
        "kf_order": [int(s) for s in slam._kf_order],
        "kf_seq_next": int(slam._kf_seq_next),
        "T_last": slam.T_last.cpu().numpy().tolist(),
        "velocity": slam.velocity.cpu().numpy().tolist(),
        "frames_since_kf": slam.frames_since_kf,
        "n_inliers_ref": slam.n_inliers_ref,
        "lost_frames": slam.lost_frames,
        "last_kf_ts": slam._last_kf_ts,
        "stats": slam.stats,
        "trajectory": [
            [ts, None if T is None else rows[i].tolist(), int(ref)]
            for i, (ts, T, ref) in enumerate(slam.trajectory)
        ],
        "traj_frozen": [[ts, np.asarray(T).tolist()] for ts, T in slam._traj_frozen],
    }
    extra_arrays = {
        "host.generator": slam.generator.get_state().numpy(),
        "host.kf_seq": np.asarray(slam.kf_seq),
    }
    for key, pending in (("host.map_stats", slam._pending_map_stats),
                         ("host.redundancy", slam._pending_redundancy)):
        if pending is not None:
            extra_arrays[key] = pending.numpy()
    if slam._init_frame is not None:
        extra["init_frame_ts"] = float(slam._init_frame.ts)
        for fld in _INIT_FRAME_FIELDS:
            extra_arrays[f"initf.{fld}"] = getattr(slam._init_frame, fld).cpu().numpy()
    save_atlas(path, slam.atlas, extra, extra_arrays)


def load_slam(path: str, slam) -> None:
    """Restore a checkpoint into an already-constructed system, on its
    device (the capacities must match: they are part of the checkpoint)."""
    from eorb_slam_tpu_torch.slam.system import FrameInput

    atlas, extra, data = load_atlas(path, with_arrays=True, device=slam.device)
    if atlas.caps != slam.atlas.caps:
        raise ValueError(
            f"capacity mismatch: checkpoint {atlas.caps} vs system {slam.atlas.caps}")

    def dev(a, dtype=None):
        t = torch.from_numpy(np.array(a, dtype=dtype))
        return t.to(slam.device)

    slam._pipe = None
    slam.atlas = atlas
    slam.state = extra["state"]
    if "kf_order" in extra:
        slam._kf_order = [int(s) for s in extra["kf_order"]]
        slam._kf_seq_next = int(extra["kf_seq_next"])
        slam.kf_seq = np.asarray(data["host.kf_seq"]).copy()
        slam.last_kf_slot = slam._kf_order[-1] if slam._kf_order else -1
    else:  # pre-lifecycle checkpoints: contiguous slots
        slam.n_kf = extra["n_kf"]
    slam.T_last = dev(extra["T_last"], np.float32)
    slam.velocity = dev(extra["velocity"], np.float32)
    slam.frames_since_kf = extra["frames_since_kf"]
    slam.n_inliers_ref = extra["n_inliers_ref"]
    slam.lost_frames = extra.get("lost_frames", 0)
    slam._last_kf_ts = extra.get("last_kf_ts")
    slam.stats = extra["stats"]
    if "host.generator" in data:
        slam.generator.set_state(torch.from_numpy(np.array(data["host.generator"])))
    slam._pending_map_stats, slam._pending_redundancy = (
        HostCopy(torch.from_numpy(np.array(data[key]))) if key in data else None
        for key in ("host.map_stats", "host.redundancy"))
    if "init_frame_ts" in extra:
        slam._init_frame = FrameInput(
            extra["init_frame_ts"],
            *[dev(data[f"initf.{fld}"]) for fld in _INIT_FRAME_FIELDS])
    else:
        slam._init_frame = None
    slam.trajectory = [
        (ts, None if T is None else np.asarray(T, np.float32), ref)
        for ts, T, ref in extra["trajectory"]
    ]
    slam._traj_frozen = [(ts, np.asarray(T, np.float64)) for ts, T in extra["traj_frozen"]]
