"""Carry state from numpy into the port.

The system has no learned weights; what has to match between the JAX
package and this one is state: the L1 builder's and the L2 map's. These
functions take that state as numpy arrays (e.g. ``np.asarray`` of the JAX
fields), so the port can continue a run from the same mid-run state.
"""

from __future__ import annotations

import numpy as np
import torch

from eorb_slam_tpu_torch.event.builder import EventWindowBuilder
from eorb_slam_tpu_torch.slam.map_state import MapState, empty_map


def cam_from_numpy(cam, device=None) -> torch.Tensor:
    """Camera parameter vector (e.g. [fx, fy, cx, cy, k1, k2, p1, p2, k3])
    -> float32 tensor on ``device``. ``None`` leaves it where numpy had it,
    on the CPU: a conversion follows its argument and picks no device."""
    return torch.as_tensor(np.asarray(cam, np.float32)).to(device)


def builder_state_from_numpy(builder: EventWindowBuilder, state: dict) -> None:
    """Load builder state given as numpy values into ``builder``.

    ``state`` keys (all optional except where noted):
    - ``prev_img`` (H,W), ``prev_pts`` (Np,2), ``prev_ok`` (Np,) bool: the
      KLT carry between windows (the JAX builder's ``_win_carry``); all
      three or none;
    - ``T_prev``, ``T_cur`` (4,4) and ``med_depth`` (): the L2 pose prior;
      all three or none;
    - ``chunk_size`` (int) and ``last_chunk_ts`` (float): the adaptive
      window's controller state;
    - ``last_kind`` (str) and ``last_score`` (float): the previous window's
      winner, which the next PoseImage reports;
    - ``cam``: the camera vector.
    """
    dev = builder.device

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

    if "prev_img" in state:
        builder._win_carry = (
            f32(state["prev_img"]), f32(state["prev_pts"]),
            torch.as_tensor(np.asarray(state["prev_ok"], bool)).to(dev),
        )
    if "T_prev" in state:
        builder.set_pose_prior(f32(state["T_prev"]), f32(state["T_cur"]),
                               f32(state["med_depth"]))
    if "chunk_size" in state:
        builder.chunk_size = int(state["chunk_size"])
    if "last_chunk_ts" in state:
        builder._last_chunk_ts = float(state["last_chunk_ts"])
    if "last_kind" in state:
        builder._last_kind = str(state["last_kind"])
        builder._last_score = float(state["last_score"])
    if "cam" in state:
        builder.cam = cam_from_numpy(state["cam"], dev)


def map_state_from_numpy(arrays, device=None) -> MapState:
    """A map given as numpy arrays, one per ``MapState`` field (e.g.
    ``{k: np.asarray(v) for k, v in jax_map._asdict().items()}``) -> the
    port's MapState on ``device``, with the same shapes and dtypes. ``None``
    leaves the map on the CPU (as ``cam_from_numpy``); the entry points that
    take it decide where they run."""
    dtypes = map_state_to_numpy(empty_map(1, 1, 1, 1))
    return MapState(**{
        k: torch.from_numpy(np.array(arrays[k], dtype=dtypes[k].dtype)).to(device)
        for k in MapState._fields
    })


def map_state_to_numpy(m: MapState) -> dict:
    """The port's MapState -> {field: numpy array} on the host."""
    return {k: v.cpu().numpy() for k, v in m._asdict().items()}
