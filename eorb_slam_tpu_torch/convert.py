"""Carry state from numpy into the port.

The system has no learned weights; what has to match between the JAX
package and this one is state: the L1 builder's, the L2 map's and the
inertial state (calibration, preintegrations, the marginal prior, and a
MonoInertialSlam's per-keyframe chain), a depth system's baseline,
place recognition's (the vocabulary, the keyframe databases and a
LoopCloser's chains and counters), an EvImageSlam's (both maps, the Sim3
gauge bridge, the stash of event frames before the joint init) and the
continuous tracker's feature tracks. These functions take that state as
numpy arrays (e.g. ``np.asarray`` of the JAX fields), so the port can
continue a run from the same mid-run state, and give it back the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from eorb_slam_tpu_torch.event.builder import EventWindowBuilder
from eorb_slam_tpu_torch.event.feature_tracks import TrackStore
from eorb_slam_tpu_torch.imu.preintegration import ImuCalib, Preintegrated
from eorb_slam_tpu_torch.optim.marginalize import PoseImuPrior
from eorb_slam_tpu_torch.retrieval import bow
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


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _fields(obj) -> dict:
    """{field: value} of a dict or of a NamedTuple (JAX's or the port's)."""
    return dict(obj) if isinstance(obj, dict) else obj._asdict()


def calib_from_numpy(calib, device=None) -> ImuCalib:
    """An IMU calibration (dict or NamedTuple of arrays by ``ImuCalib``
    field, e.g. the JAX package's ``ImuCalib``) -> the port's, float32."""
    c = _fields(calib)
    return ImuCalib(*(_f32(c[k], device) for k in ImuCalib._fields))


def pre_from_numpy(pre, device=None) -> Preintegrated:
    """A preintegration, stacked or not (dict or NamedTuple of arrays by
    ``Preintegrated`` field) -> the port's, float32."""
    p = _fields(pre)
    return Preintegrated(*(_f32(p[k], device) for k in Preintegrated._fields))


def pre_to_numpy(pre: Preintegrated) -> dict:
    return {k: v.cpu().numpy() for k, v in pre._asdict().items()}


def prior_from_numpy(prior, device=None) -> PoseImuPrior:
    p = _fields(prior)
    return PoseImuPrior(*(_f32(p[k], device) for k in PoseImuPrior._fields))


def prior_to_numpy(prior: PoseImuPrior) -> dict:
    return {k: v.cpu().numpy() for k, v in prior._asdict().items()}


VI_STATE = ("pre_kf", "kf_vel", "kf_bg", "kf_ba", "kf_prev", "bg", "ba", "vel")


def vi_state_from_numpy(slam, state: dict) -> None:
    """Load a MonoInertialSlam's per-keyframe inertial state into ``slam``
    (on its device): ``pre_kf`` (a stacked preintegration), ``kf_vel``,
    ``kf_bg``, ``kf_ba`` (K,3), ``kf_prev`` (K,) int, ``bg``, ``ba``,
    ``vel`` (3,); optional ``pre_since_kf`` and ``pre_last_frame``."""
    dev = slam.device
    slam.pre_kf = pre_from_numpy(state["pre_kf"], dev)
    for k in ("kf_vel", "kf_bg", "kf_ba", "bg", "ba", "vel"):
        setattr(slam, k, _f32(state[k], dev))
    slam.kf_prev = np.array(state["kf_prev"], dtype=np.int32)
    for k in ("pre_since_kf", "pre_last_frame"):
        if k in state:
            setattr(slam, k, pre_from_numpy(state[k], dev))


def vi_state_to_numpy(slam) -> dict:
    """A MonoInertialSlam's inertial state as numpy arrays (the keys of
    ``vi_state_from_numpy``, both optional ones included)."""
    out = {k: getattr(slam, k) for k in VI_STATE}
    out = {k: (np.array(v) if isinstance(v, np.ndarray) else v.cpu().numpy())
           for k, v in out.items() if k != "pre_kf"}
    out["pre_kf"] = pre_to_numpy(slam.pre_kf)
    out["pre_since_kf"] = pre_to_numpy(slam.pre_since_kf)
    out["pre_last_frame"] = pre_to_numpy(slam.pre_last_frame)
    return out


def depth_state_from_numpy(slam, state: dict) -> None:
    """Load a stereo system's ``baseline`` (meters; StereoSlam,
    StereoInertialSlam)."""
    slam.baseline = float(state["baseline"])


def vocab_from_numpy(voc, device=None):
    """A vocabulary: a flat (V,256) +-1 codebook -> int8 tensor, or a
    2-level vocabulary (dict or NamedTuple with ``words1``, ``words2``,
    ``weights``, e.g. the JAX package's HierVocab) -> the port's HierVocab."""
    if isinstance(voc, dict) or hasattr(voc, "_asdict"):
        v = _fields(voc)
        return bow.HierVocab(
            words1=torch.from_numpy(np.array(v["words1"], np.int8)).to(device),
            words2=torch.from_numpy(np.array(v["words2"], np.int8)).to(device),
            weights=_f32(v["weights"], device))
    return torch.from_numpy(np.array(voc, np.int8)).to(device)


def database_from_numpy(db, device=None):
    """A keyframe database (dict or NamedTuple of arrays): the dense one
    (``bow``, ``has_word``, ``valid``) or the sparse one (``ids``, ``w``,
    ``valid``) -> the port's, by its fields."""
    d = _fields(db)
    valid = torch.from_numpy(np.array(d["valid"], bool)).to(device)
    if "ids" in d:
        return bow.SparseKeyFrameDatabase(
            ids=torch.from_numpy(np.array(d["ids"], np.int32)).to(device),
            w=_f32(d["w"], device), valid=valid)
    return bow.KeyFrameDatabase(
        bow=_f32(d["bow"], device),
        has_word=torch.from_numpy(np.array(d["has_word"], bool)).to(device),
        valid=valid)


def database_to_numpy(db) -> dict:
    return {k: v.cpu().numpy() for k, v in db._asdict().items()}


def loop_closer_state_from_numpy(lc, state: dict) -> None:
    """Load a LoopCloser's state into ``lc`` (on its device): ``db`` (a
    database, see ``database_from_numpy``), ``chains`` ([(set of slots,
    length)]: the consistency groups), ``kf_count``, ``last_loop_kfc`` and
    ``added_at`` ({slot: keyframe count at insertion})."""
    lc.db = database_from_numpy(state["db"], lc.device)
    lc._chains = [(set(int(x) for x in g), int(c)) for g, c in state["chains"]]
    lc._kf_count = int(state["kf_count"])
    lc._last_loop_kfc = int(state["last_loop_kfc"])
    lc._added_at = {int(k): int(v) for k, v in state["added_at"].items()}


def loop_closer_state_to_numpy(lc) -> dict:
    """A LoopCloser's state (the keys of ``loop_closer_state_from_numpy``)."""
    return {"db": database_to_numpy(lc.db),
            "chains": [(set(g), c) for g, c in lc._chains],
            "kf_count": lc._kf_count, "last_loop_kfc": lc._last_loop_kfc,
            "added_at": dict(lc._added_at)}


def tracks_from_numpy(tr, device=None) -> TrackStore:
    """Feature tracks (dict or NamedTuple of arrays by ``TrackStore`` field,
    e.g. the JAX package's) -> the port's TrackStore on ``device``."""
    d = _fields(tr)
    dtypes = dict(xy=np.float32, valid=bool, lm=np.int32, age=np.int32,
                  birth_kf=np.int32, desc_pm1=np.int8, quality=np.float32)
    return TrackStore(**{k: torch.from_numpy(np.array(d[k], dtype=dtypes[k])).to(device)
                         for k in TrackStore._fields})


def tracks_to_numpy(tr: TrackStore) -> dict:
    return {k: v.cpu().numpy() for k, v in tr._asdict().items()}


def ev_image_state_from_numpy(slam, state: dict) -> None:
    """Load an EvImageSlam's joint state into ``slam`` (on its device):
    ``im_map`` and ``ev_map`` (maps as ``map_state_from_numpy`` takes
    them); optional ``gauge`` ((s, R_ie (3,3), t_ie (3,)) or None) with
    ``gauge_locked``; optional ``stash`` ([(ts, frame, Tcw)] with the frame
    any object with ``xy_ud``, ``octave``, ``angle``, ``desc_pm1`` and
    ``valid``, e.g. the JAX package's FrameInput)."""
    from eorb_slam_tpu_torch.slam.system import FrameInput

    dev = slam.device
    slam.im.map = map_state_from_numpy(state["im_map"], dev)
    slam.ev.map = map_state_from_numpy(state["ev_map"], dev)
    if "gauge" in state:
        g = state["gauge"]
        slam._last_gauge = None if g is None else (
            float(g[0]), np.asarray(g[1], np.float64), np.asarray(g[2], np.float64))
        slam._gauge_locked = bool(state.get("gauge_locked", False))
    if "stash" in state:
        dtypes = dict(xy_ud=np.float32, octave=np.int32, angle=np.float32,
                      desc_pm1=np.int8, valid=bool)
        stash = []
        for ts, f, T in state["stash"]:
            stash.append((float(ts), FrameInput(float(ts), *(
                torch.from_numpy(np.array(getattr(f, k), dtype=dtypes[k])).to(dev)
                for k in dtypes)), np.array(T, dtype=np.float32)))
        slam._ev_stash = stash
