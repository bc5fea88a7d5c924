"""Trajectory serialization: TUM-format save/load with timing-stat headers.

Keeps the reference's exact conventions so its Python evaluators keep
working unmodified (reference System::SaveTrajectoryEuRoC /
SaveTrajectoryEvent include/System.h:179-225; timing header prepended at
Examples/Event/fmt_ev_ethz.cpp:221-242):

- one line per pose: ``ts tx ty tz qx qy qz qw`` (body/camera-in-world),
- optional leading ``#``-comment lines carrying per-stage timing statistics
  (the `MySmartTimer` "commented stat" convention,
  reference include/Utils/MyDataTypes.h:32-57).

Writes go through the native C++ writer (native/fastio.cpp) when built.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from eorb_slam_tpu_torch.io import native


class SmartTimer:
    """tic/toc accumulator producing a '# name: avg=..s n=..' header line.

    Reference: MySmartTimer (include/Utils/MyDataTypes.h:32-57).
    """

    def __init__(self, name: str):
        self.name = name
        self.deltas: list = []
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> None:
        if self._t0 is not None:
            self.deltas.append(time.perf_counter() - self._t0)
            self._t0 = None

    @property
    def average(self) -> float:
        return float(np.mean(self.deltas)) if self.deltas else 0.0

    def stat_comment(self) -> str:
        if not self.deltas:
            return f"# {self.name}: n=0\n"
        d = np.asarray(self.deltas)
        return (
            f"# {self.name}: avg={d.mean():.6f}s med={np.median(d):.6f}s "
            f"min={d.min():.6f}s max={d.max():.6f}s n={len(d)}\n"
        )


class SmartWatchDog:
    """Spin-loop liveness guard: count waits, escalate past a limit.

    Reference: MySmartWatchDog (include/Utils/MyDataTypes.h:59-79), the
    reference's only liveness mechanism — e.g. aborting a local BA that
    starves the tracker (src/Event/EvAsynchTrackerU.cpp:1080-1086). Here the
    host pipeline is single-threaded dataflow, so the guard protects bounded
    retry loops (device polling, dataset streaming) instead of mutexes.
    """

    def __init__(self, name: str, limit: int = 10000):
        self.name = name
        self.limit = int(limit)
        self.count = 0
        self.triggered = 0

    def reset(self) -> None:
        self.count = 0

    def step(self) -> bool:
        """Register one wait iteration. Returns True when the limit is hit
        (caller should abort/escalate); auto-resets after triggering."""
        self.count += 1
        if self.count >= self.limit:
            self.triggered += 1
            self.count = 0
            return True
        return False


def mats_to_tum(ts: np.ndarray, Twc: np.ndarray) -> np.ndarray:
    """(F,) ts + (F,4,4) world-from-camera poses -> (F,8) TUM rows."""
    import torch

    from eorb_slam_tpu_torch.geometry import lie

    R = torch.from_numpy(np.array(Twc[:, :3, :3], np.float32))
    q_wxyz = lie.quat_from_mat(R).numpy()
    t = Twc[:, :3, 3]
    return np.concatenate(
        [np.asarray(ts)[:, None], t, q_wxyz[:, 1:4], q_wxyz[:, :1]], axis=1
    ).astype(np.float64)


def tum_to_mats(rows: np.ndarray):
    """(F,8) TUM rows -> ((F,) ts, (F,4,4) poses)."""
    import torch

    from eorb_slam_tpu_torch.geometry import lie

    ts = rows[:, 0]
    q_xyzw = rows[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    R = lie.quat_to_mat(torch.from_numpy(np.array(q_wxyz, np.float32))).numpy()
    T = np.tile(np.eye(4, dtype=np.float64), (rows.shape[0], 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rows[:, 1:4]
    return ts, T


def save_tum(
    path: str,
    ts: np.ndarray,
    Twc: np.ndarray,
    timers: tuple = (),
    extra_header: str = "",
) -> None:
    """Save a trajectory in TUM format with the timing-stats header."""
    header = "".join(t.stat_comment() for t in timers) + extra_header
    rows = mats_to_tum(np.asarray(ts), np.asarray(Twc))
    if native.write_tum(path, header, rows):
        return
    with open(path, "w") as f:
        f.write(header)
        for r in rows:
            f.write(
                f"{r[0]:.9f} " + " ".join(f"{v:.7f}" for v in r[1:]) + "\n"
            )


def load_tum(path: str) -> np.ndarray:
    """Load TUM rows (comment lines skipped) -> (F,8) float64."""
    arr = native.parse_txt(path)
    if arr is None:
        arr = np.loadtxt(path, comments="#", ndmin=2)
    return np.asarray(arr, np.float64)


@dataclasses.dataclass
class FrameLog:
    """Per-frame trajectory bookkeeping (reference FrameInfo,
    include/Utils/MyDataTypes.h:584-614): relative pose to reference KF so
    the final trajectory re-reads optimized KF poses."""

    ts: list = dataclasses.field(default_factory=list)
    ref_kf: list = dataclasses.field(default_factory=list)
    T_rel: list = dataclasses.field(default_factory=list)  # Tcr: cam from refKF
    lost: list = dataclasses.field(default_factory=list)

    def push(self, ts: float, ref_kf: int, T_rel: np.ndarray, lost: bool = False):
        self.ts.append(float(ts))
        self.ref_kf.append(int(ref_kf))
        self.T_rel.append(np.asarray(T_rel, np.float64))
        self.lost.append(bool(lost))

    def recover(self, kf_Twc: np.ndarray):
        """Compose each frame against the (optimized) KF poses.

        kf_Twc: (K,4,4) world-from-camera poses indexed by KF slot.
        Returns (ts (F,), Twc (F,4,4)) for non-lost frames.
        """
        out_ts, out_T = [], []
        for ts, rk, Tcr, lost in zip(self.ts, self.ref_kf, self.T_rel, self.lost):
            if lost or rk < 0 or rk >= len(kf_Twc):
                continue
            Twr = np.asarray(kf_Twc[rk], np.float64)
            out_ts.append(ts)
            out_T.append(Twr @ np.linalg.inv(Tcr))
        if not out_ts:
            return np.zeros(0), np.zeros((0, 4, 4))
        return np.asarray(out_ts), np.stack(out_T)
