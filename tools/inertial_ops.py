"""Eager op counts of the inertial units on the CPU: the ops each unit
dispatches in one eager call (views apart), a stand-in for the kernel
launches the same call issues on the card, where each such op is about one
launch. The units: ``inertial._inertial_init`` at the IMU init's and the
scale refinement's keys (K = 32 slots, 8 keyframes of
``chip_smoke._vi_init_problem``), ``inertial._linear_alignment``,
``vi_system._preintegrate_frame`` at 10 and 5 IMU samples, unpadded and
padded to their buckets, and ``vi_system._write_kf_imu_state`` at an int and
a tensor slot.

    JAX_PLATFORMS=cpu python3 tools/inertial_ops.py

No JAX is imported and no card is needed (a few seconds).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import INIT_KEYS, _vi_init_problem  # noqa: E402
from eorb_slam_tpu_torch import convert  # noqa: E402
from eorb_slam_tpu_torch.imu import preintegration as pre_mod  # noqa: E402
from eorb_slam_tpu_torch.optim import inertial  # noqa: E402
from eorb_slam_tpu_torch.slam import vi_system  # noqa: E402


class _Ops(TorchDispatchMode):
    """Counts the dispatched ops, views apart."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _count(fn, **kw) -> int:
    fn(**kw)                      # per-device constants built
    with _Ops() as ops:
        fn(**kw)
    return ops.n


def main() -> int:
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    Twb, stack, ev = _vi_init_problem(8, 32)
    kw = dict(Twb=torch.from_numpy(Twb), pre_stack=convert.pre_from_numpy(stack),
              edge_valid=torch.from_numpy(ev), prev=torch.arange(32) - 1)
    for kind, key in INIT_KEYS.items():
        print(f"{kind}, K=32, {key['iters']} iterations: "
              f"{_count(inertial._inertial_init, **kw, **key)} ops; at one iteration "
              f"{_count(inertial._inertial_init, **kw, **dict(key, iters=1))}, at none "
              f"{_count(inertial._inertial_init, **kw, **dict(key, iters=0))}")
    print(f"linear alignment, K=32: {_count(inertial._linear_alignment, **kw)} ops")
    rng = np.random.default_rng(0)
    calib = pre_mod.make_calib()
    since = pre_mod.identity_preintegrated()
    for S in (10, 5):
        chunk = vi_system.ImuChunk(gyro=rng.normal(0, 0.05, (S, 3)).astype(np.float32),
                                   acc=rng.normal(0, 0.2, (S, 3)).astype(np.float32),
                                   dts=np.full(S, 1.0 / 200.0, np.float32))
        n = {pad: _count(vi_system._preintegrate_frame,
                         **dict(zip(("gyro", "acc", "dts", "imu_ok"),
                                    vi_system._chunk_tensors(chunk, cpu, pad=pad))),
                         pre_since_kf=since, calib=calib) for pad in (False, True)}
        print(f"pre-init preintegration, {S} samples: {n[False]} ops unpadded, {n[True]} "
              f"padded to {vi_system.imu_bucket(S)}")
    K, z = 32, lambda *s: torch.zeros(s)
    st = dict(pre_kf=pre_mod.stack([since] * K), kf_vel=z(K, 3), kf_bg=z(K, 3),
              kf_ba=z(K, 3), pre_window=since, vel=z(3), bg=z(3), ba=z(3))
    print(f"keyframe IMU-state write, K=32: {_count(vi_system._write_kf_imu_state, **st, slot=3)}"
          f" ops at an int slot, "
          f"{_count(vi_system._write_kf_imu_state, **st, slot=torch.tensor(3))} at a tensor "
          f"slot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
