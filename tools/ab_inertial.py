"""Inertial frames/s of two checkouts on one card, in turns: chip_smoke.py's
IMU_MONOCULAR phase (configs/synth_euroc_vi.yaml on a generated room_01,
752x480) and IMU_STEREO phase (configs/synth_euroc_imu_stereo.yaml on a
generated corridor_st_01), each checkout in a process of its own with its
own chip_smoke.py and package, in the order parent, change, change, parent.
The kernels and the native library are built before either phase runs, so
no build lands inside a timed run.

    git archive HEAD | tar -x -C results/parent
    python3 tools/ab_inertial.py results/parent [--out chiprun_out/ab_inertial.json]

Needs a CUDA device (about 10 minutes on an H100). Each process's log goes
beside the JSON (``ab_inertial_<turn>_<label>.log``); the JSON holds each
turn's frames/s and the phases' summary lines (device ms and launches per
frame, reads, IMU init frame).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ORDER = ("parent", "change", "change", "parent")
TAG = "AB_INERTIAL "


def _child(root: str) -> int:
    """Run both inertial phases of the checkout at ``root``."""
    import shutil
    import tempfile

    sys.path.insert(0, root)
    import chip_smoke as cs
    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from eorb_slam_tpu_torch.io import native
    from eorb_slam_tpu_torch.ops import hopper_splat

    hopper_splat.build()
    try:
        from eorb_slam_tpu_torch.ops import hopper_linalg
    except ImportError:           # a checkout without the eigensolver kernel
        hopper_linalg = None
    if hopper_linalg is not None:
        hopper_linalg.build()
    if native.get_lib() is None:
        raise RuntimeError(f"native library: {native.BUILD_ERROR}")
    cs._log(f"gpu: {cs._gpu_line()}")
    # no frame under the profiler inside the timed runs (a checkout whose
    # chip_smoke.py profiles none there has no such setting)
    cs.PREINIT_PROFILED = 0
    work = tempfile.mkdtemp(prefix="ab_inertial_")
    try:
        t0 = time.perf_counter()
        mono = cs.run_app_imu_monocular(work)
        t_mono = time.perf_counter() - t0
        depth = cs.run_generate_depth(work)
        t0 = time.perf_counter()
        stereo = cs.run_app_imu_stereo(work, depth)
        t_stereo = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {}
    for name, r, t in (("IMU_MONOCULAR", mono, t_mono), ("IMU_STEREO", stereo, t_stereo)):
        out[name] = dict(frames=r["frames"], wall_s=r["wall_s"],
                         frames_per_s=r["frames"] / r["wall_s"], phase_s=t)
    print(TAG + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the parent checkout's directory")
    ap.add_argument("--change", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the change's directory (this checkout)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab_inertial.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return _child(os.path.abspath(args.parent))
    roots = dict(parent=os.path.abspath(args.parent), change=os.path.abspath(args.change))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for i, label in enumerate(ORDER):
        log = os.path.join(out_dir, f"ab_inertial_{i}_{label}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), roots[label],
                                 "--child"], cwd=roots[label], stdout=f,
                                stderr=subprocess.STDOUT, timeout=900).returncode
        with open(log) as f:
            lines = f.read().splitlines()
        res = [json.loads(x[len(TAG):]) for x in lines if x.startswith(TAG)]
        summary = [x for x in lines if x.startswith(("run_slam IMU_", "gpu:"))
                   or "per frame" in x]
        turns.append(dict(turn=i, label=label, rc=rc, result=res[-1] if res else None,
                          summary=summary))
        print(f"turn {i} {label}: rc {rc} {res[-1] if res else lines[-5:]}", flush=True)
        if rc != 0:
            break
    with open(args.out, "w") as f:
        json.dump(turns, f, indent=1)
    return 0 if all(t["rc"] == 0 for t in turns) and len(turns) == len(ORDER) else 1


if __name__ == "__main__":
    sys.exit(main())
