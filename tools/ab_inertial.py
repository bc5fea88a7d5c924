"""Inertial frames/s of two checkouts on one card, in turns: chip_smoke.py's
IMU_MONOCULAR phase (configs/synth_euroc_vi.yaml on a generated room_01,
752x480) and IMU_STEREO phase (configs/synth_euroc_imu_stereo.yaml on a
generated corridor_st_01), each checkout in a process of its own with its
own chip_smoke.py and package, in the order parent, change, change, parent.
The kernels and the native library are built before either phase runs, so
no build lands inside a timed run.

Each phase runs RUNS times in a turn. The first run profiles the phase's
frames tracked before the IMU init (host-issued launches, as chip_smoke.py
prints them; its keys' first calls and captures fall in it); the others
profile nothing, and the last of them gives the steady frames/s. Every
keyframe's mapping time is taken by the host clock between two
synchronisations, split into keyframes before and after the IMU init (the
init attempts fall in the former, the VI local BA and the scale
refinements in the latter).

    git archive HEAD | tar -x -C results/parent
    python3 tools/ab_inertial.py results/parent [--out chiprun_out/ab_inertial.json]

Needs a CUDA device (about 25 minutes on an H100). Each process's log goes
beside the JSON (``ab_inertial_<turn>_<label>.log``); the JSON holds, per
turn and phase, each run's frames/s, keyframe ms before and after the IMU
init, IMU init frame and applied scale, the profiled pre-init steps, and
the phases' summary lines.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import time

ORDER = ("parent", "change", "change", "parent")
TAG = "AB_INERTIAL "
RUNS = 2


def _preinit(lines, tag):
    """The profiled pre-init steps the phase printed (index, kind,
    host-issued launches, device kernels, device ms), or None."""
    for x in lines:
        if x.startswith(f"run_slam {tag} frames tracked before the IMU init"):
            m = re.search(r": (\[.*\])$", x)
            return ast.literal_eval(m.group(1)) if m else None
    return None


def _init_of(lines, tag):
    """(IMU init frame, scale applied) from the phase's summary line (the
    scale there may include the frames after the run)."""
    for x in lines:
        if x.startswith(f"run_slam {tag} ") and "scale applied" in x:
            f = re.search(r"IMU initiali[sz]ed at frame (\w+)", x)
            s = re.search(r"scale applied ([-\d.]+)", x)
            return (f.group(1) if f else None), (float(s.group(1)) if s else None)
    return None, None


def _child(root: str) -> int:
    """Run both inertial phases of the checkout at ``root``."""
    import shutil
    import tempfile

    sys.path.insert(0, root)
    import chip_smoke as cs
    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    import torch
    from eorb_slam_tpu_torch.io import native
    from eorb_slam_tpu_torch.ops import hopper_splat
    from eorb_slam_tpu_torch.slam import vi_system

    hopper_splat.build()
    try:
        from eorb_slam_tpu_torch.ops import hopper_linalg
    except ImportError:           # a checkout without the eigensolver kernel
        hopper_linalg = None
    if hopper_linalg is not None:
        hopper_linalg.build()
    if native.get_lib() is None:
        raise RuntimeError(f"native library: {native.BUILD_ERROR}")
    gpu = cs._gpu_line()
    cs._log(f"gpu: {gpu}")
    lines, log = [], cs._log

    def keep(*a):
        lines.append(" ".join(str(x) for x in a))
        log(*a)

    cs._log = keep
    # the inertial init's recorded calls are not replayed after the runs (a
    # checkout that replays none has no such setting)
    cs.VI_INIT_REPLAYED = 0
    profiled = cs.PREINIT_PROFILED
    insert, kf = vi_system.MonoInertialSlam._insert_keyframe, []

    def timed_insert(self, *a, **k):
        before = bool(self.imu_initialized)
        torch.cuda.synchronize()
        t = time.perf_counter()
        insert(self, *a, **k)
        torch.cuda.synchronize()
        kf.append((before, 1e3 * (time.perf_counter() - t)))

    # the system at the end of each app run: its scale and world transforms
    # (the phases' frames after the run add keyframes)
    from eorb_slam_tpu_torch.apps import run_slam
    run_seq, ends = run_slam.run_sequence, []

    def ended(*a, **k):
        slam, res = run_seq(*a, **k)
        ends.append((slam.scale_applied, [float(s) for _, s in slam.pending_world_transforms]))
        return slam, res

    run_slam.run_sequence = ended
    vi_system.MonoInertialSlam._insert_keyframe = timed_insert
    work = tempfile.mkdtemp(prefix="ab_inertial_")
    out = {"gpu": gpu}
    try:
        depth = None
        for tag in ("IMU_MONOCULAR", "IMU_STEREO"):
            runs = []
            for k in range(RUNS):
                # the first run profiles its pre-init steps; the others none
                cs.PREINIT_PROFILED = profiled if k == 0 else 0
                del kf[:], lines[:], ends[:]
                t0 = time.perf_counter()
                if tag == "IMU_MONOCULAR":
                    r = cs.run_app_imu_monocular(work)
                else:
                    depth = depth or cs.run_generate_depth(work)
                    r = cs.run_app_imu_stereo(work, depth)
                init_at, _ = _init_of(lines, tag)
                scale, transforms = ends[0]
                pre = [ms for b, ms in kf if not b]
                post = [ms for b, ms in kf if b]
                runs.append(dict(
                    frames=r["frames"], wall_s=r["wall_s"],
                    frames_per_s=r["frames"] / r["wall_s"],
                    phase_s=time.perf_counter() - t0, imu_init_frame=init_at,
                    scale_applied=scale, world_transform_scales=transforms,
                    kf_ms_pre_init=pre, kf_ms_vi=post,
                    kf_ms_pre_init_mean=sum(pre) / max(len(pre), 1),
                    kf_ms_vi_mean=sum(post) / max(len(post), 1),
                    preinit=_preinit(lines, tag),
                    summary=[x for x in lines if x.startswith((f"run_slam {tag}", "graphs "))]))
            out[tag] = dict(runs=runs, frames_per_s=runs[-1]["frames_per_s"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
        vi_system.MonoInertialSlam._insert_keyframe = insert
        run_slam.run_sequence = run_seq
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
                                stderr=subprocess.STDOUT, timeout=1200).returncode
        with open(log) as f:
            lines = f.read().splitlines()
        res = [json.loads(x[len(TAG):]) for x in lines if x.startswith(TAG)]
        turns.append(dict(turn=i, label=label, rc=rc, result=res[-1] if res else None))
        brief = {tag: [(round(r["frames_per_s"], 3), r["imu_init_frame"], r["scale_applied"],
                        round(r["kf_ms_pre_init_mean"], 1), round(r["kf_ms_vi_mean"], 1),
                        [h for _, kind, h, _, _ in r["preinit"] or []])
                       for r in v["runs"]]
                 for tag, v in (res[-1] if res else {}).items() if tag != "gpu"}
        print(f"turn {i} {label}: rc {rc} (frames/s, IMU init frame, scale, keyframe ms "
              f"before / after the init, pre-init launches) per run: "
              f"{brief if res else lines[-5:]}", flush=True)
        if rc != 0:
            break
    with open(args.out, "w") as f:
        json.dump(turns, f, indent=1)
    return 0 if all(t["rc"] == 0 for t in turns) and len(turns) == len(ORDER) else 1


if __name__ == "__main__":
    sys.exit(main())
