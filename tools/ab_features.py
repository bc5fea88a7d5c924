"""Feature-path frames/s and launches of two checkouts on one card, in turns:
chip_smoke.py's STEREO and RGBD phases (configs/synth_euroc_stereo.yaml and
configs/synth_euroc_rgbd.yaml on one generated corridor_st_01, 752x480, 512
features), then IMU_MONOCULAR (configs/synth_euroc_vi.yaml on a generated
room_01) with PREINIT_N of its frames tracked before the IMU init under
torch.profiler. Each checkout runs in a process of its own with its own
chip_smoke.py and package, in the order parent, change, change, parent. The
kernels and the native library are built before any phase runs, so no build
lands inside a timed run.

    git archive HEAD | tar -x -C results/parent
    python3 tools/ab_features.py results/parent [--out chiprun_out/ab_features.json]

Needs a CUDA device (about 12 minutes on an H100). Each process's log goes
beside the JSON (``ab_features_<turn>_<label>.log``); the JSON holds, per
turn, the card's name and power limit and, per mode, STEREO's and RGBD's
RUNS app runs (frames, wall s, frames/s; the last is the steady rate), the
profiled frames after the last run (device kernels, device ms, host-issued
launches and kind of each, as the phase prints them); for IMU_MONOCULAR the
profiled pre-init frames (frame, kind, host-issued launches, device
kernels, device ms) and the run's frames/s (the profiled frames inside
it).
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
TAG = "AB_FEATURES "
# IMU_MONOCULAR: frames tracked before the IMU init, from this frame on,
# under the profiler (the visual init and every key of the feature path
# behind them)
PREINIT_FROM, PREINIT_N = 12, 4
# STEREO and RGBD run this many times in a turn, one after the other: the
# first in a process pays its warm-up (and, where the units replay, their
# captures); the last gives the steady rate
RUNS = 2


def _per_frame(lines, tag):
    """The phase's profiled frames after its app run, from the first of
    ``lines`` that prints them: [(device kernels, device ms, host-issued
    launches, kind), ...]."""
    for x in lines:
        if x.startswith(f"run_slam {tag} per frame after the run"):
            m = re.search(r"kind of step: (\[.*\])\)$", x)
            return ast.literal_eval(m.group(1)) if m else None
    return None


def _imu_preinit(cs, work):
    """IMU_MONOCULAR through run_slam.main on a room_01 generated as
    chip_smoke.run_app_imu_monocular generates it, VI_FRAMES frames, its
    frames tracked before the IMU init from PREINIT_FROM on (PREINIT_N of
    them) under torch.profiler. Returns (frames, wall s, rows)."""
    from eorb_slam_tpu_torch.apps import run_slam
    from eorb_slam_tpu_torch.io import config, synth_dataset as sd
    from eorb_slam_tpu_torch.slam import vi_system

    root = os.path.join(work, "euroc_vi")
    settings = cs._settings_with_root("synth_euroc_vi.yaml", root, work)
    st = config.load_settings(settings)
    w, h, fx, fps = st.cam.width, st.cam.height, st.cam.fx, st.cam.fps
    sd.write_euroc(root, "room_01", sd.make_scene("room", w, h, fx, n_dots=10),
                   sd.make_trajectory("room", cs.VI_ROOM_S),
                   duration=cs.VI_GEN_FRAMES / fps, fps=fps, verbose=False,
                   renderer=sd.make_box_renderer("room", w, h, fx))
    process = vi_system.MonoInertialSlam.process_image_imu
    rows, n = [], [0]

    def profiled(self, img, ts, imu, **kw):
        i = n[0]
        n[0] += 1
        if (self.imu_initialized or self.state != vi_system.OK or i < PREINIT_FROM
                or len(rows) >= PREINIT_N):
            return process(self, img, ts, imu, **kw)
        keys = (cs._captures(), cs._first_calls())
        res, per = cs._profile(lambda: process(self, img, ts, imu, **kw))
        kind = ("new key" if (cs._captures(), cs._first_calls()) != keys
                else cs._frame_kind(res))
        rows.append((i, kind, per.launches, sum(c for c, _ in per.values()),
                     round(sum(us for _, us in per.values()) / 1e3, 3)))
        return res

    vi_system.MonoInertialSlam.process_image_imu = profiled
    try:
        (out,) = run_slam.main([settings, "--sequence", "room_01", "--max-frames",
                                str(cs.VI_FRAMES), "--out", os.path.join(work, "results_vi")])
    finally:
        vi_system.MonoInertialSlam.process_image_imu = process
    return n[0], out["wall_s"], rows


def _child(root: str) -> int:
    """Run the phases of the checkout at ``root``."""
    import shutil
    import tempfile

    sys.path.insert(0, root)
    import chip_smoke as cs
    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from eorb_slam_tpu_torch.io import native
    from eorb_slam_tpu_torch.ops import hopper_linalg, hopper_splat

    hopper_splat.build()
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
    work = tempfile.mkdtemp(prefix="ab_features_")
    out = {"gpu": gpu}
    try:
        depth = cs.run_generate_depth(work)
        for tag, run in (("STEREO", cs.run_app_stereo), ("RGBD", cs.run_app_rgbd)):
            runs = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                r = run(work, depth)
                runs.append(dict(frames=r["frames"], wall_s=r["wall_s"],
                                 frames_per_s=r["fps"], phase_s=time.perf_counter() - t0))
            out[tag] = dict(runs=runs, frames_per_s=runs[-1]["frames_per_s"],
                            device_ms=r["device_ms"], launches_frame=r["launches_frame"],
                            per_frame=_per_frame(lines[::-1], tag))
        n, wall_s, rows = _imu_preinit(cs, work)
        out["IMU_MONOCULAR"] = dict(frames=n, wall_s=wall_s, frames_per_s=n / wall_s,
                                    preinit=rows)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        cs._log = log
    print(TAG + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the parent checkout's directory")
    ap.add_argument("--change", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the change's directory (this checkout)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab_features.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return _child(os.path.abspath(args.parent))
    roots = dict(parent=os.path.abspath(args.parent), change=os.path.abspath(args.change))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for i, label in enumerate(ORDER):
        log = os.path.join(out_dir, f"ab_features_{i}_{label}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), roots[label],
                                 "--child"], cwd=roots[label], stdout=f,
                                stderr=subprocess.STDOUT, timeout=900).returncode
        with open(log) as f:
            lines = f.read().splitlines()
        res = [json.loads(x[len(TAG):]) for x in lines if x.startswith(TAG)]
        turns.append(dict(turn=i, label=label, rc=rc, result=res[-1] if res else None))
        short = {k: ([u["frames_per_s"] for u in v.get("runs", [v])],
                     [c[2] for c in v.get("per_frame") or v.get("preinit") or []])
                 for k, v in (res[-1] if res else {}).items() if isinstance(v, dict)}
        print(f"turn {i} {label}: rc {rc} {short if res else lines[-5:]}", flush=True)
        if rc != 0:
            break
    with open(args.out, "w") as f:
        json.dump(turns, f, indent=1)
    return 0 if all(t["rc"] == 0 for t in turns) and len(turns) == len(ORDER) else 1


if __name__ == "__main__":
    sys.exit(main())
