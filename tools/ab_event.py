"""Event-mode rates of two checkouts on one card, in turns: EVENT_MONO
(configs/synth_ev_mono.yaml), EVENT_IMU_MONO (configs/synth_ev_imu_mono.yaml)
and the continuous tracker (configs/synth_ev_only.yaml with
``Event.contTracking: 1``) through apps/run_slam.main on one generated
EV-ETHZ shakes_01 (chip_smoke.py's generator settings), each checkout in a
process of its own with its own package, in the order parent, change,
change, parent. The image trackers are seeded as chip_smoke.py seeds them
(EV_IMAGE_SEED). Each mode runs RUNS times in a turn with no profiler,
the second run (every key captured by the first) giving the steady rate;
then once more with its steps from PROFILE_FROM on under torch.profiler
(CUDA activity): per image (image modes) or per window (continuous) the
host-issued launches (kernel and graph launches, chip_smoke's
HOST_LAUNCH_APIS), the device kernels and device ms, and the step's kind:
"paired" where both trackers tracked without a keyframe from a tracked
state and the joint solve was accepted, "KF", else the image tracker's
kind; a continuous window is "KF" or "window". The kernels and the
native library are built, and the data generated, before any run is
timed.

    git archive HEAD | tar -x -C results/parent
    python3 tools/ab_event.py results/parent [--out chiprun_out/ab_event.json]

Needs a CUDA device (about 10 minutes on an H100). Each process's log goes
beside the JSON (``ab_event_<turn>_<label>.log``); the JSON holds each
turn's runs (images or windows, wall seconds and the rate) and its
profiled steps.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ORDER = ("parent", "change", "change", "parent")
TAG = "AB_EVENT "
MODES = (("EVENT_MONO", "synth_ev_mono.yaml", False),
         ("EVENT_IMU_MONO", "synth_ev_imu_mono.yaml", False),
         ("EVENT_ONLY continuous", "synth_ev_only.yaml", True))
RUNS = 2
PROFILE_FROM = {"EVENT_MONO": 6, "EVENT_IMU_MONO": 6, "EVENT_ONLY continuous": 40}
PROFILE_N = {"EVENT_MONO": 6, "EVENT_IMU_MONO": 6, "EVENT_ONLY continuous": 3}


def _setup(root: str):
    """The checkout at ``root`` imported, its kernels and native library
    built; returns its chip_smoke module."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import eorb_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from eorb_slam_tpu_torch.io import native
    from eorb_slam_tpu_torch.ops import hopper_linalg, hopper_splat

    hopper_splat.build()
    hopper_linalg.build()
    if native.get_lib() is None:
        raise RuntimeError(f"native library: {native.BUILD_ERROR}")
    cs._log(f"gpu: {cs._gpu_line()}")
    return cs


def _generate(root: str, data: str) -> int:
    """Write the shakes sequence into ``data`` with the checkout at
    ``root``."""
    cs = _setup(root)
    res = cs.run_generate(data)
    print(TAG + json.dumps(dict(root=res["root"], events=res["events"])), flush=True)
    return 0


def _profiled(cs, tag, cont):
    """Patch the mode's per-step entry point to profile its steps from
    PROFILE_FROM[tag] on; returns (undo, the steps' records)."""
    import torch
    from eorb_slam_tpu_torch.slam import ev_image_system as evi
    from eorb_slam_tpu_torch.slam import event_continuous as tec
    from eorb_slam_tpu_torch.slam.system import OK

    first, n = PROFILE_FROM[tag], PROFILE_N[tag]
    steps, count, cur = [], [0], {}

    def record(i, kind, per):
        steps.append(dict(step=i, kind=kind, host_launches=per.launches,
                          device_kernels=sum(c for c, _ in per.values()),
                          device_ms=sum(us for _, us in per.values()) / 1e3))

    if cont:
        from torch.profiler import ProfilerActivity, profile

        orig = tec.ContinuousEventTracker.process_event_image

        def windowed(self, img, ts, full=True):
            r = orig(self, img, ts, full=full)
            if full:
                count[0] += 1
                if cur:
                    torch.cuda.synchronize()
                    cur["prof"].stop()
                    record(count[0], "KF" if r.get("kf") else "window",
                           cs._activity(cur.pop("prof")))
                if first <= count[0] < first + n:
                    torch.cuda.synchronize()
                    cur["prof"] = profile(activities=[ProfilerActivity.CUDA])
                    cur["prof"].start()
            return r

        tec.ContinuousEventTracker.process_event_image = windowed
        return lambda: setattr(tec.ContinuousEventTracker, "process_event_image", orig), steps

    orig = evi.EvImageSlam.track_ev_mono

    def tracked(self, *a, **kw):
        i = count[0]
        count[0] += 1
        if not first <= i < first + n:
            return orig(self, *a, **kw)
        ev_ok = self.ev.state == OK
        res, per = cs._profile(lambda: orig(self, *a, **kw))
        im, evr, joint = res["image"] or {}, res["event"] or {}, res["joint"]
        if im.get("kf") or evr.get("kf"):
            kind = "KF"
        elif (ev_ok and cs._frame_kind(im) == cs._frame_kind(evr) == "track"
              and joint is not None and not joint.get("rejected")):
            kind = "paired"
        else:
            kind = cs._frame_kind(im)
        record(i, kind, per)
        return res

    evi.EvImageSlam.track_ev_mono = tracked
    return lambda: setattr(evi.EvImageSlam, "track_ev_mono", orig), steps


def _child(root: str, data_root: str, work: str) -> int:
    """Run every mode RUNS times, and once profiled, with the checkout at
    ``root``."""
    cs = _setup(root)
    from eorb_slam_tpu_torch.apps import run_slam

    build = run_slam.build_system

    def seeded(*a, **kw):
        slam = build(*a, **kw)
        if hasattr(slam, "im"):
            slam.im.generator.manual_seed(cs.EV_IMAGE_SEED)
        return slam

    run_slam.build_system = seeded
    out = {}
    try:
        for tag, config, cont in MODES:
            settings = cs._settings_with_root(config, data_root, work,
                                              name=f"{tag.replace(' ', '_')}.yaml")
            if cont:
                with open(settings) as f:
                    text = f.read()
                text, n = re.subn(r"(?m)^Event\.contTracking:.*$", "Event.contTracking: 1",
                                  text)
                if n != 1:
                    raise RuntimeError(f"{config}: {n} Event.contTracking lines")
                with open(settings, "w") as f:
                    f.write(text)
            runs = []
            for k in range(RUNS):
                t0 = time.perf_counter()
                (res,) = run_slam.main([settings, "--sequence", "shakes_01", "--out",
                                        os.path.join(work, f"out_{k}")])
                st = res["stats"]
                units = st["windows"] if cont else res["iterations"]
                runs.append(dict(units=units, wall_s=res["wall_s"],
                                 rate=units / res["wall_s"], main_s=time.perf_counter() - t0,
                                 device=res["device"]))
                cs._log(f"{tag} run {k}: {units} {'windows' if cont else 'images'} in "
                        f"{res['wall_s']:.3f} s = {units / res['wall_s']:.3f} per s")
            undo, steps = _profiled(cs, tag, cont)
            try:
                run_slam.main([settings, "--sequence", "shakes_01", "--out",
                               os.path.join(work, "out_profiled")])
            finally:
                undo()
            cs._log(f"{tag} profiled: {steps}")
            out[tag] = dict(runs=runs, profiled=steps)
    finally:
        run_slam.build_system = build
    print(TAG + json.dumps(out), flush=True)
    return 0


def _run(args_list, cwd, log):
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), *args_list],
                            cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                            timeout=900).returncode
    with open(log) as f:
        lines = f.read().splitlines()
    res = [json.loads(x[len(TAG):]) for x in lines if x.startswith(TAG)]
    return rc, res[-1] if res else None, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the parent checkout's directory")
    ap.add_argument("--change", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the change's directory (this checkout)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab_event.json"))
    ap.add_argument("--child", nargs=2, metavar=("DATA", "WORK"), help=argparse.SUPPRESS)
    ap.add_argument("--generate", metavar="DATA", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.generate:
        return _generate(os.path.abspath(args.parent), args.generate)
    if args.child:
        return _child(os.path.abspath(args.parent), *args.child)
    import tempfile

    roots = dict(parent=os.path.abspath(args.parent), change=os.path.abspath(args.change))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ab_event_")
    rc, gen, lines = _run([roots["change"], "--generate", tmp], roots["change"],
                          os.path.join(out_dir, "ab_event_generate.log"))
    if rc != 0 or gen is None:
        print(f"generation failed: rc {rc} {lines[-5:]}", flush=True)
        return 1
    turns = []
    for i, label in enumerate(ORDER):
        work = os.path.join(tmp, f"turn{i}")
        os.makedirs(work)
        rc, res, lines = _run([roots[label], "--child", gen["root"], work], roots[label],
                              os.path.join(out_dir, f"ab_event_{i}_{label}.log"))
        turns.append(dict(turn=i, label=label, rc=rc, result=res,
                          gpu=[x for x in lines if x.startswith("gpu:")][:1]))
        print(f"turn {i} {label}: rc {rc} {res if res else lines[-5:]}", flush=True)
        if rc != 0:
            break
    with open(args.out, "w") as f:
        json.dump(turns, f, indent=1)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return 0 if all(t["rc"] == 0 for t in turns) and len(turns) == len(ORDER) else 1


if __name__ == "__main__":
    sys.exit(main())
