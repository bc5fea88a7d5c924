"""Where the IMU initializes on generated sequences, in the JAX package (the
reference) or in the PyTorch port, run through each package's
``apps.run_slam`` on the same data (written by the port's generator).

    # IMU_MONOCULAR at the configs/synth_euroc_vi.yaml width on a room loop
    python tools/vi_init_check.py --out DIR --package jax --kind room --loop 10 \
        --frames 84 --max-frames 80
    python tools/vi_init_check.py --out DIR --package port --device cuda --seed 1 ...
    # EVENT_IMU with the configs/synth_ev_imu.yaml settings on 0.5 s of shakes
    python tools/vi_init_check.py --out DIR --package jax --event-imu
    # IMU_STEREO with the configs/synth_euroc_imu_stereo.yaml settings (the
    # sequence gets cam1 at 0.11 m = bf / fx, and depth0)
    python tools/vi_init_check.py --out DIR --package jax --stereo --kind corridor \
        --frames 120
    # MONOCULAR with place recognition, configs/synth_euroc_room_large.yaml,
    # on two turns of the room loop (chip_smoke.run_app_loop's sequence)
    python tools/vi_init_check.py --out DIR --package jax --loops --kind room \
        --loop 10 --frames 402 --max-frames 400
    # EVENT_MONO / EVENT_IMU_MONO with configs/synth_ev_mono.yaml /
    # synth_ev_imu_mono.yaml, and EVENT_ONLY with synth_ev_only.yaml and
    # Event.contTracking: 1, on 0.5 s of shakes (chip_smoke's sequence)
    python tools/vi_init_check.py --out DIR --package jax --kind shakes \
        --mode event_mono     # or event_imu_mono, continuous
    # the same modes over several image-tracker seeds in one process (the
    # event map's birth rate), and both packages on the same draws: JAX's
    # run first, then the port's with JAX's RANSAC draws and two-view fits
    # replayed in call order (the draw injection of tests/test_torch_l2_slice.py)
    python tools/vi_init_check.py --out DIR --package port --device cuda --kind shakes \
        --mode event_mono --seeds 0-9
    python tools/vi_init_check.py --out DIR --package both --kind shakes \
        --mode event_mono --seed 0

Prints every inertial-init attempt (frame, GN iterations, scale, chi2 per
residual dof against the 3.0 gate), the first initialized frame, the
tracked share and the ATE with the scale fixed at 1 and Sim3-aligned. With
``--loops``: the frames not tracked, where a new map starts and where the
maps merge, every detection pass that found a candidate and the loop
closer's gate decisions (the ``eorb.loop`` log lines). With ``--kind
shakes``: the images tracked, both maps' keyframes, the joint init, joint
frames and joint BAs, the Sim3 ATE and whether the fused trajectory was
written (``--mode continuous``: chunks, windows, keyframes and poses), and
per image both trackers' states and the joint init's triangulated matches
(``--package both``: side by side, with the largest pose difference). The
sequence is
generated on the CPU once per DIR. ``--seed`` reseeds the port's RANSAC
generator (the JAX package keeps its PRNGKey(0), except for the image
tracker of ``--mode event_mono`` / ``event_imu_mono``, whose key becomes
PRNGKey(seed)); ``--seeds A-B`` runs the image-clock modes once per seed.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _settings(config: str, root: str, path: str, seq: str) -> str:
    text = open(os.path.join(REPO, "configs", config)).read()
    text = re.sub(r'(?m)^DS\.Paths\.root:.*$', f'DS.Paths.root: "{root}"', text)
    text = re.sub(r'(?ms)^DS\.Seq\.names:\n(  - .*?\n)+', f'DS.Seq.names:\n  - "{seq}"\n', text)
    with open(path, "w") as f:
        f.write(text)
    return path


def _generate(a) -> str:
    from eorb_slam_tpu_torch.io import synth_dataset as sd

    if a.event_imu or a.kind == "shakes":
        seq = "shakes_01"
        if not os.path.exists(os.path.join(a.out, seq)):
            scene = sd.make_scene("shakes", 240, 180, 199.0, n_dots=6000, seed=0)
            sd.write_ev_ethz(a.out, seq, scene, sd.make_trajectory("shakes", 0.5), 0.5,
                             fps=24.0, sim_hz=150.0, contrast=0.25, verbose=False,
                             device="cpu")
        config = {"event_mono": "synth_ev_mono.yaml", "event_imu_mono": "synth_ev_imu_mono.yaml",
                  "continuous": "synth_ev_only.yaml"}.get(a.mode, "synth_ev_imu.yaml")
        path = _settings(config, a.out, os.path.join(a.out, f"{a.mode or 's'}.yaml"), seq)
        if a.mode == "continuous":
            text = re.sub(r"(?m)^Event\.contTracking:.*$", "Event.contTracking: 1",
                          open(path).read())
            open(path, "w").write(text)
        return path
    seq = f"{a.kind}_st_01" if a.stereo else f"{a.kind}_01"
    if not os.path.exists(os.path.join(a.out, seq)):
        W, H, fx, fps = 752, 480, 458.0, 20.0
        sd.write_euroc(a.out, seq, sd.make_scene(a.kind, W, H, fx, n_dots=10),
                       sd.make_trajectory(a.kind, a.loop), duration=a.frames / fps,
                       fps=fps, verbose=False, stereo_baseline=0.11 if a.stereo else None,
                       write_depth=a.stereo,
                       renderer=sd.make_box_renderer(a.kind, W, H, fx, device="cpu"))
    config = ("synth_euroc_imu_stereo.yaml" if a.stereo else
              "synth_euroc_room_large.yaml" if a.loops else "synth_euroc_vi.yaml")
    return _settings(config, a.out, os.path.join(a.out, "s.yaml"), seq)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--package", choices=["jax", "port", "both"], required=True)
    p.add_argument("--event-imu", action="store_true")
    p.add_argument("--stereo", action="store_true", help="IMU_STEREO")
    p.add_argument("--loops", action="store_true",
                   help="MONOCULAR with place recognition (room_large)")
    p.add_argument("--kind", default="room", choices=["room", "corridor", "shakes"])
    p.add_argument("--mode", default=None,
                   choices=["event_mono", "event_imu_mono", "continuous"],
                   help="with --kind shakes: the image-clock event modes, or the "
                        "continuous event tracker")
    p.add_argument("--loop", type=float, default=10.0, help="room loop period, s")
    p.add_argument("--frames", type=int, default=84, help="frames generated")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default="cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", default=None, help="A-B: --mode event_mono / event_imu_mono "
                                                 "once per seed in A..B")
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    settings = _generate(a)
    if a.kind == "shakes" and a.mode in ("event_mono", "event_imu_mono"):
        return _event_image(a, settings)
    if a.package == "jax":
        from eorb_slam_tpu.apps import run_slam
        from eorb_slam_tpu.optim import inertial
        from eorb_slam_tpu.slam import loop_closing, rgbd_stereo, system, vi_system
        extra = []
    else:
        from eorb_slam_tpu_torch.apps import run_slam
        from eorb_slam_tpu_torch.optim import inertial
        from eorb_slam_tpu_torch.slam import loop_closing, rgbd_stereo, system, vi_system
        extra = ["--device", a.device]
        build = run_slam.build_system

        def seeded(*args, **kw):
            slam = build(*args, **kw)
            getattr(slam, "l2", getattr(slam, "im", slam)).generator.manual_seed(a.seed)
            return slam

        run_slam.build_system = seeded

    # one entry per frame / MCI (process_image_imu calls
    # process_features_imu until the IMU initializes, process_stereo_imu
    # either of them: count the outer call)
    frames, depth = [], [0]
    for cls, name in ((vi_system.MonoInertialSlam, "process_image_imu"),
                      (vi_system.MonoInertialSlam, "process_features_imu"),
                      (rgbd_stereo.StereoInertialSlam, "process_stereo_imu")):
        fn = getattr(cls, name)

        def counted(self, *args, _fn=fn, **kw):
            if not depth[0]:
                frames.append(self.imu_initialized)
            depth[0] += 1
            try:
                return _fn(self, *args, **kw)
            finally:
                depth[0] -= 1

        setattr(cls, name, counted)
    solve = inertial.inertial_init

    def logged(Twb, pre, edge_valid, **kw):
        res = solve(Twb, pre, edge_valid, **kw)
        ev, prev = np.asarray(edge_valid), np.asarray(kw["prev"])
        n = int((ev & (prev >= 0)).sum())
        print(f"init attempt at frame {len(frames) - 1}: {kw['iters']} iterations, scale "
              f"{float(res.scale):.4f}, chi2/dof {float(res.cost) / max(9 * n, 1):.3f}",
              flush=True)
        return res

    inertial.inertial_init = logged
    if a.loops:
        mono = _watch_loops(system.MonoSlam, loop_closing.LoopCloser)
    args = [settings, "--eval", "--out", os.path.join(a.out, a.package)] + extra
    if a.max_frames:
        args += ["--max-frames", str(a.max_frames)]
    (out,) = run_slam.main(args)
    if a.mode == "continuous":
        st = out["stats"]
        print(f"RESULT {a.package} continuous: {st['chunks']} chunks ({st['idle']} idle), "
              f"{st['windows']} windows, {st['l2_tiny']} tiny and {st['l2_full']} full "
              f"images, {st['l2_kf']} keyframes, {out['tracked_poses']} tracked poses")
        return
    if a.loops:
        rec, passes = mono
        lost = [i for i, (s, *_) in enumerate(rec) if s != system.OK]
        new_map = [i for i, (_, nm, _) in enumerate(rec) if nm]
        merged = [i for i in range(1, len(rec)) if rec[i][2] > rec[i - 1][2]]
        cands = [(i, q, c, n) for i, q, c, n in passes if c >= 0]
        print(f"RESULT {a.package} loops: {len(rec)} frames, not tracked {lost}; new map at "
              f"{new_map}, merged at {merged}; {len(passes)} detection passes, with a "
              f"candidate (frame, query, candidate, Sim3 inliers): {cands}; stats "
              f"{out['stats']}")
        return
    st, ev = out["stats"], out.get("eval", {})
    init = frames.index(True) - 1 if True in frames else None
    mci = "mci" in st
    tracked = st["tracked"] if mci else out["tracked_poses"]
    total = st["mci"] if mci else st["frames"]
    print(f"RESULT {a.package}: first initialized after frame {init}; {tracked} of {total} "
          f"{'MCIs' if mci else 'frames'} tracked ({st.get('l2_lost', st.get('lost'))} lost); "
          f"ATE with the scale fixed at 1 {ev.get('ate_rmse')} m over "
          f"{ev.get('ape_piecewise', {}).get('traj_len')} m of path")


def _event_image(a, settings):
    """EVENT_MONO / EVENT_IMU_MONO: one app run per seed (``--package jax`` /
    ``port``), or JAX's run then the port's on JAX's draws (``both``)."""
    import importlib

    lo, hi = map(int, (a.seeds or f"{a.seed}-{a.seed}").split("-"))
    born = {}
    for seed in range(lo, hi + 1):
        runs = {}
        if a.package == "both":
            import pytest

            from tests.test_torch_l2_slice import install_jax_draws

            mp = pytest.MonkeyPatch()
            keys = {"two": [], "pnp": [], "i_two": 0, "i_pnp": 0}
            _record_and_replay(mp, install_jax_draws(mp), keys)
        for pkg in (("jax", "port") if a.package == "both" else (a.package,)):
            root = "eorb_slam_tpu" if pkg == "jax" else "eorb_slam_tpu_torch"
            run_slam = importlib.import_module(root + ".apps.run_slam")
            evi = importlib.import_module(root + ".slam.ev_image_system")
            datasets = importlib.import_module(root + ".io.datasets")
            rec, build, track = [], run_slam.build_system, evi.EvImageSlam.track_ev_mono

            def seeded(*args, _pkg=pkg, _seed=seed, **kw):
                slam = build(*args, **kw)
                if _pkg == "jax":
                    import jax

                    slam.im.key = jax.random.PRNGKey(_seed)
                elif a.package == "port":
                    slam.im.generator.manual_seed(_seed)
                return slam

            def tracked(self, *args, **kw):
                r = track(self, *args, **kw)
                T = np.asarray(self.im.T_last.cpu() if hasattr(self.im.T_last, "cpu")
                               else self.im.T_last)
                rec.append((self.im.state, self.ev.state, (r["event"] or {}).get("n"), T))
                return r

            run_slam.build_system, evi.EvImageSlam.track_ev_mono = seeded, tracked
            extra = ["--device", "cpu" if a.package == "both" else a.device] \
                if pkg == "port" else []
            try:
                (out,) = run_slam.main([settings, "--eval", "--out",
                                        os.path.join(a.out, f"{pkg}_{seed}")] + extra)
            finally:
                run_slam.build_system, evi.EvImageSlam.track_ev_mono = build, track
            seq = datasets.load_sequence("ev_ethz", a.out, "shakes_01", ts_factor=1.0)
            ev = (run_slam.evaluate(seq, out["trajectory_file"], monocular=True)
                  if "trajectory_file" in out else {})
            runs[pkg] = (out, ev, rec)
            st = out["stats"]
            path = ev.get("ape_piecewise", {}).get("traj_len", 0.0)
            born[(pkg, seed)] = st["ev"]["kf"] >= 2 and st["joint_frames"] >= 1
            print(f"RESULT {pkg} {a.mode} seed {seed}: {out['iterations']} images, "
                  f"{out['tracked_poses']} tracked poses; image / event keyframes "
                  f"{st['im']['kf']} / {st['ev']['kf']}; joint inits {st['joint_inits']}, "
                  f"joint frames {st['joint_frames']}, joint BAs {st['joint_bas']}; Sim3 ATE "
                  f"{ev.get('ate_rmse')} m over {path} m of path "
                  f"({100 * ev.get('ate_rmse', np.nan) / max(path, 1e-12):.1f}%); fused file "
                  f"{'written' if 'fused_trajectory_file' in out else 'not written'}, fusion "
                  f"error {out.get('fusion_error')}; event tracker frames {st['ev']['frames']}; "
                  f"per image (image state, event state, joint-init matches) "
                  f"{[r[:3] for r in rec]}", flush=True)
        if a.package == "both":
            (_, _, rj), (_, _, rt) = runs["jax"], runs["port"]
            same = [x[:3] == y[:3] for x, y in zip(rj, rt)]
            dT = [float(np.abs(x[3] - y[3]).max()) for x, y in zip(rj, rt)]
            print(f"BOTH seed {seed}: {len(rj)} / {len(rt)} images, the same (states, matches) "
                  f"per image {same}, image-pose max abs difference per image "
                  f"{[f'{d:.1e}' for d in dT]}; draws replayed {keys['i_two']} of "
                  f"{len(keys['two'])} two-view, {keys['i_pnp']} of {len(keys['pnp'])} PnP",
                  flush=True)
            mp.undo()
    for pkg in sorted({p for p, _ in born}):
        got = [s for (p, s), b in born.items() if p == pkg and b]
        print(f"BORN {pkg} {a.mode}: the event map born with a joint frame at seeds {got}, "
              f"{len(got)} of {hi - lo + 1}", flush=True)


def _record_and_replay(mp, draws, keys):
    """``--package both``: JAX's RANSAC keys recorded in call order, and handed
    to the port's samplers (``draws``, from ``install_jax_draws``) before its
    call of the same number: the ``both`` fixture of tests/test_torch_apps.py."""
    from eorb_slam_tpu.geometry import twoview as jtv
    from eorb_slam_tpu.slam import relocalization as jrl
    from eorb_slam_tpu_torch.geometry import twoview as ttv
    from eorb_slam_tpu_torch.slam import relocalization as trl

    for which, jm, tm, name in (("two", jtv, ttv, "reconstruct_two_views"),
                                ("pnp", jrl, trl, "pnp_ransac")):
        jfn, tfn = getattr(jm, name), getattr(tm, name)

        def record(cam, x, y, valid, key, _fn=jfn, _w=which, **kw):
            keys[_w].append(key)
            return _fn(cam, x, y, valid, key, **kw)

        def replay(*args, _fn=tfn, _w=which, **kw):
            draws[_w] = keys[_w][keys["i_" + _w]]
            keys["i_" + _w] += 1
            return _fn(*args, **kw)

        mp.setattr(jm, name, record)
        mp.setattr(tm, name, replay)


def _watch_loops(mono_cls, closer_cls):
    """Record each MonoSlam frame (state, new map, merges so far) and each
    detection pass (frame, query, candidate, inliers); echo the eorb.loop
    gate decisions with the frame they came on."""
    import logging

    rec, passes = [], []
    process, detect = mono_cls.process_image, closer_cls.detect_and_correct

    def recording(self, *args, **kw):
        res = process(self, *args, **kw)
        rec.append((res["state"], bool(res.get("new_map")), self.map_merges))
        return res

    def counted(self, m, q, **kw):
        m, info = detect(self, m, q, **kw)
        passes.append((len(rec), info.query, info.matched, info.n_inliers))
        return m, info

    class Echo(logging.Handler):
        def emit(self, r):
            print(f"eorb.loop at frame {len(rec)}: {r.getMessage()}", flush=True)

    mono_cls.process_image, closer_cls.detect_and_correct = recording, counted
    logging.getLogger("eorb.loop").addHandler(Echo())
    return rec, passes


if __name__ == "__main__":
    main()
