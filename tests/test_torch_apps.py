"""The app layer of the port against the JAX package: ``run_sequence`` on
ONE on-disk dataset (written once by the port's generator) through both
``apps/run_slam`` modules, for EVENT_ONLY (discrete tracker) and for
MONOCULAR at 320x240, the narrowest width that turns duplicate fusion and
the descriptor refresh on.

What is made equal by hand, as in tests/test_torch_l2_slice.py: both
systems are built as their apps build them (EventSlam and MONOCULAR with
the pipelined speculation on), JAX's RANSAC draws and two-view minimal-set
fits are replayed into the port in call order, and the JAX builder resolves its window metadata blocking (the
port on the CPU always has it at once). For speed both builders run 5
contrast-maximization iterations. Everything else runs on its own: parser,
loader, native queue, L1, ORB, tracking, fusion, BA, TUM writer, evaluator.

Tolerances: the same state and keyframe decision after every frame / MCI,
the same keyframe count, poses within 2e-3 (map units; f32 LM and GN in
another summation order); the two ATEs within 10% of each other (or both
under 1e-3 of the path, where 10% of a tiny number is noise).
"""

import glob
import os

import numpy as np
import pytest
import torch

from eorb_slam_tpu.apps import run_slam as jrun
from eorb_slam_tpu.event import builder as jb
from eorb_slam_tpu.geometry import twoview as jtv
from eorb_slam_tpu.io import config as jcfg, datasets as jds
from eorb_slam_tpu.slam import relocalization as jrl, system as jsys
from eorb_slam_tpu_torch.apps import run_slam as trun
from eorb_slam_tpu_torch.geometry import twoview as ttv
from eorb_slam_tpu_torch.io import config as tcfg, datasets as tds
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.slam import relocalization as trl, system as tsys
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several xdist workers that share the machine's
    cores, and torch's intra-op pool spins on all of them in every worker:
    at full width that multiplies the wall time of this file's system-sized
    runs many times over. Two threads while this file runs, the process's
    setting restored after (other files' numerics stay as they were)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

CM_ITERS = 5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Both datasets and their settings files, written once."""
    root = tmp_path_factory.mktemp("synth")
    ev_scene = tsd.make_scene("shakes", 240, 180, 199.0, n_dots=1500, seed=0)
    pose = tsd.make_trajectory("shakes", 1.0)
    tsd.write_ev_ethz(str(root / "ev"), "shakes", ev_scene, pose, duration=0.15,
                      contrast=0.45, with_images=False, verbose=False,
                      device="cpu")
    ev_yaml = tsd.write_settings_yaml(
        str(root / "ev.yaml"), fmt="ev_ethz", root=str(root / "ev"),
        seqs=["shakes"], sensor="event_only", scene=ev_scene, fps=24.0,
        ts_factor=1.0, n_features=256,
        extra={"Event.data.l1ChunkSize": 12000, "Event.data.l1NumLoop": 4,
               "Event.data.maxPixelDisp": 3.0, "Event.data.minEvGenRate": 0.5,
               "Event.contTracking": 0})
    W, H, fx = 320, 240, 195.0
    im_scene = tsd.make_scene("corridor", W, H, fx, n_dots=10)
    cpose = tsd.make_trajectory("corridor", 10.0)
    tsd.write_euroc(str(root / "im"), "corridor", im_scene, cpose, duration=1.5,
                    fps=20.0, verbose=False,
                    renderer=tsd.make_box_renderer("corridor", W, H, fx, device="cpu"))
    im_yaml = tsd.write_settings_yaml(
        str(root / "im.yaml"), fmt="euroc", root=str(root / "im"),
        seqs=["corridor"], sensor="monocular", scene=im_scene, fps=20.0,
        ts_factor=1.0e9, n_features=256,
        extra={"SLAM.maxKeyFrames": 8, "SLAM.maxLandmarks": 1024,
               "SLAM.maxFramesBetweenKF": 4})
    return dict(root=root, ev_yaml=ev_yaml, im_yaml=im_yaml)


@pytest.fixture
def both(monkeypatch, jax_draws):
    """On top of ``jax_draws`` (the port's samplers and two-view fits return
    JAX's results for the key it holds): build both systems alike, record
    JAX's RANSAC keys in call order and hand them to ``jax_draws`` before the
    port's call of the same number (the two runs are not interleaved here),
    and log both sides' per-frame results."""
    log = {"j": [], "t": [], "two": [], "pnp": [], "i_two": 0, "i_pnp": 0}

    def build_alike(run):
        build = run.build_system

        def wrapped(st, **kw):
            slam = build(st, **kw)
            if hasattr(slam, "cfg"):
                slam.cfg.cm_iters = CM_ITERS
            return slam

        monkeypatch.setattr(run, "build_system", wrapped)

    build_alike(jrun)
    build_alike(trun)
    j_meta = jb.EventWindowBuilder._resolve_window_meta
    monkeypatch.setattr(jb.EventWindowBuilder, "_resolve_window_meta",
                        lambda self, block=False: j_meta(self, block=True))

    def record(mod, name, which):
        fn = getattr(mod, name)          # jax_draws' recorder of the latest key

        def wrapped(cam, a, b, valid, key, **kw):
            log[which].append(key)
            return fn(cam, a, b, valid, key, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    def replay(mod, name, which):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            jax_draws[which] = log[which][log["i_" + which]]
            log["i_" + which] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    record(jtv, "reconstruct_two_views", "two")
    record(jrl, "pnp_ransac", "pnp")
    replay(ttv, "reconstruct_two_views", "two")
    replay(trl, "pnp_ransac", "pnp")

    def logged(cls, side, pose):
        process = cls.process_image

        def wrapped(self, img, ts, **kw):
            r = process(self, img, ts, **kw)
            log[side].append((dict(r), pose(self.T_last), self.n_kf))
            return r

        monkeypatch.setattr(cls, "process_image", wrapped)

    logged(jsys.MonoSlam, "j", np.asarray)
    logged(tsys.MonoSlam, "t", lambda T: T.numpy().copy())
    return log


def _run_both(yaml_path, out, max_frames):
    sj, st = jcfg.load_settings(yaml_path), tcfg.load_settings(yaml_path)
    name = st.dataset.sequences[0]
    qj = jds.load_sequence(sj.dataset.format, sj.dataset.root, name,
                           ts_factor=sj.dataset.ts_factor)
    qt = tds.load_sequence(st.dataset.format, st.dataset.root, name,
                           ts_factor=st.dataset.ts_factor)
    jslam, jout = jrun.run_sequence(sj, qj, out_dir=str(out / "j"),
                                    max_frames=max_frames, verbose=False)
    tslam, tout = trun.run_sequence(st, qt, out_dir=str(out / "t"),
                                    max_frames=max_frames, verbose=False,
                                    device="cpu")
    mono = st.sensor.is_monocular() and not st.sensor.is_inertial()
    ej = jrun.evaluate(qj, jout["trajectory_file"], monocular=mono)
    et = trun.evaluate(qt, tout["trajectory_file"], monocular=mono)
    return (jslam, jout, ej), (tslam, tout, et)


def _same_frames(log, n_pose_checked=None):
    assert len(log["t"]) == len(log["j"]) > 0
    for i, ((rj, Tj, kj), (rt, Tt, kt)) in enumerate(zip(log["j"], log["t"])):
        assert rt["state"] == rj["state"], (i, rj, rt)
        assert rt.get("kf") == rj.get("kf"), (i, rj, rt)
        assert kt == kj, i
        if n_pose_checked is None or i < n_pose_checked:
            np.testing.assert_allclose(Tt, Tj, atol=2e-3, err_msg=f"frame {i}")
    assert log["i_two"] == len(log["two"]) and log["i_pnp"] == len(log["pnp"])


def _ate_close(et, ej, path_len):
    assert np.isfinite(et["ate_rmse"]) and et["ate_n"] == ej["ate_n"]
    a, b = et["ate_rmse"], ej["ate_rmse"]
    assert abs(a - b) <= 0.1 * b or max(a, b) < 1e-3 * path_len, (a, b)


def test_run_sequence_event_only_matches_jax(data, both, tmp_path):
    (jslam, jout, ej), (tslam, tout, et) = _run_both(data["ev_yaml"], tmp_path, 7)
    assert tslam.builder._q is not None                 # native queue in use
    _same_frames(both, n_pose_checked=12)
    sj, st = jout["stats"], tout["stats"]
    for k in ("windows", "chunks", "mci", "tracked", "l2_kf", "l2_lost"):
        assert st[k] == sj[k], k
    assert st["mci"] >= 12 and st["tracked"] >= 8
    assert tout["iterations"] == jout["iterations"] == 7
    assert tout["tracked_poses"] == jout["tracked_poses"]
    assert open(tout["trajectory_file"]).readline().startswith("# tracking:")
    _ate_close(et, ej, et["ape_piecewise"]["traj_len"])


def test_run_sequence_monocular_320_matches_jax(data, both, tmp_path):
    (jslam, jout, ej), (tslam, tout, et) = _run_both(data["im_yaml"], tmp_path, None)
    assert tslam.fuse_enabled and tslam.desc_refresh and jslam.fuse_enabled
    _same_frames(both)
    sj, st = jout["stats"], tout["stats"]
    assert tslam.state == tsys.OK and st["kf"] == sj["kf"] >= 4
    assert st["fuse_steps"] == st["refresh_steps"] >= 2
    assert st.get("fused", 0) == sj.get("fused", 0)
    assert abs(st["lm"] - sj["lm"]) <= 0.02 * sj["lm"]
    assert tout["tracked_poses"] == jout["tracked_poses"] >= 20
    _ate_close(et, ej, et["ape_piecewise"]["traj_len"])


@pytest.mark.parametrize("sensor,row", [
    ("event_mono", "row 12"), ("event_imu_mono", "row 12")])
def test_unported_sensor_configs_name_their_roadmap_row(sensor, row):
    """The modes of ROADMAP.md Queue 1 ``row`` are ported now: their sensor
    configurations build the image-clock event systems instead of raising
    a NotImplementedError that names the row."""
    from eorb_slam_tpu_torch.slam import ev_image_system as tev, event_inertial as tei

    st = tcfg.Settings(sensor=tcfg.sensor_from_string(sensor))
    slam = trun.build_system(st, device="cpu")
    cls = tei.EvImageInertialSlam if sensor == "event_imu_mono" else tev.EvImageSlam
    assert type(slam) is cls and slam.device.type == "cpu"
    assert slam.im.loop_closer is None and hasattr(slam, "fused_trajectory")


def test_unported_branches_raise():
    from eorb_slam_tpu_torch.slam import event_continuous as tec

    # the continuous tracker (row 14) is ported: contTracking (default 1) builds it
    st = tcfg.Settings(sensor=tcfg.SensorConfig.EVENT_ONLY)
    assert st.event.continuous
    assert isinstance(trun.build_system(st, device="cpu"), tec.EventSlamContinuous)
    # mixed ORB + AKAZE features (row 13) are ported: mode 2 builds
    # MixedMonoSlam (not pipelined, as in the reference app); any other
    # mode builds the pipelined ORB MonoSlam, mode 1 (AKAZE only) included
    from eorb_slam_tpu_torch.slam import system as tsys

    slam = trun.build_system(tcfg.Settings(features=tcfg.FeatureConfig(mode=2)),
                             device="cpu")
    assert type(slam) is tsys.MixedMonoSlam and not slam.pipelined
    slam = trun.build_system(tcfg.Settings(features=tcfg.FeatureConfig(mode=1)),
                             device="cpu")
    assert type(slam) is tsys.MonoSlam and slam.pipelined
    assert trun.make_vocab(tcfg.Settings(), device="cpu") is None
    with pytest.raises(ValueError):
        trun.build_system(tcfg.Settings(sensor=tcfg.SensorConfig.IDLE), device="cpu")


_CONFIG_SYSTEMS = {
    "event_only": "EventSlamContinuous", "monocular": "MonoSlam",
    "imu_monocular": "MonoInertialSlam", "event_imu": "EventInertialSlam",
    "stereo": "StereoSlam", "rgbd": "RgbdSlam", "imu_stereo": "StereoInertialSlam",
    "event_mono": "EvImageSlam", "event_imu_mono": "EvImageInertialSlam",
}


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    + ["synth_ev_only.yaml+contTracking"])
def test_build_system_builds_every_config(name, tmp_path):
    """Every settings file of configs/ builds its system (no mode raises any
    more), and synth_ev_only.yaml with ``Event.contTracking: 1`` builds the
    continuous tracker."""
    path = os.path.join(REPO, "configs", name.split("+")[0])
    if name.endswith("+contTracking"):
        text = open(path).read().replace("Event.contTracking: 0", "Event.contTracking: 1")
        assert "Event.contTracking: 1" in text
        path = str(tmp_path / "cont.yaml")
        open(path, "w").write(text)
    st = tcfg.load_settings(path)
    slam = trun.build_system(st, device="cpu")
    want = _CONFIG_SYSTEMS[st.sensor.name.lower()]
    if st.sensor is tcfg.SensorConfig.EVENT_ONLY and not st.event.continuous:
        want = "EventSlam"
    assert type(slam).__name__ == want and slam.device.type == "cpu"


def test_build_system_reads_the_settings():
    st = tcfg.Settings(
        sensor=tcfg.SensorConfig.EVENT_ONLY,
        cam=tcfg.CameraConfig(fx=199.0, fy=199.0, cx=120.0, cy=90.0, width=240, height=180),
        event=tcfg.EventConfig(l1_chunk_size=6000, l1_num_loop=4, continuous=False,
                               min_ev_gen_rate=0.5))
    slam = trun.build_system(st, device="cpu")
    assert slam.device.type == "cpu" and slam.cfg.l1_chunk_size == 6000
    assert slam.cfg.min_ev_gen_rate == 0.5 and not slam.l2.fuse_enabled
    st = tcfg.Settings(cam=tcfg.CameraConfig(fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                                             width=752, height=480),
                       features=tcfg.FeatureConfig(n_features=512),
                       slam=tcfg.SlamConfig(max_keyframes=6, max_landmarks=512))
    slam = trun.build_system(st, device="cpu")
    assert slam.map.N == 512 and slam.map.K == 6 and slam.map.M == 512
    assert slam.fuse_enabled and slam.desc_refresh and slam.img_w == 752


def test_main_runs_on_the_cpu_when_asked(data, tmp_path, capsys):
    res = trun.main([data["ev_yaml"], "--device", "cpu", "--max-frames", "1",
                     "--out", str(tmp_path), "--eval"])
    assert len(res) == 1 and res[0]["device"] == "cpu"
    assert res[0]["iterations"] == 1 and "stats" in res[0]
    assert "shakes" in capsys.readouterr().out
