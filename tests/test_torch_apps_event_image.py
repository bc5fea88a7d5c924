"""The image-clock event modes and the continuous event tracker through the
app layer, against the JAX package: ``run_sequence`` of both
``apps/run_slam`` modules on ONE generated EV-ETHZ dataset (the port's
generator: shakes at the synth_ev_* camera, images at 24 fps and the IMU),
for EVENT_MONO, EVENT_IMU_MONO and EVENT_ONLY with ``Event.contTracking:
1``.

What is made equal by hand is what tests/test_torch_apps.py makes equal (its
``both`` fixture): JAX's RANSAC draws and two-view fits are replayed into the
port in call order, and both builders run 5 ascent iterations over a
32,768-slot window (the apps' default is 65,536, where the CPU's plain
splat would dominate the file's time; at 16,384 the event map is not born
within the sequence). The settings are the synth_ev_* ones with 256
features (the image and event trackers then share one extraction width) and
an 8-keyframe, 1,024-landmark map. Everything else runs on its own: parser,
loaders, the event slicing per image, the IMU slicing, build_mci, both
trackers, the joint steps, fusion and the TUM writers.

Tolerances: the same state and keyframe decision after every tracker call,
the same keyframe counts, poses within 2e-3 (map units); the same pose
counts in the trajectory files, poses within 2e-3, and the same for the
fused trajectory.
"""

import numpy as np
import pytest
import torch

from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.io.trajectory import load_tum
from eorb_slam_tpu_torch.slam import event_continuous as tec, event_inertial as tei
from eorb_slam_tpu_torch.slam import ev_image_system as tev
from tests.test_torch_apps import _run_both, _same_frames, both  # noqa: F401 (fixture)
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)

SECONDS, DOTS = 0.3, 1500
WINDOW = 32768


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    """Both apps build their systems with the test's window capacity."""
    from eorb_slam_tpu.apps import run_slam as jrun
    from eorb_slam_tpu_torch.apps import run_slam as trun

    for run in (jrun, trun):
        build = run.build_system

        def wrapped(st, build=build, **kw):
            slam = build(st, **kw)
            slam.cfg.max_window_events = WINDOW
            return slam

        monkeypatch.setattr(run, "build_system", wrapped)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_ev_image")
    scene = tsd.make_scene("shakes", 240, 180, 199.0, n_dots=DOTS, seed=0)
    tsd.write_ev_ethz(str(root / "ev"), "shakes", scene, tsd.make_trajectory("shakes", 1.0),
                      duration=SECONDS, contrast=0.25, verbose=False, device="cpu")
    extra = {"Event.data.l1ChunkSize": 6000, "Event.data.l1NumLoop": 4,
             "Event.data.maxPixelDisp": 3.0, "Event.data.minEvGenRate": 0.5,
             "SLAM.maxKeyFrames": 8, "SLAM.maxLandmarks": 1024}

    def settings(name, sensor, **more):
        return tsd.write_settings_yaml(
            str(root / f"{name}.yaml"), fmt="ev_ethz", root=str(root / "ev"),
            seqs=["shakes"], sensor=sensor, scene=scene, fps=24.0, ts_factor=1.0,
            n_features=256, extra=dict(extra, **more))

    return dict(mono=settings("mono", "event_mono"),
                imu_mono=settings("imu_mono", "event_imu_mono"),
                cont=settings("cont", "event_only", **{"Event.contTracking": 1}))


def _same_trajectories(jout, tout, key):
    rj, rt = load_tum(jout[key]), load_tum(tout[key])
    assert rt.shape == rj.shape and len(rj) >= 3
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    np.testing.assert_allclose(rt[:, 1:4], rj[:, 1:4], atol=2e-3)
    # quaternions up to sign
    dq = np.minimum(np.abs(rt[:, 4:] - rj[:, 4:]).max(1), np.abs(rt[:, 4:] + rj[:, 4:]).max(1))
    assert dq.max() <= 2e-3


def _log_frames(monkeypatch, log):
    """After every image: each tracker's state, keyframe decision, keyframe
    count and pose, image side first."""
    from eorb_slam_tpu.slam import ev_image_system as jev

    for cls, side in ((jev.EvImageSlam, "j"), (tev.EvImageSlam, "t")):
        fn = cls.track_ev_mono

        def wrapped(self, *a, fn=fn, side=side, **kw):
            r = fn(self, *a, **kw)
            for s, key in ((self.im, "image"), (self.ev, "event")):
                T = np.asarray(s.T_last) if side == "j" else s.T_last.numpy().copy()
                log[side].append(({"state": s.state, "kf": (r[key] or {}).get("kf")}, T,
                                  s.n_kf))
            return r

        monkeypatch.setattr(cls, "track_ev_mono", wrapped)


@pytest.mark.parametrize("mode,frames", [("mono", 7), ("imu_mono", 5)])
def test_run_sequence_event_image_matches_jax(mode, frames, data, both, tmp_path,
                                              monkeypatch):
    log = {"j": [], "t": [], "two": [], "pnp": [], "i_two": 0, "i_pnp": 0}
    _log_frames(monkeypatch, log)
    (jslam, jout, ej), (tslam, tout, et) = _run_both(data[mode], tmp_path, frames)
    cls = tei.EvImageInertialSlam if mode == "imu_mono" else tev.EvImageSlam
    assert type(tslam) is cls and tslam.device.type == "cpu"
    assert len(log["j"]) == 2 * frames
    _same_frames(log)
    assert both["i_two"] == len(both["two"]) >= 1 and both["i_pnp"] == len(both["pnp"])
    assert tout["iterations"] == jout["iterations"] == frames
    sj, st = jout["stats"], tout["stats"]
    for k in ("joint_frames", "joint_bas", "joint_inits", "gauge_reseeds"):
        assert st[k] == sj[k], k
    for side in ("im", "ev"):
        assert st[side]["kf"] == sj[side]["kf"] and st[side]["frames"] == sj[side]["frames"]
    assert st["im"]["kf"] >= 2 and st["joint_inits"] == (mode == "mono")
    assert tout["tracked_poses"] == jout["tracked_poses"]
    _same_trajectories(jout, tout, "trajectory_file")
    assert "fusion_error" not in tout and "fusion_error" not in jout
    assert ("fused_trajectory_file" in tout) == ("fused_trajectory_file" in jout)
    if "fused_trajectory_file" in jout:
        _same_trajectories(jout, tout, "fused_trajectory_file")
    if mode == "imu_mono":
        assert tslam.im.imu_initialized == jslam.im.imu_initialized
        assert tslam.im.scale_applied == jslam.im.scale_applied


def test_run_sequence_continuous_matches_jax(data, both, tmp_path, monkeypatch):
    """EVENT_ONLY with the continuous tracker over three 24,000-event
    chunks: the builder's chunks, two windows through build_mci."""
    from eorb_slam_tpu.slam import event_continuous as jec

    for mod, side in ((jec, "j"), (tec, "t")):
        fn = mod.ContinuousEventTracker.process_event_image

        def logged(self, img, ts, full=True, fn=fn, side=side):
            r = fn(self, img, ts, full=full)
            T = self.T_last
            both[side].append((dict(r, kf=r.get("kf")),
                               np.asarray(T) if side == "j" else T.numpy().copy(), self.n_kf))
            return r

        monkeypatch.setattr(mod.ContinuousEventTracker, "process_event_image", logged)
    (jslam, jout, _), (tslam, tout, _) = _run_both_events(data["cont"], tmp_path, 3)
    assert isinstance(tslam, tec.EventSlamContinuous)
    _same_frames(both)
    sj, st = jout["stats"], tout["stats"]
    assert st == sj
    assert st["windows"] >= 2 and st["idle"] == 0
    assert st["l2_full"] == st["windows"] and st["l2_tiny"] == st["chunks"] - st["windows"]
    assert tout["tracked_poses"] == jout["tracked_poses"]


def _run_both_events(yaml_path, out, max_frames):
    """``_run_both`` without the evaluation: the continuous tracker writes no
    trajectory before it initializes."""
    from eorb_slam_tpu.apps import run_slam as jrun
    from eorb_slam_tpu.io import config as jcfg, datasets as jds
    from eorb_slam_tpu_torch.apps import run_slam as trun
    from eorb_slam_tpu_torch.io import config as tcfg, datasets as tds

    sj, st = jcfg.load_settings(yaml_path), tcfg.load_settings(yaml_path)
    name = st.dataset.sequences[0]
    qj = jds.load_sequence(sj.dataset.format, sj.dataset.root, name, ts_factor=1.0)
    qt = tds.load_sequence(st.dataset.format, st.dataset.root, name, ts_factor=1.0)
    jslam, jout = jrun.run_sequence(sj, qj, out_dir=str(out / "j"), max_frames=max_frames,
                                    verbose=False)
    tslam, tout = trun.run_sequence(st, qt, out_dir=str(out / "t"), max_frames=max_frames,
                                    verbose=False, device="cpu")
    return (jslam, jout, None), (tslam, tout, None)
