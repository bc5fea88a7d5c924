"""IMU_MONOCULAR of the app layer against the JAX package: ``run_sequence``
through both ``apps/run_slam`` modules on ONE on-disk EuRoC dataset at
320x240 (written once by the port's generator, IMU included), long enough
for the IMU to initialize, so the inertial frame step runs on both sides
(EVENT_IMU: tests/test_torch_event_inertial.py).

What is made equal by hand is what tests/test_torch_apps.py makes equal
(its ``both`` fixture): JAX's RANSAC draws and two-view fits are replayed
into the port in call order, the JAX builder resolves its window metadata
blocking, and both builders run 5 contrast-maximization iterations.
Everything else runs on its own: parser, loaders, IMU slicing,
preintegration, the inertial init and its gates, ORB, tracking, the VI
optimizations, BA and the TUM writer.

Tolerances: the same state and keyframe decision after every frame, the
same IMU-initialized flag after every frame, the same keyframe count; poses
within 2e-3 (map units) before the IMU initializes and 5e-3 after (the
metric rescale multiplies them by ~4); ATE within 10% of each other.
"""

import numpy as np
import pytest
import torch

from eorb_slam_tpu.slam import vi_system as jvs
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.slam import vi_system as tvs
from tests.test_torch_apps import _ate_close, _run_both, both  # noqa: F401 (fixture)
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)

# 39 frames at 20 fps: the IMU initializes at frame 37 (it needs 1.5 s and 6
# keyframes), then the inertial frame step runs on both sides
IM_SECONDS, IM_FPS = 1.96, 20.0


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
    root = tmp_path_factory.mktemp("synth_imu")
    W, H, fx = 320, 240, 195.0
    im_scene = tsd.make_scene("corridor", W, H, fx, n_dots=10)
    tsd.write_euroc(str(root / "im"), "corridor", im_scene, tsd.make_trajectory("corridor", 10.0),
                    duration=IM_SECONDS, fps=IM_FPS, verbose=False,
                    renderer=tsd.make_box_renderer("corridor", W, H, fx, device="cpu"))
    im_yaml = tsd.write_settings_yaml(
        str(root / "im.yaml"), fmt="euroc", root=str(root / "im"),
        seqs=["corridor"], sensor="imu_monocular", scene=im_scene, fps=IM_FPS,
        ts_factor=1.0e9, n_features=256,
        extra={"SLAM.maxKeyFrames": 8, "SLAM.maxLandmarks": 1024,
               "SLAM.maxFramesBetweenKF": 4})
    return dict(im_yaml=im_yaml)


def _log_calls(monkeypatch, log, cls, name, side, l2=lambda s: s):
    fn = getattr(cls, name)

    def wrapped(self, *a, **kw):
        r = fn(self, *a, **kw)
        s = l2(self)
        T = s.T_last
        log[side].append((dict(r), np.asarray(T) if side == "j" else T.numpy().copy(),
                          s.n_kf, s.imu_initialized))
        return r

    monkeypatch.setattr(cls, name, wrapped)


def _same_steps(log, n_pose=None):
    assert len(log["t"]) == len(log["j"]) > 0
    for i, ((rj, Tj, kj, ij), (rt, Tt, kt, it)) in enumerate(zip(log["j"], log["t"])):
        assert rt["state"] == rj["state"], (i, rj, rt)
        assert rt.get("kf") == rj.get("kf"), (i, rj, rt)
        assert (kt, it) == (kj, ij), i
        if n_pose is None or i < n_pose:
            np.testing.assert_allclose(Tt, Tj, atol=5e-3 if ij else 2e-3,
                                       err_msg=f"step {i}")
    assert log["i_two"] == len(log["two"]) and log["i_pnp"] == len(log["pnp"])


def test_run_sequence_imu_monocular_320_matches_jax(data, both, tmp_path, monkeypatch):
    _log_calls(monkeypatch, both, jvs.MonoInertialSlam, "process_image_imu", "j")
    _log_calls(monkeypatch, both, tvs.MonoInertialSlam, "process_image_imu", "t")
    (jslam, jout, ej), (tslam, tout, et) = _run_both(data["im_yaml"], tmp_path, None)
    assert isinstance(tslam, tvs.MonoInertialSlam) and tslam.device.type == "cpu"
    _same_steps(both)
    assert tslam.imu_initialized and jslam.imu_initialized
    # the inertial frame step ran after the init, on both sides
    first = [i for i, (*_, it) in enumerate(both["t"]) if it][0]
    assert len(both["t"]) - first >= 2
    assert tslam.scale_applied == pytest.approx(jslam.scale_applied, rel=1e-2)
    assert len(tslam.pending_world_transforms) == len(jslam.pending_world_transforms)
    sj, st = jout["stats"], tout["stats"]
    assert st["kf"] == sj["kf"] and st.get("kf_culled") == sj.get("kf_culled")
    assert tout["tracked_poses"] == jout["tracked_poses"] >= 30
    assert et["ate_scale"] == ej["ate_scale"] == 1.0    # inertial: SE3, no scale
    _ate_close(et, ej, et["ape_piecewise"]["traj_len"])


def test_build_system_builds_the_inertial_systems():
    """The two IMU modes build their systems from the settings: the
    calibration from ``IMU.*`` (discrete sigmas at ``IMU.Frequency``), the
    capacities from ``SLAM.*`` and the camera from ``Camera.*``."""
    from eorb_slam_tpu_torch.apps import run_slam as trun
    from eorb_slam_tpu_torch.io import config as tcfg
    from eorb_slam_tpu_torch.slam import event_inertial as tei

    imu = tcfg.ImuConfig(freq=100.0, noise_gyro=1e-3, noise_acc=1e-2)
    st = tcfg.Settings(sensor=tcfg.SensorConfig.IMU_MONOCULAR, imu=imu,
                       cam=tcfg.CameraConfig(fx=195.0, fy=195.0, cx=160.0, cy=120.0,
                                             width=320, height=240),
                       slam=tcfg.SlamConfig(max_keyframes=6, max_landmarks=512))
    slam = trun.build_system(st, device="cpu")
    assert isinstance(slam, tvs.MonoInertialSlam) and not slam.pipelined
    assert (slam.map.K, slam.map.M, slam.img_w) == (6, 512, 320)
    assert float(slam.calib.gyro_noise) == pytest.approx(1e-3 * 10.0, rel=1e-6)
    st = tcfg.Settings(sensor=tcfg.SensorConfig.EVENT_IMU, imu=imu,
                       event=tcfg.EventConfig(l1_chunk_size=6000, l1_num_loop=4))
    slam = trun.build_system(st, device="cpu")
    assert isinstance(slam, tei.EventInertialSlam) and slam.cfg.l1_chunk_size == 6000
    assert slam.device.type == slam.l2.device.type == "cpu" and not slam.l2.fuse_enabled
    assert float(slam.l2.calib.acc_walk) == pytest.approx(3e-3 / 10.0, rel=1e-6)
