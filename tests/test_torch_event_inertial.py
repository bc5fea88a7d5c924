"""EVENT_IMU of the port (``slam/event_inertial``) against the JAX package:
``ImuBuffer`` windows (exactly equal, empty windows and pushed chunks
included), the MCI dispatch, and ``EventInertialSlam`` on a short event
stream with IMU MCI by MCI, through ``run_sequence`` of both
``apps/run_slam`` modules on ONE on-disk EV-ETHZ dataset (generated shakes
with its imu.txt): the event-clock loop feeding ``grab_imu``, the builder,
the MCIs, the inertial L2 (preintegration per MCI merged into per-keyframe
factors), tracking and mapping.

As in tests/test_torch_apps.py (its ``both`` fixture) the JAX draws and
two-view fits are injected, window metadata resolves blocking on both sides
and the builders run 5 ascent iterations. The stream is short of the IMU
init's 1 s of keyframes: the inertial init is held in
tests/test_torch_vi_slam.py and tests/test_torch_apps_inertial.py.

Tolerances: the same L2 state and keyframe decision after every MCI, the
same keyframe count, poses within 2e-3 (map units) after every MCI,
the per-keyframe preintegrations' dt equal and dR within 1e-5, the same IMU
samples left in both buffers, the ATEs within 10% of each other.
"""

import numpy as np
import pytest
import torch

from eorb_slam_tpu.slam import event_inertial as jei
from eorb_slam_tpu.slam.vi_system import ImuChunk as JChunk
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.imu import preintegration as tpre
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.slam import event_inertial as tei
from eorb_slam_tpu_torch.slam.vi_system import ImuChunk
from tests.test_torch_apps import _ate_close, _run_both, both  # noqa: F401 (fixture)
from tests.test_torch_apps_inertial import _log_calls, _same_steps
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)
from tests.test_torch_slice import CAM, CFG

CHUNKS = 5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ev_yaml(tmp_path_factory):
    """A generated EV-ETHZ shakes sequence with its IMU, and the settings
    (the synth_ev_imu shape: 240x180, fx 199, 12,000 x 4 event windows)."""
    root = tmp_path_factory.mktemp("synth_ev_imu")
    scene = tsd.make_scene("shakes", 240, 180, 199.0, n_dots=1500, seed=0)
    tsd.write_ev_ethz(str(root / "ev"), "shakes", scene, tsd.make_trajectory("shakes", 1.0),
                      duration=0.12, contrast=0.45, with_images=False, verbose=False,
                      device="cpu")
    return tsd.write_settings_yaml(
        str(root / "ev.yaml"), fmt="ev_ethz", root=str(root / "ev"),
        seqs=["shakes"], sensor="event_imu", scene=scene, fps=24.0,
        ts_factor=1.0, n_features=256,
        extra={"Event.data.l1ChunkSize": 12000, "Event.data.l1NumLoop": 4,
               "Event.data.maxPixelDisp": 3.0, "Event.data.minEvGenRate": 0.5})


def _chunks_equal(a, b):
    for k in ("gyro", "acc", "dts"):
        x, y = getattr(a, k), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_imu_buffer_windows_equal_jax():
    rng = np.random.default_rng(0)
    ts = np.arange(0.0, 1.0, 0.005) + rng.uniform(0, 1e-4, 200)
    gyro, acc = rng.normal(size=(200, 3)), rng.normal(size=(200, 3))
    jbuf, tbuf = jei.ImuBuffer(), tei.ImuBuffer()
    for buf in (jbuf, tbuf):
        buf.push(ts[:120], gyro[:120], acc[:120])
    for t1 in (0.0, 0.25, 0.25, 0.31, 0.6, 0.6001):
        _chunks_equal(tbuf.window(t1), jbuf.window(t1))
    chunk = dict(gyro=gyro[120:].astype(np.float32), acc=acc[120:].astype(np.float32),
                 dts=np.full(80, 0.005, np.float32))
    jbuf.push_chunk(1.0, JChunk(**chunk))
    tbuf.push_chunk(1.0, ImuChunk(**chunk))
    for t1 in (0.8, 2.0, 3.0):
        _chunks_equal(tbuf.window(t1), jbuf.window(t1))
    assert len(tbuf) == 0 and tbuf.popped == 200
    # the JAX test's own case on the port
    buf = tei.ImuBuffer()
    t = np.arange(0.0, 1.0, 0.005)
    buf.push(t, np.ones((len(t), 3)), 2 * np.ones((len(t), 3)))
    c1, c2 = buf.window(0.25), buf.window(0.5)
    assert c1.gyro.shape[0] == 51 and c2.gyro.shape[0] == 50
    assert np.isclose(c2.dts.sum(), 0.25, atol=0.01) and buf.window(0.5).gyro.shape[0] == 0


@pytest.mark.parametrize("initialized", [False, True])
def test_track_mci_takes_the_inertial_step_once_initialized(initialized, monkeypatch):
    """_track_mci routes an MCI to process_image_imu once the IMU is
    initialized and tracking, else to extraction + process_features_imu (the
    JAX module's dispatch), and hands each its IMU window."""
    slam = tei.EventInertialSlam(CAM, tpre.make_calib(), tb.BuilderConfig(**CFG),
                                 max_kp=64, K=4, M=64, device="cpu")
    slam.grab_imu(np.asarray([0.01, 0.02, 0.03]), np.zeros((3, 3)), np.zeros((3, 3)))
    seen = []
    monkeypatch.setattr(slam.l2, "process_image_imu",
                        lambda img, ts, chunk, max_kp=None: seen.append(("img", len(chunk.dts)))
                        or {"state": slam.l2.state})
    monkeypatch.setattr(slam.l2, "process_features_imu",
                        lambda f, chunk: seen.append(("feat", len(chunk.dts)))
                        or {"state": slam.l2.state})
    slam.l2.imu_initialized = initialized
    slam.l2.state = tei.slam_system.OK if initialized else tei.slam_system.NOT_INITIALIZED
    pi = tb.PoseImage(*([None] * len(tb.PoseImage._fields)))._replace(
        img=torch.zeros(CFG["img_h"], CFG["img_w"]), ts=0.025, best_kind="hist")
    res = slam._track_mci(pi)
    assert seen == [("img" if initialized else "feat", 2)]
    assert res["imu_init"] is initialized and res["ts"] == 0.025


def test_run_sequence_event_imu_matches_jax(ev_yaml, both, tmp_path, monkeypatch):
    _log_calls(monkeypatch, both, jei.EventInertialSlam, "_track_mci", "j", lambda s: s.l2)
    _log_calls(monkeypatch, both, tei.EventInertialSlam, "_track_mci", "t", lambda s: s.l2)
    (jslam, jout, ej), (tslam, tout, et) = _run_both(ev_yaml, tmp_path, CHUNKS)
    assert isinstance(tslam, tei.EventInertialSlam) and tslam.builder._q is not None
    _same_steps(both)
    assert tout["iterations"] == jout["iterations"] == CHUNKS
    sj, st = jout["stats"], tout["stats"]
    for k in ("windows", "chunks", "mci", "tracked", "l2_kf", "l2_lost"):
        assert st[k] == sj[k], k
    assert st["mci"] >= 8 and st["tracked"] >= 3
    # every IMU sample up to the last MCI went through the buffer, on both
    last_ts = both["t"][-1][0]["ts"]
    assert tslam.imu.popped > 0 and not (tslam.imu._ts <= last_ts).any()
    assert len(tslam.imu) == len(jslam.imu._ts)
    # ... and into the same per-keyframe inertial factors
    np.testing.assert_array_equal(tslam.l2.kf_prev, jslam.l2.kf_prev)
    live = tslam.l2.kf_prev >= 0
    assert live.sum() >= 1
    np.testing.assert_allclose(tslam.l2.pre_kf.dt.numpy()[live],
                               np.asarray(jslam.l2.pre_kf.dt)[live], atol=1e-6)
    np.testing.assert_allclose(tslam.l2.pre_kf.dR.numpy()[live],
                               np.asarray(jslam.l2.pre_kf.dR)[live], atol=1e-5)
    assert tout["tracked_poses"] == jout["tracked_poses"]
    _ate_close(et, ej, et["ape_piecewise"]["traj_len"])
