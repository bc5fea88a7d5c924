"""The port's monocular-inertial system (``slam/vi_system.MonoInertialSlam``)
against the JAX package's, frame by frame on ONE SynthWorld run: the same
features (``tests/synth.SynthWorld``) and IMU chunks (``imu_between``, with
gyro and accelerometer biases) go into both, through
``process_features_imu``: preintegration per frame and per keyframe, the
staged inertial initialization with its chi2/dof gate, gravity alignment
and metric rescaling, IMU-predicted tracking with the motion-only VI
optimization, VI local BA and the scale refinements.

JAX's two-view draws and fits are injected (tests/test_torch_l2_slice
``jax_draws``). The world measures chi2/dof ~0.1 at the accepted init, far
from the 3.0 gate, so both packages accept the same attempts.

Sized for the CPU: 50 frames (the IMU initializes at frame 34), K=12, M=2048
(tests/test_vi_slam.py runs 120 frames at K=32, M=4096). Asserted: the same
state and keyframe decision on every frame, the same init frame, keyframe
count and accepted-init keyframe, the same sequence of accepted world
transforms, scale within 1%, per-frame camera positions within 1 cm; and
the reference's own gates on the port: SE3 ATE < 0.08 m, Sim3 scale
1 +- 0.05, gyro bias within 2e-3 of the truth.
"""

import numpy as np
import pytest
import torch

from eorb_slam_tpu.evals import ate
from eorb_slam_tpu.imu import preintegration as jpre
from eorb_slam_tpu.slam import vi_system as jvs
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.imu import preintegration as tpre
from eorb_slam_tpu_torch.slam import system as tsys, vi_system as tvs
from tests.synth import CAM, SynthWorld, imu_between
from tests.test_torch_l2_slice import install_jax_draws

BG_TRUE = np.asarray([0.004, -0.006, 0.003])
BA_TRUE = np.asarray([0.02, -0.015, 0.03])
N_FRAMES, FPS = 50, 20.0
KW = dict(K=12, M=2048, N=512, P=8)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frame_t(f):
    return tsys.FrameInput(f.ts, *(torch.from_numpy(np.array(x)) for x in
                                   (f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid)))


@pytest.fixture(scope="module")
def runs():
    """(jslam, tslam, per-frame log, ground truth) of one joint run, with
    JAX's draws injected for its duration."""
    mp = pytest.MonkeyPatch()
    try:
        install_jax_draws(mp)
        world = SynthWorld(n_landmarks=1500, seed=0, noise_px=0.4)
        jslam = jvs.MonoInertialSlam(CAM, jpre.make_calib(freq=200.0), **KW)
        tslam = tvs.MonoInertialSlam(CAM, tpre.make_calib(freq=200.0), device="cpu", **KW)
        log, gt, t_prev = [], [], 0.0
        for i in range(N_FRAMES):
            t = i / FPS
            f, Tcw = world.frame(t)
            chunk = imu_between(world, t_prev, t, bg=BG_TRUE, ba=BA_TRUE)
            rj = jslam.process_features_imu(f, chunk)
            rt = tslam.process_features_imu(_frame_t(f), tvs.ImuChunk(**vars(chunk)))
            log.append((rj, rt, jslam.imu_initialized, tslam.imu_initialized,
                        jslam.n_kf, tslam.n_kf))
            gt.append((t, np.linalg.inv(Tcw)))
            t_prev = t
    finally:
        mp.undo()
    return jslam, tslam, log, gt


def test_same_decisions_and_init(runs):
    jslam, tslam, log, _ = runs
    for i, (rj, rt, ij, it, kj, kt) in enumerate(log):
        assert rt["state"] == rj["state"], (i, rj, rt)
        assert rt.get("kf") == rj.get("kf"), (i, rj, rt)
        assert (it, kt) == (ij, kj), i
    init = [i for i, (*_, ij, it, _, _) in enumerate(log) if it]
    assert init and init[0] == [i for i, (*_, ij, it, _, _) in enumerate(log) if ij][0]
    assert tslam._init_kf_count == jslam._init_kf_count
    assert tslam.stats["kf"] == jslam.stats["kf"] and tslam.stats["lost"] == 0
    # the same attempts, and the same accepted world transforms
    assert len(tslam._init_scale_hist) == len(jslam._init_scale_hist)
    np.testing.assert_allclose(tslam._init_scale_hist, jslam._init_scale_hist, rtol=1e-2)
    assert len(tslam.pending_world_transforms) == len(jslam.pending_world_transforms) >= 2
    for (Rt, st), (Rj, sj) in zip(tslam.pending_world_transforms,
                                  jslam.pending_world_transforms):
        np.testing.assert_allclose(Rt, Rj, atol=1e-3)
        assert st == pytest.approx(sj, rel=1e-2)
    assert tslam.scale_applied == pytest.approx(jslam.scale_applied, rel=1e-2)


def test_positions_within_a_centimetre(runs):
    jslam, tslam, _, _ = runs
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    d = [np.linalg.norm(a[:3, 3] - b[:3, 3]) for (_, a), (_, b) in zip(traj_t, traj_j)]
    assert max(d) < 0.01, max(d)
    np.testing.assert_allclose(tslam.bg.numpy(), np.asarray(jslam.bg), atol=2e-4)


def test_reference_gates_on_the_port(runs):
    """tests/test_vi_slam.py's bars: the map is metric after the IMU init."""
    _, tslam, _, gt = runs
    assert tslam.state == tsys.OK and tslam.imu_initialized
    est = tslam.trajectory_twc()
    rmse, n, _, _, _ = ate.ate_rmse(est, gt, with_scale=False)
    assert n > 40 and rmse < 0.08, rmse
    _, _, s_free, _, _ = ate.ate_rmse(est, gt, with_scale=True)
    assert s_free == pytest.approx(1.0, abs=0.05)
    np.testing.assert_allclose(tslam.bg.numpy(), BG_TRUE, atol=2e-3)


def test_vi_state_round_trips_through_convert(runs):
    """The port's inertial state goes to numpy and back unchanged, and the
    JAX package's state loads into a port system."""
    jslam, tslam, _, _ = runs
    st = convert.vi_state_to_numpy(tslam)
    fresh = tvs.MonoInertialSlam(CAM, tpre.make_calib(freq=200.0), device="cpu", **KW)
    convert.vi_state_from_numpy(fresh, st)
    again = convert.vi_state_to_numpy(fresh)
    for k in convert.VI_STATE:
        if k == "pre_kf":
            for f in tpre.Preintegrated._fields:
                np.testing.assert_array_equal(again[k][f], st[k][f])
        else:
            np.testing.assert_array_equal(again[k], st[k])
    jstate = {k: (jslam.pre_kf._asdict() if k == "pre_kf" else np.asarray(getattr(jslam, k)))
              for k in convert.VI_STATE}
    convert.vi_state_from_numpy(fresh, jstate)
    np.testing.assert_array_equal(fresh.kf_prev, jslam.kf_prev)
    np.testing.assert_allclose(fresh.pre_kf.C.numpy(), np.asarray(jslam.pre_kf.C),
                               rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(fresh.pre_kf.dR.numpy(), tslam.pre_kf.dR.numpy(), atol=1e-4)
