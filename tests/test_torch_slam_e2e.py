"""End-to-end monocular SLAM of the port on the synthetic world of
tests/test_slam_e2e.py, at the full width (752x480, 512 features, K=32,
M=4096), where duplicate fusion and the descriptor refresh are on: init,
tracking, mapping, and the same ATE gate as the JAX package's test (5 cm on
a ~7 m trajectory, scale free). The port runs its own RANSAC draws here."""

import numpy as np
import pytest
import torch

from eorb_slam_tpu_torch.evals import ate
from eorb_slam_tpu_torch.slam.system import OK, FrameInput, MonoSlam
from tests.synth import CAM, SynthWorld


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


@pytest.fixture(scope="module")
def run_result():
    world = SynthWorld(n_landmarks=1500, seed=0, noise_px=0.4)
    slam = MonoSlam(CAM, K=32, M=4096, N=512, P=8, device="cpu")
    assert slam.fuse_enabled and slam.desc_refresh
    gt = []
    for i in range(120):
        t = i / 20.0
        f, Tcw_gt = world.frame(t)
        slam.process_features(FrameInput(f.ts, *(
            torch.from_numpy(np.array(x))
            for x in (f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid))))
        gt.append((t, np.linalg.inv(Tcw_gt)))
    return slam, gt


def test_initializes(run_result):
    slam, _ = run_result
    assert slam.state == OK and slam.n_kf >= 2 and slam.stats["lm"] > 100


def test_never_lost(run_result):
    assert run_result[0].stats["lost"] == 0


def test_tracks_most_frames(run_result):
    slam, gt = run_result
    assert len(slam.trajectory_twc()) > 0.9 * (len(gt) - 2)


def test_ate_gate(run_result):
    slam, gt = run_result
    rmse, n, _, _, _ = ate.ate_rmse(slam.trajectory_twc(), gt, with_scale=True)
    assert n > 100
    assert rmse < 0.05, f"ATE RMSE {rmse:.4f} m over {n} poses"


def test_keyframes_and_map_grow(run_result):
    slam, _ = run_result
    assert slam.n_kf >= 4 and slam.stats["lm"] > 300


def test_fusion_and_refresh_ran_on_every_keyframe(run_result):
    st = run_result[0].stats
    assert st["fuse_steps"] == st["refresh_steps"] >= 4
    assert st.get("fused", 0) >= 0 and st["kf"] >= 4
