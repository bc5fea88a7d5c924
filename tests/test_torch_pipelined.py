"""The port's pipelined speculation (``MonoSlam(pipelined=True)``, what
EventSlam and the MONOCULAR app build) against the JAX package's, frame by
frame on the same rendered 320x240 corridor frames: the decision on a frame
is read one frame late, a keyframe keeps the in-flight frame's predicted
pose, and a frame that did not track rolls the speculation back and is
replayed synchronously.

JAX's RANSAC draws and two-view fits are injected (tests/test_torch_l2_slice
``jax_draws``); everything else runs on its own. Tolerances, as for
MONOCULAR in tests/test_torch_apps.py: the same result (state, keyframe
decision) after every ``process_image``, the same keyframe count, poses
within 2e-3 (map units) after every frame and in the final trajectory, and
the same trajectory timestamps. The reference's own gates
(tests/test_pipelined.py) hold on the port: speculation tracks within 2
frames of the synchronous path, keyframes within 3, ATE < max(0.05, 2 sync
+ 0.01); after a blank frame it recovers, with no duplicate timestamps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.evals import ate
from eorb_slam_tpu.slam import system as jsys
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.slam import system as tsys
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)

W, H, FX, FPS = 320, 240, 195.0, 20.0
N_FRAMES, BLANK_AT = 26, 16
KW = dict(img_w=W, img_h=H, K=8, M=1024, N=256, max_frames_between_kf=4)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """The corridor at 320x240 through the port's box renderer, as uint8
    frames, with the ground-truth Tcw of each."""
    render = tsd.make_box_renderer("corridor", W, H, FX, device="cpu")
    pose = tsd.make_trajectory("corridor", 10.0)
    out = []
    for i in range(N_FRAMES):
        Tcw = np.asarray(pose(i / FPS), np.float32)
        img = (render(Tcw).numpy() * 255.0).astype(np.uint8)
        out.append((i / FPS, img, Tcw))
    return out


def _cam():
    return np.asarray([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0], np.float32)


def _run_both(frames, blank_at=None):
    """Both packages with speculation on, frame by frame; per-frame results."""
    jslam = jsys.MonoSlam(jnp.asarray(_cam()), pipelined=True, **KW)
    tslam = tsys.MonoSlam(_cam(), pipelined=True, device="cpu", **KW)
    log = []
    for i, (ts, img, _) in enumerate(frames):
        if i == blank_at:
            img = np.zeros_like(img)
        rj = jslam.process_image(jnp.asarray(img), ts)
        rt = tslam.process_image(torch.from_numpy(img), ts)
        log.append((rj, rt, np.asarray(jslam.T_last), tslam.T_last.numpy().copy(),
                    jslam.n_kf, tslam.n_kf))
    return jslam, tslam, log


def _same_run(jslam, tslam, log):
    for i, (rj, rt, Tj, Tt, kj, kt) in enumerate(log):
        assert rt["state"] == rj["state"], (i, rj, rt)
        assert rt.get("kf") == rj.get("kf"), (i, rj, rt)
        assert rt.get("pipelined") == rj.get("pipelined"), (i, rj, rt)
        assert kt == kj, i
        np.testing.assert_allclose(Tt, Tj, atol=2e-3, err_msg=f"frame {i}")
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=2e-3)
    assert tslam.stats["kf"] == jslam.stats["kf"]
    assert tslam.stats["lost"] == jslam.stats["lost"]
    return traj_t


def _ate(traj, frames):
    gt = {round(t, 6): np.linalg.inv(Tcw) for t, _, Tcw in frames}
    est = [(t, T) for t, T in traj if round(t, 6) in gt]
    r, n, _, _, _ = ate.ate_rmse(est, [(t, gt[round(t, 6)]) for t, _ in est],
                                 with_scale=True)
    return r, n


def test_speculation_matches_jax_and_the_sync_path(frames, jax_draws):
    jslam, tslam, log = _run_both(frames)
    assert any(rt.get("pipelined") for _, rt, *_ in log)        # it speculated
    traj = _same_run(jslam, tslam, log)
    assert tslam.state == tsys.OK and tslam.stats["kf"] >= 4
    assert tslam._pipe is None                                   # flushed

    sync = tsys.MonoSlam(_cam(), pipelined=False, device="cpu", **KW)
    for ts, img, _ in frames:
        sync.process_image(torch.from_numpy(img), ts)
    r_p, n_p = _ate(traj, frames)
    r_s, n_s = _ate(sync.trajectory_twc(), frames)
    assert n_p >= n_s - 2 and n_p >= N_FRAMES - 8
    assert abs(tslam.stats["kf"] - sync.stats["kf"]) <= 3
    assert r_p < max(0.05, 2.0 * r_s + 0.01), (r_p, r_s)


def test_blank_frame_rolls_back_like_jax(frames, jax_draws):
    """A blank frame mid-run is a failed speculation: the rollback drops its
    trajectory entry and its successor's, restores the pose and replays
    both synchronously, on both packages alike."""
    jslam, tslam, log = _run_both(frames, blank_at=BLANK_AT)
    traj = _same_run(jslam, tslam, log)
    # the replayed blank frame went lost (its successor's result is what
    # process_image returned), the same on both
    assert tslam.stats["lost"] == jslam.stats["lost"] >= 1
    ts = [t for t, _ in traj]
    assert len(ts) == len(set(ts))
    assert BLANK_AT / FPS not in ts
    assert tslam.state == tsys.OK
    r, n = _ate(traj, frames)
    assert n >= N_FRAMES - 8 and r < 0.12, (r, n)
