"""The port's headless viewer (viz/viewer.py): the four cases of
tests/test_viz.py, and MapDrawer.draw / plot_trajectories / FrameDrawer
giving pixel-equal arrays to the JAX package's on the same numpy inputs."""

from __future__ import annotations

import os

import numpy as np

from eorb_slam_tpu.viz import viewer as jviewer
from eorb_slam_tpu_torch.viz import viewer


def _map_inputs():
    rng = np.random.default_rng(0)
    lm = rng.uniform(-2, 2, (500, 3))
    valid = rng.uniform(size=500) > 0.3
    kf_T = np.tile(np.eye(4), (4, 1, 1))
    for k in range(4):
        kf_T[k, :3, 3] = [0.1 * k, 0, 0]
    traj = [(0.1 * k, np.linalg.inv(kf_T[k])) for k in range(4)]
    return lm, valid, kf_T, traj


def _trajectories():
    tr = {
        "est": [(t, np.eye(4) + 0) for t in np.arange(0, 1, 0.1)],
        "gt": [(t, np.eye(4) + 0) for t in np.arange(0, 1, 0.1)],
    }
    for k, (ts, T) in enumerate(tr["est"]):
        T2 = T.copy()
        T2[:3, 3] = [0.1 * k, 0.05 * k, 0]
        tr["est"][k] = (ts, T2)
    return tr


def test_map_drawer(tmp_path):
    lm, valid, kf_T, traj = _map_inputs()
    p = str(tmp_path / "map.png")
    img = viewer.MapDrawer().draw(lm, valid, kf_T, 4, trajectory=traj, path=p, title="t")
    assert img.ndim == 3 and img.shape[2] == 3 and img.size > 0
    assert os.path.exists(p) and os.path.getsize(p) > 1000
    ref = jviewer.MapDrawer().draw(lm, valid, kf_T, 4, trajectory=traj, title="t")
    np.testing.assert_array_equal(img, ref)


def test_frame_drawer_channels(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (120, 160))
    kp = rng.uniform([0, 0], [160, 120], (40, 2))
    draws = []
    for mod in (viewer, jviewer):
        fd = mod.FrameDrawer()
        fd.update("orb", img, kp, state_text="OK  40 pts")
        fd.update("l2", img * 0.5, kp[:20],
                  matched=np.arange(20) % 2 == 0, state_text="TRACKING")
        draws.append(fd)
    one = draws[0].render("orb")
    assert one.shape == (120, 160, 3)
    p = str(tmp_path / "frames.png")
    both = draws[0].render_all(path=p)
    assert both.shape[0] == 240 and os.path.exists(p)
    np.testing.assert_array_equal(both, draws[1].render_all())


def test_plot_trajectories_and_save_image(tmp_path):
    tr = _trajectories()
    p = str(tmp_path / "traj.png")
    img = viewer.plot_trajectories(tr, path=p)
    assert img.size > 0 and os.path.exists(p)
    np.testing.assert_array_equal(img, jviewer.plot_trajectories(tr))

    mci = np.random.default_rng(0).uniform(size=(64, 64))
    viewer.save_image(mci, str(tmp_path / "mci.png"))
    jviewer.save_image(mci, str(tmp_path / "mci_jax.png"))
    assert (tmp_path / "mci.png").read_bytes() == (tmp_path / "mci_jax.png").read_bytes()


def test_draw_slam_facade(tmp_path):
    """MapDrawer.draw_slam over a real (tiny) port MonoSlam on the CPU: the
    map tensors are read to host numpy."""
    from eorb_slam_tpu_torch.slam.system import MonoSlam

    cam = np.asarray([200.0, 200.0, 120.0, 90.0, 0, 0, 0, 0, 0], np.float32)
    slam = MonoSlam(cam, img_w=240, img_h=180, N=128, K=8, M=256, device="cpu")
    img = viewer.MapDrawer().draw_slam(slam, path=str(tmp_path / "m.png"))
    assert img.size > 0 and os.path.exists(tmp_path / "m.png")
