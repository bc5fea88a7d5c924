"""The port's dataset generator against the JAX package's on the same seeds:
trajectories, scenes, IMU and ground truth are numpy on both sides and
equal; the dot renderer (torch in the port, JAX in the reference) agrees to
1e-5 of the image maximum, the box renderer to 1e-4 with 99.5% of the
pixels within 1e-5 (see there); the event simulation is a threshold process on
those images, so a last-ulp pixel difference may add or drop an event:
event counts agree within 0.5%, not event for event.

The dot renderer reaches the splat through ``tensorize.splat_gauss`` on both
sides (the port's separable form on the CPU, JAX's XLA form: the Pallas
kernel is only dispatched on a TPU backend)."""

import os

import numpy as np
import pytest
import torch

from eorb_slam_tpu.io import datasets as jds, synth_dataset as jsd
from eorb_slam_tpu_torch.io import datasets as tds, synth_dataset as tsd


TRAJS = ["corridor", "room", "shakes"]


def _img_close(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32, what
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()),
                               err_msg=what)


@pytest.mark.parametrize("kind", TRAJS)
def test_trajectory_scene_imu_gt_match_jax(kind):
    pt, pj = tsd.make_trajectory(kind, 4.0), jsd.make_trajectory(kind, 4.0)
    for t in (0.0, 0.37, 1.9, 3.99):
        assert np.array_equal(pt(t), pj(t))
    st = tsd.make_scene(kind, 240, 180, 199.0, n_dots=200, seed=3)
    sj = jsd.make_scene(kind, 240, 180, 199.0, n_dots=200, seed=3)
    assert np.array_equal(st.dots, sj.dots) and np.array_equal(st.amp, sj.amp)
    assert st.dots.shape == (800, 3) and st.sigma == sj.sigma == 1.1
    assert np.array_equal(st.camera_params(), sj.camera_params())
    for a, b in zip(tsd.imu_from_trajectory(pt, 0.0, 0.1, 200.0, 2e-4, 2e-3, seed=1),
                    jsd.imu_from_trajectory(pj, 0.0, 0.1, 200.0, 2e-4, 2e-3, seed=1)):
        assert np.array_equal(a, b)
    ts = np.linspace(0.01, 0.5, 9)
    assert np.array_equal(tsd._gt_rows(pt, ts), jsd._gt_rows(pj, ts))


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(0)
    for w in (rng.normal(0, 1, 3), np.zeros(3), np.asarray([3.1, 0.0, 0.0])):
        R = tsd.so3_exp_np(w)
        assert np.array_equal(R, jsd.so3_exp_np(w))
        assert np.array_equal(tsd.so3_log_np(R), jsd.so3_log_np(R))
        assert np.array_equal(tsd.quat_wxyz_np(R), jsd.quat_wxyz_np(R))
    with pytest.raises(ValueError):
        tsd.make_trajectory("spiral", 1.0)


@pytest.mark.parametrize("kind", ["shakes", "corridor"])
def test_dot_renderer_matches_jax(kind):
    W, H = (240, 180) if kind == "shakes" else (160, 120)
    st = tsd.make_scene(kind, W, H, 199.0, n_dots=500, seed=1)
    sj = jsd.make_scene(kind, W, H, 199.0, n_dots=500, seed=1)
    pose = tsd.make_trajectory(kind, 2.0)
    rt, rj = tsd._renderer(st, pose, device="cpu"), jsd._renderer(sj, pose)
    assert st.gain == pytest.approx(sj.gain, rel=1e-5)
    for t in (0.0, 0.21, 1.3):
        Tcw = np.asarray(pose(t), np.float32)
        it = rt(Tcw)
        assert isinstance(it, torch.Tensor) and it.device.type == "cpu"
        _img_close(it.numpy(), rj(Tcw), f"{kind} t={t}")
    assert float(it.max()) > 0.5 and float(it.min()) == 0.0


def test_event_simulation_matches_jax_within_half_a_percent():
    st = tsd.make_scene("shakes", 240, 180, 199.0, n_dots=1500, seed=2)
    sj = jsd.make_scene("shakes", 240, 180, 199.0, n_dots=1500, seed=2)
    pose = tsd.make_trajectory("shakes", 1.0)
    et = tsd.simulate_events(tsd._renderer(st, pose, device="cpu"), pose, 0.0, 0.1)
    ej = jsd.simulate_events(jsd._renderer(sj, pose), pose, 0.0, 0.1)
    assert len(ej) > 50_000 and et.dtype == np.float64 and et.shape[1] == 4
    assert abs(len(et) - len(ej)) <= 0.005 * len(ej)
    assert np.all(np.diff(et[:, 0]) >= 0)
    for c, hi in ((1, 240), (2, 180), (3, 2)):
        assert et[:, c].min() >= 0 and et[:, c].max() < hi
    # the same pixels fire: per-pixel count images agree almost everywhere
    ht = np.histogram2d(et[:, 2], et[:, 1], bins=(180, 240), range=((0, 180), (0, 240)))[0]
    hj = np.histogram2d(ej[:, 2], ej[:, 1], bins=(180, 240), range=((0, 180), (0, 240)))[0]
    assert (ht != hj).mean() < 0.005
    # identical images give identical events (the port's vectorised ordinal
    # against the reference's per-pixel loop)
    imgs = {}

    def frozen(Tcw):
        return imgs.setdefault(Tcw.tobytes(), np.asarray(
            tsd._to_numpy(tsd._renderer(st, pose, device="cpu")(Tcw))))

    a = tsd.simulate_events(frozen, pose, 0.0, 0.04, seed=5)
    b = jsd.simulate_events(frozen, pose, 0.0, 0.04, seed=5)
    assert len(a) > 10_000 and np.array_equal(a, b)


def test_value_noise_texture_matches_jax():
    tt, tj = tsd._value_noise_texture(256, seed=4), jsd._value_noise_texture(256, seed=4)
    _img_close(tt, tj)
    assert tt.min() == 0.0 and tt.max() == 1.0


@pytest.mark.parametrize("kind", ["corridor", "room"])
def test_box_renderer_matches_jax(kind):
    W, H, fx = 160, 120, 97.0
    rt = tsd.make_box_renderer(kind, W, H, fx, seed=2, device="cpu")
    rj = jsd.make_box_renderer(kind, W, H, fx, seed=2)
    pose = tsd.make_trajectory(kind, 6.0)
    for t in (0.0, 1.7, 4.2):
        Tcw = np.asarray(pose(t), np.float32)
        it, dt = rt.with_depth(Tcw)
        ij, dj = rj.with_depth(Tcw)
        it, dt, ij, dj = (np.asarray(x) for x in (it, dt, ij, dj))
        # texture coordinates reach ~7,000 texels (wall offset x 160 px/m),
        # where one f32 ulp is 5e-4 texel: a last-ulp difference in the ray
        # hit moves the bilinear sample by up to ~4e-5. So: every pixel
        # within 1e-4 of the maximum, at least 99.5% within 1e-5 of it
        err = np.abs(it - ij) / float(ij.max())
        assert err.max() < 1e-4, (kind, t, err.max())
        assert (err > 1e-5).mean() < 5e-3, (kind, t, (err > 1e-5).sum())
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rt(Tcw).numpy(), it)
    assert it.std() > 0.05
    with pytest.raises(ValueError):
        tsd.make_box_renderer("shakes", W, H, fx, device="cpu")


def _read(path):
    with open(path) as f:
        return f.read()


def test_write_ev_ethz_matches_jax(tmp_path):
    st = tsd.make_scene("shakes", 240, 180, 199.0, n_dots=800, seed=1)
    sj = jsd.make_scene("shakes", 240, 180, 199.0, n_dots=800, seed=1)
    pose = tsd.make_trajectory("shakes", 1.0)
    kw = dict(duration=0.1, fps=24.0, sim_hz=150.0, contrast=0.25, verbose=False)
    rt = tsd.write_ev_ethz(str(tmp_path / "t"), "s", st, pose, device="cpu", **kw)
    rj = jsd.write_ev_ethz(str(tmp_path / "j"), "s", sj, pose, **kw)
    assert sorted(os.listdir(rt)) == sorted(os.listdir(rj))
    for name in ("imu.txt", "groundtruth.txt", "calib.txt", "images.txt"):
        assert _read(os.path.join(rt, name)) == _read(os.path.join(rj, name)), name
    # each side's files load through each side's loader
    qt = tds.load_sequence("ev_ethz", str(tmp_path / "t"), "s")
    qj = jds.load_sequence("ev_ethz", str(tmp_path / "j"), "s")
    assert qt.events.events.dtype == np.float64
    nt, nj = len(qt.events), len(qj.events)
    assert nj > 20_000 and abs(nt - nj) <= 0.005 * nj
    assert np.array_equal(qt.imu.gyro, qj.imu.gyro) and np.array_equal(qt.gt_pose, qj.gt_pose)
    assert qt.n_frames == qj.n_frames == 2
    for i in range(2):      # 8-bit PNGs: one grey level where a pixel rounds apart
        assert np.abs(qt.image(i) - qj.image(i)).max() <= 1.0 / 255 + 1e-6
    cross = jds.load_sequence("ev_ethz", str(tmp_path / "t"), "s")
    assert np.array_equal(cross.events.events, qt.events.events)


def test_write_euroc_matches_jax(tmp_path):
    W, H, fx = 96, 64, 60.0
    pose = tsd.make_trajectory("corridor", 2.0)
    scene_t = tsd.make_scene("corridor", W, H, fx, n_dots=50)
    scene_j = jsd.make_scene("corridor", W, H, fx, n_dots=50)
    kw = dict(duration=0.2, fps=20.0, verbose=False, stereo_baseline=0.11,
              write_depth=True)
    rt = tsd.write_euroc(str(tmp_path / "t"), "c", scene_t, pose,
                         renderer=tsd.make_box_renderer("corridor", W, H, fx, device="cpu"),
                         **kw)
    rj = jsd.write_euroc(str(tmp_path / "j"), "c", scene_j, pose,
                         renderer=jsd.make_box_renderer("corridor", W, H, fx), **kw)
    for sub in ("cam0/data.csv", "imu0/data.csv",
                "state_groundtruth_estimate0/data.csv"):
        assert _read(os.path.join(rt, "mav0", sub)) == _read(os.path.join(rj, "mav0", sub))
    qt = tds.load_sequence("euroc", str(tmp_path / "t"), "c")
    qj = jds.load_sequence("euroc", str(tmp_path / "j"), "c")
    assert qt.n_frames == qj.n_frames == 4 and qt.right_paths and qt.depth_paths
    for i in range(4):
        assert np.abs(qt.image(i) - qj.image(i)).max() <= 1.0 / 255 + 1e-6
        assert np.abs(qt.image_right(i) - qj.image_right(i)).max() <= 1.0 / 255 + 1e-6
        assert np.abs(qt.depth(i) - qj.depth(i)).max() <= 2.0 / 5000
    with pytest.raises(ValueError, match="with_depth"):
        tsd.write_euroc(str(tmp_path / "x"), "c", scene_t, pose, duration=0.1,
                        write_depth=True, verbose=False, device="cpu")
    # without a renderer the dot renderer draws the frames
    tsd.write_euroc(str(tmp_path / "d"), "c", scene_t, pose, duration=0.1,
                    verbose=False, device="cpu")
    assert tds.load_sequence("euroc", str(tmp_path / "d"), "c").n_frames == 2


def test_write_settings_yaml_matches_jax(tmp_path):
    from eorb_slam_tpu_torch.io import config as tcfg

    scene = tsd.make_scene("shakes", 240, 180, 199.0, n_dots=10)
    kw = dict(fmt="ev_ethz", root="/data/x", seqs=["a", "b"], sensor="event_only",
              scene=scene, fps=24.0, ts_factor=1.0, n_features=256,
              extra={"Event.data.l1ChunkSize": 6000, "Event.contTracking": 0})
    pt = tsd.write_settings_yaml(str(tmp_path / "t.yaml"), **kw)
    pj = jsd.write_settings_yaml(str(tmp_path / "j.yaml"), **kw)
    assert _read(pt) == _read(pj)
    s = tcfg.load_settings(pt)
    assert s.sensor is tcfg.SensorConfig.EVENT_ONLY and s.dataset.sequences == ("a", "b")
    assert s.event.l1_chunk_size == 6000 and not s.event.continuous


def test_cli_generates_on_the_cpu_when_asked(tmp_path, capsys):
    tsd.main(["--out", str(tmp_path), "--kind", "ev_ethz", "--seq", "s",
              "--duration", "0.05", "--n-dots", "300", "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    seq = tds.load_sequence("ev_ethz", str(tmp_path), "s")
    assert len(seq.events) > 1000 and seq.gt_pose.shape == (5, 7)
    tsd.main(["--out", str(tmp_path), "--kind", "euroc", "--seq", "c",
              "--duration", "0.1", "--size", "96x64", "--device", "cpu"])
    assert tds.load_sequence("euroc", str(tmp_path), "c").n_frames == 2
