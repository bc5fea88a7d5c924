"""The port's host I/O against the JAX package's, on the same files and the
same seeded arrays: the native library (built into the port's own build
directory), the event queue against the numpy buffer and against JAX's
queue, the loaders on tiny datasets written to ``tmp_path``, the TUM round
trip, and the Kannala-Brandt camera with the rectify map.

Tolerances: host arrays are equal (same parser, same arithmetic); TUM poses
1e-6 (f32 quaternions through two implementations); KB8 and the rectify map
1e-5 relative to pixel coordinates (f32 Newton steps in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import builder as jb
from eorb_slam_tpu.geometry import camera as jcam
from eorb_slam_tpu.io import datasets as jds, native as jnat, trajectory as jtraj
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.geometry import camera as tcam
from eorb_slam_tpu_torch.io import datasets as tds, native as tnat
from eorb_slam_tpu_torch.io import trajectory as ttraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(n, seed, t0=100.0):
    rng = np.random.default_rng(seed)
    ts = t0 + np.sort(rng.uniform(0, 0.05, n))
    return np.stack([ts, rng.integers(0, 240, n).astype(float),
                     rng.integers(0, 180, n).astype(float),
                     rng.integers(0, 2, n).astype(float)], 1)


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


# ------------------------------------------------------------------ native

def test_native_library_builds_into_the_port():
    lib = tnat.get_lib()
    assert lib is not None, tnat.BUILD_ERROR
    assert os.path.dirname(lib._name) == tnat.BUILD_DIR
    assert tnat.BUILD_DIR == os.path.join(REPO, "eorb_slam_tpu_torch", "build")
    assert "native" + os.sep + "libfastio" not in lib._name


@pytest.mark.parametrize("mode", ["events", "txt", "csv"])
def test_native_parsers_match_jax(tmp_path, mode):
    ev = _events(500, 1)
    p = str(tmp_path / f"f.{mode}")
    if mode == "csv":
        with open(p, "w") as f:
            f.write("#ts,x,y,p\n")
            f.writelines(f"{r[0]:.9f},{r[1]:.1f},{r[2]:.1f},{r[3]:.0f}\n" for r in ev)
        a, b = tnat.parse_csv(p), jnat.parse_csv(p)
    else:
        with open(p, "w") as f:
            f.writelines(f"{r[0]:.9f} {int(r[1])} {int(r[2])} {int(r[3])}\n" for r in ev)
        if mode == "events":
            a, b = tnat.parse_events(p, 400), jnat.parse_events(p, 400)
        else:
            a, b = tnat.parse_txt(p), jnat.parse_txt(p)
    assert a.dtype == np.float64 and np.array_equal(a, b)
    np.testing.assert_allclose(a[:, 0], ev[:len(a), 0], atol=1e-9, rtol=0)
    assert tnat.parse_txt(str(tmp_path / "missing")) is None


def test_event_queue_matches_numpy_buffer_and_jax():
    """feed / consume / inject_front in the order EventWindowBuilder uses them:
    the port's native queue, the port's numpy buffer and JAX's native queue
    hand out equal arrays."""
    ev = _events(5000, 2)
    qt, qj = tnat.make_queue(), jnat.make_queue()
    assert qt is not None and qj is not None
    b = tb.EventWindowBuilder(tb.BuilderConfig(), device="cpu")
    b._q = None                                   # the numpy path
    for q in (qt, qj, b):
        q.feed(ev[:3000])
        q.feed(ev[3000:])
    assert len(qt) == len(qj) == b.pending_events() == 5000
    for n in (700, 1300, 2048):
        ct, cj, cb = qt.consume(n), qj.consume(n), b._consume(n)
        assert ct.dtype == np.float64 and ct.shape == (n, 4)
        assert np.array_equal(ct, cj) and np.array_equal(ct, cb)
        keep = ct[-n // 2:]
        qt.inject_front(keep), qj.inject_front(keep), b._inject_front(keep)
        assert len(qt) == len(qj) == b.pending_events()
    rest = len(qt)
    ct, cj, cb = qt.consume(10 ** 6), qj.consume(10 ** 6), b._consume(10 ** 6)
    assert len(ct) == rest and np.array_equal(ct, cj) and np.array_equal(ct, cb)
    assert len(qt) == 0
    qt.close(), qj.close()


@pytest.mark.parametrize("n,cap", [(300, 512), (900, 512), (0, 64)])
def test_pad_rebase_matches_numpy_and_jax(n, cap):
    ev = _events(n, 3)
    t0 = float(ev[max(n - cap, 0), 0]) if n else 0.0
    out_t, val_t, drop_t = tnat.pad_rebase(ev, cap, t0)
    out_j, val_j, drop_j = jnat.pad_rebase(ev, cap, t0)
    assert np.array_equal(out_t[val_t], out_j[val_j]) and drop_t == drop_j
    assert np.array_equal(val_t, val_j) and out_t.dtype == np.float32
    # EventWindowBuilder's numpy branch
    kept = ev[max(n - cap, 0):]
    assert val_t.sum() == len(kept) and drop_t == max(n - cap, 0)
    np.testing.assert_array_equal(out_t[:len(kept), 0],
                                  (kept[:, 0] - t0).astype(np.float32))
    np.testing.assert_array_equal(out_t[:len(kept), 1:],
                                  kept[:, 1:].astype(np.float32))
    pt, vt, dt = tb._pad_events(ev, cap)
    pj, vj, dj = jb._pad_events(ev, cap)
    assert np.array_equal(pt[vt], pj[vj]) and np.array_equal(vt, vj) and dt == dj


def test_builder_streams_a_file_through_the_queue(tmp_path):
    ev = _events(3000, 4)
    p = str(tmp_path / "events.txt")
    with open(p, "w") as f:
        f.writelines(f"{r[0]:.9f} {int(r[1])} {int(r[2])} {int(r[3])}\n" for r in ev)
    b = tb.EventWindowBuilder(tb.BuilderConfig(), device="cpu")
    assert b._q is not None                        # native queue in use
    assert b.stream_file(p)
    b._q.stream_join()
    assert b.pending_events() == 3000
    got = b._consume(3000)
    np.testing.assert_allclose(got, ev, atol=1e-9, rtol=0)


# ------------------------------------------------------------- trajectories

def _poses(F, seed):
    rng = np.random.default_rng(seed)
    from eorb_slam_tpu_torch.geometry import lie

    Twc = np.tile(np.eye(4), (F, 1, 1))
    R = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.6, (F, 3)).astype(np.float32)))
    Twc[:, :3, :3] = R.numpy()
    Twc[:, :3, 3] = rng.normal(0, 2, (F, 3))
    return np.arange(F) * 0.05 + 100.0, Twc


def test_tum_rows_match_jax():
    ts, Twc = _poses(40, 5)
    rt, rj = ttraj.mats_to_tum(ts, Twc), jtraj.mats_to_tum(ts, Twc)
    assert rt.shape == rj.shape == (40, 8) and rt.dtype == np.float64
    np.testing.assert_allclose(rt, rj, atol=1e-6, rtol=0)
    (ts_t, Tt), (ts_j, Tj) = ttraj.tum_to_mats(rj), jtraj.tum_to_mats(rj)
    assert np.array_equal(ts_t, ts_j) and Tt.dtype == Tj.dtype
    np.testing.assert_allclose(Tt, Tj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(Tt, Twc, atol=1e-5, rtol=0)


def test_tum_file_round_trip_and_cross_load(tmp_path):
    ts, Twc = _poses(12, 6)
    timer = ttraj.SmartTimer("tracking")
    for _ in range(3):
        timer.tic()
        timer.toc()
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    ttraj.save_tum(pt, ts, Twc, timers=(timer,))
    jtraj.save_tum(pj, ts, Twc)
    assert open(pt).read().startswith("# tracking:")
    rows = ttraj.load_tum(pt)
    assert rows.shape == (12, 8)
    np.testing.assert_allclose(rows, jtraj.load_tum(pt), atol=0, rtol=0)
    np.testing.assert_allclose(rows, ttraj.load_tum(pj), atol=1e-6, rtol=0)
    ts2, T2 = ttraj.tum_to_mats(rows)
    np.testing.assert_allclose(ts2, ts, atol=1e-9)
    np.testing.assert_allclose(T2, Twc, atol=1e-5)


def test_timer_watchdog_framelog_match_jax():
    tt, tj = ttraj.SmartTimer("x"), jtraj.SmartTimer("x")
    for t in (tt, tj):
        t.deltas.extend([0.01, 0.03, 0.02])
    assert tt.average == tj.average and tt.stat_comment() == tj.stat_comment()
    wt, wj = ttraj.SmartWatchDog("w", 3), jtraj.SmartWatchDog("w", 3)
    assert [wt.step() for _ in range(7)] == [wj.step() for _ in range(7)]
    assert wt.triggered == wj.triggered == 2
    ts, Twc = _poses(6, 7)
    lt, lj = ttraj.FrameLog(), jtraj.FrameLog()
    for log in (lt, lj):
        for i in range(6):
            log.push(float(ts[i]), i % 2, Twc[i])
    (at, bt), (aj, bj) = lt.recover(Twc[:2]), lj.recover(Twc[:2])
    assert np.array_equal(at, aj)
    np.testing.assert_allclose(bt, bj, atol=1e-12)


# ------------------------------------------------------------------ loaders

def _same_sequence(st, sj):
    assert st.name == sj.name and st.n_frames == sj.n_frames
    assert np.array_equal(st.image_ts, sj.image_ts)
    assert st.image_paths == sj.image_paths
    assert st.right_paths == sj.right_paths and st.depth_paths == sj.depth_paths
    for a, b in ((st.gt_ts, sj.gt_ts), (st.gt_pose, sj.gt_pose)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert (st.imu is None) == (sj.imu is None)
    if st.imu is not None:
        for k in ("ts", "gyro", "acc"):
            assert np.array_equal(getattr(st.imu, k), getattr(sj.imu, k)), k
        for a, b in zip(st.imu.chunk(0.0, 1e12, 8), sj.imu.chunk(0.0, 1e12, 8)):
            assert np.array_equal(a, b)
    assert (st.events is None) == (sj.events is None)
    if st.events is not None:
        assert st.events.events.dtype == np.float64
        assert np.array_equal(st.events.events, sj.events.events)


def _png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def test_ev_ethz_loader_matches_jax(tmp_path):
    root = str(tmp_path)
    seq = os.path.join(root, "s")
    ev = _events(2000, 8)
    _write(os.path.join(seq, "events.txt"), "".join(
        f"{r[0]:.9f} {int(r[1])} {int(r[2])} {int(r[3])}\n" for r in ev))
    _write(os.path.join(seq, "imu.txt"),
           "0.00 0.1 0.2 9.8 0.01 0.02 0.03\n0.02 0.1 0.3 9.7 0.02 0.02 0.03\n")
    _write(os.path.join(seq, "groundtruth.txt"),
           "0.0 0 0 0 0 0 0 1\n0.05 0.1 0 0 0 0 0 1\n")
    _write(os.path.join(seq, "images.txt"), "100.01 images/a.png\n100.05 images/b.png\n")
    rng = np.random.default_rng(0)
    for n in "ab":
        _png(os.path.join(seq, "images", f"{n}.png"),
             rng.integers(0, 255, (18, 24)).astype(np.uint8))
    rmap = np.zeros((180, 240, 2), np.float32)
    rmap[..., 0] = np.arange(240)[None, :] + 0.5
    rmap[..., 1] = np.arange(180)[:, None] - 0.25
    for kw in ({}, {"rectify_map": rmap}, {"max_events": 700}):
        st = tds.load_sequence("ev_ethz", root, "s", ts_factor=1.0, **kw)
        sj = jds.load_sequence("ev_ethz", root, "s", ts_factor=1.0, **kw)
        _same_sequence(st, sj)
    assert np.array_equal(st.image(1), sj.image(1)) and st.image(0).dtype == np.float32
    # chunk service and the overlap rewind
    for s in (st, sj):
        s.events.rewind(10 ** 9)
    for a, b in ((st.events.next_chunk_count(300), sj.events.next_chunk_count(300)),
                 (st.events.next_chunk_until(100.03), sj.events.next_chunk_until(100.03))):
        assert np.array_equal(a, b)
    st.events.rewind(50), sj.events.rewind(50)
    assert st.events.cursor == sj.events.cursor and not st.events.exhausted
    sm_t = tds.load_sequence("mvsec", root, "s")         # txt export fallback
    sm_j = jds.load_sequence("mvsec", root, "s")
    _same_sequence(sm_t, sm_j)


def test_euroc_loader_matches_jax(tmp_path):
    root = str(tmp_path)
    base = os.path.join(root, "MH", "mav0")
    _write(os.path.join(base, "cam0", "data.csv"),
           "#timestamp [ns],filename\n1000000000,0.png\n1050000000,1.png\n1100000000,2.png\n")
    _write(os.path.join(base, "imu0", "data.csv"),
           "#ts,wx,wy,wz,ax,ay,az\n1000000000,0.01,0.02,0.03,9.8,0.0,0.1\n"
           "1005000000,0.02,0.02,0.03,9.7,0.0,0.1\n")
    _write(os.path.join(base, "state_groundtruth_estimate0", "data.csv"),
           "#ts,px,py,pz,qw,qx,qy,qz\n1000000000,1.0,2.0,3.0,0.5,0.5,0.5,0.5\n")
    rng = np.random.default_rng(1)
    for i in range(3):
        for cam in ("cam0", "cam1"):
            _png(os.path.join(base, cam, "data", f"{i}.png"),
                 rng.integers(0, 255, (12, 16)).astype(np.uint8))
        _png(os.path.join(base, "depth0", "data", f"{i}.png"),
             rng.integers(0, 60000, (12, 16)).astype(np.uint16))
    st = tds.load_sequence("euroc", root, "MH", ts_factor=1e9)
    sj = jds.load_sequence("euroc", root, "MH", ts_factor=1e9)
    _same_sequence(st, sj)
    assert st.right_paths and st.depth_paths
    for i in range(3):
        assert np.array_equal(st.image(i), sj.image(i))
        assert np.array_equal(st.image_right(i), sj.image_right(i))
        assert np.array_equal(st.depth(i), sj.depth(i))


def test_tum_rgbd_and_kitti_loaders_match_jax(tmp_path):
    root = str(tmp_path)
    s = os.path.join(root, "fr1")
    _write(os.path.join(s, "rgb.txt"), "# c\n1.00 rgb/a.png\n1.10 rgb/b.png\n1.50 rgb/c.png\n")
    _write(os.path.join(s, "depth.txt"), "1.01 depth/a.png\n1.11 depth/b.png\n")
    _write(os.path.join(s, "groundtruth.txt"), "# g\n1.0 0 0 0 0 0 0 1\n1.1 0.1 0 0 0 0 0 1\n")
    _same_sequence(tds.load_sequence("tum_rgbd", root, "fr1"),
                   jds.load_sequence("tum_rgbd", root, "fr1"))
    k = os.path.join(root, "sequences", "00")
    _write(os.path.join(k, "times.txt"), "0.0\n0.1\n0.2\n")
    for i in range(3):
        _png(os.path.join(k, "image_0", f"{i:06d}.png"), np.zeros((4, 4), np.uint8))
        _png(os.path.join(k, "image_1", f"{i:06d}.png"), np.zeros((4, 4), np.uint8))
    _, Twc = _poses(3, 9)
    os.makedirs(os.path.join(root, "poses"))
    np.savetxt(os.path.join(root, "poses", "00.txt"), Twc[:, :3, :].reshape(3, 12))
    _same_sequence(tds.load_sequence("kitti", root, "00"),
                   jds.load_sequence("kitti", root, "00"))


def test_unported_and_unknown_formats_raise(tmp_path):
    # the bag reader is ported: "rosbag" loads a bag (tests/test_torch_rosbag.py
    # holds it against the JAX loader)
    from eorb_slam_tpu_torch.io import rosbag as tbag

    tbag.write_bag(str(tmp_path / "x.bag"), [
        ("/dvs/imu", "sensor_msgs/Imu", 1.0, tbag.encode_imu(1.0, [0, 0, 1], [0, 0, 9.81]))])
    seq = tds.load_sequence("rosbag", str(tmp_path), "x", cache_dir=str(tmp_path / "img"))
    assert seq.n_frames == 0 and len(seq.imu.ts) == 1 and seq.events is None
    with pytest.raises(ValueError):
        tds.load_sequence("nope", str(tmp_path), "x")
    with pytest.raises(FileNotFoundError):
        tds.load_sequence("mvsec", str(tmp_path), "none")


# ------------------------------------------------------------------- camera

KB8 = [190.9, 190.2, 254.9, 256.9, 0.0034, 0.0007, -0.0020, 0.0002]


def _close_px(a, b):
    np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, float(np.abs(b).max())),
                               rtol=0)


def test_kb8_matches_jax():
    rng = np.random.default_rng(10)
    pts = np.concatenate([rng.uniform(-2, 2, (200, 2)),
                          rng.uniform(0.5, 6, (200, 1))], 1).astype(np.float32)
    pt, pj = tcam.make_kb8(*KB8), jcam.make_kb8(*KB8)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    uv_t = tcam.kb8_project(pt, torch.from_numpy(pts))
    uv_j = np.array(jcam.kb8_project(pj, jnp.asarray(pts)))
    _close_px(uv_t.numpy(), uv_j)
    ray_t = tcam.kb8_unproject(pt, torch.from_numpy(uv_j))
    ray_j = np.asarray(jcam.kb8_unproject(pj, jnp.asarray(uv_j)))
    np.testing.assert_allclose(ray_t.numpy(), ray_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ray_t.numpy()[:, :2], pts[:, :2] / pts[:, 2:], atol=1e-4)
    J_t = tcam.kb8_project_jac_point(pt, torch.from_numpy(pts[0]))
    J_j = np.asarray(jcam.kb8_project_jac_point(pj, jnp.asarray(pts[0])))
    np.testing.assert_allclose(J_t.numpy(), J_j, atol=1e-3, rtol=1e-5)
    for model in (tcam.PINHOLE, tcam.FISHEYE_KB8):
        prm = [KB8[0], KB8[1], KB8[2], KB8[3], -0.1, 0.02, 1e-4, -1e-4, 0.0]
        a = tcam.project(model, torch.tensor(prm), torch.from_numpy(pts))
        b = np.array(jcam.project(model, jnp.asarray(prm, jnp.float32), jnp.asarray(pts)))
        _close_px(a.numpy(), b)
        c = tcam.unproject(model, torch.tensor(prm), torch.from_numpy(b))
        d = np.asarray(jcam.unproject(model, jnp.asarray(prm, jnp.float32), jnp.asarray(b)))
        np.testing.assert_allclose(c.numpy(), d, atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["pinhole", "kb8"])
def test_rectify_map_matches_jax(model):
    if model == "kb8":
        prm = np.asarray([100.0, 100.0, 32.0, 24.0, 0.01, -0.002, 0.001, 0.0, 0.0], np.float32)
        mt = tcam.build_rectify_map(torch.from_numpy(prm), 64, 48, tcam.FISHEYE_KB8)
        mj = jcam.build_rectify_map(jnp.asarray(prm), 64, 48, jcam.FISHEYE_KB8)
    else:
        prm = np.asarray([100.0, 101.0, 32.0, 24.0, -0.3, 0.1, 1e-3, -2e-3, 0.01], np.float32)
        mt = tcam.build_rectify_map(torch.from_numpy(prm), 64, 48)
        mj = jcam.build_rectify_map(jnp.asarray(prm), 64, 48)
    assert isinstance(mt, np.ndarray) and mt.shape == mj.shape == (48, 64, 2)
    _close_px(mt, mj)
    assert np.abs(mt[0, 0] - [0, 0]).max() > 0.05      # the corner moved


def test_kb8_triangulate_matches_jax():
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.uniform(-1, 1, (64, 2)),
                          rng.uniform(2, 6, (64, 1))], 1).astype(np.float32)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -0.2
    pj = jcam.make_kb8(*KB8)
    uv1 = np.array(jcam.kb8_project(pj, jnp.asarray(pts)))
    uv2 = np.array(jcam.kb8_project(pj, jnp.asarray(pts @ Trl[:3, :3].T + Trl[:3, 3])))
    uv2[:8] += 9.0                                    # broken matches
    valid = np.ones(64, bool)
    valid[60:] = False
    pt = tcam.make_kb8(*KB8)
    X_t, z_t, ok_t = tcam.kb8_triangulate_matches(
        pt, pt, torch.from_numpy(Trl), torch.from_numpy(uv1),
        torch.from_numpy(uv2), torch.from_numpy(valid))
    X_j, z_j, ok_j = jcam.kb8_triangulate_matches(
        pj, pj, jnp.asarray(Trl), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(valid))
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j)) and ok_t.sum() >= 40
    ok = ok_t.numpy()
    np.testing.assert_allclose(X_t.numpy()[ok], np.asarray(X_j)[ok], atol=2e-3)
    np.testing.assert_allclose(X_t.numpy()[ok], pts[ok], atol=5e-2)
