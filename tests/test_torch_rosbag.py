"""The port's ROS bag v2.0 reader and writer (io/rosbag.py) against the JAX
package's: the same bytes for the same messages, a bag written by either
package read by the other, and ``load_sequence("rosbag", ...)`` giving the
JAX loader's sequence (images, IMU, events) exactly."""

import numpy as np

from eorb_slam_tpu.io import datasets as jds
from eorb_slam_tpu.io import rosbag as jbag
from eorb_slam_tpu_torch.io import datasets as tds
from eorb_slam_tpu_torch.io import rosbag as tbag


def _messages(pkg):
    """Images, IMU rows and two event arrays (tests/test_rosbag.py's bag,
    polarity as 0/1 and as -1/+1), encoded by ``pkg``'s writer."""
    rng = np.random.default_rng(0)
    msgs = []
    for i in range(4):
        ts = 1.0 + i * 0.1
        img = rng.integers(0, 255, (12, 16), np.uint8)
        msgs.append(("/dvs/image_raw", "sensor_msgs/Image", ts, pkg.encode_image(ts, img)))
    for i in range(20):
        ts = 1.0 + i * 0.02
        msgs.append(("/dvs/imu", "sensor_msgs/Imu", ts,
                     pkg.encode_imu(ts, [0.1, -0.2, 0.3 + i], [0.0, 0.0, 9.81])))
    for k, pol in enumerate(([0, 1], [-1, 1])):
        ev = np.stack([
            1.0 + k * 0.2 + np.sort(rng.uniform(0, 0.2, 50)),
            rng.integers(0, 16, 50), rng.integers(0, 12, 50), rng.choice(pol, 50),
        ], axis=1)
        msgs.append(("/dvs/events", "dvs_msgs/EventArray", 1.0 + k * 0.2,
                     pkg.encode_event_array(ev, 12, 16)))
    msgs.sort(key=lambda m: m[2])
    return msgs


def test_writer_bytes_equal_jax(tmp_path):
    mj, mt = _messages(jbag), _messages(tbag)
    assert [m[3] for m in mt] == [m[3] for m in mj]
    jbag.write_bag(str(tmp_path / "j.bag"), mj)
    tbag.write_bag(str(tmp_path / "t.bag"), mt)
    assert (tmp_path / "t.bag").read_bytes() == (tmp_path / "j.bag").read_bytes()


def test_bags_cross_packages(tmp_path):
    """A JAX-written bag through the port's reader and the reverse: the same
    records, and the same decoded messages."""
    jbag.write_bag(str(tmp_path / "j.bag"), _messages(jbag))
    tbag.write_bag(str(tmp_path / "t.bag"), _messages(tbag))
    for path in (tmp_path / "j.bag", tmp_path / "t.bag"):
        got, want = list(tbag.read_bag(str(path))), list(jbag.read_bag(str(path)))
        assert got == want and len(got) == 4 + 20 + 2
        assert list(tbag.read_bag(str(path), {"/dvs/imu"})) == [m for m in want
                                                                if m[0] == "/dvs/imu"]
        for topic, _, _, raw in got:
            if topic == "/dvs/imu":
                a, b = tbag.decode_imu(raw), jbag.decode_imu(raw)
            elif topic == "/dvs/image_raw":
                a, b = tbag.decode_image(raw), jbag.decode_image(raw)
            else:
                a, b = (tbag.decode_event_array(raw),), (jbag.decode_event_array(raw),)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_load_sequence_rosbag_matches_jax(tmp_path):
    tbag.write_bag(str(tmp_path / "seq.bag"), _messages(tbag))
    kw = dict(image_topic="/dvs/image_raw", ts_factor=1.0)
    got = tds.load_sequence("rosbag", str(tmp_path), "seq",
                            cache_dir=str(tmp_path / "t_imgs"), **kw)
    want = jds.load_sequence("bag", str(tmp_path), "seq.bag",
                             cache_dir=str(tmp_path / "j_imgs"), **kw)
    assert got.n_frames == want.n_frames == 4
    np.testing.assert_array_equal(got.image_ts, want.image_ts)
    for i in range(got.n_frames):
        np.testing.assert_array_equal(got.image(i), want.image(i))
    for f in ("ts", "gyro", "acc"):
        a, b = getattr(got.imu, f), getattr(want.imu, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got.events) == len(want.events) == 100
    np.testing.assert_array_equal(got.events.events, want.events.events)
    # times survive the (sec, nsec) round trip to 2 ns
    assert np.all(np.diff(got.events.events[:, 0]) >= 0)
