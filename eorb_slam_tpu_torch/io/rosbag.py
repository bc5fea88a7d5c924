"""Minimal pure-Python ROS1 bag (v2.0) reader and writer: the RosBagStore
equivalent.

Port of ``eorb_slam_tpu/io/rosbag.py`` (host code, no tensors). The
reference wraps rosbag::Bag to pull images, IMU and events from DAVIS
recordings (reference include/ROS/RosBagStore.h). This reads the documented
bag v2.0 container (http://wiki.ros.org/Bags/Format/2.0) without ROS:
length-prefixed records with name=value headers, connection records
declaring topics, chunk records (uncompressed or bz2) embedding
message-data records.

Decoders cover the three message types the event pipeline needs:
- sensor_msgs/Imu          -> (ts, gyro xyz, acc xyz)
- sensor_msgs/Image (mono8)-> (ts, HxW uint8)
- dvs_msgs/EventArray      -> (N,4) [ts x y polarity]

``load_rosbag`` assembles them into the same ``datasets.Sequence`` the
other loaders produce, so ``apps/run_slam`` reads bags without ROS. The
writer (``write_bag`` and the ``encode_*`` functions) writes the same
bytes as the JAX package's for the same messages.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Iterator, Optional

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07


def _parse_header(buf: bytes) -> dict:
    out = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        field = buf[i : i + n]
        i += n
        k, _, v = field.partition(b"=")
        out[k.decode()] = v
    return out


def _records(buf: bytes, offset: int = 0) -> Iterator[tuple[dict, bytes]]:
    i = offset
    n = len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        hdr = _parse_header(buf[i : i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i : i + dlen]
        i += dlen
        yield hdr, data


def _ros_time(b: bytes, off: int = 0) -> float:
    sec, nsec = struct.unpack_from("<II", b, off)
    return sec + nsec * 1e-9


class _Cursor:
    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def u8(self):
        v = self.d[self.i]
        self.i += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.d, self.i)
        self.i += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.d, self.i)
        self.i += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.d, self.i)
        self.i += 8 * n
        return v

    def time(self):
        sec, nsec = struct.unpack_from("<II", self.d, self.i)
        self.i += 8
        return sec + nsec * 1e-9

    def string(self):
        n = self.u32()
        s = self.d[self.i : self.i + n]
        self.i += n
        return s

    def skip(self, n):
        self.i += n


def _skip_std_header(c: _Cursor) -> None:
    c.u32()          # seq
    c.time()         # stamp
    c.string()       # frame_id


def decode_imu(data: bytes):
    c = _Cursor(data)
    c.u32()
    ts = c.time()
    c.string()
    c.f64(4)         # orientation quat
    c.f64(9)
    gyro = np.asarray(c.f64(3))
    c.f64(9)
    acc = np.asarray(c.f64(3))
    return ts, gyro, acc


def decode_image(data: bytes):
    c = _Cursor(data)
    c.u32()
    ts = c.time()
    c.string()
    h = c.u32()
    w = c.u32()
    enc = c.string().decode()
    c.u8()           # is_bigendian
    step = c.u32()
    n = c.u32()
    img = np.frombuffer(c.d, np.uint8, n, c.i)
    if enc not in ("mono8", "8UC1"):
        raise ValueError(f"unsupported encoding {enc!r}")
    return ts, img.reshape(h, step)[:, :w].copy()


def decode_event_array(data: bytes) -> np.ndarray:
    c = _Cursor(data)
    _skip_std_header(c)
    c.u32()          # height
    c.u32()          # width
    n = c.u32()
    ev = np.zeros((n, 4), np.float64)
    # dvs_msgs/Event: x uint16, y uint16, ts time, polarity bool
    raw = np.frombuffer(c.d, np.uint8, n * 13, c.i).reshape(n, 13)
    xy = raw[:, :4].copy().view("<u2").reshape(n, 2)
    secs = raw[:, 4:12].copy().view("<u4").reshape(n, 2)
    ev[:, 0] = secs[:, 0] + secs[:, 1] * 1e-9
    ev[:, 1] = xy[:, 0]
    ev[:, 2] = xy[:, 1]
    ev[:, 3] = raw[:, 12]
    return ev


def read_bag(path: str, topics: Optional[set] = None):
    """Yield (topic, msg_type, ts, raw_bytes) for every message, in file
    order. Handles uncompressed and bz2 chunks."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_MAGIC):
        raise ValueError("not a ROS bag v2.0 file")
    conns: dict[int, tuple[str, str]] = {}

    def handle(hdr, data):
        op = hdr["op"][0]
        if op == OP_CONN:
            (cid,) = struct.unpack("<I", hdr["conn"])
            sub = _parse_header(data)
            conns[cid] = (
                hdr["topic"].decode(),
                sub.get("type", b"?").decode(),
            )
        elif op == OP_MSG:
            (cid,) = struct.unpack("<I", hdr["conn"])
            topic, mtype = conns.get(cid, ("?", "?"))
            if topics is None or topic in topics:
                return topic, mtype, _ros_time(hdr["time"]), data
        return None

    for hdr, data in _records(buf, len(_MAGIC)):
        op = hdr["op"][0]
        if op == OP_CHUNK:
            comp = hdr.get("compression", b"none")
            payload = bz2.decompress(data) if comp == b"bz2" else data
            for h2, d2 in _records(payload):
                out = handle(h2, d2)
                if out:
                    yield out
        else:
            out = handle(hdr, data)
            if out:
                yield out


def load_rosbag(path: str, image_topic: str = "/dvs/image_raw",
                imu_topic: str = "/dvs/imu",
                event_topic: str = "/dvs/events",
                cache_dir: Optional[str] = None):
    """Assemble a bag into a `datasets.Sequence`: images are extracted to
    PNG files (the Sequence API serves images by path), IMU/events become
    contiguous arrays."""
    from PIL import Image

    from eorb_slam_tpu_torch.io import datasets

    cache = cache_dir or (os.path.splitext(path)[0] + "_images")
    os.makedirs(cache, exist_ok=True)

    img_ts, img_paths = [], []
    imu_rows = []
    ev_chunks = []
    for topic, mtype, rts, raw in read_bag(
        path, {image_topic, imu_topic, event_topic}
    ):
        if topic == imu_topic:
            ts, g, a = decode_imu(raw)
            imu_rows.append([ts, *g, *a])
        elif topic == image_topic:
            ts, img = decode_image(raw)
            p = os.path.join(cache, f"{int(round(ts * 1e9))}.png")
            if not os.path.exists(p):
                Image.fromarray(img, "L").save(p)
            img_ts.append(ts)
            img_paths.append(p)
        elif topic == event_topic:
            ev_chunks.append(decode_event_array(raw))

    imu = None
    if imu_rows:
        arr = np.asarray(imu_rows)
        imu = datasets.ImuData(ts=arr[:, 0], gyro=arr[:, 1:4].astype(np.float32),
                               acc=arr[:, 4:7].astype(np.float32))
    events = None
    if ev_chunks:
        ev = np.concatenate(ev_chunks)
        events = datasets.EventStream(ev[np.argsort(ev[:, 0], kind="stable")])
    return datasets.Sequence(
        name=os.path.basename(path), image_ts=np.asarray(img_ts),
        image_paths=img_paths, imu=imu, events=events,
    )


# ----------------------------------------------------------------- writer
# (round-trips the reader without ROS installed)


def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _time_bytes(ts: float) -> bytes:
    sec = int(ts)
    return struct.pack("<II", sec, int(round((ts - sec) * 1e9)))


def encode_imu(ts: float, gyro, acc) -> bytes:
    out = struct.pack("<I", 0) + _time_bytes(ts) + struct.pack("<I", 0)
    out += struct.pack("<4d", 0, 0, 0, 1) + struct.pack("<9d", *([0] * 9))
    out += struct.pack("<3d", *gyro) + struct.pack("<9d", *([0] * 9))
    out += struct.pack("<3d", *acc) + struct.pack("<9d", *([0] * 9))
    return out


def encode_image(ts: float, img: np.ndarray) -> bytes:
    h, w = img.shape
    out = struct.pack("<I", 0) + _time_bytes(ts) + struct.pack("<I", 0)
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", 5) + b"mono8"
    out += struct.pack("<BI", 0, w)
    data = img.astype(np.uint8).tobytes()
    return out + struct.pack("<I", len(data)) + data


def encode_event_array(ev: np.ndarray, h: int, w: int) -> bytes:
    out = struct.pack("<I", 0) + _time_bytes(float(ev[0, 0]) if len(ev) else 0.0)
    out += struct.pack("<I", 0)
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", len(ev))
    # one packed record per event: x, y uint16, ts (sec, nsec) uint32,
    # polarity uint8; the fields _time_bytes gives, for all rows at once
    ev = np.asarray(ev, np.float64).reshape(-1, 4)
    sec = np.trunc(ev[:, 0])
    rows = np.zeros(len(ev), np.dtype([("x", "<u2"), ("y", "<u2"), ("sec", "<u4"),
                                       ("nsec", "<u4"), ("p", "u1")]))
    rows["x"], rows["y"] = ev[:, 1].astype(np.int64), ev[:, 2].astype(np.int64)
    rows["sec"], rows["nsec"] = sec, np.round((ev[:, 0] - sec) * 1e9)
    rows["p"] = ev[:, 3] > 0
    return out + rows.tobytes()


def write_bag(path: str, messages) -> None:
    """messages: iterable of (topic, msg_type, ts, raw_bytes)."""
    conn_ids: dict[str, int] = {}
    chunk = b""
    for topic, mtype, ts, raw in messages:
        if topic not in conn_ids:
            cid = len(conn_ids)
            conn_ids[topic] = cid
            sub = _header({"topic": topic.encode(), "type": mtype.encode(),
                           "md5sum": b"0" * 32,
                           "message_definition": b""})
            chunk += _record(
                {"op": bytes([OP_CONN]),
                 "conn": struct.pack("<I", cid),
                 "topic": topic.encode()}, sub)
        chunk += _record(
            {"op": bytes([OP_MSG]),
             "conn": struct.pack("<I", conn_ids[topic]),
             "time": _time_bytes(ts)}, raw)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_record(
            {"op": bytes([OP_BAGHDR]), "index_pos": struct.pack("<Q", 0),
             "conn_count": struct.pack("<I", len(conn_ids)),
             "chunk_count": struct.pack("<I", 1)},
            b"\x20" * 4096))
        f.write(_record(
            {"op": bytes([OP_CHUNK]), "compression": b"none",
             "size": struct.pack("<I", len(chunk))}, chunk))
