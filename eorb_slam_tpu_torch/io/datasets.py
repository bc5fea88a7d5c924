"""Dataset loaders: EuRoC, EV-ETHZ (public event-camera dataset), MVSEC.

Re-expresses the reference's L8 loaders (reference src/Utils/DataStore.cpp:473-737
`EurocLoader`, src/Event/EventLoader.cpp:80,378 `EventDataStore`/`EvEthzLoader`)
array-first: instead of per-line C++ parsing into std::vectors of structs, data
is parsed once (by the native C++ fast parser in `eorb_slam_tpu_torch.io.native`
when available, else NumPy) into contiguous arrays, and served as
**fixed-shape, mask-padded chunks** ready for fixed-shape device code:

- images by index/timestamp,
- IMU measurement chunks between two timestamps (gyro-first ordering of the
  reference is normalized to (gyro, acc) columns here),
- event chunks by count or by time span (`EventDataStore::getEventChunk*`),
  optionally rectified at load like the reference's MyCalibrator hook
  (reference include/Event/EventLoader.h:15-50).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from eorb_slam_tpu_torch.io import native


def _load_image(path: str) -> np.ndarray:
    """Load a grayscale image as float32 [0,1] without OpenCV."""
    from PIL import Image  # imported at use: most runs read no image

    im = Image.open(path).convert("L")
    return np.asarray(im, np.float32) / 255.0


def load_events_txt(path: str, max_events: Optional[int] = None) -> np.ndarray:
    """Parse `events.txt` lines `ts x y p` -> float64 (N,4).

    Reference: EventDataStore::parseLine (src/Event/EventLoader.cpp:80).
    Uses the native C++ parser when built (≈10× faster than np.loadtxt).
    float64 because the ts column must not quantize (EventData::ts is
    double in the reference); EventWindowBuilder rebases to window-relative
    float32 on dispatch."""
    ev = native.parse_events(path, max_events)
    if ev is not None:
        return ev
    ev = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if max_events is not None:
        ev = ev[:max_events]
    return np.ascontiguousarray(ev[:, :4])


def load_csv(path: str, skip_header: bool = True) -> np.ndarray:
    arr = native.parse_csv(path)
    if arr is None:
        arr = np.genfromtxt(path, delimiter=",", skip_header=1 if skip_header else 0)
        arr = np.atleast_2d(arr)
    return arr


@dataclasses.dataclass
class ImuData:
    """Contiguous IMU stream: ts (seconds), gyro (N,3), acc (N,3)."""

    ts: np.ndarray
    gyro: np.ndarray
    acc: np.ndarray

    def chunk(self, t0: float, t1: float, max_n: int = 256):
        """Measurements in (t0, t1] as fixed-shape padded arrays + valid mask.

        Mirrors ImuDataStore::getNextChunk's (t0,t1] window (reference
        src/Utils/DataStore.cpp) but returns mask-padded tensors.
        """
        i0 = int(np.searchsorted(self.ts, t0, side="right"))
        i1 = int(np.searchsorted(self.ts, t1, side="right"))
        n = min(i1 - i0, max_n)
        ts = np.zeros(max_n, np.float64)
        gyr = np.zeros((max_n, 3), np.float32)
        acc = np.zeros((max_n, 3), np.float32)
        valid = np.zeros(max_n, bool)
        ts[:n] = self.ts[i0 : i0 + n]
        gyr[:n] = self.gyro[i0 : i0 + n]
        acc[:n] = self.acc[i0 : i0 + n]
        valid[:n] = True
        return ts, gyr, acc, valid


class EventStream:
    """Event stream with count/time-bounded chunk service + overlap reinsertion.

    Reference: EventDataStore chunking + EvTrackManager's consumeBegin /
    injectEventsBegin overlap protocol (src/Event/EvTrackManager.cpp:258,355).
    """

    def __init__(self, events: np.ndarray, rectify_map: Optional[np.ndarray] = None):
        if rectify_map is not None:
            xi = np.clip(events[:, 1].astype(np.int64), 0, rectify_map.shape[1] - 1)
            yi = np.clip(events[:, 2].astype(np.int64), 0, rectify_map.shape[0] - 1)
            events = events.copy()
            events[:, 1:3] = rectify_map[yi, xi]
        self.events = events
        self.cursor = 0

    def __len__(self):
        return self.events.shape[0]

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self)

    def next_chunk_count(self, n: int) -> np.ndarray:
        c = self.events[self.cursor : self.cursor + n]
        self.cursor += len(c)
        return c

    def next_chunk_until(self, t1: float) -> np.ndarray:
        end = int(np.searchsorted(self.events[:, 0], t1, side="right"))
        c = self.events[self.cursor : max(end, self.cursor)]
        self.cursor = max(end, self.cursor)
        return c

    def rewind(self, n: int) -> None:
        """Overlap re-injection: step the cursor back n events."""
        self.cursor = max(0, self.cursor - n)


@dataclasses.dataclass
class Sequence:
    """One loaded sequence: image index, IMU, events, ground truth."""

    name: str
    image_ts: np.ndarray                  # (F,) seconds
    image_paths: list
    imu: Optional[ImuData] = None
    events: Optional[EventStream] = None
    gt_ts: Optional[np.ndarray] = None    # (G,)
    gt_pose: Optional[np.ndarray] = None  # (G,7) tx ty tz qx qy qz qw
    right_paths: Optional[list] = None    # stereo right images (cam1)
    depth_paths: Optional[list] = None    # RGB-D depth images
    depth_factor: float = 5000.0          # TUM depth png scale (mm*5)
    image_arrays: Optional[np.ndarray] = None  # (F,H,W) in-memory frames
    #                                       (HDF5-served datasets, e.g. MVSEC)

    def image(self, i: int) -> np.ndarray:
        if self.image_arrays is not None:
            return np.asarray(self.image_arrays[i], np.float32) / 255.0
        return _load_image(self.image_paths[i])

    def image_right(self, i: int) -> np.ndarray:
        return _load_image(self.right_paths[i])

    def depth(self, i: int) -> np.ndarray:
        """Metric depth map (meters); 0 = no reading (TUM convention)."""
        from PIL import Image

        arr = np.asarray(Image.open(self.depth_paths[i]), np.float32)
        return arr / self.depth_factor

    @property
    def n_frames(self) -> int:
        return len(self.image_ts)


def load_euroc(root: str, sequence: str, ts_factor: float = 1.0e9) -> Sequence:
    """EuRoC MAV format: mav0/{cam0,imu0,state_groundtruth_estimate0}/data.csv.

    Reference: EurocLoader (src/Utils/DataStore.cpp:473-737). Timestamps are
    divided by `ts_factor` (ns -> s).
    """
    seq_root = os.path.join(root, sequence, "mav0")
    cam_csv = os.path.join(seq_root, "cam0", "data.csv")
    img_dir = os.path.join(seq_root, "cam0", "data")

    ts_list, paths = [], []
    with open(cam_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            ts_list.append(float(parts[0]) / ts_factor)
            paths.append(os.path.join(img_dir, parts[1].strip()))
    image_ts = np.asarray(ts_list, np.float64)

    # stereo right camera (cam1) when present — same filenames by EuRoC
    # convention (hardware-synchronized shutters)
    right_paths = None
    cam1_dir = os.path.join(seq_root, "cam1", "data")
    if os.path.isdir(cam1_dir):
        rp = [os.path.join(cam1_dir, os.path.basename(p)) for p in paths]
        if all(os.path.exists(p) for p in rp[:3]):
            right_paths = rp

    # depth camera (synthetic RGB-D sequences in EuRoC layout: depth0/data
    # holds 16-bit TUM-convention depth PNGs with matching filenames)
    depth_paths = None
    depth_dir = os.path.join(seq_root, "depth0", "data")
    if os.path.isdir(depth_dir):
        dp = [os.path.join(depth_dir, os.path.basename(p)) for p in paths]
        if all(os.path.exists(p) for p in dp[:3]):
            depth_paths = dp

    imu = None
    imu_csv = os.path.join(seq_root, "imu0", "data.csv")
    if os.path.exists(imu_csv):
        arr = load_csv(imu_csv)
        # EuRoC columns: ts, wx wy wz, ax ay az (gyro-first, like the reference).
        imu = ImuData(
            ts=arr[:, 0] / ts_factor,
            gyro=arr[:, 1:4].astype(np.float32),
            acc=arr[:, 4:7].astype(np.float32),
        )

    gt_ts = gt_pose = None
    gt_csv = os.path.join(seq_root, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        arr = load_csv(gt_csv)
        gt_ts = arr[:, 0] / ts_factor
        # EuRoC GT: ts, p(3), q(wxyz), ... -> normalize to (t, q_xyzw).
        q_wxyz = arr[:, 4:8]
        gt_pose = np.concatenate(
            [arr[:, 1:4], q_wxyz[:, 1:4], q_wxyz[:, :1]], axis=1
        ).astype(np.float64)

    return Sequence(
        name=sequence, image_ts=image_ts, image_paths=paths, imu=imu,
        gt_ts=gt_ts, gt_pose=gt_pose, right_paths=right_paths,
        depth_paths=depth_paths,
    )


def load_tum_rgbd(root: str, sequence: str, max_dt: float = 0.02,
                  **_kw) -> Sequence:
    """TUM RGB-D format: per-sequence dir with `rgb.txt` / `depth.txt`
    (`ts path` lines) + `groundtruth.txt` (ts tx ty tz qx qy qz qw).
    RGB and depth are associated by nearest timestamp (the dataset's own
    associate.py protocol). Reference's TumRgbdLoader is a 2-line stub —
    this is a working implementation."""
    seq_root = os.path.join(root, sequence)

    def read_index(name):
        ts, paths = [], []
        p = os.path.join(seq_root, name)
        if not os.path.exists(p):
            return np.zeros(0), []
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split()[:2]
                ts.append(float(a))
                paths.append(os.path.join(seq_root, b))
        return np.asarray(ts, np.float64), paths

    rgb_ts, rgb_paths = read_index("rgb.txt")
    dep_ts, dep_paths = read_index("depth.txt")

    # associate depth to rgb by nearest ts within max_dt
    image_ts, image_paths, depth_paths = [], [], []
    for t, p in zip(rgb_ts, rgb_paths):
        if len(dep_ts) == 0:
            break
        j = int(np.clip(np.searchsorted(dep_ts, t), 1, len(dep_ts) - 1))
        j = j - 1 if abs(dep_ts[j - 1] - t) < abs(dep_ts[j] - t) else j
        if abs(dep_ts[j] - t) <= max_dt:
            image_ts.append(t)
            image_paths.append(p)
            depth_paths.append(dep_paths[j])

    gt_ts = gt_pose = None
    gt_txt = os.path.join(seq_root, "groundtruth.txt")
    if os.path.exists(gt_txt):
        arr = np.loadtxt(gt_txt, dtype=np.float64, ndmin=2, comments="#")
        gt_ts, gt_pose = arr[:, 0], arr[:, 1:8]

    return Sequence(
        name=sequence, image_ts=np.asarray(image_ts, np.float64),
        image_paths=image_paths, depth_paths=depth_paths,
        gt_ts=gt_ts, gt_pose=gt_pose, depth_factor=5000.0,
    )


def load_kitti(root: str, sequence: str, **_kw) -> Sequence:
    """KITTI odometry format: sequences/NN/{image_0,image_1}/*.png +
    times.txt; GT poses from poses/NN.txt (3x4 row-major Twc, cam0 frame).
    Reference's KittiLoader is a stub — this is a working implementation."""
    seq_root = os.path.join(root, "sequences", sequence)
    times = np.loadtxt(os.path.join(seq_root, "times.txt"),
                       dtype=np.float64, ndmin=1)
    img0 = sorted(
        os.path.join(seq_root, "image_0", f)
        for f in os.listdir(os.path.join(seq_root, "image_0"))
        if f.endswith(".png")
    )
    img1_dir = os.path.join(seq_root, "image_1")
    right = None
    if os.path.isdir(img1_dir):
        right = [os.path.join(img1_dir, os.path.basename(p)) for p in img0]

    gt_ts = gt_pose = None
    pose_txt = os.path.join(root, "poses", f"{sequence}.txt")
    if os.path.exists(pose_txt):
        arr = np.loadtxt(pose_txt, dtype=np.float64, ndmin=2)
        n = min(len(arr), len(times))
        import torch

        from eorb_slam_tpu_torch.geometry import lie

        R = torch.from_numpy(
            np.array(arr[:n].reshape(n, 3, 4)[:, :, :3], np.float32))
        q = lie.quat_from_mat(R).numpy()
        quats = np.concatenate([q[:, 1:4], q[:, :1]], axis=1)   # -> xyzw
        gt_ts = times[:n]
        gt_pose = np.concatenate(
            [arr[:n].reshape(n, 3, 4)[:, :, 3], np.asarray(quats)], axis=1
        )

    return Sequence(
        name=sequence, image_ts=times[: len(img0)], image_paths=img0,
        right_paths=right, gt_ts=gt_ts, gt_pose=gt_pose,
    )


def load_ev_ethz(
    root: str,
    sequence: str,
    rectify_map: Optional[np.ndarray] = None,
    max_events: Optional[int] = None,
    **_kw,  # ts_factor etc. — EV-ETHZ timestamps are already seconds
) -> Sequence:
    """EV-ETHZ (Event Camera Dataset) format: per-sequence directory with
    `events.txt` (ts x y p, seconds), `images.txt` (ts path), `imu.txt`
    (ts ax ay az gx gy gz), `groundtruth.txt` (ts tx ty tz qx qy qz qw).

    Reference: EvEthzLoader (src/Event/EventLoader.cpp:378). NOTE the
    EV-ETHZ imu.txt is accel-first; the reference normalizes ordering in its
    parser — we normalize to (gyro, acc) here.
    """
    seq_root = os.path.join(root, sequence)

    image_ts, paths = [], []
    img_index = os.path.join(seq_root, "images.txt")
    if os.path.exists(img_index):
        with open(img_index) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    image_ts.append(float(parts[0]))
                    paths.append(os.path.join(seq_root, parts[1]))
    image_ts = np.asarray(image_ts, np.float64)

    imu = None
    imu_txt = os.path.join(seq_root, "imu.txt")
    if os.path.exists(imu_txt):
        arr = np.loadtxt(imu_txt, dtype=np.float64, ndmin=2)
        imu = ImuData(
            ts=arr[:, 0],
            gyro=arr[:, 4:7].astype(np.float32),
            acc=arr[:, 1:4].astype(np.float32),
        )

    events = None
    ev_txt = os.path.join(seq_root, "events.txt")
    if os.path.exists(ev_txt):
        events = EventStream(load_events_txt(ev_txt, max_events), rectify_map)

    gt_ts = gt_pose = None
    gt_txt = os.path.join(seq_root, "groundtruth.txt")
    if os.path.exists(gt_txt):
        arr = np.loadtxt(gt_txt, dtype=np.float64, ndmin=2)
        gt_ts, gt_pose = arr[:, 0], arr[:, 1:8]

    return Sequence(
        name=sequence, image_ts=image_ts, image_paths=paths, imu=imu,
        events=events, gt_ts=gt_ts, gt_pose=gt_pose,
    )


def load_mvsec(root: str, sequence: str, max_events: Optional[int] = None,
               side: str = "left", **kw) -> Sequence:
    """MVSEC: EV-ETHZ-style txt exports (served through `load_ev_ethz`) or
    the native HDF5 pair `<sequence>_data.hdf5` / `<sequence>_gt.hdf5`
    (reference pathway: include/Event/EventLoader.h:52-91; the reference
    itself only parses the txt export — the HDF5 path here EXCEEDS it).

    HDF5 layout (MVSEC release format): `davis/<side>/events` (N,4) with
    columns (x, y, t, p); `image_raw` (F,H,W) uint8 + `image_raw_ts` (F,);
    `imu` (N,6) = (ax, ay, az, wx, wy, wz) + `imu_ts`; GT file:
    `davis/<side>/pose` (G,4,4) Twc + `pose_ts`. The time column of the
    event table is DETECTED (the monotone non-decreasing one), so exports
    with (t, x, y, p) ordering load identically."""
    seq_root = os.path.join(root, sequence)
    if os.path.exists(os.path.join(seq_root, "events.txt")):
        return load_ev_ethz(root, sequence, **kw)
    import h5py

    cands = [
        os.path.join(root, sequence + "_data.hdf5"),
        os.path.join(seq_root, sequence + "_data.hdf5"),
        os.path.join(seq_root, "data.hdf5"),
    ]
    data_path = next((p for p in cands if os.path.exists(p)), None)
    if data_path is None:
        raise FileNotFoundError(
            f"MVSEC: no events.txt export and no *_data.hdf5 under "
            f"{root}/{sequence}"
        )

    with h5py.File(data_path, "r") as f:
        g = f["davis"][side]
        ev_raw = np.asarray(
            g["events"][:max_events] if max_events else g["events"],
            np.float64,
        )
        # detect the time column: the only strictly non-decreasing one with
        # large magnitude (epoch seconds); x/y/p all oscillate
        tcol = None
        for c in range(ev_raw.shape[1]):
            d = np.diff(ev_raw[: min(len(ev_raw), 4096), c])
            if len(d) and (d >= 0).all() and ev_raw[0, c] != ev_raw[-1, c]:
                tcol = c
                break
        if tcol is None:
            raise ValueError("MVSEC events: no monotone time column found")
        others = [c for c in range(ev_raw.shape[1]) if c != tcol]
        # polarity column: values in {-1,0,1}; of the rest, x spans wider
        # than y (346x260 sensor) — fall back to (x, y, p) order
        pol = next(
            (c for c in others
             if np.isin(np.unique(ev_raw[:1024, c]), [-1, 0, 1]).all()),
            others[-1],
        )
        xy = [c for c in others if c != pol]
        events = np.stack([
            ev_raw[:, tcol], ev_raw[:, xy[0]], ev_raw[:, xy[1]],
            np.where(ev_raw[:, pol] > 0, 1.0, -1.0),
        ], axis=1)

        image_arrays = image_ts = None
        if "image_raw" in g:
            image_arrays = np.asarray(g["image_raw"])
            image_ts = np.asarray(g["image_raw_ts"], np.float64)

        imu = None
        if "imu" in g:
            arr = np.asarray(g["imu"], np.float64)
            imu = ImuData(
                ts=np.asarray(g["imu_ts"], np.float64),
                gyro=arr[:, 3:6].astype(np.float32),
                acc=arr[:, 0:3].astype(np.float32),
            )

    gt_ts = gt_pose = None
    gt_path = data_path.replace("_data.hdf5", "_gt.hdf5")
    if gt_path != data_path and os.path.exists(gt_path):
        with h5py.File(gt_path, "r") as f:
            gg = f["davis"][side]
            if "pose" in gg:
                Ts = np.asarray(gg["pose"], np.float64)     # (G,4,4) Twc
                gt_ts = np.asarray(gg["pose_ts"], np.float64)
                from eorb_slam_tpu_torch.io.synth_dataset import quat_wxyz_np

                quats = np.stack([quat_wxyz_np(T[:3, :3]) for T in Ts])
                gt_pose = np.concatenate([
                    Ts[:, :3, 3],                      # tx ty tz
                    quats[:, 1:4], quats[:, 0:1],      # qx qy qz qw
                ], axis=1)

    if image_ts is None:
        # event-only HDF5: synthesize a nominal frame clock so event-mode
        # apps (which pace on image_ts) can still drive the stream
        t0, t1 = float(events[0, 0]), float(events[-1, 0])
        image_ts = np.arange(t0, t1, 1.0 / 30.0)

    return Sequence(
        name=sequence, image_ts=image_ts, image_paths=[],
        image_arrays=image_arrays,
        imu=imu, events=EventStream(events),
        gt_ts=gt_ts, gt_pose=gt_pose,
    )


def load_rosbag(root: str, sequence: str, **kw) -> Sequence:
    """ROS1 bag (v2.0) without ROS: pure-Python reader (io/rosbag.py;
    reference RosBagStore, include/ROS/RosBagStore.h)."""
    from eorb_slam_tpu_torch.io import rosbag

    path = os.path.join(root, sequence)
    if not path.endswith(".bag"):
        path += ".bag"
    return rosbag.load_rosbag(path, **{
        k: v for k, v in kw.items()
        if k in ("image_topic", "imu_topic", "event_topic", "cache_dir")
    })


def load_sequence(fmt: str, root: str, sequence: str, **kw) -> Sequence:
    fmt = fmt.lower()
    if fmt == "euroc":
        return load_euroc(root, sequence, **kw)
    if fmt in ("rosbag", "bag"):
        return load_rosbag(root, sequence, **kw)
    if fmt in ("ev_ethz", "ethz", "event"):
        return load_ev_ethz(root, sequence, **kw)
    if fmt == "mvsec":
        return load_mvsec(root, sequence, **kw)
    if fmt == "tum_rgbd":
        return load_tum_rgbd(root, sequence, **kw)
    if fmt == "kitti":
        return load_kitti(root, sequence, **kw)
    raise ValueError(f"unknown dataset format {fmt!r}")
