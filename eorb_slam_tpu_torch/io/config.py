"""Config system: sensor configuration + typed settings parsed from one YAML.

Mirrors the reference's single-settings-file design (reference
Examples/Event/EvETHZ.yaml:9-211, parsed by src/Utils/MyParameters.cpp and
include/Event/EventData.h:75-126) and its first-class `MySensorConfig`
(reference include/Utils/MyDataTypes.h:201-246) whose `isEvent/isImage/
isInertial/isMonocular` predicates key every pipeline branch.

The same YAML keys are kept where they exist (`Camera.fx`,
`Event.data.l1ChunkSize`, ...) so reference settings files can be reused,
parsed with PyYAML into plain dataclasses instead of OpenCV FileStorage.
PyYAML is imported inside `load_settings`, so importing this module needs
numpy only. Fields and defaults equal `eorb_slam_tpu/io/config.py`'s.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class SensorConfig(enum.Enum):
    """Sensor configurations (reference include/Utils/MyDataTypes.h:203-214)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    EVENT_ONLY = 5
    EVENT_MONO = 6
    EVENT_IMU = 7
    EVENT_IMU_MONO = 8
    IDLE = 9

    # ---- predicates (reference MySensorConfig::is*) ----
    def is_event(self) -> bool:
        return self in (
            SensorConfig.EVENT_ONLY,
            SensorConfig.EVENT_MONO,
            SensorConfig.EVENT_IMU,
            SensorConfig.EVENT_IMU_MONO,
        )

    def is_image(self) -> bool:
        return self in (
            SensorConfig.MONOCULAR,
            SensorConfig.STEREO,
            SensorConfig.RGBD,
            SensorConfig.IMU_MONOCULAR,
            SensorConfig.IMU_STEREO,
            SensorConfig.EVENT_MONO,
            SensorConfig.EVENT_IMU_MONO,
        )

    def is_inertial(self) -> bool:
        return self in (
            SensorConfig.IMU_MONOCULAR,
            SensorConfig.IMU_STEREO,
            SensorConfig.EVENT_IMU,
            SensorConfig.EVENT_IMU_MONO,
        )

    def is_monocular(self) -> bool:
        return self in (
            SensorConfig.MONOCULAR,
            SensorConfig.IMU_MONOCULAR,
            SensorConfig.EVENT_ONLY,
            SensorConfig.EVENT_MONO,
            SensorConfig.EVENT_IMU,
            SensorConfig.EVENT_IMU_MONO,
        )

    def is_stereo(self) -> bool:
        return self in (SensorConfig.STEREO, SensorConfig.IMU_STEREO)

    def is_rgbd(self) -> bool:
        return self is SensorConfig.RGBD


_SENSOR_STRINGS = {
    "mono_im": SensorConfig.MONOCULAR,
    "monocular": SensorConfig.MONOCULAR,
    "stereo": SensorConfig.STEREO,
    "rgbd": SensorConfig.RGBD,
    "mono_im_imu": SensorConfig.IMU_MONOCULAR,
    "imu_monocular": SensorConfig.IMU_MONOCULAR,
    "stereo_imu": SensorConfig.IMU_STEREO,
    "imu_stereo": SensorConfig.IMU_STEREO,
    "event_only": SensorConfig.EVENT_ONLY,
    "mono_ev": SensorConfig.EVENT_ONLY,
    "event_mono": SensorConfig.EVENT_MONO,
    "mono_ev_im": SensorConfig.EVENT_MONO,
    "event_imu": SensorConfig.EVENT_IMU,
    "mono_ev_imu": SensorConfig.EVENT_IMU,
    "event_imu_mono": SensorConfig.EVENT_IMU_MONO,
    "mono_ev_im_imu": SensorConfig.EVENT_IMU_MONO,
    "idle": SensorConfig.IDLE,
}


def sensor_from_string(s: str) -> SensorConfig:
    """Parse the `DS.Sensor.config` string (reference MySensorConfig::mapConfig)."""
    key = s.strip().lower()
    if key not in _SENSOR_STRINGS:
        raise ValueError(f"unknown sensor config string: {s!r}")
    return _SENSOR_STRINGS[key]


@dataclasses.dataclass
class CameraConfig:
    """Intrinsics/distortion (reference include/Utils/MyParameters.h:25-78)."""

    model: str = "pinhole"  # "pinhole" | "kb8"
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2 k3 (or k1..k4 for kb8)
    width: int = 0
    height: int = 0
    fps: float = 30.0
    bf: float = 0.0            # stereo baseline*fx
    th_depth: float = 35.0     # close/far stereo threshold

    def params_array(self) -> np.ndarray:
        d = list(self.dist) + [0.0] * 5
        if self.model == "kb8":
            return np.asarray(
                [self.fx, self.fy, self.cx, self.cy, d[0], d[1], d[2], d[3], 0.0],
                np.float32,
            )
        return np.asarray(
            [self.fx, self.fy, self.cx, self.cy, d[0], d[1], d[2], d[3], d[4]],
            np.float32,
        )


@dataclasses.dataclass
class ImuConfig:
    """IMU noise/calibration (reference YAML `IMU.*`, MyParameters::parseIMUParams)."""

    Tbc: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    freq: float = 200.0
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3


@dataclasses.dataclass
class FeatureConfig:
    """ORB/AKAZE extraction knobs (reference include/ORBextractor.h:33-47, YAML `Features.*`)."""

    mode: int = 0                  # 0=ORB, 1=AKAZE, 2=mixed (reference Features.mode)
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass
class EventConfig:
    """Event knobs (reference `EvParams`, include/Event/EventData.h:75-126)."""

    l1_chunk_size: int = 2000
    l1_num_loop: int = 4           # L2 window = l1NumLoop * l1ChunkSize
    min_ev_gen_rate: float = 1.0   # events/pixel/sec gate
    max_pixel_disp: float = 3.0    # adaptive-window target median flow (px)
    l1_fixed_win: bool = False
    l2_track_mode: int = 1         # 0=odometry 1=TLM 2=TLM_CH_REF
    continuous: bool = True        # EvAsynchTrackerU-style continuous tracking
    overlap: float = 0.5           # overlap re-injection fraction
    klt_win: int = 23
    klt_levels: int = 3
    klt_iters: int = 10
    klt_eps: float = 0.03
    detector_mode: int = 0         # 0=FAST 1=ORB-no-desc 2=mixed
    n_points: int = 300
    sigma: float = 1.0             # splat Gaussian sigma


@dataclasses.dataclass
class ViewerConfig:
    enabled: bool = False
    kf_size: float = 0.05
    point_size: float = 2.0


@dataclasses.dataclass
class DatasetConfig:
    """Dataset paths/sequences (reference YAML `DS.*`, include/Utils/DataStore.h:224-325)."""

    name: str = ""
    format: str = "euroc"          # euroc | ev_ethz | mvsec | tum_rgbd | kitti
    root: str = ""
    sequences: tuple = ()
    seq_target: int = -1           # -1: all
    ts_factor: float = 1.0e9       # timestamps stored in ns for EuRoC
    max_iter: int = 1


@dataclasses.dataclass
class SlamConfig:
    """Map capacities + keyframe policy (the reference has no caps — its
    maps grow unbounded; here capacity is a sliding window with culling,
    sized per deployment)."""

    max_keyframes: int = 32
    max_landmarks: int = 4096
    local_window: int = 5
    max_frames_between_kf: int = 10


@dataclasses.dataclass
class VocabConfig:
    """Place-recognition vocabulary (reference: ORBvoc.txt path passed to
    System; here either a DBoW2 text file imported hierarchically or an
    on-the-fly trained vocabulary for synthetic runs)."""

    path: str = ""                 # ORBvoc-style text file ("" = none)
    train_words: int = 0           # >0: train K1*K2~train_words on startup
    train_frames: int = 5          # frames sampled for on-the-fly training


@dataclasses.dataclass
class Settings:
    """Everything one run needs — the analog of the reference's single YAML."""

    sensor: SensorConfig = SensorConfig.MONOCULAR
    cam: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    cam_right: Optional[CameraConfig] = None
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    event: EventConfig = dataclasses.field(default_factory=EventConfig)
    viewer: ViewerConfig = dataclasses.field(default_factory=ViewerConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    slam: SlamConfig = dataclasses.field(default_factory=SlamConfig)
    vocab: VocabConfig = dataclasses.field(default_factory=VocabConfig)
    missing: tuple = ()            # keys that fell back to defaults (missParams analog)


def _get(d: dict, key: str, default, missing: list):
    cur = d
    for part in key.split("."):
        if not isinstance(cur, dict) or part not in cur:
            missing.append(key)
            return default
        cur = cur[part]
    return cur


def load_settings(path: str) -> Settings:
    """Parse a YAML settings file into `Settings`.

    Accepts both this framework's nested layout and the reference's flat
    `Camera.fx:`-style keys (OpenCV FileStorage files minus the `%YAML:1.0`
    directive).
    """
    import yaml

    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):
        text = text.split("\n", 1)[1]
    raw = yaml.safe_load(text) or {}

    # Flat "Camera.fx" keys -> nested dicts.
    nested: dict = {}
    for k, v in raw.items():
        cur = nested
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        if isinstance(cur, dict):
            cur[parts[-1]] = v
    miss: list = []

    sensor = sensor_from_string(
        str(_get(nested, "DS.Sensor.config", "monocular", miss))
    )

    def cam_cfg(prefix: str) -> CameraConfig:
        ctype = str(_get(nested, f"{prefix}.type", "pinhole", miss)).lower()
        model = "kb8" if "kannala" in ctype or "fisheye" in ctype else "pinhole"
        if model == "kb8":
            dist = tuple(
                float(_get(nested, f"{prefix}.{n}", 0.0, miss))
                for n in ("k1", "k2", "k3", "k4")
            )
        else:
            dist = tuple(
                float(_get(nested, f"{prefix}.{n}", 0.0, miss))
                for n in ("k1", "k2", "p1", "p2", "k3")
            )
        return CameraConfig(
            model=model,
            fx=float(_get(nested, f"{prefix}.fx", 0.0, miss)),
            fy=float(_get(nested, f"{prefix}.fy", 0.0, miss)),
            cx=float(_get(nested, f"{prefix}.cx", 0.0, miss)),
            cy=float(_get(nested, f"{prefix}.cy", 0.0, miss)),
            dist=dist,
            width=int(_get(nested, f"{prefix}.width", 0, miss)),
            height=int(_get(nested, f"{prefix}.height", 0, miss)),
            fps=float(_get(nested, f"{prefix}.fps", 30.0, miss)),
            bf=float(_get(nested, f"{prefix}.bf", 0.0, miss)),
            th_depth=float(_get(nested, f"{prefix}.ThDepth", 35.0, miss)),
        )

    cam = cam_cfg("Camera")
    cam_right = cam_cfg("Camera2") if "Camera2" in nested else None

    tbc = _get(nested, "Tbc.data", None, miss)
    imu = ImuConfig(
        Tbc=(
            np.asarray(tbc, np.float32).reshape(4, 4)
            if tbc is not None
            else np.eye(4, dtype=np.float32)
        ),
        freq=float(_get(nested, "IMU.Frequency", 200.0, miss)),
        noise_gyro=float(_get(nested, "IMU.NoiseGyro", 1.7e-4, miss)),
        noise_acc=float(_get(nested, "IMU.NoiseAcc", 2.0e-3, miss)),
        walk_gyro=float(_get(nested, "IMU.GyroWalk", 1.9e-5, miss)),
        walk_acc=float(_get(nested, "IMU.AccWalk", 3.0e-3, miss)),
    )

    feats = FeatureConfig(
        mode=int(_get(nested, "Features.mode", 0, miss)),
        n_features=int(_get(nested, "ORBextractor.nFeatures", 1000, miss)),
        scale_factor=float(_get(nested, "ORBextractor.scaleFactor", 1.2, miss)),
        n_levels=int(_get(nested, "ORBextractor.nLevels", 8, miss)),
        ini_th_fast=int(_get(nested, "ORBextractor.iniThFAST", 20, miss)),
        min_th_fast=int(_get(nested, "ORBextractor.minThFAST", 7, miss)),
    )

    ev = EventConfig(
        l1_chunk_size=int(_get(nested, "Event.data.l1ChunkSize", 2000, miss)),
        l1_num_loop=int(_get(nested, "Event.data.l1NumLoop", 4, miss)),
        min_ev_gen_rate=float(_get(nested, "Event.data.minEvGenRate", 1.0, miss)),
        max_pixel_disp=float(_get(nested, "Event.data.maxPixelDisp", 3.0, miss)),
        l1_fixed_win=bool(_get(nested, "Event.data.l1FixedWin", False, miss)),
        l2_track_mode=int(_get(nested, "Event.l2TrackMode", 1, miss)),
        continuous=bool(_get(nested, "Event.contTracking", True, miss)),
        klt_win=int(_get(nested, "Event.klt.winSize", 23, miss)),
        klt_levels=int(_get(nested, "Event.klt.maxLevel", 3, miss)) + 1,
        klt_iters=int(_get(nested, "Event.klt.maxIter", 10, miss)),
        klt_eps=float(_get(nested, "Event.klt.eps", 0.03, miss)),
        detector_mode=int(_get(nested, "Event.fts.detMode", 0, miss)),
        n_points=int(_get(nested, "Event.fts.maxNumPts", 300, miss)),
    )

    viewer = ViewerConfig(
        enabled=bool(_get(nested, "Viewer.enabled", False, miss)),
        kf_size=float(_get(nested, "Viewer.KeyFrameSize", 0.05, miss)),
        point_size=float(_get(nested, "Viewer.PointSize", 2.0, miss)),
    )

    seqs = _get(nested, "DS.Seq.names", [], miss)
    if isinstance(seqs, str):
        seqs = [seqs]
    ds = DatasetConfig(
        name=str(_get(nested, "DS.name", "", miss)),
        format=str(_get(nested, "DS.format", "euroc", miss)).lower(),
        root=str(_get(nested, "DS.Paths.root", "", miss)),
        sequences=tuple(seqs),
        seq_target=int(_get(nested, "DS.Seq.target", -1, miss)),
        ts_factor=float(_get(nested, "DS.tsFactor", 1.0e9, miss)),
        max_iter=int(_get(nested, "DS.nMaxIter", 1, miss)),
    )

    slam = SlamConfig(
        max_keyframes=int(_get(nested, "SLAM.maxKeyFrames", 32, miss)),
        max_landmarks=int(_get(nested, "SLAM.maxLandmarks", 4096, miss)),
        local_window=int(_get(nested, "SLAM.localWindow", 5, miss)),
        max_frames_between_kf=int(_get(nested, "SLAM.maxFramesBetweenKF",
                                       10, miss)),
    )
    vocab = VocabConfig(
        path=str(_get(nested, "Vocabulary.path", "", miss)),
        train_words=int(_get(nested, "Vocabulary.trainWords", 0, miss)),
        train_frames=int(_get(nested, "Vocabulary.trainFrames", 5, miss)),
    )

    return Settings(
        sensor=sensor,
        cam=cam,
        cam_right=cam_right,
        imu=imu,
        features=feats,
        event=ev,
        viewer=viewer,
        dataset=ds,
        slam=slam,
        vocab=vocab,
        missing=tuple(miss),
    )
