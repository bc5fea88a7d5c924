"""The port's settings reader against the JAX package's: the same dataclass
fields and defaults, the same sensor predicates, and ``load_settings`` field
for field on every file in ``configs/`` and on a nested-layout text. Values
are compared exactly (both sides parse the same text with PyYAML)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from eorb_slam_tpu.io import config as jcfg
from eorb_slam_tpu_torch.io import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)
                 for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))
DATACLASSES = ["CameraConfig", "ImuConfig", "FeatureConfig", "EventConfig",
               "ViewerConfig", "DatasetConfig", "SlamConfig", "VocabConfig",
               "Settings"]

NESTED = """
DS:
  Sensor:
    config: mono_ev_im
  name: synth
  format: ev_ethz
  Paths:
    root: /data/x
  Seq:
    names: [shapes_synth, "b c"]
    target: 0
Camera:
  type: KannalaBrandt8
  fx: 190.5
  fy: 191.0
  cx: 120
  cy: 90.25
  k1: -0.01
  k4: 0.002
  width: 240
  height: 180
  fps: 24
Camera2:
  fx: 100.0
  bf: 40.0
Tbc:
  data: [1, 0, 0, 0.1, 0, 1, 0, 0.2, 0, 0, 1, 0.3, 0, 0, 0, 1]
ORBextractor:
  nFeatures: 384
Event:
  contTracking: 0
  data:
    l1ChunkSize: 1500
    l1NumLoop: 3
    minEvGenRate: 0.05
    l1FixedWin: true
  klt:
    maxLevel: 2
Vocabulary:
  trainWords: 64
"""


def _same(a, b, where=""):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif hasattr(a, "name") and hasattr(a, "value"):        # the sensor enum
        assert (a.name, a.value) == (b.name, b.value), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("name", DATACLASSES)
def test_config_fields_match_jax(name):
    fj = dataclasses.fields(getattr(jcfg, name))
    ft = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in ft] == [f.name for f in fj]
    _same(getattr(tcfg, name)(), getattr(jcfg, name)(), name)


@pytest.mark.parametrize("member", [m.name for m in jcfg.SensorConfig])
def test_sensor_config_matches_jax(member):
    sj, st = jcfg.SensorConfig[member], tcfg.SensorConfig[member]
    assert st.value == sj.value
    for pred in ("is_event", "is_image", "is_inertial", "is_monocular",
                 "is_stereo", "is_rgbd"):
        assert getattr(st, pred)() == getattr(sj, pred)(), pred
    assert len(tcfg.SensorConfig) == len(jcfg.SensorConfig)


def test_sensor_strings_match_jax():
    assert sorted(tcfg._SENSOR_STRINGS) == sorted(jcfg._SENSOR_STRINGS)
    for k in jcfg._SENSOR_STRINGS:
        assert tcfg.sensor_from_string(k.upper()).name == \
            jcfg.sensor_from_string(k).name
    with pytest.raises(ValueError):
        tcfg.sensor_from_string("lidar")


@pytest.mark.parametrize("name", CONFIGS)
def test_load_settings_matches_jax(name):
    path = os.path.join(REPO, "configs", name)
    sj, st = jcfg.load_settings(path), tcfg.load_settings(path)
    _same(st, sj, name)
    assert np.array_equal(st.cam.params_array(), sj.cam.params_array())


def test_load_settings_nested_layout_matches_jax(tmp_path):
    path = tmp_path / "nested.yaml"
    path.write_text(NESTED)
    sj, st = jcfg.load_settings(str(path)), tcfg.load_settings(str(path))
    _same(st, sj, "nested")
    assert st.cam.model == "kb8" and st.cam_right is not None
    assert st.sensor is tcfg.SensorConfig.EVENT_MONO
    assert st.event.klt_levels == 3 and st.event.l1_fixed_win is True
    assert st.imu.Tbc[2, 3] == np.float32(0.3)
    assert np.array_equal(st.cam.params_array(), sj.cam.params_array())
    assert st.cam.params_array()[7] == np.float32(0.002)


def test_configs_are_all_covered():
    assert len(CONFIGS) >= 11 and "synth_ev_only.yaml" in CONFIGS
