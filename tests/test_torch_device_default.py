"""The port's entry points run on the card unless the caller asks for the
CPU: with ``device=None`` they resolve to ``cuda``, and on a machine without
a CUDA device they raise a RuntimeError that names CUDA instead of carrying
on on the CPU. ``device="cpu"`` is what the CPU tests pass."""

import os

import numpy as np
import pytest
import torch

from eorb_slam_tpu_torch import _host, convert
from eorb_slam_tpu_torch.apps import run_slam as trun
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.imu import preintegration as tpre
from eorb_slam_tpu_torch.io import checkpoint as tck
from eorb_slam_tpu_torch.io import config as tcfg, synth_dataset as tsd
from eorb_slam_tpu_torch.parallel import mesh_utils as tmesh
from eorb_slam_tpu_torch.slam import atlas as tatlas
from eorb_slam_tpu_torch.slam import ev_image_system as tev
from eorb_slam_tpu_torch.slam import event_continuous as tec
from eorb_slam_tpu_torch.slam import event_inertial as tei
from eorb_slam_tpu_torch.slam import event_system as tes
from eorb_slam_tpu_torch.slam import loop_closing as tlc
from eorb_slam_tpu_torch.slam import rgbd_stereo as trs
from eorb_slam_tpu_torch.slam import system as tsys
from eorb_slam_tpu_torch.slam import vi_system as tvs

CAM = np.asarray([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0, 0], np.float32)
SMALL = dict(K=4, M=64, P=4)

_SCENE = tsd.make_scene("shakes", 48, 36, 40.0, n_dots=20)
_MONO = tcfg.Settings(cam=tcfg.CameraConfig(fx=40.0, fy=40.0, cx=24.0, cy=18.0,
                                            width=48, height=36),
                      slam=tcfg.SlamConfig(max_keyframes=4, max_landmarks=64),
                      features=tcfg.FeatureConfig(n_features=128))


def _load_atlas(**kw):
    """``load_atlas`` of a small atlas written on the CPU; the atlas."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "atlas.npz")
    tck.save_atlas(path, tatlas.Atlas(N=32, **SMALL, device="cpu"))
    return tck.load_atlas(path, **kw)[0]


class _Renderer:
    """A renderer with the ``device`` its tensors live on."""

    def __init__(self, render):
        self.render = render
        self.device = render(np.eye(4, dtype=np.float32)).device


ENTRY_POINTS = {
    "build_system": lambda **kw: trun.build_system(_MONO, **kw),
    "dot_renderer": lambda **kw: _Renderer(tsd._renderer(
        tsd.make_scene("shakes", 48, 36, 40.0, n_dots=20), **kw)),
    "box_renderer": lambda **kw: _Renderer(tsd.make_box_renderer(
        "corridor", 48, 36, 40.0, **kw)),
    "EventWindowBuilder": lambda **kw: tb.EventWindowBuilder(
        tb.BuilderConfig(), CAM, **kw),
    "MonoSlam": lambda **kw: tsys.MonoSlam(CAM, N=32, **SMALL, **kw),
    "MixedMonoSlam": lambda **kw: tsys.MixedMonoSlam(CAM, N=32, **SMALL, **kw),
    "make_mesh": lambda **kw: tmesh.make_mesh(**kw),
    "load_atlas": _load_atlas,
    "EventSlam": lambda **kw: tes.EventSlam(CAM, max_kp=32, **SMALL, **kw),
    "MonoInertialSlam": lambda **kw: tvs.MonoInertialSlam(
        CAM, tpre.make_calib(), N=32, **SMALL, **kw),
    "EventInertialSlam": lambda **kw: tei.EventInertialSlam(
        CAM, tpre.make_calib(), max_kp=32, **SMALL, **kw),
    "Atlas": lambda **kw: tatlas.Atlas(N=32, **SMALL, **kw),
    "StereoSlam": lambda **kw: trs.StereoSlam(CAM, baseline=0.11, N=32, **SMALL, **kw),
    "RgbdSlam": lambda **kw: trs.RgbdSlam(CAM, N=32, **SMALL, **kw),
    "StereoInertialSlam": lambda **kw: trs.StereoInertialSlam(
        CAM, tpre.make_calib(), baseline=0.11, N=32, **SMALL, **kw),
    "LoopCloser": lambda **kw: tlc.LoopCloser(
        CAM, np.ones((8, 256), np.int8), Kmax=4, **kw),
    "EvImageSlam": lambda **kw: tev.EvImageSlam(CAM, max_kp=32, ev_max_kp=32,
                                                **SMALL, **kw),
    "EvImageInertialSlam": lambda **kw: tei.EvImageInertialSlam(
        CAM, tpre.make_calib(), max_kp=32, ev_max_kp=32, **SMALL, **kw),
    "ContinuousEventTracker": lambda **kw: tec.ContinuousEventTracker(
        CAM, n_tracks=32, **SMALL, **kw),
    "EventSlamContinuous": lambda **kw: tec.EventSlamContinuous(CAM, n_tracks=32,
                                                                **SMALL, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        obj = make()
        dev = obj.builder.device if hasattr(obj, "builder") else obj.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_runs_when_asked(name):
    obj = ENTRY_POINTS[name](device="cpu")
    if hasattr(obj, "l2"):
        assert obj.builder.device.type == obj.l2.device.type == "cpu"
        assert obj.l2.map.kf_T.device.type == "cpu"
    else:
        assert obj.device.type == "cpu"
    if hasattr(obj, "ev"):      # the image-clock event modes: both maps
        assert obj.builder.device.type == obj.im.device.type == obj.ev.device.type
        assert obj.im.map.kf_T.device.type == obj.ev.map.kf_T.device.type == "cpu"
    if hasattr(obj, "tracks"):
        assert obj.tracks.xy.device.type == "cpu"
    vi = getattr(obj, "l2", getattr(obj, "im", obj))
    if hasattr(vi, "calib"):
        assert vi.calib.Tbc.device.type == vi.pre_kf.C.device.type == "cpu"


def test_resolve_device_follows_an_explicit_argument():
    assert _host.resolve_device("cpu") == torch.device("cpu")
    assert _host.resolve_device(torch.device("cuda:0")) == torch.device("cuda:0")


def test_conversions_follow_their_argument():
    """convert.*_from_numpy pick no device: None leaves the state on the CPU."""
    assert convert.cam_from_numpy(CAM).device.type == "cpu"
    assert convert.cam_from_numpy(CAM, "cpu").device.type == "cpu"


@pytest.mark.parametrize("cli", ["run_slam", "synth_dataset"])
def test_cli_default_device_is_the_card(cli, tmp_path):
    """Neither command line carries on on the CPU when it finds no card; with
    ``--device cpu`` both run (tests/test_torch_apps.py,
    tests/test_torch_synth_dataset.py)."""
    if cli == "run_slam":
        settings = tsd.write_settings_yaml(
            str(tmp_path / "s.yaml"), fmt="ev_ethz", root=str(tmp_path), seqs=["s"],
            sensor="event_only", scene=_SCENE, fps=24.0, ts_factor=1.0)
        run = lambda: trun.main([settings, "--out", str(tmp_path / "o")])
    else:
        run = lambda: tsd.main(["--out", str(tmp_path), "--kind", "ev_ethz",
                                "--duration", "0.02"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
    assert not (tmp_path / "o").exists() and not (tmp_path / "seq01").exists()


def test_writers_default_to_the_card(tmp_path):
    pose = tsd.make_trajectory("shakes", 1.0)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised by chip_smoke.py")
    for write in (tsd.write_ev_ethz, tsd.write_euroc):
        with pytest.raises(RuntimeError, match="CUDA"):
            write(str(tmp_path), "s", _SCENE, pose, 0.05, verbose=False)
