"""The port's entry points run on the card unless the caller asks for the
CPU: with ``device=None`` they resolve to ``cuda``, and on a machine without
a CUDA device they raise a RuntimeError that names CUDA instead of carrying
on on the CPU. ``device="cpu"`` is what the CPU tests pass."""

import numpy as np
import pytest
import torch

from eorb_slam_tpu_torch import _host, convert
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.slam import atlas as tatlas
from eorb_slam_tpu_torch.slam import event_system as tes
from eorb_slam_tpu_torch.slam import system as tsys

CAM = np.asarray([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0, 0], np.float32)
SMALL = dict(K=4, M=64, P=4)

ENTRY_POINTS = {
    "EventWindowBuilder": lambda **kw: tb.EventWindowBuilder(
        tb.BuilderConfig(), CAM, **kw),
    "MonoSlam": lambda **kw: tsys.MonoSlam(CAM, N=32, **SMALL, **kw),
    "EventSlam": lambda **kw: tes.EventSlam(CAM, max_kp=32, **SMALL, **kw),
    "Atlas": lambda **kw: tatlas.Atlas(N=32, **SMALL, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        obj = make()
        dev = obj.builder.device if name == "EventSlam" else obj.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_runs_when_asked(name):
    obj = ENTRY_POINTS[name](device="cpu")
    if name == "EventSlam":
        assert obj.builder.device.type == obj.l2.device.type == "cpu"
        assert obj.l2.map.kf_T.device.type == "cpu"
    else:
        assert obj.device.type == "cpu"


def test_resolve_device_follows_an_explicit_argument():
    assert _host.resolve_device("cpu") == torch.device("cpu")
    assert _host.resolve_device(torch.device("cuda:0")) == torch.device("cuda:0")


def test_conversions_follow_their_argument():
    """convert.*_from_numpy pick no device: None leaves the state on the CPU."""
    assert convert.cam_from_numpy(CAM).device.type == "cpu"
    assert convert.cam_from_numpy(CAM, "cpu").device.type == "cpu"
