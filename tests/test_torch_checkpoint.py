"""The port's checkpoint / resume (io/checkpoint.py) against the JAX
package's: the same ``.npz`` format, so an atlas written by either package
loads in the other bit for bit, and the port's counterparts of
tests/test_checkpoint.py: an exact state round trip with a deterministic
resume, and NOT_INITIALIZED keeping its init frame. The maps come from the
port's MonoSlam on SynthWorld; no JAX function is compiled here."""

import numpy as np
import pytest
import torch

from eorb_slam_tpu.io import checkpoint as jck
from eorb_slam_tpu.slam import atlas as jatlas
from eorb_slam_tpu_torch.io import checkpoint as tck
from eorb_slam_tpu_torch.slam import map_state as tms
from eorb_slam_tpu_torch.slam import system as tsys
from tests import synth


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frame(world, t, seed=None):
    f, _ = world.frame(float(t), seed=seed)
    return tsys.FrameInput(f.ts, *(torch.from_numpy(np.array(x)) for x in
                                   (f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid)))


def _slam():
    return tsys.MonoSlam(synth.CAM, K=8, M=1024, min_init_matches=60, device="cpu")


@pytest.fixture(scope="module")
def tracked():
    """A port MonoSlam after 12 SynthWorld frames (initialized, tracking)."""
    world = synth.SynthWorld(seed=21)
    slam = _slam()
    for t in np.arange(0.0, 1.2, 0.1):
        slam.process_features(_frame(world, t))
    assert slam.state == tsys.OK
    return world, slam


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_maps(maps_a, maps_b):
    """Bit-equal maps (either package's), field by field, dtypes too."""
    assert len(maps_a) == len(maps_b)
    for a, b in zip(maps_a, maps_b):
        for field in tms.MapState._fields:
            x, y = _np(getattr(a, field)), _np(getattr(b, field))
            assert x.dtype == y.dtype and x.shape == y.shape, field
            np.testing.assert_array_equal(x, y, err_msg=field)


def test_port_atlas_loads_in_jax(tracked, tmp_path):
    _, slam = tracked
    path = str(tmp_path / "port_atlas")
    tck.save_atlas(path, slam.atlas, extra={"note": "port"})
    atlas, extra = jck.load_atlas(path)
    assert extra == {"note": "port"} and atlas.caps == slam.atlas.caps
    assert atlas.active == slam.atlas.active
    _same_maps(slam.atlas.maps, atlas.maps)


def test_jax_atlas_loads_in_port(tracked, tmp_path):
    """A JAX atlas of two maps (the port's map and an empty one, the second
    active) read by the port, on the CPU."""
    import jax.numpy as jnp

    _, slam = tracked
    jat = jatlas.Atlas(*slam.atlas.caps)
    jat.maps = [type(jat.maps[0])(*[jnp.asarray(t.numpy()) for t in slam.map]),
                jat.maps[0]]
    jat.imu_initialized = [False, False]
    jat.active = 1
    path = str(tmp_path / "jax_atlas.npz")
    jck.save_atlas(path, jat, extra={"note": "jax"})
    atlas, extra = tck.load_atlas(path, device="cpu")
    assert extra == {"note": "jax"} and atlas.caps == tuple(jat.caps)
    assert atlas.active == 1 and atlas.device.type == "cpu"
    _same_maps(jat.maps, atlas.maps)


def test_checkpoint_roundtrip_and_resume(tracked, tmp_path):
    world, slam = tracked
    path = str(tmp_path / "ckpt.npz")
    tck.save_slam(path, slam)

    # restore into a FRESH system and compare state exactly
    slam2 = _slam()
    tck.load_slam(path, slam2)
    assert slam2.n_kf == slam.n_kf and slam2.state == slam.state
    assert slam2._kf_order == slam._kf_order
    np.testing.assert_array_equal(slam2.kf_seq, slam.kf_seq)
    # exact-restore extras: generator state and recovery counters round-trip
    assert torch.equal(slam2.generator.get_state(), slam.generator.get_state())
    assert slam2.lost_frames == slam.lost_frames
    _same_maps(slam.atlas.maps, slam2.atlas.maps)
    assert torch.equal(slam2.T_last, slam.T_last)
    assert torch.equal(slam2.velocity, slam.velocity)
    assert len(slam2.trajectory_twc()) == len(slam.trajectory_twc())

    # both must track the NEXT frames identically (deterministic resume)
    for t in np.arange(1.2, 1.6, 0.1):
        r1 = slam.process_features(_frame(world, t, seed=int(t * 1000)))
        r2 = slam2.process_features(_frame(world, t, seed=int(t * 1000)))
        assert r1 == r2 and r1["state"] == tsys.OK
    np.testing.assert_allclose(slam.T_last.numpy(), slam2.T_last.numpy(), atol=1e-5)
    assert slam2.stats == slam.stats
    for (ta, a), (tb, b) in zip(slam.trajectory_twc(), slam2.trajectory_twc()):
        assert ta == tb
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_checkpoint_not_initialized_keeps_init_frame(tmp_path):
    """A checkpoint taken in NOT_INITIALIZED keeps the pending reference
    frame, so the resumed system initializes from the same two views."""
    world = synth.SynthWorld(seed=22)
    slam = _slam()
    slam.process_features(_frame(world, 0.0))
    assert slam.state == tsys.NOT_INITIALIZED and slam._init_frame is not None

    path = str(tmp_path / "ckpt0.npz")
    tck.save_slam(path, slam)
    slam2 = _slam()
    tck.load_slam(path, slam2)
    assert slam2._init_frame is not None
    assert slam2._init_frame.ts == slam._init_frame.ts
    for fld in ("xy_ud", "octave", "angle", "desc_pm1", "valid"):
        assert torch.equal(getattr(slam2._init_frame, fld),
                           getattr(slam._init_frame, fld)), fld

    # both initialize identically on the same second view
    r1 = slam.process_features(_frame(world, 0.4, seed=400))
    r2 = slam2.process_features(_frame(world, 0.4, seed=400))
    assert r1 == r2 and r1["state"] == tsys.OK
    assert torch.equal(slam.T_last, slam2.T_last)
