"""Parity of the port's event tensorization helpers with the JAX package:
warps, normalization and focus metrics. Tolerance 1e-5 relative; warped
pixel coordinates also get 1e-4 px absolute, about 7 f32 ulps at 240 px
(the two libraries' sin/cos/division differ in the last ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import tensorize as jt
from eorb_slam_tpu.geometry import lie as jlie
from eorb_slam_tpu_torch.event import tensorize as tt

H, W = 180, 240
CAM = np.asarray([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0, 0], np.float32)
PX_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _events(n=500, seed=0):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1).astype(np.float32)
    t = np.sort(rng.uniform(0, 0.01, n)).astype(np.float32)
    return xy, t


def _poses(seed=0):
    rng = np.random.default_rng(seed)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)))
    T1 = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)))
    return T0, T1


def test_warp_se2():
    xy, t = _events()
    params = np.asarray([0.8, -120.0, 45.0], np.float32)
    center = np.asarray([W / 2.0, H / 2.0], np.float32)
    ref = np.asarray(jt.warp_se2(jnp.asarray(xy), jnp.asarray(t),
                                 jnp.asarray(params), jnp.asarray(center)))
    got = tt.warp_se2(_t(xy), _t(t), _t(params), _t(center)).numpy()
    np.testing.assert_allclose(got, ref, **PX_TOL)


@pytest.mark.parametrize("depth", [2.5, "per_event"])
def test_warp_se3_depth(depth):
    xy, t = _events(seed=1)
    t_rel = t / t.max()
    T0, T1 = _poses(1)
    if depth == "per_event":
        depth = np.random.default_rng(2).uniform(1.0, 6.0, len(xy)).astype(np.float32)
    rx, rz = jt.warp_se3_depth(jnp.asarray(xy), jnp.asarray(t_rel), jnp.asarray(T0),
                               jnp.asarray(T1), jnp.asarray(CAM), jnp.asarray(depth))
    gx, gz = tt.warp_se3_depth(_t(xy), _t(t_rel), _t(T0), _t(T1), _t(CAM),
                               torch.as_tensor(depth))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), **PX_TOL)
    np.testing.assert_allclose(gz.numpy(), np.asarray(rz), rtol=1e-5, atol=1e-6)


def test_warp_se3_depthmap():
    xy, t = _events(seed=3)
    t_rel = t / t.max()
    T0, T1 = _poses(3)
    rng = np.random.default_rng(4)
    dmap = rng.uniform(1.0, 5.0, (H, W)).astype(np.float32)
    dmap[rng.random((H, W)) < 0.3] = 0.0          # holes
    rx, rz = jt.warp_se3_depthmap(jnp.asarray(xy), jnp.asarray(t_rel), jnp.asarray(T0),
                                  jnp.asarray(T1), jnp.asarray(CAM),
                                  jnp.asarray(dmap), 3.0)
    gx, gz = tt.warp_se3_depthmap(_t(xy), _t(t_rel), _t(T0), _t(T1), _t(CAM),
                                  _t(dmap), 3.0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), **PX_TOL)
    np.testing.assert_allclose(gz.numpy(), np.asarray(rz), rtol=1e-5, atol=1e-6)


def _image(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.gamma(0.5, 2.0, (H, W)) - 0.3).astype(np.float32)


def test_normalize_to_image():
    img = _image()
    ref = np.asarray(jt.normalize_to_image(jnp.asarray(img)))
    got = tt.normalize_to_image(_t(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.min() == 0.0 and got.max() == pytest.approx(1.0)


@pytest.mark.parametrize("masked", [False, True])
def test_image_std(masked):
    img = _image(6)
    mask = np.random.default_rng(7).random((H, W)) < 0.6 if masked else None
    ref = float(jt.image_std(jnp.asarray(img),
                             None if mask is None else jnp.asarray(mask)))
    got = float(tt.image_std(_t(img), None if mask is None else _t(mask)))
    assert got == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("patch", [30, 17])
def test_patch_std_mean(patch):
    img = _image(8)
    ref = float(jt.patch_std_mean(jnp.asarray(img), patch=patch))
    got = float(tt.patch_std_mean(_t(img), patch=patch))
    assert got == pytest.approx(ref, rel=1e-5)
    # batched form (the candidate scoring) equals the per-image scores
    batch = np.stack([img, _image(9)])
    got_b = tt.patch_std_mean(_t(batch), patch=patch).numpy()
    refs = [float(jt.patch_std_mean(jnp.asarray(b), patch=patch)) for b in batch]
    np.testing.assert_allclose(got_b, refs, rtol=1e-5)


def test_event_gen_rate():
    ref = float(jt.event_gen_rate(24000, 0.006, H * W))
    assert float(tt.event_gen_rate(24000, 0.006, H * W)) == pytest.approx(ref, rel=1e-6)
