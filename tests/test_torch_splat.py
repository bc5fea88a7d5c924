"""Parity of the port's event splat (CPU path of ops/hopper_splat.splat)
with the JAX package's splat, forward and VJP.

On a CPU tensor the wrapper computes the plain separable version; the CUDA
kernel is compared with that same plain version on the card by
chip_smoke.py. Tolerances: forward 1e-5·max|ref|, gradients 1e-4·max|ref|
(f32 products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import tensorize as jt
from eorb_slam_tpu_torch.event import tensorize as tt
from eorb_slam_tpu_torch.ops import hopper_splat

H, W = 180, 240
SIGMA, TRUNC = 1.0, 2.5


def _events(kind, n, seed):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1)
    w = rng.choice([-1.0, 1.0], n)
    if kind == "edge":        # out of the image by at most 3 px
        xy = np.stack([rng.uniform(-3, W + 2, n), rng.uniform(-3, H + 2, n)], 1)
    elif kind == "far":       # a third parked 1e6 px away (the TPU pad value)
        far = rng.random(n) < 0.33
        xy[far] = rng.choice([-1e6, 1e6], (far.sum(), 2))
    elif kind == "zero_w":    # a third of the events carry weight 0
        w[rng.random(n) < 0.33] = 0.0
    elif kind == "on_grid":   # integer and half-integer coordinates: the
        # truncation radius 2.5 lands exactly on pixel centres
        xy = np.round(xy * 2) / 2
    return xy.astype(np.float32), w.astype(np.float32)


CASES = [("in", 700), ("edge", 700), ("far", 700), ("zero_w", 700),
         ("on_grid", 700), ("in", 1), ("in", 513)]


@pytest.mark.parametrize("kind,n", CASES)
def test_forward_matches_jax(kind, n):
    xy, w = _events(kind, n, seed=n)
    ref = np.asarray(jt._splat_gauss_separable(
        jnp.asarray(xy), jnp.asarray(w), H, W, SIGMA, TRUNC))
    got = hopper_splat.splat(torch.from_numpy(xy), torch.from_numpy(w),
                             H, W, SIGMA, TRUNC).numpy()
    assert got.shape == (H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30))


def test_splat_gauss_dispatch_matches_jax():
    """tensorize.splat_gauss (valid mask, polarity off) against JAX's."""
    xy, _ = _events("edge", 900, seed=3)
    rng = np.random.default_rng(4)
    valid = rng.random(900) < 0.8
    pol = rng.choice([-1.0, 1.0], 900).astype(np.float32)
    ref = np.asarray(jt.splat_gauss(jnp.asarray(xy), jnp.asarray(valid),
                                    jnp.asarray(pol), H, W))
    got = tt.splat_gauss(torch.from_numpy(xy), torch.from_numpy(valid),
                         torch.from_numpy(pol), H, W).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_inf_coordinates_add_nothing():
    """+-inf coordinates (the DPose warp at z~0) contribute exactly 0."""
    xy, w = _events("in", 300, seed=5)
    bad = xy.copy()
    bad[:20, 0] = np.inf
    bad[20:40, 1] = -np.inf
    w_bad = w.copy()
    w_bad[:40] = 0.0
    w_ok = w.copy()
    w_ok[:40] = 0.0
    ref = np.asarray(jt._splat_gauss_separable(
        jnp.asarray(bad), jnp.asarray(w_bad), H, W, SIGMA, TRUNC))
    got = hopper_splat.splat(torch.from_numpy(bad), torch.from_numpy(w_bad),
                             H, W, SIGMA, TRUNC).numpy()
    clean = hopper_splat.splat(torch.from_numpy(xy), torch.from_numpy(w_ok),
                               H, W, SIGMA, TRUNC).numpy()
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(got, clean, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind,n", [("in", 600), ("edge", 600), ("zero_w", 600),
                                    ("in", 77)])
def test_vjp_matches_jax(kind, n):
    xy, w = _events(kind, n, seed=10 + n)
    g = np.random.default_rng(n).normal(size=(H, W)).astype(np.float32)

    _, vjp = jax.vjp(
        lambda a, b: jt._splat_gauss_separable(a, b, H, W, SIGMA, TRUNC),
        jnp.asarray(xy), jnp.asarray(w))
    ref_xy, ref_w = (np.asarray(v) for v in vjp(jnp.asarray(g)))

    txy = torch.from_numpy(xy).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = hopper_splat.splat(txy, tw, H, W, SIGMA, TRUNC)
    got_xy, got_w = torch.autograd.grad(out, (txy, tw), torch.from_numpy(g))

    np.testing.assert_allclose(got_xy.numpy(), ref_xy, rtol=0,
                               atol=1e-4 * np.abs(ref_xy).max())
    np.testing.assert_allclose(got_w.numpy(), ref_w, rtol=0,
                               atol=1e-4 * np.abs(ref_w).max())


def test_wrapper_rejects_bad_inputs():
    xy = torch.zeros(4, 2)
    w = torch.ones(4)
    with pytest.raises(TypeError):
        hopper_splat.splat(xy.double(), w, H, W, SIGMA, TRUNC)
    with pytest.raises(ValueError):
        hopper_splat.splat(xy[:, :1], w, H, W, SIGMA, TRUNC)
    with pytest.raises(ValueError):
        hopper_splat.splat(xy, w[:3], H, W, SIGMA, TRUNC)
    with pytest.raises(ValueError):
        hopper_splat.splat(torch.zeros(2, 4).t(), w, H, W, SIGMA, TRUNC)


def test_cpu_path_launches_no_kernel():
    before = hopper_splat.splat.launches
    xy, w = _events("in", 10, seed=0)
    hopper_splat.splat(torch.from_numpy(xy), torch.from_numpy(w), H, W,
                       SIGMA, TRUNC)
    assert hopper_splat.splat.launches == before
