"""Parity of the port's contrast maximization with the JAX package:
``maximize_rt2d`` (params rel 1e-3, contrast rel 1e-4) on a clearly moving
dot field, so that no accept/reject step of the ascent is a near-tie, and
``fit_rt2d_points``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import contrast_max as jcm
from eorb_slam_tpu_torch.event import contrast_max as tcm

H, W = 60, 80


def _moving_dots(omega, vx, vy, n_dots=25, per_dot=30, T=0.05, seed=0):
    """Events of dots under the RT2D motion the warp inverts."""
    rng = np.random.default_rng(seed)
    c = np.asarray([W / 2.0, H / 2.0])
    p0 = rng.uniform([8, 8], [W - 8, H - 8], (n_dots, 2))
    t = rng.uniform(0, T, (n_dots, per_dot))
    a = -omega * t
    rel = p0[:, None, :] - c + np.asarray([vx, vy]) * t[..., None]
    xy = np.stack([np.cos(a) * rel[..., 0] - np.sin(a) * rel[..., 1],
                   np.sin(a) * rel[..., 0] + np.cos(a) * rel[..., 1]], -1) + c
    xy = xy.reshape(-1, 2) + rng.normal(0, 0.15, (n_dots * per_dot, 2))
    valid = rng.random(len(xy)) < 0.95
    return xy.astype(np.float32), t.reshape(-1).astype(np.float32), valid


@pytest.mark.parametrize("motion", [(0.0, 120.0, -60.0), (2.0, -80.0, 40.0)])
def test_maximize_rt2d_matches_jax(motion):
    xy, t, valid = _moving_dots(*motion)
    p_ref, c_ref, c0_ref = jcm.maximize_rt2d(
        jnp.asarray(xy), jnp.asarray(t), jnp.asarray(valid), H, W, iters=10)
    p, c, c0 = tcm.maximize_rt2d(torch.from_numpy(xy), torch.from_numpy(t),
                                 torch.from_numpy(valid), H, W, iters=10)
    p_ref = np.asarray(p_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(p_ref).max())
    assert float(c) == pytest.approx(float(c_ref), rel=1e-4)
    assert float(c0) == pytest.approx(float(c0_ref), rel=1e-4)
    assert float(c) > float(c0)     # the ascent sharpened the image


@pytest.mark.parametrize("n_valid", [0, 3, 40])
def test_fit_rt2d_points_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    prev = rng.uniform(10, 230, (64, 2)).astype(np.float32)
    center = np.asarray([120.0, 90.0], np.float32)
    omega, vx, vy, dt = 1.5, 200.0, -90.0, 0.004
    r = prev - center
    flow = dt * np.stack([-omega * r[:, 1] + vx, omega * r[:, 0] + vy], 1)
    cur = (prev + flow + rng.normal(0, 0.01, prev.shape)).astype(np.float32)
    ok = np.zeros(64, bool)
    ok[:n_valid] = True
    p_ref, n_ref = jcm.fit_rt2d_points(jnp.asarray(prev), jnp.asarray(cur),
                                       jnp.asarray(ok), jnp.asarray(dt, jnp.float32),
                                       jnp.asarray(center))
    p, n = tcm.fit_rt2d_points(torch.from_numpy(prev), torch.from_numpy(cur),
                               torch.from_numpy(ok), torch.tensor(dt),
                               torch.from_numpy(center))
    assert int(n) == int(n_ref) == n_valid
    p_ref = np.asarray(p_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-3,
                               atol=1e-3 * max(np.abs(p_ref).max(), 1e-6))
    if n_valid >= 6:
        np.testing.assert_allclose(p.numpy(), [omega, vx, vy], rtol=0.05)
