"""Parity of the port's KLT tracker and FAST detector with the JAX package:
KLT xy within 1e-3 px with equal ``ok``; FAST keypoint sets equal,
including the order among tied scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import klt as jklt
from eorb_slam_tpu.event import tensorize as jt
from eorb_slam_tpu.ops import fast as jfast
from eorb_slam_tpu_torch.event import klt as tklt
from eorb_slam_tpu_torch.ops import fast as tfast

H, W = 180, 240


def _event_image(shift, seed, n=6000):
    """Normalized splat of events scattered around fixed dots (the shape of
    the builder's chunk images)."""
    dots = np.random.default_rng(0).uniform([10, 10], [W - 10, H - 10], (150, 2))
    rng = np.random.default_rng(seed)
    xy = dots[rng.integers(0, len(dots), n)] + shift + rng.normal(0, 0.4, (n, 2))
    acc = jt._splat_gauss_separable(jnp.asarray(xy, jnp.float32),
                                    jnp.ones(n, jnp.float32), H, W, 1.0, 2.5)
    return np.asarray(jt.normalize_to_image(acc))


@pytest.mark.parametrize("shift", [(1.3, -0.7), (-2.6, 1.9)])
def test_track_matches_jax(shift):
    a = _event_image((0.0, 0.0), seed=1)
    b = _event_image(np.asarray(shift), seed=2)
    xy, _, ok = jfast.detect_grid(jnp.asarray(a), threshold=0.08,
                                  min_threshold=0.03, cell=24, per_cell=2,
                                  max_kp=128, border=6)
    kw = dict(win=9, levels=2, iters=6, min_ncc=0.3)
    ref = jklt.track(jnp.asarray(a), jnp.asarray(b), xy, ok, **kw)
    got = tklt.track(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(np.asarray(xy)),
                     torch.from_numpy(np.asarray(ok)), **kw)
    ok_ref = np.asarray(ref.ok)
    assert ok_ref.sum() > 50
    np.testing.assert_array_equal(got.ok.numpy(), ok_ref)
    np.testing.assert_allclose(got.xy.numpy()[ok_ref], np.asarray(ref.xy)[ok_ref],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.ncc.numpy(), np.asarray(ref.ncc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(ref.err), rtol=0, atol=1e-4)
    # the tracks recover the shift
    d = got.xy.numpy()[ok_ref] - np.asarray(xy)[ok_ref]
    np.testing.assert_allclose(np.median(d, axis=0), shift, atol=0.2)


def test_track_with_guess_and_downsample():
    a = _event_image((0.0, 0.0), seed=3)
    b = _event_image((4.0, 3.0), seed=4)
    xy = np.asarray(jfast.detect_grid(jnp.asarray(a), 0.08, 0.03, 24, 2, 64, 6)[0])
    guess = xy + np.asarray([3.5, 2.5], np.float32)
    ok = np.ones(len(xy), bool)
    ref = jklt.track(jnp.asarray(a), jnp.asarray(b), jnp.asarray(xy), jnp.asarray(ok),
                     guess=jnp.asarray(guess))
    got = tklt.track(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(xy),
                     torch.from_numpy(ok), guess=torch.from_numpy(guess))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    m = np.asarray(ref.ok)
    np.testing.assert_allclose(got.xy.numpy()[m], np.asarray(ref.xy)[m], atol=1e-3)
    np.testing.assert_allclose(tklt.downsample2(torch.from_numpy(a)).numpy(),
                               np.asarray(jklt.downsample2(jnp.asarray(a))), atol=1e-6)


@pytest.mark.parametrize("n_ok", [0, 1, 2, 7, 10])
def test_median_displacement(n_ok):
    """Even counts average the two middle values (jnp.nanmedian); none -> NaN."""
    rng = np.random.default_rng(n_ok)
    xy0 = rng.uniform(0, 100, (16, 2)).astype(np.float32)
    xy = (xy0 + rng.normal(0, 3, (16, 2))).astype(np.float32)
    ok = np.zeros(16, bool)
    ok[rng.permutation(16)[:n_ok]] = True
    z = np.zeros(16, np.float32)
    ref = float(jklt.median_displacement(
        jklt.KLTResult(jnp.asarray(xy), jnp.asarray(ok), jnp.asarray(z), jnp.asarray(z)),
        jnp.asarray(xy0)))
    got = float(tklt.median_displacement(
        tklt.KLTResult(torch.from_numpy(xy), torch.from_numpy(ok),
                       torch.from_numpy(z), torch.from_numpy(z)),
        torch.from_numpy(xy0)))
    if n_ok == 0:
        assert np.isnan(ref) and np.isnan(got)
    else:
        assert got == pytest.approx(ref, rel=1e-6)
        disp = np.linalg.norm(xy - xy0, axis=1)[ok]
        assert got == pytest.approx(float(np.median(disp)), rel=1e-5)


def _tied_image():
    """Blocks of identical squares: every square gives the same FAST scores,
    so the top-k selection must break ties the way jax.lax.top_k does."""
    img = np.zeros((H, W), np.float32)
    for y in range(8, H - 16, 12):
        for x in range(8, W - 16, 12):
            img[y:y + 5, x:x + 5] = 1.0
    img[100:106, 60:66] = 0.6     # a few distinct corners too
    return img


@pytest.mark.parametrize("image", ["tied", "events"])
def test_detect_grid_matches_jax(image):
    img = _tied_image() if image == "tied" else _event_image((0.0, 0.0), seed=5)
    for kw in (dict(threshold=0.08, min_threshold=0.03, cell=24, per_cell=2,
                    max_kp=128, border=6),
               dict(threshold=0.2, min_threshold=0.05, cell=32, per_cell=5,
                    max_kp=300, border=16)):
        ref = [np.asarray(a) for a in jfast.detect_grid(jnp.asarray(img), **kw)]
        got = [a.numpy() for a in tfast.detect_grid(torch.from_numpy(img), **kw)]
        assert ref[2].sum() > 10
        np.testing.assert_array_equal(got[0], ref[0])   # same points, same order
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)


def test_fast_score_and_nms():
    img = _event_image((0.0, 0.0), seed=6)
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), 0.05))
    got = tfast.fast_score(torch.from_numpy(img), 0.05).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tfast.nms3x3(torch.from_numpy(ref)).numpy(),
                                  np.asarray(jfast.nms3x3(jnp.asarray(ref))))
