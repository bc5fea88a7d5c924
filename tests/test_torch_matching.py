"""The port's descriptor matching against the JAX package: the same seeded
+-1 descriptors (many exact distance ties, clutter, invalid slots, zeroed
descriptors) give the same integers — distances, best/second-best, matches
and masks are compared for equality, no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.ops import matching as jm
from eorb_slam_tpu_torch.ops import matching as tm


def _descs(seed, n_feat=200, n_lm=300):
    """Landmark descriptors, and feature descriptors made from some of them
    with a few flipped bits (so matches, near-ties and exact ties exist)."""
    rng = np.random.default_rng(seed)
    lm = (rng.integers(0, 2, (n_lm, 256)) * 2 - 1).astype(np.int8)
    src = rng.integers(0, n_lm, n_feat)
    feat = lm[src].copy()
    flips = rng.integers(0, 256, (n_feat, 12))
    for r in range(n_feat):
        feat[r, flips[r, : rng.integers(0, 12)]] *= -1
    clutter = rng.random(n_feat) < 0.2
    feat[clutter] = (rng.integers(0, 2, (clutter.sum(), 256)) * 2 - 1)
    lm[rng.integers(0, n_lm, 10)] = lm[rng.integers(0, n_lm, 10)]  # duplicates
    v1 = rng.random(n_feat) > 0.1
    v2 = rng.random(n_lm) > 0.1
    feat = feat * v1[:, None].astype(np.int8)     # invalid slots are zeroed
    xy1 = rng.uniform(0, 240, (n_feat, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 240, (n_lm, 2)).astype(np.float32)
    return feat, v1, lm, v2, xy1, xy2


def test_hamming_matrix_equal():
    d1, _, d2, _, _, _ = _descs(0)
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = tm.hamming_matrix(torch.from_numpy(d1), torch.from_numpy(d2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_masked_best2_equal():
    d1, v1, d2, v2, xy1, xy2 = _descs(1)
    dist = np.asarray(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    mask = v1[:, None] & v2[None, :] & np.asarray(
        jm.window_mask(jnp.asarray(xy1), jnp.asarray(xy2), 60.0))
    ref = jm.masked_best2(jnp.asarray(dist), jnp.asarray(mask))
    got = tm.masked_best2(torch.from_numpy(dist), torch.from_numpy(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("gate", ["none", "window", "level"])
@pytest.mark.parametrize("seed", [2, 3])
def test_match_nnratio_equal(mutual, gate, seed):
    d1, v1, d2, v2, xy1, xy2 = _descs(seed)
    rng = np.random.default_rng(seed + 100)
    pair = None
    if gate == "window":
        pair = np.asarray(jm.window_mask(jnp.asarray(xy1), jnp.asarray(xy2), 50.0))
        got_mask = tm.window_mask(torch.from_numpy(xy1), torch.from_numpy(xy2), 50.0)
        np.testing.assert_array_equal(got_mask.numpy(), pair)
    elif gate == "level":
        l1 = rng.integers(0, 8, len(d1)).astype(np.int32)
        l2 = rng.integers(0, 8, len(d2)).astype(np.int32)
        pair = np.asarray(jm.level_mask(jnp.asarray(l1), jnp.asarray(l2)))
        got_mask = tm.level_mask(torch.from_numpy(l1), torch.from_numpy(l2))
        np.testing.assert_array_equal(got_mask.numpy(), pair)
    for max_dist, ratio in ((jm.TH_LOW, 0.75), (jm.TH_HIGH, 0.9)):
        ref = jm.match_nnratio(
            jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
            pair_mask=None if pair is None else jnp.asarray(pair),
            max_dist=max_dist, nn_ratio=ratio, mutual=mutual)
        got = tm.match_nnratio(
            torch.from_numpy(d1), torch.from_numpy(v1), torch.from_numpy(d2),
            torch.from_numpy(v2),
            pair_mask=None if pair is None else torch.from_numpy(pair),
            max_dist=max_dist, nn_ratio=ratio, mutual=mutual)
        assert got[0].dtype == torch.int32
        assert (got[0].numpy() >= 0).sum() > 10
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_rotation_consistency_equal():
    rng = np.random.default_rng(5)
    n = 300
    a1 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    a2 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    best = rng.integers(0, n, n)
    # a dominant rotation plus exact histogram ties between other bins
    a1[:120] = (a2[best[:120]] + 0.4) % (2 * np.pi)
    matched = rng.random(n) > 0.2
    ref = jm.rotation_consistency(jnp.asarray(a1), jnp.asarray(a2),
                                  jnp.asarray(best), jnp.asarray(matched))
    got = tm.rotation_consistency(torch.from_numpy(a1), torch.from_numpy(a2),
                                  torch.from_numpy(best), torch.from_numpy(matched))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_channel_mask_and_mutual_filter_equal():
    rng = np.random.default_rng(6)
    c1 = rng.integers(0, 2, 50).astype(np.int32)
    c2 = rng.integers(0, 2, 70).astype(np.int32)
    np.testing.assert_array_equal(
        tm.channel_mask(torch.from_numpy(c1), torch.from_numpy(c2)).numpy(),
        np.asarray(jm.channel_mask(jnp.asarray(c1), jnp.asarray(c2))))
    b12 = rng.integers(0, 70, 50)
    b21 = rng.integers(0, 50, 70)
    np.testing.assert_array_equal(
        tm.mutual_filter(torch.from_numpy(b12), torch.from_numpy(b21)).numpy(),
        np.asarray(jm.mutual_filter(jnp.asarray(b12), jnp.asarray(b21))))
