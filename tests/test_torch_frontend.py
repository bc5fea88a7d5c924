"""Parity of the port's ORB front-end (pyramid, rBRIEF, extract) with the
JAX package.

Tolerances: level-0 keypoints equal (same image, same FAST); over all
levels >= 98% of keypoints shared (the resize sums in another order and can
move a score across a threshold); >= 99% of descriptor bits equal per
shared keypoint (a rotated pattern offset at exactly .5 may round the other
way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import tensorize as jt
from eorb_slam_tpu.ops import frontend as jfe
from eorb_slam_tpu.ops import orb as jorb
from eorb_slam_tpu.ops import pyramid as jpyr
from eorb_slam_tpu_torch.ops import frontend as tfe
from eorb_slam_tpu_torch.ops import orb as torb
from eorb_slam_tpu_torch.ops import pyramid as tpyr

H, W = 180, 240


def _mci(seed=0, n=30000):
    """An MCI-like image in [0,255]: a sharp splat of events on edges and
    blobs."""
    rng = np.random.default_rng(seed)
    segs = rng.uniform([0, 0, 0, 0], [W, H, W, H], (40, 4))
    s = rng.integers(0, len(segs), n)
    u = rng.random(n)[:, None]
    xy = segs[s, :2] * (1 - u) + segs[s, 2:] * u + rng.normal(0, 0.3, (n, 2))
    acc = jt._splat_gauss_separable(jnp.asarray(xy, jnp.float32),
                                    jnp.ones(n, jnp.float32), H, W, 1.0, 2.5)
    return np.asarray(jt.normalize_to_image(acc)) * 255.0


def test_brief_pattern_identical():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())


@pytest.mark.parametrize("shape", [(150, 200), (125, 167), (16, 20)])
def test_resize_matches_jax_antialiased_bilinear(shape):
    img = np.random.default_rng(1).uniform(0, 255, (H, W)).astype(np.float32)
    import jax

    ref = np.asarray(jax.image.resize(jnp.asarray(img), shape, method="bilinear"))
    got = tpyr.resize_bilinear(torch.from_numpy(img), shape).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)   # 255-scale pixels


def test_pyramid_and_blur():
    img = _mci(2)
    ref = jpyr.build_pyramid(jnp.asarray(img))
    got = tpyr.build_pyramid(torch.from_numpy(img))
    assert [g.shape for g in got] == [r.shape for r in ref]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tpyr.gaussian_blur(torch.from_numpy(img)).numpy(),
                               np.asarray(jpyr.gaussian_blur(jnp.asarray(img))),
                               rtol=0, atol=1e-3)
    assert tfe.level_quotas(256) == jfe.level_quotas(256)


def test_describe_and_unpack_bit_layout():
    img = np.asarray(jpyr.gaussian_blur(jnp.asarray(_mci(3))))
    rng = np.random.default_rng(4)
    xy = rng.integers(20, [W - 20, H - 20], (200, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    ref = np.asarray(jorb.describe(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(ang)))
    got = torb.describe(torch.from_numpy(img), torch.from_numpy(xy),
                        torch.from_numpy(ang))
    assert got.dtype == torch.int32 and ref.dtype == np.uint32
    bits_ref = np.unpackbits(ref.view(np.uint8), bitorder="little")
    bits_got = np.unpackbits(got.numpy().view(np.uint32).view(np.uint8), bitorder="little")
    assert np.mean(bits_ref == bits_got) >= 0.99
    # unpack of the SAME words is exact, in the JAX bit order
    np.testing.assert_array_equal(
        torb.unpack_pm1(torch.from_numpy(ref.view(np.int32))).numpy(),
        np.asarray(jorb.unpack_pm1(jnp.asarray(ref))))
    # orientations
    np.testing.assert_allclose(
        torb.orientations(torch.from_numpy(img), torch.from_numpy(xy)).numpy(),
        np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy))),
        rtol=0, atol=1e-4)


def _kp_set(xy, octave, valid):
    return {(int(round(x * 100)), int(round(y * 100)), int(o))
            for (x, y), o, v in zip(xy, octave, valid) if v}


@pytest.mark.parametrize("seed", [5, 6])
def test_extract_matches_jax(seed):
    img = _mci(seed)
    ref = jfe.extract(jnp.asarray(img), max_kp=256)
    got = tfe.extract(torch.from_numpy(img), max_kp=256)
    ref = jfe.Features(*[np.asarray(a) for a in ref])
    got = tfe.Features(*[a.numpy() for a in got])
    assert got.xy.shape == ref.xy.shape == (256, 2)
    assert got.desc.shape == ref.desc.shape == (256, 8)
    assert got.desc_pm1.dtype == np.int8

    # level 0: same image, same FAST -> identical keypoints, in order
    l0 = ref.octave == 0
    np.testing.assert_array_equal(got.xy[l0], ref.xy[l0])
    np.testing.assert_array_equal(got.valid[l0], ref.valid[l0])
    np.testing.assert_array_equal(got.octave, ref.octave)

    # all levels: >= 98% of the keypoints shared
    ks_ref = _kp_set(ref.xy, ref.octave, ref.valid)
    ks_got = _kp_set(got.xy, got.octave, got.valid)
    assert len(ks_ref) > 150
    assert len(ks_ref & ks_got) >= 0.98 * max(len(ks_ref), len(ks_got))

    # descriptors of shared keypoints: >= 99% of bits equal per keypoint
    idx_ref = {k: i for i, k in enumerate(
        (int(round(x * 100)), int(round(y * 100)), int(o))
        for (x, y), o in zip(ref.xy, ref.octave))}
    for j, ((x, y), o, v) in enumerate(zip(got.xy, got.octave, got.valid)):
        k = (int(round(x * 100)), int(round(y * 100)), int(o))
        if not v or k not in ks_ref:
            continue
        i = idx_ref[k]
        agree = np.mean(ref.desc_pm1[i] == got.desc_pm1[j])
        assert agree >= 0.99, (k, agree)
        assert abs(got.angle[j] - ref.angle[i]) < 1e-3 or \
            abs(abs(got.angle[j] - ref.angle[i]) - 2 * np.pi) < 1e-3
    # invalid slots carry zero descriptors
    assert (got.desc_pm1[~got.valid] == 0).all()
