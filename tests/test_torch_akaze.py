"""Parity of the port's AKAZE features (ops/akaze.py) and the mixed ORB +
AKAZE extraction (frontend.extract_mixed) with the JAX package, on the
rendered image of tests/test_akaze.py.

Every JAX quantity comes from one jitted call (one compile). Tolerances:
the contrast factor within 1e-6 relative; the scale-space level images and
the diffusion within 1e-5 of max|ref| (48 explicit f32 steps in the same
tap order); the Hessian responses within 1e-4 of max|ref| (three stacked
difference stencils); orientations within 1e-4 rad; keypoint xy equal in
>= 98% of the valid slots; MLDB bits equal in >= 99.5% on shared
keypoints (a cell mean's last ulp flips a comparison), the bits compared
alone on JAX's own keypoints and angles and after the whole extraction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.ops import akaze as jak
from eorb_slam_tpu.ops import frontend as jfe
from eorb_slam_tpu_torch.ops import akaze as tak
from eorb_slam_tpu_torch.ops import frontend as tfe
from eorb_slam_tpu_torch.ops import matching as tmatch
from eorb_slam_tpu_torch.ops import orb as torb

from tests.test_ev_image_slam import render_frame
from tests.test_event_slam import EventWorld

N_KP = 256                 # extract_mixed's budget
N_AK = N_KP // 2           # its AKAZE half (orb_frac 0.5)
LVL_TOL = 1e-5
HESS_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _step_image():
    """A noisy step edge (tests/test_akaze.py's diffusion scene)."""
    rng = np.random.default_rng(0)
    step = np.zeros((96, 96), np.float32)
    step[:, 48:] = 1.0
    return step + rng.normal(0, 0.05, step.shape).astype(np.float32)


@jax.jit
def _jax_reference(img, step):
    x = img / 255.0
    levels = jak.nonlinear_scale_space(x)
    feats = jak.extract_akaze(img, max_kp=N_AK)
    q0 = jfe.level_quotas(N_AK)[0]
    xy0 = feats.xy[:q0]                   # level-0 slots: level pixels
    ang0 = jak.gradient_orientation(levels[0], xy0)
    return dict(
        k=jak.contrast_k(x), levels=levels,
        hess=[jak.hessian_response(L, 1.0 + 0.4 * l) for l, L in enumerate(levels)],
        feats=feats, xy0=xy0, ang0=ang0,
        desc0=jak.mldb_describe(levels[0], xy0, ang0),
        step_k=jak.contrast_k(step),
        step_diff=jak.diffuse(step, jak.contrast_k(step), steps=12),
    )


@pytest.fixture(scope="module")
def scene():
    img = np.asarray(render_frame(EventWorld(n_points=260, seed=21), 0.0), np.float32)
    ref = jax.tree.map(np.array, _jax_reference(jnp.asarray(img),
                                                  jnp.asarray(_step_image())))
    return img, ref


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _bits(desc):
    return np.unpackbits(np.ascontiguousarray(desc).view(np.uint8),
                         bitorder="little").reshape(len(desc), -1)


def test_conv_scharr_and_contrast(scene):
    img, ref = scene
    x = img / 255.0
    k = np.arange(25, dtype=np.float32).reshape(5, 5) - 12.0
    k[2, 2] = 0.0
    np.testing.assert_allclose(tak._conv2(torch.from_numpy(x), k).numpy(),
                               np.asarray(jak._conv2(jnp.asarray(x), k)),
                               rtol=0, atol=1e-5)
    for got, want in zip(tak._scharr(torch.from_numpy(x)), jak._scharr(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert abs(float(tak.contrast_k(torch.from_numpy(x))) - ref["k"]) <= 1e-6 * ref["k"]


def test_diffusion_and_scale_space(scene):
    img, ref = scene
    step = torch.from_numpy(_step_image())
    k = tak.contrast_k(step)
    assert abs(float(k) - ref["step_k"]) <= 1e-6 * ref["step_k"]
    diff = tak.diffuse(step, k, steps=12).numpy()
    assert _rel(diff, ref["step_diff"]) <= LVL_TOL
    # the property tests/test_akaze.py holds: flat noise smooths, the edge stays
    assert diff[:, :30].std() < 0.6 * step.numpy()[:, :30].std()

    levels = tak.nonlinear_scale_space(torch.from_numpy(img / 255.0))
    assert [tuple(L.shape) for L in levels] == [r.shape for r in ref["levels"]]
    for l, (L, want) in enumerate(zip(levels, ref["levels"])):
        assert _rel(L, want) <= LVL_TOL, l
        hess = tak.hessian_response(L, 1.0 + 0.4 * l)
        assert _rel(hess, ref["hess"][l]) <= HESS_TOL, l


def test_mldb_layout_identical():
    for got, want in zip(tak._mldb_layout(), jak._mldb_layout()):
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            np.testing.assert_array_equal(g, w)


def test_orientation_and_mldb_on_jax_keypoints(scene):
    """Orientation and descriptors on JAX's own level-0 keypoints, level
    image and angles: the MLDB bits are compared alone."""
    _, ref = scene
    L0 = torch.from_numpy(ref["levels"][0])
    xy0 = torch.from_numpy(ref["xy0"])
    ang = tak.gradient_orientation(L0, xy0).numpy()
    np.testing.assert_allclose(ang, ref["ang0"], rtol=0, atol=1e-4)
    desc = tak.mldb_describe(L0, xy0, torch.from_numpy(ref["ang0"]))
    assert desc.dtype == torch.int32
    same = _bits(desc.numpy()) == _bits(ref["desc0"])
    assert same.mean() >= 0.995, same.mean()


def _hold_akaze(feats, ref_feats):
    """Keypoints equal in >= 98% of the valid slots, bits in >= 99.5% of
    the shared keypoints."""
    v_ref = ref_feats.valid
    assert feats.valid.numpy().sum() == v_ref.sum() >= 60
    same_xy = np.all(feats.xy.numpy() == ref_feats.xy, axis=1) & v_ref
    assert same_xy.sum() >= 0.98 * v_ref.sum(), (same_xy.sum(), v_ref.sum())
    np.testing.assert_array_equal(feats.octave.numpy()[same_xy], ref_feats.octave[same_xy])
    bits = _bits(feats.desc.numpy())[same_xy] == _bits(ref_feats.desc)[same_xy]
    assert bits.mean() >= 0.995, bits.mean()
    pm = feats.desc_pm1.numpy()
    assert (pm[~feats.valid.numpy()] == 0).all()


def test_extract_akaze_matches_jax(scene):
    img, ref = scene
    feats = tak.extract_akaze(torch.from_numpy(img), max_kp=N_AK)
    _hold_akaze(feats, ref["feats"])


def test_extract_mixed_channels(scene):
    img, ref = scene
    t = torch.from_numpy(img)
    feats, ch = tfe.extract_mixed(t, max_kp=N_KP, orb_frac=0.5)
    ch = ch.numpy()
    assert ch.dtype == np.int32 and (ch[:N_AK] == 0).all() and (ch[N_AK:] == 1).all()
    orb_half = tfe.extract(t, max_kp=N_KP - N_AK)
    for got, want in zip(feats, orb_half):
        np.testing.assert_array_equal(got[:N_AK].numpy(), want.numpy())
    _hold_akaze(tfe.Features(*[f[N_AK:] for f in feats]), ref["feats"])
    v = feats.valid.numpy()
    assert v[:N_AK].sum() >= 40 and v[N_AK:].sum() >= 40
    # the channel mask blocks cross-channel pairs
    cm = tmatch.channel_mask(torch.from_numpy(ch), torch.from_numpy(ch)).numpy()
    assert cm[:N_AK, :N_AK].all() and not cm[:N_AK, N_AK:].any()
    assert torb.unpack_pm1(feats.desc).shape == (N_KP, 256)
