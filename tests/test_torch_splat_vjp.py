"""The splat's gather VJP and its SE2 forms (CPU paths of
ops/hopper_splat) against autograd and against the JAX package.

The plain gather VJP (``_splat_vjp_plain``: what ``splat``'s backward runs on
a CPU tensor, and the formula the CUDA VJP kernel implements) is held
against (a) autograd through the port's dense ``_splat_gauss_separable`` and
(b) ``jax.vjp`` of the JAX package's ``_splat_gauss_separable``, which is what
``pallas_splat._splat_bwd`` runs. Tolerance 1e-5·max|ref|: f32 sums in
another order. The SE2 forms: ``splat_gauss_se2`` against JAX ``warp_se2`` +
``splat_gauss`` (1e-5·max|ref|), and dL/dparams against ``jax.grad`` of the
JAX ``_contrast`` (1e-4·max|ref|: a sum over all events in another order).
The CUDA kernels are compared with these same plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import contrast_max as jcm
from eorb_slam_tpu.event import tensorize as jt
from eorb_slam_tpu_torch.event import contrast_max as tcm
from eorb_slam_tpu_torch.event import tensorize as tt
from eorb_slam_tpu_torch.ops import hopper_splat

SIGMA, TRUNC = 1.0, 2.5
SIZES = [(180, 240), (37, 53)]
KINDS = ["inside", "border", "outside", "weight0", "weight_neg", "on_radius"]


def _events(kind, n, H, W, seed):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(3, W - 4, n), rng.uniform(3, H - 4, n)], 1)
    w = np.ones(n)
    if kind == "border":        # within 3 px of the frame, inside and out
        xy = np.stack([rng.uniform(-3, W + 2, n), rng.uniform(-3, H + 2, n)], 1)
        side = rng.random(n) < 0.5
        xy[side, 0] = rng.choice([-1.0, 0.3, W - 1.2, W + 1.0], side.sum())
    elif kind == "outside":     # a third parked far away
        far = rng.random(n) < 0.33
        xy[far] = rng.choice([-1e6, 1e6, -40.0, 400.0], (far.sum(), 2))
    elif kind == "weight0":
        w[rng.random(n) < 0.33] = 0.0
    elif kind == "weight_neg":
        w[rng.random(n) < 0.5] = -1.0
    elif kind == "on_radius":   # |d| = 2.5 exactly: x = 10.5 has taps 8 and 13
        xy = np.floor(xy) + 0.5
        xy[0] = [10.5, 10.5]
    return xy.astype(np.float32), w.astype(np.float32)


def _cotangent(H, W, seed):
    return np.random.default_rng(seed).normal(size=(H, W)).astype(np.float32)


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("n", [600, 4096])
@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_gather_vjp_matches_autograd_and_jax(kind, H, W, n):
    xy, w = _events(kind, n, H, W, seed=n + H)
    g = _cotangent(H, W, seed=n)
    got_xy, got_w = hopper_splat._splat_vjp_plain(
        torch.from_numpy(g), torch.from_numpy(xy), torch.from_numpy(w),
        H, W, SIGMA, TRUNC)

    txy = torch.from_numpy(xy).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ref_xy, ref_w = torch.autograd.grad(
        tt._splat_gauss_separable(txy, tw, H, W, SIGMA, TRUNC), (txy, tw),
        torch.from_numpy(g))
    _close(got_xy.numpy(), ref_xy.numpy(), 1e-5)
    _close(got_w.numpy(), ref_w.numpy(), 1e-5)

    _, vjp = jax.vjp(
        lambda a, b: jt._splat_gauss_separable(a, b, H, W, SIGMA, TRUNC),
        jnp.asarray(xy), jnp.asarray(w))
    jax_xy, jax_w = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    _close(got_xy.numpy(), jax_xy, 1e-5)
    _close(got_w.numpy(), jax_w, 1e-5)


def test_backward_of_splat_is_the_gather_form():
    """``splat``'s backward on a CPU tensor returns exactly the plain gather
    VJP, and only the gradients asked for."""
    H, W = SIZES[1]
    xy, w = _events("border", 300, H, W, seed=1)
    g = torch.from_numpy(_cotangent(H, W, seed=2))
    txy = torch.from_numpy(xy).requires_grad_(True)
    tw = torch.from_numpy(w)
    out = hopper_splat.splat(txy, tw, H, W, SIGMA, TRUNC)
    (got,) = torch.autograd.grad(out, (txy,), g)
    ref, _ = hopper_splat._splat_vjp_plain(g, txy.detach(), tw, H, W, SIGMA, TRUNC)
    assert torch.equal(got, ref)
    assert hopper_splat.splat.vjp_launches == 0     # no kernel on the CPU


def test_gather_vjp_nonfinite_matches_autograd():
    """Where autograd through the separable form is not finite, the gather
    form writes NaN, element for element; elsewhere they agree."""
    H, W = SIZES[1]
    xy, w = _events("inside", 64, H, W, seed=3)
    xy[0, 0] = np.inf
    xy[1, 1] = -np.inf
    xy[2, 0] = np.nan
    xy[3, 1] = np.nan
    w[4] = np.inf
    w[5] = np.nan
    xy[6] = [np.inf, np.inf]
    w[6] = 0.0
    g = torch.from_numpy(_cotangent(H, W, seed=4))
    got = hopper_splat._splat_vjp_plain(g, torch.from_numpy(xy),
                                        torch.from_numpy(w), H, W, SIGMA, TRUNC)
    txy = torch.from_numpy(xy).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ref = torch.autograd.grad(
        tt._splat_gauss_separable(txy, tw, H, W, SIGMA, TRUNC), (txy, tw), g)
    for a, b in zip(got, ref):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.isnan(a[~fin]).all()
        _close(a[fin].numpy(), b[fin].numpy(), 1e-5)
    assert int((~torch.isfinite(ref[0])).sum()) >= 8   # the case is not empty


def _se2_case(H, W, n, seed):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n)], 1)
    t = rng.uniform(0, 0.02, n)
    valid = rng.random(n) < 0.85
    params = np.asarray([1.5, 220.0, -130.0])
    f32 = np.float32
    return xy.astype(f32), t.astype(f32), valid, params.astype(f32)


@pytest.mark.parametrize("n", [600, 4096])
@pytest.mark.parametrize("H,W", SIZES)
def test_splat_gauss_se2_matches_jax(H, W, n):
    xy, t, valid, params = _se2_case(H, W, n, seed=n + W)
    center = (W / 2.0, H / 2.0)
    pol = np.ones(n, np.float32)
    ref = np.asarray(jt.splat_gauss(
        jt.warp_se2(jnp.asarray(xy), jnp.asarray(t), jnp.asarray(params),
                    jnp.asarray(center, jnp.float32)),
        jnp.asarray(valid), jnp.asarray(pol), H, W))
    got = tt.splat_gauss_se2(
        torch.from_numpy(xy), torch.from_numpy(t), torch.from_numpy(params),
        center, torch.from_numpy(valid), H, W).numpy()
    assert got.shape == (H, W) and got.dtype == np.float32
    _close(got, ref, 1e-5)


def test_splat_se2_float_weights():
    """f32 weights (polarity times validity) in place of the bool mask."""
    H, W = SIZES[1]
    xy, t, valid, params = _se2_case(H, W, 500, seed=9)
    pol = np.random.default_rng(1).choice([-1.0, 1.0], 500).astype(np.float32)
    center = (W / 2.0, H / 2.0)
    txy, tt_, tp = (torch.from_numpy(a) for a in (xy, t, params))
    got = hopper_splat.splat_se2(txy, tt_, torch.from_numpy(pol * valid), tp,
                                 center, H, W, SIGMA, TRUNC)
    ref = tt.splat_gauss(
        tt.warp_se2(txy, tt_, tp, torch.tensor(center)),
        torch.from_numpy(valid), torch.from_numpy(pol), H, W, use_polarity=True)
    _close(got.numpy(), ref.numpy(), 1e-6)


@pytest.mark.parametrize("n", [600, 4096])
@pytest.mark.parametrize("H,W", SIZES)
def test_contrast_grad_matches_jax(H, W, n):
    """dL/dparams through splat_gauss_se2's backward (the plain SE2 gather
    VJP) against jax.grad of the JAX package's _contrast."""
    xy, t, valid, params = _se2_case(H, W, n, seed=n + H)
    pol = np.ones(n, np.float32)
    center = (W / 2.0, H / 2.0)
    c_ref, g_ref = jax.value_and_grad(jcm._contrast)(
        jnp.asarray(params), jnp.asarray(xy), jnp.asarray(t), jnp.asarray(valid),
        jnp.asarray(pol), jnp.asarray(center, jnp.float32), H, W, SIGMA)
    p = torch.from_numpy(params).requires_grad_(True)
    c = tcm._contrast(p, torch.from_numpy(xy), torch.from_numpy(t),
                      torch.from_numpy(valid), center, H, W, SIGMA)
    (g,) = torch.autograd.grad(c, p)
    assert float(c.detach()) == pytest.approx(float(c_ref), rel=1e-5)
    _close(g.numpy(), np.asarray(g_ref), 1e-4)
    assert np.abs(np.asarray(g_ref)).min() > 0      # every parameter is live


def test_se2_vjp_matches_autograd_through_warp():
    """The SE2 VJP against autograd through the port's warp_se2 + dense
    separable splat, with float weights."""
    H, W = SIZES[1]
    xy, t, _, params = _se2_case(H, W, 800, seed=5)
    w = np.random.default_rng(6).choice([-1.0, 0.0, 1.0], 800).astype(np.float32)
    g = torch.from_numpy(_cotangent(H, W, seed=7))
    center = (W / 2.0, H / 2.0)
    txy, tt_, tw = (torch.from_numpy(a) for a in (xy, t, w))
    p = torch.from_numpy(params).requires_grad_(True)
    (got,) = torch.autograd.grad(
        hopper_splat.splat_se2(txy, tt_, tw, p, center, H, W, SIGMA, TRUNC), p, g)
    q = torch.from_numpy(params).requires_grad_(True)
    (ref,) = torch.autograd.grad(
        tt._splat_gauss_separable(tt.warp_se2(txy, tt_, q, torch.tensor(center)),
                                  tw, H, W, SIGMA, TRUNC), q, g)
    _close(got.numpy(), ref.numpy(), 1e-4)


def test_splat_se2_rejects_bad_inputs():
    H, W = SIZES[1]
    xy, t, w, p = torch.zeros(4, 2), torch.zeros(4), torch.ones(4), torch.zeros(3)
    ok = dict(center=(1.0, 2.0), H=H, W=W, sigma=SIGMA, trunc=TRUNC)
    hopper_splat.splat_se2(xy, t, w, p, **ok)
    hopper_splat.splat_se2(xy, t, w > 0, p, **ok)          # a bool mask
    with pytest.raises(TypeError):
        hopper_splat.splat_se2(xy, t, w.to(torch.int32), p, **ok)
    with pytest.raises(ValueError):
        hopper_splat.splat_se2(xy, t[:3], w, p, **ok)
    with pytest.raises(ValueError):
        hopper_splat.splat_se2(xy, t, w, torch.zeros(4), **ok)
    with pytest.raises(ValueError):
        hopper_splat.splat_se2(xy, torch.zeros(8)[::2], w, p, **ok)
    with pytest.raises(ValueError):     # differentiable w.r.t. params only
        hopper_splat.splat_se2(xy.clone().requires_grad_(True), t, w, p, **ok)
    with pytest.raises(TypeError):      # the identity form takes f32 weights
        hopper_splat.splat(xy, w > 0, H, W, SIGMA, TRUNC)
