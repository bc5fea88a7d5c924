"""The contrast-maximization ascent as the ascent kernel runs it
(``contrast_max._ascent_loop``, the CPU path of ``maximize_rt2d``) and the
kernel's layout (``hopper_splat.ascent_layout``).

The loop takes no autograd: the contrast's cotangent in closed form
(``_cotangent``) feeds the plain SE2 VJP. Held against autograd of the
port's ``_contrast`` (bit-equal: the closed form is autograd's own op order)
and ``jax.grad`` of the JAX package's ``_contrast`` (1e-5 relative: sums in
another order); the loop against the autograd loop it replaces, copied here
(bit-equal: the accepted trial's image equals the image autograd
recomputes at the accepted point), and against the JAX ``maximize_rt2d``
(params 1e-3, contrast 1e-4, as tests/test_torch_contrast_max.py). The CUDA
kernel itself is held against this loop on the card by chip_smoke.py
(``check_kernel_ascent``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import contrast_max as jcm
from eorb_slam_tpu_torch.event import contrast_max as tcm
from eorb_slam_tpu_torch.event import tensorize as tt
from eorb_slam_tpu_torch.ops import hopper_splat

H, W = 60, 80
SIGMA, TRUNC = 1.0, 2.5
MOTIONS = [(0.0, 120.0, -60.0), (2.0, -80.0, 40.0)]   # test_torch_contrast_max.py's
ITERS = 10


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _moving_dots(omega, vx, vy, n_dots=25, per_dot=30, T=0.05, seed=0):
    """Events of dots under the RT2D motion the warp inverts (as
    tests/test_torch_contrast_max.py makes them)."""
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


def _torch(*a):
    return tuple(torch.from_numpy(x) for x in a)


def _autograd_loop(xy, t_rel, valid, H, W, params0, iters, sigma, lr):
    """The ascent before the kernel: autograd through ``_contrast`` for the
    gradient, 1 + 2 * iters forward splats."""
    dt = xy.dtype
    center = (W / 2.0, H / 2.0)

    def f(p):
        return tcm._contrast(p, xy, t_rel, valid, center, H, W, sigma)

    def grad(p):
        p = p.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(f(p), p)
        return g

    scale = torch.tensor([2.0 / max(H, W), 1.0, 1.0], dtype=dt)
    with torch.no_grad():
        p = params0
        best = f(params0)
        c0 = best
        step = torch.tensor(lr, dtype=dt)
        for _ in range(iters):
            g = grad(p) * scale * scale
            gn = torch.linalg.norm(g / scale)
            p_new = p + step * g / torch.clamp(gn, min=1e-12)
            c_new = f(p_new)
            better = c_new > best
            p = torch.where(better, p_new, p)
            best = torch.where(better, c_new, best)
            step = torch.where(better, step * 1.1, step * 0.5)
    return p, best, c0


def _closed_form_grad(p, xy, t, valid):
    center = (W / 2.0, H / 2.0)
    img = tt.splat_gauss_se2(xy, t, p, center, valid, H, W, sigma=SIGMA)
    return hopper_splat.splat_se2_vjp(tcm._cotangent(img), xy, t, valid, p, center,
                                      H, W, SIGMA, TRUNC)


@pytest.mark.parametrize("params", [(0.0, 0.0, 0.0), (0.3, 50.0, -20.0)])
@pytest.mark.parametrize("motion", MOTIONS)
def test_cotangent_vjp_matches_autograd(motion, params):
    """The closed-form cotangent through the plain SE2 VJP against
    torch.autograd.grad of _contrast: the same bits (<= 1e-7 relative
    allowed)."""
    xy, t, valid = _torch(*_moving_dots(*motion))
    p = torch.tensor(params, dtype=torch.float32)
    q = p.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        tcm._contrast(q, xy, t, valid, (W / 2.0, H / 2.0), H, W, SIGMA), q)
    got = _closed_form_grad(p, xy, t, valid)
    if not torch.equal(got, ref):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-7,
                                   atol=1e-7 * float(ref.abs().max()))


@pytest.mark.parametrize("motion", MOTIONS)
def test_cotangent_vjp_matches_jax_grad(motion):
    """The same gradient against jax.grad of the JAX package's _contrast
    (1e-5 relative: its sums run in another order)."""
    xy, t, valid = _moving_dots(*motion)
    params = np.asarray([0.3, 50.0, -20.0], np.float32)
    g_ref = np.asarray(jax.grad(jcm._contrast)(
        jnp.asarray(params), jnp.asarray(xy), jnp.asarray(t), jnp.asarray(valid),
        jnp.ones(len(xy), jnp.float32), jnp.asarray([W / 2.0, H / 2.0], jnp.float32),
        H, W, SIGMA))
    got = _closed_form_grad(torch.from_numpy(params), *_torch(xy, t, valid)).numpy()
    np.testing.assert_allclose(got, g_ref, rtol=1e-5, atol=1e-5 * np.abs(g_ref).max())


# lr 1 takes every step on these motions; lr 40 overshoots, so the ascent
# also rejects steps and halves its step size
@pytest.mark.parametrize("lr", [1.0, 40.0])
@pytest.mark.parametrize("motion", MOTIONS)
def test_ascent_loop_matches_autograd_loop(motion, lr):
    """_ascent_loop against the autograd loop it replaces: the same bits,
    the accept decisions with them."""
    xy, t, valid = _torch(*_moving_dots(*motion))
    z = torch.zeros(3)
    ref = _autograd_loop(xy, t, valid, H, W, z, ITERS, SIGMA, lr)
    trace = torch.zeros(ITERS + 1, 4)
    got = tcm._ascent_loop(xy, t, valid, H, W, z, ITERS, SIGMA, lr, trace=trace)
    for a, b in zip(got, ref):
        assert torch.equal(a, b), (got, ref)
    rejected = int((trace[1:, 3] <= torch.cummax(trace[:, 3], 0).values[:-1]).sum())
    assert (rejected > 0) == (lr > 1.0)


@pytest.mark.parametrize("motion", MOTIONS)
def test_ascent_loop_matches_jax(motion):
    """maximize_rt2d on CPU tensors (_ascent_loop) against the JAX
    maximize_rt2d: params 1e-3, contrast 1e-4."""
    xy, t, valid = _moving_dots(*motion)
    p_ref, c_ref, c0_ref = jcm.maximize_rt2d(
        jnp.asarray(xy), jnp.asarray(t), jnp.asarray(valid), H, W, iters=ITERS)
    p, c, c0 = tcm._ascent_loop(*_torch(xy, t, valid), H, W, torch.zeros(3), ITERS,
                                SIGMA, 1.0)
    p_ref = np.asarray(p_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-3, atol=1e-3 * np.abs(p_ref).max())
    assert float(c) == pytest.approx(float(c_ref), rel=1e-4)
    assert float(c0) == pytest.approx(float(c0_ref), rel=1e-4)


@pytest.mark.parametrize("lr", [1.0, 40.0])
def test_trace_rows(lr):
    """Row 0 is the start and its contrast, row k the k-th trial point and
    its contrast (each the contrast _contrast computes there); the result is
    the last trial whose contrast beat the best before it."""
    xy, t, valid = _torch(*_moving_dots(*MOTIONS[1]))
    p0 = torch.tensor([0.1, -5.0, 3.0])
    trace = torch.full((ITERS + 1, 4), float("nan"))
    p, best, c0 = tcm._ascent_loop(xy, t, valid, H, W, p0, ITERS, SIGMA, lr, trace=trace)
    assert torch.equal(trace[0, :3], p0) and float(trace[0, 3]) == float(c0)
    center = (W / 2.0, H / 2.0)
    for row in trace:
        c = tcm._contrast(row[:3].contiguous(), xy, t, valid, center, H, W, SIGMA)
        assert float(row[3]) == float(c)
    run, last = float(c0), 0
    for k in range(1, ITERS + 1):
        if float(trace[k, 3]) > run:
            run, last = float(trace[k, 3]), k
    assert float(best) == run and torch.equal(p, trace[last, :3])


def test_ascent_loop_nan_event():
    """A NaN coordinate poisons every image: the contrast is NaN, no step
    is taken, and the autograd loop says the same."""
    xy, t, valid = _torch(*_moving_dots(*MOTIONS[0]))
    xy[5, 1] = float("nan")
    p0 = torch.tensor([0.2, 1.0, -1.0])
    p, best, c0 = tcm._ascent_loop(xy, t, valid, H, W, p0, 3, SIGMA, 1.0)
    ref = _autograd_loop(xy, t, valid, H, W, p0, 3, SIGMA, 1.0)
    assert torch.equal(p, p0) and torch.equal(p, ref[0])
    assert torch.isnan(best) and torch.isnan(c0) and torch.isnan(ref[1])


def test_maximize_rt2d_dispatch(monkeypatch):
    """On CPU tensors maximize_rt2d runs _ascent_loop (with contiguous
    copies of strided inputs) and launches nothing; the kernel's wrapper
    refuses CPU tensors."""
    xy, t, valid = _torch(*_moving_dots(*MOTIONS[0]))
    calls = []
    loop = tcm._ascent_loop
    monkeypatch.setattr(tcm, "_ascent_loop",
                        lambda *a, **k: calls.append(a) or loop(*a, **k))
    launches = (hopper_splat.splat.launches, hopper_splat.splat.vjp_launches,
                hopper_splat.splat.ascent_launches)
    got = tcm.maximize_rt2d(xy[::2], t[::2], valid[::2], H, W, iters=3)
    ref = loop(xy[::2].contiguous(), t[::2].contiguous(), valid[::2].contiguous(), H, W,
               torch.zeros(3), 3, SIGMA, 1.0)
    assert len(calls) == 1 and all(a.is_contiguous() for a in calls[0][:3])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert launches == (hopper_splat.splat.launches, hopper_splat.splat.vjp_launches,
                        hopper_splat.splat.ascent_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hopper_splat.splat_ascent_se2(xy, t, valid, torch.zeros(3), (W / 2.0, H / 2.0), H,
                                      W, 3, SIGMA, TRUNC, 1.0)
    with pytest.raises(ValueError, match="trunc < 3.5"):
        hopper_splat.splat_ascent_se2(xy, t, valid, torch.zeros(3), (W / 2.0, H / 2.0), H,
                                      W, 3, SIGMA, 3.5, 1.0)


# every (H, W, N) the repo's event configs give the ascent: 240x180 with
# the L1 window's cm_sample and build_mci's 65,536 slots, masks or f32
# weights; and small and ragged shapes
@pytest.mark.parametrize("H,W,n,mask", [
    (180, 240, 16384, True), (180, 240, 65536, True), (180, 240, 65536, False),
    (180, 240, 12000, True), (180, 240, 0, True), (60, 80, 750, True), (7, 5, 33, False),
])
def test_ascent_layout_fits(H, W, n, mask):
    """Every image row is owned by exactly one block, every event by one
    block, the event arrays stay 16-byte aligned, and a block's shared
    memory stays within the card's 232,448 bytes: a 2,304-byte header, a
    band of three 32-bit limb sums and an f32 value a pixel, 25 bytes per
    warped event and a list of 3,072 entries of 24 bytes. The weight's type (a 1-byte mask or an f32
    weight) no longer changes it: the raw events stay in device memory."""
    lay = hopper_splat.ascent_layout(n, H, W)
    C = hopper_splat.ASCENT_CLUSTER
    owner = np.concatenate([np.full(max(0, min(H - r * lay.rows, lay.rows)), r)
                            for r in range(C)])
    assert owner.tolist() == [h // lay.rows for h in range(H)]
    events = sum(max(0, min(n - r * lay.per_rank, lay.per_rank)) for r in range(C))
    assert events == n and lay.per_rank % 16 == 0
    assert lay.smem_bytes <= hopper_splat.ASCENT_SMEM_MAX == 232_448
    band = -(-lay.rows * W * 12 // 16) * 16 + -(-lay.rows * W * 4 // 16) * 16
    assert lay.smem_bytes == 2304 + band + lay.per_rank * 25 + 3072 * 24


@pytest.mark.parametrize("H,W,n", [(180, 240, 131072), (480, 752, 1), (260, 346, 65536)])
def test_ascent_layout_raises_above_capacity(H, W, n):
    """A shape whose block would need more shared memory than a block may
    use is refused, with the limit in the message."""
    with pytest.raises(ValueError, match="232448"):
        hopper_splat.ascent_layout(n, H, W)


@pytest.mark.parametrize("H,W,n", [(60, 80, 65537), (7, 5, 70000)])
def test_ascent_layout_raises_above_events(H, W, n):
    """More than 65,536 events are refused even where they would fit: a
    pixel takes one tap per event, and the limb sums' range holds 2^16
    taps."""
    with pytest.raises(ValueError, match="65536"):
        hopper_splat.ascent_layout(n, H, W)


# ---- the ascent kernel's fixed-point adds (csrc/splat.cu: add_fix_limbs and
# FixBand::at): a tap v (int64, |v| < 2^48) enters a pixel's three 32-bit
# words as bits 0-15, bits 16-31 and v >> 32 (arithmetic) mod 2^32, with adds
# that return nothing; the pixel's value is W0 + 2^16 W1 + 2^32 W2 mod 2^64.

def _f32_taps(w, g):
    """The kernel's taps: __float2ll_rn(gy * gx * 2^32) with gy = g_row * w
    and gx = g_col, each product rounded to f32."""
    gy = (g[:, 0] * w).astype(np.float32)
    prod = (gy * g[:, 1]).astype(np.float32) * np.float32(2.0**32)
    return np.rint(prod.astype(np.float32).astype(np.float64)).astype(np.int64)


def _limb_words(taps):
    """The three words of one pixel after every tap's adds, as the card's
    32-bit adds leave them; asserts the two low words never wrap."""
    u = taps.view(np.uint64)
    lo = u & np.uint64(0xFFFFFFFF)
    w0 = int((lo & np.uint64(0xFFFF)).astype(object).sum())
    w1 = int((lo >> np.uint64(16)).astype(object).sum())
    w2 = int((u >> np.uint64(32)).astype(object).sum()) % 2**32
    assert w0 < 2**32 and w1 < 2**32, (w0, w1)
    return w0, w1, w2


def _recombined(words) -> int:
    w0, w1, w2 = words
    s = (w0 + (w1 << 16) + (w2 << 32)) % 2**64
    return s - 2**64 if s >= 2**63 else s


_GAUSS_MAX = np.float32(1.0)   # a tap at d = 0 in both directions


@pytest.mark.parametrize("case", [
    "mask, one event", "mask, 65536 events on one pixel", "weights of both signs",
    "weights near +-2^16", "65536 events at the largest weight (wraps)", "cancelling",
])
def test_limb_sums_match_int64(case):
    """The limb model of a pixel's fixed-point sum against np.int64 sums of
    the same taps (which wrap mod 2^64 as the single 64-bit accumulator
    did): the same value in any order of the adds, with negative weights,
    weights next to the 2^16 range limit and a pixel hit by every event of a
    65,536-event window, where the two low words reach their largest sums
    without wrapping."""
    rng = np.random.default_rng(len(case))
    big = np.float32(np.nextafter(np.float32(65536.0), np.float32(0.0)))   # < 2^16
    if case == "mask, one event":
        w = np.ones(1, np.float32)
        g = rng.uniform(0.04, 1.0, (1, 2)).astype(np.float32)
    elif case == "mask, 65536 events on one pixel":
        w = np.ones(65536, np.float32)
        g = rng.uniform(0.04, 1.0, (65536, 2)).astype(np.float32)
        g[:1000] = _GAUSS_MAX                      # taps of exactly 2^32
    elif case == "weights of both signs":
        w = rng.uniform(-300.0, 300.0, 20000).astype(np.float32)
        g = rng.uniform(0.04, 1.0, (20000, 2)).astype(np.float32)
    elif case == "weights near +-2^16":
        w = np.where(rng.random(4096) < 0.5, big, -big).astype(np.float32)
        g = np.full((4096, 2), _GAUSS_MAX, np.float32)
        g[::3] = rng.uniform(0.04, 1.0, (len(g[::3]), 2))
    elif case == "65536 events at the largest weight (wraps)":
        w = np.full(65536, big, np.float32)
        g = np.full((65536, 2), _GAUSS_MAX, np.float32)
    else:
        w = rng.uniform(-2.0, 2.0, 5000).astype(np.float32)
        w = np.concatenate([w, -w])
        g = np.tile(rng.uniform(0.04, 1.0, (5000, 2)).astype(np.float32), (2, 1))
    taps = _f32_taps(w, g)
    assert np.abs(taps).max() < 2**48 + 1
    with np.errstate(over="ignore"):
        ref = int(taps.sum(dtype=np.int64))
    got = _recombined(_limb_words(taps))
    shuffled = _recombined(_limb_words(taps[rng.permutation(len(taps))]))
    assert got == ref == shuffled
    if case == "cancelling":
        assert got == 0
