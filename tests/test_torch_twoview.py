"""The port's two-view initialization and PnP RANSAC against the JAX
package, with the JAX random draws injected: torch cannot reproduce
``jax.random``'s stream, so each test replaces the port's sampling function
(``twoview._sample_minimal_sets``, ``relocalization._draw_hypotheses``) with
one that returns ``np.asarray`` of the JAX sampler's draws for the same key.

The minimal-set fits need one more step. Both packages take the null
vector of the 9x9 normal matrix A^T A in float32, which squares A's
condition number: with camera-normalized coordinates of ~0.5 the eigen-gap
is near f32 resolution, and a last-ulp difference in A^T A moves the fitted
E by 1e-2 (median) to 0.7 (worst) — JAX's own f32 fit differs from a
float64 one by as much. So the hypotheses, and with them RANSAC's winner,
are not reproducible across LAPACK builds. The tests therefore hold:
- with JAX's draws AND JAX's fits injected, everything downstream (scoring,
  H/E selection, decomposition, motion check, triangulation): the same model
  and ``success``, ``Tcw2`` within 1e-4 once the sign of the unit
  translation is fixed, triangulated masks equal on >= 99%, points within
  1e-3 relative to their distance;
- the fits themselves as accurate as JAX's against a float64 fit;
- with only the draws injected, the same model and success, and both
  motions within RANSAC accuracy of the true one.
PnP: the same ``ok``, inlier count within 1%, ``Tcw`` within 1e-4.
Degenerate input yields no exception and no success on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.geometry import twoview as jtv
from eorb_slam_tpu.slam import relocalization as jrl, tracking as jtr
from eorb_slam_tpu_torch.geometry import twoview as ttv
from eorb_slam_tpu_torch.slam import relocalization as trl
from tests.synth import CAM, SynthWorld

TCAM = torch.from_numpy(np.array(CAM))


def _t(x):
    return torch.from_numpy(np.array(x))


def _inject_twoview(monkeypatch, key):
    """The port's sampler returns JAX's draws for the two subkeys that
    reconstruct_two_views splits off ``key`` (E sets, then H sets)."""
    kE, kH = jax.random.split(key)

    def fake(generator, valid, iters, k):
        sub = kE if k == 8 else kH
        idx = jtv._sample_minimal_sets(sub, jnp.asarray(valid.numpy()), iters, k)
        return torch.from_numpy(np.asarray(idx)).long()

    monkeypatch.setattr(ttv, "_sample_minimal_sets", fake)


def _synth_pair(t2, planar=False, seed=0):
    world = SynthWorld(n_landmarks=320, seed=seed, noise_px=0.4)
    if planar:
        world.lm[:, 2] = 7.0 + 0.05 * world.lm[:, 0]
    f1, _ = world.frame(0.0, n_slots=256, n_clutter=30, seed=seed + 1)
    f2, _ = world.frame(t2, n_slots=256, n_clutter=30, seed=seed + 2)
    m12, _ = jtr.match_for_initialization(f1.desc_pm1, f1.valid, f1.xy_ud,
                                          f2.desc_pm1, f2.valid, f2.xy_ud)
    m12 = np.asarray(m12)
    uv1 = np.asarray(f1.xy_ud)
    uv2 = np.asarray(f2.xy_ud)[np.where(m12 >= 0, m12, 0)]
    return uv1, uv2, m12 >= 0


def _sign_fixed(T):
    T = np.array(T)
    s = np.sign(T[np.argmax(np.abs(T[:3, 3])), 3])
    T[:3, 3] *= s
    return T


def _inject_fits(monkeypatch):
    """The port fits each minimal set with the JAX fitter (see module doc:
    the f32 normal-equation eigensolve amplifies last-ulp differences)."""
    for name in ("_fit_E_batch", "_fit_H_batch"):
        jfit = jax.jit(getattr(jtv, name))

        def fake(x1, x2, jfit=jfit):
            out = jfit(jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()))
            return torch.from_numpy(np.array(out))

        monkeypatch.setattr(ttv, name, fake)


def _run_both(uv1, uv2, valid, key):
    ref = jtv.reconstruct_two_views(jnp.asarray(CAM), jnp.asarray(uv1),
                                    jnp.asarray(uv2), jnp.asarray(valid), key,
                                    min_triangulated=50)
    got = ttv.reconstruct_two_views(TCAM, _t(uv1), _t(uv2), _t(valid),
                                    torch.Generator().manual_seed(0),
                                    min_triangulated=50)
    assert bool(got.success) == bool(ref.success) and bool(ref.success)
    assert bool(got.used_homography) == bool(ref.used_homography)
    return got, ref


CASES = [("general", 0.3, 1), ("general", 0.15, 2), ("planar", 0.3, 3)]


@pytest.mark.parametrize("case", CASES)
def test_reconstruct_two_views_matches_jax(monkeypatch, case):
    """Same draws and same fitted hypotheses: scoring, model selection,
    decomposition and the motion check agree to 1e-4."""
    kind, t2, seed = case
    uv1, uv2, valid = _synth_pair(t2, planar=(kind == "planar"), seed=seed)
    assert valid.sum() > 100
    key = jax.random.PRNGKey(seed)
    _inject_twoview(monkeypatch, key)
    _inject_fits(monkeypatch)
    got, ref = _run_both(uv1, uv2, valid, key)
    if kind == "planar":
        assert bool(ref.used_homography)
    np.testing.assert_allclose(_sign_fixed(got.Tcw2.numpy()),
                               _sign_fixed(np.asarray(ref.Tcw2)), atol=1e-4)
    tri_g, tri_r = got.is_triangulated.numpy(), np.asarray(ref.is_triangulated)
    assert (tri_g == tri_r).mean() >= 0.99
    assert abs(int(got.n_good) - int(ref.n_good)) <= 0.01 * len(valid)
    both = tri_g & tri_r
    pg, pr = got.pts3d.numpy()[both], np.asarray(ref.pts3d)[both]
    if np.sign(got.Tcw2.numpy()[0, 3]) == np.sign(np.asarray(ref.Tcw2)[0, 3]):
        dist = np.linalg.norm(pr, axis=1, keepdims=True)
        np.testing.assert_allclose(pg / dist, pr / dist, atol=1e-3)


@pytest.mark.parametrize("case", CASES)
def test_reconstruct_two_views_own_fits(monkeypatch, case):
    """Same draws, each package fitting its own hypotheses: the same model
    and success, and both motions as close to the true one as RANSAC gets
    here — rotation within 1e-2 rad, unit translation within 0.1 (the
    winning hypothesis may differ, see module doc)."""
    kind, t2, seed = case
    uv1, uv2, valid = _synth_pair(t2, planar=(kind == "planar"), seed=seed)
    key = jax.random.PRNGKey(seed)
    _inject_twoview(monkeypatch, key)
    got, ref = _run_both(uv1, uv2, valid, key)
    world = SynthWorld(n_landmarks=320, seed=seed)
    T_gt = world.pose(t2) @ np.linalg.inv(world.pose(0.0))
    t_gt = T_gt[:3, 3] / np.linalg.norm(T_gt[:3, 3])
    for T in (got.Tcw2.numpy(), np.asarray(ref.Tcw2)):
        cos = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
        assert np.arccos(np.clip(cos, -1, 1)) < 1e-2
        assert np.abs(T[:3, 3] * np.sign(T[:3, 3] @ t_gt) - t_gt).max() < 0.1


def _fit_error(fit, x1, x2, exact):
    """Distance (up to sign, unit Frobenius norm) of each fitted model from
    the float64 fit of the same minimal set."""
    got = np.asarray(fit(x1, x2), np.float64)
    got = got / np.linalg.norm(got, axis=(1, 2), keepdims=True)
    return np.minimum(np.abs(got - exact).max((1, 2)), np.abs(got + exact).max((1, 2)))


def test_fit_batches_as_accurate_as_jax():
    """On SynthWorld minimal sets (JAX's draws) each package's f32 fit is as
    far from the float64 fit as the other's: median and 90th-percentile
    errors within 2x of JAX's (plus 1e-5)."""
    uv1, uv2, valid = _synth_pair(0.3, seed=1)
    kE, kH = jax.random.split(jax.random.PRNGKey(1))
    x1 = np.asarray(jtv._normalize(jnp.asarray(CAM), jnp.asarray(uv1)))
    x2 = np.asarray(jtv._normalize(jnp.asarray(CAM), jnp.asarray(uv2)))
    for name, key, k in (("_fit_E_batch", kE, 8), ("_fit_H_batch", kH, 4)):
        idx = np.asarray(jtv._sample_minimal_sets(key, jnp.asarray(valid), 200, k))
        a, b = x1[idx], x2[idx]
        exact = ttv.__dict__[name](_t(a).double(), _t(b).double()).numpy()
        exact = exact / np.linalg.norm(exact, axis=(1, 2), keepdims=True)
        e_jax = _fit_error(lambda p, q: getattr(jtv, name)(jnp.asarray(p), jnp.asarray(q)),
                           a, b, exact)
        e_port = _fit_error(lambda p, q: getattr(ttv, name)(_t(p), _t(q)).numpy(),
                            a, b, exact)
        for q in (50, 90):
            assert np.percentile(e_port, q) <= 2 * np.percentile(e_jax, q) + 1e-5, (
                name, q, np.percentile(e_port, q), np.percentile(e_jax, q))


def test_reconstruct_two_views_degenerate_does_not_raise():
    """Three valid correspondences, all at one pixel: every minimal set
    repeats points, homographies are singular. No success, no exception."""
    uv = np.zeros((64, 2), np.float32) + 100.0
    valid = np.zeros(64, bool)
    valid[:3] = True
    got = ttv.reconstruct_two_views(TCAM, _t(uv), _t(uv), _t(valid),
                                    torch.Generator().manual_seed(0), iters=50)
    ref = jtv.reconstruct_two_views(jnp.asarray(CAM), jnp.asarray(uv),
                                    jnp.asarray(uv), jnp.asarray(valid),
                                    jax.random.PRNGKey(0), iters=50)
    assert not bool(got.success) and not bool(ref.success)


def _pnp_scene(seed=0, n=200, outliers=0.3):
    rng = np.random.default_rng(seed)
    world = SynthWorld(n_landmarks=n, seed=seed)
    T = world.pose(0.4)
    pc = world.lm @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2],
                   CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(0, 700, (bad.sum(), 2))
    valid = (pc[:, 2] > 0.5) & (rng.random(n) > 0.1)
    return world.lm.astype(np.float32), uv.astype(np.float32), valid, T


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_matches_jax(monkeypatch, seed):
    pts, uv, valid, T_gt = _pnp_scene(seed)
    key = jax.random.PRNGKey(10 + seed)
    # what jrl.pnp_ransac hands jax.random.choice
    probs = jnp.asarray(valid).astype(jnp.float32) / jnp.maximum(valid.sum(), 1)
    n_hyp = 256

    def fake(generator, probs_t, n, k):
        np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs), rtol=1e-6)
        idx = jax.random.choice(key, len(pts), (n, k), replace=True, p=probs)
        return torch.from_numpy(np.asarray(idx)).long()

    monkeypatch.setattr(trl, "_draw_hypotheses", fake)
    ref = jrl.pnp_ransac(jnp.asarray(CAM), jnp.asarray(pts), jnp.asarray(uv),
                         jnp.asarray(valid), key, n_hyp=n_hyp)
    got = trl.pnp_ransac(TCAM, _t(pts), _t(uv), _t(valid),
                         torch.Generator().manual_seed(0), n_hyp=n_hyp)
    assert bool(got.ok) == bool(ref.ok) and bool(ref.ok)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 0.01 * len(pts)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
    assert np.abs(got.Tcw.numpy()[:3, 3] - T_gt[:3, 3]).max() < 0.05


def test_pnp_ransac_own_draws_and_no_valid():
    pts, uv, valid, T_gt = _pnp_scene(2)
    got = trl.pnp_ransac(TCAM, _t(pts), _t(uv), _t(valid),
                         torch.Generator().manual_seed(3))
    assert bool(got.ok)
    assert np.abs(got.Tcw.numpy()[:3, 3] - T_gt[:3, 3]).max() < 0.05
    none = trl.pnp_ransac(TCAM, _t(pts), _t(uv), _t(np.zeros_like(valid)),
                          torch.Generator().manual_seed(3))
    assert not bool(none.ok) and int(none.n_inliers) == 0
