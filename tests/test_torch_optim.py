"""The port's optimizer core and triangulation against the JAX package on
the same seeded numpy inputs.

Tolerances: robust kernels 1e-6 relative (same f32 formulas); pose-only GN
``Tcw`` within 1e-4 with equal inlier masks (40 f32 GN steps, sums in
another order); the Cholesky solve NaN on both sides for a matrix that is
not positive definite; Schur BA ``kf_T``, ``lm_pos`` and both costs within
rel 1e-3 of their scale, fixed poses bit-exact; DLT triangulation within
1e-4 relative to the point's distance (a 4x4 eigensolve in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.geometry import triangulation as jtri
from eorb_slam_tpu.optim import linalg as jlinalg, pose_only as jpo
from eorb_slam_tpu.optim import robust as jrob, schur_ba as jba
from eorb_slam_tpu_torch.geometry import triangulation as ttri
from eorb_slam_tpu_torch.optim import linalg as tlinalg, pose_only as tpo
from eorb_slam_tpu_torch.optim import robust as trob, schur_ba as tba

CAM = np.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _so3(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3)
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _pose(rot, trans):
    T = np.eye(4)
    T[:3, :3] = _so3(rot)
    T[:3, 3] = trans
    return T


def make_scene(K=6, M=64, noise_px=0.5, seed=3):
    """Landmarks in front of K cameras on a line, their noisy projections
    (M,K,2), float32 — the shape of tests/test_optim.py's scene."""
    rng = np.random.default_rng(seed)
    lm = np.concatenate([rng.uniform(-2, 2, (M, 2)), rng.uniform(4, 8, (M, 1))], 1)
    Ts = []
    for k in range(K):
        R = _so3([0.0, 0.02 * k, 0.0])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ np.array([0.4 * k, 0.05 * np.sin(k), 0.0])
        Ts.append(T)
    Ts = np.stack(Ts)
    pc = np.einsum("kij,mj->mki", Ts[:, :3, :3], lm) + Ts[None, :, :3, 3]
    uv = np.stack([CAM[0] * pc[..., 0] / pc[..., 2] + CAM[2],
                   CAM[1] * pc[..., 1] / pc[..., 2] + CAM[3]], -1)
    uv += rng.normal(0, noise_px, uv.shape)
    return lm.astype(np.float32), Ts.astype(np.float32), uv.astype(np.float32)


@pytest.mark.parametrize("fn", ["huber_weight", "huber_cost"])
def test_robust_kernels(fn):
    chi2 = np.random.default_rng(0).gamma(1.0, 4.0, 500).astype(np.float32)
    chi2[:3] = [0.0, trob.CHI2_MONO, 1e-14]
    ref = np.asarray(getattr(jrob, fn)(jnp.asarray(chi2), jrob.CHI2_MONO))
    got = getattr(trob, fn)(_t(chi2), trob.CHI2_MONO).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_solve_spd_jacobi_matches_and_nan_when_not_pd():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = (A @ A.T + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    ref = np.asarray(jlinalg.solve_spd_jacobi(jnp.asarray(H), jnp.asarray(b)))
    got = tlinalg.solve_spd_jacobi(_t(H), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    bad = H.copy()
    bad[2, 2] = -bad[2, 2]          # indefinite
    ref = np.asarray(jlinalg.solve_spd_jacobi(jnp.asarray(bad), jnp.asarray(b)))
    got = tlinalg.solve_spd_jacobi(_t(bad), _t(b)).numpy()
    assert np.isnan(ref).all() and np.isnan(got).all()


@pytest.mark.parametrize("case", ["perturbed", "outliers", "half_valid", "none_valid"])
def test_pose_optimization_matches_jax(case):
    lm, Ts, obs = make_scene()
    T0 = Ts[3].copy()
    uv = obs[:, 3].copy()
    valid = np.ones(len(lm), bool)
    inv_sigma = np.ones(len(lm), np.float32)
    if case == "perturbed":
        T0 = (_pose([0.02, 0.03, -0.01], [0.1, -0.08, 0.05]) @ T0).astype(np.float32)
    elif case == "outliers":
        uv[:10] += 40.0
        inv_sigma[::3] = 1.0 / 1.2
    elif case == "half_valid":
        valid[::2] = False
        uv[::2] = 1e6
    else:
        valid[:] = False
    ref = jpo.pose_optimization(jnp.asarray(CAM), jnp.asarray(T0), jnp.asarray(lm),
                                jnp.asarray(uv), jnp.asarray(inv_sigma),
                                jnp.asarray(valid))
    got = tpo.pose_optimization(_t(CAM), _t(T0), _t(lm), _t(uv), _t(inv_sigma),
                                _t(valid))
    T_ref, inl_ref, n_ref = (np.asarray(x) for x in ref)
    T_got, inl_got, n_got = (x.numpy() for x in got)
    assert np.isfinite(T_got).all()
    np.testing.assert_allclose(T_got, T_ref, atol=1e-4)
    np.testing.assert_array_equal(inl_got, inl_ref)
    assert int(n_got) == int(n_ref)
    if case == "none_valid":
        np.testing.assert_allclose(T_got, T0, atol=1e-6)   # pose unchanged
        assert int(n_got) == 0


def _ba_problem(K=8, M=128, P=4, seed=5):
    """K=8 poses, M=128 landmarks, P=4 observations each (of 4 of the 8
    poses), perturbed start, two fixed poses, some invalid slots."""
    lm, Ts, obs = make_scene(K=K, M=M, noise_px=0.5, seed=seed)
    rng = np.random.default_rng(seed + 1)
    obs_kf = np.stack([np.sort(rng.choice(K, P, replace=False)) for _ in range(M)])
    obs_uv = np.take_along_axis(obs, obs_kf[:, :, None], axis=1)
    obs_valid = rng.random((M, P)) > 0.05
    Ts0 = Ts.copy()
    for k in range(2, K):
        Ts0[k] = _pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.02, 3)) @ Ts0[k]
    lm0 = lm + rng.normal(0, 0.05, lm.shape)
    lm_valid = np.ones(M, bool)
    lm_valid[-3:] = False
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    octs = rng.integers(0, 3, (M, P))
    return dict(
        cam_params=CAM, kf_T=Ts0.astype(np.float32), kf_fixed=fixed,
        kf_valid=np.ones(K, bool), lm_pos=lm0.astype(np.float32),
        lm_valid=lm_valid, obs_kf=obs_kf.astype(np.int32), obs_uv=obs_uv,
        obs_inv_sigma=(1.2 ** -octs).astype(np.float32), obs_valid=obs_valid,
    )


@pytest.mark.parametrize("iters", [1, 10])
def test_bundle_adjust_matches_jax(iters):
    p = _ba_problem()
    ref = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
                            iters=iters)
    got = tba.bundle_adjust(tba.BAProblem(**{k: _t(v) for k, v in p.items()}),
                            iters=iters)
    kf_ref, lm_ref = np.asarray(ref.kf_T), np.asarray(ref.lm_pos)
    kf_got, lm_got = got.kf_T.numpy(), got.lm_pos.numpy()
    assert float(ref.cost) < float(ref.cost0)
    # fixed poses: only the rotation re-projection of the accepted steps
    # touches them, identically on both sides
    np.testing.assert_array_equal(kf_got[:2], kf_ref[:2])
    np.testing.assert_allclose(kf_got[:2], p["kf_T"][:2], atol=1e-6)
    np.testing.assert_allclose(kf_got, kf_ref, rtol=0, atol=1e-3 * np.abs(kf_ref).max())
    np.testing.assert_allclose(lm_got, lm_ref, rtol=0, atol=1e-3 * np.abs(lm_ref).max())
    for a, b in ((got.cost0, ref.cost0), (got.cost, ref.cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3)
    assert (got.obs_inlier.numpy() != np.asarray(ref.obs_inlier)).mean() <= 0.01


def test_bundle_adjust_empty_problem():
    p = _ba_problem(K=4, M=32)
    p["obs_valid"] = np.zeros_like(p["obs_valid"])
    got = tba.bundle_adjust(tba.BAProblem(**{k: _t(v) for k, v in p.items()}), iters=3)
    assert np.isfinite(got.kf_T.numpy()).all()
    assert float(got.cost) == 0.0


def test_schur_pieces_match_jax():
    p = _ba_problem()
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tba.BAProblem(**{k: _t(v) for k, v in p.items()})
    for huber in (True, False):
        ref = jba._schur_pieces(jp, jp.kf_T, jp.lm_pos, jnp.float32(3e-4),
                                jnp.asarray(huber))
        got = tba._schur_pieces(tp, tp.kf_T, tp.lm_pos, torch.tensor(3e-4), huber)
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert g.shape == r.shape
            scale = max(float(np.abs(r).max()), 1.0)
            assert np.abs(g.numpy() - r).max() <= 1e-5 * scale


def test_triangulate_dlt_and_checks_match_jax():
    lm, Ts, obs = make_scene(K=3, M=200, noise_px=0.3, seed=9)
    T1, T2 = Ts[0], Ts[2]
    kinv = np.array([1 / CAM[0], 1 / CAM[1]], np.float32)
    ray1 = np.concatenate([(obs[:, 0] - CAM[2:4]) * kinv, np.ones((200, 1))], 1)
    ray2 = np.concatenate([(obs[:, 2] - CAM[2:4]) * kinv, np.ones((200, 1))], 1)
    ray1, ray2 = ray1.astype(np.float32), ray2.astype(np.float32)
    ref = np.asarray(jtri.triangulate_dlt(jnp.asarray(T1)[None], jnp.asarray(T2)[None],
                                          jnp.asarray(ray1), jnp.asarray(ray2)))
    got = ttri.triangulate_dlt(_t(T1)[None], _t(T2)[None], _t(ray1), _t(ray2)).numpy()
    dist = np.linalg.norm(ref, axis=1, keepdims=True)
    np.testing.assert_allclose(got / dist, ref / dist, atol=1e-4)
    ok_ref, cos_ref = jtri.triangulation_checks(
        jnp.asarray(T1)[None], jnp.asarray(T2)[None], jnp.asarray(ray1),
        jnp.asarray(ray2), jnp.asarray(ref), inv_sigma1=458.0, inv_sigma2=458.0)
    ok_got, cos_got = ttri.triangulation_checks(
        _t(T1)[None], _t(T2)[None], _t(ray1), _t(ray2), _t(ref),
        inv_sigma1=458.0, inv_sigma2=458.0)
    np.testing.assert_array_equal(ok_got.numpy(), np.asarray(ok_ref))
    np.testing.assert_allclose(cos_got.numpy(), np.asarray(cos_ref), rtol=1e-6)
