"""Parity of the port's Lie-group math and pinhole camera with the JAX
package, on random, near-identity and near-pi inputs (tolerance 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.geometry import camera as jcam
from eorb_slam_tpu.geometry import lie as jlie
from eorb_slam_tpu_torch.geometry import camera as tcam
from eorb_slam_tpu_torch.geometry import lie as tlie

TOL = dict(rtol=1e-5, atol=1e-5)


def _rotvecs(regime, n=64, seed=0):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if regime == "random":
        ang = rng.uniform(0.0, 2.5, n)
    elif regime == "identity":
        ang = 10.0 ** rng.uniform(-8, -4, n)
    else:  # near pi
        ang = np.pi - 10.0 ** rng.uniform(-3, -1.5, n)
    return (axis * ang[:, None]).astype(np.float32)


def _both(fn_name, *args):
    """Run lie.<fn_name> of both packages on the same numpy args."""
    ref = getattr(jlie, fn_name)(*[jnp.asarray(a) for a in args])
    got = getattr(tlie, fn_name)(*[torch.from_numpy(np.asarray(a)) for a in args])
    return ref, got


def _close(ref, got, **tol):
    if isinstance(ref, tuple):
        for r, g in zip(ref, got):
            _close(r, g, **tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


REGIMES = ["random", "identity", "near_pi"]


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("fn", ["hat", "so3_exp", "so3_right_jacobian",
                                "so3_right_jacobian_inv"])
def test_so3_from_rotvec(fn, regime):
    phi = _rotvecs(regime)
    tol = {}
    if fn == "so3_right_jacobian_inv" and regime == "near_pi":
        # (1+cos)/(2 theta sin) cancels catastrophically in f32 near pi;
        # the two libraries' cos differ by an ulp there
        tol = dict(rtol=1e-4, atol=1e-4)
    _close(*_both(fn, phi), **tol)


@pytest.mark.parametrize("regime", REGIMES)
def test_rotation_roundtrips(regime):
    phi = _rotvecs(regime, seed=1)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    _close(*_both("vee", np.asarray(jlie.hat(jnp.asarray(phi)))))
    _close(*_both("quat_from_mat", R))
    _close(*_both("so3_log", R))
    _close(*_both("project_so3", R))
    q = np.asarray(jlie.quat_from_mat(jnp.asarray(R)))
    _close(*_both("quat_to_mat", q))
    _close(*_both("quat_log", q))
    _close(*_both("quat_conj", q))


@pytest.mark.parametrize("regime", REGIMES)
def test_quaternion_products_and_slerp(regime):
    rng = np.random.default_rng(2)
    q0 = np.asarray(jlie.quat_from_mat(jlie.so3_exp(jnp.asarray(_rotvecs(regime, seed=2)))))
    q1 = np.asarray(jlie.quat_from_mat(jlie.so3_exp(jnp.asarray(_rotvecs(regime, seed=3)))))
    _close(*_both("quat_mul", q0, q1))
    t = rng.uniform(0, 1, (len(q0), 1)).astype(np.float32)
    _close(*_both("quat_slerp", q0, q1, t))
    _close(*_both("quat_slerp", q0, q0, t))     # identical ends: small branch


def _se3s(regime, seed):
    rng = np.random.default_rng(seed)
    phi = _rotvecs(regime, seed=seed)
    rho = rng.normal(0, 1.0, phi.shape).astype(np.float32)
    return np.concatenate([rho, phi], axis=1)


@pytest.mark.parametrize("regime", REGIMES)
def test_se3(regime):
    xi = _se3s(regime, 4)
    _close(*_both("se3_exp", xi))
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    T2 = np.asarray(jlie.se3_exp(jnp.asarray(_se3s(regime, 5))))
    _close(*_both("se3_log", T))
    _close(*_both("se3_inv", T))
    _close(*_both("se3_mul", T, T2))
    _close(*_both("se3_project", T))
    _close(*_both("se3_rot", T))
    _close(*_both("se3_trans", T))
    _close(*_both("se3", T[:, :3, :3], T[:, :3, 3]))
    p = np.random.default_rng(6).normal(size=(len(T), 3)).astype(np.float32)
    _close(*_both("se3_apply", T, p))
    alpha = np.random.default_rng(7).uniform(0, 1, len(T)).astype(np.float32)
    ref = jlie.interpolate_se3(jnp.asarray(T[0]), jnp.asarray(T2[0]), jnp.asarray(alpha))
    got = tlie.interpolate_se3(torch.from_numpy(T[0]), torch.from_numpy(T2[0]),
                               torch.from_numpy(alpha))
    _close(ref, got)
    np.testing.assert_array_equal(tlie.se3_identity((2,)).numpy(),
                                  np.asarray(jlie.se3_identity((2,))))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("sig", ["zero", "small", "large"])
def test_sim3(regime, sig):
    xi6 = _se3s(regime, 8)
    rng = np.random.default_rng(9)
    sigma = {"zero": np.zeros(len(xi6)),
             "small": 10.0 ** rng.uniform(-8, -6, len(xi6)),
             "large": rng.uniform(-0.7, 0.7, len(xi6))}[sig]
    xi = np.concatenate([xi6, sigma[:, None]], axis=1).astype(np.float32)
    _close(*_both("sim3_exp", xi))
    R, t, s = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi)))
    p = rng.normal(size=t.shape).astype(np.float32)
    _close(*_both("sim3_apply", R, t, s, p))
    _close(*_both("sim3_inv", R, t, s))
    _close(*_both("sim3_mul", R, t, s, R[::-1].copy(), t[::-1].copy(), s[::-1].copy()))


CAMS = {
    "linear": [199.0, 199.0, 120.0, 90.0],
    "distorted": [199.0, 197.0, 121.0, 89.0, -0.2, 0.05, 1e-3, -2e-3, 0.01],
}


@pytest.mark.parametrize("name", list(CAMS))
def test_pinhole(name):
    jp = jcam.make_pinhole(*CAMS[name])
    tp = tcam.make_pinhole(*CAMS[name])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _close(jcam.K_matrix(jp), tcam.K_matrix(tp))
    rng = np.random.default_rng(10)
    pts = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-0.8, 0.8, 200),
                    rng.uniform(0.5, 5.0, 200)], 1).astype(np.float32)
    pts[0, 2] = 0.0      # z = 0 hits the 1e-9 guard
    uv = np.stack([rng.uniform(0, 240, 200), rng.uniform(0, 180, 200)], 1).astype(np.float32)
    jt_, tt_ = jnp.asarray(pts), torch.from_numpy(pts)
    ju, tu = jnp.asarray(uv), torch.from_numpy(uv)
    _close(jcam.pinhole_project_linear(jp, jt_), tcam.pinhole_project_linear(tp, tt_))
    _close(jcam.pinhole_project(jp, jt_), tcam.pinhole_project(tp, tt_))
    _close(jcam.pinhole_project_jac_point(jp, jt_), tcam.pinhole_project_jac_point(tp, tt_))
    _close(jcam.pinhole_unproject_linear(jp, ju), tcam.pinhole_unproject_linear(tp, tu))
    _close(jcam.pinhole_unproject(jp, ju), tcam.pinhole_unproject(tp, tu))
    _close(jcam.undistort_points(jp, ju), tcam.undistort_points(tp, tu), rtol=1e-5, atol=1e-4)
    xyn = jt_[:, :2] / 5.0
    _close(jcam.pinhole_distort_normalized(jp, xyn),
           tcam.pinhole_distort_normalized(tp, tt_[:, :2] / 5.0))
