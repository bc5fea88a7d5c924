"""The port's Schur tools and the marginalized pose-IMU prior
(``optim/marginalize``) against the JAX package on the same seeded inputs:
``marginalize`` / ``condition`` / ``sparsify`` (including a rank-deficient
block through the pseudo-inverse), ``prior_residual`` and
``pose_inertial_optimization_last_frame`` over a chain of two frames, each
frame's prior the previous one's output.

Tolerances (float32 on both sides): the Schur tools 1e-4 of the largest
entry; the prior residual 1e-5; the last-frame optimization Tcw 1e-4,
velocities and biases 1e-4, the same inliers, and the chained prior's
information 1e-3 of its largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.geometry import camera as jcam, lie as jlie
from eorb_slam_tpu.imu import preintegration as jpre
from eorb_slam_tpu.optim import marginalize as jmarg
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.optim import marginalize as tmarg
from tests.test_imu import CALIB, imu_samples, state


def T(x):
    return torch.from_numpy(np.array(x))


def _rand_psd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n + 3, n))
    return (A.T @ A).astype(np.float32)


def _close(a, b, rel=1e-4):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, atol=rel * max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("n,start,end", [(9, 3, 5), (30, 0, 14), (12, 6, 11)])
def test_marginalize_matches_jax(n, start, end):
    H = _rand_psd(n, n)
    _close(tmarg.marginalize(T(H), start, end), jmarg.marginalize(jnp.asarray(H), start, end))


def test_marginalize_singular_block_uses_pinv():
    H = _rand_psd(6, 2)
    H[4:6, :] = 0.0
    H[:, 4:6] = 0.0
    got = tmarg.marginalize(T(H), 3, 5)
    assert torch.isfinite(got).all()
    _close(got, jmarg.marginalize(jnp.asarray(H), 3, 5))


def test_condition_and_sparsify_match_jax():
    H = _rand_psd(9, 4)
    _close(tmarg.condition(T(H), 2, 4), jmarg.condition(jnp.asarray(H), 2, 4))
    _close(tmarg.sparsify(T(H), 0, 2, 3, 5), jmarg.sparsify(jnp.asarray(H), 0, 2, 3, 5))


def test_prior_residual_matches_jax():
    rng = np.random.default_rng(1)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
    T1 = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32))) @ T0
    v, bg, ba = (rng.normal(0, s, 3).astype(np.float32) for s in (0.5, 0.01, 0.05))
    H = _rand_psd(15, 9)
    H[:, 12:] = H[12:, :] = 0.0                     # rank-deficient information
    pj = jmarg.PoseImuPrior(*(jnp.asarray(x) for x in (T0, v, bg, ba, H)))
    pt = convert.prior_from_numpy(pj)
    args = (T1, v + 0.1, bg - 0.01, ba + 0.02)
    _close(tmarg.prior_residual(pt, *(T(a) for a in args)),
           jmarg.prior_residual(pj, *(jnp.asarray(a) for a in args)), 1e-5)
    ident = tmarg.identity_prior(T(T0), T(v), T(bg), T(ba))
    assert float(torch.linalg.norm(tmarg.prior_residual(ident, T(T0), T(v), T(bg), T(ba)))) < 1e-5


def test_last_frame_optimization_prior_chain_matches_jax():
    """Two consecutive frames through PoseInertialOptimizationLastFrame, the
    second one's prior the first one's marginal (tests/test_marginalize.py's
    chain), both packages fed the same perturbed starts and observations."""
    rng = np.random.default_rng(7)
    cam = jcam.make_pinhole(458.0, 457.0, 376.0, 240.0)
    Tbc = np.eye(4, dtype=np.float32)

    def tcw_vel(t):
        R, p, v = state(t)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3], M[:3, 3] = R, p
        return np.asarray(jpre.Tcw_from_Twb(jnp.asarray(M), jnp.asarray(Tbc))), v

    N = 128
    lm = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(5, 10, (N, 1))],
                        axis=1).astype(np.float32)

    def obs(Tcw):
        pc = lm @ Tcw[:3, :3].T + Tcw[:3, 3]
        uv = np.stack([458.0 * pc[:, 0] / pc[:, 2] + 376.0,
                       457.0 * pc[:, 1] / pc[:, 2] + 240.0], 1)
        uv = uv + rng.normal(0, 0.4, (N, 2))
        uv[:5] += 30.0                                   # outliers
        return uv.astype(np.float32)

    t0, t1, t2 = 0.5, 0.75, 1.0
    Tcw0, v0 = tcw_vel(t0)
    prior_j = jmarg.identity_prior(jnp.asarray(Tcw0), jnp.asarray(v0, jnp.float32),
                                   jnp.zeros(3), jnp.zeros(3), weight=1e4)
    prior_t = convert.prior_from_numpy(prior_j)
    cam_t = T(np.asarray(cam))
    for ta, tb in [(t0, t1), (t1, t2)]:
        Tcw_gt, v_gt = tcw_vel(tb)
        pre_j = jpre.integrate(*imu_samples(ta, tb), jnp.zeros(3), jnp.zeros(3), CALIB)
        xi = np.float32([0.02, -0.03, 0.01, 0.02, -0.02, 0.03])
        Tcw_init = np.asarray(jlie.se3_exp(jnp.asarray(xi))) @ Tcw_gt
        vel_init = (v_gt + rng.normal(0, 0.1, 3)).astype(np.float32)
        uv = obs(Tcw_gt)
        args = (Tcw_init, vel_init, np.zeros(3, np.float32), np.zeros(3, np.float32),
                lm, uv, np.ones(N, np.float32), np.ones(N, bool))
        oj = jmarg.pose_inertial_optimization_last_frame(
            cam, *(jnp.asarray(a) for a in args), prior_j, pre_j, jnp.asarray(Tbc))
        ot = tmarg.pose_inertial_optimization_last_frame(
            cam_t, *(T(a) for a in args), prior_t, convert.pre_from_numpy(pre_j), T(Tbc))
        np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-4)
        for k in (1, 2, 3):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-4)
        np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))
        assert int(ot[5]) == int(oj[5]) > 100
        Hj = np.asarray(oj[6].H)
        np.testing.assert_allclose(ot[6].H.numpy(), Hj, atol=1e-3 * np.abs(Hj).max())
        # the JAX test's own bar, on the port
        assert np.linalg.norm(ot[0].numpy()[:3, 3] - Tcw_gt[:3, 3]) < 0.02
        prior_j, prior_t = oj[6], ot[6]
    w = torch.linalg.eigvalsh(prior_t.H.double())
    assert float(w.min()) > -1e-2 * float(w.max())
    np.testing.assert_array_equal(prior_t.Tcw.numpy(), ot[0].numpy())
