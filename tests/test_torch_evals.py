"""The port's trajectory metrics (numpy on both sides) against the JAX
package's on the same seeded trajectories: ATE, RPE, piecewise APE and the
KITTI odometry errors agree to 1e-9 (same arithmetic, same order)."""

import numpy as np
import pytest

from eorb_slam_tpu.evals import ate as jate, kitti_odom as jko, rpe as jrpe
from eorb_slam_tpu_torch.evals import ate as tate, kitti_odom as tko, rpe as trpe

TOL = 1e-9


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    K = K / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _traj(n, seed, step=0.4, noise=0.0, scale=1.0, ts_jump=None):
    """(gt, est) as [(ts, Twc)] lists: a smooth path and a noisy, scaled,
    rigidly moved copy of it."""
    rng = np.random.default_rng(seed)
    gt, est = [], []
    Tg = np.eye(4)
    A = np.eye(4)
    A[:3, :3] = _rot(rng.normal(0, 0.5, 3))
    A[:3, 3] = rng.normal(0, 2.0, 3)
    t = 0.0
    for i in range(n):
        d = np.eye(4)
        d[:3, :3] = _rot(rng.normal(0, 0.03, 3))
        d[:3, 3] = [step * 0.1 * rng.normal(), step * 0.1 * rng.normal(), step]
        Tg = Tg @ d
        t += 0.05 if ts_jump is None or i != ts_jump else 3.0
        Te = A @ Tg
        Te[:3, 3] *= scale
        Te[:3, 3] += rng.normal(0, noise, 3)
        Te[:3, :3] = Te[:3, :3] @ _rot(rng.normal(0, noise * 0.1, 3))
        gt.append((t, Tg.copy()))
        est.append((t + 1e-4 * rng.uniform(), Te))
    return gt, est


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(0, 10, 80))
    b = np.sort(np.concatenate([a[::2] + rng.normal(0, 0.01, 40),
                                rng.uniform(0, 10, 30)]))
    for x, y in zip(tate.associate(a, b, 0.02), jate.associate(a, b, 0.02)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_matches_jax(with_scale):
    rng = np.random.default_rng(3)
    src = rng.normal(0, 1, (40, 3))
    dst = 1.7 * src @ _rot(np.array([0.3, -0.2, 0.5])).T + [1, 2, 3] \
        + rng.normal(0, 0.01, (40, 3))
    _close(tate.umeyama_align(src, dst, with_scale),
           jate.umeyama_align(src, dst, with_scale))


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_ate_rmse_matches_jax(seed, with_scale):
    gt, est = _traj(60, seed, noise=0.02, scale=1.3)
    rt = tate.ate_rmse(est, gt, with_scale=with_scale)
    rj = jate.ate_rmse(est, gt, with_scale=with_scale)
    _close(rt, rj)
    assert rt[1] == 60 and np.isfinite(rt[0])


@pytest.mark.parametrize("kw", [dict(delta=1, scale_norm=True),
                                dict(delta=5, scale_norm=False)])
def test_rpe_matches_jax(kw):
    gt, est = _traj(50, 4, noise=0.01, scale=0.8)
    _close(trpe.rpe(est, gt, **kw), jrpe.rpe(est, gt, **kw))


def test_piecewise_ape_matches_jax():
    gt, est = _traj(70, 5, noise=0.01, scale=2.0, ts_jump=35)
    rt = trpe.ate_piecewise(est, gt, with_scale=True)
    rj = jrpe.ate_piecewise(est, gt, with_scale=True)
    _close({k: v for k, v in rt.items() if k != "pieces"},
           {k: v for k, v in rj.items() if k != "pieces"})
    assert len(rt["pieces"]) == len(rj["pieces"]) >= 2
    pt, pj = trpe.break_pieces(est), jrpe.break_pieces(est)
    assert [[t for t, _ in p] for p in pt] == [[t for t, _ in p] for p in pj]


def test_kitti_odom_matches_jax(tmp_path):
    gt, est = _traj(400, 6, step=0.6, noise=0.01)
    Pg = np.stack([T for _, T in gt])
    Pe = np.stack([T for _, T in est])
    rt, rj = tko.kitti_odom_eval(Pg, Pe), jko.kitti_odom_eval(Pg, Pe)
    _close(rt, rj)
    assert rt["n_subseq"] > 0
    _close(tko.trajectory_distances(Pg), jko.trajectory_distances(Pg))
    path = tmp_path / "00.txt"
    np.savetxt(path, Pg[:, :3, :].reshape(len(Pg), 12))
    _close(tko.load_kitti_poses(str(path)), jko.load_kitti_poses(str(path)))
