"""The port's IMU stack against the JAX package on the same seeded inputs:
preintegration (``imu/preintegration``), the inertial residuals and the
inertial-only initialization (``optim/inertial``), and visual-inertial BA
and the motion-only VI pose optimization (``optim/vi_ba``).

Fixtures are the JAX package's own (tests/test_imu.py): ideal IMU samples on
an analytic trajectory, keyframe preintegration stacks, and the VI-BA
problem. Tolerances, float32 on both sides:
- preintegration and merge: 1e-5 abs (one f32 product order apart);
- Jacobians against ``jax.jacfwd`` at the same point: 1e-4 of the largest
  entry;
- inertial_init and linear_alignment: scale rel 1e-4, gravity 1e-4 rad,
  gyro bias 1e-5 abs, acc bias 5e-4 abs, velocities 1e-4 abs;
- vi_bundle_adjust: the initial cost rel 1e-5, the final cost rel 1e-3
  after 30 LM steps (converged) and after 3 on a reused-slot chain, poses
  1e-3;
  pose_inertial_optimization: Tcw 1e-4, the same inliers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.geometry import lie as jlie
from eorb_slam_tpu.imu import preintegration as jpre
from eorb_slam_tpu.optim import inertial as jin, vi_ba as jvba
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.imu import preintegration as tpre
from eorb_slam_tpu_torch.optim import inertial as tin, schur_ba as tsba, vi_ba as tvba
from tests.test_imu import (
    CALIB, _kf_preintegrations, _make_vi_problem, imu_samples, state,
)

TCALIB = convert.calib_from_numpy(CALIB)


def T(x):
    return torch.from_numpy(np.array(x))


def tpre_of(p):
    return convert.pre_from_numpy(p)


def _close_pre(pt, pj, atol):
    for name, a, b in zip(tpre.Preintegrated._fields, pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, err_msg=name)


def _integrate_both(g, a, d, o, bg=np.zeros(3), ba=np.zeros(3)):
    pj = jpre.integrate(g, a, d, o, jnp.asarray(bg, jnp.float32),
                        jnp.asarray(ba, jnp.float32), CALIB)
    pt = tpre.integrate(T(g), T(a), T(d), T(o), T(np.float32(bg)), T(np.float32(ba)),
                        TCALIB)
    return pt, pj


def test_make_calib_matches():
    for name, a, b in zip(tpre.ImuCalib._fields, tpre.make_calib(), jpre.make_calib()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("bias", [False, True])
def test_integrate_matches_jax(bias):
    bg = np.asarray([0.02, -0.01, 0.015]) if bias else np.zeros(3)
    ba = np.asarray([0.1, 0.05, -0.08]) if bias else np.zeros(3)
    g, a, d, o = imu_samples(0.3, 0.8, bg=bg, ba=ba)
    pt, pj = _integrate_both(g, a, d, o, bg, ba)
    _close_pre(pt, pj, 1e-5)


def test_masked_samples_change_nothing():
    """Padding marked invalid (garbage values) leaves the window as it is,
    on both sides, and the two agree."""
    g, a, d, o = imu_samples(0.0, 0.5)
    pad = lambda x, v: jnp.concatenate([x, jnp.full((32,) + x.shape[1:], v, x.dtype)])
    g2, a2, d2 = pad(g, 99.0), pad(a, -99.0), pad(d, 0.01)
    o2 = jnp.concatenate([o, jnp.zeros(32, bool)])
    p1, _ = _integrate_both(g, a, d, o)
    p2, pj2 = _integrate_both(g2, a2, d2, o2)
    for name, x, y in zip(tpre.Preintegrated._fields, p1, p2):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    _close_pre(p2, pj2, 1e-5)


@pytest.mark.parametrize("t1", [0.33, 0.45])
def test_bucket_padded_window_matches_jax(t1):
    """The inertial frame step's window as the port pads it (to a
    power-of-two bucket of at least 8, zeros masked off, as the JAX
    package's frame step pads it), fed to both packages: within 1e-5 of
    JAX, and the port's bits those of the unpadded window."""
    from eorb_slam_tpu_torch.slam import vi_system as tvs

    g, a, d, _ = imu_samples(0.3, t1)
    chunk = tvs.ImuChunk(gyro=np.asarray(g), acc=np.asarray(a), dts=np.asarray(d))
    cpu = torch.device("cpu")
    padded = tvs._chunk_tensors(chunk, cpu, pad=True)
    assert padded[0].shape[0] == tvs.imu_bucket(len(d)) > len(d)
    pt, pj = _integrate_both(*(x.numpy() for x in padded))
    _close_pre(pt, pj, 1e-5)
    plain, _ = _integrate_both(*(x.numpy() for x in tvs._chunk_tensors(chunk, cpu)))
    for name, x, y in zip(tpre.Preintegrated._fields, pt, plain):
        assert torch.equal(x.view(-1).view(torch.uint8), y.view(-1).view(torch.uint8)), name


def test_bias_jacobian_and_delta_corrected():
    bg = np.asarray([0.02, -0.01, 0.015], np.float32)
    ba = np.asarray([0.1, 0.05, -0.08], np.float32)
    g, a, d, o = imu_samples(0.0, 0.5, bg=bg, ba=ba)
    pt0, pj0 = _integrate_both(g, a, d, o)
    pt1, _ = _integrate_both(g, a, d, o, bg, ba)
    got = tpre.delta_corrected(pt0, T(bg), T(ba))
    want = jpre.delta_corrected(pj0, jnp.asarray(bg), jnp.asarray(ba))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    # first order against integrating with the true bias (the JAX test's bar)
    np.testing.assert_allclose(got[0].numpy(), pt1.dR.numpy(), atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), pt1.dV.numpy(), atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), pt1.dP.numpy(), atol=1e-3)


def test_merge_matches_jax_and_joint_integration():
    pa_t, pa_j = _integrate_both(*imu_samples(0.0, 0.4))
    pb_t, pb_j = _integrate_both(*imu_samples(0.4, 0.9))
    pm_t, pm_j = tpre.merge(pa_t, pb_t), jpre.merge(pa_j, pb_j)
    _close_pre(pm_t, pm_j, 1e-5)
    g1, a1, d1, o1 = imu_samples(0.0, 0.4)
    g2, a2, d2, o2 = imu_samples(0.4, 0.9)
    joint, _ = _integrate_both(*(jnp.concatenate(x) for x in
                                 ((g1, g2), (a1, a2), (d1, d2), (o1, o2))))
    np.testing.assert_allclose(pm_t.dR.numpy(), joint.dR.numpy(), atol=1e-5)
    np.testing.assert_allclose(pm_t.dV.numpy(), joint.dV.numpy(), atol=1e-4)
    np.testing.assert_allclose(pm_t.dP.numpy(), joint.dP.numpy(), atol=1e-4)
    # stacked merge (the keyframe chain's batched form) equals per-entry
    st = tpre.merge(tpre.stack([pa_t, pb_t]), tpre.stack([pb_t, pa_t]))
    _close_pre(tpre.take(st, 0), pm_j, 1e-5)


def test_predict_state_and_information_match():
    g, a, d, o = imu_samples(0.3, 0.8)
    pt, pj = _integrate_both(g, a, d, o)
    R0, p0, v0 = (np.asarray(x, np.float32) for x in state(0.3))
    bg, ba = np.float32([0.001, 0.002, -0.001]), np.float32([0.01, 0.0, 0.02])
    got = tpre.predict_state(T(R0), T(p0), T(v0), pt, T(bg), T(ba))
    want = jpre.predict_state(jnp.asarray(R0), jnp.asarray(p0), jnp.asarray(v0), pj,
                              jnp.asarray(bg), jnp.asarray(ba))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    it, ij = tpre.information_9(pt).numpy(), np.asarray(jpre.information_9(pj))
    np.testing.assert_allclose(it, ij, rtol=1e-3, atol=1e-3 * np.abs(ij).max())
    Tcw = np.asarray(jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 0.05, 0.1, -0.02])))
    Tbc = np.asarray(jlie.se3_exp(jnp.asarray([0.01, 0.02, -0.03, 0.0, 0.02, 0.1])))
    np.testing.assert_allclose(tpre.Twb_from_Tcw(T(Tcw), T(Tbc)).numpy(),
                               np.asarray(jpre.Twb_from_Tcw(Tcw, Tbc)), atol=1e-6)
    np.testing.assert_allclose(tpre.Tcw_from_Twb(T(Tcw), T(Tbc)).numpy(),
                               np.asarray(jpre.Tcw_from_Twb(Tcw, Tbc)), atol=1e-6)


@functools.lru_cache(maxsize=None)
def _init_problem(K=8):
    s_true = 2.5
    R_vw = np.asarray(jlie.so3_exp(jnp.asarray([0.25, -0.15, 0.0], jnp.float32)))
    bg = np.asarray([0.01, -0.02, 0.005])
    ba = np.asarray([0.05, -0.03, 0.08])
    kf_times = np.arange(K) * 0.4 + 0.1
    Twb = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k, t in enumerate(kf_times):
        R, p, _ = state(t)
        Twb[k, :3, :3] = R_vw @ R
        Twb[k, :3, 3] = (1.0 / s_true) * R_vw @ p
    pre = _kf_preintegrations(kf_times, bg=bg, ba=ba)
    edge_valid = np.asarray([False] + [True] * (K - 1))
    return Twb, pre, edge_valid, s_true, R_vw


def _angle(a, b):
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def test_linear_alignment_matches_jax():
    Twb, pre, ev, _, _ = _init_problem()
    # a culled-and-reused chain: slot order is not temporal order
    prev = np.asarray([-1, 0, 1, 2, 3, 4, 5, 6], np.int32)
    for p in (None, prev):
        sj, gj, vj = jin.linear_alignment(jnp.asarray(Twb), pre, jnp.asarray(ev),
                                          None if p is None else jnp.asarray(p))
        st, gt, vt = tin.linear_alignment(T(Twb), tpre_of(pre), T(ev),
                                          None if p is None else T(p))
        assert abs(float(st) - float(sj)) <= 1e-4 * abs(float(sj))
        assert _angle(gt.numpy(), np.asarray(gj)) < 1e-4
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


def test_inertial_init_matches_jax():
    Twb, pre, ev, s_true, R_vw = _init_problem()
    kw = dict(prior_gyro=1e2, prior_acc=1.0, iters=60)
    rj = jin.inertial_init(jnp.asarray(Twb), pre, jnp.asarray(ev), **kw)
    rt = tin.inertial_init(T(Twb), tpre_of(pre), T(ev), **kw)
    assert abs(float(rt.scale) - float(rj.scale)) <= 1e-4 * float(rj.scale)
    assert _angle(rt.g.numpy(), np.asarray(rj.g)) < 1e-4
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), atol=1e-5)
    # the acc bias is weakly observable over these short windows (the JAX
    # test holds it only to 0.08 of the truth): 5e-4 between the packages
    np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), atol=5e-4)
    np.testing.assert_allclose(rt.vel.numpy(), np.asarray(rj.vel), atol=1e-4)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3, atol=1e-4)
    # the JAX test's own bar, on the port
    assert float(rt.scale) == pytest.approx(s_true, rel=0.02)
    assert _angle(rt.g.numpy(), R_vw @ np.asarray([0.0, 0.0, -9.81])) < 0.032


def test_nanmedian_matches_jnp():
    rng = np.random.default_rng(0)
    for n_nan in (0, 1, 4, 8):
        for n in (7, 8):
            x = rng.normal(size=n).astype(np.float32)
            x[:min(n_nan, n)] = np.nan
            want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
            got = tin.nanmedian(T(x)).numpy()[0]
            np.testing.assert_equal(got, want)


def _edge_point(seed=0):
    """A random linearization point of one inertial edge."""
    rng = np.random.default_rng(seed)
    pre = _kf_preintegrations(np.asarray([0.2, 0.55]))
    pre1 = jax.tree_util.tree_map(lambda x: x[1], pre)
    Tcw = [np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
           for _ in range(2)]
    v = rng.normal(0, 0.5, (2, 3)).astype(np.float32)
    b = rng.normal(0, 0.01, (4, 3)).astype(np.float32)
    Tbc = np.asarray(jlie.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, 0.02, -0.05])))
    return pre1, Tcw, v, b, Tbc


def test_vi_edge_jacobians_match_jax_jacfwd():
    """VI-BA's edge residual (inertial + bias random walk) and its Jacobian
    over the 30 endpoint perturbations, against ``jax.jacfwd`` of the JAX
    package's own edge functions at the same point."""
    pre1, Tcw, v, b, Tbc = _edge_point()
    G = jnp.asarray([0.0, 0.0, -9.81], jnp.float32)
    pre2 = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), pre1)
    jp = jvba.VIBAProblem(visual=None, Tbc=jnp.asarray(Tbc), kf_vel=None, kf_bg=None,
                          kf_ba=None, pre=pre2, edge_valid=jnp.asarray([False, True]),
                          g=G, prev=jnp.asarray([-1, 0]))
    kf_T = jnp.asarray(np.stack(Tcw))
    kv, kbg, kba = jnp.asarray(v), jnp.asarray(b[:2]), jnp.asarray(b[2:])

    def r_j(d):
        d1, d2 = d[:15], d[15:]
        return jnp.concatenate([
            jvba._edge_residual(jp, kf_T, kv, kbg, kba, 1, 0, d1, d2),
            jvba._bias_rw_residual(jp, kbg, kba, 1, 0, d1, d2)])

    x0 = jnp.asarray(np.random.default_rng(3).normal(0, 1e-2, 30), jnp.float32)
    Jj, rj = np.asarray(jax.jacfwd(r_j)(x0)), np.asarray(r_j(x0))

    tp1 = tpre_of(pre1)
    L_in = tin.floored_info_chol(tp1.C[:9, :9])
    L_rw = tin.chol_of_inverse(tp1.C[9:, 9:] + torch.eye(6) * 1e-12)
    args = (T(Tcw[0]), T(Tcw[1]), T(v[0]), T(v[1]), T(b[0]), T(b[2]), T(b[1]), T(b[3]),
            tp1, L_in, L_rw, T(Tbc), T(np.asarray(G)))

    def r_t(d):
        return tvba._residual_fn(d[:15], d[15:], *args)

    xt = T(np.asarray(x0))
    Jt = torch.func.jacfwd(r_t)(xt).numpy()
    np.testing.assert_allclose(r_t(xt).numpy(), rj, atol=1e-4 * np.abs(rj).max())
    np.testing.assert_allclose(Jt, Jj, atol=1e-4 * np.abs(Jj).max())


def test_inertial_init_jacobian_matches_jax():
    """The residual Jacobian inertial_init differentiates: the port's
    ``torch.func.jacfwd`` of the whitened edge residual in the scaled (GS)
    form against ``jax.jacfwd`` of the JAX one, in (v1, v2, bg, ba, rwg, s)."""
    pre1, Tcw, v, b, _ = _edge_point(1)
    Twb = [np.linalg.inv(x) for x in Tcw]

    def pack(x, jnp_):
        g = jin.gravity_from_dir(x[12:14]) if jnp_ else tin.gravity_from_dir(x[12:14])
        s = (jnp.exp if jnp_ else torch.exp)(x[14])
        return x[0:3], x[3:6], x[6:9], x[9:12], g, s

    def r_j(x):
        v1, v2, bg, ba, g, s = pack(x, True)
        return jin.whitened_inertial_residual(
            jnp.asarray(Twb[0][:3, :3]), jnp.asarray(Twb[0][:3, 3]), v1, bg, ba,
            jnp.asarray(Twb[1][:3, :3]), jnp.asarray(Twb[1][:3, 3]), v2, pre1, g, s)

    tp1 = tpre_of(pre1)

    def r_t(x):
        v1, v2, bg, ba, g, s = pack(x, False)
        return tin.whitened_inertial_residual(
            T(Twb[0][:3, :3]), T(Twb[0][:3, 3]), v1, bg, ba,
            T(Twb[1][:3, :3]), T(Twb[1][:3, 3]), v2, tp1, g, s)

    x0 = np.concatenate([v.reshape(-1), b[0], b[2], [0.2, -0.1], [0.3]]).astype(np.float32)
    Jj = np.asarray(jax.jacfwd(r_j)(jnp.asarray(x0)))
    Jt = torch.func.jacfwd(r_t)(T(x0)).numpy()
    np.testing.assert_allclose(Jt, Jj, atol=1e-4 * np.abs(Jj).max())


_make_vi_problem = functools.lru_cache(maxsize=None)(_make_vi_problem)


def _vi_problem_torch(p):
    vis = tsba.BAProblem(*(T(x) for x in p.visual))
    return tvba.VIBAProblem(vis, T(p.Tbc), T(p.kf_vel), T(p.kf_bg), T(p.kf_ba),
                            tpre_of(p.pre), T(p.edge_valid), T(p.g),
                            None if p.prev is None else T(p.prev))


def test_vi_bundle_adjust_matches_jax():
    iters = 30
    prob, Tcw_gt, vel_gt, _ = _make_vi_problem()
    rj = jvba.vi_bundle_adjust(prob, iters=iters)
    rt = tvba.vi_bundle_adjust(_vi_problem_torch(prob), iters=iters)
    np.testing.assert_allclose(float(rt.cost0), float(rj.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    np.testing.assert_allclose(rt.kf_T.numpy(), np.asarray(rj.kf_T), atol=1e-3)
    np.testing.assert_allclose(rt.kf_vel.numpy(), np.asarray(rj.kf_vel), atol=1e-2)
    assert (rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)).mean() > 0.999
    # the JAX test's own bars, on the port
    err0 = np.linalg.norm(np.asarray(prob.visual.kf_T)[:, :3, 3] - Tcw_gt[:, :3, 3])
    err1 = np.linalg.norm(rt.kf_T.numpy()[:, :3, 3] - Tcw_gt[:, :3, 3])
    assert float(rt.cost) < float(rt.cost0) and err1 < 0.5 * err0


def test_vi_bundle_adjust_with_a_reused_slot_chain():
    """Slots out of temporal order (a culled keyframe's slot reused): the
    explicit ``prev`` chain, with one edge masked off."""
    prob, _, _, _ = _make_vi_problem()
    prev = jnp.asarray([2, -1, 1, 0, 3, 4], jnp.int32)
    ev = jnp.asarray([True, False, True, True, False, True])
    prob = prob._replace(prev=prev, edge_valid=ev)
    rj = jvba.vi_bundle_adjust(prob, iters=3)
    rt = tvba.vi_bundle_adjust(_vi_problem_torch(prob), iters=3)
    np.testing.assert_allclose(float(rt.cost0), float(rj.cost0), rtol=1e-5)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    np.testing.assert_allclose(rt.kf_T.numpy(), np.asarray(rj.kf_T), atol=1e-3)


def test_pose_inertial_optimization_matches_jax():
    rng = np.random.default_rng(3)
    from eorb_slam_tpu.geometry import camera as jcam

    cam = jcam.make_pinhole(458.0, 457.0, 376.0, 240.0)
    t_ref, t_cur = 0.5, 0.75
    Twb = []
    for t in (t_ref, t_cur):
        R, p, _ = state(t)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3], M[:3, 3] = R, p
        Twb.append(M)
    Tcw_ref, Tcw_cur = (np.asarray(jpre.Tcw_from_Twb(jnp.asarray(M), jnp.eye(4))) for M in Twb)
    N = 128
    lm = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(5, 10, (N, 1))],
                        axis=1).astype(np.float32)
    pc = lm @ Tcw_cur[:3, :3].T + Tcw_cur[:3, 3]
    uv = (np.stack([458.0 * pc[:, 0] / pc[:, 2] + 376.0, 457.0 * pc[:, 1] / pc[:, 2] + 240.0],
                   1) + rng.normal(0, 0.4, (N, 2))).astype(np.float32)
    uv[:6] += 40.0                                      # outliers
    pre_j = jpre.integrate(*imu_samples(t_ref, t_cur), jnp.zeros(3), jnp.zeros(3), CALIB)
    xi = np.float32([0.02, -0.03, 0.01, 0.015, -0.02, 0.025])
    Tcw0 = np.asarray(jlie.se3_exp(jnp.asarray(xi))) @ Tcw_cur
    vel0 = (state(t_cur)[2] + rng.normal(0, 0.1, 3)).astype(np.float32)
    v_r = state(t_ref)[2].astype(np.float32)
    valid = np.ones(N, bool)
    valid[-4:] = False
    args = (Tcw0, vel0, np.zeros(3, np.float32), np.zeros(3, np.float32), lm, uv,
            np.ones(N, np.float32), valid, Tcw_ref, v_r)
    oj = jvba.pose_inertial_optimization(cam, *(jnp.asarray(a) for a in args), pre_j,
                                         jnp.eye(4), return_H=True)
    ot = tvba.pose_inertial_optimization(T(np.asarray(cam)), *(T(a) for a in args),
                                         tpre_of(pre_j), torch.eye(4), return_H=True)
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-4)
    for k in (1, 2, 3):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-4)
    np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))
    assert int(ot[5]) == int(oj[5]) > 100
    Hj = np.asarray(oj[6])
    np.testing.assert_allclose(ot[6].numpy(), Hj, rtol=1e-3, atol=1e-4 * np.abs(Hj).max())
    t_err = np.linalg.norm(ot[0].numpy()[:3, 3] - Tcw_cur[:3, 3])
    assert t_err < 0.01                    # the JAX test's bar, on the port


def test_apply_scaled_rotation_and_gravity_from_dir_match():
    rng = np.random.default_rng(5)
    Twb = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32)))
                    for _ in range(4)])
    lm = rng.normal(size=(10, 3)).astype(np.float32)
    vel = rng.normal(size=(4, 3)).astype(np.float32)
    Ryw = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05])))
    for a, b in zip(tin.apply_scaled_rotation(T(Twb), T(lm), T(vel), T(Ryw), 1.7),
                    jin.apply_scaled_rotation(Twb, lm, vel, Ryw, 1.7)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    r = np.float32([0.3, -0.2])
    np.testing.assert_allclose(tin.gravity_from_dir(T(r)).numpy(),
                               np.asarray(jin.gravity_from_dir(jnp.asarray(r))), atol=1e-5)


def test_conversions_round_trip():
    pre = _kf_preintegrations(np.asarray([0.1, 0.4, 0.8]))
    tp = tpre_of(pre)
    back = convert.pre_to_numpy(tp)
    for k, v in pre._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    assert tpre.take(tp, 1).dR.shape == (3, 3)
    tcal = convert.calib_from_numpy(CALIB)
    assert tcal.Tbc.dtype == torch.float32 and tcal.Tbc.device.type == "cpu"
