"""EVENT_MONO of the port (``slam/ev_image_system``, ``EvImageInertialSlam``
and ``EventWindowBuilder.build_mci``) against the JAX package.

One module-scoped run drives both ``EvImageSlam``s frame by frame over the
same intensity frames (rendered with the port's plain splat from the numpy
world of tests/test_event_slam.py) and the same event stream, with JAX's
two-view and PnP draws injected (``install_jax_draws``). The image map
initializes at frame 1, the event map's joint init lands at frame 10 and a
joint local BA at frame 13. The five fixed-shape steps, ``build_mci`` and
the loop handoff are then held on the JAX run's own state, converted with
numpy. Both builders run 5 ascent iterations over a 16,384-event window.

Tolerances: the same image / event states, keyframe decisions, keyframe
counts and joint counters after every frame, both trackers' poses within
2e-3 (map units); the steps' poses within 1e-5 and their inlier / match
flags equal; ``_estimate_gauge`` within 1e-9 (host numpy on both sides);
``build_mci`` the same winner, its four scores within 1e-5 relative and
the MCI (in [0,1]) within 1e-5; the world-transform replay within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from eorb_slam_tpu.event import builder as jb
from eorb_slam_tpu.slam import ev_image_system as jev, event_inertial as jei
from eorb_slam_tpu.slam import loop_closing as jlc
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.event import builder as tb, tensorize as tt
from eorb_slam_tpu_torch.imu import preintegration as tpre
from eorb_slam_tpu_torch.slam import ev_image_system as tev, event_inertial as tei
from eorb_slam_tpu_torch.slam import loop_closing as tlc
from tests.test_event_slam import CAM, CX, CY, FX, FY, H, W, EventWorld, make_cfg
from tests.test_torch_l2_slice import install_jax_draws

FRAMES, FPS, EV_RATE = 14, 12.0, 100_000
KW = dict(img_w=W, img_h=H, max_kp=256, ev_max_kp=256, synch_window_s=0.2,
          K=12, M=1024, min_init_matches=30, min_track_inliers=8)
CFG = dict(make_cfg().__dict__, cm_iters=5)
POSE_TOL, STEP_TOL = 2e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def render(world, t: float) -> np.ndarray:
    """The APS frame of the event world in [0,255]: Gaussian blobs at the
    points' projections, splatted by the port's plain (CPU) splat."""
    Tcw = world.pose(t)
    pc = (Tcw[:3, :3] @ world.pts.T).T + Tcw[:3, 3]
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY],
                  1).astype(np.float32)
    ok = (pc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    img = tt.splat_gauss(torch.from_numpy(uv), torch.from_numpy(ok),
                         torch.ones(len(uv)), H, W, sigma=1.2)
    return (tt.normalize_to_image(img) * 255.0).numpy()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    install_jax_draws(mp)
    # the JAX init's triangulation calls, for the step test to replay
    tri_calls = []
    j_tri = jev._init_triangulate_known_poses

    def rec_tri(*a):
        r = j_tri(*a)
        tri_calls.append((a, int(r[-1])))
        return r

    mp.setattr(jev, "_init_triangulate_known_poses", rec_tri)
    world = EventWorld(n_points=260, seed=5)
    js = jev.EvImageSlam(CAM, jb.BuilderConfig(**CFG), **KW)
    ts = tev.EvImageSlam(np.asarray(CAM), tb.BuilderConfig(**CFG), device="cpu", **KW)
    ev = world.events(0.0, FRAMES / FPS, int(EV_RATE * FRAMES / FPS))
    log, last = [], 0.0
    for t in np.arange(FRAMES) / FPS:
        chunk = ev[(ev[:, 0] > last) & (ev[:, 0] <= t)]
        img = render(world, float(t))
        rj = js.track_ev_mono(chunk, img, float(t))
        rt = ts.track_ev_mono(chunk, img, float(t))
        log.append((rj, rt, [(s.im.state, s.ev.state, s.im.n_kf, s.ev.n_kf, s.joint_frames,
                              s.joint_bas, s.joint_inits) for s in (js, ts)],
                    [(np.asarray(js.im.T_last), np.asarray(js.ev.T_last)),
                     (ts.im.T_last.numpy(), ts.ev.T_last.numpy())]))
        last = t
    mp.undo()
    return js, ts, log, ev, tri_calls


def test_ev_image_slam_matches_jax_frame_by_frame(run):
    js, ts, log, _, _ = run
    for i, (rj, rt, (cj, ct), ((Tij, Tej), (Tit, Tet))) in enumerate(log):
        assert ct == cj, (i, cj, ct)
        for side in ("image", "event"):
            a, b = rj[side] or {}, rt[side] or {}
            assert (a.get("state"), a.get("kf"), a.get("joint_init")) == \
                (b.get("state"), b.get("kf"), b.get("joint_init")), (i, side, a, b)
        assert (rj["joint"] is None) == (rt["joint"] is None), i
        np.testing.assert_allclose(Tit, Tij, atol=POSE_TOL, err_msg=f"image, frame {i}")
        np.testing.assert_allclose(Tet, Tej, atol=POSE_TOL, err_msg=f"event, frame {i}")
    assert js.joint_inits == ts.joint_inits == 1
    assert ts.joint_frames == js.joint_frames >= 3 and ts.joint_bas == js.joint_bas >= 1
    traj_j, traj_t = js.trajectory_twc(), ts.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
    fj, ft = js.fused_trajectory(), ts.fused_trajectory()
    assert ft["chains"] == fj["chains"] >= 1 and ft["kinds"] == fj["kinds"]
    for (_, a), (_, b) in zip(ft["fused"], fj["fused"]):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)


def _maps(js):
    im = convert.map_state_from_numpy({k: np.asarray(v) for k, v in js.im.map._asdict().items()})
    ev = convert.map_state_from_numpy({k: np.asarray(v) for k, v in js.ev.map._asdict().items()})
    return im, ev


def test_joint_pose_and_writeback_match_jax(run):
    js = run[0]
    tr_i, f_i, tr_e, f_e = js.im.last_track, js.im.last_frame, js.ev.last_track, js.ev.last_frame
    im, ev = _maps(js)
    R = np.asarray([[0.99, -0.1411, 0.0], [0.1411, 0.99, 0.0], [0.0, 0.0, 1.0]], np.float32)
    R, _ = np.linalg.qr(R)
    R = (R * np.sign(np.diag(R))).astype(np.float32)
    for s, R_ie, t_ie in ((1.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
                          (1.3, R, np.asarray([0.05, -0.02, 0.1], np.float32))):
        args = [np.asarray(x) for x in (tr_i.feat_lm, f_i.xy_ud, f_i.octave,
                                        tr_e.feat_lm, f_e.xy_ud, f_e.octave)]
        Tj_j, fl_j = jev._joint_pose_step(
            CAM, js.im.map.lm_pos, js.ev.map.lm_pos, *map(jnp.asarray, args),
            jnp.asarray(R_ie), jnp.asarray(t_ie), jnp.asarray(s, jnp.float32), tr_i.Tcw)
        Tj_t, fl_t = tev._joint_pose_step(
            _t(CAM), im.lm_pos, ev.lm_pos, *map(torch.from_numpy, args),
            R_ie, t_ie, s, _t(tr_i.Tcw))
        np.testing.assert_array_equal(fl_t.numpy(), np.asarray(fl_j))
        assert fl_t[0] >= 20
        np.testing.assert_allclose(Tj_t.numpy(), np.asarray(Tj_j), atol=STEP_TOL)
        wb_j = jev._joint_writeback(Tj_j, js.im.T_last, js.ev.T_last, jnp.asarray(R_ie),
                                    jnp.asarray(t_ie), jnp.asarray(s, jnp.float32),
                                    js.im.map.kf_T[js.im._kf_ref()])
        wb_t = tev._joint_writeback(_t(Tj_j), _t(js.im.T_last), _t(js.ev.T_last), R_ie, t_ie, s,
                                    im.kf_T[js.im._kf_ref()])
        for a, b in zip(wb_t, wb_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=STEP_TOL)


def test_init_triangulate_known_poses_matches_jax(run):
    """Replays the JAX run's init triangulations (the one that seeded the
    event map among them) on the port."""
    calls = run[4]
    assert max(n for _, n in calls) >= 20
    for a, n_j in calls:
        rj = jev._init_triangulate_known_poses(*a)
        rt = tev._init_triangulate_known_poses(*(_t(x) for x in a))
        m12, idx2, pts, ok, n = rj
        np.testing.assert_array_equal(rt[0].numpy(), np.asarray(m12))
        np.testing.assert_array_equal(rt[1].numpy(), np.asarray(idx2))
        np.testing.assert_array_equal(rt[3].numpy(), np.asarray(ok))
        assert int(rt[4]) == int(n) == n_j
        # float32 DLT (an SVD per point) over a short baseline: the points
        # agree to 1e-3 of their distance
        okn = np.asarray(ok)
        pj = np.asarray(pts)[okn]
        err = np.abs(rt[2].numpy()[okn] - pj).max(axis=1)
        assert (err <= 1e-3 * np.linalg.norm(pj, axis=1)).all(), err.max()


def test_propagate_loop_to_event_matches_jax(run):
    js = run[0]
    im, ev = _maps(js)
    G = np.eye(4, dtype=np.float32)
    G[:3, :3] = np.asarray([[np.cos(0.3), 0, np.sin(0.3)], [0, 1, 0],
                            [-np.sin(0.3), 0, np.cos(0.3)]], np.float32)
    G[:3, 3] = [0.5, -0.2, 0.1]
    T_after = np.asarray(js.im.map.kf_T) @ G
    for s in (1.0, 0.8):
        b = (np.eye(3, dtype=np.float32), np.asarray([0.1, 0.0, -0.1], np.float32), s)
        ej = jev._propagate_loop_to_event(
            js.ev.map, js.im.map.kf_ts, js.im.map.kf_valid, js.im.map.kf_T,
            jnp.asarray(T_after), jnp.asarray(b[0]), jnp.asarray(b[1]),
            jnp.asarray(s, jnp.float32))
        et = tev._propagate_loop_to_event(ev, im.kf_ts, im.kf_valid, im.kf_T,
                                          _t(T_after), *b)
        np.testing.assert_allclose(et.kf_T.numpy(), np.asarray(ej.kf_T), atol=STEP_TOL)
        np.testing.assert_allclose(et.lm_pos.numpy(), np.asarray(ej.lm_pos), atol=STEP_TOL)


def _f64(m):
    """A map's float32 fields in float64 (numpy)."""
    return {k: (np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32
                else np.asarray(v)) for k, v in m._asdict().items()}


def test_joint_local_ba_step_matches_jax(run):
    """In float64 on both sides (JAX with x64 on): 8 float32 LM iterations
    from one state part ways by ~2e-3 (ROADMAP Queue 3), float64 ones do not."""
    js = run[0]
    im_np, ev_np = _f64(js.im.map), _f64(js.ev.map)
    im, ev = (convert.MapState(**{k: torch.from_numpy(v) for k, v in d.items()})
              for d in (im_np, ev_np))
    free_im, free_ev = np.asarray(js.im._ba_window()), np.asarray(js.ev._ba_window())
    assert free_im.sum() >= 1 and free_ev.sum() >= 1
    I3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    with jax.enable_x64(True):
        jm = [type(js.im.map)(**{k: jnp.asarray(v) for k, v in d.items()})
              for d in (im_np, ev_np)]
        imj, evj, cj = jev._joint_local_ba_step(
            *jm, CAM, jnp.asarray(I3), jnp.asarray(z3),
            jnp.asarray(1.0, jnp.float32), jnp.asarray(free_im), jnp.asarray(free_ev))
        imj, evj, cj = (jax.tree_util.tree_map(np.asarray, x) for x in (imj, evj, cj))
    imt, evt, ct = tev._joint_local_ba_step(im, ev, _t(CAM), I3, z3, 1.0,
                                            _t(free_im), _t(free_ev))
    assert imt.kf_T.dtype == torch.float64
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-9)
    for a, b in ((imt, imj), (evt, evj)):
        kv = b.kf_valid
        np.testing.assert_allclose(a.kf_T.numpy()[kv], b.kf_T[kv], atol=STEP_TOL)
        lv = b.lm_valid
        np.testing.assert_allclose(a.lm_pos.numpy()[lv], b.lm_pos[lv], atol=STEP_TOL)


def test_estimate_gauge_matches_jax(run):
    js, ts = run[0], run[1]
    rng = np.random.default_rng(4)
    R_true = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    s_true, t_true = 2.5, np.asarray([0.3, -0.1, 0.2])
    pairs = []
    for k in range(8):
        Te = np.eye(4)
        C_ev = np.asarray([0.1 * k, 0.02 * k * k, 0.05 * np.sin(k)]) + rng.normal(0, 1e-3, 3)
        Te[:3, :3] = np.eye(3)
        Te[:3, 3] = -C_ev
        Ti = np.eye(4)
        Ti[:3, :3] = R_true.T
        C_im = s_true * R_true @ C_ev + t_true + rng.normal(0, 1e-3, 3)
        Ti[:3, 3] = -R_true.T @ C_im
        pairs.append((0.1 * k, Ti.astype(np.float32), Te.astype(np.float32)))
    for n in (2, 5, 8):
        js._gauge_pairs, ts._gauge_pairs = list(pairs[:n]), list(pairs[:n])
        gj, gt = js._estimate_gauge(), ts._estimate_gauge()
        assert (gj is None) == (gt is None) == (n < 3)
        if gj is not None:
            for a, b in zip(gt, gj):
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
            assert gt[0] == pytest.approx(s_true, rel=1e-2)
    js._gauge_pairs, ts._gauge_pairs = [], []


def test_build_mci_matches_jax(run):
    js, ts, _, ev, _ = run
    window = ev[(ev[:, 0] > 0.3) & (ev[:, 0] <= 0.5)].astype(np.float64)
    assert len(window) > CFG["max_window_events"]      # the newest events are kept
    T_prev = np.asarray(js.im.map.kf_T[0])
    T_cur = np.asarray(js.im.map.kf_T[1])
    for prior in (False, True):
        jbld = jb.EventWindowBuilder(jb.BuilderConfig(**CFG), CAM)
        tbld = tb.EventWindowBuilder(tb.BuilderConfig(**CFG), np.asarray(CAM), device="cpu")
        if prior:
            jbld.set_pose_prior(T_prev, T_cur, 2.0)
            tbld.set_pose_prior(_t(T_prev), _t(T_cur), _t(2.0, np.float32))
        pj, pt = jbld.build_mci(window), tbld.build_mci(window)
        assert pt.best_kind == pj.best_kind and pt.ts0 == pj.ts0 and pt.ts == pj.ts
        assert tbld.stats == jbld.stats
        assert pt.score == pytest.approx(pj.score, rel=STEP_TOL)
        img_j = np.asarray(pj.img)
        assert np.abs(pt.img.numpy() - img_j).max() <= STEP_TOL * img_j.max()
        np.testing.assert_allclose(pt.se2_params.numpy(), np.asarray(pj.se2_params), atol=1e-4)


def _loop_pair(js):
    """Fresh EvImageSlams of both packages carrying the JAX run's joint
    state (keyframe orders, states, gauge; the maps in float64, see
    test_joint_local_ba_step_matches_jax). Call inside ``jax.enable_x64``."""
    jn = jev.EvImageSlam(CAM, jb.BuilderConfig(**CFG), **KW)
    tn = tev.EvImageSlam(np.asarray(CAM), tb.BuilderConfig(**CFG), device="cpu", **KW)
    f = js.im.last_frame
    state = {"im_map": _f64(js.im.map), "ev_map": _f64(js.ev.map),
             "gauge": js._last_gauge, "gauge_locked": js._gauge_locked,
             "stash": [(f.ts, f, np.asarray(js.im.T_last))]}
    convert.ev_image_state_from_numpy(tn, state)
    assert tn._gauge_locked and tn._last_gauge[0] == 1.0
    (ts, ft, T), = tn._ev_stash
    assert ts == f.ts and ft.ts == f.ts
    for k in ("xy_ud", "octave", "angle", "desc_pm1", "valid"):
        np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(f, k)))
    np.testing.assert_array_equal(T, np.asarray(js.im.T_last))
    tn._ev_stash = []
    # convert carries the maps in the port's dtypes; this test wants float64
    tn.im.map, tn.ev.map = (convert.MapState(**{k: torch.from_numpy(v) for k, v in d.items()})
                            for d in (state["im_map"], state["ev_map"]))
    jn.im.map, jn.ev.map = (type(js.im.map)(**{k: jnp.asarray(v) for k, v in d.items()})
                            for d in (state["im_map"], state["ev_map"]))
    jn._last_gauge, jn._gauge_locked = js._last_gauge, js._gauge_locked
    for a, b in ((jn.im, js.im), (jn.ev, js.ev), (tn.im, js.im), (tn.ev, js.ev)):
        a._kf_order, a.last_kf_slot, a.state = list(b._kf_order), b.last_kf_slot, b.state
    return jn, tn


def test_on_image_loop_after_a_stashed_correction_matches_jax(run):
    """The handoff as MonoSlam stashes it on a loop weld: the pre-correction
    poses, the LoopInfo, the validity and timestamps; then the event map
    follows the weld and the joint GBA runs over both maps."""
    G = np.eye(4)
    G[:3, :3] = np.asarray([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
                            [0, np.sin(0.2), np.cos(0.2)]])
    G[:3, 3] = [0.1, 0.05, -0.1]
    with jax.enable_x64(True):
        jn, tn = _loop_pair(run[0])
        T_before = np.asarray(jn.im.map.kf_T)
        jn.im.map = jn.im.map._replace(kf_T=jnp.asarray(T_before @ G))
        tn.im.map = tn.im.map._replace(kf_T=_t(T_before @ G))
        matched = int(jn.im._kf_order[0])
        jn._on_image_loop(jnp.asarray(T_before), jlc.LoopInfo(True, 1, matched, 40, 1.0),
                          jn.im.map.kf_valid, jn.im.map.kf_ts)
        tn._on_image_loop(_t(T_before), tlc.LoopInfo(True, 1, matched, 40, 1.0),
                          tn.im.map.kf_valid, tn.im.map.kf_ts)
        res_j = [np.asarray(x) for x in (jn.im.map.kf_T, jn.ev.map.kf_T, jn.im.T_last,
                                         jn.ev.T_last, jn.im.map.kf_valid, jn.ev.map.kf_valid)]
    assert tn.joint_loop_gbas == jn.joint_loop_gbas == 1 and tn._gauge_pairs == []
    kv_i, kv_e = res_j[4], res_j[5]
    np.testing.assert_allclose(tn.im.map.kf_T.numpy()[kv_i], res_j[0][kv_i], atol=STEP_TOL)
    np.testing.assert_allclose(tn.ev.map.kf_T.numpy()[kv_e], res_j[1][kv_e], atol=STEP_TOL)
    np.testing.assert_allclose(tn.im.T_last.numpy(), res_j[2], atol=STEP_TOL)
    np.testing.assert_allclose(tn.ev.T_last.numpy(), res_j[3], atol=STEP_TOL)
    # the event map moved with the weld
    assert np.abs(res_j[1][kv_e] - _f64(run[0].ev.map)["kf_T"][kv_e]).max() > 1e-2


def test_apply_world_transform_to_event_matches_jax(run):
    js = run[0]
    kw = dict(KW, cfg=None)
    jn = jei.EvImageInertialSlam(CAM, jei.pre_mod.make_calib(), **kw)
    tn = tei.EvImageInertialSlam(np.asarray(CAM), tpre.make_calib(), device="cpu", **kw)
    tn.ev.map = convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in js.ev.map._asdict().items()})
    jn.ev.map = js.ev.map
    jn.ev.T_last, tn.ev.T_last = js.ev.T_last, _t(js.ev.T_last)
    jn.ev.trajectory = list(js.ev.trajectory)
    tn.ev.trajectory = [(t, None if T is None else np.asarray(T), r)
                        for t, T, r in js.ev.trajectory]
    for a in (jn.ev, tn.ev):
        a._kf_order = list(js.ev._kf_order)
    c, s_ = np.cos(0.4), np.sin(0.4)
    Ryw = np.asarray([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    jn._apply_world_transform_to_event(Ryw, 3.7)
    tn._apply_world_transform_to_event(Ryw, 3.7)
    np.testing.assert_allclose(tn.ev.map.kf_T.numpy(), np.asarray(jn.ev.map.kf_T), atol=1e-6)
    np.testing.assert_allclose(tn.ev.map.lm_pos.numpy(), np.asarray(jn.ev.map.lm_pos),
                               atol=1e-6 * 3.7 * 10)
    np.testing.assert_allclose(tn.ev.T_last.numpy(), np.asarray(jn.ev.T_last), atol=1e-6)
    np.testing.assert_allclose(tn.ev.velocity.numpy(), np.eye(4))
    for (_, a), (_, b) in zip(tn.ev.trajectory_twc(), jn.ev.trajectory_twc()):
        np.testing.assert_allclose(a, b, atol=1e-5)
