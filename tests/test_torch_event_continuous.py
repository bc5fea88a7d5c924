"""The continuous event tracker of the port (``Event.contTracking: 1``:
``event/feature_tracks``, ``EventWindowBuilder.step``,
``local_mapping.create_new_landmarks_aligned`` and
``slam/event_continuous``) against the JAX package.

Inputs come from numpy: the synthetic images of tests/test_event_continuous.py
and the numpy event world of tests/test_event_slam.py, at the JAX test's
tracker settings (256 tracks, init after 3 px of median disparity) with a
12-keyframe, 1,024-landmark map, 5 ascent iterations and JAX's two-view
draws injected (``install_jax_draws``). The tracker sees 0.96 s of the
stream: it initializes on the third window and inserts two more
keyframes.

Tolerances: track slots, validity, landmark links and births equal, track
positions within 1e-4 px; per chunk the same reconst_stat, chunk size,
winner and KLT-fit gating, event images within 1e-5 of their maximum;
``create_new_landmarks_aligned`` the same integer tables, positions within
1e-3 of their distance (float32 DLT); per ``track_events`` call the same states, keyframe decisions and
keyframe counts, poses within 2e-3 (map units).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eorb_slam_tpu.event import builder as jb, feature_tracks as jft
from eorb_slam_tpu.slam import event_continuous as jec, local_mapping as jlm
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.event import builder as tb, feature_tracks as tft
from eorb_slam_tpu_torch.slam import event_continuous as tec, local_mapping as tlm
from tests.test_event_slam import CAM, H, W, EventWorld, make_cfg
from tests.test_torch_l2_slice import install_jax_draws

CFG = dict(make_cfg().__dict__, cm_iters=5)
KW = dict(n_tracks=256, min_init_matches=25, min_track_inliers=8,
          min_init_disp_px=3.0, kf_disp_px=6.0, K=12, M=1024)
PACKET, N_EVENTS = 8000, 64000


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    world = EventWorld(n_points=260, seed=5)
    return world.events(0.0, 2.4, 160000)[:N_EVENTS].astype(np.float64)


def _tracks_equal(tt, tj, xy_tol=1e-4):
    j = {k: np.asarray(v) for k, v in tj._asdict().items()}
    t = convert.tracks_to_numpy(tt)
    for k in ("valid", "lm", "birth_kf", "age", "desc_pm1"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["xy"], j["xy"], atol=xy_tol)
    np.testing.assert_allclose(t["quality"][j["valid"]], j["quality"][j["valid"]], atol=1e-4)


def _blob_images():
    """The JAX test's two images: 3x3 blobs, the second shifted by 3 px."""
    rng = np.random.default_rng(0)
    img0 = np.zeros((H, W), np.float32)
    for x, y in rng.uniform(20, 140, (40, 2)).astype(np.float32):
        yi, xi = int(y), int(x)
        img0[yi - 1: yi + 2, xi - 1: xi + 2] = 1.0
        img0[yi, xi] = 2.0
    return img0, np.roll(img0, 3, axis=1)


def test_track_store_advance_and_top_up_match_jax():
    img0, img1 = _blob_images()
    tj, nj = jft.top_up(jft.empty_tracks(128), jnp.asarray(img0))
    tt, nt = tft.top_up(tft.empty_tracks(128), torch.from_numpy(img0))
    assert int(nt) == int(nj) >= 10
    _tracks_equal(tt, tj)
    tj2, mj = jft.advance(tj, jnp.asarray(img0), jnp.asarray(img1))
    tt2, mt = tft.advance(tt, torch.from_numpy(img0), torch.from_numpy(img1))
    _tracks_equal(tt2, tj2)
    assert float(mt) == pytest.approx(float(mj), abs=1e-4) and abs(float(mt) - 3.0) < 0.6
    # kill every other slot and top up from the JAX state carried across:
    # survivors untouched, reseeded slots carry no landmark / birth
    kill = np.zeros(128, bool)
    kill[::2] = True
    tj3 = tj2._replace(valid=tj2.valid & ~jnp.asarray(kill), lm=jnp.where(
        jnp.asarray(kill), -1, jnp.arange(128, dtype=jnp.int32)),
        birth_kf=jnp.full(128, 3, jnp.int32))
    tt3 = convert.tracks_from_numpy(tj3)
    tj4, nj = jft.top_up(tj3, jnp.asarray(img1))
    tt4, nt = tft.top_up(tt3, torch.from_numpy(img1))
    assert int(nt) == int(nj) > 0
    _tracks_equal(tt4, tj4)
    # a store with every slot free and more candidates than slots
    tj5, nj = jft.top_up(jft.empty_tracks(8), jnp.asarray(img0), min_dist=0.0)
    tt5, nt = tft.top_up(tft.empty_tracks(8), torch.from_numpy(img0), min_dist=0.0)
    assert int(nt) == int(nj) == 8
    _tracks_equal(tt5, tj5)


def test_builder_step_matches_jax(stream):
    """step() chunk by chunk: tiny frames, windows through _finish_window
    with the overlap re-injected, the adaptive chunk size, and an idle gap
    (a sparse stretch under the gen-rate gate) that drops the KLT fit."""
    ev = stream[:36000]
    sparse = np.zeros((3000, 4))
    sparse[:, 0] = ev[-1, 0] + np.linspace(0.01, 40.0, 3000)
    sparse[:, 1:] = ev[:3000, 1:]
    tail = ev[:6000].copy()
    tail[:, 0] += sparse[-1, 0] + 0.01 - ev[0, 0]
    ev = np.concatenate([ev, sparse, tail])
    jbld = jb.EventWindowBuilder(jb.BuilderConfig(**CFG), CAM)
    tbld = tb.EventWindowBuilder(tb.BuilderConfig(**CFG), np.asarray(CAM), device="cpu")
    jbld.feed(ev)
    tbld.feed(ev)
    kinds = []
    while True:
        pj, pt = jbld.step(), tbld.step()
        assert (pj is None) == (pt is None)
        assert tbld.stats == jbld.stats and tbld.chunk_size == jbld.chunk_size
        assert (tbld._klt_fit is None) == (jbld._klt_fit is None)
        if tbld._klt_fit is not None:
            assert tbld._klt_fit[3] == jbld._klt_fit[3]
            np.testing.assert_array_equal(tbld._klt_fit[2].numpy(), np.asarray(jbld._klt_fit[2]))
        if pj is None:
            if tbld.pending_events() < tbld.chunk_size:
                break
            continue
        assert (pt.reconst_stat, pt.best_kind, pt.ts, pt.ts0) == \
            (pj.reconst_stat, pj.best_kind, pj.ts, pj.ts0)
        img_j = np.asarray(pj.img)
        assert np.abs(pt.img.numpy() - img_j).max() <= 1e-5 * img_j.max()
        if pj.reconst_stat:
            assert pt.score == pytest.approx(pj.score, rel=1e-5)
        kinds.append((pj.reconst_stat, pj.best_kind))
    assert jbld.stats["idle"] >= 1 and jbld.stats["windows"] >= 3
    assert (0, "hist") in kinds and any(k == "klt2d" for _, k in kinds)
    assert tbld.pending_events() == jbld.pending_events()


@pytest.fixture(scope="module")
def run(stream):
    mp = pytest.MonkeyPatch()
    install_jax_draws(mp)
    js = jec.EventSlamContinuous(CAM, jb.BuilderConfig(**CFG), **KW)
    ts = tec.EventSlamContinuous(np.asarray(CAM), tb.BuilderConfig(**CFG), device="cpu", **KW)
    log = []
    for k in range(0, len(stream), PACKET):
        oj = js.track_events(stream[k:k + PACKET])
        ot = ts.track_events(stream[k:k + PACKET])
        log.append((oj, ot, (js.l2.n_kf, ts.l2.n_kf), np.asarray(js.l2.T_last),
                    ts.l2.T_last.numpy().copy()))
    mp.undo()
    return js, ts, log


def test_continuous_tracker_matches_jax(run):
    js, ts, log = run
    n_kf_steps = 0
    for i, (oj, ot, (kj, kt), Tj, Tt) in enumerate(log):
        assert [(r["state"], r.get("kf"), r["mci_kind"], r["ts"]) for r in ot] == \
            [(r["state"], r.get("kf"), r["mci_kind"], r["ts"]) for r in oj], i
        assert kt == kj, i
        n_kf_steps += sum(bool(r.get("kf")) for r in oj)
        np.testing.assert_allclose(Tt, Tj, atol=2e-3, err_msg=f"call {i}")
    assert js.l2.state == jec.slam_system.OK and n_kf_steps >= 2
    sj, st = js.stats, ts.stats
    for k in ("chunks", "windows", "idle", "l2_kf", "l2_frames", "l2_tiny", "l2_full",
              "l2_topped", "l2_lost"):
        assert st[k] == sj[k], k
    assert sj["l2_full"] == sj["windows"] and sj["l2_tiny"] == sj["chunks"] - sj["windows"]
    assert abs(st["l2_lm"] - sj["l2_lm"]) <= 2
    np.testing.assert_array_equal(ts.l2.kf_seq, js.l2.kf_seq)
    assert ts.l2._kf_order == js.l2._kf_order
    tr_t, tr_j = ts.l2.tracks, js.l2.tracks
    np.testing.assert_array_equal(tr_t.valid.numpy(), np.asarray(tr_j.valid))
    np.testing.assert_array_equal(tr_t.birth_kf.numpy(), np.asarray(tr_j.birth_kf))
    traj_j, traj_t = js.trajectory_twc(), ts.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j] and len(traj_j) >= 5
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_create_new_landmarks_aligned_matches_jax(run):
    """On the JAX tracker's final map: the newest keyframe against each of
    the three before it, with the tracks' birth gate."""
    l2 = run[0].l2
    m_np = {k: np.asarray(v) for k, v in l2.map._asdict().items()}
    order = l2._kf_order
    a = order[-1]
    tr = l2.tracks
    # free the new keyframe's links so that there is something to found
    m_np["kf_feat_lm"] = m_np["kf_feat_lm"].copy()
    m_np["kf_feat_lm"][a, ::2] = -1
    mj0 = type(l2.map)(**{k: jnp.asarray(v) for k, v in m_np.items()})
    mt0 = convert.map_state_from_numpy(m_np)
    n_new = 0
    for kf_b in order[-4:-1]:
        slot_ok = (tr.valid & (tr.birth_kf >= 0) & (tr.birth_kf <= int(l2.kf_seq[kf_b])))
        mj, idj = jlm.create_new_landmarks_aligned(mj0, jnp.asarray(CAM), jnp.asarray(a),
                                                   jnp.asarray(kf_b), slot_ok)
        mt, idt = tlm.create_new_landmarks_aligned(mt0, torch.from_numpy(np.asarray(CAM)),
                                                   a, kf_b, torch.from_numpy(np.asarray(slot_ok)))
        np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
        n_new += int((np.asarray(idj) >= 0).sum())
        t_np = convert.map_state_to_numpy(mt)
        for k, v in mj._asdict().items():
            v = np.asarray(v)
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(t_np[k], v, err_msg=k)
            else:
                # float32 DLT (an SVD per row): 1e-3 of the distance
                np.testing.assert_allclose(t_np[k], v, rtol=1e-3, atol=1e-5, err_msg=k)
    assert n_new >= 5
