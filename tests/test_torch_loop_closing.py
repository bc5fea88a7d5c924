"""Place recognition, loop closing and map merging of the port against the
JAX package: Sim3 alignment and RANSAC, the pose graph in every chart, the
BoW vocabularies and keyframe databases, projection verification, the
LoopCloser on a map the JAX package built (tests/test_loop_closing.py's
circle), the Atlas merge, and MonoSlam with a vocabulary on the JAX
package's inline-loop and merge-after-loss scenes.

Randomness is JAX's: k-means seeds, Sim3 minimal sets, two-view and PnP
draws (with the two-view fits) are replayed into the port in call order.

Tolerances: umeyama within 1e-5; sim3_ransac the same inlier set (R, t, s
within 1e-4); the pose graph in float64 within 1e-9 in every chart and,
converged in float32, within 2e-4; BoW the same words and word ids, scores
within 1e-6, the same top-k with ties; the loop closer the same candidate
and the same decision at every gate (its log lines), corrected poses within
1e-4; Atlas.merge equal tables (positions within 1e-5); MonoSlam the same
state, loop and merge counters and Atlas size on every frame (so the same
loops_closed and map_merges), and on the merge scene the same keyframe
decisions and poses within 1e-3 (the inline-loop scene: 5e-2, see there).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import tensorize as jtz
from eorb_slam_tpu.geometry import camera as jcam, lie as jlie, sim3_solver as jss
from eorb_slam_tpu.geometry import twoview as jtv
from eorb_slam_tpu.ops import frontend as jfe
from eorb_slam_tpu.optim import pose_graph as jpg
from eorb_slam_tpu.retrieval import bow as jbow
from eorb_slam_tpu.slam import atlas as jat, loop_closing as jlc, map_state as jms
from eorb_slam_tpu.slam import relocalization as jrl, system as jsys
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.geometry import sim3_solver as tss, twoview as ttv
from eorb_slam_tpu_torch.optim import pose_graph as tpg
from eorb_slam_tpu_torch.retrieval import bow as tbow
from eorb_slam_tpu_torch.slam import atlas as tat, loop_closing as tlc
from eorb_slam_tpu_torch.slam import relocalization as trl, system as tsys
from tests.test_loop_closing import _circle_poses, _proj_verify_fixture, _tiny_map
from tests.test_torch_l2_slice import install_jax_draws

CAM = np.array(jcam.make_pinhole(458.0, 457.0, 376.0, 240.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and the f32 systems here amplify a reduction
    order's last bit (depth landmarks, weakly held landmarks in the small
    scenes), so the order is fixed rather than left to the core count. The
    process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _rand_desc(rng, n):
    return rng.integers(0, 2, (n, 256)).astype(np.int8) * 2 - 1


@pytest.fixture
def kmeans_draws(monkeypatch):
    """The port's k-means seeds are JAX's for the same seed."""
    install_kmeans_draws(monkeypatch)


def install_kmeans_draws(monkeypatch):
    def draw(seed, n, n_words, device):
        idx = jax.random.choice(jax.random.PRNGKey(seed), n, (n_words,),
                                replace=n < n_words)
        return torch.from_numpy(np.array(idx)).long().to(device)

    monkeypatch.setattr(tbow, "_draw_init_words", draw)


def _sim3_draw(key_of):
    def draw(generator, probs, n_hyp):
        idx = jax.random.choice(key_of(), probs.shape[0], (n_hyp, 3), replace=True,
                                p=jnp.asarray(probs.cpu().numpy()))
        return torch.from_numpy(np.array(idx)).long()
    return draw


@pytest.fixture
def replay(monkeypatch, kmeans_draws):
    """Every RANSAC of the JAX side records its key in call order; the
    port's call of the same number draws JAX's samples for that key (the
    two-view fits are JAX's too: tests/test_torch_l2_slice.py)."""
    return install_replay(monkeypatch)


def install_replay(monkeypatch):
    keys = install_jax_draws(monkeypatch)
    log = {"two": [], "pnp": [], "sim3": []}
    pos = dict.fromkeys(log, 0)

    def record(mod, name, which, at):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            log[which].append(a[at])
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    def replayed(mod, name, which):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            keys[which] = log[which][pos[which]]
            pos[which] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    record(jtv, "reconstruct_two_views", "two", 4)
    record(jrl, "pnp_ransac", "pnp", 4)
    record(jss, "sim3_ransac", "sim3", 3)
    replayed(ttv, "reconstruct_two_views", "two")
    replayed(trl, "pnp_ransac", "pnp")
    replayed(tss, "sim3_ransac", "sim3")
    monkeypatch.setattr(tss, "_draw_minimal_sets", _sim3_draw(lambda: keys["sim3"]))
    return log, pos


@pytest.fixture
def loop_log():
    """The eorb.loop gate decisions, in order (both packages log there)."""
    rec = []

    class H(logging.Handler):
        def emit(self, r):
            rec.append(r.getMessage())

    h = H()
    log = logging.getLogger("eorb.loop")
    log.addHandler(h)
    yield rec
    log.removeHandler(h)


# ---------------------------------------------------------------- Sim3


def test_umeyama_matches_jax():
    rng = np.random.default_rng(0)
    P = rng.normal(size=(64, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)))
    Q = (1.7 * P @ R.T + [0.5, -1.0, 2.0] + rng.normal(0, 0.01, P.shape)).astype(np.float32)
    w = rng.uniform(0, 1, 64).astype(np.float32)
    for kw in (dict(), dict(w=w), dict(w=w, with_scale=False)):
        jw = {k: (jnp.asarray(v) if k == "w" else v) for k, v in kw.items()}
        tw = {k: (_t(v) if k == "w" else v) for k, v in kw.items()}
        for a, b in zip(jss.umeyama(jnp.asarray(P), jnp.asarray(Q), **jw),
                        tss.umeyama(_t(P), _t(Q), **tw)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    # batched minimal triples, as the RANSAC fits them; of distinct points:
    # a triple with a repeated point leaves a rotation free, and each
    # eigensolver picks another member of that family
    idx = np.stack([rng.choice(64, 3, replace=False) for _ in range(32)])
    Rb, tb, sb = tss.umeyama(_t(P)[idx], _t(Q)[idx])
    Rj, tj, sj = jax.vmap(jss.umeyama)(jnp.asarray(P)[idx], jnp.asarray(Q)[idx])
    for a, b in ((Rj, Rb), (tj, tb), (sj, sb)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_sim3_ransac_matches_jax(monkeypatch):
    """tests/test_loop_closing.py's RANSAC with 30% outliers, JAX's draws."""
    rng = np.random.default_rng(1)
    N = 128
    P = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(3, 8, (N, 1))],
                       1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, 0.1, -0.05], jnp.float32)))
    Q = (1.3 * P @ R.T + [0.2, 0.1, -0.3]).astype(np.float32)
    out = rng.random(N) < 0.3
    Q[out] += rng.normal(0, 1.0, (out.sum(), 3)).astype(np.float32)
    valid = rng.random(N) > 0.1
    key = jax.random.PRNGKey(0)
    monkeypatch.setattr(tss, "_draw_minimal_sets", _sim3_draw(lambda: key))
    rj = jss.sim3_ransac(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(valid), key,
                         jnp.full(N, 9.21, jnp.float32), jnp.asarray(CAM), jnp.asarray(CAM))
    rt = tss.sim3_ransac(_t(P), _t(Q), _t(valid), torch.Generator(),
                         torch.full((N,), 9.21), _t(CAM), _t(CAM))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 0.8 * (~out & valid).sum()
    for a, b in ((rj.R, rt.R), (rj.t, rt.t), (rj.s, rt.s)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


# ---------------------------------------------------------------- pose graph


def _drifted_graph(K=12, E=32, chart="sim3"):
    T_gt = _circle_poses(K)
    T = T_gt.copy()
    err = np.eye(4, dtype=np.float32)
    for k in range(1, K):
        err = err @ np.asarray(jlie.se3_exp(jnp.asarray(
            [0.01, -0.005, 0.01, 0.002, 0.003, -0.002], jnp.float32)))
        T[k] = T_gt[k] @ err
    ei, ej, ew = np.zeros(E, np.int32), np.zeros(E, np.int32), np.zeros(E, np.float32)
    eR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    et, es = np.zeros((E, 3), np.float32), np.ones(E, np.float32)
    pairs = [(k, k + 1) for k in range(K - 1)] + [(K - 1, 0), (2, 5), (7, 3)]
    for n, (i, j) in enumerate(pairs):
        rel = T_gt[j] @ np.linalg.inv(T_gt[i])
        ei[n], ej[n], ew[n] = i, j, 1.0
        eR[n], et[n] = rel[:3, :3], rel[:3, 3]
    es[K - 1] = 1.05 if chart == "sim3" else 1.0     # a scale-drift loop edge
    fixed = np.zeros(K, bool)
    fixed[0] = True
    valid = np.ones(K, bool)
    valid[9] = False                                   # an empty slot
    return dict(R=T[:, :3, :3], t=T[:, :3, 3], s=np.ones(K, np.float32),
                kf_valid=valid, fixed=fixed, edge_i=ei, edge_j=ej, edge_R=eR,
                edge_t=et, edge_s=es, edge_w=ew)


@pytest.mark.parametrize("chart", ["sim3", "se3", "4dof"])
def test_optimize_pose_graph_matches_jax(chart):
    g = _drifted_graph(chart=chart)
    # float64, a few iterations: the same iterates
    with jax.enable_x64(True):
        gj = jpg.PoseGraph(**{k: jnp.asarray(v if v.dtype.kind in "biu" else
                                             v.astype(np.float64)) for k, v in g.items()})
        oj = jpg.optimize_pose_graph(gj, iters=4, chart=chart)
        oj = {k: np.asarray(getattr(oj, k)) for k in ("R", "t", "s")}
    gt = tpg.PoseGraph(**{k: torch.from_numpy(v if v.dtype.kind in "biu" else
                                              v.astype(np.float64)) for k, v in g.items()})
    ot = tpg.optimize_pose_graph(gt, iters=4, chart=chart)
    moved = np.abs(oj["t"] - g["t"]).max()
    assert moved > 1e-3
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(ot, k).numpy(), oj[k], atol=1e-9, rtol=0)
    # float32, converged
    gj = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})
    oj = jpg.optimize_pose_graph(gj, iters=20, chart=chart)
    ot = tpg.optimize_pose_graph(tpg.PoseGraph(**{k: _t(v) for k, v in g.items()}),
                                 iters=20, chart=chart)
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(ot, k).numpy(), np.asarray(getattr(oj, k)),
                                   atol=2e-4)


def test_relative_sim3_and_correct_landmarks_match_jax():
    rng = np.random.default_rng(3)
    K, M = 12, 50
    g = _drifted_graph(K=K)
    R2 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.1, (K, 3)), jnp.float32)))
    t2, s2 = rng.normal(size=(K, 3)).astype(np.float32), rng.uniform(0.8, 1.2, K).astype(np.float32)
    args = (g["R"], g["t"], g["s"], R2, t2, s2)
    for a, b in zip(jpg.relative_sim3(*(jnp.asarray(x) for x in args)),
                    tpg.relative_sim3(*(_t(x) for x in args))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    pos = rng.normal(size=(M, 3)).astype(np.float32)
    ref = rng.integers(0, K, M).astype(np.int32)
    valid = rng.random(M) > 0.2
    cj = jpg.correct_landmarks(jnp.asarray(pos), jnp.asarray(ref), jnp.asarray(valid),
                               *(jnp.asarray(x) for x in args))
    ct = tpg.correct_landmarks(_t(pos), _t(ref), _t(valid), *(_t(x) for x in args))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)


# ---------------------------------------------------------------- BoW


def test_train_vocab_and_quantize_match_jax(kmeans_draws):
    rng = np.random.default_rng(3)
    descs = _rand_desc(rng, 300)
    for n_words, iters in ((16, 4), (512, 2)):        # without / with replacement
        wj = np.asarray(jbow.train_vocab(jnp.asarray(descs), n_words, iters=iters, seed=5))
        wt = tbow.train_vocab(_t(descs), n_words, iters=iters, seed=5).numpy()
        np.testing.assert_array_equal(wt, wj)
    valid = rng.random(300) > 0.2
    idj, bj = jbow.quantize(jnp.asarray(descs), jnp.asarray(valid), jnp.asarray(wj))
    idt, bt = tbow.quantize(_t(descs), _t(valid), _t(wj))
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)


def test_detect_candidates_matches_jax():
    """Dense database: the common-word gate, L1 scores, the exclusion mask
    and equal scores (duplicated rows) kept in slot order."""
    rng = np.random.default_rng(2)
    words = _rand_desc(rng, 64)
    frames = [_rand_desc(rng, 100) for _ in range(5)]
    frames += [frames[0], frames[2], frames[0]]        # ties
    dbj, dbt = jbow.empty_database(10, 64), tbow.empty_database(10, 64)
    bows = []
    for i, d in enumerate(frames):
        _, b = jbow.quantize(jnp.asarray(d), jnp.ones(100, bool), jnp.asarray(words))
        bows.append(np.asarray(b))
        if i < 7:
            dbj, dbt = jbow.add_keyframe(dbj, i, b), tbow.add_keyframe(dbt, i, _t(b))
    dbj, dbt = jbow.erase_keyframe(dbj, 2), tbow.erase_keyframe(dbt, 2)
    for k, v in convert.database_to_numpy(dbt).items():
        np.testing.assert_allclose(v, np.asarray(getattr(dbj, k)), atol=1e-7)
    for excl in ([4], [], [0, 5]):
        mask = np.zeros(10, bool)
        mask[excl] = True
        sj, ij = jbow.detect_candidates(dbj, jnp.asarray(bows[7]), jnp.asarray(mask), top_k=4)
        st, it = tbow.detect_candidates(dbt, _t(bows[7]), _t(mask), top_k=4)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(tbow.all_scores(dbt, _t(bows[7])).numpy(),
                               np.asarray(jbow.all_scores(dbj, jnp.asarray(bows[7]))),
                               atol=1e-6)


def test_hier_vocab_and_sparse_database_match_jax(kmeans_draws):
    rng = np.random.default_rng(4)
    descs = _rand_desc(rng, 600)
    vj = jbow.train_hier_vocab(jnp.asarray(descs), K1=8, K2=8, iters=4, seed=3)
    vt = tbow.train_hier_vocab(_t(descs), K1=8, K2=8, iters=4, seed=3)
    for k in ("words1", "words2", "weights"):
        np.testing.assert_array_equal(getattr(vt, k).numpy(), np.asarray(getattr(vj, k)))
    vt = convert.vocab_from_numpy(vj)
    dbj, dbt = jbow.empty_sparse_database(6, 128), tbow.empty_sparse_database(6, 128)
    qs = []
    for i in range(6):
        d = descs[rng.choice(600, 128, replace=False)] if i < 5 else descs[:128]
        valid = rng.random(128) > 0.1
        wj, ww = jbow.quantize_hier(jnp.asarray(d), jnp.asarray(valid), vj)
        wt, wwt = tbow.quantize_hier(_t(d), _t(valid), vt)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(wwt.numpy(), np.asarray(ww))
        rj, rt = jbow.sparse_bow_row(wj, ww), tbow.sparse_bow_row(wt, wwt)
        np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
        np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), atol=1e-6)
        qs.append((wj, ww))
        if i < 5:
            dbj = jbow.sparse_add_keyframe(dbj, i, wj, ww)
            dbt = tbow.sparse_add_keyframe(dbt, i, wt, wwt)
    dbj, dbt = jbow.sparse_erase_keyframe(dbj, 3), tbow.sparse_erase_keyframe(dbt, 3)
    qj = jbow.sparse_bow_row(*qs[5])
    qt = tuple(_t(x) for x in qj)
    mask = np.zeros(6, bool)
    mask[1] = True
    sj, ij = jbow.sparse_detect_candidates(dbj, *qj, jnp.asarray(mask), top_k=3)
    st, it = tbow.sparse_detect_candidates(dbt, *qt, _t(mask), top_k=3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(tbow.sparse_all_scores(dbt, *qt).numpy(),
                               np.asarray(jbow.sparse_all_scores(dbj, *qj)), atol=1e-6)


def test_vocab_text_importers_match_jax(tmp_path, kmeans_draws):
    """ORBvoc.txt-format files written here (no download): the flat leaf
    codebook, and the 2-level import with the balanced cells."""
    rng = np.random.default_rng(2)
    n = 600
    base = rng.integers(0, 2, (60, 32), dtype=np.uint8) * 255
    rows = ["0 0 " + " ".join(["0"] * 32) + " 0.0"]        # an inner node
    for i in range(n):
        by = base[i % 60] if i < n // 2 else rng.integers(0, 256, 32, dtype=np.uint8)
        rows.append("0 1 " + " ".join(str(int(b)) for b in by)
                    + f" {rng.uniform(0.1, 1.0):.4f}")
    path = tmp_path / "voc.txt"
    path.write_text("10 6 0 0\n" + "\n".join(rows) + "\n")
    np.testing.assert_array_equal(tbow.load_vocab_text(str(path), max_words=500),
                                  jbow.load_vocab_text(str(path), max_words=500))
    vj = jbow.load_vocab_text_hier(str(path), K1=16)
    vt = tbow.load_vocab_text_hier(str(path), K1=16, device="cpu")
    for k in ("words1", "words2", "weights"):
        np.testing.assert_array_equal(getattr(vt, k).numpy(), np.asarray(getattr(vj, k)))
    sim = rng.normal(0, 1, (700, 8)).astype(np.float32)
    sim[:500, 3] += 50.0
    np.testing.assert_array_equal(tbow.balanced_cells(sim, 100),
                                  jbow.balanced_cells(sim, 100))


# ---------------------------------------------------------------- loop closer


@pytest.mark.parametrize("aliased", [False, True])
def test_projection_verify_matches_jax(aliased):
    m = _proj_verify_fixture(np.random.default_rng(12 if aliased else 11), aliased)
    args = (m.kf_T[0], m.kf_T[1], m.kf_feat_lm[0], m.kf_feat_valid[0], m.kf_desc_pm1[0],
            m.lm_pos, m.lm_desc_pm1, m.kf_xy[1], m.kf_desc_pm1[1], m.kf_feat_valid[1])
    nj = int(jlc._projection_verify(jnp.asarray(CAM), *args, jnp.eye(3), jnp.zeros(3),
                                    jnp.asarray(1.0), jnp.asarray(752.0), jnp.asarray(480.0)))
    nt = int(tlc._projection_verify(_t(CAM), *(_t(a) for a in args), torch.eye(3),
                                    torch.zeros(3), torch.tensor(1.0), 752.0, 480.0))
    assert nt == nj and (nj < 40 if aliased else nj >= 40)


def _circle_map():
    """tests/test_loop_closing.py's closed circle of 10 KFs: the last one
    revisits KF0's view through drifted duplicate landmarks."""
    rng = np.random.default_rng(7)
    K, N, M = 10, 96, 300
    T_full = _circle_poses(K - 1, radius=4.0)
    T_gt = np.concatenate([T_full, T_full[:1]], axis=0)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (M, 2)), rng.uniform(-1.5, 1.5, (M, 1))],
                         1).astype(np.float32)
    descs = _rand_desc(rng, M)
    m = jms.empty_map(K=16, M=512, N=N, P=12)
    m = m._replace(lm_pos=m.lm_pos.at[:M].set(jnp.asarray(pts)),
                   lm_valid=m.lm_valid.at[:M].set(True))
    T_est = T_gt.copy()
    err = np.eye(4, dtype=np.float32)
    for k in range(1, K):
        err = err @ np.asarray(jlie.se3_exp(jnp.asarray(
            [0.02, 0.0, 0.01, 0.004, 0.0, -0.004], jnp.float32)))
        T_est[k] = T_gt[k] @ err

    def window(k):
        return (np.arange(N) + (k * M) // (K - 1) - N // 2) % M

    def insert(m, k, T_true, lm_ids, vis):
        pc = pts[vis] @ T_true[:3, :3].T + T_true[:3, 3]
        uv = np.asarray(jcam.pinhole_project_linear(jnp.asarray(CAM), jnp.asarray(pc)))
        return jms.insert_keyframe(
            m, jnp.asarray(k), jnp.asarray(T_est[k]), float(k), jnp.asarray(uv),
            jnp.zeros(N, jnp.int32), jnp.zeros(N), jnp.asarray(descs[vis]),
            jnp.ones(N, bool), jnp.asarray(lm_ids.astype(np.int32)))

    for k in range(K - 1):
        m = insert(m, k, T_gt[k], window(k), window(k))
    vis = window(0)
    pc_true = pts[vis] @ T_gt[K - 1][:3, :3].T + T_gt[K - 1][:3, 3]
    Twc = np.linalg.inv(T_est[K - 1])
    dup = M + np.arange(N)
    m = m._replace(
        lm_pos=m.lm_pos.at[jnp.asarray(dup)].set(jnp.asarray(
            (pc_true @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32))),
        lm_valid=m.lm_valid.at[jnp.asarray(dup)].set(True),
        lm_first_kf=m.lm_first_kf.at[jnp.asarray(dup)].set(K - 1))
    m = insert(m, K - 1, T_gt[K - 1], dup, vis)
    return m, descs


@pytest.mark.parametrize("vocab,state", [("flat", "own"), ("flat", "converted"),
                                         ("hier", "own")])
def test_loop_closer_matches_jax(vocab, state, replay, loop_log):
    """detect_and_correct on the JAX-built circle map: with the reference's
    consistency gate of 3 the first two queries are rejected by the chain
    and the third welds; then the cooldown. With ``converted`` the port's
    closer starts from the JAX closer's database and counters."""
    jm, descs = _circle_map()
    tm = convert.map_state_from_numpy(_np(jm))
    if vocab == "flat":
        words = jbow.train_vocab(jnp.asarray(descs), 32, iters=3)
    else:
        words = jbow.train_hier_vocab(jnp.asarray(descs), K1=8, K2=8, iters=4)
    kw = dict(Kmax=16, min_inliers=15, consistency_required=3, sparse_words_per_kf=96)
    jl = jlc.LoopCloser(jnp.asarray(CAM), words, **kw)
    tl = tlc.LoopCloser(CAM, convert.vocab_from_numpy(
        words if vocab == "flat" else words._asdict()), device="cpu", **kw)
    assert tl.hier == (vocab == "hier")
    for lc in (jl, tl):
        lc.min_candidate_gap = 5
    for k in range(9):
        jl.add_keyframe(jm, k)
        if state == "own":
            tl.add_keyframe(tm, k)
    if state == "converted":
        jstate = dict(db=_np(jl.db), chains=jl._chains, kf_count=jl._kf_count,
                      last_loop_kfc=jl._last_loop_kfc, added_at=jl._added_at)
        convert.loop_closer_state_from_numpy(tl, jstate)
        back = convert.loop_closer_state_to_numpy(tl)
        assert {k: v for k, v in back.items() if k != "db"} == \
            {k: v for k, v in jstate.items() if k != "db"}
    for k, v in convert.database_to_numpy(tl.db).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jl.db, k)), atol=1e-6)
    infos = []
    for call in range(4):
        n0 = len(loop_log)
        jm2, ij = jl.detect_and_correct(jm, 9, run_gba=call < 3)
        gj = loop_log[n0:]
        n0 = len(loop_log)
        tm2, it = tl.detect_and_correct(tm, 9, run_gba=call < 3)
        gt = loop_log[n0:]
        assert it.detected == ij.detected and it.matched == ij.matched, (call, ij, it)
        assert it.n_inliers == ij.n_inliers and abs(it.scale - ij.scale) < 1e-4
        assert [g.split()[:2] for g in gt] == [g.split()[:2] for g in gj], (gj, gt)
        infos.append(ij)
        if ij.detected:
            np.testing.assert_allclose(tm2.kf_T.numpy(), np.asarray(jm2.kf_T), atol=1e-4)
            np.testing.assert_allclose(tm2.lm_pos.numpy(), np.asarray(jm2.lm_pos), atol=1e-4)
            for k in ("kf_feat_lm", "obs_valid", "lm_valid"):
                np.testing.assert_array_equal(getattr(tm2, k).numpy(), np.asarray(getattr(jm2, k)))
            assert tl.last_fuse_count == jl.last_fuse_count
    assert [i.detected for i in infos] == [False, False, True, False]
    assert infos[0].matched == 0 and infos[3].matched == -1          # cooldown


def test_atlas_merge_matches_jax():
    rng = np.random.default_rng(6)
    ja = jat.Atlas(K=8, M=128, N=32, P=8)
    ta = tat.Atlas(K=8, M=128, N=32, P=8, device="cpu")
    m0, m1 = _tiny_map(rng, K_kf=2), _tiny_map(rng, K_kf=3)
    ja.current, ta.current = m0, convert.map_state_from_numpy(_np(m0))
    ja.create_new_map()
    ta.create_new_map()
    ja.current, ta.current = m1, convert.map_state_from_numpy(_np(m1))
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t, s = np.asarray([0.3, -0.1, 0.2], np.float32), np.float32(1.3)
    mj = ja.merge(0, jnp.asarray(R), jnp.asarray(t), jnp.asarray(s))
    mt = ta.merge(0, R, t, s)
    assert ta.n_maps() == ja.n_maps() == 1 and ta.active == ja.active == 0
    a, b = convert.map_state_to_numpy(mt), _np(mj)
    for k in a:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["kf_valid"].sum() == 5


# ---------------------------------------------------------------- MonoSlam


W, H, F = 240, 180, 200.0


def _renderer(rng, n):
    """The JAX tests' dot scene (their tensorize splat), as numpy images."""
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(6, 12, n)], 1)
    amp = rng.uniform(0.3, 1.0, n)

    def render(Tcw):
        pc = (Tcw[:3, :3] @ pts.T).T + Tcw[:3, 3]
        uv = np.stack([F * pc[:, 0] / pc[:, 2] + W / 2, F * pc[:, 1] / pc[:, 2] + H / 2],
                      1).astype(np.float32)
        ok = (pc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < H)
        img = jtz.splat_gauss(jnp.asarray(uv), jnp.asarray(ok),
                              jnp.asarray(amp, jnp.float32), H, W, sigma=1.2)
        return (np.asarray(jtz.normalize_to_image(img)) * 255.0).astype(np.float32)

    return render


def _both_slams(render0, **kw):
    cam = np.array(jcam.make_pinhole(F, F, W / 2, H / 2))
    f0 = jfe.extract(jnp.asarray(render0), max_kp=256)
    words = jbow.train_vocab(f0.desc_pm1, 32, iters=3)
    kw = dict(img_w=W, img_h=H, N=256, min_init_matches=30, min_track_inliers=8, **kw)
    jslam = jsys.MonoSlam(jnp.asarray(cam), loop_words=words, **kw)
    tslam = tsys.MonoSlam(cam, loop_words=convert.vocab_from_numpy(words),
                          device="cpu", **kw)
    return jslam, tslam


def _step_both(jslam, tslam, img, ts):
    """One frame through both; the same state, recovery flags, loop and
    merge counters and Atlas size. Returns (rj, rt, largest pose
    difference)."""
    rj = jslam.process_image(jnp.asarray(img), ts)
    rt = tslam.process_image(torch.from_numpy(img), ts)
    assert rt["state"] == rj["state"], (ts, rj, rt)
    for k in ("reloc", "new_map"):
        assert rt.get(k) == rj.get(k), (ts, rj, rt)
    assert (tslam.loops_closed, tslam.map_merges, tslam.atlas.n_maps()) == \
        (jslam.loops_closed, jslam.map_merges, jslam.atlas.n_maps()), ts
    return rj, rt, float(np.abs(tslam.T_last.numpy() - np.asarray(jslam.T_last)).max())


def test_monoslam_inline_loop_matches_jax(replay):
    """tests/test_loop_closing.py's out-and-back run with loop_words (here
    34 of its 54 frames, K=32 as the merge scene: one JAX compile for both):
    place recognition on every keyframe past the gap, and no (false) loop on
    either side. Poses within 5e-2 only: on this 240x180 dot scene the f32
    init BA leaves a few weakly constrained landmarks 3.5e-2 apart between
    the packages (with or without a vocabulary), and from frame 7 a
    triangulation on its threshold parts the runs (ROADMAP.md Queue 3)."""
    render = _renderer(np.random.default_rng(5), 400)

    def pose(t):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-1.5 * (2 * t if t < 0.5 else 2 * (1 - t)),
                    -0.15 * np.sin(2 * np.pi * t), 0.0]
        return T

    jslam, tslam = _both_slams(render(pose(0.0)), K=32, M=4096,
                               max_frames_between_kf=3, loop_min_gap=10)
    for i in range(34):
        assert _step_both(jslam, tslam, render(pose(i / 48)), i * 0.1)[2] < 5e-2, i
    assert abs(tslam.stats["kf"] - jslam.stats["kf"]) <= 1
    assert tslam.loop_closer._kf_count >= tslam.loop_min_gap       # detection ran
    assert tslam.loops_closed == jslam.loops_closed == 0
    assert tslam.stats["lost"] == jslam.stats["lost"] == 0
    assert int(tslam.loop_closer.db.valid.sum()) == tslam.stats["kf"]


def test_monoslam_merge_after_loss_matches_jax(replay):
    """tests/test_loop_closing.py's merge scene (its three phases; the
    weld comes on the 10th frame of the third, and the last five track the
    welded map): map, black out until the Atlas stores the map, re-map the
    same scene from another spot: the stored map's BoW index is hit and the
    Sim3 weld merges the two, on the same frame in both packages."""
    render = _renderer(np.random.default_rng(8), 300)

    def at(x, y=0.0):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-x, -y, 0.0]
        return render(T)

    jslam, tslam = _both_slams(at(0.0), K=32, M=4096, max_frames_between_kf=2,
                               loop_min_gap=99)
    for s in (jslam, tslam):
        s.lost_grace = 2
    frames = [(at(float(x)), 0.1 * i) for i, x in enumerate(np.arange(0.0, 1.4, 0.04))]
    frames += [(np.zeros((H, W), np.float32), 10.0 + 0.1 * k) for k in range(6)]
    frames += [(at(float(x), 0.05), 20.0 + 0.1 * i)
               for i, x in enumerate(np.arange(0.3, 1.2, 0.06))]
    for img, ts in frames:
        rj, rt, d = _step_both(jslam, tslam, img, ts)
        assert rt.get("kf") == rj.get("kf") and tslam.n_kf == jslam.n_kf, ts
        assert d < 1e-3, ts
        if ts == 10.5:             # the blackout stored the map
            assert tslam.atlas.n_maps() == 2 and len(tslam._stored_dbs) == 1
    assert tslam.map_merges == jslam.map_merges >= 1
    assert tslam.atlas.n_maps() == 1 and tslam._kf_order == jslam._kf_order
    assert tslam.stats["lm"] == jslam.stats["lm"]
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=1e-3)
