"""Duplicate fusion, the medoid descriptor refresh and the covisibility
graph of the port against the JAX package, from one JAX map carried across
by ``convert``: a JAX MonoSlam runs SynthWorld frames, then duplicates of
landmarks shared by two keyframes are injected into the map (numpy edits),
among them two groups whose candidate pairs tie exactly in descriptor
distance: one where the tied pairs share the loser, one where they share
the winner. The repeated-index scatters of ``fuse_duplicates`` then decide
the result, and XLA's CPU scatter (the later update wins) is the reference.

Tolerances: everything here is integer / copy logic, so the integer tables,
``n_fused``, the refreshed descriptors and the covisibility counts are
equal. ``keyframe_mapping_step(do_fuse=True, refresh_desc=True)``: integer
tables and descriptors equal, poses and landmarks 1e-4 relative to their
scale, BA costs rel 1e-3 (f32 LM in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from eorb_slam_tpu.slam import covisibility as jcov, local_mapping as jlm
from eorb_slam_tpu.slam import map_state as jms
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.slam import covisibility as tcov, local_mapping as tlm
from tests.synth import CAM
from tests.test_torch_map import (INT_FIELDS, _assert_maps_equal, _np_map, _t,
                                  _track_both, jax_run)  # noqa: F401 (fixture)


TABLES = ("kf_feat_lm", "obs_kf", "obs_feat", "obs_valid", "lm_valid",
          "lm_nobs", "lm_desc_pm1")


def _inject(ref, a, b):
    """12 clones and the two tie groups of ``chip_smoke._inject_duplicates``
    (the same edits the card check makes)."""
    return chip_smoke._inject_duplicates(ref, a, b, n_simple=12)


def _fuse_both(mdict, a, b):
    jm, jn = jlm.fuse_duplicates(
        jms.MapState(**{k: jnp.asarray(v) for k, v in mdict.items()}),
        jnp.asarray(CAM), jnp.asarray(a), jnp.asarray(b))
    tm, tn = tlm.fuse_duplicates(convert.map_state_from_numpy(mdict, "cpu"),
                                 _t(CAM), a, b)
    return jm, int(jn), tm, int(tn)


def test_fuse_duplicates_with_injected_duplicates_and_ties(jax_run):
    slam = jax_run[0]
    order = slam._kf_order
    a, b = order[-1], order[-2]
    mdict, ties = _inject(_np_map(slam.map), a, b)
    jm, jn, tm, tn = _fuse_both(mdict, a, b)
    assert tn == jn and jn >= 12 + 4
    ref = _np_map(jm)
    _assert_maps_equal(tm, ref, TABLES)
    _assert_maps_equal(tm, ref)                       # every other field too
    # the ties were real, and the pair later in feature order won them
    lose, win = ties
    later = int(np.argmax(lose["fa"]))
    assert not ref["lm_valid"][lose["x"]]
    assert ref["lm_valid"][list(lose["l"])].all()
    assert (ref["kf_feat_lm"][b, list(lose["fb"])] == lose["l"][later]).all()
    later = int(np.argmax(win["fa"]))
    assert ref["lm_valid"][win["x"]] and not ref["lm_valid"][list(win["l"])].any()
    assert ref["lm_nobs"][win["x"]] == 4
    src = win["l"][later]
    col = int(np.flatnonzero(mdict["obs_valid"][src])[0])   # its first observation
    assert ref["obs_feat"][win["x"], 3] == mdict["obs_feat"][src, col]
    assert ref["obs_kf"][win["x"], 3] == mdict["obs_kf"][src, col]
    # links are consistent: no feature points at a dead landmark
    got = convert.map_state_to_numpy(tm)
    l = got["kf_feat_lm"]
    assert got["lm_valid"][l[l >= 0]].all()


@pytest.mark.parametrize("pair", ["newest-oldest", "self", "no-duplicates"])
def test_fuse_duplicates_other_pairs(jax_run, pair):
    slam = jax_run[0]
    order = slam._kf_order
    ref0 = _np_map(slam.map)
    if pair == "newest-oldest":
        a, b = order[-1], order[0]
        mdict = ref0
    elif pair == "self":
        a = b = order[-1]
        mdict, _ = _inject(ref0, order[-1], order[-2])
    else:
        a, b = order[-1], order[-2]
        mdict = ref0
    jm, jn, tm, tn = _fuse_both(mdict, a, b)
    assert tn == jn
    _assert_maps_equal(tm, _np_map(jm))


def test_update_landmark_descriptors_matches_jax(jax_run):
    slam = jax_run[0]
    mdict, _ = _inject(_np_map(slam.map), slam._kf_order[-1], slam._kf_order[-2])
    # rows with 2 observations tie exactly (both medoid scores equal): the
    # first column must win, as jnp.argmin
    nobs = mdict["obs_valid"].sum(1)
    assert (nobs[mdict["lm_valid"]] == 2).sum() >= 10
    assert (nobs[mdict["lm_valid"]] >= 3).sum() >= 10
    jm = jlm.update_landmark_descriptors(
        jms.MapState(**{k: jnp.asarray(v) for k, v in mdict.items()}))
    tm = tlm.update_landmark_descriptors(convert.map_state_from_numpy(mdict, "cpu"))
    ref = _np_map(jm)
    assert (ref["lm_desc_pm1"] != mdict["lm_desc_pm1"]).any()   # it moved some
    _assert_maps_equal(tm, ref)


def test_local_ba_with_refresh_matches_jax(jax_run):
    slam = jax_run[0]
    ref0 = _np_map(slam.map)
    kf_free = np.zeros(slam.map.K, bool)
    kf_free[slam._kf_order[2:]] = True
    jm, jc0, jc1 = jlm.local_ba(slam.map, jnp.asarray(CAM), jnp.asarray(kf_free),
                                iters=8, refresh_desc=True)
    tm, tc0, tc1 = tlm.local_ba(convert.map_state_from_numpy(ref0, "cpu"), _t(CAM),
                                _t(kf_free), iters=8, refresh_desc=True)
    _assert_maps_equal(tm, _np_map(jm), INT_FIELDS)
    np.testing.assert_allclose([float(tc0), float(tc1)],
                               [float(jc0), float(jc1)], rtol=1e-3)


def test_keyframe_mapping_step_with_fusion_and_refresh(jax_run):
    slam, f, T_pred = jax_run
    jres, _, tmap = _track_both(slam, f, T_pred)
    order = slam._kf_order
    slot = int(np.flatnonzero(~np.asarray(slam.map.kf_valid))[0])
    tri = [order[-k] if k <= len(order) else slot for k in range(1, 5)]
    fuse_nb = list(order[-4:-1])
    kf_free = np.zeros(slam.map.K, bool)
    kf_free[order[max(2, len(order) - 4):]] = True
    kf_free[slot] = True
    args = (f.ts, f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid, jres.feat_lm)
    jm, jT, jst = jlm.keyframe_mapping_step(
        slam.map, CAM, jnp.asarray(slot), jres.Tcw, *args,
        jnp.asarray(tri, jnp.int32), jnp.asarray(fuse_nb, jnp.int32),
        jnp.asarray(kf_free), do_fuse=True, refresh_desc=True)
    i64 = torch.int64
    tm, tT, tst = tlm.keyframe_mapping_step(
        tmap, _t(CAM), torch.tensor(slot, dtype=i64), _t(jres.Tcw),
        torch.tensor(f.ts, dtype=torch.float32), *map(_t, args[1:]),
        torch.tensor(tri, dtype=i64), torch.tensor(fuse_nb, dtype=i64), _t(kf_free),
        do_fuse=True, refresh_desc=True)
    ref = _np_map(jm)
    got = convert.map_state_to_numpy(tm)
    _assert_maps_equal(tm, ref, INT_FIELDS)
    for k in ("kf_T", "lm_pos"):
        v = ref["lm_valid"] if k == "lm_pos" else ref["kf_valid"]
        np.testing.assert_allclose(got[k][v], ref[k][v], rtol=0,
                                   atol=1e-4 * np.abs(ref[k][v]).max())
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_array_equal(tst.numpy()[[0, 1, 4, 5, 6]],
                                  np.asarray(jst)[[0, 1, 4, 5, 6]])
    np.testing.assert_allclose(tst.numpy()[2:4], np.asarray(jst)[2:4], rtol=1e-3)


# ------------------------------------------------------------ covisibility

@pytest.mark.parametrize("injected", [False, True])
def test_covisibility_matches_jax(jax_run, injected):
    slam = jax_run[0]
    mdict = _np_map(slam.map)
    if injected:
        mdict, _ = _inject(mdict, slam._kf_order[-1], slam._kf_order[-2])
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in mdict.items()})
    tm = convert.map_state_from_numpy(mdict, "cpu")
    np.testing.assert_array_equal(tcov.obs_indicator(tm).numpy(),
                                  np.asarray(jcov.obs_indicator(jm)))
    C = np.asarray(jcov.shared_counts(jm))
    np.testing.assert_array_equal(tcov.shared_counts(tm).numpy(), C)
    assert C.max() >= 30 and (C == C.T).all()
    for kf in slam._kf_order:
        it, wt = tcov.covisible_neighbors(tm, kf, top_k=5)
        ij, wj = jcov.covisible_neighbors(jm, jnp.asarray(kf), top_k=5)
        # equal counts (and the zeros of empty slots) keep the lower slot
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        for th in (15, 60):
            np.testing.assert_array_equal(
                tcov.covisibility_mask(tm, kf, th).numpy(),
                np.asarray(jcov.covisibility_mask(jm, jnp.asarray(kf), th)))


def test_covisible_neighbors_tie_order():
    """Small integer counts tie all the time: among equal counts the lower
    keyframe slot comes first, on any device."""
    from eorb_slam_tpu_torch.slam import map_state as tms

    m = tms.empty_map(K=6, M=8, N=4, P=4, device="cpu")
    obs_kf = torch.tensor([[0, 1, 2, 3]] * 8, dtype=torch.int32)
    m = m._replace(obs_kf=obs_kf, obs_valid=torch.ones(8, 4, dtype=torch.bool),
                   lm_valid=torch.ones(8, dtype=torch.bool),
                   kf_valid=torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.bool))
    idx, w = tcov.covisible_neighbors(m, 1, top_k=4)
    assert idx.tolist() == [0, 2, 3, 1] and w.tolist() == [8.0, 8.0, 8.0, 0.0]
