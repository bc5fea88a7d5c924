"""The port's map state, tracking and keyframe mapping against the JAX
package, started from the same map: a JAX MonoSlam runs a few SynthWorld
frames, and its MapState crosses to the port through
``convert.map_state_from_numpy``.

Tolerances: the map_state functions are integer/copy logic and must agree
exactly (every field), including the duplicate-index scatters that send
masked-out updates to slot 0 (XLA's CPU scatter keeps the last duplicate;
the port picks the same one on purpose). ``median_scene_depth`` exactly.
``track_frame``: feat_lm equal on >= 98% of features, Tcw within 1e-4.
``keyframe_mapping_step``: the map's integer tables equal, poses and
landmarks within 1e-4 (relative to their scale), BA costs rel 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.slam import local_mapping as jlm, map_state as jms
from eorb_slam_tpu.slam import system as jsys, tracking as jtr
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.slam import local_mapping as tlm, map_state as tms
from eorb_slam_tpu_torch.slam import tracking as ttr
from tests.synth import CAM, H, W, SynthWorld

INT_FIELDS = ("kf_valid", "kf_octave", "kf_feat_valid", "kf_feat_lm",
              "lm_valid", "lm_nobs", "lm_first_kf", "obs_kf", "obs_feat",
              "obs_valid", "kf_desc_pm1", "lm_desc_pm1")
N_SLOTS = 256


def _np_map(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def _assert_maps_equal(got, ref, fields=tms.MapState._fields):
    got = convert.map_state_to_numpy(got)
    for k in fields:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _t(x):
    return torch.from_numpy(np.array(x))


def _slot(x):
    """Keyframe slots as the mapping step takes them: int64 tensors."""
    return torch.as_tensor(x, dtype=torch.int64)


def _ts(x):
    """A timestamp as the mapping step takes it: a () float32 tensor."""
    return torch.tensor(x, dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX MonoSlam after 10 SynthWorld frames (several keyframes, full
    observation rows), plus the next frame and its predicted pose."""
    world = SynthWorld(n_landmarks=320, seed=4, noise_px=0.4)
    slam = jsys.MonoSlam(CAM, K=8, M=1024, N=N_SLOTS, P=4, min_init_matches=60,
                         max_frames_between_kf=2)
    slam.fuse_enabled = slam.desc_refresh = False
    for i in range(10):
        f, _ = world.frame(i / 20.0, n_slots=N_SLOTS, n_clutter=30, seed=i)
        slam.process_features(f)
    slam._drain_mapping()
    assert slam.state == jsys.OK and slam.n_kf >= 4
    f, _ = world.frame(10 / 20.0, n_slots=N_SLOTS, n_clutter=30, seed=10)
    T_pred = np.asarray(slam.velocity @ slam.T_last)
    return slam, f, T_pred


def test_map_roundtrip_through_convert(jax_run):
    slam, _, _ = jax_run
    ref = _np_map(slam.map)
    m = convert.map_state_from_numpy(ref, "cpu")
    assert m.K == 8 and m.M == 1024 and m.N == N_SLOTS and m.P == 4
    _assert_maps_equal(m, ref)


def test_alloc_landmarks_duplicate_slot0_on_fresh_map():
    """ok = [T, F, F, T, F, F, F, F] on a fresh map: candidate 0 gets id 0,
    but the rejected candidates' write-backs to slot 0 come later and win,
    so lm_valid[0] stays False (the reference's behaviour, reproduced)."""
    rng = np.random.default_rng(0)
    C = 8
    ok = np.array([1, 0, 0, 1, 0, 0, 0, 0], bool)
    pos = rng.normal(size=(C, 3)).astype(np.float32)
    desc = (rng.integers(0, 2, (C, 256)) * 2 - 1).astype(np.int8)
    fa = np.arange(C, dtype=np.int32)
    fb = np.where(ok, rng.permutation(C), 0).astype(np.int32)
    jm, jids = jms.alloc_landmarks(jms.empty_map(4, 16, C, 4), jnp.asarray(pos),
                                   jnp.asarray(desc), jnp.asarray(ok),
                                   jnp.asarray(0), jnp.asarray(fa),
                                   jnp.asarray(1), jnp.asarray(fb))
    tm, tids = tms.alloc_landmarks(tms.empty_map(4, 16, C, 4), _t(pos), _t(desc),
                                   _t(ok), 0, _t(fa), 1, _t(fb))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    ref = _np_map(jm)
    _assert_maps_equal(tm, ref)
    assert int(tids[0]) == 0 and not bool(tm.lm_valid[0])
    assert int(tids[3]) == 1 and bool(tm.lm_valid[1])


@pytest.mark.parametrize("slot_kind", ["free", "reused"])
def test_insert_keyframe_equal(jax_run, slot_kind):
    slam, f, _ = jax_run
    ref_map = _np_map(slam.map)
    rng = np.random.default_rng(1)
    kv = ref_map["kf_valid"]
    slot = int(np.flatnonzero(~kv)[0] if slot_kind == "free" else np.flatnonzero(kv)[1])
    lm_ids = np.flatnonzero(ref_map["lm_valid"])
    feat_lm = np.where(rng.random(N_SLOTS) < 0.6, rng.choice(lm_ids, N_SLOTS), -1)
    feat_lm[:6] = lm_ids[0]                      # several features -> one landmark
    full = np.flatnonzero(ref_map["obs_valid"].all(1) & ref_map["lm_valid"])
    assert len(full) > 0
    feat_lm[10:20] = full[:10].repeat(2)[:10]    # rows with no free column
    feat_lm = feat_lm.astype(np.int32)
    T = np.asarray(slam.T_last)
    args_np = (T, np.float32(0.55), np.asarray(f.xy_ud), np.asarray(f.octave),
               np.asarray(f.angle), np.asarray(f.desc_pm1), np.asarray(f.valid),
               feat_lm)
    jm = jms.insert_keyframe(slam.map, jnp.asarray(slot), *map(jnp.asarray, args_np))
    tm = tms.insert_keyframe(convert.map_state_from_numpy(ref_map), slot,
                             *map(_t, args_np))
    _assert_maps_equal(tm, _np_map(jm))


def test_alloc_remove_redundancy_depth_equal(jax_run):
    slam, _, _ = jax_run
    ref_map = _np_map(slam.map)
    tmap = convert.map_state_from_numpy(ref_map)
    rng = np.random.default_rng(2)
    N = N_SLOTS
    kv = np.flatnonzero(ref_map["kf_valid"])
    ka, kb = int(kv[-1]), int(kv[-2])
    ok = rng.random(N) < 0.3
    pos = rng.normal(0, 3, (N, 3)).astype(np.float32)
    desc = (rng.integers(0, 2, (N, 256)) * 2 - 1).astype(np.int8)
    fa = np.arange(N, dtype=np.int32)
    fb = np.where(ok, rng.permutation(N), 0).astype(np.int32)
    jm, jids = jms.alloc_landmarks(slam.map, jnp.asarray(pos), jnp.asarray(desc),
                                   jnp.asarray(ok), jnp.asarray(ka), jnp.asarray(fa),
                                   jnp.asarray(kb), jnp.asarray(fb))
    tm, tids = tms.alloc_landmarks(tmap, _t(pos), _t(desc), _t(ok), ka, _t(fa),
                                   kb, _t(fb))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _assert_maps_equal(tm, _np_map(jm))

    for slot in (int(kv[1]), int(kv[-1])):
        _assert_maps_equal(tms.remove_keyframe(tmap, slot),
                           _np_map(jms.remove_keyframe(slam.map, jnp.asarray(slot))))

    jf, jt = jms.keyframe_redundancy(slam.map)
    tf, tt = tms.keyframe_redundancy(tmap)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    for T in (np.asarray(slam.T_last), np.asarray(slam.map.kf_T[kv[0]])):
        ref = jms.median_scene_depth(slam.map.lm_pos, slam.map.lm_valid, jnp.asarray(T))
        got = tms.median_scene_depth(tmap.lm_pos, tmap.lm_valid, _t(T))
        assert float(got) == float(ref)
    few = np.zeros_like(ref_map["lm_valid"])
    few[np.flatnonzero(ref_map["lm_valid"])[:5]] = True
    assert float(tms.median_scene_depth(tmap.lm_pos, _t(few), _t(T))) == 1.0


def _track_both(slam, f, T_pred):
    jres = jtr.track_frame(slam.map, CAM, f.xy_ud, f.octave, f.desc_pm1, f.valid,
                           jnp.asarray(T_pred), img_w=W, img_h=H)
    tmap = convert.map_state_from_numpy(_np_map(slam.map))
    tres = ttr.track_frame(tmap, _t(CAM), _t(f.xy_ud), _t(f.octave),
                           _t(f.desc_pm1), _t(f.valid), _t(T_pred), img_w=W, img_h=H)
    return jres, tres, tmap


def test_track_frame_from_jax_map(jax_run):
    slam, f, T_pred = jax_run
    jres, tres, _ = _track_both(slam, f, T_pred)
    jl, tl = np.asarray(jres.feat_lm), tres.feat_lm.numpy()
    assert (jl >= 0).sum() > 50
    assert (jl == tl).mean() >= 0.98
    np.testing.assert_allclose(tres.Tcw.numpy(), np.asarray(jres.Tcw), atol=1e-4)
    assert abs(int(tres.n_inliers) - int(jres.n_inliers)) <= 0.02 * N_SLOTS


def test_keyframe_mapping_step_from_jax_map(jax_run):
    slam, f, T_pred = jax_run
    jres, _, tmap = _track_both(slam, f, T_pred)
    order = slam._kf_order
    slot = int(np.flatnonzero(~np.asarray(slam.map.kf_valid))[0])
    tri = [order[-k] if k <= len(order) else slot for k in range(1, 5)]
    kf_free = np.zeros(slam.map.K, bool)
    kf_free[order[max(2, len(order) - 4):]] = True
    kf_free[slot] = True
    args = (f.ts, f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid, jres.feat_lm)
    jm, jT, jst = jlm.keyframe_mapping_step(
        slam.map, CAM, jnp.asarray(slot), jres.Tcw, *args,
        jnp.asarray(tri, jnp.int32), jnp.full(3, slot, jnp.int32),
        jnp.asarray(kf_free), do_fuse=False, refresh_desc=False)
    tm, tT, tst = tlm.keyframe_mapping_step(
        tmap, _t(CAM), _slot(slot), _t(jres.Tcw), _ts(f.ts), *map(_t, args[1:]),
        _slot(tri), _slot([slot] * 3), _t(kf_free), do_fuse=False, refresh_desc=False)
    ref = _np_map(jm)
    got = convert.map_state_to_numpy(tm)
    assert ref["lm_valid"].sum() > np.asarray(slam.map.lm_valid).sum()  # new points
    _assert_maps_equal(tm, ref, INT_FIELDS)
    for k in ("kf_T", "lm_pos"):
        v = ref["lm_valid"] if k == "lm_pos" else ref["kf_valid"]
        np.testing.assert_allclose(got[k][v], ref[k][v], rtol=0,
                                   atol=1e-4 * np.abs(ref[k][v]).max())
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_array_equal(tst.numpy()[[0, 1, 4, 5, 6]],
                                  np.asarray(jst)[[0, 1, 4, 5, 6]])
    np.testing.assert_allclose(tst.numpy()[2:4], np.asarray(jst)[2:4], rtol=1e-3)


def test_unported_mapping_options_raise(jax_run):
    """Fusion and the descriptor refresh used to raise NotImplementedError;
    both are ported now, so asking for them runs (their parity with JAX is
    held in tests/test_torch_fuse.py)."""
    slam, f, _ = jax_run
    tmap = convert.map_state_from_numpy(_np_map(slam.map))
    free = torch.zeros(tmap.K, dtype=torch.bool)
    m, c0, c1 = tlm.local_ba(tmap, _t(CAM), free, refresh_desc=True)
    assert m.lm_desc_pm1.shape == tmap.lm_desc_pm1.shape and torch.isfinite(c1)
    m, T, stats = tlm.keyframe_mapping_step(
        tmap, _t(CAM), _slot(7), torch.eye(4), _ts(0.0), _t(f.xy_ud), _t(f.octave),
        _t(f.angle), _t(f.desc_pm1), _t(f.valid),
        torch.full((N_SLOTS,), -1, dtype=torch.int32), _slot([7] * 4), _slot([7] * 3),
        free, do_fuse=True, refresh_desc=False)
    assert bool(m.kf_valid[7]) and stats.shape == (7,) and stats[1] >= 0
