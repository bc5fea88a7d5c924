"""The ported slice against the JAX package, window by window: the same
seeded event stream through ``EventWindowBuilder.step_window`` of both
packages (metadata resolved with ``block=True`` on both sides, so the
adaptive window sees the same feedback), then ORB ``extract`` on each MCI.

Per window: ``best_kind`` and ``chunk_size`` equal, candidate scores within
rel 1e-3, the MCI (in [0,1]) within 1e-3 everywhere except where one
event's Gaussian tap crosses the truncation radius (see ``_assert_mci``),
and >= 95% of the keypoints shared. One case starts mid-stream from the
JAX builder's state, carried across by ``convert.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.event import builder as jb
from eorb_slam_tpu.ops import frontend as jfe
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.ops import frontend as tfe

W, H, F = 240, 180, 199.0
CAM = np.asarray([F, F, W / 2.0, H / 2.0, 0, 0, 0, 0, 0], np.float32)
CFG = dict(img_w=W, img_h=H, l1_chunk_size=1000, l1_num_loop=4,
           max_pixel_disp=3.0, min_ev_gen_rate=0.5, cm_iters=5)
# the largest jump one event makes in the raw image when one of its taps
# moves across |d| = trunc = 2.5 px: exp(-2.5^2 / 2)
TAP_EDGE = float(np.exp(-3.125))


def _stream(seconds=0.08, rate=600_000, seed=5):
    """Synthetic DAVIS240 events of a 3D point cloud seen by a moving camera
    (the shape of bench.py's stream), float64 [t, x, y, p]."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.2, 2.2, 300), rng.uniform(-1.6, 1.6, 300),
                    rng.uniform(2.5, 6.0, 300)], 1)
    n = int(seconds * rate)
    ts = np.sort(rng.uniform(0, seconds, n))
    p = pts[rng.integers(0, len(pts), n)]
    yaw = 0.9 * ts                               # rad, about the y axis
    c, s = np.cos(yaw), np.sin(yaw)
    pos = np.stack([4.0 * ts, 0.3 * np.sin(20 * ts), 0.8 * ts], 1)
    q = p - pos
    pc = np.stack([c * q[:, 0] - s * q[:, 2], q[:, 1], s * q[:, 0] + c * q[:, 2]], 1)
    ev = np.stack([ts, F * pc[:, 0] / pc[:, 2] + W / 2.0,
                   F * pc[:, 1] / pc[:, 2] + H / 2.0,
                   rng.choice([-1.0, 1.0], n)], 1)
    ev[:, 1:3] += rng.normal(0, 0.25, (n, 2))
    inb = (ev[:, 1] >= 0) & (ev[:, 1] < W) & (ev[:, 2] >= 0) & (ev[:, 2] < H)
    return ev[inb]


def _step_both(jbld, tbld):
    jbld._resolve_window_meta(block=True)
    tbld._resolve_window_meta(block=True)
    assert tbld.chunk_size == jbld.chunk_size
    return jbld.step_window(), tbld.step_window()


def _assert_mci(mci_t, mci_j, meta):
    """MCI within 1e-3 except at pixels explained by taps that crossed the
    truncation radius: the truncated Gaussian jumps there by up to
    TAP_EDGE (before normalization), so a last-ulp difference in a warped
    coordinate can add or drop one tap. Such pixels are few, each within
    one tap jump of the reference."""
    assert mci_t.shape == (H, W) and np.isfinite(mci_t).all()
    assert mci_t.min() >= 0.0 and mci_t.max() <= 1.0 + 1e-6
    diff = np.abs(mci_t - mci_j)
    if diff.max() <= 1e-3:
        return
    best = int(meta[0])
    assert best != 0, "the plain histogram has no warp: it must match to 1e-3"
    bad = diff > 1e-3
    assert bad.sum() <= 12, bad.sum()
    # the raw image's range is unknown here; bound through the normalized
    # one: a tap jump is TAP_EDGE / (hi - lo), and hi - lo >= 1 event peak
    assert diff.max() <= TAP_EDGE, diff.max()


def _assert_features(img_t, img_j):
    fj = jfe.extract(jnp.asarray(img_j * 255.0), max_kp=256)
    ft = tfe.extract(img_t * 255.0, max_kp=256)
    kj = {(round(float(x), 2), round(float(y), 2), int(o))
          for (x, y), o, v in zip(np.asarray(fj.xy), np.asarray(fj.octave),
                                  np.asarray(fj.valid)) if v}
    kt = {(round(float(x), 2), round(float(y), 2), int(o))
          for (x, y), o, v in zip(ft.xy.numpy(), ft.octave.numpy(),
                                  ft.valid.numpy()) if v}
    assert len(kj) > 50
    assert len(kj & kt) >= 0.95 * max(len(kj), len(kt)), (len(kj), len(kt),
                                                          len(kj & kt))


def _compare_windows(jbld, tbld, n_windows):
    kinds = []
    for _ in range(n_windows):
        pj, pt = _step_both(jbld, tbld)
        assert pj is not None and pt is not None
        mj = np.asarray(pj.se2_params)
        mt = pt.se2_params.numpy()
        assert int(mt[0]) == int(mj[0])                  # winning candidate
        np.testing.assert_allclose(mt[1:5], mj[1:5], rtol=1e-3)   # scores
        L = CFG["l1_num_loop"]
        mds_j, mds_t = mj[5:5 + L], mt[5:5 + L]          # KLT median disp.
        np.testing.assert_array_equal(np.isnan(mds_t), np.isnan(mds_j))
        np.testing.assert_allclose(mds_t, mds_j, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(mt[-3:], mj[-3:], rtol=1e-3,
                                   atol=1e-3 * np.abs(mj[-3:]).max())
        assert (pt.ts, pt.ts0, pt.best_kind) == (pj.ts, pj.ts0, pj.best_kind)
        _assert_mci(pt.img.numpy(), np.asarray(pj.img), mj)
        _assert_features(pt.img, np.asarray(pj.img))
        kinds.append(tb.KINDS[int(mt[0])])
    # resolve the last window: the chunk sizes it sets must agree too
    jbld._resolve_window_meta(block=True)
    tbld._resolve_window_meta(block=True)
    assert tbld.chunk_size == jbld.chunk_size
    assert tbld.stats == jbld.stats
    return kinds


def test_slice_from_stream_start():
    ev = _stream()
    jbld = jb.EventWindowBuilder(jb.BuilderConfig(**CFG), jnp.asarray(CAM))
    tbld = tb.EventWindowBuilder(tb.BuilderConfig(**CFG), CAM, device="cpu")
    jbld.feed(ev)
    tbld.feed(ev)
    _compare_windows(jbld, tbld, 5)
    assert tbld.pending_events() == jbld.pending_events()


def test_slice_mid_stream_through_convert():
    """Run the JAX builder alone for 2 windows, give it an L2 pose prior,
    carry its state into a fresh port builder, then compare 3 windows (the
    DPose candidate competes in these)."""
    ev = _stream(seed=7)
    jbld = jb.EventWindowBuilder(jb.BuilderConfig(**CFG), jnp.asarray(CAM))
    jbld.feed(ev)
    for _ in range(2):
        jbld._resolve_window_meta(block=True)
        assert jbld.step_window() is not None
    jbld._resolve_window_meta(block=True)
    T_prev = np.eye(4, dtype=np.float32)
    T_cur = np.eye(4, dtype=np.float32)
    T_cur[:3, 3] = [-0.012, 0.001, -0.002]   # about the stream's motion
    jbld.set_pose_prior(jnp.asarray(T_prev), jnp.asarray(T_cur),
                        jnp.asarray(3.5, jnp.float32))

    tbld = tb.EventWindowBuilder(tb.BuilderConfig(**CFG),
                                 convert.cam_from_numpy(np.zeros(9)),
                                 device="cpu")
    img, pts, ok = (np.asarray(a) for a in jbld._win_carry)
    convert.builder_state_from_numpy(tbld, dict(
        prev_img=img, prev_pts=pts, prev_ok=ok, T_prev=T_prev, T_cur=T_cur,
        med_depth=np.float32(3.5), chunk_size=jbld.chunk_size,
        last_chunk_ts=jbld._last_chunk_ts, last_kind=jbld._last_kind,
        last_score=jbld._last_score, cam=np.asarray(jbld.cam)))
    rest = jbld._consume(jbld.pending_events())
    jbld._inject_front(rest)
    tbld.feed(rest)
    tbld.stats = dict(jbld.stats)
    np.testing.assert_array_equal(tbld.cam.numpy(), CAM)

    _compare_windows(jbld, tbld, 3)


def test_builder_config_fields_match_jax():
    """Every field of the JAX BuilderConfig exists in the port's, with the
    same default, so a JAX config passes as keyword arguments."""
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jb.BuilderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tb.BuilderConfig)}
    assert tf == jf
    cfg = dataclasses.asdict(jb.BuilderConfig(l1_chunk_size=1500,
                                              max_window_events=16384))
    assert dataclasses.asdict(tb.BuilderConfig(**cfg)) == cfg


def test_pad_events_matches_jax():
    ev = _stream(seconds=0.002)
    for cap, t0 in ((4096, None), (len(ev) // 2, None), (len(ev) + 10, 0.0005)):
        got = tb._pad_events(ev, cap, t0)
        ref = jb._pad_events(ev, cap, t0)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


def test_idle_window_resets_carry():
    """A stream below min_ev_gen_rate is gated exactly as in JAX."""
    ev = _stream(seconds=1.0, rate=20_000)
    jbld = jb.EventWindowBuilder(jb.BuilderConfig(**CFG), jnp.asarray(CAM))
    tbld = tb.EventWindowBuilder(tb.BuilderConfig(**CFG), CAM, device="cpu")
    jbld.feed(ev)
    tbld.feed(ev)
    assert jbld.step_window() is None and tbld.step_window() is None
    assert tbld.stats == jbld.stats and tbld.stats["idle"] == 1
    assert tbld._win_carry is None


def test_builder_meta_copy_is_device_tensor_on_cpu():
    tbld = tb.EventWindowBuilder(tb.BuilderConfig(**CFG), CAM, device="cpu")
    tbld.feed(_stream(seconds=0.02))
    pi = tbld.step_window()
    assert pi is not None and pi.img.device.type == "cpu"
    assert isinstance(pi.se2_params, torch.Tensor)
    tbld._resolve_window_meta()       # CPU copies are ready at once
    assert tbld._pending_meta is None
