"""The stereo / RGB-D slice of the port against the JAX package: the stereo
matcher, the depth-map lookup, depth-founded landmarks, StereoSlam and the
RGB-D frame on the JAX package's own fixtures (tests/test_stereo_rgbd.py).
StereoInertialSlam is held against the reference through the app
(tests/test_torch_apps_depth.py).

Inputs are made once with numpy from a seed and go through both packages.
RANSAC draws and two-view fits are JAX's (``jax_draws``), as in
tests/test_torch_l2_slice.py.

Tolerances: ``stereo_match`` the same matched set and u_right, depth within
1e-5 relative; ``depth_from_depthmap`` exact; ``create_depth_landmarks``
the same tables, positions within 1e-5; StereoSlam the same state and
keyframe decision on every frame and poses within 1e-3 m; the RGB-D plane
at 4 m the same depths (1e-5) and features.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.geometry import camera as jcam
from eorb_slam_tpu.ops import stereo_match as jsm
from eorb_slam_tpu.slam import local_mapping as jlm, map_state as jms
from eorb_slam_tpu.slam import rgbd_stereo as jrs
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.ops import stereo_match as tsm
from eorb_slam_tpu_torch.slam import local_mapping as tlm
from eorb_slam_tpu_torch.slam import rgbd_stereo as trs, system as tsys
from tests import synth
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)

FX, BASELINE = 458.0, 0.11


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


def _frame_t(f):
    return tsys.FrameInput(f.ts, *(_t(x) for x in (f.xy_ud, f.octave, f.angle,
                                                   f.desc_pm1, f.valid)),
                           depth=None if f.depth is None else _t(f.depth))


def _stereo_inputs(seed):
    """A rectified pair of a 3D cloud: true matches on mixed octaves, noisy
    descriptors, clutter on both sides and an aliased right feature set."""
    rng = np.random.default_rng(seed)
    n, n_clutter = 200, 40
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(1.5, 20, n)], axis=1)
    uv_l = np.stack([FX * pts[:, 0] / pts[:, 2] + 376.0,
                     457.0 * pts[:, 1] / pts[:, 2] + 240.0], axis=1)
    uv_r = uv_l.copy()
    uv_r[:, 0] -= FX * BASELINE / pts[:, 2]
    uv_r += rng.normal(0, 0.3, uv_r.shape)
    desc = synth.random_descriptors(n, seed + 1)
    desc_r = desc.copy()
    flips = rng.integers(0, 256, (n, 6))
    for r in range(n):
        desc_r[r, flips[r]] *= -1
    oct_l = rng.integers(0, 4, n)
    oct_r = np.clip(oct_l + rng.integers(-1, 2, n), 0, 7)
    # clutter: random positions, random descriptors, both images
    cl = rng.uniform((0, 0), (752, 480), (n_clutter, 2))
    cr = rng.uniform((0, 0), (752, 480), (n_clutter, 2))
    xy_l = np.concatenate([uv_l, cl]).astype(np.float32)
    xy_r = np.concatenate([uv_r, cr]).astype(np.float32)
    d_l = np.concatenate([desc, synth.random_descriptors(n_clutter, seed + 2)])
    d_r = np.concatenate([desc_r, synth.random_descriptors(n_clutter, seed + 3)])
    o_l = np.concatenate([oct_l, rng.integers(0, 8, n_clutter)]).astype(np.int32)
    o_r = np.concatenate([oct_r, rng.integers(0, 8, n_clutter)]).astype(np.int32)
    v_l = rng.random(n + n_clutter) > 0.05
    v_r = rng.random(n + n_clutter) > 0.05
    return xy_l, o_l, d_l, v_l, xy_r, o_r, d_r, v_r


@pytest.mark.parametrize("seed", [3, 17])
def test_stereo_match_matches_jax(seed):
    args = _stereo_inputs(seed)
    dj, uj, okj = (np.asarray(x) for x in jsm.stereo_match(
        *(jnp.asarray(a) for a in args), FX, BASELINE))
    dt, ut, okt = (x.numpy() for x in tsm.stereo_match(
        *(_t(a) for a in args), FX, BASELINE))
    assert okj.sum() >= 100
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(dt < 0, dj < 0)
    np.testing.assert_allclose(dt[okj], dj[okj], rtol=1e-5)


def test_stereo_match_median_prune_on_even_counts():
    """The prune's median is the sorted distance at index n_matched // 2 (the
    upper middle for an even count), as the reference picks it: with matches
    at distances (0, 0, 40, 40) the cut is 1.5 * 1.4 * 40 = 84, and the
    lower middle (0 -> 2.1) would drop the two distance-40 matches."""
    n = 4
    xy_l = np.asarray([[100.0 + 60 * i, 100.0] for i in range(n)], np.float32)
    xy_r = xy_l - np.asarray([10.0, 0.0], np.float32)
    d_l = synth.random_descriptors(n, 5)
    d_r = d_l.copy()
    d_r[2:, :40] *= -1
    args = (xy_l, np.zeros(n, np.int32), d_l, np.ones(n, bool),
            xy_r, np.zeros(n, np.int32), d_r, np.ones(n, bool))
    okj = np.asarray(jsm.stereo_match(*(jnp.asarray(a) for a in args), FX, BASELINE)[2])
    okt = tsm.stereo_match(*(_t(a) for a in args), FX, BASELINE)[2].numpy()
    assert okj.all()
    np.testing.assert_array_equal(okt, okj)


def test_depth_from_depthmap_matches_jax():
    rng = np.random.default_rng(4)
    H, W = 60, 80
    dm = rng.uniform(0.5, 9.0, (H, W)).astype(np.float32)
    dm[rng.random((H, W)) < 0.2] = 0.0
    dm[3, 5] = np.nan
    # half-integers round to even; points outside are clipped to the border
    xy = np.concatenate([
        rng.uniform(-5, W + 5, (200, 2)),
        np.asarray([[4.5, 2.5], [5.5, 3.5], [0.5, 0.5], [W - 0.5, H - 0.5],
                    [5.0, 3.0], [-3.0, 10.0], [W + 3.0, H + 9.0]]),
    ]).astype(np.float32)
    valid = rng.random(len(xy)) > 0.1
    dj, okj = (np.asarray(x) for x in jsm.depth_from_depthmap(
        jnp.asarray(xy), jnp.asarray(dm), jnp.asarray(valid)))
    dt, okt = (x.numpy() for x in tsm.depth_from_depthmap(_t(xy), _t(dm), _t(valid)))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(dt, dj)


def test_create_depth_landmarks_matches_jax():
    rng = np.random.default_rng(9)
    K, M, N, P = 4, 96, 48, 4
    jm = jms.empty_map(K=K, M=M, N=N, P=P)
    # a few landmarks already in use, one KF before the depth KF
    jm = jm._replace(lm_valid=jm.lm_valid.at[jnp.asarray([0, 3, 4])].set(True))
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.2, -0.1, 0.3]
    xy = rng.uniform((0, 0), (752, 480), (N, 2)).astype(np.float32)
    feat_lm = np.full(N, -1, np.int32)
    feat_lm[:5] = [0, 3, 4, 0, 3]
    valid = rng.random(N) > 0.1
    jm = jms.insert_keyframe(
        jm, jnp.asarray(2), jnp.asarray(T), 0.5, jnp.asarray(xy),
        jnp.zeros(N, jnp.int32), jnp.zeros(N), jnp.asarray(synth.random_descriptors(N, 2)),
        jnp.asarray(valid), jnp.asarray(feat_lm))
    depth = rng.uniform(0.5, 12, N).astype(np.float32)
    depth[rng.random(N) < 0.25] = -1.0
    depth[7] = np.inf
    cam = np.array(synth.CAM)
    jm2, nj = jlm.create_depth_landmarks(jm, jnp.asarray(cam), jnp.asarray(2),
                                         jnp.asarray(depth))
    tm = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    tm2, nt = tlm.create_depth_landmarks(tm, _t(cam), 2, _t(depth))
    assert int(nt) == int(nj) > 20
    a, b = convert.map_state_to_numpy(tm2), {k: np.asarray(v) for k, v in jm2._asdict().items()}
    for k in a:
        if k == "lm_pos":
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # both founding observation rows point at (slot, feat)
    new = b["lm_valid"] & ~np.asarray(jm.lm_valid)
    assert (b["obs_kf"][new, :2] == 2).all()
    assert (b["obs_feat"][new, 0] == b["obs_feat"][new, 1]).all()


def test_stereo_slam_matches_jax(jax_draws):
    """tests/test_stereo_rgbd.py's metric StereoSlam run (SynthWorld seed 11,
    2 s at 10 Hz), frame by frame."""
    world = synth.SynthWorld(seed=11)
    kw = dict(baseline=0.11, min_init_matches=60, K=8, M=2048)
    jslam = jrs.StereoSlam(synth.CAM, **kw)
    tslam = trs.StereoSlam(np.array(synth.CAM), device="cpu", **dict(kw, baseline=1.0))
    convert.depth_state_from_numpy(tslam, {"baseline": jslam.baseline})
    assert tslam.baseline == jslam.baseline
    gt = []
    for t in np.arange(0.0, 2.0, 0.1):
        f, Tcw = world.frame(float(t), with_depth=True)
        rj, rt = jslam.process_features(f), tslam.process_features(_frame_t(f))
        assert rt["state"] == rj["state"] and rt.get("kf") == rj.get("kf"), (t, rj, rt)
        assert tslam.n_kf == jslam.n_kf
        np.testing.assert_allclose(tslam.T_last.numpy(), np.asarray(jslam.T_last),
                                   atol=1e-3)
        gt.append((float(t), np.linalg.inv(Tcw)))
    assert tslam.state == tsys.OK and tslam.n_kf >= 2 and tslam.stats["lost"] == 0
    assert tslam.stats["lm"] == jslam.stats["lm"]
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=1e-3)
    # metric: within 5 cm of the ground truth without a scale fit
    err = [np.linalg.norm(a[:3, 3] - g[:3, 3]) for (_, a), (_, g) in zip(traj_t, gt)]
    assert np.sqrt(np.mean(np.square(err))) < 0.05


def test_rgbd_frame_on_a_plane_matches_jax():
    """tests/test_stereo_rgbd.py's RGB-D entry: a plane at 4 m, a random
    image; the depth lookup at the distorted keypoints feeds the frame."""
    rng = np.random.default_rng(5)
    H, W = 240, 320
    cam = np.array(jcam.make_pinhole(200.0, 200.0, 160.0, 120.0))
    depth_map = np.full((H, W), 4.0, np.float32)
    depth_map[:, :40] = 50.0          # beyond max_depth: no depth there
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    jslam = jrs.RgbdSlam(jnp.asarray(cam), min_init_matches=40, N=256)
    fj = jslam.make_rgbd_frame(jnp.asarray(img), jnp.asarray(depth_map), 0.0, max_kp=256)
    tslam = trs.RgbdSlam(cam, min_init_matches=40, N=256, device="cpu")
    ft = tslam.make_rgbd_frame(_t(img), _t(depth_map), 0.0, max_kp=256)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_allclose(ft.xy_ud.numpy(), np.asarray(fj.xy_ud), atol=1e-4)
    d, v = ft.depth.numpy(), ft.valid.numpy()
    np.testing.assert_allclose(d, np.asarray(fj.depth), atol=1e-5)
    assert (np.abs(d[v & (d > 0)] - 4.0) < 1e-5).all()
    assert (d[v] > 0).sum() >= 50 and (d[v] < 0).sum() > 0
    # the frame founds the map from one frame (a landmark per depth-valid
    # feature, less the one the slot-0 scatter defect drops, on both sides)
    rj, rt = jslam.process_features(fj), tslam.process_features(ft)
    assert rt == rj and rt["state"] == tsys.OK
    assert tslam.stats["lm"] == jslam.stats["lm"] >= int((d[v] > 0).sum()) - 1
