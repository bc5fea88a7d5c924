"""The feature path's graph runners on the CPU: ``frontend.extract``,
``camera.undistort_points``, ``tracking.track_frame`` and
``stereo_match.stereo_match``, the port's counterparts of the reference's
jitted functions of the same names.

Each runner is driven with the stand-in graph class of
``tests/test_torch_graphs.py`` (``CpuGraph``: a capture on CPU tensors whose
replay runs the captured call again on the runner's static buffers) and
held bit for bit against its eager function, on a second key too (a uint8
and a float32 image; the narrow search and the wide re-search; a second
point count; a second stereo pair size). A second eager call builds no
cached constant, and no unit reads a device value or lifts host data
(``tests/test_torch_host_reads.py``'s counter). The tracked image frame and
the inertial frame step, which call these units inside their own capture,
keep their bits and count each inner unit once, in their own graph's
counts. StereoSlam's frames replay at their call sites with the runners in
place. One parity case per unit holds the renamed bodies against the JAX
functions on the same numpy-seeded inputs (one jitted call for all four):

- ``extract``: level-0 keypoints equal; >= 98% of all keypoints shared
  (as ``tests/test_torch_frontend.py``);
- ``undistort_points``: within 1e-4 px (``tests/test_torch_stereo_rgbd.py``'s
  RGB-D frame);
- ``track_frame``: ``feat_lm`` equal on >= 98% of the features, Tcw within
  1e-4 (``tests/test_torch_map.py``);
- ``stereo_match``: the same matched set and u_right, depth within 1e-5
  relative (``tests/test_torch_stereo_rgbd.py``).

Whether a real CUDA capture gives the eager bits is the card's question
(``chip_smoke.check_graphs_small``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _bits_equal
from eorb_slam_tpu.geometry import camera as jcam
from eorb_slam_tpu.ops import frontend as jfe
from eorb_slam_tpu.ops import stereo_match as jsm
from eorb_slam_tpu.slam import map_state as jms
from eorb_slam_tpu.slam import tracking as jtr
from eorb_slam_tpu_torch import _graphs, _host, convert
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.ops import frontend, hopper_splat, orb, pyramid, stereo_match
from eorb_slam_tpu_torch.slam import rgbd_stereo, tracking, vi_system
from tests.test_torch_graphs import CpuGraph, _runner, _vi_call, tracked  # noqa: F401
from tests.test_torch_host_reads import HostReads
from tests.test_torch_stereo_rgbd import BASELINE, _stereo_inputs

W, H, FX = 240, 180, 146.25
# a radial-tangential camera for the undistortion (the corridor's has none)
CAM_D = np.asarray([FX, FX, W / 2.0, H / 2.0, -0.28, 0.07, 2e-4, 1e-5, 0.0], np.float32)
# the stereo pairs' camera (tests/test_torch_stereo_rgbd.py)
STEREO_FX = 458.0
UNITS = {"extract": (frontend, "extract"), "undistort_points": (cam_mod, "undistort_points"),
         "track_frame": (tracking, "track_frame"),
         "stereo_match": (stereo_match, "stereo_match")}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _uv(n, seed):
    """``n`` observed pixels spread over the image."""
    rng = np.random.default_rng(seed)
    return rng.uniform((0.0, 0.0), (W, H), (n, 2)).astype(np.float32)


def _stereo_call(seed, n_right=None):
    """The stereo matcher's arguments by name on a rectified pair
    (``_stereo_inputs``), its right side cut to ``n_right`` features."""
    xl, ol, dl, vl, xr, o_r, dr, vr = (torch.from_numpy(np.array(a))
                                       for a in _stereo_inputs(seed))
    if n_right is not None:
        xr, o_r, dr, vr = xr[:n_right], o_r[:n_right], dr[:n_right], vr[:n_right]
    return dict(xy_l=xl, oct_l=ol, desc_l=dl, valid_l=vl, xy_r=xr, oct_r=o_r, desc_r=dr,
                valid_r=vr, fx=STEREO_FX, baseline=BASELINE)


def _frame(slam, img):
    """The tracked search's feature inputs from one image, as the
    features-entry modes make them."""
    f = frontend._extract(img, max_kp=slam.map.N)
    return (cam_mod._undistort_points(slam.cam, f.xy), f.octave, f.desc_pm1, f.valid)


def _track_call(slam, m, img, wide=False):
    """``track_frame``'s arguments by name: ``img``'s features against the
    map ``m`` from the motion model's pose; the wide re-search's window and
    ratio where ``wide``."""
    xy_ud, octave, desc, valid = _frame(slam, img)
    kw = dict(m=m, cam_params=slam.cam, xy_ud=xy_ud, octave=octave, desc_pm1=desc,
              feat_valid=valid, T_pred=slam.velocity @ slam.T_last, img_w=W, img_h=H)
    if wide:
        kw.update(search_radius=tracking.WIDE_RADIUS, nn_ratio=tracking.WIDE_NN_RATIO)
    return kw


@pytest.fixture(scope="module")
def calls(tracked):  # noqa: F811
    """Each unit's calls by name: a sequence crossing keys, and one call
    for the single-call checks (the last)."""
    slam, m0, m1, imgs = tracked
    f32 = [img.to(torch.float32) for img in imgs]
    cam_d = torch.from_numpy(CAM_D)
    return {
        "extract": [dict(img=img, max_kp=slam.map.N)
                    for img in (imgs[0], imgs[0], imgs[1], f32[0], f32[1], f32[1])],
        "undistort_points": [dict(params=cam_d, uv=torch.from_numpy(_uv(n, s)))
                             for n, s in ((256, 0), (256, 1), (256, 2), (64, 3), (64, 4))],
        "track_frame": [_track_call(slam, m, imgs[k], wide)
                        for m, k, wide in ((m0, 0, False), (m0, 1, False), (m1, 1, False),
                                           (m1, 0, True), (m1, 1, True))],
        "stereo_match": [_stereo_call(s, n) for s, n in ((3, None), (17, None), (5, None),
                                                         (3, 200), (17, 200))],
    }


# the keys each sequence meets, and its replays
KEYS = {"extract": (2, 4), "undistort_points": (2, 3), "track_frame": (2, 3),
        "stereo_match": (2, 3)}


def test_the_four_units_are_graph_runners():
    """Each unit is a runner whose static arguments are the reference's
    static_argnames and the Python numbers the port keys on."""
    static = {"extract": ("max_kp", "n_levels", "threshold", "min_threshold", "cell",
                          "per_cell"),
              "undistort_points": (),
              "track_frame": ("img_w", "img_h", "search_radius", "max_dist", "nn_ratio"),
              "stereo_match": ("fx", "baseline", "min_depth", "max_depth")}
    for unit, (mod, name) in UNITS.items():
        runner = getattr(mod, name)
        assert isinstance(runner, _graphs.GraphRunner), unit
        assert runner.static == static[unit], unit
        assert runner.fn is getattr(mod, "_" + name), unit


@pytest.mark.parametrize("unit", list(UNITS))
def test_unit_replays_the_eager_step(calls, unit):
    """The unit's calls through a runner with the stand-in graph: every
    captured or replayed output bit-equal to the eager function's on the
    same call, a capture per key."""
    mod, name = UNITS[unit]
    r = _runner(getattr(mod, name))
    for i, kw in enumerate(calls[unit]):
        replays = r.replays
        got = r(**kw)
        if r.replays != replays:
            assert _bits_equal(got, r.fn(**kw)), i
    assert (r.keys, r.replays) == KEYS[unit]
    assert r.captures == r.keys


def _cache_misses() -> int:
    """Misses of every per-device constant cache the feature path uses."""
    cached = (_host.constant, pyramid._resize_weights, orb._orientation_grids,
              orb._brief_pattern_f32)
    return sum(f.cache_info().misses for f in cached)


@pytest.mark.parametrize("unit", list(UNITS))
def test_unit_second_call_builds_no_constant(calls, unit):
    mod, name = UNITS[unit]
    fn, kw = getattr(mod, name).fn, calls[unit][-1]
    fn(**kw)
    misses = _cache_misses()
    fn(**kw)
    assert _cache_misses() == misses


@pytest.mark.parametrize("unit", list(UNITS))
def test_unit_reads_nothing(calls, unit):
    """After a warm-up the unit neither reads a device value on the host
    nor makes a tensor of host data."""
    mod, name = UNITS[unit]
    fn = getattr(mod, name).fn
    for kw in calls[unit]:
        fn(**kw)
        with HostReads() as hr:
            fn(**kw)
        assert not hr.reads and not hr.lifts, (dict(hr.reads), dict(hr.lifts))


# ------------------------------------------------ inside the outer captures

def _counting(fn):
    """``fn`` counting one "launch" of the forward splat per call, so that
    an outer graph's capture-time counts show which inner steps it holds."""
    @functools.wraps(fn)
    def step(*a, **k):
        hopper_splat.splat.launches += 1
        return fn(*a, **k)
    return step


@pytest.fixture
def inner_runners(monkeypatch):
    """The four module runners replaced by stand-in runners of counting
    steps; restores the splat count after."""
    runners = {}
    for unit, (mod, name) in UNITS.items():
        unit_runner = getattr(mod, name)
        runners[unit] = _graphs.GraphRunner(_counting(unit_runner.fn),
                                            static=unit_runner.static, graph_cls=CpuGraph)
        monkeypatch.setattr(mod, name, runners[unit])
    n = hopper_splat.splat.launches
    hopper_splat.splat.launches = 0
    yield runners
    hopper_splat.splat.launches = n


def _outer_counts(r):
    """The forward splat's capture-time count of ``r``'s one graph."""
    (entry,) = r._entries.values()
    at = [(o, a) for o, a in _graphs._COUNTERS].index((hopper_splat.splat, "launches"))
    return entry.counts[at]


def test_track_image_frame_runs_its_units_inline(tracked, inner_runners):  # noqa: F811
    """The tracked image frame through a stand-in runner with the inner
    runners in place: bit-equal to the whole step run eagerly; its graph
    counts extract, undistort_points and track_frame once each, and the
    inner runners captured and replayed nothing (their keys warmed up by
    the outer step's eager first call)."""
    slam, m0, m1, imgs = tracked
    r = _runner(tracking.track_image_frame)
    kw = dict(max_kp=slam.map.N, img_w=W, img_h=H)
    for i, m in enumerate((m0, m0, m0, m1)):
        a = (imgs[i % 2], slam.cam, m, slam.velocity, slam.T_last, m.kf_T[0])
        got = r(*a, **kw)
        with _graphs.capturing():
            want = tracking._track_image_frame(*a, **kw)
        assert _bits_equal(got, want), i
    assert (r.captures, r.replays) == (1, 3)
    assert _outer_counts(r) == 3
    for unit in ("extract", "undistort_points", "track_frame"):
        ir = inner_runners[unit]
        assert (ir.captures, ir.replays, len(ir._warm)) == (0, 0, 1), unit
    assert inner_runners["stereo_match"]._warm == set()


def test_vi_frame_step_runs_its_units_inline(tracked, inner_runners):  # noqa: F811
    """The inertial frame step likewise: extract and undistort_points
    inline, counted once each in its graph (its batched re-search calls
    the search under vmap, not the track_frame runner)."""
    slam, m0, m1, imgs = tracked
    r = _runner(vi_system.vi_frame_step)
    for i, (m, k) in enumerate(((m0, 0), (m0, 1), (m1, 1))):
        kw = _vi_call(slam, m, imgs[k], 10, False, seed=i)
        got = r(**kw)
        with _graphs.capturing():
            want = vi_system._vi_frame_step(**kw)
        assert _bits_equal(got, want), i
    assert (r.captures, r.replays) == (1, 2)
    assert _outer_counts(r) == 2
    for unit in ("extract", "undistort_points"):
        ir = inner_runners[unit]
        assert (ir.captures, ir.replays, len(ir._warm)) == (0, 0, 1), unit
    assert inner_runners["track_frame"]._warm == set()


def test_stereo_frames_replay_at_their_call_sites(inner_runners):
    """StereoSlam on a rendered corridor pair, with the four runners in
    place and with their eager functions: the same trajectory bits, the
    same map; the left (uint8) and right (float32) images are two keys of
    extract, and every later frame replays."""
    render = tsd.make_box_renderer("corridor", W, H, FX, device="cpu")
    pose = tsd.make_trajectory("corridor", 10.0)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -BASELINE
    pairs = []
    for i in range(5):
        Tcw = np.asarray(pose(i / 20.0), np.float32)
        pairs.append(((render(Tcw) * 255.0).to(torch.uint8), render(T_rl @ Tcw) * 255.0,
                      i / 20.0))
    cam = np.asarray([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0], np.float32)
    kw = dict(img_w=W, img_h=H, K=8, M=1024, N=256, device="cpu")
    runs = []
    for graphs in (True, False):
        if not graphs:
            for unit, (mod, name) in UNITS.items():
                setattr(mod, name, inner_runners[unit].fn.__wrapped__)
        slam = rgbd_stereo.StereoSlam(cam, baseline=BASELINE, **kw)
        states = [slam.process_stereo(*p)["state"] for p in pairs]
        runs.append((states, slam.T_last, slam.map))
    (s_g, T_g, m_g), (s_e, T_e, m_e) = runs
    assert s_g == s_e and s_g[-1] == rgbd_stereo.OK
    assert _bits_equal((T_g, tuple(m_g)), (T_e, tuple(m_e)))
    ex = inner_runners["extract"]
    assert (ex.keys, len(ex._warm)) == (2, 2)
    assert ex.replays == 2 * len(pairs) - 2
    for unit in ("undistort_points", "stereo_match", "track_frame"):
        assert inner_runners[unit].replays > 0, unit


# ------------------------------------------------------ against the reference

@pytest.fixture(scope="module")
def reference(tracked, calls):  # noqa: F811
    """The four JAX functions on the same inputs, in one jitted call."""
    slam, m0, m1, imgs = tracked
    img = imgs[0].to(torch.float32).numpy()
    uv = calls["undistort_points"][0]["uv"].numpy()
    tkw = calls["track_frame"][2]
    jm = jms.MapState(**{k: jnp.asarray(v)
                         for k, v in convert.map_state_to_numpy(tkw["m"]).items()})
    track_in = [tkw[k].numpy() for k in ("cam_params", "xy_ud", "octave", "desc_pm1",
                                         "feat_valid", "T_pred")]
    skw = calls["stereo_match"][0]
    stereo_in = [skw[k].numpy() for k in ("xy_l", "oct_l", "desc_l", "valid_l", "xy_r",
                                          "oct_r", "desc_r", "valid_r")]

    @jax.jit
    def ref(img, cam_d, uv, m, track_in, stereo_in):
        return (jfe.extract(img, max_kp=slam.map.N), jcam.undistort_points(cam_d, uv),
                jtr.track_frame(m, *track_in, img_w=W, img_h=H),
                jsm.stereo_match(*stereo_in, STEREO_FX, BASELINE))

    out = ref(jnp.asarray(img), jnp.asarray(CAM_D), jnp.asarray(uv), jm,
              [jnp.asarray(x) for x in track_in], [jnp.asarray(x) for x in stereo_in])
    out = jax.tree_util.tree_map(np.asarray, out)
    return dict(zip(UNITS, out)), dict(extract=dict(img=torch.from_numpy(img),
                                                    max_kp=slam.map.N))


def _kp_set(xy, octave, valid):
    return {(int(round(x * 100)), int(round(y * 100)), int(o))
            for (x, y), o, v in zip(xy, octave, valid) if v}


@pytest.mark.parametrize("unit", list(UNITS))
def test_unit_matches_jax(calls, reference, unit):
    ref, extra = reference
    kw = extra.get(unit) or {"undistort_points": calls["undistort_points"][0],
                             "track_frame": calls["track_frame"][2],
                             "stereo_match": calls["stereo_match"][0]}[unit]
    mod, name = UNITS[unit]
    got = getattr(mod, name)(**kw)
    want = ref[unit]
    if unit == "extract":
        got = frontend.Features(*[a.numpy() for a in got])
        want = frontend.Features(*want)
        l0 = want.octave == 0
        np.testing.assert_array_equal(got.octave, want.octave)
        np.testing.assert_array_equal(got.xy[l0], want.xy[l0])
        np.testing.assert_array_equal(got.valid[l0], want.valid[l0])
        ks_got = _kp_set(got.xy, got.octave, got.valid)
        ks_ref = _kp_set(want.xy, want.octave, want.valid)
        assert len(ks_ref) > 100
        assert len(ks_ref & ks_got) >= 0.98 * max(len(ks_ref), len(ks_got))
    elif unit == "undistort_points":
        assert np.abs(want - kw["uv"].numpy()).max() > 1.0    # the distortion acts
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    elif unit == "track_frame":
        Tcw, feat_lm, _, _, n_inl = want
        assert int(n_inl) >= 20
        assert np.mean(got.feat_lm.numpy() == feat_lm) >= 0.98
        np.testing.assert_allclose(got.Tcw.numpy(), Tcw, rtol=0, atol=1e-4)
    else:
        depth, u_right, ok = want
        d, u, o = (x.numpy() for x in got)
        assert ok.sum() >= 100
        np.testing.assert_array_equal(o, ok)
        np.testing.assert_array_equal(u, u_right)
        np.testing.assert_allclose(d[ok], depth[ok], rtol=1e-5)
