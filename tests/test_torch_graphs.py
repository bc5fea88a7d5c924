"""The graph runner (``eorb_slam_tpu_torch/_graphs.py``), the port's
counterpart of ``jax.jit``, on the CPU.

On the card ``GraphRunner`` captures a step once per key into a CUDA graph
and replays it; a CPU call runs the eager function. Here the runner is
driven with a stand-in graph class that captures on CPU tensors: its
capture runs the step on the runner's static buffers and keeps the call,
and its replay runs that call again on the same buffers (with the launch
counters held, as a replay runs no Python) and writes the results into the
captured outputs. That exercises everything the runner does around a graph:
keys, warm-up, static buffers and their copies, outputs cloned out, the
counters, a runner nested in another's capture. The units go through it,
each against its eager function: the L1 window, the tracked image frame,
local BA's LM loop, the keyframe mapping step (local BA inline in it), the
tracked inertial frame (its IMU window padded to a bucket, with and without
the marginal prior), VI-BA's LM loop, build_mci's candidates, the
per-chunk step, track advance and top-up, the pose-only solve (inline
under ``torch.func.vmap``) and EVENT_MONO's five joint units. Whether a real
capture gives the eager bits is the card's question
(``chip_smoke.check_graphs_small``). No JAX here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pytest
import torch

from chip_smoke import _bits_equal
from eorb_slam_tpu_torch import _graphs, _host
from chip_smoke import _vi_ba_problem
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.event import feature_tracks as ft
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.ops import hopper_linalg, hopper_splat
from eorb_slam_tpu_torch.optim import marginalize, pose_only, schur_ba, vi_ba
from eorb_slam_tpu_torch.slam import ev_image_system as evi
from eorb_slam_tpu_torch.slam import local_mapping
from eorb_slam_tpu_torch.slam import map_state as ms
from eorb_slam_tpu_torch.slam import system as tsys
from eorb_slam_tpu_torch.slam import tracking, vi_system

W, H, FX, FPS = 240, 180, 146.25, 20.0
KW = dict(img_w=W, img_h=H, K=8, M=1024, N=256, max_frames_between_kf=3)


class CpuGraph:
    """A stand-in for ``_graphs.CudaGraph`` on CPU tensors."""

    device_type = "cpu"

    @staticmethod
    def new_pool():
        return None

    def capture(self, fn, pool):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        # a replay runs no Python: the counters hold, and a runner the step
        # calls runs inline, as it did at capture
        held = _graphs._snapshot()
        with _graphs.capturing():
            new = self.fn()
        _graphs._restore(held)
        dst, src = [], []
        _graphs._flatten(self.out, dst, "out")
        _graphs._flatten(new, src, "out")
        for d, s in zip(dst, src):
            d.copy_(s)


def _runner(unit):
    """``unit``'s eager function behind a runner with the stand-in graph."""
    return _graphs.GraphRunner(unit.fn, static=unit.static, graph_cls=CpuGraph)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the runner

class Toy(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def _toy(x, m, scale: float, n: int):
    """A step with a static number, a NamedTuple input and a counted
    "launch" of each hand kernel."""
    hopper_splat.splat.launches += 1
    hopper_splat.splat.ascent_launches += 2
    hopper_linalg.sym_eig.by_n[4] = hopper_linalg.sym_eig.by_n.get(4, 0) + 1
    return (x * scale + m.b, (m.a.sum() * n)[None]), m.a + 1


def _toy_runner():
    return _graphs.GraphRunner(_toy, static=("scale", "n"), graph_cls=CpuGraph)


def test_captures_once_per_key():
    r = _toy_runner()
    x, m = torch.arange(4.0), Toy(torch.ones(3), torch.zeros(4))
    for _ in range(4):
        r(x, m, 2.0, 3)
    assert (r.captures, r.replays, r.keys) == (1, 3, 1)
    # a static value, an input shape and a map field's shape: each a key
    r(x, m, 3.0, 3)
    r(x, m, 3.0, 3)
    r(torch.arange(5.0), Toy(torch.ones(3), torch.zeros(5)), 3.0, 3)
    r(torch.arange(5.0), Toy(torch.ones(3), torch.zeros(5)), 3.0, 3)
    r(x, Toy(torch.ones(6), torch.zeros(4)), 3.0, 3)
    r(x, Toy(torch.ones(6), torch.zeros(4)), 3.0, 3)
    assert (r.captures, r.keys) == (4, 4)
    # a dtype is a key too
    r(x.double(), Toy(torch.ones(3), torch.zeros(4)), 3.0, 3)
    assert r.captures == 4


def test_python_number_outside_the_key_raises():
    r = _toy_runner()
    with pytest.raises(TypeError, match="Python number"):
        r(2.0, Toy(torch.ones(3), torch.zeros(4)), 2.0, 3)
    with pytest.raises(TypeError, match="Python number"):
        r(torch.ones(4), Toy(torch.ones(3), 0.0), 2.0, 3)
    # the real L1 window: a median depth given as a float
    a = list(_window_args(1024, False, 0))
    a[9] = 1.0
    with pytest.raises(TypeError, match="med_depth"):
        tb.window_step(*a)


def test_outputs_are_not_static_buffers():
    r = _toy_runner()
    m = Toy(torch.ones(3), torch.zeros(4))
    outs = [r(torch.full((4,), float(i)), m, 2.0, 3) for i in range(4)]
    for i, (d, a) in enumerate(outs):
        assert torch.equal(d[0], torch.full((4,), 2.0 * i))
        assert torch.equal(a, torch.full((3,), 2.0))
    # every call handed out its own tensors
    ptrs = {t.data_ptr() for d, a in outs for t in (d[0], d[1], a)}
    assert len(ptrs) == 12


def test_replaced_and_written_inputs_are_seen():
    r = _toy_runner()
    x = torch.arange(4.0)
    m = Toy(torch.ones(3), torch.zeros(4))
    r(x, m, 2.0, 3)
    r(x, m, 2.0, 3)
    # a map replaced functionally, as a keyframe replaces it
    m2 = m._replace(b=torch.full((4,), 5.0), a=torch.full((3,), 2.0))
    d, a = r(x, m2, 2.0, 3)
    assert torch.equal(d[0], x * 2.0 + 5.0) and torch.equal(a, torch.full((3,), 3.0))
    assert torch.equal(d[1], torch.tensor([18.0]))
    # the same tensor object written in place since the last call
    x.add_(1.0)
    d, _ = r(x, m2, 2.0, 3)
    assert torch.equal(d[0], x * 2.0 + 5.0)
    # a view of a written base
    base = torch.zeros(8)
    v = base[2:6]
    r(v, m2, 2.0, 3)
    base[3] = 7.0
    d, _ = r(v, m2, 2.0, 3)
    assert d[0][1].item() == 19.0


def _writes_its_input(x, m):
    x.mul_(2.0)
    return x + m.a


def test_a_step_that_writes_its_input_raises():
    """A replay would write the static buffer, not the caller's tensor: the
    capture refuses such a step."""
    r = _graphs.GraphRunner(_writes_its_input, graph_cls=CpuGraph)
    x, m = torch.ones(3), Toy(torch.ones(3), torch.zeros(4))
    r(x, m)
    assert torch.equal(x, torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="in place"):
        r(x, m)
    assert r.captures == 0


def test_counters_advance_by_the_capture_time_counts():
    r = _toy_runner()
    m = Toy(torch.ones(3), torch.zeros(4))
    hopper_splat.splat.launches = hopper_splat.splat.ascent_launches = 0
    hopper_linalg.sym_eig.by_n = {}
    for i in range(1, 5):     # eager, capture + replay, replay, replay
        r(torch.ones(4), m, 2.0, 3)
        assert (hopper_splat.splat.launches, hopper_splat.splat.ascent_launches,
                hopper_linalg.sym_eig.by_n) == (i, 2 * i, {4: i})
    assert r.captures == 1
    hopper_splat.splat.launches = hopper_splat.splat.ascent_launches = 0
    hopper_linalg.sym_eig.by_n = {}


def test_cpu_tensors_run_the_eager_function():
    """The module's runners run CPU calls eagerly: no capture, the eager
    function's values."""
    prob = _ba_problem()
    before = schur_ba.bundle_adjust.captures
    for _ in range(3):
        got = schur_ba.bundle_adjust(prob, iters=3)
    assert schur_ba.bundle_adjust.captures == before
    assert _bits_equal(got, schur_ba._bundle_adjust(prob, iters=3))


# ------------------------------------------------------- the three units

def _window_args(C, have_dpose, seed, L=3):
    """One L1 window's inputs at chunk bucket ``C``: events of a moving
    point cloud, a KLT carry and the L2 pose prior."""
    rng = np.random.default_rng(seed)
    n = C - 100
    chunks = np.zeros((L, C, 4), np.float32)
    cvalid = np.zeros((L, C), bool)
    pts = np.stack([rng.uniform(20, W - 20, 60), rng.uniform(20, H - 20, 60)], 1)
    for i in range(L):
        k = rng.integers(0, len(pts), n)
        t = np.sort(rng.uniform(i * 0.002, (i + 1) * 0.002, n))
        chunks[i, :n, 0] = t
        chunks[i, :n, 1] = pts[k, 0] + 400.0 * t + rng.normal(0, 0.3, n)
        chunks[i, :n, 2] = pts[k, 1] + rng.normal(0, 0.3, n)
        chunks[i, :n, 3] = rng.choice([-1.0, 1.0], n)
        cvalid[i, :n] = True
    T = np.eye(4, dtype=np.float32)
    T1 = T.copy()
    T1[0, 3] = 0.01
    f = torch.from_numpy
    return (f(chunks), f(cvalid), torch.tensor(0.002 * L), torch.full((L,), 0.002),
            torch.zeros(H, W), torch.zeros(16, 2), torch.zeros(16, dtype=torch.bool),
            f(T), f(T1), torch.tensor(3.0), have_dpose,
            torch.tensor([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0]),
            H, W, 1.0, 3, 2)


def test_window_step_replays_the_eager_window():
    """A window sequence through the runner and eagerly: the chunk bucket
    and have_dpose change on the way, the KLT carry feeds each next window;
    every output bit-equal."""
    r = _runner(tb.window_step)
    plan = [(1024, False)] * 3 + [(2048, False)] * 2 + [(1024, True)] * 2
    carry = None
    for i, (C, dpose) in enumerate(plan):
        a = list(_window_args(C, dpose, i))
        if carry is not None:
            a[4:7] = carry
        got = r(*a)
        want = tb._window_step(*a)
        assert _bits_equal(got, want), i
        carry = got[2:]
    assert (r.captures, r.keys, r.replays) == (3, 3, 4)


def test_window_step_second_call_builds_no_constant():
    a = _window_args(1024, True, 0)
    tb._window_step(*a)
    misses = _host.constant.cache_info().misses
    tb._window_step(*a)
    assert _host.constant.cache_info().misses == misses


@pytest.fixture(scope="module")
def tracked():
    """A MonoSlam past its initialisation on the corridor at 240x180, its
    next frames, and the map after one more keyframe."""
    render = tsd.make_box_renderer("corridor", W, H, FX, device="cpu")
    pose = tsd.make_trajectory("corridor", 10.0)
    frames = [(i / FPS, (render(np.asarray(pose(i / FPS), np.float32)) * 255.0)
               .to(torch.uint8)) for i in range(8)]
    cam = np.asarray([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0], np.float32)
    slam = tsys.MonoSlam(cam, pipelined=False, device="cpu", **KW)
    for i, (ts, img) in enumerate(frames):
        slam.process_image(img, ts)
        if slam.state == tsys.OK:
            break
    else:
        pytest.fail("the corridor did not initialise")
    m0 = slam.map
    kf0 = slam.stats["kf"]
    rest = frames[i + 1:]
    for ts, img in rest:
        slam.process_image(img, ts)
        if slam.stats["kf"] != kf0:
            break
    assert slam.map is not m0
    return slam, m0, slam.map, [img for _, img in rest]


def test_track_image_frame_replays_the_eager_frame(tracked):
    """Frames through the runner and eagerly, against the map after the
    initialisation and then against the map a keyframe replaced: every
    output bit-equal, one capture (the map's shapes stay)."""
    slam, m0, m1, imgs = tracked
    r = _runner(tracking.track_image_frame)
    kw = dict(max_kp=slam.map.N, img_w=W, img_h=H)
    for m in (m0, m0, m0, m1, m1):
        for img in imgs[:2]:
            a = (img, slam.cam, m, slam.velocity, slam.T_last, m.kf_T[0])
            got = r(*a, **kw)
            assert _bits_equal(got, tracking._track_image_frame(*a, **kw))
    assert (r.captures, r.keys, r.replays) == (1, 1, 9)
    # outputs of the map change differ from those before it
    a0 = (imgs[0], slam.cam, m0, slam.velocity, slam.T_last, m0.kf_T[0])
    a1 = (imgs[0], slam.cam, m1, slam.velocity, slam.T_last, m1.kf_T[0])
    assert not _bits_equal(r(*a0, **kw), r(*a1, **kw))


def test_track_image_frame_second_call_builds_no_constant(tracked):
    slam, m0, _, imgs = tracked
    a = (imgs[0], slam.cam, m0, slam.velocity, slam.T_last, m0.kf_T[0])
    kw = dict(max_kp=slam.map.N, img_w=W, img_h=H)
    tracking._track_image_frame(*a, **kw)
    misses = _host.constant.cache_info().misses
    tracking._track_image_frame(*a, **kw)
    assert _host.constant.cache_info().misses == misses


def _ba_problem(K=6, M=96, P=4, seed=0, dtype=np.float32):
    """A landmark-major BA problem (BAProblem order): K poses on a line,
    two fixed, M points 4-8 m away, P noisy observations each, the
    landmarks perturbed by 2 cm."""
    rng = np.random.default_rng(seed)
    lm = np.concatenate([rng.uniform(-2, 2, (M, 2)), rng.uniform(4, 8, (M, 1))], 1)
    Ts = np.tile(np.eye(4), (K, 1, 1))
    Ts[:, 0, 3] = -0.25 * np.arange(K)
    obs_kf = rng.integers(0, K, (M, P)).astype(np.int32)
    pc = np.einsum("mpij,mj->mpi", Ts[obs_kf][..., :3, :3], lm) + Ts[obs_kf][..., :3, 3]
    uv = np.stack([FX * pc[..., 0] / pc[..., 2] + W / 2.0,
                   FX * pc[..., 1] / pc[..., 2] + H / 2.0], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    cam = np.asarray([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0])
    return schur_ba.BAProblem(*(torch.from_numpy(np.asarray(x)) for x in (
        cam.astype(dtype), Ts.astype(dtype), np.asarray([True, True] + [False] * (K - 2)),
        np.ones(K, bool), (lm + rng.normal(0, 0.02, lm.shape)).astype(dtype),
        np.ones(M, bool), obs_kf, uv.astype(dtype), np.ones((M, P), dtype),
        pc[..., 2] > 0.1)))


def test_bundle_adjust_replays_the_eager_solve(tracked):
    """Problems through the runner and eagerly: a new seed (same shapes),
    a new iteration count and float64 (new keys), and local BA over the
    corridor maps; every output bit-equal."""
    slam, m0, m1, _ = tracked
    r = _runner(schur_ba.bundle_adjust)
    for seed, iters, dtype in ((0, 4, np.float32), (1, 4, np.float32), (2, 4, np.float32),
                               (2, 2, np.float32), (3, 2, np.float32),
                               (3, 2, np.float64), (4, 2, np.float64)):
        p = _ba_problem(seed=seed, dtype=dtype)
        assert _bits_equal(r(p, iters=iters), schur_ba._bundle_adjust(p, iters=iters))
    assert (r.captures, r.keys, r.replays) == (3, 3, 4)
    # the keyframe path's problem: local_ba with its BA swapped for the runner
    free = m1.kf_valid.clone()
    free[0] = False
    want = local_mapping.local_ba(m1, slam.cam, free)
    orig = schur_ba.bundle_adjust
    schur_ba.bundle_adjust = r
    try:
        # eager, captured at m0, replayed at the map a keyframe replaced
        got = [local_mapping.local_ba(m, slam.cam, free) for m in (m0, m0, m1)]
    finally:
        schur_ba.bundle_adjust = orig
    assert r.captures == 4
    assert _bits_equal(got[2], want) and not _bits_equal(got[1], want)


def test_bundle_adjust_second_call_builds_no_constant():
    p = _ba_problem()
    schur_ba._bundle_adjust(p, iters=2)
    misses = _host.constant.cache_info().misses
    schur_ba._bundle_adjust(p, iters=2)
    assert _host.constant.cache_info().misses == misses


# ----------------------------------------------------- nesting, the keyframe

def _inner(x):
    hopper_splat.splat.launches += 1
    return x * 2.0


def test_a_runner_inside_a_capture_runs_inline_and_counts_once():
    """A runner called by a step that another runner captures warms up,
    captures and replays nothing of its own: its launches count once, in
    the outer graph's counts, as a jitted function inlined in another."""
    inner = _graphs.GraphRunner(_inner, graph_cls=CpuGraph)

    def outer_fn(x):
        hopper_splat.splat.launches += 1
        return inner(x) + 1.0

    outer = _graphs.GraphRunner(outer_fn, graph_cls=CpuGraph)
    hopper_splat.splat.launches = 0
    x = torch.arange(3.0)
    for i in range(1, 6):      # eager, capture + replay, replays
        assert torch.equal(outer(x + i), (x + i) * 2.0 + 1.0)
        assert hopper_splat.splat.launches == 2 * i
    assert (outer.captures, outer.replays) == (1, 4)
    # the outer's eager first call met the inner runner outside a capture
    # (a warm-up); inside the capture and the replays it ran inline
    assert (inner.captures, inner.replays, inner.keys, len(inner._warm)) == (0, 0, 0, 1)
    counts = next(iter(outer._entries.values())).counts
    at = [(o, a) for o, a in _graphs._COUNTERS].index((hopper_splat.splat, "launches"))
    assert counts[at] == 2
    # outside a capture the inner runner is a runner of its own again: its
    # key is warm, so the next call captures and replays
    inner(x)
    inner(x)
    assert (inner.captures, inner.replays) == (1, 2)
    hopper_splat.splat.launches = 0


def _mapping_call(slam, m, img, fuse=True):
    """The keyframe mapping step's arguments as MonoSlam._insert_keyframe
    makes them for the frame ``img`` tracked against ``m``: the slots, the
    partners and the timestamp as device tensors."""
    kw = dict(max_kp=m.N, img_w=W, img_h=H)
    res, feats, xy_ud, *_ = tracking._track_image_frame(
        img, slam.cam, m, slam.velocity, slam.T_last, m.kf_T[0], **kw)
    order = [int(k) for k in np.flatnonzero(m.kf_valid.numpy())]
    slot = int(np.flatnonzero(~m.kf_valid.numpy())[0])
    tri = [order[-k] if k <= len(order) else slot for k in range(1, 5)]
    nb = (order[-4:-1] if fuse else []) + [slot] * 3
    kf_free = torch.zeros(m.K, dtype=torch.bool)
    kf_free[order[2:] + [slot]] = True
    i64 = torch.int64
    return dict(m=m, cam_params=slam.cam, slot=torch.tensor(slot, dtype=i64), Tcw=res.Tcw,
                ts=torch.tensor(0.55, dtype=m.kf_ts.dtype), xy=xy_ud, octave=feats.octave,
                angle=feats.angle, desc_pm1=feats.desc_pm1, feat_valid=feats.valid,
                feat_lm=res.feat_lm, tri_partners=torch.tensor(tri, dtype=i64),
                fuse_partners=torch.tensor(nb[:3], dtype=i64), kf_free=kf_free,
                do_fuse=fuse, refresh_desc=fuse)


def test_keyframe_mapping_step_replays_the_eager_step(tracked):
    """Keyframe steps through the runner and eagerly, with local BA's own
    runner swapped for one with the stand-in graph: fusion and the
    descriptor refresh on (three frames, the map a keyframe replaced on the
    third), then off (a key of its own); every output bit-equal, and the
    inner BA runner ran inline in the captures and replays."""
    slam, m0, m1, imgs = tracked
    calls = [_mapping_call(slam, m, img, fuse)
             for m, img, fuse in ((m1, imgs[0], True), (m1, imgs[1], True),
                                  (m0, imgs[1], True), (m1, imgs[0], False),
                                  (m1, imgs[1], False), (m1, imgs[1], False))]
    want = [local_mapping._keyframe_mapping_step(**kw) for kw in calls]
    r = _runner(local_mapping.keyframe_mapping_step)
    inner = _runner(schur_ba.bundle_adjust)
    orig = schur_ba.bundle_adjust
    schur_ba.bundle_adjust = inner
    try:
        got = [r(**kw) for kw in calls]
    finally:
        schur_ba.bundle_adjust = orig
    for i, (g, w) in enumerate(zip(got, want)):
        assert _bits_equal(g, w), i
    assert (r.captures, r.keys, r.replays) == (2, 2, 4)
    # the BA runner met outside a capture only the two eager first calls
    # (a warm-up, then a capture and its replay); in the outer captures and
    # replays it ran inline
    assert (inner.captures, inner.replays) == (1, 1)
    # the fused step found landmarks to triangulate and the map changed
    assert bool((want[0][0].lm_valid.sum() > m1.lm_valid.sum()).item())
    assert not _bits_equal(want[1][0], want[2][0])


def test_keyframe_mapping_step_takes_int_and_tensor_slots_alike(tracked):
    """The eager step on ints, lists and a float (the other callers' form)
    and on device tensors (the graph's form): the same bits, and the map's
    own functions likewise on a tensor slot."""
    slam, _, m1, imgs = tracked
    kw = _mapping_call(slam, m1, imgs[0])
    as_ints = dict(kw, slot=int(kw["slot"]), ts=float(kw["ts"]),
                   tri_partners=kw["tri_partners"].tolist(),
                   fuse_partners=kw["fuse_partners"].tolist())
    assert _bits_equal(local_mapping._keyframe_mapping_step(**as_ints),
                       local_mapping._keyframe_mapping_step(**kw))
    a, b = (int(k) for k in np.flatnonzero(m1.kf_valid.numpy())[-2:])
    ta, tb_ = (torch.tensor(k) for k in (a, b))
    depth = torch.linspace(0.5, 4.0, m1.N)
    for fn, args_int, args_t in (
            (local_mapping.create_new_landmarks, (a, b), (ta, tb_)),
            (local_mapping.fuse_duplicates, (a, b), (ta, tb_)),
            (local_mapping.create_depth_landmarks, (a, depth), (ta, depth))):
        assert _bits_equal(fn(m1, slam.cam, *args_int), fn(m1, slam.cam, *args_t)), fn
    assert _bits_equal(ms.remove_keyframe(m1, a), ms.remove_keyframe(m1, ta))
    assert _bits_equal(ms.row(m1.kf_T, a), ms.row(m1.kf_T, ta))


def test_keyframe_mapping_step_second_call_builds_no_constant(tracked):
    slam, _, m1, imgs = tracked
    kw = _mapping_call(slam, m1, imgs[0])
    local_mapping._keyframe_mapping_step(**kw)
    misses = _host.constant.cache_info().misses
    local_mapping._keyframe_mapping_step(**kw)
    assert _host.constant.cache_info().misses == misses


def test_mapping_slots_stage_the_step_inputs(tracked):
    """MonoSlam stages the slot, the partners and the timestamp in one
    copy: int64 slots and a timestamp in kf_ts's dtype, with their values."""
    slam = tracked[0]
    slot, tri, fuse, ts = slam._mapping_slots(5, [4, 3, 5, 5], [2, 5, 5], 0.7)
    assert (slot.dtype, tri.dtype, fuse.dtype, ts.dtype) == (
        torch.int64, torch.int64, torch.int64, slam.map.kf_ts.dtype)
    assert (slot.shape, tri.shape, fuse.shape, ts.shape) == ((), (4,), (3,), ())
    assert (int(slot), tri.tolist(), fuse.tolist()) == (5, [4, 3, 5, 5], [2, 5, 5])
    assert float(ts) == float(np.float32(0.7))


# ------------------------------------------------------ the inertial units

def _imu_chunk(S, seed):
    rng = np.random.default_rng(seed)
    acc = rng.normal(0, 0.2, (S, 3)) + [0.0, 0.0, pre_mod.GRAVITY]
    return vi_system.ImuChunk(gyro=rng.normal(0, 0.05, (S, 3)).astype(np.float32),
                              acc=acc.astype(np.float32),
                              dts=np.full(S, 1.0 / 200.0, np.float32))


def _vi_call(slam, m, img, S, prior, pad=True, seed=0):
    """The inertial frame step's arguments, as MonoInertialSlam makes them,
    on the corridor map ``m``: an S-sample IMU window (padded to its
    bucket), against the last keyframe or a PoseImuPrior."""
    z3 = torch.zeros(3)
    kf = int(np.flatnonzero(m.kf_valid.numpy())[-1])
    window = vi_system._chunk_tensors(_imu_chunk(S, seed), torch.device("cpu"), pad=pad)
    pri = marginalize.identity_prior(slam.T_last, z3, z3, z3) if prior else None
    return dict(img=img, cam_params=slam.cam, m=m, gyro=window[0], acc=window[1],
                dts=window[2], imu_ok=window[3], T_last=slam.T_last, vel=z3, bg=z3, ba=z3,
                pre_since_kf=pre_mod.identity_preintegrated(device="cpu"), T_kf=m.kf_T[kf],
                vel_kf=z3, prior=pri, ref_T=m.kf_T[0], calib=pre_mod.make_calib(),
                min_inl_retry=slam.min_track_inliers, max_kp=m.N, img_w=W, img_h=H)


def test_vi_frame_step_replays_the_eager_step(tracked):
    """Inertial frames through the runner and eagerly: against the last
    keyframe (replayed across a map change) and against a PoseImuPrior
    (a key of its own), at two IMU buckets (10 samples in 16, 5 in 8);
    every captured or replayed output bit-equal to the eager step's (a
    key's first call is the eager step itself)."""
    slam, m0, m1, imgs = tracked
    plan = [(m0, 0, 10, False), (m0, 1, 10, False), (m1, 1, 10, False),
            (m1, 0, 10, True), (m1, 1, 10, True), (m1, 0, 5, True), (m1, 1, 5, True)]
    r = _runner(vi_system.vi_frame_step)
    for i, (m, k, S, prior) in enumerate(plan):
        kw = _vi_call(slam, m, imgs[k], S, prior, seed=i)
        replays = r.replays
        got = r(**kw)
        if r.replays != replays:
            assert _bits_equal(got, vi_system._vi_frame_step(**kw)), i
    assert (r.captures, r.keys, r.replays) == (3, 3, 4)


def test_padded_imu_window_gives_the_unpadded_bits(tracked):
    """A window padded to its bucket, the pad masked off, gives the
    unpadded window's bits: through the preintegration (empty, short,
    exact and long windows) and through the whole inertial frame step."""
    z3 = torch.zeros(3)
    calib = pre_mod.make_calib()
    cpu = torch.device("cpu")
    for S in (0, 3, 8, 10, 17):
        chunk = _imu_chunk(S, S)
        plain = vi_system._chunk_tensors(chunk, cpu)
        padded = vi_system._chunk_tensors(chunk, cpu, pad=True)
        assert padded[0].shape[0] == vi_system.imu_bucket(S) == max(8, 1 << (S - 1).bit_length())
        assert int(padded[3].sum()) == S
        assert _bits_equal(pre_mod.integrate(*plain, z3, z3, calib),
                           pre_mod.integrate(*padded, z3, z3, calib)), S
    slam, _, m1, imgs = tracked
    got = vi_system._vi_frame_step(**_vi_call(slam, m1, imgs[0], 10, False))
    want = vi_system._vi_frame_step(**_vi_call(slam, m1, imgs[0], 10, False, pad=False))
    assert _bits_equal(got, want)


def test_vi_frame_step_second_call_builds_no_constant(tracked):
    slam, _, m1, imgs = tracked
    kw = _vi_call(slam, m1, imgs[0], 10, True)
    vi_system._vi_frame_step(**kw)
    misses = _host.constant.cache_info().misses
    vi_system._vi_frame_step(**kw)
    assert _host.constant.cache_info().misses == misses


def test_vi_bundle_adjust_replays_the_eager_solve():
    """VI-BA problems through the runner and eagerly at the keyframe
    path's 8 iterations: new states (the same key), then a reused-slot
    chain (an input of its own: a key); every captured or replayed output
    bit-equal to the eager solve's."""
    r = _runner(vi_ba.vi_bundle_adjust)
    p = _vi_ba_problem(6, 48, 0, "cpu", torch.float32)
    chain = p._replace(prev=torch.tensor([2, -1, 1, 0, 3, 4]),
                       edge_valid=torch.tensor([True, False, True, True, False, True]))
    probs = [p, p._replace(kf_vel=p.kf_vel + 0.01),
             p._replace(visual=p.visual._replace(lm_pos=p.visual.lm_pos + 0.02)),
             chain, chain._replace(kf_vel=chain.kf_vel - 0.01)]
    for i, q in enumerate(probs):
        replays = r.replays
        got = r(q, iters=8)
        if r.replays != replays:
            assert _bits_equal(got, vi_ba._vi_bundle_adjust(q, iters=8)), i
    assert (r.captures, r.keys, r.replays) == (2, 2, 3)


def test_vi_bundle_adjust_second_call_builds_no_constant():
    p = _vi_ba_problem(6, 48, 0, "cpu", torch.float32)
    vi_ba._vi_bundle_adjust(p, iters=2)
    misses = _host.constant.cache_info().misses
    vi_ba._vi_bundle_adjust(p, iters=2)
    assert _host.constant.cache_info().misses == misses


# ------------------------------------- the event-image and continuous units

def _mci_args(C, have_dpose, seed, have_klt=True):
    """build_mci's candidates' inputs over a C-slot window (cm_iters 3):
    the events of a moving point cloud, the pose prior and a KLT pair."""
    a = _window_args(C // 2, have_dpose, seed, L=2)
    rng = np.random.default_rng(seed + 100)
    n = 16
    kp = torch.from_numpy(np.stack([rng.uniform(20, W - 20, n), rng.uniform(20, H - 20, n)],
                                   1).astype(np.float32))
    kc = kp + torch.tensor([0.8, 0.1])
    return dict(ev=a[0].reshape(-1, 4), valid=a[1].reshape(-1), dt=a[2], T0=a[7], T1=a[8],
                med_depth=a[9], have_dpose=have_dpose, klt_prev=kp, klt_cur=kc,
                klt_ok=torch.ones(n, dtype=torch.bool), klt_dt=torch.tensor(0.002),
                have_klt=torch.tensor(have_klt), cam_params=a[11], H=H, W=W, sigma=1.0,
                cm_iters=3)


def _replays_equal(r, unit, calls):
    """Each call through the runner ``r``; every captured or replayed
    output bit-equal to ``unit.fn``'s on the same call (a key's first call
    is the eager step itself)."""
    for i, kw in enumerate(calls):
        replays = r.replays
        got = r(**kw)
        if r.replays != replays:
            assert _bits_equal(got, unit.fn(**kw)), i


def test_make_candidates_replays_the_eager_step():
    """Windows through the runner: without and then with the pose prior
    (a key each), the KLT candidate on and off (the same key), new events
    on every call; every replay bit-equal to the eager step."""
    r = _runner(tb.make_candidates)
    calls = [_mci_args(2048, dp, i, have_klt=i % 2 == 0)
             for i, dp in enumerate([False] * 3 + [True] * 3)]
    _replays_equal(r, tb.make_candidates, calls)
    assert (r.captures, r.keys, r.replays) == (2, 2, 4)
    assert not _bits_equal(r(**calls[4]), r(**calls[5]))


def test_make_candidates_second_call_builds_no_constant():
    kw = _mci_args(2048, True, 0)
    tb._make_candidates(**kw)
    misses = _host.constant.cache_info().misses
    tb._make_candidates(**kw)
    assert _host.constant.cache_info().misses == misses


def _chunk_calls(n, seed=0):
    """The per-chunk step's calls over ``n`` chunks of 1,948 events in
    2,048 slots, each the next's previous image: the first without one."""
    a = _window_args(2048, False, seed, L=n)
    calls, prev = [], None
    for i in range(n):
        kw = dict(ev=a[0][i], valid=a[1][i], prev_img=None, prev_pts=None, prev_ok=None,
                  H=H, W=W, sigma=1.0, n_klt=32, have_prev=prev is not None)
        if prev is not None:
            kw.update(prev_img=prev[0], prev_pts=prev[4], prev_ok=prev[5])
        prev = tb._chunk_step(**kw)
        calls.append(kw)
    return calls


def test_chunk_step_replays_the_eager_step():
    """Chunks through the runner, each tracked from the one before: the
    first two without a previous image (a key), then with one (a key);
    every replay bit-equal to the eager step; the step's median and its
    corners are the eager builder's."""
    calls = _chunk_calls(5)
    calls.insert(1, dict(calls[0], ev=calls[2]["ev"], valid=calls[2]["valid"]))
    r = _runner(tb.chunk_step)
    _replays_equal(r, tb.chunk_step, calls)
    assert (r.captures, r.keys, r.replays) == (2, 2, 4)
    out = tb._chunk_step(**calls[-1])
    assert out[1] is not None and torch.isfinite(out[1]) and bool(out[5].any())


def test_chunk_step_second_call_builds_no_constant():
    kw = _chunk_calls(2)[1]
    tb._chunk_step(**kw)
    misses = _host.constant.cache_info().misses
    tb._chunk_step(**kw)
    assert _host.constant.cache_info().misses == misses


def _track_calls(n=4):
    """Track advance and top-up calls: a store topped up on a chunk image,
    then advanced chunk by chunk and topped up again on each."""
    imgs = [c[0] * 255.0 for c in (tb._chunk_step(**kw) for kw in _chunk_calls(n, seed=3))]
    store = ft.top_up.fn(ft.empty_tracks(64), imgs[0])[0]
    adv, top = [], []
    for a, b in zip(imgs, imgs[1:]):
        adv.append(dict(tr=store, img_prev=a, img_cur=b))
        store = ft.advance.fn(**adv[-1])[0]
        top.append(dict(tr=store, img=b))
        store = ft.top_up.fn(**top[-1])[0]
    return adv, top


def test_track_advance_and_top_up_replay_the_eager_steps():
    """The continuous tracker's two track units through runners on a
    sequence of chunk images, each call on the store the last left; every
    replay bit-equal; top-up seeds tracks and advance keeps some."""
    adv, top = _track_calls()
    for unit, calls in ((ft.advance, adv), (ft.top_up, top)):
        r = _runner(unit)
        _replays_equal(r, unit, calls)
        assert (r.captures, r.keys, r.replays) == (1, 1, len(calls) - 1)
    assert int(ft.top_up.fn(**top[0])[1]) > 0
    assert bool(ft.advance.fn(**adv[-1])[0].valid.any())


def test_track_units_second_call_build_no_constant():
    adv, top = _track_calls(2)
    for fn, kw in ((ft.advance.fn, adv[0]), (ft.top_up.fn, top[0])):
        fn(**kw)
        misses = _host.constant.cache_info().misses
        fn(**kw)
        assert _host.constant.cache_info().misses == misses


def _pose_call(seed, n=96):
    rng = np.random.default_rng(seed)
    pts = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, n)].astype(np.float32)
    uv = (FX * pts[:, :2] / pts[:, 2:] + [W / 2.0, H / 2.0]).astype(np.float32)
    uv[:8] += 30.0
    T0 = lie.se3_exp(torch.from_numpy(rng.normal(0, 0.02, 6).astype(np.float32)))
    return dict(cam_params=torch.tensor([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0]), Tcw0=T0,
                pts_w=torch.from_numpy(pts), uv_obs=torch.from_numpy(uv),
                inv_sigma=torch.ones(n), valid=torch.from_numpy(rng.random(n) < 0.9))


def test_pose_optimization_replays_the_eager_solve():
    """Solves through the runner: new scenes at the default rounds, then
    fewer rounds (a key); every replay bit-equal; under torch.func.vmap the
    runner runs the solve inline."""
    r = _runner(pose_only.pose_optimization)
    calls = [_pose_call(i) for i in range(4)] + [dict(_pose_call(i), rounds=2)
                                                  for i in range(4, 7)]
    _replays_equal(r, pose_only.pose_optimization, calls)
    assert (r.captures, r.keys, r.replays) == (2, 2, 5)
    batch = [torch.stack([a, b]) for a, b in zip(_pose_call(0).values(),
                                                  _pose_call(1).values())]
    got = torch.func.vmap(lambda *a: r(*a))(*batch)
    assert r.replays == 5
    assert _bits_equal(got, torch.func.vmap(pose_only._pose_optimization)(*batch))


def _joint_calls(slam, m_im, m_ev, img, iters=3):
    """The five joint units' calls (tensors only, the bridge staged) on the
    corridor maps, the image map ``m_im`` and as the event map ``m_ev``
    (another state of the same corridor: timestamp twins), the frame
    ``img`` tracked against both; the init triangulation between the first keyframe
    and that frame."""
    kw = dict(max_kp=m_im.N, img_w=W, img_h=H)
    ri, fi, xi, *_ = tracking._track_image_frame(img, slam.cam, m_im, slam.velocity,
                                                  slam.T_last, m_im.kf_T[0], **kw)
    re, fe, xe, *_ = tracking._track_image_frame(img, slam.cam, m_ev, slam.velocity,
                                                  slam.T_last, m_ev.kf_T[0], **kw)
    c, s_ = np.cos(0.1), np.sin(0.1)
    R = np.asarray([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
    bridge = evi._bridge(R, np.asarray([0.05, -0.02, 0.1]), 1.3, m_im.kf_T)
    G = lie.se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.0, 0.3, 0.0]))
    free_im, free_ev = m_im.kf_valid.clone(), m_ev.kf_valid.clone()
    free_im[0] = free_ev[0] = False
    Tj = ri.Tcw
    return {
        "joint local BA": dict(im_map=m_im, ev_map=m_ev, cam_params=slam.cam, Rm=bridge[0],
                               tm=bridge[1], sm=bridge[2], kf_free_im=free_im,
                               kf_free_ev=free_ev, iters=iters),
        "loop propagation": dict(ev_map=m_ev, im_kf_ts=m_im.kf_ts, im_kf_valid=m_im.kf_valid,
                                 T_before=m_im.kf_T, T_after=m_im.kf_T @ G, Rm=bridge[0],
                                 tm=bridge[1], sm=bridge[2]),
        "init triangulation": dict(cam_params=slam.cam, d1=m_im.kf_desc_pm1[0],
                                   v1=m_im.kf_feat_valid[0], xy1=m_im.kf_xy[0], d2=fi.desc_pm1,
                                   v2=fi.valid, xy2=xi, T1=m_im.kf_T[0], T2=Tj),
        "joint pose": dict(cam_params=slam.cam, im_lm_pos=m_im.lm_pos, ev_lm_pos=m_ev.lm_pos,
                           feat_lm_i=ri.feat_lm, xy_i=xi, oct_i=fi.octave,
                           feat_lm_e=re.feat_lm, xy_e=xe, oct_e=fe.octave, Rm=bridge[0],
                           tm=bridge[1], sm=bridge[2], Tcw0=Tj),
        "joint write-back": dict(Tj=Tj, T_last_im=slam.T_last, T_last_ev=slam.T_last @ G,
                                 Rm=bridge[0], tm=bridge[1], sm=bridge[2],
                                 ref_T_im=m_im.kf_T[0]),
    }


JOINT_UNITS = {"joint local BA": evi.joint_local_ba, "loop propagation": evi.propagate_loop,
               "init triangulation": evi.init_triangulate, "joint pose": evi.joint_pose,
               "joint write-back": evi.joint_writeback}


@pytest.fixture(scope="module")
def joint(tracked):
    """Three calls of each joint unit: on the corridor's maps, then a new
    frame, then the two maps swapped (the same key)."""
    slam, m0, m1, imgs = tracked
    return [_joint_calls(slam, a, b, im)
            for a, b, im in ((m1, m0, imgs[-1]), (m1, m0, imgs[-2]), (m0, m1, imgs[-1]))]


@pytest.mark.parametrize("kind", list(JOINT_UNITS))
def test_joint_unit_replays_the_eager_step(joint, kind):
    """Each of EVENT_MONO's five joint units through a runner: every replay
    bit-equal to the eager step; a second call of the eager step builds no
    constant."""
    unit = JOINT_UNITS[kind]
    calls = [c[kind] for c in joint]
    r = _runner(unit)
    _replays_equal(r, unit, calls)
    assert (r.captures, r.keys, r.replays) == (1, 1, 2)
    misses = _host.constant.cache_info().misses
    out = unit.fn(**calls[0])
    assert _host.constant.cache_info().misses == misses
    # the step did work on these inputs
    assert JOINT_WORK[kind](out, calls[0]), kind


JOINT_WORK = {
    "joint local BA": lambda o, kw: float(o[2][1]) < float(o[2][0]),
    "loop propagation": lambda o, kw: not torch.equal(o.kf_T, kw["ev_map"].kf_T),
    "init triangulation": lambda o, kw: int(o[4]) >= 20,
    "joint pose": lambda o, kw: float(o[1][0]) >= 20 and float(o[1][2]) == 1.0,
    "joint write-back": lambda o, kw: bool(torch.isfinite(o[1]).all()),
}
