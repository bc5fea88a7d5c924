"""The inertial units' graph runners on the CPU: ``inertial.inertial_init``
(the IMU init and its scale refinement: two keys), ``inertial.linear_alignment``
(the init's seed, inline inside the init's capture),
``vi_system.preintegrate_frame`` (a pre-init frame's preintegration and
the keyframe window's merge) and ``vi_system.write_kf_imu_state`` (the
per-keyframe inertial-state write), the port's counterparts of the
reference's jitted ``inertial_init`` and ``linear_alignment``, its
``integrate`` scan with the ``merge`` after it, and ``_write_kf_imu_state``.

Each runner is driven with the stand-in graph class of
``tests/test_torch_graphs.py`` (``CpuGraph``: a capture on CPU tensors whose
replay runs the captured call again on the runner's static buffers) and
held bit for bit against its eager function: the init at both keys and with
``fix_scale`` both ways (K = 8, a few iterations), the preintegration at
buckets 8 and 16 against the unpadded window's eager integrate and merge,
the write with an int slot (eager) and a tensor slot (the graph's form). A
second eager call builds no cached constant, and no unit reads a device
value or lifts host data (``tests/test_torch_host_reads.py``'s counter). A
MonoInertialSlam on a SynthWorld (its poses from numpy) runs through the
stand-in runners, each key met before the run so that its first call in
the run captures, and eagerly: the same bits, the same IMU init frame and
scale. One parity case holds the init (the app's first-init key, 60
iterations) and a padded frame's preintegration and merge against the JAX
package's ``inertial_init``, ``integrate`` and ``merge`` in one jitted call,
at ``tests/test_torch_imu.py``'s tolerances: scale rel 1e-4, gravity 1e-4
rad, gyro bias 1e-5, acc bias 5e-4, velocities 1e-4 abs; preintegration
1e-5 abs.

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

from chip_smoke import _bits_equal, _imu_window, _vi_init_problem
from eorb_slam_tpu.imu import preintegration as jpre
from eorb_slam_tpu.optim import inertial as jin
from eorb_slam_tpu_torch import _graphs, _host, convert
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.optim import inertial
from eorb_slam_tpu_torch.slam import system as tsys
from eorb_slam_tpu_torch.slam import vi_system
from tests.synth import CAM, SynthWorld, imu_between
from tests.test_torch_graphs import _imu_chunk, _runner
from tests.test_torch_host_reads import HostReads

UNITS = {"inertial_init": (inertial, "inertial_init"),
         "linear_alignment": (inertial, "linear_alignment"),
         "preintegrate_frame": (vi_system, "preintegrate_frame"),
         "write_kf_imu_state": (vi_system, "write_kf_imu_state")}
# the app's two keys of the init (vi_system.MonoInertialSlam: the first
# init and the scale refinement), at a few iterations
INIT_KEY = dict(prior_gyro=1e2, prior_acc=1e6, iters=4)
REFINE_KEY = dict(prior_gyro=1.0, prior_acc=1e4, iters=3)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_problem = functools.lru_cache(maxsize=None)(_vi_init_problem)


def _init_inputs(seed, K=8, slots=None, prev=True):
    """The init's tensor inputs by name on tests/test_imu.py's problem, the
    poses moved by a seeded few millimetres (another call's values)."""
    Twb, stack, ev = _problem(K, slots)
    rng = np.random.default_rng(seed)
    Twb = Twb.copy()
    Twb[:K, :3, 3] += rng.normal(0, 3e-3, (K, 3)).astype(np.float32)
    kw = dict(Twb=torch.from_numpy(Twb), pre_stack=convert.pre_from_numpy(stack),
              edge_valid=torch.from_numpy(ev))
    if prev:
        n = len(ev)
        kw["prev"] = torch.arange(n, dtype=torch.int64) - 1
    return kw


def _since(seed):
    """A keyframe window already holding one frame's preintegration."""
    chunk = _imu_chunk(9, 100 + seed)
    z3 = torch.zeros(3)
    return pre_mod.integrate(*vi_system._chunk_tensors(chunk, CPU), z3, z3,
                             pre_mod.make_calib())


def _state(K, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))  # noqa: E731
    pre_kf = pre_mod.stack([_since(seed + k) for k in range(K)])
    return dict(pre_kf=pre_kf, kf_vel=f(K, 3), kf_bg=f(K, 3), kf_ba=f(K, 3),
                pre_window=_since(seed + 50), vel=f(3), bg=f(3), ba=f(3))


@pytest.fixture(scope="module")
def calls():
    """Each unit's calls by name, a sequence crossing keys (the last one is
    the single-call checks' call)."""
    calib = pre_mod.make_calib()
    pre = [dict(zip(("gyro", "acc", "dts", "imu_ok"),
                    vi_system._chunk_tensors(_imu_chunk(S, S), CPU, pad=True)),
                pre_since_kf=_since(S), calib=calib)
           for S in (5, 8, 10, 13, 16, 7)]
    init = [dict(_init_inputs(s), **k) for s, k in (
        (0, INIT_KEY), (1, INIT_KEY), (2, INIT_KEY), (3, REFINE_KEY), (4, REFINE_KEY),
        (5, REFINE_KEY), (6, dict(REFINE_KEY, fix_scale=True)),
        (7, dict(REFINE_KEY, fix_scale=True)))]
    align = [_init_inputs(s, prev=p) for s, p in ((0, True), (1, True), (2, True),
                                                  (3, False), (4, False))]
    write = [dict(_state(8, s), slot=torch.tensor(k)) for s, k in ((0, 3), (1, 5), (2, 0))]
    return {"inertial_init": init, "linear_alignment": align, "preintegrate_frame": pre,
            "write_kf_imu_state": write}


# (keys, replays) each sequence meets
KEYS = {"inertial_init": (3, 5), "linear_alignment": (2, 3), "preintegrate_frame": (2, 4),
        "write_kf_imu_state": (1, 2)}


def test_the_four_units_are_graph_runners():
    """Each unit is a runner whose static arguments are the reference's
    static_argnames and the Python numbers the port keys on."""
    static = {"inertial_init": ("prior_gyro", "prior_acc", "iters", "fix_scale"),
              "linear_alignment": (), "preintegrate_frame": (), "write_kf_imu_state": ()}
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


def test_init_runs_the_alignment_inline(calls, monkeypatch):
    """Inside the init's capture the alignment runs inline: a stand-in
    alignment runner meets its key once (the init's eager first call) and
    neither captures nor replays; the init keeps its bits."""
    inner = _runner(inertial.linear_alignment)
    monkeypatch.setattr(inertial, "linear_alignment", inner)
    r = _runner(inertial.inertial_init)
    for kw in calls["inertial_init"][:3]:
        got = r(**kw)
        with _graphs.capturing():
            assert _bits_equal(got, inertial._inertial_init(**kw))
    assert (r.captures, r.replays) == (1, 2)
    assert (inner.captures, inner.replays, len(inner._warm)) == (0, 0, 1)


def test_padded_window_gives_the_unpadded_bits(calls):
    """Buckets 8 and 16: the padded window through the runner gives the
    eager integrate and merge of the window as it came, unpadded."""
    r = _runner(vi_system.preintegrate_frame)
    calib = pre_mod.make_calib()
    z3 = torch.zeros(3)
    for S in (5, 8, 8, 10, 16, 13, 12):
        chunk = _imu_chunk(S, S)
        padded = vi_system._chunk_tensors(chunk, CPU, pad=True)
        since = _since(S)
        got = r(*padded, since, calib)
        pre = pre_mod.integrate(*vi_system._chunk_tensors(chunk, CPU), z3, z3, calib)
        assert _bits_equal(got, (pre, pre_mod.merge(since, pre))), S
    assert (r.keys, r.replays) == (2, 5)


def test_write_takes_int_and_tensor_slots_alike(calls):
    """The eager write on an int slot (the reference's form) and the runner
    on a device tensor: the same bits, and only the slot's rows change."""
    r = _runner(vi_system.write_kf_imu_state)
    for kw in calls["write_kf_imu_state"]:
        slot = int(kw["slot"])
        want = vi_system._write_kf_imu_state(**dict(kw, slot=slot))
        assert _bits_equal(r(**kw), want), slot
        pre, vel, _, _ = want
        keep = torch.arange(8) != slot
        assert _bits_equal(vel[keep], kw["kf_vel"][keep])
        assert _bits_equal(vel[slot], kw["vel"])
        assert _bits_equal(pre_mod.take(pre, slot), kw["pre_window"])
    # the old form: pre_mod.put and an index assignment
    kw = calls["write_kf_imu_state"][0]
    vel = kw["kf_vel"].clone()
    vel[3] = kw["vel"]
    got = vi_system._write_kf_imu_state(**dict(kw, slot=3))
    assert _bits_equal(got[0], pre_mod.put(kw["pre_kf"], 3, kw["pre_window"]))
    assert _bits_equal(got[1], vel)


@pytest.mark.parametrize("unit", list(UNITS))
def test_unit_second_call_builds_no_constant(calls, unit):
    mod, name = UNITS[unit]
    fn, kw = getattr(mod, name).fn, calls[unit][-1]
    fn(**kw)
    misses = _host.constant.cache_info().misses
    fn(**kw)
    assert _host.constant.cache_info().misses == misses


@pytest.mark.parametrize("unit", list(UNITS))
def test_unit_reads_nothing(calls, unit):
    """After a warm-up the unit neither reads a device value on the host
    nor makes a tensor of host data."""
    mod, name = UNITS[unit]
    fn = getattr(mod, name).fn
    for kw in calls[unit][-2:]:
        fn(**kw)
        with HostReads() as hr:
            fn(**kw)
        assert not hr.reads and not hr.lifts, (dict(hr.reads), dict(hr.lifts))


# ---------------------------------------------------- through the system

class _World(SynthWorld):
    """tests/synth.SynthWorld with its poses from numpy (no JAX call)."""

    def pose(self, t: float) -> np.ndarray:
        pos = np.asarray([1.2 * t + 0.25 * np.sin(1.3 * t), 0.35 * np.sin(2.0 * t),
                          0.3 * t + 0.2 * (1.0 - np.cos(1.7 * t))])
        R = tsd.so3_exp_np(np.asarray([0.05 * np.sin(0.3 * t), 0.12 * np.sin(0.5 * t),
                                       0.0])).astype(np.float32)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R.T
        Tcw[:3, 3] = -R.T @ pos
        return Tcw


VI_FRAMES, VI_FPS = 21, 20.0
VI_KW = dict(K=8, M=2048, N=512, P=8, min_kf_imu_init=4, min_time_imu_init=0.8,
             max_frames_between_kf=3)


def _vi_run(world_frames):
    """MonoInertialSlam through ``process_features_imu`` on the frames:
    (its per-frame (state, kf, IMU initialised), the system)."""
    slam = vi_system.MonoInertialSlam(CAM, pre_mod.make_calib(freq=200.0), device="cpu",
                                      **VI_KW)
    log = []
    for f, chunk in world_frames:
        r = slam.process_features_imu(f, chunk)
        log.append((r["state"], bool(r.get("kf")), slam.imu_initialized))
    return log, slam


def _warm(runner, kw):
    """A key's first call (eager), so that the run's first call captures."""
    n = len(runner._warm)
    runner(**kw)
    assert len(runner._warm) == n + 1 and runner.keys == 0


def test_inertial_slam_replays_the_eager_run(monkeypatch):
    """The same run through stand-in runners of the four units (each key of
    the init and the write met once before the run, so that the run's
    first call of it captures and the later ones replay) and eagerly: the
    same decisions, IMU init frame, scales, trajectory and map bits."""
    world = _World(n_landmarks=1500, seed=0, noise_px=0.4)
    frames, t_prev = [], 0.0
    for i in range(VI_FRAMES):
        t = i / VI_FPS
        f, _ = world.frame(t)
        frames.append((tsys.FrameInput(f.ts, *(torch.from_numpy(np.array(x)) for x in (
            f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid))),
            vi_system.ImuChunk(**vars(imu_between(world, t_prev, t)))))
        t_prev = t
    K = VI_KW["K"]
    runners = {u: _runner(getattr(mod, name)) for u, (mod, name) in UNITS.items()}
    for u, (mod, name) in UNITS.items():
        monkeypatch.setattr(mod, name, runners[u])
    _warm(runners["inertial_init"], dict(_init_inputs(0, K=K), prior_gyro=1e2,
                                         prior_acc=1e6, iters=60, fix_scale=False))
    _warm(runners["inertial_init"], dict(_init_inputs(1, K=K), prior_gyro=1.0,
                                         prior_acc=1e4, iters=40, fix_scale=False))
    _warm(runners["write_kf_imu_state"], dict(_state(K, 0), slot=torch.tensor(2)))
    log_g, g = _vi_run(frames)
    for u, (mod, name) in UNITS.items():
        monkeypatch.setattr(mod, name, runners[u].fn)
    log_e, e = _vi_run(frames)
    init_at = [i for i, (*_, ini) in enumerate(log_g) if ini]
    assert log_g == log_e and init_at, (log_g, log_e)
    assert g.scale_applied == e.scale_applied and g._init_scale_hist == e._init_scale_hist
    assert len(g.pending_world_transforms) >= 2       # the init and a refinement
    for (Rg, sg), (Re, se) in zip(g.pending_world_transforms, e.pending_world_transforms):
        assert sg == se and np.array_equal(Rg, Re)
    assert [t for t, _, _ in g.trajectory] == [t for t, _, _ in e.trajectory]
    assert _bits_equal([T for _, T, _ in g.trajectory], [T for _, T, _ in e.trajectory])
    assert _bits_equal((tuple(g.map), g.pre_kf, g.kf_vel, g.kf_bg, g.kf_ba, g.T_last),
                       (tuple(e.map), e.pre_kf, e.kf_vel, e.kf_bg, e.kf_ba, e.T_last))
    init, write, pre = (runners[u] for u in ("inertial_init", "write_kf_imu_state",
                                             "preintegrate_frame"))
    assert (init.keys, write.keys) == (2, 1) and init.replays >= 2 and write.replays >= 4
    assert pre.keys >= 1 and pre.replays >= VI_FRAMES - 4


# ------------------------------------------------------ against the reference

def test_init_and_preintegration_match_jax():
    """The app's first-init key (60 iterations) on tests/test_imu.py's
    problem, and a padded frame's preintegration with the merge after it,
    against the JAX package in one jitted call."""
    Twb, stack, ev = _problem(8, None)
    prev = np.arange(8, dtype=np.int32) - 1
    g, a, d, o = _imu_window(0.3, 0.35, bg=np.asarray([0.02, -0.01, 0.015]))
    since = convert.pre_to_numpy(_since(0))

    @jax.jit
    def ref(Twb, stack, ev, prev, g, a, d, o, since):
        init = jin.inertial_init(Twb, stack, ev, prior_gyro=1e2, prior_acc=1e6, iters=60,
                                 prev=prev)
        pre = jpre.integrate(g, a, d, o, jnp.zeros(3), jnp.zeros(3), jpre.make_calib())
        return init, pre, jpre.merge(since, pre)

    jp = lambda p: jpre.Preintegrated(**{k: jnp.asarray(v) for k, v in p.items()})  # noqa: E731
    rj, pj, mj = jax.tree_util.tree_map(np.asarray, ref(
        jnp.asarray(Twb), jp(stack), jnp.asarray(ev), jnp.asarray(prev),
        *(jnp.asarray(x) for x in (g, a, d, o)), jp(since)))

    rt = inertial.inertial_init(torch.from_numpy(Twb), convert.pre_from_numpy(stack),
                                torch.from_numpy(ev), prior_gyro=1e2, prior_acc=1e6,
                                iters=60, prev=torch.from_numpy(prev).long())
    assert abs(float(rt.scale) - float(rj.scale)) <= 1e-4 * float(rj.scale)
    cos = np.dot(rt.g.numpy(), rj.g) / (np.linalg.norm(rt.g.numpy()) * np.linalg.norm(rj.g))
    assert float(np.arccos(np.clip(cos, -1.0, 1.0))) < 1e-4
    np.testing.assert_allclose(rt.bg.numpy(), rj.bg, atol=1e-5)
    np.testing.assert_allclose(rt.ba.numpy(), rj.ba, atol=5e-4)
    np.testing.assert_allclose(rt.vel.numpy(), rj.vel, atol=1e-4)
    assert float(rt.scale) == pytest.approx(2.5, rel=0.02)

    chunk = vi_system.ImuChunk(gyro=g, acc=a, dts=d)
    assert vi_system.imu_bucket(len(d)) > len(d)          # the pad is there
    pt, mt = vi_system.preintegrate_frame(*vi_system._chunk_tensors(chunk, CPU, pad=True),
                                          convert.pre_from_numpy(since), pre_mod.make_calib())
    for got, want in ((pt, pj), (mt, mj)):
        for name, x, y in zip(pre_mod.Preintegrated._fields, got, want):
            np.testing.assert_allclose(x.numpy(), y, atol=1e-5, err_msg=name)
