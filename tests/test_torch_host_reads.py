"""The port's frame path reads nothing back from its device and copies no
host constant to it.

On the card two kinds of call drain the stream: a read of a device value
(``int``/``bool``/``float``/``.item()`` of a tensor: ``_local_scalar_dense``,
and ops whose output shape depends on the data: ``nonzero``, a boolean-mask
index, ``masked_select``, ``unique``), and a copy of host data to the device
made by ``torch.tensor``/``as_tensor``/``from_numpy`` (``lift_fresh``; torch
copies pageable memory to the card with a synchronising memcpy unless
``non_blocking=True``). On the CPU the same calls reach the dispatcher, so a
``TorchDispatchMode`` counts them here, each under the ``file:line`` of the
port that made it. Every check warms up once first, so that constants cached
per device are built.

Cases: the pose-only GN, local BA's LM loop (``schur_ba.bundle_adjust``),
``track_image_frame``, ``MonoSlam.process_image``
on tracked frames that insert no keyframe (synchronous and speculative),
``EventWindowBuilder.step_window`` (host data staged only by the named
helpers), one keyframe insertion (a stated small count), and the inertial
frame step ``vi_system._vi_frame_step`` against the last keyframe and
against a ``PoseImuPrior``, on the narrow and on the wide branch of its
re-search (chosen on the device): it reads nothing, so the inertial frame's
one read is its caller's flags (``MonoInertialSlam.process_image_imu``).
The event-image and continuous units (build_mci's candidates, the per-chunk
step, track advance and top-up, EVENT_MONO's five joint steps) read
nothing; ``EventWindowBuilder.step`` reads one median per chunk, and the
joint steps' wrappers lift their host bridge in one staging copy.
The status checks inside ``torch.linalg.eigh``/``svd`` never reach the
dispatcher: the card's ``chip_smoke._Syncs`` counts those, and the port no
longer calls either on a CUDA tensor in these steps. No JAX here.
"""

from __future__ import annotations

import collections
import copy
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.event import feature_tracks as ft
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.imu import preintegration as pre_mod
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.optim import marginalize, pose_only, schur_ba
from eorb_slam_tpu_torch.slam import system as tsys
from eorb_slam_tpu_torch.slam import tracking, vi_system
from eorb_slam_tpu_torch.slam import ev_image_system as evi
from tests.test_torch_graphs import (JOINT_UNITS, _ba_problem, _chunk_calls, _joint_calls,
                                     _mci_args, _track_calls)

PKG = os.path.dirname(os.path.abspath(tsys.__file__)).rsplit(os.sep, 1)[0]
aten = torch.ops.aten
# a device value read on the host
READS = {aten._local_scalar_dense.default}
# ops whose output shape depends on the data (the host waits for it)
SHAPED = {aten.nonzero.default, aten.masked_select.default,
          aten._unique2.default, aten.unique_consecutive.default,
          aten.unique_dim.default}
# host data made into a tensor (a host-to-device copy on the card)
LIFTS = {aten.lift_fresh.default}

W, H, FX, FPS = 240, 180, 146.25, 20.0
KW = dict(img_w=W, img_h=H, K=8, M=1024, N=256, max_frames_between_kf=3)
N_FRAMES = 8


def _site() -> str:
    """``file:line function`` of the innermost frame inside the port's
    package."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.startswith(PKG + os.sep):
            return (f"{os.path.relpath(f.f_code.co_filename, PKG)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "outside the package"


def _where(sites) -> set:
    """The ``file function`` of each ``file:line function`` site."""
    return {f"{s.split(':')[0]} {s.split()[1]}" for s in sites}


class HostReads(TorchDispatchMode):
    """Counts, while active, the port's host reads and host-data lifts by
    site: ``reads`` and ``lifts`` are ``Counter({"file:line": n})``."""

    def __init__(self):
        super().__init__()
        self.reads = collections.Counter()
        self.lifts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in READS or func in SHAPED or (
                func is aten.index.Tensor and any(
                    i is not None and i.dtype == torch.bool for i in args[1])):
            self.reads[_site()] += 1
        elif func in LIFTS:
            self.lifts[_site()] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cam():
    return np.asarray([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def frames():
    """The corridor at 240x180 through the port's box renderer, uint8."""
    render = tsd.make_box_renderer("corridor", W, H, FX, device="cpu")
    pose = tsd.make_trajectory("corridor", 10.0)
    return [(i / FPS, (render(np.asarray(pose(i / FPS), np.float32)) * 255.0)
             .to(torch.uint8)) for i in range(N_FRAMES)]


def _tracking_slam(frames, pipelined):
    """A MonoSlam past its initialisation, and the next frame's index."""
    slam = tsys.MonoSlam(_cam(), pipelined=pipelined, device="cpu", **KW)
    for i, (ts, img) in enumerate(frames):
        slam.process_image(img, ts)
        if slam.state == tsys.OK:
            return slam, i + 1
    pytest.fail("the corridor did not initialise")


def test_pose_optimization_reads_nothing():
    rng = np.random.default_rng(0)
    n = 128
    pts = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, n)].astype(np.float32)
    cam = torch.from_numpy(_cam())
    T0 = torch.eye(4)
    uv = (FX * pts[:, :2] / pts[:, 2:] + [W / 2.0, H / 2.0]).astype(np.float32)
    args = (cam, T0, torch.from_numpy(pts), torch.from_numpy(uv), torch.ones(n),
            torch.from_numpy(rng.random(n) < 0.9))
    pose_only.pose_optimization(*args)
    with HostReads() as hr:
        Tcw, inl, n_inl = pose_only.pose_optimization(*args)
    assert not hr.reads and not hr.lifts, (hr.reads, hr.lifts)
    assert torch.isfinite(Tcw).all() and int(n_inl) > 0


def test_bundle_adjust_reads_nothing():
    """Local BA's LM loop (accept and reject on the device) reads nothing
    and lifts no host data once warmed up."""
    prob = _ba_problem()
    schur_ba.bundle_adjust(prob, iters=4)
    with HostReads() as hr:
        res = schur_ba.bundle_adjust(prob, iters=4)
    assert not hr.reads and not hr.lifts, (hr.reads, hr.lifts)
    assert float(res.cost) < float(res.cost0)


def test_se3_copies_its_bottom_row_once():
    """``lie.se3`` lifts no constant once its cached row exists, and keeps
    its values."""
    R = lie.so3_exp(torch.tensor([[0.1, -0.2, 0.3], [0.0, 0.0, 0.0]]))
    t = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]])
    lie.se3(R, t)
    with HostReads() as hr:
        T = lie.se3(R, t)
    assert not hr.lifts and not hr.reads
    assert T.shape == (2, 4, 4)
    assert torch.equal(T[:, 3], torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 2))
    assert torch.equal(T[:, :3, :3], R) and torch.equal(T[:, :3, 3], t)


def test_track_image_frame_reads_nothing(frames):
    slam, i = _tracking_slam(frames, pipelined=False)
    ts, img = frames[i]
    args = (img, slam.cam, slam.map, slam.velocity, slam.T_last,
            slam.map.kf_T[slam._kf_ref()])
    kw = dict(max_kp=slam.map.N, img_w=W, img_h=H)
    tracking.track_image_frame(*args, **kw)
    with HostReads() as hr:
        res = tracking.track_image_frame(*args, **kw)
    assert not hr.reads and not hr.lifts, (hr.reads, hr.lifts)
    assert int(res[3][0]) >= slam.min_track_inliers


@pytest.fixture(scope="module")
def runs(frames):
    """Both modes over the frames after the initialisation: each step's
    result and its HostReads."""
    out = {}
    slam0, i = _tracking_slam(frames, pipelined=False)
    for pipelined in (False, True):
        slam = copy.deepcopy(slam0)
        slam.pipelined = pipelined
        steps = []
        for ts, img in frames[i:]:
            kf0 = slam.stats["kf"]
            with HostReads() as hr:
                res = slam.process_image(img, ts)
            steps.append((res, slam.stats["kf"] != kf0, hr))
        out[pipelined] = steps
    return out


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "speculative"])
def test_process_image_tracked_frames_read_only_the_flags(runs, pipelined):
    """A tracked frame that inserts no keyframe: nothing but its (2,)
    flags read (synchronous: the frame's own, here a CPU tensor that needs
    no read op; speculative: the previous frame's HostCopy)."""
    seen = 0
    for res, new_kf, hr in runs[pipelined]:
        if res.get("kf") or new_kf or res["state"] != tsys.OK:
            continue
        seen += 1
        assert not hr.reads and not hr.lifts, (res, hr.reads, hr.lifts)
    assert seen >= 3


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "speculative"])
def test_keyframe_insertion_reads_a_few(runs, pipelined):
    """A frame that inserts a keyframe (the mapping step, the culling pass,
    the BA window; the initialisation warmed the caches up): reads only at
    KF_READS, and host data lifted only for the BA window's mask and, in
    one staging copy, the mapping step's slots and timestamp."""
    kf_steps = [hr for res, _, hr in runs[pipelined] if res.get("kf")]
    assert kf_steps
    for hr in kf_steps:
        assert _where(hr.reads) <= KF_READS and sum(hr.reads.values()) <= 16, hr.reads
        assert _where(hr.lifts) <= KF_LIFTS, hr.lifts
        staged = sum(n for site, n in hr.lifts.items() if site.startswith("_host.py"))
        assert staged == 1, hr.lifts


# none: the local BA's one-hot camera assignment is a comparison (F.one_hot
# read its classes' range twice per LM iteration on the CPU)
KF_READS: set = set()
# the BA window's (K,) mask, and the mapping step's slot, partners and
# timestamp (MonoSlam._mapping_slots, one to_device): host data, staged
# without blocking
KF_LIFTS = {"slam/system.py _ba_window", "_host.py to_device"}


def _stream(seconds=0.04, rate=600_000, seed=5):
    """DAVIS240-sized events of a point cloud seen by a moving camera."""
    rng = np.random.default_rng(seed)
    F, Wd, Hd = 199.0, 240, 180
    pts = np.stack([rng.uniform(-2.2, 2.2, 300), rng.uniform(-1.6, 1.6, 300),
                    rng.uniform(2.5, 6.0, 300)], 1)
    n = int(seconds * rate)
    ts = np.sort(rng.uniform(0, seconds, n))
    p = pts[rng.integers(0, len(pts), n)]
    pos = np.stack([4.0 * ts, 0.3 * np.sin(20 * ts), 0.8 * ts], 1)
    q = p - pos
    ev = np.stack([ts, F * q[:, 0] / q[:, 2] + Wd / 2.0, F * q[:, 1] / q[:, 2] + Hd / 2.0,
                   rng.choice([-1.0, 1.0], n)], 1)
    inb = (ev[:, 1] >= 0) & (ev[:, 1] < Wd) & (ev[:, 2] >= 0) & (ev[:, 2] < Hd)
    return ev[inb]


# the host data a window really brings, staged by these two helpers
STAGING = {"event/builder.py _to_dev", "_host.py to_device"}


def test_step_window_reads_nothing():
    cfg = tb.BuilderConfig(img_w=240, img_h=180, l1_chunk_size=1000, l1_num_loop=4,
                           max_pixel_disp=3.0, min_ev_gen_rate=0.5, cm_iters=3)
    cam = np.asarray([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0, 0], np.float32)
    bld = tb.EventWindowBuilder(cfg, cam, device="cpu")
    bld.feed(_stream())
    assert bld.step_window() is not None
    # the L2 pose prior as EventSlam posts it: device tensors
    T = lie.se3_exp(torch.tensor([0.01, 0.0, 0.02, 0.0, 0.01, 0.0]))
    bld.set_pose_prior(torch.eye(4), T, torch.tensor(4.0))
    n = 0
    while True:
        with HostReads() as hr:
            pi = bld.step_window()
        if pi is None:
            break
        n += 1
        assert not hr.reads, hr.reads
        assert _where(hr.lifts) <= STAGING, hr.lifts
    assert n >= 1


@pytest.mark.parametrize("branch", ["narrow", "wide"])
@pytest.mark.parametrize("prior", [False, True], ids=["last_keyframe", "pose_imu_prior"])
def test_vi_frame_step_reads_nothing(frames, prior, branch):
    """The inertial frame step on the corridor map: 200 Hz IMU samples of
    a body at rest, the wide re-search forced by the threshold (never met,
    or always met)."""
    slam, i = _tracking_slam(frames, pipelined=False)
    _, img = frames[i]
    S = int(round(200.0 / FPS))
    z3 = torch.zeros(3)
    window = (torch.zeros(S, 3), torch.tensor([[0.0, 0.0, pre_mod.GRAVITY]] * S),
              torch.full((S,), 1.0 / 200.0), torch.ones(S, dtype=torch.bool))
    kf = slam._kf_order[-1]
    imu_prior = marginalize.identity_prior(slam.T_last, z3, z3, z3) if prior else None
    args = (img, slam.cam, slam.map, *window, slam.T_last, z3, z3, z3,
            pre_mod.identity_preintegrated(device="cpu"), slam.map.kf_T[kf], z3,
            imu_prior, slam.map.kf_T[slam._kf_ref()], pre_mod.make_calib(),
            0 if branch == "narrow" else 10_000)
    kw = dict(max_kp=slam.map.N, img_w=W, img_h=H)
    vi_system._vi_frame_step(*args, **kw)
    with HostReads() as hr:
        out = vi_system._vi_frame_step(*args, **kw)
    assert not hr.reads and not hr.lifts, (hr.reads, hr.lifts)
    flags = out[3]
    assert flags.shape == (2,) and torch.isfinite(flags).all()


def test_event_units_read_nothing():
    """build_mci's candidates, the per-chunk step (with and without a
    previous image), track advance and top-up: no read, no lift."""
    adv, top = _track_calls(2)
    chunks = _chunk_calls(2)
    for fn, kw in ((tb._make_candidates, _mci_args(2048, True, 0)),
                   (tb._chunk_step, chunks[0]), (tb._chunk_step, chunks[1]),
                   (ft._advance, adv[0]), (ft._top_up, top[0])):
        fn(**kw)
        with HostReads() as hr:
            fn(**kw)
        assert not hr.reads and not hr.lifts, (fn.__name__, hr.reads, hr.lifts)


def test_step_reads_one_median_per_chunk():
    """The per-chunk path over a stream: each chunk reads its median
    displacement once (the reference reads it too), a window's MCI adds
    only build_mci's packed read (a copy, unseen on the CPU); host data is
    staged only by the named helpers."""
    cfg = tb.BuilderConfig(img_w=240, img_h=180, l1_chunk_size=1000, l1_num_loop=3,
                           max_pixel_disp=3.0, min_ev_gen_rate=0.5, cm_iters=2,
                           max_window_events=4096)
    bld = tb.EventWindowBuilder(cfg, np.asarray([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0, 0],
                                                np.float32), device="cpu")
    bld.feed(_stream(0.05))
    seen = collections.Counter()
    while True:
        with HostReads() as hr:
            pi = bld.step()
        if pi is None:
            break
        if bld.stats["chunks"] > 1:
            assert _where(hr.reads) == {"event/builder.py step"}, hr.reads
            assert sum(hr.reads.values()) == 1, hr.reads
        if seen[1]:          # the first MCI built the device constants
            assert _where(hr.lifts) <= STAGING, hr.lifts
        seen[pi.reconst_stat] += 1
    assert seen[0] >= 4 and seen[1] >= 2, seen


@pytest.fixture(scope="module")
def joint_calls(frames):
    slam, i = _tracking_slam(frames, pipelined=False)
    return slam, _joint_calls(slam, slam.map, slam.map, frames[i][1])


def test_joint_units_read_nothing(joint_calls):
    for kind, kw in joint_calls[1].items():
        fn = JOINT_UNITS[kind].fn
        fn(**kw)
        with HostReads() as hr:
            fn(**kw)
        assert not hr.reads and not hr.lifts, (kind, hr.reads, hr.lifts)


def test_joint_wrappers_stage_the_bridge_in_one_copy(joint_calls, monkeypatch):
    """Each joint wrapper given the host bridge (numpy and a float) lifts it
    in one staging copy and hands its runner tensors only (a runner raises
    on a Python number or an array); given a staged bridge it lifts none.
    The values are the runner's on the staged bridge."""
    slam, calls = joint_calls
    c, s_ = np.cos(0.1), np.sin(0.1)
    host = (np.asarray([[c, -s_, 0], [s_, c, 0], [0, 0, 1]]), np.asarray([0.05, -0.02, 0.1]),
            1.3)
    staged = evi._bridge(*host, slam.map.kf_T)
    assert [tuple(t.shape) for t in staged] == [(3, 3), (3,), ()]
    assert len({t.untyped_storage().data_ptr() for t in staged}) == 1
    wrappers = {
        "joint local BA": lambda b, k: evi._joint_local_ba_step(
            k["im_map"], k["ev_map"], k["cam_params"], *b, k["kf_free_im"], k["kf_free_ev"],
            iters=k["iters"]),
        "loop propagation": lambda b, k: evi._propagate_loop_to_event(
            k["ev_map"], k["im_kf_ts"], k["im_kf_valid"], k["T_before"], k["T_after"], *b),
        "joint pose": lambda b, k: evi._joint_pose_step(
            k["cam_params"], k["im_lm_pos"], k["ev_lm_pos"], k["feat_lm_i"], k["xy_i"],
            k["oct_i"], k["feat_lm_e"], k["xy_e"], k["oct_e"], *b, k["Tcw0"]),
        "joint write-back": lambda b, k: evi._joint_writeback(
            k["Tj"], k["T_last_im"], k["T_last_ev"], *b, k["ref_T_im"]),
    }
    for kind, call in wrappers.items():
        kw = calls[kind]
        want = JOINT_UNITS[kind].fn(**dict(kw, Rm=staged[0], tm=staged[1], sm=staged[2]))
        for bridge, lifts in ((host, 1), (staged, 0)):
            call(bridge, kw)
            with HostReads() as hr:
                got = call(bridge, kw)
            assert not hr.reads, (kind, hr.reads)
            assert sum(hr.lifts.values()) == lifts and _where(hr.lifts) <= {
                "_host.py to_device"}, (kind, hr.lifts)
            for a, b in zip(torch.utils._pytree.tree_leaves(got),
                            torch.utils._pytree.tree_leaves(want)):
                assert torch.equal(a, b), kind
