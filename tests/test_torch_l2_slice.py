"""The L2 slice of the port against the JAX package, frame by frame:
``MonoSlam.process_features`` on SynthWorld, and ``EventSlam`` from an event
stream through the builder, MCI, ORB, tracking and mapping.

Randomness is injected: the JAX MonoSlam's keys are recorded as it calls
``reconstruct_two_views`` / ``pnp_ransac``, and the port's samplers return
``np.asarray`` of the JAX draws for the same key. The two-view minimal-set
fits are injected too (the jitted JAX fitter on the port's own inputs):
their f32 normal-equation eigensolve turns last-ulp differences into 1e-2
differences of the model (see tests/test_torch_twoview.py), which RANSAC
then turns into a different winner. Everything else runs on its own.

Both EventSlams speculate one MCI ahead (``pipelined=True``), as their
constructors set it.

Tolerances: SynthWorld — the same state and keyframe decision on every
frame, poses within 1e-3. EventSlam (metadata resolved with ``block=True``
on both sides) — the same L2 state after every MCI and the same keyframe
count, poses within 2e-3 (map units, after the median-depth normalization)
for the first 12 MCIs, and the two whole trajectories Sim3-aligned to each
other within 1% of the path length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.evals import ate
from eorb_slam_tpu.event import builder as jb
from eorb_slam_tpu.geometry import twoview as jtv
from eorb_slam_tpu.slam import event_system as jes, relocalization as jrl
from eorb_slam_tpu.slam import system as jsys
from eorb_slam_tpu_torch.event import builder as tb
from eorb_slam_tpu_torch.geometry import twoview as ttv
from eorb_slam_tpu_torch.slam import event_system as tes, relocalization as trl
from eorb_slam_tpu_torch.slam import system as tsys
from tests.synth import CAM, H, W, SynthWorld
from tests.test_torch_slice import CAM as EV_CAM, CFG as EV_CFG, _stream


@pytest.fixture
def jax_draws(monkeypatch):
    """Record the keys the JAX system hands its RANSACs; make the port's
    samplers (and two-view fits) return JAX's results for those keys."""
    return install_jax_draws(monkeypatch)


def install_jax_draws(monkeypatch):
    """The body of ``jax_draws``, for fixtures of a wider scope (pass a
    ``pytest.MonkeyPatch`` and ``undo()`` it after)."""
    keys = {}
    j_two, j_pnp = jtv.reconstruct_two_views, jrl.pnp_ransac

    def rec_two(cam, uv1, uv2, valid, key, **kw):
        keys["two"] = key
        return j_two(cam, uv1, uv2, valid, key, **kw)

    def rec_pnp(cam, pts, uv, valid, key, **kw):
        keys["pnp"] = key
        return j_pnp(cam, pts, uv, valid, key, **kw)

    monkeypatch.setattr(jtv, "reconstruct_two_views", rec_two)
    monkeypatch.setattr(jrl, "pnp_ransac", rec_pnp)

    def sample(generator, valid, iters, k):
        kE, kH = jax.random.split(keys["two"])
        idx = jtv._sample_minimal_sets(kE if k == 8 else kH,
                                       jnp.asarray(valid.numpy()), iters, k)
        return torch.from_numpy(np.asarray(idx)).long()

    def draw(generator, probs, n_hyp, k):
        idx = jax.random.choice(keys["pnp"], probs.shape[0], (n_hyp, k),
                                replace=True, p=jnp.asarray(probs.numpy()))
        return torch.from_numpy(np.asarray(idx)).long()

    monkeypatch.setattr(ttv, "_sample_minimal_sets", sample)
    monkeypatch.setattr(trl, "_draw_hypotheses", draw)
    for name in ("_fit_E_batch", "_fit_H_batch"):
        jfit = jax.jit(getattr(jtv, name))

        def fit(x1, x2, jfit=jfit):
            return torch.from_numpy(np.array(jfit(jnp.asarray(x1.numpy()),
                                                  jnp.asarray(x2.numpy()))))

        monkeypatch.setattr(ttv, name, fit)
    return keys


def _same_step(rj, rt):
    assert rt["state"] == rj["state"], (rj, rt)
    assert rt.get("kf") == rj.get("kf"), (rj, rt)


def _sim3_rmse_frac(traj_t, traj_j):
    """RMSE of the port's camera centres Sim3-aligned onto JAX's, as a
    fraction of JAX's path length."""
    rmse, n, _, _, _ = ate.ate_rmse(traj_t, traj_j, with_scale=True, max_dt=1e-6)
    c = np.asarray([T[:3, 3] for _, T in traj_j])
    path = np.linalg.norm(np.diff(c, axis=0), axis=1).sum()
    assert n == len(traj_j) and path > 0
    return rmse / path


def test_monoslam_process_features_matches_jax(jax_draws):
    world = SynthWorld(n_landmarks=320, seed=6, noise_px=0.4)
    # a 6-slot keyframe window with a keyframe every 3 frames: slots are
    # culled and reused within the 40 frames
    kw = dict(K=6, M=1024, N=256, P=4, min_init_matches=80,
              max_frames_between_kf=3)
    jslam = jsys.MonoSlam(CAM, **kw)
    tslam = tsys.MonoSlam(CAM, device="cpu", **kw)
    for s in (jslam, tslam):
        s.fuse_enabled = s.desc_refresh = False      # not ported (>= 320 px)
    n_kf_frames = 0
    for i in range(40):
        f, _ = world.frame(i / 20.0, n_slots=256, n_clutter=30, seed=100 + i)
        ft = tsys.FrameInput(f.ts, *(torch.from_numpy(np.array(x)) for x in
                                     (f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid)))
        rj = jslam.process_features(f)
        rt = tslam.process_features(ft)
        _same_step(rj, rt)
        n_kf_frames += bool(rj.get("kf"))
        np.testing.assert_allclose(tslam.T_last.numpy(), np.asarray(jslam.T_last),
                                   atol=1e-3)
        assert tslam.n_kf == jslam.n_kf
    assert jslam.state == jsys.OK and n_kf_frames >= 3
    assert tslam.kf_culled == jslam.kf_culled >= 2
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=1e-3)
    assert tslam.stats["lm"] == jslam.stats["lm"]


@pytest.fixture
def two_torch_threads():
    """Two intra-op threads while a test runs (the suite's workers share
    the machine's cores; the AKAZE scale space is many small ops); the
    process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_mixed_monoslam_process_image_matches_jax(jax_draws, two_torch_threads):
    """MixedMonoSlam (Features.mode 2) on 20 rendered 320x240 corridor
    frames, image in: the mixed ORB + AKAZE extraction, init, tracking and
    mapping with fusion. The same state and keyframe decision on every
    frame and the same channel layout; poses within 1e-3 through the fifth
    keyframe (frame 13). The sixth keyframe's f32 local BA parts the two
    packages by ~5e-3 (one landmark more or less behind a triangulation
    gate; ROADMAP Queue 3, f32 optimizers), so the last six frames hold
    the states and poses within 1e-2."""
    from eorb_slam_tpu_torch.io import synth_dataset as tsd

    w, h, fx = 320, 240, 195.0
    render = tsd.make_box_renderer("corridor", w, h, fx, device="cpu")
    pose = tsd.make_trajectory("corridor", 10.0)
    cam = np.asarray([fx, fx, w / 2.0, h / 2.0, 0, 0, 0, 0, 0], np.float32)
    kw = dict(img_w=w, img_h=h, K=6, M=1024, N=256, P=4, max_frames_between_kf=3)
    jslam = jsys.MixedMonoSlam(jnp.asarray(cam), **kw)
    tslam = tsys.MixedMonoSlam(cam, device="cpu", **kw)
    assert not tslam.pipelined and tslam.fuse_enabled
    states = []
    for i in range(20):
        t = i / 20.0
        img = (render(np.asarray(pose(t), np.float32)).numpy() * 255.0).astype(np.uint8)
        rj = jslam.process_image(jnp.asarray(img), t)
        rt = tslam.process_image(torch.from_numpy(img), t)
        _same_step(rj, rt)
        states.append(rj["state"])
        np.testing.assert_allclose(tslam.T_last.numpy(), np.asarray(jslam.T_last),
                                   atol=1e-3 if i < 14 else 1e-2, err_msg=f"frame {i}")
        assert tslam.n_kf == jslam.n_kf
        np.testing.assert_array_equal(tslam.last_channel.numpy(),
                                      np.asarray(jslam.last_channel))
    assert states.count(jsys.OK) >= 16 and jslam.stats["kf"] >= 6, jslam.stats
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=1e-2)


def test_event_slam_track_events_matches_jax(jax_draws):
    ev = _stream(seconds=0.2, rate=600_000, seed=5)
    kw = dict(max_kp=256, K=12, M=1024)
    jslam = jes.EventSlam(jnp.asarray(EV_CAM), jb.BuilderConfig(**EV_CFG), **kw)
    tslam = tes.EventSlam(EV_CAM, tb.BuilderConfig(**EV_CFG), device="cpu", **kw)
    jslam.builder.feed(ev)
    tslam.builder.feed(ev)
    n, n_dpose = 0, 0
    while True:
        # track_events' loop, with the window metadata resolved on both sides
        jslam.builder._resolve_window_meta(block=True)
        tslam.builder._resolve_window_meta(block=True)
        n_dpose += tslam.builder.pose_prior is not None
        pj, pt = jslam.builder.step_window(), tslam.builder.step_window()
        assert (pj is None) == (pt is None)
        if pj is None:
            break
        rj, rt = jslam._track_mci(pj), tslam._track_mci(pt)
        _same_step(rj, rt)
        assert tslam.l2.n_kf == jslam.l2.n_kf
        if n < 12:
            np.testing.assert_allclose(tslam.l2.T_last.numpy(),
                                       np.asarray(jslam.l2.T_last), atol=2e-3)
        n += 1
    assert n >= 12 and n_dpose >= 4
    assert tslam.n_tracked == jslam.n_tracked >= 10
    st_t, st_j = tslam.stats, jslam.stats
    for k in ("windows", "chunks", "mci", "l2_kf", "l2_lost"):
        assert st_t[k] == st_j[k], k
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert len(traj_t) == len(traj_j) >= 10
    assert _sim3_rmse_frac(traj_t, traj_j) < 0.01


def _garbage(ts, seed, n_slots=256):
    """A frame of pure clutter: tracking must fail on it."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform((0, 0), (W, H), (n_slots, 2)).astype(np.float32)
    desc = (rng.integers(0, 2, (n_slots, 256)) * 2 - 1).astype(np.int8)
    return jsys.FrameInput(ts, jnp.asarray(xy), jnp.zeros(n_slots, jnp.int32),
                           jnp.zeros(n_slots, jnp.float32), jnp.asarray(desc),
                           jnp.ones(n_slots, bool))


def test_monoslam_recovery_matches_jax(jax_draws):
    """Loss, relocalization by PnP, the RECENTLY_LOST grace, and the
    irrecoverable loss that stores the map and starts a new one: the same
    state on every frame, poses within 1e-3, the same Atlas and trajectory."""
    world = SynthWorld(n_landmarks=320, seed=11, noise_px=0.4)
    kw = dict(K=8, M=1024, N=256, P=4, min_init_matches=80,
              max_frames_between_kf=3)
    jslam = jsys.MonoSlam(CAM, **kw)
    tslam = tsys.MonoSlam(CAM, device="cpu", **kw)
    for s in (jslam, tslam):
        s.fuse_enabled = s.desc_refresh = False
        s.lost_grace, s.min_kf_store = 2, 3
    frames = [world.frame(i / 20.0, n_slots=256, n_clutter=30, seed=200 + i)[0]
              for i in range(10)]
    frames += [_garbage(0.5 + 0.05 * k, 300 + k) for k in range(2)]
    # back ~0.65 m from the last pose: projection search misses, global
    # matching + PnP relocalizes
    frames += [world.frame(-0.2, n_slots=256, n_clutter=30, seed=250)[0]]
    frames += [_garbage(0.7 + 0.05 * k, 400 + k) for k in range(4)]
    frames += [world.frame(1.0 + i / 20.0, n_slots=256, n_clutter=30,
                           seed=500 + i)[0] for i in range(4)]
    seen = []
    for f in frames:
        ft = tsys.FrameInput(f.ts, *(torch.from_numpy(np.array(x)) for x in
                                     (f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid)))
        rj, rt = jslam.process_features(f), tslam.process_features(ft)
        _same_step(rj, rt)
        assert rt.get("reloc") == rj.get("reloc") and rt.get("new_map") == rj.get("new_map")
        seen.append((rj["state"], rj.get("reloc"), rj.get("new_map")))
        np.testing.assert_allclose(tslam.T_last.numpy(), np.asarray(jslam.T_last),
                                   atol=1e-3)
    assert (jsys.OK, True, None) in seen                        # relocalized
    assert (jsys.RECENTLY_LOST, None, None) in seen
    assert any(new for _, _, new in seen) and jslam.state == jsys.OK  # re-initialized
    assert tslam.atlas.n_maps() == jslam.atlas.n_maps() == 2
    assert tslam.stats["lost"] == jslam.stats["lost"]
    traj_j, traj_t = jslam.trajectory_twc(), tslam.trajectory_twc()
    assert [t for t, _ in traj_t] == [t for t, _ in traj_j]
    for (_, a), (_, b) in zip(traj_t, traj_j):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_unported_modes_raise():
    assert tsys.MonoSlam(CAM, pipelined=True, device="cpu").pipelined
    # loop closing is ported: a vocabulary builds the loop closer
    slam = tsys.MonoSlam(CAM, loop_words=np.ones((4, 256), np.int8), device="cpu")
    assert slam.loop_closer.device.type == "cpu" and not slam.loop_closer.hier
