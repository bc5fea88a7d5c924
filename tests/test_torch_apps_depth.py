"""STEREO, RGBD and IMU_STEREO of the app layer against the JAX package
(and ``make_vocab``'s failure when a configured vocabulary cannot be set up):
``run_slam.main`` of both packages (the port's with ``--device cpu``) on ONE
generated EuRoC corridor at 320x240 with cam1 (baseline 0.11 m = bf / fx)
and depth0, written once by the port's generator, and scored with
``--eval`` (the depth modes are metric: the scale stays at 1).

What is made equal by hand is what tests/test_torch_apps.py makes equal:
JAX's RANSAC draws are replayed into the port in call order. Everything
else runs on its own: parser, loaders (right images, 16-bit depth), ORB on
both images, the stereo matcher and the depth lookup, the single-frame
metric init, tracking, depth landmarks, BA, IMU preintegration and the
inertial init at a fixed scale, the TUM writer and the evaluator. IMU_STEREO
is compared through the inertial init; the port alone runs on through the
inertial frames to the next keyframe, where the right image is extracted
and matched only then (the deferral). The deferral itself is then held
against JAX's on one state: the depth each side's keyframe step computes
from the pending right image, and the landmarks that depth founds on JAX's
map (the same matched set, depth within 1e-5 relative, tables equal,
positions within 1e-5 from the same depth).

Tolerances: the same state and keyframe decision after every frame, the
same keyframe count and IMU-initialized flag, poses within 2e-3 m until the
third keyframe and 5e-2 m from it on; landmark counts within 2%; ATEs
within 10% of each other or 0.5% of the path length. The
loose bound is the reference's own: a depth-founded landmark enters BA with
its one view twice and no depth residual, so its depth along the ray is a
null direction of the f32 LM (damping alone holds it). From identical
inputs the two packages' local BAs move such landmarks apart by up to 3 m
along their rays, and once a keyframe pose is free (the third keyframe)
the poses follow by 3e-3 to 3e-2 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eorb_slam_tpu.apps import run_slam as jrun
from eorb_slam_tpu.geometry import camera as jcam
from eorb_slam_tpu.ops import frontend as jfe
from eorb_slam_tpu.slam import local_mapping as jlm, map_state as jms
from eorb_slam_tpu.slam import rgbd_stereo as jrs, system as jsys, vi_system as jvi
from eorb_slam_tpu_torch import convert
from eorb_slam_tpu_torch.apps import run_slam as trun
from eorb_slam_tpu_torch.io import config as tcfg
from eorb_slam_tpu_torch.io import synth_dataset as tsd
from eorb_slam_tpu_torch.slam import local_mapping as tlm
from eorb_slam_tpu_torch.slam import rgbd_stereo as trs, system as tsys, vi_system as tvi
from tests.test_torch_apps import both  # noqa: F401 (fixture)
from tests.test_torch_l2_slice import jax_draws  # noqa: F401 (fixture)

# 10 fps and a keyframe at most every 3 frames: IMU_STEREO's inertial init
# (1.5 s and 6 keyframes) comes at frame 17 of the 22
W, H, FX, FPS, BASELINE = 320, 240, 195.0, 10.0, 0.11
SECONDS = 2.2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the machine's cores); the process's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_depth")
    scene = tsd.make_scene("corridor", W, H, FX, n_dots=10)
    tsd.write_euroc(str(root / "im"), "corridor_st", scene,
                    tsd.make_trajectory("corridor", 10.0), duration=SECONDS, fps=FPS,
                    verbose=False, stereo_baseline=BASELINE, write_depth=True,
                    renderer=tsd.make_box_renderer("corridor", W, H, FX, device="cpu"))

    def settings(sensor):
        return tsd.write_settings_yaml(
            str(root / f"{sensor}.yaml"), fmt="euroc", root=str(root / "im"),
            seqs=["corridor_st"], sensor=sensor, scene=scene, fps=FPS,
            ts_factor=1.0e9, n_features=256,
            extra={"SLAM.maxKeyFrames": 8, "SLAM.maxLandmarks": 1024,
                   "SLAM.maxFramesBetweenKF": 3, "Camera.bf": FX * BASELINE})

    return {s: settings(s) for s in ("stereo", "rgbd", "imu_stereo")}


def _log(monkeypatch, log, cls, name, side):
    fn = getattr(cls, name)

    def wrapped(self, *a, **kw):
        r = fn(self, *a, **kw)
        T = np.asarray(self.T_last) if side == "j" else self.T_last.numpy().copy()
        log[side].append((dict(r), T, self.n_kf, getattr(self, "imu_initialized", False)))
        return r

    monkeypatch.setattr(cls, name, wrapped)


def _main_both(monkeypatch, both, settings, tmp_path, cls_name, method, max_frames,
               port_only=0):
    """Both mains on ``max_frames`` frames, frame by frame; the port's then
    runs ``port_only`` frames more (compared with nothing: the JAX side's
    compile of what those frames run would double the file's time)."""
    slams = {}
    for side, run, mod in (("j", jrun, jrs), ("t", trun, trs)):
        _log(monkeypatch, both, getattr(mod, cls_name), method, side)
        seq_fn = run.run_sequence

        def keep(st, seq, _fn=seq_fn, _side=side, **kw):
            slam, out = _fn(st, seq, **kw)
            slams[_side] = slam
            slams["seq"] = seq
            return slam, out

        monkeypatch.setattr(run, "run_sequence", keep)
    args = [settings, "--eval"]
    (oj,) = jrun.main(args + ["--out", str(tmp_path / "j"), "--max-frames", str(max_frames)])
    (ot,) = trun.main(args + ["--out", str(tmp_path / "t"), "--device", "cpu",
                              "--max-frames", str(max_frames + port_only)])
    assert ot["device"] == "cpu" and isinstance(slams["t"], getattr(trs, cls_name))
    assert len(both["j"]) == max_frames and len(both["t"]) == max_frames + port_only
    for i, ((rj, Tj, kj, ij), (rt, Tt, kt, it)) in enumerate(zip(both["j"], both["t"])):
        assert rt["state"] == rj["state"] and rt.get("kf") == rj.get("kf"), (i, rj, rt)
        assert (kt, it) == (kj, ij), i
        np.testing.assert_allclose(Tt, Tj, atol=2e-3 if kj < 3 else 5e-2,
                                   err_msg=f"frame {i}")
    et, ej = ot["eval"], oj["eval"]
    if port_only:
        assert all(r["state"] == 1 for r, *_ in both["t"][max_frames:])
        assert et["ate_scale"] == 1.0 and np.isfinite(et["ate_rmse"])
        return slams["j"], slams["t"], ot, slams["seq"]
    assert ot["stats"]["kf"] == oj["stats"]["kf"] and ot["tracked_poses"] == oj["tracked_poses"]
    assert et["ate_scale"] == ej["ate_scale"] == 1.0            # metric
    assert et["ate_n"] == ej["ate_n"]
    a, b, path = et["ate_rmse"], ej["ate_rmse"], et["ape_piecewise"]["traj_len"]
    assert abs(a - b) <= max(0.1 * max(a, b), 0.005 * path), (a, b, path)
    return slams["j"], slams["t"], ot


def test_main_stereo_matches_jax(data, both, tmp_path, monkeypatch):
    jslam, tslam, out = _main_both(monkeypatch, both, data["stereo"], tmp_path,
                                   "StereoSlam", "process_stereo", 16)
    assert tslam.baseline == pytest.approx(BASELINE, rel=1e-6) == jslam.baseline
    assert out["stats"]["kf"] >= 3
    assert abs(out["stats"]["lm"] - jslam.stats["lm"]) <= 0.02 * jslam.stats["lm"]


def test_main_rgbd_matches_jax(data, both, tmp_path, monkeypatch):
    jslam, tslam, out = _main_both(monkeypatch, both, data["rgbd"], tmp_path,
                                   "RgbdSlam", "process_rgbd", 16)
    assert out["stats"]["kf"] >= 3
    assert abs(out["stats"]["lm"] - jslam.stats["lm"]) <= 0.02 * jslam.stats["lm"]


def test_main_imu_stereo_matches_jax(data, both, tmp_path, monkeypatch):
    """Both packages through the inertial init (at frame 17, the last frame
    compared); the port then runs on through the left-only inertial frame
    step to the next keyframe, where the right image is extracted and
    matched (the deferral), and keeps tracking."""
    calls = {"j": 0, "t": 0}
    for side, mod in (("j", jrs), ("t", trs)):
        fn = mod.StereoInertialSlam._insert_keyframe

        def counted(self, f, *a, _fn=fn, _side=side, **kw):
            calls[_side] += f.depth is None and self._pending_right is not None
            return _fn(self, f, *a, **kw)

        monkeypatch.setattr(mod.StereoInertialSlam, "_insert_keyframe", counted)
    n = int(SECONDS * FPS)
    jslam, tslam, out, seq = _main_both(monkeypatch, both, data["imu_stereo"], tmp_path,
                                        "StereoInertialSlam", "process_stereo_imu", n - 4,
                                        port_only=4)
    assert tslam.imu_initialized and jslam.imu_initialized
    assert calls["j"] == 0 and calls["t"] >= 1      # deferred stereo depth ran
    assert 0.8 < tslam.scale_applied < 1.25
    # the same inertial init attempts (their scale estimates)
    assert len(tslam._init_scale_hist) == len(jslam._init_scale_hist) >= 1
    assert tslam._init_scale_hist == pytest.approx(jslam._init_scale_hist, rel=1e-3)
    _deferred_keyframe_matches_jax(monkeypatch, jslam, tslam, seq, n - 4)


def _deferred_keyframe_matches_jax(monkeypatch, jslam, tslam, seq, i):
    """IMU_STEREO's deferral against JAX on one state: frame ``i``'s LEFT
    features (JAX's extraction, given to both) reach each side's
    ``StereoInertialSlam._insert_keyframe`` with no depth and frame i's
    right image pending, as ``process_stereo_imu`` leaves them once the IMU
    is initialized. Each side extracts the right image and matches it there;
    the depth it hands on must agree (the same matched set, 1e-5 relative),
    and the landmarks that depth founds on JAX's map after the compared run
    must agree: tables equal, positions within 1e-5 from JAX's depth (as
    test_create_depth_landmarks_matches_jax holds them) and within 1e-5
    relative from the port's own. The rest of the
    keyframe step (mapping, BA, VI-BA) is held by the runs above and left
    out here: it would compile JAX's inertial keyframe path for one frame."""
    img_l = (seq.image(i) * 255.0).astype(np.float32)
    img_r = (seq.image_right(i) * 255.0).astype(np.float32)
    ts = float(seq.image_ts[i])
    fe = jfe.extract(jnp.asarray(img_l), max_kp=jslam.map.N)
    fj = jsys.FrameInput(ts, jcam.undistort_points(jslam.cam, fe.xy), fe.octave,
                         fe.angle, fe.desc_pm1, fe.valid)
    ft = tsys.FrameInput(ts, *(torch.from_numpy(np.array(x)) for x in (
        fj.xy_ud, fj.octave, fj.angle, fj.desc_pm1, fj.valid)))
    got = {}
    for side, slam, cls, f, r in (
            ("j", jslam, jvi.MonoInertialSlam, fj, jnp.asarray(img_r)),
            ("t", tslam, tvi.MonoInertialSlam, ft, torch.from_numpy(img_r))):
        monkeypatch.setattr(cls, "_insert_keyframe",
                            lambda self, f, res, n_inl=None, _s=side: got.__setitem__(_s, f))
        slam._pending_right = (r, None)
        slam._insert_keyframe(f, None)
        slam._pending_right = None
    dj, dt = np.asarray(got["j"].depth), got["t"].depth.numpy()
    ok = np.isfinite(dj) & (dj > 0)
    np.testing.assert_array_equal(np.isfinite(dt) & (dt > 0), ok)
    assert ok.sum() >= 30
    np.testing.assert_allclose(dt[ok], dj[ok], rtol=1e-5)
    # the landmarks that depth founds, on one map (JAX's) at a free slot
    jm = jslam.map
    slot = int(np.flatnonzero(~np.asarray(jm.kf_valid))[0])
    N = fj.xy_ud.shape[0]
    jm = jms.insert_keyframe(jm, jnp.asarray(slot), jslam.T_last, ts, fj.xy_ud, fj.octave,
                             fj.angle, fj.desc_pm1, fj.valid, jnp.full((N,), -1, jnp.int32))
    tm = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    jm2, nj = jlm.create_depth_landmarks(jm, jslam.cam, jnp.asarray(slot), jnp.asarray(dj))
    b = {k: np.asarray(v) for k, v in jm2._asdict().items()}
    # from JAX's depth: positions within 1e-5; from the port's own depth:
    # within the depth's 1e-5 relative (a founding point moves along its ray)
    for d, tol in ((dj, dict(atol=1e-5)), (dt, dict(rtol=1e-5, atol=1e-6))):
        tm2, nt = tlm.create_depth_landmarks(tm, tslam.cam, slot, torch.from_numpy(d))
        assert int(nt) == int(nj) >= 30
        a = convert.map_state_to_numpy(tm2)
        for k in a:
            if k == "lm_pos":
                np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_make_vocab_fails_loudly(tmp_path):
    """A configured vocabulary that cannot be set up raises (the reference's
    app prints and runs without loops)."""
    st = tcfg.Settings(vocab=tcfg.VocabConfig(train_words=64))
    with pytest.raises(ValueError, match="no frames"):
        trun.make_vocab(st, None, device="cpu")
    st = tcfg.Settings(vocab=tcfg.VocabConfig(path=str(tmp_path / "missing.txt")))
    with pytest.raises(FileNotFoundError):
        trun.make_vocab(st, None, device="cpu")
