"""Event-image synchronized SLAM (EVENT_MONO).

PyTorch port of ``eorb_slam_tpu/slam/ev_image_system.py`` (reference
System::TrackEvMono and the synch trackers): the image frames are the clock.
Per image an MCI is built over the events that end at the image timestamp
(``EventWindowBuilder.build_mci``: the splat kernels on the card), the image
tracker runs first, the event tracker follows on its own map, slaved to the
image pose through a Sim3 gauge bridge, and every paired frame is refined by
one pose optimization over both matched observation sets. Keyframes from
either side run a joint local BA over the union of both maps, with event
keyframes that share an image keyframe's timestamp riding its pose vertex.
An image-side loop correction carries the event map with it.

The two maps are two MapStates (the reference's two Atlases). A DAVIS
sensor's events and frames share one pixel array, so one camera model
serves both. The five fixed-shape steps run on the
maps' device; the host keeps the state machine, the stash of event frames
before the joint init and the gauge estimate (numpy, as the reference's).

Each of the five steps is a graph runner over a function of tensors alone
(``joint_local_ba``, ``propagate_loop``, ``init_triangulate``,
``joint_pose``, ``joint_writeback``: the reference's jits, one CUDA-graph
replay per call on the card). ``_joint_local_ba_step``,
``_propagate_loop_to_event``, ``_joint_pose_step`` and ``_joint_writeback``
keep the steps' signatures: they stage the Sim3 bridge, numpy on the host, on the device in
one copy that does not wait for the device queue (never inside a capture,
where a host copy would bake one frame's gauge into the graph), then call
the runner.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch._host import to_device
from eorb_slam_tpu_torch.event import builder as ev_builder
from eorb_slam_tpu_torch.geometry import camera as cam_mod
from eorb_slam_tpu_torch.geometry import lie, triangulation
from eorb_slam_tpu_torch.ops import frontend, matching
from eorb_slam_tpu_torch.optim import pose_only, schur_ba
from eorb_slam_tpu_torch.slam import map_state as ms
from eorb_slam_tpu_torch.slam import system as slam_system


def _ev_pose_to_im(T, R, t, s):
    """Event-gauge Tcw (...,4,4) -> image gauge through p_im = s R p_ev + t:
    R' = R_ev R^T, t' = s t_ev - R' t."""
    Rp = T[..., :3, :3] @ R.T
    return lie.se3(Rp, s * T[..., :3, 3] - Rp @ t)


def _im_pose_to_ev(T, R, t, s):
    """The inverse of ``_ev_pose_to_im``."""
    return lie.se3(T[..., :3, :3] @ R,
                   (T[..., :3, 3] + T[..., :3, :3] @ t) / s)


def _bridge(R_ie, t_ie, s_ie, like: torch.Tensor):
    """The Sim3 bridge (R (3,3), t (3,), s ()) as tensors of ``like``'s
    dtype on its device. Host values (numpy, Python numbers) go in one copy
    from pinned memory that does not wait for the device queue; tensors are
    moved or cast, a bridge staged already passes through."""
    xs = (R_ie, t_ie, s_ie)
    if any(isinstance(x, torch.Tensor) for x in xs):
        return tuple(torch.as_tensor(x, dtype=like.dtype).to(like.device, non_blocking=True)
                     for x in xs)
    dtype = torch.empty(0, dtype=like.dtype).numpy().dtype
    t = to_device(np.concatenate([np.asarray(x, dtype).reshape(-1) for x in xs]), like.device)
    return t[:9].view(3, 3), t[9:12], t[12]


def _joint_local_ba(im_map, ev_map, cam_params, Rm, tm, sm, kf_free_im, kf_free_ev,
                    ev_sigma_scale: float = 0.5, iters: int = 8, twin_eps: float = 1e-3):
    """Joint local BA over the union of the image map and the Sim3-bridged
    event map (EvOptimizer::LocalBundleAdjustment / setEventMapVxAndEdges).

    Event keyframes and landmarks are mapped into the image gauge, both
    observation tables concatenate into one BAProblem (the event keyframe
    axis offset by K_im), and the solution is split back through the
    inverse Sim3. Twin coupling: an event keyframe whose timestamp matches
    an image keyframe's (|dt| < twin_eps) puts its observations on that
    image vertex, drops out of the solve, and follows its twin on the way
    out. Runs in the maps' dtype, the bridge (Rm, tm, sm) a device tensor
    in it. Returns (im_map', ev_map', [cost0, cost])."""
    K_im = im_map.kf_T.shape[0]

    ev_T_im = _ev_pose_to_im(ev_map.kf_T, Rm, tm, sm)
    ev_lm_im = sm * (ev_map.lm_pos @ Rm.T) + tm

    # timestamp twins: event KF j <-> image KF twin[j]
    dts = torch.abs(ev_map.kf_ts[:, None] - im_map.kf_ts[None, :])
    dts = torch.where(im_map.kf_valid[None, :], dts, torch.inf)
    dmin, twin = torch.min(dts, dim=1)
    has_twin = (dmin < twin_eps) & ev_map.kf_valid

    kf_T = torch.cat([im_map.kf_T, ev_T_im])
    kf_valid = torch.cat([im_map.kf_valid, ev_map.kf_valid])
    kf_fixed = ~torch.cat([kf_free_im, kf_free_ev & ~has_twin])
    lm_pos = torch.cat([im_map.lm_pos, ev_lm_im])
    lm_valid = torch.cat([im_map.lm_valid, ev_map.lm_valid])

    ik, jf = im_map.obs_kf.long(), im_map.obs_feat.long()
    ek, ef = ev_map.obs_kf.long(), ev_map.obs_feat.long()
    sig_im = frontend.inv_sigma(im_map.kf_octave[ik, jf]).to(kf_T.dtype)
    sig_ev = frontend.inv_sigma(ev_map.kf_octave[ek, ef]).to(kf_T.dtype)
    # event observations ride their image twin's vertex when one exists
    obs_kf_ev = torch.where(has_twin[ek], twin[ek], ek + K_im)

    prob = schur_ba.BAProblem(
        cam_params=cam_params.to(kf_T.dtype),
        kf_T=kf_T,
        kf_fixed=kf_fixed,
        kf_valid=kf_valid,
        lm_pos=lm_pos,
        lm_valid=lm_valid,
        obs_kf=torch.cat([im_map.obs_kf, obs_kf_ev.to(im_map.obs_kf.dtype)]),
        obs_uv=torch.cat([im_map.kf_xy[ik, jf], ev_map.kf_xy[ek, ef]]).to(kf_T.dtype),
        obs_inv_sigma=torch.cat([sig_im, ev_sigma_scale * sig_ev]),
        obs_valid=torch.cat([im_map.obs_valid & im_map.kf_valid[ik],
                             ev_map.obs_valid & ev_map.kf_valid[ek]]),
    )
    res = schur_ba.bundle_adjust(prob, iters=iters)

    M_im = im_map.lm_pos.shape[0]
    im_map = im_map._replace(kf_T=res.kf_T[:K_im], lm_pos=res.lm_pos[:M_im])
    # twin event KFs follow the refined image vertex exactly
    ev_T_im_out = torch.where(has_twin[:, None, None], res.kf_T[twin], res.kf_T[K_im:])
    ev_T_new = torch.where(ev_map.kf_valid[:, None, None],
                           _im_pose_to_ev(ev_T_im_out, Rm, tm, sm), ev_map.kf_T)
    ev_lm_new = ((res.lm_pos[M_im:] - tm) @ Rm) / sm
    ev_map = ev_map._replace(kf_T=ev_T_new, lm_pos=ev_lm_new)
    return im_map, ev_map, torch.stack([res.cost0, res.cost])


# the reference's jit with static iters (and here the two weights); local
# BA's own runner runs inline in its capture
joint_local_ba = _graphs.GraphRunner(
    _joint_local_ba, static=("ev_sigma_scale", "iters", "twin_eps"))


def _joint_local_ba_step(
    im_map, ev_map, cam_params,
    R_ie, t_ie, s_ie,            # Sim3: event-map coords -> image-map coords
    kf_free_im, kf_free_ev,      # (K_im,), (K_ev,) bool BA windows
    ev_sigma_scale: float = 0.5,
    iters: int = 8,
    twin_eps: float = 1e-3,
):
    """``joint_local_ba`` with the bridge staged (see the module notes)."""
    return joint_local_ba(im_map, ev_map, cam_params, *_bridge(R_ie, t_ie, s_ie, im_map.kf_T),
                          kf_free_im, kf_free_ev, ev_sigma_scale=ev_sigma_scale, iters=iters,
                          twin_eps=twin_eps)


def _propagate_loop(ev_map, im_kf_ts, im_kf_valid, T_before, T_after, Rm, tm, sm):
    """Carry an image-map loop correction into the synch event map: each
    event keyframe follows its nearest-in-time image keyframe's correction
    D_j = T_before_j^-1 T_after_j rigidly (findNearestPose), and each event
    landmark its first-observing keyframe's anchor, so camera-frame
    coordinates stay fixed through the weld. In the image gauge through the
    Sim3 bridge (device tensors)."""
    d = torch.abs(ev_map.kf_ts[:, None] - im_kf_ts[None, :])
    d = torch.where(im_kf_valid[None, :], d, torch.inf)
    anchor = torch.argmin(d, dim=1)                           # (K_ev,)

    D = lie.se3_inv(T_before[anchor]) @ T_after[anchor]       # (K_ev,4,4)
    Te_new = _im_pose_to_ev(_ev_pose_to_im(ev_map.kf_T, Rm, tm, sm) @ D, Rm, tm, sm)
    Te_new = torch.where(ev_map.kf_valid[:, None, None], Te_new, ev_map.kf_T)

    aj = anchor[torch.clamp(ev_map.lm_first_kf, min=0).long()]   # (M,)
    Dl = lie.se3_inv(T_after[aj]) @ T_before[aj]
    y = sm * (ev_map.lm_pos @ Rm.T) + tm                      # ev -> image gauge
    y_new = (Dl[:, :3, :3] @ y[:, :, None])[:, :, 0] + Dl[:, :3, 3]
    x_new = ((y_new - tm) @ Rm) / sm
    x_new = torch.where(ev_map.lm_valid[:, None], x_new, ev_map.lm_pos)
    return ev_map._replace(kf_T=Te_new, lm_pos=x_new)


propagate_loop = _graphs.GraphRunner(_propagate_loop)


def _propagate_loop_to_event(ev_map, im_kf_ts, im_kf_valid, T_before, T_after,
                             R_ie, t_ie, s_ie):
    """``propagate_loop`` with the bridge staged."""
    return propagate_loop(ev_map, im_kf_ts, im_kf_valid, T_before, T_after,
                          *_bridge(R_ie, t_ie, s_ie, ev_map.kf_T))


def _init_triangulate_known_poses(
    cam_params,
    d1, v1, xy1,      # event features at the earlier image-tracked frame
    d2, v2, xy2,      # event features at the later image-tracked frame
    T1, T2,           # (4,4) IMAGE-tracker poses at the two timestamps
):
    """Joint event-map initialization core (resolveEventMapInit /
    evImReconst2ViewsSynch): match the two event frames loosely (TH_HIGH, a
    150 px window: with known poses the triangulation gates reject wrong
    pairs) and triangulate with the IMAGE tracker's poses, so the event map
    is born in the image gauge. Returns (m12, idx2, pts3d_world, ok, n_ok)."""
    pair = matching.window_mask(xy1, xy2, 150.0)
    m12, _ = matching.match_nnratio(
        d1, v1, d2, v2, pair_mask=pair,
        max_dist=matching.TH_HIGH, nn_ratio=0.9, mutual=True,
    )
    idx2 = torch.where(m12 >= 0, m12, 0).long()
    ray1 = cam_mod.pinhole_unproject_linear(cam_params, xy1)
    ray2 = cam_mod.pinhole_unproject_linear(cam_params, xy2[idx2])
    pts = triangulation.triangulate_dlt(T1[None], T2[None], ray1, ray2)
    fx = cam_params[0]
    ok_tri, _ = triangulation.triangulation_checks(
        T1[None], T2[None], ray1, ray2, pts,
        min_parallax_cos=0.9995,  # >= 1.8 deg; the caller gates the baseline
        inv_sigma1=fx, inv_sigma2=fx,
    )
    ok = ok_tri & (m12 >= 0) & v1
    return m12, idx2, pts, ok, ok.sum(dtype=torch.int32)


init_triangulate = _graphs.GraphRunner(_init_triangulate_known_poses)


def _joint_pose(cam_params, im_lm_pos, ev_lm_pos, feat_lm_i, xy_i, oct_i,
                feat_lm_e, xy_e, oct_e, Rm, tm, sm, Tcw0):
    """Joint image + event pose optimization: both matched landmark sets
    (the event side Sim3-bridged, at half weight), one GN solve (the
    pose-only runner inline). Returns (Tcw, packed flags [n_inl_total,
    n_inl_image, finite])."""
    mi, me = feat_lm_i >= 0, feat_lm_e >= 0
    pts_i = im_lm_pos[torch.where(mi, feat_lm_i, 0).long()]
    pts_e = sm * (ev_lm_pos[torch.where(me, feat_lm_e, 0).long()] @ Rm.T) + tm
    inv_sig = torch.cat([frontend.inv_sigma(oct_i), 0.5 * frontend.inv_sigma(oct_e)])
    Tj, inlier, n_inl = pose_only.pose_optimization(
        cam_params, Tcw0, torch.cat([pts_i, pts_e]), torch.cat([xy_i, xy_e]),
        inv_sig, torch.cat([mi, me]),
    )
    flags = torch.stack([
        n_inl.to(torch.float32),
        inlier[: xy_i.shape[0]].sum().to(torch.float32),
        torch.isfinite(Tj).all().to(torch.float32),
    ])
    return Tj, flags


joint_pose = _graphs.GraphRunner(_joint_pose)


def _joint_pose_step(cam_params, im_lm_pos, ev_lm_pos,
                     feat_lm_i, xy_i, oct_i, feat_lm_e, xy_e, oct_e,
                     R_ie, t_ie, s_ie, Tcw0):
    """``joint_pose`` with the bridge staged."""
    return joint_pose(cam_params, im_lm_pos, ev_lm_pos, feat_lm_i, xy_i, oct_i,
                      feat_lm_e, xy_e, oct_e, *_bridge(R_ie, t_ie, s_ie, im_lm_pos), Tcw0)


def _joint_wb(Tj, T_last_im, T_last_ev, Rm, tm, sm, ref_T_im):
    """Post-solve pose algebra: both trackers' motion models, the event-gauge
    twin pose and the image trajectory entry. Returns (vel_im, Te, vel_ev,
    T_rel)."""
    vel_im = Tj @ lie.se3_inv(T_last_im)
    Te = _im_pose_to_ev(Tj, Rm, tm, sm)
    vel_ev = Te @ lie.se3_inv(T_last_ev)
    T_rel = Tj @ lie.se3_inv(ref_T_im)
    return vel_im, Te, vel_ev, T_rel


joint_writeback = _graphs.GraphRunner(_joint_wb)


def _joint_writeback(Tj, T_last_im, T_last_ev, R_ie, t_ie, s_ie, ref_T_im):
    """``joint_writeback`` with the bridge staged."""
    return joint_writeback(Tj, T_last_im, T_last_ev, *_bridge(R_ie, t_ie, s_ie, Tj), ref_T_im)


class EvImageSlam:
    """One clock (image frames), two maps (image + event), joint pose
    optimization. Runs on ``device``: the card when it is None."""

    def __init__(
        self,
        cam_params,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        img_w: int = 240,
        img_h: int = 180,
        max_kp: int = 512,
        ev_max_kp: int = 256,
        synch_window_s: float = 0.15,
        device=None,
        **slam_kw,
    ):
        self.cfg = cfg or ev_builder.BuilderConfig(img_w=img_w, img_h=img_h)
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params, device=device)
        self.device = self.builder.device
        self.cam = self.builder.cam.clone()
        self.synch_window_s = synch_window_s
        self.max_kp = max_kp
        self.ev_max_kp = ev_max_kp

        self.im = slam_system.MonoSlam(cam_params, img_w=img_w, img_h=img_h,
                                       N=max_kp, device=self.device, **slam_kw)
        # opt into the loop-correction handoff (consumed in track_ev_mono)
        self.im.loop_correction_consumer = True
        ev_min_init = max(20, slam_kw.get("min_init_matches", 40) // 2)
        self.ev = slam_system.MonoSlam(
            cam_params, img_w=img_w, img_h=img_h, N=ev_max_kp,
            K=slam_kw.get("K", 32), M=slam_kw.get("M", 4096),
            min_init_matches=ev_min_init,
            min_init_triangulated=max(15, ev_min_init * 3 // 4),
            min_track_inliers=8, device=self.device,
        )
        # event twin map: no fuse pass (EvLocalMapping has none; coarse MCI
        # features make duplicate-merging net-harmful)
        self.ev.fuse_enabled = False
        self._ev_buf = np.zeros((0, 4), np.float64)
        self._last_im_ts: Optional[float] = None
        self.joint_frames = 0
        # ORB-driven event init: (ts, event FrameInput, image Tcw) of
        # image-tracked frames while the event map does not exist
        self._ev_stash: list = []
        self._ev_stash_cap = 20
        self.joint_inits = 0
        self.gauge_reseeds = 0
        # paired (ts, Tcw_im, Tcw_ev) feeding the Sim3 gauge estimate
        self._gauge_pairs: list = []
        self._gauge_window = 12
        self.joint_ba_enabled = True
        self.joint_bas = 0
        self.joint_loop_gbas = 0
        self._last_gauge = None
        # after a joint init the maps share one gauge by construction; the
        # bridge stays pinned at identity and map-level rescales (IMU init)
        # are replayed on the event map instead
        self._gauge_locked = False

    # ---------------------------------------------------------------- input

    def track_ev_mono(self, events: np.ndarray, img, ts: float, imu=None):
        """System::TrackEvMono: buffer the events, build the synch MCI at the
        image timestamp, run both trackers and the joint refinement. ``img``
        is the intensity frame in [0,255] (numpy or a tensor); ``imu`` (the
        ImuChunk since the previous frame) goes to an inertial image
        tracker."""
        if len(events):
            self._ev_buf = np.concatenate([self._ev_buf, np.asarray(events, np.float64)])

        mci = self._synch_mci(ts)

        # image tracker first (clock master)
        im_res = self._track_image(img, ts, imu)

        # an image-side loop correction moves the event map with it, and the
        # joint GBA after it sees the event observations
        if self.im.last_loop_correction is not None:
            self._on_image_loop(*self.im.last_loop_correction)
            self.im.last_loop_correction = None

        ev_res = None
        if mci is not None:
            mci_img = mci.img * 255.0
            im_ok = (self.im.state == slam_system.OK
                     and self.im.last_frame is not None
                     and self.im.last_frame.ts == ts)
            if self.ev.state == slam_system.OK:
                # slave the event tracker to the image pose: the image
                # tracker has solved this timestamp already
                if im_ok and self._last_gauge is not None:
                    self._seed_ev_from_image()
                elif im_ok:
                    self.ev.velocity = self.im.velocity
                ev_res = self.ev.process_image(mci_img, ts, max_kp=self.ev_max_kp)
            elif self.ev.state == slam_system.NOT_INITIALIZED:
                # ORB-driven joint init in the image gauge
                if im_ok:
                    ev_res = self._try_joint_event_init(mci_img, ts)
            elif im_ok and self._last_gauge is not None:
                # event tracker lost, image tracker healthy: plant the
                # gauge-mapped image pose and retry; the lost counter keeps
                # counting, so the tracker's own grace logic can escalate to
                # a map reset and a joint re-init
                self._seed_ev_from_image()
                self.gauge_reseeds += 1
                ev_res = self.ev.process_image(mci_img, ts, max_kp=self.ev_max_kp)

        joint = self._joint_refine(ts)
        # joint local BA on a keyframe insertion from either side
        new_kf = (isinstance(im_res, dict) and im_res.get("kf")) or (
            isinstance(ev_res, dict) and ev_res.get("kf"))
        if (self.joint_ba_enabled and self._last_gauge is not None
                and joint is not None and not joint.get("rejected")
                and new_kf and self.ev.n_kf >= 2):
            self._run_joint_ba()
        self._last_im_ts = ts
        return {"image": im_res, "event": ev_res, "joint": joint}

    def _try_joint_event_init(self, mci_img, ts: float):
        """Initialize the event map from the image tracker
        (SetInitEvFrameSynch + resolveEventMapInit): stash event frames at
        image-tracked timestamps; once two have image-pose baseline, match
        and triangulate with those poses, seed the event map in the image
        gauge and run one joint init BA. The bridge starts at identity."""
        feats = frontend.extract(mci_img, max_kp=self.ev.map.N)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        f = slam_system.FrameInput(ts, xy_ud, feats.octave, feats.angle,
                                   feats.desc_pm1, feats.valid)
        Ti = self.im.T_last.cpu().numpy()
        self._ev_stash.append((ts, f, Ti))
        self._ev_stash = self._ev_stash[-self._ev_stash_cap:]
        if len(self._ev_stash) < 2:
            return {"state": self.ev.state, "joint_init": False}

        # partners: the NEWEST stashed frames first (MCI appearance
        # decorrelates fast), at least 0.02 map units of baseline
        C_cur = -Ti[:3, :3].T @ Ti[:3, 3]
        cands = []
        for ts0, f0, T0 in reversed(self._ev_stash[:-1]):
            C0 = -T0[:3, :3].T @ T0[:3, 3]
            if np.linalg.norm(C0 - C_cur) >= 0.02:
                cands.append((ts0, f0, T0))
            if len(cands) >= 3:
                break
        if not cands:
            return {"state": self.ev.state, "joint_init": False}

        dev = self.device
        Ti_t = torch.from_numpy(Ti).to(dev)
        tri = []
        for ts0, f0, T0 in cands:
            tri.append((ts0, f0, T0) + init_triangulate(
                self.cam, f0.desc_pm1, f0.valid, f0.xy_ud,
                f.desc_pm1, f.valid, f.xy_ud, torch.from_numpy(T0).to(dev), Ti_t,
            )[1:])
        # one read of every candidate's count; the first best wins
        counts = torch.stack([c[-1] for c in tri]).cpu().numpy()
        b = int(np.argmax(counts))
        n = int(counts[b])
        ts0, f0, T0, idx2, pts, ok, _ = tri[b]
        # known poses need fewer points than a blind two-view init, but a
        # map the per-frame tracker cannot hold must not be seeded
        if n < max(20, 2 * self.ev.min_track_inliers,
                   self.ev.min_init_triangulated // 2):
            return {"state": self.ev.state, "joint_init": False, "n": n}

        ev = self.ev
        N = ev.map.N
        feat_ids = torch.arange(N, dtype=torch.int32, device=dev)
        no_lm = torch.full((N,), -1, dtype=torch.int32, device=dev)
        m = ms.insert_keyframe(ev.map, 0, torch.from_numpy(T0).to(dev), ts0,
                               f0.xy_ud, f0.octave, f0.angle, f0.desc_pm1,
                               f0.valid, no_lm)
        m = ms.insert_keyframe(m, 1, Ti_t, ts, f.xy_ud, f.octave, f.angle,
                               f.desc_pm1, f.valid, no_lm)
        m, _ = ms.alloc_landmarks(m, pts, f0.desc_pm1, ok, 0, feat_ids, 1, idx2)
        ev.map = m
        ev.n_kf = 2

        # joint init BA: the image gauge pinned, event KF1 + landmarks free
        kf_free_ev = torch.zeros(ev.map.K, dtype=torch.bool, device=dev)
        kf_free_ev[1] = True
        self.im.map, self.ev.map, _ = _joint_local_ba_step(
            self.im.map, self.ev.map, self.cam, np.eye(3), np.zeros(3), 1.0,
            torch.zeros(self.im.map.K, dtype=torch.bool, device=dev), kf_free_ev,
        )

        ev.state = slam_system.OK
        ev.T_last = ev.map.kf_T[1]
        ev.velocity = ev._eye4()
        ev.frames_since_kf = 0
        ev.n_inliers_ref = n
        ev._last_kf_ts = ts
        ev.last_frame = f
        ev._log_pose(ts, ev.T_last)
        ev.stats["kf"] = 2
        ev.stats["lm"] = int(ev.map.lm_valid.sum())
        if ev.loop_closer is not None:
            ev.loop_closer.add_keyframe(ev.map, 0)
            ev.loop_closer.add_keyframe(ev.map, 1)

        # the bridge is identity by construction, and stays pinned there
        self._last_gauge = (1.0, np.eye(3), np.zeros(3))
        self._gauge_locked = True
        self._gauge_pairs = []
        self._ev_stash.clear()
        self.joint_inits += 1
        return {"state": ev.state, "joint_init": True, "n": n}

    def _seed_ev_from_image(self):
        """The image tracker's current pose through the bridge into the
        event gauge, as the event tracker's prediction (identity velocity):
        Tcw_ev = [R_i R_ie | (R_i t_ie + t_i) / s]."""
        s, R_ie, t_ie = self._last_gauge
        self.ev.T_last = _im_pose_to_ev(self.im.T_last,
                                        *_bridge(R_ie, t_ie, s, self.im.T_last))
        self.ev.velocity = self.ev._eye4()

    def _on_image_loop(self, T_before, info, valid_before=None, ts_before=None):
        """Event side of a loop correction: rigid follow of the weld, then a
        joint global BA over both observation sets (every image KF free but
        the loop anchor, every event KF free)."""
        # paired poses from before the correction no longer constrain the
        # gauge consistently
        self._gauge_pairs = []
        if (self._last_gauge is None or self.ev.n_kf < 2
                or self.ev.state not in (slam_system.OK, slam_system.LOST)):
            return
        s, R_ie, t_ie = self._last_gauge
        # anchor on the slots valid AT CORRECTION TIME
        anchor_ts = self.im.map.kf_ts if ts_before is None else ts_before
        anchor_valid = (self.im.map.kf_valid if valid_before is None
                        else valid_before & self.im.map.kf_valid)
        self.ev.map = _propagate_loop_to_event(
            self.ev.map, anchor_ts, anchor_valid, T_before, self.im.map.kf_T,
            R_ie, t_ie, s)
        im_free = self.im.map.kf_valid.clone()
        if 0 <= info.matched < im_free.shape[0]:
            im_free[info.matched] = False
        self.im.map, self.ev.map, _ = _joint_local_ba_step(
            self.im.map, self.ev.map, self.cam, R_ie, t_ie, s,
            im_free, self.ev.map.kf_valid,
        )
        self.im.T_last = self.im.map.kf_T[self.im._kf_ref()]
        self.im.velocity = self.im._eye4()
        if self.ev.last_kf_slot >= 0:
            self.ev.T_last = self.ev.map.kf_T[self.ev.last_kf_slot]
        self.ev.velocity = self.ev._eye4()
        self.joint_loop_gbas += 1

    def _run_joint_ba(self):
        s, R_ie, t_ie = self._last_gauge
        ref = self.im._kf_ref()
        T_ref_before = self.im.map.kf_T[ref]
        self.im.map, self.ev.map, _ = _joint_local_ba_step(
            self.im.map, self.ev.map, self.cam, R_ie, t_ie, s,
            self.im._ba_window(), self.ev._ba_window(),
        )
        # the CURRENT pose follows its reference keyframe's correction
        # relatively (the frames tracked since that keyframe stay)
        if ref >= 0:
            self.im.T_last = (self.im.T_last @ lie.se3_inv(T_ref_before)
                              @ self.im.map.kf_T[ref])
        self.joint_bas += 1

    def _frame_tensor(self, img) -> torch.Tensor:
        """The frame on the system's device as float32 [0,255] (a uint8
        frame crosses as uint8 and is cast there)."""
        if not isinstance(img, torch.Tensor):
            img = to_device(np.asarray(img), self.device)
        return img.to(self.device).to(torch.float32)

    def _track_image(self, img, ts: float, imu=None):
        """Image-tracker hook; the inertial variant routes the IMU window
        into the frame (slam/event_inertial.py)."""
        return self.im.process_image(self._frame_tensor(img), ts, max_kp=self.max_kp)

    def _synch_mci(self, ts: float) -> Optional[ev_builder.PoseImage]:
        """getSynchMCI: the MCI over the events ending at the image
        timestamp, at most ``synch_window_s`` of them."""
        sel = self._ev_buf[:, 0] <= ts
        window = self._ev_buf[sel]
        self._ev_buf = self._ev_buf[~sel]
        if len(window) < self.cfg.min_chunk:
            return None
        window = window[window[:, 0] >= ts - self.synch_window_s]
        if len(window) < self.cfg.min_chunk:
            return None
        # build_mci touches no builder buffer: nothing is re-injected
        return self.builder.build_mci(window)

    # ------------------------------------------------------------ joint opt

    def _estimate_gauge(self):
        """Sim3 (s, R_ie, t_ie) mapping event-map coordinates into the image
        gauge, from recent frames both trackers tracked on their own: the
        chordal mean of R_im^T R_ev, the median baseline ratio, the mean
        residual translation. Host numpy. Returns (s, R_ie, t_ie, residual)
        or None when under-constrained or the two gauges disagree."""
        pairs = self._gauge_pairs[-self._gauge_window:]
        if len(pairs) < 3:
            return None
        R_sum = np.zeros((3, 3))
        C_im, C_ev = [], []
        for _, Ti, Te in pairs:
            R_sum += Ti[:3, :3].T @ Te[:3, :3]
            C_im.append(-Ti[:3, :3].T @ Ti[:3, 3])
            C_ev.append(-Te[:3, :3].T @ Te[:3, 3])
        U, _, Vt = np.linalg.svd(R_sum)
        R_ie = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
        C_im = np.stack(C_im)
        C_ev = np.stack(C_ev)

        d_im = np.linalg.norm(np.diff(C_im, axis=0), axis=1)
        d_ev = np.linalg.norm(np.diff(C_ev, axis=0), axis=1)
        ok = d_ev > 1e-4
        if ok.sum() < 2 or float(d_im[ok].max()) < 1e-4:
            return None
        s = float(np.median(d_im[ok] / d_ev[ok]))
        if not np.isfinite(s) or s < 1e-6:
            return None
        t_ie = (C_im - s * (R_ie @ C_ev.T).T).mean(axis=0)

        # agreement gate: the Sim3 must explain the paired centres
        resid = np.linalg.norm(C_im - (s * (R_ie @ C_ev.T).T + t_ie), axis=1)
        span = float(d_im.sum())
        if float(np.median(resid)) > max(0.25 * span, 1e-3):
            return None
        return s, R_ie, t_ie, float(np.median(resid))

    def _joint_refine(self, ts: float):
        """EvOptimizer::PoseOptimization: one GN solve over both paired
        frames' matches, the event landmarks bridged into the image gauge."""
        if (self.im.state != slam_system.OK or self.ev.state != slam_system.OK
                or self.im.last_track is None or self.ev.last_track is None
                or self.im.last_frame is None or self.ev.last_frame is None
                or self.im.last_frame.ts != ts or self.ev.last_frame.ts != ts):
            return None
        tr_i, f_i = self.im.last_track, self.im.last_frame
        tr_e, f_e = self.ev.last_track, self.ev.last_frame
        if self._gauge_locked:
            s, R_ie, t_ie = self._last_gauge
            return self._joint_solve(ts, tr_i, f_i, tr_e, f_e, s, R_ie, t_ie, 0.0)
        Tpair = torch.stack([tr_i.Tcw, tr_e.Tcw]).cpu().numpy()
        self._gauge_pairs.append((ts, Tpair[0], Tpair[1]))
        gauge = self._estimate_gauge()
        if gauge is None:
            # under-constrained: keep the previous bridge
            if self._last_gauge is None:
                return None
            s, R_ie, t_ie = self._last_gauge
            resid = -1.0
        else:
            s, R_ie, t_ie, resid = gauge
            self._last_gauge = (s, R_ie, t_ie)
        return self._joint_solve(ts, tr_i, f_i, tr_e, f_e, s, R_ie, t_ie, resid)

    def _joint_solve(self, ts, tr_i, f_i, tr_e, f_e, s, R_ie, t_ie, resid):
        # the bridge staged once for both steps; one solve, one packed read:
        # the joint flags and the image-only solve's inlier count
        bridge = _bridge(R_ie, t_ie, s, self.im.map.lm_pos)
        Tj, flags = _joint_pose_step(
            self.cam, self.im.map.lm_pos, self.ev.map.lm_pos,
            tr_i.feat_lm, f_i.xy_ud, f_i.octave,
            tr_e.feat_lm, f_e.xy_ud, f_e.octave, *bridge, tr_i.Tcw,
        )
        packed = torch.cat([flags, tr_i.n_inliers.reshape(1).to(torch.float32)])
        n_inl, im_inl_joint, finite, n_im_only = (float(x) for x in packed.cpu().numpy())
        # a torn gauge shows as the joint solve losing image inliers against
        # the image-only solve (more than 10% + 2; event inliers alone must
        # not vouch): keep the image pose then
        if im_inl_joint < 0.9 * n_im_only - 2.0 or not finite:
            return {"n_inliers": int(n_inl), "rejected": True}

        vel_im, Te_j, vel_ev, T_rel = _joint_writeback(
            Tj, self.im.T_last, self.ev.T_last, *bridge,
            self.im.map.kf_T[self.im._kf_ref()],
        )
        self.im.velocity = vel_im
        self.im.T_last = Tj
        self.ev.velocity = vel_ev
        self.ev.T_last = Te_j
        if self.im.trajectory and self.im.trajectory[-1][0] == ts:
            self.im.trajectory.pop()
            self.im.trajectory.append((ts, T_rel, self.im._kf_ref()))
        self.joint_frames += 1
        return {"n_inliers": int(n_inl), "scale_bridge": s, "gauge_resid": resid}

    # --------------------------------------------------------------- output

    def trajectory_twc(self):
        return self.im.trajectory_twc()

    def fused_trajectory(self, **kw):
        """System::FuseEventORB: the event keyframe chains welded into the
        image trajectory's gauge (slam/fusion.py). Returns its result dict."""
        from eorb_slam_tpu_torch.slam import fusion

        return fusion.fuse_event_orb(self.im.trajectory_twc(), self.ev.trajectory_twc(),
                                     device=self.device, **kw)

    @property
    def stats(self):
        return {
            "im": dict(self.im.stats),
            "ev": dict(self.ev.stats),
            "joint_frames": self.joint_frames,
            "joint_bas": self.joint_bas,
            "joint_inits": self.joint_inits,
            "joint_loop_gbas": self.joint_loop_gbas,
            "gauge_reseeds": self.gauge_reseeds,
        }
