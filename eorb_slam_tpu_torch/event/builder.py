"""L1 event front-end: adaptive windowing + motion-compensated image (MCI)
synthesis with batched candidate selection.

PyTorch port of the batched-window path of ``eorb_slam_tpu/event/builder.py``
(``step_window`` / ``_window_step`` / ``_make_candidates``). One L1 window of
``l1_num_loop`` chunks runs as one call: the per-chunk splats, the KLT
continuity chain, FAST re-detection, and four MCI candidates (plain
histogram, SE2 contrast maximization, SE3 DPose warp, KLT-fitted SE2 warp),
the winner picked by patch-STD. All of it stays on the builder's device; the
host keeps scalar control state (adaptive chunk size, cursor) and reads one
small metadata vector a window late, through a non-blocking copy.

Beside it, the per-chunk state machine of the continuous tracker
(``step``: one identity splat per chunk in ``_chunk_image``, KLT
continuity and the adaptive chunk size chunk by chunk, a tiny frame per
chunk and an MCI per window through ``_finish_window``) and ``build_mci``,
the four candidates over one padded window that the image-clock modes
build at each image timestamp. Every splat of both goes through
``tensorize.splat_gauss`` / ``splat_gauss_se2`` (the forward splat kernel on
the card), and the SE2 candidate's contrast-maximization ascent through
``contrast_max.maximize_rt2d`` (the ascent kernel on the card: one launch).

The host event buffer is the native C++ queue (``io/native``: O(1) consume
and front re-injection, background file streaming) where the library
builds, else a numpy array.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch._host import HostCopy, constant, resolve_device, to_device
from eorb_slam_tpu_torch.event import contrast_max, klt, tensorize
from eorb_slam_tpu_torch.geometry import lie
from eorb_slam_tpu_torch.io import native
from eorb_slam_tpu_torch.ops import fast

KINDS = ("hist", "se2", "dpose", "klt2d")


@dataclasses.dataclass
class BuilderConfig:
    """Event.* knobs (reference EvParams; defaults from EvETHZ.yaml)."""

    img_w: int = 240
    img_h: int = 180
    l1_chunk_size: int = 2000          # Event.data.l1ChunkSize
    l1_num_loop: int = 4               # Event.data.l1NumLoop (L2 win = n*chunk)
    min_chunk: int = 500
    max_chunk: int = 12000
    max_pixel_disp: float = 3.0        # Event.data.maxPixelDisp
    min_ev_gen_rate: float = 1.0       # events/px/s idle gate (minEvGenRate)
    sigma: float = 1.0                 # ev2im_gauss sigma
    cm_iters: int = 40                 # contrast-max ascent iterations
    cm_sample: int = 16384             # events used by the CM *ascent* (a
    #                                    temporal-strided subset estimates the
    #                                    mean-over-events gradient; the final
    #                                    warp/splat always uses all events)
    max_window_events: int = 65536     # static capacity of build_mci's
    #                                    window (step_window pads per chunk
    #                                    and does not read it)
    n_klt_pts: int = 128               # FAST corners tracked per chunk
    overlap: float = 0.5               # re-injection fraction per window


class PoseImage(NamedTuple):
    """Dispatch record to L2: reconst_stat 0 = tiny frame, 1 = full MCI."""

    img: object                # (H,W) float32 in [0,1], on the builder's device
    ts: float                  # window end timestamp
    ts0: float                 # window start timestamp
    reconst_stat: int
    best_kind: str             # 'hist' | 'se2' | 'dpose' | 'klt2d'
    se2_params: object         # window metadata (device tensor, see _window_step)
    score: float               # winning patch-STD


def _pad_events(ev: np.ndarray, cap: int, t0: Optional[float] = None):
    """(n,4) float64 -> fixed-cap (cap,4) float32 + valid mask (host-side).

    Timestamps are rebased to ``t0`` (default: first kept event) BEFORE the
    float32 cast, so per-event relative times inside millisecond windows
    keep their precision. When the window exceeds ``cap`` the MOST RECENT
    events are kept. Returns (padded, valid, n_dropped)."""
    n_drop = max(len(ev) - cap, 0)
    if t0 is None:
        t0 = float(ev[n_drop, 0]) if len(ev) else 0.0
    nat = native.pad_rebase(ev, cap, t0)
    if nat is not None:
        return nat
    ev = ev[n_drop:]
    n = len(ev)
    out = np.zeros((cap, 4), np.float32)
    valid = np.zeros(cap, bool)
    out[:n, 0] = (ev[:, 0] - t0).astype(np.float32)
    out[:n, 1:] = ev[:, 1:].astype(np.float32)
    valid[:n] = True
    return out, valid, n_drop


def _chunk_image(ev: torch.Tensor, valid: torch.Tensor, H: int, W: int,
                 sigma: float) -> torch.Tensor:
    """One padded chunk's event image in [0,1]: the identity splat."""
    img = tensorize.splat_gauss(ev[:, 1:3], valid, ev[:, 3], H, W, sigma=sigma)
    return tensorize.normalize_to_image(img)


def _make_candidates(
    ev: torch.Tensor,        # (C,4) padded window events [t-t0, x, y, p]
    valid: torch.Tensor,     # (C,)
    dt: torch.Tensor,        # () window duration t1-t0 (seconds)
    T0: torch.Tensor,        # (4,4) Tcw prior at window start (L2 DPose)
    T1: torch.Tensor,        # (4,4) Tcw prior at window end
    med_depth: torch.Tensor,  # () scalar median scene depth from L2
    have_dpose: bool,        # is the (T0,T1,depth) prior usable
    klt_prev: torch.Tensor,  # (Npts,2) KLT reference corners (chunk i-1)
    klt_cur: torch.Tensor,   # (Npts,2) tracked positions (chunk i)
    klt_ok: torch.Tensor,    # (Npts,) bool
    klt_dt: torch.Tensor,    # () seconds between the two chunk images
    have_klt: torch.Tensor,  # () bool
    cam_params: torch.Tensor,
    H: int,
    W: int,
    sigma: float,
    cm_iters: int,
    cm_stride: int = 1,
):
    """All four MCI candidates of one window and the winner. Returns
    (best_img normalized to [0,1], best index, (4,) scores, (3,) se2).
    Runs 4 forward splats and one ascent (on the card: 4 forward kernel
    launches and one ascent kernel launch)."""
    t_sec = ev[:, 0].contiguous()
    t_rel = t_sec / torch.clamp(dt, min=1e-9)                   # [0,1]
    xy = ev[:, 1:3].contiguous()
    pol = ev[:, 3]

    # candidate 0: plain Gaussian histogram (getEvHist)
    img_h = tensorize.splat_gauss(xy, valid, pol, H, W, sigma=sigma)

    # candidate 1: SE2 contrast maximization (getAff2DMCI); the ascent runs
    # on a temporally-strided subset, the final warp uses ALL events
    params, _, _ = contrast_max.maximize_rt2d(
        xy[::cm_stride], t_sec[::cm_stride], valid[::cm_stride],
        H, W, iters=cm_iters, sigma=sigma,
    )
    center = (W / 2.0, H / 2.0)
    # aligned to the window END: the MCI is stamped ts = window end. The
    # SE2 warp runs inside the splat kernel (tensorize.splat_gauss_se2).
    t_end = t_sec - dt
    img_se2 = tensorize.splat_gauss_se2(xy, t_end, params, center, valid,
                                        H, W, sigma=sigma)

    # candidate 2: SE3 DPose warp with L2's median depth (getDPoseMCI)
    xy_dp, z_dp = tensorize.warp_se3_depth(
        xy, t_rel, T0, T1, cam_params, med_depth
    )
    v_dp = valid & (z_dp > 1e-3)
    img_dp = tensorize.splat_gauss(xy_dp, v_dp, pol, H, W, sigma=sigma)

    # candidate 3: SE2 flow fitted to the builder's own KLT correspondences
    params_fit, n_fit = contrast_max.fit_rt2d_points(
        klt_prev, klt_cur, klt_ok, klt_dt, constant(center, xy.dtype, xy.device)
    )
    img_fit = tensorize.splat_gauss_se2(xy, t_end, params_fit, center, valid,
                                        H, W, sigma=sigma)

    # score the RAW accumulators (same event mass in every candidate)
    imgs_raw = torch.stack([img_h, img_se2, img_dp, img_fit])
    scores = tensorize.patch_std_mean(imgs_raw)
    # conditional candidates only compete when their inputs exist
    s_dp = scores[2] if have_dpose else torch.full_like(scores[2], -torch.inf)
    s_fit = torch.where(have_klt & (n_fit >= 6), scores[3], -torch.inf)
    scores = torch.stack([scores[0], scores[1], s_dp, s_fit])
    best = torch.argmax(scores)
    # select + normalize on the device (index_select: no host read of best)
    best_img = tensorize.normalize_to_image(
        imgs_raw.index_select(0, best.view(1))[0])
    return best_img, best, scores, params


def _chunk_step(
    ev: torch.Tensor,          # (C,4) one padded chunk [t-t0, x, y, p]
    valid: torch.Tensor,       # (C,)
    prev_img: Optional[torch.Tensor],   # (H,W) the previous chunk image
    prev_pts: Optional[torch.Tensor],   # (Np,2) its FAST corners
    prev_ok: Optional[torch.Tensor],    # (Np,)
    H: int,
    W: int,
    sigma: float,
    n_klt: int,
    have_prev: bool,
    min_ncc: float = 0.3,
    threshold: float = 0.08,
    min_threshold: float = 0.03,
):
    """One chunk of the per-chunk path (``step``): the identity splat and
    normalization, KLT from the previous chunk image with its median
    displacement (where ``have_prev``), FAST on the new image; each step of
    ``_window_step``'s loop, and the reference's _chunk_image, klt.track
    and fast.detect_grid jits as one unit. Returns (img, median
    displacement, tracked corners, their mask, new corners, their mask);
    the KLT outputs are None without a previous image."""
    img = _chunk_image(ev, valid, H, W, sigma)
    med = kc = kok = None
    if have_prev:
        res = klt.track(prev_img, img, prev_pts, prev_ok, win=9, levels=2, iters=6,
                        min_ncc=min_ncc)
        med = klt.median_displacement(res, prev_pts)
        kc, kok = res.xy, prev_ok & res.ok
    xy, _, vmask = fast.detect_grid(
        img, threshold=threshold, min_threshold=min_threshold, cell=24,
        per_cell=2, max_kp=n_klt, border=6,
    )
    return img, med, kc, kok, xy, vmask


def _window_step(
    chunks: torch.Tensor,     # (L,C,4) per-chunk padded events, t rebased
    #                           to the WINDOW start (float32 seconds)
    cvalid: torch.Tensor,     # (L,C)
    dt_win: torch.Tensor,     # () window duration (s)
    chunk_dts: torch.Tensor,  # (L,) dt between consecutive chunk ends
    prev_img: torch.Tensor,   # (H,W) last chunk image of the previous window
    prev_pts: torch.Tensor,   # (Np,2) its FAST corners
    prev_ok: torch.Tensor,    # (Np,)
    T_prev: torch.Tensor,     # (4,4) L2 pose feedback (PoseDepthInfo)
    T_cur: torch.Tensor,      # (4,4)
    med_depth: torch.Tensor,  # ()
    have_dpose: bool,
    cam_params: torch.Tensor,
    H: int,
    W: int,
    sigma: float,
    cm_iters: int,
    cm_stride: int,
):
    """The ENTIRE L1 window: per-chunk splats, the KLT continuity chain,
    FAST re-detection, and all four MCI candidates. Returns
    (best_img, meta, last chunk image, its corners, their mask) where
    meta = [best, scores(4), median displacements(L), se2(3)]."""
    L = chunks.shape[0]
    n_klt = prev_pts.shape[0]
    img_p, pts_p, ok_p = prev_img, prev_pts, prev_ok
    mds = []
    for i in range(L):
        img_c, md, kc, kok, xy_new, vmask = _chunk_step(
            chunks[i], cvalid[i], img_p, pts_p, ok_p, H, W, sigma, n_klt, have_prev=True)
        mds.append(md)
        # the last chunk's correspondences seed the measured-flow candidate
        kp = pts_p
        img_p, pts_p, ok_p = img_c, xy_new, vmask

    # window-level MCI candidates over the flattened (time-ordered) events
    ev = chunks.reshape(-1, 4)
    valid = cvalid.reshape(-1)
    # DPose prior: constant-velocity extrapolation on the device
    rel = T_cur @ lie.se3_inv(T_prev)
    best_img, best, scores, se2 = _make_candidates(
        ev, valid, dt_win,
        T_cur, rel @ T_cur, med_depth, have_dpose,
        kp, kc, kok, torch.clamp(chunk_dts[-1], min=1e-6),
        torch.sum(kok) >= 6,
        cam_params, H=H, W=W, sigma=sigma, cm_iters=cm_iters,
        cm_stride=cm_stride,
    )
    meta = torch.cat(
        [best[None].to(torch.float32), scores, torch.stack(mds), se2]
    )
    return best_img, meta, img_p, pts_p, ok_p


# the L1 window as one dispatch, as the reference's jit with static H, W,
# sigma, cm_iters, cm_stride: on the card one CUDA graph per key (the chunk
# bucket and count are shapes; have_dpose and cm_stride are static too)
window_step = _graphs.GraphRunner(
    _window_step, static=("have_dpose", "H", "W", "sigma", "cm_iters", "cm_stride"))

# build_mci's four candidates as one dispatch, the reference's
# _make_candidates_jit: the window is padded to max_window_events, so one
# key per have_dpose
make_candidates = _graphs.GraphRunner(
    _make_candidates, static=("have_dpose", "H", "W", "sigma", "cm_iters", "cm_stride"))


# the per-chunk unit as one dispatch: one key with a previous chunk image
# and one without
chunk_step = _graphs.GraphRunner(_chunk_step, static=(
    "H", "W", "sigma", "n_klt", "have_prev", "min_ncc", "threshold", "min_threshold"))


class EventWindowBuilder:
    """Host orchestrator for the L1 window state machine on one device:
    the card (``device=None`` is ``cuda``; without one it raises), or the CPU
    when asked with ``device="cpu"``.

    Feed raw event arrays with :meth:`feed`; call :meth:`step_window`, which
    returns a ``PoseImage`` whenever a full window is buffered, else None,
    or :meth:`step`, which returns one per buffered chunk (a tiny frame, or
    the window's MCI after ``l1_num_loop`` chunks). :meth:`build_mci`
    builds the MCI of a given window and touches no buffer."""

    def __init__(self, cfg: BuilderConfig, cam_params=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = (
            torch.as_tensor(cam_params, dtype=torch.float32, device=self.device)
            if cam_params is not None
            else torch.tensor(
                [1.0, 1.0, cfg.img_w / 2.0, cfg.img_h / 2.0, 0, 0, 0, 0],
                dtype=torch.float32, device=self.device)
        )
        # host event buffer stays float64: raw timestamps must not be
        # quantized before window rebasing. The native queue where the
        # library is available, else the numpy array
        self._q = native.make_queue()
        self.buf = np.zeros((0, 4), np.float64)
        self.chunk_size = cfg.l1_chunk_size
        self.last_med_disp = float("nan")
        # PoseDepthInfo analog: L2 posts (T0, T1, med_depth) back here
        self.pose_prior: Optional[tuple] = None
        # per-chunk path (step): the window's chunks so far, the last chunk
        # image with its corners, and the newest KLT correspondence set
        # (prev_pts, cur_pts, ok, dt) for the measured-flow candidate
        self.chunks_in_window: list = []
        self.prev_img: Optional[torch.Tensor] = None
        self.prev_pts: Optional[torch.Tensor] = None
        self.prev_pts_valid: Optional[torch.Tensor] = None
        self._klt_fit = None
        self._last_chunk_ts = 0.0
        # device KLT carry + metadata copied to the host a window late
        self._win_carry = None
        self._pending_meta = None
        self._last_kind = "hist"
        self._last_score = 0.0
        self.stats = {"chunks": 0, "windows": 0, "idle": 0, "ev_truncated": 0}

    # ------------------------------------------------------------- input

    def feed(self, events: np.ndarray) -> None:
        if len(events):
            if self._q is not None:
                self._q.feed(np.asarray(events, np.float64))
            else:
                self.buf = np.concatenate(
                    [self.buf, np.asarray(events, np.float64)])

    def stream_file(self, path: str, max_rows=None) -> bool:
        """Start the native background streamer parsing ``path`` (ts x y p
        text) into the queue; returns False when unavailable."""
        return self._q is not None and self._q.stream_file(path, max_rows)

    def pending_events(self) -> int:
        return len(self._q) if self._q is not None else len(self.buf)

    def _consume(self, n: int) -> np.ndarray:
        if self._q is not None:
            return self._q.consume(n)
        chunk, self.buf = self.buf[:n], self.buf[n:]
        return chunk

    def _inject_front(self, events: np.ndarray) -> None:
        if self._q is not None:
            self._q.inject_front(events)
        else:
            self.buf = np.concatenate([events, self.buf])

    def set_pose_prior(self, T0, T1, med_depth):
        """L2 pose/depth feedback (PoseDepthInfo analog). Device tensors are
        consumed on the device by step_window without a host read."""
        self.pose_prior = (T0, T1, med_depth)

    # ------------------------------------------------------------- control

    def _adapt_chunk_size(self, med_disp: float) -> None:
        """calcNewL1ChunkSize: scale the window so the median optical flow
        hits maxPixelDisp (damped ratio clamp)."""
        if not np.isfinite(med_disp) or med_disp <= 1e-3:
            return
        ratio = self.cfg.max_pixel_disp / med_disp
        ratio = float(np.clip(ratio, 0.5, 2.0))
        self.chunk_size = int(
            np.clip(self.chunk_size * ratio, self.cfg.min_chunk, self.cfg.max_chunk)
        )

    def _resolve_window_meta(self, block: bool = False) -> None:
        """Read the newest window metadata, if its copy to the host has
        landed (or wait for it with ``block``), and run the adaptive-window
        feedback on it. Without ``block`` the feedback lags by as many
        windows as the device is behind the host."""
        if self._pending_meta is None:
            return
        if not block and not self._pending_meta.ready():
            return
        meta = self._pending_meta.numpy()
        self._pending_meta = None
        L = self.cfg.l1_num_loop
        best_i = int(meta[0])
        self._last_kind = KINDS[best_i]
        self._last_score = float(meta[1 + best_i])
        mds = meta[5:5 + L]
        mds = mds[np.isfinite(mds) & (mds > 1e-3)]
        if len(mds):
            med = float(np.median(mds))
            self.last_med_disp = med
            self._adapt_chunk_size(med)

    def _to_dev(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device, non_blocking=True)

    def step_window(self) -> Optional[PoseImage]:
        """Process one FULL L1 window (l1_num_loop chunks) — splats, KLT
        continuity chain, FAST re-detection, and the four MCI candidates (see
        _window_step). Returns a PoseImage per completed window.

        ``best_kind``/``score`` lag one window (the exact values ride the
        metadata in ``se2_params``)."""
        cfg = self.cfg
        L = cfg.l1_num_loop
        cs = self.chunk_size
        if self.pending_events() < cs * L:
            return None
        self._resolve_window_meta()
        cs = self.chunk_size        # feedback may have changed it
        if self.pending_events() < cs * L:
            return None
        win = self._consume(cs * L)
        self.stats["chunks"] += L

        t0, t1 = float(win[0, 0]), float(win[-1, 0])
        rate = len(win) / max(t1 - t0, 1e-9) / (cfg.img_w * cfg.img_h)
        if rate < cfg.min_ev_gen_rate:
            self.stats["idle"] += 1
            self._win_carry = None
            self._klt_fit = None
            return None

        # per-chunk padded tensor, power-of-two bucket
        C = max(1024, 1 << (cs - 1).bit_length())
        chunks = np.zeros((L, C, 4), np.float32)
        cvalid = np.zeros((L, C), bool)
        tr = (win[:, 0] - t0).astype(np.float32)
        for i in range(L):
            seg = slice(i * cs, (i + 1) * cs)
            chunks[i, :cs, 0] = tr[seg]
            chunks[i, :cs, 1:] = win[seg, 1:].astype(np.float32)
            cvalid[i, :cs] = True
        chunk_t1 = win[(np.arange(L) + 1) * cs - 1, 0]
        prev_t1 = self._last_chunk_ts or (t0 - 1e-3)
        dts = np.diff(np.concatenate([[prev_t1], chunk_t1])).astype(np.float32)
        self._last_chunk_ts = float(chunk_t1[-1])

        dev = self.device
        carry = self._win_carry
        if carry is None:
            n = cfg.n_klt_pts
            carry = (
                torch.zeros((cfg.img_h, cfg.img_w), dtype=torch.float32, device=dev),
                torch.zeros((n, 2), dtype=torch.float32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev),
            )
        if self.pose_prior is not None:
            T_prev, T_cur, depth = self.pose_prior
            have_dpose = True
        else:
            T_prev = T_cur = np.eye(4, dtype=np.float32)
            depth, have_dpose = 1.0, False
        cm_stride = max(1, int(np.ceil(L * C / max(cfg.cm_sample, 1))))

        best_img, meta, img_l, pts_l, ok_l = window_step(
            self._to_dev(chunks), self._to_dev(cvalid, torch.bool),
            self._to_dev(np.float32(t1 - t0)), self._to_dev(dts),
            carry[0], carry[1], carry[2],
            self._to_dev(T_prev), self._to_dev(T_cur), self._to_dev(depth),
            have_dpose, self.cam, H=cfg.img_h, W=cfg.img_w, sigma=cfg.sigma,
            cm_iters=cfg.cm_iters, cm_stride=cm_stride,
        )
        self._win_carry = (img_l, pts_l, ok_l)
        self._pending_meta = HostCopy(meta)
        self.stats["windows"] += 1

        n_keep = int(len(win) * cfg.overlap)
        if n_keep > 0:
            self._inject_front(win[-n_keep:])
        return PoseImage(
            img=best_img, ts=t1, ts0=t0, reconst_stat=1,
            best_kind=self._last_kind, se2_params=meta,
            score=self._last_score,
        )

    # ------------------------------------------------- per-chunk pipeline

    def step(self) -> Optional[PoseImage]:
        """Consume one chunk: the gen-rate gate, its event image, KLT from
        the previous chunk image (the median displacement resizes the next
        chunk), FAST corners for the next pair. Returns a tiny frame
        (reconst_stat 0) until ``l1_num_loop`` chunks make a window, then
        that window's MCI; None when less than a chunk is buffered or the
        chunk was idle. Reads the median displacement once per chunk."""
        cfg = self.cfg
        if self.pending_events() < self.chunk_size:
            return None
        chunk = self._consume(self.chunk_size)
        self.stats["chunks"] += 1

        # gen-rate gate
        t_span = float(chunk[-1, 0] - chunk[0, 0])
        rate = len(chunk) / max(t_span, 1e-9) / (cfg.img_w * cfg.img_h)
        if rate < cfg.min_ev_gen_rate:
            self.stats["idle"] += 1
            self.chunks_in_window.clear()
            self.prev_img = None
            # stale correspondences must not seed the measured-flow MCI
            # after an idle gap (their dt no longer matches)
            self._klt_fit = None
            return None

        ev_pad, v_pad, _ = _pad_events(chunk, cfg.max_chunk)
        # the chunk image, KLT continuity from the previous chunk image and
        # FAST corners for the next pair, as one unit
        have_prev = self.prev_img is not None and self.prev_pts is not None
        img, med, kc, kok, xy, vmask = chunk_step(
            self._to_dev(ev_pad), self._to_dev(v_pad, torch.bool),
            self.prev_img if have_prev else None, self.prev_pts if have_prev else None,
            self.prev_pts_valid if have_prev else None,
            H=cfg.img_h, W=cfg.img_w, sigma=cfg.sigma, n_klt=cfg.n_klt_pts,
            have_prev=have_prev)
        if have_prev:
            # the median pixel displacement drives the adaptive chunk size
            med = float(med)
            self.last_med_disp = med
            self._adapt_chunk_size(med)
            self._klt_fit = (self.prev_pts, kc, kok,
                             float(chunk[-1, 0]) - self._last_chunk_ts)
        self._last_chunk_ts = float(chunk[-1, 0])
        self.prev_img, self.prev_pts, self.prev_pts_valid = img, xy, vmask

        self.chunks_in_window.append(chunk)
        if len(self.chunks_in_window) < cfg.l1_num_loop:
            # tiny frame: KLT continuity only (reconst_stat 0)
            return PoseImage(
                img=img, ts=float(chunk[-1, 0]), ts0=float(chunk[0, 0]),
                reconst_stat=0, best_kind="hist",
                se2_params=np.zeros(3, np.float32), score=0.0,
            )
        return self._finish_window()

    def build_mci(self, window: np.ndarray) -> PoseImage:
        """The four candidates and the winner over one event window, padded
        to ``max_window_events`` (the ascent runs on all of it). Pure with
        respect to the builder's buffers: the image-clock modes build their
        synchronized MCI with it, and the per-chunk path its window's. The
        DPose candidate extrapolates the pose prior at constant velocity on
        the device; the KLT candidate uses the newest correspondence set
        when its dt is positive. One packed host read: [best, scores]."""
        cfg = self.cfg
        t0, t1 = float(window[0, 0]), float(window[-1, 0])
        ev_pad, v_pad, n_drop = _pad_events(window, cfg.max_window_events)
        if n_drop:
            # the padded window rebases to the first KEPT event
            t0 = float(window[n_drop, 0])
            self.stats["ev_truncated"] += n_drop

        dev = self.device
        if self._klt_fit is not None and self._klt_fit[3] > 0:
            # kdt <= 0 for the chunk pair straddling the overlap re-injection
            # (timestamps step backward): no fit from it
            kp, kc, kok, kdt = self._klt_fit
            have_klt = True
        else:
            n = cfg.n_klt_pts
            kp = kc = constant(((0.0, 0.0),) * n, torch.float32, dev)
            kok = constant((False,) * n, torch.bool, dev)
            kdt, have_klt = 1e-3, False
        # the window's host scalars in one copy: its duration, the KLT pair's
        # dt, the median depth of no prior, and have_klt
        f32 = np.asarray([t1 - t0, kdt, 1.0], np.float32)
        staged = to_device(np.concatenate([f32.view(np.uint8), np.asarray([have_klt], np.uint8)]),
                           dev)
        dt, kdt_t, depth = staged[:f32.nbytes].view(torch.float32).unbind()
        have_klt_t = staged[f32.nbytes:].view(torch.bool)[0]

        if self.pose_prior is not None:
            # L2 posts the poses of its last two tracked frames: warp this
            # window with the constant-velocity extrapolation (T_cur,
            # rel @ T_cur), as step_window does
            T_prev, T_cur, depth = (self._to_dev(x) for x in self.pose_prior)
            T0, T1 = T_cur, (T_cur @ lie.se3_inv(T_prev)) @ T_cur
            have_dpose = True
        else:
            T0 = T1 = constant(tuple(map(tuple, np.eye(4))), torch.float32, dev)
            have_dpose = False

        best_img, best, scores, se2 = make_candidates(
            self._to_dev(ev_pad), self._to_dev(v_pad, torch.bool), dt, T0, T1, depth,
            have_dpose, kp, kc, kok, kdt_t, have_klt_t, self.cam,
            H=cfg.img_h, W=cfg.img_w, sigma=cfg.sigma, cm_iters=cfg.cm_iters,
        )
        meta = torch.cat([best[None].to(torch.float32), scores]).cpu().numpy()
        best_i = int(meta[0])
        self.stats["windows"] += 1
        return PoseImage(
            img=best_img, ts=t1, ts0=t0, reconst_stat=1,
            best_kind=KINDS[best_i], se2_params=se2, score=float(meta[1 + best_i]),
        )

    def _finish_window(self) -> PoseImage:
        """The window's MCI, then the overlap tail back into the queue
        (injectEventsBegin)."""
        window = np.concatenate(self.chunks_in_window)
        pi = self.build_mci(window)
        n_keep = int(len(window) * self.cfg.overlap)
        if n_keep > 0:
            self._inject_front(window[-n_keep:])
        self.chunks_in_window.clear()
        return pi
