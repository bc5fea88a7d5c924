"""Synthetic dataset generator: disk-format-faithful EuRoC / EV-ETHZ sequences.

The reference is validated exclusively on real datasets (EuRoC, the ETH event
camera dataset, MVSEC) pulled through its loaders (reference
src/Utils/DataStore.cpp:473-737, src/Event/EventLoader.cpp:378 and the
fmt_ev_ethz app loop, Examples/Event/fmt_ev_ethz.cpp:43-270). This module
renders a long textured 3D scene — intensity images, DVS events (ESIM-style
per-pixel log-intensity threshold crossings), IMU consistent with the
trajectory, and ground truth — and writes it in the SAME file layouts, so the
full application path (native parser, loaders, frontend, tracker, trajectory
writer, evaluator) is exercised end-to-end without network access:

- EuRoC:   <root>/<seq>/mav0/cam0/data.csv + data/*.png,
           imu0/data.csv, state_groundtruth_estimate0/data.csv   (ns stamps)
- EV-ETHZ: <root>/<seq>/events.txt, images.txt + images/,
           imu.txt (accel-first like the dataset), groundtruth.txt (seconds)

Rendering is Gaussian-splat point texture (event/tensorize.splat_gauss): a
dense cloud of fixed 3D "texture dots" projected per frame — enough FAST
corners for the ORB frontend, perfectly known geometry for ATE gates. The
image-frontend datasets use a ray-cast textured box world instead.

PyTorch port of ``eorb_slam_tpu/io/synth_dataset.py``: trajectories, scenes,
IMU, the event simulation and the writers are numpy; the two renderers are
torch and run on the card unless ``device`` says otherwise (``None`` is
``cuda`` and raises where there is none), so on the card the dot renderer's
splat is the hand-written CUDA kernel, one launch per rendered pose.

CLI:
    python -m eorb_slam_tpu_torch.io.synth_dataset --out DIR --kind euroc \
        --seq seq01 --duration 30 [--traj corridor|room|shakes] [--fps 20]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from eorb_slam_tpu_torch._host import resolve_device

GRAVITY_W = np.asarray([0.0, 0.0, -9.81])


# -------------------------------------------------- numpy rotation helpers
# (the generator evaluates poses tens of thousands of times: host-side f64
# math, no device ops)


def so3_exp_np(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-10:
        return np.eye(3) + _hat_np(w)
    a = w / th
    K = _hat_np(a)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def so3_log_np(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-8:
        return np.asarray([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                           R[1, 0] - R[0, 1]]) / 2.0
    return th / (2 * np.sin(th)) * np.asarray(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _hat_np(w):
    return np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                      np.float64)


def quat_wxyz_np(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.asarray([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                           (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


# ----------------------------------------------------------------- trajectory


def make_trajectory(kind: str, duration: float):
    """Returns Tcw(t): smooth camera-to-world pose path with real
    translational/rotational excitation (VI scale observability needs
    acceleration; event generation needs optical flow)."""

    def _pose_from(C, R_wc):
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ C
        return T

    def _lookat(C, target, up=np.asarray([0.0, 0.0, -1.0])):
        """R_wc with camera +z toward `target` (optical axis), x right."""
        z = target - C
        z = z / np.linalg.norm(z)
        x = np.cross(z, up)
        n = np.linalg.norm(x)
        if n < 1e-6:
            x = np.asarray([1.0, 0.0, 0.0])
        else:
            x = x / n
        y = np.cross(z, x)
        return np.stack([x, y, z], axis=1)

    if kind == "corridor":
        # forward flight ALONG the optical axis (+z) through the textured
        # tube, with lateral/vertical sway and gentle attitude wobble
        def pose(t):
            C = np.asarray([
                0.8 * np.sin(0.9 * t),
                0.5 * np.sin(0.7 * t + 1.0),
                1.0 * t + 0.25 * np.sin(1.3 * t),
            ])
            yaw = 0.10 * np.sin(0.5 * t)
            pitch = 0.05 * np.sin(0.4 * t + 1.0)
            R_cw = so3_exp_np(np.asarray(
                [pitch, yaw, 0.03 * np.sin(0.8 * t)]))
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = R_cw
            T[:3, 3] = -R_cw @ C
            return T
        return pose

    if kind == "room":
        # closed loop around a room, always looking at the center: the path
        # REVISITS its start (loop-closure fixture)
        w = 2.0 * np.pi / duration

        def pose(t):
            ang = w * t
            C = np.asarray([
                3.0 * np.cos(ang),
                3.0 * np.sin(ang),
                0.5 * np.sin(2.0 * ang) + 0.3 * np.sin(1.1 * t),
            ])
            target = np.asarray([0.0, 0.0, 0.15 * np.sin(0.7 * t)])
            return _pose_from(C, _lookat(C, target))
        return pose

    if kind == "shakes":
        # 6-dof jitter in front of a near-planar textured wall
        # (ev_ethz shapes_6dof-like: high optical flow, bounded volume)
        def pose(t):
            C = np.asarray([
                0.45 * np.sin(2.1 * t) + 0.2 * np.sin(0.33 * t),
                0.35 * np.sin(1.7 * t + 1.0),
                0.25 * np.sin(1.3 * t + 0.5),
            ])
            rot = np.asarray([
                0.10 * np.sin(1.9 * t),
                0.12 * np.sin(1.5 * t + 0.7),
                0.15 * np.sin(1.1 * t + 0.2),
            ])
            R_cw = so3_exp_np(np.asarray(rot))
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = R_cw
            T[:3, 3] = -R_cw @ C
            return T
        return pose

    raise ValueError(f"unknown trajectory kind {kind!r}")


# ---------------------------------------------------------------------- scene


@dataclasses.dataclass
class Scene:
    """Fixed cloud of textured 3D dots + camera intrinsics."""

    dots: np.ndarray     # (D,3) float32
    amp: np.ndarray      # (D,) float32 splat amplitude
    W: int
    H: int
    fx: float
    fy: float
    cx: float
    cy: float
    sigma: float = 1.1
    gain: Optional[float] = None   # fixed photometric gain (set on first use)

    def camera_params(self) -> np.ndarray:
        return np.asarray([self.fx, self.fy, self.cx, self.cy, 0, 0, 0, 0],
                          np.float32)


def make_scene(kind: str, W: int, H: int, fx: float, n_dots: int = 6000,
               seed: int = 0, constellation: int = 4) -> Scene:
    """`constellation` > 1 replaces each texture dot with a small cluster of
    sub-dots at random offsets/amplitudes: isolated Gaussian blobs are all
    IDENTICAL to a binary descriptor (radially symmetric), so matching
    degenerates into ambiguity — clusters give every feature patch a unique
    local gradient pattern, like real-world texture."""
    rng = np.random.default_rng(seed)
    if kind == "corridor":
        dots = np.concatenate([
            rng.uniform(-8, 8 + 40.0, (n_dots, 1)),     # along the path
            rng.uniform(-5, 5, (n_dots, 1)),
            rng.uniform(2, 14, (n_dots, 1)),
        ], axis=1)
    elif kind == "room":
        # dots on the walls/volume of a room around the origin
        dots = np.concatenate([
            rng.uniform(-2.2, 2.2, (n_dots, 1)),
            rng.uniform(-2.2, 2.2, (n_dots, 1)),
            rng.uniform(-1.6, 1.6, (n_dots, 1)),
        ], axis=1)
    elif kind == "shakes":
        # near-planar wall ~2.5 m in front (+z), mild depth relief
        dots = np.concatenate([
            rng.uniform(-2.6, 2.6, (n_dots, 1)),
            rng.uniform(-2.0, 2.0, (n_dots, 1)),
            rng.uniform(2.0, 3.2, (n_dots, 1)),
        ], axis=1)
    else:
        raise ValueError(f"unknown scene kind {kind!r}")
    if constellation > 1:
        # cluster radius scales with depth so the projected footprint stays
        # roughly constant (~a BRIEF patch) across the scene
        reps = constellation
        base = np.repeat(dots, reps, axis=0)
        z = base[:, 2:3] if kind != "room" else np.full((len(base), 1), 2.5)
        spread = 0.012 * np.abs(z) + 0.01
        off = rng.normal(0, 1.0, (len(base), 3)) * spread
        off[:, 2] *= 0.2  # keep clusters near-planar (depth-coherent)
        dots = base + off
        amp = rng.uniform(0.2, 1.0, len(dots)).astype(np.float32)
    else:
        amp = rng.uniform(0.35, 1.0, n_dots).astype(np.float32)
    return Scene(dots=dots.astype(np.float32), amp=amp, W=W, H=H,
                 fx=fx, fy=fx, cx=W / 2.0, cy=H / 2.0)


def _to_numpy(x) -> np.ndarray:
    """A rendered image (device tensor) or any array -> numpy on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pose_tensor(Tcw, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(Tcw, np.float32)).to(device)


def _renderer(scene: Scene, pose_fn=None, device=None):
    """Tcw (4,4) -> [H,W] float image in [0,1], a tensor on ``device``.

    Uses a FIXED photometric gain (calibrated once on the first pose) — a
    per-frame max-normalization would couple every pixel's brightness to the
    global splat density, firing spurious DVS events on the whole frame each
    simulation step.

    One splat per pose through ``tensorize.splat_gauss`` (on the card: one
    launch of the CUDA kernel, identity form). As in the reference, the
    amplitudes ride the polarity argument, which the splat ignores without
    ``use_polarity``: every dot in view weighs 1."""
    from eorb_slam_tpu_torch.event import tensorize

    device = resolve_device(device)
    dots = torch.as_tensor(scene.dots).to(device)
    amp = torch.as_tensor(scene.amp).to(device)
    fx, fy, cx, cy = scene.fx, scene.fy, scene.cx, scene.cy
    H, W = scene.H, scene.W

    def render_raw(Tcw):
        Tcw = _pose_tensor(Tcw, device)
        pc = dots @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        uv = torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)
        ok = (z > 0.3) & (uv[:, 0] >= -3) & (uv[:, 0] < W + 3) \
            & (uv[:, 1] >= -3) & (uv[:, 1] < H + 3)
        return tensorize.splat_gauss(uv, ok, amp, H, W, sigma=scene.sigma)

    if scene.gain is None:
        T0 = np.asarray(pose_fn(0.0), np.float32) if pose_fn is not None \
            else np.eye(4, dtype=np.float32)
        ref = _to_numpy(render_raw(T0))
        scene.gain = float(1.0 / max(np.percentile(ref, 99.5), 1e-6))

    gain = scene.gain

    def render(Tcw):
        return torch.clamp(render_raw(Tcw) * gain, 0.0, 1.0)

    return render


# ------------------------------------------------------------------------ imu


def imu_from_trajectory(pose_fn, t0: float, t1: float, hz: float = 200.0,
                        noise_gyro: float = 0.0, noise_acc: float = 0.0,
                        seed: int = 0):
    """Finite-difference IMU consistent with Tcw(t) (body frame == camera
    frame, Tbc = I): gyro from the rotation log, accel from the second
    difference of the camera center, gravity added in the body frame.
    Returns (ts, gyro (N,3), acc (N,3))."""
    n = int(round((t1 - t0) * hz))
    ts = t0 + (np.arange(n) + 1) / hz
    h = 1e-3
    gyro = np.zeros((n, 3))
    acc = np.zeros((n, 3))
    for i, t in enumerate(ts):
        Ta = np.asarray(pose_fn(t - h), np.float64)
        T0 = np.asarray(pose_fn(t), np.float64)
        Tb = np.asarray(pose_fn(t + h), np.float64)
        Ra, R0, Rb = Ta[:3, :3].T, T0[:3, :3].T, Tb[:3, :3].T   # R_wc
        Ca = -Ra @ Ta[:3, 3]
        C0 = -R0 @ T0[:3, 3]
        Cb = -Rb @ Tb[:3, 3]
        w = so3_log_np(Ra.T @ Rb) / (2 * h)
        a_w = (Cb - 2 * C0 + Ca) / (h * h)
        gyro[i] = w
        acc[i] = R0.T @ (a_w - GRAVITY_W)
    if noise_gyro > 0 or noise_acc > 0:
        rng = np.random.default_rng(seed + 77)
        gyro = gyro + rng.normal(0, noise_gyro, gyro.shape)
        acc = acc + rng.normal(0, noise_acc, acc.shape)
    return ts, gyro.astype(np.float64), acc.astype(np.float64)


# --------------------------------------------------------------------- events


def simulate_events(render, pose_fn, t0: float, t1: float,
                    sim_hz: float = 150.0, contrast: float = 0.18,
                    eps: float = 0.02, max_per_pixel: int = 6,
                    seed: int = 0):
    """ESIM-style DVS simulation: per-pixel log-intensity reference levels,
    one event per contrast-threshold crossing, timestamps linearly
    interpolated within the sim step. Returns (N,4) float64 [ts x y p]."""
    rng = np.random.default_rng(seed + 13)
    n_steps = int(round((t1 - t0) * sim_hz))
    L_ref = None
    t_prev = t0
    chunks = []
    for k in range(n_steps + 1):
        t = t0 + k / sim_hz
        img = _to_numpy(render(np.asarray(pose_fn(t), np.float32)))
        L = np.log(img + eps)
        if L_ref is None:
            L_ref = L
            t_prev = t
            continue
        d = L - L_ref
        n_ev = np.minimum(np.floor(np.abs(d) / contrast).astype(np.int32),
                          max_per_pixel)
        ys, xs = np.nonzero(n_ev)
        if len(ys):
            counts = n_ev[ys, xs]
            pol = (d[ys, xs] > 0)
            total = int(counts.sum())
            # expand: pixel i emits counts[i] events spread over the step
            xs_e = np.repeat(xs, counts)
            ys_e = np.repeat(ys, counts)
            pol_e = np.repeat(pol, counts)
            # within-pixel ordinal 1..c for interpolated timestamps
            first = np.cumsum(counts) - counts
            ord_e = np.arange(total) - np.repeat(first, counts) + 1
            frac = ord_e / (np.repeat(counts, counts) + 1.0)
            ts_e = t_prev + (t - t_prev) * frac \
                + rng.uniform(0, 0.1 / sim_hz, total)
            chunk = np.stack([
                ts_e, xs_e.astype(np.float64), ys_e.astype(np.float64),
                pol_e.astype(np.float64)
            ], axis=1)
            chunks.append(chunk)
            L_ref = L_ref + n_ev * contrast * np.sign(d)
        t_prev = t
    if not chunks:
        return np.zeros((0, 4))
    ev = np.concatenate(chunks, axis=0)
    return ev[np.argsort(ev[:, 0], kind="stable")]


# ------------------------------------------------------- textured box world


def _value_noise_texture(n: int = 1024, seed: int = 0,
                         octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise texture in [0,1]: dense gradients at every
    scale, which is what ORB features need (sparse splat dots are
    near-identical to a binary descriptor and matching collapses with
    baseline — measured 512->50 surviving matches over 10 frames)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    tex = np.zeros((n, n), np.float32)
    for o in range(octaves):
        k = 8 << o
        g = rng.standard_normal((k, k)).astype(np.float32)
        # upsampling only: half-pixel centres, edges clamped, no antialias
        up = F.interpolate(torch.from_numpy(g)[None, None], size=(n, n),
                           mode="bilinear", align_corners=False)[0, 0]
        tex += up.numpy() / (1.6 ** o)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return tex


def make_box_renderer(kind: str, W: int, H: int, fx: float, seed: int = 0,
                      device=None):
    """Tcw -> [H,W] image (a tensor on ``device``) of a texture-mapped box
    world (ray/plane intersection per pixel + bilinear texture sampling).
    Rich, photometrically stable imagery for the image-frontend datasets.
    ``render.with_depth(Tcw)`` also returns the camera z-depth map."""
    device = resolve_device(device)
    fy, cx, cy = fx, W / 2.0, H / 2.0
    TN = 1024
    tex = torch.from_numpy(_value_noise_texture(TN, seed)).to(device)
    px_per_m = 160.0

    if kind == "corridor":
        # tube along +z: side walls x=+-3, floor/ceiling y=+-2, far cap z=70
        planes = [(0, -3.0), (0, 3.0), (1, -2.0), (1, 2.0), (2, 70.0)]
    elif kind == "room":
        planes = [(0, -4.0), (0, 4.0), (1, -3.0), (1, 3.0),
                  (2, -4.0), (2, 4.0)]
    else:
        raise ValueError(kind)

    us, vs = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        indexing="xy")
    d_cam = torch.stack([(us - cx) / fx, (vs - cy) / fy,
                         torch.ones_like(us)], -1)            # (H,W,3)
    inf = torch.tensor(float("inf"), device=device)

    def sample(u, v):
        # a ray that misses the plane has infinite coordinates; its sample
        # is never used (an infinite hit distance wins nothing), so any
        # in-range texel will do
        ui = torch.nan_to_num(torch.remainder(u * px_per_m, TN - 1.0), 0.0, 0.0, 0.0)
        vi = torch.nan_to_num(torch.remainder(v * px_per_m, TN - 1.0), 0.0, 0.0, 0.0)
        x0 = torch.floor(ui).long()
        y0 = torch.floor(vi).long()
        ax = ui - x0
        ay = vi - y0
        x1 = (x0 + 1) % TN
        y1 = (y0 + 1) % TN
        return ((1 - ax) * (1 - ay) * tex[y0, x0]
                + ax * (1 - ay) * tex[y0, x1]
                + (1 - ax) * ay * tex[y1, x0]
                + ax * ay * tex[y1, x1])

    def render_with_depth(Tcw):
        Tcw = _pose_tensor(Tcw, device)
        R = Tcw[:3, :3]
        t = Tcw[:3, 3]
        C = -R.T @ t
        dirs = torch.einsum("ij,hwj->hwi", R.T, d_cam)     # world rays
        best_t = torch.full((H, W), float("inf"), device=device)
        val = torch.zeros((H, W), device=device)
        for pi, (ax, off) in enumerate(planes):
            denom = dirs[..., ax]
            th = (off - C[ax]) / torch.where(denom.abs() < 1e-9, inf, denom)
            th = torch.where(th > 0.1, th, inf)
            p = C[None, None, :] + th[..., None] * dirs
            o1, o2 = [a for a in range(3) if a != ax]
            # per-plane texture offset so opposite walls differ
            v_pix = sample(p[..., o1] + 37.31 * (pi + 1),
                           p[..., o2] + 11.71 * (pi + 1))
            hit = th < best_t
            val = torch.where(hit, v_pix, val)
            best_t = torch.minimum(best_t, th)
        # d_cam has z=1, so the ray parameter IS the camera z-depth
        depth = torch.where(torch.isfinite(best_t), best_t, 0.0)
        return torch.clamp(val, 0.0, 1.0), depth

    def render(Tcw):
        return render_with_depth(Tcw)[0]

    render.with_depth = render_with_depth
    return render


# -------------------------------------------------------------------- writers


def _save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8), "L").save(path)


def _save_depth_png(path: str, depth_m: np.ndarray, factor: float) -> None:
    """16-bit depth PNG, TUM convention (counts = meters * factor; 0 = no
    reading). Depths beyond the uint16 range are recorded as missing."""
    from PIL import Image

    counts = depth_m * factor
    counts = np.where((counts > 0) & (counts < 65535), counts, 0)
    Image.fromarray(counts.astype(np.uint16), "I;16").save(path)


def _quat_wxyz(R_wc: np.ndarray) -> np.ndarray:
    return quat_wxyz_np(R_wc)


def _gt_rows(pose_fn, ts: np.ndarray):
    """(ts, tx ty tz, qw qx qy qz) of Twc (body == camera frame)."""
    rows = np.zeros((len(ts), 8))
    for i, t in enumerate(ts):
        T = np.asarray(pose_fn(t), np.float64)
        R_wc = T[:3, :3].T
        C = -R_wc @ T[:3, 3]
        q = _quat_wxyz(R_wc)
        rows[i] = [t, *C, *q]
    return rows


def write_euroc(root: str, seq: str, scene: Scene, pose_fn,
                duration: float, fps: float = 20.0, imu_hz: float = 200.0,
                gt_hz: float = 100.0, noise_gyro: float = 2e-4,
                noise_acc: float = 2e-3, verbose: bool = True,
                renderer=None, stereo_baseline: Optional[float] = None,
                write_depth: bool = False,
                depth_factor: float = 5000.0, device=None) -> str:
    """Render + write a EuRoC-layout sequence (ns integer timestamps).

    ``stereo_baseline``: also render cam1 displaced by +baseline meters
    along the camera x axis (EuRoC cam1 layout, rectified geometry).
    ``write_depth``: also write 16-bit depth PNGs (TUM convention,
    depth_factor counts per meter) under depth0/data — requires a renderer
    with a ``with_depth`` variant (make_box_renderer provides one).
    ``device`` is where the dot renderer runs when no ``renderer`` is given
    (``None``: the card)."""
    base = os.path.join(root, seq, "mav0")
    cam_dir = os.path.join(base, "cam0", "data")
    imu_dir = os.path.join(base, "imu0")
    gt_dir = os.path.join(base, "state_groundtruth_estimate0")
    dirs = [cam_dir, imu_dir, gt_dir]
    if stereo_baseline:
        cam1_dir = os.path.join(base, "cam1", "data")
        dirs.append(cam1_dir)
    if write_depth:
        depth_dir = os.path.join(base, "depth0", "data")
        dirs.append(depth_dir)
    for d in dirs:
        os.makedirs(d, exist_ok=True)

    render = (renderer if renderer is not None
              else _renderer(scene, pose_fn, device))
    if write_depth and not hasattr(render, "with_depth"):
        raise ValueError("write_depth requires a renderer with .with_depth")
    T_rl = np.eye(4, dtype=np.float32)
    if stereo_baseline:
        # right camera: a point at x in the left frame sits at x - b in the
        # right frame -> Tcw_right = [I | -b e_x] @ Tcw_left
        T_rl[0, 3] = -float(stereo_baseline)
    n_frames = int(duration * fps)
    with open(os.path.join(base, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i in range(n_frames):
            t = (i + 1) / fps
            ns = int(round(t * 1e9))
            name = f"{ns}.png"
            Tcw = np.asarray(pose_fn(t), np.float32)
            if write_depth:
                img, depth = (_to_numpy(x)
                              for x in render.with_depth(Tcw))
                _save_depth_png(os.path.join(depth_dir, name), depth,
                                depth_factor)
            else:
                img = _to_numpy(render(Tcw))
            _save_png(os.path.join(cam_dir, name), img)
            if stereo_baseline:
                img_r = _to_numpy(render(T_rl @ Tcw))
                _save_png(os.path.join(cam1_dir, name), img_r)
            f.write(f"{ns},{name}\n")
            if verbose and i % 200 == 0:
                print(f"[{seq}] frame {i}/{n_frames}", flush=True)

    ts, gyro, acc = imu_from_trajectory(
        pose_fn, 0.0, duration, imu_hz, noise_gyro, noise_acc)
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x [m s^-2],a_RS_S_y,a_RS_S_z\n")
        for i in range(len(ts)):
            f.write(f"{int(round(ts[i] * 1e9))},"
                    + ",".join(f"{v:.9f}" for v in gyro[i]) + ","
                    + ",".join(f"{v:.9f}" for v in acc[i]) + "\n")

    gt_ts = (np.arange(int(duration * gt_hz)) + 1) / gt_hz
    rows = _gt_rows(pose_fn, gt_ts)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p_RS_R_x [m],p_RS_R_y,p_RS_R_z,"
                "q_RS_w [],q_RS_x,q_RS_y,q_RS_z\n")
        for r in rows:
            f.write(f"{int(round(r[0] * 1e9))},"
                    + ",".join(f"{v:.9f}" for v in r[1:]) + "\n")
    return os.path.join(root, seq)


def write_ev_ethz(root: str, seq: str, scene: Scene, pose_fn,
                  duration: float, fps: float = 24.0, imu_hz: float = 200.0,
                  gt_hz: float = 100.0, sim_hz: float = 150.0,
                  contrast: float = 0.18, noise_gyro: float = 2e-4,
                  noise_acc: float = 2e-3, with_images: bool = True,
                  verbose: bool = True, device=None) -> str:
    """Render + write an EV-ETHZ-layout sequence (seconds; accel-first
    imu.txt like the real dataset). ``device`` is where the dot renderer
    runs (``None``: the card)."""
    seq_root = os.path.join(root, seq)
    img_dir = os.path.join(seq_root, "images")
    os.makedirs(img_dir, exist_ok=True)
    render = _renderer(scene, pose_fn, device)

    if verbose:
        print(f"[{seq}] simulating events at {sim_hz} Hz ...", flush=True)
    ev = simulate_events(render, pose_fn, 0.0, duration,
                         sim_hz=sim_hz, contrast=contrast)
    with open(os.path.join(seq_root, "events.txt"), "w") as f:
        cols = [ev[:, 0].tolist()] + [ev[:, c].astype(np.int64).tolist()
                                      for c in (1, 2, 3)]
        f.writelines(f"{t:.9f} {x} {y} {p}\n" for t, x, y, p in zip(*cols))
    if verbose:
        print(f"[{seq}] {len(ev)} events", flush=True)

    if with_images:
        n_frames = int(duration * fps)
        with open(os.path.join(seq_root, "images.txt"), "w") as f:
            for i in range(n_frames):
                t = (i + 1) / fps
                name = f"images/frame_{i:08d}.png"
                img = _to_numpy(render(np.asarray(pose_fn(t), np.float32)))
                _save_png(os.path.join(seq_root, name), img)
                f.write(f"{t:.9f} {name}\n")

    ts, gyro, acc = imu_from_trajectory(
        pose_fn, 0.0, duration, imu_hz, noise_gyro, noise_acc)
    with open(os.path.join(seq_root, "imu.txt"), "w") as f:
        for i in range(len(ts)):   # EV-ETHZ order: ts ax ay az gx gy gz
            f.write(f"{ts[i]:.9f} "
                    + " ".join(f"{v:.9f}" for v in acc[i]) + " "
                    + " ".join(f"{v:.9f}" for v in gyro[i]) + "\n")

    gt_ts = (np.arange(int(duration * gt_hz)) + 1) / gt_hz
    rows = _gt_rows(pose_fn, gt_ts)
    with open(os.path.join(seq_root, "groundtruth.txt"), "w") as f:
        for r in rows:   # ts tx ty tz qx qy qz qw
            f.write(f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f} {r[3]:.9f} "
                    f"{r[5]:.9f} {r[6]:.9f} {r[7]:.9f} {r[4]:.9f}\n")
    with open(os.path.join(seq_root, "calib.txt"), "w") as f:
        f.write(f"{scene.fx} {scene.fy} {scene.cx} {scene.cy} 0 0 0 0 0\n")
    return seq_root


def write_settings_yaml(path: str, *, fmt: str, root: str, seqs: list,
                        sensor: str, scene: Scene, fps: float,
                        ts_factor: float, n_features: int = 512,
                        extra: Optional[dict] = None) -> str:
    """Emit a run_slam settings YAML in the reference's flat-key format."""
    lines = [
        "%YAML:1.0", "---",
        'DS.name: "synth"',
        f'DS.format: "{fmt}"',
        f'DS.Paths.root: "{root}"',
        "DS.Seq.names:",
    ]
    lines += [f'  - "{s}"' for s in seqs]
    lines += [
        "DS.Seq.target: -1",
        f"DS.tsFactor: {ts_factor}",
        f'DS.Sensor.config: "{sensor}"',
        f"Camera.fx: {scene.fx}",
        f"Camera.fy: {scene.fy}",
        f"Camera.cx: {scene.cx}",
        f"Camera.cy: {scene.cy}",
        "Camera.k1: 0.0", "Camera.k2: 0.0",
        "Camera.p1: 0.0", "Camera.p2: 0.0",
        f"Camera.width: {scene.W}",
        f"Camera.height: {scene.H}",
        f"Camera.fps: {fps}",
        f"ORBextractor.nFeatures: {n_features}",
        "IMU.Frequency: 200.0",
        "IMU.NoiseGyro: 2.0e-4",
        "IMU.NoiseAcc: 2.0e-3",
        "IMU.GyroWalk: 1.9e-5",
        "IMU.AccWalk: 3.0e-3",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


# ------------------------------------------------------------------------ cli


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--kind", choices=["euroc", "ev_ethz"], default="euroc")
    p.add_argument("--seq", default="seq01")
    p.add_argument("--traj", choices=["corridor", "room", "shakes"],
                   default=None)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--size", default=None, help="WxH (default per kind)")
    p.add_argument("--n-dots", type=int, default=6000)
    p.add_argument("--sim-hz", type=float, default=150.0)
    p.add_argument("--contrast", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stereo-baseline", type=float, default=None,
                   help="also render cam1 at this baseline (meters)")
    p.add_argument("--depth", action="store_true",
                   help="also write 16-bit depth PNGs (RGB-D modes)")
    p.add_argument("--device", default=None,
                   help="where the renderers run: default the card (raises "
                        "without one); 'cpu' renders on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.kind == "euroc":
        W, H, fx = 752, 480, 458.0
        fps = args.fps or 20.0
        traj = args.traj or "corridor"
    else:
        W, H, fx = 240, 180, 199.0
        fps = args.fps or 24.0
        traj = args.traj or "shakes"
    if args.size:
        W, H = (int(x) for x in args.size.lower().split("x"))

    scene = make_scene(traj, W, H, fx, n_dots=args.n_dots, seed=args.seed)
    pose_fn = make_trajectory(traj, args.duration)
    if args.kind == "euroc":
        # image-frontend datasets use the dense textured-box renderer
        renderer = make_box_renderer(traj, W, H, fx, seed=args.seed,
                                     device=device)
        out = write_euroc(args.out, args.seq, scene, pose_fn,
                          args.duration, fps=fps, renderer=renderer,
                          stereo_baseline=args.stereo_baseline,
                          write_depth=args.depth, device=device)
    else:
        out = write_ev_ethz(args.out, args.seq, scene, pose_fn,
                            args.duration, fps=fps, sim_hz=args.sim_hz,
                            contrast=args.contrast, device=device)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
