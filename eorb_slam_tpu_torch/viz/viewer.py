"""Headless host visualization: the reference's viewer stack without a GUI
thread.

Port of ``eorb_slam_tpu/viz/viewer.py`` (host code): ``MapDrawer`` renders
the 3D map, keyframes and trajectory (reference src/MapDrawer.cc),
``FrameDrawer`` multi-channel 2D keypoint overlays with per-tracker state
text (src/FrameDrawer.cc, include/Utils/MyFrameDrawer.h), and
``save_image`` the MCI / debug image dumps (include/Utils/Visualization.h).
Figures render to arrays and PNGs through matplotlib's Agg backend, for
notebooks, CI artifacts and offline inspection.

matplotlib is imported by the functions that draw with it, not by this
module: a machine without matplotlib imports the module and uses the PIL
parts (``FrameDrawer``, ``save_image``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ------------------------------------------------------------------ 3D map


class MapDrawer:
    """3D scatter of landmarks + keyframe frusta + trajectory
    (reference MapDrawer::DrawMapPoints/DrawKeyFrames/DrawCurrentCamera)."""

    def __init__(self, kf_size: float = 0.05, point_size: float = 1.0):
        self.kf_size = kf_size
        self.point_size = point_size

    def draw(
        self,
        lm_pos: np.ndarray,                 # (M,3)
        lm_valid: Optional[np.ndarray] = None,
        kf_T: Optional[np.ndarray] = None,  # (K,4,4) Tcw
        n_kf: int = 0,
        kf_slots: Optional[list] = None,    # active slots in temporal order
        trajectory: Optional[list] = None,  # [(ts, Twc)]
        path: Optional[str] = None,
        title: str = "",
    ):
        fig = _pyplot().figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        pts = np.asarray(lm_pos)
        if lm_valid is not None:
            pts = pts[np.asarray(lm_valid)]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=self.point_size,
                       c="k", alpha=0.4, linewidths=0)
        if kf_T is not None and (n_kf > 0 or kf_slots):
            slots = kf_slots if kf_slots is not None else range(n_kf)
            C = []
            for k in slots:
                T = np.asarray(kf_T[k])
                R, t = T[:3, :3], T[:3, 3]
                c = -R.T @ t
                C.append(c)
                self._frustum(ax, R.T, c)
            C = np.stack(C)
            ax.plot(C[:, 0], C[:, 1], C[:, 2], "b-", lw=0.8, alpha=0.7)
        if trajectory:
            P = np.stack([np.asarray(T)[:3, 3] for _, T in trajectory])
            ax.plot(P[:, 0], P[:, 1], P[:, 2], "g-", lw=1.2)
        if title:
            ax.set_title(title)
        ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
        out = _fig_out(fig, path)
        return out

    def _frustum(self, ax, Rwc, c):
        w = self.kf_size
        corners = np.asarray(
            [[w, w * 0.75, w * 2], [-w, w * 0.75, w * 2],
             [-w, -w * 0.75, w * 2], [w, -w * 0.75, w * 2]]
        )
        pts = (Rwc @ corners.T).T + c
        for p in pts:
            ax.plot(*np.stack([c, p]).T, "b-", lw=0.4, alpha=0.6)
        loop = np.concatenate([pts, pts[:1]])
        ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], "b-", lw=0.4, alpha=0.6)

    def draw_slam(self, slam, path: Optional[str] = None, title: str = ""):
        """Convenience over any pipeline exposing .map / .trajectory_twc():
        the map tensors are read to host numpy."""
        m = getattr(slam, "map", None)
        if m is None and hasattr(slam, "l2"):
            return self.draw_slam(slam.l2, path=path, title=title)
        return self.draw(
            m.lm_pos.cpu().numpy(), m.lm_valid.cpu().numpy(),
            m.kf_T.cpu().numpy(), int(getattr(slam, "n_kf", 0)),
            kf_slots=list(getattr(slam, "_kf_order", []) or []) or None,
            trajectory=slam.trajectory_twc(), path=path, title=title,
        )


# ----------------------------------------------------------------- 2D frame


_CHANNEL_COLORS = {
    "orb": (0, 220, 0),
    "l1": (255, 160, 0),
    "l2": (40, 120, 255),
    "event": (40, 120, 255),
}


class FrameDrawer:
    """Multi-channel keypoint overlay (reference MyFrameDrawer: one channel
    per tracker — ORB, L1 event builder, L2 event tracker — each with a
    FrameDrawFilter and a state-text banner)."""

    def __init__(self):
        self._channels: dict = {}

    def update(
        self,
        channel: str,
        img: np.ndarray,                 # (H,W) grayscale, any range
        kp_xy: Optional[np.ndarray] = None,
        kp_valid: Optional[np.ndarray] = None,
        matched: Optional[np.ndarray] = None,  # bool per kp: has map point
        state_text: str = "",
    ):
        self._channels[channel] = dict(
            img=np.asarray(img, np.float32), kp=kp_xy, valid=kp_valid,
            matched=matched, text=state_text,
        )

    def render(self, channel: str) -> np.ndarray:
        """(H,W,3) uint8 overlay for one channel."""
        from PIL import Image, ImageDraw

        ch = self._channels[channel]
        img = ch["img"]
        lo, hi = float(img.min()), float(img.max())
        g = (img - lo) / (hi - lo) * 255.0 if hi > lo else img * 0
        rgb = Image.fromarray(g.astype(np.uint8), "L").convert("RGB")
        dr = ImageDraw.Draw(rgb)
        color = _CHANNEL_COLORS.get(channel.lower(), (0, 220, 0))
        kp = ch["kp"]
        if kp is not None:
            kp = np.asarray(kp)
            valid = (
                np.asarray(ch["valid"])
                if ch["valid"] is not None
                else np.ones(len(kp), bool)
            )
            matched = (
                np.asarray(ch["matched"])
                if ch["matched"] is not None
                else np.ones(len(kp), bool)
            )
            for (x, y), v, m in zip(kp, valid, matched):
                if not v:
                    continue
                r = 3 if m else 2
                c = color if m else (160, 160, 160)
                dr.ellipse([x - r, y - r, x + r, y + r], outline=c)
        if ch["text"]:
            dr.text((4, 2), ch["text"], fill=(255, 255, 60))
        return np.asarray(rgb)

    def render_all(self, path: Optional[str] = None) -> np.ndarray:
        """Stack all channels vertically (the reference tiles channels in
        one window)."""
        frames = [self.render(c) for c in self._channels]
        W = max(f.shape[1] for f in frames)
        frames = [
            np.pad(f, ((0, 0), (0, W - f.shape[1]), (0, 0))) for f in frames
        ]
        out = np.concatenate(frames, axis=0)
        if path:
            from PIL import Image

            Image.fromarray(out).save(path)
        return out


# ----------------------------------------------------------- trajectory viz


def plot_trajectories(
    trajs: dict,                      # name -> [(ts, Twc)]
    path: Optional[str] = None,
    axes: tuple = (0, 1),
    title: str = "",
):
    """2D top-down comparison plot (the evaluation suite's plot_traj)."""
    fig, ax = _pyplot().subplots(figsize=(6, 6))
    i, j = axes
    for name, tr in trajs.items():
        if not tr:
            continue
        P = np.stack([np.asarray(T)[:3, 3] for _, T in tr])
        ax.plot(P[:, i], P[:, j], label=name, lw=1.2)
    ax.set_aspect("equal")
    ax.legend()
    if title:
        ax.set_title(title)
    ax.set_xlabel("xyz"[i]), ax.set_ylabel("xyz"[j])
    return _fig_out(fig, path)


def save_image(img: np.ndarray, path: str):
    """MCI / debug image dump (reference Visualization::saveImage)."""
    from PIL import Image

    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    g = (img - lo) / (hi - lo) * 255.0 if hi > lo else img * 0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(g.astype(np.uint8), "L").save(path)


def _fig_out(fig, path: Optional[str]) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=110, bbox_inches="tight")
    _pyplot().close(fig)
    return buf
