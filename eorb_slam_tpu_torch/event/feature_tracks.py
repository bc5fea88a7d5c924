"""Fixed-capacity persistent feature tracks (KLT-carried, landmark-linked).

PyTorch port of ``eorb_slam_tpu/event/feature_tracks.py`` (reference
FeatureTrack, the backbone of the continuous event tracker
EvAsynchTrackerU). A track owns one slot for its whole life, and the slot
index is the feature index in every keyframe it appears in: two keyframes'
feature arrays are ALIGNED by construction, so triangulation needs no
descriptor matching ("the same row of consecutive kf_xy arrays").

``advance`` and ``top_up`` are graph runners, the reference's jits: on the
card each call is one CUDA-graph replay per key (the store's capacity and
the image size are shapes; the KLT and detector settings are static).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eorb_slam_tpu_torch import _graphs
from eorb_slam_tpu_torch.event import klt
from eorb_slam_tpu_torch.ops import fast
from eorb_slam_tpu_torch.slam.map_state import scatter_set_last


class TrackStore(NamedTuple):
    xy: torch.Tensor        # (T,2) current position
    valid: torch.Tensor     # (T,) alive
    lm: torch.Tensor        # (T,) int32 attached landmark or -1
    age: torch.Tensor       # (T,) int32 images survived
    birth_kf: torch.Tensor  # (T,) int32 keyframe sequence id at (re)birth, -1 = none
    desc_pm1: torch.Tensor  # (T,256) int8 descriptor at birth
    quality: torch.Tensor   # (T,) float32 KLT NCC of the last advance

    @property
    def T(self):
        return self.xy.shape[0]


def empty_tracks(T: int, device=None) -> TrackStore:
    """``T`` dead slots on ``device`` (the caller's: None is the CPU, as
    for a tensor factory)."""
    i32 = torch.int32
    return TrackStore(
        xy=torch.zeros((T, 2), dtype=torch.float32, device=device),
        valid=torch.zeros(T, dtype=torch.bool, device=device),
        lm=torch.full((T,), -1, dtype=i32, device=device),
        age=torch.zeros(T, dtype=i32, device=device),
        birth_kf=torch.full((T,), -1, dtype=i32, device=device),
        desc_pm1=torch.zeros((T, 256), dtype=torch.int8, device=device),
        quality=torch.ones(T, dtype=torch.float32, device=device),
    )


def _advance(
    tr: TrackStore,
    img_prev: torch.Tensor,
    img_cur: torch.Tensor,
    guess_xy: torch.Tensor = None,   # (T,2) predicted positions (optional)
    win: int = 11,
    levels: int = 3,
    iters: int = 8,
    min_ncc: float = 0.4,
):
    """KLT-advance every live track into the current image
    (trackLastFeatures). Returns (TrackStore, median displacement of the
    surviving tracks as a device scalar)."""
    res = klt.track(img_prev, img_cur, tr.xy, tr.valid, guess=guess_xy,
                    win=win, levels=levels, iters=iters, min_ncc=min_ncc)
    med = klt.median_displacement(res, tr.xy)
    tr = tr._replace(
        xy=torch.where(res.ok[:, None], res.xy, tr.xy),
        valid=tr.valid & res.ok,
        age=tr.age + res.ok.to(torch.int32),
        quality=torch.where(res.ok, torch.clamp(res.ncc, 0.0, 1.0), tr.quality),
    )
    return tr, med


def _top_up(
    tr: TrackStore,
    img: torch.Tensor,
    min_dist: float = 8.0,
    threshold: float = 0.08,
    cell: int = 24,
    per_cell: int = 2,
    max_new: int = 128,
    border: int = 6,
):
    """Detect grid-uniform FAST corners and seed them into dead slots,
    skipping detections near live tracks (detectAndFuseNewFeatures /
    selectNewKPtsUniform). New tracks carry lm = -1 and birth_kf = -1 until
    a keyframe adopts them. Returns (TrackStore, number seeded as a device
    scalar)."""
    xy_new, _, v_new = fast.detect_grid(
        img, threshold=threshold, min_threshold=threshold / 3.0,
        cell=cell, per_cell=per_cell, max_kp=max_new, border=border,
    )
    # suppress candidates near existing live tracks
    d2 = torch.sum((xy_new[:, None, :] - tr.xy[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(tr.valid[None, :], d2, torch.inf)
    v_new = v_new & (torch.min(d2, dim=1).values >= min_dist ** 2)

    # prefix-sum allocation of accepted candidates into dead slots
    i32 = torch.int32
    dev = tr.xy.device
    Tcap = tr.T
    free = ~tr.valid
    free_rank = torch.cumsum(free.to(i32), 0, dtype=i32) - 1
    n_free = free.sum(dtype=i32)
    cand_rank = torch.cumsum(v_new.to(i32), 0, dtype=i32) - 1
    take = v_new & (cand_rank < n_free)
    # rank -> slot: the free slots scatter their index to their rank, the
    # live ones to the last rank, last write winning (as the reference's
    # XLA scatter does on the CPU)
    slot_of_rank = scatter_set_last(
        torch.zeros(Tcap, dtype=i32, device=dev),
        torch.where(free, free_rank, Tcap - 1),
        torch.arange(Tcap, dtype=i32, device=dev))
    slot = torch.where(take, slot_of_rank[torch.clamp(cand_rank, 0, Tcap - 1).long()],
                       0).long()

    def put(t, v):
        return scatter_set_last(t, slot, torch.where(
            take.view((-1,) + (1,) * (t.dim() - 1)), v, t[slot]))

    tr = tr._replace(
        xy=put(tr.xy, xy_new),
        valid=put(tr.valid, torch.ones_like(take)),
        lm=put(tr.lm, torch.full_like(slot, -1, dtype=i32)),
        age=put(tr.age, torch.zeros_like(slot, dtype=i32)),
        birth_kf=put(tr.birth_kf, torch.full_like(slot, -1, dtype=i32)),
        quality=put(tr.quality, torch.ones_like(xy_new[:, 0])),
    )
    return tr, take.sum(dtype=i32)


# the reference's two jits, each one dispatch on the card
advance = _graphs.GraphRunner(_advance, static=("win", "levels", "iters", "min_ncc"))
top_up = _graphs.GraphRunner(_top_up, static=(
    "min_dist", "threshold", "cell", "per_cell", "max_new", "border"))
