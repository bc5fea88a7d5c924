"""Atlas: multi-map container for lost-tracking recovery.

PyTorch port of ``eorb_slam_tpu/slam/atlas.py`` (reference Atlas): a list of
MapState values on one device (the card unless ``device`` says otherwise) +
an active index. ``create_new_map`` stores the active map and starts a fresh
one, ``reset_active`` empties it. The Sim3 weld of a stored map into the
active one (``merge``) waits for the place-recognition slice and raises
NotImplementedError.
"""

from __future__ import annotations

from typing import List

from eorb_slam_tpu_torch._host import resolve_device
from eorb_slam_tpu_torch.slam import map_state as ms


class Atlas:
    def __init__(self, K: int = 32, M: int = 4096, N: int = 512, P: int = 8,
                 device=None):
        self.caps = (K, M, N, P)
        self.device = resolve_device(device)
        self.maps: List[ms.MapState] = [ms.empty_map(K, M, N, P, self.device)]
        self.active = 0

    @property
    def current(self) -> ms.MapState:
        return self.maps[self.active]

    @current.setter
    def current(self, m: ms.MapState) -> None:
        self.maps[self.active] = m

    def n_maps(self) -> int:
        return len(self.maps)

    def create_new_map(self) -> ms.MapState:
        """Tracking lost with an established map: keep it, start fresh
        (reference Tracking::CreateMapInAtlas)."""
        self.maps.append(ms.empty_map(*self.caps, self.device))
        self.active = len(self.maps) - 1
        return self.current

    def reset_active(self) -> ms.MapState:
        self.maps[self.active] = ms.empty_map(*self.caps, self.device)
        return self.current

    def merge(self, stored_idx: int, R, t, s) -> ms.MapState:
        raise NotImplementedError(
            "Atlas.merge (the cross-map Sim3 weld) is not ported yet")
