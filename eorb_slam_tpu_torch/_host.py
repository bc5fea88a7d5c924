"""Host-side helpers: which device an entry point runs on, and
device-to-host copies that overlap with later work.

The port's entry points (EventWindowBuilder, MonoSlam, EventSlam, Atlas) run
on the card unless the caller asks for the CPU: ``resolve_device(None)`` is
``cuda``, and raises where there is none rather than carrying on on the CPU.

A small tensor the host reads later (a window's metadata, a mapping step's
stats) is copied into pinned host memory with ``non_blocking=True`` and a
CUDA event is recorded behind the copy; the host reads it once that event
has completed, without stalling the device queue in between. A CPU tensor
is its own copy.

Constants go the other way without a copy: ``torch.tensor(..., device=
cuda)`` copies from pageable host memory and drains the stream first, so a
Python number becomes a device scalar by a fill (``scalar``) and a small
fixed table is copied once per device, from pinned memory without
blocking, and cached (``constant``).
"""

from __future__ import annotations

import functools
import numbers

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless "
            "asked otherwise (pass device='cpu' to run on the CPU)")
    return torch.device("cuda")


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array (e.g. a uint8 frame) -> tensor on ``device``. For the
    card the array is staged in pinned memory and copied without blocking,
    so the host goes on while the transfer runs; the consumer casts on the
    device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype on ``like``'s device, with the
    values ``torch.as_tensor(x, dtype=, device=)`` gives. A Python number is
    filled in on the device (no host-to-device copy); a tensor is moved or
    cast as ``as_tensor`` would."""
    if isinstance(x, numbers.Number):
        return torch.full((), x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The constant ``torch.tensor(values, dtype=dtype)`` on ``device``,
    copied there once and cached: later calls copy nothing. The one copy to
    the card goes from pinned memory without blocking, so even a first use
    does not wait for the device queue. Shared by every caller, so never
    written in place."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """The copy of ``t`` to the host, started now and read later."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = t, None

    def ready(self) -> bool:
        """Has the copy landed (never waits)?"""
        return self.done is None or self.done.query()

    def numpy(self) -> np.ndarray:
        """The host value; waits for the copy if it is still in flight."""
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()
