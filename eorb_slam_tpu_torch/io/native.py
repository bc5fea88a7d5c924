"""ctypes bridge to the native C++ fast-I/O library (native/fastio.cpp,
native/evqueue.cpp at the repository root).

The shared library is built on first use with g++ into this package's
``build/`` directory (git-ignored; the file name carries a hash of the
sources and flags, and it is written under a temporary name and renamed, so
parallel processes cannot load a half-written file). ``native/libfastio.so``
belongs to the JAX package and is never touched. Where no toolchain exists
``get_lib`` returns None, ``BUILD_ERROR`` says why, and callers use their
numpy paths: this is host code, no device work depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
BUILD_ERROR: Optional[str] = None

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _build_and_load() -> Optional[ctypes.CDLL]:
    global BUILD_ERROR
    srcs = [os.path.join(NATIVE_DIR, f) for f in ("fastio.cpp", "evqueue.cpp")]
    hdrs = [os.path.join(NATIVE_DIR, "parse_util.h")]
    if not all(os.path.exists(f) for f in srcs + hdrs):
        BUILD_ERROR = f"native sources not found under {NATIVE_DIR}"
        return None
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in srcs + hdrs:
        with open(f, "rb") as fh:
            digest.update(fh.read())
    out = os.path.join(BUILD_DIR, f"libfastio_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, *srcs, "-o", tmp, "-lpthread"]
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=300)
            os.replace(tmp, out)
        except subprocess.CalledProcessError as e:
            BUILD_ERROR = f"g++ failed ({e.returncode}):\n{e.stderr}"
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            BUILD_ERROR = f"could not build {out}: {e}"
            return None
    try:
        return _bind(ctypes.CDLL(out))
    except (OSError, AttributeError) as e:
        BUILD_ERROR = f"could not load {out}: {e}"
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fastio_parse.restype = ctypes.POINTER(ctypes.c_double)
    lib.fastio_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastio_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.fastio_write_tum.restype = ctypes.c_int
    lib.fastio_write_tum.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    dp = ctypes.POINTER(ctypes.c_double)
    lib.evq_create.restype = ctypes.c_void_p
    lib.evq_destroy.argtypes = [ctypes.c_void_p]
    lib.evq_feed.argtypes = [ctypes.c_void_p, dp, ctypes.c_int64]
    lib.evq_size.restype = ctypes.c_int64
    lib.evq_size.argtypes = [ctypes.c_void_p]
    lib.evq_consume.restype = ctypes.c_int64
    lib.evq_consume.argtypes = [ctypes.c_void_p, ctypes.c_int64, dp]
    lib.evq_inject_front.argtypes = [ctypes.c_void_p, dp, ctypes.c_int64]
    lib.evq_pad_rebase.restype = ctypes.c_int64
    lib.evq_pad_rebase.argtypes = [
        dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.evq_stream_file.restype = ctypes.c_int
    lib.evq_stream_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.evq_stream_active.restype = ctypes.c_int
    lib.evq_stream_active.argtypes = [ctypes.c_void_p]
    lib.evq_stream_join.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


def _parse(path: str, mode: int, max_rows: Optional[int]) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None or not os.path.exists(path):
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = lib.fastio_parse(
        path.encode(), mode, -1 if max_rows is None else max_rows,
        ctypes.byref(rows), ctypes.byref(cols),
    )
    if not ptr:
        return None
    try:
        n = rows.value * cols.value
        # from_address + frombuffer is O(1) to create (np.ctypeslib.as_array
        # pays O(n) building the ctypes array type); one copy to own the data.
        buf = (ctypes.c_double * n).from_address(
            ctypes.addressof(ptr.contents)
        )
        return np.frombuffer(buf, dtype=np.float64).reshape(
            rows.value, cols.value
        ).copy()
    finally:
        lib.fastio_free(ptr)


def parse_events(path: str, max_events: Optional[int] = None) -> Optional[np.ndarray]:
    """Whitespace table (events/imu/gt txt) -> float64 (N,4) or None.

    Timestamps MUST stay float64: at ts~100 s float32 quantizes to ~10 us,
    which corrupts t_rel inside millisecond MCI windows (the reference keeps
    EventData::ts double, include/Event/EventData.h:36-58); the window
    builder rebases to float32 only after subtracting the window start."""
    arr = _parse(path, 0, max_events)
    if arr is None:
        return None
    return np.ascontiguousarray(arr[:, :4])


def parse_txt(path: str, max_rows: Optional[int] = None) -> Optional[np.ndarray]:
    return _parse(path, 0, max_rows)


def parse_csv(path: str, max_rows: Optional[int] = None) -> Optional[np.ndarray]:
    return _parse(path, 1, max_rows)


class NativeEventQueue:
    """Native event FIFO + background file streamer (native/evqueue.cpp).

    Runtime replacement for the reference's SharedQueue/EventQueue buffers
    (include/Event/EventData.h:130-139, src/Event/EvTrackManager.cpp:227-258):
    contiguous C++ ring with O(1)-amortized consume and front re-injection,
    and an optional parser thread that streams events.txt into the queue so
    host parsing overlaps device compute. Construct via :func:`make_queue`,
    which returns None when the native library is unavailable (callers fall
    back to the numpy buffer path).
    """

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.evq_create()

    def close(self) -> None:
        if self._h:
            self._lib.evq_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def feed(self, events: np.ndarray) -> None:
        ev = np.ascontiguousarray(events, np.float64)
        if len(ev) == 0:
            return
        assert ev.ndim == 2 and ev.shape[1] == 4
        self._lib.evq_feed(
            self._h, ev.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ev)
        )

    def __len__(self) -> int:
        return int(self._lib.evq_size(self._h))

    def consume(self, n: int) -> np.ndarray:
        out = np.empty((n, 4), np.float64)
        m = self._lib.evq_consume(
            self._h, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )
        return out[:m]

    def inject_front(self, events: np.ndarray) -> None:
        ev = np.ascontiguousarray(events, np.float64)
        if len(ev) == 0:
            return
        self._lib.evq_inject_front(
            self._h, ev.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ev)
        )

    def stream_file(self, path: str, max_rows: Optional[int] = None,
                    block_rows: int = 1 << 16) -> bool:
        rc = self._lib.evq_stream_file(
            self._h, path.encode(), -1 if max_rows is None else max_rows,
            block_rows,
        )
        return rc == 0

    def stream_active(self) -> bool:
        return bool(self._lib.evq_stream_active(self._h))

    def stream_join(self) -> None:
        self._lib.evq_stream_join(self._h)


def make_queue() -> Optional[NativeEventQueue]:
    lib = get_lib()
    if lib is None or not hasattr(lib, "evq_create"):
        return None
    return NativeEventQueue(lib)


def pad_rebase(events: np.ndarray, cap: int, t0: float):
    """Native keep-most-recent-cap + ts-rebase + float32 cast; returns
    (out (cap,4) float32, valid (cap,) bool, n_dropped) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "evq_pad_rebase"):
        return None
    ev = np.ascontiguousarray(events, np.float64)
    out = np.empty((cap, 4), np.float32)
    valid = np.empty(cap, np.uint8)
    drop = lib.evq_pad_rebase(
        ev.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ev), cap,
        float(t0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out, valid.astype(bool), int(drop)


def write_tum(path: str, header: str, data: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    d = np.ascontiguousarray(data, np.float64)
    assert d.ndim == 2 and d.shape[1] == 8
    rc = lib.fastio_write_tum(
        path.encode(), header.encode(),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), d.shape[0],
    )
    return rc == 0
