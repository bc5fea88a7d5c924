"""The port's counterpart of ``jax.jit``: a step captured once per key as a
CUDA graph and replayed, one dispatch per call.

The JAX package compiles each per-step unit of its main path (the L1
window, the tracked image frame, local BA's LM loop, the keyframe mapping
step, the tracked inertial frame, VI-BA's LM loop, the synchronized MCI's
candidates, the continuous tracker's chunk step, track advance and top-up,
the pose-only solve, EVENT_MONO's joint steps) into one executable per
key of static arguments and runs it as one dispatch. Run eagerly, the
same step is thousands of kernel launches, each costing the host more time
than the card spends on it. :class:`GraphRunner` wraps such a step: on the
card it captures the step once per key into a CUDA graph and then replays
it, so a call costs the host a few copies and one graph launch.

The key is the device, every input tensor's shape, strides and dtype, the
structure of the inputs, and the values of the step's static arguments
(the ``static_argnames`` of ``jax.jit``). Every other input must be a
tensor, or a tuple, list or ``NamedTuple`` of tensors (``None``
allowed): a Python number there is refused, never baked into a graph.

For each key the runner keeps:

- static input buffers, into which each call copies its tensors on the
  stream (one device-to-device copy each). A step that writes one of its
  inputs in place is refused at capture: a replay would write the static
  buffer, not the caller's tensor.
- the graph's static outputs. After each replay they are cloned out (one
  device-to-device copy each), so no caller ever holds a static buffer: a
  caller may keep one call's outputs while it makes the next call.
- the kernel launches counted while the step was captured. The hand
  kernels' wrappers count their launches in Python (:func:`counted`), and a
  replay runs no Python, so each replay adds the counts seen at capture and
  the capture itself counts nothing.

A runner called while another runner captures (local BA's LM loop inside
the keyframe mapping step) runs its function inline, as a jitted function
called inside a jitted one is inlined: it warms nothing up, copies into no
buffer of its own and neither captures nor replays, and its kernels'
launches count once, in the outer graph's counts. So does a runner called
on tensors that ``torch.func`` transforms (the batched searches under
``vmap``).

A key is captured only on its second call: the first runs eagerly, which
builds every per-device constant and table cache the step uses (a cached
constant first made inside a capture would be copied from host memory freed
before the replay). All of a runner's graphs allocate from one private
memory pool. A call whose tensors lie on the CPU runs the eager function
(what the CPU parity tests run); a capture that fails raises, and nothing
falls back to the eager path on the card.
"""

from __future__ import annotations

import contextlib
import inspect
import numbers
import time

import torch

# (object, attribute) launch counters that a replay advances: an int, or a
# dict of ints (launches by size)
_COUNTERS: list = []


def counted(obj, *attrs: str) -> None:
    """Declare ``obj.<attr>`` (for each of ``attrs``) a launch counter that
    a kernel wrapper advances in Python where it launches its kernel."""
    _COUNTERS.extend((obj, a) for a in attrs)


def _snapshot() -> list:
    return [dict(v) if isinstance(v, dict) else v
            for v in (getattr(o, a) for o, a in _COUNTERS)]


def _restore(snap: list) -> None:
    for (o, a), v in zip(_COUNTERS, snap):
        setattr(o, a, dict(v) if isinstance(v, dict) else v)


def _delta(before: list, after: list) -> list:
    out = []
    for b, a in zip(before, after):
        if isinstance(a, dict):
            out.append({k: c - b.get(k, 0) for k, c in a.items() if c != b.get(k, 0)})
        else:
            out.append(a - b)
    return out


def _advance(delta: list) -> None:
    for (o, a), d in zip(_COUNTERS, delta):
        if isinstance(d, dict):
            cur = getattr(o, a)
            for k, c in d.items():
                cur[k] = cur.get(k, 0) + c
        elif d:
            setattr(o, a, getattr(o, a) + d)


# captures in progress: a runner called inside one runs its function inline
_capturing = 0


@contextlib.contextmanager
def capturing():
    """The span of a capture: every runner called inside it runs inline."""
    global _capturing
    _capturing += 1
    try:
        yield
    finally:
        _capturing -= 1


def _nested() -> bool:
    """Is a capture in progress (a runner's, or any on the current CUDA
    stream)?"""
    return _capturing > 0 or (torch.cuda.is_initialized()
                              and torch.cuda.is_current_stream_capturing())


# ------------------------------------------------------------- input trees

def _flatten(x, leaves: list, where: str):
    """The structure of ``x`` with its tensors appended to ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return True
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x), tuple(_flatten(v, leaves, f"{where}.{f}")
                               for f, v in zip(x._fields, x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, f"{where}[{i}]")
                               for i, v in enumerate(x)))
    if isinstance(x, numbers.Number):
        raise TypeError(f"{where} is the Python number {x!r}, which is not in the "
                        f"graph's key: pass it as a tensor or declare it static")
    raise TypeError(f"{where} is a {type(x).__name__}: a graph's inputs are tensors, "
                    f"None and tuples, lists or NamedTuples of them")


def _unflatten(spec, it):
    if spec is True:
        return next(it)
    if spec is None:
        return None
    typ, parts = spec
    vals = [_unflatten(s, it) for s in parts]
    return typ(*vals) if hasattr(typ, "_fields") else typ(vals)


# ------------------------------------------------------------------ graphs

class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` as the runner drives it: ``capture``
    runs a callable under capture into a memory pool and returns its
    outputs, ``replay`` launches the graph on the current stream. The
    captured ``cudaGraph_t`` is kept beside its instantiation
    (``raw_graph``), so that a check can list the kernels a replay
    launches."""

    device_type = "cuda"

    def __init__(self):
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    def capture(self, fn, pool):
        with torch.cuda.graph(self._graph, pool=pool):
            out = fn()
        self._graph.instantiate()
        return out

    def raw_graph(self) -> int:
        """The captured ``cudaGraph_t``."""
        return self._graph.raw_cuda_graph()

    def replay(self) -> None:
        self._graph.replay()


class _Entry:
    """One key's graph, its static buffers and its capture-time counts."""

    def __init__(self, graph, bufs, outs, out_spec, counts):
        self.graph, self.bufs = graph, bufs
        self.outs, self.out_spec, self.counts = outs, out_spec, counts


class GraphRunner:
    """``fn`` captured once per key and replayed (see the module notes).
    ``static`` names ``fn``'s arguments that belong to the key; the others
    must hold only tensors. Called inside another runner's capture, it
    runs ``fn`` inline. ``graph_cls`` makes the graphs (``CudaGraph``:
    ``torch.cuda.CUDAGraph``); calls whose tensors lie on another device
    type than its ``device_type`` run ``fn`` eagerly. ``fn`` stays callable
    as ``runner.fn``."""

    def __init__(self, fn, static=(), graph_cls=CudaGraph):
        self.fn = fn
        self._sig = inspect.signature(fn)
        for p in self._sig.parameters.values():
            if p.kind not in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                raise TypeError(f"{fn.__qualname__}: a graph takes named arguments, "
                                f"not {p}")
        unknown = set(static) - set(self._sig.parameters)
        if unknown:
            raise TypeError(f"{fn.__qualname__} has no arguments {sorted(unknown)}")
        self.static = tuple(n for n in self._sig.parameters if n in static)
        self._graph_cls = graph_cls
        self._pool = None
        self._entries: dict = {}
        self._warm: set = set()
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.__name__ = fn.__name__

    @property
    def pool(self):
        """The graphs' private memory pool (None before the first capture)."""
        return self._pool

    @property
    def keys(self) -> int:
        return len(self._entries)

    def __call__(self, *args, **kwargs):
        if _nested():
            return self.fn(*args, **kwargs)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = bound.arguments
        names = [n for n in arguments if n not in self.static]
        leaves: list = []
        spec = tuple(_flatten(arguments[n], leaves, n) for n in names)
        if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in leaves):
            # under torch.func.vmap (a batch of searches) the step runs
            # inline, as a jitted function does under jax.vmap
            return self.fn(*args, **kwargs)
        devices = {t.device for t in leaves}
        if not any(d.type == self._graph_cls.device_type for d in devices):
            return self.fn(*args, **kwargs)
        if len(devices) != 1:
            raise ValueError(f"{self.__name__}: inputs on {sorted(map(str, devices))}; "
                             f"a graph's tensors lie on one device")
        key = (devices.pop(), tuple(arguments[n] for n in self.static), spec,
               tuple((t.shape, t.stride(), t.dtype) for t in leaves))
        entry = self._entries.get(key)
        if entry is None:
            if key not in self._warm:
                self._warm.add(key)
                return self.fn(*args, **kwargs)
            entry = self._capture(key, leaves, names, spec, arguments)
        else:
            for buf, src in zip(entry.bufs, leaves):
                buf.copy_(src)
        entry.graph.replay()
        _advance(entry.counts)
        self.replays += 1
        return _unflatten(entry.out_spec, (t.clone() for t in entry.outs))

    def _capture(self, key, leaves, names, spec, arguments) -> _Entry:
        bufs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
                for t in leaves]
        for b, t in zip(bufs, leaves):
            b.copy_(t)
        it = iter(bufs)
        call = {n: _unflatten(s, it) for n, s in zip(names, spec)}
        call.update((n, arguments[n]) for n in self.static)
        if self._pool is None:
            self._pool = self._graph_cls.new_pool()
        graph = self._graph_cls()
        before = _snapshot()
        vers = [b._version for b in bufs]
        t0 = time.perf_counter()
        with capturing():
            out = graph.capture(lambda: self.fn(**call), self._pool)
        self.capture_s += time.perf_counter() - t0
        counts = _delta(before, _snapshot())
        _restore(before)
        written = [i for i, (b, v) in enumerate(zip(bufs, vers)) if b._version != v]
        if written:
            raise ValueError(f"{self.__name__} writes its inputs {written} in place: a "
                             f"replay would not write the caller's tensors")
        outs: list = []
        out_spec = _flatten(out, outs, f"{self.__name__}'s output")
        entry = _Entry(graph, bufs, outs, out_spec, counts)
        self._entries[key] = entry
        self.captures += 1
        return entry
