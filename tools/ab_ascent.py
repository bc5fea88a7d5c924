"""Parent against change: the contrast-maximization ascent kernel of a parent
checkout and of this tree, on the same events, in turns, on the card.

    python3 tools/ab_ascent.py <parent checkout root>   # on a machine with an H100

Builds the parent's ``eorb_slam_tpu_torch/csrc/splat.cu`` with this tree's
nvcc flags into ``eorb_slam_tpu_torch/build/`` (git-ignored), beside this
tree's build, and loads the parent's ``ops/hopper_splat.py`` as a module of
its own, bound to that library, so each kernel runs behind its own wrapper
(its own layout and C entry). Then, on ``chip_smoke._se2_events(n,
seed=3)`` at the ascent's two call-site shapes (16,384 and 65,536 events;
40 steps, as ``contrast_max.maximize_rt2d`` calls it), it times parent,
change, change, parent: device µs per call by CUDA-graph replay and by CUDA
events around eager calls. It fails unless the two kernels' start contrasts
``c0`` have the same bits (their images are the same fixed-point sums), and
prints the card's name and power limit. The empty window (16 events, one
block's worth) is timed the same way: the floor of 41 steps of barriers.

Make the parent checkout with ``git archive <commit> | tar -x -C <dir>``
inside a directory that ``.gitignore`` lists (``results/parent``), so that
it travels with the working tree to the machine with the card and stays
out of commits.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NS = (16, 16384, 65536)
ORDER = ("parent", "change", "change", "parent")


def _build_parent(parent: str):
    """Start nvcc on the parent's splat.cu; returns (process, library path)."""
    from eorb_slam_tpu_torch import _build

    src = os.path.join(parent, "eorb_slam_tpu_torch", "csrc", "splat.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"libsplat_parent_{digest[:16]}.so")
    if os.path.exists(so):
        return None, so
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def _parent_module(parent: str, so: str):
    """The parent's ops/hopper_splat.py as the module ``parent_hopper_splat``,
    its kernels bound to the parent's library."""
    from eorb_slam_tpu_torch import _build

    path = os.path.join(parent, "eorb_slam_tpu_torch", "ops", "hopper_splat.py")
    spec = importlib.util.spec_from_file_location("parent_hopper_splat", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(so)
    try:
        mod._kernels()          # cached: every later call returns this binding
    finally:
        _build.load = load
    return mod


def _bits(x: torch.Tensor) -> int:
    return int(x.reshape(1).view(torch.int32).item())


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_ascent: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from eorb_slam_tpu_torch.event import contrast_max
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    parent = os.path.abspath(argv[0])
    proc, so = _build_parent(parent)
    hs.build()
    if proc is not None and proc.wait() != 0:
        raise RuntimeError(f"nvcc failed on the parent's splat.cu:\n{proc.stdout.read()}")
    pm = _parent_module(parent, so)
    gpu = cs._gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"change: {hs.ascent_attrs()}", flush=True)

    center = (cs.W / 2.0, cs.H / 2.0)
    z = torch.zeros(3, device="cuda")
    result = {}
    for n in NS:
        xy, t, valid, _ = cs._se2_events(n, seed=3)
        calls = {k: (lambda m=m: m.splat_ascent_se2(xy, t, valid, z, center, cs.H, cs.W,
                                                     cs.CM_ITERS, cs.SIGMA,
                                                     contrast_max._TRUNC, 1.0))
                 for k, m in (("parent", pm), ("change", hs))}
        outs = {k: f() for k, f in calls.items()}
        torch.cuda.synchronize()
        c0 = {k: o[2] for k, o in outs.items()}
        if _bits(c0["parent"]) != _bits(c0["change"]):
            raise RuntimeError(f"N={n}: start contrasts differ: parent {float(c0['parent'])!r}, "
                               f"change {float(c0['change'])!r}")
        dev = {k: [] for k in calls}
        ev = {k: [] for k in calls}
        for k in ORDER:
            dev[k].append(1e3 * cs._device_ms(calls[k], reps=10, trials=3))
            ev[k].append(1e3 * cs._time_ms(calls[k], reps=5, trials=3))
        med = {k: (float(np.median(dev[k])), float(np.median(ev[k]))) for k in calls}
        result[n] = med
        print(f"N={n}: c0 {float(c0['change']):.9g} the same bits in both; best contrast "
              f"parent {float(outs['parent'][1]):.9g}, change {float(outs['change'][1]):.9g}; "
              f"params parent {outs['parent'][0].tolist()}, change {outs['change'][0].tolist()}",
              flush=True)
        print(f"N={n}: device us by graph replay, turns {ORDER}: "
              + ", ".join(f"{k} {[round(v, 1) for v in dev[k]]}" for k in calls)
              + f"; by events: " + ", ".join(f"{k} {[round(v, 1) for v in ev[k]]}"
                                            for k in calls)
              + f"; median parent {med['parent'][0]:.1f} / {med['parent'][1]:.1f}, change "
              f"{med['change'][0]:.1f} / {med['change'][1]:.1f} us, parent / change "
              f"{med['parent'][0] / med['change'][0]:.2f}x (replay), "
              f"{med['parent'][1] / med['change'][1]:.2f}x (events)", flush=True)
    slower = [n for n in NS[1:] if not result[n]["change"][0] < result[n]["parent"][0]]
    print(f"gpu: {gpu}", flush=True)
    if slower:
        print(f"ab_ascent: the change is not faster at N = {slower}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
