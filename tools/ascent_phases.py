"""Where one call of the ascent kernel spends its time, phase by phase, on
the card.

Builds a copy of ``eorb_slam_tpu_torch/csrc/splat.cu`` with clock64()
counters between the phases of ``splat_ascent_kernel`` (thread 0 of every
block adds the cycles since the last mark to its phase), runs one
``contrast_max.maximize_rt2d``-shaped call through it at 16,384 and 65,536
events (chip_smoke.py's ``_se2_events``, 40 steps), and prints the
microseconds per call of each phase, block 0's and the largest over the
cluster's blocks: the cycles converted at the rate of block 0's cycles per
microsecond of the call's own time (CUDA events). The counters cost little
beside the phases they time (compare the call's time with chip_smoke.py's
device time of the uninstrumented kernel). A barrier's wait lands in the
phase that ends at it; the set-up before the first step (the events' bulk
copies, the first warp, scatter and moments) lands in "set-up + decision".

    python3 tools/ascent_phases.py        # on a machine with an H100

The copy and its library go into eorb_slam_tpu_torch/build/ (git-ignored).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("warp + zero", "barrier", "scatter", "moments", "gradient", "step",
          "set-up + decision")
# (where in the kernel's source, the mark inserted before it); a mark adds
# the cycles since the previous mark to its phase
_MARKS = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n  const int rank",
     "  long long prof_t = clock64();\n"),
    ("    if (changed) {   // the current point's", "    PHASE_MARK(6);\n"),
    ("      changed = false;\n", None),
    ("    flags = ascent_warp(ev, cnt, xw_s, aux_s, a);\n", "    PHASE_MARK(5);\n"),
    ("    cluster.sync();   // every block's warped events and zeroed band\n    band.band = trial;",
     "    PHASE_MARK(0);\n"),
    ("    band.band = trial;\n", "    PHASE_MARK(1);\n"),
    ("    const Moments tm = ascent_moments(", "    PHASE_MARK(2);\n"),
    ("    if (trace) {\n      float* row", "    PHASE_MARK(3);\n"),
]


def instrumented(src: str) -> str:
    """splat.cu with the phase counters and a C entry that reads them."""
    head = ("namespace {\n__device__ unsigned long long g_phase[32][8];\n"
            "#define PHASE_MARK(ph) do { if (threadIdx.x == 0) { const long long c_ = clock64(); "
            "g_phase[cg::this_cluster().block_rank()][ph] += c_ - prof_t; prof_t = c_; } } "
            "while (0)\n")
    src = src.replace("namespace {\n", head, 1)
    k0 = src.index("__global__ void __launch_bounds__(kAscentThreads, 1) splat_ascent_kernel")
    body = src[k0:]
    for anchor, mark in _MARKS:
        if anchor not in body:
            raise RuntimeError(f"splat.cu changed: no {anchor.strip()!r} to mark")
        if mark is None:   # the gradient ends where `changed` is cleared
            body = body.replace(anchor, anchor + "      PHASE_MARK(4);\n", 1)
        else:
            body = body.replace(anchor, mark + anchor, 1)
    return src[:k0] + body + (
        '\nextern "C" int phase_read(void* host) {\n'
        "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n"
        'extern "C" int phase_zero() {\n  static unsigned long long z[32][8];\n'
        "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("ascent_phases: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from eorb_slam_tpu_torch import _build
    from eorb_slam_tpu_torch.event import contrast_max
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "splat_phases.cu")
    so = os.path.join(_build.BUILD_DIR, "libsplat_phases.so")
    with open(os.path.join(_build.SRC_DIR, "splat.cu")) as f:
        src = instrumented(f.read())
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    fwd, vjp, _, threads = hs._kernels()
    asc = lib.splat_ascent_se2
    asc.restype, asc.argtypes = ctypes.c_int, hs._kernels()[2].argtypes
    print(f"gpu: {cs._gpu_line()}")
    saved = hs._kernels
    hs._kernels = lambda: (fwd, vjp, asc, threads)
    try:
        z = torch.zeros(3, device="cuda")
        for n in cs.ASCENT_NS:
            xy, t, valid, _ = cs._se2_events(n, seed=3)
            run = lambda: contrast_max._ascent_kernel(xy, t, valid, cs.H, cs.W, z, cs.CM_ITERS,
                                                      cs.SIGMA, 1.0)
            run()
            torch.cuda.synchronize()
            lib.phase_zero()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            call_us = 1e3 * a.elapsed_time(b)
            buf = (ctypes.c_ulonglong * 256)()
            lib.phase_read(buf)
            cycles = np.asarray(buf, dtype=np.float64).reshape(32, 8)[:hs.ASCENT_CLUSTER]
            us = cycles * call_us / cycles[0].sum()
            print(f"N={n}, {cs.CM_ITERS} steps, one call {call_us:.0f} us by events at "
                  f"{cycles[0].sum() / call_us:.0f} cycles/us; us per call by phase (block 0 / "
                  "largest over the blocks): "
                  + ", ".join(f"{name} {us[0, j]:.0f} / {us[:, j].max():.0f}"
                              for j, name in enumerate(PHASES)))
    finally:
        hs._kernels = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
