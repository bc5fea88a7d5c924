"""Where one call of the ascent kernel spends its time, phase by phase, on
the card.

Builds ``eorb_slam_tpu_torch/csrc/splat.cu`` with ``-DASCENT_PHASES``: its
``ASCENT_MARK`` points then make thread 0 of every block add the cycles
since its last mark to the mark's phase (``g_phase``, read through the C
entry ``ascent_phase_read``). It runs one ``contrast_max.maximize_rt2d``-shaped
call through that build at 16,384 and 65,536 events (chip_smoke.py's
``_se2_events``, 40 steps) and prints the microseconds per call of each
phase, block 0's and the largest over the cluster's blocks: the cycles
converted at the rate of block 0's cycles per microsecond of the call's own
time (CUDA events). A barrier's wait lands in the phase that ends at it;
"find + copy" is a pass's compaction (the band codes read through the
cluster, the scan, the listed events' records copied in), "taps" its
scatter or gather over the list. The marks lengthen a call by ~15% at
16,384 events and ~2% at 65,536 on an NVIDIA H100 80GB HBM3 at 700 W
(compare the call's time with chip_smoke.py's device time of the
uninstrumented kernel).

    python3 tools/ascent_phases.py        # on a machine with an H100

The library goes into eorb_slam_tpu_torch/build/ (git-ignored).
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

# csrc/splat.cu's ASCENT_MARK phases, in their order (kAscentPhases)
PHASES = ("warp", "barrier after the warp", "scatter: find + copy", "scatter: taps",
          "moments + f32 image", "gather: copy", "gather: taps", "sums + stores",
          "barrier after the sums", "step + zero", "set-up + decision")


def main() -> int:
    if not torch.cuda.is_available():
        print("ascent_phases: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from eorb_slam_tpu_torch import _build
    from eorb_slam_tpu_torch.event import contrast_max
    from eorb_slam_tpu_torch.ops import hopper_splat as hs

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libsplat_phases.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DASCENT_PHASES", "-o", so,
                           os.path.join(_build.SRC_DIR, "splat.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    kernels = hs._kernels()
    asc = lib.splat_ascent_se2
    asc.restype, asc.argtypes = ctypes.c_int, kernels[2].argtypes
    print(f"gpu: {cs._gpu_line()}")
    saved = hs._kernels
    hs._kernels = lambda: (*kernels[:2], asc, *kernels[3:])
    cluster, nph = hs.ASCENT_CLUSTER, len(PHASES)
    try:
        z = torch.zeros(3, device="cuda")
        for n in cs.ASCENT_NS:
            xy, t, valid, _ = cs._se2_events(n, seed=3)
            run = lambda: contrast_max._ascent_kernel(xy, t, valid, cs.H, cs.W, z, cs.CM_ITERS,
                                                      cs.SIGMA, 1.0)
            run()
            torch.cuda.synchronize()
            lib.ascent_phase_zero()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            call_us = 1e3 * a.elapsed_time(b)
            buf = (ctypes.c_ulonglong * (cluster * nph))()
            lib.ascent_phase_read(buf)
            cycles = np.asarray(buf, dtype=np.float64).reshape(cluster, nph)
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
