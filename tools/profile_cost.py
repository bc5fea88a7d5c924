"""What chip_smoke.py's measuring costs on the card: torch.profiler with CPU
and CUDA activity against CUDA activity alone (launches and device time
seen, profiled run, ``key_averages``), and the blocking-read counter
(``chip_smoke._Syncs``) against plain reads. The workload is three
``frontend.extract`` calls on one 752x480 image, twice per setting.

    python3 tools/profile_cost.py        # needs a CUDA device
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import eorb_slam_tpu_torch  # noqa: E402,F401
from eorb_slam_tpu_torch.ops import frontend  # noqa: E402


def _profiled(work, acts):
    from torch.autograd import DeviceType
    from torch.profiler import profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as p:
        work()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    per = {}
    for e in p.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            per[e.key] = (e.count, float(us if us is not None else e.self_cuda_time_total))
    return per, t1 - t0, time.perf_counter() - t1


def main():
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profile_cost: no CUDA device visible", file=sys.stderr)
        return 1
    print("gpu:", cs._gpu_line(), flush=True)
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((480, 752)) * 255).astype(np.uint8)).cuda()

    def work():
        return [frontend.extract(img, max_kp=512) for _ in range(3)]

    work()
    torch.cuda.synchronize()
    for _ in range(2):
        for acts, name in (([ProfilerActivity.CPU, ProfilerActivity.CUDA], "cpu+cuda"),
                           ([ProfilerActivity.CUDA], "cuda")):
            per, t_run, t_avg = _profiled(work, acts)
            print(f"{name}: {sum(c for c, _ in per.values())} launches, "
                  f"{sum(u for _, u in per.values()) / 1e3:.3f} ms device, {len(per)} names; "
                  f"profiled run {t_run:.2f} s, key_averages {t_avg:.2f} s", flush=True)
    t0 = time.perf_counter()
    work()
    torch.cuda.synchronize()
    print(f"unprofiled run {time.perf_counter() - t0:.2f} s", flush=True)
    x = torch.ones(8, device="cuda")
    for n in (1, 100):
        with cs._Syncs() as sy:
            t0 = time.perf_counter()
            for _ in range(n):
                float(x.sum())
            sy.mark()
            dt = time.perf_counter() - t0
        print(f"read counter: {sy.steps[0]} reads counted for {n} in {dt:.3f} s", flush=True)
    t0 = time.perf_counter()
    for _ in range(100):
        float(x.sum())
    print(f"100 reads without the counter: {time.perf_counter() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
