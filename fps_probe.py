#!/usr/bin/env python3
"""PointBERT's farthest-point sampling (models/pointbert.py) on one GPU: its
time in a fresh process, after a torch.profiler trace (runtime/profiler.
DeviceTrace) and after heavy allocation, beside the host time of one small
op's dispatch. FPS issues ~12 small launches per step for 512 steps, so its
time is the host's; this shows how far the process's state moves it.

    python3 fps_probe.py        # on the card; prints one line per state
"""
import gc
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from oakink2_tamf_tpu_torch.models import pointbert as PB  # noqa: E402
from oakink2_tamf_tpu_torch.runtime.profiler import DeviceTrace  # noqa: E402


def probe(label, one, x64):
    """One line: a small add_'s dispatch (host us), FPS of one cloud (card
    ms and host enqueue ms) and of 64 clouds (card ms)."""
    torch.cuda.synchronize()
    t = torch.zeros(16, device="cuda")
    t0 = time.perf_counter()
    for _ in range(2000):
        t.add_(1.0)
    disp = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    fps1 = cs.cuda_time_ms(lambda: PB.farthest_point_sampling(one, 512), reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PB.farthest_point_sampling(one, 512)
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    fps64 = cs.cuda_time_ms(lambda: PB.farthest_point_sampling(x64, 512), reps=3)
    print(f"{label}: add_ dispatch {disp:.2f} us; FPS one cloud {fps1:.3f} ms (host enqueue {host:.3f} ms); "
          f"FPS batch 64 {fps64:.3f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        print("fps_probe: no CUDA device", file=sys.stderr)
        return 1
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    set_fp32_precision()
    print(cs.card_line(), os.cpu_count(), flush=True)
    clouds = cs.pointbert_clouds(64)
    one, x64 = clouds[:1].cuda(), clouds.cuda()
    probe("fresh", one, x64)
    probe("fresh again", one, x64)
    with tempfile.TemporaryDirectory() as d:
        tr = DeviceTrace(d, "cuda").start()
        for _ in range(3):
            PB.farthest_point_sampling(one, 8)
        tr.stop()
    probe("after a DeviceTrace", one, x64)
    big = [torch.empty(1 << 28, device="cuda") for _ in range(20)]
    del big
    junk = [{"a": [i] * 10} for i in range(2_000_000)]
    probe("after 20 GiB of allocations and 2M python objects", one, x64)
    del junk
    gc.collect()
    probe("after gc", one, x64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
