"""The work the timed window's steps ask for (benchmark/lib/work.py, from the
cell's shapes and generated inputs) over the timed window's host-clock
time, as a share of the FP32 peak outside the tensor cores. The timed
window runs before the traced one and without the profiler."""

from benchmark.lib.peaks import FP32_FLOPS


def read(run):
    flops = run.layer.get("work_flops")
    return 100.0 * flops / (run.window_s * FP32_FLOPS) if flops else None
