"""The work the timed window's steps ask for (benchmark/lib/work.py, from the
cell's shapes and generated inputs) over the timed window's host-clock
time, as a share of the FP32 peak outside the tensor cores of the cell's
cards: on several chips the entry counts the whole group's work, and it is
held against that many cards' peak. The timed window runs before the traced
one and without the profiler."""

from benchmark.lib.peaks import FP32_FLOPS


def read(run):
    flops = run.layer.get("work_flops")
    return 100.0 * flops / (run.window_s * FP32_FLOPS * run.chips) if flops else None
