"""The device's idle share of the traced window: 1 - (union of kernel, memcpy
and memset intervals) / (the window's span), from the trace. The profiler
slows the host's launches, so a host-bound cell reads idler traced than
untraced (PERF.md, section 3)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
