"""Device ms per train step of the exchange between the ranks: every NCCL
kernel in this rank's traced window (rank 0's in the result), found by
name, over the traced steps (in the tests' CPU rehearsal on gloo ranks, the
host's all-reduce and all-gather operators stand in for them). The program
all-reduces the gradients in one flat buffer after backward()
(parallel/mesh.all_reduce_grads_) and reduces the step's metrics after the
optimizer; nothing overlaps them, so the time is exposed, and it holds the
wait for the slowest rank. Silent on a cell of one chip; an error where
the trace holds fewer of them than steps (the name no longer finds the
exchange)."""

NEEDLES = ("nccl", "c10d::all")


def read(run):
    if run.trace is None or run.chips == 1:
        return None
    steps = run.traced["steps"]
    t = n = 0
    for needle in NEEDLES:
        dt, dn = run.trace.kernel_time(needle)
        t, n = t + dt, n + dn
    if n < steps or steps == 0 or t <= 0:
        raise RuntimeError(f"{n} NCCL kernels ({t} s) in the trace for {steps} traced steps")
    return 1e3 * t / steps
