"""#8 (ops/chamfer_loss, `dist_loss_kernel`): the least time of its launches in the
traced window (benchmark/lib/work.py's bound, summed over the window's
steps) over their device time in the trace, found by the kernel's name.
Silent where the kernel's counter saw no launch (the kernel is off the
path); an error where the counter and the trace disagree (the name no
longer finds the kernel, or finds another)."""

KERNEL = "dist_loss_kernel"
NAME = "dist_loss"


def read(run):
    if run.trace is None:
        return None
    t, n = run.trace.kernel_time(KERNEL)
    launched = run.traced["launches"][NAME]
    if launched == 0 and n == 0:
        return None
    if n != launched or t <= 0:
        raise RuntimeError(f"{KERNEL}: {launched} launches counted, {n} in the trace ({t} s)")
    return 100.0 * run.traced["bound_s"][NAME] / t
