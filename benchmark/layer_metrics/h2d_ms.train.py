"""Device ms per train step inside the program's `batch.h2d` spans
(runtime/profiler.py, read with report() after the traced window): the batch's
copy to the card (launch/common.device_batch, from pageable host memory), one
a step. A device span's time is the stream's between its two CUDA events. The
step count is the program's own top-level step spans, and must equal the
traced window's. Silent without a trace, where the program has no recorder of
spans (an older version) or where the span is absent (the layer is off the
path); an error where the step counts disagree."""

SPAN = "batch.h2d"
STEPS = ("train.g_step", "train.r_step")


def read(run):
    if run.trace is None:
        return None
    try:
        from oakink2_tamf_tpu_torch.runtime.profiler import report
    except ImportError:
        return None
    rep = report()
    n = sum(rep.spans[s].n for s in STEPS if s in rep.spans)
    if n != run.traced["steps"] or n == 0:
        raise RuntimeError(f"{n} step spans in the program's record, {run.traced['steps']} traced steps")
    t = rep.spans.get(SPAN)
    return 1e3 * t.device_s / n if t is not None else None
