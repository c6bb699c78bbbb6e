"""Host ms per G denoising step: the program's `diffusion.step` spans
(runtime/profiler.py, read with report() after the traced window), one a step
of the DDPM chain, each from the host's entry to its exit. Where the host
leads the card this is the host's cost to launch a step; where the launch queue
is full it reads the card's pace. The spans must equal the traced window's G
steps. Silent without a trace or where the program has no recorder of spans
(an older version); an error where the counts disagree."""

SPAN = "diffusion.step"


def read(run):
    if run.trace is None:
        return None
    try:
        from oakink2_tamf_tpu_torch.runtime.profiler import report
    except ImportError:
        return None
    t = report().spans.get(SPAN)
    if t is None or t.n != run.traced["g_steps"] or t.n == 0:
        raise RuntimeError(f"{t.n if t else 0} {SPAN} spans in the program's record, "
                           f"{run.traced['g_steps']} traced G steps")
    return 1e3 * t.host_s / t.n
