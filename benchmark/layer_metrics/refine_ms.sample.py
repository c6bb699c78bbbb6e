"""Device ms per `generate` call inside the program's `serve.refine` span
(runtime/profiler.py, read with report() after the traced window): R's tail of
the call (MANO of G's sample, its h2o with the cull mask and #2, the R net,
MANO of the refined pose). A device span's time is the stream's between its
two CUDA events. The calls are the program's own top-level `serve.generate`
spans; their `diffusion.step` spans must equal the traced window's G steps.
Silent without a trace, where the program has no recorder of spans (an older
version) or where the span is absent (the layer is off the path); an error
where the step counts disagree."""

SPAN = "serve.refine"


def read(run):
    if run.trace is None:
        return None
    try:
        from oakink2_tamf_tpu_torch.runtime.profiler import report
    except ImportError:
        return None
    rep = report()
    calls = rep.spans.get("serve.generate")
    steps = rep.spans.get("diffusion.step")
    if calls is None or steps is None or steps.n != run.traced["g_steps"]:
        raise RuntimeError(f"{calls.n if calls else 0} generate and {steps.n if steps else 0} diffusion.step "
                           f"spans in the program's record, {run.traced['g_steps']} traced G steps")
    t = rep.spans.get(SPAN)
    return 1e3 * t.device_s / calls.n if t is not None else None
