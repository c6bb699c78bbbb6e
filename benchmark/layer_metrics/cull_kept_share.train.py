"""The share of the h2o cull mask's blocks that it keeps, over the traced window:
100 x the program's counters `cull.blocks_kept` / `cull.blocks_live`
(runtime/profiler.py, read with report(); ops/chamfer_cull.cull_mask counts
the (frame, hand region, object tile) blocks it runs, and those of the frames
its caller marks live). The step count is the program's own top-level step
spans, and must equal the traced window's. Silent without a trace, where the
program has no recorder of spans (an older version) or where no mask ran; an
error where the step counts disagree or more blocks are kept than live."""

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
    kept, live = rep.counters.get("cull.blocks_kept"), rep.counters.get("cull.blocks_live")
    if not live:
        return None
    if kept is None or kept > live:
        raise RuntimeError(f"cull.blocks_kept {kept} of cull.blocks_live {live} in {n} traced steps")
    return 100.0 * kept / live
