"""Device kernels in the traced window over the G denoising steps in it (each
call runs the whole chain)."""


def read(run):
    if run.trace is None or not run.traced.get("g_steps"):
        return None
    return run.trace.n_kernels / run.traced["g_steps"]
