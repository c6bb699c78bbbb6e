"""The caching allocator's peak over the timed window
(torch.cuda.max_memory_allocated after reset_peak_memory_stats at its start)."""


def read(run):
    return run.memory_peak / 2**30 if run.memory_peak else None
