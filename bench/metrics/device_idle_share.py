"""1 - the union of kernel, copy and memset intervals over the profiled
epochs' wall time (torch.profiler), in %."""


def read(ctx):
    p = ctx.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
