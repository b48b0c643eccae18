"""Mean host time of one backend.step (forward, backward and AdamW
dispatched; no synchronise), outside the profiled epochs."""
import statistics


def read(ctx):
    v = ctx.part["step_ms"]
    return statistics.fmean(v) if v else None
