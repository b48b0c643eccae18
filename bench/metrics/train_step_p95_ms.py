"""95th percentile (nearest rank) of the intervals between consecutive
step completions on the device over the whole window: a CUDA event is
recorded after each step, with no synchronise, and read after the
window closes."""
from bench.stats import p95


def read(ctx):
    return p95(ctx.step_intervals_ms)
