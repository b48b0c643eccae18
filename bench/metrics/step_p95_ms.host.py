"""95th percentile (nearest rank) of the intervals between consecutive
step completions (CUDA events) outside the profiled epochs: the step
tail where the host sets the pace."""
from bench.stats import p95


def read(ctx):
    return p95(ctx.part["intervals_ms"])
