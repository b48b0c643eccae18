"""Mean host time of one next() of the batcher's epoch iterator: the
subgraph, its normalisation and the block-ELL tiles (prefetch thread),
over the part of the window outside the profiled epochs."""
import statistics


def read(ctx):
    v = ctx.part["build_ms"]
    return statistics.fmean(v) if v else None
