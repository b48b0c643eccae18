"""Mean host time of the block-ELL tiling of a batch (`batch.tiles`:
the tiles of Â and Âᵀ, the pool's recycle included), read from the
program's spans (repro_torch.runtime.trace). Tracing is on while the
profiler records, so under --trace 1 the spans cover exactly the
profiled epochs."""


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    ns = [s.t1 - s.t0 for s in trace.spans() if s.name == "batch.tiles"]
    return sum(ns) / len(ns) / 1e6 if ns else None
