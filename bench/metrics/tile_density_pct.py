"""The nonzeros of Â and Âᵀ over the elements their tiles ship, in %:
100 · Σ 2·`batch.adj_nnz` / Σ `batch.tile_slots`·`batch.block`², from
the program's counters (repro_torch.runtime.trace) on each batch's
`batch.normalize` and `batch.tiles` spans. Tracing is on while the
profiler records, so under --trace 1 the counters cover exactly the
profiled epochs' batches."""


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    nnz = shipped = 0
    for s in trace.spans():
        c = s.counters or {}
        if s.name == "batch.normalize" and "batch.adj_nnz" in c:
            nnz += 2 * c["batch.adj_nnz"]
        elif s.name == "batch.tiles" and "batch.tile_slots" in c:
            shipped += c["batch.tile_slots"] * c["batch.block"] ** 2
    return 100.0 * nnz / shipped if shipped else None
