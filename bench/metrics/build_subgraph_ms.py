"""Mean host time per batch of the build's stages before the tiles:
the nodes of the batch (`batch.nodes`), its induced subgraph
(`batch.subgraph`) and the §6.2 renormalisation (`batch.normalize`),
read from the program's spans (repro_torch.runtime.trace) inside each
`batch.build`. Tracing is on while the profiler records, so under
--trace 1 the spans cover exactly the profiled epochs."""
STAGES = ("batch.nodes", "batch.subgraph", "batch.normalize")


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    spans = trace.spans()
    builds = {s.id: 0 for s in spans if s.name == "batch.build"}
    for s in spans:
        if s.name in STAGES and s.parent in builds:
            builds[s.parent] += s.t1 - s.t0
    return sum(builds.values()) / len(builds) / 1e6 if builds else None
