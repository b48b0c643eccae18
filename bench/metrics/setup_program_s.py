"""The program's own set-up: its `setup.build` span (the experiment
built: partition, batcher, backend, Engine) plus its `setup.init_state`
span (the seeded parameters and optimizer state), read from the
program's spans (repro_torch.runtime.trace), which keeps set-up spans
whether or not tracing is on. The rest of setup_s is imports, the
benchmark's graph, the kernels' first calls and the warm-up steps."""


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    ns = [s.t1 - s.t0 for s in trace.spans()
          if s.name in ("setup.build", "setup.init_state")]
    return sum(ns) / 1e9 if ns else None
