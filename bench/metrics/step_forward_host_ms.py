"""Mean host time of a step's `step.forward` span: the forward pass
and the loss (`gcn_loss`) dispatched, with no synchronise, read from
the program's spans (repro_torch.runtime.trace). Tracing is on while
the profiler records, so under --trace 1 the spans cover exactly the
profiled epochs."""


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    ns = [s.t1 - s.t0 for s in trace.spans() if s.name == "step.forward"]
    return sum(ns) / len(ns) / 1e6 if ns else None
