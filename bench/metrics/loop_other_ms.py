"""Mean host time per step of the training loop outside the batch's
build, its copy and the step: each `engine.iter` span of a step less
the `batch.build`, `batch.copy` and `engine.step` spans inside it, read
from the program's spans (repro_torch.runtime.trace). What remains is
the hooks, the loop's bookkeeping and the wait on a prefetch queue.
Tracing is on while the profiler records, so under --trace 1 the spans
cover exactly the profiled epochs."""
WORK = ("batch.build", "batch.copy", "engine.step")


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    left = {s.id: s.t1 - s.t0 for s in spans
            if s.name == "engine.iter" and s.step is not None}
    for s in spans:
        if s.name not in WORK:
            continue
        up = by_id.get(s.parent)
        while up is not None and up.id not in left and up.name not in WORK:
            up = by_id.get(up.parent)
        if up is not None and up.id in left:
            left[up.id] -= s.t1 - s.t0
    return sum(left.values()) / len(left) / 1e6 if left else None
