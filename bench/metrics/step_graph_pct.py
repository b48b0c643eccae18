"""Share of the training steps that ran as a replay of a captured CUDA
graph: 100 × the program's `step.replay` spans over its `engine.step`
spans (repro_torch.runtime.trace). Tracing is on while the profiler
records, so under --trace 1 the spans cover exactly the profiled
epochs, which follow the warm-up in which each payload signature's
graph is captured. A program with neither `step.replay` nor
`step.capture` spans reads nothing."""


def read(ctx):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    names = [s.name for s in trace.spans()]
    steps = names.count("engine.step")
    if not steps or not ({"step.replay", "step.capture"} & set(names)):
        return None
    return 100.0 * names.count("step.replay") / steps
