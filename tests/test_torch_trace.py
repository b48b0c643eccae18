"""The port's spans and counters (`repro_torch.runtime.trace`) and their
sites in the training path, on the CPU: what is recorded when, how
spans nest and share a step, the counters of a hand-worked batch, the
spans in a `torch.profiler` trace, the Engine's and set-up's timers
read from the spans, and the benchmark's readers of them."""
import importlib.util
import os
import pathlib
import statistics
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.batching import ClusterBatcher
from repro_torch.core.experiment import build_experiment, preset
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import partition_graph
from repro_torch.kernels import _build
from repro_torch.nn.tree import tree_leaves
from repro_torch.runtime import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_SPANS = ("engine.iter", "engine.fetch", "batch.build", "batch.nodes",
              "batch.subgraph", "batch.relabel", "batch.normalize",
              "batch.tiles",
              "batch.features", "batch.copy", "engine.step", "step.forward",
              "step.backward", "step.optimizer", "engine.hooks")
SETUP_SPANS = ("setup.build", "setup.partition", "setup.batcher",
               "setup.backend", "setup.init_state")
# what bench/trace.py picks device events and annotations out by
BENCH_KEYS = ("xw_kernel", "spmm_kernel", "reduce_splits", "Memcpy",
              "Memset")
READERS = ("build_subgraph_ms", "build_tiles_ms", "tile_density_pct",
           "step_forward_host_ms", "step_backward_host_ms",
           "step_optimizer_host_ms", "loop_other_ms", "setup_program_s",
           "partition_within_pct", "build_relabel_ms")


@pytest.fixture(autouse=True)
def recorder():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _spec(**sets):
    spec = preset("ppi_tiny")
    spec.partition.cache = False
    spec.batch.sparse_adj = True
    spec.model.fuse_spmm = True
    spec.run.epochs = 2
    spec.run.eval_every = 0
    spec.run.checkpoint_dir = None
    for k, v in sets.items():
        sec, field = k.split("__")
        setattr(getattr(spec, sec), field, v)
    return spec


def _fit(spec, on: bool):
    if on:
        trace.enable()
    try:
        exp = build_experiment(spec, device="cpu")
        return exp, exp.fit()
    finally:
        trace.disable()


def _history(res):
    return [{k: v for k, v in h.items()
             if k not in ("time", "flagged_steps", "trace")}
            for h in res.history]


def _steps(exp):
    spe = exp.batcher.steps_per_epoch()
    return {(e, k) for e in range(exp.spec.run.epochs) for k in range(spe)}


def _partition_spans(spans):
    """The spans a computed partition opens under `setup.partition`: one
    `partition.coarsen` a level (one more when the last stalled), one
    `partition.initial`, one `partition.refine` a level and one for the
    coarsest graph."""
    part = next(s for s in spans if s.name == "setup.partition")
    levels = part.counters["partition.levels"]
    coarsen = [s.name for s in spans].count("partition.coarsen")
    assert coarsen in (levels, levels + 1)
    return (("partition.coarsen",) * coarsen + ("partition.initial",)
            + ("partition.refine",) * (levels + 1))


def test_off_records_only_setup_and_trains_as_on():
    # the partitioner's library loads once a process (a `setup.kernels`
    # span, kept whether or not tracing is on): load it first, so that
    # the spans below do not depend on which tests this process ran
    from repro_torch.graph import partition
    partition._native()
    trace.reset()
    off, res_off = _fit(_spec(), on=False)
    spans = trace.spans()
    names = [s.name for s in spans]
    assert sorted(names) == sorted(SETUP_SPANS + _partition_spans(spans))
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("partition."):
            assert by_id[s.parent].name == "setup.partition"
    assert all("trace" not in h for h in res_off.history)
    trace.reset()
    on, res_on = _fit(_spec(), on=True)
    assert {s.name for s in trace.spans()} >= set(STEP_SPANS)
    for a, b in zip(tree_leaves(res_off.params), tree_leaves(res_on.params)):
        assert torch.equal(a, b)
    assert _history(res_off) == _history(res_on)
    for rec in res_on.history:
        spans = rec["trace"]["spans"]
        assert spans["engine.step"]["count"] == on.batcher.steps_per_epoch()
        assert rec["trace"]["counters"]["batch.adj_nnz"] > 0


def test_env_var_turns_tracing_on():
    code = textwrap.dedent("""
        from repro_torch.runtime import trace
        assert trace.on()
        with trace.span("x"):
            pass
        assert [s.name for s in trace.spans()] == ["x"]
        print("ok")
    """)
    env = dict(os.environ, REPRO_TORCH_TRACE="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("prefetch", [0, 2])
def test_each_step_has_one_of_each_span_nested_on_its_thread(prefetch):
    exp, _ = _fit(_spec(execution__prefetch=prefetch), on=True)
    spans = [s for s in trace.spans() if not s.name.startswith("setup.")]
    by_id = {s.id: s for s in spans}
    main = next(s.tid for s in spans if s.name == "engine.iter")
    steps = _steps(exp)
    for name in STEP_SPANS:
        got = sorted(s.step for s in spans
                     if s.name == name and s.step is not None)
        assert got == sorted(steps), name
    for s in spans:
        parent = by_id.get(s.parent)
        if parent is None:
            continue
        assert parent.tid == s.tid
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        assert parent.step == s.step, (s.name, parent.name)
    # the one iteration a stream's end adds per epoch carries no step
    ends = [s for s in spans if s.name == "engine.iter" and s.step is None]
    assert len(ends) == exp.spec.run.epochs
    builds = {s.step: s for s in spans if s.name == "batch.build"}
    copies = {s.step: s for s in spans if s.name == "batch.copy"}
    fetches = {s.step: s for s in spans if s.name == "engine.fetch"}
    for step in steps:
        assert builds[step].t1 <= fetches[step].t1
        if prefetch:
            # built and copied ahead on the producer thread, under the
            # identifier of the step that consumes them
            assert builds[step].tid == copies[step].tid != main
            assert builds[step].parent is None
        else:
            assert builds[step].tid == main
            assert by_id[builds[step].parent] is fetches[step]
    for s in spans:
        if s.name == "batch.relabel":
            assert by_id[s.parent].name == "batch.subgraph"


def _hand_graph():
    # clusters {0, 1, 2} and {3, 4, 5}: paths 0-1-2 and 3-4-5, and the
    # between-cluster link 2-3, which no one-cluster batch holds
    g = CSRGraph.from_edges(6, [0, 1, 3, 4, 2], [1, 2, 4, 5, 3])
    g.features = np.arange(12, dtype=np.float32).reshape(6, 2)
    g.labels = np.array([0, 1, 0, 1, 0, 1], np.int32)
    g.train_mask = np.ones(6, bool)
    return g, np.array([0, 0, 0, 1, 1, 1])


def test_counters_of_a_hand_worked_batch():
    g, parts = _hand_graph()
    batcher = ClusterBatcher(g, parts, clusters_per_batch=1, norm="eq10",
                             node_cap=4, pad_multiple=2, sparse_adj=True,
                             block_size=2)
    trace.enable()
    batches = list(batcher.epoch(0))
    trace.disable()
    assert len(batches) == 2
    spans = trace.spans()
    # each batch: a 3-node path, 2 edges each way + 3 self loops (Eq. 10)
    assert [s.counters for s in spans if s.name == "batch.normalize"] == \
        [{"batch.adj_nnz": 7}] * 2
    # cap 4 / B 2: 2 row blocks × K 2 for Â, the same for Âᵀ
    assert [s.counters for s in spans if s.name == "batch.tiles"] == \
        [{"batch.tile_slots": 8, "batch.block": 2}] * 2
    assert [s.counters for s in spans if s.name == "batch.build"] == \
        [{"batch.nodes_real": 3}] * 2
    assert [s.step for s in spans if s.name == "batch.build"] == \
        [(0, 0), (0, 1)]
    summ = trace.summary()
    assert summ["counters"]["batch.adj_nnz"] == 14
    assert summ["spans"]["batch.build"]["count"] == 2


def test_spans_are_ranges_of_the_profiler_trace():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    exp = build_experiment(_spec(), device="cpu")
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.fit()
    assert not trace.on()
    spans = trace.spans()
    names = {s.name for s in spans}
    assert names >= set(STEP_SPANS) | {"setup.init_state"}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() in names]
    offsets = []
    for name in names:
        ours = sorted(s.t0 for s in spans if s.name == name)
        theirs = sorted(e.start_ns() for e in events if e.name() == name)
        assert len(ours) == len(theirs), name
        offsets += [b - a for a, b in zip(ours, theirs)]
    med = statistics.median(offsets)
    spread = sorted(abs(o - med) for o in offsets)
    assert spread[int(0.9 * (len(spread) - 1))] < 100_000


def test_no_span_name_is_one_bench_trace_keys_on():
    _fit(_spec(), on=True)
    names = {s.name for s in trace.spans()} | {"setup.kernels"}
    doc = (ROOT / "docs" / "tracing.md").read_text()
    for name in names:
        assert not name.startswith("bench."), name
        assert not any(k in name for k in BENCH_KEYS), name
        assert f"`{name}`" in doc, f"{name} is not in docs/tracing.md"


def test_graph_span_and_counter_names_obey_the_rule():
    """The CUDA-graph step's spans and counters, which a CPU run never
    records, by the same rule as the names a CPU run records."""
    from repro_torch.core import step_graph
    doc = (ROOT / "docs" / "tracing.md").read_text()
    for name in step_graph.SPANS + step_graph.COUNTERS:
        assert name.startswith("step.")
        assert not any(k in name for k in BENCH_KEYS), name
        assert f"`{name}`" in doc, f"{name} is not in docs/tracing.md"


def test_a_cpu_step_runs_eagerly(fitted_spans):
    names = [s.name for s in fitted_spans]
    assert not set(names) & {"step.capture", "step.replay"}
    steps = names.count("engine.step")
    assert steps > 0
    for name in ("step.forward", "step.backward", "step.optimizer"):
        assert names.count(name) == steps, name


@pytest.mark.parametrize("replays,captures,want", [
    (0, 0, None), (4, 1, 100.0), (2, 0, 50.0), (0, 1, 0.0)])
def test_step_graph_pct_on_synthetic_spans(replays, captures, want,
                                           monkeypatch):
    """100 × replays over engine.step spans; nothing from a program that
    has neither graph span (the eager path, the benchmark's parent)."""
    import types
    made = ([types.SimpleNamespace(name="engine.step")] * 4
            + [types.SimpleNamespace(name="step.forward")] * 4
            + [types.SimpleNamespace(name="step.replay")] * replays
            + [types.SimpleNamespace(name="step.capture")] * captures)
    read = _reader("step_graph_pct")
    monkeypatch.setattr(trace, "spans", lambda since_ns=None: made)
    assert read(None) == want
    monkeypatch.setattr(trace, "spans", lambda since_ns=None: [])
    assert read(None) is None


def test_engine_timers_read_the_spans_clock_pairs(monkeypatch):
    exp = build_experiment(_spec(execution__prefetch="auto"), device="cpu")
    seen = []
    flag = exp.engine.straggler.flag_step
    monkeypatch.setattr(exp.engine.straggler, "flag_step",
                        lambda sec: seen.append(sec) or flag(sec))
    trace.enable()
    res = exp.fit()
    trace.disable()
    spans = trace.spans()
    steps = [s for s in spans if s.name == "engine.step"]
    assert seen == [(s.t1 - s.t0) / 1e9 for s in steps]
    spe = exp.batcher.steps_per_epoch()
    fetch = sum(s.t1 - s.t0 for s in spans if s.name == "engine.fetch"
                and s.step is not None and s.step[0] == 0)
    step = sum(s.t1 - s.t0 for s in steps[:spe])
    assert res.history[0]["host_build_over_step"] == fetch / step
    part = [s for s in spans if s.name == "setup.partition"]
    assert exp.partition_stats.seconds == part[0].seconds


def test_partition_seconds_and_cache_counter_without_tracing(tmp_path):
    g, _ = _hand_graph()
    for cached in (0, 1):
        _, stats = partition_graph(g, 2, cache=str(tmp_path))
        sp = [s for s in trace.spans() if s.name == "setup.partition"][-1]
        assert stats.seconds == sp.seconds > 0
        # the cut is counted whether the assignment was computed or loaded
        assert stats.edge_cut == 2 and stats.num_edges == 10
        levels = {} if cached else {"partition.levels": 0}
        assert sp.counters == {"partition.cached": cached,
                               "partition.cut_slots": 2,
                               "partition.slots": 10, **levels}


def test_kernel_build_seconds_are_the_setup_span(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\necho built\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    first = _build.build(["block_ell_spmm", "block_ell_spmm_fused"])
    again = _build.build(["block_ell_spmm"])
    spans = [s for s in trace.spans() if s.name == "setup.kernels"]
    assert [s.counters for s in spans] == [{"kernels.built": 2}, None]
    assert [r.seconds for r in first] == [spans[0].seconds] * 2
    assert [r.cached for r in again] == [True] and again[0].seconds == 0.0


def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _by_hand(spans):
    """Each reader's value worked out from the spans another way: by
    name and step, not by parent links."""
    def ms(s):
        return (s.t1 - s.t0) / 1e6

    def of(name):
        return {s.step: s for s in spans if s.name == name
                and s.step is not None}
    builds, iters = of("batch.build"), of("engine.iter")
    pre = {k: sum(ms(of(n)[k]) for n in ("batch.nodes", "batch.subgraph",
                                          "batch.normalize"))
           for k in builds}
    slots = sum(of("batch.tiles")[k].counters["batch.tile_slots"]
                * of("batch.tiles")[k].counters["batch.block"] ** 2
                for k in builds)
    nnz = sum(2 * of("batch.normalize")[k].counters["batch.adj_nnz"]
              for k in builds)
    other = [ms(iters[k]) - ms(builds[k]) - ms(of("batch.copy")[k])
             - ms(of("engine.step")[k]) for k in iters]
    setup = [s for s in spans
             if s.name in ("setup.build", "setup.init_state")]
    part = next(s for s in spans if s.name == "setup.partition").counters
    mean = statistics.fmean
    return {
        "build_subgraph_ms": mean(pre.values()),
        "build_tiles_ms": mean(ms(s) for s in of("batch.tiles").values()),
        "tile_density_pct": 100.0 * nnz / slots,
        "step_forward_host_ms": mean(map(ms, of("step.forward").values())),
        "step_backward_host_ms": mean(map(ms,
                                          of("step.backward").values())),
        "step_optimizer_host_ms": mean(map(ms,
                                           of("step.optimizer").values())),
        "loop_other_ms": mean(other),
        "setup_program_s": sum(s.t1 - s.t0 for s in setup) / 1e9,
        "partition_within_pct": 100.0 * (1.0 - part["partition.cut_slots"]
                                         / part["partition.slots"]),
        "build_relabel_ms": mean(ms(s) for s in of("batch.relabel").values()),
    }


@pytest.fixture(scope="module")
def fitted_spans():
    trace.reset()
    _fit(_spec(), on=True)
    spans = trace.spans()
    trace.reset()
    return spans


@pytest.mark.parametrize("name", READERS)
def test_bench_reader_reads_the_recorder(name, fitted_spans, monkeypatch):
    read = _reader(name)
    assert read(None) is None                   # nothing recorded
    monkeypatch.setattr(trace, "spans", lambda since_ns=None: fitted_spans)
    want = _by_hand(fitted_spans)[name]
    assert read(None) == pytest.approx(want, rel=1e-9)
    if name == "tile_density_pct":
        # ppi_tiny: one 128-row block, K 1 each way, so each batch ships
        # 2 · 128² elements for its 2 · nnz nonzeros
        assert want == pytest.approx(100.0 * statistics.fmean(
            s.counters["batch.adj_nnz"] for s in fitted_spans
            if s.name == "batch.normalize") / 128 ** 2)


def test_reader_returns_none_without_the_recorder(fitted_spans,
                                                  monkeypatch):
    """A program without the recorder (the benchmark's parent commit)
    reads as no number, not as an error."""
    import repro_torch.runtime
    monkeypatch.setattr(trace, "spans", lambda since_ns=None: fitted_spans)
    assert all(_reader(name)(None) is not None for name in READERS)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(repro_torch.runtime, "trace")
    for name in READERS:
        assert _reader(name)(None) is None


def test_off_path_allocates_no_span():
    assert trace.span("engine.iter") is trace.span("batch.build")
    assert trace.step_span("engine.iter", 0, 0) is trace.span("x")
    with trace.span("engine.iter") as sp:
        trace.count("batch.adj_nnz", 3)
    assert sp is None and trace.spans() == []
    t = trace.Timer("engine.step", timed=False)
    with t:
        pass
    assert t.ns == 0 and t.span is None and trace.spans() == []


def test_a_span_open_when_the_profiler_stops_is_dropped():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with trace.span("engine.hooks"):
        with trace.span("step.forward"):
            pass
        prof.stop()
    with trace.setup_span("setup.build"):
        pass
    assert [s.name for s in trace.spans()] == ["step.forward", "setup.build"]
