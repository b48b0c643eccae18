"""Driver of the "train" traffic kind: one trainer in a closed loop
through the port's `Engine.fit`.

Set-up builds one experiment with `build_experiment` (the graph made by
the benchmark and handed in, the partition from the checkout's cache),
and one `Engine.fit` drives it from the seed: its first steps are the
checked ones and the warm-up, and the window opens at the end of the
warm-up's last step, inside the same fit, on the same state. The window
closes with a synchronise after the step that crosses `--seconds`.

Spans (host clock, perf_counter_ns) come from the benchmark's own
wrappers, installed on the instances and around the copy:
  build  each next() of the batcher's epoch iterator (prefetch thread)
  copy   each `batch_to_device` of the Engine (prefetch thread)
  step   each `backend.step` (main thread)
A CUDA event after each step dates its completion on the device.

With --trace 1 the window's first `profile_epochs` epochs run under
torch.profiler; the spans, the rate of work and the step tail are then
read over the rest of the window.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
import types
from typing import Dict, List, Optional

import numpy as np

from bench import counts, spec
from bench import trace as tr
from bench.graphs import sbm
from bench.reference import check
from bench.reference import cluster_gcn as ref


def settings(cell: Dict, seed: int) -> Dict:
    """The spec settings of a run: the configuration's recipe, the
    traffic's loop settings, and --seed on the traffic's seed keys."""
    s = {**cell["config"]["set"], **cell["traffic"]["set"]}
    for key in cell["traffic"]["seed_keys"]:
        s[key] = seed
    return s


def flat(tree) -> Dict:
    """A GCN parameter tree {"layers": [{"w", "b", "ln_scale"?}]} by
    leaf name ("layers.0.w", ...)."""
    return {f"layers.{i}.{k}": v for i, layer in enumerate(tree["layers"])
            for k, v in layer.items()}


def payload_bytes(batch) -> int:
    total = 0
    for leaf in batch.astuple():
        parts = leaf.tensors() if hasattr(leaf, "tensors") else [leaf]
        for t in parts:
            if t is None:
                continue
            total += (t.numel() * t.element_size() if hasattr(t, "element_size")
                      else np.asarray(t).nbytes)
    return total


class Spans:
    """The benchmark's spans and counters of one run."""

    def __init__(self, checked: int):
        self.builds: List[tuple] = []    # (t0, t1, num_real, bytes)
        self.copies: List[tuple] = []    # (t0, t1)
        self.steps: List[tuple] = []     # (t0, t1)
        self.payloads: List = []         # the checked steps' payloads
        self.checked = checked
        self.profiling = False


def instrument(exp, spans: Spans, fault: Optional[str]):
    """Wrap the batcher's epoch iterator, the backend's step and the
    Engine's copy; plant `fault` (checks of the check only):
    half_batch, state_unchanged, or leaf_frozen (the last layer's
    weight left as it was before each step). Returns the function that
    undoes the module-level wrap."""
    import torch
    from repro_torch.core import engine as engine_mod

    batcher, backend = exp.batcher, exp.engine.backend
    epoch = batcher.epoch

    def timed_epoch(e, start_step=0):
        it = epoch(e, start_step=start_step) if start_step else epoch(e)
        while True:
            t0 = time.perf_counter_ns()
            try:
                b = next(it)
            except StopIteration:
                return
            spans.builds.append((t0, time.perf_counter_ns(),
                                 int(b.num_real), payload_bytes(b)))
            yield b
    batcher.epoch = timed_epoch

    step = backend.step
    last_w = lambda st: backend.params(st)["layers"][-1]["w"]  # noqa: E731

    def timed_step(state, payload):
        kept = last_w(state).clone() if fault == "leaf_frozen" else None
        t0 = time.perf_counter_ns()
        if spans.profiling:
            with torch.profiler.record_function("bench.step"):
                out = step(state, payload)
        else:
            out = step(state, payload)
        spans.steps.append((t0, time.perf_counter_ns()))
        if len(spans.payloads) < spans.checked:
            spans.payloads.append(payload)
        if fault == "state_unchanged":
            return (state,) + tuple(out[1:])
        if kept is not None:
            with torch.no_grad():
                last_w(out[0]).copy_(kept)
        return out
    backend.step = timed_step

    if fault == "half_batch":
        nodes_of = batcher._batch_nodes
        batcher._batch_nodes = lambda ids, **kw: (
            lambda n: n[:len(n) // 2])(nodes_of(ids, **kw))
    elif fault not in (None, "state_unchanged", "leaf_frozen"):
        raise ValueError(f"unknown fault {fault!r}")

    copy = engine_mod.batch_to_device

    def timed_copy(*a, **kw):
        t0 = time.perf_counter_ns()
        out = copy(*a, **kw)
        spans.copies.append((t0, time.perf_counter_ns()))
        return out
    engine_mod.batch_to_device = timed_copy

    def undo():
        engine_mod.batch_to_device = copy
    return undo


class Window:
    """The Engine hook that captures the checked steps, opens the window
    after the warm-up, profiles its first epochs (--trace 1) and closes
    it once --seconds have passed."""

    def __init__(self, spans: Spans, *, seconds: float, warmup: int,
                 checked: int, profile_steps: int, trace: bool,
                 t_start: float, cuda: bool):
        self.spans = spans
        self.seconds, self.warmup, self.checked = seconds, warmup, checked
        self.profile_steps, self.trace = profile_steps, trace
        self.t_start, self.cuda = t_start, cuda
        self.losses, self.window_losses, self.window_steps = [], [], []
        self.marks: List[tuple] = []     # (global step, event or time)
        self.prof = None
        self.prof_ns = None              # (start, end) perf_counter_ns
        self.rest_mark = None            # index into marks
        self.t_open = self.t_close = self.t_rest = None

    # -- clocks ---------------------------------------------------------
    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def _mark(self, g):
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((g, ev))
        else:
            self.marks.append((g, time.perf_counter()))

    def intervals_ms(self, first: int = 0) -> List[float]:
        out = []
        for (_, a), (_, b) in zip(self.marks[first:], self.marks[first + 1:]):
            out.append(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out

    # -- hooks ----------------------------------------------------------
    def on_fit_start(self, engine):
        self.params0 = flat(engine.backend.params(engine.state))

    def on_step(self, engine, info):
        import torch
        g = info["global_step"]
        if g <= self.checked:
            self.losses.append(info["loss"])
            if g == 1:
                self.mu1 = flat(engine.state["opt"].mu)
            if g == self.checked:
                self.params_last = flat(engine.backend.params(engine.state))
        if g < self.warmup:
            return
        if g == self.warmup:
            self._sync()
            if self.cuda:
                self.setup_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            self.t_open = time.perf_counter()
            self.setup_s = self.t_open - self.t_start
            self._mark(g)
            if self.trace:
                self._start_profile()
            return
        now = time.perf_counter()
        self.window_steps.append(g)
        self.window_losses.append(info["loss"])
        self._mark(g)
        if self.prof is not None and g >= self.warmup + self.profile_steps:
            self._stop_profile()
        if now - self.t_open >= self.seconds:
            self._sync()
            self.t_close = time.perf_counter()
            if self.prof is not None:
                self._stop_profile()
            engine.request_stop(reason="benchmark window closed")

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.spans.profiling = True
        self.prof_ns = (time.perf_counter_ns(), None)

    def _stop_profile(self):
        self._sync()
        self.prof_ns = (self.prof_ns[0], time.perf_counter_ns())
        self.spans.profiling = False
        self.prof.stop()
        self.profiled, self.prof = self.prof, None
        self.t_rest = time.perf_counter()
        self.rest_mark = len(self.marks)
        self._mark(None)


def _check_recipe(spec_obj, s: Dict) -> None:
    """The program runs what the configuration states."""
    for path, want in s.items():
        obj = spec_obj
        for part in path.split("."):
            obj = getattr(obj, part)
        if obj != want:
            raise RuntimeError(f"the spec holds {path}={obj!r}, the "
                               f"configuration states {want!r}")


def drive(bm, cell, *, seed: int, seconds: float, trace: bool, device: str,
          t_start: float, root, cache, fault: Optional[str] = None) -> Dict:
    import torch
    from repro_torch.core.experiment import (apply_overrides,
                                             build_experiment, preset)
    from repro_torch.graph.csr import CSRGraph

    name = cell["workload"]["name"]
    conf, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    cuda = torch.device(device).type == "cuda"
    s = settings(cell, seed)
    arrays = sbm.load_or_make(conf["graph"], cache / "graphs")
    graph = CSRGraph(indptr=arrays["indptr"], indices=arrays["indices"],
                     data=np.ones(len(arrays["indices"]), np.float32),
                     features=arrays["features"], labels=arrays["labels"],
                     train_mask=arrays["train_mask"],
                     val_mask=arrays["val_mask"],
                     test_mask=arrays["test_mask"])
    run_spec = apply_overrides(preset(conf["preset"]), dict(s))
    run_spec.partition.cache_dir = str(cache / "partitions")
    _check_recipe(run_spec, s)
    warmup, checked = int(traffic["warmup_steps"]), int(traffic["checked_steps"])
    if not 1 <= checked <= warmup:
        raise ValueError("checked_steps must lie in 1..warmup_steps")
    spans = Spans(checked)
    window = Window(spans, seconds=seconds, warmup=warmup, checked=checked,
                    profile_steps=0, trace=trace, t_start=t_start, cuda=cuda)
    exp = build_experiment(run_spec, graph=graph, device=device,
                           extra_hooks=[window])
    spe = exp.batcher.steps_per_epoch()
    window.profile_steps = int(traffic["profile_epochs"]) * spe
    undo = instrument(exp, spans, fault)
    power = None
    if trace:
        power = _power_limit() if cuda else None
        _warm_profiler(cuda, device)
    print(f"[bench] {name}: {graph.num_nodes} nodes, {graph.num_edges} "
          f"edge slots, {exp.batcher.num_parts} parts, {spe} steps an "
          f"epoch, node_cap {exp.batcher.node_cap}"
          + (f"; card {power}" if power else ""), file=sys.stderr)
    try:
        exp.engine.fit()
    finally:
        undo()
    if window.t_close is None:
        raise RuntimeError("the run ended before its window closed "
                           "(run.epochs too small for --seconds)")
    window._sync()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_peak = window.setup_peak if cuda else 0
    finite = torch.isfinite(torch.stack(window.window_losses).float())
    failed = int((~finite).sum())
    builds = spans.builds
    steps_w = window.window_steps
    nodes_w = sum(builds[g - 1][2] for g in steps_w)
    cap = int(spans.payloads[0][1].shape[0])
    parts = np.asarray(exp.parts)
    dims = counts.layer_dims(exp.cfg.in_dim, exp.cfg.hidden_dim,
                             exp.cfg.out_dim, exp.cfg.num_layers)

    # the part of the window the host spans and the rate of work are
    # read over: all of it, or what follows the profiled epochs
    if trace and window.rest_mark is not None:
        part_steps = [g for g in steps_w if g > window.warmup
                      + window.profile_steps]
        part_t = (window.t_rest, window.t_close)
        part_marks = window.rest_mark
    else:
        part_steps, part_t, part_marks = steps_w, (window.t_open,
                                                   window.t_close), 0
    lo_ns = int(part_t[0] * 1e9)
    hi_ns = int(part_t[1] * 1e9)
    part = dict(
        seconds=part_t[1] - part_t[0], steps=part_steps,
        build_ms=[(b - a) / 1e6 for a, b, *_ in builds
                  if lo_ns <= a and b <= hi_ns],
        step_ms=[(b - a) / 1e6 for a, b in spans.steps
                 if lo_ns <= a and b <= hi_ns],
        payload_bytes=[builds[g - 1][3] for g in part_steps],
        intervals_ms=window.intervals_ms(part_marks))

    quarters = _quarters(window, steps_w, builds)
    print(f"[bench] window: {len(steps_w)} steps, nodes/s by quarter "
          f"{quarters}", file=sys.stderr)
    profile = breakdown = None
    batch_counts = {}
    if trace:
        batch_counts = _batch_counts(arrays, parts, s, cap, steps_w, spe,
                                     builds)
        part["flops"] = [counts.step_flops(*batch_counts[g], dims)
                         for g in part_steps]
        if cuda and window.prof_ns and window.prof_ns[1]:
            profile, breakdown = _read_profile(window, spans, dims,
                                               batch_counts, spe)
    # what the metric readers (bench/metrics/*.py) read
    ctx = types.SimpleNamespace(trace=trace, setup_s=window.setup_s,
                  window_s=window.t_close - window.t_open,
                  window_nodes=nodes_w,
                  step_intervals_ms=window.intervals_ms(0),
                  part=part, profile=profile, peak_window_bytes=window_peak,
                  cuda=cuda, power_limit=power)
    metrics = {}
    for m in spec.metrics_for(bm, name, trace):
        value = spec.read_metric(spec.reader(root, m["name"]), ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["workload"]["chips"]),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if trace and profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]

    # the check, once the window has closed, the peak is read and the
    # program's state is freed
    prog = dict(losses=[float(v) for v in window.losses], mu1=window.mu1,
                params0=window.params0, params_last=window.params_last,
                payloads=spans.payloads)
    exp.engine.state = None
    del exp, window, builds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check_run(arrays, parts, s, cap=cap, checked=checked,
                     device=device, prog=prog)
    result = {"correct": check.verdict(nums, limits),
              "attempted": len(steps_w), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": float(nums[k]), "limit": limits[k]}
                        for k in check.NAMES}
    return result


def _quarters(window: Window, steps, builds) -> List[float]:
    """Nodes/s over each quarter of the window's steps (CUDA events):
    whether a run's rate wanders within it or holds one level."""
    if not window.cuda or len(steps) < 8:
        return []
    marks = window.marks[:len(steps) + 1] if window.rest_mark is None \
        else [m for m in window.marks if m[0] is not None]
    out = []
    q = len(steps) // 4
    for i in range(4):
        a, b = i * q, (i + 1) * q
        ms = marks[a][1].elapsed_time(marks[b][1])
        out.append(round(sum(builds[g - 1][2] for g in steps[a:b])
                         / ms * 1e3, 1))
    return out


def check_run(arrays, parts, s: Dict, *, cap: int, checked: int, device,
              prog: Dict) -> Dict[str, float]:
    """The numbers of `check.NAMES` for one run: the reference's first
    `checked` steps against the program's record (`prog`)."""
    recipe = ref.Recipe.from_settings(s)
    part = check.partition_numbers(arrays["indptr"], arrays["indices"],
                                   parts, recipe.num_parts)
    kw = dict(run_seed=int(s["run.seed"]), batch_seed=int(s["batch.seed"]),
              cap=cap, steps=checked, device=device)
    want = ref.run_steps(arrays, parts, recipe, **kw)
    print(f"[bench] check: {check.diagnostics(prog, want, recipe.b1)}, partition cut "
          f"{part['cut']!r}", file=sys.stderr)
    return check.all_numbers(prog, want, recipe.b1,
                                 part["partition_vs_chance"])


def _batch_counts(arrays, parts, s, cap, steps, spe, builds) -> Dict:
    """(n, nnz) of each window step's batch, its nodes worked out again
    from the seeds (`reference.cluster_gcn`); n must match the
    program's num_real."""
    recipe = ref.Recipe.from_settings(s)
    members = ref.cluster_members(parts, recipe.num_parts)
    seed = int(s["batch.seed"])
    groups: Dict[int, list] = {}
    out = {}
    self_loops = recipe.norm != "eq1"
    for g in steps:
        e, k = divmod(g - 1, spe)
        if e not in groups:
            groups[e] = ref.epoch_groups(recipe.num_parts,
                                         recipe.clusters_per_batch, seed, e)
        nodes = ref.batch_nodes(members, groups[e][k], cap, seed, e, k)
        if len(nodes) != builds[g - 1][2]:
            raise RuntimeError(f"step {g}: {len(nodes)} nodes worked out, "
                               f"the program's batch has {builds[g - 1][2]}")
        out[g] = (len(nodes), counts.induced_nnz(
            arrays["indptr"], arrays["indices"], nodes, self_loops))
    return out


def _read_profile(window: Window, spans: Spans, dims, batch_counts,
                  spe) -> tuple:
    """busy_s, window_s, the block-ELL products' device time against
    the least time their work needs, and the breakdown."""
    prof = window.profiled
    t0, t1 = window.prof_ns
    steps = [g for g in window.window_steps
             if window.warmup < g <= window.warmup + window.profile_steps]
    events = tr.device_events(prof)
    ours = [a for a, _ in spans.steps[steps[0] - 1:steps[-1]]]
    theirs = [a for a, _ in tr.host_events(prof, "bench.step")]
    off = tr.clock_offset(ours, theirs) if len(ours) == len(theirs) else None
    if off is None:
        off = events[0][0] - t0 if events else 0
        print("[bench] trace: step annotations unmatched; the idle gaps "
              "are placed from the first device event", file=sys.stderr)
    lo, hi = t0 + off, t1 + off
    events = [e for e in events if e[1] > lo and e[0] < hi]
    busy = tr.union([(max(a, lo), min(b, hi)) for a, b, _ in events])
    busy_s = sum(b - a for a, b in busy) / 1e9
    window_s = (t1 - t0) / 1e9

    fused_t, plain_t = tr.block_ell_calls(events)
    n_calls = len(steps) * len(dims)
    fused = plain = None
    if len(fused_t) == n_calls and len(plain_t) == n_calls:
        f_ops = f_bytes = s_ops = s_bytes = f_min = s_min = 0.0
        for g in steps:
            n, nnz = batch_counts[g]
            for d, f in dims:
                fo, fb = counts.fused_spmm_work(n, nnz, d, f)
                so, sb = counts.spmm_work(n, nnz, f)
                f_min += counts.min_seconds(fo, fb)[0]
                s_min += counts.min_seconds(so, sb)[0]
                f_ops, f_bytes = f_ops + fo, f_bytes + fb
                s_ops, s_bytes = s_ops + so, s_bytes + sb
        fused = dict(kernel_s=sum(fused_t), min_s=f_min,
                     bound=counts.min_seconds(f_ops, f_bytes)[1])
        plain = dict(kernel_s=sum(plain_t), min_s=s_min,
                     bound=counts.min_seconds(s_ops, s_bytes)[1])
        ns = [batch_counts[g] for g in steps]
        print(f"[bench] trace: batches of {np.mean([a for a, _ in ns])!r} "
              f"nodes and {np.mean([b for _, b in ns])!r} nonzeros of Â "
              f"on average", file=sys.stderr)
        print(f"[bench] trace: fused calls {len(fused_t)}, "
              f"{fused['kernel_s']!r} s on the device, least "
              f"{f_min!r} s, {fused['bound']}-bound; plain calls "
              f"{len(plain_t)}, {plain['kernel_s']!r} s, least "
              f"{s_min!r} s, {plain['bound']}-bound", file=sys.stderr)
    else:
        print(f"[bench] trace: {len(fused_t)} fused and {len(plain_t)} "
              f"plain block-ELL calls found, {n_calls} each expected; "
              f"no roofline", file=sys.stderr)

    shift = lambda sp: [(a + off, b + off) for a, b, *_ in sp]  # noqa: E731
    step_spans = spans.steps
    ends = [(step_spans[g - 1][1] + off, step_spans[g][0] + off)
            for g in steps if g % spe == 0 and g < len(step_spans)]
    gaps = tr.idle_gaps(busy, lo, hi, {"step": shift(step_spans),
                                       "copy": shift(spans.copies),
                                       "build": shift(spans.builds)}, ends)
    totals: Dict[str, float] = {}
    for _, _, pieces in gaps:
        for label, sec in pieces.items():
            totals[label] = totals.get(label, 0.0) + sec
    idle = sorted(totals.items(), key=lambda kv: -kv[1])
    longest = sorted(gaps, key=lambda g: -g[1])[:10 - len(idle)]
    idle += [(f"{label}, longest", sec) for label, sec, _ in longest]
    ops = sorted(tr.by_name(events).items(), key=lambda kv: -kv[1])[:10]
    breakdown = {"device_ops": [[k[:160], v] for k, v in ops],
                 "idle_gaps": [[k, v] for k, v in idle]}
    profile = dict(busy_s=busy_s, window_s=window_s, fused=fused,
                   spmm=plain, steps=len(steps))
    return profile, breakdown


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _warm_profiler(cuda: bool, device) -> None:
    """Start the profiler once in set-up, so that its first start's
    cost falls outside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()
