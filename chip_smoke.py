#!/usr/bin/env python3
"""On-GPU smoke of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100/H200) and nvcc; fails on any other
host, and fails in a directory holding nothing of the repository but
this script. Three phases, each of which must pass:

1. Build: compiles every CUDA kernel of the port from the sources in
   this checkout (one nvcc per source, in parallel) and prints the GPU's
   name and power limit (nvidia-smi) and the build time.
2. Kernel vs plain version on the GPU: `spmm_block_ell`'s CUDA kernel
   against the plain PyTorch version on the same inputs, over B in {8,
   16, 128}, F in {1, 121, 2048}, fp32 and bf16, row_k None and given
   (some rows 0), K = 0, and the exact ppi_sota cluster shape. Tolerance
   max|Δ| <= 1e-5·max(1, max|y_ref|) in fp32 (the two sum in different
   orders) and 8e-3·max(1, max|y_ref|) in bf16 (the output is rounded
   once to bf16, ulp 2^-8). Prints each case's error and the kernel's
   and the plain version's time (CUDA events, after warm-up); at the
   ppi_sota shape also one torch.bmm on the gathered operands as a
   library yardstick (timed only; the port never calls it).
3. Serve ppi_sota (5 layers, 2048 wide) end to end: random seeded
   params saved with the port's CheckpointManager, then
   `repro_torch.launch.serve_gcn.main` precomputes the embedding cache
   and answers 1024 lookups. Checks the kernel launch count (non-empty
   clusters x 5 propagations), served logits against the host oracle
   `full_graph_logits` (max|Δ| <= 1e-4·max(1, max|ref|)), and the lazy
   halo re-embed of an invalidated cluster against its warm value. It
   also shows where the time goes: one more precompute under
   torch.profiler (device time by kernel and copy, device idle share)
   and one 256-id query split into its host gather and device step.

The last three lines of stdout are the nvidia-smi line, a JSON line of
per-kernel numbers (`{"kernels": [...]}`), and
`{"ok": true, "device": {...}}`. Full per-case results also go to
chiprun_out/chip_smoke.json. Datasets, partitions, checkpoints and the
serving cache live in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
PPI_SHAPE = dict(nrb=3, K=110, B=128, ncb=110, F=2048)
SERVE_TOL = 1e-4


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _case_inputs(nrb, K, B, ncb, F, dtype, row_k_mode, seed):
    """Block-ELL operands in the format the host builders emit: slots
    past each row's live count hold zero tiles pointing at column-block
    0. row_k_mode: None (all K live, row_k not passed), "given"."""
    import torch
    g = torch.Generator().manual_seed(seed)
    blocks = torch.randn(nrb, K, B, B, generator=g)
    cols = torch.randint(0, ncb, (nrb, K), generator=g, dtype=torch.int32)
    x = torch.randn(ncb * B, F, generator=g)
    row_k = None
    if row_k_mode == "given":
        live = torch.randint(0, K + 1, (nrb,), generator=g,
                             dtype=torch.int32)
        live[0] = 0                      # an empty row-block
        for i in range(nrb):
            blocks[i, int(live[i]):] = 0
            cols[i, int(live[i]):] = 0
        row_k = live.cuda()
    return (blocks.to(dtype).cuda(), cols.cuda(), x.to(dtype).cuda(),
            row_k)


def _bound_ms(blocks, cols, x, row_k, y):
    """(ms, what bounds it): the least time on the card for this call,
    the larger of the bytes (each input read once, the output written
    once) over the peak memory rate and the live tiles' FLOPs over the
    dtype's peak rate."""
    nrb, K, B, _ = blocks.shape
    live = (int(row_k.sum()) if row_k is not None else nrb * K)
    flops = 2.0 * live * B * B * x.shape[1]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (blocks, cols, x, y)
                 + ((row_k,) if row_k is not None else ()))
    peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(results: dict) -> dict:
    import torch
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_block_ell_ref

    cases = []
    for B in (8, 16, 128):
        nrb, K, ncb = (3, 8, 16) if B == 128 else (5, 6, 9)
        for F in (1, 121, 2048):
            for dtype in (torch.float32, torch.bfloat16):
                for mode in (None, "given"):
                    cases.append((nrb, K, B, ncb, F, dtype, mode))
        cases.append((4, 0, B, 3, 121, torch.float32, None))     # K = 0
    p = PPI_SHAPE
    for dtype, mode in ((torch.float32, None), (torch.bfloat16, None),
                        (torch.float32, "given")):
        cases.append((p["nrb"], p["K"], p["B"], p["ncb"], p["F"], dtype,
                      mode))
    main_case = None
    for n, (nrb, K, B, ncb, F, dtype, mode) in enumerate(cases):
        blocks, cols, x, row_k = _case_inputs(nrb, K, B, ncb, F, dtype,
                                              mode, seed=n)
        y = block_spmm.spmm_block_ell(blocks, cols, x, row_k=row_k)
        torch.cuda.synchronize()
        ref = spmm_block_ell_ref(blocks, cols, x)
        err = float((y.float() - ref.float()).abs().max()) if y.numel() \
            else 0.0
        scale = max(1.0, float(ref.float().abs().max())) if y.numel() \
            else 1.0
        dname = str(dtype).replace("torch.", "")
        ok = err <= TOL[dname] * scale
        is_ppi = (nrb, K, B, ncb, F) == tuple(p.values())
        reps = 10 if is_ppi else 5
        if K:
            ms = _time_ms(lambda: block_spmm._launch(blocks, cols, x, row_k),
                          reps)
        else:
            ms = None                    # the wrapper launches nothing
        plain_ms = _time_ms(lambda: spmm_block_ell_ref(blocks, cols, x),
                            reps)
        row = dict(nrb=nrb, K=K, B=B, ncb=ncb, F=F, dtype=dname,
                   row_k=mode, max_abs_err=err, max_abs_ref=scale,
                   tol=TOL[dname] * scale, ok=ok, ms=ms, plain_ms=plain_ms)
        row["bound_ms"], row["bound_by"] = _bound_ms(blocks, cols, x, row_k,
                                                     y)
        if is_ppi:
            gathered = x.reshape(-1, B, F)[cols.long()].reshape(
                nrb, K * B, F)
            a = blocks.permute(0, 2, 1, 3).reshape(nrb, B, K * B)
            row["library_ms"] = _time_ms(lambda: torch.bmm(a, gathered),
                                         reps)
            del gathered, a
            if dtype == torch.float32 and mode is None:
                main_case = row          # the shape and call serving makes
        results["kernel_cases"].append(row)
        print(f"[kernels] B={B:>3} F={F:>4} nrb={nrb} K={K:>3} {dname:>8} "
              f"row_k={mode or 'None':>5}  max|Δ|={err:.3e} "
              f"(tol {TOL[dname] * scale:.3e})  "
              f"kernel {'-' if ms is None else f'{ms:.4f}'} ms  "
              f"plain {plain_ms:.4f} ms  bound {row['bound_ms']:.4f} ms"
              + (f"  bmm {row['library_ms']:.4f} ms" if is_ppi else "")
              + ("" if ok else "  FAIL"))
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain "
                                 f"version: {row}")
        del blocks, cols, x, y, ref
    return main_case


def _breakdown(engine, results: dict) -> None:
    """Where the serving time goes: one more full precompute under
    torch.profiler (device time by kernel, device idle share), and one
    256-id query split into its host gather and its device step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import full_graph_embeddings

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        full_graph_embeddings(engine.params, engine.graph, engine.parts,
                              engine.cfg, norm=engine.norm,
                              diag_lambda=engine.diag_lambda,
                              block=engine.block)
        wall = time.perf_counter() - t0
    device = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            device[evt.key] = device.get(evt.key, 0.0) + us / 1e6
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    results["precompute_profile"] = dict(
        wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
        top_device_s={k[:80]: v for k, v in top})
    print(f"[profile] precompute {wall:.3f} s wall, device busy "
          f"{busy:.3f} s, idle share {1.0 - busy / wall:.3f}")
    for name, sec in top:
        print(f"[profile]   {sec:8.4f} s  {name[:90]}")

    rng = np.random.default_rng(2)
    ids = rng.integers(0, engine.graph.num_nodes, size=256)
    gather, step = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        logits = engine._gather_logits(ids)
        gather.append(time.perf_counter() - t0)
        x = torch.from_numpy(logits).to(engine.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._step(x)
        torch.cuda.synchronize()
        step.append(time.perf_counter() - t0)
    results["query_256_split"] = dict(gather_ms=float(np.median(gather)) * 1e3,
                                      step_ms=float(np.median(step)) * 1e3)
    print(f"[profile] 256-id query: host gather "
          f"{np.median(gather) * 1e3:.3f} ms, device step "
          f"{np.median(step) * 1e3:.3f} ms (medians of 5)")


def phase_serve(results: dict, work: pathlib.Path) -> int:
    import numpy as np
    import torch
    from repro_torch.core.experiment import (build_gcn_config, build_graph,
                                             build_partition, preset)
    from repro_torch.core.gcn import init_gcn, params_to_numpy
    from repro_torch.core.trainer import full_graph_logits
    from repro_torch.kernels import block_spmm
    from repro_torch.launch import serve_gcn
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.serve import ServeEngine

    spec = preset("ppi_sota")
    graph = build_graph(spec)
    cfg = build_gcn_config(spec, graph)
    parts, _ = build_partition(spec, graph)
    nonempty = int((np.bincount(parts, minlength=spec.partition.num_parts)
                    > 0).sum())
    propagations = cfg.num_layers + int(cfg.precompute_ax)
    gcn = init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                   device="cuda")
    ck = work / "checkpoints"
    CheckpointManager(str(ck)).save(0, {"params": params_to_numpy(gcn)})
    del gcn
    bench_path = work / "serve_bench.json"
    print(f"[serve] ppi_sota: {graph.num_nodes} nodes, {graph.num_edges} "
          f"edge slots, {nonempty} non-empty clusters, {cfg.num_layers} "
          f"layers x {cfg.hidden_dim} wide")

    # --- the main path: every launch count starts at 0 here -------------
    block_spmm.LAUNCHES = 0
    rc = serve_gcn.main(["--preset", "ppi_sota", "--checkpoint-dir",
                         str(ck), "--queries", "1024",
                         "--bench-out", str(bench_path)])
    launches = block_spmm.LAUNCHES
    # ---------------------------------------------------------------------
    if rc != 0:
        raise AssertionError(f"serve_gcn returned {rc}")
    expected = nonempty * propagations
    print(f"[serve] block_ell_spmm launches: {launches} (expected "
          f"{nonempty} clusters x {propagations} propagations = "
          f"{expected})")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != {expected}")
    bench = json.loads(bench_path.read_text())
    results["serve"] = bench
    for row in bench["rows"]:
        if "p50_ms" in row:
            print(f"[serve] {row['name']}: {row['requests']} req  "
                  f"p50 {row['p50_ms']:.4f} ms  p99 {row['p99_ms']:.4f} ms")
        else:
            print(f"[serve] {row['name']}: {row['seconds']:.4f} s "
                  f"({row['warmed_clusters']} clusters)")
    print(f"[serve] QPS {bench['qps']:.1f} over {bench['queries']} lookups")

    # --- parity of the served logits with the host oracle ---------------
    engine = ServeEngine.from_checkpoint(spec, str(ck), device="cuda")
    if engine.warm() != 0:
        raise AssertionError("the rebuilt engine did not find the warm "
                             "cache")
    rng = np.random.default_rng(1)
    ids = rng.choice(graph.num_nodes, size=min(2048, graph.num_nodes),
                     replace=False)
    served = engine.query(ids).logits
    t0 = time.perf_counter()
    ref = full_graph_logits(engine.params, engine.graph, engine.cfg,
                            norm=engine.norm,
                            diag_lambda=engine.diag_lambda)
    oracle_s = time.perf_counter() - t0
    bound = SERVE_TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(served - ref[ids]).max())
    results["serve_parity"] = dict(ids=len(ids), max_abs_err=err,
                                   bound=bound, oracle_s=oracle_s)
    print(f"[serve] parity vs host oracle over {len(ids)} ids: "
          f"max|Δ| = {err:.3e} (bound {bound:.3e})")
    if not err <= bound:
        raise AssertionError("served logits disagree with the oracle")

    _breakdown(engine, results)

    # --- lazy halo re-embed of an invalidated cluster --------------------
    c = int(parts[ids[0]])
    rows = np.where(engine.parts == c)[0]
    warm_value = np.array(engine.cache.load(c))
    engine.cache.invalidate(c)
    before = block_spmm.LAUNCHES
    t0 = time.perf_counter()
    lazy = engine.query(rows).logits
    lazy_s = time.perf_counter() - t0
    relaunch = block_spmm.LAUNCHES - before
    bound = SERVE_TOL * max(1.0, float(np.abs(warm_value).max()))
    err = float(np.abs(lazy - warm_value).max())
    results["lazy_reembed"] = dict(cluster=c, rows=len(rows),
                                   max_abs_err=err, bound=bound,
                                   launches=relaunch, seconds=lazy_s)
    print(f"[serve] lazy re-embed of cluster {c} ({len(rows)} rows, "
          f"{relaunch} launches, {lazy_s:.3f} s): max|Δ| vs warm = "
          f"{err:.3e} (bound {bound:.3e})")
    if relaunch < 1 or not err <= bound:
        raise AssertionError("lazy re-embed did not go through the "
                             "kernel or disagrees with the warm value")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs "
              "only on a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = _smi()
    print(f"[build] {smi}")
    print(f"[build] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = _build.build()
    build_s = time.perf_counter() - t0
    for b in builds:
        print(f"[build] {b.name}: {b.path.name} in {b.seconds:.2f} s"
              + (" (cached)" if b.cached else ""))
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels built in {build_s:.2f} s")

    results = {"gpu": smi, "build_s": build_s, "kernel_cases": []}
    main_case = phase_kernels(results)

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke-"))
    old_cache = os.environ.get("REPRO_DATASETS_CACHE")
    os.environ["REPRO_DATASETS_CACHE"] = str(work / "datasets")
    try:
        launches = phase_serve(results, work)
    finally:
        if old_cache is None:
            os.environ.pop("REPRO_DATASETS_CACHE", None)
        else:
            os.environ["REPRO_DATASETS_CACHE"] = old_cache
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "block_ell_spmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_spmm.cu",
        "replaces": "src/repro/kernels/block_spmm.py:103",
        "also_replaces": "src/repro/kernels/block_spmm.py:132",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": {k: main_case[k] for k in ("nrb", "K", "B", "ncb", "F",
                                            "dtype")},
    }]
    results["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
