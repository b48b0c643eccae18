"""GCN serving driver on the port — checkpoint → per-cluster embedding
cache → latency-measured query loop.

    python -m repro_torch.launch.serve_gcn --preset ppi_sota \
        --checkpoint-dir /tmp/ck --queries 1024
    python -m repro_torch.launch.serve_gcn --preset ppi_tiny \
        --checkpoint-dir /tmp/ck --device cpu --queries 256 \
        --verify-parity --bench-out /tmp/serve.json

Same flags as `repro.launch.serve_gcn`, plus `--device` (default
"cuda"; a host without a GPU must pass `--device cpu`). Loads the spec
(--preset/--spec + --set), restores params from the newest intact
checkpoint, precomputes the per-cluster embedding cache on the device
(skipped on a warm cache: the directory is keyed on checkpoint step +
partition fingerprint), then answers `--queries` random lookups in
mixed-size batches across the padding-bucket ladder and reports
per-bucket p50/p99 latency and overall QPS.

With no checkpoint on disk the CLI TRAINS the preset first on
`--device` (the spec's run section says how; `core.experiment.
build_experiment(...).fit()` writes the checkpoint into the serving
directory), so the one-liner works from a blank tree.
`--verify-parity` cross-checks every served logit against the host
oracle (core.trainer.full_graph_logits): at 1e-5 on the CPU (the
reference's contract) and at 1e-4·max(1, max|ref|) on a GPU, whose
kernels sum 2048-wide layers in other orders. `--bench-out` writes
the latency rows as BENCH json (metric: p50_s, lower is better).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from repro_torch.launch.run_experiment import DEFAULT_RESULTS, load_spec

PARITY_TOL = 1e-5          # max|Δ| on the CPU
CARD_PARITY_TOL = 1e-4     # max|Δ| / max(1, max|ref|) on a GPU


def _percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _train_if_needed(spec, ckpt_dir: str, device) -> None:
    """Cold start: no usable checkpoint under ckpt_dir → run the spec's
    training loop on `device` to produce one (the serve CLI stays a
    one-liner)."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    if CheckpointManager(ckpt_dir).latest_valid_step() is not None:
        return
    print(f"[serve_gcn] no checkpoint in {ckpt_dir} — training "
          f"{spec.name} for {spec.run.epochs} epoch(s) first",
          file=sys.stderr)
    from repro_torch.core.experiment import build_experiment
    train_spec = spec.copy()
    train_spec.run.checkpoint_dir = ckpt_dir
    build_experiment(train_spec, device=device).fit()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve_gcn",
        description="serve GCN predictions from a training checkpoint "
                    "via the per-cluster embedding cache (PyTorch/CUDA)")
    ap.add_argument("--preset", help="registered preset name")
    ap.add_argument("--spec", help="path to a spec JSON file")
    ap.add_argument("--set", action="append", metavar="PATH=VALUE",
                    help="override a spec field (repeatable), e.g. "
                         "serve.max_batch=64")
    ap.add_argument("--queries", type=int, default=1024,
                    help="total node lookups to serve")
    ap.add_argument("--checkpoint-dir",
                    help="checkpoint directory (default: the spec's "
                         "run.checkpoint_dir, falling back to "
                         "<results-dir>/<name>/checkpoints); trains "
                         "first when empty")
    ap.add_argument("--results-dir", default=str(DEFAULT_RESULTS))
    ap.add_argument("--step", type=int, default=None,
                    help="serve this checkpoint step instead of the "
                         "newest intact one")
    ap.add_argument("--seed", type=int, default=0,
                    help="query-sampling RNG seed")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--verify-parity", action="store_true",
                    help="check every served logit against the host "
                         "full-graph oracle (1e-5 on the CPU, "
                         "1e-4·max(1, max|ref|) on a GPU)")
    ap.add_argument("--bench-out", metavar="PATH",
                    help="also write the latency rows as BENCH json")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[serve_gcn] {e}")
    spec = load_spec(args)
    ckpt_dir = (args.checkpoint_dir or spec.run.checkpoint_dir
                or str(pathlib.Path(args.results_dir) / spec.name
                       / "checkpoints"))

    if args.step is None:
        _train_if_needed(spec, ckpt_dir, device)

    from repro_torch.serve import ServeEngine
    engine = ServeEngine.from_checkpoint(spec, ckpt_dir, step=args.step,
                                         device=device)
    n_nodes = engine.graph.num_nodes
    print(f"[serve_gcn] {spec.name}: step "
          f"{engine.cache.checkpoint_step}, {n_nodes} nodes, "
          f"{engine.num_parts} clusters, buckets {engine.buckets}, "
          f"device {device}, cache {engine.cache.dir}", file=sys.stderr)
    t0 = time.perf_counter()
    warmed = engine.warm()
    precompute_s = time.perf_counter() - t0
    print(f"[serve_gcn] precompute: {warmed} cluster(s) in "
          f"{precompute_s:.3f}s "
          f"({'cold' if warmed else 'warm cache'})", file=sys.stderr)

    # mixed-size batches cycling through the bucket ladder, so every
    # bucket shape is exercised; the first touch of each bucket is a
    # warm-up excluded from the latencies
    rng = np.random.default_rng(args.seed)
    sizes, left, i = [], args.queries, 0
    while left > 0:
        b = engine.buckets[i % len(engine.buckets)]
        sizes.append(min(b, left))
        left -= sizes[-1]
        i += 1
    for b in engine.buckets:
        engine.query(rng.integers(0, n_nodes, size=b))

    per_bucket: dict = {}
    results = []
    t0 = time.perf_counter()
    for sz in sizes:
        ids = rng.integers(0, n_nodes, size=sz)
        r = engine.query(ids)
        results.append(r)
        per_bucket.setdefault(r.bucket, []).append(r.latency_s)
    wall = time.perf_counter() - t0
    qps = args.queries / wall

    bench_rows = []
    for b in sorted(per_bucket):
        lats = per_bucket[b]
        p50, p99 = _percentile(lats, 50), _percentile(lats, 99)
        bench_rows.append({
            "name": f"serve/{spec.name}/bucket{b}",
            "p50_s": p50, "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "requests": len(lats)})
        print(f"[serve_gcn] bucket {b:>5}: {len(lats):>5} req  "
              f"p50 {p50 * 1e3:8.3f} ms  p99 {p99 * 1e3:8.3f} ms",
              file=sys.stderr)
    print(f"[serve_gcn] served {args.queries} lookups in {wall:.3f}s "
          f"= {qps:,.0f} QPS", file=sys.stderr)

    if args.verify_parity:
        from repro_torch.core.trainer import full_graph_logits
        ref = full_graph_logits(engine.params, engine.graph, engine.cfg,
                                norm=engine.norm,
                                diag_lambda=engine.diag_lambda)
        worst = max(float(np.abs(r.logits - ref[r.node_ids]).max())
                    for r in results)
        bound = (PARITY_TOL if device.type == "cpu" else
                 CARD_PARITY_TOL * max(1.0, float(np.abs(ref).max())))
        status = "OK" if worst <= bound else "FAIL"
        print(f"[serve_gcn] parity vs host full-graph oracle: "
              f"max |Δ| = {worst:.2e} (bound {bound:.2e}) [{status}]",
              file=sys.stderr)
        if worst > bound:
            return 1

    if args.bench_out:
        bench_rows.append({"name": f"serve/{spec.name}/precompute",
                           "seconds": precompute_s,
                           "warmed_clusters": warmed})
        record = {"bench": "serve", "preset": spec.name,
                  "device": str(device),
                  "device_name": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                  "checkpoint_step": engine.cache.checkpoint_step,
                  "queries": args.queries, "qps": qps,
                  "buckets": list(engine.buckets), "rows": bench_rows}
        pathlib.Path(args.bench_out).write_text(
            json.dumps(record, indent=2, sort_keys=True) + "\n")
        print(f"[serve_gcn] wrote {args.bench_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
