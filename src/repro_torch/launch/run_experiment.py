"""Declarative experiment runner on the port — the training driver of
`repro.launch.run_experiment`, plus `--device`.

    python -m repro_torch.launch.run_experiment --preset ppi_sota \
        --set batch.sparse_adj=true --set model.fuse_spmm=true
    python -m repro_torch.launch.run_experiment --preset ppi_tiny \
        --device cpu --set run.checkpoint_dir=/tmp/ck
    python -m repro_torch.launch.run_experiment --spec results/.../spec.json \
        --resume
    python -m repro_torch.launch.run_experiment --preset reddit --print-spec
    torchrun --nproc_per_node 2 -m repro_torch.launch.run_experiment \
        --preset ppi_sota --set execution.data_shards=2 \
        --set execution.compression=8

Start from a registered preset (--preset, see --list-presets) or a spec
JSON file (--spec), layer `--set section.field=value` overrides (values
are JSON literals with plain-string fallback), then either print the
resolved spec (--print-spec) or build + fit. `--resume` continues from
the newest checkpoint in run.checkpoint_dir on the same trajectory as an
uninterrupted run. `--device` defaults to "cuda"; a host without a GPU
must pass `--device cpu`.

`execution.data_shards=N` trains data parallel: under `torchrun
--nproc_per_node N` each rank joins the process group torchrun
describes (NCCL on CUDA, one card per rank: cuda:$LOCAL_RANK; gloo on
the CPU); without torchrun only N=1 runs, as a world of 1. Rank 0 alone
writes the two files below and prints.

Every run writes its reproducibility artifact next to its metrics:
    <results-dir>/<spec.name>/spec.json     resolved spec (round-trips)
    <results-dir>/<spec.name>/metrics.json  history + final eval score
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import warnings

from repro_torch.core.experiment import (ExperimentSpec, apply_overrides,
                                         list_presets, parse_set_items,
                                         preset, validate)

# cwd-relative so non-editable installs don't write into site-packages
DEFAULT_RESULTS = pathlib.Path("results") / "experiments"


def load_spec(args) -> ExperimentSpec:
    """--preset or --spec, then every --set override, validated."""
    if args.preset and args.spec:
        raise SystemExit("pass --preset OR --spec, not both")
    if args.preset:
        spec = preset(args.preset)
    elif args.spec:
        spec = ExperimentSpec.from_json(
            pathlib.Path(args.spec).read_text())
    else:
        raise SystemExit("one of --preset/--spec is required "
                         "(see --list-presets)")
    try:
        apply_overrides(spec, parse_set_items(args.set))
    except (ValueError, KeyError) as e:
        # KeyError: unknown --set path; ValueError: malformed item
        raise SystemExit(str(e).strip('"'))
    return validate(spec)


def init_distributed(spec: ExperimentSpec, device) -> bool:
    """Initialise the default process group that execution.data_shards
    asks for: from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT), or, without torchrun, a world of 1 for
    data_shards=1. NCCL on CUDA, gloo on the CPU. Returns True when this
    call initialised the group (the caller destroys it)."""
    import torch
    import torch.distributed as dist
    if spec.execution.data_shards is None or dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        from repro_torch.device import rank_device
        torch.cuda.set_device(rank_device(device))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif spec.execution.data_shards == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise SystemExit(
            f"execution.data_shards={spec.execution.data_shards} needs "
            f"one process per rank: torchrun --nproc_per_node "
            f"{spec.execution.data_shards} -m "
            f"repro_torch.launch.run_experiment ...")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.run_experiment",
        description="build + run a declarative Cluster-GCN experiment "
                    "(PyTorch/CUDA)")
    ap.add_argument("--preset", help="registered preset name")
    ap.add_argument("--spec", help="path to a spec JSON file")
    ap.add_argument("--set", action="append", metavar="PATH=VALUE",
                    help="override a spec field, e.g. run.epochs=2 "
                         "(repeatable; JSON-literal values)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved spec JSON and exit")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in "
                         "run.checkpoint_dir")
    ap.add_argument("--results-dir", default=str(DEFAULT_RESULTS),
                    help="where <name>/spec.json + metrics.json land")
    ap.add_argument("--device", default="cuda",
                    help="where training runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.list_presets:
        print("\n".join(list_presets()))
        return 0

    spec = load_spec(args)
    if args.print_spec:
        print(spec.to_json(indent=2))
        return 0
    if args.resume and not spec.run.checkpoint_dir:
        raise SystemExit("--resume needs run.checkpoint_dir in the spec "
                         "(e.g. --set run.checkpoint_dir=/tmp/ck)")
    from repro_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[run_experiment] {e}")

    import torch.distributed as dist
    owns_group = init_distributed(spec, device)
    try:
        return _run(spec, args, device)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(spec: ExperimentSpec, args, device) -> int:
    from repro_torch.core.experiment import build_experiment
    exp = build_experiment(spec, device=device)
    device = exp.engine.device
    rank = exp.engine.rank
    # the reproducibility artifact goes down BEFORE training so a
    # hard-killed run can still be resumed via --spec <...>/spec.json
    out = pathlib.Path(args.results_dir) / spec.name
    if rank == 0:
        out.mkdir(parents=True, exist_ok=True)
        (out / "spec.json").write_text(spec.to_json(indent=2))
    steps = exp.batcher.steps_per_epoch()
    if exp.partition_stats is not None:
        sampler_desc = (f"{spec.partition.num_parts} parts (within "
                        f"{exp.partition_stats.within_fraction:.1%})")
        if exp.partition_stats.cached is not None:
            sampler_desc += (", partition cache "
                             + ("hit" if exp.partition_stats.cached
                                else "miss"))
    else:    # partition-free SAINT sampler
        sampler_desc = (f"{spec.batch.sampler} sampler "
                        f"(budget {exp.batcher.budget})")
    world = exp.engine.world
    if world > 1 or exp.group is not None:
        sampler_desc += (f", data parallel over {world} rank(s) "
                         f"(compression {spec.execution.compression}, "
                         f"{exp.engine.backend.group_size} batches a step)")
    if rank == 0:
        print(f"[experiment] {spec.name}: {exp.graph.num_nodes} nodes, "
              f"{exp.graph.num_edges // 2} edges, {sampler_desc}, "
              f"{steps} batches/epoch x {spec.run.epochs} epochs on "
              f"{device}{', resume' if args.resume else ''}",
              file=sys.stderr)
    result = exp.fit(resume=args.resume)
    if rank != 0:
        return 0

    # final eval on the explicit split (or the warn-on-fallback "auto")
    from repro_torch.core.engine import resolve_eval_mask
    from repro_torch.core.trainer import evaluate
    split, mask = resolve_eval_mask(exp.graph, spec.run.eval_split,
                                    warner=warnings.warn)
    last = result.history[-1] if result.history else {}
    if (last.get("eval_split") == split and "val_score" in last
            and not exp.engine.preempted):
        # EvalHook already scored these exact params on this split at
        # the last epoch — skip the duplicate full-graph propagation
        final_score = last["val_score"]
    else:
        final_score = evaluate(result.params, exp.graph, exp.cfg, mask,
                               spec.batch.norm, spec.batch.diag_lambda)

    metrics = {"history": result.history,
               "final": {"split": split, "score": final_score},
               "seconds": result.seconds,
               "preempted": exp.engine.preempted,
               "stop_reason": exp.engine.stop_reason,
               "diverged": exp.engine.diverged,
               "global_step": exp.engine.global_step,
               "device": str(device)}
    (out / "metrics.json").write_text(json.dumps(metrics, indent=1))
    print(json.dumps({"name": spec.name, "epochs": len(result.history),
                      "final_" + split + "_score": round(final_score, 4),
                      "seconds": round(result.seconds, 1),
                      "results": str(out)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
