"""Readings that set the limits of `correct` (never run by the
benchmark's own runs):

  control   the reference put in the program's place, computed in TF32
            (the precision below the configuration's fp32 with TF32
            off), judged by the fp32 reference as a run of the program
            is;
  fault     a run of the program through the harness with a fault
            planted under its timed path: half_batch (half of each
            batch left out, the mean taken over the rest),
            state_unchanged (a step that returns its state as it was)
            or leaf_frozen (the last layer's weight left unmoved);
  random    the partition replaced by a uniformly random assignment
            (the port's own `random_partition`).

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        [--fault half_batch|state_unchanged|leaf_frozen] [--random-partition]

prints one JSON line per seed with every number of `check.NAMES` and
the name of the card it ran on. It needs a CUDA device, as a run does:
TF32 on the CPU is fp32, and a control read there would read sound.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import harness, spec  # noqa: E402


def setup(bm, name, root, device):
    """The cell's graph, the program's partition and padded batch size,
    made as a run's set-up makes them."""
    import numpy as np
    from repro_torch.core.experiment import (apply_overrides,
                                             build_experiment, preset)
    from repro_torch.graph.csr import CSRGraph

    from bench.drivers.train import settings
    from bench.graphs import sbm
    cell = spec.cell(bm, name, root)
    conf = cell["config"]
    arrays = sbm.load_or_make(conf["graph"],
                              harness.cache_dir(root) / "graphs")
    graph = CSRGraph(indptr=arrays["indptr"], indices=arrays["indices"],
                     data=np.ones(len(arrays["indices"]), np.float32),
                     features=arrays["features"], labels=arrays["labels"],
                     train_mask=arrays["train_mask"])
    s = settings(cell, 0)
    run_spec = apply_overrides(preset(conf["preset"]), dict(s))
    run_spec.partition.cache_dir = str(harness.cache_dir(root) / "partitions")
    exp = build_experiment(run_spec, graph=graph, device=device)
    return cell, arrays, np.asarray(exp.parts), exp.batcher.node_cap


def control_numbers(bm, name, seeds, *, device, root=spec.ROOT):
    """check.NAMES of the TF32 reference in the program's place, one
    dict per seed."""
    from bench.drivers.train import settings
    from bench.reference import check
    from bench.reference import cluster_gcn as ref
    cell, arrays, parts, cap = setup(bm, name, root, device)
    steps = int(cell["traffic"]["checked_steps"])
    out = []
    for seed in seeds:
        s = settings(cell, seed)
        recipe = ref.Recipe.from_settings(s)
        kw = dict(run_seed=int(s["run.seed"]), batch_seed=int(s["batch.seed"]),
                  cap=cap, steps=steps, device=device)
        low = ref.run_steps(arrays, parts, recipe, precision="tf32", **kw)
        want = ref.run_steps(arrays, parts, recipe, **kw)
        prog = dict(losses=low.losses, params0=low.params0,
                    params_last=low.params_last, payloads=None,
                    mu1={k: v * (1 - recipe.b1) for k, v in low.grads1.items()})
        part = check.partition_numbers(arrays["indptr"], arrays["indices"],
                                       parts, recipe.num_parts)
        nums = check.all_numbers(prog, want, recipe.b1,
                                 part["partition_vs_chance"])
        out.append(dict(seed=seed, correct=check.verdict(nums, cell["limits"]),
                        **nums, diagnostics=check.diagnostics(prog, want, recipe.b1)))
    return out


def random_partition(bm, name, root=spec.ROOT) -> dict:
    from repro_torch.graph.partition import random_partition

    from bench.graphs import sbm
    from bench.reference import check
    cell = spec.cell(bm, name, root)
    arrays = sbm.load_or_make(cell["config"]["graph"],
                              harness.cache_dir(root) / "graphs")
    p = int(cell["config"]["set"]["partition.num_parts"])
    parts = random_partition(len(arrays["indptr"]) - 1, p, seed=0)
    return check.partition_numbers(arrays["indptr"], arrays["indices"],
                                   parts, p)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault",
                    choices=("half_batch", "state_unchanged", "leaf_frozen"))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--random-partition", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    root = spec.ROOT
    bm = spec.load(root)
    harness.point_caches(root)
    import torch
    if not torch.cuda.is_available():
        print("the control needs a CUDA device; none is visible",
              file=sys.stderr)
        return 3
    device = "cuda"
    card = torch.cuda.get_device_name(0)
    if args.random_partition:
        print(json.dumps({"workload": args.workload, "device": card,
                          "random_partition":
                          random_partition(bm, args.workload, root)}))
    if args.fault:
        for seed in seeds:
            r = harness.run_cell(bm, args.workload, seed=seed,
                                 seconds=args.seconds, trace=False,
                                 device=device, t_start=T_START, root=root,
                                 fault=args.fault)
            print(json.dumps(dict(workload=args.workload, fault=args.fault,
                                  device=card, seed=seed,
                                  correct=r["correct"],
                                  **{k: v["value"] for k, v in
                                     r["checks"].items()})), flush=True)
        return 0
    for row in control_numbers(bm, args.workload, seeds, device=device,
                               root=root):
        print(json.dumps(dict(workload=args.workload, control="tf32",
                              device=card, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
