"""Dry-run of the PAPER'S OWN training step on the production mesh — the
port of `repro.launch.dryrun_gcn`: distributed Cluster-GCN at the
PPI-SOTA shape (5 layers × 2048 hidden, multilabel), traced the way
`launch/dryrun.py` traces the LM cells (a fake process group of 256 or
512 ranks, fake tensors, the cost walker of `launch/cost_analysis` on
rank 0's local ops).

    python -m repro_torch.launch.dryrun_gcn --variant all [--multipod]

Clusters are the data-parallel unit, as in the paper and the port's
`dist/steps.py` `make_gcn_train_step`: each data shard takes its OWN
cluster batch (the block-diagonal objective of Eq. 6/7 decomposes
exactly), computes its gradient, and the gradients meet in ONE
all-reduce of a flat fp32 buffer over the data axes (two on the
multipod mesh: pod, then data); every shard then applies the same
AdamW update. Along 'model' the weights are replicated and every rank
of a model group computes the same cluster, except in the
tensor-parallel variants.

Variants (the reference's):
  base    — paper-faithful: fp32, dense Â, weights replicated over model
  bf16    — bf16 params and features (the products accumulate in fp32)
  ax      — + paper §6.2 A'X precompute (the first propagation hoisted
            to the batch builder)
  tp      — + tensor-parallel hidden layers over 'model': alternating
            column (Shard(1)) and row (Shard(0)) weights, DTensors on
            the mesh's 'model' axis
  q4      — tp with q = 4 clusters per shard batch (cap 4 × 1280)
  sparse  — Â as a BlockEllAdj (block-ELL tiles + transpose), every
            Â·(XW) forward and backward through the block-ELL product
            (its plain version on these fake CPU tensors), K = cap/B
  sparsek — the same at the fill-adaptive K = 4 ≪ cap/B = 10

Per variant it writes results/dryrun_torch/clustergcn-ppi-sota__
train_cluster__<mesh>__<variant>.json with the fields of
`launch/dryrun.py`'s records. Importing this module starts no process
group.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch
import torch.distributed as dist

from repro_torch.core.gcn import GCNConfig, gcn_loss
from repro_torch.kernels.block_spmm import BlockEllAdj
from repro_torch.launch.dryrun import (RESULTS, fake_world, roofline,
                                       summary_line)
from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                                     data_axes, make_production_mesh,
                                     production_shape)
from repro_torch.nn.optim import AdamState, adamw, apply_updates
from repro_torch.nn.tree import tree_leaves, tree_map, tree_unflatten

# PPI-SOTA shape (paper §4.3 Table 10): node_cap from p=50 partitions of
# the 56944-node PPI graph (avg cluster ~1139 -> cap 1280 = 10×128)
CFG = dict(in_dim=50, hidden_dim=2048, out_dim=121, num_layers=5,
           node_cap=1280)
VARIANTS = ("base", "bf16", "ax", "tp", "q4", "sparse", "sparsek")
_TILE = 128


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _tp_placement(i: int, din: int, dout: int, msize: int):
    """(w, b) placements on the 'model' axis for layer i: column-sharded
    at even layers, row-sharded at odd ones, replicated where the dim
    does not divide (the reference's `wspec`)."""
    from torch.distributed.tensor import Replicate, Shard
    if i % 2 == 0 and dout % msize == 0:
        return (Shard(1),), (Shard(0),)
    if i % 2 == 1 and din % msize == 0:
        return (Shard(0),), (Replicate(),)
    return (Replicate(),), (Replicate(),)


def build(variant: str, mesh):
    """(step, state, batch) of one rank: its cluster batch and the
    {params, step, mu, nu} state; the tensors are made with
    torch.empty, so build under a FakeTensorMode for no storage."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from "
                         f"{VARIANTS}")
    cap = CFG["node_cap"] * (4 if variant == "q4" else 1)
    bf16 = variant in ("bf16", "ax", "tp", "q4")
    tp = variant in ("tp", "q4")
    dt = torch.bfloat16 if bf16 else torch.float32
    cfg = GCNConfig(in_dim=CFG["in_dim"], hidden_dim=CFG["hidden_dim"],
                    out_dim=CFG["out_dim"], num_layers=CFG["num_layers"],
                    dropout=0.0, multilabel=True, layernorm=False,
                    precompute_ax=variant in ("ax", "tp", "q4"))

    if variant in ("sparse", "sparsek"):
        nrb = cap // _TILE
        K = 4 if variant == "sparsek" else nrb
        tiles = (nrb, K, _TILE, _TILE)
        adj = BlockEllAdj(torch.empty(tiles, dtype=dt),
                          torch.empty((nrb, K), dtype=torch.int32),
                          torch.empty(tiles, dtype=dt),
                          torch.empty((nrb, K), dtype=torch.int32),
                          checked=True)
    else:
        adj = torch.empty((cap, cap), dtype=dt)
    batch = (adj,
             torch.empty((cap, CFG["in_dim"]), dtype=dt),
             torch.empty((cap, CFG["out_dim"]), dtype=torch.float32),
             torch.empty((cap,), dtype=torch.bool),
             torch.empty((cap,), dtype=torch.float32),
             torch.empty((), dtype=torch.int32))

    model = mesh["model"] if tp else None
    msize = int(mesh["model"].size()) if tp else 1
    layers = []
    for i, (din, dout) in enumerate(cfg.dims):
        w = torch.empty((din, dout), dtype=torch.float32)
        b = torch.empty((dout,), dtype=torch.float32)
        if tp:
            from torch.distributed.tensor import distribute_tensor
            pw, pb = _tp_placement(i, din, dout, msize)
            w = distribute_tensor(w, model, pw, src_data_rank=None)
            b = distribute_tensor(b, model, pb, src_data_rank=None)
        layers.append({"w": w, "b": b})
    params = {"layers": layers}
    zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
    state = {"params": params, "step": torch.zeros((), dtype=torch.int32),
             "mu": zeros(), "nu": zeros()}

    opt = adamw(1e-2)
    groups = [mesh[a] for a in data_axes(mesh)]
    dsize = math.prod(int(g.size()) for g in groups)

    def train_step(state, batch):
        from torch.distributed._functional_collectives import all_reduce
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            params = state["params"]
            leaves = tree_leaves(params)
            live = [p.detach().requires_grad_(True) for p in leaves]
            p = tree_unflatten(params, [x.to(dt) for x in live])
            loss, _ = gcn_loss(p, batch, cfg, train=False)
            grads = torch.autograd.grad(loss, live)
            grads = [g.redistribute(x.device_mesh, x.placements)
                     if isinstance(g, DTensor) else g
                     for g, x in zip(grads, leaves)]
            # the data-parallel sync: ONE all-reduce of every local
            # gradient shard, flat fp32, per data axis
            flat = torch.cat([_local(g).reshape(-1).float() for g in grads])
            for g in groups:
                flat = all_reduce(flat, "sum", g)
            flat = flat / dsize
            synced, off = [], 0
            for g in grads:
                n = _local(g).numel()
                part = flat[off:off + n].view(_local(g).shape)
                off += n
                synced.append(DTensor.from_local(
                    part, g.device_mesh, g.placements, run_check=False)
                    if isinstance(g, DTensor) else part)
            with torch.no_grad():
                updates, ost = opt.update(
                    tree_unflatten(params, synced),
                    AdamState(state["step"], state["mu"], state["nu"]),
                    params)
                new = {"params": apply_updates(params, updates),
                       "step": ost.step, "mu": ost.mu, "nu": ost.nu}
        return new, loss.detach()

    return train_step, state, batch


def run(variant: str, multi_pod: bool = False, save: bool = True) -> dict:
    """Trace one variant on a fake world of the production mesh's size
    and return (and save) its record; a failure is recorded."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cost_analysis import run_step
    shp, _ = production_shape(multi_pod)
    fake_world(math.prod(shp))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = dict(arch="clustergcn-ppi-sota", shape="train_cluster",
               mesh="multipod" if multi_pod else "pod", tag=variant)
    t0 = time.perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, state, batch = build(variant, mesh)
        _, walker, memory = run_step(step, state, batch)
        walked = walker.summary()
        rec.update(status="ok", trace_s=round(time.perf_counter() - t0, 1),
                   flops_per_device=float(walked["flops"]),
                   bytes_accessed_per_device=float(walked["bytes"]),
                   collectives=walked["collectives"], memory=memory,
                   num_devices=int(math.prod(tuple(mesh.shape))),
                   mesh_shape=dict(zip(mesh.mesh_dim_names,
                                       (int(s) for s in mesh.shape))))
        rec["roofline"] = roofline(rec, PEAK_FLOPS_FP32 if variant in (
            "base", "sparse", "sparsek") else PEAK_FLOPS_BF16)
    except Exception as e:  # record failures — they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        name = f"clustergcn-ppi-sota__train_cluster__{rec['mesh']}__" \
               f"{variant}.json"
        (RESULTS / name).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.dryrun_gcn",
        description="Trace the Cluster-GCN training step on a fake "
                    "production mesh")
    ap.add_argument("--variant", default="all", choices=VARIANTS + ("all",))
    ap.add_argument("--multipod", action="store_true")
    args = ap.parse_args(argv)
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    errors = 0
    try:
        for v in variants:
            t0 = time.perf_counter()
            r = run(v, args.multipod)
            print(summary_line(dict(r, arch=f"{r['arch']} {v}"),
                               time.perf_counter() - t0))
            errors += r["status"] == "error"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
