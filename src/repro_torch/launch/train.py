"""LM training launcher on the port — the counterpart of
`repro.launch.train`: the train step of `dist/steps.py` with the
runtime around it (deterministic data, checkpointing and restore,
preemption handling, straggler monitoring).

    python -m repro_torch.launch.train --arch llama3.2-1b \
        --batch 4 --seq 2048 --microbatches 2 --steps 6 --ckpt /tmp/ck
    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
        --device cpu --steps 6 --batch 8 --seq 64 --microbatches 2 \
        --ckpt /tmp/ck --ckpt-every 2

The reference's flags, plus `--device` (default "cuda"; a host without
a GPU must pass `--device cpu`). `--mesh` (the reference's):
  host      the default. Alone, one device and the unsharded step. Under
            torchrun (`--nproc_per_node N`), a (N, 1) ("data", "model")
            mesh over the ranks, FSDP off: the step of `dist/steps.py` on
            DTensors, the batch over "data" (NCCL and cuda:$LOCAL_RANK on
            CUDA, gloo on the CPU).
  pod       the (16, 16) production mesh, FSDP on; needs torchrun with
            exactly 256 ranks.
  multipod  (2, 16, 16), FSDP on; exactly 512 ranks.
Any other world stops with a message naming the ranks it needs; nothing
falls back to one device. The sharding rules are `dist.sharding`'s
`make_rules` for the CLI's (seq, batch) shape.
The train state ({params, step, mu, nu}: fp32 params and AdamW moments,
`dist.steps.spec_train_state`) is drawn from `--seed` on the device;
with `--ckpt` it is restored from the latest valid step there, and the
checkpoint keys are the reference's, so either package resumes the
other's run (on a mesh rank 0 writes it from the gathered state, and
every rank restores the whole state and keeps its shards). Batches come
from the Markov-chain `TokenPipeline`, a pure function of (seed, step),
so every rank builds the same global batch and keeps its shard. Every
step's loss is read back, so each step ends synchronised; the JSON log
lines follow `--log-every` as in the reference. `main(argv)` returns
the per-step metrics and wall seconds.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import rank_device, resolve_device
from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                       make_rules, shardings_for)
from repro_torch.dist.steps import make_train_step, spec_train_state
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     production_shape)
from repro_torch.models.config import ShapeConfig
from repro_torch.models.spec import init_tree, spec_params
from repro_torch.nn.tree import tree_map
from repro_torch.nn.optim import adamw, warmup_cosine_schedule
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.resilience import (PreemptionHandler,
                                            StragglerDetector)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM training on one device or a device mesh "
                    "(PyTorch/CUDA)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="host",
                    choices=("host", "pod", "multipod"))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args(argv)

    distributed = "WORLD_SIZE" in os.environ
    if args.mesh != "host" and not distributed:
        shape, axes = production_shape(args.mesh == "multipod")
        raise SystemExit(
            f"[train] --mesh {args.mesh} is the {shape} mesh over {axes}: "
            f"it needs {math.prod(shape)} ranks under torchrun "
            f"(--nproc_per_node ...); this process is one rank")
    try:
        device = (rank_device if distributed else resolve_device)(
            args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[train] {e}")
    owned = False
    if distributed and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        owned = True
    try:
        return _train(args, device, distributed)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, device: torch.device, distributed: bool) -> dict:
    cfg = get_arch(args.arch, smoke=args.smoke)
    mesh = None
    if distributed:
        try:
            mesh = make_debug_mesh(dist.get_world_size(), 1, device.type) \
                if args.mesh == "host" else make_production_mesh(
                    multi_pod=args.mesh == "multipod",
                    device_type=device.type)
        except RuntimeError as e:
            raise SystemExit(f"[train] --mesh {args.mesh}: {e}")
    rank0 = not distributed or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    policy = CellPolicy(fsdp=args.mesh != "host",
                        microbatches=args.microbatches, remat=True,
                        loss_chunk=min(512, args.seq))
    opt = adamw(warmup_cosine_schedule(args.lr, 10, args.steps),
                weight_decay=0.01, clip_norm=1.0)
    st_specs = spec_train_state(cfg)
    act_spec = shardings = None
    if mesh is not None:
        rules = make_rules(mesh, cfg, ShapeConfig("cli", "train", args.seq,
                                                  args.batch), policy)
        act_spec = (rules.get("batch"), None, None)
        shardings = shardings_for(st_specs, mesh, rules)
    step_fn = make_train_step(cfg, policy, opt, act_spec=act_spec,
                              mesh=mesh)

    where = f"device {device}" if mesh is None else \
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {device.type}"
    say(f"[train] {cfg.name}: {spec_params(st_specs['params']):,} "
        f"params, {where}")
    state = init_tree(st_specs, torch.Generator(device=device)
                      .manual_seed(args.seed), device)
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state = ckpt.restore(state, device=device)
        start_step = int(state["step"])
        say(f"[train] restored checkpoint at step {start_step}")
    if mesh is not None:
        state = distribute_tree(state, shardings)

    def save(step: int, blocking: bool = False) -> None:
        if mesh is None:
            ckpt.save(step, state, blocking=blocking)
            return
        full = tree_map(lambda t: t.full_tensor(), state)
        if rank0:
            ckpt.save(step, full, blocking=True)
        dist.barrier()

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)
    straggler = StragglerDetector()
    history = []
    t_last = time.perf_counter()
    with PreemptionHandler() as pre:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.batch_at(step).items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            row = {k: float(v) for k, v in metrics.items()}
            row.update(step=step + 1, seconds=time.perf_counter() - t0)
            history.append(row)
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                flagged = straggler.record({0: dt})
                say(json.dumps({
                    "step": step + 1,
                    "loss": round(row["loss"], 4),
                    "acc": round(row["acc"], 4),
                    "s_per_step": round(dt / args.log_every, 3),
                    **({"stragglers": flagged} if flagged else {}),
                }))
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if pre.should_stop:
                say("[train] preemption signal — checkpoint + exit")
                if ckpt:
                    save(step + 1, blocking=True)
                return dict(arch=cfg.name, device=str(device),
                            start_step=start_step, history=history,
                            preempted=True, mesh=where)
    if ckpt:
        save(args.steps, blocking=True)
    say("[train] done")
    return dict(arch=cfg.name, device=str(device), start_step=start_step,
                history=history, preempted=False, mesh=where)


if __name__ == "__main__":
    main()
