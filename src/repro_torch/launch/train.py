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
a GPU must pass `--device cpu`). The port trains on one device: `--mesh
host` (the default) is that device; `pod` and `multipod` need the
reference's mesh sharding rules, which wait for ROADMAP A7, and raise.
The train state ({params, step, mu, nu}: fp32 params and AdamW moments,
`dist.steps.spec_train_state`) is drawn from `--seed` on the device;
with `--ckpt` it is restored from the latest valid step there, and the
checkpoint keys are the reference's, so either package resumes the
other's run. Batches come from the Markov-chain `TokenPipeline`, a pure
function of (seed, step). Every step's loss is read back, so each step
ends synchronised; the JSON log lines follow `--log-every` as in the
reference. `main(argv)` returns the per-step metrics and wall seconds.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import CellPolicy
from repro_torch.dist.steps import make_train_step, spec_train_state
from repro_torch.models.spec import init_tree, spec_params
from repro_torch.nn.optim import adamw, warmup_cosine_schedule
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.resilience import (PreemptionHandler,
                                            StragglerDetector)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM training on one device (PyTorch/CUDA)")
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

    if args.mesh != "host":
        raise SystemExit(f"[train] --mesh {args.mesh} needs the mesh "
                         f"sharding rules, not ported yet (ROADMAP A7); "
                         f"the port trains on one device (--mesh host)")
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[train] {e}")
    cfg = get_arch(args.arch, smoke=args.smoke)
    policy = CellPolicy(fsdp=False, microbatches=args.microbatches,
                        remat=True, loss_chunk=min(512, args.seq))
    opt = adamw(warmup_cosine_schedule(args.lr, 10, args.steps),
                weight_decay=0.01, clip_norm=1.0)
    step_fn = make_train_step(cfg, policy, opt)

    st_specs = spec_train_state(cfg)
    print(f"[train] {cfg.name}: {spec_params(st_specs['params']):,} "
          f"params, device {device}")
    state = init_tree(st_specs, torch.Generator(device=device)
                      .manual_seed(args.seed), device)
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state = ckpt.restore(state, device=device)
        start_step = int(state["step"])
        print(f"[train] restored checkpoint at step {start_step}")

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
                print(json.dumps({
                    "step": step + 1,
                    "loss": round(row["loss"], 4),
                    "acc": round(row["acc"], 4),
                    "s_per_step": round(dt / args.log_every, 3),
                    **({"stragglers": flagged} if flagged else {}),
                }))
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
            if pre.should_stop:
                print("[train] preemption signal — checkpoint + exit")
                if ckpt:
                    ckpt.save(step + 1, state, blocking=True)
                return dict(arch=cfg.name, device=str(device),
                            start_step=start_step, history=history,
                            preempted=True)
    if ckpt:
        ckpt.save(args.steps, state, blocking=True)
    print("[train] done")
    return dict(arch=cfg.name, device=str(device), start_step=start_step,
                history=history, preempted=False)


if __name__ == "__main__":
    main()
