"""LANGUAGE-MODEL serving on the port: batched prefill + greedy decode
over the transformer stack (repro_torch.models.lm) — the counterpart of
`repro.launch.serve`, NOT the Cluster-GCN serving layer
(`repro_torch.launch.serve_gcn`).

    python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \
        --device cpu --batch 4 --prompt-len 32 --gen 16
    python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.serve --arch llama3.2-1b --smoke \
        --device cpu --mesh host --batch 4 --prompt-len 32 --gen 16

The reference's flags, plus `--device` (default "cuda"; a host without
a GPU must pass `--device cpu`). `--mesh` (the reference's):
  host      the default. Alone, one device. In a process group
            (torchrun, or a caller that initialised one), a (N, 1)
            ("data", "model") mesh over its N ranks: the prefill and
            decode steps of `dist/steps.py` on DTensors, the batch over
            "data" (NCCL and cuda:$LOCAL_RANK on CUDA, gloo on the CPU).
  pod       the (16, 16) production mesh; needs exactly 256 ranks.
  multipod  (2, 16, 16); exactly 512 ranks.
Any other world stops with a message naming the ranks it needs; nothing
falls back to one device. On a mesh the sharding rules are
`dist.sharding`'s `make_rules` for a decode cell of the CLI's context
and batch, FSDP and remat off, as the reference's CLI takes them; the
params and caches are laid out by `shardings_for`, the logits stay
vocab-sharded and the greedy token is their vocab-parallel argmax
(`layers.vocab_argmax`). Only rank 0 prints; every rank returns the
gathered tokens and logits.

Weights are random, drawn from `--seed` on the device (the reference
does the same); each matmul weight is cast to the compute dtype as soon
as it is drawn (identical values to a cast after init; a 20 B model
never holds its fp32 tree), the norm scales stay fp32. Prompts, and a
VLM's prefix embeddings after them, are drawn with numpy from `--seed`,
as the reference draws them (on every rank, each keeping its rows). The
KV caches hold the whole context (prefix, prompt and generated tokens)
and decode step i runs at position npfx + prompt_len + i. Prefill runs
the flash-attention kernel in every layer (on a CUDA device; under
`local_map` on a mesh); decode attends over the KV cache in plain
PyTorch.

The reference's CLI sizes its caches to prompt_len + gen without the
prefix, so its prefill raises for a VLM whenever gen < npfx (ROADMAP C,
R4); the port sizes them to the context.

Prints the prefill time, the decode rate and the first row's tokens, as
the reference does. `main(argv)` returns them with the launch counts of
the flash kernel during prefill and during decode.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.device import rank_device, resolve_device
from repro_torch.dist.sharding import (CellPolicy, distribute_tree,
                                       make_rules, placements, shardings_for)
from repro_torch.dist.steps import (_full, make_decode_step,
                                    make_prefill_step)
from repro_torch.kernels import flash_attention
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     production_shape)
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.layers import vocab_argmax
from repro_torch.models.lm import (cast_matmul_leaf, spec_caches,
                                   spec_params)
from repro_torch.models.spec import init_tree
from repro_torch.models.spec import spec_params as count_params


def _init_cast(specs, gen: torch.Generator, dev: torch.device,
               dtype: torch.dtype, key=None):
    """`init_tree(specs, gen, dev)` leaf by leaf in the same order (the
    same values), each matmul weight cast to `dtype` as soon as it is
    drawn: the fp32 copy of one leaf at a time is alive, never the whole
    fp32 tree beside its cast."""
    if isinstance(specs, dict):
        return {k: _init_cast(specs[k], gen, dev, dtype, k)
                for k in sorted(specs)}
    leaf = init_tree(specs, gen, dev)
    return cast_matmul_leaf(key, leaf, dtype)


def init_params(cfg: ArchConfig, seed: int, device) -> Dict:
    """Params on `device` from `seed`, the matmul weights in the compute
    dtype (`lm.cast_matmul_weights` of the fp32 init, value for
    value)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _init_cast(spec_params(cfg), gen, dev, cfg.dtype)


def init_serving(cfg: ArchConfig, batch: int, max_seq: int, seed: int,
                 device) -> tuple:
    """(params, caches) on `device`: `init_params`, and empty caches for
    `batch` rows of `max_seq` positions."""
    dev = resolve_device(device)
    caches = init_tree(spec_caches(cfg, batch, max_seq), torch.Generator(),
                       dev)
    return init_params(cfg, seed, dev), caches


def make_batch(cfg: ArchConfig, batch: int, prompt_len: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """Random prompts from numpy's generator seeded with `seed`, then,
    for a VLM, its prefix embeddings (B, npfx, d) fp32 from the same
    generator, as the reference draws them."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len),
                           dtype=np.int32)
    out = {"tokens": torch.from_numpy(prompts).to(device)}
    if cfg.num_prefix_embeddings:
        pfx = rng.normal(size=(batch, cfg.num_prefix_embeddings,
                               cfg.d_model)).astype(np.float32)
        out["prefix_embeddings"] = torch.from_numpy(pfx).to(device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM prefill + greedy decode on one device or a "
                    "device mesh (PyTorch/CUDA)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="host",
                    choices=("host", "pod", "multipod"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    distributed = dist.is_initialized() or "WORLD_SIZE" in os.environ
    if args.mesh != "host" and not distributed:
        shape, axes = production_shape(args.mesh == "multipod")
        raise SystemExit(
            f"[serve] --mesh {args.mesh} is the {shape} mesh over {axes}: "
            f"it needs {math.prod(shape)} ranks under torchrun "
            f"(--nproc_per_node ...); this process is one rank")
    try:
        device = (rank_device if distributed else resolve_device)(
            args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[serve] {e}")
    owned = False
    if distributed and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        owned = True
    try:
        return _serve(args, device, distributed)
    finally:
        if owned:
            dist.destroy_process_group()


def _serve(args, device: torch.device, distributed: bool) -> dict:
    cfg = get_arch(args.arch, smoke=args.smoke)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode serving")
    if args.gen < 1:
        raise SystemExit("--gen must be at least 1")
    mesh = None
    if distributed:
        try:
            mesh = make_debug_mesh(dist.get_world_size(), 1, device.type) \
                if args.mesh == "host" else make_production_mesh(
                    multi_pod=args.mesh == "multipod",
                    device_type=device.type)
        except RuntimeError as e:
            raise SystemExit(f"[serve] --mesh {args.mesh}: {e}")
    say = print if not distributed or dist.get_rank() == 0 else \
        (lambda *a, **k: None)
    npfx = cfg.num_prefix_embeddings
    max_seq = npfx + args.prompt_len + args.gen
    p_specs = spec_params(cfg)
    where = f"device {device}" if mesh is None else \
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {device.type}"
    say(f"[serve] {cfg.name}: {count_params(p_specs):,} params, {where}")
    params, caches = init_serving(cfg, args.batch, max_seq, args.seed,
                                  device)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, device)
    if mesh is None:
        prefill_fn = make_prefill_step(cfg)
        decode_fn = make_decode_step(cfg)
    else:
        from torch.distributed.tensor import distribute_tensor
        policy = CellPolicy(fsdp=False, remat=False)
        rules = make_rules(mesh, cfg, ShapeConfig(
            "cli", "decode", max_seq, args.batch), policy)
        act_spec = (rules.get("batch"), None, None)
        params = distribute_tree(params, shardings_for(p_specs, mesh, rules))
        caches = distribute_tree(caches, shardings_for(
            spec_caches(cfg, args.batch, max_seq), mesh, rules))
        batch = {k: distribute_tensor(v, mesh, placements(
            (act_spec[0],) + (None,) * (v.dim() - 1), mesh),
            src_data_rank=None) for k, v in batch.items()}
        prefill_fn = make_prefill_step(cfg, policy, act_spec)
        decode_fn = make_decode_step(cfg, policy, act_spec)

    with torch.no_grad():
        _sync(device)
        launches0 = flash_attention.LAUNCHES
        t0 = time.perf_counter()
        logits, caches = prefill_fn(params, batch, caches)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        launches1 = flash_attention.LAUNCHES
        prefill_logits = logits
        tok = vocab_argmax(logits).to(torch.int32)[:, None]

        generated = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            tok, logits, caches = decode_fn(params, tok, caches,
                                            args.prompt_len + npfx + i)
            generated.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
        launches2 = flash_attention.LAUNCHES
        out = _full(torch.cat(generated, dim=1)).cpu().numpy()
        prefill_logits = _full(prefill_logits).cpu()
        last_logits = _full(logits).cpu()

    toks_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    say(f"[serve] {cfg.name}: prefill {args.batch}×{args.prompt_len} "
        f"in {t_prefill:.2f}s; decode {args.gen - 1} steps "
        f"@ {toks_s:.1f} tok/s")
    say("[serve] sample generation (first row):", out[0][:16])
    return dict(arch=cfg.name, device=str(device), mesh=where,
                prefill_s=t_prefill, decode_s=t_decode,
                decode_steps=args.gen - 1, decode_tok_s=toks_s, tokens=out,
                prefill_logits=prefill_logits, last_logits=last_logits,
                launches={"prefill": launches1 - launches0,
                          "decode": launches2 - launches1})


if __name__ == "__main__":
    main()
