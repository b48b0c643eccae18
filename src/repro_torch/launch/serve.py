"""LANGUAGE-MODEL serving on the port: batched prefill + greedy decode
over the transformer stack (repro_torch.models.lm) — the counterpart of
`repro.launch.serve`, NOT the Cluster-GCN serving layer
(`repro_torch.launch.serve_gcn`).

    python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \
        --device cpu --batch 4 --prompt-len 32 --gen 16

Same flags as the reference, with `--device` (default "cuda"; a host
without a GPU must pass `--device cpu`) in place of `--mesh`: the port
serves on one card. Weights are random, drawn from `--seed` on the
device (the reference does the same); the matmul weights are cast to
the compute dtype once after init (`lm.cast_matmul_weights`, identical
values), the norm scales stay fp32. Prompts are drawn with numpy from
`--seed`. Prefill runs the flash-attention kernel in every layer (on a
CUDA device); decode attends over the KV cache in plain PyTorch.

Prints the prefill time, the decode rate and the first row's tokens, as
the reference does. `main(argv)` returns them with the launch counts of
the flash kernel during prefill and during decode.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.dist.steps import make_decode_step, make_prefill_step
from repro_torch.kernels import flash_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (cast_matmul_weights, spec_caches,
                                   spec_params)
from repro_torch.models.spec import init_tree


def init_serving(cfg: ArchConfig, batch: int, max_seq: int, seed: int,
                 device) -> tuple:
    """(params, caches) on `device`: params from `seed` with the matmul
    weights cast to the compute dtype, empty caches for `batch` rows of
    `max_seq` positions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = cast_matmul_weights(init_tree(spec_params(cfg), gen, dev),
                                 cfg.dtype)
    caches = init_tree(spec_caches(cfg, batch, max_seq), gen, dev)
    return params, caches


def make_batch(cfg: ArchConfig, batch: int, prompt_len: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """Random prompts from numpy's generator seeded with `seed`, as the
    reference draws them (the VLM prefix embeddings come with
    ROADMAP A7.4)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len),
                           dtype=np.int32)
    return {"tokens": torch.from_numpy(prompts).to(device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM prefill + greedy decode on one device "
                    "(PyTorch/CUDA)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"[serve] {e}")
    cfg = get_arch(args.arch, smoke=args.smoke)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode serving")
    if args.gen < 1:
        raise SystemExit("--gen must be at least 1")
    max_seq = args.prompt_len + args.gen
    params, caches = init_serving(cfg, args.batch, max_seq, args.seed,
                                  device)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, device)
    prefill_fn = make_prefill_step(cfg)
    decode_fn = make_decode_step(cfg)

    with torch.no_grad():
        _sync(device)
        launches0 = flash_attention.LAUNCHES
        t0 = time.perf_counter()
        logits, caches = prefill_fn(params, batch, caches)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        launches1 = flash_attention.LAUNCHES
        prefill_logits = logits
        tok = logits.argmax(-1).to(torch.int32)[:, None]

        generated = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            tok, logits, caches = decode_fn(params, tok, caches,
                                            args.prompt_len + i)
            generated.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
        launches2 = flash_attention.LAUNCHES
    out = torch.cat(generated, dim=1).cpu().numpy()

    toks_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] {cfg.name}: prefill {args.batch}×{args.prompt_len} "
          f"in {t_prefill:.2f}s; decode {args.gen - 1} steps "
          f"@ {toks_s:.1f} tok/s")
    print("[serve] sample generation (first row):", out[0][:16])
    return dict(arch=cfg.name, device=str(device), prefill_s=t_prefill,
                decode_s=t_decode, decode_steps=args.gen - 1,
                decode_tok_s=toks_s, tokens=out,
                prefill_logits=prefill_logits.cpu(),
                last_logits=logits.cpu(),
                launches={"prefill": launches1 - launches0,
                          "decode": launches2 - launches1})


if __name__ == "__main__":
    main()
