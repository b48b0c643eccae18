"""Step builders — the single-device counterparts of
`repro.dist.steps.make_prefill_step` / `make_decode_step`.

The reference closes over a `CellPolicy` and leaves sharding to the jit
in/out shardings; the port runs on one card, so a step is a plain
closure over the architecture config. The data-parallel GCN step
(`make_gcn_train_step`) will live beside them (ROADMAP A5).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import decode_step, prefill


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch, caches) -> (last-position logits, caches)."""
    def step(params, batch, caches):
        return prefill(params, cfg, batch, caches)
    return step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """(params, tokens (B, 1), caches, pos) -> (next greedy token (B, 1)
    int32, logits (B, V), caches). The argmax stays on the device, so a
    decode loop never waits for the host."""
    def step(params, tokens, caches, pos):
        logits, caches = decode_step(params, cfg, tokens, caches, pos)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        return nxt, logits, caches
    return step
