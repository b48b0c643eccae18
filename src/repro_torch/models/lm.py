"""Unified pattern-stacked language model — the serving half of
`repro.models.lm` (everything but the training loss).

Layer stack = `num_groups` × `pattern` (params stacked on a leading
group axis) + unstacked `tail` blocks. The reference scans the groups
with `lax.scan`; here a Python loop walks the group axis, handing each
block views of its group's params and caches, so the caches keep the
reference's stacked layout and are written in place.

Entry points:
  spec_params / spec_caches — TensorSpec trees (single source of truth)
  prefill                   — run the prompt, write caches, last-position
                              logits
  decode_step               — one token in, caches updated
  encode                    — encoder-only forward (hubert): frame
                              logits (B, S, V)

`cast_matmul_leaf` is the rule for which params are cast once to the
compute dtype (identical values to the per-use cast; the norm scales
stay fp32): `launch.serve.init_params` applies it to each leaf as it is
drawn, `cast_matmul_weights` to a whole fp32 tree (the oracle the tests
hold init_params to).

Logits are fp32, computed from the compute-dtype operands (the
reference's `preferred_element_type=float32`): the rounded operands are
upcast, which is exact, and multiplied in fp32.

Batches carry "tokens" (B, S) int, or "embeddings" (B, S, d) for the
stub-frontend encoder (hubert), or "prefix_embeddings" (B, npfx, d) and
"tokens" for the VLM (paligemma), whose prefix comes first.

Block kinds: `attn`, `local`, `enc` and `moe` (attention + the MoE
FFN). The SSM mixers and the Zamba2 shared blocks raise
NotImplementedError naming their ROADMAP item; `lm_loss` comes with the
LM training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.ops import multi_head_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (attention_apply, attn_cache_spec,
                                       mlp_apply, moe_apply, rmsnorm,
                                       spec_attention, spec_mlp, spec_moe,
                                       spec_rmsnorm)
from repro_torch.models.spec import TensorSpec, stack_specs
from repro_torch.nn.tree import tree_map

Tree = Any

_ATTN_MLP = ("attn", "local", "enc")
_ATTN_KINDS = _ATTN_MLP + ("moe",)
_NOT_PORTED = {
    "mamba2": "the SSM blocks of models/gla.py, ROADMAP A6.5",
    "mlstm": "the SSM blocks of models/gla.py, ROADMAP A6.5",
    "slstm": "the SSM blocks of models/gla.py, ROADMAP A6.5",
    "shared_attn": "the Zamba2 shared blocks, ROADMAP A6.5",
}
# params whose every use is a matmul operand cast to the compute dtype
# (the MoE's stacked expert weights share the dense MLP's names)
_MATMUL_KEYS = frozenset(("embed", "lm_head", "wq", "wk", "wv", "wo",
                          "wg", "wu", "wd", "router"))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} blocks are not ported yet "
                               f"({_NOT_PORTED[what]})")


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------
def spec_block(cfg: ArchConfig, kind: str) -> Dict:
    if kind in _ATTN_MLP:
        return {"attn": spec_attention(cfg), "mlp": spec_mlp(cfg)}
    if kind == "moe":
        return {"attn": spec_attention(cfg), "moe": spec_moe(cfg)}
    if kind in _NOT_PORTED:
        raise _not_ported(kind)
    raise ValueError(kind)


def cache_spec_block(cfg: ArchConfig, kind: str, batch: int,
                     max_seq: int) -> Dict:
    if kind in _ATTN_KINDS:
        return {"attn": attn_cache_spec(cfg, batch, max_seq, kind)}
    if kind in _NOT_PORTED:
        raise _not_ported(kind)
    raise ValueError(kind)


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.shared_attn:
        raise _not_ported("shared_attn")


def spec_params(cfg: ArchConfig) -> Dict:
    _check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {}
    if cfg.input_mode == "tokens" or cfg.num_prefix_embeddings:
        specs["embed"] = TensorSpec((V, d), ("vocab", "embed"),
                                    init="normal", scale=0.02)
    specs["groups"] = {
        f"p{i}": stack_specs(spec_block(cfg, k), cfg.num_groups, "layers")
        for i, k in enumerate(cfg.pattern)}
    if cfg.tail:
        specs["tail"] = {f"t{i}": spec_block(cfg, k)
                         for i, k in enumerate(cfg.tail)}
    specs["final_norm"] = spec_rmsnorm(d)
    if not cfg.tie_embeddings or "embed" not in specs:
        specs["lm_head"] = TensorSpec((d, V), ("embed", "vocab"),
                                      init="normal", scale=d ** -0.5)
    return specs


def spec_caches(cfg: ArchConfig, batch: int, max_seq: int) -> Dict:
    _check_ported(cfg)
    caches: Dict[str, Any] = {
        "groups": {f"p{i}": stack_specs(
            cache_spec_block(cfg, k, batch, max_seq), cfg.num_groups,
            "layers") for i, k in enumerate(cfg.pattern)}}
    if cfg.tail:
        caches["tail"] = {f"t{i}": cache_spec_block(cfg, k, batch, max_seq)
                          for i, k in enumerate(cfg.tail)}
    return caches


def cast_matmul_leaf(key: str, leaf: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """The param leaf under `key`, cast to `dtype` if it is a matmul
    weight (embeddings, head, attention, MLP and MoE projections, the
    router), so a step reads it in the compute dtype instead of casting
    an fp32 weight at every use; any other leaf unchanged."""
    return leaf.to(dtype) if key in _MATMUL_KEYS else leaf


def cast_matmul_weights(params: Dict, dtype: torch.dtype) -> Dict:
    """`cast_matmul_leaf` over every leaf of `params`. The values the
    model sees are identical; norm scales stay fp32."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return cast_matmul_leaf(key, tree, dtype)
    return walk(params)


# ----------------------------------------------------------------------
# block application
# ----------------------------------------------------------------------
def _apply_block(params, cfg: ArchConfig, kind: str, h: torch.Tensor, *,
                 positions, attn_fn, cache, decode_pos
                 ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """One block; a MoE block's aux loss is dropped (serving reads no
    loss)."""
    if kind not in _ATTN_KINDS:
        raise _not_ported(kind) if kind in _NOT_PORTED else ValueError(kind)
    y, nc = attention_apply(
        params["attn"], cfg, h, kind=kind, positions=positions,
        attn_fn=attn_fn, cache=None if cache is None else cache["attn"],
        decode_pos=decode_pos)
    h = h + y
    if kind == "moe":
        h = h + moe_apply(params["moe"], cfg, h)[0]
    else:
        h = h + mlp_apply(params["mlp"], cfg, h)
    return h, None if cache is None else {"attn": nc}


def _run_body(params, cfg: ArchConfig, h: torch.Tensor, *, positions,
              attn_fn, caches: Optional[Tree], decode_pos
              ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """Every group of the pattern, then the tail. Each block gets views
    of its group's slice of the stacked params and caches, so cache
    writes land in the stacked tensors; returns (h, caches)."""
    _check_ported(cfg)
    for g in range(cfg.num_groups):
        for i, kind in enumerate(cfg.pattern):
            gp = tree_map(lambda t: t[g], params["groups"][f"p{i}"])
            gc = None if caches is None else tree_map(
                lambda t: t[g], caches["groups"][f"p{i}"])
            h, _ = _apply_block(gp, cfg, kind, h, positions=positions,
                                attn_fn=attn_fn, cache=gc,
                                decode_pos=decode_pos)
    for i, kind in enumerate(cfg.tail):
        c = None if caches is None else caches["tail"][f"t{i}"]
        h, _ = _apply_block(params["tail"][f"t{i}"], cfg, kind, h,
                            positions=positions, attn_fn=attn_fn, cache=c,
                            decode_pos=decode_pos)
    return h, caches


def _embed_inputs(params, cfg: ArchConfig, batch: Dict) -> torch.Tensor:
    """(B, S, d) in the compute dtype."""
    dt = cfg.dtype
    if cfg.input_mode == "embeddings":
        return batch["embeddings"].to(dt)
    tok_emb = params["embed"][batch["tokens"].long()].to(dt)
    if cfg.emb_scale_by_sqrt_dim:
        tok_emb = tok_emb * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.num_prefix_embeddings:
        pfx = batch["prefix_embeddings"].to(dt)
        tok_emb = torch.cat([pfx, tok_emb], dim=1)
    return tok_emb


def _head_weight(params, cfg: ArchConfig) -> torch.Tensor:
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def _head(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 h @ head from compute-dtype operands (h (..., d))."""
    w = _head_weight(params, cfg).to(h.dtype)
    return h.float() @ w.float()


def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of h (B, d), softcapped where the arch says so."""
    logits = _head(params, cfg, h)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def encode(params, cfg: ArchConfig, batch: Dict, *,
           attn_fn: Callable = multi_head_attention) -> torch.Tensor:
    """Encoder-only forward (hubert's "prefill"): frame logits (B, S, V)
    in fp32 from compute-dtype operands, without the logit softcap, as
    the reference's `encode` returns them."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = _run_body(params, cfg, h, positions=positions, attn_fn=attn_fn,
                     caches=None, decode_pos=None)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def prefill(params, cfg: ArchConfig, batch: Dict, caches: Tree, *,
            attn_fn: Callable = multi_head_attention
            ) -> Tuple[torch.Tensor, Tree]:
    """Run the prompt through the model, writing `caches` in place.
    Returns (last-position logits (B, V) fp32, caches)."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = _run_body(params, cfg, h, positions=positions,
                          attn_fn=attn_fn, caches=caches, decode_pos=None)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h[:, -1]), caches


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor,
                caches: Tree, pos: int) -> Tuple[torch.Tensor, Tree]:
    """One decode step. tokens: (B, 1) int; pos: int, the position of
    the incoming token. Returns (logits (B, V) fp32, caches, written in
    place). The position stays a host int, so a decode loop issues no
    host-device copy. Attention reads the cache (`decode_attention`), so
    no attention function is taken."""
    if cfg.input_mode == "embeddings":
        raise ValueError("encoder-only archs have no decode step")
    pos = int(pos)
    h = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.emb_scale_by_sqrt_dim:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    positions = torch.arange(pos, pos + 1, device=h.device)
    h, caches = _run_body(params, cfg, h, positions=positions,
                          attn_fn=None, caches=caches, decode_pos=pos)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h[:, 0]), caches
