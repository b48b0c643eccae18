"""Unified pattern-stacked language model — the port of
`repro.models.lm`.

Layer stack = `num_groups` × `pattern` (params stacked on a leading
group axis) + unstacked `tail` blocks. Zamba2-style shared attention
blocks run at the end of every group, alternating between
`shared_attn_count` weight sets (`gidx % count`); each invocation has
its own KV cache, stacked on the group axis. The reference scans the
groups with `lax.scan`; here a Python loop walks the group axis, handing
each block views of its group's params and caches, so the caches keep
the reference's stacked layout and are written in place.

Entry points:
  spec_params / spec_caches — TensorSpec trees (single source of truth)
  lm_loss                   — training loss: chunked softmax CE, each
                              chunk under `torch.utils.checkpoint`, so
                              the logits of one chunk are live at a time
                              and recomputed in the backward
  prefill                   — run the prompt, write caches, last-position
                              logits
  decode_step               — one token in, caches updated
  encode                    — encoder-only forward (hubert): frame
                              logits (B, S, V)

With `remat` (training), each group runs under non-reentrant
`torch.utils.checkpoint`, the reference's `jax.checkpoint` with
`nothing_saveable`: only the group's input is kept, and the backward
recomputes the group.

`cast_matmul_leaf` is the rule for which params are cast once to the
compute dtype (identical values to the per-use cast): a leaf is cast
only if every use of it is a cast to the compute dtype, so the norm
scales, the sLSTM recurrence `r` and bias `b` (used in fp32) and the
Mamba2 `A_log` and `dt_bias` (fp32 decay) stay fp32.
`launch.serve.init_params` applies it to each leaf as it is drawn,
`cast_matmul_weights` to a whole fp32 tree. Training never pre-casts:
the fp32 masters are cast at each use, as in the reference.

Sharded runs: every entry point takes `act_spec`, the activations'
sharding spec (a tuple of mesh-axis entries, `(batch axis, None,
None)`). On DTensors (`dist/steps.py` with a mesh) the residual stream
is redistributed to it at the reference's constraint points, the
body's input and every group's output, and also at every sublayer's
output: DTensor places each op on its own, and would otherwise leave a
row-parallel product's partial sums pending in the residual stream
(`_constrain`). On plain tensors it is ignored, as the reference's
constraint is without a mesh.

Logits are fp32, computed from the compute-dtype operands (the
reference's `preferred_element_type=float32`): the rounded operands are
upcast, which is exact, and multiplied in fp32.

Batches carry "tokens" (B, S) int, or "embeddings" (B, S, d) and, for
training, "targets" (B, S) for the stub-frontend encoder (hubert), or
"prefix_embeddings" (B, npfx, d) and "tokens" for the VLM (paligemma),
whose prefix comes first.

Block kinds: `attn`, `local`, `enc` and `moe` (attention + the MoE
FFN), and the mixers of `models/gla.py`: `mamba2`, `mlstm`, `slstm`.
A prefill starts each SSM block from its cache's state, as the
reference's does, so it is given freshly zeroed caches.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import multi_head_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.gla import (mamba2_apply, mamba2_cache_spec,
                                    mlstm_apply, mlstm_cache_spec,
                                    slstm_apply, slstm_cache_spec,
                                    spec_mamba2, spec_mlstm, spec_slstm)
from repro_torch.models.layers import (attention_apply, attn_cache_spec,
                                       mlp_apply, moe_apply, rmsnorm,
                                       spec_attention, spec_mlp, spec_moe,
                                       spec_rmsnorm, vocab_parallel_nll,
                                       vocab_split)
from repro_torch.models.spec import TensorSpec, stack_specs
from repro_torch.nn.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any

_ATTN_MLP = ("attn", "local", "enc")
_ATTN_KINDS = _ATTN_MLP + ("moe",)
_SSM = {"mamba2": (spec_mamba2, mamba2_cache_spec, mamba2_apply),
        "mlstm": (spec_mlstm, mlstm_cache_spec, mlstm_apply),
        "slstm": (spec_slstm, slstm_cache_spec, slstm_apply)}
# params whose every use is a matmul operand (or a depthwise conv tap or
# a gate bias) cast to the compute dtype; the MoE's stacked expert
# weights share the dense MLP's names, the mLSTM's projections the
# attention's, the sLSTM's output projection the Mamba2's
_MATMUL_KEYS = frozenset(("embed", "lm_head", "wq", "wk", "wv", "wo",
                          "wg", "wu", "wd", "router", "in_proj", "out_proj",
                          "up_proj", "down_proj", "w_in", "w_gates",
                          "b_gates", "conv_w"))


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------
def spec_block(cfg: ArchConfig, kind: str) -> Dict:
    if kind in _ATTN_MLP:
        return {"attn": spec_attention(cfg), "mlp": spec_mlp(cfg)}
    if kind == "moe":
        return {"attn": spec_attention(cfg), "moe": spec_moe(cfg)}
    if kind in _SSM:
        return {kind: _SSM[kind][0](cfg)}
    raise ValueError(kind)


def cache_spec_block(cfg: ArchConfig, kind: str, batch: int,
                     max_seq: int) -> Dict:
    if kind in _ATTN_KINDS:
        return {"attn": attn_cache_spec(cfg, batch, max_seq, kind)}
    if kind in _SSM:
        return {kind: _SSM[kind][1](cfg, batch)}
    raise ValueError(kind)


def spec_params(cfg: ArchConfig) -> Dict:
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
    if cfg.shared_attn:
        specs["shared"] = {f"s{i}": {"attn": spec_attention(cfg),
                                     "mlp": spec_mlp(cfg)}
                           for i in range(cfg.shared_attn_count)}
    specs["final_norm"] = spec_rmsnorm(d)
    if not cfg.tie_embeddings or "embed" not in specs:
        specs["lm_head"] = TensorSpec((d, V), ("embed", "vocab"),
                                      init="normal", scale=d ** -0.5)
    return specs


def spec_caches(cfg: ArchConfig, batch: int, max_seq: int) -> Dict:
    caches: Dict[str, Any] = {
        "groups": {f"p{i}": stack_specs(
            cache_spec_block(cfg, k, batch, max_seq), cfg.num_groups,
            "layers") for i, k in enumerate(cfg.pattern)}}
    if cfg.tail:
        caches["tail"] = {f"t{i}": cache_spec_block(cfg, k, batch, max_seq)
                          for i, k in enumerate(cfg.tail)}
    if cfg.shared_attn:
        caches["shared"] = stack_specs(
            attn_cache_spec(cfg, batch, max_seq, "attn"), cfg.num_groups,
            "layers")
    return caches


def cast_matmul_leaf(key: str, leaf: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """The param leaf under `key`, cast to `dtype` if every use of it is
    a cast to the compute dtype (`_MATMUL_KEYS`), so a step reads it in
    the compute dtype instead of casting an fp32 weight at every use;
    any other leaf unchanged."""
    return leaf.to(dtype) if key in _MATMUL_KEYS else leaf


def cast_matmul_weights(params: Dict, dtype: torch.dtype) -> Dict:
    """`cast_matmul_leaf` over every leaf of `params`. The values the
    model sees are identical; the fp32 leaves stay fp32."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return cast_matmul_leaf(key, tree, dtype)
    return walk(params)


# ----------------------------------------------------------------------
# block application
# ----------------------------------------------------------------------
def _constrain(h: torch.Tensor, spec) -> torch.Tensor:
    """h redistributed to the sharding spec `spec` on its own mesh when
    h is a DTensor; h itself otherwise (or with no spec)."""
    if spec is None:
        return h
    from torch.distributed.tensor import DTensor
    if not isinstance(h, DTensor):
        return h
    from repro_torch.dist.sharding import constrain, placements
    return constrain(h, placements(spec, h.device_mesh))


def _apply_block(params, cfg: ArchConfig, kind: str, h: torch.Tensor, *,
                 positions, attn_fn, cache, decode_pos, act_spec=None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block; returns (h, the MoE aux loss or None). A given cache
    is written in place. Each sublayer's output is constrained to
    `act_spec` before the residual add (`_constrain`)."""
    if kind in _ATTN_KINDS:
        y, _ = attention_apply(
            params["attn"], cfg, h, kind=kind, positions=positions,
            attn_fn=attn_fn, cache=None if cache is None else cache["attn"],
            decode_pos=decode_pos)
        h = h + _constrain(y, act_spec)
        if kind == "moe":
            y2, aux = moe_apply(params["moe"], cfg, h)
            return h + _constrain(y2, act_spec), aux
        y = mlp_apply(params["mlp"], cfg, h)
        return h + _constrain(y, act_spec), None
    if kind not in _SSM:
        raise ValueError(kind)
    y, nc = _SSM[kind][2](params[kind], cfg, h,
                          cache=None if cache is None else cache[kind],
                          decode=decode_pos is not None)
    if cache is not None:
        for name, t in nc.items():
            cache[kind][name].copy_(t)
    return h + _constrain(y, act_spec), None


def _apply_shared(shared_params, cfg: ArchConfig, h: torch.Tensor,
                  gidx: int, *, positions, attn_fn, cache, decode_pos,
                  act_spec=None) -> torch.Tensor:
    """Zamba2 shared block after group `gidx`: attention + MLP with the
    weights `s{gidx % shared_attn_count}`; a given cache (this
    invocation's slot) is written in place."""
    p = shared_params[f"s{gidx % cfg.shared_attn_count}"]
    y, _ = attention_apply(p["attn"], cfg, h, kind="attn",
                           positions=positions, attn_fn=attn_fn,
                           cache=cache, decode_pos=decode_pos)
    h = h + _constrain(y, act_spec)
    return h + _constrain(mlp_apply(p["mlp"], cfg, h), act_spec)


def _run_body(params, cfg: ArchConfig, h: torch.Tensor, *, positions,
              attn_fn, caches: Optional[Tree], decode_pos,
              remat: bool = False, act_spec=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every group of the pattern (each followed by the shared block,
    if any), then the tail. Each block gets views of its group's slice
    of the stacked params and caches, so cache writes land in the
    stacked tensors. With `remat` (and no caches) each group runs under
    `torch.utils.checkpoint`. The body's input and each group's output
    are constrained to `act_spec`. Returns (h, the summed MoE aux
    loss)."""
    kw = dict(positions=positions, attn_fn=attn_fn, decode_pos=decode_pos,
              act_spec=act_spec)
    h = _constrain(h, act_spec)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    # each stacked param leaf split once into its group slices: the
    # backward then stacks the slices' grads in one op, where indexing
    # t[g] per group would add num_groups full-size zero-padded grads
    slices = [t.unbind(0) for t in tree_leaves(params["groups"])]

    def group(g: int, hh: torch.Tensor):
        aux = zero
        gp = tree_unflatten(params["groups"], [s[g] for s in slices])
        for i, kind in enumerate(cfg.pattern):
            gc = None if caches is None else tree_map(
                lambda t: t[g], caches["groups"][f"p{i}"])
            hh, a = _apply_block(gp[f"p{i}"], cfg, kind, hh, cache=gc,
                                 **kw)
            if a is not None:
                aux = aux + a
        if cfg.shared_attn:
            sc = None if caches is None else tree_map(lambda t: t[g],
                                                      caches["shared"])
            hh = _apply_shared(params["shared"], cfg, hh, g, cache=sc, **kw)
        return _constrain(hh, act_spec), aux

    aux = zero
    for g in range(cfg.num_groups):
        if remat and caches is None:
            h, a = checkpoint(group, g, h, use_reentrant=False)
        else:
            h, a = group(g, h)
        aux = aux + a
    for i, kind in enumerate(cfg.tail):
        c = None if caches is None else caches["tail"][f"t{i}"]
        h, a = _apply_block(params["tail"][f"t{i}"], cfg, kind, h, cache=c,
                            **kw)
        if a is not None:
            aux = aux + a
    return h, aux


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the (V, d) embedding for int tokens (B, S). A plain
    tensor is indexed. A DTensor is looked up Megatron-style under
    `local_map`, so no index op meets DTensor's sharding rules: the
    table's FSDP (data) shards are gathered, each rank indexes its own
    tokens in its own vocab shard (rows outside it are zero), and the
    rows are partial sums over the vocab's mesh axis (the caller's
    `_constrain` reduces them). The table's gradient is local: partial
    over the axes the tokens are split on, vocab-sharded as the
    table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(embed, DTensor):
        return embed[tokens.long()]
    from torch.distributed.tensor.experimental import local_map
    w = _gather_data(embed)
    mesh = w.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    t_pl = tuple(tokens.placements)
    vocab = [i for i, p in enumerate(w.placements) if p == Shard(0)]
    out_pl = tuple(Partial() if i in vocab else p
                   for i, p in enumerate(t_pl))
    grad_pl = tuple(Partial() if isinstance(tp, Shard) else wp
                    for tp, wp in zip(t_pl, w.placements))
    coord = mesh.get_coordinate()
    shard = 0
    for i in vocab:                     # this rank's vocab shard index
        shard = shard * mesh.size(i) + coord[i]

    def local(e, t):
        t = t.long()
        if not vocab:
            return e[t]
        lo = shard * e.shape[0]
        inside = (t >= lo) & (t < lo + e.shape[0])
        rows = e[torch.where(inside, t - lo, torch.zeros_like(t))]
        return rows * inside[..., None].to(rows.dtype)
    return local_map(local, out_placements=(out_pl,),
                     in_placements=(tuple(w.placements), t_pl),
                     in_grad_placements=(grad_pl, t_pl),
                     device_mesh=mesh)(w, tokens)


def _embed_inputs(params, cfg: ArchConfig, batch: Dict) -> torch.Tensor:
    """(B, S, d) in the compute dtype."""
    dt = cfg.dtype
    if cfg.input_mode == "embeddings":
        return batch["embeddings"].to(dt)
    tok_emb = _lookup(params["embed"], batch["tokens"]).to(dt)
    if cfg.emb_scale_by_sqrt_dim:
        tok_emb = tok_emb * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.num_prefix_embeddings:
        pfx = batch["prefix_embeddings"].to(dt)
        tok_emb = torch.cat([pfx, tok_emb], dim=1)
    return tok_emb


def _gather_data(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its shards over the data axes gathered (the FSDP
    all-gather of a weight before use); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    names = tuple(t.device_mesh.mesh_dim_names)
    return t.redistribute(t.device_mesh, [
        Replicate() if names[i] in ("pod", "data") else p
        for i, p in enumerate(t.placements)])


def _head_weight(params, cfg: ArchConfig) -> torch.Tensor:
    """The (d, V) head; in a sharded step gathered over the data axes,
    so the logits are vocab-parallel over 'model' and each rank computes
    only its own tokens' (DTensor would otherwise keep the FSDP dim
    sharded and sum partial logits of every rank's tokens)."""
    if "lm_head" in params:
        return _gather_data(params["lm_head"])
    return _gather_data(params["embed"].T)


def _fp32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 h @ w from compute-dtype operands: w rounded to h's dtype,
    both upcast (exact) and multiplied in fp32."""
    return h.float() @ w.to(h.dtype).float()


def _head(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 h @ head from compute-dtype operands (h (..., d))."""
    return _fp32_product(h, _head_weight(params, cfg))


def _softcap(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of h (B, d), softcapped where the arch says so."""
    return _softcap(cfg, _head(params, cfg, h))


# ----------------------------------------------------------------------
# training loss (chunked softmax CE)
# ----------------------------------------------------------------------
def _targets(cfg: ArchConfig, batch: Dict, B: int, S: int, device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets (B, S) int64, mask (B, S) fp32): next-token for LMs (the
    last position and a VLM's prefix masked out), frame-aligned for
    encoders."""
    if cfg.input_mode == "embeddings":
        targets = batch["targets"].long()
        return targets, torch.ones(targets.shape, device=device)
    tok = batch["tokens"].long()
    T = tok.shape[1]
    targets = torch.cat([tok[:, 1:], tok.new_zeros((B, 1))], 1)
    mask = torch.cat([torch.ones((B, T - 1), device=device),
                      torch.zeros((B, 1), device=device)], 1)
    npfx = S - T
    if npfx:
        targets = torch.cat([tok.new_zeros((B, npfx)), targets], 1)
        mask = torch.cat([torch.zeros((B, npfx), device=device), mask], 1)
    return targets, mask


def _ce_chunk(cfg: ArchConfig, hc: torch.Tensor, tc: torch.Tensor,
              mc: torch.Tensor, w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ masked NLL, Σ masked correct) of one chunk: fp32 logits from
    compute-dtype operands, softcapped; argmax takes the first maximum,
    as jax's does. In a sharded step whose head splits the vocab the
    logits stay vocab-parallel: `layers.vocab_parallel_nll` reduces
    row-sized values over the vocab's shards, never the vocab itself."""
    logits = _softcap(cfg, _fp32_product(hc, w))
    if vocab_split(logits):
        nll, correct = vocab_parallel_nll(logits, tc)
    else:
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, tc[..., None])[..., 0]
        correct = (logits.argmax(-1) == tc).float()
    return (nll * mc).sum(), (correct * mc).sum()


def lm_loss(params, cfg: ArchConfig, batch: Dict, *,
            attn_fn: Callable = multi_head_attention, remat: bool = True,
            loss_chunk: int = 512, moe_aux_weight: float = 0.01,
            act_spec=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token (or frame) cross-entropy, plus the MoE aux term
    weighted by `moe_aux_weight` per group. Returns (loss, metrics:
    "ce", "acc", "tokens", and "moe_aux" for MoE archs). The sequence is
    cut into `loss_chunk`-long pieces (the last zero-padded and masked);
    each runs under `torch.utils.checkpoint`, so the backward recomputes
    its logits."""
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)
    h, aux = _run_body(params, cfg, h, positions=positions, attn_fn=attn_fn,
                       caches=None, decode_pos=None, remat=remat,
                       act_spec=act_spec)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    targets, mask = _targets(cfg, batch, B, S, h.device)

    w = _head_weight(params, cfg)
    cl = min(loss_chunk, S)
    loss_sum = acc_sum = torch.zeros((), device=h.device)
    for start in range(0, S, cl):
        sl = slice(start, start + cl)
        hc, tc, mc = h[:, sl], targets[:, sl], mask[:, sl]
        pad = cl - hc.shape[1]
        if pad:
            hc = torch.cat([hc, hc.new_zeros((B, pad, hc.shape[2]))], 1)
            tc = torch.cat([tc, tc.new_zeros((B, pad))], 1)
            mc = torch.cat([mc, mc.new_zeros((B, pad))], 1)
        nll, correct = checkpoint(_ce_chunk, cfg, hc, tc, mc, w,
                                  use_reentrant=False)
        loss_sum = loss_sum + nll
        acc_sum = acc_sum + correct

    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = loss_sum / denom
    metrics = {"ce": loss, "acc": acc_sum / denom, "tokens": denom}
    if cfg.num_experts:
        loss = loss + moe_aux_weight * aux / cfg.num_groups
        metrics["moe_aux"] = aux
    return loss, metrics


def encode(params, cfg: ArchConfig, batch: Dict, *,
           attn_fn: Callable = multi_head_attention,
           act_spec=None) -> torch.Tensor:
    """Encoder-only forward (hubert's "prefill"): frame logits (B, S, V)
    in fp32 from compute-dtype operands, without the logit softcap, as
    the reference's `encode` returns them."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = _run_body(params, cfg, h, positions=positions, attn_fn=attn_fn,
                     caches=None, decode_pos=None, act_spec=act_spec)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def prefill(params, cfg: ArchConfig, batch: Dict, caches: Tree, *,
            attn_fn: Callable = multi_head_attention, act_spec=None
            ) -> Tuple[torch.Tensor, Tree]:
    """Run the prompt through the model, writing `caches` in place.
    Returns (last-position logits (B, V) fp32, caches)."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _ = _run_body(params, cfg, h, positions=positions, attn_fn=attn_fn,
                     caches=caches, decode_pos=None, act_spec=act_spec)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h[:, -1]), caches


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor,
                caches: Tree, pos: int, *, act_spec=None
                ) -> Tuple[torch.Tensor, Tree]:
    """One decode step. tokens: (B, 1) int; pos: int, the position of
    the incoming token. Returns (logits (B, V) fp32, caches, written in
    place). The position stays a host int, so a decode loop issues no
    host-device copy. Attention reads the cache (`decode_attention`), so
    no attention function is taken."""
    if cfg.input_mode == "embeddings":
        raise ValueError("encoder-only archs have no decode step")
    pos = int(pos)
    h = _lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.emb_scale_by_sqrt_dim:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    positions = torch.arange(pos, pos + 1, device=h.device)
    h, _ = _run_body(params, cfg, h, positions=positions, attn_fn=None,
                     caches=caches, decode_pos=pos, act_spec=act_spec)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h[:, 0]), caches
