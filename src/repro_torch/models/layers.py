"""Transformer building blocks — the port of `repro.models.layers`:
norms, RoPE, GQA attention with its KV caches (linear, or a ring of
`sliding_window` slots for 'local' layers), the dense MLP (SwiGLU /
GeGLU) and the MoE FFN (top-k routing, sort-based dispatch with
capacity, the Switch aux loss).

`spec_*` functions return TensorSpec trees (models/spec.py); the
matching `*_apply` functions take materialized params. Weights are cast
to the activations' dtype at every use, as in the reference; a caller
that casts the matmul weights once beforehand (`lm.cast_matmul_weights`)
gets identical values without the per-call cast. Norm scales stay fp32.

Caches are written in place: prefill and decode update the cache
tensors they are given and return that same dict (the reference returns
new arrays with the same values).

In a sharded step the same code runs on DTensors. Where DTensor cannot
carry a layout through a reshape (heads that do not split evenly over
the mesh), `_splittable` and `_pinned` gather the dim first; the MoE
buffers and expert weights take the reference's constraints
(`_moe_constrain`). Each is the identity on plain tensors. Logits whose
vocab is split over the mesh keep it split: their argmax and
cross-entropy reduce row-sized values over the shards (`vocab_argmax`,
`vocab_parallel_nll`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ArchConfig
from repro_torch.models.spec import TensorSpec

Tree = Any


# ----------------------------------------------------------------------
# norms / activations
# ----------------------------------------------------------------------
def spec_rmsnorm(d: int) -> Dict[str, TensorSpec]:
    return {"scale": TensorSpec((d,), ("embed",), init="zeros")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x) as `jax.nn.silu` runs it: σ = 1 / (1 + exp(-x)), each
    primitive rounded to x's dtype (XLA's expansion of `logistic`), so
    bf16 activations match the reference's bit for bit where a fused
    `F.silu` (one rounding) differs in a third of them."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(approximate=True)` primitive by primitive, with its
    constants rounded to x's dtype (0.796875 and 0.0446777 in bf16)."""
    c = float(torch.tensor((2 / torch.pi) ** 0.5, dtype=x.dtype))
    a = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def _act(name: str):
    return {"silu": _silu, "gelu": _gelu_tanh}[name]


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., T, D) with D even; positions: (T,). Half-split rotation
    (not interleaved) with fp32 angles; x is promoted to fp32 by the
    fp32 sin/cos (full tensors, so torch promotes as jnp does) and the
    result cast back to x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq            # (T, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention (GQA) + caches
# ----------------------------------------------------------------------
def spec_attention(cfg: ArchConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    sp = {
        "wq": TensorSpec((d, nq * hd), ("embed", "heads"), init="normal",
                         scale=d ** -0.5),
        "wk": TensorSpec((d, nkv * hd), ("embed", "kv"), init="normal",
                         scale=d ** -0.5),
        "wv": TensorSpec((d, nkv * hd), ("embed", "kv"), init="normal",
                         scale=d ** -0.5),
        "wo": TensorSpec((nq * hd, d), ("heads", "embed"), init="normal",
                         scale=(nq * hd) ** -0.5),
        "norm": spec_rmsnorm(d),
    }
    if cfg.qk_norm:
        sp["q_norm"] = {"scale": TensorSpec((hd,), (None,), init="zeros")}
        sp["k_norm"] = {"scale": TensorSpec((hd,), (None,), init="zeros")}
    if cfg.post_norm:
        sp["post"] = spec_rmsnorm(d)
    return sp


def attn_cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
                    kind: str) -> Dict[str, TensorSpec]:
    """KV cache for one attention layer. Sliding-window ('local') layers
    get a ring buffer of `window` slots with per-slot absolute positions
    (-1 marks an empty slot once prefill has run)."""
    slots = max_seq
    if kind == "local" and cfg.sliding_window is not None:
        slots = min(max_seq, cfg.sliding_window)
    nkv, hd = cfg.num_kv_heads, cfg.hd
    return {
        "k": TensorSpec((batch, nkv, slots, hd),
                        ("batch", "kv_heads", "kv_seq", None), init="zeros",
                        dtype=cfg.dtype),
        "v": TensorSpec((batch, nkv, slots, hd),
                        ("batch", "kv_heads", "kv_seq", None), init="zeros",
                        dtype=cfg.dtype),
        "pos": TensorSpec((slots,), (None,), init="zeros",
                          dtype=torch.int32),
    }


def _gathered(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with dim `dim` gathered on every mesh dim that shards
    it; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in t.placements])


def vocab_split(logits: torch.Tensor) -> bool:
    """Whether `logits` is a DTensor whose last (vocab) dim is sharded
    over its mesh: the case `vocab_argmax` and `vocab_parallel_nll`
    reduce over the shards. Anything else takes the plain formulas (a
    DTensor then computes them on whole rows, as on one device)."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(logits, DTensor) and any(
        isinstance(p, Shard) and p.dim == logits.dim() - 1
        for p in logits.placements)


def _vocab_layout(logits):
    """For a DTensor of logits (..., V): (the mesh dims that shard V,
    the placements of a row-wise result: V's dims replicated, every
    other placement kept)."""
    from torch.distributed.tensor import Replicate, Shard
    last = logits.dim() - 1
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    rows = tuple(Replicate() if i in vocab else p
                 for i, p in enumerate(logits.placements))
    return vocab, rows


def _vocab_offset(mesh, vocab, local_v: int) -> int:
    """This rank's first vocab index: its shard index over the mesh dims
    `vocab` (major to minor) times the shard width."""
    coord = mesh.get_coordinate()
    shard = 0
    for i in vocab:
        shard = shard * mesh.size(i) + coord[i]
    return shard * local_v


def _rows_like(t, mesh, rows):
    """Targets (..., ) laid out as the row-wise placements `rows` (a
    plain tensor counts as replicated): a local slice, no collective."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, rows)


def _first_max(x, lo: int, vocab_size: int, groups):
    """(row max, global index of its first occurrence) of the local
    vocab shard x (..., V/n) starting at index `lo`, reduced over the
    vocab shards `groups`: the maximum by an all-reduce MAX, the index
    by an all-reduce MIN among the shards that hold it, so a tie across
    shards resolves to the lowest index, as `jnp.argmax` does."""
    from torch.distributed import _functional_collectives as funcol
    li = x.argmax(-1)
    mv = x.gather(-1, li[..., None])[..., 0]
    m = mv
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    idx = torch.where(mv == m, li + lo, torch.full_like(li, vocab_size))
    for g in groups:
        idx = funcol.all_reduce(idx, "min", g)
    return m, idx


class _VocabNLL(torch.autograd.Function):
    """−log softmax(x)[t] per row over logits whose vocab is split
    across ranks: x (..., V/n) this rank's shard from index `lo`, m the
    global row max, t the global targets. The sums of exps and the
    target's shifted logit (0 on the shards without it) are all-reduced
    over `groups`; the backward is local, (softmax − one-hot)·g."""

    @staticmethod
    def forward(ctx, x, m, t, lo, groups):
        from torch.distributed import _functional_collectives as funcol
        z = x - m[..., None]
        s = z.exp().sum(-1)
        inside = (t >= lo) & (t < lo + x.shape[-1])
        col = torch.where(inside, t - lo, torch.zeros_like(t))
        zt = torch.where(inside, z.gather(-1, col[..., None])[..., 0],
                         torch.zeros_like(s))
        for g in groups:
            s = funcol.all_reduce(s, "sum", g)
            zt = funcol.all_reduce(zt, "sum", g)
        lse = torch.log(s)
        ctx.save_for_backward(z, lse, col, inside)
        return -(zt - lse)

    @staticmethod
    def backward(ctx, g):
        z, lse, col, inside = ctx.saved_tensors
        grad = torch.exp(z - lse[..., None]) * g[..., None]
        hit = torch.where(inside, -g, torch.zeros_like(g))
        grad = grad.scatter_add(-1, col[..., None], hit[..., None])
        return grad, None, None, None, None


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim, the first maximum as `jnp.argmax`
    takes it. A DTensor whose vocab is split over the mesh reduces each
    rank's shard maximum and its index over the vocab's mesh dims
    (`_first_max`); nothing vocab-sized crosses ranks. The result keeps
    the logits' other placements."""
    if not vocab_split(logits):
        return logits.argmax(-1)
    from torch.distributed.tensor.experimental import local_map
    vocab, rows = _vocab_layout(logits)
    mesh = logits.device_mesh
    V = logits.shape[-1]
    groups = [(mesh, i) for i in vocab]

    def local(x):
        lo = _vocab_offset(mesh, vocab, x.shape[-1])
        return _first_max(x, lo, V, groups)[1]
    return local_map(local, out_placements=(rows,),
                     in_placements=(tuple(logits.placements),),
                     device_mesh=mesh)(logits)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(−log softmax(logits)[targets], argmax == targets as fp32), per
    row, on a DTensor of fp32 logits (..., V) whose vocab is split over
    the mesh (`vocab_split`): each rank works on its
    vocab shard under `local_map` and only row-sized values cross ranks
    (the max, the sum of exps, the target's logit, the argmax), in the
    forward and the backward (`_VocabNLL`). Both results take the
    logits' row placements."""
    from torch.distributed.tensor.experimental import local_map
    vocab, rows = _vocab_layout(logits)
    mesh = logits.device_mesh
    V = logits.shape[-1]
    groups = [(mesh, i) for i in vocab]
    targets = _rows_like(targets.long(), mesh, rows)

    def local(x, t):
        lo = _vocab_offset(mesh, vocab, x.shape[-1])
        with torch.no_grad():
            m, idx = _first_max(x.detach(), lo, V, groups)
        nll = _VocabNLL.apply(x, m, t, lo, groups)
        return nll, (idx == t).float()
    return local_map(local, out_placements=(rows, rows),
                     in_placements=(tuple(logits.placements), rows),
                     device_mesh=mesh)(logits, targets)


def _splittable(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """t, ready for its dim `dim` to be split into (n, ·): a DTensor
    whose dim is sharded over mesh dims that do not divide n (kv width
    512 over 16 ranks for 8 heads) is gathered on them first
    (`_gathered`); anything else is returned as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t
    d = dim % t.dim()
    ways = math.prod(size for size, p in zip(tuple(t.device_mesh.shape),
                                             t.placements)
                     if isinstance(p, Shard) and p.dim == d)
    return t if n % ways == 0 else _gathered(t, dim)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """t itself; on a DTensor, an identity whose backward brings the
    gradient to t's layout, so the heads merged into t are split again
    from a layout that splits evenly (DTensor may shard the incoming
    gradient along the merged dim)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """t (B, T, n·hd) viewed as (B, T, n, hd) (`_splittable` first)."""
    t = _splittable(t, -1, n)
    return t.view(t.shape[0], t.shape[1], n, hd)


def _qkv(params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
         kind: str):
    """q (B, Hq, T, hd), k and v (B, Hkv, T, hd), rotated; k and v are
    transposed views (unit stride along hd), which the flash kernel
    reads in place."""
    B, T, _ = x.shape
    hd, nq, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(x @ params["wq"].to(x.dtype), nq, hd)
    k = _split_heads(x @ params["wk"].to(x.dtype), nkv, hd)
    v = _split_heads(x @ params["wv"].to(x.dtype), nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    theta = cfg.rope_theta
    if kind in ("attn", "moe") and cfg.rope_theta_global is not None:
        theta = cfg.rope_theta_global
    q = rope(q.transpose(1, 2), positions, theta)
    k = rope(k.transpose(1, 2), positions, theta)
    return q, k, v.transpose(1, 2)


def _write_prefill_cache(cache, cfg: ArchConfig, kind: str, k, v,
                         positions) -> None:
    """The reference's prefill cache write, in place: a linear cache
    takes the T new entries in its first slots and is cleared after
    them (pos -1); a sliding-window ring shorter than the prompt keeps
    the last `slots` entries at slot pos % slots."""
    T = k.shape[2]
    slots = cache["k"].shape[2]
    if slots < T and not (kind == "local"
                          and cfg.sliding_window is not None):
        raise ValueError(f"global-attention cache has {slots} slots < "
                         f"prompt length {T}; size caches to the full "
                         f"context")
    from torch.distributed.tensor import DTensor
    if isinstance(cache["k"], DTensor):
        _write_prefill_whole(cache, k, v, positions, slots)
        return
    if slots >= T:
        for name, new in (("k", k), ("v", v)):
            cache[name][:, :, :T] = new
            cache[name][:, :, T:] = 0
        cache["pos"][:T] = positions
        cache["pos"][T:] = -1
    else:
        pp = positions[T - slots:]
        idx = (pp % slots).long()
        for name, new in (("k", k), ("v", v)):
            cache[name].zero_()
            cache[name][:, :, idx] = new[:, :, T - slots:]
        cache["pos"].fill_(-1)
        cache["pos"][idx] = pp.to(torch.int32)


def _write_prefill_whole(cache, k, v, positions, slots: int) -> None:
    """`_write_prefill_cache` for DTensor caches: each cache tensor is
    built whole and copied in (a write into a slice of a dim sharded
    over the mesh, the sequence-sharded KV of kv=1 archs, would land in
    a gathered copy). A ring's slot j holds the position
    T - slots + ((j - T) mod slots): a rotation of the last `slots`."""
    T = k.shape[2]
    if slots >= T:
        def fill(t, dim, value):
            shape = list(t.shape)
            shape[dim] = slots - T
            return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                            device=t.device)], dim)
        kv = [fill(t, 2, 0) for t in (k, v)]
        pos = fill(positions.to(torch.int32), 0, -1)
    else:
        r = (T - slots) % slots

        def fill(t, dim, value):
            t = t.narrow(dim, T - slots, slots)
            return torch.cat([t.narrow(dim, slots - r, r),
                              t.narrow(dim, 0, slots - r)], dim)
        kv = [fill(t, 2, 0) for t in (k, v)]
        pos = fill(positions.to(torch.int32), 0, -1)
    for name, t in zip(("k", "v"), kv):
        cache[name].copy_(t)
    cache["pos"].copy_(pos)


def attention_apply(params, cfg: ArchConfig, x: torch.Tensor, *, kind: str,
                    positions: torch.Tensor, attn_fn,
                    cache: Optional[Tree] = None,
                    decode_pos: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """Pre-norm attention block (the caller adds the residual).

    Prefill (or a cache-less forward): x (B, T, d) attends to itself
    through `attn_fn`; a given `cache` is rewritten in place. Decode: x
    is (B, 1, d) and `decode_pos` the int position of the token; it is
    written into its slot and attends over the cache
    (`decode_attention`)."""
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    B, T, _ = h.shape
    window = cfg.sliding_window if kind == "local" else None
    causal = kind != "enc"

    q, k, v = _qkv(params, cfg, h, positions, kind)

    if cache is None or decode_pos is None:
        out = attn_fn(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_softcap)
        if cache is not None:
            _write_prefill_cache(cache, cfg, kind, k, v, positions)
    else:
        widx = decode_pos % cache["k"].shape[2]
        from torch.distributed.tensor import DTensor
        if isinstance(cache["k"], DTensor):     # whole, as in the prefill
            slot = torch.arange(cache["k"].shape[2],
                                device=k.device) == widx
            for name, new in (("k", k), ("v", v)):
                cache[name].copy_(torch.where(slot[:, None], new,
                                              cache[name]))
            cache["pos"].copy_(torch.where(slot, decode_pos, cache["pos"]))
        else:
            cache["k"][:, :, widx] = k[:, :, 0]
            cache["v"][:, :, widx] = v[:, :, 0]
            cache["pos"][widx] = decode_pos
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                               decode_pos, window=window,
                               softcap=cfg.attn_softcap)

    out = _pinned(out.transpose(1, 2).reshape(B, T, cfg.num_heads * cfg.hd))
    out = out @ params["wo"].to(out.dtype)
    if cfg.post_norm:
        out = rmsnorm(params["post"], out, cfg.norm_eps)
    return out, cache


def decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     kpos: torch.Tensor, qpos: int, *, window=None,
                     softcap=None) -> torch.Tensor:
    """Single-token attention over a (possibly ring) cache.
    q: (B, Hq, 1, D); kc/vc: (B, Hkv, S, D); kpos: (S,) absolute
    positions (-1 = empty); qpos: the current position. A memory-bound
    matvec that stays plain PyTorch, as the reference leaves it to XLA;
    q heads are grouped by kv head (h // rep) instead of repeating the
    cache, which gives the same products."""
    B, Hq, _, D = q.shape
    Hkv = kc.shape[1]
    rep = Hq // Hkv
    qg = _splittable(q.float(), 1, Hkv).reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bgkd->bgrk", qg, kc.float()) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = (kpos >= 0) & (kpos <= qpos)
    if window is not None:
        valid &= kpos > qpos - window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bgkd->bgrd", p, vc.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


# ----------------------------------------------------------------------
# dense MLP (SwiGLU / GeGLU)
# ----------------------------------------------------------------------
def spec_mlp(cfg: ArchConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": spec_rmsnorm(d),
        "wg": TensorSpec((d, f), ("embed", "ffn"), init="normal",
                         scale=d ** -0.5),
        "wu": TensorSpec((d, f), ("embed", "ffn"), init="normal",
                         scale=d ** -0.5),
        "wd": TensorSpec((f, d), ("ffn", "embed"), init="normal",
                         scale=f ** -0.5),
        **({"post": spec_rmsnorm(d)} if cfg.post_norm else {}),
    }


def mlp_apply(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    act = _act(cfg.act)
    g = act(h @ params["wg"].to(h.dtype))
    u = h @ params["wu"].to(h.dtype)
    out = (g * u) @ params["wd"].to(h.dtype)
    if cfg.post_norm:
        out = rmsnorm(params["post"], out, cfg.norm_eps)
    return out


# ----------------------------------------------------------------------
# MoE FFN: top-k routing, sort-based dispatch with capacity (static
# shapes, GShard/Switch style)
# ----------------------------------------------------------------------
def spec_moe(cfg: ArchConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "norm": spec_rmsnorm(d),
        "router": TensorSpec((d, e), ("embed", None), init="normal",
                             scale=d ** -0.5),
        "wg": TensorSpec((e, d, f), ("experts", "embed", "moe_ffn"),
                         init="normal", scale=d ** -0.5),
        "wu": TensorSpec((e, d, f), ("experts", "embed", "moe_ffn"),
                         init="normal", scale=d ** -0.5),
        "wd": TensorSpec((e, f, d), ("experts", "moe_ffn", "embed"),
                         init="normal", scale=f ** -0.5),
    }


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for `tokens` routed tokens: the capacity factor's
    share, rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_route(params, cfg: ArchConfig, h: torch.Tensor):
    """Router of the normed tokens h (B, T, d): (probs (B, T, E) fp32,
    topv, topi (B, T, k)). Logits are computed in h's dtype, then an
    fp32 softmax; the top k are taken by a stable descending sort, so
    tied probabilities (common from bf16 logits) pick the lower expert
    first, as `jax.lax.top_k` does."""
    logits = (h @ params["router"].to(h.dtype)).float()
    probs = torch.softmax(logits, -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return probs, vals[..., :k], idx[..., :k]


def _moe_constrain(x: torch.Tensor, spec_axes) -> torch.Tensor:
    """The reference's MoE constraint: on a DTensor, x redistributed so
    each dim sits on the mesh axes its entry names ("data": the data
    axes, "model"); a plain tensor (no mesh), or a layout whose dims do
    not divide their axes, is returned as it is. The (E, C, ·) dispatch
    buffer goes to (data = rows, model = experts), and the expert
    weights to experts over 'model' with their FSDP dims gathered, so
    the expert products are local."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist.sharding import _data_spec, constrain, placements
    from repro_torch.launch.mesh import axis_size
    mesh = x.device_mesh
    data = _data_spec(mesh)
    model = "model" if "model" in tuple(mesh.mesh_dim_names) else None
    spec = tuple(model if a == "model" else (data if a == "data" else None)
                 for a in spec_axes)
    if any(e is not None and d % axis_size(mesh, e)
           for d, e in zip(x.shape, spec)):
        return x
    return constrain(x, placements(spec, mesh))


def _moe_slots(topi: torch.Tensor, Bd: int, C: int, E: int):
    """(expert, slot) of every assignment in token-major order, per
    dispatch row: each row sorts its assignments by expert (stable); one
    past its expert's C slots goes to the overflow row E."""
    flat_e = topi.reshape(Bd, -1)
    n = flat_e.shape[1]
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    e_s = flat_e.gather(-1, order)
    experts = torch.arange(E, device=topi.device).expand(Bd, E).contiguous()
    starts = torch.searchsorted(e_s, experts)               # (Bd, E)
    pos_in_e = torch.arange(n, device=topi.device) - starts.gather(-1, e_s)
    keep_s = pos_in_e < C
    dst_e_s = torch.where(keep_s, e_s, E)                    # overflow row
    dst_c_s = torch.where(keep_s, pos_in_e, 0)
    # back to token-major order: position order[j] takes sorted entry j
    de_o = torch.empty_like(dst_e_s).scatter_(-1, order, dst_e_s)
    dc_o = torch.empty_like(dst_c_s).scatter_(-1, order, dst_c_s)
    return de_o, dc_o


def _moe_dispatch(h: torch.Tensor, de_o, dc_o, E: int, C: int, k: int):
    """The (Bd, E, C, d) buffer of the rows' assignments."""
    Bd, _, d = h.shape
    rows = torch.arange(Bd, device=h.device)[:, None]
    buf = h.new_zeros((Bd, E + 1, C, d))
    buf[rows, de_o, dc_o] = h.repeat_interleave(k, dim=1)
    return buf[:, :E]


def _moe_collect(out: torch.Tensor, de_o, dc_o, flat_w, lo: int = 0):
    """Each assignment's expert output times its weight, (Bd, T·k, d),
    from the experts lo … lo + out.shape[1] that `out` holds (zero for
    the rest and for dropped assignments)."""
    Bd, El = out.shape[:2]
    rows = torch.arange(Bd, device=out.device)[:, None]
    e = de_o - lo
    gathered = out[rows, e.clamp(0, El - 1), dc_o]
    w_keep = (flat_w * ((e >= 0) & (e < El))).to(gathered.dtype)
    return gathered * w_keep[..., None]


def _moe_experts(params, cfg: ArchConfig, buf: torch.Tensor, big: bool):
    """The expert FFN on the (Bd, E, C, d) buffer."""
    wg, wu, wd = (params[n].to(buf.dtype) for n in ("wg", "wu", "wd"))
    if big:
        # ZeRO-3 gather of the expert weights' FSDP dims, only where the
        # activations outweigh the weights (training, prefill)
        wg, wu, wd = (_moe_constrain(w, ("model", None, None))
                      for w in (wg, wu, wd))
    act = _act(cfg.act)
    g = act(torch.einsum("becd,edf->becf", buf, wg))
    u = torch.einsum("becd,edf->becf", buf, wu)
    return torch.einsum("becf,efd->becd", g * u, wd)


def _moe_sharded(params, cfg: ArchConfig, h, topv, topi, Bd: int, C: int):
    """The dispatch, experts and collection on DTensors: the row-local
    bookkeeping, the buffer writes and the collection run under
    `local_map` on each rank's rows (DTensor has no rules for their
    index ops); the expert products shard over 'model' as the buffer
    and weights are constrained. A rank collects only its own experts'
    outputs, so the result is partial over the mesh dims that shard the
    experts (the caller's `_constrain` sums it). Returns (Bd, T·k, d)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    E, k = cfg.num_experts, cfg.experts_per_token
    mesh = h.device_mesh
    if Bd == 1:          # one dispatch row over every token: gather them
        h = h.redistribute(mesh, [Replicate()] * mesh.ndim)
        topi = topi.redistribute(mesh, [Replicate()] * mesh.ndim)
        topv = topv.redistribute(mesh, [Replicate()] * mesh.ndim)
    rp = tuple(topi.placements)
    de_o, dc_o = local_map(lambda t: _moe_slots(t, t.shape[0] if Bd > 1
                                                else 1, C, E),
                           out_placements=(rp, rp), in_placements=(rp,),
                           device_mesh=mesh)(topi)
    hp = tuple(h.placements)
    buf = local_map(lambda x, a, b: _moe_dispatch(x, a, b, E, C, k),
                    out_placements=(hp,), in_placements=(hp, rp, rp),
                    device_mesh=mesh)(h.reshape(Bd, -1, h.shape[-1]),
                                      de_o, dc_o)
    buf = _moe_constrain(buf, ("data" if Bd > 1 else None, "model", None,
                               None))
    out = _moe_experts(params, cfg, buf, Bd * h.shape[1] > 512)
    # rows as the bookkeeping's, experts where DTensor put them, the rest
    # whole: the layout the collection below reads
    op = tuple(Shard(0) if rp[i] == Shard(0) else
               (p if isinstance(p, Shard) and p.dim == 1 else Replicate())
               for i, p in enumerate(out.placements))
    out = out.redistribute(mesh, op)
    ex = [i for i, p in enumerate(op) if isinstance(p, Shard)
          and p.dim == 1]
    coord = mesh.get_coordinate()
    shard = 0
    for i in ex:
        shard = shard * mesh.size(i) + coord[i]
    res = tuple(Partial() if i in ex else p for i, p in enumerate(rp))
    return local_map(
        lambda o, a, b, w: _moe_collect(o, a, b, w, lo=shard * o.shape[1]),
        out_placements=(res,), in_placements=(op, rp, rp, rp),
        in_grad_placements=(op, rp, rp, res), device_mesh=mesh)(
            out, de_o, dc_o, topv.reshape(Bd, -1))


def moe_apply(params, cfg: ArchConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (y (B, T, d), the Switch load-balancing aux loss).

    The reference's row-local dispatch: each batch row sorts its T·k
    assignments by expert (stable) and writes them into its own
    (E, C, d) buffer; an assignment past its expert's C slots goes to an
    overflow row E and is dropped. Small batches (B·T ≤ 512, decode)
    flatten to one row with C = B·T, which no expert can overflow, so
    decode is exact. The expert products are batched matmuls over the
    buffer; each token's outputs are collected from its k slots and
    summed with the renormalised top-k weights. DTensors take
    `_moe_sharded`.
    """
    from torch.distributed.tensor import DTensor
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    probs, topv, topi = moe_route(params, cfg, h)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    if B * T <= 512:
        Bd, Td, C = 1, B * T, B * T
    else:
        Bd, Td, C = B, T, moe_capacity(cfg, T)
    if isinstance(h, DTensor):
        contrib = _moe_sharded(params, cfg, h, topv, topi, Bd, C)
    else:
        h = h.reshape(Bd, Td, d)
        de_o, dc_o = _moe_slots(topi, Bd, C, E)
        buf = _moe_dispatch(h, de_o, dc_o, E, C, k)
        out = _moe_experts(params, cfg, buf, Bd * Td > 512)
        contrib = _moe_collect(out, de_o, dc_o, topv.reshape(Bd, Td * k))
    y = contrib.reshape(B, T, k, d).sum(2)

    frac = (topi[..., None] == torch.arange(E, device=topi.device)
            ).float().mean((0, 1, 2))
    aux = E * (frac * probs.mean((0, 1))).sum()
    return y, aux
