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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def _qkv(params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
         kind: str):
    """q (B, Hq, T, hd), k and v (B, Hkv, T, hd), rotated; k and v are
    transposed views (unit stride along hd), which the flash kernel
    reads in place."""
    B, T, _ = x.shape
    hd, nq, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"].to(x.dtype)).view(B, T, nq, hd)
    k = (x @ params["wk"].to(x.dtype)).view(B, T, nkv, hd)
    v = (x @ params["wv"].to(x.dtype)).view(B, T, nkv, hd)
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
        cache["k"][:, :, widx] = k[:, :, 0]
        cache["v"][:, :, widx] = v[:, :, 0]
        cache["pos"][widx] = decode_pos
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                               decode_pos, window=window,
                               softcap=cfg.attn_softcap)

    out = out.transpose(1, 2).reshape(B, T, cfg.num_heads * cfg.hd)
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
    qg = q.float().reshape(B, Hkv, rep, D)
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
    summed with the renormalised top-k weights.
    """
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    probs, topv, topi = moe_route(params, cfg, h)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    if B * T <= 512:
        Bd, Td, C = 1, B * T, B * T
    else:
        Bd, Td, C = B, T, moe_capacity(cfg, T)
    h = h.reshape(Bd, Td, d)

    flat_e = topi.reshape(Bd, Td * k)     # token-major assignment order
    flat_w = topv.reshape(Bd, Td * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    e_s = flat_e.gather(-1, order)
    experts = torch.arange(E, device=x.device).expand(Bd, E).contiguous()
    starts = torch.searchsorted(e_s, experts)               # (Bd, E)
    pos_in_e = torch.arange(Td * k, device=x.device) \
        - starts.gather(-1, e_s)
    keep_s = pos_in_e < C
    dst_e_s = torch.where(keep_s, e_s, E)                    # overflow row
    dst_c_s = torch.where(keep_s, pos_in_e, 0)
    # back to token-major order: position order[j] takes sorted entry j
    de_o = torch.empty_like(dst_e_s).scatter_(-1, order, dst_e_s)
    dc_o = torch.empty_like(dst_c_s).scatter_(-1, order, dst_c_s)

    rows = torch.arange(Bd, device=x.device)[:, None]
    buf = h.new_zeros((Bd, E + 1, C, d))
    buf[rows, de_o, dc_o] = h.repeat_interleave(k, dim=1)
    buf = buf[:, :E]

    act = _act(cfg.act)
    g = act(torch.einsum("becd,edf->becf", buf, params["wg"].to(h.dtype)))
    u = torch.einsum("becd,edf->becf", buf, params["wu"].to(h.dtype))
    out = torch.einsum("becf,efd->becd", g * u, params["wd"].to(h.dtype))

    gathered = out[rows, de_o.clamp(max=E - 1), dc_o]       # (Bd, T·k, d)
    w_keep = (flat_w * (de_o < E)).to(gathered.dtype)
    y = (gathered * w_keep[..., None]).reshape(B, T, k, d).sum(2)

    frac = F.one_hot(topi, E).float().mean((0, 1, 2))
    aux = E * (frac * probs.mean((0, 1))).sum()
    return y, aux
