"""Plain PyTorch versions of the port's kernels — what CPU tensors take,
and what `chip_smoke.py` holds each CUDA kernel against on the card."""
from __future__ import annotations

import torch


# ----------------------------------------------------------------------
# block-ELL SpMM
# ----------------------------------------------------------------------
def spmm_block_ell_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """y[i*B:(i+1)*B] = Σ_k blocks[i,k] @ x[block_cols[i,k]*B : +B].

    Counterpart of `repro.kernels.ref.spmm_block_ell_ref`: the K slot
    sum is folded into the contraction, one batched (B, K·B) @ (K·B, F)
    product per row-block. Precision contract: operands are rounded to
    x's dtype, the products accumulate in fp32 (a bf16×bf16 product is
    exact in fp32, so upcasting the rounded operands and multiplying in
    fp32 is that contract), and the result is cast back to x's dtype.
    Multiplies every slot (padding tiles are zero), so it needs no
    `row_k`."""
    nrb, K, B, _ = blocks.shape
    F = x.shape[1]
    op_dtype = x.dtype if x.is_floating_point() else torch.float32
    xb = x.reshape(-1, B, F)                      # (ncb, B, F)
    gathered = xb[block_cols.long()].reshape(nrb, K * B, F)
    a = blocks.permute(0, 2, 1, 3).reshape(nrb, B, K * B)
    y = torch.bmm(a.to(op_dtype).float(), gathered.to(op_dtype).float())
    return y.reshape(nrb * B, F).to(x.dtype)


# ----------------------------------------------------------------------
# fused Â·(XW + 1bᵀ)
# ----------------------------------------------------------------------
def spmm_fused_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                   x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """y = Â (X W + 1 bᵀ) — counterpart of
    `repro.kernels.ref.spmm_fused_ref`, with its contract: XW in the
    operand dtype (x's) with an fp32 accumulator, an fp32 bias add, a
    cast to x's dtype, then `spmm_block_ell_ref`. Multiplies every slot
    (it needs no `row_k`)."""
    op_dtype = x.dtype if x.is_floating_point() else torch.float32
    xw = torch.matmul(x.to(op_dtype).float(), w.to(op_dtype).float())
    if b is not None:
        xw = xw + b.float()
    return spmm_block_ell_ref(blocks, block_cols, xw.to(x.dtype))


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
NEG_INF = -1e30


def attention_mask(Tq: int, Tk: int, causal: bool, window, device
                   ) -> torch.Tensor:
    """(Tq, Tk) bool: which keys each query row sees. Positions are
    absolute with q aligned to the END of k (q row i sits at Tk - Tq + i),
    causal keeps kpos <= qpos, a window keeps kpos > qpos - window."""
    qpos = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None, softcap=None,
                        scale=None) -> torch.Tensor:
    """The plain version of `_flash_kernel` (src/repro/kernels/
    flash_attention.py): q (..., Tq, D), k/v (..., Tk, D) with the same
    leading dims (the reference's (BH, T, D)). Scores, max, denominator
    and P·V in fp32; scale (default D^-½), then the optional tanh
    softcap, then the mask (NEG_INF = -1e30); a row that sees no key
    gives 0 (the kernel's guarded online softmax), where `mha_ref` gives
    the mean of v. Returns q's dtype."""
    D, Tq, Tk = q.shape[-1], q.shape[-2], k.shape[-2]
    if Tk == 0:
        return torch.zeros_like(q)
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~attention_mask(Tq, Tk, causal, window, q.device),
                      NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m > NEG_INF / 2, torch.exp(s - m), 0.0)
    o = torch.matmul(p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.to(q.dtype)


def _repeat_kv(q, k, v):
    """GQA: kv head g serves q heads g·rep … g·rep + rep - 1 (q head h
    reads kv head h // rep, as `jnp.repeat(k, rep, axis=1)` does)."""
    rep = q.shape[1] // k.shape[1]
    return k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)


def multi_head_attention_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, **kw) -> torch.Tensor:
    """`flash_attention_ref` on (B, Hq, Tq, D) and (B, Hkv, Tk, D), kv
    heads repeated for GQA: the plain version of the flash kernel's
    wrapper, which CPU tensors take."""
    k, v = _repeat_kv(q, k, v)
    return flash_attention_ref(q, k, v, **kw)


def mha_ref(q, k, v, *, causal: bool = True, window=None, softcap=None,
            scale=None) -> torch.Tensor:
    """Copy of `repro.kernels.ref.mha_ref`, the reference's testing
    oracle: q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), a plain softmax over
    -1e30-masked logits, so a row that sees no key gets the mean of v."""
    D, Tq, Tk = q.shape[-1], q.shape[-2], k.shape[-2]
    k, v = _repeat_kv(q, k, v)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(
        ~attention_mask(Tq, Tk, causal, window, q.device), NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
