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
