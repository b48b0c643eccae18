"""Block-ELL sparse·dense product y = Â·X — the port of
`repro.kernels.block_spmm.spmm_block_ell`.

A CUDA tensor goes to the hand-written Hopper kernel
(`csrc/block_ell_spmm.cu`, built at first use and loaded with ctypes);
a CPU tensor goes to the plain PyTorch version (`ref.spmm_block_ell_ref`).
There is no fallback between the two: a CUDA input launches the kernel
or raises.

Format (host-built, see ops.py):
  blocks:     (nrb, K, B, B)  dense value tiles, zero-padded
  block_cols: (nrb, K) int32  column-block per slot; empty slots point
                              at column-block 0 with an all-zero tile
  x:          (ncb * B, F)    dense right-hand side
  row_k:      (nrb,) int32    optional live-slot count per row-block;
                              slots past it hold zero tiles, so skipping
                              them is exact (None means all K)
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spmm_block_ell_ref

# kernel launches since import (or since a caller reset it): a run shows
# it went through the kernel by reading this before and after
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_TILE_M, _TILE_N = 64, 64          # the kernel's output tile (block_ell_spmm.cu)
_MAX_GRID_Y = 65535


@functools.cache
def _kernel_fns():
    lib = _build.load("block_ell_spmm")
    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fns = {}
    for dtype, sym in ((torch.float32, "block_ell_spmm_f32"),
                       (torch.bfloat16, "block_ell_spmm_bf16")):
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    err = lib.block_ell_spmm_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fns, err


def _check(blocks, block_cols, x, row_k) -> None:
    """Raise on anything the kernel does not take."""
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be (nrb, K, B, B); got "
                         f"{tuple(blocks.shape)}")
    nrb, K, B, _ = blocks.shape
    if B < 1:
        raise ValueError("block size B must be >= 1")
    if tuple(block_cols.shape) != (nrb, K) or block_cols.dtype != torch.int32:
        raise ValueError(f"block_cols must be int32 ({nrb}, {K}); got "
                         f"{block_cols.dtype} {tuple(block_cols.shape)}")
    if x.dim() != 2 or x.shape[0] % B:
        raise ValueError(f"x must be (ncb*B, F) with B={B}; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or blocks.dtype not in _DTYPES:
        raise TypeError(f"x and blocks must be float32 or bfloat16; got "
                        f"{x.dtype}, {blocks.dtype}")
    tensors = [blocks, block_cols, x]
    if row_k is not None:
        if tuple(row_k.shape) != (nrb,) or row_k.dtype != torch.int32:
            raise ValueError(f"row_k must be int32 ({nrb},); got "
                             f"{row_k.dtype} {tuple(row_k.shape)}")
        tensors.append(row_k)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")


def spmm_block_ell(blocks: torch.Tensor, block_cols: torch.Tensor,
                   x: torch.Tensor, *,
                   row_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A @ x with A in block-ELL form. Returns (nrb*B, F) in x's
    dtype; the sum is fp32 either way. The tiles are cast to x's dtype
    first (bf16 x pulls them down to bf16, as the reference's `_apply`
    does), and K = 0 returns zeros without a launch."""
    _check(blocks, block_cols, x, row_k)
    if blocks.dtype != x.dtype:
        blocks = blocks.to(x.dtype)
    nrb, K, B, _ = blocks.shape
    F = x.shape[1]
    if K == 0 or nrb == 0 or F == 0:
        return torch.zeros((nrb * B, F), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return spmm_block_ell_ref(blocks, block_cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"no block-ELL kernel for device {x.device}")
    ncb = x.shape[0] // B
    # one small device reduction (and sync) keeps a bad index from
    # becoming an out-of-bounds read inside the kernel
    lo, hi = torch.stack(torch.aminmax(block_cols)).tolist()
    if lo < 0 or hi >= ncb:
        raise ValueError(f"block_cols out of range [0, {ncb}): "
                         f"min {lo}, max {hi}")
    return _launch(blocks, block_cols, x, row_k)


def _launch(blocks: torch.Tensor, block_cols: torch.Tensor,
            x: torch.Tensor, row_k: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the CUDA kernel on validated operands (blocks already in
    x's dtype) on the current stream, without synchronising."""
    global LAUNCHES
    nrb, K, B, _ = blocks.shape
    F = x.shape[1]
    row_tiles = -(-B // _TILE_M)
    if -(-F // _TILE_N) > _MAX_GRID_Y or nrb * row_tiles >= 2 ** 31:
        raise ValueError(f"shape too large for one launch: nrb={nrb}, "
                         f"B={B}, F={F}")
    fns, err_str = _kernel_fns()
    y = torch.empty((nrb * B, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fns[x.dtype](blocks.data_ptr(), block_cols.data_ptr(),
                           None if row_k is None else row_k.data_ptr(),
                           x.data_ptr(), y.data_ptr(), nrb, K, B, F, stream)
    if err:
        raise RuntimeError(f"block_ell_spmm launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    LAUNCHES += 1
    return y
