"""Block-ELL products on the port — `repro.kernels.block_spmm`'s kernels,
its `BlockEllAdj` and its differentiable `spmm_ell` / `spmm_fused`.

Two hand-written Hopper kernels, each with a plain PyTorch version
(`ref.py`) and a wrapper that picks one by the device of its inputs:

  * `spmm_block_ell`: y = Â·X (`csrc/block_ell_spmm.cu`), the port of
    `_spmm_kernel` + `_spmm_kernel_rowk`;
  * `spmm_fused_block_ell`: y = Â·(XW + 1bᵀ)
    (`csrc/block_ell_spmm_fused.cu`), the port of `_spmm_fused_kernel`.

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version. There is no fallback between the two.

Format (host-built, see ops.py):
  blocks:     (nrb, K, B, B)  dense value tiles, zero-padded
  block_cols: (nrb, K) int32  column-block per slot; empty slots point
                              at column-block 0 with an all-zero tile
  x:          (ncb * B, F)    dense right-hand side
  row_k:      (nrb,) int32    optional live-slot count per row-block;
                              slots past it hold zero tiles, so skipping
                              them is exact (None means all K)

`spmm_ell` and `spmm_fused` are `torch.autograd.Function`s on a
`BlockEllAdj` (tiles + host-built transpose): their backward runs the
block-ELL kernel on the transposed tiles with `row_k_t`, so a dense Â is
never built in either direction. Their `block_cols` ranges are checked
once, when the `BlockEllAdj` is built or moved, so a training step
launches without a host sync; a direct `spmm_block_ell` call still
checks its indices before every launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spmm_block_ell_ref, spmm_fused_ref

# kernel launches since import (or since a caller reset it): a run shows
# it went through a kernel by reading these before and after
LAUNCHES = 0           # block_ell_spmm (y = Â·X)
LAUNCHES_FUSED = 0     # block_ell_spmm_fused (y = Â·(XW + b))

_DTYPES = (torch.float32, torch.bfloat16)
_TILE_M, _TILE_N = 64, 64          # block_ell_spmm.cu's output tile
_FUSED_ROWS = 128                  # block_ell_spmm_fused.cu's output rows
_FUSED_MAX_B = 512                 # its XW tile (B x 64 fp32) in shared memory
_MAX_GRID_Y = 65535


# ----------------------------------------------------------------------
# the block-ELL adjacency with its transpose
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockEllAdj:
    """Block-ELL Â and Âᵀ as tensors — `repro.kernels.BlockEllAdj`.

    blocks:       (nrb, K,  B, B)   forward value tiles of Â
    block_cols:   (nrb, K)  int32   forward slot → column-block index
    blocks_t:     (ncb, Kt, B, B)   value tiles of Âᵀ (backward pass)
    block_cols_t: (ncb, Kt) int32
    row_k:        (nrb,) int32 or None   live slots per row-block
    row_k_t:      (ncb,) int32 or None   the same for the transpose

    The reference's format invariants hold (ops.py builds it): occupied
    slots first, padding slots are zero tiles pointing at column-block
    0, so skipping slots past row_k is exact. Construction checks every
    `block_cols` entry against the other direction's block count — on
    the host for CPU tensors, with one device reduction otherwise — and
    `.to()` carries that check along, so the products launch without a
    per-call bounds sync."""
    blocks: torch.Tensor
    block_cols: torch.Tensor
    blocks_t: torch.Tensor
    block_cols_t: torch.Tensor
    row_k: Optional[torch.Tensor] = None
    row_k_t: Optional[torch.Tensor] = None
    checked: bool = dataclasses.field(default=False, repr=False,
                                      compare=False)

    def __post_init__(self):
        if not self.checked:
            _check_cols(self.block_cols, self.blocks_t.shape[0], "block_cols")
            _check_cols(self.block_cols_t, self.blocks.shape[0],
                        "block_cols_t")
            object.__setattr__(self, "checked", True)

    @staticmethod
    def from_numpy(blocks, block_cols, blocks_t, block_cols_t,
                   row_k=None, row_k_t=None) -> "BlockEllAdj":
        """Wrap host numpy leaves as CPU tensors (no copy)."""
        t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a))
        return BlockEllAdj(t(blocks), t(block_cols), t(blocks_t),
                           t(block_cols_t), t(row_k), t(row_k_t))

    def tensors(self):
        return (self.blocks, self.block_cols, self.blocks_t,
                self.block_cols_t, self.row_k, self.row_k_t)

    def to(self, device, non_blocking: bool = False) -> "BlockEllAdj":
        """The same adjacency on `device` (already checked, so no sync).
        With non_blocking, CPU leaves are first copied into pinned
        memory, so a host buffer the builder recycles later is never
        read by a copy still in flight."""
        dev = torch.device(device)

        def move(t):
            if t is None or t.device == dev:
                return t
            if non_blocking and t.device.type == "cpu" and dev.type == "cuda":
                t = t.pin_memory()
            return t.to(dev, non_blocking=non_blocking)
        return BlockEllAdj(*(move(t) for t in self.tensors()), checked=True)


def _check_cols(cols: torch.Tensor, n_blocks: int, what: str) -> None:
    if cols.numel() == 0:
        return
    if cols.device.type == "cpu":
        lo, hi = int(cols.min()), int(cols.max())
    else:
        lo, hi = torch.stack(torch.aminmax(cols)).tolist()
    if lo < 0 or hi >= n_blocks:
        raise ValueError(f"{what} out of range [0, {n_blocks}): "
                         f"min {lo}, max {hi}")


# ----------------------------------------------------------------------
# kernel 1: y = Â·X
# ----------------------------------------------------------------------
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
    does), and K = 0 returns zeros without a launch. On a CUDA tensor
    the column indices are checked before the launch (one small device
    reduction and sync)."""
    return _spmm(blocks, block_cols, x, row_k, cols_checked=False)


def _spmm(blocks, block_cols, x, row_k, *, cols_checked: bool):
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
    if not cols_checked:
        # keeps a bad index from becoming an out-of-bounds read inside
        # the kernel
        _check_cols(block_cols, x.shape[0] // B, "block_cols")
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


# ----------------------------------------------------------------------
# kernel 2: y = Â·(XW + 1bᵀ)
# ----------------------------------------------------------------------
@functools.cache
def _fused_fns():
    lib = _build.load("block_ell_spmm_fused")
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
    fns = {}
    for dtype, sym in ((torch.float32, "block_ell_spmm_fused_f32"),
                       (torch.bfloat16, "block_ell_spmm_fused_bf16")):
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    err = lib.block_ell_spmm_fused_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fns, err


def _check_fused(blocks, block_cols, x, w, b, row_k) -> None:
    _check(blocks, block_cols, x, row_k)
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be (D, F) with D = x.shape[1] = "
                         f"{x.shape[1]}; got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16; got {w.dtype}")
    tensors = [w]
    if b is not None:
        if tuple(b.shape) != (w.shape[1],) or b.dtype != torch.float32:
            raise ValueError(f"b must be float32 ({w.shape[1]},); got "
                             f"{b.dtype} {tuple(b.shape)}")
        tensors.append(b)
    if any(t.device != x.device for t in tensors):
        raise ValueError("w and b must lie on x's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")


def spmm_fused_block_ell(blocks: torch.Tensor, block_cols: torch.Tensor,
                         x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None, *,
                         row_k: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """y = A @ (x @ w + b) with A in block-ELL form, in one kernel.
    Returns (nrb*B, F) in x's dtype. Precision as in the reference's
    `_fused_apply`: the tiles and w are cast to x's dtype, XW and the
    aggregation accumulate in fp32, b (fp32) is added to the fp32 XW,
    which is rounded to x's dtype before the aggregation. K = 0 returns
    zeros without a launch. On a CUDA tensor the column indices are
    checked before the launch (one small device reduction and sync)."""
    return _spmm_fused(blocks, block_cols, x, w, b, row_k,
                       cols_checked=False)


def _spmm_fused(blocks, block_cols, x, w, b, row_k, *, cols_checked: bool):
    if blocks.dtype != x.dtype:
        blocks = blocks.to(x.dtype)
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if b is not None and b.dtype != torch.float32:
        b = b.float()
    _check_fused(blocks, block_cols, x, w, b, row_k)
    nrb, K, B, _ = blocks.shape
    F = w.shape[1]
    if K == 0 or nrb == 0 or F == 0:
        return torch.zeros((nrb * B, F), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return spmm_fused_ref(blocks, block_cols, x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"no fused block-ELL kernel for device {x.device}")
    if not cols_checked:
        _check_cols(block_cols, x.shape[0] // B, "block_cols")
    return _launch_fused(blocks, block_cols, x, w, b, row_k)


def _launch_fused(blocks, block_cols, x, w, b, row_k) -> torch.Tensor:
    """Launch the fused CUDA kernel on validated operands (blocks and w
    in x's dtype, b fp32 or None) on the current stream."""
    global LAUNCHES_FUSED
    nrb, K, B, _ = blocks.shape
    D, F = w.shape
    if B > _FUSED_MAX_B:
        raise ValueError(f"the fused kernel keeps a (B, 64) XW tile in "
                         f"shared memory and takes B <= {_FUSED_MAX_B}; "
                         f"got B={B}")
    row_tiles = -(-B // _FUSED_ROWS)
    if -(-F // _TILE_N) > _MAX_GRID_Y or nrb * row_tiles >= 2 ** 31:
        raise ValueError(f"shape too large for one launch: nrb={nrb}, "
                         f"B={B}, F={F}")
    fns, err_str = _fused_fns()
    y = torch.empty((nrb * B, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fns[x.dtype](blocks.data_ptr(), block_cols.data_ptr(),
                           None if row_k is None else row_k.data_ptr(),
                           x.data_ptr(), w.data_ptr(),
                           None if b is None else b.data_ptr(),
                           y.data_ptr(), nrb, K, B, D, F, stream)
    if err:
        raise RuntimeError(f"block_ell_spmm_fused launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    LAUNCHES_FUSED += 1
    return y


# ----------------------------------------------------------------------
# differentiable products on a BlockEllAdj
# ----------------------------------------------------------------------
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation, returned in fp32 (operands already
    rounded to their dtype; a bf16×bf16 product is exact in fp32)."""
    return torch.matmul(a.float(), b.float())


def _rows_match(x: torch.Tensor, n_col_blocks: int, B: int) -> None:
    """The adjacency's column indices were checked against
    `n_col_blocks`; x must have exactly that many B-row blocks."""
    if x.dim() != 2 or x.shape[0] != n_col_blocks * B:
        raise ValueError(f"x must have {n_col_blocks} x {B} rows for this "
                         f"adjacency; got {tuple(x.shape)}")


def _apply(blocks, block_cols, x, row_k, n_col_blocks) -> torch.Tensor:
    """One block-ELL product of a checked adjacency — the reference's
    `_apply`: a bf16 x pulls the tiles down to bf16, K = 0 is zeros."""
    _rows_match(x, n_col_blocks, blocks.shape[2])
    return _spmm(blocks, block_cols, x.contiguous(), row_k,
                 cols_checked=True)


def _forward(adj, x):
    return _apply(adj.blocks, adj.block_cols, x, adj.row_k,
                  adj.blocks_t.shape[0])


def _transposed(adj, g):
    # Âᵀ ḡ on the transposed tiles; Â is data, not a parameter
    return _apply(adj.blocks_t, adj.block_cols_t, g, adj.row_k_t,
                  adj.blocks.shape[0])


class _SpmmEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return _forward(adj, x)

    @staticmethod
    def backward(ctx, g):
        return _transposed(ctx.adj, g), None


class _SpmmFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, adj):
        ctx.adj = adj
        ctx.has_b = b is not None
        ctx.save_for_backward(x, w)
        _rows_match(x, adj.blocks_t.shape[0], adj.blocks.shape[2])
        return _spmm_fused(adj.blocks, adj.block_cols, x.contiguous(),
                           w.contiguous(),
                           None if b is None else b.contiguous(),
                           adj.row_k, cols_checked=True)

    @staticmethod
    def backward(ctx, g):
        # y = Â (XW + 1bᵀ). With g̃ = Âᵀ ḡ (the transposed-tile product):
        #   dX = g̃ Wᵀ    dW = Xᵀ g̃    db = g̃ᵀ 1    dÂ = 0 (data)
        # operands in x's dtype, fp32 accumulation, parameter grads in
        # the parameters' dtype — the reference's `_spmm_fused_bwd`
        x, w = ctx.saved_tensors
        gt = _transposed(ctx.adj, g)
        cd = x.dtype
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(gt, w.to(cd).t()).to(cd)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.t(), gt).to(w.dtype)
        if ctx.has_b and ctx.needs_input_grad[2]:
            db = gt.float().sum(0)
        return dx, dw, db, None


def spmm_ell(adj: BlockEllAdj, x: torch.Tensor) -> torch.Tensor:
    """Differentiable y = Â x on a BlockEllAdj: forward through the
    block-ELL kernel with `row_k`, backward through the same kernel on
    the transposed tiles with `row_k_t`."""
    return _SpmmEll.apply(x, adj)


def spmm_fused(adj: BlockEllAdj, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable y = Â (X W + 1 bᵀ): forward through the fused
    kernel, backward through the block-ELL kernel on the transposed
    tiles plus dX/dW/db as dense products."""
    return _SpmmFused.apply(x, w, b, adj)
