"""Block-ELL products on the port — `repro.kernels.block_spmm`'s kernels,
its `BlockEllAdj` and its differentiable `spmm_ell` / `spmm_fused`.

Two hand-written Hopper kernels, each with a plain PyTorch version
(`ref.py`) and a wrapper that picks one by the device of its inputs:

  * `spmm_block_ell`: y = Â·X (`csrc/block_ell_spmm.cu`), the port of
    `_spmm_kernel` + `_spmm_kernel_rowk`;
  * `spmm_fused_block_ell`: y = Â·(XW + 1bᵀ)
    (`csrc/block_ell_spmm_fused.cu`), the port of `_spmm_fused_kernel`.

A third, `scatter_tiles` (`csrc/block_ell_scatter.cu`), writes the tiles
of a `BlockEllCoords` (a batch's nonzeros with their tile offsets, what
the host ships) into a zeroed `BlockEllAdj` on the card; on the CPU the
same scatter is a numpy assignment.

Both run on one fp32 tile mainloop (`csrc/block_tile.cuh`: 128-row
output tiles, a 4-stage cp.async ring, 8 x 16 register tiles, the
contraction split so that every shape fills the SMs, fixed-order
reduction of the split partials). The wrapper plans each launch
(`plan_tiles`, `copy_width`) and allocates its workspace. CUDA tensors
launch the kernel or raise; CPU tensors take the plain version. There is
no fallback between the two.

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

import contextlib
import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spmm_block_ell_ref, spmm_fused_ref

# kernel launches since import (or since a caller reset it): a run shows
# it went through a kernel by reading these before and after; a CUDA
# graph's replay adds the launches its capture counted (`add_launches`)
LAUNCHES = 0           # block_ell_spmm (y = Â·X)
LAUNCHES_FUSED = 0     # block_ell_spmm_fused (y = Â·(XW + b)), one per call
LAUNCHES_SCATTER = 0   # block_ell_scatter (tiles of a BlockEllCoords)

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535


# ----------------------------------------------------------------------
# launch planning for the tile mainloop (csrc/block_tile.cuh)
# ----------------------------------------------------------------------
_TILE_M = 128            # output rows per CTA
_CHUNK = 16              # contraction depth per pipeline stage
_MAX_SPLITS = 64
# The split cost model, in units of one 16-deep chunk of a 128 x 128 tile
# (≈2.2 µs of an SM shared by two CTAs, fp32, H100). A 128 x 64 chunk costs
# half. An SM holds `_RESIDENT` CTAs at once (registers and shared memory);
# CTAs resident together share its rate, a CTA alone on an SM runs at 1/1.5
# of the shared rate per CTA (too few warps to hide latency), and the
# busiest SM (ceil(ctas / sms) CTAs) sets the time; each CTA adds 0.5 for
# its pipeline fill and epilogue, overlapped across the resident ones. With
# splits, the reduction kernel adds 0.5 and reads every fp32 partial back
# (≈1.1 µs per 3 MB). Fitted to split sweeps on an H100 at the ppi_sota
# serving and training shapes.
_CHUNK_COST = {128: 1.0, 64: 0.5}
_RESIDENT = {128: 2, 64: 3}
_ALONE = 1.5
_CTA_COST = 0.5
_REDUCE_COST = 0.5
_PARTIAL_ELEM_COST = 6.5e-7
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How one launch of the tile mainloop covers its output."""
    tile_n: int          # output columns per CTA: 128, or 64
    splits: int          # ranges of the contraction (blockIdx.z)
    copy_bytes: int      # 16 / 4: cp.async width; 0: synchronous loads
    ctas: int            # CTAs of the main kernel
    partial_elems: int   # fp32 workspace of the split partials (0: none)


def copy_width(dtype: torch.dtype, widths, ptrs) -> int:
    """The copy mode block_tile.cuh takes for operands whose rows are
    `widths` elements long and whose bases are at `ptrs`: 16-byte
    cp.async where every row and base is 16-byte aligned, 4-byte
    cp.async where they are 4-byte aligned (fp32 always; bf16 of even
    widths), else 0: synchronous loads (bf16 rows of odd width)."""
    es = _ESIZE[dtype]
    for mode in (16, 4):
        if all(w * es % mode == 0 for w in widths) and \
                all(p % mode == 0 for p in ptrs):
            return mode
    return 0


def _busiest_sm_cost(n: int, per: int, tile_n: int) -> float:
    """Time for an SM that runs `n` CTAs of `per` chunks each: in rounds
    of up to _RESIDENT[tile_n] CTAs sharing it; a last round of one CTA
    runs alone."""
    resident, unit = _RESIDENT[tile_n], per * _CHUNK_COST[tile_n]
    full, last = divmod(n, resident)
    return full * resident * unit + n * _CTA_COST / resident + (
        0.0 if last == 0 else unit * (_ALONE if last == 1 else last))


def plan_tiles(m_tiles: int, rows: int, n: int, chunks: int, copy: int,
               sms: int) -> TilePlan:
    """Tile width and split count for an output of `m_tiles` 128-row
    tiles (`rows` rows in all) by `n` columns over `chunks` 16-deep
    contraction chunks, on a card of `sms` SMs. Plans that launch at
    least `sms` CTAs come first; among them the least cost by the model
    above, then the fewest splits. Pure: the same shape gives the same
    plan, hence the same summation order."""
    best = None
    for tile_n in (128, 64):
        tiles = m_tiles * -(-n // tile_n)
        for s in range(1, max(1, min(chunks, _MAX_SPLITS)) + 1):
            per = -(-chunks // s)
            splits = -(-chunks // per) if per else 1
            ctas = tiles * splits
            cost = _busiest_sm_cost(-(-ctas // sms), per, tile_n)
            if splits > 1:
                cost += _REDUCE_COST + _PARTIAL_ELEM_COST * splits * rows * n
            key = (ctas < sms, round(cost, 9), splits, tile_n != 128)
            if best is None or key < best[0]:
                best = (key, TilePlan(tile_n, splits, copy, ctas,
                                      splits * rows * n if splits > 1
                                      else 0))
    return best[1]


def _low_bits(ptrs) -> int:
    """The base addresses' bits below 16: all that `copy_width` reads of
    them, so plans can be cached on it."""
    low = 0
    for p in ptrs:
        low |= p & 15
    return low


def spmm_plan(nrb: int, K: int, B: int, F: int, dtype: torch.dtype,
              ptrs, sms: int) -> TilePlan:
    """The block-ELL SpMM's plan: A is each slot's (B, B) tile, the
    contraction K slots of ceil(B/16) chunks; `ptrs` are the bases of
    the tiles and of x."""
    return _spmm_plan(nrb, K, B, F, dtype, _low_bits(ptrs), sms)


def xw_plan(M: int, D: int, F: int, dtype: torch.dtype, ptrs,
            sms: int) -> TilePlan:
    """The fused product's stage (a), XW + b over M rows of x; `ptrs`
    are the bases of x and w."""
    return _xw_plan(M, D, F, dtype, _low_bits(ptrs), sms)


# cached: a training step plans the same few shapes on every call, and
# planning costs microseconds of host time beside ~20 µs launches
@functools.lru_cache(maxsize=4096)
def _spmm_plan(nrb, K, B, F, dtype, low, sms) -> TilePlan:
    return plan_tiles(nrb * -(-B // _TILE_M), nrb * B, F, K * -(-B // _CHUNK),
                      copy_width(dtype, (B, F), (low,)), sms)


@functools.lru_cache(maxsize=4096)
def _xw_plan(M, D, F, dtype, low, sms) -> TilePlan:
    return plan_tiles(-(-M // _TILE_M), M, F, -(-D // _CHUNK),
                      copy_width(dtype, (D, F), (low,)), sms)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _on(device: torch.device):
    """The device context of a launch: none when `device` is current
    (entering one costs microseconds on every call)."""
    if device.type != "cuda" or device.index is None or \
            torch.cuda.device_count() == 1 or \
            device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The current CUDA stream of `device` as a pointer (the raw getter
    skips building a Stream object: several microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# the fp32 split partials per (device, stream), kept between launches
_WORKSPACE: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def _partials(x: torch.Tensor, stream: int, elems: int) -> Optional[int]:
    """A pointer to `elems` fp32 of split partials on the stream (None
    for none). The buffer is allocated here, with torch on x's device,
    grown when a launch needs more and reused otherwise: launches on one
    stream run in order, so they can share it, and allocating one per
    call costs microseconds on the host."""
    if not elems:
        return None
    key = (x.device.index, stream)
    part = _WORKSPACE.get(key)
    if part is None or part.numel() < elems:
        part = _WORKSPACE[key] = x.new_empty(elems, dtype=torch.float32)
    return part.data_ptr()


@contextlib.contextmanager
def graph_workspace():
    """For the capture of a CUDA graph: the launches inside take their
    split partials from a dict of their own, yielded, which the caller
    keeps for as long as the graph lives (a replay writes through the
    pointers its capture saw, so those buffers must never be freed or
    regrown under it). The shared per-stream buffers are neither used
    nor replaced meanwhile."""
    global _WORKSPACE
    saved, _WORKSPACE = _WORKSPACE, {}
    try:
        yield _WORKSPACE
    finally:
        _WORKSPACE = saved


def launch_counts() -> Tuple[int, int, int]:
    """(LAUNCHES, LAUNCHES_FUSED, LAUNCHES_SCATTER) as they stand."""
    return LAUNCHES, LAUNCHES_FUSED, LAUNCHES_SCATTER


def add_launches(counts: Tuple[int, int, int]) -> None:
    """Add `counts`, ordered as `launch_counts` gives them, to the
    counters: a CUDA graph's capture executes none of the launches it
    counted (it takes them back) and each replay executes all of them."""
    global LAUNCHES, LAUNCHES_FUSED, LAUNCHES_SCATTER
    LAUNCHES += counts[0]
    LAUNCHES_FUSED += counts[1]
    LAUNCHES_SCATTER += counts[2]


def _check_grid(plan: TilePlan, m_tiles: int, n: int) -> None:
    if -(-n // plan.tile_n) > _MAX_GRID_Y or m_tiles >= 2 ** 31:
        raise ValueError(f"shape too large for one launch: {m_tiles} row "
                         f"tiles of 128, {n} columns")


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


# the sections of a BlockEllCoords' packed buffer, in order
_SECTIONS = ("values", "offsets", "offsets_t", "block_cols", "block_cols_t",
             "row_k", "row_k_t")


@dataclasses.dataclass(frozen=True)
class BlockEllCoords:
    """A block-ELL Â and Âᵀ as the host ships them: each nonzero once,
    with where it lands in the tiles of either direction, instead of the
    tiles themselves (a batch's tiles are mostly zeros).

    packed: one int32 tensor, the sections of `sections()` end to end:
      values        (nnz,)      fp32 bits, CSR order
      offsets       (nnz,)      flat offset into blocks (nrb, K, B, B)
      offsets_t     (nnz,)      flat offset into blocks_t (ncb, Kt, B, B)
      block_cols    (nrb * K)   as in BlockEllAdj
      block_cols_t  (ncb * Kt)
      row_k         (nrb,)
      row_k_t       (ncb,)
    nnz: the nonzeros.
    shape: (nrb, K, ncb, Kt, B), the tile shape it expands to; payloads
      of one shape stack into one step (`core.engine._dp_groups`).

    `ops.block_ell_coords_from_csr` builds it; `to(device)` returns the
    `BlockEllAdj` that `ops.block_ell_adj_from_csr` builds from the same
    CSR, bit for bit. The offsets of distinct coordinates are distinct,
    so the scatter is exact in any order."""
    packed: torch.Tensor
    nnz: int
    shape: Tuple[int, int, int, int, int]

    def __post_init__(self):
        nrb, K, ncb, Kt, _ = self.shape
        want = 3 * self.nnz + nrb * K + ncb * Kt + nrb + ncb
        if self.packed.dtype != torch.int32 or \
                tuple(self.packed.shape) != (want,):
            raise ValueError(f"packed must be int32 ({want},); got "
                             f"{self.packed.dtype} "
                             f"{tuple(self.packed.shape)}")

    @staticmethod
    def allocate(nnz: int, shape) -> "BlockEllCoords":
        """An unfilled host adjacency of `nnz` nonzeros and tile shape
        `shape`; the builder writes every section."""
        nrb, K, ncb, Kt, _ = shape
        n = 3 * nnz + nrb * K + ncb * Kt + nrb + ncb
        return BlockEllCoords(torch.empty(n, dtype=torch.int32), int(nnz),
                              tuple(int(d) for d in shape))

    def sections(self, buf: Optional[torch.Tensor] = None) -> Dict:
        """Views of `buf` (the packed buffer, or a copy of it on another
        device) by section name, values as fp32 and the column maps as
        (nrb, K) and (ncb, Kt)."""
        buf = self.packed if buf is None else buf
        nrb, K, ncb, Kt, _ = self.shape
        sizes = (self.nnz, self.nnz, self.nnz, nrb * K, ncb * Kt, nrb, ncb)
        out, at = {}, 0
        for name, n in zip(_SECTIONS, sizes):
            out[name] = buf[at:at + n]
            at += n
        out["values"] = out["values"].view(torch.float32)
        out["block_cols"] = out["block_cols"].view(nrb, K)
        out["block_cols_t"] = out["block_cols_t"].view(ncb, Kt)
        return out

    def tensors(self):
        """What crosses to the device: the one packed buffer."""
        return (self.packed,)

    def to(self, device, non_blocking: bool = False) -> BlockEllAdj:
        """The tiles on `device`: one copy of the packed buffer, then
        `scatter_tiles` (the CUDA kernel on a card, numpy on the CPU).
        Nothing waits on the device beyond the copy itself, which is
        blocking unless `non_blocking`; with non_blocking, the buffer is
        first copied into pinned memory."""
        dev = torch.device(device)
        buf = self.packed
        if buf.device != dev:
            if non_blocking and buf.device.type == "cpu" and \
                    dev.type == "cuda":
                buf = buf.pin_memory()
            buf = buf.to(dev, non_blocking=non_blocking)
        s = self.sections(buf)
        nrb, K, ncb, Kt, B = self.shape
        blocks, blocks_t = scatter_tiles(s["values"], s["offsets"],
                                         s["offsets_t"], nrb * K * B * B,
                                         ncb * Kt * B * B)
        # the columns were checked on the host when they were built
        return BlockEllAdj(blocks.view(nrb, K, B, B), s["block_cols"],
                           blocks_t.view(ncb, Kt, B, B), s["block_cols_t"],
                           s["row_k"], s["row_k_t"], checked=True)


@functools.cache
def _scatter_fns():
    lib = _build.load("block_ell_scatter")
    fn = lib.block_ell_scatter_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = lib.block_ell_scatter_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def scatter_tiles(values: torch.Tensor, offsets: torch.Tensor,
                  offsets_t: torch.Tensor, n: int, n_t: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two zeroed fp32 arrays of n and n_t elements with values[i] at
    offsets[i] in the first and at offsets_t[i] in the second (int32
    offsets, each distinct within its array and already in range). On a
    CUDA tensor: one `torch.zeros` and one launch on the current stream,
    no sync; on the CPU: numpy."""
    global LAUNCHES_SCATTER
    dev = values.device
    if dev.type == "cpu":
        v = values.numpy()
        tiles, tiles_t = np.zeros(n, np.float32), np.zeros(n_t, np.float32)
        tiles[offsets.numpy()] = v
        tiles_t[offsets_t.numpy()] = v
        return torch.from_numpy(tiles), torch.from_numpy(tiles_t)
    if dev.type != "cuda":
        raise ValueError(f"no block-ELL scatter for device {dev}")
    both = torch.zeros(n + n_t, dtype=torch.float32, device=dev)
    tiles, tiles_t = both[:n], both[n:]
    nnz = values.numel()
    if nnz:
        fn, err_str = _scatter_fns()
        with _on(dev):
            err = fn(values.data_ptr(), offsets.data_ptr(),
                     offsets_t.data_ptr(), nnz, tiles.data_ptr(),
                     tiles_t.data_ptr(), _stream(dev))
        if err:
            raise RuntimeError(f"block_ell_scatter launch failed: "
                               f"{err_str(err).decode()} (cudaError {err})")
        LAUNCHES_SCATTER += 1
    return tiles, tiles_t


# ----------------------------------------------------------------------
# kernel 1: y = Â·X
# ----------------------------------------------------------------------
@functools.cache
def _kernel_fns():
    lib = _build.load("block_ell_spmm")
    argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
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
    plan = spmm_plan(nrb, K, B, F, x.dtype, (blocks.data_ptr(), x.data_ptr()),
                     _sms(x.device))
    _check_grid(plan, nrb * -(-B // _TILE_M), F)
    fns, err_str = _kernel_fns()
    y = x.new_empty((nrb * B, F))
    with _on(x.device):
        stream = _stream(x.device)
        err = fns[x.dtype](blocks.data_ptr(), block_cols.data_ptr(),
                           None if row_k is None else row_k.data_ptr(),
                           x.data_ptr(), y.data_ptr(),
                           _partials(x, stream, plan.partial_elems),
                           nrb, K, B, F, plan.tile_n, plan.splits,
                           plan.copy_bytes, stream)
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
    argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
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
    """y = A @ (x @ w + b) with A in block-ELL form, in one call (XW + b
    once per row of x into a scratch, then the block-ELL SpMM over it).
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
    """Launch the fused product (stage (a) XW + b into a scratch of x's
    dtype, stage (b) the block-ELL SpMM over it: one C call, one count)
    on validated operands (blocks and w in x's dtype, b fp32 or None) on
    the current stream."""
    global LAUNCHES_FUSED
    nrb, K, B, _ = blocks.shape
    M, D = x.shape
    F = w.shape[1]
    sms = _sms(x.device)
    plan_a = xw_plan(M, D, F, x.dtype, (x.data_ptr(), w.data_ptr()), sms)
    _check_grid(plan_a, -(-M // _TILE_M), F)
    fns, err_str = _fused_fns()
    xw = x.new_empty((M, F))
    plan_b = spmm_plan(nrb, K, B, F, x.dtype,
                       (blocks.data_ptr(), xw.data_ptr()), sms)
    _check_grid(plan_b, nrb * -(-B // _TILE_M), F)
    y = x.new_empty((nrb * B, F))
    with _on(x.device):
        stream = _stream(x.device)
        part = _partials(x, stream, max(plan_a.partial_elems,
                                        plan_b.partial_elems))
        err = fns[x.dtype](blocks.data_ptr(), block_cols.data_ptr(),
                           None if row_k is None else row_k.data_ptr(),
                           x.data_ptr(), w.data_ptr(),
                           None if b is None else b.data_ptr(),
                           y.data_ptr(), xw.data_ptr(), part,
                           nrb, K, B, M, D, F,
                           plan_a.tile_n, plan_a.splits, plan_a.copy_bytes,
                           plan_b.tile_n, plan_b.splits, plan_b.copy_bytes,
                           stream)
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
