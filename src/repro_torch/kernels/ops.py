"""Host-side block-ELL builders (numpy), the SpMM dispatch and the
attention dispatch — the port of `repro.kernels.ops`.

Builders, copied from the reference: `block_ell_from_dense`,
`block_ell_from_csr` with its vectorized COO core, `block_ell_transpose`,
`block_ell_adj_from_dense`, `block_ell_adj_from_csr`,
`block_ell_needed_k`, and the `TileBufferPool` that `_scatter_tiles`
sources buffers from. Their tiles are bit-identical to the reference's
(tests/test_torch_host_stages.py, tests/test_torch_batching.py); the
`BlockEllAdj` builders wrap the numpy leaves as CPU tensors without a
copy. The port's own `block_ell_coords_from_csr` is what a sparse batch
payload carries: the same adjacency as `block_ell_adj_from_csr`'s, as
nonzeros with their tile offsets, whose tiles `.to(device)` writes.

Dispatch: `spmm(adj, x)` and `spmm_xw(adj, x, w, b)` take a dense
adjacency (a tensor: `torch.matmul` in x's dtype with fp32
accumulation) or a `BlockEllAdj` (the differentiable block-ELL products
of `repro_torch.kernels.block_spmm`). `multi_head_attention(q, k, v)`
is the attention seam of the LM stack (`kernels/flash_attention.py`);
on DTensors (a sharded step) it runs the kernel under `local_map`, so
the kernel only ever sees one rank's shards.

Format (what the CUDA kernels assume): blocks (nrb, K, B, B) value
tiles; block_cols (nrb, K) int32; within a row-block the occupied
slots come first in ascending column-block order, and trailing empty
slots hold an all-zero tile pointing at column-block 0.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.block_spmm import (BlockEllAdj, BlockEllCoords,
                                            spmm_ell, spmm_fused)
from repro_torch.kernels.flash_attention import flash_attention


class TileBufferPool:
    """Ring of reusable zeroed host buffers for the block-ELL builders.

    The builders' dominant allocation is the pair of K·B² tile arrays
    (forward + transpose) they zero-fill per batch — at cap 8192, B 128,
    K 64 that is 2 × 512 MB of fresh np.zeros per batch. A pool hands
    out the same `depth` buffers round-robin per (size, dtype) and
    re-zeros ONLY the positions the builder reported writing
    (`mark(buf, flat_indices)`) — for sparse batches that is the nnz
    footprint, not the full buffer, so steady-state builder cost tracks
    the data actually written.

    Correctness contract: a buffer handed out by `zeros` is recycled
    after `depth` further same-key requests, so the caller must be done
    with what it built by then. A buffer that was never `mark`ed is
    fully re-zeroed on recycle, so forgetting to mark costs speed, never
    correctness. Not thread-safe — use one pool per producer thread.
    The training payload no longer takes tiles from a pool: a sparse
    batch ships coordinates (`block_ell_coords_from_csr`).
    """

    def __init__(self, depth: int = 8):
        self.depth = max(2, int(depth))
        # (size, dtype str) -> {"bufs": [arr], "written": [idx|None], "i"}
        self._rings: dict = {}
        self._slots: dict = {}         # id(flat buffer) -> (key, index)

    def zeros(self, n: int, dtype) -> np.ndarray:
        """An all-zero flat (n,) buffer of `dtype`, freshly allocated
        until the ring is full, then recycled round-robin."""
        key = (int(n), np.dtype(dtype).str)
        ring = self._rings.setdefault(key,
                                      {"bufs": [], "written": [], "i": 0})
        if len(ring["bufs"]) < self.depth:
            buf = np.zeros(n, dtype)
            ring["bufs"].append(buf)
            ring["written"].append(None)
            self._slots[id(buf)] = (key, len(ring["bufs"]) - 1)
            return buf
        i = ring["i"]
        ring["i"] = (i + 1) % self.depth
        buf = ring["bufs"][i]
        w = ring["written"][i]
        if w is None:
            buf[:] = 0                  # unknown writes: full re-zero
        elif isinstance(w, tuple):      # ("rows", idx, span) — mark_rows
            _, idx, span = w
            if len(idx):
                buf.reshape(-1, span)[idx] = 0
        elif len(w):
            buf[w] = 0                  # sparse re-zero of what was used
        ring["written"][i] = None
        return buf

    def mark(self, buf: np.ndarray, flat_indices: np.ndarray) -> None:
        """Record the flat positions written into a pooled buffer so its
        next recycle zeroes only those. No-op for foreign buffers."""
        slot = self._slots.get(id(buf))
        if slot is not None:
            key, i = slot
            self._rings[key]["written"][i] = flat_indices

    def mark_rows(self, buf: np.ndarray, row_indices: np.ndarray,
                  span: int) -> None:
        """Record whole written ROWS of `buf` viewed as (-1, span) — the
        shape of whole-tile writes (block_ell_transpose stores B·B tiles
        per slot), where per-element flat indices would cost more than
        they save. Recycle re-zeros `buf.reshape(-1, span)[rows]`.
        No-op for foreign buffers."""
        slot = self._slots.get(id(buf))
        if slot is not None:
            key, i = slot
            self._rings[key]["written"][i] = \
                ("rows", np.asarray(row_indices), int(span))


def _block_ell_from_coo(rows, cols, data, nrb: int, ncb: int, block: int,
                        k_slots: int | None = None,
                        dtype=np.float32,
                        assume_unique: bool | None = None,
                        pool=None, with_row_k: bool = False):
    """Vectorized block-ELL assembly from COO coordinates (the
    `block_ell_from_csr` core). Pure bincount/cumsum/scatter, no
    Python loops over tiles and no O(nnz log nnz) sorts; duplicate
    (row, col) entries accumulate. Slots within a row-block are ordered
    by ascending column-block, exactly the reference builders' layout
    (bit-match proven by tests/test_torch_host_stages.py). `assume_unique` skips the
    duplicate-coordinate probe when the caller already knows (canonical
    CSR has no duplicates)."""
    B = block
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    data = np.asarray(data)
    rb, cb, rlo, clo = _block_coords(rows, cols, B, nrb, ncb)
    present = _occupancy(rb, cb, nrb, ncb)
    need = int(present.sum(1).max()) if present.size else 0
    K = k_slots if k_slots is not None else max(1, need)
    if need > K:
        raise ValueError(
            f"k_slots={K} drops non-zero tiles (need {need})")
    if assume_unique is None:
        assume_unique = not _has_duplicate_coords(rows, cols,
                                                  np.int64(ncb) * B)
    blocks, cols_arr = _scatter_tiles(present, rb, cb, rlo, clo, data,
                                      K, B, assume_unique, dtype,
                                      pool=pool)
    if with_row_k:
        return blocks, cols_arr, present.sum(1).astype(np.int32)
    return blocks, cols_arr


def _scatter_tiles(present, rb, cb, rlo, clo, data, K: int, B: int,
                   assume_unique: bool, dtype=np.float32, pool=None):
    """One block-ELL scatter direction given the (nrb, ncb) tile
    occupancy and per-nnz block/offset coordinates. The caller has
    already validated K against the per-row-block need. `pool`
    (TileBufferPool) sources the two output buffers from the reuse ring
    instead of fresh np.zeros — bit-identical output, the written
    positions are reported back so recycling re-zeros only those."""
    nrb, ncb = present.shape
    if pool is None:
        cols_flat = np.zeros(nrb * K, np.int32)
    else:
        cols_flat = pool.zeros(nrb * K, np.int32)
    cols_arr = cols_flat.reshape(nrb, K)
    if K == 0 or not present.any():
        if pool is None:
            blocks_flat = np.zeros(nrb * K * B * B, dtype)
        else:
            blocks_flat = pool.zeros(nrb * K * B * B, dtype)
            empty = np.empty(0, np.int64)
            pool.mark(cols_flat, empty)
            pool.mark(blocks_flat, empty)
        return blocks_flat.reshape(nrb, K, B, B), cols_arr
    pr, pc, cslot, flat = _tile_layout(present, rb, cb, rlo, clo, K, B)
    cols_arr[pr, cslot] = pc.astype(np.int32)
    # one flat scatter: distinct coordinates map to distinct flat
    # indices, so plain fancy assignment is exact (and ~5× cheaper than
    # the buffered np.add.at, which is kept for the duplicate case —
    # f32 accumulation, same bit pattern as the loop-based reference)
    if pool is None:
        blocks = np.zeros(nrb * K * B * B, dtype)
    else:
        blocks = pool.zeros(nrb * K * B * B, dtype)
        pool.mark(cols_flat, pr.astype(np.int64) * K + cslot)
        pool.mark(blocks, flat)
    if assume_unique:
        blocks[flat] = data
    else:
        np.add.at(blocks, flat, data)
    return blocks.reshape(nrb, K, B, B), cols_arr


def _tile_layout(present, rb, cb, rlo, clo, K: int, B: int):
    """Where one scatter direction puts each nonzero: the occupied tiles
    (pr, pc) of the (nrb, ncb) occupancy, in row-major order, the slot
    each takes in its row-block, and every nonzero's flat offset into
    the (nrb, K, B, B) tile array (int32 whenever the array fits)."""
    nrb, ncb = present.shape
    # rank of tile (r, c) among the occupied tiles of row-block r,
    # ordered by ascending c — the slot layout the loop-based reference
    # produces (np.nonzero scans row-major, so no sort needed here either)
    idt = np.int32 if nrb * K * B * B < 2**31 else np.int64
    rank = (np.cumsum(present, axis=1) - 1).astype(idt)    # (nrb, ncb)
    pr, pc = np.nonzero(present)
    cslot = rank[pr, pc]
    # the per-tile flat start offset is a tiny (nrb, ncb) table, so the
    # per-nnz work is one gather on the flat tile key + multiply-adds
    tstart = ((rank + np.arange(nrb, dtype=idt)[:, None] * idt(K))
              * idt(B * B)).ravel()
    flat = np.take(tstart, _tile_key(rb, cb, nrb, ncb)) \
        + rlo.astype(idt, copy=False) * idt(B) + clo.astype(idt, copy=False)
    return pr, pc, cslot, flat


def _block_coords(rows, cols, B: int, nrb: int, ncb: int):
    """(rows // B, cols // B, rows % B, cols % B) in int32 when the tile
    grid allows it (it always does for cluster batches); shifts and
    masks when B is a power of two (the indices are non-negative)."""
    idt = np.int32 if max(nrb, ncb) * B < 2**31 else np.int64
    rows = rows.astype(idt, copy=False)
    cols = cols.astype(idt, copy=False)
    if B & (B - 1) == 0:
        shift, mask = B.bit_length() - 1, idt(B - 1)
        return rows >> shift, cols >> shift, rows & mask, cols & mask
    return rows // B, cols // B, rows % B, cols % B


def _tile_key(rb, cb, nrb: int, ncb: int):
    """Each nonzero's tile, row-major in the (nrb, ncb) grid."""
    if nrb * ncb >= 2**31:
        rb = rb.astype(np.int64)
    return rb * rb.dtype.type(ncb) + cb


def _occupancy(rb, cb, nrb: int, ncb: int):
    """The (nrb, ncb) tile occupancy. The tile-key space is tiny (≤
    (cap/B)² cells), so occupied tiles and their per-row ranks come
    from one O(nnz) bincount + an O(ntiles) cumsum table — NO
    O(nnz log nnz) sort anywhere."""
    return (np.bincount(_tile_key(rb, cb, nrb, ncb), minlength=nrb * ncb)
            > 0).reshape(nrb, ncb)


def _expand_rows(indptr):
    """CSR row ids per nnz, int32 when the row count allows it."""
    n = len(indptr) - 1
    rdt = np.int32 if n < 2**31 else np.int64
    return np.repeat(np.arange(n, dtype=rdt), np.diff(indptr))


def _has_duplicate_coords(rows, cols, col_span) -> bool:
    """True if any (row, col) coordinate repeats. Canonical CSR keeps
    rows grouped and column indices sorted, so one adjacent-diff pass
    answers it; unsorted input falls back to np.unique."""
    if len(rows) < 2:
        return False
    d_r, d_c = np.diff(rows), np.diff(cols)
    if bool(np.all((d_r > 0) | ((d_r == 0) & (d_c >= 0)))):  # CSR order
        return bool(((d_r == 0) & (d_c == 0)).any())
    elem = rows.astype(np.int64) * col_span + cols
    return len(np.unique(elem)) != len(elem)


def block_ell_from_csr(indptr, indices, data, n_cols: int, block: int = 128,
                       k_slots: int | None = None,
                       n_rows: int | None = None,
                       pool=None, with_row_k: bool = False):
    """Block-ELL from CSR without densifying the full matrix (full-graph
    inference path). Memory ~ nnz-blocks · B². `n_rows` pads the row dim
    beyond len(indptr)-1 (fixed-shape cluster batches). Vectorized
    (bincount/cumsum/scatter), bit-identical to the reference builder.
    `pool` (TileBufferPool) sources
    the tile buffers from the reuse ring instead of a fresh K·B²
    zero-fill — bit-identical output. `with_row_k=True` appends the
    (nrb,) int32 per-row-block occupancy as a third element."""
    n = len(indptr) - 1
    B = block
    nrb, ncb = -(-max(n, n_rows or 0) // B), -(-n_cols // B)
    rows = _expand_rows(indptr)
    return _block_ell_from_coo(rows, indices, data, nrb, ncb, B, k_slots,
                               pool=pool, with_row_k=with_row_k)


def block_ell_needed_k(indptr, indices, block: int, n_cols: int,
                       n_rows: int | None = None) -> tuple[int, int]:
    """(need_fwd, need_t): smallest lossless K for the forward and the
    transposed block-ELL of this CSR pattern — computed from coordinates
    only, no tiles built. This is what the fill-adaptive K-bucket policy
    (repro_torch.core.kslots) measures per batch."""
    n = len(indptr) - 1
    B = block
    nrb, ncb = -(-max(n, n_rows or 0) // B), -(-n_cols // B)
    rb, cb, _, _ = _block_coords(_expand_rows(indptr), np.asarray(indices),
                                 B, nrb, ncb)
    present = _occupancy(rb, cb, nrb, ncb)
    if not present.any():
        return 0, 0
    return int(present.sum(1).max()), int(present.sum(0).max())



def block_ell_from_dense(adj: np.ndarray, block: int = 128,
                         k_slots: int | None = None,
                         with_row_k: bool = False):
    """Tile a dense (n, m) matrix into block-ELL. Returns (blocks,
    block_cols) with shapes ((nrb, K, B, B), (nrb, K)); rows padded up to a
    block multiple. Empty slots carry a zero tile pointing at col-block 0.
    `with_row_k=True` appends the (nrb,) int32 per-row-block occupancy
    (the K-specialization map) as a third element."""
    n, m = adj.shape
    B = block
    nrb, ncb = -(-n // B), -(-m // B)
    padded = np.zeros((nrb * B, ncb * B), adj.dtype)
    padded[:n, :m] = adj
    tiles = padded.reshape(nrb, B, ncb, B).transpose(0, 2, 1, 3)  # (nrb,ncb,B,B)
    nz = np.abs(tiles).sum(axis=(2, 3)) > 0                        # (nrb, ncb)
    need = int(nz.sum(1).max()) if nz.size else 0
    K = k_slots if k_slots is not None else max(1, need)
    if need > K:
        raise ValueError(
            f"k_slots={K} drops non-zero tiles (need {need})")
    blocks = np.zeros((nrb, K, B, B), adj.dtype)
    cols = np.zeros((nrb, K), np.int32)
    for i in range(nrb):
        cbs = np.where(nz[i])[0]
        blocks[i, :len(cbs)] = tiles[i, cbs]
        cols[i, :len(cbs)] = cbs
    if with_row_k:
        return blocks, cols, nz.sum(1).astype(np.int32)
    return blocks, cols


def block_ell_transpose(blocks: np.ndarray, block_cols: np.ndarray,
                        n_col_blocks: int, k_slots: int | None = None,
                        pool=None, with_row_k: bool = False):
    """Host-side transpose of a block-ELL matrix: tile (i, →c) becomes
    tile (c, →i) transposed. All-zero tiles (ELL padding slots) are
    skipped so padding never inflates the transposed K. Duplicate
    (row, col) tiles accumulate — the spmm sums over slots, so this stays
    lossless. Raises if an explicit k_slots would drop a non-zero tile.
    Vectorized: one fused any() over tiles + a stable argsort by column
    block. `pool` (TileBufferPool) sources the transposed tile buffers
    from the reuse ring — whole-tile writes are reported via
    `mark_rows`, so the recycle re-zeros one (B, B) row span per written
    slot instead of the full K_t·B² fill. `with_row_k=True` appends the
    (ncb,) int32 occupancy of the transposed tiles as a third element."""
    blocks = np.asarray(blocks)
    block_cols = np.asarray(block_cols)
    nrb, K, B, _ = blocks.shape
    ncb = n_col_blocks
    nz = (blocks.reshape(nrb, K, -1).any(axis=-1) if blocks.size
          else np.zeros((nrb, K), bool))
    i_arr, k_arr = np.nonzero(nz)               # ordered by (i, k)
    c_arr = block_cols[i_arr, k_arr].astype(np.int64)
    counts = np.bincount(c_arr, minlength=ncb)
    K_t = k_slots if k_slots is not None else max(1, int(counts.max())
                                                  if counts.size else 1)
    if len(c_arr) and int(counts.max()) > K_t:
        raise ValueError(
            f"k_slots={K_t} drops non-zero transposed tiles "
            f"(need {int(counts.max())})")
    if pool is None:
        blocks_t = np.zeros((ncb, K_t, B, B), blocks.dtype)
        cols_t = np.zeros((ncb, K_t), np.int32)
        bt_flat = ct_flat = None
    else:
        bt_flat = pool.zeros(ncb * K_t * B * B, blocks.dtype)
        ct_flat = pool.zeros(ncb * K_t, np.int32)
        blocks_t = bt_flat.reshape(ncb, K_t, B, B)
        cols_t = ct_flat.reshape(ncb, K_t)
    if len(c_arr):
        order = np.argsort(c_arr, kind="stable")  # keep (i, k) order per c
        cs = c_arr[order]
        start = np.zeros(ncb + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        slot = np.arange(len(cs), dtype=np.int64) - start[cs]
        blocks_t[cs, slot] = blocks[i_arr[order], k_arr[order]] \
            .transpose(0, 2, 1)
        cols_t[cs, slot] = i_arr[order].astype(np.int32)
        if pool is not None:
            written = cs * K_t + slot
            pool.mark_rows(bt_flat, written, B * B)
            pool.mark(ct_flat, written)
    elif pool is not None:
        empty = np.empty(0, np.int64)
        pool.mark(bt_flat, empty)
        pool.mark(ct_flat, empty)
    if with_row_k:
        return blocks_t, cols_t, counts.astype(np.int32)
    return blocks_t, cols_t


def block_ell_adj_from_dense(adj: np.ndarray, block: int = 128,
                             k_slots: int | None = None,
                             k_slots_t: int | None = None) -> BlockEllAdj:
    """BlockEllAdj (forward + transposed tiles) from a dense matrix.
    Leaves are CPU tensors over the host numpy arrays; `.to(device)`
    moves them when the step runs."""
    blocks, cols, row_k = block_ell_from_dense(adj, block, k_slots,
                                               with_row_k=True)
    ncb = -(-adj.shape[1] // block)
    kt = k_slots_t if k_slots_t is not None else k_slots
    blocks_t, cols_t, row_k_t = block_ell_transpose(blocks, cols, ncb, kt,
                                                    with_row_k=True)
    return BlockEllAdj.from_numpy(blocks, cols, blocks_t, cols_t,
                                  row_k, row_k_t)


def _csr_tile_plan(indptr, indices, n_cols: int, block: int, k_slots,
                   k_slots_t, n_rows, k_chooser):
    """What both CSR adjacency builders compute once and share between
    the two directions: the COO rows, the block/offset coordinates (the
    transpose swaps them), the (nrb, ncb) tile occupancy (the
    transposed occupancy is its transpose) and the two K, checked
    against the occupancy."""
    n = len(indptr) - 1
    B = block
    nrb, ncb = -(-max(n, n_rows or 0) // B), -(-n_cols // B)
    rows = _expand_rows(indptr)
    cols = np.asarray(indices)
    rb, cb, rlo, clo = _block_coords(rows, cols, B, nrb, ncb)
    present = _occupancy(rb, cb, nrb, ncb)
    need_f = int(present.sum(1).max()) if present.size else 0
    need_t = int(present.sum(0).max()) if present.size else 0
    if k_chooser is not None:
        if k_slots is not None or k_slots_t is not None:
            raise ValueError("pass either k_chooser or k_slots/k_slots_t")
        K = Kt = int(k_chooser(need_f, need_t))
    else:
        K = k_slots if k_slots is not None else max(1, need_f)
        kt = k_slots_t if k_slots_t is not None else k_slots
        Kt = kt if kt is not None else max(1, need_t)
    if need_f > K:
        raise ValueError(
            f"k_slots={K} drops non-zero tiles (need {need_f})")
    if need_t > Kt:
        raise ValueError(
            f"k_slots={Kt} drops non-zero tiles (need {need_t})")
    return rows, cols, (rb, cb, rlo, clo), present, K, Kt


def block_ell_adj_from_csr(indptr, indices, data, n_cols: int,
                           block: int = 128, k_slots: int | None = None,
                           k_slots_t: int | None = None,
                           n_rows: int | None = None,
                           assume_unique: bool | None = None,
                           k_chooser=None) -> BlockEllAdj:
    """BlockEllAdj from CSR without densifying. The transpose is built
    DIRECTLY from the CSR coordinates (CSC = swapped COO through the
    same vectorized assembler — tile (c,→i) of Âᵀ is tile (i,→c) of Â
    transposed), never tile-by-tile from the forward tiles. `assume_unique=True` skips the duplicate-coordinate probe
    when the caller knows the CSR is canonical (everything
    normalize_csr emits is). `k_chooser` (mutually exclusive with
    k_slots/k_slots_t) maps the measured (need_fwd, need_t) to one K for
    both directions — the fill-adaptive bucket policy picks its bucket
    HERE, from the occupancy this builder computes anyway."""
    B = block
    data = np.asarray(data)
    rows, cols_coo, (rb, cb, rlo, clo), present, K, Kt = _csr_tile_plan(
        indptr, indices, n_cols, B, k_slots, k_slots_t, n_rows, k_chooser)
    uniq_coords = assume_unique if assume_unique is not None else \
        not _has_duplicate_coords(rows, cols_coo,
                                  np.int64(present.shape[1]) * B)
    blocks, cols = _scatter_tiles(present, rb, cb, rlo, clo, data, K, B,
                                  uniq_coords)
    blocks_t, cols_t = _scatter_tiles(present.T, cb, rb, clo, rlo, data,
                                      Kt, B, uniq_coords)
    # the occupancy bincount computed above IS the K-specialization map —
    # per-row-block live slots forward, per-col-block for the transpose
    return BlockEllAdj.from_numpy(blocks, cols, blocks_t, cols_t,
                                  present.sum(1).astype(np.int32),
                                  present.sum(0).astype(np.int32))


def block_ell_coords_from_csr(indptr, indices, data, n_cols: int,
                              block: int = 128, k_slots: int | None = None,
                              k_slots_t: int | None = None,
                              n_rows: int | None = None,
                              k_chooser=None) -> BlockEllCoords:
    """The adjacency `block_ell_adj_from_csr` builds, as coordinates —
    the ClusterBatcher sparse path (normalize_csr output goes straight
    here): the same K choice and checks, the same column maps and
    occupancy, and for each nonzero its fp32 value and its flat offsets
    into the forward and the transposed tiles, packed into one host
    buffer; no tile is written until `.to(device)`. The coordinates
    must be unique (canonical CSR, as normalize_csr emits), and the
    offsets int32."""
    B = block
    data = np.asarray(data)
    _, _, (rb, cb, rlo, clo), present, K, Kt = _csr_tile_plan(
        indptr, indices, n_cols, B, k_slots, k_slots_t, n_rows, k_chooser)
    nrb, ncb = present.shape
    if max(nrb * K, ncb * Kt) * B * B >= 2**31:
        raise ValueError(f"tiles of ({nrb}, {K}) and ({ncb}, {Kt}) slots "
                         f"of {B}² need offsets beyond int32")
    coords = BlockEllCoords.allocate(len(data), (nrb, K, ncb, Kt, B))
    s = {k: v.numpy() for k, v in coords.sections().items()}
    s["values"][:] = data
    for direction, (occ, r, c, lo_r, lo_c, k) in (
            ("", (present, rb, cb, rlo, clo, K)),
            ("_t", (present.T, cb, rb, clo, rlo, Kt))):
        pr, pc, cslot, flat = _tile_layout(occ, r, c, lo_r, lo_c, k, B)
        s["offsets" + direction][:] = flat
        cols = s["block_cols" + direction]
        cols[:] = 0
        cols[pr, cslot] = pc
        s["row_k" + direction][:] = occ.sum(1)
    return coords


# ----------------------------------------------------------------------
# SpMM dispatch
# ----------------------------------------------------------------------
def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """Adjacency-polymorphic y = Â x — the seam every training layer
    dispatches through. A dense `adj` tensor goes to `spmm_dense`; a
    `BlockEllAdj` to the differentiable block-ELL product `spmm_ell`
    (CUDA kernel on the GPU, its plain version on the CPU; backward on
    the transposed tiles). The result is in x's dtype with fp32
    accumulation either way; Â gets no gradient."""
    if isinstance(adj, BlockEllAdj):
        return spmm_ell(adj, x)
    return spmm_dense(adj, x)


def spmm_dense(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense path: adj rounded to x's dtype, fp32 accumulation, result
    cast to x's dtype (plain `adj @ x` when everything is fp32)."""
    return torch.matmul(adj.to(x.dtype).float(), x.float()).to(x.dtype)


def spmm_xw(adj, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Adjacency-polymorphic fused y = Â (X W + 1 bᵀ) — the seam
    `gcn_forward` takes when `model.fuse_spmm` is on. A `BlockEllAdj`
    goes to the fused block-ELL product (`spmm_fused`); a dense `adj`
    runs the exact unfused layer math (XW in x's dtype with fp32
    accumulation, fp32 bias, cast to x's dtype, `spmm_dense`)."""
    if isinstance(adj, BlockEllAdj):
        return spmm_fused(adj, x, w, b)
    cd = x.dtype
    z = torch.matmul(x.float(), w.to(cd).float())
    if b is not None:
        z = z + b
    return spmm_dense(adj, z.to(cd))


# ----------------------------------------------------------------------
# attention dispatch
# ----------------------------------------------------------------------
def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window=None, softcap=None,
                         scale=None) -> torch.Tensor:
    """q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D); returns (B, Hq, Tq, D)
    — the counterpart of `repro.kernels.ops.multi_head_attention`. GQA
    maps q head h to kv head h // (Hq/Hkv). CUDA tensors run the flash
    kernel (`csrc/flash_attention.cu`, kv heads indexed in place), CPU
    tensors its plain version (kv heads repeated). DTensors go through
    `sharded_attention`."""
    if _is_dtensor(q):
        return sharded_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sharded_attention(q, k, v, *, causal: bool = True, window=None,
                      softcap=None, scale=None):
    """`flash_attention` on DTensors q (B, Hq, Tq, D), k, v (B, Hkv, Tk,
    D): the batch over the mesh's data axes and the heads over 'model'
    (each only where it divides), then the kernel under `local_map` on
    every rank's shards, so `_FlashAttention` (which passes raw
    pointers) never receives a DTensor. Attention is independent per
    (batch row, head), so the local results are the global result's
    shards and no collective runs inside. When the kv heads do not split
    over 'model' (Hkv < the axis), k and v are repeated to the q heads
    first (q head h reads kv head h // (Hq/Hkv)), on each rank's
    replicated copy."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    B, Hq = q.shape[0], q.shape[1]
    Hkv = k.shape[1]
    dsize = math.prod(sizes[a] for a in names if a in ("pod", "data"))
    msize = sizes.get("model", 1)
    by_batch = B % dsize == 0
    by_heads = Hq % msize == 0

    def layout(heads_sharded: bool):
        return tuple(
            Shard(0) if a in ("pod", "data") and by_batch else
            Shard(1) if a == "model" and heads_sharded else Replicate()
            for a in names)
    qp = layout(by_heads)
    if by_heads and msize > 1 and Hkv % msize:
        rep = Hq // Hkv
        k, v = (t.redistribute(mesh, layout(False)) for t in (k, v))
        k, v = (t[:, :, None].expand(t.shape[0], Hkv, rep, *t.shape[2:])
                .reshape(t.shape[0], Hq, *t.shape[2:]) for t in (k, v))
    q, k, v = (t.redistribute(mesh, qp) for t in (q, k, v))
    fn = local_map(functools.partial(flash_attention, causal=causal,
                                     window=window, softcap=softcap,
                                     scale=scale),
                   out_placements=(qp,), in_placements=(qp, qp, qp),
                   device_mesh=mesh)
    return fn(q, k, v)
