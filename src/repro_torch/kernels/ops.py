"""Host-side block-ELL builders (numpy) — a copy of the builders in
`repro.kernels.ops`: `block_ell_from_csr` with its vectorized COO core,
`block_ell_needed_k`, and the `TileBufferPool` that `_scatter_tiles`
sources buffers from. Output is bit-identical to the reference's
(tests/test_torch_host_stages.py). The tiles go to the device as torch
tensors; the product itself is `repro_torch.kernels.block_spmm`.

Format (what the CUDA kernel assumes): blocks (nrb, K, B, B) value
tiles; block_cols (nrb, K) int32; within a row-block the occupied
slots come first in ascending column-block order, and trailing empty
slots hold an all-zero tile pointing at column-block 0.
"""
from __future__ import annotations

import numpy as np


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
    after `depth` further same-key requests, so the consumer must be
    done with a payload by then (training steps consume batches in
    order; prefetch queues are shallower than `depth`; the DP stacker
    deep-copies the few batches it retains across an epoch —
    engine._dp_groups). A buffer that was never `mark`ed is fully
    re-zeroed on recycle, so forgetting to mark costs speed, never
    correctness. Not thread-safe — use one pool per producer thread
    (each sampler owns its own).
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
    # the tile-key space is tiny (≤ (cap/B)² cells), so occupied tiles
    # and their per-row ranks come from one O(nnz) bincount + an
    # O(ntiles) cumsum table — NO O(nnz log nnz) sort anywhere
    present = (np.bincount(rb.astype(np.int64, copy=False) * ncb + cb,
                           minlength=nrb * ncb) > 0).reshape(nrb, ncb)
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
    # rank of tile (r, c) among the occupied tiles of row-block r,
    # ordered by ascending c — the slot layout the loop-based reference
    # produces (np.nonzero scans row-major, so no sort needed here either)
    idt = np.int32 if nrb * K * B * B < 2**31 else np.int64
    rank = (np.cumsum(present, axis=1) - 1).astype(idt)    # (nrb, ncb)
    pr, pc = np.nonzero(present)
    cslot = rank[pr, pc]
    cols_arr[pr, cslot] = pc.astype(np.int32)
    # one flat scatter: distinct coordinates map to distinct flat
    # indices, so plain fancy assignment is exact (and ~5× cheaper than
    # the buffered np.add.at, which is kept for the duplicate case —
    # f32 accumulation, same bit pattern as the loop-based reference).
    # The per-tile flat start offset is a tiny (nrb, ncb) table, so the
    # per-nnz work is one gather + two fused multiply-adds, all int32
    # whenever the tile array fits (always, for cluster batches).
    tstart = (rank + np.arange(nrb, dtype=idt)[:, None] * idt(K)) \
        * idt(B * B)
    flat = tstart[rb, cb] + rlo.astype(idt, copy=False) * idt(B) \
        + clo.astype(idt, copy=False)
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


def _block_coords(rows, cols, B: int, nrb: int, ncb: int):
    """(rows // B, cols // B, rows % B, cols % B) in int32 when the tile
    grid allows it (it always does for cluster batches)."""
    idt = np.int32 if max(nrb, ncb) * B < 2**31 else np.int64
    rows = rows.astype(idt, copy=False)
    cols = cols.astype(idt, copy=False)
    return rows // B, cols // B, rows % B, cols % B


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
    rb = _expand_rows(indptr) // B
    cb = np.asarray(indices) // B
    present = (np.bincount(rb.astype(np.int64, copy=False) * ncb + cb,
                           minlength=nrb * ncb) > 0).reshape(nrb, ncb)
    if not present.any():
        return 0, 0
    return int(present.sum(1).max()), int(present.sum(0).max())

