"""The compact block-ELL adjacency a sparse batch payload carries
(`kernels.block_spmm.BlockEllCoords`, built by
`kernels.ops.block_ell_coords_from_csr`), on the CPU.

Its `.to("cpu")` must be the `BlockEllAdj` that `block_ell_adj_from_csr`
builds from the same CSR, bit for bit in all six tensors, for k_slots
"cap", an "auto" bucket and an int, with an empty row block, at B 16 and
128. The payload helpers count what crosses to the device (the packed
buffer, not the tiles), `_dp_groups` keys on the tile shape (K
included, not the nonzero count) and wraps a short final group around
to its bucket's first batches as built. The CUDA scatter is
held against the same host tiles in tests/test_torch_kernels_gpu.py.
"""
import numpy as np
import pytest

from repro_torch.core.batching import (ClusterBatcher, batch_to_device,
                                       payload_arrays, payload_shapes)
from repro_torch.core.engine import _dp_groups
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.partition import partition_graph
from repro_torch.kernels.block_spmm import BlockEllAdj, BlockEllCoords
from repro_torch.kernels.ops import (block_ell_adj_from_csr,
                                     block_ell_coords_from_csr)
from repro_torch.runtime import trace

FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
          "row_k_t")


def _csr(n, nnz, seed, empty_block=None, B=None):
    """A canonical CSR (sorted, unique coordinates) of an n × n matrix
    with about `nnz` nonzeros; rows and columns of row block
    `empty_block` (of B) are left empty."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    if empty_block is not None:
        keep = (r // B != empty_block) & (c // B != empty_block)
        r, c = r[keep], c[keep]
    key = np.unique(r.astype(np.int64) * n + c)
    rows, cols = key // n, (key % n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    data = rng.random(len(key)).astype(np.float32) + 0.01
    return indptr, cols, data


def _bucket(nf, nt):
    """A k_slots="auto" style chooser: the next power of two."""
    return 1 << (max(nf, nt, 1) - 1).bit_length()


def _assert_same_adj(got: BlockEllAdj, want: BlockEllAdj):
    assert got.checked
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.numpy().tobytes() == b.numpy().tobytes(), f


@pytest.mark.parametrize("B", [16, 128])
@pytest.mark.parametrize("k", ["cap", "auto", "int"])
@pytest.mark.parametrize("empty", [False, True])
def test_to_cpu_is_the_host_builders_adjacency(B, k, empty):
    nrb = 6
    cap = nrb * B
    n = cap - B // 2                       # padded rows past the real ones
    ip, ix, dt = _csr(n, 3 * cap, seed=B + len(k),
                      empty_block=2 if empty else None, B=B)
    kw = dict(n_cols=cap, block=B, n_rows=cap)
    if k == "cap":
        kw.update(k_slots=nrb, k_slots_t=nrb)
    elif k == "int":
        kw.update(k_slots=nrb + 1, k_slots_t=nrb + 1)
    else:
        kw.update(k_chooser=_bucket)
    coords = block_ell_coords_from_csr(ip, ix, dt, **kw)
    want = block_ell_adj_from_csr(ip, ix, dt, assume_unique=True, **kw)
    nrb_w, K = want.block_cols.shape
    ncb_w, Kt = want.block_cols_t.shape
    assert coords.shape == (nrb_w, K, ncb_w, Kt, B)
    assert coords.nnz == len(dt)
    _assert_same_adj(coords.to("cpu"), want)
    if empty:
        assert int(want.row_k[2]) == 0 and int(want.row_k_t[2]) == 0


def test_an_empty_adjacency_expands_to_zero_tiles():
    ip = np.zeros(33, np.int64)
    ix, dt = np.zeros(0, np.int32), np.zeros(0, np.float32)
    kw = dict(n_cols=32, block=16, n_rows=32, k_slots=2, k_slots_t=2)
    coords = block_ell_coords_from_csr(ip, ix, dt, **kw)
    assert coords.nnz == 0
    _assert_same_adj(coords.to("cpu"), block_ell_adj_from_csr(
        ip, ix, dt, assume_unique=True, **kw))


def test_raises_like_the_host_builder():
    ip, ix, dt = _csr(96, 400, seed=1)
    for build in (block_ell_coords_from_csr, block_ell_adj_from_csr):
        with pytest.raises(ValueError, match="drops non-zero tiles"):
            build(ip, ix, dt, n_cols=96, block=16, k_slots=1, k_slots_t=1)
        with pytest.raises(ValueError, match="either k_chooser"):
            build(ip, ix, dt, n_cols=96, block=16, k_slots=6,
                  k_chooser=_bucket)


def test_packed_buffer_is_checked():
    coords = BlockEllCoords.allocate(5, (2, 2, 2, 2, 16))
    assert coords.packed.numel() == 3 * 5 + 4 + 4 + 2 + 2
    with pytest.raises(ValueError, match="packed must be int32"):
        BlockEllCoords(coords.packed[1:], 5, coords.shape)
    with pytest.raises(ValueError, match="packed must be int32"):
        BlockEllCoords(coords.packed.float(), 5, coords.shape)


@pytest.fixture(scope="module")
def batch():
    g = make_dataset("ppi", scale=0.03, seed=0)
    parts, _ = partition_graph(g, 8, method="metis", seed=0, cache=False)
    b = ClusterBatcher(g, parts, clusters_per_batch=2, sparse_adj=True,
                       block_size=16, pad_multiple=16)
    return next(iter(b.epoch(0)))


def test_payload_arrays_and_copy_bytes_count_the_compact_adjacency(batch):
    host = batch.astuple()
    adj = host[0]
    assert isinstance(adj, BlockEllCoords)
    arrays = payload_arrays(host)
    assert arrays[0] is adj.packed and len(arrays) == len(host)
    nrb, K, ncb, Kt, B = adj.shape
    assert adj.packed.numel() * 4 == 4 * (3 * adj.nnz + nrb * K + ncb * Kt
                                          + nrb + ncb)
    shipped = adj.packed.numel() * 4 + sum(np.asarray(a).nbytes
                                           for a in host[1:])
    tiles = 4 * B * B * (nrb * K + ncb * Kt)
    assert shipped < tiles                  # the zeros stay behind
    trace.disable()
    trace.reset()
    trace.enable()
    try:
        moved = batch_to_device(host, "cpu")
        moved_list = batch_to_device([host, host], "cpu")
    finally:
        trace.disable()
    copies = [s for s in trace.spans() if s.name == "batch.copy"]
    trace.reset()
    assert [s.counters for s in copies] == [
        {"copy.bytes": shipped, "copy.pinned": 0,
         "copy.tiles_on_device": 0, "copy.adj_bytes": adj.packed.numel() * 4},
        {"copy.bytes": 2 * shipped, "copy.pinned": 0,
         "copy.tiles_on_device": 0,
         "copy.adj_bytes": 2 * adj.packed.numel() * 4}]
    assert isinstance(moved[0], BlockEllAdj)
    assert all(isinstance(p[0], BlockEllAdj) for p in moved_list)


def test_dp_groups_key_on_the_tile_shape(batch):
    """Two adjacencies of one tile shape and different nonzero counts
    share a group; another K does not."""
    host = batch.astuple()
    ip, ix, dt = _csr(host[1].shape[0], 300, seed=5)
    cap = host[1].shape[0]
    nrb = cap // 16
    other = {k: block_ell_coords_from_csr(ip, ix, dt, n_cols=cap, block=16,
                                          n_rows=cap, k_slots=k,
                                          k_slots_t=k)
             for k in (nrb, nrb + 2)}
    same = (other[nrb],) + host[1:]
    wider = (other[nrb + 2],) + host[1:]
    assert other[nrb].nnz != host[0].nnz
    assert payload_shapes(same) == payload_shapes(host)
    assert payload_shapes(wider) != payload_shapes(host)
    groups = list(_dp_groups(iter([host, wider, same, wider]), 2))
    assert [[id(p[0]) for p in g] for g in groups] == [
        [id(host[0]), id(same[0])], [id(wider[0]), id(wider[0])]]


def test_dp_groups_fill_a_short_group_from_the_first_batches(batch):
    """A bucket's short final group wraps around to that bucket's first
    batches, the very payloads built (nothing reuses their buffers)."""
    host = batch.astuple()
    ip, ix, dt = _csr(host[1].shape[0], 300, seed=6)
    cap = host[1].shape[0]
    other = block_ell_coords_from_csr(ip, ix, dt, n_cols=cap, block=16,
                                      n_rows=cap, k_slots=cap // 16 + 1,
                                      k_slots_t=cap // 16 + 1)
    wider = (other,) + host[1:]
    stream = [host, wider, host, host]
    groups = list(_dp_groups(iter(stream), 3))
    assert [[id(p[0]) for p in g] for g in groups] == [
        [id(host[0])] * 3, [id(other)] * 3]
    assert all(p is wider for p in groups[1])
