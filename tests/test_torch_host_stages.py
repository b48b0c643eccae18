"""The port's host stages (numpy copies) are bit-equal to the reference:
dataset generators, normalization, partitioning and its fingerprints,
the partition cache, the block-ELL builders and the tile pool."""
import numpy as np
import pytest

from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import normalization as ref_norm
from repro.graph import partition as ref_part
from repro.kernels import ops as ref_ops
from repro_torch.core import kslots
from repro_torch.graph import csr, generators, normalization, partition
from repro_torch.kernels import ops

GRAPH_FIELDS = ("indptr", "indices", "data", "features", "labels",
                "train_mask", "val_mask", "test_mask")


def _assert_bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def ppi_graph():
    return generators.make_dataset("ppi", 0.03)


@pytest.mark.parametrize("name,scale", [("ppi", 0.03), ("reddit", 0.01),
                                        ("amazon2m", 0.0003),
                                        ("cora", 0.1),
                                        ("structural", 0.1)])
def test_make_dataset_bit_equal(name, scale):
    got = generators.make_dataset(name, scale, seed=3)
    want = ref_gen.make_dataset(name, scale, seed=3)
    for f in GRAPH_FIELDS:
        _assert_bit_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("name", ["ppi_real", "reddit_real", "ogbn_arxiv",
                                  "ogbn_products"])
def test_real_datasets_are_registered_but_not_loadable_yet(
        name, tmp_path, monkeypatch):
    """Every real name reaches the loader; with no archive in reach (an
    empty file:// mirror, never the network) it fails with the offline
    hint after its retries."""
    monkeypatch.setenv("REPRO_DATASETS_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("REPRO_DATASETS_MIRROR",
                       (tmp_path / "empty").as_uri())
    monkeypatch.setenv("REPRO_DOWNLOAD_BACKOFF", "0.001")
    with pytest.raises(RuntimeError, match="REPRO_DATASETS_MIRROR"):
        generators.make_dataset(name)


@pytest.mark.parametrize("method,lam", [("eq1", 0.0), ("eq9", 0.0),
                                        ("eq10", 0.0), ("eq11", 1.0),
                                        ("sym", 0.0)])
def test_normalize_csr_bit_equal(ppi_graph, method, lam):
    g = ppi_graph
    got = normalization.normalize_csr(g.indptr, g.indices, g.data, method,
                                      lam)
    want = ref_norm.normalize_csr(g.indptr, g.indices, g.data, method, lam)
    for a, b in zip(got, want):
        _assert_bit_equal(a, b)


@pytest.mark.parametrize("method", ["eq1", "eq10", "eq11"])
def test_normalize_dense_bit_equal(method):
    rng = np.random.default_rng(0)
    adj = (rng.random((40, 40)) < 0.2).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    _assert_bit_equal(normalization.normalize_dense(adj, method, 0.5),
                      ref_norm.normalize_dense(adj, method, 0.5))


@pytest.mark.parametrize("method,num_parts", [("metis", 8), ("random", 8),
                                              ("metis", 50)])
def test_partition_and_fingerprints_bit_equal(ppi_graph, method, num_parts):
    got, gstats = partition.partition_graph(ppi_graph, num_parts,
                                            method=method, seed=1)
    want, wstats = ref_part.partition_graph(ppi_graph, num_parts,
                                            method=method, seed=1)
    _assert_bit_equal(got, want)
    assert gstats.edge_cut == wstats.edge_cut
    assert partition.graph_fingerprint(ppi_graph) \
        == ref_part.graph_fingerprint(ppi_graph)
    assert partition.partition_fingerprint(ppi_graph, got) \
        == ref_part.partition_fingerprint(ppi_graph, want)


def test_partition_cache_shared_with_reference(ppi_graph, tmp_path):
    """Same key scheme and assignment: an entry the port writes is a
    cache hit for the reference, with identical parts."""
    got, s1 = partition.partition_graph(ppi_graph, 8, cache=str(tmp_path))
    assert s1.cached is False
    want, s2 = ref_part.partition_graph(ppi_graph, 8, cache=str(tmp_path))
    assert s2.cached is True
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("with_row_k", [False, True])
@pytest.mark.parametrize("B,k_extra,pad_rows", [(8, 0, 0), (16, 0, 24),
                                                (16, 5, 0), (128, 0, 0)])
def test_block_ell_from_csr_bit_equal(ppi_graph, B, k_extra, pad_rows,
                                      with_row_k):
    g = ppi_graph
    ip, ix, dt = ref_norm.normalize_csr(g.indptr, g.indices, g.data,
                                        "eq11", 1.0)
    rows = np.arange(0, g.num_nodes, 3)          # a scattered row slice
    sub_ip = np.concatenate([[0], np.cumsum(np.diff(ip)[rows])])
    take = np.concatenate([np.arange(ip[r], ip[r + 1]) for r in rows])
    n_cols = -(-g.num_nodes // B) * B
    need = ref_ops.block_ell_needed_k(sub_ip, ix[take], B, n_cols)[0]
    kw = dict(n_cols=n_cols, block=B,
              k_slots=(need + k_extra) if k_extra else None,
              n_rows=(len(rows) + pad_rows) if pad_rows else None,
              with_row_k=with_row_k)
    got = ops.block_ell_from_csr(sub_ip, ix[take], dt[take], **kw)
    want = ref_ops.block_ell_from_csr(sub_ip, ix[take], dt[take], **kw)
    assert len(got) == len(want) == (3 if with_row_k else 2)
    for a, b in zip(got, want):
        _assert_bit_equal(a, b)


def test_block_ell_builder_with_tile_pool_bit_equal(ppi_graph):
    """Pooled builds stay bit-equal to the reference's unpooled ones
    across several ring recycles of alternating density."""
    g = ppi_graph
    ip, ix, dt = ref_norm.normalize_csr(g.indptr, g.indices, g.data)
    pool = ops.TileBufferPool(depth=2)
    for step in range(6):
        rows = np.arange(step % 2, g.num_nodes, 2 + step % 3)[:96]
        sub_ip = np.concatenate([[0], np.cumsum(np.diff(ip)[rows])])
        take = np.concatenate([np.arange(ip[r], ip[r + 1]) for r in rows])
        kw = dict(n_cols=448, block=16, k_slots=28, n_rows=96)
        got = ops.block_ell_from_csr(sub_ip, ix[take], dt[take], pool=pool,
                                     **kw)
        want = ref_ops.block_ell_from_csr(sub_ip, ix[take], dt[take], **kw)
        for a, b in zip(got, want):
            _assert_bit_equal(a, b)


def test_needed_k_and_pow2_ceil_match(ppi_graph):
    g = ppi_graph
    for B in (8, 16, 128):
        assert ops.block_ell_needed_k(g.indptr, g.indices, B,
                                      g.num_nodes) \
            == ref_ops.block_ell_needed_k(g.indptr, g.indices, B,
                                          g.num_nodes)
    from repro.core.kslots import pow2_ceil as ref_pow2
    assert [kslots.pow2_ceil(v) for v in range(0, 300, 7)] \
        == [ref_pow2(v) for v in range(0, 300, 7)]


def test_append_graph_and_cuts_bit_equal(ppi_graph):
    g = ppi_graph
    rng = np.random.default_rng(4)
    n = g.num_nodes
    kw = dict(num_new_nodes=3, src=[0, 5, n, n + 1, n + 2, 7],
              dst=[n, n + 1, n + 2, 9, 9, 7],
              features=rng.normal(size=(3, g.features.shape[1]))
              .astype(np.float32))
    got = csr.append_graph(g, **kw)
    want = ref_csr.append_graph(g, **kw)
    for f in GRAPH_FIELDS:
        _assert_bit_equal(getattr(got, f), getattr(want, f))
    parts = np.arange(got.num_nodes) % 5
    assert csr.edge_cut(got, parts) == ref_csr.edge_cut(want, parts)
    assert csr.within_cut_fraction(got, parts) \
        == ref_csr.within_cut_fraction(want, parts)
