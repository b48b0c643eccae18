"""The port's cluster batcher against the reference's, payload for payload.

`repro_torch.core.batching.ClusterBatcher.epoch(e)` must emit the same
batches, bit for bit, as `repro.core.batching.ClusterBatcher.epoch(e)`
per (seed, epoch): dense and block-ELL adjacency, k_slots "cap"/"auto"/
int, overflow subsampling, payload-time A'X, the start_step fast-forward
and pooled tile buffers. Both batchers get the same graph (the port's
generator, checked equal to the reference's) and the same partition.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core.batching import ClusterBatcher as RefBatcher
from repro.graph.generators import make_dataset as ref_make_dataset
from repro_torch.core.batching import ClusterBatcher, batch_to_device
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.partition import partition_graph
from repro_torch.kernels.block_spmm import BlockEllAdj

FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
          "row_k_t")


@pytest.fixture(scope="module")
def graphs():
    g = make_dataset("ppi", scale=0.03, seed=0)
    rg = ref_make_dataset("ppi", scale=0.03, seed=0)
    for f in ("indptr", "indices", "data", "features", "labels",
              "train_mask", "val_mask", "test_mask"):
        assert np.array_equal(getattr(g, f), getattr(rg, f)), f
    parts, _ = partition_graph(g, 8, method="metis", seed=0, cache=False)
    return g, rg, parts


def _assert_same_payload(ref, got):
    r_adj, g_adj = ref.adj, got.adj
    if isinstance(g_adj, BlockEllAdj):
        for f in FIELDS:
            a, b = np.asarray(getattr(r_adj, f)), getattr(g_adj, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    else:
        assert r_adj.dtype == g_adj.dtype and np.array_equal(r_adj, g_adj)
    for f in ("features", "labels", "node_mask", "loss_mask", "num_real"):
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _pair(graphs, **kw):
    g, rg, parts = graphs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # overflow warns once each
        return RefBatcher(rg, parts, **kw), ClusterBatcher(g, parts, **kw)


CASES = {
    "dense": dict(),
    "dense_q2": dict(clusters_per_batch=2),
    "sparse_cap": dict(clusters_per_batch=2, sparse_adj=True,
                       block_size=16, pad_multiple=16),
    "sparse_auto": dict(clusters_per_batch=2, sparse_adj=True,
                        block_size=16, pad_multiple=16, k_slots="auto"),
    "sparse_int": dict(clusters_per_batch=3, sparse_adj=True,
                       block_size=32, pad_multiple=32, k_slots=8),
    "overflow_dense": dict(clusters_per_batch=2, node_cap=64,
                           pad_multiple=16),
    "overflow_sparse": dict(clusters_per_batch=2, node_cap=64,
                            pad_multiple=16, sparse_adj=True,
                            block_size=16),
    "precompute_ax_dense": dict(clusters_per_batch=2, precompute_ax=True),
    "precompute_ax_sparse": dict(clusters_per_batch=2, precompute_ax=True,
                                 sparse_adj=True, block_size=16,
                                 pad_multiple=16, norm="eq11",
                                 diag_lambda=1.0),
    "pooled_tiles": dict(clusters_per_batch=2, sparse_adj=True,
                         block_size=16, pad_multiple=16,
                         reuse_tile_buffers=True),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_payloads_bit_equal_to_reference(graphs, case, seed):
    ref, port = _pair(graphs, seed=seed, **CASES[case])
    assert port.node_cap == ref.node_cap
    assert port.steps_per_epoch() == ref.steps_per_epoch()
    if ref.k_plan is not None:
        assert port.k_plan.buckets == ref.k_plan.buckets
    for epoch in (0, 1):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want, got = list(ref.epoch(epoch)), []
            for b in port.epoch(epoch):
                # pooled tile buffers recycle: compare before moving on
                got.append(b)
                _assert_same_payload(want[len(got) - 1], b)
        assert len(got) == len(want) == ref.steps_per_epoch()
    assert port.overflow_count == ref.overflow_count


@pytest.mark.parametrize("sparse", [False, True])
def test_start_step_fast_forward_bit_equal(graphs, sparse):
    kw = dict(clusters_per_batch=2, seed=1)
    if sparse:
        kw.update(sparse_adj=True, block_size=16, pad_multiple=16)
    ref, port = _pair(graphs, **kw)
    want = list(ref.epoch(2, start_step=2))
    got = list(port.epoch(2, start_step=2))
    assert len(got) == len(want) == port.steps_per_epoch() - 2
    for a, b in zip(want, got):
        _assert_same_payload(a, b)
    # ... and equal to the tail of the unskipped stream
    for a, b in zip(list(port.epoch(2))[2:], got):
        _assert_same_payload(a, b)


def test_sample_csrs_and_padding_stats_match(graphs):
    ref, port = _pair(graphs, clusters_per_batch=2, sparse_adj=True,
                      block_size=16, pad_multiple=16, k_slots="auto")
    for (a, b, c), (x, y, z) in zip(ref.sample_csrs(3), port.sample_csrs(3)):
        assert np.array_equal(a, x) and np.array_equal(b, y)
        assert np.array_equal(c, z)
    assert ref.padding_stats() == port.padding_stats()


@pytest.mark.parametrize("sparse", [False, True])
def test_batch_to_device_gives_equal_tensors(graphs, sparse):
    kw = dict(clusters_per_batch=2)
    if sparse:
        kw.update(sparse_adj=True, block_size=16, pad_multiple=16)
    _, port = _pair(graphs, **kw)
    batch = next(iter(port.epoch(0)))
    moved = batch_to_device(batch.astuple(), "cpu")
    for host, dev in zip(batch.astuple(), moved):
        if isinstance(dev, BlockEllAdj):
            assert dev.checked
            for h, d in zip(host.tensors(), dev.tensors()):
                assert torch.equal(h, d)
        else:
            assert isinstance(dev, torch.Tensor)
            assert np.array_equal(np.asarray(host), dev.numpy())


def test_overflow_without_drop_raises_like_reference(graphs):
    ref, port = _pair(graphs, clusters_per_batch=3, node_cap=64,
                      pad_multiple=16, drop_overflow=False)
    for b in (ref, port):
        with pytest.raises(ValueError, match="exceeds cap"):
            list(b.epoch(0))
