"""The work counts from a hand-worked batch: n, nnz and the widths, and
nothing of the program's tiles."""
import numpy as np
import pytest

from bench import counts


def two_cluster_graph():
    """Six nodes, clusters {0, 1, 2} and {3, 4, 5}: a triangle in each,
    one edge 2-3 between them, and an edge 0-6 to a seventh node outside
    the batch."""
    edges = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5), (2, 3), (0, 6)]
    n = 7
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    indptr = np.cumsum([0] + [len(x) for x in adj]).astype(np.int64)
    indices = np.concatenate([sorted(x) for x in adj]).astype(np.int32)
    return indptr, indices


def test_induced_nnz_by_hand():
    indptr, indices = two_cluster_graph()
    nodes = np.array([0, 1, 2, 3, 4, 5])
    # 7 edges among the six nodes, both directions, plus 6 self loops
    assert counts.induced_nnz(indptr, indices, nodes) == 2 * 7 + 6
    assert counts.induced_nnz(indptr, indices, nodes, self_loops=False) == 14
    assert counts.induced_nnz(indptr, indices, np.array([0, 1, 2])) == 6 + 3


def test_step_flops_by_hand():
    n, nnz = 6, 20
    dims = counts.layer_dims(5, 8, 3, 2)          # 5 -> 8 -> 3
    assert dims == [(5, 8), (8, 3)]
    fwd = (2 * 6 * 5 * 8 + 2 * 20 * 8) + (2 * 6 * 8 * 3 + 2 * 20 * 3)
    # backward: Â^T G per layer, dW per layer, dX on the second layer only
    bwd = (2 * 20 * 8 + 2 * 6 * 5 * 8) + (2 * 20 * 3 + 2 * 2 * 6 * 8 * 3)
    assert counts.step_flops(n, nnz, dims) == fwd + bwd


def test_kernel_work_by_hand():
    flops, nbytes = counts.fused_spmm_work(6, 20, 5, 8)
    assert flops == 2 * 6 * 5 * 8 + 2 * 20 * 8
    assert nbytes == 4 * (6 * 5 + 5 * 8 + 8 + 6 * 8) + 20 * 8 + 7 * 4
    flops, nbytes = counts.spmm_work(6, 20, 8)
    assert flops == 2 * 20 * 8
    assert nbytes == 4 * 2 * 6 * 8 + 20 * 8 + 7 * 4
    t, bound = counts.min_seconds(67e12, 1.0)
    assert t == pytest.approx(1.0) and bound == "compute"
    t, bound = counts.min_seconds(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and bound == "memory"


@pytest.mark.parametrize("block", [2, 4])
def test_counts_ignore_the_tile_layout(block):
    """The program's payload for the batch, tiled at two block sizes:
    the tiles differ, the counted work does not."""
    from repro_torch.core.batching import subgraph_payload
    from repro_torch.graph.csr import CSRGraph
    indptr, indices = two_cluster_graph()
    g = CSRGraph(indptr=indptr, indices=indices,
                 data=np.ones(len(indices), np.float32),
                 features=np.ones((7, 5), np.float32),
                 labels=np.zeros(7, np.int32))
    nodes = np.array([0, 1, 2, 3, 4, 5])
    b = subgraph_payload(g, nodes, node_cap=8, norm="eq10", sparse_adj=True,
                         block_size=block)
    tiles = b.adj.blocks.numel()
    assert tiles == (8 // block) * (8 // block) * block * block
    assert int(np.count_nonzero(b.adj.blocks.numpy())) == 20
    n, nnz = int(b.num_real), counts.induced_nnz(indptr, indices, nodes)
    assert (n, nnz) == (6, 20)
    assert counts.step_flops(n, nnz, [(5, 8), (8, 3)]) == \
        counts.step_flops(6, 20, [(5, 8), (8, 3)])
