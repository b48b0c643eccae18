"""CSR graph container and basic graph ops (host-side, numpy).

A numpy-only copy of `repro.graph.csr`: the port keeps graphs on the
host in CSR form exactly like the reference, and only cluster tiles and
dense activations go to the device. Being a copy (not an import) keeps
`repro_torch` free of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

Array = np.ndarray


@dataclasses.dataclass
class CSRGraph:
    """Undirected graph in CSR form.

    indptr:  (N+1,) int64
    indices: (nnz,) int32 — column index of each edge slot
    data:    (nnz,) float32 — edge weight (1.0 for unweighted)
    features: optional (N, F) float32 node features
    labels:   optional (N,) int32 (multi-class) or (N, C) float32 (multi-label)
    train_mask/val_mask/test_mask: optional (N,) bool
    """

    indptr: Array
    indices: Array
    data: Array
    features: Optional[Array] = None
    labels: Optional[Array] = None
    train_mask: Optional[Array] = None
    val_mask: Optional[Array] = None
    test_mask: Optional[Array] = None

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.data = np.asarray(self.data, dtype=np.float32)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        """Number of directed edge slots (2x undirected edges)."""
        return len(self.indices)

    @property
    def degrees(self) -> Array:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> Array:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def edge_weights(self, u: int) -> Array:
        return self.data[self.indptr[u]:self.indptr[u + 1]]

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(num_nodes: int, src: Array, dst: Array,
                   make_undirected: bool = True, **node_data) -> "CSRGraph":
        """Build CSR from an edge list. Dedupes and removes self-loops."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if make_undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        # dedupe
        key = src * num_nodes + dst
        key = np.unique(key)
        src = (key // num_nodes).astype(np.int64)
        dst = (key % num_nodes).astype(np.int32)
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr=indptr, indices=dst,
                        data=np.ones(len(dst), np.float32), **node_data)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.num_nodes, self.num_nodes))

    # ------------------------------------------------------------------
    # subgraph extraction — the core primitive Cluster-GCN needs
    # ------------------------------------------------------------------
    def subgraph(self, nodes: Array) -> Tuple["CSRGraph", Array]:
        """Induced subgraph on `nodes` (kept in given order).

        Returns (sub, relabel) where relabel maps old ids -> new local ids
        (-1 for nodes not in the subgraph).
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        n = self.num_nodes
        relabel = np.full(n, -1, dtype=np.int64)
        relabel[nodes] = np.arange(len(nodes))
        # gather each node's adjacency rows
        starts = self.indptr[nodes]
        ends = self.indptr[nodes + 1]
        counts = ends - starts
        total = int(counts.sum())
        # flat gather indices, vectorized: for each selected row i the slots
        # are starts[i] .. ends[i]-1
        pos = np.cumsum(np.concatenate([[0], counts]))
        flat = (np.repeat(starts, counts)
                + np.arange(total, dtype=np.int64)
                - np.repeat(pos[:-1], counts))
        cols = self.indices[flat]
        vals = self.data[flat]
        new_cols = relabel[cols]
        keep = new_cols >= 0
        # rebuild indptr
        row_of = np.repeat(np.arange(len(nodes)), counts)[keep]
        new_cols = new_cols[keep].astype(np.int32)
        vals = vals[keep]
        indptr = np.zeros(len(nodes) + 1, dtype=np.int64)
        np.add.at(indptr, row_of + 1, 1)
        indptr = np.cumsum(indptr)
        sub = CSRGraph(
            indptr=indptr, indices=new_cols, data=vals,
            features=None if self.features is None else self.features[nodes],
            labels=None if self.labels is None else self.labels[nodes],
            train_mask=None if self.train_mask is None else self.train_mask[nodes],
            val_mask=None if self.val_mask is None else self.val_mask[nodes],
            test_mask=None if self.test_mask is None else self.test_mask[nodes],
        )
        return sub, relabel

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        arrs = dict(indptr=self.indptr, indices=self.indices, data=self.data)
        for k in ("features", "labels", "train_mask", "val_mask", "test_mask"):
            v = getattr(self, k)
            if v is not None:
                arrs[k] = v
        np.savez_compressed(path, **arrs)

    @staticmethod
    def load(path: str) -> "CSRGraph":
        z = np.load(path)
        kw = {k: z[k] for k in z.files}
        return CSRGraph(**kw)


def append_graph(graph: CSRGraph, *, num_new_nodes: int = 0,
                 src: Array = (), dst: Array = (),
                 features: Optional[Array] = None,
                 labels: Optional[Array] = None) -> CSRGraph:
    """Append new nodes and undirected edges — the live-update primitive
    behind repro_torch.serve.deltas.GraphDelta.

    New nodes get ids N..N+num_new_nodes-1; `src`/`dst` may connect any
    mix of existing and new ids. Self-loops are dropped and duplicate
    (u, v) slots are deduped with the EXISTING edge's weight winning, so
    re-announcing a known edge is a no-op. Returns a NEW CSRGraph (the
    input is never mutated — serving keeps querying the old graph until
    the swap). New nodes extend the masks with False and, when the graph
    is labeled but `labels` is not given, get all-zero labels (a served
    node's labels are what the model predicts, not an input). The node
    feature matrix is materialized by the concat, so an mmap'd
    Amazon2M-scale feature file is paged in on first append — acceptable
    for the in-session delta overlay this implements, not for bulk
    re-ingestion (use the dataset loaders for that)."""
    n_old = graph.num_nodes
    n_new = n_old + int(num_new_nodes)
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError(f"src/dst length mismatch: {len(src)} vs "
                         f"{len(dst)}")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n_new):
        raise ValueError(
            f"edge endpoint out of range [0, {n_new}) — new nodes must "
            f"be announced via num_new_nodes before edges reference them")
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # old COO + both directions of the new edges, old slots FIRST so the
    # first-occurrence dedupe keeps existing weights
    old_rows = np.repeat(np.arange(n_old, dtype=np.int64), graph.degrees)
    all_src = np.concatenate([old_rows, src, dst])
    all_dst = np.concatenate([graph.indices.astype(np.int64), dst, src])
    all_w = np.concatenate([graph.data,
                            np.ones(2 * len(src), np.float32)])
    key = all_src * n_new + all_dst
    uniq, first = np.unique(key, return_index=True)
    rows2 = (uniq // n_new).astype(np.int64)
    cols2 = (uniq % n_new).astype(np.int32)
    vals2 = all_w[first]
    indptr = np.zeros(n_new + 1, dtype=np.int64)
    np.add.at(indptr, rows2 + 1, 1)
    indptr = np.cumsum(indptr)

    def _extend(arr, new_rows, what):
        if arr is None:
            return None
        if num_new_nodes == 0:
            return arr
        if new_rows is None:
            pad_shape = (num_new_nodes,) + arr.shape[1:]
            new_rows = np.zeros(pad_shape, dtype=arr.dtype)
        new_rows = np.asarray(new_rows, dtype=arr.dtype)
        if new_rows.shape != (num_new_nodes,) + arr.shape[1:]:
            raise ValueError(
                f"{what} for the {num_new_nodes} new node(s) must have "
                f"shape {(num_new_nodes,) + arr.shape[1:]}; got "
                f"{new_rows.shape}")
        return np.concatenate([np.asarray(arr), new_rows])

    if graph.features is not None and num_new_nodes and features is None:
        raise ValueError(f"the graph has features but none were given "
                         f"for the {num_new_nodes} new node(s)")
    false_pad = (np.zeros(num_new_nodes, bool) if num_new_nodes else None)
    return CSRGraph(
        indptr=indptr, indices=cols2, data=vals2,
        features=_extend(graph.features, features, "features"),
        labels=_extend(graph.labels, labels, "labels"),
        train_mask=_extend(graph.train_mask, false_pad, "train_mask"),
        val_mask=_extend(graph.val_mask, false_pad, "val_mask"),
        test_mask=_extend(graph.test_mask, false_pad, "test_mask"))


def edge_cut(graph: CSRGraph, parts: Array) -> int:
    """Number of directed edge slots crossing partitions."""
    parts = np.asarray(parts)
    row_of = np.repeat(np.arange(graph.num_nodes), graph.degrees)
    return int(np.count_nonzero(parts[row_of] != parts[graph.indices]))


def within_cut_fraction(graph: CSRGraph, parts: Array) -> float:
    """Fraction of edges kept inside partitions == embedding utilization
    (paper §3.1: utilization of a batch == ||A_BB||_0)."""
    if graph.num_edges == 0:
        return 1.0
    return 1.0 - edge_cut(graph, parts) / graph.num_edges
