"""Live graph updates for the serving layer — a copy of
`repro.serve.deltas` (host-side numpy).

A `GraphDelta` is a small batch of new nodes/edges appended to the
served graph. Applying one is cheap on purpose: the CSR is rebuilt
host-side (`graph.csr.append_graph`), new nodes are assigned to the
majority cluster among their already-assigned neighbors (the greedy
streaming heuristic — METIS quality is not needed for a handful of
nodes), and ONLY the clusters inside the delta's influence region have
their cached embeddings invalidated. The region is the num_layers-hop
neighborhood of the changed nodes: adding edge (u, v) rescales u's and
v's degrees, so rows/columns u and v of the normalized Â change, and
after L propagations every node within L hops of u or v can see the
difference — including nodes in other clusters reached through
cross-cluster edges. Clusters outside that region keep serving cached
bytes unchanged, and that is exact, not an approximation.

`BalanceMonitor` watches the side effect of that laziness: greedy
assignment slowly skews cluster sizes, and Cluster-GCN's whole premise
(paper §3.1) is that per-cluster work is roughly uniform. When the
max/mean size ratio passes the threshold the monitor warns and fires
the optional re-partition hook — warn-only for now; a real deployment
would schedule a background METIS re-partition + cache rebuild there.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, append_graph
from repro_torch.serve.embedding_cache import _expand_frontier


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A batch of live updates: `num_new_nodes` new nodes (ids assigned
    densely after the current max) plus undirected edges src[i]—dst[i]
    over any mix of old and new ids. `features` must cover the new
    nodes when the graph has node features."""
    src: Tuple[int, ...] = ()
    dst: Tuple[int, ...] = ()
    num_new_nodes: int = 0
    features: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return len(self.src)


def apply_delta(graph: CSRGraph, parts: np.ndarray, delta: GraphDelta,
                *, num_layers: int
                ) -> Tuple[CSRGraph, np.ndarray, List[int]]:
    """Apply one delta. Returns (new_graph, new_parts, touched) where
    `touched` is the sorted list of cluster ids whose cached embeddings
    are now stale: every cluster intersecting the `num_layers`-hop
    neighborhood (on the NEW graph) of the changed nodes — edge
    endpoints plus new nodes. An edge changes its endpoints' degrees,
    hence rows AND columns u, v of the normalized Â; each of the L
    propagation hops then widens the set of affected hidden states by
    one neighbor hop, so final logits change only for nodes within L
    hops of a changed node. Clusters not listed are untouched by
    construction — no logit of theirs moved — so their cached
    embeddings remain exact on the updated graph. (Re-announcing an
    existing edge is a CSR no-op but still invalidates conservatively.)
    """
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    n_old = graph.num_nodes
    new_graph = append_graph(graph, num_new_nodes=delta.num_new_nodes,
                             src=delta.src, dst=delta.dst,
                             features=delta.features)
    parts = np.asarray(parts)
    num_parts = int(parts.max()) + 1 if len(parts) else 1
    new_parts = np.concatenate(
        [parts, np.full(delta.num_new_nodes, -1, parts.dtype)])
    # assign new nodes in id order so new→new edges see earlier picks
    sizes = np.bincount(parts, minlength=num_parts).astype(np.int64)
    for v in range(n_old, n_old + delta.num_new_nodes):
        nbr_parts = new_parts[new_graph.neighbors(v)]
        nbr_parts = nbr_parts[nbr_parts >= 0]
        if len(nbr_parts):
            c = int(np.bincount(nbr_parts, minlength=num_parts).argmax())
        else:
            c = int(sizes.argmin())     # isolated node → smallest cluster
        new_parts[v] = c
        sizes[c] += 1
    seeds = list(range(n_old, n_old + delta.num_new_nodes))
    for u, v in zip(delta.src, delta.dst):
        if u != v:
            seeds.extend((int(u), int(v)))
    region = np.unique(np.asarray(seeds, dtype=np.int64))
    for _ in range(num_layers):
        region = _expand_frontier(new_graph.indptr, new_graph.indices,
                                  region)
    touched = np.unique(new_parts[region]) if len(region) else []
    return new_graph, new_parts, [int(c) for c in touched]


class BalanceMonitor:
    """Flags partition-quality decay under live growth. `check(parts)`
    computes imbalance = max cluster size / mean cluster size; past
    `threshold` it warns and calls `on_rebalance(imbalance, sizes)`
    once per exceedance streak (re-arming after the ratio drops back).
    Warn-only: re-partitioning is the hook's job, not the monitor's."""

    def __init__(self, *, threshold: float = 2.0,
                 on_rebalance: Optional[Callable] = None):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.threshold = float(threshold)
        self.on_rebalance = on_rebalance
        self._armed = True

    def check(self, parts: np.ndarray) -> float:
        parts = np.asarray(parts)
        num_parts = int(parts.max()) + 1 if len(parts) else 1
        sizes = np.bincount(parts, minlength=num_parts)
        imbalance = float(sizes.max() / max(sizes.mean(), 1e-12))
        if imbalance > self.threshold:
            if self._armed:
                warnings.warn(
                    f"cluster imbalance {imbalance:.2f} exceeds "
                    f"threshold {self.threshold:.2f} (sizes "
                    f"{sizes.tolist()}); serving quality degrades — "
                    f"schedule a re-partition", RuntimeWarning,
                    stacklevel=2)
                if self.on_rebalance is not None:
                    self.on_rebalance(imbalance, sizes)
                self._armed = False
        else:
            self._armed = True
        return imbalance
