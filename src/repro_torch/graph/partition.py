"""Multilevel graph partitioner (METIS-like) in vectorized numpy.

The paper partitions with METIS [8]. METIS is not installable offline, so
we implement the same multilevel scheme:

  1. COARSEN   — heavy-edge matching (HEM) via vectorized "handshake"
                 proposals; contract matched pairs, accumulate node/edge
                 weights.
  2. INIT      — on the coarsest graph: BFS locality ordering + balanced
                 weighted chunking into p parts.
  3. UNCOARSEN — project the partition up each level and refine with
                 balance-constrained greedy label propagation (a vectorized
                 stand-in for FM/KL boundary refinement).

Quality target is NOT bit-parity with METIS; it is "clustering partition
>> random partition" on community-structured graphs, which is what drives
every Cluster-GCN claim (paper Table 2, Fig. 2). tests/test_partition.py
checks the edge-cut gap quantitatively.
"""
from __future__ import annotations

import dataclasses
import hashlib
import pathlib
import time
import warnings
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.graph.csr import CSRGraph, edge_cut

# Bump whenever metis_like_partition / random_partition can return a
# different assignment for the same (graph, num_parts, method, seed) —
# the version is part of the disk-cache key, so stale cached partitions
# are never served across algorithm changes.
PARTITIONER_VERSION = 1


# ----------------------------------------------------------------------
# low-level helpers on (indptr, indices, weights) triples
# ----------------------------------------------------------------------
def _row_of(indptr: np.ndarray) -> np.ndarray:
    deg = np.diff(indptr)
    return np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), deg)


def _segment_argmax_per_row(indptr, indices, weights, tiebreak):
    """For each row, the neighbor with max edge weight (ties -> tiebreak
    noise). Returns (best_neighbor, has_neighbor_mask).

    CSR rows are contiguous so per-row max is a single maximum.reduceat —
    no O(E log E) sort. Rows whose every slot is masked (-inf) return -1.
    """
    n = len(indptr) - 1
    deg = np.diff(indptr)
    has = deg > 0
    best = np.full(n, -1, np.int64)
    if len(indices) == 0:
        return best, has
    # jitter to randomize ties deterministically per call
    w = weights.astype(np.float64) + tiebreak[indices] * 1e-6
    ne_rows = np.where(has)[0]
    rowmax = np.maximum.reduceat(w, indptr[ne_rows])
    rowmax_full = np.repeat(rowmax, deg[ne_rows])
    row = _row_of(indptr)
    pos = np.where(w >= rowmax_full)[0]          # >=: ties + exact max
    r = row[pos]
    firstmask = np.ones(len(r), bool)
    firstmask[1:] = r[1:] != r[:-1]              # row-sorted -> first per row
    sel = pos[firstmask]
    best[row[sel]] = indices[sel]
    best[ne_rows[~np.isfinite(rowmax)]] = -1     # fully-masked rows
    return best, has


def _coarsen_once(indptr, indices, weights, node_w, rng, max_node_w):
    """One HEM round: returns (cmap, coarse graph triple, coarse node_w).

    `max_node_w` caps merged node weight (METIS's vertex-weight constraint)
    so no coarse node can exceed a fraction of a partition — without it,
    hub-heavy graphs produce unsplittable super-nodes and the final
    partition is badly imbalanced.
    """
    n = len(indptr) - 1
    tiebreak = rng.random(n)
    match = np.full(n, -1, np.int64)
    unmatched = np.ones(n, bool)
    # a few handshake rounds: propose heaviest unmatched neighbor; mutual
    # proposals become matches
    ip, ix, wt = indptr, indices, weights
    row = _row_of(ip)
    for _ in range(3):
        # mask out matched nodes' slots and over-weight merges
        alive = (unmatched[ix] & unmatched[row]
                 & (node_w[ix] + node_w[row] <= max_node_w))
        w_eff = np.where(alive, wt, -np.inf)
        prop, has = _segment_argmax_per_row(ip, ix, w_eff, tiebreak)
        valid = (prop >= 0) & unmatched & has
        # drop proposals onto matched nodes (w_eff=-inf rows give prop of a
        # matched node only when all neighbors matched; filter explicitly)
        valid &= np.where(prop >= 0, unmatched[np.clip(prop, 0, n - 1)], False)
        valid &= np.where(
            prop >= 0, node_w + node_w[np.clip(prop, 0, n - 1)] <= max_node_w,
            False)
        cand = np.where(valid)[0]
        mutual = cand[(prop[prop[cand]] == cand) & (prop[cand] > cand)]
        match[mutual] = prop[mutual]
        match[prop[mutual]] = mutual
        unmatched[mutual] = False
        unmatched[prop[mutual]] = False
        if unmatched.sum() < 0.15 * n:
            break
    # build coarse map: pair -> one id, singleton -> own id
    pair_lo = np.where((match >= 0) & (np.arange(n) < match))[0]
    cmap = np.full(n, -1, np.int64)
    nc = 0
    singles = np.where(match < 0)[0]
    cmap[singles] = np.arange(len(singles))
    nc = len(singles)
    cmap[pair_lo] = np.arange(nc, nc + len(pair_lo))
    cmap[match[pair_lo]] = cmap[pair_lo]
    nc += len(pair_lo)

    # coarse node weights
    cw = np.zeros(nc, np.int64)
    np.add.at(cw, cmap, node_w)

    # coarse edges: map endpoints, drop self loops, merge parallel edges
    row = _row_of(indptr)
    cs, cd = cmap[row], cmap[indices]
    keep = cs != cd
    cs, cd, cwt = cs[keep], cd[keep], weights[keep]
    key = cs * nc + cd
    order = np.argsort(key, kind="stable")
    key, cwt = key[order], cwt[order]
    uniq, start = np.unique(key, return_index=True)
    merged_w = np.add.reduceat(cwt, start) if len(cwt) else cwt
    csrc = (uniq // nc).astype(np.int64)
    cdst = (uniq % nc).astype(np.int32)
    cptr = np.zeros(nc + 1, np.int64)
    np.add.at(cptr, csrc + 1, 1)
    cptr = np.cumsum(cptr)
    return cmap, (cptr, cdst, merged_w.astype(np.float64)), cw


def _bfs_order(indptr, indices, rng) -> np.ndarray:
    """Multi-source-tolerant BFS ordering (locality-preserving)."""
    n = len(indptr) - 1
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    filled = 0
    while filled < n:
        seeds = np.where(~visited)[0]
        start = seeds[rng.integers(0, len(seeds))]
        frontier = np.array([start], np.int64)
        visited[start] = True
        while len(frontier):
            order[filled:filled + len(frontier)] = frontier
            filled += len(frontier)
            # expand
            starts, ends = indptr[frontier], indptr[frontier + 1]
            counts = ends - starts
            total = int(counts.sum())
            if total == 0:
                break
            pos = np.cumsum(np.concatenate([[0], counts]))
            flat = (np.repeat(starts, counts)
                    + np.arange(total, dtype=np.int64)
                    - np.repeat(pos[:-1], counts))
            nbr = indices[flat]
            nbr = nbr[~visited[nbr]]
            nbr = np.unique(nbr)
            visited[nbr] = True
            frontier = nbr
    return order


def _initial_partition(indptr, indices, node_w, p, rng) -> np.ndarray:
    """BFS order + balanced weighted chunking into p parts."""
    order = _bfs_order(indptr, indices, rng)
    w = node_w[order].astype(np.float64)
    cum = np.cumsum(w)
    total = cum[-1]
    # boundaries at total/p increments
    bounds = (cum - 1e-9) // (total / p)
    parts = np.empty(len(order), np.int64)
    parts[order] = np.minimum(bounds.astype(np.int64), p - 1)
    return parts


def _refine_lp(indptr, indices, weights, node_w, parts, p,
               rounds: int, eps: float, rng) -> np.ndarray:
    """Balance-constrained greedy label-propagation refinement.

    Per round: for every node compute connectivity to each adjacent
    partition (segment-sum over sorted (node, nbr_part) keys), move to the
    best different partition if gain>0, subject to per-partition inflow /
    outflow caps that keep sizes within (1±eps)·target.
    """
    n = len(indptr) - 1
    row = _row_of(indptr)
    target = node_w.sum() / p
    hi = (1.0 + eps) * target
    lo = max(0.0, (1.0 - eps) * target)
    parts = parts.copy()
    for _ in range(rounds):
        # restrict to boundary nodes — the only ones with positive gain
        cross = parts[row] != parts[indices]
        if not cross.any():
            break
        bnodes = np.unique(row[cross])
        starts, ends = indptr[bnodes], indptr[bnodes + 1]
        counts = ends - starts
        total = int(counts.sum())
        pos = np.cumsum(np.concatenate([[0], counts]))
        flat = (np.repeat(starts, counts)
                + np.arange(total, dtype=np.int64)
                - np.repeat(pos[:-1], counts))
        brow = np.repeat(np.arange(len(bnodes), dtype=np.int64), counts)
        bcols = indices[flat]
        bwts = weights[flat]

        np_part = parts[bcols]
        key = brow * p + np_part
        order = np.argsort(key, kind="stable")
        k_s, w_s = key[order], bwts[order]
        uniq, start = np.unique(k_s, return_index=True)
        conn = np.add.reduceat(w_s, start) if len(w_s) else w_s
        u_row = bnodes[(uniq // p).astype(np.int64)]
        u_part = (uniq % p).astype(np.int64)
        # current-partition connectivity per node
        cur_conn = np.zeros(n)
        is_cur = u_part == parts[u_row]
        cur_conn[u_row[is_cur]] = conn[is_cur]
        # best foreign partition per node
        gain = conn - cur_conn[u_row]
        gain[is_cur] = -np.inf
        # segment argmax over rows
        o2 = np.lexsort((gain, u_row))
        r2 = u_row[o2]
        last = np.zeros(len(o2), bool)
        if len(o2):
            last[-1] = True
            last[:-1] = r2[:-1] != r2[1:]
        best_rows = r2[last]
        best_gain = gain[o2[last]]
        best_dest = u_part[o2[last]]
        movers = best_rows[best_gain > 1e-12]
        if len(movers) == 0:
            break
        mg = best_gain[best_gain > 1e-12]
        md = best_dest[best_gain > 1e-12]
        msrc = parts[movers]
        mw = node_w[movers].astype(np.float64)

        sizes = np.zeros(p)
        np.add.at(sizes, parts, node_w.astype(np.float64))

        # cap inflow per destination and outflow per source, best gain first
        ord_g = np.argsort(-mg, kind="stable")
        movers, mg, md, msrc, mw = (movers[ord_g], mg[ord_g], md[ord_g],
                                    msrc[ord_g], mw[ord_g])
        # inflow headroom
        in_room = np.maximum(hi - sizes, 0.0)
        out_room = np.maximum(sizes - lo, 0.0)
        # rank of each mover within its destination by cumulative weight
        def _cum_within(groups, w):
            o = np.argsort(groups, kind="stable")
            gs, ws = groups[o], w[o]
            cw = np.cumsum(ws)
            starts = np.zeros(len(gs), bool)
            if len(gs):
                starts[0] = True
                starts[1:] = gs[1:] != gs[:-1]
            base = np.where(starts, 0.0, np.nan)
            # subtract cumsum at group start
            start_idx = np.where(starts)[0]
            offsets = np.zeros(len(gs))
            offsets[start_idx] = cw[start_idx] - ws[start_idx]
            offsets = np.maximum.accumulate(offsets)
            res = np.empty(len(gs))
            res[o] = cw - offsets  # inclusive cum weight within group
            return res
        cum_in = _cum_within(md, mw)
        cum_out = _cum_within(msrc, mw)
        ok = (cum_in <= in_room[md]) & (cum_out <= out_room[msrc])
        parts[movers[ok]] = md[ok]
    return parts


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
@dataclasses.dataclass
class PartitionStats:
    num_parts: int
    edge_cut: int
    num_edges: int
    within_fraction: float
    max_part: int
    min_part: int
    imbalance: float
    seconds: float
    # disk-cache accounting: None = caching disabled, False = computed
    # fresh (and stored), True = served from the cache
    cached: Optional[bool] = None
    fingerprint: Optional[str] = None


def graph_fingerprint(graph: CSRGraph) -> str:
    """Content hash of the graph STRUCTURE (indptr/indices/data — what
    the partitioners read). Two loads of the same dataset fingerprint
    identically; any edit to the graph changes it, so a cached partition
    can never be served for a different graph."""
    h = hashlib.sha256()
    for arr in (graph.indptr, graph.indices, graph.data):
        a = np.ascontiguousarray(arr)
        h.update(f"{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:20]


def partition_fingerprint(graph: CSRGraph, parts: np.ndarray) -> str:
    """Content hash of (graph structure, cluster assignment) — the key
    for anything derived from a PARTITIONED graph, e.g. the serving
    layer's per-cluster embedding cache (keyed on this plus the
    checkpoint step). Changing either the graph or the assignment
    changes the fingerprint, so stale derived artifacts can never be
    served."""
    h = hashlib.sha256()
    h.update(graph_fingerprint(graph).encode())
    p = np.ascontiguousarray(np.asarray(parts, dtype=np.int64))
    h.update(f"parts:{p.shape}".encode())
    h.update(p.tobytes())
    return h.hexdigest()[:20]


def default_partition_cache_dir() -> pathlib.Path:
    """Partitions share the dataset cache root
    (repro_torch.graph.datasets), so one env var ($REPRO_DATASETS_CACHE)
    relocates both. The key scheme equals the reference's, and so does
    the assignment, so the two packages may share one cache."""
    from repro_torch.graph.datasets import cache_root
    return cache_root() / "partitions"


def _cache_key(fingerprint: str, num_parts: int, method: str, seed: int,
               kw: dict) -> str:
    key = (f"{fingerprint}_p{num_parts}_{method}_s{seed}"
           f"_v{PARTITIONER_VERSION}")
    if kw:
        extra = hashlib.sha256(
            repr(sorted(kw.items())).encode()).hexdigest()[:8]
        key += f"_k{extra}"
    return key


def random_partition(num_nodes: int, num_parts: int, seed: int = 0) -> np.ndarray:
    """Paper Table 2 baseline: balanced random partition."""
    rng = np.random.default_rng(seed)
    parts = np.arange(num_nodes, dtype=np.int64) % num_parts
    rng.shuffle(parts)
    return parts


def metis_like_partition(graph: CSRGraph, num_parts: int, seed: int = 0,
                         eps: float = 0.15, refine_rounds: int = 6,
                         coarsen_target: Optional[int] = None) -> np.ndarray:
    """Multilevel k-way partition. Returns (N,) int64 part ids in [0, p)."""
    n = graph.num_nodes
    p = num_parts
    if p <= 1:
        return np.zeros(n, np.int64)
    if p >= n:
        return np.arange(n, dtype=np.int64) % p
    rng = np.random.default_rng(seed)
    coarsen_target = coarsen_target or max(4 * p, 2048)

    # no coarse node may exceed ~35% of a partition (balance guarantee)
    max_node_w = max(2, int(0.35 * n / p))

    levels: List[Tuple] = []   # (indptr, indices, weights, node_w)
    cmaps: List[np.ndarray] = []
    ip = graph.indptr
    ix = graph.indices
    wt = graph.data.astype(np.float64)
    nw = np.ones(n, np.int64)
    while len(ip) - 1 > coarsen_target and len(levels) < 30:
        levels.append((ip, ix, wt, nw))
        cmap, (cip, cix, cwt), cnw = _coarsen_once(ip, ix, wt, nw, rng,
                                                   max_node_w)
        if len(cip) - 1 > 0.97 * (len(ip) - 1):  # stalled
            levels.pop()
            break
        cmaps.append(cmap)
        ip, ix, wt, nw = cip, cix, cwt, cnw

    parts = _initial_partition(ip, ix, nw, p, rng)
    parts = _refine_lp(ip, ix, wt, nw, parts, p, refine_rounds, eps, rng)

    for (fip, fix, fwt, fnw), cmap in zip(reversed(levels), reversed(cmaps)):
        parts = parts[cmap]
        # cheaper refinement on the (large) fine levels — boundary-only LP
        parts = _refine_lp(fip, fix, fwt, fnw, parts, p,
                           max(2, refine_rounds // 2), eps, rng)
    return parts


def partition_graph(graph: CSRGraph, num_parts: int, method: str = "metis",
                    seed: int = 0,
                    cache: Union[bool, str, pathlib.Path, None] = None,
                    **kw) -> Tuple[np.ndarray, PartitionStats]:
    """Partition + quality stats (preprocessing-time accounting, Table 13).

    cache: None/False disables the disk cache (the historical behavior);
    True memoizes the assignment under default_partition_cache_dir();
    a path string uses that directory instead. The cache key is
    (graph_fingerprint, num_parts, method, seed, PARTITIONER_VERSION,
    extra kwargs), so METIS-like partitioning of a real dataset runs
    once per machine instead of once per run — the DGL reimplementation
    reports partitioning dominating wall clock on Reddit-scale graphs.
    Cache hits recompute the cheap quality stats (O(E)) and set
    stats.cached=True; unwritable cache dirs degrade to a warning,
    never a failure."""
    t0 = time.perf_counter()
    cache_dir: Optional[pathlib.Path] = None
    cache_path: Optional[pathlib.Path] = None
    fingerprint: Optional[str] = None
    if cache:
        cache_dir = (default_partition_cache_dir() if cache is True
                     else pathlib.Path(cache).expanduser())
        fingerprint = graph_fingerprint(graph)
        cache_path = cache_dir / (
            _cache_key(fingerprint, num_parts, method, seed, kw) + ".npz")
        if cache_path.exists():
            parts = np.load(cache_path)["parts"]
            if len(parts) != graph.num_nodes:
                raise RuntimeError(
                    f"corrupt partition cache entry {cache_path}: "
                    f"{len(parts)} assignments for a "
                    f"{graph.num_nodes}-node graph — delete the file")
            return parts, _partition_stats(graph, parts, num_parts, t0,
                                           cached=True,
                                           fingerprint=fingerprint)
    if method == "random":
        parts = random_partition(graph.num_nodes, num_parts, seed)
    elif method in ("metis", "cluster"):
        parts = metis_like_partition(graph, num_parts, seed=seed, **kw)
    else:
        raise ValueError(f"unknown partition method {method!r}")
    if cache_path is not None:
        try:
            cache_dir.mkdir(parents=True, exist_ok=True)
            tmp = cache_path.with_suffix(f".tmp-{id(parts)}.npz")
            np.savez(tmp, parts=parts)
            tmp.replace(cache_path)
        except OSError as e:
            warnings.warn(f"partition cache write to {cache_path} "
                          f"failed ({e}) — continuing uncached",
                          stacklevel=2)
    return parts, _partition_stats(graph, parts, num_parts, t0,
                                   cached=False if cache else None,
                                   fingerprint=fingerprint)


def _partition_stats(graph: CSRGraph, parts: np.ndarray, num_parts: int,
                     t0: float, cached: Optional[bool],
                     fingerprint: Optional[str]) -> PartitionStats:
    cut = edge_cut(graph, parts)
    sizes = np.bincount(parts, minlength=num_parts)
    ne = max(graph.num_edges, 1)
    return PartitionStats(
        num_parts=num_parts, edge_cut=cut, num_edges=graph.num_edges,
        within_fraction=1.0 - cut / ne, max_part=int(sizes.max()),
        min_part=int(sizes.min()),
        imbalance=float(sizes.max() / max(1.0, graph.num_nodes / num_parts)),
        seconds=time.perf_counter() - t0, cached=cached,
        fingerprint=fingerprint)
