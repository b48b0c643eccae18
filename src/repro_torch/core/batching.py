"""Cluster batch construction — the heart of Cluster-GCN (paper
§3.1–3.2); the port of `repro.core.batching`.

Pipeline:
  1. preprocessing: partition the TRAINING subgraph (inductive setting,
     paper §6.2) into p clusters with the METIS-like partitioner.
  2. per step: sample q clusters WITHOUT replacement within the epoch
     (Algorithm 1 line 3), take the induced subgraph on their union —
     this re-adds the between-cluster links among the chosen clusters
     (§3.2) — re-normalize it (§6.2), and emit a FIXED-SHAPE padded
     batch.

Everything here is host numpy, copied from the reference so payloads
are bit-identical per (seed, epoch) (tests/test_torch_batching.py). A
sparse payload's adjacency is a `BlockEllCoords`: the nonzeros of Â
with their offsets into the block-ELL tiles of Â and Âᵀ, one packed
CPU tensor. `batch_to_device` moves a payload to the device the step
runs on; there the adjacency becomes the `BlockEllAdj` the reference's
payload holds, its tiles written on that device (a CUDA kernel on a
card). The GraphSAINT samplers
(`core/samplers.py`) build their payloads through `subgraph_payload`
too. `utilization_stats` and `label_entropy_per_cluster` measure a
partition as the paper's §3.1 and Fig. 2 do (host numpy, the
reference's code).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (Iterator, List, Optional, Protocol, Sequence, Tuple,
                    Union, runtime_checkable)

import numpy as np

import torch

from repro_torch.graph.csr import CSRGraph, group_members
from repro_torch.graph.normalization import normalize_csr, normalize_dense
from repro_torch.kernels.block_spmm import BlockEllAdj, BlockEllCoords
from repro_torch.runtime import trace

Array = np.ndarray


@dataclasses.dataclass
class ClusterBatch:
    """Fixed-shape batch. All arrays padded to node_cap.

    adj:        (cap, cap) float32 — normalized adjacency of the q-cluster
                union subgraph (zero rows/cols in padding) — OR, with
                `ClusterBatcher(sparse_adj=True)`, a
                kernels.BlockEllCoords: the block-ELL Â and Âᵀ as
                nonzeros and tile offsets, whose `.to(device)` is a
                fixed-shape BlockEllAdj.
    features:   (cap, F) float32
    labels:     (cap,) int32 or (cap, C) float32
    node_mask:  (cap,) bool — real node?
    loss_mask:  (cap,) float32 — training node & real (loss weighting)
    num_real:   () int32
    """
    adj: Array
    features: Array
    labels: Array
    node_mask: Array
    loss_mask: Array
    num_real: Array

    def astuple(self):
        return (self.adj, self.features, self.labels, self.node_mask,
                self.loss_mask, self.num_real)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@runtime_checkable
class Sampler(Protocol):
    """The subgraph-sampling contract the training stack consumes.

    A sampler owns the preprocessing → per-step-subgraph half of
    Algorithm 1; everything downstream (Engine, SingleDevice/ShardMap
    StepBackends, prefetch, checkpoint/resume fast-forward) only sees
    this protocol. Implementations: `ClusterBatcher` (paper §3.2
    stochastic multiple partitions), the GraphSAINT-style samplers
    (`core/samplers.py`).

    Contract:
      * `epoch(e, start_step=k)` yields the fixed-shape `ClusterBatch`
        payloads of epoch e from step k on (all `steps_per_epoch()` of
        them at the default k=0), and the stream is a pure function of
        (sampler config, e) — same config + epoch ⇒ bitwise-identical
        batches. That determinism is what makes `Engine.fit(resume=
        True)` exact, and `start_step` is the CHEAP fast-forward: the
        skipped steps advance the epoch's rng stream without building
        their payloads, bitwise-equivalent to build-and-discard
        (locked by tests/test_engine.py) at a fraction of the cost —
        resume and checkpoint-fallback re-fast-forward both ride it.
      * `sample_csrs(n)` returns the normalized batch CSR patterns of
        the FIRST n batches of epoch 0 (the same rng stream training
        sees) so the k_slots planner (repro_torch.core.kslots) measures
        exactly what training will tile.
      * attributes `norm` / `diag_lambda` / `sparse_adj` / `node_cap` /
        `block_size` / `seed` / `precompute_ax` describe the payload so
        trainer/eval paths can mirror the batch normalization (and so
        the Engine can verify the model's precompute_ax expectation
        against what the payload actually carries).
    """
    graph: CSRGraph
    node_cap: Optional[int]
    norm: str
    diag_lambda: float
    sparse_adj: bool
    block_size: int
    seed: int
    precompute_ax: bool

    def epoch(self, epoch_idx: int,
              start_step: int = 0) -> Iterator["ClusterBatch"]: ...

    def steps_per_epoch(self) -> int: ...

    def sample_csrs(self, n: int) -> List[Tuple[Array, Array, Array]]: ...

    def padding_stats(self, sample_batches: int = 4) -> dict: ...


def normalized_subgraph_csr(graph: CSRGraph, nodes: Array, norm: str,
                            diag_lambda: float = 0.0
                            ) -> Tuple[Array, Array, Array]:
    """Normalized CSR (indptr, indices, data) of the induced subgraph on
    `nodes` — the exact matrix `subgraph_payload` densifies or tiles
    (so K planning measures what training builds)."""
    sub, _ = graph.subgraph(nodes)
    return normalize_csr(sub.indptr, sub.indices, sub.data, norm,
                         diag_lambda)


def subgraph_payload(graph: CSRGraph, nodes: Array, *, node_cap: int,
                     norm: str, diag_lambda: float = 0.0,
                     sparse_adj: bool = False, block_size: int = 128,
                     k_slots: Union[int, str] = "cap", k_plan=None,
                     loss_weights: Optional[Array] = None,
                     precompute_ax: bool = False) -> "ClusterBatch":
    """Induced subgraph on `nodes` → fixed-shape ClusterBatch payload.

    The one place batch payloads are built — ClusterBatcher and the
    GraphSAINT-style samplers all call this, so every sampler emits the
    exact contract the Engine/backends consume: a (cap, cap) dense
    normalized adjacency (paper §6.2 per-batch re-normalization) or a
    BlockEllCoords (sparse_adj=True, never densified, its tiles written
    where it is moved to; K follows k_slots/k_plan exactly as
    documented on ClusterBatcher), padded features/labels, node_mask,
    loss_mask and num_real.

    loss_weights (len(nodes),) scales the loss mask per REAL node —
    SAINT samplers pass their unbiased-estimator normalization
    coefficients here (train_mask still zeroes non-training nodes);
    None keeps the plain {0, 1} training mask of the cluster path.

    precompute_ax=True replaces the features with Â'·X aggregated ONCE
    here on the host (paper §6.2) — the model's first layer then skips
    its propagation (GCNConfig.precompute_ax). One host spmm per batch
    instead of one device spmm per step per epoch, and under mixed
    precision the first aggregation happens in full fp32 numpy.
    """
    if k_slots == "auto" and k_plan is None:
        raise ValueError("k_slots='auto' needs a pre-computed k_plan "
                         "(repro_torch.core.kslots.plan_k_buckets) — samplers "
                         "build one at init")
    with trace.span("batch.subgraph"):
        sub, _ = graph.subgraph(nodes)  # re-adds Δ links among chosen nodes
    b = len(nodes)
    cap = node_cap

    if sparse_adj:
        # normalize the batch CSR directly (paper §6.2) and place its
        # nonzeros in the tiles — the dense (cap, cap) block is never
        # materialized, and the tiles are written only on the device.
        # K follows the k_slots policy: "cap" pins the lossless worst
        # case cap/B; "auto" picks the smallest pre-planned bucket that
        # holds this batch losslessly (repro_torch.core.kslots); an int
        # is used as-is (the builder raises if it would drop tiles).
        from repro_torch.kernels.ops import block_ell_coords_from_csr
        with trace.span("batch.normalize"):
            ip, ix, dt = normalize_csr(sub.indptr, sub.indices, sub.data,
                                       norm, diag_lambda)
            trace.count("batch.adj_nnz", len(ix))
        if k_slots == "auto":
            # bucket picked inside the builder from the occupancy it
            # computes anyway — no extra O(nnz) pass per batch
            k_kw = dict(k_chooser=lambda nf, nt: k_plan.bucket_for(
                max(nf, nt, 1)))
        else:
            k = cap // block_size if k_slots == "cap" else int(k_slots)
            k_kw = dict(k_slots=k, k_slots_t=k)
        with trace.span("batch.tiles") as tiles:
            adj = block_ell_coords_from_csr(ip, ix, dt, n_cols=cap,
                                            block=block_size, n_rows=cap,
                                            **k_kw)
            if tiles:
                # row blocks × K of Â plus the same of Âᵀ: the tiles of
                # block² elements each that the kernels read
                nrb, K, ncb, Kt, _ = adj.shape
                tiles.count("batch.tile_slots", nrb * K + ncb * Kt)
                tiles.count("batch.block", block_size)
    else:
        with trace.span("batch.normalize"):
            dense = np.zeros((cap, cap), np.float32)
            row = np.repeat(np.arange(b), np.diff(sub.indptr))
            dense[row, sub.indices] = sub.data
            # re-normalize the combined adjacency (paper §6.2)
            dense[:b, :b] = normalize_dense(dense[:b, :b], norm,
                                            diag_lambda)
            dense[b:, :] = 0.0
            dense[:, b:] = 0.0
            adj = dense

    with trace.span("batch.features"):
        feat_dim = graph.features.shape[1]
        feats = np.zeros((cap, feat_dim), np.float32)
        feats[:b] = graph.features[nodes]
        if precompute_ax:
            # host-side Â'·X (paper §6.2): aggregate once per batch, in fp32
            # regardless of the training compute dtype; padding rows stay 0
            if sparse_adj:
                import scipy.sparse as sp
                feats[:b] = sp.csr_matrix((dt, ix, ip),
                                          shape=(b, b)) @ feats[:b]
            else:
                feats[:b] = adj[:b, :b] @ feats[:b]

        labels_src = graph.labels
        if labels_src.ndim == 1:
            labels = np.zeros((cap,), np.int32)
        else:
            labels = np.zeros((cap, labels_src.shape[1]), np.float32)
        labels[:b] = labels_src[nodes]

        node_mask = np.zeros(cap, bool)
        node_mask[:b] = True
        loss_mask = np.zeros(cap, np.float32)
        if graph.train_mask is not None:
            loss_mask[:b] = graph.train_mask[nodes].astype(np.float32)
        else:
            loss_mask[:b] = 1.0
        if loss_weights is not None:
            loss_mask[:b] *= np.asarray(loss_weights, np.float32)
        return ClusterBatch(adj=adj, features=feats, labels=labels,
                            node_mask=node_mask, loss_mask=loss_mask,
                            num_real=np.int32(b))


@dataclasses.dataclass
class ClusterBatcher:
    """Stochastic multiple partitions batcher (paper Algorithm 1).

    graph: FULL graph (inductive: pass the training subgraph for training).
    parts: (N,) partition assignment from repro_torch.graph.partition.
    clusters_per_batch: q.
    norm: normalization method for each batch ('eq1'|'eq10'|'eq9'|'eq11').
    diag_lambda: λ of Eq. 11.
    precompute_ax: paper §6.2 — first layer uses A'X precomputed per batch
      (exact 1-hop aggregation; saves one propagation in the model).
    sparse_adj: emit BlockEllCoords batches (the normalized batch CSR's
      nonzeros with their block-ELL tile offsets, never densified, the
      tiles written on the device) instead of the dense (cap, cap)
      block — the block-ELL CUDA kernel path.
    block_size: tile edge B of the block-ELL format (node_cap must be a
      multiple of it; the default matches pad_multiple=128).
    k_slots: ELL slot-count policy for the sparse path:
      "cap"  — K pinned at the lossless worst case cap/B for every batch
               (one tile shape; heavy zero padding at low block fill);
      "auto" — fill-adaptive buckets (repro_torch.core.kslots): a few epoch-0
               batches are sampled at init to pick a small ladder of
               power-of-two K buckets (cap/B always the last, lossless
               fallback), and each batch is built at the smallest bucket
               that holds it losslessly, so FLOPs and tile bytes
               track the real fill with at most len(buckets) shapes;
      int    — fixed explicit K; the builders raise if it would drop a
               non-zero tile (lossless or loud, never silently wrong).
      For async host-side batch construction overlapping the device step
      see execution.prefetch (repro_torch.core.prefetch) — batch order is
      identical either way.
    reuse_tile_buffers: accepted for the reference's config, and without
      effect: a sparse batch ships coordinates (BlockEllCoords), so it
      has no host tile buffers to recycle.
    """
    graph: CSRGraph
    parts: Array
    clusters_per_batch: int = 1
    norm: str = "eq10"
    diag_lambda: float = 0.0
    node_cap: Optional[int] = None
    pad_multiple: int = 128
    seed: int = 0
    drop_overflow: bool = True
    sparse_adj: bool = False
    block_size: int = 128
    k_slots: Union[int, str] = "cap"
    precompute_ax: bool = False
    reuse_tile_buffers: bool = False

    def __post_init__(self):
        self.parts = np.asarray(self.parts)
        self.num_parts = int(self.parts.max()) + 1
        self._members: List[Array] = group_members(self.parts,
                                                   self.num_parts)
        sizes = np.array([len(m) for m in self._members])
        if self.node_cap is None:
            # capacity: q * (mean + 3σ of cluster size), padded to 128
            q = self.clusters_per_batch
            est = q * sizes.mean() + 3.0 * np.sqrt(q) * sizes.std()
            self.node_cap = _round_up(max(int(est), int(sizes.max())),
                                      self.pad_multiple)
        self._sizes = sizes
        self.overflow_count = 0
        self._overflow_warned = False
        if self.sparse_adj and self.node_cap % self.block_size:
            raise ValueError(
                f"sparse_adj needs node_cap ({self.node_cap}) divisible by "
                f"block_size ({self.block_size})")
        if isinstance(self.k_slots, str) and self.k_slots not in ("cap",
                                                                  "auto"):
            raise ValueError(
                f"k_slots must be 'cap', 'auto' or an int; "
                f"got {self.k_slots!r}")
        self.k_plan = None
        if self.sparse_adj and self.k_slots == "auto":
            from repro_torch.core.kslots import plan_k_buckets
            self.k_plan = plan_k_buckets(self)

    # ------------------------------------------------------------------
    def _batch_nodes(self, cluster_ids: Sequence[int],
                     count_overflow: bool = True,
                     rng_ctx: Tuple[int, int] = (0, 0)) -> Array:
        """Union of the chosen clusters' nodes, subsampled down to
        node_cap on overflow (loudly, when counting) — the one place
        overflow is handled.

        Overflow is resolved by a UNIFORM subsample over the whole
        union, seeded per (batcher seed, epoch, step) via `rng_ctx` —
        not by truncating the concatenation, which would drop nodes
        exclusively from the LAST cluster of the batch and
        systematically bias training against later-drawn clusters.
        The kept nodes preserve their concatenation order (clusters
        stay contiguous, which is what gives block-ELL tiles their
        fill), and the per-(seed, epoch, step) seeding keeps the epoch
        stream a pure function of (seed, epoch) — resume fast-forward
        stays bitwise-exact."""
        nodes = np.concatenate([self._members[t] for t in cluster_ids])
        if len(nodes) > self.node_cap:
            if not self.drop_overflow:
                raise ValueError(
                    f"batch of {len(nodes)} nodes exceeds cap {self.node_cap}")
            if count_overflow:
                self.overflow_count += len(nodes) - self.node_cap
                if not self._overflow_warned:
                    self._overflow_warned = True
                    warnings.warn(
                        f"ClusterBatcher subsampled away "
                        f"{len(nodes) - self.node_cap} overflow nodes "
                        f"(batch of {len(nodes)} > node_cap "
                        f"{self.node_cap}); raise node_cap or lower "
                        f"clusters_per_batch — cumulative count in "
                        f"padding_stats()['overflow_count']", stacklevel=3)
            epoch_idx, step = rng_ctx
            rng = np.random.default_rng(
                (self.seed, int(epoch_idx), int(step)))
            keep = rng.choice(len(nodes), size=self.node_cap,
                              replace=False)
            nodes = nodes[np.sort(keep)]
        return nodes

    def batch_csr(self, cluster_ids: Sequence[int], *,
                  rng_ctx: Tuple[int, int] = (0, 0)
                  ) -> Tuple[Array, Array, Array]:
        """Normalized CSR (indptr, indices, data) of the q-cluster union
        batch — the exact matrix batch_from_clusters turns into tiles
        (or a dense block). The K planner (repro_torch.core.kslots) measures
        THIS, so bucket choice and batch construction cannot drift;
        `rng_ctx` is the (epoch, step) the batch would occupy, so the
        overflow subsample matches the trained batch node-for-node."""
        nodes = self._batch_nodes(cluster_ids, count_overflow=False,
                                  rng_ctx=rng_ctx)
        return normalized_subgraph_csr(self.graph, nodes, self.norm,
                                       self.diag_lambda)

    def batch_from_clusters(self, cluster_ids: Sequence[int], *,
                            rng_ctx: Tuple[int, int] = (0, 0)
                            ) -> ClusterBatch:
        """One-off payload build for the given clusters (stats probes,
        benchmarks, planning); safe beside a running `epoch()` stream,
        as builds share no buffers."""
        return self._build(cluster_ids, rng_ctx=rng_ctx)

    def _build(self, cluster_ids: Sequence[int], *,
               rng_ctx: Tuple[int, int]) -> ClusterBatch:
        # rng_ctx is the (epoch, step) the batch serves: its step id
        with trace.span("batch.build", step=rng_ctx):
            with trace.span("batch.nodes"):
                nodes = self._batch_nodes(cluster_ids, rng_ctx=rng_ctx)
            trace.count("batch.nodes_real", len(nodes))
            return subgraph_payload(
                self.graph, nodes, node_cap=self.node_cap, norm=self.norm,
                diag_lambda=self.diag_lambda, sparse_adj=self.sparse_adj,
                block_size=self.block_size, k_slots=self.k_slots,
                k_plan=self.k_plan, precompute_ax=self.precompute_ax)

    # ------------------------------------------------------------------
    def epoch(self, epoch_idx: int,
              start_step: int = 0) -> Iterator[ClusterBatch]:
        """One pass over ALL clusters: shuffle, group into batches of q
        clusters without replacement (Algorithm 1). When q does not
        divide num_parts the final batch carries the num_parts % q
        trailing clusters (same padded fixed shape — dropping them would
        silently skip those clusters every epoch).

        start_step=k skips the first k batches WITHOUT building their
        payloads (the epoch permutation is drawn whole, so group
        selection is free) — the cheap resume fast-forward of the
        Sampler protocol; the surviving steps keep their original
        rng_ctx, so the tail is bitwise the unskipped stream's."""
        for step, group in enumerate(self._epoch_groups(epoch_idx)):
            if step < start_step:
                continue
            yield self._build(group, rng_ctx=(epoch_idx, step))

    def _epoch_groups(self, epoch_idx: int) -> Iterator[Array]:
        """The epoch's cluster groups — the deterministic (seed, epoch)
        stream both `epoch` and `sample_csrs` draw from."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(self.num_parts)
        q = self.clusters_per_batch
        for i in range(0, self.num_parts, q):
            yield order[i:i + q]

    def steps_per_epoch(self) -> int:
        return -(-self.num_parts // self.clusters_per_batch)

    def sample_csrs(self, n: int) -> List[Tuple[Array, Array, Array]]:
        """Normalized batch CSRs of the first `n` batches of epoch 0 —
        the same rng stream and grouping the real epoch uses, so the
        k_slots planner (repro_torch.core.kslots) measures exactly what
        training will tile (Sampler protocol)."""
        groups = list(self._epoch_groups(0))[:max(1, n)]
        return [self.batch_csr(g, rng_ctx=(0, i))
                for i, g in enumerate(groups)]

    # ------------------------------------------------------------------
    def padding_stats(self, sample_batches: int = 4) -> dict:
        """Padding/overflow accounting; with sparse_adj also the sampled
        block-fill statistics (mean/p95 lossless forward and transposed
        K, repro_torch.core.kslots.fill_stats) and the chosen K-bucket ladder,
        so the k_slots="auto" choice is inspectable."""
        q = self.clusters_per_batch
        avg = q * self._sizes.mean()
        stats = dict(node_cap=self.node_cap, avg_batch_nodes=float(avg),
                     pad_waste=float(1.0 - avg / self.node_cap),
                     max_cluster=int(self._sizes.max()),
                     min_cluster=int(self._sizes.min()),
                     overflow_count=int(self.overflow_count))
        if self.sparse_adj:
            from repro_torch.core.kslots import fill_stats
            stats.update(fill_stats(self, sample_batches))
            if self.k_plan is not None:
                stats["k_buckets"] = list(self.k_plan.buckets)
        return stats



def utilization_stats(graph: CSRGraph, parts: Array,
                      q: int, trials: int = 20, seed: int = 0) -> dict:
    """Embedding utilization = within-batch edge fraction (paper §3.1).

    Measures the actual fraction of graph edges available inside sampled
    q-cluster batches (between-cluster links among chosen clusters count —
    §3.2 adds them back).
    """
    rng = np.random.default_rng(seed)
    num_parts = int(parts.max()) + 1
    row = np.repeat(np.arange(graph.num_nodes), graph.degrees)
    src_p, dst_p = parts[row], parts[graph.indices]
    fracs = []
    for _ in range(trials):
        chosen = rng.choice(num_parts, size=min(q, num_parts), replace=False)
        inset = np.zeros(num_parts, bool)
        inset[chosen] = True
        within = inset[src_p] & inset[dst_p]
        # edges touching chosen clusters
        touch = inset[src_p] | inset[dst_p]
        fracs.append(within.sum() / max(1, touch.sum()))
    return dict(mean_within=float(np.mean(fracs)),
                std_within=float(np.std(fracs)))


def label_entropy_per_cluster(graph: CSRGraph, parts: Array) -> Array:
    """Paper Fig. 2: label-distribution entropy per cluster."""
    labels = graph.labels
    if labels.ndim > 1:
        labels = labels.argmax(1)
    num_parts = int(parts.max()) + 1
    num_classes = int(labels.max()) + 1
    ent = np.zeros(num_parts)
    for t in range(num_parts):
        sel = labels[parts == t]
        if len(sel) == 0:
            continue
        p = np.bincount(sel, minlength=num_classes) / len(sel)
        p = p[p > 0]
        ent[t] = float(-(p * np.log(p)).sum())
    return ent

def batch_to_device(batch_tuple, device, non_blocking: bool = False):
    """A `ClusterBatch.astuple()` payload (numpy leaves; the adjacency
    dense numpy or a `BlockEllCoords`) as tensors on `device`, the
    adjacency a `BlockEllAdj` whose tiles are written there; a list of
    payloads (a data-parallel rank's slice) maps to a list. With
    non_blocking on a CUDA device the host arrays are first copied into
    pinned memory, so a host buffer reused later is never read by a
    copy still in flight."""
    dev = torch.device(device)
    with trace.span("batch.copy") as copy:
        out = _to_device(batch_tuple, dev, non_blocking)
        if copy:
            host = batch_tuple if isinstance(batch_tuple, list) \
                else [batch_tuple]
            copy.count("copy.bytes", sum(
                _nbytes(t) for p in host for t in payload_arrays(p)
                if t is not None))
            copy.count("copy.pinned", int(non_blocking and dev.type == "cuda"))
            coords = [a for p in host for a in p
                      if isinstance(a, BlockEllCoords)]
            if coords:
                copy.count("copy.tiles_on_device",
                           len(coords) if dev.type == "cuda" else 0)
                copy.count("copy.adj_bytes",
                           sum(_nbytes(a.packed) for a in coords))
    return out


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def payload_arrays(batch) -> list:
    """The host arrays of a batch tuple, an adjacency's tensors (a
    BlockEllCoords' packed buffer; a BlockEllAdj's tensors, None where
    it has no row_k) included, in order: what its copy ships."""
    out = []
    for leaf in batch:
        out.extend(leaf.tensors()
                   if isinstance(leaf, (BlockEllAdj, BlockEllCoords))
                   else [leaf])
    return out


def payload_shapes(batch) -> tuple:
    """The shape signature of a sampler's batch tuple: each leaf's
    shape, a compact adjacency's tile shape. Payloads of one signature
    give the step tensors of one shape (the K of a k_slots="auto" bucket
    included)."""
    return tuple(leaf.shape if isinstance(leaf, BlockEllCoords)
                 else np.shape(leaf) for leaf in batch)


def _to_device(batch_tuple, dev: torch.device, non_blocking: bool):
    if isinstance(batch_tuple, list):
        return [_to_device(b, dev, non_blocking) for b in batch_tuple]

    def move(a):
        if isinstance(a, (BlockEllAdj, BlockEllCoords)):
            return a.to(dev, non_blocking=non_blocking)
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        if t.device == dev:
            return t
        if non_blocking and dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=non_blocking)
    return tuple(move(a) for a in batch_tuple)
