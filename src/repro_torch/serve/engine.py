"""The online half of the serving layer: cluster-keyed lookups through a
fixed-shape probs/top-k step on the device — the port of
`repro.serve.engine`.

Query flow: node ids → group by cluster (`parts` is the routing table)
→ per-cluster embedding fetch (disk cache hit = an mmap'd row gather;
miss = lazy exact re-embed via the L-hop halo path) → pad the gathered
logits to the smallest pow2 request bucket → one probs + top-k step on
the device (`torch.sigmoid`/`torch.softmax`, `torch.topk`) whose shapes
are keyed only on the bucket.

Live updates enter through `apply_delta`: the graph/routing table are
swapped, the cache re-keys onto the grown graph's partition fingerprint
carrying over every cluster outside the delta's num_layers-hop
influence region, and the balance monitor checks the partition.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.gcn import GCN, GCNConfig
from repro_torch.core.kslots import pow2_ceil
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import partition_fingerprint
from repro_torch.serve.deltas import BalanceMonitor, GraphDelta, apply_delta
from repro_torch.serve.embedding_cache import (EmbeddingCache, embed_cluster,
                                               full_graph_embeddings)

DEFAULT_BUCKETS = (1, 8, 64)


@dataclasses.dataclass
class ServeResult:
    """One answered query batch. Arrays are trimmed to the requested
    ids (padding removed); `bucket` and `latency_s` describe the step
    that actually ran."""
    node_ids: np.ndarray          # (n,) int64 — echo of the request
    logits: np.ndarray            # (n, C) fp32
    probs: np.ndarray             # (n, C) fp32 sigmoid/softmax
    topk_ids: np.ndarray          # (n, k) int32 class ids, best first
    topk_scores: np.ndarray       # (n, k) fp32
    bucket: int                   # padded batch size that executed
    latency_s: float              # wall time of gather→step→host, synced


class ServeEngine:
    """Serves final-layer GCN predictions for single nodes or batches,
    backed by the per-cluster `EmbeddingCache`. The heavy math
    (multi-hop propagation) happens offline in `warm()` or lazily per
    cluster on first touch, on `device`; the online step is an
    embedding row gather plus a small probs/top-k step there too.

    `device` defaults to "cuda" and raises when no GPU is visible; pass
    device="cpu" to serve from the host."""

    def __init__(self, params: GCN, graph: CSRGraph, parts: np.ndarray,
                 cfg: GCNConfig, *, cache: EmbeddingCache,
                 device="cuda", norm: str = "eq10",
                 diag_lambda: float = 0.0,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 256, top_k: int = 5, block: int = 128,
                 imbalance_threshold: float = 2.0,
                 on_rebalance: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.graph = graph
        self.parts = np.asarray(parts)
        self.cfg = cfg
        self.cache = cache
        self.norm = norm
        self.diag_lambda = float(diag_lambda)
        self.block = int(block)
        self.max_batch = int(max_batch)
        self.top_k = min(int(top_k), cfg.out_dim)
        cap = pow2_ceil(self.max_batch)
        if buckets is None:
            buckets = [b for b in DEFAULT_BUCKETS if b < cap] + [cap]
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {self.buckets}")
        self.monitor = BalanceMonitor(threshold=imbalance_threshold,
                                      on_rebalance=on_rebalance)
        self.num_parts = int(self.parts.max()) + 1
        self._cluster_rows: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------
    def _rows_of(self, c: int) -> np.ndarray:
        rows = self._cluster_rows.get(c)
        if rows is None:
            rows = np.where(self.parts == c)[0]
            self._cluster_rows[c] = rows
        return rows

    def _ensure_cluster(self, c: int) -> np.ndarray:
        """Cache hit → mmap'd load; miss → exact halo re-embed + store
        (this IS the lazy re-embed path after an invalidation)."""
        if not self.cache.has(c):
            emb = embed_cluster(self.params, self.graph, self.cfg,
                                self._rows_of(c), norm=self.norm,
                                diag_lambda=self.diag_lambda,
                                block=self.block)
            self.cache.store(c, emb)
        return self.cache.load(c)

    def warm(self) -> int:
        """Precompute every missing cluster. When the cache is entirely
        cold this is ONE shared full-graph blocked pass (hidden layers
        computed once, not per cluster); a partially-warm cache fills
        the gaps via the per-cluster halo path. Returns the number of
        clusters computed."""
        missing = [c for c in range(self.num_parts)
                   if not self.cache.has(c)]
        if len(missing) == self.num_parts:
            z = full_graph_embeddings(
                self.params, self.graph, self.parts, self.cfg,
                norm=self.norm, diag_lambda=self.diag_lambda,
                block=self.block)
            for c in missing:
                self.cache.store(c, z[self._rows_of(c)])
        else:
            for c in missing:
                self._ensure_cluster(c)
        return len(missing)

    # ------------------------------------------------------------------
    # the query step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _step(self, logits: torch.Tensor):
        """Fixed-shape probs + top-k on the device."""
        if self.cfg.multilabel:
            probs = torch.sigmoid(logits)
        else:
            probs = torch.softmax(logits, dim=-1)
        scores, ids = torch.topk(probs, self.top_k, dim=-1)
        return probs, ids.to(torch.int32), scores

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds the largest bucket "
                         f"{self.buckets[-1]} — query() should have "
                         f"chunked it")

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def _gather_logits(self, ids: np.ndarray) -> np.ndarray:
        out = np.empty((len(ids), self.cfg.out_dim), np.float32)
        for c in np.unique(self.parts[ids]):
            emb = self._ensure_cluster(int(c))
            rows = self._rows_of(int(c))
            sel = np.where(self.parts[ids] == c)[0]
            out[sel] = emb[np.searchsorted(rows, ids[sel])]
        return out

    def query(self, node_ids) -> ServeResult:
        """Answer a batch of node-id lookups. Requests larger than the
        top bucket are split into cap-sized chunks and re-joined (the
        reported bucket/latency are then the largest chunk's bucket and
        the summed chunk latency)."""
        ids = np.atleast_1d(np.asarray(node_ids, dtype=np.int64))
        if ids.ndim != 1 or len(ids) == 0:
            raise ValueError("node_ids must be a non-empty 1-D sequence")
        if ids.min() < 0 or ids.max() >= self.graph.num_nodes:
            raise ValueError(f"node id out of range [0, "
                             f"{self.graph.num_nodes})")
        cap = self.buckets[-1]
        if len(ids) > cap:
            chunks = [self.query(ids[s:s + cap])
                      for s in range(0, len(ids), cap)]
            return ServeResult(
                node_ids=ids,
                logits=np.concatenate([r.logits for r in chunks]),
                probs=np.concatenate([r.probs for r in chunks]),
                topk_ids=np.concatenate([r.topk_ids for r in chunks]),
                topk_scores=np.concatenate(
                    [r.topk_scores for r in chunks]),
                bucket=max(r.bucket for r in chunks),
                latency_s=sum(r.latency_s for r in chunks))
        t0 = time.perf_counter()
        logits = self._gather_logits(ids)
        bucket = self.bucket_for(len(ids))
        padded = np.zeros((bucket, self.cfg.out_dim), np.float32)
        padded[:len(ids)] = logits
        probs, tk_ids, tk_scores = self._step(
            torch.from_numpy(padded).to(self.device))
        if self.device.type == "cuda":
            # the step is asynchronous: wait for it inside the timed
            # region, as the reference waits in block_until_ready
            torch.cuda.synchronize(self.device)
        probs, tk_ids, tk_scores = (probs.cpu().numpy(),
                                    tk_ids.cpu().numpy(),
                                    tk_scores.cpu().numpy())
        latency = time.perf_counter() - t0
        return ServeResult(
            node_ids=ids, logits=logits, probs=probs[:len(ids)],
            topk_ids=tk_ids[:len(ids)], topk_scores=tk_scores[:len(ids)],
            bucket=bucket, latency_s=latency)

    # ------------------------------------------------------------------
    # live updates
    # ------------------------------------------------------------------
    def apply_delta(self, delta: GraphDelta) -> Dict:
        """Apply a live update: swap in the appended graph + routing
        table, invalidate the clusters inside the delta's
        num_layers-hop influence region (every cluster outside it keeps
        serving its exact cached bytes), re-key the cache onto the grown
        graph's partition fingerprint, and run the balance check."""
        graph2, parts2, touched = apply_delta(
            self.graph, self.parts, delta,
            num_layers=self.cfg.num_layers)
        new_fp = partition_fingerprint(graph2, parts2)
        if new_fp == self.cache.partition_fingerprint:
            # every edge was already present: the served graph did not
            # change, so nothing is stale and the key stays
            touched, invalidated = [], []
        else:
            invalidated = [c for c in touched if self.cache.has(c)]
            self.cache = self.cache.rekey(new_fp, drop=touched)
        self.graph, self.parts = graph2, parts2
        self.num_parts = int(self.parts.max()) + 1
        self._cluster_rows.clear()
        imbalance = self.monitor.check(self.parts)
        return {"touched_clusters": touched,
                "invalidated_clusters": invalidated,
                "num_nodes": self.graph.num_nodes,
                "imbalance": imbalance}

    # ------------------------------------------------------------------
    # construction from a training run
    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, spec, checkpoint_dir: Optional[str] = None,
                        *, step: Optional[int] = None,
                        graph: Optional[CSRGraph] = None,
                        cache_root=None, device="cuda") -> "ServeEngine":
        """Build a serving engine on `device` from an ExperimentSpec and
        the checkpoints its training run wrote (by either package — the
        on-disk layout is shared). Params-only restore via
        CheckpointManager.restore_params, walking back past corrupt
        newest steps. The cache directory is keyed on (restored step,
        partition fingerprint)."""
        from repro_torch.core.experiment import (build_gcn_config,
                                                 build_graph,
                                                 build_partition, validate)
        from repro_torch.core.gcn import (init_gcn, params_from_numpy,
                                          params_to_numpy)
        from repro_torch.graph.datasets import default_serving_cache_dir
        from repro_torch.runtime.checkpoint import CheckpointManager

        dev = resolve_device(device)
        validate(spec)
        ckpt_dir = checkpoint_dir or spec.run.checkpoint_dir
        if not ckpt_dir:
            raise ValueError("no checkpoint directory: pass "
                             "checkpoint_dir or set run.checkpoint_dir")
        if graph is None:
            graph = build_graph(spec)
        parts, _ = build_partition(spec, graph)
        cfg = build_gcn_config(spec, graph)
        # the template only carries the tree structure and shapes
        template = params_to_numpy(init_gcn(
            cfg, generator=torch.Generator().manual_seed(spec.run.seed),
            device="cpu"))
        mgr = CheckpointManager(ckpt_dir)
        tree, loaded_step = mgr.restore_params(template, step=step,
                                               device=dev)
        s = spec.serve
        if cache_root is None:
            cache_root = (s.cache_dir if s.cache_dir
                          else default_serving_cache_dir() / spec.name)
        cache = EmbeddingCache(
            cache_root, checkpoint_step=loaded_step,
            partition_fingerprint=partition_fingerprint(graph, parts))
        return cls(params_from_numpy(tree, dev), graph, parts, cfg,
                   cache=cache, device=dev, norm=spec.batch.norm,
                   diag_lambda=spec.batch.diag_lambda,
                   buckets=s.buckets, max_batch=s.max_batch,
                   top_k=s.top_k,
                   imbalance_threshold=s.imbalance_threshold)
