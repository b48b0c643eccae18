"""GraphSAINT-style subgraph samplers (Zeng et al., 2018/2019) — the
port of `repro.core.samplers`, pure numpy and copied line for line, so
a sampler's payloads (estimator weights in `loss_mask` included) are
bit-identical to the reference's per (seed, epoch)
(tests/test_torch_samplers.py).

Cluster-GCN trades estimator variance for partition-induced bias: every
batch is a union of precomputed clusters, so nodes always co-occur with
their cluster. The samplers here sit at the other end of that family —
each step draws an INDEPENDENT random subgraph, so there is no
partition bias, at the price of per-batch variance that the
loss-normalization coefficients below correct for.

Both samplers emit the exact `ClusterBatch` payload contract the
training stack already consumes (`core.batching.subgraph_payload` does
the shared work): dense or block-ELL adjacency of the induced
subgraph re-normalized per batch (paper §6.2 style), fixed node_cap
padding, masks — so the Engine, both StepBackends, k_slots bucketing,
prefetch and checkpoint/resume fast-forward all work unchanged. Epoch
streams are a pure function of (seed, epoch), which is what keeps
`Engine.fit(resume=True)` bitwise-exact for these samplers too.

Sampling distributions and estimator:

* `SaintNodeSampler` — `budget` i.i.d. node draws per batch, uniform
  (p_v = 1/N) or degree-proportional (p_v ∝ deg(v) + 1; the +1 keeps
  isolated nodes reachable so no training node has p_v = 0). The batch
  is the induced subgraph on the distinct drawn nodes.
* `SaintEdgeSampler` — `budget` i.i.d. edge draws per batch with the
  GraphSAINT variance-motivated distribution p_e ∝ 1/deg(u) + 1/deg(v);
  the batch is the induced subgraph on the union of sampled endpoints.

Loss normalization (the unbiased estimator): for each node v in the
batch, the sampler emits the coefficient

    w_v = c_v / E[c_v]

where c_v counts how often v was drawn (node sampler) or how many
sampled edges touch v (edge sampler), and E[c_v] is its closed form
(budget·p_v, resp. budget·Σ_{e∋v} p_e). Since E[w_v] = 1 for every
node, Σ_v w_v·L_v over sampled training nodes is an exactly unbiased
estimator of the full-graph training-loss SUM, and E[Σ_v w_v] is the
training-node count — so the batch loss that `gcn_loss` computes,
Σ w·L / Σ w, is the self-normalized (consistent) estimator of the
full-graph MEAN training loss (the reference's tests/test_samplers.py
Monte-Carlo checks both). The coefficients ride in the payload's
existing `loss_mask` float field; the cluster path keeps its {0, 1}
mask.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.batching import (ClusterBatch, _round_up,
                                       normalized_subgraph_csr,
                                       subgraph_payload)
from repro_torch.graph.csr import CSRGraph
from repro_torch.runtime import trace

Array = np.ndarray


@dataclasses.dataclass
class _SaintSampler:
    """Shared scaffolding of the GraphSAINT-style samplers.

    graph: FULL graph (inductive: pass the training subgraph).
    budget: draws per batch — nodes for SaintNodeSampler, edges for
      SaintEdgeSampler. The distinct-node count of a batch is bounded by
      `budget` (node) / `2 * budget` (edge), which is what sizes the
      default node_cap — SAINT batches can never overflow it, so unlike
      ClusterBatcher there is no drop_overflow knob (dropping sampled
      nodes would silently skew the estimator weights).
    batches_per_epoch: steps per "epoch" (an epoch is a bookkeeping
      unit here — draws are i.i.d.); None derives a pass-over-the-data
      equivalent (N/budget nodes, resp. E/budget edges).
    norm/diag_lambda, node_cap/pad_multiple, sparse_adj/block_size/
      k_slots/precompute_ax/reuse_tile_buffers: payload knobs, exactly
      as on ClusterBatcher (reuse_tile_buffers without effect; k_slots
      "auto" plans fill-adaptive K buckets from epoch-0 samples via the
      same repro_torch.core.kslots machinery).
    seed: the epoch stream is a pure function of (seed, epoch_idx).
    """
    graph: CSRGraph
    budget: int
    norm: str = "eq10"
    diag_lambda: float = 0.0
    node_cap: Optional[int] = None
    pad_multiple: int = 128
    seed: int = 0
    batches_per_epoch: Optional[int] = None
    sparse_adj: bool = False
    block_size: int = 128
    k_slots: Union[int, str] = "cap"
    precompute_ax: bool = False
    reuse_tile_buffers: bool = False

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1; got {self.budget}")
        if (self.batches_per_epoch is not None
                and self.batches_per_epoch < 1):
            raise ValueError(f"batches_per_epoch must be None or >= 1; "
                             f"got {self.batches_per_epoch}")
        self._setup()
        if self.node_cap is None:
            self.node_cap = _round_up(max(self._max_batch_nodes(), 1),
                                      self.pad_multiple)
        elif self.node_cap < self._max_batch_nodes():
            raise ValueError(
                f"node_cap={self.node_cap} cannot hold a worst-case "
                f"batch of {self._max_batch_nodes()} distinct nodes "
                f"(budget={self.budget}); raise node_cap or lower the "
                f"budget — SAINT batches are never truncated, that "
                f"would bias the estimator")
        if self.sparse_adj and self.node_cap % self.block_size:
            raise ValueError(
                f"sparse_adj needs node_cap ({self.node_cap}) divisible "
                f"by block_size ({self.block_size})")
        if isinstance(self.k_slots, str) and self.k_slots not in ("cap",
                                                                  "auto"):
            raise ValueError(f"k_slots must be 'cap', 'auto' or an int; "
                             f"got {self.k_slots!r}")
        self.k_plan = None
        if self.sparse_adj and self.k_slots == "auto":
            from repro_torch.core.kslots import plan_k_buckets
            self.k_plan = plan_k_buckets(self)

    # -- subclass hooks -------------------------------------------------
    def _setup(self) -> None:
        raise NotImplementedError

    def _max_batch_nodes(self) -> int:
        raise NotImplementedError

    def _default_steps(self) -> int:
        raise NotImplementedError

    def draw(self, rng: np.random.Generator) -> Tuple[Array, Array]:
        """(nodes, weights): distinct sampled node ids (ascending) and
        their estimator coefficients w_v = c_v / E[c_v]."""
        raise NotImplementedError

    # -- Sampler protocol -----------------------------------------------
    def steps_per_epoch(self) -> int:
        return (self.batches_per_epoch if self.batches_per_epoch
                is not None else self._default_steps())

    def _payload(self, nodes: Array, weights: Array) -> ClusterBatch:
        return subgraph_payload(self.graph, nodes, node_cap=self.node_cap,
                                norm=self.norm,
                                diag_lambda=self.diag_lambda,
                                sparse_adj=self.sparse_adj,
                                block_size=self.block_size,
                                k_slots=self.k_slots, k_plan=self.k_plan,
                                loss_weights=weights,
                                precompute_ax=self.precompute_ax)

    def epoch(self, epoch_idx: int, start_step: int = 0):
        """steps_per_epoch() i.i.d. subgraph batches. The stream is a
        pure function of (seed, epoch_idx) — resume fast-forward skips
        k payloads and reproduces the tail exactly. start_step=k still
        DRAWS the skipped steps (the rng stream must advance exactly as
        training's did) but skips payload construction — the subgraph
        extraction + tiling that dominates batch cost."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        for step in range(self.steps_per_epoch()):
            if step < start_step:
                self.draw(rng)
                continue
            with trace.step_span("batch.build", epoch_idx, step):
                with trace.span("batch.nodes"):
                    nodes, weights = self.draw(rng)
                trace.count("batch.nodes_real", len(nodes))
                payload = self._payload(nodes, weights)
            yield payload

    def sample_csrs(self, n: int) -> List[Tuple[Array, Array, Array]]:
        """Normalized batch CSRs of the first n batches of epoch 0 (the
        rng stream training sees) for the k_slots planner."""
        rng = np.random.default_rng((self.seed, 0))
        n = min(max(1, n), self.steps_per_epoch())
        return [normalized_subgraph_csr(self.graph, self.draw(rng)[0],
                                        self.norm, self.diag_lambda)
                for _ in range(n)]

    def padding_stats(self, sample_batches: int = 4) -> dict:
        """Sampled batch-size / padding accounting (and block-fill stats
        on the sparse path), mirroring ClusterBatcher.padding_stats."""
        rng = np.random.default_rng((self.seed, 0))
        sizes = [len(self.draw(rng)[0]) for _ in range(sample_batches)]
        avg = float(np.mean(sizes))
        stats = dict(node_cap=self.node_cap, avg_batch_nodes=avg,
                     pad_waste=float(1.0 - avg / self.node_cap),
                     budget=self.budget, overflow_count=0)
        if self.sparse_adj:
            from repro_torch.core.kslots import fill_stats
            stats.update(fill_stats(self, sample_batches))
            if self.k_plan is not None:
                stats["k_buckets"] = list(self.k_plan.buckets)
        return stats


@dataclasses.dataclass
class SaintNodeSampler(_SaintSampler):
    """GraphSAINT node sampler: `budget` i.i.d. node draws per batch.

    degree_weighted=False draws uniformly (p_v = 1/N); True draws
    p_v ∝ deg(v) + 1 (degree-proportional, +1 so isolated nodes keep
    non-zero probability and the loss estimator stays unbiased).
    """
    degree_weighted: bool = False

    def _setup(self) -> None:
        if self.degree_weighted:
            w = self.graph.degrees.astype(np.float64) + 1.0
            self._p = w / w.sum()
        else:
            self._p = None        # uniform: p_v = 1/N, kept scalar

    def _max_batch_nodes(self) -> int:
        return min(self.budget, self.graph.num_nodes)

    def _default_steps(self) -> int:
        return -(-self.graph.num_nodes // self.budget)

    def draw(self, rng: np.random.Generator) -> Tuple[Array, Array]:
        n = self.graph.num_nodes
        if self.degree_weighted:
            idx = rng.choice(n, size=self.budget, replace=True, p=self._p)
        else:
            idx = rng.integers(0, n, size=self.budget)
        nodes, counts = np.unique(idx, return_counts=True)
        # w_v = c_v / E[c_v],  E[c_v] = budget * p_v
        p = 1.0 / n if self._p is None else self._p[nodes]
        weights = counts / (self.budget * p)
        return nodes, weights.astype(np.float32)


@dataclasses.dataclass
class SaintEdgeSampler(_SaintSampler):
    """GraphSAINT edge sampler: `budget` i.i.d. edge draws per batch
    with p_e ∝ 1/deg(u) + 1/deg(v) (the variance-motivated distribution
    of Zeng et al.), batch = induced subgraph on the sampled endpoints.
    A node's expected incidence count E[c_v] = budget·Σ_{e∋v} p_e is
    exact in closed form, which is what the loss coefficients divide by.
    """

    def _setup(self) -> None:
        g = self.graph
        row = np.repeat(np.arange(g.num_nodes), g.degrees)
        upper = row < g.indices          # each undirected edge once
        self._eu = row[upper].astype(np.int64)
        self._ev = g.indices[upper].astype(np.int64)
        if len(self._eu) == 0:
            raise ValueError("SaintEdgeSampler needs a graph with at "
                             "least one edge")
        deg = g.degrees.astype(np.float64)
        p = 1.0 / deg[self._eu] + 1.0 / deg[self._ev]
        self._pe = p / p.sum()
        # per-draw incidence probability Σ_{e∋v} p_e  (E[c_v]/budget)
        q = np.zeros(g.num_nodes)
        np.add.at(q, self._eu, self._pe)
        np.add.at(q, self._ev, self._pe)
        self._qv = q

    def _max_batch_nodes(self) -> int:
        return min(2 * self.budget, self.graph.num_nodes)

    def _default_steps(self) -> int:
        return -(-len(self._eu) // self.budget)

    def draw(self, rng: np.random.Generator) -> Tuple[Array, Array]:
        eidx = rng.choice(len(self._eu), size=self.budget, replace=True,
                          p=self._pe)
        ends = np.concatenate([self._eu[eidx], self._ev[eidx]])
        nodes, counts = np.unique(ends, return_counts=True)
        # w_v = c_v / E[c_v],  E[c_v] = budget * q_v
        weights = counts / (self.budget * self._qv[nodes])
        return nodes, weights.astype(np.float32)
