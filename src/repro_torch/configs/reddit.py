"""Paper Table 4 config for Reddit-like data, exposed as constants and
as runnable ExperimentSpec presets ("reddit" / "reddit_tiny" in the
repro_torch.core.experiment registry). Reddit is MULTICLASS (softmax CE) —
the preset sets that explicitly instead of inheriting PPI's
multilabel."""
from repro_torch.core.experiment import (BatchSpec, DataSpec,
                                         ExperimentSpec, ModelSpec,
                                         OptimSpec, PartitionSpec, RunSpec)

PARTITIONS = 1500
CLUSTERS_PER_BATCH = 20
HIDDEN = 128


def spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="reddit",
        data=DataSpec(name="reddit", scale=1.0, seed=0),
        partition=PartitionSpec(num_parts=PARTITIONS, method="metis"),
        batch=BatchSpec(clusters_per_batch=CLUSTERS_PER_BATCH,
                        norm="eq10"),
        model=ModelSpec(hidden_dim=HIDDEN, num_layers=4, dropout=0.2,
                        multilabel=False),
        optim=OptimSpec(name="adamw", lr=1e-2),
        run=RunSpec(epochs=130, eval_every=10, eval_split="val"))


def tiny_spec() -> ExperimentSpec:
    """CPU-smoke-sized Reddit: ~600 nodes, small hidden."""
    s = spec()
    s.name = "reddit_tiny"
    s.data.scale = 0.01
    s.partition.num_parts = 8
    s.batch.clusters_per_batch = 2
    s.model.hidden_dim = 32
    s.model.num_layers = 2
    s.run.epochs = 5
    s.run.eval_every = 1
    return s


def real_spec() -> ExperimentSpec:
    """Table 4 Reddit recipe on the REAL Reddit graph (232,965 nodes,
    602 features, 41 classes; DGL npz distribution) — the leaderboard
    run against the paper's 96.60 micro-F1. Downloaded + cached on
    first use (repro_torch.graph.datasets)."""
    s = spec()
    s.name = "reddit_real"
    s.data = DataSpec(name="reddit_real")
    return s


def tiny_saint_spec() -> ExperimentSpec:
    """reddit_tiny on the GraphSAINT edge sampler (p_e ∝ 1/deg(u) +
    1/deg(v)) — exercises the edge-sampled variance/bias trade-off on
    the high-degree Reddit-like generator (repro.core.samplers)."""
    s = tiny_spec()
    s.name = "reddit_tiny_saint"
    s.batch.sampler = "saint_edge"
    s.batch.budget = 256           # edges/draw → ≤ 512-node batches
    return s
