"""Paper Table 4 config for Amazon2M-like data (§4.2), exposed as
constants and as runnable ExperimentSpec presets ("amazon2m" /
"amazon2m_tiny" in the repro_torch.core.experiment registry). Amazon2M is
MULTICLASS, and its co-purchase generator has no validation split —
eval_split is explicitly "test" here rather than silently falling
back."""
from repro_torch.core.experiment import (BatchSpec, DataSpec,
                                         ExperimentSpec, ModelSpec,
                                         OptimSpec, PartitionSpec, RunSpec)

PARTITIONS = 15000
CLUSTERS_PER_BATCH = 10
HIDDEN = 400


def spec() -> ExperimentSpec:
    return ExperimentSpec(
        name="amazon2m",
        data=DataSpec(name="amazon2m", scale=1.0, seed=0),
        partition=PartitionSpec(num_parts=PARTITIONS, method="metis"),
        batch=BatchSpec(clusters_per_batch=CLUSTERS_PER_BATCH,
                        norm="eq10"),
        model=ModelSpec(hidden_dim=HIDDEN, num_layers=3, dropout=0.2,
                        multilabel=False),
        optim=OptimSpec(name="adamw", lr=1e-2),
        run=RunSpec(epochs=200, eval_every=20, eval_split="test"))


def real_spec() -> ExperimentSpec:
    """The Table 4 Amazon2M recipe on ogbn-products (2,449,029 nodes —
    the SAME Amazon co-purchase graph, in its modern OGB distribution;
    the paper's original Amazon2M files are no longer hosted). Splits
    follow OGB's sales-ranking protocol, which HAS a validation set —
    so unlike the synthetic stand-in this evaluates on val during
    training and reserves test for the leaderboard."""
    s = spec()
    s.name = "amazon2m_real"
    s.data = DataSpec(name="ogbn_products")
    s.run.eval_split = "val"
    return s


def tiny_spec() -> ExperimentSpec:
    """CPU-smoke-sized Amazon2M: ~700 nodes of the power-law
    co-purchase generator."""
    s = spec()
    s.name = "amazon2m_tiny"
    s.data.scale = 0.0003
    s.partition.num_parts = 8
    s.batch.clusters_per_batch = 2
    s.model.hidden_dim = 32
    s.run.epochs = 5
    s.run.eval_every = 1
    return s
