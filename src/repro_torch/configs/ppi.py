"""Paper dataset config for PPI (Table 4): partitions, clusters-per-
batch, hidden size — plus the §4.3 SOTA deep recipe — exposed both as
constants and as runnable ExperimentSpec presets (registered in
repro_torch.core.experiment as "ppi" / "ppi_sota" / "ppi_tiny")."""
from repro_torch.core.experiment import (BatchSpec, DataSpec,
                                         ExperimentSpec, ModelSpec,
                                         OptimSpec, PartitionSpec, RunSpec)
from repro_torch.core.gcn import GCNConfig

# paper Table 4 hyper-parameters
PARTITIONS = 50
CLUSTERS_PER_BATCH = 1
HIDDEN = 512

# §4.3 SOTA: 5 layers, 2048 hidden, diagonal enhancement Eq. 11
SOTA = dict(num_layers=5, hidden=2048, norm="eq11", diag_lambda=1.0,
            dropout=0.1)


def gcn_config(in_dim: int, out_dim: int, num_layers: int = 3,
               hidden: int = HIDDEN,
               multilabel: bool = True) -> GCNConfig:
    """PPI is multi-label (sigmoid BCE) so that's the default here, but
    it is a parameter — reusing this helper for a multiclass dataset no
    longer silently trains the wrong loss (the preset registry sets it
    per dataset; build_gcn_config infers it from the labels)."""
    return GCNConfig(in_dim=in_dim, hidden_dim=hidden, out_dim=out_dim,
                     num_layers=num_layers, dropout=0.2,
                     multilabel=multilabel)


def spec() -> ExperimentSpec:
    """Table 4 PPI recipe on the PPI-like generator."""
    return ExperimentSpec(
        name="ppi",
        data=DataSpec(name="ppi", scale=1.0, seed=0),
        partition=PartitionSpec(num_parts=PARTITIONS, method="metis"),
        batch=BatchSpec(clusters_per_batch=CLUSTERS_PER_BATCH,
                        norm="eq10"),
        model=ModelSpec(hidden_dim=HIDDEN, num_layers=3, dropout=0.2,
                        multilabel=True),
        optim=OptimSpec(name="adamw", lr=1e-2),
        run=RunSpec(epochs=200, eval_every=10, eval_split="val"))


def sota_spec() -> ExperimentSpec:
    """§4.3 SOTA: 5-layer 2048-hidden deep GCN with Eq. 11 diagonal
    enhancement (the recipe that needs diag_lambda to converge)."""
    s = spec()
    s.name = "ppi_sota"
    s.batch.norm = SOTA["norm"]
    s.batch.diag_lambda = SOTA["diag_lambda"]
    s.model.num_layers = SOTA["num_layers"]
    s.model.hidden_dim = SOTA["hidden"]
    s.model.dropout = SOTA["dropout"]
    return s


def tiny_spec() -> ExperimentSpec:
    """CPU-smoke-sized PPI: same shape of recipe, ~400 nodes."""
    s = spec()
    s.name = "ppi_tiny"
    s.data.scale = 0.03
    s.partition.num_parts = 8
    s.batch.clusters_per_batch = 2
    s.model.hidden_dim = 64
    s.run.epochs = 5
    s.run.eval_every = 1
    return s


def deep_tiny_spec() -> ExperimentSpec:
    """CPU-smoke-sized DEEP PPI: the §4.3 deep-GCN shape (8 layers,
    Eq. 11 diagonal enhancement) under the full precision/memory
    policy — bf16 compute with dynamic loss scaling, layer-chunked
    remat, and payload-time A'X (paper §6.2). The CI deep-gcn-smoke job
    trains this end to end, so the whole mixed-precision path stays
    exercised on every commit."""
    s = tiny_spec()
    s.name = "ppi_deep_tiny"
    s.batch.norm = SOTA["norm"]
    s.batch.diag_lambda = SOTA["diag_lambda"]
    s.model.num_layers = 8
    s.model.residual = True
    s.model.precompute_ax = True
    s.model.precision = "bf16"
    s.model.loss_scaling = "dynamic"
    s.model.remat = True
    s.model.remat_chunk = 2
    s.run.epochs = 3
    return s


def real_spec() -> ExperimentSpec:
    """Table 4 PPI recipe on the REAL GraphSAGE PPI graph (56,944
    nodes, 50 features, 121 labels) — the leaderboard run that compares
    against the paper's 99.36 micro-F1. First use downloads and caches
    the dataset (repro.graph.datasets; not ported yet); the partition is memoized in
    the partition cache keyed on the dataset fingerprint."""
    s = spec()
    s.name = "ppi_real"
    s.data = DataSpec(name="ppi_real")
    return s


def real_tiny_spec() -> ExperimentSpec:
    """The REAL PPI graph under a CI-sized recipe: full data (real
    graphs cannot be shrunk — data.scale must stay 1.0), but a narrow
    model and few epochs so the nightly real-datasets lane trains end
    to end in minutes on CPU. The micro-F1 floor this must clear is
    asserted by the lane, not here."""
    s = real_spec()
    s.name = "ppi_real_tiny"
    s.batch.clusters_per_batch = 2
    s.model.hidden_dim = 128
    s.model.num_layers = 2
    s.run.epochs = 10
    s.run.eval_every = 5
    return s


def tiny_saint_spec() -> ExperimentSpec:
    """ppi_tiny on the GraphSAINT node sampler instead of the cluster
    batcher — same graph/model/optimizer, partition-free i.i.d.
    subgraphs with unbiased loss normalization (the repo's first
    non-cluster workload; repro.core.samplers)."""
    s = tiny_spec()
    s.name = "ppi_tiny_saint"
    s.batch.sampler = "saint_node"
    s.batch.budget = 128           # ~ the q-cluster union batch size
    return s
