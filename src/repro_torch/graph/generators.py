"""Synthetic graph generators.

The container has no network access, so the paper's datasets (PPI, Reddit,
Amazon, Amazon2M) are stood in for by generators that match their
*statistics that matter to the algorithm*:

* community structure (clustering must beat random partitioning — Table 2),
* labels correlated with communities (label-entropy skew — Fig. 2),
* features correlated with labels (so GCN training actually learns),
* power-law degree for the co-purchase graphs (Amazon2M §4.2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph, group_members


@dataclasses.dataclass(frozen=True)
class SBMSpec:
    num_nodes: int = 10_000
    num_communities: int = 50
    num_classes: int = 10
    feature_dim: int = 64
    avg_within_degree: float = 12.0
    avg_between_degree: float = 2.0
    # probability that a node's class equals its community's dominant class
    label_purity: float = 0.85
    feature_noise: float = 1.0
    multilabel: bool = False
    train_frac: float = 0.66
    val_frac: float = 0.12
    seed: int = 0


def _sample_block_edges(rng, rows, cols, n_edges):
    """Sample ~n_edges random (src, dst) pairs between two node id arrays."""
    if n_edges <= 0 or len(rows) == 0 or len(cols) == 0:
        return (np.empty(0, np.int64),) * 2
    src = rows[rng.integers(0, len(rows), size=n_edges)]
    dst = cols[rng.integers(0, len(cols), size=n_edges)]
    return src, dst


def stochastic_block_model(spec: SBMSpec) -> CSRGraph:
    """SBM with community-correlated labels and label-correlated features.

    Edge sampling is O(E) (sample endpoints per block, dedupe in CSR build)
    which is what lets the scale benchmark generate multi-million-node
    graphs in numpy.
    """
    rng = np.random.default_rng(spec.seed)
    n, k = spec.num_nodes, spec.num_communities
    comm = rng.integers(0, k, size=n)
    order = np.argsort(comm, kind="stable")
    comm = comm[order]  # nodes grouped by community but ids are 0..n-1
    # nodes per community (contiguous after sort — but we keep ids scattered
    # via a random permutation so partitioners cannot cheat on node order)
    perm = rng.permutation(n)
    comm = comm[np.argsort(perm)]  # random assignment, same distribution

    members = group_members(comm, k)

    # within-community edges
    srcs, dsts = [], []
    for c in range(k):
        m = members[c]
        ne = int(len(m) * spec.avg_within_degree / 2)
        s, d = _sample_block_edges(rng, m, m, ne)
        srcs.append(s)
        dsts.append(d)
    # between-community edges: sample random endpoints from all nodes and
    # keep the cross ones (cheap and unbiased enough)
    ne_between = int(n * spec.avg_between_degree / 2)
    s = rng.integers(0, n, size=ne_between * 2)
    d = rng.integers(0, n, size=ne_between * 2)
    cross = comm[s] != comm[d]
    srcs.append(s[cross][:ne_between])
    dsts.append(d[cross][:ne_between])

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)

    # labels: each community has a dominant class
    dom = rng.integers(0, spec.num_classes, size=k)
    labels = dom[comm].astype(np.int32)
    flip = rng.random(n) > spec.label_purity
    labels[flip] = rng.integers(0, spec.num_classes, size=int(flip.sum()))

    # features: class centroid + noise
    centroids = rng.normal(size=(spec.num_classes, spec.feature_dim)).astype(np.float32)
    feats = centroids[labels] + spec.feature_noise * rng.normal(
        size=(n, spec.feature_dim)).astype(np.float32)

    if spec.multilabel:
        # PPI-style multi-label: dominant class one-hot plus random extras
        y = np.zeros((n, spec.num_classes), np.float32)
        y[np.arange(n), labels] = 1.0
        extra = rng.random((n, spec.num_classes)) < 0.08
        y = np.maximum(y, extra.astype(np.float32))
        labels_out = y
    else:
        labels_out = labels

    # splits
    u = rng.random(n)
    train_mask = u < spec.train_frac
    val_mask = (u >= spec.train_frac) & (u < spec.train_frac + spec.val_frac)
    test_mask = ~(train_mask | val_mask)

    g = CSRGraph.from_edges(n, src, dst, features=feats, labels=labels_out,
                            train_mask=train_mask, val_mask=val_mask,
                            test_mask=test_mask)
    return g


@dataclasses.dataclass(frozen=True)
class CoPurchaseSpec:
    """Amazon2M-like: power-law degree + community structure."""
    num_nodes: int = 100_000
    num_communities: int = 500
    num_classes: int = 47
    feature_dim: int = 100
    avg_degree: float = 25.0
    within_frac: float = 0.85
    label_purity: float = 0.8
    seed: int = 0


def copurchase_graph(spec: CoPurchaseSpec) -> CSRGraph:
    """Power-law degrees via preferential weights, community-biased edges."""
    rng = np.random.default_rng(spec.seed)
    n, k = spec.num_nodes, spec.num_communities
    comm = rng.integers(0, k, size=n)
    # Zipf-ish node weights -> power-law degree when sampling endpoints
    w = rng.pareto(2.0, size=n) + 1.0
    total_edges = int(n * spec.avg_degree / 2)

    members = group_members(comm, k)
    mweights = [w[m] / w[m].sum() if len(m) else None for m in members]

    n_within = int(total_edges * spec.within_frac)
    # distribute within edges across communities proportional to size
    sizes = np.array([len(m) for m in members], dtype=np.float64)
    alloc = rng.multinomial(n_within, sizes / sizes.sum())
    srcs, dsts = [], []
    for c in range(k):
        m = members[c]
        if len(m) < 2 or alloc[c] == 0:
            continue
        s = rng.choice(m, size=alloc[c], p=mweights[c])
        d = rng.choice(m, size=alloc[c], p=mweights[c])
        srcs.append(s)
        dsts.append(d)
    n_between = total_edges - n_within
    p = w / w.sum()
    srcs.append(rng.choice(n, size=n_between, p=p))
    dsts.append(rng.choice(n, size=n_between, p=p))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)

    dom = rng.integers(0, spec.num_classes, size=k)
    labels = dom[comm].astype(np.int32)
    flip = rng.random(n) > spec.label_purity
    labels[flip] = rng.integers(0, spec.num_classes, size=int(flip.sum()))
    centroids = rng.normal(size=(spec.num_classes, spec.feature_dim)).astype(np.float32)
    feats = (centroids[labels] + rng.normal(size=(n, spec.feature_dim))).astype(np.float32)

    u = rng.random(n)
    train_mask = u < 0.7
    test_mask = ~train_mask
    return CSRGraph.from_edges(n, src, dst, features=feats, labels=labels,
                               train_mask=train_mask,
                               val_mask=np.zeros(n, bool), test_mask=test_mask)


# Named dataset registry mirroring the paper's Table 3 (scaled for CPU),
# plus the real benchmark datasets (repro_torch.graph.datasets) under
# their *_real / ogbn_* names.
def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 cache_dir: str | None = None,
                 mmap: bool = True) -> CSRGraph:
    """One registry for every graph a spec can name. Synthetic names
    (ppi, reddit, amazon2m, cora, structural) are seeded generators and
    honor `scale` — bit-identical to `repro.graph.make_dataset` for the
    same (name, scale, seed). Real names (ppi_real, reddit_real,
    ogbn_arxiv, ogbn_products) load the actual benchmark through the
    disk cache (`cache_dir`/`mmap` — repro_torch.graph.datasets) and
    reject scale != 1 loudly: real data cannot be resampled, *_tiny
    recipes shrink the model/epochs instead. `seed` is ignored for real
    datasets (their splits are fixed upstream)."""
    name = name.lower()
    from repro_torch.graph.datasets import REAL_DATASETS, load_dataset
    if name in REAL_DATASETS:
        if scale != 1.0:
            raise ValueError(
                f"data.scale={scale} is not applicable to the real "
                f"dataset {name!r} — real graphs cannot be resampled; "
                f"keep scale=1.0 (the *_real_tiny presets shrink the "
                f"recipe, not the data)")
        return load_dataset(name, cache_dir=cache_dir, mmap=mmap)
    if name == "ppi":  # multi-label, dense-ish
        return stochastic_block_model(SBMSpec(
            num_nodes=max(256, int(14_000 * scale)), num_communities=50,
            num_classes=121, feature_dim=50, avg_within_degree=24.0,
            avg_between_degree=4.0, multilabel=True, seed=seed))
    if name == "reddit":  # multi-class, high degree
        return stochastic_block_model(SBMSpec(
            num_nodes=max(256, int(58_000 * scale)), num_communities=300,
            num_classes=41, feature_dim=128, avg_within_degree=40.0,
            avg_between_degree=8.0, seed=seed))
    if name == "amazon2m":
        return copurchase_graph(CoPurchaseSpec(
            num_nodes=max(512, int(2_449_029 * scale)),
            num_communities=max(8, int(15000 * scale)),
            num_classes=47, feature_dim=100, avg_degree=25.0, seed=seed))
    if name == "cora":
        return stochastic_block_model(SBMSpec(
            num_nodes=max(256, int(2_708 * scale)), num_communities=10,
            num_classes=7, feature_dim=64, avg_within_degree=4.0,
            avg_between_degree=1.0, seed=seed))
    if name == "structural":
        # features are nearly pure noise (SNR ~1/16 per dim): a GCN can
        # only classify by aggregating neighborhoods — the regime where
        # batch edge-coverage (the paper's embedding utilization) decides
        # the outcome. Reproduces the paper's Table 2 gaps sharply.
        return stochastic_block_model(SBMSpec(
            num_nodes=max(512, int(4_000 * scale)), num_communities=40,
            num_classes=8, feature_dim=32, avg_within_degree=16.0,
            avg_between_degree=2.0, label_purity=1.0, feature_noise=16.0,
            seed=seed))
    raise ValueError(f"unknown dataset {name!r}")
