"""The benchmark's graphs: a frozen numpy copy of the port's
stochastic-block-model generator (`repro_torch.graph.generators.
stochastic_block_model` with `CSRGraph.from_edges`), so that a change to
the program's generator never changes the yardstick's inputs.

`make_graph(params)` returns plain numpy arrays (indptr, indices,
features, labels, train/val/test masks) that the harness hands to the
port (as its `CSRGraph`) and to the reference alike. `load_or_make`
caches them under the checkout, keyed by the parameters' content, so
only the first run of a configuration in a checkout generates.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
from typing import Dict

import numpy as np

# bumped whenever the arrays for a given parameter set would change
GENERATOR_VERSION = 1

# the SBM parameters a configuration's "graph" section may set, with
# the port's SBMSpec defaults
DEFAULTS = dict(num_nodes=10_000, num_communities=50, num_classes=10,
                feature_dim=64, avg_within_degree=12.0,
                avg_between_degree=2.0, label_purity=0.85,
                feature_noise=1.0, multilabel=False, train_frac=0.66,
                val_frac=0.12, seed=0)

ARRAYS = ("indptr", "indices", "features", "labels", "train_mask",
          "val_mask", "test_mask")


def _params(graph: dict) -> dict:
    unknown = set(graph) - set(DEFAULTS) - {"generator"}
    if unknown:
        raise ValueError(f"unknown graph parameter(s) {sorted(unknown)}")
    if graph.get("generator", "sbm") != "sbm":
        raise ValueError(f"unknown generator {graph['generator']!r}")
    return {**DEFAULTS, **{k: v for k, v in graph.items()
                           if k != "generator"}}


def _group_members(labels: np.ndarray, k: int):
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(k + 1))
    return [order[bounds[c]:bounds[c + 1]] for c in range(k)]


def _sample_block_edges(rng, rows, cols, n_edges):
    if n_edges <= 0 or len(rows) == 0 or len(cols) == 0:
        return (np.empty(0, np.int64),) * 2
    src = rows[rng.integers(0, len(rows), size=n_edges)]
    dst = cols[rng.integers(0, len(cols), size=n_edges)]
    return src, dst


def _csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray):
    """Undirected CSR without self loops or duplicate edges."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = np.unique(src * n + dst)
    src = key // n
    dst = (key % n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr), dst


def make_graph(graph: dict) -> Dict[str, np.ndarray]:
    """SBM with community-correlated labels and label-correlated
    features, drawn from `graph["seed"]` alone."""
    p = _params(graph)
    rng = np.random.default_rng(p["seed"])
    n, k = int(p["num_nodes"]), int(p["num_communities"])
    comm = rng.integers(0, k, size=n)
    order = np.argsort(comm, kind="stable")
    comm = comm[order]
    perm = rng.permutation(n)
    comm = comm[np.argsort(perm)]
    members = _group_members(comm, k)

    srcs, dsts = [], []
    for c in range(k):
        m = members[c]
        ne = int(len(m) * p["avg_within_degree"] / 2)
        s, d = _sample_block_edges(rng, m, m, ne)
        srcs.append(s)
        dsts.append(d)
    ne_between = int(n * p["avg_between_degree"] / 2)
    s = rng.integers(0, n, size=ne_between * 2)
    d = rng.integers(0, n, size=ne_between * 2)
    cross = comm[s] != comm[d]
    srcs.append(s[cross][:ne_between])
    dsts.append(d[cross][:ne_between])
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)

    classes, fdim = int(p["num_classes"]), int(p["feature_dim"])
    dom = rng.integers(0, classes, size=k)
    labels = dom[comm].astype(np.int32)
    flip = rng.random(n) > p["label_purity"]
    labels[flip] = rng.integers(0, classes, size=int(flip.sum()))
    centroids = rng.normal(size=(classes, fdim)).astype(np.float32)
    feats = centroids[labels] + p["feature_noise"] * rng.normal(
        size=(n, fdim)).astype(np.float32)
    if p["multilabel"]:
        y = np.zeros((n, classes), np.float32)
        y[np.arange(n), labels] = 1.0
        extra = rng.random((n, classes)) < 0.08
        labels = np.maximum(y, extra.astype(np.float32))
    u = rng.random(n)
    train = u < p["train_frac"]
    val = (u >= p["train_frac"]) & (u < p["train_frac"] + p["val_frac"])
    indptr, indices = _csr_from_edges(n, src, dst)
    return dict(indptr=indptr, indices=indices,
                features=np.ascontiguousarray(feats, dtype=np.float32),
                labels=labels, train_mask=train, val_mask=val,
                test_mask=~(train | val))


def graph_key(graph: dict) -> str:
    blob = json.dumps({"v": GENERATOR_VERSION, "p": _params(graph)},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def load_or_make(graph: dict, cache_dir) -> Dict[str, np.ndarray]:
    """The graph of `graph`'s parameters, from `cache_dir` when a run
    in this checkout already made it; otherwise made and stored there
    (written under a temporary name, then renamed)."""
    cache_dir = pathlib.Path(cache_dir)
    path = cache_dir / f"graph-{graph_key(graph)}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return {name: z[name] for name in ARRAYS}
    arrays = make_graph(graph)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)
    return arrays
