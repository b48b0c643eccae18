"""Cluster-GCN's insight transferred to LM data batching — a copy of
`repro.data.clustered_batching` (numpy only, so the port keeps its own).

The paper's core idea — construct batches that maximize *within-batch
reuse* by clustering — maps onto sequence batching: cluster documents by
content similarity (hashed n-gram features + k-means, the text analogue
of METIS on the doc-similarity graph) and draw each batch from q
clusters. Within-batch token/vocabulary locality improves embedding-
gradient sparsity and cache behaviour; the q>1 stochastic mixing is the
paper's §3.2 variance fix, verbatim.

Off by default; the reference demonstrates it in
examples/clustered_lm_batches.py.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


def ngram_features(docs: List[np.ndarray], dim: int = 256,
                   n: int = 1) -> np.ndarray:
    """Hashed n-gram count features, L2 normalized. docs: int token
    arrays. n=1 (hashed vocabulary histogram) separates topical content
    well; n=2 adds sequence structure but saturates small `dim`."""
    feats = np.zeros((len(docs), dim), np.float32)
    for i, d in enumerate(docs):
        if len(d) < n:
            continue
        if n == 1:
            grams = d.astype(np.int64) * 2_654_435_761
        else:
            grams = d[:-1].astype(np.int64) * 1_000_003 + d[1:]
        np.add.at(feats[i], grams % dim, 1.0)
        feats[i] /= max(1.0, np.linalg.norm(feats[i]))
    return feats


def kmeans(x: np.ndarray, k: int, iters: int = 25,
           seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    assign = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if (new == assign).all():
            break
        assign = new
        for c in range(len(centers)):
            sel = x[assign == c]
            if len(sel):
                centers[c] = sel.mean(0)
    return assign


@dataclasses.dataclass
class ClusteredBatcher:
    """Stochastic multiple partitions over document clusters:
    each batch = docs from q randomly chosen clusters (without
    replacement within an epoch), exactly Algorithm 1's loop."""
    docs: List[np.ndarray]
    num_clusters: int = 32
    clusters_per_batch: int = 4
    batch_docs: int = 32
    seed: int = 0

    def __post_init__(self):
        feats = ngram_features(self.docs)
        self.assign = kmeans(feats, self.num_clusters, seed=self.seed)
        self.members = [np.where(self.assign == c)[0]
                        for c in range(self.num_clusters)]

    def epoch(self, epoch_idx: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(self.num_clusters)
        q = self.clusters_per_batch
        for i in range(0, self.num_clusters - q + 1, q):
            pool = np.concatenate([self.members[c] for c in order[i:i + q]])
            rng.shuffle(pool)
            for j in range(0, len(pool) - self.batch_docs + 1,
                           self.batch_docs):
                yield pool[j:j + self.batch_docs]

    def within_batch_vocab_locality(self, batch_ids: np.ndarray) -> float:
        """Metric mirroring 'embedding utilization': mean pairwise vocab
        overlap (Jaccard) inside the batch."""
        sets = [set(np.unique(self.docs[i])) for i in batch_ids]
        tot, cnt = 0.0, 0
        for i in range(len(sets)):
            for j in range(i + 1, len(sets)):
                u = len(sets[i] | sets[j])
                tot += len(sets[i] & sets[j]) / max(u, 1)
                cnt += 1
        return tot / max(cnt, 1)
