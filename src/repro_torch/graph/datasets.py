"""Dataset cache root and the real-dataset name registry.

The port's counterpart of `repro.graph.datasets`, cut to what serving
needs: the cache root (shared with the reference through the same
$REPRO_DATASETS_CACHE variable, so one setting relocates datasets,
partitions and serving state of both packages) and the names of the
real benchmark graphs. Downloading, checksums and the mmap'd processed
cache come with the real-datasets slice of the port; until then
`make_dataset` raises NotImplementedError for these names.
"""
from __future__ import annotations

import os
import pathlib
from typing import Dict


def cache_root() -> pathlib.Path:
    """Dataset cache root: $REPRO_DATASETS_CACHE or ~/.cache/repro-datasets."""
    env = os.environ.get("REPRO_DATASETS_CACHE")
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path.home() / ".cache" / "repro-datasets"


def default_serving_cache_dir() -> pathlib.Path:
    """Per-cluster serving embedding caches (repro_torch.serve) share the
    dataset cache root, so one env var ($REPRO_DATASETS_CACHE)
    relocates datasets, partitions and serving state together."""
    return cache_root() / "serving"


# name -> what the dataset is (the reference registry's `notes`)
REAL_DATASETS: Dict[str, str] = {
    "ppi_real": "GraphSAGE PPI, 56944 nodes, 121 labels (multilabel), "
                "paper Table 4 / §4.3",
    "reddit_real": "DGL Reddit, 232965 nodes, 41 classes, paper Table 4",
    "ogbn_arxiv": "OGB arxiv citation graph, 169343 nodes, 40 classes",
    "ogbn_products": "OGB products co-purchase graph, 2.4M nodes — the "
                     "modern public stand-in for the paper's (unreleased) "
                     "Amazon2M",
}
