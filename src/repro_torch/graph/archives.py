"""Seeded archives in the real datasets' on-disk formats.

Neither the test hosts nor the GPU host can download the real
benchmarks, so the real-dataset path (`repro_torch.graph.datasets`:
fetch → checksum → extract → parse → processed cache → mmap) is driven
by archives written here from a seed and served through
$REPRO_DATASETS_MIRROR as a `file://` directory. Sizes are parameters;
the defaults are GraphSAGE PPI's published ones, so the whole pipeline
and the training that follows run at the real graph's scale. Links,
features and labels are random: no accuracy measured on them means
anything.
"""
from __future__ import annotations

import io
import json
import pathlib
import zipfile
from typing import Dict

import numpy as np

# GraphSAGE PPI (Hamilton et al. 2017): 24 protein graphs, 20 for
# training, 2 for validation, 2 for testing
PPI_NODES = 56_944
PPI_LINKS = 818_716
PPI_FEATURES = 50
PPI_LABELS = 121
PPI_VAL = 6_514
PPI_TEST = 5_524
PPI_GRAPHS = 24


def write_graphsage_ppi(path: pathlib.Path, *, num_nodes: int = PPI_NODES,
                        num_links: int = PPI_LINKS,
                        feature_dim: int = PPI_FEATURES,
                        num_labels: int = PPI_LABELS, val: int = PPI_VAL,
                        test: int = PPI_TEST, num_graphs: int = PPI_GRAPHS,
                        label_rate: float = 0.3,
                        seed: int = 0) -> Dict[str, int]:
    """Write `path` (ppi.zip) in GraphSAGE's layout: ppi-G.json (a
    node_link graph whose nodes carry the val/test flags), ppi-feats.npy
    (N, F) float32, ppi-class_map.json (id → multilabel list) and
    ppi-id_map.json (id → row). As in the real PPI the nodes form
    `num_graphs` disjoint graphs and the splits are whole graphs: the
    training nodes first, then `val`, then `test` nodes, each split cut
    into contiguous graphs (two each for val and test, the rest for
    training). Links are drawn uniformly within each graph, in
    proportion to its size (self-loops and duplicates are dropped by the
    parser's CSR build, as the real file's would be). Returns the counts
    written."""
    train = num_nodes - val - test
    if train < 1 or val < 1 or test < 1 or num_graphs < 5:
        raise ValueError(f"need train, val and test nodes and >= 5 graphs; "
                         f"got {num_nodes} nodes, val {val}, test {test}, "
                         f"{num_graphs} graphs")
    rng = np.random.default_rng(seed)
    bounds = np.concatenate([
        np.linspace(0, train, num_graphs - 3, dtype=np.int64),
        np.linspace(train, train + val, 3, dtype=np.int64)[1:],
        np.linspace(train + val, num_nodes, 3, dtype=np.int64)[1:]])
    sizes = np.diff(bounds)
    per_graph = rng.multinomial(num_links, sizes / sizes.sum())
    src, dst = [], []
    for lo, size, k in zip(bounds[:-1], sizes, per_graph):
        src.append(lo + rng.integers(0, size, k))
        dst.append(lo + rng.integers(0, size, k))
    src, dst = np.concatenate(src), np.concatenate(dst)
    flags = [(i >= train and i < train + val, i >= train + val)
             for i in range(num_nodes)]
    nodes = ",".join(
        f'{{"id": {i}, "val": {"true" if v else "false"}, '
        f'"test": {"true" if t else "false"}}}'
        for i, (v, t) in enumerate(flags))
    links = ",".join(f'{{"source": {s}, "target": {d}}}'
                     for s, d in zip(src.tolist(), dst.tolist()))
    graph_json = ('{"directed": false, "multigraph": false, "graph": {}, '
                  f'"nodes": [{nodes}], "links": [{links}]}}')
    labels = (rng.random((num_nodes, num_labels)) < label_rate)
    class_map = "{" + ",".join(
        f'"{i}": [{",".join("1" if x else "0" for x in row)}]'
        for i, row in enumerate(labels.tolist())) + "}"
    feats = rng.normal(size=(num_nodes, feature_dim)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, feats)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ppi-G.json", graph_json)
        z.writestr("ppi-id_map.json",
                   json.dumps({str(i): i for i in range(num_nodes)}))
        z.writestr("ppi-class_map.json", class_map)
        z.writestr("ppi-feats.npy", buf.getvalue())
    return {"nodes": num_nodes, "links": int(len(src)), "train": train,
            "val": val, "test": test, "graphs": num_graphs,
            "features": feature_dim, "labels": num_labels}
