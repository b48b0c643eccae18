"""Shared set-up of the benchmark's CPU tests (run with
`python -m pytest bench/tests`; the repository's own suite, whose
testpaths is tests/, does not collect them).

`tiny_root` is a copy of the benchmark (BENCHMARK.json and bench/) with
two tiny cells added as new files only: the same recipes' shapes of
work (multi-label Eq. 11 with the fused kernel path, multiclass Eq. 10
over unions of clusters) at sizes a CPU runs in seconds."""
from __future__ import annotations

import copy
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny_ml": dict(
        preset="ppi_sota",
        graph=dict(num_nodes=640, num_communities=8, num_classes=7,
                   feature_dim=12, avg_within_degree=10.0,
                   avg_between_degree=2.0, multilabel=True, seed=3),
        set={"partition.num_parts": 6, "batch.clusters_per_batch": 1,
             "batch.norm": "eq11", "batch.diag_lambda": 1.0,
             "model.hidden_dim": 32, "model.num_layers": 3,
             "model.dropout": 0.1, "model.multilabel": True}),
    "tiny_mc": dict(
        preset="reddit",
        graph=dict(num_nodes=900, num_communities=12, num_classes=5,
                   feature_dim=16, avg_within_degree=14.0,
                   avg_between_degree=3.0, multilabel=False, seed=4),
        set={"partition.num_parts": 9, "batch.clusters_per_batch": 3,
             "batch.norm": "eq10", "batch.diag_lambda": 0.0,
             "model.hidden_dim": 24, "model.num_layers": 3,
             "model.dropout": 0.2, "model.multilabel": False}),
}
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "update_gap": 1e-4,
               "leaf_gap": 1e-2, "grad_cos_gap": 1e-4, "adj_gap": 1e-6,
               "batch_rows_off": 0, "partition_vs_chance": 0.5}


def copy_benchmark(dest: pathlib.Path) -> pathlib.Path:
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return dest


def add_tiny_cells(root: pathlib.Path) -> None:
    """New files and entries only: a configuration, a cell and a limits
    file for each tiny recipe."""
    bm = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "bench/configs/ppi_sota.json").read_text())
    for name, t in TINY.items():
        conf = copy.deepcopy(base)
        conf["preset"] = t["preset"]
        conf["graph"] = dict(generator="sbm", **t["graph"])
        conf["set"].update(t["set"])
        conf.pop("published")
        (root / f"bench/configs/{name}.json").write_text(json.dumps(conf))
        bm["configs"].append({"name": name, "source": "a CPU test size",
                              "file": f"bench/configs/{name}.json",
                              "reduced": ["graph"], "why": "CPU tests"})
        cell = f"{name}.train"
        bm["workloads"].append({"name": cell, "config": name,
                                "traffic": "cluster_train", "chips": 1,
                                "why": "CPU tests"})
        (root / f"bench/limits/{cell}.json").write_text(
            json.dumps(TINY_LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(bm, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    root = copy_benchmark(tmp_path_factory.mktemp("checkout"))
    add_tiny_cells(root)
    return root


def run_tiny(root, cell, *, seed=7, seconds=0.6, trace=False, fault=None):
    import time

    from bench import harness, spec
    bm = spec.load(root)
    return harness.run_cell(bm, cell, seed=seed, seconds=seconds,
                            trace=trace, device="cpu",
                            t_start=time.perf_counter(), root=root,
                            fault=fault)
