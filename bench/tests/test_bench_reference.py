"""The reference against the port at tiny sizes on the CPU, the frozen
generator, and the benchmark's isolation from JAX and the JAX
package."""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, TINY, run_tiny

CELLS = [f"{name}.train" for name in TINY]


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(tiny_root, cell):
    r = run_tiny(tiny_root, cell, seed=2 ** 33 + 5)
    assert r["correct"], r["checks"]
    assert r["checks"]["batch_rows_off"]["value"] == 0
    assert r["checks"]["adj_gap"]["value"] <= 1e-6
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_trace_run_reads_host_metrics(tiny_root, cell):
    # long enough that steps follow the profiled epochs on a busy host
    r = run_tiny(tiny_root, cell, trace=True, seconds=4.0)
    assert r["correct"], r["checks"]
    for name in ("batch_build_ms", "payload_mib", "step_host_ms"):
        assert r["metrics"][name]["value"] > 0
    # device metrics are never read from a CPU run
    assert "train_mfu" not in r["metrics"]
    assert "device_idle_share" not in r["metrics"]


def test_generator_reproduces_itself():
    from bench.graphs.sbm import make_graph
    p = dict(TINY["tiny_ml"]["graph"])
    a, b = make_graph(p), make_graph(p)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    c = make_graph(dict(p, seed=p["seed"] + 1))
    assert not np.array_equal(a["indices"], c["indices"])


def test_generator_is_the_ports():
    from repro_torch.graph.generators import SBMSpec, stochastic_block_model

    from bench.graphs.sbm import make_graph
    for p in (TINY["tiny_ml"]["graph"], TINY["tiny_mc"]["graph"]):
        ours = make_graph(p)
        theirs = stochastic_block_model(SBMSpec(**p))
        for k, v in ours.items():
            assert np.array_equal(v, getattr(theirs, k)), k


def test_graph_cache_round_trip(tmp_path):
    from bench.graphs import sbm
    p = dict(TINY["tiny_mc"]["graph"], generator="sbm")
    made = sbm.load_or_make(p, tmp_path)
    (path,) = tmp_path.glob("graph-*.npz")
    loaded = sbm.load_or_make(p, tmp_path)
    assert path.name == f"graph-{sbm.graph_key(p)}.npz"
    for k in made:
        assert np.array_equal(made[k], loaded[k])


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if path.parent.name == "tests":
            continue
        # nothing the benchmark runs reads the JAX package's records
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_a_run_loads_no_jax(tiny_root):
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'bench/tests')!r}]
from conftest import run_tiny
from bench import harness
r = run_tiny(__import__('pathlib').Path({str(tiny_root)!r}), 'tiny_mc.train')
print(r['correct'], harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_forbidden_names_compare_whole_top_level(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro_torchlike_probe", object())
    assert "repro_torchlike_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.probe", object())
    assert "repro.probe" in harness.forbidden_modules()


def test_benchmark_file_is_sound():
    from bench import spec
    assert spec.validate(spec.load(ROOT), ROOT) == []
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bm["paths"] == ["bench"]


def _step_run(grads, change):
    import types

    import torch
    zeros = {k: torch.zeros_like(v) for k, v in change.items()}
    return types.SimpleNamespace(losses=[1.0], grads1=grads, params0=zeros,
                                 params_last=change)


@pytest.mark.parametrize("fault", ["reversed", "unmoved"])
def test_worst_leaf_numbers_catch_one_leaf(fault):
    """A fault in one leaf of six: the medians pass it; a gradient of the
    right size pointing the other way reads in grad_cos_gap, a leaf left
    unmoved in leaf_gap."""
    import torch

    from bench.reference import check
    g = torch.Generator().manual_seed(0)
    leaves = {f"layers.{i}.w": torch.randn(8, 8, generator=g)
              for i in range(6)}
    ref = _step_run(leaves, {k: -0.01 * torch.sign(v)
                             for k, v in leaves.items()})
    grads = dict(leaves)
    change = dict(ref.params_last)
    if fault == "reversed":
        grads["layers.5.w"] = -grads["layers.5.w"]
    else:
        change["layers.5.w"] = torch.zeros(8, 8)
    b1 = 0.9
    prog = dict(losses=[1.0], mu1={k: v * (1 - b1) for k, v in grads.items()},
                params0=ref.params0, params_last=change)
    nums = check.step_numbers(prog, ref, b1)
    assert nums["grad_gap"] < 1e-6 and nums["update_gap"] < 1e-6
    if fault == "reversed":
        assert nums["grad_cos_gap"] == pytest.approx(2.0)
        assert nums["leaf_gap"] < 1e-6
    else:
        assert nums["leaf_gap"] == pytest.approx(1.0)
        assert nums["grad_cos_gap"] < 1e-6
