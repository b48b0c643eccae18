"""Driven by data: a new configuration, traffic mix, cell and metric
are new files and new entries, found by name, with no existing file
edited; and every name and unit keeps to the allowed characters."""
import hashlib
import json
import re

import pytest

from conftest import ROOT, add_tiny_cells, copy_benchmark, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing_any(tmp_path):
    from bench import spec
    root = copy_benchmark(tmp_path / "checkout")
    add_tiny_cells(root)
    before = _digests(root)
    bm = json.loads((root / "BENCHMARK.json").read_text())
    # a traffic mix: the same driver, another prefetch depth
    mix = json.loads((root / "bench/traffic/cluster_train.json").read_text())
    mix["set"]["execution.prefetch"] = 1
    (root / "bench/traffic/cluster_train_p1.json").write_text(json.dumps(mix))
    # a configuration: a third tiny recipe
    conf = json.loads((root / "bench/configs/tiny_mc.json").read_text())
    conf["set"]["model.num_layers"] = 2
    (root / "bench/configs/tiny_two.json").write_text(json.dumps(conf))
    bm["configs"].append({"name": "tiny_two", "source": "a CPU test size",
                          "file": "bench/configs/tiny_two.json",
                          "reduced": [], "why": "two layers"})
    # a cell and its limits
    bm["workloads"].append({"name": "tiny_two.p1", "config": "tiny_two",
                            "traffic": "cluster_train_p1", "chips": 1,
                            "why": "prefetch 1"})
    (root / "bench/limits/tiny_two.p1.json").write_text(
        (root / "bench/limits/tiny_mc.train.json").read_text())
    # a per-layer metric with its reader
    (root / "bench/metrics/nodes_per_step.py").write_text(
        "def read(ctx):\n"
        "    steps = len(ctx.step_intervals_ms)\n"
        "    return ctx.window_nodes / steps if steps else None\n")
    bm["per_layer"].append({"name": "nodes_per_step", "unit": "nodes",
                            "better": "higher", "source": "program_counter",
                            "layer": "host batching",
                            "moves": "train_nodes_per_s",
                            "workloads": ["tiny_two.p1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))

    assert spec.validate(bm, root) == []
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (
            root / "bench/traffic/cluster_train_p1.json",
            root / "bench/configs/tiny_two.json",
            root / "bench/limits/tiny_two.p1.json",
            root / "bench/metrics/nodes_per_step.py")}
    cell = spec.cell(bm, "tiny_two.p1", root)
    assert cell["traffic"]["set"]["execution.prefetch"] == 1
    r = run_tiny(root, "tiny_two.p1", trace=True, seconds=4.0)
    assert r["correct"], r["checks"]
    assert r["metrics"]["nodes_per_step"]["value"] > 0
    r0 = run_tiny(root, "tiny_two.p1", trace=False)
    assert set(r0["metrics"]) == {"train_nodes_per_s", "setup_s"}


def _names_units(bm):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bm[group]:
            yield "name", e["name"]
            if "unit" in e:
                yield "unit", e["unit"]
            for key in ("config", "traffic"):
                if key in e:
                    yield "name", e[key]
            for key in e.get("reduced", []):
                yield "name", key


def test_names_and_units_keep_to_the_allowed_characters():
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind, value in _names_units(bm):
        assert (NAME if kind == "name" else UNIT).match(value), value
    for path in (ROOT / "bench").rglob("*"):
        rel = path.relative_to(ROOT / "bench").as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("bad", [
    ("workloads", 0, "name", "ppi sota"),
    ("end_to_end", 0, "unit", "nodes per second"),
    ("per_layer", 0, "layer", "two\nlines"),
    ("end_to_end", 0, "bound", 0.3),
    ("per_layer", 0, "moves", "no_such_metric"),
])
def test_a_breach_is_refused(bad):
    from bench import spec
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    group, i, key, value = bad
    bm[group][i][key] = value
    assert spec.validate(bm, ROOT)
