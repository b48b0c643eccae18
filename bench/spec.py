"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix. The
harness finds everything else by those names, so a new configuration,
mix, cell or metric is a new file and a new entry, never an edit:

  configuration  the `file` of its `configs` entry (JSON)
  traffic mix    bench/traffic/<traffic>.json
  metric         bench/metrics/<metric name>.py, defining read(ctx)
  check limits   bench/limits/<cell name>.json
  driver         bench/drivers/<traffic's "driver">.py, defining drive()

`validate` checks the file against the benchmark contract's rules of
form (names, units, keys, lengths, references between entries) and
that every file above exists.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(text, limit=200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def load(root: pathlib.Path = ROOT) -> Dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def bench_dir(root: pathlib.Path = ROOT) -> pathlib.Path:
    return pathlib.Path(root) / "bench"


def traffic_path(root, traffic: str) -> pathlib.Path:
    return bench_dir(root) / "traffic" / f"{traffic}.json"


def metric_path(root, name: str) -> pathlib.Path:
    return bench_dir(root) / "metrics" / f"{name}.py"


def limits_path(root, cell: str) -> pathlib.Path:
    return bench_dir(root) / "limits" / f"{cell}.json"


def driver_path(root, driver: str) -> pathlib.Path:
    return bench_dir(root) / "drivers" / f"{driver}.py"


def validate(bm: Dict, root: pathlib.Path = ROOT) -> List[str]:
    """Every breach of the contract's rules of form, as messages (empty
    when the file is sound)."""
    root = pathlib.Path(root)
    errs: List[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    need(set(bm) == TOP_KEYS, f"top-level keys must be {sorted(TOP_KEYS)}")
    paths = bm.get("paths", [])
    need(isinstance(paths, list) and 1 <= len(paths) <= 16
         and all(isinstance(p, str) and PATH.match(p) and ".." not in p
                 and not p.startswith("/") for p in paths), "bad paths")
    cmd = bm.get("command", [])
    need(isinstance(cmd, list) and 1 <= len(cmd) <= 32
         and all(_line(w) for w in cmd), "bad command")
    rs = bm.get("run_seconds")
    need(isinstance(rs, int) and 1 <= rs <= 51, "run_seconds must be 1..51")

    def under_paths(p: str) -> bool:
        return any(p == d or p.startswith(d.rstrip("/") + "/") for d in paths)

    names_seen = set()
    configs = bm.get("configs", [])
    need(1 <= len(configs) <= 24, "1 to 24 configs")
    files = set()
    for c in configs:
        need(set(c) == {"name", "source", "file", "reduced", "why"},
             f"config keys: {sorted(c)}")
        need(NAME.match(str(c.get("name", ""))), f"config name {c.get('name')!r}")
        need(c.get("name") not in names_seen, f"duplicate name {c.get('name')}")
        names_seen.add(c.get("name"))
        need(_line(c.get("source")) and _line(c.get("why")),
             f"config {c.get('name')}: source/why")
        f = c.get("file", "")
        need(under_paths(f) and (root / f).is_file() and f not in files,
             f"config {c.get('name')}: file {f!r}")
        files.add(f)
        red = c.get("reduced", [])
        need(isinstance(red, list) and len(red) <= 16
             and all(NAME.match(k) for k in red), f"config {c.get('name')}: reduced")
    cfg_names = {c.get("name") for c in configs}

    cells = bm.get("workloads", [])
    need(1 <= len(cells) <= 24, "1 to 24 workloads")
    pairs = set()
    four = 0
    for w in cells:
        need(set(w) == {"name", "config", "traffic", "chips", "why"},
             f"workload keys: {sorted(w)}")
        name = str(w.get("name", ""))
        need(NAME.match(name) and name not in names_seen,
             f"workload name {name!r}")
        names_seen.add(name)
        need(w.get("config") in cfg_names, f"{name}: unknown config")
        need(NAME.match(str(w.get("traffic", ""))), f"{name}: traffic name")
        need(traffic_path(root, w.get("traffic", "")).is_file(),
             f"{name}: no traffic file")
        need(limits_path(root, name).is_file(), f"{name}: no limits file")
        need(w.get("chips") in (1, 4), f"{name}: chips must be 1 or 4")
        four += w.get("chips") == 4
        need(_line(w.get("why")), f"{name}: why")
        pair = (w.get("config"), w.get("traffic"))
        need(pair not in pairs, f"{name}: config and traffic pair repeats")
        pairs.add(pair)
        if traffic_path(root, w.get("traffic", "")).is_file():
            drv = json.loads(traffic_path(root, w["traffic"]).read_text())
            need(driver_path(root, str(drv.get("driver", ""))).is_file(),
                 f"{name}: no driver {drv.get('driver')!r}")
    need(four <= max(1, len(cells) // 4), "too many 4-chip cells")
    used = {w.get("config") for w in cells}
    need(cfg_names <= used, "a config is used by no cell")
    cell_names = {w.get("name") for w in cells}

    e2e = bm.get("end_to_end", [])
    need(1 <= len(e2e) <= 16, "1 to 16 end-to-end metrics")
    need(any(m.get("name") == "setup_s" for m in e2e), "setup_s is missing")
    for m in e2e:
        need(set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}, f"e2e keys: {sorted(m)}")
        b = m.get("bound")
        need(isinstance(b, (int, float)) and 0.01 <= b <= 0.25,
             f"{m.get('name')}: bound")
        need(m.get("source") in ("host_clock", "device_trace"),
             f"{m.get('name')}: e2e source")
    per = bm.get("per_layer", [])
    need(1 <= len(per) <= 128, "1 to 128 per-layer metrics")
    e2e_names = {m.get("name") for m in e2e}
    for m in per:
        need(set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"},
             f"per-layer keys: {sorted(m)}")
        need(_line(m.get("layer")), f"{m.get('name')}: layer")
        need(m.get("moves") in e2e_names, f"{m.get('name')}: moves")
        need(m.get("source") in SOURCES, f"{m.get('name')}: source")
    for m in e2e + per:
        name = str(m.get("name", ""))
        need(NAME.match(name) and name not in names_seen, f"metric {name!r}")
        names_seen.add(name)
        need(UNIT.match(str(m.get("unit", ""))), f"{name}: unit")
        need(m.get("better") in ("lower", "higher"), f"{name}: better")
        need(metric_path(root, name).is_file(), f"{name}: no reader file")
        wl = m.get("workloads")
        need(wl is None or (isinstance(wl, list) and wl
                            and set(wl) <= cell_names),
             f"{name}: workloads")
    need(len(json.dumps(bm)) <= 64 * 1024, "BENCHMARK.json over 64 KiB")
    return errs


def cell(bm: Dict, name: str, root: pathlib.Path = ROOT) -> Dict:
    """Everything a run of cell `name` needs, found by name."""
    root = pathlib.Path(root)
    work = next((w for w in bm["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {[w['name'] for w in bm['workloads']]})")
    conf = next(c for c in bm["configs"] if c["name"] == work["config"])
    return dict(workload=work, config_entry=conf,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads(traffic_path(root, work["traffic"])
                                   .read_text()),
                limits=json.loads(limits_path(root, name).read_text()))


def metrics_for(bm: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    without tracing, its per-layer metrics with."""
    group = bm["per_layer"] if trace else bm["end_to_end"]
    return [m for m in group
            if m.get("workloads") is None or cell_name in m["workloads"]]


def load_module(path: pathlib.Path, prefix: str):
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root, name: str):
    """The `read(ctx)` of metric `name` (bench/metrics/<name>.py)."""
    return load_module(metric_path(root, name), "bench_metric_").read


def driver(root, name: str):
    return load_module(driver_path(root, name), "bench_driver_")


def read_metric(read, ctx) -> Optional[float]:
    value = read(ctx)
    return None if value is None else float(value)
