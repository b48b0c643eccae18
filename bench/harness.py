"""The benchmark's command line: find the cell, check the chips, point
every cache into the checkout, run the cell's driver, and print the
numbers compared beside their limits (last on standard error) and the
result line (last on standard output)."""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
from typing import Dict, List, Optional

from bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dir(root: pathlib.Path) -> pathlib.Path:
    return spec.bench_dir(root) / ".cache"


def point_caches(root: pathlib.Path) -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths, so that only a checkout's first run builds."""
    base = cache_dir(root)
    for var, sub in (("REPRO_TORCH_BUILD_DIR", "kernels"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("REPRO_DATASETS_CACHE", "datasets")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, or
    the JAX package's (compared whole: the port's name begins with it)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def run_cell(bm: Dict, name: str, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, root: pathlib.Path = spec.ROOT,
             fault: Optional[str] = None) -> Dict:
    """One run of cell `name` on `device` through its traffic's driver:
    the result line as a dict, with the numbers compared under
    "checks", last."""
    cell = spec.cell(bm, name, root)
    drv = spec.driver(root, cell["traffic"]["driver"])
    return drv.drive(bm, cell, seed=seed, seconds=seconds, trace=trace,
                     device=device, t_start=t_start, root=root,
                     cache=cache_dir(root), fault=fault)


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec.ROOT
    bm = spec.load(root)
    errs = spec.validate(bm, root)
    if errs:
        print("BENCHMARK.json is not sound:\n  " + "\n  ".join(errs),
              file=sys.stderr)
        return 2
    cell = spec.cell(bm, args.workload, root)
    point_caches(root)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 3
    result = run_cell(bm, args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=t_start, root=root)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print("\n".join(check_lines(result["checks"])), file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0
