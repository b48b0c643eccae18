"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `lib<name>-<hash>.so` under the build directory, then loaded with
ctypes: no PyTorch headers, so a build takes seconds. Builds happen at
first use (never at import, so CPU-only hosts import every module), are
keyed on the source's content, the `csrc/*.cuh` headers and the flags,
and are published by an atomic rename, so a stale or half-written
library is never loaded.

Build directory: $REPRO_TORCH_BUILD_DIR, else `build/` next to this file.
nvcc: $NVCC, else `nvcc` on PATH, else $CUDA_HOME/bin/nvcc (CUDA_HOME
defaults to /usr/local/cuda).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence

from repro_torch.runtime import trace

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("block_ell_spmm", "block_ell_spmm_fused", "block_ell_scatter",
           "flash_attention", "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    name: str
    path: pathlib.Path
    seconds: float    # the `setup.kernels` span of the build it was part
                      # of (the builds run together); 0 when cached
    log: str          # nvcc's output (ptxas register/spill report), kept
                      # beside the library and read back when cached
    cached: bool      # the library was already built from this source


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return (pathlib.Path(env) if env
            else pathlib.Path(__file__).resolve().parent / "build")


def nvcc_path() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built at first use and need the CUDA toolkit "
                       "(set $NVCC or $CUDA_HOME, or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    """Where the library of `csrc/<name>.cu` is built: keyed on that
    source, every header in `csrc/` (a source may include any of them)
    and the flags, so an edited header never reloads a stale build."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _log_path(lib: pathlib.Path) -> pathlib.Path:
    return lib.with_name(lib.name + ".log")


def build(names: Sequence[str] = SOURCES) -> List[BuildResult]:
    """Compile every library in `names` that is not built yet — one nvcc
    per source, all started together — and return what each took.
    Raises RuntimeError with nvcc's output when a build fails."""
    with trace.setup_span("setup.kernels") as sp:
        results = _build(names)
    return [r if r.cached else dataclasses.replace(r, seconds=sp.seconds)
            for r in results]


def _build(names: Sequence[str]) -> List[BuildResult]:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    results: List[BuildResult] = []
    running = []
    for name in names:
        path = library_path(name)
        if path.exists():
            log = _log_path(path)
            results.append(BuildResult(name, path, 0.0, log.read_text()
                                       if log.exists() else "", True))
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        trace.count("kernels.built")
        running.append((name, path, pathlib.Path(tmp), proc))
    failures = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}.cu "
                            f"(rc {proc.returncode}):\n{log}")
            continue
        _log_path(tmp).write_text(log)
        _log_path(tmp).replace(_log_path(path))
        tmp.replace(path)
        results.append(BuildResult(name, path, 0.0, log, False))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built first if
    needed. The caller declares argtypes/restype."""
    lib = _LOADED.get(name)
    if lib is None:
        with trace.setup_span("setup.kernels"):
            path = library_path(name)
            if not path.exists():
                _build([name])
            lib = ctypes.CDLL(str(path))
            trace.count("kernels.loaded")
        _LOADED[name] = lib
    return lib
