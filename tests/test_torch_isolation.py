"""`repro_torch` stands alone and never drifts to the CPU.

Every module imports with JAX blocked and the reference package off the
path; no source line imports either. Entry points default to CUDA and
raise on a host without a GPU unless the caller asks for the CPU."""
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\.)")
NEW_MODULES = ("repro_torch.models.gla", "repro_torch.launch.train",
               "repro_torch.data.tokens",
               "repro_torch.data.clustered_batching",
               "repro_torch.dist.sharding",
               "repro_torch.configs.xlstm_1_3b",
               "repro_torch.configs.zamba2_7b",
               "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
               "repro_torch.launch.dryrun_gcn",
               "repro_torch.launch.cost_analysis")


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    bad = [f"{p}:{i}: {line.strip()}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)]
    assert not bad, "\n".join(bad)


def test_every_module_imports_without_jax_or_the_reference(tmp_path):
    shutil.copytree(PORT, tmp_path / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["repro"] = None        # and so does the reference
        sys.path = [{str(tmp_path)!r}] + [p for p in sys.path
                                          if "src" not in p]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in {NEW_MODULES!r}:         # the LM training slice's
            assert name in names, name
        loaded = [m for m in sys.modules
                  if (m == "jax" or m.startswith(("jax.", "repro.")))
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 25     # every module was walked


def test_importing_the_dry_runs_starts_no_process_group():
    """The dry-runs join a fake process group in `main()`, never at
    import: importing them leaves torch.distributed untouched."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch.distributed as dist
        import repro_torch.launch.dryrun, repro_torch.launch.dryrun_gcn
        import repro_torch.launch.cost_analysis, repro_torch.launch.mesh
        assert not dist.is_initialized()
        assert "torch.testing._internal.distributed.fake_pg" \
            not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", \
        out.stderr[-3000:]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")


def _tiny_engine_args(tmp_path):
    from repro_torch.core.experiment import (build_gcn_config, build_graph,
                                             build_partition, preset)
    from repro_torch.core.gcn import init_gcn
    from repro_torch.graph.partition import partition_fingerprint
    from repro_torch.serve import EmbeddingCache
    spec = preset("ppi_tiny")
    graph = build_graph(spec)
    parts, _ = build_partition(spec, graph)
    cfg = build_gcn_config(spec, graph)
    gcn = init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    cache = EmbeddingCache(tmp_path, checkpoint_step=0,
                           partition_fingerprint=partition_fingerprint(
                               graph, parts))
    return gcn, graph, parts, cfg, cache


def test_serve_engine_defaults_to_cuda_and_raises_without_gpu(no_gpu,
                                                              tmp_path):
    from repro_torch.serve import ServeEngine
    gcn, graph, parts, cfg, cache = _tiny_engine_args(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServeEngine(gcn, graph, parts, cfg, cache=cache)
    eng = ServeEngine(gcn, graph, parts, cfg, cache=cache, device="cpu")
    assert eng.device.type == "cpu"


def test_from_checkpoint_raises_without_gpu(no_gpu, tmp_path):
    from repro_torch.core.experiment import preset
    from repro_torch.serve import ServeEngine
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServeEngine.from_checkpoint(preset("ppi_tiny"), str(tmp_path))


def test_serve_gcn_defaults_to_cuda_and_exits_without_gpu(no_gpu,
                                                          tmp_path):
    from repro_torch.launch import serve_gcn
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        serve_gcn.main(["--preset", "ppi_tiny",
                        "--checkpoint-dir", str(tmp_path)])


@pytest.mark.parametrize("what", ["init_gcn", "params_from_numpy",
                                  "restore"])
def test_explicit_cuda_raises_without_gpu(no_gpu, tmp_path, what):
    from repro_torch.core.gcn import GCNConfig, init_gcn, params_from_numpy
    from repro_torch.runtime.checkpoint import CheckpointManager
    cfg = GCNConfig(in_dim=3, hidden_dim=4, out_dim=2, num_layers=2)
    tree = {"w": np.ones((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        if what == "init_gcn":
            init_gcn(cfg, generator=torch.Generator(), device="cuda")
        elif what == "params_from_numpy":
            params_from_numpy({"layers": [{"w": np.ones((3, 2)),
                                           "b": np.zeros(2)}]}, "cuda")
        else:
            m = CheckpointManager(str(tmp_path))
            m.save(1, {"params": tree})
            m.restore_params(tree, device="cuda")
