"""The port's CUDA kernels on the GPU (marker `gpu`; skipped elsewhere).

Run on a machine with an sm_90 GPU and nvcc:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Imports only torch and the port, so it runs where JAX is not installed.
The kernel is held against its plain PyTorch version on the same CUDA
inputs at 1e-5·max(1, max|y_ref|) in fp32 and 8e-3·max(1, max|y_ref|)
in bf16, and the serving path against the host oracle.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 GPU")
    return torch.device("cuda")


def _operands(nrb, K, B, ncb, F, dtype, live, seed):
    g = torch.Generator().manual_seed(seed)
    blocks = torch.randn(nrb, K, B, B, generator=g)
    cols = torch.randint(0, ncb, (nrb, K), generator=g, dtype=torch.int32)
    x = torch.randn(ncb * B, F, generator=g)
    row_k = None
    if live:
        row_k = torch.randint(0, K + 1, (nrb,), generator=g,
                              dtype=torch.int32)
        row_k[0] = 0
        for i in range(nrb):
            blocks[i, int(row_k[i]):] = 0
            cols[i, int(row_k[i]):] = 0
    return blocks.to(dtype), cols, x.to(dtype), row_k


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F", [(8, 1), (16, 121), (128, 200)])
def test_kernel_matches_plain_version(cuda, B, F, dtype, live):
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_block_ell_ref
    blocks, cols, x, row_k = _operands(4, 5, B, 6, F, dtype, live, seed=B)
    args = [t.to(cuda) for t in (blocks, cols, x)]
    before = block_spmm.LAUNCHES
    y = block_spmm.spmm_block_ell(
        *args, row_k=None if row_k is None else row_k.to(cuda))
    torch.cuda.synchronize()
    assert block_spmm.LAUNCHES == before + 1
    want = spmm_block_ell_ref(*args).float()
    err = float((y.float() - want).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(want.abs().max()))


def test_kernel_rejects_out_of_range_columns(cuda):
    from repro_torch.kernels.block_spmm import spmm_block_ell
    blocks, cols, x, _ = _operands(2, 3, 16, 4, 8, torch.float32, False, 0)
    cols[1, 2] = 4
    with pytest.raises(ValueError, match="out of range"):
        spmm_block_ell(blocks.to(cuda), cols.to(cuda), x.to(cuda))


def test_serving_on_gpu_matches_host_oracle(cuda, tmp_path):
    from repro_torch.core.experiment import (build_gcn_config, build_graph,
                                             build_partition, preset)
    from repro_torch.core.gcn import init_gcn
    from repro_torch.core.trainer import full_graph_logits
    from repro_torch.graph.partition import partition_fingerprint
    from repro_torch.serve import EmbeddingCache, ServeEngine
    spec = preset("ppi_tiny")
    spec.partition.cache = False
    graph = build_graph(spec)
    parts, _ = build_partition(spec, graph)
    cfg = build_gcn_config(spec, graph)
    gcn = init_gcn(cfg, generator=torch.Generator().manual_seed(0),
                   device="cuda")
    cache = EmbeddingCache(tmp_path, checkpoint_step=0,
                           partition_fingerprint=partition_fingerprint(
                               graph, parts))
    eng = ServeEngine(gcn, graph, parts, cfg, cache=cache,
                      norm=spec.batch.norm)
    eng.warm()
    ids = np.arange(graph.num_nodes)
    got = eng.query(ids).logits
    want = full_graph_logits(eng.params, graph, cfg, norm=spec.batch.norm)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
