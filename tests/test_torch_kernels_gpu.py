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


# ----------------------------------------------------------------------
# the fused kernel y = Â·(XW + b) and the differentiable products
# ----------------------------------------------------------------------
def _fused_operands(nrb, K, B, ncb, D, F, dtype, live, seed):
    blocks, cols, _, row_k = _operands(nrb, K, B, ncb, 1, dtype, live, seed)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(ncb * B, D, generator=g).to(dtype)
    w = (torch.randn(D, F, generator=g) / max(1, D) ** 0.5).to(dtype)
    b = torch.randn(F, generator=g)
    return blocks, cols, x, w, b, row_k


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,F", [(8, 1, 121), (16, 121, 1),
                                   (128, 50, 200), (200, 33, 70)])
def test_fused_kernel_matches_plain_version(cuda, B, D, F, dtype, live):
    """B 200 runs two 128-row output tiles per row-block and needs more
    than 48 KB of shared memory (the opt-in attribute path)."""
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_fused_ref
    blocks, cols, x, w, b, row_k = _fused_operands(3, 4, B, 5, D, F, dtype,
                                                   live, seed=B + D)
    args = [t.to(cuda) for t in (blocks, cols, x, w, b)]
    rk = None if row_k is None else row_k.to(cuda)
    before = block_spmm.LAUNCHES_FUSED
    y = block_spmm.spmm_fused_block_ell(*args, row_k=rk)
    torch.cuda.synchronize()
    assert block_spmm.LAUNCHES_FUSED == before + 1
    want = spmm_fused_ref(*args).float()
    err = float((y.float() - want).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(want.abs().max()))


def test_fused_kernel_rejects_out_of_range_columns(cuda):
    from repro_torch.kernels.block_spmm import spmm_fused_block_ell
    blocks, cols, x, w, b, _ = _fused_operands(2, 3, 16, 4, 8, 8,
                                               torch.float32, False, 0)
    cols[1, 2] = 4
    with pytest.raises(ValueError, match="out of range"):
        spmm_fused_block_ell(*(t.to(cuda) for t in (blocks, cols, x, w, b)))


def test_block_ell_adj_checks_columns_when_built_on_the_gpu(cuda):
    from repro_torch.kernels.block_spmm import BlockEllAdj
    blocks, cols, _, _ = _operands(2, 3, 8, 2, 1, torch.float32, False, 0)
    cols[0, 0] = 2                   # only 2 column blocks (blocks_t rows)
    with pytest.raises(ValueError, match="out of range"):
        BlockEllAdj(blocks.to(cuda), cols.to(cuda), blocks[:2].to(cuda),
                    torch.zeros(2, 3, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_differentiable_products_on_gpu_match_cpu(cuda, fused, dtype):
    """`spmm_ell` / `spmm_fused` forward and backward on CUDA (kernels)
    against the same on the CPU (plain versions). fp32: 1e-4·max(1,
    max|ref|) (other summation orders, two chained products); bf16:
    2e-2·max(1, max|ref|) (several bf16 roundings of intermediates)."""
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ops import block_ell_adj_from_dense
    rng = np.random.default_rng(3)
    B, n, D, F = 16, 80, 24, 40
    dense = (rng.random((n, n)) < 0.05) * rng.normal(size=(n, n))
    adj = block_ell_adj_from_dense(dense.astype(np.float32), B)
    x0 = rng.normal(size=(adj.blocks_t.shape[0] * B, D)).astype(np.float32)
    w0 = (rng.normal(size=(D, F)) / D ** 0.5).astype(np.float32)
    b0 = rng.normal(size=F).astype(np.float32)
    gy = rng.normal(size=(adj.blocks.shape[0] * B,
                          F if fused else D)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        a = adj.to(dev)
        x = torch.from_numpy(x0).to(dev, dtype).requires_grad_()
        w = torch.from_numpy(w0).to(dev).requires_grad_()
        b = torch.from_numpy(b0).to(dev).requires_grad_()
        before = (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED)
        y = (block_spmm.spmm_fused(a, x, w, b) if fused
             else block_spmm.spmm_ell(a, x))
        y.backward(torch.from_numpy(gy).to(dev, dtype))
        launched = (block_spmm.LAUNCHES - before[0],
                    block_spmm.LAUNCHES_FUSED - before[1])
        grads = [x.grad] + ([w.grad, b.grad] if fused else [])
        out[str(dev)] = ([y] + grads, launched)
    assert out["cpu"][1] == (0, 0)
    assert out["cuda"][1] == ((1, 1) if fused else (2, 0))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        want = want.detach().float()
        err = float((got.detach().float().cpu() - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max()))
