"""The port's CUDA kernels on the GPU (marker `gpu`; skipped elsewhere).

Run on a machine with an sm_90 GPU and nvcc:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Imports only torch and the port, so it runs where JAX is not installed.
The kernel is held against its plain PyTorch version on the same CUDA
inputs at 1e-5·max(1, max|y_ref|) in fp32 and 8e-3·max(1, max|y_ref|)
in bf16, and the serving paths against the host oracle (GCN) and the
CPU's plain versions (LM).
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


# ----------------------------------------------------------------------
# flash attention and the LM serving path
# ----------------------------------------------------------------------
_ATTN = [dict(causal=True), dict(causal=False), dict(causal=True, window=17),
         dict(causal=True, softcap=30.0)]


@pytest.mark.parametrize("kw", _ATTN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", [
    (2, 4, 1, 100, 100, 16), (1, 8, 2, 1, 96, 64), (1, 4, 2, 96, 64, 80),
    (1, 2, 2, 130, 130, 128), (1, 2, 1, 70, 70, 256)])
def test_flash_kernel_matches_plain_version(cuda, kw, dtype, B, Hq, Hkv, Tq,
                                            Tk, D):
    """Ragged T, decode-style Tq 1, Tq > Tk (rows that see no key give 0),
    D 16..256 (D 256 needs the opt-in shared memory), GQA 4/1 and 4/2."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import multi_head_attention_ref
    g = torch.Generator().manual_seed(Tq + D)
    q = torch.randn(B, Hq, Tq, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Hkv, Tk, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Hkv, Tk, D, generator=g).to(dtype).to(cuda)
    before = fa.LAUNCHES
    y = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = multi_head_attention_ref(q, k, v, **kw).float()
    err = float((y.float() - want).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(want.abs().max()))


def test_flash_kernel_reads_strided_views(cuda):
    """The model passes transposed (B, T, H, D) views; the kernel reads
    them through their strides."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 77, 8, 64, generator=g).bfloat16().to(cuda)
    kv = torch.randn(2, 77, 2, 64, generator=g).bfloat16().to(cuda)
    got = fa.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                             kv.transpose(1, 2))
    want = fa.flash_attention(x.transpose(1, 2).contiguous(),
                              kv.transpose(1, 2).contiguous(),
                              kv.transpose(1, 2).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=200, softcap=30.0)])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", [
    (2, 8, 2, 300, 300, 64), (1, 4, 1, 200, 333, 128),
    (1, 4, 2, 333, 200, 256), (1, 4, 1, 129, 129, 80)])
def test_sm90_kernel_matches_plain_version(cuda, B, Hq, Hkv, Tq, Tk, D, kw,
                                           strided):
    """The bf16 wgmma/TMA kernel at each D bucket (64, 128, 256; 80 pads
    to 128), ragged Tq and Tk (Tq > Tk: rows that see no key give 0),
    contiguous and as transposed (B, T, H, D) views."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import multi_head_attention_ref
    g = torch.Generator().manual_seed(Tq + Tk + D)
    ops = []
    for H, T in ((Hq, Tq), (Hkv, Tk), (Hkv, Tk)):
        shape = (B, T, H, D) if strided else (B, H, T, D)
        x = torch.randn(*shape, generator=g).bfloat16().to(cuda)
        ops.append(x.transpose(1, 2) if strided else x)
    before = fa.LAUNCHES_SM90
    y = fa.flash_attention(*ops, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_SM90 == before + 1
    want = multi_head_attention_ref(*ops, **kw).float()
    err = float((y.float() - want).abs().max())
    assert err <= TOL[torch.bfloat16] * max(1.0, float(want.abs().max()))


def test_sm90_kernel_rejects_views_tma_cannot_read(cuda):
    from repro_torch.kernels import flash_attention as fa
    x = torch.zeros(1, 4, 64, 72, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device=cuda)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(x[..., 1:65], k, k)  # base 2 bytes off
    assert fa.LAUNCHES == before
    y = fa.flash_attention(x[..., :64], k, k)  # token stride 144 bytes
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1 and y.shape == (1, 4, 64, 64)


def test_lm_prefill_and_decode_on_gpu_match_cpu(cuda):
    """SMOKE llama3.2-1b in fp32, same params: prefill (the flash kernel,
    one launch per layer) and one decode step on the GPU against the
    CPU's plain versions, 1e-4 relative (other summation orders)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models.spec import init_tree
    from repro_torch.nn.tree import tree_map
    cfg = dataclasses.replace(get_arch("llama3.2-1b", smoke=True),
                              compute_dtype="float32")
    params = init_tree(lm.spec_params(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        c = init_tree(lm.spec_caches(cfg, 2, 48), torch.Generator(), dev)
        before = fa.LAUNCHES
        with torch.no_grad():
            logits, c = lm.prefill(p, cfg, {"tokens": toks.to(dev)}, c)
            dec, _ = lm.decode_step(p, cfg, toks[:, :1].to(dev), c, 40)
        out[str(dev)] = (logits.cpu(), dec.cpu(), fa.LAUNCHES - before)
    assert out["cpu"][2] == 0 and out["cuda"][2] == cfg.num_layers
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_serve_cli_on_gpu_launches_once_per_layer_in_prefill(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    out = serve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                      "--prompt-len", "33", "--gen", "4"])
    assert out["device"].startswith("cuda")
    assert out["launches"] == {"prefill": 2, "decode": 0}
    assert torch.isfinite(out["prefill_logits"]).all()
    assert out["tokens"].shape == (2, 4)
