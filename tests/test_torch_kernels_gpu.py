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
    """B 200 runs two 128-row output tiles per row-block; odd bf16
    widths (D or F 1 and 121) take the synchronous copy path."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,F", [(50, 2048), (2048, 121)])
def test_fused_kernel_at_the_outer_training_layers(cuda, D, F, dtype):
    """ppi_sota's first layer (x rows of 50: the 4-byte copy path) and
    its last (a 121-wide output: 64-wide tiles, the slot loop split
    over many CTAs), nrb 3 x K 3 slots of B 128, all slots live."""
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_fused_ref
    blocks, cols, x, w, b, _ = _fused_operands(3, 3, 128, 3, D, F, dtype,
                                               False, seed=D + F)
    args = [t.to(cuda) for t in (blocks, cols, x, w, b)]
    rk = torch.full((3,), 3, dtype=torch.int32, device=cuda)
    y = block_spmm.spmm_fused_block_ell(*args, row_k=rk)
    torch.cuda.synchronize()
    want = spmm_fused_ref(*args).float()
    err = float((y.float() - want).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("F", [2048, 121])
def test_kernel_with_row_k_and_an_empty_row_block(cuda, F):
    """The training shape with row_k = (2, 0, 3): the empty row-block's
    splits own no live slot and must still write zeros."""
    from repro_torch.kernels import block_spmm
    from repro_torch.kernels.ref import spmm_block_ell_ref
    blocks, cols, x, _ = _operands(3, 3, 128, 3, F, torch.float32, False,
                                   seed=F)
    row_k = torch.tensor([2, 0, 3], dtype=torch.int32)
    for i in range(3):
        blocks[i, int(row_k[i]):] = 0
        cols[i, int(row_k[i]):] = 0
    args = [t.to(cuda) for t in (blocks, cols, x)]
    y = block_spmm.spmm_block_ell(*args, row_k=row_k.to(cuda))
    torch.cuda.synchronize()
    assert not y[128:256].any()
    want = spmm_block_ell_ref(*args).float()
    err = float((y.float() - want).abs().max())
    assert err <= TOL[torch.float32] * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("case", ["spmm_2048", "spmm_121", "fused"])
def test_split_products_are_bitwise_repeatable(cuda, case):
    """Split contractions sum their fp32 partials in a fixed order: the
    same inputs give bitwise the same output on every call."""
    from repro_torch.kernels import block_spmm
    sms = block_spmm._sms(cuda)
    if case == "fused":
        ops = [t.to(cuda) for t in _fused_operands(
            3, 3, 128, 3, 2048, 2048, torch.float32, False, seed=5)[:5]]
        plan = block_spmm.xw_plan(384, 2048, 2048, torch.float32, (0, 0), sms)
        run = lambda: block_spmm.spmm_fused_block_ell(*ops)  # noqa: E731
    else:
        F = 2048 if case == "spmm_2048" else 121
        ops = [t.to(cuda) for t in _operands(3, 3, 128, 3, F, torch.float32,
                                             False, 5)[:3]]
        plan = block_spmm.spmm_plan(3, 3, 128, F, torch.float32, (0, 0), sms)
        run = lambda: block_spmm.spmm_block_ell(*ops)  # noqa: E731
    assert plan.splits > 1
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


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


ADJ_FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
              "row_k_t")
# (row blocks of 128, real rows, nonzeros asked for, band about the
# diagonal): the training batches of ppi_sota and reddit (12 × 12 and
# 27 × 27 tiles, ≈27,500 and ≈15,200 nonzeros), and a banded reddit
# shape whose "auto" bucket is below cap/B
SCATTER_CASES = {"ppi": (12, 1140, 27_540, None),
                 "reddit": (27, 3104, 15_200, None),
                 "reddit_auto": (27, 3104, 15_200, 150)}


def _batch_csr(n, nnz, band, seed):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = (rng.integers(0, n, nnz) if band is None else
         np.clip(r + rng.integers(-band, band + 1, nnz), 0, n - 1))
    key = np.unique(r.astype(np.int64) * n + c)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    data = rng.random(len(key)).astype(np.float32) + 0.01
    return indptr, (key % n).astype(np.int32), data


def _scatter_inputs(case):
    from repro_torch.kernels.ops import (block_ell_adj_from_csr,
                                         block_ell_coords_from_csr)
    nrb, n, nnz, band = SCATTER_CASES[case]
    cap = nrb * 128
    ip, ix, dt = _batch_csr(n, nnz, band, seed=nrb)
    kw = dict(n_cols=cap, block=128, n_rows=cap)
    if band is None:
        kw.update(k_slots=nrb, k_slots_t=nrb)
    else:
        kw.update(k_chooser=lambda nf, nt: 1 << (max(nf, nt, 1)
                                                 - 1).bit_length())
    return (block_ell_coords_from_csr(ip, ix, dt, **kw),
            block_ell_adj_from_csr(ip, ix, dt, assume_unique=True, **kw))


def _assert_adj_equal(got, want):
    assert got.checked
    for f in ADJ_FIELDS:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f


@pytest.mark.parametrize("non_blocking", [False, True])
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_device_scatter_matches_host_tiles(cuda, case, non_blocking):
    """`BlockEllCoords.to("cuda")`: one scatter launch, and the tiles
    `block_ell_adj_from_csr` builds on the host, bit for bit."""
    from repro_torch.kernels import block_spmm
    coords, want = _scatter_inputs(case)
    if SCATTER_CASES[case][3] is not None:
        assert want.block_cols.shape[1] < SCATTER_CASES[case][0]
    before = block_spmm.LAUNCHES_SCATTER
    got = coords.to(cuda, non_blocking=non_blocking)
    torch.cuda.synchronize()
    assert block_spmm.LAUNCHES_SCATTER == before + 1
    assert got.blocks.is_cuda and got.block_cols.is_cuda
    _assert_adj_equal(got, want)


def test_device_scatter_needs_no_sync(cuda):
    """Nothing in `.to("cuda")` waits on the device: the copy is
    asynchronous from pinned memory (at prefetch > 0; the blocking copy
    of prefetch 0 is a sync of its own), then a zero fill and a launch."""
    coords, want = _scatter_inputs("reddit")
    coords.to(cuda, non_blocking=True)     # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = coords.to(cuda, non_blocking=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _assert_adj_equal(got, want)


def test_sparse_payload_moves_to_the_gpu(cuda):
    """A ClusterBatcher payload on the card: the compact adjacency
    scattered there (one `copy.tiles_on_device`), equal to its CPU
    expansion, and the copy counts the packed buffer's bytes."""
    from repro_torch.core.batching import ClusterBatcher, batch_to_device
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.partition import partition_graph
    from repro_torch.runtime import trace
    g = make_dataset("ppi", scale=0.03, seed=0)
    parts, _ = partition_graph(g, 8, method="metis", seed=0, cache=False)
    host = next(iter(ClusterBatcher(g, parts, clusters_per_batch=2,
                                    sparse_adj=True).epoch(0))).astuple()
    trace.reset()
    trace.enable()
    try:
        dev = batch_to_device(host, cuda)
    finally:
        trace.disable()
    torch.cuda.synchronize()
    (copy,) = [s for s in trace.spans() if s.name == "batch.copy"]
    trace.reset()
    assert copy.counters["copy.tiles_on_device"] == 1
    assert copy.counters["copy.adj_bytes"] == host[0].packed.numel() * 4
    _assert_adj_equal(dev[0], host[0].to("cpu"))
    for h, d in zip(host[1:], dev[1:]):
        assert np.array_equal(np.asarray(h), d.cpu().numpy())


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


@pytest.mark.parametrize("sampler", ["saint_node", "saint_edge"])
def test_saint_training_step_on_gpu_matches_cpu(cuda, sampler):
    """One `gcn_loss` + backward on a GraphSAINT batch (fractional loss
    weights, block-ELL, fused layers) on CUDA (the kernels: one fused
    and one SpMM launch per layer) against the CPU (plain versions):
    loss within 1e-4 relative, grads within 1e-4·max(1, max|g_cpu|)."""
    import dataclasses
    from repro_torch.core.batching import batch_to_device
    from repro_torch.core.experiment import build_experiment, preset
    from repro_torch.core.gcn import gcn_loss, init_params
    from repro_torch.kernels import block_spmm
    from repro_torch.nn.tree import tree_leaves, tree_map
    spec = preset("ppi_tiny_saint")
    spec.batch.sampler = sampler
    spec.batch.sparse_adj = True
    spec.model.fuse_spmm = True
    spec.partition.cache = False
    exp = build_experiment(spec, device=cuda)
    cfg = dataclasses.replace(exp.cfg, dropout=0.0)
    host = next(iter(exp.batcher.epoch(0))).astuple()
    lm = host[4]
    assert not np.all(np.isin(lm, (0.0, 1.0)))   # estimator weights
    params = init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        before = (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED)
        loss, _ = gcn_loss(p, batch_to_device(host, dev), cfg, train=True)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        launched = (block_spmm.LAUNCHES - before[0],
                    block_spmm.LAUNCHES_FUSED - before[1])
        out[str(dev)] = (float(loss.detach()),
                         [g.float().cpu() for g in grads], launched)
    n = cfg.num_layers
    assert out["cpu"][2] == (0, 0) and out["cuda"][2] == (n, n)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= \
        1e-4 * abs(out["cpu"][0])
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert float((got - want).abs().max()) <= \
            1e-4 * max(1.0, float(want.abs().max()))


def test_full_batch_baseline_on_gpu_matches_cpu(cuda):
    """Two full-batch epochs (`index_add` with atomics on CUDA) from the
    same init: losses within 1e-4 relative, params within
    1e-4·max(1, max|p|)."""
    from repro_torch.core.baselines import train_full_batch
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.graph.generators import make_dataset
    from repro_torch.nn import optim
    from repro_torch.nn.tree import tree_leaves
    g = make_dataset("ppi", scale=0.05, seed=0)
    cfg = GCNConfig(in_dim=50, hidden_dim=64, out_dim=121, num_layers=3,
                    dropout=0.0, multilabel=True)
    out = {str(dev): train_full_batch(g, cfg, optim.adamw(1e-2), 2,
                                      device=dev)
           for dev in ("cpu", cuda)}
    for a, b in zip(out["cuda"]["history"], out["cpu"]["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    for a, b in zip(tree_leaves(out["cuda"]["params"]),
                    tree_leaves(out["cpu"]["params"])):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * max(1.0, float(b.abs().max()))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=48, softcap=30.0),
                                dict(causal=False)])
def test_flash_gradient_matches_autograd_of_the_plain_version(cuda, kw,
                                                              dtype):
    """Under autograd the kernel's forward runs (one launch) and the
    backward is the VJP of `blocked_attention`: its q, k, v gradients
    against autograd of the plain version on the same CUDA inputs,
    within the forward's tolerance."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import multi_head_attention_ref
    g = torch.Generator().manual_seed(3)
    shapes = ((2, 4, 160, 64), (2, 2, 160, 64), (2, 2, 160, 64))
    base = [torch.randn(s, generator=g).to(cuda, dtype) for s in shapes]
    ct = torch.randn(shapes[0], generator=g).to(cuda, dtype)
    a = [t.clone().requires_grad_(True) for t in base]
    before = fa.LAUNCHES
    out = fa.flash_attention(*a, **kw)
    got = torch.autograd.grad(out, a, ct)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    b = [t.clone().requires_grad_(True) for t in base]
    want = torch.autograd.grad(multi_head_attention_ref(*b, **kw), b, ct)
    for x, w in zip(got, want):
        assert x.dtype == dtype
        err = float((x.float() - w.float()).abs().max())
        assert err <= TOL[dtype] * max(1.0, float(w.float().abs().max()))


def test_lm_training_step_on_gpu_matches_cpu(cuda):
    """One `make_train_step` of SMOKE llama3.2-1b in fp32 with remat and
    2 microbatches: the flash forward inside autograd (2 launches per
    layer and microbatch: forward and the remat recompute) and the
    metrics and params against the CPU's."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import CellPolicy
    from repro_torch.dist.steps import make_train_step, spec_train_state
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.spec import init_tree
    from repro_torch.nn.optim import adamw
    from repro_torch.nn.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_arch("llama3.2-1b", smoke=True),
                              compute_dtype="float32")
    state = init_tree(spec_train_state(cfg),
                      torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg, CellPolicy(microbatches=2, loss_chunk=32),
                           adamw(1e-3, clip_norm=1.0))
    out = {}
    for dev in ("cpu", cuda):
        before = fa.LAUNCHES
        new, metrics = step(tree_map(lambda t: t.to(dev), state),
                            {"tokens": toks.to(dev)})
        out[str(dev)] = (new, {k: float(v) for k, v in metrics.items()},
                         fa.LAUNCHES - before)
    assert out["cpu"][2] == 0 and out["cuda"][2] == 2 * 2 * cfg.num_layers
    for key, want in out["cpu"][1].items():
        assert abs(out["cuda"][1][key] - want) <= 1e-4 * max(1.0, abs(want))
    for got, want in zip(tree_leaves(out["cuda"][0]["mu"]),
                         tree_leaves(out["cpu"][0]["mu"])):
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * max(
            1.0, float(want.abs().max()))
