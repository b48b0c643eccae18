"""The port's training-path kernels on the CPU against the reference.

* The fused product y = Â·(XW + b): `repro_torch`'s wrapper (its plain
  version on CPU tensors) and its autograd Function against the
  reference's Pallas kernel in interpret mode and its jnp oracle, over
  B in {8, 16}, ragged D and F, fp32 and bf16, row_k None and given,
  empty row-blocks, inflated K and K = 0. Tolerance 1e-5·max(1,
  max|ref|) in fp32 (other summation order) and 8e-3·max(1, max|ref|)
  in bf16 (one bf16 rounding of the output), as for the SpMM.
* Gradients of `spmm_ell` (dx) and `spmm_fused` (dx, dW, db) against
  `jax.vjp` of the reference's `spmm_ell`/`spmm_fused` (impl="ref"; the
  BlockEllAdj leaves go through jnp.asarray, see ROADMAP C1).
* The new host builders, bit for bit, and the dense dispatch.
The CUDA kernels themselves are checked on the GPU by chip_smoke.py and
tests/test_torch_kernels_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.block_spmm import BlockEllAdj as RefAdj
from repro.kernels.block_spmm import spmm_ell as ref_spmm_ell
from repro.kernels.block_spmm import spmm_fused as ref_spmm_fused
from repro.kernels.block_spmm import spmm_fused_block_ell as ref_fused_kernel
from repro.kernels.ref import spmm_fused_ref as ref_fused_oracle
from repro_torch.kernels import block_spmm, ops
from repro_torch.kernels.block_spmm import (BlockEllAdj, spmm_ell, spmm_fused,
                                            spmm_fused_block_ell)

TOL = {"fp32": 1e-5, "bf16": 8e-3}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
          "row_k_t")


def _dense(B, fill, seed, nrb=5, ncb=7):
    """A block-sparse dense Â. fill: "normal"; "empty_rows" (whole
    row-blocks without tiles); "inflated_k" (built with K above need)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((nrb * B, ncb * B), np.float32)
    for i in range(nrb):
        for j in range(ncb):
            if rng.random() < 0.4:
                dense[i * B:(i + 1) * B, j * B:(j + 1) * B] = \
                    rng.normal(size=(B, B)) * (rng.random((B, B)) < 0.3)
    if fill == "empty_rows":
        dense[B:3 * B] = 0.0
    return dense


def _need(dense, B):
    nrb, ncb = dense.shape[0] // B, dense.shape[1] // B
    return int((np.abs(dense.reshape(nrb, B, ncb, B)).sum((1, 3)) > 0)
               .sum(1).max())


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _ref_adj(port_adj):
    """The reference's BlockEllAdj with the same leaves (jnp arrays)."""
    return RefAdj(*(jnp.asarray(t.numpy()) for t in port_adj.tensors()))


# ----------------------------------------------------------------------
# the fused product, forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fill", ["normal", "empty_rows", "inflated_k"])
@pytest.mark.parametrize("use_row_k", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,D,F", [(8, 5, 13), (16, 21, 9)])
def test_fused_matches_reference_kernel_and_oracle(B, D, F, dtype,
                                                   use_row_k, fill):
    dense = _dense(B, fill, seed=B * 7 + D)
    k = _need(dense, B) + 3 if fill == "inflated_k" else None
    blocks, cols, row_k = ops.block_ell_from_dense(dense, B, k_slots=k,
                                                   with_row_k=True)
    rng = np.random.default_rng(D)
    x = rng.normal(size=(dense.shape[1], D)).astype(np.float32)
    w = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=F).astype(np.float32)
    jb, jx, jw = (jnp.asarray(a, JNP[dtype]) for a in (blocks, x, w))
    want_kernel = ref_fused_kernel(
        jb, jnp.asarray(cols), jx, jw, jnp.asarray(b),
        row_k=jnp.asarray(row_k) if use_row_k else None, block_f=128,
        interpret=True)
    want_oracle = ref_fused_oracle(jb, jnp.asarray(cols), jx, jw,
                                   jnp.asarray(b))
    tx = torch.from_numpy(x).to(TORCH[dtype])
    got = spmm_fused_block_ell(
        torch.from_numpy(blocks), torch.from_numpy(cols), tx,
        torch.from_numpy(w), torch.from_numpy(b),
        row_k=torch.from_numpy(row_k) if use_row_k else None)
    assert got.dtype == TORCH[dtype]
    assert tuple(got.shape) == (blocks.shape[0] * B, F)
    adj = ops.block_ell_adj_from_dense(dense, B, k_slots=k)
    got_fn = spmm_fused(adj, tx, torch.from_numpy(w), torch.from_numpy(b))
    for want in (want_kernel, want_oracle):
        want = np.asarray(want.astype(jnp.float32))
        bound = TOL[dtype] * max(1.0, float(np.abs(want).max()))
        assert _max_err(got.float().numpy(), want) <= bound
        assert _max_err(got_fn.detach().float().numpy(), want) <= bound


@pytest.mark.parametrize("B", [8, 16])
def test_fused_k_zero_returns_zeros(B):
    blocks = np.zeros((3, 0, B, B), np.float32)
    cols = np.zeros((3, 0), np.int32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2 * B, 6)).astype(np.float32)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    want = np.asarray(ref_fused_kernel(
        jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = spmm_fused_block_ell(*(torch.from_numpy(a)
                                 for a in (blocks, cols, x, w, b))).numpy()
    assert got.shape == want.shape == (3 * B, 5)
    assert not got.any() and not want.any()


def test_fused_equals_unfused_composition_in_fp32():
    """In fp32 the fused plain version is the unfused matmul-then-spmm,
    value for value (the rounding between the products is a no-op)."""
    dense = _dense(8, "normal", seed=11)
    adj = ops.block_ell_adj_from_dense(dense, 8)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(dense.shape[1], 7))
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=3).astype(np.float32))
    fused = ops.spmm_xw(adj, x, w, b)
    unfused = ops.spmm(adj, (torch.matmul(x, w) + b))
    assert torch.equal(fused, unfused)


def test_cpu_training_products_launch_no_kernel():
    dense = _dense(8, "normal", seed=5)
    adj = ops.block_ell_adj_from_dense(dense, 8)
    x = torch.randn(dense.shape[1], 4, requires_grad=True)
    w = torch.randn(4, 3, requires_grad=True)
    before = (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED)
    (spmm_ell(adj, x).sum() + spmm_fused(adj, x, w).sum()).backward()
    assert (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED) == before


def test_fused_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor on any other device launches a kernel or raises (here the
    meta device, which has no kernel)."""
    dense = _dense(8, "normal", seed=6)
    blocks, cols = ops.block_ell_from_dense(dense, 8)
    args = [torch.from_numpy(blocks), torch.from_numpy(cols),
            torch.randn(dense.shape[1], 4), torch.randn(4, 3),
            torch.randn(3)]
    with pytest.raises(ValueError, match="no fused block-ELL kernel"):
        spmm_fused_block_ell(*(a.to("meta") for a in args))


@pytest.mark.parametrize("bad", ["w_rows", "w_rank", "b_shape", "w_dtype"])
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(bad):
    dense = _dense(8, "normal", seed=7)
    blocks, cols = ops.block_ell_from_dense(dense, 8)
    kw = dict(blocks=torch.from_numpy(blocks),
              block_cols=torch.from_numpy(cols),
              x=torch.randn(dense.shape[1], 4), w=torch.randn(4, 3),
              b=torch.randn(3))
    if bad == "w_rows":
        kw["w"] = torch.randn(5, 3)
    elif bad == "w_rank":
        kw["w"] = torch.randn(4)
    elif bad == "b_shape":
        kw["b"] = torch.randn(4)
    elif bad == "w_dtype":
        kw["w"] = torch.randn(4, 3).double()
        kw["x"] = kw["x"].double()
    with pytest.raises((ValueError, TypeError)):
        spmm_fused_block_ell(**kw)


# ----------------------------------------------------------------------
# gradients against jax.vjp of the reference's custom VJPs
# ----------------------------------------------------------------------
# fp32: 1e-4·max(1, max|g_ref|) — two chained products summed in other
# orders. bf16: the transposed product g̃ = Âᵀḡ is rounded to bf16
# (ulp 2^-8 of its magnitude) before the dense dW/dX products, and a
# sum-order difference can flip that rounding for some entries; each
# flip moves a grad entry by at most one such ulp times |x| or |w|
# summed over few terms, so 1e-2·max(1, max|g_ref|) bounds it.
GRAD_TOL = {"fp32": 1e-4, "bf16": 1e-2}


@pytest.mark.parametrize("fused", [False, True], ids=["ell", "fused"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,fill", [(8, "normal"), (16, "empty_rows"),
                                    (8, "inflated_k")])
def test_grads_match_reference_vjp(B, fill, dtype, fused):
    dense = _dense(B, fill, seed=B + 3, nrb=5, ncb=5)
    k = _need(dense, B) + 2 if fill == "inflated_k" else None
    adj = ops.block_ell_adj_from_dense(dense, B, k_slots=k, k_slots_t=k)
    jadj = _ref_adj(adj)
    rng = np.random.default_rng(B)
    D, F = 6, 11
    x = rng.normal(size=(dense.shape[1], D)).astype(np.float32)
    w = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=F).astype(np.float32)
    gy = rng.normal(size=(dense.shape[0], F if fused else D)) \
        .astype(np.float32)
    jx = jnp.asarray(x, JNP[dtype])
    jg = jnp.asarray(gy, JNP[dtype])
    tx = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()
    if fused:
        _, vjp = jax.vjp(lambda x_, w_, b_: ref_spmm_fused(
            jadj, x_, w_, b_, impl="ref"), jx, jnp.asarray(w),
            jnp.asarray(b))
        want = vjp(jg)
        tw = torch.from_numpy(w).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        y = spmm_fused(adj, tx, tw, tb)
        y.backward(torch.from_numpy(gy).to(TORCH[dtype]))
        got = (tx.grad, tw.grad, tb.grad)
    else:
        _, vjp = jax.vjp(lambda x_: ref_spmm_ell(jadj, x_, impl="ref"), jx)
        want = vjp(jg)
        y = spmm_ell(adj, tx)
        y.backward(torch.from_numpy(gy).to(TORCH[dtype]))
        got = (tx.grad,)
    assert tx.grad.dtype == TORCH[dtype]
    for g, r in zip(got, want):
        r = np.asarray(r.astype(jnp.float32))
        bound = GRAD_TOL[dtype] * max(1.0, float(np.abs(r).max()))
        assert _max_err(g.float().numpy(), r) <= bound


def test_fused_without_bias_and_frozen_input():
    """b=None gives no bias grad; an input that needs no grad gets none
    (layer 0's features), while W still does."""
    dense = _dense(8, "normal", seed=9)
    adj = ops.block_ell_adj_from_dense(dense, 8)
    x = torch.randn(dense.shape[1], 4)
    w = torch.randn(4, 3, requires_grad=True)
    spmm_fused(adj, x, w).sum().backward()
    assert w.grad is not None and x.grad is None
    jadj = _ref_adj(adj)
    _, vjp = jax.vjp(lambda w_: ref_spmm_fused(jadj, jnp.asarray(x.numpy()),
                                               w_, None, impl="ref"),
                     jnp.asarray(w.detach().numpy()))
    (want,) = vjp(jnp.ones((dense.shape[0], 3), jnp.float32))
    assert _max_err(w.grad.numpy(), want) <= 1e-4 * max(
        1.0, float(np.abs(np.asarray(want)).max()))


# ----------------------------------------------------------------------
# BlockEllAdj: checked once, when built or moved
# ----------------------------------------------------------------------
def test_block_ell_adj_rejects_out_of_range_columns():
    dense = _dense(8, "normal", seed=2, nrb=3, ncb=3)
    adj = ops.block_ell_adj_from_dense(dense, 8)
    bad = adj.block_cols.clone()
    bad[0, 0] = adj.blocks_t.shape[0]
    with pytest.raises(ValueError, match="block_cols out of range"):
        BlockEllAdj(adj.blocks, bad, adj.blocks_t, adj.block_cols_t)
    bad_t = adj.block_cols_t.clone()
    bad_t[0, 0] = -1
    with pytest.raises(ValueError, match="block_cols_t out of range"):
        BlockEllAdj(adj.blocks, adj.block_cols, adj.blocks_t, bad_t)
    moved = adj.to("cpu")
    assert moved.checked and moved.blocks.device.type == "cpu"


def test_products_reject_x_of_another_size():
    dense = _dense(8, "normal", seed=4, nrb=3, ncb=4)
    adj = ops.block_ell_adj_from_dense(dense, 8)
    with pytest.raises(ValueError, match="rows for this adjacency"):
        spmm_ell(adj, torch.randn(3 * 8, 2))
    with pytest.raises(ValueError, match="rows for this adjacency"):
        spmm_fused(adj, torch.randn(5 * 8, 2), torch.randn(2, 2))


# ----------------------------------------------------------------------
# host builders, bit for bit
# ----------------------------------------------------------------------
def _csr_of(dense):
    import scipy.sparse as sp
    m = sp.csr_matrix(dense)
    m.sort_indices()
    return m.indptr, m.indices.astype(np.int32), m.data.astype(np.float32)


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("fill", ["normal", "empty_rows"])
def test_builders_bit_equal_to_reference(B, fill):
    dense = _dense(B, fill, seed=B + 1)
    n_cb = -(-dense.shape[1] // B)
    # block_ell_from_dense (+ row_k) and the transpose (+ pool, + row_k)
    want = ref_ops.block_ell_from_dense(dense, B, with_row_k=True)
    got = ops.block_ell_from_dense(dense, B, with_row_k=True)
    for a, g in zip(want, got):
        assert np.array_equal(a, g) and a.dtype == g.dtype
    pool_r, pool_p = ref_ops.TileBufferPool(2), ops.TileBufferPool(2)
    for _ in range(3):                  # cycle the pools' rings
        want_t = ref_ops.block_ell_transpose(want[0], want[1], n_cb,
                                             pool=pool_r, with_row_k=True)
        got_t = ops.block_ell_transpose(got[0], got[1], n_cb,
                                        pool=pool_p, with_row_k=True)
        for a, g in zip(want_t, got_t):
            assert np.array_equal(a, g) and a.dtype == g.dtype
    # BlockEllAdj from dense and from CSR (k_chooser, pool, n_rows)
    pairs = [(ref_ops.block_ell_adj_from_dense(dense, B),
              ops.block_ell_adj_from_dense(dense, B))]
    ip, ix, dt = _csr_of(dense)
    chooser = lambda nf, nt: max(nf, nt) + 1  # noqa: E731
    pool_r, pool_p = ref_ops.TileBufferPool(2), ops.TileBufferPool(2)
    for _ in range(3):
        pairs.append((
            ref_ops.block_ell_adj_from_csr(ip, ix, dt, dense.shape[1], B,
                                           n_rows=dense.shape[0] + B,
                                           k_chooser=chooser, pool=pool_r),
            ops.block_ell_adj_from_csr(ip, ix, dt, dense.shape[1], B,
                                       n_rows=dense.shape[0] + B,
                                       k_chooser=chooser, pool=pool_p)))
    for ra, pa in pairs:
        for f in FIELDS:
            a, g = np.asarray(getattr(ra, f)), getattr(pa, f).numpy()
            assert np.array_equal(a, g) and a.dtype == g.dtype, f


def test_csr_builder_raises_on_lossy_k_like_the_reference():
    dense = _dense(8, "normal", seed=8)
    ip, ix, dt = _csr_of(dense)
    for builder in (ref_ops.block_ell_adj_from_csr,
                    ops.block_ell_adj_from_csr):
        with pytest.raises(ValueError, match="drops non-zero tiles"):
            builder(ip, ix, dt, dense.shape[1], 8, k_slots=1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_dispatch_matches_reference(dtype):
    rng = np.random.default_rng(12)
    adj = (rng.random((24, 24)) < 0.2).astype(np.float32)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    jx = jnp.asarray(x, JNP[dtype])
    tx = torch.from_numpy(x).to(TORCH[dtype])
    pairs = [(ref_ops.spmm(jnp.asarray(adj), jx),
              ops.spmm(torch.from_numpy(adj), tx)),
             (ref_ops.spmm_xw(jnp.asarray(adj), jx, jnp.asarray(w),
                              jnp.asarray(b)),
              ops.spmm_xw(torch.from_numpy(adj), tx, torch.from_numpy(w),
                          torch.from_numpy(b)))]
    for want, got in pairs:
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == TORCH[dtype]
        assert _max_err(got.float().numpy(), want) <= \
            TOL[dtype] * max(1.0, float(np.abs(want).max()))
