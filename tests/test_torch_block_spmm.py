"""The port's block-ELL product on the CPU against the reference.

`repro_torch.kernels.block_spmm.spmm_block_ell` on CPU tensors (its
plain PyTorch version) is held against the reference's Pallas kernel in
interpret mode and against the reference's pure-jnp oracle, on the same
numpy inputs: B in {8, 16}, ragged F, fp32 and bf16, row_k None and
given, empty row-blocks, inflated K, and K = 0. Tolerances:
max|Δ| <= 1e-5·max(1, max|y_ref|) in fp32 (different summation order),
8e-3·max(1, max|y_ref|) in bf16 (one bf16 rounding of the output).
The CUDA kernel itself is checked on the GPU by chip_smoke.py and
tests/test_torch_kernels_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_spmm import spmm_block_ell as jax_spmm
from repro.kernels.ops import block_ell_from_dense
from repro.kernels.ref import spmm_block_ell_ref as jax_ref
from repro_torch.kernels import block_spmm
from repro_torch.kernels.block_spmm import spmm_block_ell
from repro_torch.kernels.ref import spmm_block_ell_ref

TOL = {"fp32": 1e-5, "bf16": 8e-3}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _operands(B, F, fill, seed):
    """Block-sparse dense Â (numpy) → reference block-ELL tiles, plus x.
    fill: "normal"; "empty_rows" (whole row-blocks without tiles);
    "inflated_k" (K above the need, trailing padding slots)."""
    rng = np.random.default_rng(seed)
    nrb, ncb = 5, 7
    dense = np.zeros((nrb * B, ncb * B), np.float32)
    for i in range(nrb):
        for j in range(ncb):
            if rng.random() < 0.4:
                dense[i * B:(i + 1) * B, j * B:(j + 1) * B] = \
                    rng.normal(size=(B, B)) * (rng.random((B, B)) < 0.3)
    if fill == "empty_rows":
        dense[B:3 * B] = 0.0
    need = int((np.abs(dense.reshape(nrb, B, ncb, B)).sum((1, 3)) > 0)
               .sum(1).max())
    k = need + 3 if fill == "inflated_k" else None
    blocks, cols, row_k = block_ell_from_dense(dense, B, k_slots=k,
                                               with_row_k=True)
    x = rng.normal(size=(ncb * B, F)).astype(np.float32)
    return blocks, cols, row_k, x


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("fill", ["normal", "empty_rows", "inflated_k"])
@pytest.mark.parametrize("use_row_k", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,F", [(8, 5), (16, 20)])
def test_cpu_spmm_matches_reference_kernel_and_oracle(B, F, dtype,
                                                      use_row_k, fill):
    blocks, cols, row_k, x = _operands(B, F, fill, seed=B * 31 + F)
    jb = jnp.asarray(blocks, JNP[dtype])        # as the reference's _apply
    jx = jnp.asarray(x, JNP[dtype])
    want_kernel = jax_spmm(jb, jnp.asarray(cols), jx,
                           row_k=jnp.asarray(row_k) if use_row_k else None,
                           block_f=128, interpret=True)
    want_ref = jax_ref(jb, jnp.asarray(cols), jx)
    got = spmm_block_ell(
        torch.from_numpy(blocks), torch.from_numpy(cols),
        torch.from_numpy(x).to(TORCH[dtype]),
        row_k=torch.from_numpy(row_k) if use_row_k else None)
    assert got.dtype == TORCH[dtype]
    assert tuple(got.shape) == (blocks.shape[0] * B, F)
    got = got.float().numpy()
    for want in (want_kernel, want_ref):
        want = np.asarray(want.astype(jnp.float32))
        bound = TOL[dtype] * max(1.0, float(np.abs(want).max()))
        assert _max_err(got, want) <= bound


@pytest.mark.parametrize("B", [8, 16])
def test_k_zero_returns_zeros(B):
    blocks = np.zeros((3, 0, B, B), np.float32)
    cols = np.zeros((3, 0), np.int32)
    x = np.random.default_rng(0).normal(size=(2 * B, 7)).astype(np.float32)
    want = np.asarray(jax_spmm(jnp.asarray(blocks), jnp.asarray(cols),
                               jnp.asarray(x), interpret=True))
    got = spmm_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                         torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3 * B, 7)
    assert not got.any() and not want.any()


def test_plain_version_matches_dense_product():
    """The plain version against Â·x computed densely (fp32, float64
    reference), independent of both packages' block-ELL code paths."""
    blocks, cols, _, x = _operands(16, 9, "normal", seed=3)
    nrb, K, B, _ = blocks.shape
    dense = np.zeros((nrb * B, x.shape[0]), np.float64)
    for i in range(nrb):
        for k in range(K):
            c = cols[i, k]
            dense[i * B:(i + 1) * B, c * B:(c + 1) * B] += blocks[i, k]
    want = dense @ x.astype(np.float64)
    got = spmm_block_ell_ref(torch.from_numpy(blocks),
                             torch.from_numpy(cols),
                             torch.from_numpy(x)).numpy()
    assert _max_err(got, want) <= 1e-5 * max(1.0, np.abs(want).max())


def test_bf16_x_casts_fp32_tiles_down():
    """A bf16 x pulls fp32 tiles down to bf16 before the product (the
    reference's `_apply` contract): same result as passing bf16 tiles."""
    blocks, cols, _, x = _operands(8, 11, "normal", seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    a = spmm_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols), xb)
    b = spmm_block_ell(torch.from_numpy(blocks).to(torch.bfloat16),
                       torch.from_numpy(cols), xb)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b)


def test_cpu_path_launches_no_kernel():
    blocks, cols, row_k, x = _operands(8, 4, "normal", seed=7)
    before = block_spmm.LAUNCHES
    spmm_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                   torch.from_numpy(x), row_k=torch.from_numpy(row_k))
    assert block_spmm.LAUNCHES == before


def _good():
    blocks, cols, row_k, x = _operands(8, 4, "normal", seed=9)
    return dict(blocks=torch.from_numpy(blocks),
                block_cols=torch.from_numpy(cols), x=torch.from_numpy(x),
                row_k=torch.from_numpy(row_k))


@pytest.mark.parametrize("bad", [
    "cols_int64", "cols_shape", "x_rows", "x_dtype", "row_k_shape",
    "noncontiguous", "blocks_rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    kw = _good()
    if bad == "cols_int64":
        kw["block_cols"] = kw["block_cols"].long()
    elif bad == "cols_shape":
        kw["block_cols"] = kw["block_cols"][:, :-1].contiguous()
    elif bad == "x_rows":
        kw["x"] = kw["x"][:-1].contiguous()
    elif bad == "x_dtype":
        kw["x"] = kw["x"].double()
    elif bad == "row_k_shape":
        kw["row_k"] = kw["row_k"][:-1].contiguous()
    elif bad == "noncontiguous":
        kw["x"] = torch.cat([kw["x"], kw["x"]], 1)[:, ::2]
    elif bad == "blocks_rank":
        kw["blocks"] = kw["blocks"][0]
    with pytest.raises((ValueError, TypeError)):
        spmm_block_ell(kw.pop("blocks"), kw.pop("block_cols"),
                       kw.pop("x"), **kw)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors go to the plain version: a tensor on any other
    device launches a kernel or raises (here the meta device, which has
    no kernel)."""
    kw = {k: v.to("meta") for k, v in _good().items()}
    with pytest.raises(ValueError, match="no block-ELL kernel"):
        spmm_block_ell(kw.pop("blocks"), kw.pop("block_cols"),
                       kw.pop("x"), **kw)
