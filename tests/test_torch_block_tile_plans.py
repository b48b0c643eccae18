"""Launch planning of the port's block-ELL kernels, on the CPU.

The CUDA kernels (`kernels/csrc/block_tile.cuh` and the two `.cu` files
on it) run only on a GPU; what surrounds them is Python and is held
here: the copy-width dispatch (16-byte cp.async, 4-byte cp.async, or
synchronous loads) from dtype, widths and base alignment; the tile
width and contraction split that fill the 132 SMs of an H100 at the
ppi_sota shapes; the workspace sizes; the arguments each launch hands
to a ctypes function with its C signature (a fake library records
them); and the build cache, which must see the shared header.
"""
import ctypes
import pathlib
import re

import pytest
import torch

from repro_torch.kernels import _build, block_spmm
from repro_torch.kernels.block_spmm import (TilePlan, copy_width,
                                            plan_tiles, spmm_plan, xw_plan)

H100_SMS = 132
CSRC = pathlib.Path(block_spmm.__file__).parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
# ppi_sota: training batches are nrb = ncb = 3 row-blocks of B 128 with
# K 3 slots (node_cap 384); layer widths 50 → 2048 → ... → 121. Serving
# multiplies a cluster's tiles: nrb 3, K 110, B 128, F 2048.
TRAIN_XW = [(50, 2048), (2048, 2048), (2048, 121)]
TRAIN_SPMM_F = [2048, 121]
SERVE = (3, 110, 128, 2048)


# ----------------------------------------------------------------------
# copy width
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,widths,ptrs,want", [
    (F32, (128, 2048), (0, 4096), 16),     # the hidden layers, serving
    (F32, (50, 2048), (0, 4096), 4),       # layer 0 reads x with D 50 (200 B rows)
    (F32, (2048, 121), (0, 4096), 4),      # layer 4 writes F 121 (484 B rows)
    (F32, (128, 2048), (0, 4100), 4),      # a base 4 bytes off 16
    (BF16, (128, 2048), (0, 4096), 16),
    (BF16, (50, 2048), (0, 4096), 4),      # 100 B rows: 4-byte aligned
    (BF16, (121, 128), (0, 4096), 0),      # odd width: rows 2-byte aligned
    (BF16, (1, 8), (0, 4096), 0),          # F or D 1
    (BF16, (128, 2048), (0, 4098), 0),     # a base 2 bytes off 4
])
def test_copy_width_follows_widths_and_alignment(dtype, widths, ptrs, want):
    assert copy_width(dtype, widths, ptrs) == want


def test_fp32_never_needs_synchronous_loads():
    for w in range(1, 40):
        assert copy_width(F32, (w, 2 * w + 1), (4, 8)) in (4, 16)


# ----------------------------------------------------------------------
# tile width and splits
# ----------------------------------------------------------------------
def _covers(plan: TilePlan, chunks: int) -> None:
    """The kernel gives split s the chunks [s*per, min((s+1)*per,
    chunks)) with per = ceil(chunks / splits): every chunk once, and
    no split past the end."""
    per = -(-chunks // plan.splits)
    owned = [t for s in range(plan.splits)
             for t in range(s * per, min((s + 1) * per, chunks))]
    assert owned == list(range(chunks))
    assert (plan.splits - 1) * per < max(chunks, 1)


@pytest.mark.parametrize("D,F", TRAIN_XW)
def test_xw_stage_fills_the_card_at_the_training_layers(D, F):
    plan = xw_plan(384, D, F, F32, (0, 0), H100_SMS)
    assert plan.ctas >= H100_SMS
    assert plan.ctas == 3 * -(-F // plan.tile_n) * plan.splits
    _covers(plan, -(-D // 16))


@pytest.mark.parametrize("F", TRAIN_SPMM_F)
def test_spmm_fills_the_card_at_the_training_shapes(F):
    """The backward's Âᵀḡ and the fused product's stage (b): 3 x 3 slots
    of B 128, F 2048 or 121 (the 121-wide output needs 64-wide tiles)."""
    plan = spmm_plan(3, 3, 128, F, F32, (0, 0), H100_SMS)
    assert plan.ctas >= H100_SMS
    assert plan.ctas == 3 * -(-F // plan.tile_n) * plan.splits
    if F == 121:
        assert plan.tile_n == 64
    _covers(plan, 3 * 8)


def test_spmm_fills_the_card_at_the_serving_shape():
    nrb, K, B, F = SERVE
    plan = spmm_plan(nrb, K, B, F, F32, (0, 0), H100_SMS)
    assert plan.ctas >= H100_SMS
    assert plan.tile_n == 128 and plan.copy_bytes == 16
    _covers(plan, K * 8)


@pytest.mark.parametrize("m_tiles,n,chunks", [
    (48, 128, 1), (1, 64, 1), (3, 2048, 0), (400, 2048, 8)])
def test_one_split_where_nothing_is_gained_by_more(m_tiles, n, chunks):
    """A single chunk, no contraction, or a grid that already fills the
    card: the partials would only cost."""
    plan = plan_tiles(m_tiles, m_tiles * 128, n, chunks, 16, H100_SMS)
    assert plan.splits == 1 and plan.partial_elems == 0


def test_plan_is_a_pure_function_of_the_shape():
    """The same shape always gives the same plan, so the same summation
    order: what makes repeated calls bitwise equal. The cached plans
    depend on the bases only through their copy width."""
    a = plan_tiles(3, 384, 2048, 128, 16, H100_SMS)
    assert plan_tiles(3, 384, 2048, 128, 16, H100_SMS) == a
    for ptrs, copy in (((4096, 8192), 16), ((4100, 8192), 4)):
        plan = spmm_plan(3, 3, 128, 2048, F32, ptrs, H100_SMS)
        assert plan.copy_bytes == copy
        assert plan == plan_tiles(3, 384, 2048, 24, copy, H100_SMS)


@pytest.mark.parametrize("shape", [(3, 3, 128, 2048), (3, 3, 128, 121),
                                   SERVE, (5, 6, 8, 1), (4, 5, 200, 200)])
def test_workspace_holds_every_split_partial(shape):
    nrb, K, B, F = shape
    plan = spmm_plan(nrb, K, B, F, F32, (0, 0), H100_SMS)
    want = plan.splits * nrb * B * F if plan.splits > 1 else 0
    assert plan.partial_elems == want
    assert plan.splits <= K * -(-B // 16)


# ----------------------------------------------------------------------
# launches through a ctypes function with the C signature
# ----------------------------------------------------------------------
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int}


def _c_argtypes(source: str, symbol: str):
    text = (CSRC / f"{source}.cu").read_text()
    params = re.search(rf"\bint {symbol}\((.*?)\)\s*{{", text, re.S).group(1)
    return [_CTYPES[" ".join(p.split()[:-1])] for p in params.split(",")]


def _fake_card(monkeypatch, source, symbol, table):
    """Point `table` (block_spmm's `_kernel_fns` or `_fused_fns`) at a
    recorder with the C signature of `symbol`; returns the call log."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *_c_argtypes(source, symbol))
    fn = proto(record)
    monkeypatch.setattr(block_spmm, table, lambda: ({F32: fn, BF16: fn},
                                                    None))
    monkeypatch.setattr(block_spmm, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(block_spmm, "_stream", lambda device: 7)
    monkeypatch.setattr(block_spmm, "_WORKSPACE", {})
    return calls, fn


def _check_partials(arg, elems):
    """The partials handed to C: the stream's cached fp32 workspace, at
    least `elems` long; None when nothing splits."""
    if not elems:
        assert arg is None
        return
    part = block_spmm._WORKSPACE[(None, 7)]
    assert arg == part.data_ptr()
    assert part.dtype == torch.float32 and part.numel() >= elems


def _operands(nrb, K, B, ncb, F, dtype):
    blocks = torch.zeros(nrb, K, B, B, dtype=dtype)
    cols = torch.zeros(nrb, K, dtype=torch.int32)
    x = torch.zeros(ncb * B, F, dtype=dtype)
    return blocks, cols, x


@pytest.mark.parametrize("F,dtype", [(2048, F32), (121, F32), (121, BF16)])
def test_spmm_launch_passes_its_plan(monkeypatch, F, dtype):
    calls, _ = _fake_card(monkeypatch, "block_ell_spmm", "block_ell_spmm_f32",
                          "_kernel_fns")
    blocks, cols, x = _operands(3, 3, 128, 3, F, dtype)
    row_k = torch.full((3,), 3, dtype=torch.int32)
    before = block_spmm.LAUNCHES
    y = block_spmm._launch(blocks, cols, x, row_k)
    assert block_spmm.LAUNCHES == before + 1
    assert y.shape == (384, F) and y.dtype == dtype
    (args,) = calls
    plan = spmm_plan(3, 3, 128, F, dtype, (blocks.data_ptr(), x.data_ptr()),
                     H100_SMS)
    assert args[:5] == (blocks.data_ptr(), cols.data_ptr(), row_k.data_ptr(),
                        x.data_ptr(), y.data_ptr())
    _check_partials(args[5], plan.partial_elems)
    assert args[6:] == (3, 3, 128, F, plan.tile_n, plan.splits,
                        plan.copy_bytes, 7)
    assert plan.copy_bytes == {(2048, F32): 16, (121, F32): 4,
                               (121, BF16): 0}[(F, dtype)]
    # a second launch reuses the workspace
    block_spmm._launch(blocks, cols, x, row_k)
    assert calls[1][5] == args[5]


@pytest.mark.parametrize("D,F", TRAIN_XW)
def test_fused_launch_plans_both_stages(monkeypatch, D, F):
    """One C call (one LAUNCHES_FUSED, no LAUNCHES) carries the plans of
    stage (a), XW + b, and stage (b), the SpMM over the scratch; one
    partials buffer serves the larger of the two."""
    calls, _ = _fake_card(monkeypatch, "block_ell_spmm_fused",
                          "block_ell_spmm_fused_f32", "_fused_fns")
    blocks, cols, _ = _operands(3, 3, 128, 3, 1, F32)
    x, w, b = torch.zeros(384, D), torch.zeros(D, F), torch.zeros(F)
    before = (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED)
    y = block_spmm._launch_fused(blocks, cols, x, w, b, None)
    assert (block_spmm.LAUNCHES, block_spmm.LAUNCHES_FUSED) == \
        (before[0], before[1] + 1)
    (args,) = calls
    plan_a = xw_plan(384, D, F, F32, (x.data_ptr(), w.data_ptr()), H100_SMS)
    plan_b = spmm_plan(3, 3, 128, F, F32, (blocks.data_ptr(), args[7]),
                       H100_SMS)
    assert args[2] is None and args[5] == b.data_ptr()
    assert args[6] == y.data_ptr() and args[7] not in (None, y.data_ptr())
    _check_partials(args[8], max(plan_a.partial_elems, plan_b.partial_elems))
    assert args[9:15] == (3, 3, 128, 384, D, F)
    assert args[15:21] == (plan_a.tile_n, plan_a.splits, plan_a.copy_bytes,
                           plan_b.tile_n, plan_b.splits, plan_b.copy_bytes)
    assert plan_a.ctas >= H100_SMS and plan_b.ctas >= H100_SMS


def test_launch_error_raises(monkeypatch):
    """A non-zero cudaError from the C call raises; nothing is counted."""
    monkeypatch.setattr(block_spmm, "_kernel_fns", lambda: (
        {F32: lambda *a: 1}, lambda code: b"invalid argument"))
    monkeypatch.setattr(block_spmm, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(block_spmm, "_stream", lambda device: 7)
    blocks, cols, x = _operands(2, 2, 8, 2, 4, F32)
    before = block_spmm.LAUNCHES
    with pytest.raises(RuntimeError, match="invalid argument"):
        block_spmm._launch(blocks, cols, x, None)
    assert block_spmm.LAUNCHES == before


# ----------------------------------------------------------------------
# the build cache
# ----------------------------------------------------------------------
def test_library_path_changes_with_a_shared_header(monkeypatch, tmp_path):
    """Editing a `.cuh` that a source includes must give a new library
    path, or a stale build would be loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "tile.cuh"\n')
    (csrc / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (csrc / "tile.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "other.cuh").write_text("// new header\n")
    assert _build.library_path("k") not in (first, second)
    assert first.parent == tmp_path / "build"


def test_the_gcn_sources_include_the_shared_mainloop():
    for name in ("block_ell_spmm", "block_ell_spmm_fused"):
        assert '#include "block_tile.cuh"' in (CSRC / f"{name}.cu").read_text()
    assert "block_tile" not in " ".join(_build.SOURCES)  # a header, not a library
