"""The port's attention (`repro_torch.kernels.ops.multi_head_attention`)
against the reference's flash kernel.

On the CPU the port takes the kernel's plain version; the reference
runs its Pallas kernel body in interpret mode. Same inputs, made with
numpy from a seed. fp32 within 1e-5·max(1, max|ref|) (summation order),
bf16 within 8e-3·max(1, max|ref|) (one bf16 rounding of the output).
The cases are the reference's own sweep (tests/test_kernels.py) plus
Tq > Tk (rows that see no key give 0), D 80 and a window with GQA.
"""
import contextlib
import ctypes
import functools
import importlib
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import multi_head_attention as ref_mha
from repro.kernels.ref import mha_ref as jax_mha_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.ops import multi_head_attention

TOL = {np.float32: 1e-5, "bfloat16": 8e-3}

ATTN_CASES = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=17),
    dict(causal=True, softcap=30.0),
]
SHAPES = [
    (1, 2, 2, 64, 64, 32),
    (2, 4, 1, 100, 100, 16),     # GQA broadcast, ragged T
    (1, 4, 2, 1, 96, 32),        # decode-style Tq = 1
    (1, 4, 2, 96, 64, 32),       # Tq > Tk: the first rows see no key
    (1, 4, 1, 40, 70, 80),       # D 80
]


def _inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    return q, k, v


def _reference(q, k, v, dtype=jnp.float32, **kw):
    out = ref_mha(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                  jnp.asarray(v, dtype), mode="interpret", block_q=32,
                  block_k=32, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return multi_head_attention(*t, **kw).float().numpy()


@pytest.mark.parametrize("kw", ATTN_CASES)
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", SHAPES)
def test_port_matches_reference_kernel(kw, B, Hq, Hkv, Tq, Tk, D):
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=B * 31 + Tq + D)
    want = _reference(q, k, v, **kw)
    before = fa.LAUNCHES
    got = _port(q, k, v, **kw)
    assert fa.LAUNCHES == before          # CPU tensors launch nothing
    assert got.shape == (B, Hq, Tq, D)
    err = np.abs(got - want).max()
    assert err <= TOL[np.float32] * max(1.0, np.abs(want).max()), err
    if Tq > Tk and kw.get("causal", True):
        assert not got[:, :, :Tq - Tk].any()   # nothing visible → 0


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=9, softcap=20.0)])
def test_port_matches_reference_kernel_bf16(kw):
    q, k, v = _inputs(2, 4, 2, 50, 50, 16, seed=5)
    want = _reference(q, k, v, jnp.bfloat16, **kw)
    got = _port(q, k, v, torch.bfloat16, **kw)
    err = np.abs(got - want).max()
    assert err <= TOL["bfloat16"] * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("kw", ATTN_CASES)
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", [s for s in SHAPES
                                               if s[3] <= s[4]])
def test_plain_version_matches_copied_mha_ref(kw, B, Hq, Hkv, Tq, Tk, D):
    """Where every row sees a key, the kernel's plain version equals the
    reference's oracle `mha_ref`; the port's copy of that oracle equals
    the reference's."""
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=Tk + D)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    plain = port_ref.multi_head_attention_ref(*t, **kw).numpy()
    copied = port_ref.mha_ref(*t, **kw).numpy()
    jax_oracle = np.asarray(jax_mha_ref(*map(jnp.asarray, (q, k, v)), **kw))
    assert np.abs(plain - copied).max() <= 1e-5 * max(
        1.0, np.abs(copied).max())
    assert np.abs(copied - jax_oracle).max() <= 1e-5 * max(
        1.0, np.abs(jax_oracle).max())


def test_fully_masked_rows_differ_between_plain_version_and_oracle():
    """Tq > Tk, causal: the kernel (and its plain version) give 0 where
    nothing is visible; mha_ref gives the mean of v there."""
    q, k, v = _inputs(1, 2, 2, 8, 4, 16, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    plain = port_ref.flash_attention_ref(*t)
    oracle = port_ref.mha_ref(*t)
    assert torch.equal(plain[:, :, :4], torch.zeros_like(plain[:, :, :4]))
    torch.testing.assert_close(oracle[:, :, :4],
                               t[2].mean(2, keepdim=True).expand(1, 2, 4, 16))
    torch.testing.assert_close(plain[:, :, 4:], oracle[:, :, 4:])


def test_flat_bh_layout_matches_reference_flash_attention():
    """The reference's (BH, T, D) entry point, same arguments."""
    from repro.kernels import flash_attention as jax_flash
    q, k, v = _inputs(1, 6, 6, 33, 45, 24, seed=9)
    q, k, v = (a[0] for a in (q, k, v))
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                window=20, scale=0.3, block_q=16,
                                block_k=16, interpret=True))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=20, scale=0.3).numpy()
    assert got.shape == (6, 33, 24)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_strided_views_match_contiguous():
    """The model hands the kernel transposed views (unit stride along D):
    the result does not depend on the layout."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 30, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 30, 2, 16)).astype(np.float32))
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = multi_head_attention(q, k, k)
    want = multi_head_attention(q.contiguous(), k.contiguous(),
                                k.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["head_dim_12", "head_dim_264", "gqa_3_2",
                                 "dtype_mix", "f16", "stride", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = k
    err = ValueError
    if bad == "head_dim_12":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "head_dim_264":
        q, k, v = (torch.zeros(*t.shape[:3], 264) for t in (q, k, v))
    elif bad == "gqa_3_2":
        q = torch.zeros(1, 3, 8, 16)
    elif bad == "dtype_mix":
        k, err = k.bfloat16(), TypeError
    elif bad == "f16":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif bad == "stride":
        q = torch.zeros(1, 4, 16, 8).transpose(2, 3)
    else:
        q = q[0]
    with pytest.raises(err):
        multi_head_attention(q, k, v)


def test_empty_keys_give_zeros():
    q = torch.ones(1, 2, 3, 8)
    k = torch.zeros(1, 2, 0, 8)
    out = multi_head_attention(q, k, k, causal=False)
    assert out.shape == q.shape and not out.any()


# ----------------------------------------------------------------------
# the ctypes binding against the C interface (no GPU needed)
# ----------------------------------------------------------------------
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int,
           "float": ctypes.c_float}
_CSRC = pathlib.Path(fa.__file__).parent / "csrc"


def _c_argtypes(source: str, symbol: str):
    """The ctypes of an `extern "C"` entry point, read from its source."""
    text = (_CSRC / f"{source}.cu").read_text()
    params = re.search(rf"\bint {symbol}\((.*?)\)\s*{{", text, re.S).group(1)
    return [_CTYPES[" ".join(p.split()[:-1])] for p in params.split(",")]


class _FakeLib:
    def __getattr__(self, name):
        fn = types.SimpleNamespace(name=name)
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("module,fns,source", [
    ("flash_attention", "_kernel_fns", "flash_attention"),
    ("block_spmm", "_kernel_fns", "block_ell_spmm"),
    ("block_spmm", "_fused_fns", "block_ell_spmm_fused"),
    ("flash_attention", "_kernel_fns", "flash_attention_sm90")])
def test_ctypes_argtypes_match_the_c_signatures(monkeypatch, module, fns,
                                                source):
    """Every entry point of the table that `source` defines has the
    argtypes of its C signature."""
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    monkeypatch.setattr(mod._build, "load", lambda name: _FakeLib())
    table, _ = getattr(mod, fns).__wrapped__()
    text = (_CSRC / f"{source}.cu").read_text()
    checked = [fn.name for fn in table.values()
               if re.search(rf"\bint {fn.name}\(", text)]
    assert checked, f"no entry point of {fns} is defined in {source}.cu"
    for fn in table.values():
        if fn.name in checked:
            assert fn.argtypes == _c_argtypes(source, fn.name), fn.name
            assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, window=5, softcap=3.0)])
def test_launch_passes_what_the_c_signature_takes(monkeypatch, kw):
    """The launch's arguments go through a ctypes function with the C
    signature: count and types must convert; values are checked too."""
    seen = {}

    def record(*args):
        seen["args"] = args
        return 0
    proto = ctypes.CFUNCTYPE(ctypes.c_int,
                             *_c_argtypes("flash_attention_sm90",
                                          "flash_attention_sm90_bf16"))
    fn = proto(record)
    monkeypatch.setattr(fa, "_kernel_fns",
                        lambda: ({torch.bfloat16: fn}, None))
    monkeypatch.setattr(fa.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    q = torch.zeros(2, 4, 5, 16, dtype=torch.bfloat16)
    k = torch.zeros(2, 9, 1, 16, dtype=torch.bfloat16).transpose(1, 2)
    before = fa.LAUNCHES
    fa._launch(q, k, k, scale=0.25, **dict(dict(window=None, softcap=None),
                                           **kw))
    assert fa.LAUNCHES == before + 1
    args = seen["args"]
    assert args[4:13] == (*q.stride()[:3], *k.stride()[:3], *k.stride()[:3])
    assert args[13:19] == (2, 4, 1, 5, 9, 16)
    assert args[19] == 0.25
    assert args[20:26] == (int("softcap" in kw and kw["softcap"] is not None),
                           kw.get("softcap") or 0.0, int(kw["causal"]),
                           int("window" in kw), kw.get("window") or 0, 7)


def _fake_cuda(monkeypatch):
    monkeypatch.setattr(fa.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))


def _recording_kernels(monkeypatch):
    """Replace both entry points with recorders; returns the call log."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append(name)
            return 0
        return fn
    monkeypatch.setattr(fa, "_kernel_fns", lambda: (
        {torch.float32: entry("flash_attention_f32"),
         torch.bfloat16: entry("flash_attention_sm90_bf16")}, None))
    _fake_cuda(monkeypatch)
    return calls


def test_launch_dispatches_bf16_to_sm90_and_fp32_to_cuda_cores(monkeypatch):
    calls = _recording_kernels(monkeypatch)
    kw = dict(causal=True, window=None, softcap=None, scale=0.25)
    before, before_sm90 = fa.LAUNCHES, fa.LAUNCHES_SM90
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 4, 8, 16, dtype=dtype)
        k = torch.zeros(1, 2, 8, 16, dtype=dtype)
        fa._launch(q, k, k, **kw)
    assert calls == ["flash_attention_sm90_bf16", "flash_attention_f32"]
    assert fa.LAUNCHES == before + 2
    assert fa.LAUNCHES_SM90 == before_sm90 + 1


def _misaligned(what, dtype):
    """q (1, 4, 8, 16) and k = v (1, 2, 8, 16) where q breaks TMA's
    16-byte rule in one way (or in a size-1 dimension, which is exempt)."""
    k = torch.zeros(1, 2, 8, 16, dtype=dtype)
    if what == "token_stride":       # 20 elements = 40 bytes a token
        q = torch.zeros(1, 4, 8, 20, dtype=dtype)[..., :16]
    elif what == "head_stride":      # (B, T, H, D) view, H stride 20
        q = torch.zeros(1, 8, 4, 20, dtype=dtype)[..., :16].transpose(1, 2)
    elif what == "batch_stride":
        q = torch.zeros(2 * 4 * 8 * 16 + 4, dtype=dtype).as_strided(
            (2, 4, 8, 16), (4 * 8 * 16 + 4, 128, 16, 1))
        k = torch.zeros(2, 2, 8, 16, dtype=dtype)
    elif what == "base":             # one element past an aligned base
        q = torch.zeros(1 + 4 * 8 * 16, dtype=dtype)[1:].view(1, 4, 8, 16)
    else:                            # "size_1_dims": Tq 1, odd strides
        q = torch.zeros(1, 4, 1, 16, dtype=dtype).as_strided(
            (1, 4, 1, 16), (3, 16, 5, 1))
    return q, k


@pytest.mark.parametrize("what", ["token_stride", "head_stride",
                                  "batch_stride", "base"])
def test_bf16_view_that_breaks_tma_alignment_raises(monkeypatch, what):
    """bf16 goes only to the TMA kernel: a view it cannot read raises
    ValueError before any kernel is called; the same view in fp32 goes
    to the CUDA-core kernel, which reads any strides."""
    calls = _recording_kernels(monkeypatch)
    kw = dict(causal=True, window=None, softcap=None, scale=0.25)
    q, k = _misaligned(what, torch.bfloat16)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        fa._launch(q, k, k, **kw)
    assert calls == [] and fa.LAUNCHES == before
    q, k = _misaligned(what, torch.float32)
    fa._launch(q, k, k, **kw)
    assert calls == ["flash_attention_f32"]


def test_size_1_dims_are_exempt_from_the_tma_rule(monkeypatch):
    calls = _recording_kernels(monkeypatch)
    q, k = _misaligned("size_1_dims", torch.bfloat16)
    fa._launch(q, k, k, causal=True, window=None, softcap=None, scale=0.25)
    assert calls == ["flash_attention_sm90_bf16"]
