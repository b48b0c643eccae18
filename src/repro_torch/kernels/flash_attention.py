"""Flash attention on the port — `repro.kernels.flash_attention`'s
kernel as hand-written Hopper kernels.

`flash_attention(q, k, v)` takes q (B, Hq, Tq, D) and k, v (B, Hkv, Tk,
D) with Hq a multiple of Hkv (q head h reads kv head h // (Hq/Hkv), the
reference's `jnp.repeat` grouping), or the reference's (BH, T, D) with
as many kv as q heads. It returns (B, Hq, Tq, D) (or (BH, Tq, D)) in
q's dtype. CPU tensors take the plain version
(`ref.multi_head_attention_ref`). CUDA tensors launch a kernel or raise,
by dtype, with no fallback between any two of these:

- bf16: `csrc/flash_attention_sm90.cu` (`flash_attention_sm90_bf16`),
  wgmma tensor cores fed by TMA. P reaches P·V as two bf16 parts (the
  rounded value and what rounding left over), so 16 bits of each
  probability count where one bf16 rounding would keep 8. TMA needs a
  16-byte aligned base and token, head and batch strides that are
  multiples of 16 bytes (size-1 dimensions exempt); a view that breaks
  this raises ValueError.
- fp32: `csrc/flash_attention.cu` (`flash_attention_f32`), fp32 CUDA
  cores, the reference's numerics (TF32 stays off).

Semantics are the reference kernel's: scale (default D^-½), optional
tanh softcap, then causal / sliding-window masks on absolute positions
with q aligned to the end of k; fp32 scores, max, denominator and P·V
accumulator; a row that sees no key gives 0. D is a multiple of 8 up to
256; inputs have unit stride along D (any strides over batch, head and
token, so the transposed views of the model need no copy).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import multi_head_attention_ref

# kernel launches since import (or since a caller reset it): a run shows
# it went through a kernel by reading these before and after. LAUNCHES
# counts both kernels, LAUNCHES_SM90 the bf16 wgmma kernel alone.
LAUNCHES = 0
LAUNCHES_SM90 = 0

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_D = 256
# q rows per block: flash_attention.cu (fp32), flash_attention_sm90.cu (bf16)
_BLOCK_Q = {torch.float32: 64, torch.bfloat16: 128}
_MAX_GRID_Y = 65535
_TMA_ALIGN = 16                    # bytes: TMA's base and stride granule
# (dtype, library, entry point); each library exports <library>_error_string
_KERNELS = ((torch.float32, "flash_attention", "flash_attention_f32"),
            (torch.bfloat16, "flash_attention_sm90",
             "flash_attention_sm90_bf16"))


@functools.cache
def _kernel_fns():
    """({dtype: entry point}, {dtype: its library's error_string})."""
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
                + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_float]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fns, errs = {}, {}
    for dtype, name, sym in _KERNELS:
        lib = _build.load(name)
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[dtype] = fn
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        errs[dtype] = err
    return fns, errs


def _check(q, k, v) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, T, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Hkv, Tk, D) = (B={B}, ·, ·, "
                         f"D={D}); got {tuple(k.shape)}, {tuple(v.shape)}")
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads "
                         f"({Hkv})")
    if D % 8 or not 8 <= D <= _MAX_D:
        raise ValueError(f"head dim D must be a multiple of 8 in "
                         f"[8, {_MAX_D}]; got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must have unit stride along D")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, softcap=None,
                    scale=None) -> torch.Tensor:
    """Attention of q over k, v (see the module docstring)."""
    flat = q.dim() == 3
    if flat:
        q, k, v = q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1)
    _check(q, k, v)
    scale = float(scale) if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        out = multi_head_attention_ref(q, k, v, **kw)
    elif q.device.type == "cuda":
        out = _launch(q, k, v, **kw)
    else:
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return out.squeeze(1) if flat else out


def _check_tma(*tensors) -> None:
    """Raise unless TMA can read each bf16 view: a 16-byte aligned base
    and strides over (batch, head, token) that are multiples of 16 bytes;
    a dimension of size 1 is never stepped, so its stride is exempt."""
    for name, t in zip("qkv", tensors):
        size = t.element_size()
        bad = [f"{what} stride {t.stride(d)}" for d, what in
               enumerate(("batch", "head", "token"))
               if t.shape[d] > 1 and t.stride(d) * size % _TMA_ALIGN]
        if t.data_ptr() % _TMA_ALIGN:
            bad.append(f"base address {t.data_ptr():#x}")
        if bad:
            raise ValueError(
                f"{name}: the bf16 kernel reads through TMA, which needs "
                f"{_TMA_ALIGN}-byte alignment; got {', '.join(bad)} "
                f"(elements of {size} bytes)")


def _launch(q, k, v, *, causal, window, softcap, scale) -> torch.Tensor:
    """Launch the dtype's CUDA kernel on validated operands on the
    current stream, without synchronising."""
    global LAUNCHES, LAUNCHES_SM90
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Tk == 0:                         # no key is visible to any row
        return out.zero_()
    if -(-Tq // _BLOCK_Q[q.dtype]) > _MAX_GRID_Y or B * Hq >= 2 ** 31 \
            or max(Tq, Tk) >= 2 ** 31:
        raise ValueError(f"shape too large for one launch: B={B}, "
                         f"Hq={Hq}, Tq={Tq}, Tk={Tk}")
    sm90 = q.dtype == torch.bfloat16
    if sm90:
        _check_tma(q, k, v)
    fns, errs = _kernel_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fns[q.dtype](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            B, Hq, Hkv, Tq, Tk, D, scale,
            int(softcap is not None),
            float(softcap) if softcap is not None else 0.0,
            int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{errs[q.dtype](err).decode()} (code {err})")
    LAUNCHES += 1
    LAUNCHES_SM90 += sm90
    return out
