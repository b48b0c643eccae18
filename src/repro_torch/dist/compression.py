"""Gradient compression for the data-parallel all-reduce — the port of
`repro.dist.compression` on `torch.distributed`.

Symmetric quantization (int4/int8 in an int8 container) with error
feedback: each rank quantizes (grad + carried error), reduces the
dequantized message, and carries the quantization residual into the
next step. The residual telescopes, so the accumulated update is
unbiased. Scales are per group of `group_size` consecutive elements of
the flattened tensor (zero-padded to a group multiple); `group_size=None`
keeps one scale per tensor.

The arithmetic is the reference's, operation for operation: `torch.round`
rounds half to even as `jnp.rint` does, a NaN code becomes 0 as XLA's
float → int8 conversion makes it, and the all-reduce sums the
DEQUANTIZED fp32 message. That is the reference's own choice ("the wire
format is simulated while the numerics are exact to the algorithm"), so
the bytes on the wire are fp32 here too. Where the reference takes a
shard_map `axis_name`, these functions take a `torch.distributed`
process group (None: the default group). They are elementwise stages
in plain PyTorch, as the reference's are `jnp` outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

# per-group quantization bucket (elements) used by the gradient sync
DEFAULT_GROUP_SIZE = 1024


def quantize_symmetric(x: torch.Tensor, bits: int = 8, eps: float = 1e-12,
                       group_size: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization to `bits` (4 or 8) in an int8 container.
    Returns (q, scale) with q shaped like x; max |x| of each scale's
    domain maps to the top code, so the round-trip error is at most
    scale/2. group_size=None (or a tensor no bigger than one group)
    gives one 0-d scale; otherwise one fp32 scale per group of the
    flattened, zero-padded tensor — pass the same group_size to
    `dequantize`."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)            # 7 or 127
    x = x.float()
    floor = torch.tensor(eps, dtype=torch.float32, device=x.device)

    def codes(v):
        q = torch.clamp(torch.round(v), -qmax, qmax)
        return torch.nan_to_num(q, nan=0.0).to(torch.int8)

    if group_size is None or x.numel() <= group_size:
        scale = torch.maximum(x.abs().max() / qmax, floor)
        return codes(x / scale), scale
    g = int(group_size)
    if g < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    n = x.numel()
    groups = torch.nn.functional.pad(x.reshape(-1), (0, (-n) % g)) \
        .reshape(-1, g)
    scale = torch.maximum(groups.abs().amax(dim=1) / qmax, floor)
    q = codes(groups / scale[:, None])
    return q.reshape(-1)[:n].reshape(x.shape), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               group_size: Optional[int] = None) -> torch.Tensor:
    """Inverse of `quantize_symmetric` — pass the group_size it was
    quantized with (a 0-d scale ignores it)."""
    if scale.dim() == 0:
        return q.float() * scale
    if group_size is None:
        raise ValueError("grouped scales need the group_size they were "
                         "quantized with")
    g = int(group_size)
    n = q.numel()
    flat = torch.nn.functional.pad(q.float().reshape(-1), (0, (-n) % g))
    out = (flat.reshape(-1, g) * scale[:, None]).reshape(-1)[:n]
    return out.reshape(q.shape)


def psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Exact mean all-reduce over `group` (the uncompressed baseline the
    variants below approximate). Returns a new tensor."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / dist.get_world_size(group)


def bf16_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean all-reduce of the bf16-rounded message, accumulated in fp32
    (the reference's bf16 wire format: cast down, back up, reduce)."""
    y = psum_mean(x.to(torch.bfloat16).float(), group)
    return y.to(x.dtype)


def error_feedback_message(local: torch.Tensor, err: torch.Tensor,
                           bits: int = 8,
                           group_size: Optional[int] = DEFAULT_GROUP_SIZE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the dequantized message a rank contributes, its new residual):
    local + err quantized and dequantized, and what that lost."""
    x = local.float() + err.float()
    q, scale = quantize_symmetric(x, bits=bits, group_size=group_size)
    deq = dequantize(q, scale, group_size=group_size)
    return deq, x - deq


def compressed_psum_mean(local: torch.Tensor, err: torch.Tensor, group=None,
                         bits: int = 8,
                         group_size: Optional[int] = DEFAULT_GROUP_SIZE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-bit mean all-reduce with error feedback.

    local : this rank's contribution (its gradient)
    err   : the quantization residual it carried from the previous step
    Returns (mean over the group, new residual to carry)."""
    deq, new_err = error_feedback_message(local, err, bits, group_size)
    return psum_mean(deq, group).to(local.dtype), new_err
