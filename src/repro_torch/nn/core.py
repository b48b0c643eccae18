"""Parameter initializers on an explicit `torch.Generator`.

Counterparts of `repro.nn.core.glorot` / `zeros_init`. Values are drawn
on the host from the caller's CPU generator and then moved, so one seed
gives the same parameters on every device. (JAX's and torch's random
streams differ, so the same seed does NOT reproduce the reference's
params: parity tests move the reference's params across instead, with
`repro_torch.core.gcn.params_from_numpy`.)
"""
from __future__ import annotations

from typing import Sequence

import torch


def glorot(generator: torch.Generator, shape: Sequence[int],
           dtype: torch.dtype = torch.float32, in_axis: int = -2,
           out_axis: int = -1) -> torch.Tensor:
    """Uniform(-s, s) with s = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[in_axis], shape[out_axis]
    scale = (6.0 / (fan_in + fan_out)) ** 0.5
    out = torch.empty(tuple(shape), dtype=dtype)
    return out.uniform_(-scale, scale, generator=generator)


def zeros(shape: Sequence[int],
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype)
