"""Single source of truth for the LM's parameter trees — the port of
`repro.models.spec`.

Every block declares its parameters as a tree (nested dicts) of
`TensorSpec`s: shape, logical axes and init. `init_tree` materializes
real tensors from it on an explicit device with an explicit
`torch.Generator`; `spec_bytes` / `spec_params` count it. The
reference's `shape_tree` and `pspec_tree` (ahead-of-time shapes and
sharding specs) wait for the port's tooling slice (ROADMAP A8).

`params_from_numpy` / `params_to_numpy` carry a tree across packages:
the reference's params (or caches) as numpy leaves become tensors here,
and back. Random init cannot match jax's streams, so parity tests hand
the reference's own params over this way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal|zeros|ones|glorot
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def map_specs(fn: Callable[[TensorSpec], Any], tree):
    """fn over the TensorSpec leaves of a nested-dict tree."""
    return tree_map(fn, tree)


def init_tree(tree, generator: torch.Generator, device):
    """Materialize real tensors on `device`, drawing every random leaf
    from `generator` in the tree's leaf order (dict keys sorted, as jax
    flattens them). A tree with a random leaf needs the generator on
    `device`; zeros and ones draw nothing."""
    dev = resolve_device(device)

    def one(s: TensorSpec) -> torch.Tensor:
        kw = dict(dtype=s.dtype, device=dev)
        if s.init == "zeros":
            return torch.zeros(s.shape, **kw)
        if s.init == "ones":
            return torch.ones(s.shape, **kw)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device} cannot draw "
                             f"tensors for {dev}")
        if s.init == "glorot":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            sc = float(np.sqrt(6.0 / (fan_in + s.shape[-1])))
            u = torch.rand(s.shape, generator=generator, **kw)
            return u.mul_(2 * sc).sub_(sc)
        if s.init == "normal":
            return torch.randn(s.shape, generator=generator,
                               **kw).mul_(s.scale)
        raise ValueError(s.init)
    return map_specs(one, tree)


def stack_specs(tree, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacking dim of size n (the group axis of the body)."""
    return map_specs(
        lambda s: TensorSpec((n,) + s.shape, (axis_name,) + s.axes,
                             s.init, s.scale, s.dtype), tree)


def spec_bytes(tree) -> int:
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in tree_leaves(tree))


def spec_params(tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(tree))


def params_from_numpy(tree, device):
    """A tree of numpy arrays (the reference's params or caches through
    `np.asarray`) as tensors on `device`, dtypes kept; bfloat16 arrays
    (ml_dtypes) cross bit for bit."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, order="C", copy=True)      # owned and writable
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(dev)
    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The inverse of `params_from_numpy`, with bfloat16 leaves as
    float32 (exact). The arrays are copies, so later in-place writes
    (a cache being decoded into) do not show through them."""
    def leaf(t: torch.Tensor):
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)
