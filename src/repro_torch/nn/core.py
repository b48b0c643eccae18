"""Parameter-tree helpers — the port of `repro.nn.core`: initializers
on an explicit `torch.Generator`, gradient accumulation over
microbatches, the remat policies, and tree counts.

Initializers (`glorot`, `zeros`) draw on the host from the caller's CPU
generator, so one seed gives the same parameters on every device.
(JAX's and torch's random streams differ, so the same seed does NOT
reproduce the reference's params: parity tests move the reference's
params across instead, with `params_from_numpy`.) The reference's
`Policy` dtype triples and `split_keys` are not ported: the LM casts
its fp32 params at each use (`models/`), the GCN's precision policy is
`core/precision.py`, and torch draws from generators, not split keys.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.nn.tree import Tree, tree_leaves, tree_map, tree_unflatten


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


# ----------------------------------------------------------------------
# gradient accumulation: microbatches in turn, fp32 grads accumulated
# ----------------------------------------------------------------------
def accumulate_gradients(loss_fn: Callable, params: Tree, batch: Tree,
                         num_microbatches: int, *loss_args,
                         split: Optional[Callable] = None,
                         grad_layout: Optional[Callable] = None,
                         **loss_kw) -> Tuple[torch.Tensor, Tree, Tree]:
    """loss_fn(params, microbatch, *args, **kw) -> (loss, aux).

    `batch` leaves must have a leading dim divisible by
    num_microbatches. Returns (mean loss, mean aux, mean grads), all
    detached, zeros for a leaf the loss does not read (as jax.grad
    gives; zamba2's second shared block at one group); with
    num_microbatches <= 1 one gradient call, its grads in the params'
    dtypes; else the microbatches run in turn (one backward graph live
    at a time) and their grads accumulate in fp32.

    Two hooks serve a sharded step (`dist/steps.py` with a mesh):
    `split(batch, m)` gives the m microbatches (default: microbatch i
    is rows i·B/m … (i+1)·B/m of every leaf), `grad_layout(g, p)` each
    gradient in its param's layout before it is summed (default: g).
    """
    leaves = tree_leaves(params)

    def grad_call(mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(live, mb, *loss_args, **loss_kw)
        # a leaf the loss never reads gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True,
                                    materialize_grads=True)
        if grad_layout is not None:
            grads = [grad_layout(g, p) for g, p in zip(grads, leaves)]
        return loss.detach(), tree_map(torch.Tensor.detach, aux), grads

    m = int(num_microbatches)
    if m <= 1:
        loss, aux, grads = grad_call(batch)
        return loss, aux, tree_unflatten(params, grads)

    def rows(batch, m):
        def split_leaf(x):
            if x.shape[0] % m:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"microbatches={m}")
            return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        micro = tree_map(split_leaf, batch)
        return [tree_map(lambda x: x[i], micro) for i in range(m)]
    loss_sum, aux_sum = 0.0, None
    g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    for mb in (split or rows)(batch, m):
        loss, aux, grads = grad_call(mb)
        for acc, g in zip(g_sum, grads):
            acc.add_(g.float())
        loss_sum = loss_sum + loss
        aux_sum = aux if aux_sum is None else tree_map(torch.add, aux_sum,
                                                       aux)
    inv = 1.0 / m
    return (loss_sum * inv, tree_map(lambda x: x * inv, aux_sum),
            tree_unflatten(params, [g * inv for g in g_sum]))


# ----------------------------------------------------------------------
# remat policies
# ----------------------------------------------------------------------
# the matmul ops whose outputs `jax.checkpoint_policies.checkpoint_dots`
# saves; `..._with_no_batch_dims` saves the unbatched ones
_DOTS_NO_BATCH = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_DOTS = _DOTS_NO_BATCH + (torch.ops.aten.bmm.default,
                          torch.ops.aten.baddbmm.default)
REMAT_POLICIES = {
    "none": None,
    "full": "nothing_saveable",           # recompute everything
    "dots": "checkpoint_dots",            # save matmul outputs
    "dots_no_batch": "checkpoint_dots_with_no_batch_dims",
}


def _save_ops(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn: Callable, policy: Optional[str]) -> Callable:
    """`fn` under non-reentrant `torch.utils.checkpoint` with the named
    policy (`REMAT_POLICIES`): "full" keeps only fn's inputs, "dots" and
    "dots_no_batch" also keep the outputs of the matmuls (all of them,
    or those without a batch dim: `mm`/`addmm`, not `bmm`) through
    selective activation checkpointing; None or "none" returns fn."""
    if policy in (None, "none"):
        return fn
    if policy == "full":
        context_fn = None
    elif policy in ("dots", "dots_no_batch"):
        ops = _DOTS if policy == "dots" else _DOTS_NO_BATCH
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_save_ops, ops))
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)
    return wrapped


# ----------------------------------------------------------------------
# misc
# ----------------------------------------------------------------------
def count_params(params: Tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def tree_bytes(params: Tree) -> int:
    return sum(int(x.numel()) * x.element_size()
               for x in tree_leaves(params))
