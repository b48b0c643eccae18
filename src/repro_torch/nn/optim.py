"""Optimizers and schedules on tensor trees — the port of
`repro.nn.optim`.

Written as functions on trees, not `torch.optim`, so the optimizer
state has the reference's layout: AdamW's state is
`AdamState(step, mu, nu)` and SGD's is `(step, velocity or None)`, and a
checkpoint of either package carries the same optimizer keys
("opt/.step", "opt/.mu/layers/0/w", ...). An optimizer is a pair
(init, update); update(grads, state, params) -> (updates, state), and
updates are ADDED to params (they already contain -lr). Every quantity
stays on the params' device: a step never syncs the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.nn.tree import Tree, tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------
def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, end_frac: float = 0.1
                           ) -> Schedule:
    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(1.0, warmup_steps)
        t = torch.clamp((step - warmup_steps)
                        / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (end_frac + (1 - end_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def warmup_linear_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int) -> Schedule:
    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(1.0, warmup_steps)
        t = torch.clamp((step - warmup_steps)
                        / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak_lr * (1.0 - t))
    return fn


# ----------------------------------------------------------------------
# optimizer core
# ----------------------------------------------------------------------
class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


def _device_of(tree: Tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return (torch.sqrt(torch.sum(torch.stack(leaves))) if leaves
            else torch.zeros(()))


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = None,
          mu_dtype: torch.dtype = torch.float32) -> Optimizer:
    sched = (learning_rate if callable(learning_rate)
             else constant_schedule(learning_rate))

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=mu_dtype)  # noqa: E731
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=_device_of(params)),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state, params):
        grads = tree_map(lambda g: g.float(), grads)
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr = sched(step)
        stepf = step.float()
        bc1 = 1 - b1 ** stepf           # scalar base: no host→device copy
        bc2 = 1 - b2 ** stepf

        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                      state.nu, grads)

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_map(upd, params, mu, nu)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(learning_rate, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    sched = (learning_rate if callable(learning_rate)
             else constant_schedule(learning_rate))

    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
        if momentum:
            return (step, tree_map(torch.zeros_like, params))
        return (step, None)

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step, vel = state
        step = step + 1
        lr = sched(step)
        if momentum:
            vel = tree_map(lambda v, g: momentum * v + g, vel, grads)
            updates = tree_map(lambda v: -lr * v, vel)
        else:
            updates = tree_map(lambda g: -lr * g, grads)
        return updates, (step, vel)

    return Optimizer(init=init, update=update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
