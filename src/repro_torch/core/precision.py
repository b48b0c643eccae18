"""One precision/memory policy from spec to kernel — the port of
`repro.core.precision`.

  * params stay fp32 (master weights: Adam moments and updates are
    exact);
  * activations and matmul OPERANDS are cast to `compute` ("fp32" or
    "bf16") per layer, while every matmul ACCUMULATES in fp32 (the
    products in `kernels.ops`/`kernels.block_spmm` and both CUDA
    kernels);
  * the loss is optionally scaled before the backward pass ("static" or
    "dynamic") and gradients are unscaled in fp32 before the optimizer;
  * with dynamic scaling a non-finite gradient skips the step (params
    and optimizer state kept) and backs the scale off; `growth_interval`
    consecutive finite steps grow it back.

The skip is a device-side select (`torch.where` on a 0-d bool), so a
scaled step never syncs the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.nn.tree import Tree, tree_leaves, tree_map

_COMPUTES = ("fp32", "bf16")
_SCALINGS = ("none", "static", "dynamic")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The spec-to-kernel precision contract (see module docstring).

    compute:         activation/operand dtype, "fp32" or "bf16"
                     (params and accumulators are always fp32)
    loss_scaling:    "none" | "static" | "dynamic"
    init_scale:      starting (static: constant) loss scale
    growth_interval: finite steps before a dynamic scale doubles
    growth_factor / backoff_factor: dynamic scale multipliers
    min_scale / max_scale: dynamic scale clamp
    """
    compute: str = "fp32"
    loss_scaling: str = "none"
    init_scale: float = 2.0 ** 15
    growth_interval: int = 200
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def __post_init__(self):
        if self.compute not in _COMPUTES:
            raise ValueError(f"precision must be one of {_COMPUTES}; "
                             f"got {self.compute!r}")
        if self.loss_scaling not in _SCALINGS:
            raise ValueError(f"loss_scaling must be one of {_SCALINGS}; "
                             f"got {self.loss_scaling!r}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute == "bf16" else torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def mixed(self) -> bool:
        return self.compute != "fp32"

    @property
    def scaled(self) -> bool:
        return self.loss_scaling != "none"

    @property
    def dynamic(self) -> bool:
        return self.loss_scaling == "dynamic"


def policy_from_config(cfg) -> PrecisionPolicy:
    """GCNConfig (precision / loss_scaling / loss_scale fields) → policy."""
    return PrecisionPolicy(
        compute=getattr(cfg, "precision", "fp32"),
        loss_scaling=getattr(cfg, "loss_scaling", "none"),
        init_scale=float(getattr(cfg, "loss_scale", 2.0 ** 15)))


def init_scale_state(policy: PrecisionPolicy,
                     device="cpu") -> Optional[Dict]:
    """{"scale": f32, "good": i32 consecutive finite steps} on `device`,
    or None when the policy does not scale."""
    if not policy.scaled:
        return None
    return {"scale": torch.tensor(policy.init_scale, dtype=torch.float32,
                                  device=device),
            "good": torch.zeros((), dtype=torch.int32, device=device)}


def scale_loss(loss, scale):
    return loss * scale


def unscale_grads(grads: Tree, scale) -> Tree:
    inv = 1.0 / scale
    return tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)


def all_finite(tree: Tree) -> torch.Tensor:
    """0-d bool tensor: every leaf of `tree` is finite everywhere."""
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()


def update_scale_state(state: Dict, finite, policy: PrecisionPolicy) -> Dict:
    """One dynamic-loss-scale transition: backoff on a non-finite step,
    grow after `growth_interval` consecutive finite ones. Static scaling
    is the identity."""
    if not policy.dynamic:
        return state
    good = torch.where(finite, state["good"] + 1, torch.zeros_like(
        state["good"]))
    grow = good >= policy.growth_interval
    scale = torch.where(
        finite,
        torch.where(grow,
                    torch.clamp(state["scale"] * policy.growth_factor,
                                max=policy.max_scale),
                    state["scale"]),
        torch.clamp(state["scale"] * policy.backoff_factor,
                    min=policy.min_scale))
    good = torch.where(grow, torch.zeros_like(good), good)
    return {"scale": scale, "good": good}


def select_tree(pred, on_true: Tree, on_false: Tree) -> Tree:
    """Leaf-wise torch.where — the step-skip select (pred is 0-d)."""
    return tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)
