"""GCN model parameters (paper Eq. 1/8/9/10/11) as a torch `nn.Module`.

Counterpart of `repro.core.gcn`. This slice carries the config and the
parameters; the per-layer math lives where serving runs it
(`serve.embedding_cache`, transform → propagate → residual → relu →
layernorm) and in the host oracle (`core.trainer.full_graph_logits`).
The batch `gcn_forward`/`gcn_loss` come with the training slice.

Parameter layout matches the reference's pytree one to one:
`gcn.layers[i].w` (din, dout), `.b` (dout,), and `.ln_scale` (dout,) on
every layer but the last when `cfg.layernorm` is on — so
`params_to_numpy(gcn)` is `{"layers": [{"w", "b", "ln_scale"}, ...]}`,
the tree the reference's checkpoints store.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.nn.core import glorot, zeros


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    in_dim: int
    hidden_dim: int
    out_dim: int
    num_layers: int = 3
    dropout: float = 0.2          # paper §4: dropout 20%
    residual: bool = False        # paper Eq. 8
    multilabel: bool = False      # PPI/Amazon: sigmoid BCE; else softmax CE
    layernorm: bool = True        # used by the deep-GCN experiments
    precompute_ax: bool = False   # paper §6.2: A'X arrives pre-aggregated
                                  # and layer 1 skips its propagation
    precision: str = "fp32"       # compute dtype ("fp32"|"bf16"); params
                                  # and matmul accumulators stay fp32
    loss_scaling: str = "none"    # "none" | "static" | "dynamic"
    loss_scale: float = 2.0 ** 15  # initial (static: constant) scale
    remat: bool = False           # recompute activations per layer chunk
    remat_chunk: int = 2          # layers per remat chunk
    fuse_spmm: bool = False       # route each layer's Â·(XW+b) through
                                  # the fused one-pass kernel seam

    @property
    def dims(self):
        ds = [self.in_dim] + [self.hidden_dim] * (self.num_layers - 1) \
             + [self.out_dim]
        return list(zip(ds[:-1], ds[1:]))


class GCNLayer(nn.Module):
    """One layer's parameters: w (din, dout), b (dout,), optional
    ln_scale (dout,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor,
                 ln_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        if ln_scale is None:
            self.register_parameter("ln_scale", None)
        else:
            self.ln_scale = nn.Parameter(ln_scale)


class GCN(nn.Module):
    """The GCN's parameters, `layers[i]` in layer order."""

    def __init__(self, layers: Sequence[GCNLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.layers[0].w.device


def init_gcn(cfg: GCNConfig, *, generator: torch.Generator,
             device) -> GCN:
    """Glorot weights, zero biases, unit layernorm scales — the
    reference's init scheme, drawn from `generator` (a CPU generator:
    the same seed gives the same params on every device)."""
    dev = resolve_device(device)
    layers = []
    for i, (din, dout) in enumerate(cfg.dims):
        ln = (torch.ones(dout) if cfg.layernorm and i < cfg.num_layers - 1
              else None)
        layers.append(GCNLayer(glorot(generator, (din, dout)),
                               zeros((dout,)), ln))
    return GCN(layers).to(dev)


def params_from_numpy(tree: Dict[str, Any], device) -> GCN:
    """A GCN on `device` from the reference's params pytree as numpy
    (or tensor) leaves: {"layers": [{"w", "b", "ln_scale"?}, ...]}."""
    dev = resolve_device(device)

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(torch.float32).clone()
        return torch.from_numpy(np.array(v, dtype=np.float32))

    layers = [GCNLayer(leaf(l["w"]), leaf(l["b"]),
                       leaf(l["ln_scale"]) if "ln_scale" in l else None)
              for l in tree["layers"]]
    return GCN(layers).to(dev)


def params_to_numpy(gcn: GCN) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: the reference's pytree layout
    with fp32 numpy leaves (what CheckpointManager.save stores)."""
    layers = []
    for layer in gcn.layers:
        d = {"w": layer.w.detach().cpu().numpy(),
             "b": layer.b.detach().cpu().numpy()}
        if layer.ln_scale is not None:
            d["ln_scale"] = layer.ln_scale.detach().cpu().numpy()
        layers.append(d)
    return {"layers": layers}
