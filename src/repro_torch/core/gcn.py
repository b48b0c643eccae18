"""GCN model (paper Eq. 1/8/9/10/11) — the port of `repro.core.gcn`.

The per-batch compute is the paper's: Z^{l+1} = Â (X^l W^l + b),
X^{l+1} = σ(Z^{l+1}), with Â the re-normalized q-cluster union block the
batcher builds on the host. Each Â·H product dispatches through
`kernels.ops.spmm` (or `spmm_xw` under `fuse_spmm`): a dense Â stays a
`torch.matmul`, a `BlockEllAdj` goes to the block-ELL CUDA kernels whose
backward runs on the host-built transposed tiles.

Parameters come in two forms with one layout: a `GCN` module (serving
restores one; `params_to_numpy(gcn)` is the reference's pytree) and a
plain tree `{"layers": [{"w", "b", "ln_scale"?}, ...]}` of tensors, which
training updates functionally (`params_tree`). `w` is (din, dout), `b`
(dout,), and `ln_scale` (dout,) sits on every layer but the last when
`cfg.layernorm` is on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.precision import policy_from_config
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import spmm as spmm_dispatch
from repro_torch.kernels.ops import spmm_xw as spmm_xw_dispatch
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
    remat: bool = False           # torch.utils.checkpoint over layer chunks
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


def params_tree(params) -> Dict[str, Any]:
    """A `GCN` module's parameters as a tree of tensors; a tree passes
    through unchanged."""
    if not isinstance(params, GCN):
        return params
    layers = []
    for layer in params.layers:
        d = {"w": layer.w, "b": layer.b}
        if layer.ln_scale is not None:
            d["ln_scale"] = layer.ln_scale
        layers.append(d)
    return {"layers": layers}


def init_params(cfg: GCNConfig, *, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """`init_gcn`'s parameters as a detached tree on `device`."""
    gcn = init_gcn(cfg, generator=generator, device=device)
    return {"layers": [{k: v.detach() for k, v in layer.items()}
                       for layer in params_tree(gcn)["layers"]]}


# ----------------------------------------------------------------------
# forward and loss on one batch
# ----------------------------------------------------------------------
def _layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # population variance and rsqrt(var + 1e-6), as the reference's
    # `_layernorm` (torch.var would default to the unbiased estimate)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of operands in their (compute) dtype, fp32 accumulation,
    fp32 result."""
    return torch.matmul(a.float(), b.float())


def _dropout_masks(x: torch.Tensor, cfg: GCNConfig,
                  generator: Optional[torch.Generator]
                  ) -> List[Optional[torch.Tensor]]:
    """Every layer's keep mask (layer i's input is (n, dims[i][0])),
    drawn up front in layer order from `generator` — the counterpart of
    the reference's pre-split per-layer keys: the draws do not depend on
    how layers are grouped for recomputation, and a recomputed chunk
    reuses its masks (torch.utils.checkpoint does not restore a user
    generator)."""
    if cfg.dropout <= 0 or generator is None:
        return [None] * cfg.num_layers
    keep = 1.0 - cfg.dropout
    n = x.shape[0]
    return [torch.rand((n, din), generator=generator,
                       device=x.device) < keep for din, _ in cfg.dims]


def gcn_forward(params, adj, x: torch.Tensor, cfg: GCNConfig, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                spmm: Callable = spmm_dispatch,
                spmm_xw: Callable = spmm_xw_dispatch) -> torch.Tensor:
    """Final-layer logits Z^{(L)} in fp32 (no activation on the last
    layer) — `repro.core.gcn.gcn_forward`.

    Precision (cfg.precision): activations and matmul operands run in
    the compute dtype, every matmul accumulates fp32, layernorm
    statistics are fp32. Dropout (train and cfg.dropout > 0) draws from
    `generator`. Memory (cfg.remat / remat_chunk): layers are grouped
    into chunks of `remat_chunk`, each run under torch.utils.checkpoint,
    so the backward recomputes a chunk's activations instead of holding
    them."""
    params = params_tree(params)
    cd = policy_from_config(cfg).compute_dtype
    layers = params["layers"]
    n = len(layers)
    masks = (_dropout_masks(x, cfg, generator) if train
             else [None] * cfg.num_layers)
    keep = 1.0 - cfg.dropout

    def layer_fn(i, h, layer, mask):
        if mask is not None:
            h = h * mask.to(h.dtype) / keep
        propagate = not (i == 0 and cfg.precompute_ax)
        if cfg.fuse_spmm and propagate:
            # fused Â·(XW + b): the same contract as the unfused branch
            z = spmm_xw(adj, h.to(cd), layer["w"], layer["b"])
        else:
            z = (_mm(h.to(cd), layer["w"].to(cd)) + layer["b"]).to(cd)
            if propagate:                # Â (XW): (b, b)·(b, F')
                z = spmm(adj, z)
        if i < n - 1:
            if cfg.residual and z.shape == h.shape:
                z = z + h.to(z.dtype)            # paper Eq. 8
            z = torch.relu(z)
            if cfg.layernorm:
                z = _layernorm(z.float(), layer["ln_scale"]).to(cd)
        return z

    h = x.to(cd)
    if cfg.remat:
        chunk = max(1, int(cfg.remat_chunk))
        for s in range(0, n, chunk):
            idx = range(s, min(n, s + chunk))

            def chunk_fn(h, *_params, idx=idx):
                for i in idx:
                    h = layer_fn(i, h, layers[i], masks[i])
                return h
            # the chunk's params are explicit inputs so the recompute
            # sees the same tensors; the masks are closed over, drawn once
            h = checkpoint(chunk_fn, h,
                           *[t for i in idx for t in layers[i].values()],
                           use_reentrant=False)
    else:
        for i in range(n):
            h = layer_fn(i, h, layers[i], masks[i])
    return h.float()


def gcn_loss(params, batch_tuple, cfg: GCNConfig, *, train: bool = True,
             generator: Optional[torch.Generator] = None,
             spmm: Callable = spmm_dispatch,
             spmm_xw: Callable = spmm_xw_dispatch):
    """(loss, aux) on a device batch tuple (adj, feats, labels,
    node_mask, loss_mask, num_real) — `repro.core.gcn.gcn_loss`. aux
    carries the micro-F1 parts (multilabel) or the correct count, as
    0-d tensors (no host sync)."""
    adj, feats, labels, node_mask, loss_mask, num_real = batch_tuple
    logits = gcn_forward(params, adj, feats, cfg, train=train,
                         generator=generator, spmm=spmm, spmm_xw=spmm_xw)
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    if cfg.multilabel:
        y = labels.float()
        # at a logit of exactly 0 (common under bf16) take the
        # reference's subgradients: jnp.maximum splits a tie (as
        # torch.maximum does) and jnp.abs has derivative +1 at 0 (as the
        # select below does; torch.abs has 0 there)
        absl = torch.where(logits >= 0, logits, -logits)
        ll = (torch.maximum(logits, logits.new_zeros(())) - logits * y
              + torch.log1p(torch.exp(-absl)))
        loss = (ll.sum(-1) * loss_mask).sum() / denom
        pred = (logits > 0).float()
        m = loss_mask[:, None]
        aux = {"tp": (pred * y * m).sum(), "fp": (pred * (1 - y) * m).sum(),
               "fn": ((1 - pred) * y * m).sum(), "n": denom}
    else:
        logp = torch.log_softmax(logits.float(), -1)
        nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
        loss = (nll * loss_mask).sum() / denom
        correct = (logits.argmax(-1) == labels).float()
        aux = {"correct": (correct * loss_mask).sum(), "n": denom}
    return loss, aux


def micro_f1(tp: float, fp: float, fn: float) -> float:
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0
