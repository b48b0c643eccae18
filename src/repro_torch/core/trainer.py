"""Cluster-GCN trainer (paper Algorithm 1) and exact full-graph
evaluation — the port of `repro.core.trainer`.

`train_cluster_gcn` is a thin wrapper over the step-driven Engine
(core.engine): a SingleDeviceBackend, the standard hooks (periodic
eval, verbose logging), and `Engine.fit()`. For the declarative path —
presets, checkpoint/resume, preemption — see core.experiment and
`python -m repro_torch.launch.run_experiment`.

Evaluation propagates the FULL graph layer by layer with scipy CSR on
the host — exact, independent of the training batching and of every
kernel it checks (`full_graph_logits` is also the host oracle behind
`serve_gcn --verify-parity`).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.batching import ClusterBatcher
from repro_torch.core.engine import (Engine, EvalHook, LoggingHook,
                                     SingleDeviceBackend, TrainResult)
from repro_torch.core.gcn import GCNConfig, micro_f1, params_tree
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.normalization import normalize_csr
from repro_torch.nn.optim import Optimizer


def _numpy_layers(params):
    """The params (a GCN module or a tree) as fp32 numpy layer dicts."""
    return [{k: (v.detach().float().cpu().numpy()
                 if isinstance(v, torch.Tensor)
                 else np.asarray(v, np.float32)) for k, v in layer.items()}
            for layer in params_tree(params)["layers"]]


def full_graph_logits(params, graph: CSRGraph, cfg: GCNConfig,
                      norm: str = "eq10",
                      diag_lambda: float = 0.0) -> np.ndarray:
    """Exact layer-wise propagation on the host (scipy CSR), fp32."""
    import scipy.sparse as sp
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data,
                               norm, diag_lambda)
    a = sp.csr_matrix((dt, ix, ip), shape=(graph.num_nodes,) * 2)
    h = graph.features.astype(np.float32)
    if cfg.precompute_ax:
        h = a @ h
    layers = _numpy_layers(params)
    for i, layer in enumerate(layers):
        z = h @ layer["w"] + layer["b"]
        if not (i == 0 and cfg.precompute_ax):
            z = a @ z
        if i < len(layers) - 1:
            if cfg.residual and z.shape == h.shape:
                z = z + h
            z = np.maximum(z, 0.0)
            if cfg.layernorm:
                mu = z.mean(-1, keepdims=True)
                sd = z.std(-1, keepdims=True)
                z = (z - mu) / (sd + 1e-6) * layer["ln_scale"]
        h = z
    return h


def evaluate(params, graph: CSRGraph, cfg: GCNConfig, mask: np.ndarray,
             norm: str = "eq10", diag_lambda: float = 0.0) -> float:
    """Micro-F1 (multilabel) or accuracy (multiclass) on `mask` nodes."""
    logits = full_graph_logits(params, graph, cfg, norm, diag_lambda)
    if cfg.multilabel:
        y = graph.labels[mask]
        pred = (logits[mask] > 0).astype(np.float32)
        tp = float((pred * y).sum())
        fp = float((pred * (1 - y)).sum())
        fn = float(((1 - pred) * y).sum())
        return micro_f1(tp, fp, fn)
    pred = logits[mask].argmax(-1)
    return float((pred == graph.labels[mask]).mean())


def train_cluster_gcn(graph: CSRGraph, batcher: ClusterBatcher,
                      cfg: GCNConfig, opt: Optimizer, num_epochs: int,
                      seed: int = 0, eval_every: int = 0,
                      eval_graph: CSRGraph | None = None,
                      verbose: bool = False, sparse_adj: bool = False,
                      prefetch: int = 0, device="cuda") -> TrainResult:
    """Paper Algorithm 1 on one device (`device` defaults to "cuda" and
    raises without a GPU unless "cpu" is given). `graph` is the training
    graph (inductive); `eval_graph` (default: graph) the full graph for
    evaluation. `sparse_adj=True` switches the batcher to BlockEllAdj
    batches, so every Â·(XW) runs through the block-ELL kernels.
    `prefetch=N` builds batches N ahead on a background thread,
    including the copy to the device. Eval runs every `eval_every`
    epochs on the val split, falling back to the test split with a
    one-time warning."""
    if sparse_adj and not batcher.sparse_adj:
        batcher = dataclasses.replace(batcher, sparse_adj=True)
    if cfg.precompute_ax and not getattr(batcher, "precompute_ax", False):
        warnings.warn(
            "cfg.precompute_ax=True but the batcher was built with "
            "precompute_ax=False — rebuilding the batcher with "
            "payload-time A'X aggregation to match the model",
            stacklevel=2)
        batcher = dataclasses.replace(batcher, precompute_ax=True)
    backend = SingleDeviceBackend(cfg, opt, device=device)
    hooks = []
    if eval_every:
        hooks.append(EvalHook(eval_graph if eval_graph is not None
                              else graph, cfg,
                              every=eval_every, split="auto",
                              norm=batcher.norm,
                              diag_lambda=batcher.diag_lambda))
    if verbose:
        hooks.append(LoggingHook())
    engine = Engine(batcher, cfg, backend, epochs=num_epochs, seed=seed,
                    prefetch=prefetch, hooks=hooks)
    return engine.fit()
