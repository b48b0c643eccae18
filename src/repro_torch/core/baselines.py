"""Baseline GCN training algorithms the paper compares against (Table 1)
— the port of `repro.core.baselines`.

* FullBatchGCN   — Kipf & Welling [9]: full-graph gradient descent.
                   Propagation is an edge-list segment sum (`index_add`
                   over the normalized edge list, differentiable through
                   autograd). Memory O(N·F·L).
* ExpansionSGD   — "vanilla SGD": exact mini-batch gradients via L-hop
                   neighborhood closure (exponential blow-up — the paper's
                   motivating pathology). Exactness argument: the L-hop
                   induced subgraph with full-graph normalization gives
                   exact embeddings for the batch nodes.
* SAGESampling   — GraphSAGE [5]-style fixed-size neighbor sampling with a
                   mean aggregator.
* VRGCN          — [2]: historical embeddings + control-variate estimator,
                   r sampled neighbors (r=2 as the paper uses). Stores
                   O(N·F·L) history — the memory cost Table 5 reports.

Each trainer keeps the reference's signature plus `device=` (default
"cuda"; raises without a GPU unless "cpu" is given) and returns the
reference's dict (`history`, `params` as a tree of tensors, `seconds`,
and VR-GCN's `history_bytes`). The host numpy work — the epoch
permutations, the L-hop closures, SAGE's neighbor tables and VR-GCN's
history with its refresh — is the reference's, draw for draw, so the
same seed samples the same batches. The device work is plain PyTorch
with autograd and the port's optimizers: the reference computes these
with XLA gathers, segment sums and matmuls and reaches no Pallas
kernel. Dropout draws from a generator seeded with `seed + 1` on the
device. On CUDA `index_add` sums with atomics, so its order (and the
last bits) are not fixed.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core.gcn import (GCNConfig, bce_with_logits, gcn_loss,
                                  init_gcn, params_tree)
from repro_torch.core.trainer import evaluate
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.normalization import normalize_csr
from repro_torch.nn.optim import Optimizer, apply_updates
from repro_torch.nn.tree import tree_leaves, tree_map


# ----------------------------------------------------------------------
# shared: full-graph normalized adjacency as edge list (device-resident)
# ----------------------------------------------------------------------
def _norm_edges(graph: CSRGraph, norm: str, device="cuda"):
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data, norm)
    rows = np.repeat(np.arange(graph.num_nodes), np.diff(ip))
    dev = resolve_device(device)
    return (torch.as_tensor(rows, dtype=torch.int64, device=dev),
            torch.as_tensor(ix, dtype=torch.int64, device=dev),
            torch.as_tensor(dt, dtype=torch.float32, device=dev))


def _propagate(rows, cols, vals, h, num_nodes):
    """A' @ h via segment sum (differentiable)."""
    gathered = h[cols] * vals[:, None]
    return h.new_zeros((num_nodes, h.shape[1])).index_add(0, rows, gathered)


def _layernorm(z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # the baselines' own form: (z - mu) / (population std + 1e-6), not
    # gcn._layernorm's rsqrt(var + 1e-6)
    mu = z.mean(-1, keepdim=True)
    return (z - mu) / (z.std(-1, keepdim=True, correction=0) + 1e-6) * scale


def _dropout(h: torch.Tensor, cfg: GCNConfig,
             gen: torch.Generator) -> torch.Tensor:
    if cfg.dropout <= 0:
        return h
    keep = 1.0 - cfg.dropout
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return h * mask.to(h.dtype) / keep


def _rows_loss(h: torch.Tensor, labels: torch.Tensor,
               cfg: GCNConfig) -> torch.Tensor:
    """Per-row loss: summed sigmoid BCE (multilabel) or softmax NLL."""
    if cfg.multilabel:
        return bce_with_logits(h, labels.float()).sum(-1)
    logp = torch.log_softmax(h, -1)
    return -torch.gather(logp, 1, labels[:, None].long())[:, 0]


def _init(cfg: GCNConfig, seed: int, dev: torch.device):
    """The seeded params as a tree, and the dropout generator."""
    gcn = init_gcn(cfg, generator=torch.Generator().manual_seed(seed),
                   device=dev)
    params = tree_map(lambda t: t.detach(), params_tree(gcn))
    return params, torch.Generator(device=dev).manual_seed(seed + 1)


def _update(params, opt: Optimizer, opt_state, loss_fn: Callable, *args):
    """One gradient step: loss_fn(params, *args) -> loss or (loss, aux);
    returns (params, opt_state, loss). A param the loss does not reach
    gets a zero gradient, as under jax.grad (VR-GCN's estimator feeds
    each layer from the history, so only the last layer's params reach
    its loss)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    out = loss_fn(live, *args)
    loss = out[0] if isinstance(out, tuple) else out
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True,
                                     materialize_grads=True))
    grads = tree_map(lambda _: next(grads), live)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return params, opt_state, loss.detach()


def _record(epoch: int, loss: float, t0: float, eval_every: int, params,
            graph: CSRGraph, cfg: GCNConfig, norm: str) -> Dict[str, Any]:
    rec = {"epoch": epoch, "loss": loss, "time": time.perf_counter() - t0}
    if eval_every and (epoch + 1) % eval_every == 0:
        mask = (graph.val_mask if graph.val_mask is not None
                and graph.val_mask.any() else graph.test_mask)
        rec["val_score"] = evaluate(params, graph, cfg, mask, norm)
    return rec


# ----------------------------------------------------------------------
# 1. full-batch gradient descent
# ----------------------------------------------------------------------
def train_full_batch(graph: CSRGraph, cfg: GCNConfig, opt: Optimizer,
                     num_epochs: int, norm: str = "eq10", seed: int = 0,
                     eval_every: int = 0, device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    rows, cols, vals = _norm_edges(graph, norm, dev)
    n = graph.num_nodes
    feats = torch.as_tensor(graph.features, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(graph.labels, device=dev)
    lmask = torch.as_tensor(graph.train_mask.astype(np.float32), device=dev)
    params, gen = _init(cfg, seed, dev)
    opt_state = opt.init(params)

    def loss_fn(p):
        h = feats
        layers = p["layers"]
        for i, layer in enumerate(layers):
            h = _dropout(h, cfg, gen)
            z = h @ layer["w"] + layer["b"]
            z = _propagate(rows, cols, vals, z, n)
            if i < len(layers) - 1:
                z = torch.relu(z)
                if cfg.layernorm:
                    z = _layernorm(z, layer["ln_scale"])
            h = z
        denom = torch.clamp(lmask.sum(), min=1.0)
        return (_rows_loss(h, labels, cfg) * lmask).sum() / denom

    hist = []
    t0 = time.perf_counter()
    for epoch in range(num_epochs):
        params, opt_state, loss = _update(params, opt, opt_state, loss_fn)
        hist.append(_record(epoch, float(loss), t0, eval_every, params,
                            graph, cfg, norm))
    return {"history": hist, "params": params,
            "seconds": time.perf_counter() - t0}


# ----------------------------------------------------------------------
# 2. vanilla SGD with exact L-hop expansion
# ----------------------------------------------------------------------
def lhop_closure(graph: CSRGraph, batch_nodes: np.ndarray, L: int,
                 cap: Optional[int] = None) -> np.ndarray:
    """Batch ∪ 1..L-hop neighbors (the paper's d^L expansion)."""
    seen = np.zeros(graph.num_nodes, bool)
    seen[batch_nodes] = True
    frontier = batch_nodes
    order = [batch_nodes]
    for _ in range(L):
        starts, ends = graph.indptr[frontier], graph.indptr[frontier + 1]
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            break
        pos = np.cumsum(np.concatenate([[0], counts]))
        flat = (np.repeat(starts, counts)
                + np.arange(total, dtype=np.int64)
                - np.repeat(pos[:-1], counts))
        nbr = np.unique(graph.indices[flat])
        nbr = nbr[~seen[nbr]]
        seen[nbr] = True
        order.append(nbr)
        frontier = nbr
        if cap is not None and sum(len(o) for o in order) > cap:
            break
    return np.concatenate(order)


def expansion_stats(graph: CSRGraph, batch_size: int, L: int,
                    trials: int = 5, seed: int = 0) -> Dict[str, float]:
    """Measures the d^L blow-up (motivating Table 1 numbers)."""
    rng = np.random.default_rng(seed)
    train_ids = np.where(graph.train_mask)[0] if graph.train_mask is not None \
        else np.arange(graph.num_nodes)
    sizes = []
    for _ in range(trials):
        b = rng.choice(train_ids, size=min(batch_size, len(train_ids)),
                       replace=False)
        sizes.append(len(lhop_closure(graph, b, L)))
    return {"mean_expanded": float(np.mean(sizes)),
            "expansion_factor": float(np.mean(sizes)) / batch_size}


def train_expansion_sgd(graph: CSRGraph, cfg: GCNConfig, opt: Optimizer,
                        num_epochs: int, batch_size: int = 512,
                        norm: str = "eq10", seed: int = 0,
                        node_cap: int = 16384,
                        eval_every: int = 0,
                        device="cuda") -> Dict[str, Any]:
    """Exact mini-batch SGD via L-hop closure + dense padded blocks."""
    dev = resolve_device(device)
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data, norm)
    a_norm = sp.csr_matrix((dt, ix, ip), shape=(graph.num_nodes,) * 2)
    params, gen = _init(cfg, seed, dev)
    opt_state = opt.init(params)
    L = cfg.num_layers
    rngnp = np.random.default_rng(seed)
    train_ids = np.where(graph.train_mask)[0]

    def loss_fn(p, batch):
        return gcn_loss(p, batch, cfg, train=True, generator=gen)

    def make_batch(batch_nodes):
        nodes = lhop_closure(graph, batch_nodes, L, cap=node_cap)[:node_cap]
        b = len(nodes)
        blk = a_norm[nodes][:, nodes].toarray().astype(np.float32)
        adj = np.zeros((node_cap, node_cap), np.float32)
        adj[:b, :b] = blk
        feats = np.zeros((node_cap, graph.features.shape[1]), np.float32)
        feats[:b] = graph.features[nodes]
        if graph.labels.ndim == 1:
            labels = np.zeros(node_cap, np.int32)
        else:
            labels = np.zeros((node_cap, graph.labels.shape[1]), np.float32)
        labels[:b] = graph.labels[nodes]
        lmask = np.zeros(node_cap, np.float32)
        lmask[:len(batch_nodes)] = 1.0   # loss only on the seed batch
        nmask = np.zeros(node_cap, bool)
        nmask[:b] = True
        return tuple(torch.as_tensor(a).to(dev) for a in
                     (adj, feats, labels, nmask, lmask, np.int32(b)))

    hist = []
    t0 = time.perf_counter()
    steps = max(1, len(train_ids) // batch_size)
    for epoch in range(num_epochs):
        perm = rngnp.permutation(train_ids)
        losses = []
        for i in range(steps):
            bn = perm[i * batch_size:(i + 1) * batch_size]
            params, opt_state, loss = _update(params, opt, opt_state,
                                              loss_fn, make_batch(bn))
            losses.append(float(loss))
        hist.append(_record(epoch, float(np.mean(losses)), t0, eval_every,
                            params, graph, cfg, norm))
    return {"history": hist, "params": params,
            "seconds": time.perf_counter() - t0}


# ----------------------------------------------------------------------
# 3. GraphSAGE-style neighbor sampling
# ----------------------------------------------------------------------
def train_sage(graph: CSRGraph, cfg: GCNConfig, opt: Optimizer,
               num_epochs: int, batch_size: int = 512,
               fanouts: Optional[List[int]] = None, seed: int = 0,
               eval_every: int = 0, norm: str = "eq10",
               device="cuda") -> Dict[str, Any]:
    """Fixed-fanout sampling (default S1=25, S2=10, then 10...) with a mean
    aggregator; same GCN weight shapes so evaluate() is reusable."""
    fanouts = fanouts or [25] + [10] * (cfg.num_layers - 1)
    assert len(fanouts) == cfg.num_layers
    dev = resolve_device(device)
    params, gen = _init(cfg, seed, dev)
    opt_state = opt.init(params)
    rngnp = np.random.default_rng(seed)
    train_ids = np.where(graph.train_mask)[0]
    L = cfg.num_layers

    # fixed layer-set capacities (fixed tensor shapes per step):
    # cap_L = b, cap_{l} = min(N, cap_{l+1}*(fanout+1))
    caps = [batch_size]
    for f in reversed(fanouts):
        caps.append(min(caps[-1] * (f + 1), graph.num_nodes))
    caps = caps[::-1]  # caps[l] = capacity of layer-l node set

    def _sample_neighbors(nodes, f):
        """Vectorized: f uniform neighbor samples per node (self if deg 0)."""
        deg = (graph.indptr[nodes + 1] - graph.indptr[nodes]).astype(np.int64)
        u = rngnp.random((len(nodes), f))
        slot = (u * np.maximum(deg, 1)[:, None]).astype(np.int64)
        nbr = graph.indices[graph.indptr[nodes][:, None] + slot].astype(np.int64)
        nbr[deg == 0] = nodes[deg == 0, None]
        return nbr

    def sample_batch(batch_nodes):
        """Per-layer (node_ids, (nbr_table, self_table)) padded to `caps`.
        Pad entries index slot 0; their outputs are never consumed by real
        entries so garbage stays out of the loss."""
        layer_nodes = [None] * (L + 1)
        layer_nbrs = [None] * L
        layer_nodes[L] = np.asarray(batch_nodes, np.int64)
        cur = layer_nodes[L]
        for l in range(L - 1, -1, -1):
            f = fanouts[l]
            nbr = _sample_neighbors(cur, f)
            uniq = np.unique(np.concatenate([cur, nbr.ravel()]))[:caps[l]]
            lut = np.zeros(graph.num_nodes, np.int64)
            lut[uniq] = np.arange(len(uniq))
            nbr_tab = np.zeros((caps[l + 1], f), np.int64)
            self_tab = np.zeros(caps[l + 1], np.int64)
            nbr_tab[:len(cur)] = lut[nbr]
            self_tab[:len(cur)] = lut[cur]
            layer_nbrs[l] = (nbr_tab, self_tab)
            padded = np.zeros(caps[l], np.int64)
            padded[:len(uniq)] = uniq
            layer_nodes[l] = padded
            cur = uniq
        return layer_nodes, layer_nbrs

    def loss_fn(p, feats0, nbr_tables, self_tables, labels):
        h = feats0
        for l in range(L):
            layer = p["layers"][l]
            h = _dropout(h, cfg, gen)
            z = h @ layer["w"] + layer["b"]
            agg = z[nbr_tables[l]].mean(1)        # mean over sampled nbrs
            selfz = z[self_tables[l]]
            z = 0.5 * (agg + selfz)               # mean aggregator w/ self
            if l < L - 1:
                z = torch.relu(z)
                if cfg.layernorm:
                    z = _layernorm(z, layer["ln_scale"])
            h = z
        return _rows_loss(h, labels, cfg).mean()

    hist = []
    t0 = time.perf_counter()
    steps = max(1, len(train_ids) // batch_size)
    for epoch in range(num_epochs):
        perm = rngnp.permutation(train_ids)
        losses = []
        for i in range(steps):
            bn = perm[i * batch_size:(i + 1) * batch_size]
            layer_nodes, tables = sample_batch(bn)
            feats0 = torch.as_tensor(graph.features[layer_nodes[0]],
                                     dtype=torch.float32, device=dev)
            labels = torch.as_tensor(graph.labels[bn], device=dev)
            params, opt_state, loss = _update(
                params, opt, opt_state, loss_fn, feats0,
                [torch.as_tensor(t[0], device=dev) for t in tables],
                [torch.as_tensor(t[1], device=dev) for t in tables],
                labels)
            losses.append(float(loss))
        hist.append(_record(epoch, float(np.mean(losses)), t0, eval_every,
                            params, graph, cfg, norm))
    return {"history": hist, "params": params,
            "seconds": time.perf_counter() - t0}


# ----------------------------------------------------------------------
# 4. VR-GCN (historical embeddings, control variate, r=2)
# ----------------------------------------------------------------------
def train_vrgcn(graph: CSRGraph, cfg: GCNConfig, opt: Optimizer,
                num_epochs: int, batch_size: int = 512, r: int = 2,
                norm: str = "eq10", seed: int = 0,
                eval_every: int = 0, device="cuda") -> Dict[str, Any]:
    """VR-GCN baseline: keeps per-layer historical embeddings H_l (N×F —
    the O(NFL) memory the paper criticizes) in host memory, estimates
    Â h ≈ Â H + Â_sampled (h − H) with r sampled neighbors, and refreshes
    history for batch nodes each step on the host.

    Simplification (the reference's): sampled neighbors' *current*
    activations are approximated by their history (one-step-stale control
    variate) instead of the exact recursive recomputation — identical
    memory footprint and per-step compute/sampling cost (what Tables 5/9
    measure), slightly different variance profile."""
    dev = resolve_device(device)
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data, norm)
    a_norm = sp.csr_matrix((dt, ix, ip), shape=(graph.num_nodes,) * 2)
    params, gen = _init(cfg, seed, dev)
    opt_state = opt.init(params)
    rngnp = np.random.default_rng(seed)
    train_ids = np.where(graph.train_mask)[0]
    L = cfg.num_layers
    n = graph.num_nodes

    dims = [d for _, d in cfg.dims]
    hist_emb = [np.zeros((n, d), np.float32) for d in dims[:-1]]  # post-act
    feats = graph.features.astype(np.float32)
    # Â's row pointers widened once: the reference widens them in every
    # call, an O(N) copy three times a step (2.45 M entries on Amazon2M)
    aptr, aidx, adat = a_norm.indptr.astype(np.int64), a_norm.indices, \
        a_norm.data

    def sample_nbrs(nodes):
        """Vectorized sampling from Â's own sparsity (incl. self loops).
        weight = a_uv · deg/r (unbiased estimator scaling)."""
        nodes = np.asarray(nodes, np.int64)
        deg = aptr[nodes + 1] - aptr[nodes]
        u = rngnp.random((len(nodes), r))
        slot = aptr[nodes][:, None] + (u * np.maximum(deg, 1)[:, None]).astype(np.int64)
        idx = aidx[slot].astype(np.int64)
        w = adat[slot] * (deg[:, None] / r)
        empty = deg == 0
        idx[empty] = nodes[empty, None]
        w[empty] = 0.0
        return idx, w.astype(np.float32)

    def loss_fn(p, x_self, hist_agg_list, nbr_feat_list, nbr_w_list,
                nbr_hist_list, labels):
        """x_self: (b, F0) batch features; per layer: historical full agg
        (b, F_l), sampled neighbor current/hist values (b, r, F_l)."""
        h = x_self
        for l in range(L):
            layer = p["layers"][l]
            # CV estimator on activations entering layer l
            delta = nbr_feat_list[l] - nbr_hist_list[l]      # (b, r, F)
            est = hist_agg_list[l] + (nbr_w_list[l][..., None] * delta).sum(1)
            est = _dropout(est, cfg, gen)
            z = est @ layer["w"] + layer["b"]
            if l < L - 1:
                z = torch.relu(z)
                if cfg.layernorm:
                    z = _layernorm(z, layer["ln_scale"])
            h = z
        return _rows_loss(h, labels, cfg).mean(), h

    def to_dev(a):
        return torch.as_tensor(a, device=dev)

    history = []
    t0 = time.perf_counter()
    steps = max(1, len(train_ids) // batch_size)
    for epoch in range(num_epochs):
        perm = rngnp.permutation(train_ids)
        losses = []
        for i in range(steps):
            bn = perm[i * batch_size:(i + 1) * batch_size]
            # host: current activations per layer for batch nodes
            # layer-0 input = raw features; layer-l input = hist activation
            cur_inputs = [feats] + hist_emb
            a_bn = a_norm[bn]        # the batch's rows of Â, sliced once
            agg0 = a_bn @ feats      # also the refresh's layer-0 product
            hist_aggs, nbr_feats, nbr_ws, nbr_hists = [], [], [], []
            for l in range(L):
                idx, w = sample_nbrs(bn)
                hist_aggs.append(to_dev(a_bn @ cur_inputs[l]
                                        if l > 0 else agg0))
                nbr_feats.append(to_dev(cur_inputs[l][idx]))
                nbr_hists.append(to_dev(cur_inputs[l][idx]))
                nbr_ws.append(to_dev(w))
            params, opt_state, loss = _update(
                params, opt, opt_state, loss_fn, to_dev(feats[bn]),
                hist_aggs, nbr_feats, nbr_ws, nbr_hists,
                to_dev(graph.labels[bn]))
            losses.append(float(loss))
            # refresh history for batch nodes (host-side forward, cheap)
            lay = [{k: v.cpu().numpy() for k, v in layer.items()}
                   for layer in params["layers"]]
            for l in range(L - 1):
                agg = agg0 if l == 0 else a_bn @ cur_inputs[l]
                z = agg @ lay[l]["w"] + lay[l]["b"]
                z = np.maximum(z, 0)
                if cfg.layernorm:
                    mu = z.mean(-1, keepdims=True)
                    z = (z - mu) / (z.std(-1, keepdims=True) + 1e-6) \
                        * lay[l]["ln_scale"]
                hist_emb[l][bn] = z
        history.append(_record(epoch, float(np.mean(losses)), t0,
                               eval_every, params, graph, cfg, norm))
    hist_bytes = sum(h.nbytes for h in hist_emb)
    return {"history": history, "params": params,
            "seconds": time.perf_counter() - t0,
            "history_bytes": hist_bytes}
