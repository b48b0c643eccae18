"""Exact full-graph evaluation on the host — the port's part of
`repro.core.trainer` that serving needs: `full_graph_logits`, the scipy
CSR oracle behind `serve_gcn --verify-parity`. It runs in numpy on the
host whatever device the model lives on, so it is independent of every
kernel it checks. `train_cluster_gcn` and `evaluate` come with the
training slice."""
from __future__ import annotations

import numpy as np

from repro_torch.core.gcn import GCN, GCNConfig, params_to_numpy
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.normalization import normalize_csr


def full_graph_logits(params: GCN, graph: CSRGraph, cfg: GCNConfig,
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
    layers = params_to_numpy(params)["layers"]
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
