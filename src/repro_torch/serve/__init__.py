"""Serving layer: cluster-keyed embedding cache, device-side query step,
and live graph updates — the port of `repro.serve`. The full-graph
precompute and the lazy re-embed run the block-ELL product through the
hand-written CUDA kernel on a GPU (`repro_torch.kernels.block_spmm`);
`launch/serve_gcn.py` is the CLI front door."""
from repro_torch.serve.deltas import BalanceMonitor, GraphDelta, apply_delta
from repro_torch.serve.embedding_cache import (EmbeddingCache, embed_cluster,
                                               full_graph_embeddings)
from repro_torch.serve.engine import ServeEngine, ServeResult

__all__ = [
    "BalanceMonitor", "GraphDelta", "apply_delta",
    "EmbeddingCache", "embed_cluster", "full_graph_embeddings",
    "ServeEngine", "ServeResult",
]
