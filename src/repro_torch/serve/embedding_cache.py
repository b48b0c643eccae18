"""Per-cluster final-layer embedding cache — the offline half of the
serving layer, ported from `repro.serve.embedding_cache`.

Two compute paths produce identical (exact, full-graph) logits:

* `full_graph_embeddings` — the offline batch precompute: layer-wise
  propagation over the WHOLE graph, cluster-block by cluster-block. The
  activations live on the model's device for the whole layer loop: per
  layer the dense transform H·W + b is one fp32 `torch.matmul`, then
  each cluster's rows of the normalized Â (sliced from the global CSR
  and tiled by the host block-ELL builder) go to the device and through
  `spmm_block_ell` — the CUDA kernel on a GPU, the plain PyTorch
  version on the CPU. A dense Â is never materialized.
* `embed_cluster` — the lazy single-cluster path used after a live
  update invalidates one cluster: exact L-hop halo propagation through
  the same product.

Both mirror `core.trainer.full_graph_logits` operation for operation
(transform → propagate → residual → relu → layernorm, the §6.2
precompute_ax skip included). Only the tile build (numpy) runs on the
host; the cache stores fp32 numpy, in the reference's layout and under
the reference's key.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
import shutil
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.gcn import GCN, GCNConfig, GCNLayer
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.normalization import normalize_csr
from repro_torch.kernels.block_spmm import spmm_block_ell
from repro_torch.kernels.ops import block_ell_from_csr


def _forward_spmm(blocks: np.ndarray, cols: np.ndarray,
                  x_pad: torch.Tensor) -> torch.Tensor:
    """Forward-only block-ELL product on x_pad's device: the host tiles
    go across, then `spmm_block_ell` (CUDA kernel or plain version by
    device; row_k=None, as the reference calls it)."""
    return spmm_block_ell(torch.from_numpy(blocks).to(x_pad.device),
                          torch.from_numpy(cols).to(x_pad.device), x_pad)


def _slice_rows(indptr, indices, data, rows):
    """Row-slice a CSR matrix (columns untouched): the flat-gather
    pattern of CSRGraph.subgraph without the column filtering."""
    rows = np.asarray(rows, dtype=np.int64)
    starts, ends = indptr[rows], indptr[rows + 1]
    counts = ends - starts
    total = int(counts.sum())
    pos = np.cumsum(np.concatenate([[0], counts]))
    flat = (np.repeat(starts, counts)
            + np.arange(total, dtype=np.int64)
            - np.repeat(pos[:-1], counts))
    return pos.astype(np.int64), indices[flat], data[flat]


def _pad_to(n: int, block: int) -> int:
    return -(-n // block) * block


def _cluster_tiles(ip, ix, dt, rows, n_cols: int,
                   block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Â[rows, :] as block-ELL tiles over `n_cols` (padded) columns."""
    sip, six, sdt = _slice_rows(ip, ix, dt, rows)
    return block_ell_from_csr(sip, six, sdt, n_cols=n_cols, block=block,
                              n_rows=_pad_to(len(rows), block))


def _inner_activation(z: torch.Tensor, h_in: Optional[torch.Tensor],
                      layer: GCNLayer, cfg: GCNConfig) -> torch.Tensor:
    """Residual → relu → layernorm, exactly as the full-graph oracle
    (trainer.full_graph_logits) applies them between layers."""
    if cfg.residual and h_in is not None and z.shape == h_in.shape:
        z = z + h_in
    z = torch.clamp_min(z, 0.0)
    if cfg.layernorm:
        mu = z.mean(-1, keepdim=True)
        sd = z.std(-1, keepdim=True, correction=0)
        z = (z - mu) / (sd + 1e-6) * layer.ln_scale
    return z


def _host_features(graph: CSRGraph, rows=slice(None)) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(graph.features[rows],
                                                 dtype=np.float32))


@torch.no_grad()
def full_graph_embeddings(params: GCN, graph: CSRGraph, parts: np.ndarray,
                          cfg: GCNConfig, *, norm: str = "eq10",
                          diag_lambda: float = 0.0, block: int = 128,
                          row_chunk: int = 65536) -> np.ndarray:
    """Exact full-graph GCN logits, propagated cluster-block by
    cluster-block on the params' device. Returns (N, out_dim) fp32
    numpy. Layer-0 dense transforms stream the (possibly mmap'd)
    feature matrix to the device `row_chunk` rows at a time; with
    cfg.residual or cfg.precompute_ax the features go across once."""
    device = params.device
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data,
                               norm, diag_lambda)
    n = graph.num_nodes
    n_pad = _pad_to(n, block)
    parts = np.asarray(parts)
    num_parts = int(parts.max()) + 1
    clusters = [rows for rows in (np.where(parts == c)[0]
                                  for c in range(num_parts)) if len(rows)]

    def propagate(x: torch.Tensor) -> torch.Tensor:
        x_pad = torch.zeros((n_pad, x.shape[1]), dtype=torch.float32,
                            device=device)
        x_pad[:n] = x
        out = torch.empty_like(x)
        for rows in clusters:
            # tiles are built per cluster and layer, as the reference
            # does: host memory stays one cluster's tiles at any scale
            blocks, cols = _cluster_tiles(ip, ix, dt, rows, n_pad, block)
            out[torch.from_numpy(rows).to(device)] = \
                _forward_spmm(blocks, cols, x_pad)[:len(rows)]
        return out

    h: Optional[torch.Tensor] = None     # None → stream graph.features
    if cfg.precompute_ax:
        h = propagate(_host_features(graph).to(device))
    elif cfg.residual:
        h = _host_features(graph).to(device)
    for i, layer in enumerate(params.layers):
        if h is None:
            z = torch.empty((n, layer.w.shape[1]), dtype=torch.float32,
                            device=device)
            for s in range(0, n, row_chunk):
                e = min(n, s + row_chunk)
                z[s:e] = (_host_features(graph, slice(s, e)).to(device)
                          @ layer.w + layer.b)
        else:
            z = h @ layer.w + layer.b
        if not (i == 0 and cfg.precompute_ax):
            z = propagate(z)
        if i < len(params.layers) - 1:
            z = _inner_activation(z, h, layer, cfg)
        h = z
    return h.cpu().numpy()


def _expand_frontier(ip, ix, nodes) -> np.ndarray:
    """nodes ∪ neighbors(nodes), sorted unique — one halo hop."""
    _, cols, _ = _slice_rows(ip, ix, ix, nodes)   # data unused
    return np.union1d(nodes, cols).astype(np.int64)


@torch.no_grad()
def embed_cluster(params: GCN, graph: CSRGraph, cfg: GCNConfig,
                  rows: np.ndarray, *, norm: str = "eq10",
                  diag_lambda: float = 0.0,
                  block: int = 128) -> np.ndarray:
    """Exact logits for `rows` only, via L-hop halo propagation on the
    params' device — the lazy re-embed path after a live update
    invalidates one cluster. The halo grows the active node set one
    neighbor hop per remaining propagation, so every Â row-slice keeps
    all its non-zeros and the result equals the full-graph forward
    restricted to `rows`. Returns (len(rows), out_dim) fp32 numpy."""
    device = params.device
    ip, ix, dt = normalize_csr(graph.indptr, graph.indices, graph.data,
                               norm, diag_lambda)
    hops = len(params.layers)  # precompute_ax trades layer-0's hop for
    # the up-front feature propagation — total hops stay num_layers
    levels: List[np.ndarray] = [np.unique(np.asarray(rows, np.int64))]
    for _ in range(hops):
        levels.append(_expand_frontier(ip, ix, levels[-1]))
    levels.reverse()          # widest halo first, `rows` last

    def prop(tgt, src_nodes, x: torch.Tensor) -> torch.Tensor:
        """Â[tgt, src_nodes] @ x — exact because src_nodes ⊇ nbrs(tgt)."""
        relabel = np.full(graph.num_nodes, -1, np.int64)
        relabel[src_nodes] = np.arange(len(src_nodes))
        sip, six, sdt = _slice_rows(ip, ix, dt, tgt)
        local = relabel[six]
        if (local < 0).any():
            raise RuntimeError("halo missed a neighbor")
        x_pad = torch.zeros((_pad_to(len(src_nodes), block), x.shape[1]),
                            dtype=torch.float32, device=device)
        x_pad[:len(src_nodes)] = x
        blocks, cols = block_ell_from_csr(
            sip, local.astype(np.int32), sdt, n_cols=x_pad.shape[0],
            block=block, n_rows=_pad_to(len(tgt), block))
        return _forward_spmm(blocks, cols, x_pad)[:len(tgt)]

    def index(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    t = 0
    nodes = levels[0]
    h = _host_features(graph, nodes).to(device)
    if cfg.precompute_ax:
        h = prop(levels[1], nodes, h)
        nodes = levels[1]
        t = 1
    for i, layer in enumerate(params.layers):
        z = h @ layer.w + layer.b
        if not (i == 0 and cfg.precompute_ax):
            new_nodes = levels[t + 1]
            z = prop(new_nodes, nodes, z)
            t += 1
        else:
            new_nodes = nodes
        if i < len(params.layers) - 1:
            # the residual adds the layer INPUT restricted to the
            # (narrower) post-propagation node set
            h_res = h[index(np.searchsorted(nodes, new_nodes))]
            z = _inner_activation(z, h_res, layer, cfg)
        nodes = new_nodes
        h = z
    # levels[-1] is sorted-unique; map back to the caller's row order
    order = np.searchsorted(nodes, np.asarray(rows, np.int64))
    return h[index(order)].cpu().numpy()


# ----------------------------------------------------------------------
# the on-disk cache
# ----------------------------------------------------------------------
class EmbeddingCache:
    """Disk cache of per-cluster final-layer embeddings, keyed on
    (checkpoint step, partition fingerprint) — the reference's layout
    and key, so a cache directory is valid for either package.

    Layout: <root>/step<NNNNNNNNNN>_<fingerprint>/{manifest.json,
    cluster_<c>.npy}. Writes are atomic and durable (tmp + fsync +
    rename + directory fsync); loads are mmap'd so a query pages in only
    the rows it touches. `recompute_counts` tracks how many times each
    cluster was (re)stored. Live updates never mutate a keyed directory
    in place: `rekey` switches to the grown graph's fingerprint,
    carrying untouched cluster files over by hardlink."""

    def __init__(self, root, *, checkpoint_step: int,
                 partition_fingerprint: str):
        self.root = pathlib.Path(root)
        self.checkpoint_step = int(checkpoint_step)
        self.partition_fingerprint = str(partition_fingerprint)
        self.dir = (self.root
                    / f"step{self.checkpoint_step:010d}"
                      f"_{self.partition_fingerprint}")
        self.dir.mkdir(parents=True, exist_ok=True)
        self.recompute_counts: Dict[int, int] = collections.Counter()
        manifest = self.dir / "manifest.json"
        if not manifest.exists():
            manifest.write_text(json.dumps(
                {"checkpoint_step": self.checkpoint_step,
                 "partition_fingerprint": self.partition_fingerprint,
                 "created": time.time()}))

    def path(self, cluster: int) -> pathlib.Path:
        return self.dir / f"cluster_{int(cluster):05d}.npy"

    def has(self, cluster: int) -> bool:
        return self.path(cluster).exists()

    def load(self, cluster: int) -> np.ndarray:
        return np.load(self.path(cluster), mmap_mode="r")

    def store(self, cluster: int, embeddings: np.ndarray) -> None:
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        fd, tmp = tempfile.mkstemp(suffix=".npy.tmp", dir=self.dir)
        try:
            with open(fd, "wb") as f:
                np.save(f, emb)
                f.flush()
                # fsync before the rename: rename-then-crash must never
                # publish a name whose data blocks are still in flight
                os.fsync(f.fileno())
            pathlib.Path(tmp).replace(self.path(cluster))
            self._fsync_dir()
        finally:
            pathlib.Path(tmp).unlink(missing_ok=True)
        self.recompute_counts[int(cluster)] += 1

    def _fsync_dir(self) -> None:
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def rekey(self, partition_fingerprint: str, *,
              drop: Iterable[int] = ()) -> "EmbeddingCache":
        """Switch to the directory keyed on a new partition fingerprint
        (the served graph changed under a GraphDelta). Every cached
        cluster except `drop` is carried over by hardlink (copy when the
        filesystem refuses links); the old directory stays intact.
        `recompute_counts` carries across."""
        if partition_fingerprint == self.partition_fingerprint:
            return self
        new = EmbeddingCache(
            self.root, checkpoint_step=self.checkpoint_step,
            partition_fingerprint=partition_fingerprint)
        new.recompute_counts = self.recompute_counts
        dropped = {int(c) for c in drop}
        for c in self.cached_clusters():
            if c in dropped or new.has(c):
                continue
            try:
                os.link(self.path(c), new.path(c))
            except OSError:
                shutil.copy2(self.path(c), new.path(c))
        new._fsync_dir()
        return new

    def invalidate(self, cluster: int) -> bool:
        """Drop one cluster's cached embeddings; the next query of the
        cluster lazily re-embeds. Returns whether there was anything to
        drop."""
        p = self.path(cluster)
        existed = p.exists()
        p.unlink(missing_ok=True)
        return existed

    def cached_clusters(self) -> List[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("cluster_*.npy"))
