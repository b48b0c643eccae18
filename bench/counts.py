"""The work a Cluster-GCN batch needs, counted from the batch's real
node count n, the nonzeros of its normalised adjacency nnz and the
configuration's widths — never from the program's padded tiles, so a
change of tile format leaves the yardstick as it was — and the H100's
published peaks (NVIDIA's data sheet, SXM part, dense rates).

Bytes count each input once and each output once, fp32 values, the
adjacency as CSR with int32 column indices and int32 row offsets.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# the H100 SXM constants of repro_torch.launch.mesh, copied
PEAK_FLOPS_FP32 = 67e12     # FLOP/s, fp32 on the CUDA cores (TF32 off)
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, bf16 on the tensor cores
HBM_BYTES_S = 3.35e12       # B/s, HBM3

F32 = 4


def layer_dims(in_dim: int, hidden: int, out_dim: int,
               num_layers: int) -> List[Tuple[int, int]]:
    ds = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
    return list(zip(ds[:-1], ds[1:]))


def csr_bytes(n: int, nnz: int) -> int:
    return nnz * (F32 + 4) + (n + 1) * 4


def fused_spmm_work(n: int, nnz: int, d: int, f: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of y = Â (X W + b): X (n, d), W (d, f), b (f,),
    y (n, f)."""
    flops = 2.0 * n * d * f + 2.0 * nnz * f
    nbytes = F32 * (n * d + d * f + f + n * f) + csr_bytes(n, nnz)
    return flops, float(nbytes)


def spmm_work(n: int, nnz: int, f: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the backward aggregation Âᵀ G: G (n, f) in,
    (n, f) out."""
    return 2.0 * nnz * f, float(F32 * 2 * n * f + csr_bytes(n, nnz))


def step_flops(n: int, nnz: int, dims: Sequence[Tuple[int, int]]) -> float:
    """Matmul FLOPs of one training step: per layer the forward
    2·n·d·f + 2·nnz·f, the backward Âᵀ G (2·nnz·f), dW (2·n·d·f) and,
    on every layer but the first, dX (2·n·d·f); no gradient flows into
    the input features."""
    total = 0.0
    for i, (d, f) in enumerate(dims):
        fwd = 2.0 * n * d * f + 2.0 * nnz * f
        bwd = 2.0 * nnz * f + 2.0 * n * d * f * (2 if i > 0 else 1)
        total += fwd + bwd
    return total


def min_seconds(flops: float, nbytes: float,
                peak_flops: float = PEAK_FLOPS_FP32) -> Tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_S
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "memory")


def induced_nnz(indptr: np.ndarray, indices: np.ndarray,
                nodes: np.ndarray, self_loops: bool = True) -> int:
    """Nonzeros of the normalised adjacency of the subgraph induced on
    `nodes`: the edge slots between two of its nodes, plus the diagonal
    that Eq. 10 and 11 add."""
    nodes = np.asarray(nodes, dtype=np.int64)
    inside = np.zeros(len(indptr) - 1, dtype=bool)
    inside[nodes] = True
    starts, ends = indptr[nodes], indptr[nodes + 1]
    counts = ends - starts
    pos = np.concatenate([[0], np.cumsum(counts)])
    flat = (np.repeat(starts, counts) + np.arange(pos[-1], dtype=np.int64)
            - np.repeat(pos[:-1], counts))
    nnz = int(np.count_nonzero(inside[indices[flat]]))
    return nnz + (len(nodes) if self_loops else 0)
