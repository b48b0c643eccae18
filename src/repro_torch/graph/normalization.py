"""Adjacency normalization variants from the paper.

All variants operate on *dense* cluster-batch adjacency blocks (that is
where Cluster-GCN does its compute) and have CSR twins for full-graph
baselines.

  eq1   : A' = D^{-1} A            (mean aggregator used in §4.1)
  sym   : D^{-1/2}(A+I)D^{-1/2}    (Kipf & Welling; for reference)
  eq10  : Ã = (D+I)^{-1}(A+I)      (paper Eq. 10)
  eq9   : A' + I                   (paper Eq. 9 — unnormalized identity add)
  eq11  : Ã + λ·diag(Ã)            (paper Eq. 11 — diagonal enhancement)

Batches built from q>1 clusters re-add between-cluster links and must be
RE-normalized on the combined subgraph (paper §6.2) — normalization is
therefore applied per batch, on the batch adjacency.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-9


def normalize_dense(adj: np.ndarray, method: str = "eq10",
                    diag_lambda: float = 0.0) -> np.ndarray:
    """Normalize a dense (b, b) adjacency block. numpy in, numpy out."""
    a = np.asarray(adj, dtype=np.float32)
    n = a.shape[0]
    eye = np.eye(n, dtype=np.float32)
    if method == "eq1":
        deg = a.sum(1)
        out = a / np.maximum(deg, _EPS)[:, None]
    elif method == "sym":
        ai = a + eye
        d = ai.sum(1)
        dinv = 1.0 / np.sqrt(np.maximum(d, _EPS))
        out = dinv[:, None] * ai * dinv[None, :]
    elif method in ("eq10", "eq9", "eq11"):
        # Ã = (D+I)^{-1}(A+I); D from A (degree), +I regularizer
        deg = a.sum(1)
        ai = a + eye
        out = ai / (deg + 1.0)[:, None]
        if method == "eq9":
            out = out + eye
        elif method == "eq11":
            out = out + diag_lambda * np.diag(np.diag(out))
    else:
        raise ValueError(f"unknown normalization {method!r}")
    return out.astype(np.float32)


def normalize_csr(indptr, indices, data, method: str = "eq10",
                  diag_lambda: float = 0.0):
    """CSR normalization for full-graph baselines. Returns new
    (indptr, indices, data) WITH self loops appended where the method
    requires them."""
    import scipy.sparse as sp
    n = len(indptr) - 1
    a = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    if method == "eq1":
        deg = np.asarray(a.sum(1)).ravel()
        dinv = sp.diags(1.0 / np.maximum(deg, _EPS))
        out = dinv @ a
    elif method == "sym":
        ai = a + sp.eye(n, format="csr")
        deg = np.asarray(ai.sum(1)).ravel()
        dh = sp.diags(1.0 / np.sqrt(np.maximum(deg, _EPS)))
        out = dh @ ai @ dh
    elif method in ("eq10", "eq9", "eq11"):
        deg = np.asarray(a.sum(1)).ravel()
        ai = a + sp.eye(n, format="csr")
        dinv = sp.diags(1.0 / (deg + 1.0))
        out = dinv @ ai
        if method == "eq9":
            out = out + sp.eye(n, format="csr")
        elif method == "eq11":
            out = out + diag_lambda * sp.diags(out.diagonal())
    else:
        raise ValueError(f"unknown normalization {method!r}")
    out = out.tocsr().astype(np.float32)
    out.sort_indices()
    return out.indptr.astype(np.int64), out.indices.astype(np.int32), out.data
