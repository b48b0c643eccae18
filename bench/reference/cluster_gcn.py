"""Plain PyTorch Cluster-GCN training steps: the benchmark's reference.

Written from the paper (Algorithm 1, Eq. 10/11, §6.2) and from what a
configuration file states, in plain `torch` operations on dense
matrices, fp32 with TF32 off. It imports nothing of the program. From
the program's run it takes only the partition, which has no unique
answer and is judged on its own (`check.partition_cut`), and the padded
batch size, the number of rows the dropout masks are drawn over.
Everything else it works out again from the graph and the seeds: the
epoch's cluster order, each batch's nodes, the normalised adjacency,
the Glorot initialisation, the dropout masks, the loss, the gradients
and the AdamW updates.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The training recipe as a configuration file states it."""
    num_parts: int
    clusters_per_batch: int
    norm: str
    diag_lambda: float
    num_layers: int
    hidden_dim: int
    dropout: float
    layernorm: bool
    residual: bool
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float

    @staticmethod
    def from_settings(s: Dict) -> "Recipe":
        return Recipe(
            num_parts=int(s["partition.num_parts"]),
            clusters_per_batch=int(s["batch.clusters_per_batch"]),
            norm=s["batch.norm"], diag_lambda=float(s["batch.diag_lambda"]),
            num_layers=int(s["model.num_layers"]),
            hidden_dim=int(s["model.hidden_dim"]),
            dropout=float(s["model.dropout"]),
            layernorm=bool(s["model.layernorm"]),
            residual=bool(s["model.residual"]),
            lr=float(s["optim.lr"]), b1=float(s["optim.b1"]),
            b2=float(s["optim.b2"]), eps=float(s["optim.eps"]),
            weight_decay=float(s["optim.weight_decay"]))

    def dims(self, in_dim: int, out_dim: int):
        ds = [in_dim] + [self.hidden_dim] * (self.num_layers - 1) + [out_dim]
        return list(zip(ds[:-1], ds[1:]))


# ----------------------------------------------------------------------
# batches (Algorithm 1)
# ----------------------------------------------------------------------
def cluster_members(parts: np.ndarray, num_parts: int) -> List[np.ndarray]:
    return [np.flatnonzero(parts == c) for c in range(num_parts)]


def epoch_groups(num_parts: int, q: int, seed: int, epoch: int):
    """The epoch's clusters, shuffled from (seed, epoch) and taken q at
    a time without replacement."""
    order = np.random.default_rng((seed, epoch)).permutation(num_parts)
    return [order[i:i + q] for i in range(0, num_parts, q)]


def batch_nodes(members: Sequence[np.ndarray], group, cap: int, seed: int,
                epoch: int, step: int) -> np.ndarray:
    """The union of the group's clusters in draw order; a union larger
    than `cap` keeps a uniform sample of `cap` nodes drawn from (seed,
    epoch, step), in union order."""
    nodes = np.concatenate([members[c] for c in group])
    if len(nodes) > cap:
        keep = np.random.default_rng((seed, epoch, step)).choice(
            len(nodes), size=cap, replace=False)
        nodes = nodes[np.sort(keep)]
    return nodes


def normalized_adjacency(indptr: np.ndarray, indices: np.ndarray,
                         nodes: np.ndarray, norm: str, diag_lambda: float,
                         device) -> torch.Tensor:
    """Dense (n, n) adjacency of the subgraph induced on `nodes`,
    normalised over that subgraph alone (§6.2): Eq. 10
    (A + I) / (deg + 1) row by row, Eq. 11 adds λ·diag of it, Eq. 9
    adds I, Eq. 1 is A / deg."""
    n = len(nodes)
    local = np.full(len(indptr) - 1, -1, dtype=np.int64)
    local[nodes] = np.arange(n)
    rows, cols = [], []
    for i, u in enumerate(nodes):
        nb = local[indices[indptr[u]:indptr[u + 1]]]
        nb = nb[nb >= 0]
        rows.append(np.full(len(nb), i, dtype=np.int64))
        cols.append(nb)
    r = torch.from_numpy(np.concatenate(rows) if rows else np.zeros(0, np.int64))
    c = torch.from_numpy(np.concatenate(cols) if cols else np.zeros(0, np.int64))
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    a[r.to(device), c.to(device)] = 1.0
    deg = a.sum(1)
    eye = torch.eye(n, dtype=torch.float32, device=device)
    if norm == "eq1":
        return a / torch.clamp(deg, min=1e-9)[:, None]
    out = (a + eye) / (deg + 1.0)[:, None]
    if norm == "eq9":
        out = out + eye
    elif norm == "eq11":
        out = out + diag_lambda * torch.diag(torch.diagonal(out))
    elif norm != "eq10":
        raise ValueError(f"unknown normalisation {norm!r}")
    return out


@dataclasses.dataclass
class Batch:
    nodes: np.ndarray
    adj: torch.Tensor          # (n, n)
    features: torch.Tensor     # (n, in_dim)
    labels: torch.Tensor       # (n,) int64 or (n, C) float32
    loss_mask: torch.Tensor    # (n,) float32


def make_batch(graph: Dict[str, np.ndarray], nodes: np.ndarray,
               recipe: Recipe, device) -> Batch:
    labels = torch.from_numpy(np.asarray(graph["labels"][nodes]))
    labels = (labels.float() if labels.dim() == 2 else labels.long())
    return Batch(
        nodes=nodes,
        adj=normalized_adjacency(graph["indptr"], graph["indices"], nodes,
                                 recipe.norm, recipe.diag_lambda, device),
        features=torch.from_numpy(
            np.asarray(graph["features"][nodes], np.float32)).to(device),
        labels=labels.to(device),
        loss_mask=torch.from_numpy(
            graph["train_mask"][nodes].astype(np.float32)).to(device))


# ----------------------------------------------------------------------
# the model, the loss and AdamW
# ----------------------------------------------------------------------
def init_params(dims, seed: int, layernorm: bool, device) -> Dict[str, torch.Tensor]:
    """Glorot-uniform weights (U(-s, s), s = sqrt(6 / (fan_in +
    fan_out))) drawn layer by layer from one CPU generator seeded with
    the run's seed, zero biases, unit layer-norm scales on every layer
    but the last."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for i, (d, f) in enumerate(dims):
        s = math.sqrt(6.0 / (d + f))
        params[f"layers.{i}.w"] = torch.empty((d, f)).uniform_(-s, s, generator=g)
        params[f"layers.{i}.b"] = torch.zeros(f)
        if layernorm and i < len(dims) - 1:
            params[f"layers.{i}.ln_scale"] = torch.ones(f)
    return {k: v.to(device) for k, v in params.items()}


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Matmul:
    """fp32 products with TF32 off, or TF32 ones: on a GPU the hardware's
    (cuBLAS with TF32 allowed), on the CPU the operands rounded to TF32
    in the forward pass."""

    def __init__(self, precision: str, device):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.emulate = precision == "tf32" and torch.device(device).type != "cuda"
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.emulate:
            a = a + (_round_tf32(a.detach()) - a).detach()
            b = b + (_round_tf32(b.detach()) - b).detach()
        return a @ b

    @contextlib.contextmanager
    def mode(self):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        allow = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def forward(params, batch: Batch, masks, recipe: Recipe, mm: Matmul):
    keep = 1.0 - recipe.dropout
    h = batch.features
    L = recipe.num_layers
    for i in range(L):
        if masks is not None:
            h = h * masks[i].to(h.dtype) / keep
        z = mm(batch.adj, mm(h, params[f"layers.{i}.w"])
               + params[f"layers.{i}.b"])
        if i < L - 1:
            if recipe.residual and z.shape == h.shape:
                z = z + h
            z = torch.relu(z)
            if recipe.layernorm:
                mu = z.mean(-1, keepdim=True)
                var = ((z - mu) ** 2).mean(-1, keepdim=True)
                z = (z - mu) / torch.sqrt(var + 1e-6) \
                    * params[f"layers.{i}.ln_scale"]
        h = z
    return h


def loss_fn(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    """Mean over the batch's training nodes: summed sigmoid
    cross-entropy over the labels (multi-label), or softmax
    cross-entropy (multiclass)."""
    if batch.labels.dim() == 2:
        per_node = F.binary_cross_entropy_with_logits(
            logits, batch.labels, reduction="none").sum(-1)
    else:
        per_node = F.cross_entropy(logits, batch.labels, reduction="none")
    return (per_node * batch.loss_mask).sum() / torch.clamp(
        batch.loss_mask.sum(), min=1.0)


def adamw(params, grads, state, step: int, recipe: Recipe):
    new = {}
    for k, p in params.items():
        g = grads[k]
        m = recipe.b1 * state["m"][k] + (1 - recipe.b1) * g
        v = recipe.b2 * state["v"][k] + (1 - recipe.b2) * g * g
        state["m"][k], state["v"][k] = m, v
        mhat = m / (1 - recipe.b1 ** step)
        vhat = v / (1 - recipe.b2 ** step)
        new[k] = p - recipe.lr * mhat / (torch.sqrt(vhat) + recipe.eps) \
            - recipe.lr * recipe.weight_decay * p
    return new


# ----------------------------------------------------------------------
# the first steps of a run
# ----------------------------------------------------------------------
@dataclasses.dataclass
class RefRun:
    losses: List[float]
    grads1: Dict[str, torch.Tensor]       # the first step's gradient
    params0: Dict[str, torch.Tensor]
    params_last: Dict[str, torch.Tensor]  # after the last step
    batches: List[Batch]


def run_steps(graph: Dict[str, np.ndarray], parts: np.ndarray,
              recipe: Recipe, *, run_seed: int, batch_seed: int, cap: int,
              steps: int, device, precision: str = "fp32") -> RefRun:
    """The first `steps` training steps of a run: epoch 0's first
    batches, dropout masks over `cap` rows drawn in layer order from a
    generator on `device` seeded with run_seed + 1, AdamW from the
    Glorot initialisation drawn from run_seed."""
    mm = Matmul(precision, device)
    members = cluster_members(parts, recipe.num_parts)
    groups = epoch_groups(recipe.num_parts, recipe.clusters_per_batch,
                          batch_seed, 0)
    in_dim = graph["features"].shape[1]
    labels = graph["labels"]
    out_dim = labels.shape[1] if labels.ndim == 2 else int(labels.max()) + 1
    dims = recipe.dims(in_dim, out_dim)
    params = init_params(dims, run_seed, recipe.layernorm, device)
    params0 = {k: v.clone() for k, v in params.items()}
    state = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
             "v": {k: torch.zeros_like(v) for k, v in params.items()}}
    gen = torch.Generator(device=device).manual_seed(run_seed + 1)
    keep = 1.0 - recipe.dropout
    losses, batches, grads1 = [], [], None
    with mm.mode():
        for step in range(steps):
            nodes = batch_nodes(members, groups[step], cap, batch_seed, 0,
                                step)
            batch = make_batch(graph, nodes, recipe, device)
            batches.append(batch)
            masks = None
            if recipe.dropout > 0:
                masks = [(torch.rand((cap, d), generator=gen, device=device)
                          < keep)[:len(nodes)] for d, _ in dims]
            live = {k: v.detach().requires_grad_(True)
                    for k, v in params.items()}
            loss = loss_fn(forward(live, batch, masks, recipe, mm), batch)
            names = list(live)
            g = torch.autograd.grad(loss, [live[k] for k in names])
            grads = dict(zip(names, g))
            if grads1 is None:
                grads1 = {k: v.detach().clone() for k, v in grads.items()}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                params = adamw(params, grads, state, step + 1, recipe)
    return RefRun(losses=losses, grads1=grads1, params0=params0,
                  params_last={k: v.detach() for k, v in params.items()},
                  batches=batches)
