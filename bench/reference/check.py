"""The numbers that decide `correct`, each read from what the program
produced on its timed path and what the reference worked out again.

* loss_gap: the relative gap of the first step's loss. The later
  steps' losses are printed, not compared: AdamW's first update is
  ±lr on every element, so an element whose gradient is near nought
  takes the other sign on round-off and moves by 2·lr, and that swings
  the later losses of two sound fp32 runs by up to 1e-3 from seed to
  seed (`diagnostics` counts those elements).
* grad_gap: the first gradient as the optimizer received it (AdamW's
  first moment after one step, over 1 - b1), leaf by leaf: the gap
  between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf; the median
  of those gaps over the leaves is compared, under a tight limit: a
  pre-activation within round-off of ReLU's kink takes either side in
  two sound fp32 runs, moves one column of one or two leaves' gradients
  by up to 1e-2 of their largest entry (the worst leaf, leaf_gap below,
  is held to a looser limit) and the median leaf's by about 2e-5.
* update_gap: the same for the parameters' change over the checked
  steps; leaves whose first reference gradient is under a thousandth of
  the median leaf's move by round-off alone under AdamW and are left
  out.
* leaf_gap: the worst leaf of the two gaps above, gradient and change
  together: the medians pass a fault confined to a few leaves (a layer
  left unmoved, a wrong update of one scale), the worst leaf does not.
* grad_cos_gap: the worst leaf's 1 - cosine between the program's first
  gradient and the reference's: a gap of norms passes a gradient of the
  right size pointing the wrong way. The change is not held so, as a
  near-nought gradient element's first AdamW step takes either sign.
* adj_gap: the largest gap of the batch's normalised adjacency, forward
  and transposed tiles, densified, over the largest entry.
* batch_rows_off: padded rows whose features, labels, node mask or loss
  mask differ from the reference's, plus every row when the real-node
  count differs.
* partition_vs_chance: the share of edge slots a uniformly random
  assignment with the same part sizes would keep inside parts, over the
  share the partition keeps: about 1 for a random partition, far below
  for a clustering; an invalid partition reads inf. The partition has
  no unique answer, so it is judged, not compared.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from bench.reference.cluster_gcn import Batch, RefRun

NAMES = ("loss_gap", "grad_gap", "update_gap", "leaf_gap", "grad_cos_gap",
         "adj_gap", "batch_rows_off", "partition_vs_chance")
TINY_GRAD = 1e-3


def partition_numbers(indptr: np.ndarray, indices: np.ndarray,
                      parts: np.ndarray, num_parts: int) -> Dict[str, float]:
    """partition_vs_chance, with the cut share beside it."""
    parts = np.asarray(parts)
    n = len(indptr) - 1
    if (parts.shape != (n,) or not np.issubdtype(parts.dtype, np.integer)
            or parts.min() < 0 or parts.max() >= num_parts):
        return {"partition_vs_chance": float("inf"), "cut": 1.0}
    sizes = np.bincount(parts, minlength=num_parts).astype(np.float64)
    if np.count_nonzero(sizes) != num_parts:
        return {"partition_vs_chance": float("inf"), "cut": 1.0}
    row = np.repeat(np.arange(n), np.diff(indptr))
    within = float(np.count_nonzero(parts[row] == parts[indices])
                   / max(1, len(indices)))
    chance = float((sizes * (sizes - 1)).sum() / (n * (n - 1.0)))
    return {"partition_vs_chance": (chance / within if within
                                    else float("inf")),
            "cut": float(1.0 - within)}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """The gap of norms of each leaf, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    if set(prog) != set(ref) or not leaves:
        return {"-": float("inf")}
    ref_n = {k: _norm(ref[k]) for k in leaves}
    med = float(np.median(list(ref_n.values())))
    out = {}
    for k in leaves:
        den = max(ref_n[k], med)
        out[k] = (abs(_norm(prog[k].to(ref[k].device)) - ref_n[k]) / den
                  if den else 0.0)
    return out


def _median(gaps: Dict[str, float]) -> float:
    return float(np.median(list(gaps.values())))


def cos_gaps(prog: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """1 - cosine of each leaf's program and reference tensors (1 where
    either is all nought and the other is not)."""
    if set(prog) != set(ref):
        return {"-": float("inf")}
    out = {}
    for k, r in ref.items():
        p, r = prog[k].to(r.device).double().flatten(), r.double().flatten()
        pn, rn = _norm(p), _norm(r)
        out[k] = (1.0 - float(p @ r) / (pn * rn) if pn and rn
                  else float(pn != rn))
    return out


def loss_gaps(prog: Dict, ref: RefRun):
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref.losses)]
    if not gaps or len(prog["losses"]) != len(ref.losses):
        gaps.append(float("inf"))
    return gaps


def diagnostics(prog: Dict, ref: RefRun, b1: float) -> Dict:
    """Read beside the numbers, not compared: every checked step's loss
    gap, the worst leaf of each gap of norms, and the elements whose
    first AdamW update takes the other sign than the reference's (with
    the largest reference gradient among them)."""
    flips = total = 0
    g_max = 0.0
    for k, g in ref.grads1.items():
        mu = prog["mu1"].get(k)
        if mu is None:
            continue
        diff = torch.sign(mu.to(g.device)) != torch.sign(g)
        flips += int(diff.sum())
        total += g.numel()
        if diff.any():
            g_max = max(g_max, float(g[diff].abs().max()))
    g, d = _gaps(prog, ref, b1)
    c = cos_gaps(_grads(prog, b1), ref.grads1)
    return {"step_loss_gaps": loss_gaps(prog, ref),
            "grad_worst_leaf": _worst(g), "update_worst_leaf": _worst(d),
            "cos_worst_leaf": _worst(c),
            "sign_flips": flips, "elements": total,
            "largest_flipped_grad": g_max}


def step_numbers(prog: Dict, ref: RefRun, b1: float) -> Dict[str, float]:
    """prog: losses (floats), mu1 (AdamW's first moment after step 1),
    params0 and params_last, all by leaf name."""
    g, d = _gaps(prog, ref, b1)
    return {"loss_gap": loss_gaps(prog, ref)[0], "grad_gap": _median(g),
            "update_gap": _median(d),
            "leaf_gap": max(_worst(g)[1], _worst(d)[1]),
            "grad_cos_gap": _worst(cos_gaps(_grads(prog, b1), ref.grads1))[1]}


def _worst(gaps: Dict[str, float]):
    return max(gaps.items(), key=lambda kv: kv[1])


def _grads(prog: Dict, b1: float) -> Dict[str, torch.Tensor]:
    """The first gradient as the optimizer received it."""
    return {k: v / (1.0 - b1) for k, v in prog["mu1"].items()}


def _gaps(prog: Dict, ref: RefRun, b1: float):
    grads = _grads(prog, b1)
    names = sorted(ref.grads1)
    g_norm = {k: _norm(ref.grads1[k]) for k in names}
    med = float(np.median(list(g_norm.values())))
    moving = [k for k in names if g_norm[k] >= TINY_GRAD * med]
    d_prog = {k: prog["params_last"][k] - prog["params0"][k]
              for k in prog["params0"]}
    d_ref = {k: ref.params_last[k] - ref.params0[k] for k in names}
    return (leaf_gaps(grads, ref.grads1, names),
            leaf_gaps(d_prog, d_ref, moving))


def densify(adj, n_rows: int, n_cols: int, transposed: bool = False):
    """The dense matrix a block-ELL adjacency's tiles hold (the slots
    the kernels read: those before row_k)."""
    blocks = adj.blocks_t if transposed else adj.blocks
    cols = adj.block_cols_t if transposed else adj.block_cols
    row_k = adj.row_k_t if transposed else adj.row_k
    nrb, K, B, _ = blocks.shape
    width = max(n_cols, (int(cols.max()) + 1) * B if cols.numel() else 0)
    dense = torch.zeros((nrb * B, width), dtype=torch.float32,
                        device=blocks.device)
    live = torch.ones((nrb, K), dtype=torch.bool, device=blocks.device)
    if row_k is not None:
        live = torch.arange(K, device=blocks.device)[None, :] \
            < row_k.to(blocks.device)[:, None].long()
    i, k = torch.nonzero(live, as_tuple=True)
    r = torch.arange(B, device=blocks.device)
    rows = (i[:, None, None] * B + r[None, :, None]).expand(-1, B, B)
    cidx = (cols[i, k].long()[:, None, None] * B
            + r[None, None, :]).expand(-1, B, B)
    dense.index_put_((rows.reshape(-1), cidx.reshape(-1)),
                     blocks[i, k].float().reshape(-1), accumulate=True)
    return dense[:n_rows]


def batch_numbers(payload, batch: Batch) -> Dict[str, float]:
    """adj_gap and batch_rows_off of one program payload (adj, features,
    labels, node_mask, loss_mask, num_real) against the reference's
    batch."""
    adj, feats, labels, node_mask, loss_mask, num_real = payload
    dev = batch.adj.device
    n = len(batch.nodes)
    cap = feats.shape[0]
    feats, labels = feats.to(dev), labels.to(dev)
    node_mask, loss_mask = node_mask.to(dev), loss_mask.to(dev)
    want_f = torch.zeros_like(feats)
    want_f[:n] = batch.features
    want_l = torch.zeros_like(labels)
    want_l[:n] = batch.labels.to(labels.dtype)
    want_nm = torch.zeros_like(node_mask)
    want_nm[:n] = True
    want_lm = torch.zeros_like(loss_mask)
    want_lm[:n] = batch.loss_mask
    off = (feats != want_f).any(-1) | (node_mask != want_nm) \
        | (loss_mask != want_lm)
    off |= (labels != want_l).any(-1) if labels.dim() == 2 \
        else labels != want_l
    rows_off = int(off.sum()) + (0 if int(num_real) == n else cap)
    want = torch.zeros((cap, cap), dtype=torch.float32, device=dev)
    want[:n, :n] = batch.adj
    scale = float(batch.adj.abs().max()) or 1.0
    gap = 0.0
    for transposed, target in ((False, want), (True, want.t())):
        got = densify(adj, cap, cap, transposed).to(dev)
        if got.shape[1] != cap:
            extra = got[:, cap:].abs().max() if got.shape[1] > cap else 0.0
            got = got[:, :cap]
            gap = max(gap, float(extra) / scale)
        gap = max(gap, float((got - target).abs().max()) / scale)
    return {"adj_gap": gap, "batch_rows_off": float(rows_off)}


def all_numbers(prog: Dict, ref: RefRun, b1: float,
                partition: float) -> Dict[str, float]:
    """Every number of NAMES. prog["payloads"] is None for the control
    (the reference in the program's place builds no payload)."""
    nums = step_numbers(prog, ref, b1)
    nums.update(adj_gap=0.0, batch_rows_off=0.0,
                partition_vs_chance=partition)
    payloads = prog["payloads"]
    if payloads is None:
        return nums
    if len(payloads) != len(ref.batches):
        nums["batch_rows_off"] = float("inf")
    for payload, batch in zip(payloads, ref.batches):
        b = batch_numbers(payload, batch)
        nums["adj_gap"] = max(nums["adj_gap"], b["adj_gap"])
        nums["batch_rows_off"] += b["batch_rows_off"]
    return nums


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(nums[k]) and nums[k] <= limits[k] for k in NAMES)
