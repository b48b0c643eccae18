"""Fill-adaptive k_slots selection for the block-ELL sparse path — a
numpy-only copy of `repro.core.kslots` (serving uses `pow2_ceil` for its
request-bucket ladder; the planner serves the training slice).

The paper's premise (§3.1) is that clustered batches are dense WITHIN
clusters and empty BETWEEN them — so the true block-ELL K of a batch
tracks the partition quality, typically far below the lossless worst
case cap/B that the sparse path previously pinned (at 1.6% block fill
~98% of the tiles it shipped to the device were zero padding).

This module measures the block-fill distribution of a batcher by
sampling a few epoch-0 batches (pattern only — no tiles are built) and
picks a small ladder of power-of-two K buckets. Each batch is then
built at the smallest bucket that holds it losslessly, so:

  * FLOPs and tile memory per step track the real fill, and
  * a step sees at most len(buckets) distinct tile shapes (K is a
    shape dim),

with the cap/B bucket always last in the ladder as the guaranteed
lossless fallback (a row-block can never reference more than cap/B
column-blocks, forward or transposed). Enabled end to end with
`ClusterBatcher(..., sparse_adj=True, k_slots="auto")`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def csr_needed_k(indptr, indices, block: int, cap: int) -> Tuple[int, int]:
    """(need_fwd, need_t): smallest lossless forward / transposed K for
    one normalized batch CSR — sparsity pattern only, no tiles built."""
    from repro_torch.kernels.ops import block_ell_needed_k
    return block_ell_needed_k(indptr, indices, block, n_cols=cap,
                              n_rows=cap)


def _sampled_needs(batcher, n: int) -> Tuple[Tuple[int, int], ...]:
    """Measure the first n epoch-0 batches of ANY Sampler — cluster or
    GraphSAINT-style — via its `sample_csrs` contract (the same rng
    stream the real epoch uses, so the sample is what training sees)."""
    return tuple(csr_needed_k(ip, ix, batcher.block_size, batcher.node_cap)
                 for ip, ix, _ in batcher.sample_csrs(n))


@dataclasses.dataclass(frozen=True)
class KSlotsPlan:
    """A ladder of lossless-fallback K buckets chosen from sampled fill.

    buckets: ascending; every entry but the last is a power of two, the
             last is always cap_k = node_cap / block_size (lossless for
             ANY batch, forward and transposed).
    sampled_ft: the (need_fwd, need_t) pairs measured per sampled batch
             (fill_stats reuses them instead of re-sampling).
    sampled_needs: max(need_fwd, need_t, 1) per sampled batch.

    Contract: `bucket_for(need)` returns the smallest ladder entry
    >= need, falling back to cap_k — so a batch built at the returned
    K is ALWAYS lossless, even when epoch-0 sampling under-estimated
    the fill (the plan can cost padding, never correctness). Batches
    that land in the same bucket share one tile shape (K is a shape
    dim). Plans are frozen (a value object): the
    payload builders capture one at sampler init and batch construction
    never mutates it, which keeps epoch streams a pure function of
    (seed, epoch) — the resume-exactness invariant."""
    buckets: Tuple[int, ...]
    cap_k: int
    sampled_ft: Tuple[Tuple[int, int], ...]

    @property
    def sampled_needs(self) -> Tuple[int, ...]:
        return tuple(max(f, t, 1) for f, t in self.sampled_ft)

    def bucket_for(self, need: int) -> int:
        """Smallest bucket that holds `need` slots; cap_k as fallback."""
        for b in self.buckets:
            if b >= need:
                return b
        return self.cap_k


def plan_k_buckets(batcher, sample_batches: int = 8,
                   max_buckets: int = 3) -> KSlotsPlan:
    """Sample the first few epoch-0 batches, measure their lossless K
    needs, and pick at most `max_buckets` buckets: power-of-two
    ceilings of the sampled median and max, plus the cap/B fallback."""
    cap_k = batcher.node_cap // batcher.block_size
    sampled_ft = _sampled_needs(batcher, sample_batches)
    needs = tuple(max(f, t, 1) for f, t in sampled_ft)
    quants = {int(np.ceil(np.quantile(needs, 0.5))), int(max(needs))}
    cands = sorted({min(pow2_ceil(v), cap_k) for v in quants})
    buckets = tuple(c for c in cands if c < cap_k)[:max_buckets - 1] \
        + (cap_k,)
    return KSlotsPlan(buckets=buckets, cap_k=cap_k, sampled_ft=sampled_ft)


def fill_stats(batcher, sample_batches: int = 4) -> dict:
    """Block-fill statistics — mean/p95 of the lossless forward and
    transposed K over sampled epoch-0 batches — so the K-bucket choice
    is inspectable (surfaced through ClusterBatcher.padding_stats()).
    Reuses the measurements the K planner already took at batcher init
    when a plan exists; otherwise samples `sample_batches` batches."""
    plan = getattr(batcher, "k_plan", None)
    if plan is not None and plan.sampled_ft:
        needs = np.array(plan.sampled_ft, dtype=float)
    else:
        needs = np.array(_sampled_needs(batcher, sample_batches),
                         dtype=float)
    nf, nt = needs[:, 0], needs[:, 1]
    return dict(cap_k=batcher.node_cap // batcher.block_size,
                k_fwd_mean=float(nf.mean()),
                k_fwd_p95=float(np.quantile(nf, 0.95)),
                k_t_mean=float(nt.mean()),
                k_t_p95=float(np.quantile(nt, 0.95)))
