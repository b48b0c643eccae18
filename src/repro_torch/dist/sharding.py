"""Per-cell parallelism knobs — the part of `repro.dist.sharding` that
the port's LM training reads.

`CellPolicy` is the reference's dataclass, field for field. The
reference's sharding rules (`make_rules`, `shardings_for`,
`batch_pspec`: logical axis names mapped onto a device mesh) wait for
the port's tooling slice (ROADMAP A7); the port trains on one device,
so `make_train_step` raises for `fsdp=True`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CellPolicy:
    """Per-cell parallelism knobs (the dry-run hillclimb surface)."""
    fsdp: bool = False          # shard 'embed' (and MoE expert state) over data
    microbatches: int = 1       # gradient-accumulation splits of the batch
    remat: bool = True          # checkpoint each scanned layer group
    loss_chunk: int = 512       # chunked-CE chunk length
