"""Sharding rules — the port of `repro.dist.sharding`: logical axis
names -> mesh axes, per (arch × shape × policy) cell, and the DTensor
placements they give on a `DeviceMesh`.

`make_rules` is the single decision point for how every tensor of the
LM shards. It never guesses from tensor names: it walks the TensorSpec
trees of models/spec.py (params AND caches), collects every dimension
size each logical axis labels, and only assigns a mesh axis when EVERY
such dimension divides the mesh-axis size. Anything that doesn't fit
falls back to replicated — so pspec_tree(specs, rules) is
divisibility-safe by construction for every arch in configs.ARCH_NAMES.
The rules dict is the reference's, entry for entry.

`shardings_for` turns a spec tree into one `Sharding` per leaf: the
mesh and a placement per mesh dim — `Shard(d)` where tensor dim d names
that mesh axis (a tuple entry such as ("pod", "data") shards dim d over
both, major to minor, as jax does), `Replicate()` elsewhere and on mesh
dims of one rank.
`distribute_tree` makes DTensors of a tree of full tensors with them.

`make_rules` reads only `mesh_dim_names` and `shape`, so tests pass a
stub mesh with no ranks behind it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.lm import spec_caches, spec_params
from repro_torch.models.spec import map_specs
from repro_torch.nn.tree import tree_leaves, tree_map

ShardingRules = Dict[str, Any]   # logical axis -> mesh axis | tuple | None


@dataclasses.dataclass(frozen=True)
class CellPolicy:
    """Per-cell parallelism knobs (the dry-run hillclimb surface)."""
    fsdp: bool = False          # shard 'embed' (and MoE expert state) over data
    microbatches: int = 1       # gradient-accumulation splits of the batch
    remat: bool = True          # checkpoint each scanned layer group
    loss_chunk: int = 512       # chunked-CE chunk length


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: one placement per mesh dim (the
    counterpart of jax's NamedSharding)."""
    mesh: Any
    placements: Tuple[Any, ...]


def _data_spec(mesh):
    """data_axes as a spec entry: a bare string for the common
    single-axis case, a tuple for multipod, None when absent."""
    axes = data_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _collect_dims(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, set]:
    """Every dimension size each logical axis labels, across the param
    tree and the (batch, seq_len)-sized cache tree."""
    dims: Dict[str, set] = {}
    trees = [spec_params(cfg),
             spec_caches(cfg, shape.global_batch, shape.seq_len)]
    for tree in trees:
        for s in tree_leaves(tree):
            for d, a in zip(s.shape, s.axes):
                if a is not None:
                    dims.setdefault(a, set()).add(int(d))
    dims.setdefault("batch", set()).add(int(shape.global_batch))
    return dims


def make_rules(mesh, cfg: ArchConfig, shape: ShapeConfig,
               policy: CellPolicy) -> ShardingRules:
    """Axis rules for one (arch × shape × policy) cell.

    Layout: tensor-ish axes (heads/kv/ffn/experts/vocab + the SSM/LSTM
    inner dims) over 'model'; 'embed' FSDP-shards over the data axes when
    policy.fsdp; 'batch' over the data axes. KV caches shard over
    kv-heads when the head count divides 'model', else fall back to
    sequence-sharded KV (flash-decoding style) — e.g. gemma3's kv=1.
    """
    dims = _collect_dims(cfg, shape)
    data = _data_spec(mesh)
    model = "model" if "model" in tuple(mesh.mesh_dim_names) else None

    def fit(axis: str, want) -> Optional[Any]:
        """`want` iff every dim labeled `axis` divides the mesh axes."""
        if want is None:
            return None
        k = axis_size(mesh, want)
        sizes = dims.get(axis)
        if not sizes or any(d % k for d in sizes):
            return None
        return want

    rules: ShardingRules = {
        "embed": fit("embed", data) if policy.fsdp else None,
        "embed2": fit("embed2", model),
        "heads": fit("heads", model),
        "kv": fit("kv", model),
        "ffn": fit("ffn", model),
        "experts": fit("experts", model),
        # expert FFN width stays unsharded: 'experts' already takes
        # 'model' and double-sharding one weight over one axis is illegal
        "moe_ffn": None,
        "vocab": fit("vocab", model),
        "layers": None,            # the group axis — never sharded
        "batch": fit("batch", data),
        "ssm_in": fit("ssm_in", model),
        "ssm_heads": fit("ssm_heads", model),
        "lstm_in": fit("lstm_in", model),
        "lstm_in2": fit("lstm_in2", model),
        "lstm_heads": fit("lstm_heads", model),
    }
    # KV cache: prefer head sharding; kv=1-style archs (or head counts
    # not divisible by 'model') get sequence-sharded KV instead.
    kv_heads = fit("kv_heads", model)
    rules["kv_heads"] = kv_heads
    rules["kv_seq"] = None if kv_heads is not None else fit("kv_seq", model)
    return rules


def placements(pspec: Tuple, mesh) -> Tuple[Any, ...]:
    """DTensor placements of a spec tuple on `mesh`: Shard(d) on each
    mesh dim that tensor dim d names, Replicate() on the others. A mesh
    dim of one rank replicates (sharding over it is the identity, and
    DTensor's einsum trips on it). A mesh axis can shard one dim only:
    where a spec names it on two (xlstm's sLSTM recurrence, (heads, in,
    in) with both ins on 'model', which jax's PartitionSpec rejects), the
    first dim takes it and the later ones stay whole."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            if out[i] == Replicate() and sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


class _Constraint(torch.autograd.Function):
    """x redistributed to `places`, and its gradient too."""

    @staticmethod
    def forward(ctx, x, places):
        ctx.places = places
        return x.redistribute(x.device_mesh, places)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.places), None


def constrain(x, places):
    """The DTensor x laid out as `places` on its mesh, the counterpart of
    `jax.lax.with_sharding_constraint`, which pins the cotangent to the
    same sharding. A plain `redistribute` leaves the gradient as it
    arrives: a column-parallel product's backward gives partial sums
    over 'model', and carried down the residual stream they make the
    next row-parallel product's backward run at full width on every rank
    (its weight gathered) where summing them here keeps it local."""
    return _Constraint.apply(x, tuple(places))


def _pspec(s, rules: ShardingRules) -> Tuple:
    return tuple(rules.get(a) if a is not None else None for a in s.axes)


def shardings_for(tree, mesh, rules: ShardingRules):
    """A `Sharding` per TensorSpec leaf of `tree`."""
    return map_specs(lambda s: Sharding(mesh, placements(_pspec(s, rules),
                                                         mesh)), tree)


def batch_pspec(bspecs, mesh, rules: ShardingRules):
    """Shardings for the model-input batch ({name: (shape, dtype)}, as
    `configs.input_specs` gives it): the batch dim sharded per
    rules['batch'], everything else replicated."""
    b = rules.get("batch")
    return {name: Sharding(mesh, placements(
        (b,) + (None,) * (len(shp) - 1), mesh))
        for name, (shp, _) in bspecs.items()}


def replicated(mesh) -> Sharding:
    return Sharding(mesh, placements((), mesh))


def local_shape(shape, sharding: Sharding) -> Tuple[int, ...]:
    """The shard one rank holds of a tensor of `shape` (every sharded
    dim divides its mesh axes, which `make_rules` guarantees)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for size, p in zip(tuple(sharding.mesh.shape), sharding.placements):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide {size}")
            out[p.dim] //= size
    return tuple(out)


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def distribute_tree(tree, shardings):
    """DTensors of a tree of full tensors, each laid out per its
    `Sharding` (same tree structure). Every rank holds the same full
    tensors (drawn from one seed), so each keeps its own shard and
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    sh = tree_leaves(shardings, is_leaf=_is_sharding)
    leaves = tree_leaves(tree)
    if len(sh) != len(leaves):
        raise ValueError(f"{len(leaves)} tensors but {len(sh)} shardings")
    it = iter(sh)

    def one(t: torch.Tensor):
        s = next(it)
        return distribute_tensor(t, s.mesh, s.placements,
                                 src_data_rank=None)
    return tree_map(one, tree)


def fake_tree(specs, shardings):
    """DTensors with the global shape and dtype of each TensorSpec of
    `specs`, each built from a local shard of `local_shape` made under
    the caller's `FakeTensorMode` (the dry-run's state: no storage)."""
    from torch.distributed.tensor import DTensor
    sh = iter(tree_leaves(shardings, is_leaf=_is_sharding))

    def one(s):
        shd = next(sh)
        local = torch.empty(local_shape(s.shape, shd), dtype=s.dtype)
        return DTensor.from_local(local, shd.mesh, shd.placements,
                                  run_check=False, shape=torch.Size(s.shape),
                                  stride=_contiguous(s.shape))
    return map_specs(one, specs)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
