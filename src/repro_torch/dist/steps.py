"""Step builders — the port of `repro.dist.steps`.

LM training: `spec_train_state` is the TensorSpec tree of the whole
train state (params, the AdamW step and fp32 moments), which
`init_tree` materializes; `make_train_step` returns (state, batch) ->
(state, metrics): `lm_loss` under the CellPolicy's remat and loss
chunk, gradients accumulated in fp32 over the policy's microbatches,
then the optimizer. The state's keys are the reference's, so a
checkpoint of either package's train state restores in the other.

Without a mesh the step runs on one device
(`nn.core.accumulate_gradients`). With `mesh=` (a DeviceMesh,
`launch.mesh`) the same step body is the reference's pjit step in
eager DTensor form:
the state's leaves are DTensors laid out per `dist.sharding`
(`shardings_for` of `spec_train_state`; FSDP when `policy.fsdp`), the
batch is sharded over the data axes, and DTensor's sharding propagation
places the collectives GSPMD would: the FSDP all-gathers of each weight
where it is used, the activations constrained to `act_spec` at the
reference's points, each gradient reduced (reduce-scatter or all-reduce)
to its param's layout, the update local to each shard. Attention runs
its kernel on local shards (`kernels.ops.sharded_attention`).

LM serving: `make_prefill_step` / `make_decode_step` (decoders) and
`make_encode_step` (encoder-only archs) are closures over the
architecture config; given DTensor params and inputs they run sharded,
with the activations constrained to `act_spec`.

GCN data parallel: `make_gcn_train_step` runs the paper's training step
on every rank of a `torch.distributed` process group, where the
reference runs it under shard_map over a mesh's data axis. Each rank
takes the gradient of the mean loss over its own cluster batches (the
block-diagonal objective of Eq. 6/7 decomposes exactly across
clusters), and the gradients meet in one all-reduce, optionally
compressed (`repro_torch.dist.compression`). Every rank then applies
the same optimizer update, so the params stay identical everywhere.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.core.gcn import GCNConfig, gcn_loss
from repro_torch.core.precision import (all_finite, init_scale_state,
                                        policy_from_config, scale_loss,
                                        select_tree, unscale_grads,
                                        update_scale_state)
from repro_torch.dist.compression import (DEFAULT_GROUP_SIZE,
                                          error_feedback_message)
from repro_torch.kernels.ops import spmm as spmm_dispatch
from repro_torch.kernels.ops import spmm_xw as spmm_xw_dispatch
from repro_torch.dist.sharding import CellPolicy
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import vocab_argmax
from repro_torch.models.lm import (decode_step, encode, lm_loss, prefill,
                                   spec_params)
from repro_torch.models.spec import TensorSpec, map_specs
from repro_torch.nn.core import accumulate_gradients
from repro_torch.nn.optim import (AdamState, Optimizer, apply_updates,
                                  global_norm)
from repro_torch.nn.tree import Tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime import faults

COMPRESSIONS = (None, "bf16", 4, 8)


# ----------------------------------------------------------------------
# LM training
# ----------------------------------------------------------------------
def spec_train_state(cfg: ArchConfig) -> Dict:
    """TensorSpec tree for {params, step, mu, nu}: the params, and the
    AdamW state `adamw()` builds (an int32 step, fp32 moments)."""
    params = spec_params(cfg)

    def moment(s: TensorSpec) -> TensorSpec:
        return TensorSpec(s.shape, s.axes, init="zeros",
                          dtype=torch.float32)
    return {"params": params,
            "step": TensorSpec((), (), init="zeros", dtype=torch.int32),
            "mu": map_specs(moment, params),
            "nu": map_specs(moment, params)}


def make_train_step(cfg: ArchConfig, policy: CellPolicy, opt: Optimizer,
                    act_spec=None, mesh=None) -> Callable:
    """(state, batch) -> (state, metrics "loss", "acc", "grad_norm"),
    the metrics 0-d tensors on the state's device (reading them syncs
    the host; the step itself does not). With policy.microbatches = m >
    1 the batch's leading dim is split into m microbatches whose
    gradients accumulate in fp32 and are averaged; loss and accuracy
    are the microbatches' means.

    With `mesh` the same step runs sharded (module docstring): the
    state's leaves must be DTensors on `mesh` (`dist.sharding.
    distribute_tree` of `shardings_for(spec_train_state(cfg), mesh,
    rules)`), the batch DTensors or plain global tensors (each rank then
    keeps its batch shard), `act_spec` the activations' spec
    (`(rules["batch"], None, None)`); the new state keeps the state's
    layouts and the metrics are plain tensors. The mesh decides only
    the inputs' placement, the microbatch split and the layouts
    (`_like`, `_full`: identities on plain tensors). Without a mesh,
    `policy.fsdp` raises: there is nothing to shard over."""
    if mesh is None and policy.fsdp:
        raise ValueError("CellPolicy(fsdp=True) shards the train state over "
                         "a device mesh: pass mesh= (launch.mesh)")
    batch_axis = act_spec[0] if act_spec else None

    def loss_fn(params, mb):
        loss, metrics = lm_loss(params, cfg, mb, remat=policy.remat,
                                loss_chunk=policy.loss_chunk,
                                act_spec=act_spec)
        return loss, {"acc": metrics["acc"]}

    def shard_input(x):
        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch.dist.sharding import placements
        if isinstance(x, DTensor):
            return x
        return distribute_tensor(x, mesh, placements(
            (batch_axis,) + (None,) * (x.dim() - 1), mesh),
            src_data_rank=None)

    def split(batch, m):
        return _split_microbatches(batch, m, act_spec)

    def step(state: Dict, batch: Dict):
        params = state["params"]
        if mesh is not None:
            batch = {k: shard_input(v) for k, v in batch.items()}
        loss, aux, grads = accumulate_gradients(
            loss_fn, params, batch, policy.microbatches,
            split=None if mesh is None else split, grad_layout=_like)
        with torch.no_grad():
            opt_state = AdamState(step=state["step"], mu=state["mu"],
                                  nu=state["nu"])
            updates, opt_state = opt.update(grads, opt_state, params)
            new_state = {"params": apply_updates(params, updates),
                         "step": opt_state.step, "mu": opt_state.mu,
                         "nu": opt_state.nu}
            new_state = tree_map(_like, new_state, state)
            metrics = {"loss": _full(loss), "acc": _full(aux["acc"]),
                       "grad_norm": _full(global_norm(grads))}
        return new_state, metrics

    return step if mesh is None else _sharded(step)


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """x laid out as ref when ref is a DTensor (a gradient's
    reduce-scatter or all-reduce to its param's layout, or a no-op); x
    itself otherwise."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def _full(x: torch.Tensor) -> torch.Tensor:
    """The global value of a DTensor; x itself otherwise."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _sharded(fn: Callable) -> Callable:
    """fn under `implicit_replication`, so the plain tensors the model
    makes (positions, masks, scalars) join DTensor ops as replicated."""
    def call(*args, **kwargs):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args, **kwargs)
    return call


def _split_microbatches(batch: Dict, m: int, act_spec) -> list:
    """The m microbatches of a DTensor batch, microbatch c the rows
    c·B/m … (c+1)·B/m as in the unsharded step, each re-pinned to the
    batch layout (the reference's `_split_microbatches`). Where m does
    not divide the batch dim's shards, that dim is gathered first (the
    inputs are token ids or frame embeddings, small beside the step)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.lm import _constrain
    batch_axis = act_spec[0] if act_spec else None

    def split(x):
        if x.shape[0] % m:
            raise ValueError(f"global batch {x.shape[0]} not divisible by "
                             f"microbatches={m}")
        shards = math.prod(n for n, p in zip(tuple(x.device_mesh.shape),
                                             x.placements)
                           if p == Shard(0))
        if m % shards:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == Shard(0) else p for p in x.placements])
        return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    micro = {k: split(v) for k, v in batch.items()}
    return [{k: _constrain(v[c], (batch_axis,) + (None,) * (v.dim() - 2))
             for k, v in micro.items()} for c in range(m)]


def make_prefill_step(cfg: ArchConfig, policy: CellPolicy = None,
                      act_spec=None) -> Callable:
    """(params, batch, caches) -> (last-position logits, caches). The
    policy is the reference's argument; a prefill runs no backward, so
    its remat changes nothing here."""
    @_sharded
    def step(params, batch, caches):
        return prefill(params, cfg, batch, caches, act_spec=act_spec)
    return step


def make_decode_step(cfg: ArchConfig, policy: CellPolicy = None,
                     act_spec=None) -> Callable:
    """(params, tokens (B, 1), caches, pos) -> (next greedy token (B, 1)
    int32, logits (B, V), caches). The argmax stays on the device, so a
    decode loop never waits for the host. On DTensors the logits keep
    their vocab-sharded layout and the argmax reduces each shard's
    maximum and its index (`layers.vocab_argmax`, jax's first
    maximum)."""
    @_sharded
    def step(params, tokens, caches, pos):
        logits, caches = decode_step(params, cfg, tokens, caches, pos,
                                     act_spec=act_spec)
        nxt = vocab_argmax(logits).to(torch.int32)[:, None]
        return nxt, logits, caches
    return step


def make_encode_step(cfg: ArchConfig, policy: CellPolicy = None,
                     act_spec=None) -> Callable:
    """Encoder-only forward: (params, batch) -> frame logits (B, S, V)."""
    @_sharded
    def step(params, batch):
        return encode(params, cfg, batch, act_spec=act_spec)
    return step


# ----------------------------------------------------------------------
# GCN data-parallel step
# ----------------------------------------------------------------------
def init_gcn_train_state(params: Tree, opt: Optimizer, nshards: int,
                         compression=None, policy=None) -> Dict:
    """{params, opt} (+ the error-feedback residuals "err", stacked on a
    leading shard axis of size `nshards`, when int compression is on;
    + the loss "scale" state when the precision policy scales), on the
    params' device — `repro.dist.steps.init_gcn_train_state`. Rank r
    reads and writes row r of "err"; the data-parallel backend gathers
    the rows before a checkpoint."""
    state = {"params": params, "opt": opt.init(params)}
    if isinstance(compression, int):
        state["err"] = tree_map(
            lambda p: torch.zeros((nshards,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device),
            params)
    if policy is not None and policy.scaled:
        device = tree_leaves(params)[0].device
        state["scale"] = init_scale_state(policy, device)
    return state


def _poison_batches(batches, rule):
    return [faults.poison_batch(b, rule) for b in batches]


def make_gcn_train_step(cfg: GCNConfig, opt: Optimizer, group=None, *,
                        compression=None, microbatches: int = 1,
                        compression_group_size=None,
                        spmm: Callable = spmm_dispatch,
                        spmm_xw: Callable = spmm_xw_dispatch) -> Callable:
    """Data-parallel Cluster-GCN step over `group` (a torch.distributed
    process group; None is the default group) — the counterpart of
    `repro.dist.steps.make_gcn_train_step`, whose mesh axis becomes the
    group's ranks.

    The returned function maps
        (state, generator, batches) -> (state, loss, aux)
    where `batches` is THIS rank's list of q_local device batch tuples
    (the rank's slice of the reference's stacked group) and `generator`
    draws this rank's dropout. Each rank takes the gradient of the mean
    loss over its batches through `gcn_loss` with the port's
    `spmm`/`spmm_xw` dispatch (on CUDA: the fused kernel forward and the
    block-ELL SpMM backward), then the gradients mean-all-reduce:
      compression=None   exact fp32 sum
      compression="bf16" the bf16-rounded message, summed in fp32
      compression=4|8    int4/int8 symmetric quantization with error
                         feedback, one scale per `compression_group_size`
                         elements (None: DEFAULT_GROUP_SIZE)
    All leaves (and the loss and aux) travel in ONE all-reduce of one
    flat fp32 buffer; quantization stays per leaf, as in the reference.
    Loss is the global mean, aux the global sums.

    microbatches=m > 1 splits the q_local batches into m sequential
    chunks, accumulating fp32 gradients (divided by m) before the one
    all-reduce. Loss scaling unscales before the reduce, so the
    residuals carry true-unit gradients, and a rank that overflowed
    spreads NaN to every rank through the reduce (quantization turns an
    infinite scale into NaN codes): the update skip is the same on
    every rank.
    """
    if compression not in COMPRESSIONS:
        raise ValueError(
            f"compression must be None, 'bf16', 4 or 8; got {compression!r}")
    m = int(microbatches)
    if m < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    gsize = DEFAULT_GROUP_SIZE if compression_group_size is None \
        else int(compression_group_size)
    if gsize < 1:
        raise ValueError(f"compression_group_size must be >= 1, got "
                         f"{compression_group_size}")
    bits = compression if isinstance(compression, int) else None
    pol = policy_from_config(cfg)
    aux_keys = ("tp", "fp", "fn", "n") if cfg.multilabel \
        else ("correct", "n")

    def local_grads(params, batches, generator, scale):
        """(mean loss, summed aux, grads) over this rank's batches."""
        q_local = len(batches)
        if q_local % m:
            raise ValueError(f"{q_local} local batches not divisible by "
                             f"microbatches={m}")
        mb = q_local // m
        grads, loss_sum = None, 0.0
        aux = {k: 0.0 for k in aux_keys}
        for c in range(m):
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            params)
            losses = []
            for bt in batches[c * mb:(c + 1) * mb]:
                loss, a = gcn_loss(live, bt, cfg, train=True,
                                   generator=generator, spmm=spmm,
                                   spmm_xw=spmm_xw)
                losses.append(loss)
                aux = {k: aux[k] + a[k].detach() for k in aux_keys}
            loss = torch.stack(losses).mean()
            target = scale_loss(loss, scale) if pol.scaled else loss
            g = torch.autograd.grad(target, tree_leaves(live))
            if m > 1:
                g = [x.float() for x in g]
            grads = list(g) if grads is None else \
                [a + b for a, b in zip(grads, g)]
            loss_sum = loss_sum + loss.detach()
        if m > 1:
            grads = [g / m for g in grads]
        return loss_sum / m, aux, grads

    def step(state, generator, batches):
        params = state["params"]
        scale = state["scale"]["scale"] if pol.scaled else None
        loss, aux, grads = local_grads(params, batches, generator, scale)
        with torch.no_grad():
            if pol.scaled:
                grads = tree_leaves(unscale_grads(grads, scale))
            new_state = dict(state)
            if bits is not None:
                rank = dist.get_rank(group)
                errs = tree_leaves(state["err"])
                msgs, rows = zip(*(
                    error_feedback_message(g, e[rank], bits, gsize)
                    for g, e in zip(grads, errs)))
            elif compression == "bf16":
                msgs = [g.to(torch.bfloat16).float() for g in grads]
            else:
                msgs = [g.float() for g in grads]
            scalars = torch.stack([loss.float()]
                                  + [torch.as_tensor(aux[k]).float()
                                     .to(loss.device) for k in aux_keys])
            flat = torch.cat([x.reshape(-1) for x in msgs] + [scalars])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            world = dist.get_world_size(group)
            out, off = [], 0
            for g in grads:
                n = g.numel()
                out.append((flat[off:off + n] / world).view(g.shape)
                           .to(g.dtype))
                off += n
            total = flat[off:]
            synced = tree_unflatten(params, out)
            updates, opt_state = opt.update(synced, state["opt"], params)
            new_params = apply_updates(params, updates)
            if bits is not None:
                new_err = tree_unflatten(params, [
                    _replace_row(e, rank, r) for e, r in zip(errs, rows)])
            if pol.scaled:
                # the reduced grads are NaN everywhere if ANY rank
                # overflowed, so every rank takes the same branch
                finite = all_finite(synced)
                new_state["params"] = select_tree(finite, new_params,
                                                  params)
                new_state["opt"] = select_tree(finite, opt_state,
                                               state["opt"])
                if bits is not None:
                    new_err = select_tree(finite, new_err, state["err"])
                new_state["scale"] = update_scale_state(state["scale"],
                                                        finite, pol)
            else:
                new_state["params"] = new_params
                new_state["opt"] = opt_state
            if bits is not None:
                new_state["err"] = new_err
        loss = total[0] / world
        aux = {k: total[1 + i] for i, k in enumerate(aux_keys)}
        return new_state, loss, aux

    # step.nonfinite_loss injection seam (runtime.faults): the batches
    # are the last argument, as in the single-device step
    def wrapped(state, generator, batches):
        rule = faults.maybe_fail("step.nonfinite_loss")
        if rule is not None:
            batches = _poison_batches(batches, rule)
        return step(state, generator, batches)
    return wrapped


def _replace_row(stack: torch.Tensor, r: int, row: torch.Tensor
                 ) -> torch.Tensor:
    """A new (world, ...) stack with row r replaced (the other rows are
    other ranks' residuals, which this rank never reads)."""
    return torch.cat([stack[:r], row[None], stack[r + 1:]])
