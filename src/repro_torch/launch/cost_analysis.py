"""Per-device cost of one step — the port's counterpart of
`repro.launch.hlo_analysis`.

The reference walks the optimized (post-SPMD) HLO text of a compiled
step. Eager PyTorch has no HLO, so this module runs the step once under
a `TorchDispatchMode` that sees every op ONE rank executes on its local
tensors, and counts, per rank:

  flops       — `torch.utils.flop_counter`'s registry (mm, addmm, bmm,
                baddbmm, convolutions, attention) on each local op's
                shapes
  bytes       — HBM-traffic proxy: each local op's input plus output
                bytes; views are free, and the reference's slice rule
                (`hlo_analysis.py:88-116`) holds: a gather-like op
                (index, gather, index_select, embedding) moves 2 × its
                output, a scatter-like op (index_put, scatter, index_add)
                2 × its update plus 64
  collectives — per kind {count, bytes}: the c10d functional ops that
                DTensor and `torch.distributed._functional_collectives`
                issue (and the legacy c10d ops of `dist.all_reduce`),
                bytes the ring estimate of the reference's
                `_COLLECTIVES`: factor × max(input, output) bytes

Python loops (layer groups, microbatches, loss chunks) run in eager, so
every iteration is seen and no trip counts are needed. Eager PyTorch
does not fuse, so `bytes` counts every elementwise op's traffic where
XLA counts a fusion's interface once: it is an upper bound of what a
fused program moves.

A mode around DTensor code sees each op twice: first with DTensor
arguments (the GLOBAL op), then every local op DTensor issues for it.
The walker returns NotImplemented for the first, so only local ops
count. DTensor's sharding propagation also runs ops on fake tensors of
the GLOBAL shape to learn output metadata; the walker wraps the
propagator for its lifetime and skips everything inside it.

Memory (the dry-run's per-device record): bytes of the tensors the ops
create, live until their last Python reference dies, on top of the
arguments' local bytes — `argument_size_in_bytes` (inputs),
`output_size_in_bytes` (the result), `temp_size_in_bytes` (the peak of
live created bytes) and `peak_memory_in_bytes` (argument + temp): what
eager PyTorch holds at once, without the caching allocator's slack.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ring factors of the reference's `_COLLECTIVES` (hlo_analysis.py:118)
_COLLECTIVES = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}
_COLLECTIVE_OPS = {
    # torch.ops._c10d_functional (DTensor, functional collectives)
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
    # torch.ops.c10d (ProcessGroup calls: dist.all_reduce, ...)
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_FREE = {"wait_tensor", "device", "empty", "empty_like", "empty_strided",
         "lift_fresh", "lift_fresh_copy", "detach", "alias", "_unsafe_view",
         "set_", "resize_", "barrier"}
_GATHER_LIKE = {"index", "gather", "index_select", "embedding",
                "take_along_dim"}
_SCATTER_LIKE = {"index_put", "index_put_", "_index_put_impl_", "scatter",
                 "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
                 "scatter_reduce_", "index_add", "index_add_", "index_copy",
                 "index_copy_", "masked_scatter", "masked_scatter_"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


@dataclasses.dataclass
class _OpCost:
    op: str
    shapes: tuple
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class CostWalker(TorchDispatchMode):
    """Counts one rank's local ops while active (module docstring).
    Enter it inside any `FakeTensorMode` the step runs under."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.ops: Dict[tuple, _OpCost] = {}
        self.live = 0
        self.temp_peak = 0
        self._skip = 0
        self._patched = None

    # -- DTensor's global-shape propagation is not this rank's work ----
    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(prop, n)), None)
        if name is None:
            raise RuntimeError("cannot find DTensor's sharding propagation "
                               "to exclude it from the count")
        orig = getattr(prop, name)

        def skipped(*args, **kwargs):
            self._skip += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._skip -= 1
        setattr(prop, name, skipped)
        self._patched = (prop, name)
        return super().__enter__()

    def __exit__(self, *exc):
        prop, name = self._patched
        delattr(prop, name)             # the class's method shows again
        self._patched = None
        return super().__exit__(*exc)

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # the global op: DTensor unwraps it
        out = func(*args, **kwargs)
        if not self._skip:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._opname if hasattr(func, "_opname") \
            else func.__name__.split(".")[0]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        if func.namespace in _COLLECTIVE_NS and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            rec = self.coll.setdefault(kind, {"count": 0.0, "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += _COLLECTIVES[kind] * max(in_b, out_b)
            self._track(func, ins, outs)
            return
        if name in _FREE or func.namespace == "prim" or \
                getattr(func, "is_view", False):
            return
        if name in _GATHER_LIKE:
            traffic = 2.0 * out_b
        elif name in _SCATTER_LIKE:
            upd = max((_nbytes(t) for t in ins[1:]), default=out_b)
            traffic = 2.0 * upd + 64.0
        else:
            traffic = float(in_b + out_b)
        fl = 0.0
        fn = self._flop_registry.get(func._overloadpacket)
        if fn is not None:
            fl = float(fn(*args, **kwargs, out_val=out))
        self.flops += fl
        self.bytes += traffic
        key = (str(func), tuple(tuple(t.shape) for t in ins[:3]))
        rec = self.ops.get(key)
        if rec is None:
            rec = self.ops[key] = _OpCost(str(func), key[1])
        rec.count += 1
        rec.flops += fl
        rec.bytes += traffic
        self._track(func, ins, outs)

    def _track(self, func, ins, outs) -> None:
        """Count each fresh output until its last reference dies."""
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen or getattr(func, "is_view", False):
                continue
            n = _nbytes(t)
            self.live += n
            self.temp_peak = max(self.temp_peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {k: dict(v) for k, v in self.coll.items()}}

    def top(self, k: int = 20) -> List[Dict]:
        rows = sorted(self.ops.values(), key=lambda r: -r.bytes)[:k]
        return [dataclasses.asdict(r) for r in rows]


def local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of (D)Tensors (local shards)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def run_step(fn: Callable, *args, **kwargs):
    """(fn's result, the walker after one call of fn(*args, **kwargs),
    its memory record)."""
    arg_b = local_bytes((args, kwargs))
    walker = CostWalker()
    with walker:
        out = fn(*args, **kwargs)
    memory = {"argument_size_in_bytes": int(arg_b),
              "output_size_in_bytes": int(local_bytes(out)),
              "temp_size_in_bytes": int(walker.temp_peak),
              "peak_memory_in_bytes": int(arg_b + walker.temp_peak)}
    return out, walker, memory


def analyze_step(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """`analyze_hlo`'s keys for one call of fn(*args, **kwargs) on this
    rank: {"flops", "bytes", "collectives": {kind: {"count",
    "bytes"}}}."""
    _, walker, _ = run_step(fn, *args, **kwargs)
    return walker.summary()


def top_costs(fn: Callable, *args, k: int = 20, **kwargs) -> List[Dict]:
    """Profiler view: the local ops (by op and input shapes) ranked by
    bytes, with their counts and FLOPs — the reference's `top_costs`."""
    _, walker, _ = run_step(fn, *args, **kwargs)
    return walker.top(k)
