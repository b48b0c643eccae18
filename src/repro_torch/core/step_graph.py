"""The training step on a CUDA device as captured CUDA graphs: one graph
per payload shape signature, each replayed with one launch instead of
the few hundred kernel launches of its forward, backward and optimizer.

`GraphedStep(fn, device)` wraps a step `fn(state, payload) -> (state,
loss, aux)` (the body `SingleDeviceBackend` runs eagerly on the CPU) and
is called the same way:

* The first call of a signature runs `fn` eagerly on a side stream, the
  warm-up that lazy initialisation needs before a capture, and returns
  its result.
* The second captures `fn` on that stream. The graph's inputs are
  static copies of the payload's tensors and of the state's tensors
  (one static state per state layout, shared by every graph of that
  layout); at its end the graph writes the new state over the static
  state and packs loss and aux into one tensor. That call and every
  later one of the signature replay the graph.
* A replay copies the payload into the graph's inputs (device to
  device) and the state too, unless it is the state the last replay
  returned, unmodified: the static state holds that one already. It
  launches the graph and returns fresh copies of the new state, the
  loss and aux. So a state or a loss returned once stays valid whatever
  later steps do, as on the eager path, and the payload is only read.

Signature: each payload tensor's shape, dtype and device (a block-ELL
adjacency's tiles, K included), so k_slots="auto" gives one graph per K
bucket, and the same for the state's tensors.

The state's dropout generators are registered with each graph, so a
replay draws what the eager step would have drawn at the same generator
offsets; a generator other than the one captured has its state carried
to the captured one and back. The block-ELL wrappers' split-partials
workspace of a capture stays with its graph (`block_spmm.
graph_workspace`), and each replay adds the launches its capture counted
to the wrappers' counters, which thus count launches executed.

A capture that fails raises; there is no eager fallback.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import block_spmm
from repro_torch.kernels.block_spmm import BlockEllAdj
from repro_torch.nn.tree import tree_builder, tree_leaves, tree_unflatten
from repro_torch.runtime import trace

# the spans and counters of this module (docs/tracing.md)
SPANS = ("step.capture", "step.replay")
COUNTERS = ("step.graph_captures", "step.graph_replays")

_NEW = object()          # a signature not seen yet


def payload_leaves(payload) -> List:
    """The payload's leaves, a block-ELL adjacency opened into its
    tensors (None where it has no `row_k`)."""
    out = []
    for leaf in payload:
        if isinstance(leaf, BlockEllAdj):
            out.extend(leaf.tensors())
        else:
            out.append(leaf)
    return out


def signature(leaves) -> tuple:
    """Shape, dtype and device of each tensor; a generator's device;
    any other leaf (None, a number) as itself, since a capture bakes it
    in."""
    return tuple((t.shape, t.dtype, t.device) if isinstance(t, torch.Tensor)
                 else ("generator", t.device)
                 if isinstance(t, torch.Generator) else t for t in leaves)


def _with_tensors(payload, tensors) -> tuple:
    """`payload` with its tensors, in `payload_leaves` order, taken from
    `tensors` (the adjacency rebuilt around them, already checked)."""
    it = iter(tensors)
    out = []
    for leaf in payload:
        if isinstance(leaf, BlockEllAdj):
            out.append(BlockEllAdj(*(None if t is None else next(it)
                                     for t in leaf.tensors()), checked=True))
        else:
            out.append(next(it) if isinstance(leaf, torch.Tensor) else leaf)
    return tuple(out)


class StaticState:
    """The static state of one state layout (`sig`): one flat buffer per
    dtype and a view of it per tensor leaf, which the graphs read and
    write. Each view starts on a boundary of `ALIGN` bytes, as a tensor
    of its own would: a kernel's copy width and a GEMM's algorithm
    depend on its operands' alignment. `last` is what `fresh` last
    returned, with its version counters."""

    ALIGN = 512          # bytes, the CUDA caching allocator's alignment

    def __init__(self, sig: tuple, tensors, device):
        self.sig = sig
        sizes: Dict[torch.dtype, int] = {}
        # each leaf's place in its dtype's flat: shape, strides, offset
        self.places = []
        for t in tensors:
            at = sizes.get(t.dtype, 0)
            self.places.append((t.dtype, t.shape,
                                torch.empty(t.shape, device="meta").stride(),
                                at))
            step = self.ALIGN // t.element_size()
            sizes[t.dtype] = at + -(-t.numel() // step) * step
        self.flats = {dt: torch.empty(n, dtype=dt, device=device)
                      for dt, n in sizes.items()}
        self.views = self._split(self.flats)
        self.last = None

    def _split(self, flats) -> List[torch.Tensor]:
        """Views of `flats` (one a dtype), one a leaf, in leaf order."""
        return [flats[dt].as_strided(shape, stride, at)
                for dt, shape, stride, at in self.places]

    def holds(self, tensors) -> bool:
        """Whether `tensors` are what `fresh` last returned, none written
        since (the views of one flat share a version counter): then the
        static state holds them already."""
        last = self.last
        return last is not None and len(last[0]) == len(tensors) and all(
            a is b for a, b in zip(last[0], tensors)) and all(
            t._version == v for t, v in zip(tensors, last[1]))

    def load(self, tensors) -> None:
        """Make the static state hold `tensors`."""
        if not self.holds(tensors):
            self.last = None
            torch._foreach_copy_(self.views, list(tensors))

    def fresh(self) -> List[torch.Tensor]:
        """A copy of the static state, leaf for leaf (one clone a dtype,
        the leaves views of it)."""
        out = self._split({dt: f.clone() for dt, f in self.flats.items()})
        self.last = (out, [t._version for t in out])
        return out


class _Graph:
    """One captured step: the graph, its payload inputs, the static state
    it reads and writes, its outputs, the generators registered with it,
    the launches it counted and the workspace it holds."""

    __slots__ = ("graph", "inputs", "static", "outputs", "packed", "keys",
                 "generators", "launches", "workspace")


class GraphedStep:
    """`fn(state, payload)` replayed as CUDA graphs on `device` (see the
    module docstring)."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, object] = {}
        self.states: Dict[tuple, StaticState] = {}
        # the static state of the last replay, and the builder of the
        # state tree it returned
        self.last: Tuple[Optional[StaticState], Optional[Callable]] = (
            None, None)

    def __call__(self, state, payload):
        leaves = tree_leaves(state)
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        p_leaves = payload_leaves(payload)
        # the state the last replay returned (built by `build`) needs no
        # signature, no copy and no new builder
        static, build = self.last
        held = static is not None and static.holds(tensors)
        key = (signature(p_leaves), static.sig if held else signature(leaves))
        entry = self.graphs.get(key, _NEW)
        if entry is _NEW:
            self.graphs[key] = None
            return self._warmup(state, payload)
        with block_spmm._on(self.device):
            if entry is None:
                entry = self.graphs[key] = self._capture(key, leaves, state,
                                                         tensors, payload)
            return self._replay(entry, leaves, tensors, p_leaves,
                                build if held else tree_builder(state), held)

    def _warmup(self, state, payload):
        """The step run eagerly on the capture stream. The streams wait
        on each other both ways, so a tensor freed on either stream is
        rewritten only after the other's work on it."""
        with block_spmm._on(self.device):
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                out = self.fn(state, payload)
            current.wait_stream(self.stream)
        return out

    def _capture(self, key, leaves, state, tensors, payload) -> _Graph:
        with trace.span("step.capture") as sp:
            g = _Graph()
            static = self.states.get(key[1])
            if static is None:
                static = self.states[key[1]] = StaticState(
                    key[1], tensors, self.device)
            g.static = static
            g.generators = [t for t in leaves
                            if isinstance(t, torch.Generator)]
            g.inputs = [torch.empty_like(t, device=self.device)
                        for t in payload_leaves(payload)
                        if isinstance(t, torch.Tensor)]
            it = iter(static.views)
            static_state = tree_unflatten(state, [
                next(it) if isinstance(t, torch.Tensor) else t
                for t in leaves])
            static_payload = _with_tensors(payload, g.inputs)
            g.graph = torch.cuda.CUDAGraph()
            for gen in g.generators:
                g.graph.register_generator_state(gen)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            before = block_spmm.launch_counts()
            with torch.cuda.stream(self.stream), \
                    block_spmm.graph_workspace() as workspace:
                g.graph.capture_begin(pool=self.pool,
                                      capture_error_mode="thread_local")
                try:
                    new_state, loss, aux = self.fn(static_state,
                                                   static_payload)
                    new = [t for t in tree_leaves(new_state)
                           if isinstance(t, torch.Tensor)]
                    if signature(new) != signature(static.views):
                        raise ValueError(
                            "the step returned a state of another layout "
                            "than it was given; a captured step writes "
                            "its new state over the old")
                    torch._foreach_copy_(static.views, new)
                    g.keys = sorted(aux)
                    outs = [loss] + [aux[k] for k in g.keys]
                    g.packed = (len({(t.dtype, t.dim()) for t in outs}) == 1
                                and outs[0].dim() == 0)
                    g.outputs = torch.stack(outs) if g.packed else outs
                except BaseException:
                    with contextlib.suppress(Exception):
                        g.graph.capture_end()
                    raise
                g.graph.capture_end()
            g.workspace = workspace
            after = block_spmm.launch_counts()
            g.launches = tuple(a - b for a, b in zip(after, before))
            block_spmm.add_launches(tuple(-n for n in g.launches))
            if sp:
                sp.count("step.graph_captures")
        return g

    def _replay(self, g: _Graph, leaves, tensors, p_leaves, build, held):
        with trace.span("step.replay") as sp:
            if not held:
                g.static.load(tensors)
            torch._foreach_copy_(g.inputs, [t for t in p_leaves
                                            if isinstance(t, torch.Tensor)])
            # (isinstance against torch.Generator is slow: tensors first)
            given = [t for t in leaves if not isinstance(t, torch.Tensor)
                     and isinstance(t, torch.Generator)]
            moved = [(ours, theirs) for ours, theirs in
                     zip(g.generators, given) if ours is not theirs]
            for ours, theirs in moved:
                ours.set_state(theirs.get_state())
            g.graph.replay()
            for ours, theirs in moved:
                theirs.set_state(ours.get_state())
            block_spmm.add_launches(g.launches)
            self.last = (g.static, build)
            it = iter(g.static.fresh())
            new_state = build(iter([next(it) if isinstance(t, torch.Tensor)
                                    else t for t in leaves]))
            outs = (g.outputs.clone().unbind() if g.packed
                    else [t.clone() for t in g.outputs])
            if sp:
                sp.count("step.graph_replays")
        return new_state, outs[0], dict(zip(g.keys, outs[1:]))
