"""Reading a torch.profiler trace of a training window: device busy time
as the union of kernel, copy and memset intervals, time by kernel, the
block-ELL products' calls picked out of the stream by kernel name, and
the device's idle gaps labelled by what the host was doing.

The device events are summed straight from the trace's raw events (as
`chip_smoke.py` `_device_events_ms` does): `key_averages()` builds a
Python object per event and has come back without a trace's device
events.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

# kernels of the block-ELL libraries (kernels/csrc/block_tile.cuh): the
# fused product launches xw_kernel then spmm_kernel, each optionally
# followed by reduce_splits; the plain product spmm_kernel alone
XW, SPMM, REDUCE = "xw_kernel", "spmm_kernel", "reduce_splits"


def device_events(prof) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of every kernel, copy and memset on the
    device, in start order; user annotations are left out."""
    from torch.autograd import DeviceType
    out = []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        name = evt.name()
        user = getattr(evt, "is_user_annotation", None)
        if name.startswith("bench.") or (user is not None and user()):
            continue
        start = evt.start_ns()
        out.append((start, start + evt.duration_ns(), name))
    out.sort()
    return out


def host_events(prof, name: str) -> List[Tuple[int, int]]:
    """(start ns, end ns) of the host events called `name`."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU and e.name() == name)


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def by_name(events) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for a, b, name in events:
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def block_ell_calls(events) -> Tuple[List[float], List[float]]:
    """Device seconds of each fused call (xw_kernel [reduce] spmm_kernel
    [reduce]) and each plain call (spmm_kernel [reduce]), in stream
    order. Copies and memsets that other threads put on the stream
    between one call's kernels are stepped over."""
    kernels = [e for e in events
               if not e[2].startswith(("Memcpy", "Memset"))]
    fused, plain = [], []
    i, n = 0, len(kernels)

    def take(j, part):
        t = 0.0
        while j < n and part in kernels[j][2]:
            t += (kernels[j][1] - kernels[j][0]) / 1e9
            j += 1
            if part != REDUCE:
                break
        return j, t

    while i < n:
        name = kernels[i][2]
        if XW in name:
            i, t = take(i, XW)
            i, r = take(i, REDUCE)
            i, s = take(i, SPMM)
            i, r2 = take(i, REDUCE)
            fused.append(t + r + s + r2)
        elif SPMM in name:
            i, s = take(i, SPMM)
            i, r = take(i, REDUCE)
            plain.append(s + r)
        else:
            i += 1
    return fused, plain


def _inside(spans: Sequence[Tuple[int, int]], starts: List[int], t: int) -> bool:
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and spans[j][0] <= t < spans[j][1]


def idle_gaps(busy: Sequence[Tuple[int, int]], t0: int, t1: int,
              host: Dict[str, Sequence[Tuple[int, int]]],
              epoch_ends: Sequence[Tuple[int, int]]
              ) -> List[Tuple[str, float, Dict[str, float]]]:
    """Each interval of [t0, t1] in which the device ran nothing, split
    at the host's spans, each piece named by what the host was doing:
    "step dispatch" (the main thread inside a step), "epoch end"
    (between an epoch's last step and the next one's first), "copy" or
    "batch build" (a copy or a build on either thread), else "loop or
    prefetch wait" (the Engine's own code between them, or its wait on
    the prefetch queue). `host` holds the spans "step", "copy" and
    "build" in the trace's clock. Returns (the label with most of the
    gap, the gap's seconds, seconds by label) for each gap."""
    gaps, prev = [], t0
    for a, b in list(busy) + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, min(a, t1)))
        prev = max(prev, b)
    order = (("step dispatch", sorted(host["step"])),
             ("epoch end", sorted(epoch_ends)),
             ("copy", sorted(host["copy"])),
             ("batch build", sorted(host["build"])))
    starts = [[s for s, _ in spans] for _, spans in order]
    edges = sorted({t for _, spans in order for span in spans for t in span})
    out = []
    for a, b in gaps:
        if b <= a:
            continue
        lo, hi = bisect.bisect_right(edges, a), bisect.bisect_left(edges, b)
        points = [a] + edges[lo:hi] + [b]
        pieces: Dict[str, float] = {}
        for p, q in zip(points, points[1:]):
            mid = (p + q) // 2
            label = next((name for (name, spans), st in zip(order, starts)
                          if _inside(spans, st, mid)), "loop or prefetch wait")
            pieces[label] = pieces.get(label, 0.0) + (q - p) / 1e9
        out.append((max(pieces, key=pieces.get), (b - a) / 1e9, pieces))
    return out


def clock_offset(ours: Sequence[int], theirs: Sequence[int]) -> Optional[int]:
    """Median of (trace clock - our clock) over paired instants."""
    diffs = sorted(b - a for a, b in zip(ours, theirs))
    return diffs[len(diffs) // 2] if diffs else None
