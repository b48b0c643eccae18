"""Spans and counters of the port's training path, kept in memory, on
the clock `torch.profiler` traces on.

    with trace.span("batch.tiles") as sp:
        adj = build_tiles(...)
        if sp:
            sp.count("batch.tile_slots", slots)

A span records its name, `time.perf_counter_ns()` at entry and exit,
the native thread id, the span that was open on that thread when it
began (its parent) and the step identifier `(epoch, step_in_epoch)` of
the batch its work serves. A span given `step=` sets that identifier
for itself and for what follows on its thread; one without takes its
parent's, else the last one its thread set, so a build on a prefetch
thread and the copy after it carry the step that will consume them.
`count(name, value)` adds to a counter on the innermost open span of
the calling thread.

Tracing is on while any of these holds: `REPRO_TORCH_TRACE=1` was set
when this module was imported, `enable()` was called (until
`disable()`), or a `torch.profiler` session is recording. While a
profiler records, every span also opens `record_function(name)`, so
it shows as a range in the profiler's trace, on the device events'
clock. A span open when the profiler stops is dropped: the profiler
drops its range too.

Off, `span` returns one shared null context after one flag test: no
allocation, no clock read, no counter. `setup_span` spans (the
one-shot `setup.*` stages) are kept either way, in a buffer of their
own. Both buffers are bounded (oldest dropped first) and read through
`spans()`, `summary()` and `reset()`; nothing is written to a file.
docs/tracing.md lists every span and counter of the port.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 18      # per-step spans kept (14 a training step)
MAX_SETUP_SPANS = 1 << 12

_INHERIT = object()
_clock = time.perf_counter_ns


class _Null:
    """The context `span` returns while tracing is off (its exit takes
    no *args, so it allocates nothing)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL = _Null()


class _Local(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []
        self.step = None
        self.tid = threading.get_native_id()


class Span:
    """One timed piece of work; a context manager that records itself
    on exit. Read its fields after exit; `seconds` is its duration."""

    __slots__ = ("name", "step", "keep", "id", "parent", "tid", "t0", "t1",
                 "counters", "_rf")

    def __init__(self, name: str, step=_INHERIT, keep: bool = False):
        self.name = name
        self.step = step
        self.keep = keep
        self.counters: Optional[Dict[str, float]] = None
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def count(self, name: str, value: float = 1) -> None:
        c = self.counters
        if c is None:
            self.counters = {name: value}
        else:
            c[name] = c.get(name, 0) + value

    def __enter__(self) -> "Span":
        loc = _local
        stack = loc.stack
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.step is _INHERIT:
            self.step = loc.step if parent is None else parent.step
        else:
            loc.step = self.step
        self.tid = loc.tid
        self.id = next(_ids)
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = _clock()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(None, None, None)
            if not (self.keep or _enabled
                    or _profiler._is_profiler_enabled):
                return False         # open across the profiler's stop
        (_setup if self.keep else _spans).append(self)
        return False


class Timer:
    """A span site whose own code needs its duration: it reads its clock
    pair whenever `timed` is set, and records the span only while
    tracing is on (one clock pair either way). `ns` is the last
    duration (0 when untimed), `span` the span last recorded (None when
    tracing was off). One per site, not re-entrant."""

    __slots__ = ("name", "timed", "ns", "span", "_t0")

    def __init__(self, name: str, timed: bool = True):
        self.name, self.timed, self.ns = name, timed, 0
        self.span: Optional[Span] = None
        self._t0 = 0

    def __enter__(self) -> "Timer":
        if _enabled or _profiler._is_profiler_enabled:
            self.span = Span(self.name).__enter__()
        else:
            self.span = None
            if self.timed:
                self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        sp = self.span
        if sp is not None:
            sp.__exit__(*exc)
            self.ns = sp.t1 - sp.t0
        elif self.timed:
            self.ns = _clock() - self._t0
        else:
            self.ns = 0
        return False


_local = _Local()
_ids = itertools.count(1)
_enabled = os.environ.get("REPRO_TORCH_TRACE", "") not in ("", "0")
_spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_setup: "collections.deque[Span]" = collections.deque(maxlen=MAX_SETUP_SPANS)


def on() -> bool:
    """Whether spans are being recorded now."""
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording (a profiler session still turns it on)."""
    global _enabled
    _enabled = False


def span(name: str, *, step=_INHERIT):
    """A span named `name` while tracing is on, else a null context
    (whose `as` target is None). `step` sets the step identifier."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, step)


def step_span(name: str, epoch: int, step_in_epoch: int):
    """`span(name, step=(epoch, step_in_epoch))`, whose pair is only
    made while tracing is on."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, (epoch, step_in_epoch))


def setup_span(name: str, *, step=_INHERIT) -> Span:
    """A one-shot set-up span, recorded whether or not tracing is on."""
    return Span(name, step, keep=True)


def count(name: str, value: float = 1) -> None:
    """Add `value` to counter `name` of the calling thread's innermost
    open span; nothing when no span is open."""
    stack = _local.stack
    if stack:
        stack[-1].count(name, value)


def spans(since_ns: Optional[int] = None) -> List[Span]:
    """Every recorded span, set-up spans included, in order of start;
    with `since_ns`, those that started at or after it."""
    if since_ns is None:
        out = list(_setup) + list(_spans)
    else:
        out = [s for s in _setup if s.t0 >= since_ns]
        for s in reversed(_spans):        # exit order: stop at the first
            if s.t1 < since_ns:           # span that ended before it
                break
            if s.t0 >= since_ns:
                out.append(s)
    out.sort(key=lambda s: (s.t0, s.id))
    return out


def reset() -> None:
    """Forget every recorded span."""
    _spans.clear()
    _setup.clear()


def summary(recorded: Optional[Iterable[Span]] = None) -> Dict:
    """{"spans": {name: {"count", "total_ms", "self_ms"}}, "counters":
    {name: total}} over `recorded` (default: every span). A span's self
    time is its duration less its children's (spans opened inside it
    on its thread)."""
    recorded = spans() if recorded is None else list(recorded)
    child_ns: Dict[int, int] = {}
    for s in recorded:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.t1 - s.t0
    names: Dict[str, Dict[str, float]] = {}
    counters: Dict[str, float] = {}
    for s in recorded:
        d = s.t1 - s.t0
        row = names.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                        "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += d / 1e6
        row["self_ms"] += (d - child_ns.get(s.id, 0)) / 1e6
        for k, v in (s.counters or {}).items():
            counters[k] = counters.get(k, 0) + v
    return {"spans": names, "counters": counters}
