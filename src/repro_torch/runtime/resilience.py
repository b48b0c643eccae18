"""Runtime resilience: preemption handling, straggler detection,
heartbeats and the elastic restart plan — a host copy of
`repro.runtime.resilience`.

At 1000+ nodes the failure model is: (a) SIGTERM preemptions with a
grace window, (b) silent node loss (heartbeat timeout), (c) stragglers
(slow-but-alive hosts degrading the synchronous step). The pieces here
are host-side and framework-agnostic; the Engine (core/engine.py) and
prefetch (core/prefetch.py) wire them to the training loop.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import threading
import time
from typing import Callable, Deque, Dict, List, Optional


# ----------------------------------------------------------------------
# preemption: translate SIGTERM/SIGINT into a checkpoint-and-exit flag
# ----------------------------------------------------------------------
class PreemptionHandler:
    """`with PreemptionHandler() as p:` — loop checks p.should_stop each
    step; on SIGTERM the current step finishes, a final checkpoint is
    written, and the job exits 0 so the scheduler restarts it cleanly.

    This is THE signal→flag implementation: `core.engine.PreemptionHook`
    is a thin adapter that wires one of these into the Engine's hook
    seam (installed for the duration of fit() only) — there is no
    second signal handler anywhere in the repo."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._old = {}
        self.should_stop = False
        self.signal_time: Optional[float] = None

    def __enter__(self):
        for s in self._signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:      # non-main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        self.should_stop = True
        self.signal_time = time.time()

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


# ----------------------------------------------------------------------
# straggler detection: EWMA of step times with outlier flagging
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StragglerDetector:
    """Tracks per-host step times (from an allgathered timing vector at
    real scale; locally from host 0's wall clock) and flags hosts whose
    EWMA exceeds `threshold` × the fleet median.

    Mitigation hooks: report() feeds the scheduler (to drain the host).

    Single-host runs use `flag_step` instead: with one host, `record`
    compares the host's EWMA against the median of itself and can never
    flag, so per-STEP wall times are compared against their own
    trailing median — the Engine feeds every step's duration in and
    counts flagged steps per epoch into the history rows
    (`flagged_steps`), which is how a degrading disk or a noisy
    neighbor shows up in metrics.json before it kills throughput."""
    alpha: float = 0.2
    threshold: float = 1.5
    window: int = 64
    warmup: int = 8

    def __post_init__(self):
        self._ewma: Dict[int, float] = {}
        self._hist: Deque = collections.deque(maxlen=self.window)
        self._step_hist: Deque = collections.deque(maxlen=self.window)

    def flag_step(self, seconds: float) -> bool:
        """Single-host per-step variant of record(): True when this
        step took more than `threshold` × the trailing median of the
        last `window` steps (after `warmup` steps have been seen —
        jit compilation makes the first steps pathological)."""
        hist = self._step_hist
        flagged = bool(
            len(hist) >= self.warmup
            and seconds > self.threshold * sorted(hist)[len(hist) // 2])
        hist.append(seconds)
        return flagged

    def record(self, host_times: Dict[int, float]) -> List[int]:
        """host -> step seconds. Returns hosts currently flagged."""
        for h, t in host_times.items():
            prev = self._ewma.get(h, t)
            self._ewma[h] = (1 - self.alpha) * prev + self.alpha * t
        self._hist.append(dict(host_times))
        if not self._ewma:
            return []
        med = sorted(self._ewma.values())[len(self._ewma) // 2]
        return [h for h, v in self._ewma.items()
                if v > self.threshold * med and len(self._hist) >= 8]

    def fleet_summary(self) -> Dict[str, float]:
        if not self._ewma:
            return {}
        vals = sorted(self._ewma.values())
        return {"median_s": vals[len(vals) // 2], "max_s": vals[-1],
                "skew": vals[-1] / max(vals[len(vals) // 2], 1e-9)}


# ----------------------------------------------------------------------
# heartbeats: detect silent node loss
# ----------------------------------------------------------------------
class HeartbeatMonitor:
    """Hosts call beat(host_id) periodically (at real scale via a
    side-channel KV store); dead() lists hosts silent for > timeout."""

    def __init__(self, timeout_s: float = 60.0, clock: Callable = time.time):
        self.timeout = timeout_s
        self._clock = clock
        self._last: Dict[int, float] = {}
        self._lock = threading.Lock()

    def beat(self, host_id: int) -> None:
        with self._lock:
            self._last[host_id] = self._clock()

    def dead(self) -> List[int]:
        now = self._clock()
        with self._lock:
            return [h for h, t in self._last.items()
                    if now - t > self.timeout]


# ----------------------------------------------------------------------
# elastic restart protocol
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ElasticPlan:
    """Decision record for a restart with a different healthy-rank set
    — the multi-host seam; nothing in-process consumes it yet, as in
    the reference.

    Checkpoints store params and optimizer state unsharded with logical
    shapes (runtime/checkpoint.py), so a restart onto another world
    size restores them unchanged (the int-compression residuals are
    stacked per rank, one row per old rank); the batch stream is a pure
    function of (seed, epoch), so a re-shard never replays or skips
    batches beyond the current step."""
    old_devices: int
    new_devices: int
    new_mesh_shape: tuple
    batch_adjustment: str   # 'keep_global' (more grad accum) | 'scale_down'

    @staticmethod
    def plan(old_devices: int, healthy_devices: int,
             axis_order=("data",)) -> "ElasticPlan":
        # shrink to the largest power-of-two device count that is
        # <= healthy (keeps mesh factorizations valid)
        new = 1
        while new * 2 <= healthy_devices:
            new *= 2
        return ElasticPlan(old_devices=old_devices, new_devices=new,
                           new_mesh_shape=(new,),
                           batch_adjustment="keep_global")

    def microbatch_multiplier(self) -> int:
        """keep_global: global batch is preserved by scaling gradient
        accumulation by old/new."""
        return max(1, self.old_devices // self.new_devices)
