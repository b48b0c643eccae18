"""Deterministic fault injection: the chaos-testing seam of the runtime —
a host copy of `repro.runtime.faults` (the port imports nothing of the
reference).

The repo advertises kill-anywhere bitwise-exact resume, hardened
downloads and self-healing prefetch — claims that are only worth
anything if they survive *injected* failures. This module provides the
one switchboard every hardened subsystem consults:

  * `FaultPlan` — a JSON-round-trippable description of WHICH named
    faults fire WHERE (spec-wired as `run.faults`; tests build it
    directly). Firing is deterministic per (plan seed, site,
    occurrence index): the same plan replays the same failures.
  * `maybe_fail(site)` — the injection-site helper threaded through
    graph/datasets.py, runtime/checkpoint.py, core/prefetch.py and
    core/engine.py. With no plan installed it is a single
    global-is-None check.
  * `install` / `fault_scope` — process-global activation. The Engine
    scopes its plan around fit(); build_experiment scopes dataset
    materialization so download faults fire too.

Sites and what the hardened code does when they fire:

  site                             injected failure        survival path
  -------------------------------  ----------------------  -------------
  download.error                   URLError before read    retry+backoff
  download.partial                 truncated stream        retry+cleanup
  checkpoint.crash_before_rename   die before atomic       tmp-dir sweep
                                   publish (tmp leaks)     on next init
  checkpoint.corrupt_latest        bit-flip the written    quarantine +
                                   shard                   fall back
  prefetch.producer_crash          producer dies silently  PrefetchError
                                   (no _DONE/_ERR)         or rebuild
  prefetch.producer_hang           producer goes silent    PrefetchError
                                   while alive             (heartbeat)
  step.nonfinite_loss              batch features poisoned divergence
                                   (nan by default)        guards
  sigterm.at_step                  SIGTERM after step k    PreemptionHook
                                   completes               checkpoint

Faults only simulate failures that real infrastructure produces;
nothing here is reachable unless a plan is explicitly installed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Any, Dict, Optional, Tuple

FAULT_SITES = (
    "download.error",
    "download.partial",
    "checkpoint.crash_before_rename",
    "checkpoint.corrupt_latest",
    "prefetch.producer_crash",
    "prefetch.producer_hang",
    "step.nonfinite_loss",
    "sigterm.at_step",
)


class InjectedFault(RuntimeError):
    """Raised (or used as the cause) by an injection site that simulates
    a hard failure. Carries the site so recovery paths and tests can
    tell injected failures from real ones."""

    def __init__(self, site: str, occurrence: Optional[int] = None):
        self.site = site
        self.occurrence = occurrence
        at = "" if occurrence is None else f" (occurrence {occurrence})"
        super().__init__(f"injected fault at {site}{at}")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """When one site fires. `at` fires on exactly those occurrence
    indices (0-based count of times the site is reached in this
    process; for sigterm.at_step the Engine passes the global step so
    `at` addresses steps even across resumes). `times` fires on the
    first N occurrences. Both unset → every occurrence. `prob` < 1
    thins the matched occurrences deterministically via a hash of
    (plan seed, site, occurrence). `value` is a payload for
    value-carrying faults (step.nonfinite_loss poisons features with
    it; None → nan)."""
    at: Optional[Tuple[int, ...]] = None
    times: Optional[int] = None
    prob: float = 1.0
    value: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.at is not None:
            d["at"] = list(self.at)
        if self.times is not None:
            d["times"] = self.times
        if self.prob != 1.0:
            d["prob"] = self.prob
        if self.value is not None:
            d["value"] = self.value
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FaultRule":
        known = {"at", "times", "prob", "value"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultRule field(s) "
                             f"{sorted(unknown)} (known: {sorted(known)})")
        at = d.get("at")
        return FaultRule(
            at=tuple(int(i) for i in at) if at is not None else None,
            times=None if d.get("times") is None else int(d["times"]),
            prob=float(d.get("prob", 1.0)),
            value=None if d.get("value") is None else float(d["value"]))


def _hash_unit(seed: int, site: str, occurrence: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, site, occurrence)."""
    h = hashlib.blake2b(f"{seed}:{site}:{occurrence}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


@dataclasses.dataclass
class FaultPlan:
    """Which faults fire, deterministically. Occurrence counters live on
    the instance (thread-safe), so a plan replays the same decisions
    only from a fresh instance — chaos tests build one per run."""
    rules: Dict[str, FaultRule] = dataclasses.field(default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        unknown = set(self.rules) - set(FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault site(s) {sorted(unknown)}; "
                             f"known: {list(FAULT_SITES)}")
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- JSON round trip (run.faults) -----------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "rules": {s: r.to_dict() for s, r in self.rules.items()}}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FaultPlan":
        known = {"seed", "rules"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultPlan field(s) "
                             f"{sorted(unknown)} (known: {sorted(known)})")
        rules = {site: FaultRule.from_dict(r)
                 for site, r in (d.get("rules") or {}).items()}
        return FaultPlan(rules=rules, seed=int(d.get("seed", 0)))

    # -- firing decision ------------------------------------------------
    def fires(self, site: str,
              index: Optional[int] = None) -> Optional[FaultRule]:
        """The rule for `site` if it fires at this occurrence (or at the
        explicit `index`), else None. Reaching a site without a rule
        does not advance its counter, so adding a rule for one site
        never shifts another's occurrence indices."""
        rule = self.rules.get(site)
        if rule is None:
            return None
        if index is None:
            with self._lock:
                index = self._counts.get(site, 0)
                self._counts[site] = index + 1
        if rule.at is not None:
            hit = index in rule.at
        elif rule.times is not None:
            hit = index < rule.times
        else:
            hit = True
        if hit and rule.prob < 1.0:
            hit = _hash_unit(self.seed, site, index) < rule.prob
        return rule if hit else None


# ----------------------------------------------------------------------
# process-global activation
# ----------------------------------------------------------------------
_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Activate `plan` process-wide (None deactivates)."""
    global _ACTIVE
    _ACTIVE = plan


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def fault_scope(plan: Optional[FaultPlan]):
    """Activate `plan` for the duration of the with-block, restoring the
    previous plan (usually None) on exit."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def maybe_fail(site: str,
               index: Optional[int] = None) -> Optional[FaultRule]:
    """THE injection-site call. Returns the firing rule (truthy) or
    None. With no plan installed — every production run — this is one
    global load and a None check; the zero-cost guarantee the chaos
    tests lock bitwise."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fires(site, index)


# ----------------------------------------------------------------------
# payload poisoning (step.nonfinite_loss)
# ----------------------------------------------------------------------
def poison_batch(batch_tuple, rule: FaultRule):
    """A copy of a device payload (dense or block-ELL) with the feature
    leaf filled with rule.value (nan by default). The poison flows
    through the REAL forward/backward math — loss and gradients go
    non-finite the way a genuine numeric blow-up would, exercising the
    scaled-policy skip and the Engine's divergence guards rather than
    bypassing them."""
    import torch
    value = float("nan") if rule.value is None else float(rule.value)
    bt = list(batch_tuple)
    bt[1] = torch.full_like(torch.as_tensor(bt[1]), value)
    return tuple(bt)


def wrap_step_faults(step_fn, batch_argnum: int = -1):
    """Wrap a train step so step.nonfinite_loss poisons the
    batch argument before the call. One maybe_fail per step; with no
    plan installed the wrapper is a transparent passthrough."""
    def wrapped(*args):
        rule = maybe_fail("step.nonfinite_loss")
        if rule is None:
            return step_fn(*args)
        args = list(args)
        args[batch_argnum] = poison_batch(args[batch_argnum], rule)
        return step_fn(*args)
    wrapped.__wrapped__ = step_fn     # the step itself, unwrapped
    return wrapped
