"""Deterministic, host-sharded token pipeline with background prefetch —
a copy of `repro.data.tokens` (numpy only, so the port keeps its own).

Restart-stable by construction: batch contents are a pure function of
(seed, step, shard_id, num_shards) — an elastic re-shard (different
num_shards) resumes at the same global step without replaying or
skipping data (see runtime/resilience.ElasticPlan).

The synthetic corpus is a fixed random Markov chain over the vocab —
REAL learnable structure (unlike iid tokens), so example training runs
show a genuinely decreasing loss.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch_size: int           # per-host batch
    seq_len: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    order: int = 512          # Markov states (vocab folded into states)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = min(self.order, self.vocab_size)
        # sparse-ish row-stochastic transition structure: each state
        # prefers ~8 successors (gives ~2.1 nats achievable CE)
        self._succ = rng.integers(0, self.vocab_size, size=(s, 8))
        self._state_of = lambda t: t % s

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, shard)."""
        rng = np.random.default_rng(
            (self.seed, step, self.shard_id, self.num_shards))
        b, l = self.batch_size, self.seq_len
        toks = np.empty((b, l), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choices = rng.integers(0, 8, size=(b, l))
        noise = rng.random((b, l)) < 0.05        # 5% unigram noise
        rand_toks = rng.integers(0, self.vocab_size, size=(b, l))
        for t in range(1, l):                    # numpy column loop, fast
            nxt = self._succ[self._state_of(toks[:, t - 1]), choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_toks[:, t], nxt)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for x in self._it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x
