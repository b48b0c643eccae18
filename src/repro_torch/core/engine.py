"""Step-driven training engine: ONE epoch loop over a StepBackend — the
port of `repro.core.engine`.

* `StepBackend` — the protocol one training step implements.
  `SingleDeviceBackend` runs the per-batch step on one device (a CUDA
  GPU, or the CPU when asked). The reference's data-parallel
  `ShardMapBackend` is a later slice of the port.
* Hooks — objects with any of `on_fit_start/on_step/on_epoch/on_eval/
  on_fit_end`, fired by the Engine: periodic eval (EvalHook), checkpoint
  cadence (CheckpointHook), metric logging (LoggingHook), preemption-
  triggered save (PreemptionHook: SIGTERM → checkpoint → clean exit) and
  a deterministic stop (StopAtStepHook).
* Resume — `Engine.fit(resume=True)` restores the latest checkpoint
  (params/optimizer/RNG state + JSON metadata carrying epoch,
  step-in-epoch, partial-epoch loss/aux accumulators and history) and
  fast-forwards the batch stream, so a stopped run continues on the
  exact trajectory of an unstopped one — mid-epoch included.

The step keeps everything on the device: loss and aux are 0-d tensors,
the optimizer and the loss-scale skip never read a value back. The host
reads losses once per epoch (the epoch record), and per step only when
a divergence guard is configured.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import math
import signal as _signal
import time
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Protocol,
                    Sequence, Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.core.batching import Sampler, batch_to_device
from repro_torch.core.gcn import GCNConfig, gcn_loss, init_params, micro_f1
from repro_torch.core.precision import (all_finite, init_scale_state,
                                        policy_from_config, scale_loss,
                                        select_tree, unscale_grads,
                                        update_scale_state)
from repro_torch.core.prefetch import prefetch_iter
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import spmm as spmm_dispatch
from repro_torch.kernels.ops import spmm_xw as spmm_xw_dispatch
from repro_torch.nn.optim import Optimizer, apply_updates
from repro_torch.nn.tree import Tree, tree_leaves, tree_map
from repro_torch.runtime import faults
from repro_torch.runtime.resilience import StragglerDetector

# deepest depth execution.prefetch="auto" will ever pick (it also bounds
# the tile-pool aliasing check for auto runs)
AUTO_PREFETCH_MAX = 4

# fit() must NOT clear an externally-installed fault plan when the
# engine itself has none, so the no-plan path enters a null context
_NULL_CTX = contextlib.nullcontext()


@dataclasses.dataclass
class TrainResult:
    history: List[Dict[str, float]]
    params: Any
    seconds: float


def _loss_and_grads(params, batch, cfg, generator, spmm, spmm_xw,
                    scale=None):
    """(loss, aux, grads) of one batch; grads of loss·scale when scaled."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = gcn_loss(live, batch, cfg, train=True, generator=generator,
                         spmm=spmm, spmm_xw=spmm_xw)
    target = loss if scale is None else scale_loss(loss, scale)
    grads = iter(torch.autograd.grad(target, tree_leaves(live)))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_map(lambda _: next(grads), live))


def make_train_step(cfg: GCNConfig, opt: Optimizer,
                    spmm: Callable = spmm_dispatch,
                    spmm_xw: Callable = spmm_xw_dispatch):
    """The per-batch training step — `repro.core.engine.make_train_step`.
    With cfg.loss_scaling == "none" it takes (params, opt_state, rng,
    batch) and returns (params, opt_state, rng, loss, aux). A scaled
    policy returns a 5-arg step (params, opt_state, rng, scale_state,
    batch): the gradient of loss·scale is unscaled in fp32, and a
    non-finite gradient keeps params and optimizer state (a device-side
    select) while dynamic scaling backs the scale off. `rng` is the
    dropout `torch.Generator`, advanced in place. Params are updated
    functionally: the step returns new tensors."""
    pol = policy_from_config(cfg)
    if not pol.scaled:
        def step(params, opt_state, rng, batch):
            loss, aux, grads = _loss_and_grads(params, batch, cfg, rng,
                                               spmm, spmm_xw)
            with torch.no_grad():
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
            return params, opt_state, rng, loss, aux
        return faults.wrap_step_faults(step)

    def scaled_step(params, opt_state, rng, scale_state, batch):
        loss, aux, grads = _loss_and_grads(params, batch, cfg, rng, spmm,
                                           spmm_xw, scale_state["scale"])
        with torch.no_grad():
            grads = unscale_grads(grads, scale_state["scale"])
            finite = all_finite(grads)
            updates, new_opt = opt.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)
            params = select_tree(finite, new_params, params)
            opt_state = select_tree(finite, new_opt, opt_state)
            scale_state = update_scale_state(scale_state, finite, pol)
        return params, opt_state, rng, scale_state, loss, aux
    return faults.wrap_step_faults(scaled_step)


# ----------------------------------------------------------------------
# step backends
# ----------------------------------------------------------------------
@runtime_checkable
class StepBackend(Protocol):
    """One training step, including its RNG threading.

    * `init(params, rng)` → the backend's state: a tree that the
      CheckpointManager round-trips leaf for leaf and the ONLY mutable
      thing a step touches, so resume from a checkpoint is exact.
    * `stream(batches)` adapts the sampler's per-batch tuples into the
      payloads `step` consumes (lazy; the identity on one device).
    * `step(state, payload)` → (new_state, loss, aux).
    * `params(state)` extracts the current model parameters.
    * `device` — where the step runs; the Engine moves payloads there.
    """
    device: torch.device

    def init(self, params: Tree, rng: torch.Generator) -> Tree: ...

    def stream(self, batches: Iterator) -> Iterator: ...

    def step(self, state: Tree, payload) -> Tuple[Tree, Any, Dict]: ...

    def params(self, state: Tree) -> Tree: ...


class SingleDeviceBackend:
    """The per-batch step on one device: `device` defaults to "cuda"
    and raises without a GPU unless "cpu" is asked for."""

    # one raw sampler payload in flight per step (Engine's pool-depth
    # guard sizes tile-buffer lifetime off this)
    group_size = 1

    def __init__(self, cfg: GCNConfig, opt: Optimizer, device="cuda",
                 spmm: Callable = spmm_dispatch,
                 spmm_xw: Callable = spmm_xw_dispatch):
        self.device = resolve_device(device)
        self.opt = opt
        self._policy = policy_from_config(cfg)
        self._step = make_train_step(cfg, opt, spmm, spmm_xw)

    def init(self, params, rng):
        state = {"params": params, "opt": self.opt.init(params), "rng": rng}
        if self._policy.scaled:
            state["scale"] = init_scale_state(self._policy, self.device)
        return state

    def stream(self, batches):
        return batches

    def step(self, state, payload):
        if self._policy.scaled:
            params, opt_state, rng, scale, loss, aux = self._step(
                state["params"], state["opt"], state["rng"],
                state["scale"], payload)
            return {"params": params, "opt": opt_state, "rng": rng,
                    "scale": scale}, loss, aux
        params, opt_state, rng, loss, aux = self._step(
            state["params"], state["opt"], state["rng"], payload)
        return {"params": params, "opt": opt_state, "rng": rng}, loss, aux

    def params(self, state):
        return state["params"]


# ----------------------------------------------------------------------
# hooks
# ----------------------------------------------------------------------
_EVAL_SPLITS = ("auto", "train", "val", "test")


def resolve_eval_mask(graph, split: str,
                      warner: Optional[Callable[[str], None]] = None
                      ) -> Tuple[str, np.ndarray]:
    """Map an eval-split name to (resolved_name, mask). split="auto"
    keeps the historical behavior — val_mask unless it is missing/empty,
    then test_mask — but `warner` is called on that fallback so silent
    test-set evaluation during training is at least loud."""
    if split not in _EVAL_SPLITS:
        raise ValueError(f"eval_split must be one of {_EVAL_SPLITS}; "
                         f"got {split!r}")
    if split == "auto":
        if graph.val_mask is not None and graph.val_mask.any():
            return "val", graph.val_mask
        if warner is not None:
            warner("eval_split='auto' fell back to the TEST split "
                   "(val_mask is missing or empty) — validation scores "
                   "are test-set scores; set run.eval_split explicitly")
        return "test", graph.test_mask
    mask = getattr(graph, f"{split}_mask")
    if mask is None or not mask.any():
        raise ValueError(
            f"eval_split={split!r} but the graph's {split}_mask is "
            f"{'missing' if mask is None else 'empty'} — evaluating on "
            f"it would produce NaN scores; pick a split with nodes "
            f"(or 'auto' for the warn-on-fallback behavior)")
    return split, mask


class EvalHook:
    """Periodic full-graph evaluation (host oracle). Mutates the shared
    epoch record in place, so `val_score`/`eval_split` land in history
    and in any checkpoint metadata written by later hooks."""

    def __init__(self, eval_graph, cfg: GCNConfig, *, every: int,
                 split: str = "auto", norm: str = "eq10",
                 diag_lambda: float = 0.0):
        if split not in _EVAL_SPLITS:
            raise ValueError(f"eval_split must be one of {_EVAL_SPLITS}; "
                             f"got {split!r}")
        if split != "auto":
            resolve_eval_mask(eval_graph, split)   # fail at build time
        self.graph, self.cfg, self.every, self.split = \
            eval_graph, cfg, every, split
        self.norm, self.diag_lambda = norm, diag_lambda
        self._warned = False

    def _warn_once(self, msg: str):
        if not self._warned:
            self._warned = True
            warnings.warn(msg, stacklevel=4)

    def on_epoch(self, engine: "Engine", rec: Dict) -> None:
        if not self.every or (rec["epoch"] + 1) % self.every:
            return
        from repro_torch.core.trainer import evaluate
        split, mask = resolve_eval_mask(self.graph, self.split,
                                        self._warn_once)
        rec["val_score"] = evaluate(engine.backend.params(engine.state),
                                    self.graph, self.cfg, mask,
                                    self.norm, self.diag_lambda)
        rec["eval_split"] = split
        for h in engine.hooks:
            fn = getattr(h, "on_eval", None)
            if fn is not None:
                fn(engine, rec)


class CheckpointHook:
    """Epoch-cadence checkpointing through the engine's manager (async
    when the manager is; the preemption-path save is blocking)."""

    def __init__(self, every: int = 1):
        self.every = max(1, int(every))

    def on_epoch(self, engine: "Engine", rec: Dict) -> None:
        if (rec["epoch"] + 1) % self.every == 0:
            engine.save_checkpoint(blocking=False)

    def on_fit_end(self, engine: "Engine") -> None:
        if engine.checkpoint is not None:
            engine.checkpoint.wait()


class LoggingHook:
    """The per-epoch metric print."""

    def on_epoch(self, engine: "Engine", rec: Dict) -> None:
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in rec.items()})


class PreemptionHook:
    """SIGTERM/SIGINT → finish the in-flight step, blocking checkpoint,
    clean exit (Engine.fit returns the partial TrainResult and sets
    engine.preempted). Wraps runtime.resilience.PreemptionHandler —
    signal handlers are installed only for the duration of fit()."""

    def __init__(self, handler=None):
        if handler is None:
            from repro_torch.runtime.resilience import PreemptionHandler
            handler = PreemptionHandler()
        self.handler = handler

    def on_fit_start(self, engine: "Engine") -> None:
        self.handler.__enter__()

    def on_step(self, engine: "Engine", info: Dict) -> None:
        if self.handler.should_stop:
            engine.request_stop(reason="preempted")

    def on_fit_end(self, engine: "Engine") -> None:
        self.handler.__exit__(None, None, None)


class StopAtStepHook:
    """Request a clean stop (checkpoint + exit) once `global_step`
    reaches `stop_after` — a deterministic stand-in for a kill."""

    def __init__(self, stop_after: int):
        self.stop_after = int(stop_after)

    def on_step(self, engine: "Engine", info: Dict) -> None:
        if info["global_step"] >= self.stop_after:
            engine.request_stop(reason=f"stop_at_step {self.stop_after}")


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
class Engine:
    """ONE loop over `backend.step`, from cold start or checkpoint.

    fit(resume=True) restores the newest valid checkpoint in
    `checkpoint` (a runtime.CheckpointManager) and fast-forwards epoch /
    step-in-epoch / partial loss accumulators so the trajectory
    continues exactly where the saved run stopped; with no checkpoint on
    disk it warns and cold-starts.
    """

    def __init__(self, batcher: Sampler, cfg: GCNConfig,
                 backend: StepBackend, *, epochs: int, seed: int = 0,
                 prefetch: Union[int, str] = 0, hooks: Sequence = (),
                 checkpoint=None, fault_plan=None,
                 max_consecutive_skipped: Optional[int] = None,
                 divergence_factor: Optional[float] = None,
                 prefetch_timeout: float = 600.0):
        if cfg.precompute_ax and not getattr(batcher, "precompute_ax",
                                             False):
            raise ValueError(
                "cfg.precompute_ax=True but the sampler was built with "
                "precompute_ax=False: the model expects the payload's "
                "features to be pre-aggregated (A'X, paper §6.2) and "
                "layer 1 would silently skip propagation on raw "
                "features. Rebuild the sampler with precompute_ax=True "
                "(build_batcher does this automatically).")
        self.prefetch_auto = prefetch == "auto"
        self.prefetch = 0 if self.prefetch_auto else int(prefetch)
        self._auto_depth: Optional[int] = None
        self._auto_ratio: Optional[float] = None
        pool = getattr(batcher, "_tile_pool", None)
        if pool is not None:
            # TileBufferPool recycles a buffer after `depth` further
            # same-key requests; each batch makes 2 requests per ring key
            # (forward + transposed tiles), so the pool holds depth//2
            # live batches: the prefetch queue plus the in-flight and
            # just-built ones must fit
            depth_bound = (AUTO_PREFETCH_MAX if self.prefetch_auto
                           else self.prefetch)
            need = depth_bound + 2
            live = pool.depth // 2
            if live < need:
                raise ValueError(
                    f"tile-buffer pool depth {pool.depth} holds only "
                    f"{live} live batches but this run keeps {need} in "
                    f"flight (prefetch={depth_bound} queued + 2 in "
                    f"flight) — recycled buffers would alias live "
                    f"payloads and silently corrupt training. Deepen the "
                    f"pool (TileBufferPool(depth={2 * need}) on the "
                    f"sampler), lower execution.prefetch, or disable "
                    f"batch.reuse_tile_buffers.")
        self.batcher = batcher
        self.cfg = cfg
        self.backend = backend
        self.device = backend.device
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.hooks = list(hooks)
        self.checkpoint = checkpoint
        # fault injection + divergence guards, all default OFF
        self.fault_plan = fault_plan
        self.max_consecutive_skipped = (
            None if max_consecutive_skipped is None
            else int(max_consecutive_skipped))
        self.divergence_factor = (None if divergence_factor is None
                                  else float(divergence_factor))
        self._guards_on = (self.max_consecutive_skipped is not None
                           or self.divergence_factor is not None)
        self.prefetch_timeout = float(prefetch_timeout)
        self.diverged = False
        self.straggler = StragglerDetector()
        try:
            self._start_seam = "start_step" in inspect.signature(
                self.batcher.epoch).parameters
        except (TypeError, ValueError):
            self._start_seam = False
        self.state: Optional[Tree] = None
        self.history: List[Dict[str, float]] = []
        self.global_step = 0
        self.preempted = False
        self.stop_reason: Optional[str] = None
        self._stop = False
        self._skip_stop_checkpoint = False
        self._consec_nonfinite = 0
        self._finite_losses: List[float] = []
        # current resume point: (epoch, step_in_epoch, losses, auxes)
        self._position: Tuple[int, int, list, list] = (0, 0, [], [])

    # -- state ----------------------------------------------------------
    def init_state(self) -> Tree:
        """Seeded params (a CPU generator, so every device starts from the
        same values) and the dropout generator on the step's device."""
        params = init_params(self.cfg,
                             generator=torch.Generator().manual_seed(
                                 self.seed),
                             device=self.device)
        rng = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        return self.backend.init(params, rng)

    def request_stop(self, reason: str = "requested") -> None:
        if not self._stop:
            self._stop = True
            self.stop_reason = reason

    # -- checkpointing --------------------------------------------------
    def save_checkpoint(self, blocking: bool = True) -> None:
        """Persist state + loop position. Loss/aux accumulators go to the
        metadata as host floats (exact for fp32 values)."""
        if self.checkpoint is None or self.state is None:
            return
        epoch, step_in_epoch, losses, auxes = self._position
        meta = {
            "epoch": epoch, "step_in_epoch": step_in_epoch,
            "global_step": self.global_step,
            "losses": [float(l) for l in losses],
            "auxes": [{k: float(v) for k, v in a.items()} for a in auxes],
            "history": [dict(h) for h in self.history],
        }
        self.checkpoint.save(self.global_step, self.state,
                             blocking=blocking, metadata=meta)

    def _try_restore(self) -> bool:
        if self.checkpoint is None:
            return False
        step = self.checkpoint.latest_valid_step()
        if step is None:
            return False
        template = self.init_state()
        self.state = self.checkpoint.restore(template, step=step,
                                             device=self.device)
        meta = self.checkpoint.read_metadata(step)
        if "history" not in meta:
            raise ValueError(
                f"checkpoint step {step} in {self.checkpoint.directory} "
                f"carries no Engine resume metadata (it was saved by a "
                f"direct CheckpointManager.save, not Engine.fit) — "
                f"restore it manually or start without resume=True")
        self.history = list(meta["history"])
        self.global_step = int(meta["global_step"])
        self._position = (int(meta["epoch"]), int(meta["step_in_epoch"]),
                          list(meta["losses"]),
                          [dict(a) for a in meta["auxes"]])
        return True

    # -- divergence guards ----------------------------------------------
    _GUARD_WINDOW = 32          # trailing finite losses the median sees
    _GUARD_WARMUP = 8           # finite steps before the explosion guard arms

    def _params_finite(self) -> bool:
        return all(bool(torch.isfinite(leaf).all()) for leaf in
                   tree_leaves(self.backend.params(self.state)))

    def _check_divergence(self, loss) -> None:
        """Per-step guard, run only when a guard is configured (the
        float() here reads the loss back, a host sync the default path
        never pays)."""
        lf = float(loss)
        if not math.isfinite(lf):
            self._consec_nonfinite += 1
            lim = self.max_consecutive_skipped
            if lim is not None and self._consec_nonfinite >= lim:
                self._divergence_stop(
                    f"{self._consec_nonfinite} consecutive non-finite "
                    f"losses")
            return
        self._consec_nonfinite = 0
        fac = self.divergence_factor
        if fac is not None and len(self._finite_losses) >= \
                self._GUARD_WARMUP:
            w = self._finite_losses
            med = sorted(w)[len(w) // 2]
            if lf > fac * med:
                self._divergence_stop(
                    f"loss {lf:.6g} exceeded {fac:g}x the trailing "
                    f"median {med:.6g}", restore=True)
                return
        self._finite_losses.append(lf)
        if len(self._finite_losses) > self._GUARD_WINDOW:
            del self._finite_losses[0]

    def _divergence_stop(self, reason: str, restore: bool = False) -> None:
        """Abort cleanly: keep the current state when its params are
        finite, otherwise restore the newest valid checkpoint — and
        never persist a poisoned state."""
        self.diverged = True
        if restore or not self._params_finite():
            if self._try_restore():
                reason += ("; restored the last-good checkpoint "
                           f"(global step {self.global_step})")
            else:
                self._skip_stop_checkpoint = True
                reason += ("; no valid checkpoint to restore — final "
                           "state NOT saved")
                warnings.warn(
                    "divergence abort with no restorable checkpoint: "
                    "the returned params are the diverged ones "
                    "(configure run.checkpoint_dir to get rollback)",
                    stacklevel=3)
        self.request_stop(reason=f"divergence: {reason}")

    # -- hook plumbing --------------------------------------------------
    def _fire(self, name: str, *args) -> None:
        for h in self.hooks:
            fn = getattr(h, name, None)
            if fn is not None:
                fn(self, *args)

    # -- the loop -------------------------------------------------------
    def fit(self, resume: bool = False) -> TrainResult:
        """Run the training loop; returns TrainResult(history, params,
        seconds). resume=True restores the newest valid checkpoint and
        continues the exact trajectory of an unstopped run (the batch
        stream is a pure function of (sampler seed, epoch), so skipping
        the first `step_in_epoch` payloads reproduces the tail); with
        nothing to restore it warns and cold-starts. `fault_plan` is
        installed for the duration of fit."""
        with faults.fault_scope(self.fault_plan) \
                if self.fault_plan is not None else _NULL_CTX:
            return self._fit(resume)

    @staticmethod
    def _timed_iter(it: Iterator, acc: List[float]) -> Iterator:
        """Pass-through iterator accumulating time spent inside next(it)
        into acc[0] — host batch build during the auto-prefetch warmup."""
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            acc[0] += time.perf_counter() - t
            yield item

    @staticmethod
    def _auto_prefetch_depth(ratio: float) -> int:
        """host_build_over_step ratio → prefetch depth: synchronous below
        5%, else ~2x the ratio, capped at AUTO_PREFETCH_MAX."""
        if ratio < 0.05:
            return 0
        return max(1, min(AUTO_PREFETCH_MAX, int(np.ceil(2.0 * ratio))))

    def _fit(self, resume: bool) -> TrainResult:
        restored = resume and self._try_restore()
        if resume and not restored:
            warnings.warn(
                "resume=True but there is nothing to restore "
                + ("(no checkpoint manager configured)"
                   if self.checkpoint is None else
                   f"(no checkpoints in {self.checkpoint.directory})")
                + " — cold-starting from epoch 0", stacklevel=2)
        if not restored:
            self.state = self.init_state()
            self.history = []
            self.global_step = 0
            self._position = (0, 0, [], [])
        self._stop = False
        self.preempted = False
        self.diverged = False
        self.stop_reason = None
        self._skip_stop_checkpoint = False
        self._consec_nonfinite = 0
        self._finite_losses = []
        start_epoch, skip_steps, losses, auxes = self._position
        seam = self._start_seam
        if self.prefetch_auto:
            self._auto_depth = None
            self._auto_ratio = None
        t0 = time.perf_counter()
        fit_error: Optional[BaseException] = None
        try:
            self._fire("on_fit_start")
            for epoch in range(start_epoch, self.epochs):
                start = skip_steps if (skip_steps and seam) else 0
                raw = (self.batcher.epoch(epoch, start_step=start)
                       if start else self.batcher.epoch(epoch))
                stream = self.backend.stream(b.astuple() for b in raw)
                step_in_epoch = start
                if skip_steps and not start:
                    for _ in range(skip_steps):
                        next(stream, None)
                    step_in_epoch = skip_steps
                skip_steps = 0
                measuring = self.prefetch_auto and self._auto_depth is None
                effective = ((self._auto_depth or 0) if self.prefetch_auto
                             else self.prefetch)
                # the copy of a payload to the device: in the producer
                # thread (pinned, non-blocking) when prefetching
                transfer = functools.partial(batch_to_device,
                                             device=self.device,
                                             non_blocking=effective > 0)
                build_acc = [0.0]
                step_total = 0.0
                if measuring:
                    stream = self._timed_iter(stream, build_acc)
                rebuild = None
                if seam and effective > 0:
                    def rebuild(consumed, _e=epoch, _s=step_in_epoch):
                        return (b.astuple() for b in self.batcher.epoch(
                            _e, start_step=_s + consumed))
                flagged = 0
                for payload in prefetch_iter(
                        stream, effective, transfer=transfer,
                        hang_timeout=self.prefetch_timeout,
                        rebuild=rebuild):
                    t_step = time.perf_counter()
                    self.state, loss, aux = self.backend.step(self.state,
                                                              payload)
                    losses.append(loss)
                    auxes.append(aux)
                    self.global_step += 1
                    step_in_epoch += 1
                    self._position = (epoch, step_in_epoch, losses, auxes)
                    dt_step = time.perf_counter() - t_step
                    step_total += dt_step
                    if self.straggler.flag_step(dt_step):
                        flagged += 1
                    if self._guards_on:
                        self._check_divergence(loss)
                    if faults.maybe_fail("sigterm.at_step",
                                         index=self.global_step):
                        _signal.raise_signal(_signal.SIGTERM)
                    self._fire("on_step", {"epoch": epoch,
                                           "step_in_epoch": step_in_epoch,
                                           "global_step": self.global_step,
                                           "loss": loss, "aux": aux})
                    if self._stop:
                        break
                if self._stop:
                    self.preempted = True
                    if not self._skip_stop_checkpoint:
                        self.save_checkpoint(blocking=True)
                    break
                rec = self._epoch_record(epoch, losses, auxes, t0, flagged)
                if self.prefetch_auto:
                    rec["prefetch_depth"] = effective
                    if measuring and step_total > 0:
                        self._auto_ratio = build_acc[0] / step_total
                        self._auto_depth = self._auto_prefetch_depth(
                            self._auto_ratio)
                        rec["host_build_over_step"] = self._auto_ratio
                self.history.append(rec)
                self._position = (epoch + 1, 0, [], [])
                losses, auxes = [], []
                self._fire("on_epoch", rec)
                if self._stop:          # stop requested by an epoch hook
                    self.preempted = True
                    if not self._skip_stop_checkpoint:
                        self.save_checkpoint(blocking=True)
                    break
        except BaseException as e:
            fit_error = e
            raise
        finally:
            try:
                self._fire("on_fit_end")
            finally:
                if self.checkpoint is not None:
                    # surface a failed FINAL async save without masking
                    # an in-flight fit exception
                    try:
                        self.checkpoint.wait()
                    except BaseException as we:  # noqa: BLE001
                        if fit_error is None:
                            raise
                        warnings.warn(
                            f"a background checkpoint save also failed "
                            f"during error teardown: {we!r}",
                            stacklevel=2)
        return TrainResult(history=self.history,
                           params=self.backend.params(self.state),
                           seconds=time.perf_counter() - t0)

    def _epoch_record(self, epoch: int, losses, auxes, t0,
                      flagged: int = 0) -> Dict:
        rec = {"epoch": epoch,
               "loss": float(np.mean([float(l) for l in losses])),
               "time": time.perf_counter() - t0,
               # straggler diagnostic (wall-time-derived, so resumed-run
               # histories may differ here, like "time")
               "flagged_steps": flagged}
        if self.cfg.multilabel:
            tp = sum(float(a["tp"]) for a in auxes)
            fp = sum(float(a["fp"]) for a in auxes)
            fn = sum(float(a["fn"]) for a in auxes)
            rec["train_f1"] = micro_f1(tp, fp, fn)
        else:
            c = sum(float(a["correct"]) for a in auxes)
            n = sum(float(a["n"]) for a in auxes)
            rec["train_acc"] = c / max(n, 1.0)
        return rec
