"""The port's training slice on the CPU against the reference.

* Model: `gcn_loss` value and grads against the reference's
  `jax.value_and_grad(gcn_loss)` on one batch with dropout 0 — fused and
  unfused, dense and block-ELL, multilabel and multiclass, residual,
  payload A'X, layernorm, remat, and bf16 (the ppi_deep_tiny switches).
* Optimizers: AdamW and SGD updates against the reference's.
* Trajectory: 20 AdamW steps of the port's Engine against the
  reference's `make_train_step` on the same ppi_tiny batches.
* Scaled steps: the bf16 + dynamic-loss-scaling step against the
  reference's, and the non-finite step skip.
* Resume: bitwise within the port; a reference checkpoint's params and
  optimizer moments restore into the port's state.
* CLI: `repro_torch.launch.run_experiment` trains on the CPU and refuses
  CUDA on a host without a GPU.

Params come from the reference's init (through numpy), so both packages
start from the same point; torch's random streams differ from jax's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.batching import ClusterBatcher as RefBatcher
from repro.core.experiment import build_experiment as ref_build_experiment
from repro.core.experiment import preset as ref_preset
from repro.core.gcn import GCNConfig as RefCfg
from repro.core.gcn import gcn_loss as ref_gcn_loss
from repro.core.gcn import init_gcn as ref_init_gcn
from repro.graph.generators import make_dataset as ref_make_dataset
from repro.kernels.block_spmm import BlockEllAdj as RefAdj
from repro.nn import optim as ref_optim
from repro_torch.core.batching import ClusterBatcher, batch_to_device
from repro_torch.core.engine import (Engine, SingleDeviceBackend,
                                     StopAtStepHook, make_train_step)
from repro_torch.core.experiment import build_experiment, preset
from repro_torch.core.gcn import GCNConfig, gcn_loss
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.partition import partition_graph
from repro_torch.launch import run_experiment
from repro_torch.nn import optim
from repro_torch.nn.tree import tree_leaves
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.faults import FaultPlan, FaultRule, fault_scope

FP32_TOL = 1e-4


@pytest.fixture(scope="module")
def graphs():
    g = make_dataset("ppi", scale=0.03, seed=0)
    rg = ref_make_dataset("ppi", scale=0.03, seed=0)
    parts, _ = partition_graph(g, 8, method="metis", seed=0, cache=False)
    return g, rg, parts


def _multiclass(graph):
    return dataclasses.replace(graph, labels=graph.labels.argmax(1)
                               .astype(np.int32))


def _ref_tuple(batch):
    """A reference payload with jnp leaves (the BlockEllAdj leaves go
    through jnp.asarray, ROADMAP C1)."""
    t = list(batch.astuple())
    if isinstance(t[0], RefAdj):
        t[0] = RefAdj(*(None if x is None else jnp.asarray(x) for x in (
            t[0].blocks, t[0].block_cols, t[0].blocks_t, t[0].block_cols_t,
            t[0].row_k, t[0].row_k_t)))
    return tuple(t)


def _port_params(ref_params, requires_grad=False):
    return {"layers": [
        {k: torch.from_numpy(np.array(v, np.float32))
         .requires_grad_(requires_grad) for k, v in layer.items()}
        for layer in ref_params["layers"]]}


def _ref_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _port_np(tree):
    return [x.detach().float().numpy() for x in tree_leaves(tree)]


# ----------------------------------------------------------------------
# model: loss and grads on one batch
# ----------------------------------------------------------------------
MODELS = {
    "base": dict(),
    "fused": dict(fuse_spmm=True),
    "sparse": dict(_sparse=True),
    "sparse_fused": dict(_sparse=True, fuse_spmm=True),
    "multiclass_sparse_fused": dict(_sparse=True, fuse_spmm=True,
                                    _multiclass=True, multilabel=False),
    "residual": dict(_sparse=True, fuse_spmm=True, residual=True,
                     num_layers=4),
    "residual_no_layernorm": dict(_sparse=True, residual=True,
                                  layernorm=False, num_layers=4),
    "precompute_ax": dict(_sparse=True, fuse_spmm=True, precompute_ax=True),
    "remat": dict(_sparse=True, fuse_spmm=True, remat=True, num_layers=4,
                  remat_chunk=3),
    "bf16": dict(_sparse=True, fuse_spmm=True, precision="bf16"),
    # the ppi_deep_tiny switches (8 layers cut to 6)
    "deep_bf16": dict(_sparse=True, fuse_spmm=True, precision="bf16",
                      residual=True, precompute_ax=True, remat=True,
                      num_layers=6, _norm="eq11"),
}


def _bf16_grads_close(got, want):
    """bf16 grads: the port rounds at the same places as the reference
    and takes its subgradients at ties, so what remains is summation
    order inside fp32 accumulations, which can flip a bf16 rounding
    (2^-8 relative) of an intermediate now and then, and a residual path
    carries the flip on (measured: 0 for 3 layers, 4e-3 of max|g| for the
    6-layer deep switches): max|Δ| <= 2e-2·max(1, max|g|) per leaf."""
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 2e-2 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_gcn_loss_and_grads_match_reference(graphs, name):
    kw = dict(MODELS[name])
    sparse = kw.pop("_sparse", False)
    multiclass = kw.pop("_multiclass", False)
    norm = kw.pop("_norm", "eq10")
    g, rg, parts = graphs
    if multiclass:
        g, rg = _multiclass(g), _multiclass(rg)
    cfg_kw = dict(in_dim=50, hidden_dim=32, out_dim=121, num_layers=3,
                  dropout=0.0, multilabel=True)
    cfg_kw.update(kw)
    bkw = dict(clusters_per_batch=2, sparse_adj=sparse, block_size=16,
               pad_multiple=16, norm=norm,
               diag_lambda=1.0 if norm == "eq11" else 0.0,
               precompute_ax=cfg_kw.get("precompute_ax", False))
    rbatch = next(iter(RefBatcher(rg, parts, **bkw).epoch(0)))
    pbatch = next(iter(ClusterBatcher(g, parts, **bkw).epoch(0)))
    rcfg, pcfg = RefCfg(**cfg_kw), GCNConfig(**cfg_kw)
    params = ref_init_gcn(jax.random.PRNGKey(0), rcfg)
    (want_loss, want_aux), want_g = jax.value_and_grad(
        ref_gcn_loss, has_aux=True)(params, _ref_tuple(rbatch), rcfg,
                                    train=True, rng=jax.random.PRNGKey(1))
    tparams = _port_params(params, requires_grad=True)
    loss, aux = gcn_loss(tparams, batch_to_device(pbatch.astuple(), "cpu"),
                         pcfg, train=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        FP32_TOL * max(1.0, abs(float(want_loss)))
    for k in want_aux:                  # micro-F1 parts / correct counts
        assert abs(float(aux[k]) - float(want_aux[k])) <= \
            1e-3 * max(1.0, abs(float(want_aux[k])))
    got = [t.grad.numpy() for t in tree_leaves(tparams)]
    want = _ref_np(want_g)
    assert [x.shape for x in got] == [x.shape for x in want]
    if pcfg.precision == "bf16":
        _bf16_grads_close(got, want)
    else:
        for a, b in zip(got, want):
            assert np.abs(a - b).max() <= FP32_TOL * max(1.0,
                                                         np.abs(b).max())


# ----------------------------------------------------------------------
# optimizers
# ----------------------------------------------------------------------
OPTS = {
    "adamw": lambda o: o.adamw(1e-2),
    "adamw_wd_clip": lambda o: o.adamw(3e-3, weight_decay=0.1,
                                       clip_norm=0.5),
    "adamw_cosine": lambda o: o.adamw(o.warmup_cosine_schedule(1e-2, 2, 6)),
    "sgd": lambda o: o.sgd(0.1),
    "sgd_momentum_clip": lambda o: o.sgd(
        o.warmup_linear_schedule(0.1, 1, 5), momentum=0.9, clip_norm=1.0),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_updates_match_reference(name):
    """Five updates from the same params and grads; the optimizer state
    has the reference's leaves in the reference's order."""
    rng = np.random.default_rng(0)
    shapes = {"layers": [{"w": (4, 3), "b": (3,)}, {"w": (3, 2), "b": (2,)}]}
    p0 = {"layers": [{k: rng.normal(size=s).astype(np.float32)
                      for k, s in layer.items()} for layer in shapes["layers"]]}
    ropt, popt = OPTS[name](ref_optim), OPTS[name](optim)
    rp = jax.tree_util.tree_map(jnp.asarray, p0)
    pp = _port_params(p0)
    rs, ps = ropt.init(rp), popt.init(pp)
    for _ in range(5):
        grads = {"layers": [{k: rng.normal(size=s).astype(np.float32)
                             for k, s in layer.items()}
                            for layer in shapes["layers"]]}
        ru, rs = ropt.update(jax.tree_util.tree_map(jnp.asarray, grads), rs,
                             rp)
        rp = ref_optim.apply_updates(rp, ru)
        pu, ps = popt.update(_port_params(grads), ps, pp)
        pp = optim.apply_updates(pp, pu)
        for a, b in zip(_port_np(pp), _ref_np(rp)):
            assert np.abs(a - b).max() <= 1e-6 * max(1.0, np.abs(b).max())
        state_r, state_p = _ref_np(rs), _port_np(ps)
        assert len(state_r) == len(state_p)
        for a, b in zip(state_p, state_r):
            assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())


# ----------------------------------------------------------------------
# 20-step trajectory: port Engine vs the reference's make_train_step
# ----------------------------------------------------------------------
STEPS = 20


class _Record:
    """Collects per-step losses; stops the Engine after `steps`."""

    def __init__(self, steps):
        self.steps, self.losses = steps, []

    def on_step(self, engine, info):
        self.losses.append(float(info["loss"]))
        if info["global_step"] >= self.steps:
            engine.request_stop("recorded")


def _engine_with_params(batcher, cfg, opt, params, hooks, epochs=100):
    backend = SingleDeviceBackend(cfg, opt, device="cpu")
    eng = Engine(batcher, cfg, backend, epochs=epochs, hooks=hooks)
    eng.init_state = lambda: backend.init(  # the reference's params
        _port_params(params), torch.Generator().manual_seed(1))
    return eng


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_twenty_step_adamw_trajectory_matches_reference(graphs, fused):
    """Per-step loss within 1e-4·max(1, |loss|) and final params within
    1e-4·max(1, max|p|). Both hold far tighter here (fp32, CPU); the
    bound leaves room for Adam's normalised step, which turns a
    last-bit difference in a near-zero gradient into an lr-sized one."""
    g, rg, parts = graphs
    cfg_kw = dict(in_dim=50, hidden_dim=64, out_dim=121, num_layers=3,
                  dropout=0.0, multilabel=True, fuse_spmm=fused)
    rcfg, pcfg = RefCfg(**cfg_kw), GCNConfig(**cfg_kw)
    bkw = dict(clusters_per_batch=2, seed=0, sparse_adj=True)
    # numpy copy first: the reference's step donates its params
    params = jax.tree_util.tree_map(
        np.asarray, ref_init_gcn(jax.random.PRNGKey(0), rcfg))
    ropt = ref_optim.adamw(1e-2)
    step = ref_engine.make_train_step(rcfg, ropt)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs, rng = ropt.init(rp), jax.random.PRNGKey(1)
    want, epoch, batcher = [], 0, RefBatcher(rg, parts, **bkw)
    while len(want) < STEPS:
        for b in batcher.epoch(epoch):
            rp, rs, rng, loss, _ = step(rp, rs, rng, _ref_tuple(b))
            want.append(float(loss))
            if len(want) == STEPS:
                break
        epoch += 1
    rec = _Record(STEPS)
    eng = _engine_with_params(ClusterBatcher(g, parts, **bkw), pcfg,
                              optim.adamw(1e-2), params, [rec])
    res = eng.fit()
    assert len(rec.losses) == STEPS
    for a, b in zip(rec.losses, want):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
    assert rec.losses[-1] < rec.losses[0]
    for a, b in zip(_port_np(res.params), _ref_np(rp)):
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_scaled_step_matches_reference(graphs, precision):
    """Three steps under dynamic loss scaling with the ppi_deep_tiny
    switches (residual, payload A'X, remat; 4 layers), from the same
    params on the same batches; the loss-scale state must be equal.
    fp32: params within 1e-4·max(1, max|p|). bf16: the gradients may
    differ by flipped roundings (see _bf16_grads_close), and Adam's
    normalised step turns a small difference in a near-zero gradient
    into an lr-sized move, so each element may differ by up to 2·lr per
    step, and the update p - p0 agrees within 10% in L2 (measured:
    3.2%)."""
    g, rg, parts = graphs
    cfg_kw = dict(in_dim=50, hidden_dim=32, out_dim=121, num_layers=4,
                  dropout=0.0, multilabel=True, fuse_spmm=True,
                  precision=precision, loss_scaling="dynamic",
                  residual=True, remat=True, precompute_ax=True)
    rcfg, pcfg = RefCfg(**cfg_kw), GCNConfig(**cfg_kw)
    bkw = dict(clusters_per_batch=2, sparse_adj=True, block_size=16,
               pad_multiple=16, precompute_ax=True)
    params = jax.tree_util.tree_map(
        np.asarray, ref_init_gcn(jax.random.PRNGKey(0), rcfg))
    p0 = _ref_np(params)
    lr = 1e-2
    ropt, popt = ref_optim.adamw(lr), optim.adamw(lr)
    rstep = ref_engine.make_train_step(rcfg, ropt)
    pstep = make_train_step(pcfg, popt)
    from repro.core.precision import init_scale_state as ref_scale
    from repro.core.precision import policy_from_config as ref_policy
    from repro_torch.core.precision import (init_scale_state,
                                            policy_from_config)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs, rsc = ropt.init(rp), ref_scale(ref_policy(rcfg))
    pp = _port_params(params)
    ps, psc = popt.init(pp), init_scale_state(policy_from_config(pcfg))
    gen, rng = torch.Generator(), jax.random.PRNGKey(1)
    rbs = list(RefBatcher(rg, parts, **bkw).epoch(0))[:3]
    pbs = list(ClusterBatcher(g, parts, **bkw).epoch(0))[:3]
    for n, (rb, pb) in enumerate(zip(rbs, pbs), 1):
        rp, rs, rng, rsc, _, _ = rstep(rp, rs, rng, rsc, _ref_tuple(rb))
        pp, ps, gen, psc, loss, _ = pstep(
            pp, ps, gen, psc, batch_to_device(pb.astuple(), "cpu"))
        assert torch.isfinite(loss)
        got, want = _port_np(pp), _ref_np(rp)
        if precision == "fp32":
            for a, b in zip(got, want):
                assert np.abs(a - b).max() <= \
                    FP32_TOL * max(1.0, np.abs(b).max())
        else:
            for a, b in zip(got, want):
                assert np.abs(a - b).max() <= 2 * lr * n
            num = sum(float(((a - b) ** 2).sum())
                      for a, b in zip(got, want))
            den = sum(float(((b - c) ** 2).sum())
                      for b, c in zip(want, p0))
            assert np.sqrt(num / den) <= 0.1
        assert float(psc["scale"]) == float(rsc["scale"])
        assert int(psc["good"]) == int(rsc["good"])


def test_nonfinite_step_is_skipped_on_the_device(graphs):
    """A poisoned batch (fault site step.nonfinite_loss) under dynamic
    scaling leaves params and optimizer state unchanged and halves the
    scale — the reference's step-skip."""
    g, _, parts = graphs
    cfg = GCNConfig(in_dim=50, hidden_dim=16, out_dim=121, num_layers=2,
                    dropout=0.0, multilabel=True, loss_scaling="dynamic",
                    loss_scale=8.0)
    opt = optim.adamw(1e-2)
    backend = SingleDeviceBackend(cfg, opt, device="cpu")
    batcher = ClusterBatcher(g, parts, clusters_per_batch=2)
    eng = Engine(batcher, cfg, backend, epochs=1)
    state = eng.init_state()
    batch = batch_to_device(next(iter(batcher.epoch(0))).astuple(), "cpu")
    plan = FaultPlan(rules={"step.nonfinite_loss": FaultRule(at=(0,))})
    with fault_scope(plan):
        new, loss, _ = backend.step(state, batch)
    assert not torch.isfinite(loss)
    for a, b in zip(tree_leaves(new["params"]), tree_leaves(state["params"])):
        assert torch.equal(a, b)
    assert int(new["opt"].step) == 0
    assert float(new["scale"]["scale"]) == 4.0
    new, loss, _ = backend.step(new, batch)       # the next one trains
    assert torch.isfinite(loss) and int(new["opt"].step) == 1


# ----------------------------------------------------------------------
# resume and checkpoints
# ----------------------------------------------------------------------
def _spec(tmp_path, **sets):
    spec = preset("ppi_tiny")
    spec.partition.cache = False
    spec.batch.sparse_adj = True
    spec.model.fuse_spmm = True
    spec.run.epochs = 2
    spec.run.eval_every = 0
    spec.run.checkpoint_dir = str(tmp_path / "ck")
    for k, v in sets.items():
        sec, field = k.split("__")
        setattr(getattr(spec, sec), field, v)
    return spec


@pytest.mark.parametrize("stop_at", [3, 4], ids=["mid_epoch",
                                                 "epoch_boundary"])
def test_resume_is_bitwise(tmp_path, stop_at):
    """A run stopped by StopAtStepHook and resumed from its checkpoint
    ends with the same params, optimizer state and RNG as an unstopped
    run (dropout on, so the restored generator matters)."""
    straight = build_experiment(_spec(tmp_path / "a"), device="cpu")
    res_a = straight.fit()
    stopped = build_experiment(_spec(tmp_path / "b"), device="cpu",
                               extra_hooks=[StopAtStepHook(stop_at)])
    stopped.fit()
    assert stopped.engine.preempted
    assert stopped.engine.global_step == stop_at
    resumed = build_experiment(_spec(tmp_path / "b"), device="cpu")
    res_b = resumed.fit(resume=True)
    assert resumed.engine.global_step == straight.engine.global_step
    for a, b in zip(tree_leaves(straight.engine.state),
                    tree_leaves(resumed.engine.state)):
        if isinstance(a, torch.Generator):
            assert torch.equal(a.get_state(), b.get_state())
        else:
            assert torch.equal(a, b)
    strip = lambda h: {k: v for k, v in h.items()  # noqa: E731
                       if k not in ("time", "flagged_steps")}
    assert [strip(h) for h in res_a.history] == \
        [strip(h) for h in res_b.history]


def test_reference_checkpoint_restores_into_port_state(tmp_path):
    """params and opt (AdamState step/mu/nu) of a reference Engine
    checkpoint restore under the same keys into the port's state."""
    spec = ref_preset("ppi_tiny")
    spec.partition.cache = False
    spec.run.epochs = 1
    spec.run.eval_every = 0
    spec.run.checkpoint_dir = str(tmp_path)
    ref_exp = ref_build_experiment(spec)
    ref_exp.fit()
    ref_state = ref_exp.engine.state
    port = build_experiment(_spec(tmp_path / "port"), device="cpu")
    template = port.engine.init_state()
    mgr = CheckpointManager(str(tmp_path))
    params, step = mgr.restore_subtree(template["params"], "params")
    opt_state, _ = mgr.restore_subtree(template["opt"], "opt", step=step)
    assert isinstance(opt_state, optim.AdamState)
    assert int(opt_state.step) == int(ref_state["opt"].step)
    for a, b in zip(_port_np(params), _ref_np(ref_state["params"])):
        assert np.array_equal(a, b)
    for a, b in zip(_port_np(opt_state), _ref_np(ref_state["opt"])):
        assert np.array_equal(a, b)


def test_engine_checkpoint_keys_match_reference_layout(tmp_path):
    exp = build_experiment(_spec(tmp_path, run__epochs=1), device="cpu")
    exp.fit()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    manifest = json.loads((mgr._step_dir(mgr.latest_step())
                           / "manifest.json").read_text())
    keys = set(manifest["arrays"])
    assert {"opt/.step", "opt/.mu/layers/0/w", "opt/.nu/layers/2/b",
            "params/layers/0/w", "params/layers/1/ln_scale", "rng"} <= keys
    assert mgr.read_metadata()["global_step"] == \
        exp.batcher.steps_per_epoch()


# ----------------------------------------------------------------------
# builders and the CLI
# ----------------------------------------------------------------------
def test_build_experiment_refuses_later_slices(tmp_path):
    """execution.data_shards trains data parallel over an initialised
    process group of exactly that many ranks, and refuses otherwise."""
    import torch.distributed as dist
    spec = _spec(tmp_path)
    spec.execution.data_shards = 2
    with pytest.raises(ValueError, match="no torch.distributed process"):
        build_experiment(spec, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="has 1 rank"):
            build_experiment(spec, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("sets", [[], ["batch.sparse_adj=true",
                                       "model.fuse_spmm=true"]],
                         ids=["dense", "sparse_fused"])
def test_cli_trains_on_cpu_and_writes_metrics(tmp_path, sets):
    argv = ["--preset", "ppi_tiny", "--device", "cpu",
            "--results-dir", str(tmp_path), "--set", "run.epochs=3",
            "--set", "partition.cache=false"]
    for s in sets:
        argv += ["--set", s]
    assert run_experiment.main(argv) == 0
    metrics = json.loads((tmp_path / "ppi_tiny" / "metrics.json")
                         .read_text())
    losses = [h["loss"] for h in metrics["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert metrics["device"] == "cpu"
    assert (tmp_path / "ppi_tiny" / "spec.json").exists()


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")


def test_cli_defaults_to_cuda_and_exits_without_gpu(no_gpu, tmp_path):
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        run_experiment.main(["--preset", "ppi_tiny",
                             "--results-dir", str(tmp_path)])


def test_engine_backend_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    cfg = GCNConfig(in_dim=3, hidden_dim=4, out_dim=2, num_layers=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SingleDeviceBackend(cfg, optim.adamw(1e-2))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_experiment(preset("ppi_tiny"))


# ----------------------------------------------------------------------
# prefetch, fault sites and guards of the ported runtime
# ----------------------------------------------------------------------
def _final_state(exp):
    return [t.get_state() if isinstance(t, torch.Generator) else t
            for t in tree_leaves(exp.engine.state)]


@pytest.mark.parametrize("prefetch,pooled", [(2, True), ("auto", False),
                                             (4, True)])
def test_prefetch_trajectory_equals_synchronous(tmp_path, prefetch, pooled):
    """Batches built ahead on a producer thread train exactly as the
    synchronous loop does, at any depth with batch.reuse_tile_buffers
    set (accepted, and without effect: payloads own their buffers)."""
    sync = build_experiment(_spec(tmp_path / "s", run__checkpoint_dir=None),
                            device="cpu")
    sync.fit()
    ahead = build_experiment(_spec(tmp_path / "p", run__checkpoint_dir=None,
                                   execution__prefetch=prefetch,
                                   batch__reuse_tile_buffers=pooled),
                             device="cpu")
    ahead.fit()
    for a, b in zip(_final_state(sync), _final_state(ahead)):
        assert torch.equal(a, b)


def test_corrupt_newest_checkpoint_falls_back_on_resume(tmp_path):
    """checkpoint.corrupt_latest flips bits in the newest step: resume
    quarantines it, lands on the previous good one, and still ends where
    an unfaulted run ends."""
    straight = build_experiment(_spec(tmp_path / "a"), device="cpu")
    straight.fit()
    faulty = _spec(tmp_path / "b")
    faulty.run.faults = {"rules": {"checkpoint.corrupt_latest":
                                   {"at": [1]}}}
    first = build_experiment(faulty, device="cpu")
    first.fit()                              # epoch-2 save is corrupted
    resumed = build_experiment(_spec(tmp_path / "b", run__epochs=2),
                               device="cpu")
    with pytest.warns(UserWarning, match="quarantined"):
        resumed.fit(resume=True)
    for a, b in zip(_final_state(straight), _final_state(resumed)):
        assert torch.equal(a, b)


def test_crash_before_rename_leaks_tmp_and_init_sweeps_it(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"params": {"w": torch.ones(2, 2)}}
    plan = FaultPlan(rules={"checkpoint.crash_before_rename":
                            FaultRule(at=(0,))})
    with fault_scope(plan), pytest.raises(Exception, match="injected"):
        mgr.save(1, tree, blocking=True)
    assert list(tmp_path.glob("step_*.tmp-*")) and mgr.steps() == []
    CheckpointManager(str(tmp_path))
    assert not list(tmp_path.glob("step_*.tmp-*"))


def test_async_save_publishes_after_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, {"params": {"w": torch.arange(4.0)}}, metadata={"k": 1})
    mgr.wait()
    assert mgr.steps() == [3] and mgr.read_metadata(3) == {"k": 1}
    got, step = mgr.restore_subtree({"w": torch.zeros(4)}, "params")
    assert step == 3 and torch.equal(got["w"], torch.arange(4.0))


def test_consecutive_nonfinite_losses_stop_the_run(tmp_path):
    """max_consecutive_skipped: poisoned steps under dynamic scaling are
    skipped on the device; after N in a row the Engine stops cleanly with
    a structured reason."""
    spec = _spec(tmp_path, model__loss_scaling="dynamic",
                 run__max_consecutive_skipped=2)
    spec.run.faults = {"rules": {"step.nonfinite_loss": {"times": 10}}}
    exp = build_experiment(spec, device="cpu")
    exp.fit()
    assert exp.engine.diverged and exp.engine.global_step == 2
    assert exp.engine.stop_reason.startswith("divergence: 2 consecutive")


def test_train_cluster_gcn_wrapper_matches_engine(graphs):
    from repro_torch.core.trainer import train_cluster_gcn
    g, _, parts = graphs
    cfg = GCNConfig(in_dim=50, hidden_dim=16, out_dim=121, num_layers=2,
                    dropout=0.0, multilabel=True, fuse_spmm=True)
    batcher = ClusterBatcher(g, parts, clusters_per_batch=2)
    res = train_cluster_gcn(g, batcher, cfg, optim.adamw(1e-2),
                            num_epochs=2, sparse_adj=True, eval_every=1,
                            device="cpu")
    backend = SingleDeviceBackend(cfg, optim.adamw(1e-2), device="cpu")
    eng = Engine(dataclasses.replace(batcher, sparse_adj=True), cfg,
                 backend, epochs=2)
    direct = eng.fit()
    assert [h["loss"] for h in res.history] == \
        [h["loss"] for h in direct.history]
    assert all("val_score" in h for h in res.history)
