"""The port's GraphSAINT samplers against the reference's, payload for
payload.

`repro_torch.core.samplers.{SaintNodeSampler, SaintEdgeSampler}` must
emit the same batches, bit for bit — the estimator weights in
`loss_mask` included — as `repro.core.samplers` per (seed, epoch):
node sampling uniform and degree-weighted, edge sampling, dense and
block-ELL adjacency with k_slots "cap" and "auto", payload-time A'X and
pooled tile buffers, and the `start_step` fast-forward. Also equal:
`steps_per_epoch`, `sample_csrs`, `padding_stats`, `default_saint_budget`
and the validation errors. Within the port: `build_experiment` builds
the samplers without a partition, and `Engine.fit(resume=True)` of a
SAINT run ends where a straight run does.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import experiment as ref_experiment
from repro.core import samplers as ref_samplers
from repro.graph.csr import CSRGraph as RefCSRGraph
from repro.graph.generators import make_dataset as ref_make_dataset
from repro_torch.core import experiment, samplers
from repro_torch.core.engine import StopAtStepHook
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import make_dataset
from repro_torch.kernels.block_spmm import BlockEllAdj, BlockEllCoords
from repro_torch.nn.tree import tree_leaves

FIELDS = ("blocks", "block_cols", "blocks_t", "block_cols_t", "row_k",
          "row_k_t")


@pytest.fixture(scope="module")
def graphs():
    g = make_dataset("ppi", scale=0.03, seed=0)
    rg = ref_make_dataset("ppi", scale=0.03, seed=0)
    for f in ("indptr", "indices", "data", "features", "labels",
              "train_mask"):
        assert np.array_equal(getattr(g, f), getattr(rg, f)), f
    return g, rg


def _assert_same_payload(ref, got):
    """Bit for bit; the port's compact adjacency is compared as the tiles
    it expands to."""
    r_adj, g_adj = (a.to("cpu") if isinstance(a, BlockEllCoords) else a
                    for a in (ref.adj, got.adj))
    if isinstance(g_adj, BlockEllAdj):
        for f in FIELDS:
            a, b = np.asarray(getattr(r_adj, f)), getattr(g_adj, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    else:
        assert r_adj.dtype == g_adj.dtype and np.array_equal(r_adj, g_adj)
    for f in ("features", "labels", "node_mask", "loss_mask", "num_real"):
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


SPARSE = dict(sparse_adj=True, block_size=16, pad_multiple=16)
CASES = {
    # name: (sampler class name, budget, keyword arguments)
    "node_dense": ("SaintNodeSampler", 64, {}),
    "node_degree_dense": ("SaintNodeSampler", 64,
                          dict(degree_weighted=True)),
    "edge_dense": ("SaintEdgeSampler", 40, {}),
    "node_sparse_cap": ("SaintNodeSampler", 64, SPARSE),
    "node_sparse_auto": ("SaintNodeSampler", 64,
                         dict(SPARSE, k_slots="auto")),
    "node_degree_sparse_auto": ("SaintNodeSampler", 64,
                                dict(SPARSE, k_slots="auto",
                                     degree_weighted=True)),
    "edge_sparse_cap": ("SaintEdgeSampler", 40, SPARSE),
    "edge_sparse_auto": ("SaintEdgeSampler", 40,
                         dict(SPARSE, k_slots="auto")),
    "edge_precompute_ax_eq11": ("SaintEdgeSampler", 40,
                                dict(SPARSE, precompute_ax=True,
                                     norm="eq11", diag_lambda=1.0)),
    "node_pooled_tiles": ("SaintNodeSampler", 64,
                          dict(SPARSE, reuse_tile_buffers=True,
                               batches_per_epoch=5)),
}


def _pair(graphs, case, **extra):
    cls, budget, kw = CASES[case]
    g, rg = graphs
    kw = dict(kw, **extra)
    return (getattr(ref_samplers, cls)(rg, budget, **kw),
            getattr(samplers, cls)(g, budget, **kw))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_payloads_bit_equal_to_reference(graphs, case, seed):
    ref, port = _pair(graphs, case, seed=seed)
    assert port.node_cap == ref.node_cap
    assert port.steps_per_epoch() == ref.steps_per_epoch()
    if ref.k_plan is not None:
        assert port.k_plan.buckets == ref.k_plan.buckets
        assert port.k_plan.sampled_ft == ref.k_plan.sampled_ft
    for epoch in (0, 1):
        want, got = [], []
        for a, b in zip(ref.epoch(epoch), port.epoch(epoch)):
            # pooled tile buffers recycle: compare before moving on
            _assert_same_payload(a, b)
            want.append(a)
            got.append(b)
        assert len(got) == len(want) == ref.steps_per_epoch()
        # the estimator weights are fractional, and only on real nodes
        lm = got[0].loss_mask
        assert (lm[~got[0].node_mask] == 0).all()
        assert not np.all(np.isin(lm, (0.0, 1.0)))


@pytest.mark.parametrize("case", ["node_dense", "edge_sparse_auto",
                                  "node_pooled_tiles"])
@pytest.mark.parametrize("start", [1, 3])
def test_start_step_fast_forward_bit_equal(graphs, case, start):
    ref, port = _pair(graphs, case)
    want = list(ref.epoch(2, start_step=start))
    got = list(port.epoch(2, start_step=start))
    assert len(got) == len(want) == ref.steps_per_epoch() - start
    for a, b in zip(want, got):
        _assert_same_payload(a, b)
    for a, b in zip(list(port.epoch(2))[start:], got):  # build-and-discard
        _assert_same_payload(a, b)


@pytest.mark.parametrize("case", ["node_dense", "node_degree_sparse_auto",
                                  "edge_sparse_cap"])
def test_sample_csrs_and_padding_stats_match(graphs, case):
    ref, port = _pair(graphs, case)
    for (a, b, c), (x, y, z) in zip(ref.sample_csrs(3), port.sample_csrs(3)):
        assert np.array_equal(a, x) and np.array_equal(b, y)
        assert np.array_equal(c, z)
    assert port.padding_stats() == ref.padding_stats()
    assert port.padding_stats(sample_batches=6) == \
        ref.padding_stats(sample_batches=6)


@pytest.mark.parametrize("kw", [
    dict(budget=0),
    dict(budget=64, batches_per_epoch=0),
    dict(budget=64, node_cap=32),
    dict(budget=64, node_cap=72, sparse_adj=True, block_size=16),
    dict(budget=64, k_slots="most"),
], ids=["budget", "batches_per_epoch", "node_cap", "block_size", "k_slots"])
@pytest.mark.parametrize("cls", ["SaintNodeSampler", "SaintEdgeSampler"])
def test_validation_errors_match_reference(graphs, cls, kw):
    g, rg = graphs
    kw = dict(kw)
    budget = kw.pop("budget")
    with pytest.raises(ValueError) as want:
        getattr(ref_samplers, cls)(rg, budget, **kw)
    with pytest.raises(ValueError) as got:
        getattr(samplers, cls)(g, budget, **kw)
    assert str(got.value) == str(want.value)


def test_edge_sampler_refuses_an_edgeless_graph_like_reference():
    args = dict(indptr=np.zeros(5, np.int64), indices=np.zeros(0, np.int32),
                data=np.zeros(0, np.float32),
                features=np.zeros((4, 2), np.float32),
                labels=np.zeros(4, np.int32))
    with pytest.raises(ValueError) as want:
        ref_samplers.SaintEdgeSampler(RefCSRGraph(**args), 4)
    with pytest.raises(ValueError) as got:
        samplers.SaintEdgeSampler(CSRGraph(**args), 4)
    assert str(got.value) == str(want.value)


class _Sized:
    """A graph stand-in: default_saint_budget reads only num_nodes."""

    def __init__(self, n):
        self.num_nodes = n


@pytest.mark.parametrize("name", ["ppi_tiny", "reddit_tiny", "ppi_sota",
                                  "amazon2m_tiny"])
@pytest.mark.parametrize("sampler", ["saint_node", "saint_edge"])
def test_default_saint_budget_equals_reference(name, sampler):
    spec, rspec = experiment.preset(name), ref_experiment.preset(name)
    spec.batch.sampler = rspec.batch.sampler = sampler
    for n in (7, 1000, 14000):
        got = experiment.default_saint_budget(spec, _Sized(n))
        want = ref_experiment.default_saint_budget(rspec, _Sized(n))
        assert got == want >= 1


# ----------------------------------------------------------------------
# build_experiment and the Engine on SAINT specs
# ----------------------------------------------------------------------
def _saint_spec(tmp_path, sampler="saint_node", **sets):
    spec = experiment.preset("ppi_tiny_saint")
    spec.batch.sampler = sampler
    spec.batch.sparse_adj = True
    spec.model.fuse_spmm = True
    spec.run.epochs = 2
    spec.run.eval_every = 0
    spec.run.checkpoint_dir = str(tmp_path / "ck")
    for k, v in sets.items():
        sec, field = k.split("__")
        setattr(getattr(spec, sec), field, v)
    return spec


@pytest.mark.parametrize("sampler,cls", [
    ("saint_node", samplers.SaintNodeSampler),
    ("saint_edge", samplers.SaintEdgeSampler)])
def test_build_experiment_builds_saint_samplers(tmp_path, sampler, cls):
    """batch.sampler=saint_* builds the sampler with no partition (the
    cluster path builds one), with the reference's budget and cap."""
    spec = _saint_spec(tmp_path, sampler, batch__budget=None)
    exp = experiment.build_experiment(spec, device="cpu")
    assert isinstance(exp.batcher, cls)
    assert exp.parts is None and exp.partition_stats is None
    rspec = ref_experiment.preset("ppi_tiny_saint")
    rspec.batch.sampler, rspec.batch.budget = sampler, None
    rspec.batch.sparse_adj = True
    rg = ref_experiment.build_graph(rspec)
    want = ref_experiment.build_batcher(rspec, rg, None)
    assert exp.batcher.budget == want.budget
    assert exp.batcher.node_cap == want.node_cap
    assert exp.batcher.steps_per_epoch() == want.steps_per_epoch()


@pytest.mark.parametrize("stop_at", [3, 7], ids=["mid_epoch",
                                                 "next_epoch"])
def test_resume_is_bitwise_for_saint(tmp_path, stop_at):
    """A SAINT run stopped by StopAtStepHook and resumed from its
    checkpoint ends with the state of a straight run (dropout on)."""
    straight = experiment.build_experiment(
        _saint_spec(tmp_path / "a", batch__batches_per_epoch=5),
        device="cpu")
    res_a = straight.fit()
    spec_b = _saint_spec(tmp_path / "b", batch__batches_per_epoch=5)
    stopped = experiment.build_experiment(
        spec_b, device="cpu", extra_hooks=[StopAtStepHook(stop_at)])
    stopped.fit()
    assert stopped.engine.preempted
    assert stopped.engine.global_step == stop_at
    resumed = experiment.build_experiment(spec_b, device="cpu")
    res_b = resumed.fit(resume=True)
    assert resumed.engine.global_step == straight.engine.global_step == 10
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


@pytest.mark.parametrize("sampler", ["saint_node", "saint_edge"])
def test_cli_trains_a_saint_run_on_cpu(tmp_path, capsys, sampler):
    """`run_experiment --preset ppi_tiny_saint --device cpu` on either
    sampler, block-ELL and fused: finite falling losses, the sampler
    named in the run's banner."""
    import json
    from repro_torch.launch import run_experiment
    argv = ["--preset", "ppi_tiny_saint", "--device", "cpu",
            "--results-dir", str(tmp_path), "--set", "run.epochs=3",
            "--set", f"batch.sampler={sampler}",
            "--set", "batch.batches_per_epoch=6",
            "--set", "batch.sparse_adj=true", "--set", "model.fuse_spmm=true"]
    assert run_experiment.main(argv) == 0
    assert f"{sampler} sampler (budget 128)" in capsys.readouterr().err
    metrics = json.loads((tmp_path / "ppi_tiny_saint" / "metrics.json")
                         .read_text())
    losses = [h["loss"] for h in metrics["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")


def test_saint_run_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            experiment.build_experiment(experiment.preset("ppi_tiny_saint"))
