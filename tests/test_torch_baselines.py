"""The port's baselines (`repro_torch.core.baselines`) against the
reference's on the CPU.

Each trainer — full-batch GCN, exact L-hop SGD, GraphSAGE and VR-GCN —
runs in both packages on a tiny graph (PPI stand-in: multilabel;
Reddit stand-in: multiclass), 2–3 layers of width 16, layernorm off
and on, dropout 0, from the reference's init: the port's `init_gcn` is
swapped for the reference's params through `params_from_numpy`, so the
port's signature stays the reference's plus `device=`. The host numpy
streams (permutations, closures, neighbor samples, VR-GCN's history)
are the reference's draw for draw, so both packages train on the same
batches.

Bounds: per-epoch losses within 1e-4·max(1, |loss|); final params
within 1e-4·max(1, max|p|) (fp32 on the CPU; what remains is summation
order, which Adam's normalised step can lift to about lr·1e-3 on a
near-zero gradient). VR-GCN's `history_bytes` equal and its final
history arrays within 1e-4·max(1, max|H|). `lhop_closure` and
`expansion_stats` are pure numpy and exactly equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core.gcn import GCNConfig as RefCfg
from repro.core.gcn import init_gcn as ref_init_gcn
from repro.graph.generators import make_dataset as ref_make_dataset
from repro.nn import optim as ref_optim
from repro_torch.core import baselines
from repro_torch.core.gcn import GCNConfig, params_from_numpy
from repro_torch.graph.generators import make_dataset
from repro_torch.nn import optim
from repro_torch.nn.tree import tree_leaves

TOL = 1e-4
DATA = {"multilabel": ("ppi", 0.03), "multiclass": ("reddit", 0.01)}
TRAINERS = {
    # name: (epochs, keyword arguments of both packages' trainer)
    "full_batch": (3, {}),
    "expansion_sgd": (2, dict(batch_size=64, node_cap=256)),
    "sage": (2, dict(batch_size=64)),
    "vrgcn": (2, dict(batch_size=64)),
}


@pytest.fixture(scope="module")
def graphs():
    return {k: (make_dataset(name, scale=s, seed=0),
                ref_make_dataset(name, scale=s, seed=0))
            for k, (name, s) in DATA.items()}


def _cfg_kw(graph, layernorm, num_layers):
    multilabel = graph.labels.ndim == 2
    out = graph.labels.shape[1] if multilabel else int(graph.labels.max()) + 1
    return dict(in_dim=graph.features.shape[1], hidden_dim=16, out_dim=out,
                num_layers=num_layers, dropout=0.0, multilabel=multilabel,
                layernorm=layernorm)


class _ZerosRecorder:
    """Stands in for a module's `np`: every array `zeros` makes is kept,
    so a test can read VR-GCN's history after training (neither package
    returns it)."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(np, name)

    def zeros(self, *args, **kwargs):
        arr = np.zeros(*args, **kwargs)
        self.made.append(arr)
        return arr


def _histories(rec, n, dims):
    return [a for a in rec.made
            if a.dtype == np.float32 and a.shape in {(n, d) for d in dims}]


def _run_both(monkeypatch, graphs, trainer, data, layernorm, num_layers):
    g, rg = graphs[data]
    kw = _cfg_kw(g, layernorm, num_layers)
    rcfg, pcfg = RefCfg(**kw), GCNConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray,
                                  ref_init_gcn(jax.random.PRNGKey(0), rcfg))
    monkeypatch.setattr(baselines, "init_gcn",
                        lambda cfg, generator, device:
                        params_from_numpy(tree, device))
    rrec, prec = _ZerosRecorder(), _ZerosRecorder()
    monkeypatch.setattr(ref_baselines, "np", rrec)
    monkeypatch.setattr(baselines, "np", prec)
    epochs, tkw = TRAINERS[trainer]
    fn = f"train_{trainer}"
    want = getattr(ref_baselines, fn)(rg, rcfg, ref_optim.adamw(1e-2),
                                      epochs, seed=0, **tkw)
    got = getattr(baselines, fn)(g, pcfg, optim.adamw(1e-2), epochs,
                                 seed=0, device="cpu", **tkw)
    return want, got, (rrec, prec), g, pcfg


@pytest.mark.parametrize("layernorm", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainer_matches_reference(monkeypatch, graphs, trainer, data,
                                   layernorm):
    num_layers = 3 if layernorm else 2
    want, got, (rrec, prec), g, cfg = _run_both(
        monkeypatch, graphs, trainer, data, layernorm, num_layers)
    assert sorted(got) == sorted(want)
    assert len(got["history"]) == len(want["history"])
    for a, b in zip(got["history"], want["history"]):
        assert a["epoch"] == b["epoch"]
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - b["loss"]) <= TOL * max(1.0, abs(b["loss"]))
    assert got["history"][-1]["loss"] < got["history"][0]["loss"]
    got_p = [t.detach().numpy() for t in tree_leaves(got["params"])]
    want_p = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        want["params"])]
    assert [p.shape for p in got_p] == [p.shape for p in want_p]
    for a, b in zip(got_p, want_p):
        assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(b).max())
    if trainer == "vrgcn":
        assert got["history_bytes"] == want["history_bytes"]
        dims = [d for _, d in cfg.dims][:-1]
        hg = _histories(prec, g.num_nodes, dims)
        hw = _histories(rrec, g.num_nodes, dims)
        assert len(hg) == len(hw) == num_layers - 1
        assert got["history_bytes"] == sum(h.nbytes for h in hg)
        for a, b in zip(hg, hw):
            assert np.abs(b).max() > 0          # the refresh wrote rows
            assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(b).max())


def test_full_batch_eval_score_matches_reference(monkeypatch, graphs):
    """eval_every: the val accuracy (host oracle in both packages)
    agrees."""
    g, rg = graphs["multiclass"]
    kw = _cfg_kw(g, True, 2)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_init_gcn(jax.random.PRNGKey(0), RefCfg(**kw)))
    monkeypatch.setattr(baselines, "init_gcn",
                        lambda cfg, generator, device:
                        params_from_numpy(tree, device))
    want = ref_baselines.train_full_batch(rg, RefCfg(**kw),
                                          ref_optim.adamw(1e-2), 2,
                                          eval_every=1)
    got = baselines.train_full_batch(g, GCNConfig(**kw), optim.adamw(1e-2),
                                     2, eval_every=1, device="cpu")
    for a, b in zip(got["history"], want["history"]):
        assert abs(a["val_score"] - b["val_score"]) <= 1e-3
    assert want["history"][-1]["val_score"] > 0


@pytest.mark.parametrize("L,cap", [(1, None), (2, None), (3, 100)])
def test_lhop_closure_equals_reference(graphs, L, cap):
    g, rg = graphs["multiclass"]
    batch = np.random.default_rng(L).choice(g.num_nodes, 32, replace=False)
    np.testing.assert_array_equal(baselines.lhop_closure(g, batch, L, cap),
                                  ref_baselines.lhop_closure(rg, batch, L,
                                                             cap))


@pytest.mark.parametrize("data", sorted(DATA))
def test_expansion_stats_equal_reference(graphs, data):
    g, rg = graphs[data]
    assert baselines.expansion_stats(g, 32, 2, trials=3, seed=4) == \
        ref_baselines.expansion_stats(rg, 32, 2, trials=3, seed=4)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainers_default_to_cuda_and_raise_without_gpu(no_gpu, graphs,
                                                        trainer):
    g, _ = graphs["multilabel"]
    cfg = GCNConfig(**_cfg_kw(g, False, 2))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        getattr(baselines, f"train_{trainer}")(g, cfg, optim.adamw(1e-2), 1)
