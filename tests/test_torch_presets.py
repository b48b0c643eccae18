"""Every synthetic GCN preset end to end in both packages, on the CPU.

One spec drives `build_experiment(spec).fit()` in the reference and in
the port, for `ppi_tiny`, `ppi_deep_tiny`, `reddit_tiny`,
`amazon2m_tiny`, `ppi_tiny_saint` and `reddit_tiny_saint`, each with
the default dense adjacency and with `batch.sparse_adj=true
model.fuse_spmm=true`: dropout 0, 2 epochs, the preset's own eval
cadence, and the reference's initial params injected into the port's
Engine (torch's init stream differs from jax's). Both packages build
the same graph, partition (or SAINT draws) and batches, so the
per-epoch loss and the final micro-F1 (multilabel) or accuracy
(multiclass) must agree:

* fp32: loss within 1e-4·max(1, |loss|), the metric within 1e-3.
* ppi_deep_tiny (bf16 compute, dynamic loss scaling): the bounds of
  tests/test_torch_train.py::test_scaled_step_matches_reference — each
  param within 2·lr per step taken, and the update p − p0 within 10% in
  L2 — with the loss within 2e-2·max(1, |loss|) (a flipped bf16
  rounding moves a logit by 2^-8 relative) and the metric within
  2e-2.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import experiment as ref_experiment
from repro_torch.core import experiment
from repro_torch.nn.tree import tree_leaves

PRESETS = ("ppi_tiny", "ppi_deep_tiny", "reddit_tiny", "amazon2m_tiny",
           "ppi_tiny_saint", "reddit_tiny_saint")
MODES = {"dense": {}, "sparse_fused": {"batch.sparse_adj": True,
                                       "model.fuse_spmm": True}}
EPOCHS = 2


def _spec(module, name, mode):
    spec = module.preset(name)
    spec.partition.cache = False
    spec.model.dropout = 0.0
    spec.run.epochs = EPOCHS
    spec.run.verbose = False
    for path, value in MODES[mode].items():
        sec, field = path.split(".")
        setattr(getattr(spec, sec), field, value)
    return spec


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _port_params(tree):
    return {"layers": [{k: torch.from_numpy(v.copy()) for k, v in l.items()}
                       for l in tree["layers"]]}


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in
            jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", PRESETS)
def test_preset_trains_like_reference(name, mode):
    ref = ref_experiment.build_experiment(_spec(ref_experiment, name, mode))
    # numpy copy first: the reference's step donates its params
    p0 = _numpy_tree(ref.engine.init_state()["params"])
    want = ref.fit()

    port = experiment.build_experiment(_spec(experiment, name, mode),
                                       device="cpu")
    backend = port.engine.backend
    port.engine.init_state = lambda: backend.init(
        _port_params(p0), torch.Generator().manual_seed(1))
    got = port.fit()

    assert type(port.batcher).__name__ == type(ref.batcher).__name__
    assert port.engine.global_step == ref.engine.global_step > 0
    assert len(got.history) == len(want.history) == EPOCHS
    bf16 = port.cfg.precision == "bf16"
    loss_tol, metric_tol = (2e-2, 2e-2) if bf16 else (1e-4, 1e-3)
    for a, b in zip(got.history, want.history):
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - b["loss"]) <= \
            loss_tol * max(1.0, abs(b["loss"]))
    assert "val_score" in want.history[-1]
    assert abs(got.history[-1]["val_score"]
               - want.history[-1]["val_score"]) <= metric_tol

    g_leaves = [t.detach().float().numpy()
                for t in tree_leaves(got.params)]
    w_leaves = _leaves(want.params)
    assert [x.shape for x in g_leaves] == [x.shape for x in w_leaves]
    if bf16:
        lr, steps = port.spec.optim.lr, port.engine.global_step
        for a, b in zip(g_leaves, w_leaves):
            assert np.abs(a - b).max() <= 2 * lr * steps
        num = sum(float(((a - b) ** 2).sum())
                  for a, b in zip(g_leaves, w_leaves))
        den = sum(float(((b - c) ** 2).sum())
                  for b, c in zip(w_leaves, _leaves(p0)))
        assert np.sqrt(num / den) <= 0.1
    else:
        for a, b in zip(g_leaves, w_leaves):
            assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max())
