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

Two more runs, under the fp32 bounds:
* `ppi_real_tiny` on a GraphSAGE-format archive served through a
  `file://` mirror (tests/test_datasets.py's fixture writer; the recipe
  cut to 4 parts and hidden 16 for the 120-node graph, never the data).
* `reddit_tiny` (dense, multiclass) with execution.data_shards=2 and the
  bf16 all-reduce: the reference on a 2-device CPU host in a
  subprocess, the port on 2 gloo CPU ranks (tests/_torch_dist.py).
  bf16 rounding of the synced gradients can flip on fp32 noise (2^-8
  of one element); measured well inside the fp32 bounds.
"""
import json

import jax
import numpy as np
import pytest
import torch

from _torch_dist import npz_params, run_plan, run_reference
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


def _fit_both(name, mode, overrides=None):
    """The reference's and the port's fit() of one spec, the port from
    the reference's initial params; returns (spec, steps, p0, port
    history, port params, reference history, reference params)."""
    specs = [_spec(m, name, mode) for m in (ref_experiment, experiment)]
    for spec, module in zip(specs, (ref_experiment, experiment)):
        module.apply_overrides(spec, overrides or {})
    ref = ref_experiment.build_experiment(specs[0])
    # numpy copy first: the reference's step donates its params
    p0 = _numpy_tree(ref.engine.init_state()["params"])
    want = ref.fit()

    port = experiment.build_experiment(specs[1], device="cpu")
    backend = port.engine.backend
    port.engine.init_state = lambda: backend.init(
        _port_params(p0), torch.Generator().manual_seed(1))
    got = port.fit()
    assert type(port.batcher).__name__ == type(ref.batcher).__name__
    assert port.engine.global_step == ref.engine.global_step > 0
    return (port.spec, port.engine.global_step, p0, got.history,
            [t.detach().float().numpy() for t in tree_leaves(got.params)],
            want.history, _leaves(want.params))


def _compare(spec, steps, p0, got, g_leaves, want, w_leaves, epochs):
    assert len(got) == len(want) == epochs
    bf16 = spec.model.precision == "bf16"
    loss_tol, metric_tol = (2e-2, 2e-2) if bf16 else (1e-4, 1e-3)
    for a, b in zip(got, want):
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - b["loss"]) <= \
            loss_tol * max(1.0, abs(b["loss"]))
    assert "val_score" in want[-1]
    assert abs(got[-1]["val_score"] - want[-1]["val_score"]) <= metric_tol
    assert [x.shape for x in g_leaves] == [x.shape for x in w_leaves]
    if bf16:
        lr = spec.optim.lr
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


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", PRESETS)
def test_preset_trains_like_reference(name, mode):
    _compare(*_fit_both(name, mode), EPOCHS)


def test_real_preset_trains_like_reference(tmp_path, monkeypatch):
    from test_datasets import make_ppi_zip
    make_ppi_zip(tmp_path / "ppi.zip")
    monkeypatch.setenv("REPRO_DATASETS_MIRROR", tmp_path.as_uri())
    monkeypatch.setenv("REPRO_DATASETS_CACHE", str(tmp_path / "cache"))
    # the fixture graph is 120 nodes: shrink the recipe, never the data
    over = {"partition.num_parts": 4, "model.hidden_dim": 16,
            "run.eval_every": 1}
    run = _fit_both("ppi_real_tiny", "sparse_fused", over)
    assert run[0].data.name == "ppi_real"
    _compare(*run, EPOCHS)


REFERENCE_DP = r"""
import json, pathlib
import jax, numpy as np
from _torch_dist import params_npz
from repro.core.experiment import ExperimentSpec, build_experiment
d = pathlib.Path(WORK)
exp = build_experiment(ExperimentSpec.from_json((d / "spec.json").read_text()))
p0 = jax.tree_util.tree_map(np.asarray,
                            exp.engine.init_state()["dist"]["params"])
np.savez(d / "p0.npz", **params_npz(p0))
res = exp.fit()
np.savez(d / "final.npz", **params_npz(
    jax.tree_util.tree_map(np.asarray, res.params)))
(d / "ref.json").write_text(json.dumps({
    "history": res.history, "global_step": exp.engine.global_step}))
print("REF_OK")
"""


def test_data_parallel_preset_trains_like_reference(tmp_path):
    spec = _spec(experiment, "reddit_tiny", "dense")
    spec.execution.data_shards = 2
    spec.execution.compression = "bf16"
    (tmp_path / "spec.json").write_text(spec.to_json())
    out = run_reference(f"WORK = {str(tmp_path)!r}\n" + REFERENCE_DP)
    assert "REF_OK" in out
    run_plan([{"kind": "experiment", "spec": str(tmp_path / "spec.json"),
               "p0": str(tmp_path / "p0.npz"),
               "out": str(tmp_path / "port")}], tmp_path, world=2)
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port" / "result.json").read_text())
    assert got["global_step"] == want["global_step"] > 0
    state = np.load(tmp_path / "port" / "state_0.npz")
    g_leaves = [state[k] for k in sorted(state.files)
                if k.startswith("dist__params__")]
    w = npz_params(np.load(tmp_path / "final.npz"))
    w_leaves = _leaves(w)
    p0 = npz_params(np.load(tmp_path / "p0.npz"))
    _compare(spec, got["global_step"], p0, got["history"], g_leaves,
             want["history"], w_leaves, EPOCHS)
