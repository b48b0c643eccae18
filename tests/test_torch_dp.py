"""The port's data-parallel Cluster-GCN against the reference, on the CPU.

The reference runs on a forced 2-device CPU host in one subprocess for
this module; the port runs on a gloo world of 2 CPU ranks in one spawn
for this module (tests/_torch_dist.py), each with its own timeout.
Dropout is 0 everywhere: `jax.random` cannot be reproduced in torch.

* `_dp_groups`: the same groups, in the same order, as the reference's
  on a stream that mixes two K buckets (k_slots "auto" and "cap") and
  reuses tile buffers, for groups of 2, 3 and 4.
* The bare step: `make_gcn_train_step` on 2 ranks against the
  reference's on a 2-device mesh, from the same params (through numpy)
  on the same stacked batches, dense and block-ELL/fused, compression
  None/"bf16"/8/4, microbatches 1 and 2, 3 steps. Each step's loss
  within 1e-5 relative and aux (tp/fp/fn/n) within 1e-3 of a count;
  the final params, AdamW moments and each rank's error-feedback
  residual row within 1e-4·max(1, max|ref|) per leaf (fp32 summation
  order in the products and the all-reduce, through 3 AdamW steps).
  For int8/int4 up to 1% of a leaf's elements may exceed that, where
  fp32 noise tips a value across a rounding tie of the quantizer: such
  an element's code moves one level, its residual by one quantization
  step (asserted at most 1.01 × twice the leaf's largest residual; a
  step is at least twice the largest residual of its group) and its
  param by at most 2·lr per step (AdamW moves a param by about lr).
* `build_experiment` with execution.data_shards=2 against the
  reference's, 3 epochs of ppi_tiny (block-ELL, fused): compression None
  with 1 microbatch, and int8 with 2 microbatches. Epoch losses within
  1e-4·max(1, |loss|) (None) and 1e-3 (int8), the final val micro-F1
  within 1e-3 (None) and 2e-2 (int8), the final state as above.
* Resume: a run stopped mid-epoch and one stopped at an epoch boundary,
  each resumed from its checkpoint, end bitwise equal to the straight
  run on every rank: params, AdamW state, the rank's residual row and
  the generator; the same history.
* Checkpoints cross: the reference's data-parallel checkpoint restores
  into the port's state tree and the port's into the reference's,
  equal to the last bit under the same keys ("dist/params/...",
  "dist/opt/.mu/...", "dist/err/..." with the rank axis first).
* In process: a world of 1 trains bitwise like the single device; the
  CLI runs data_shards=1 without torchrun and refuses 2; "cuda" means
  cuda:$LOCAL_RANK.
"""
import json

import numpy as np
import pytest
import torch

from _torch_dist import (npz_params, params_npz, run_plan,
                         run_reference, save_batches)

LAYOUTS = ("dense", "sparse")
COMPRESSIONS = (None, "bf16", 8, 4)
MICROBATCHES = (1, 2)
CASES = [(layout, comp, m) for layout in LAYOUTS for comp in COMPRESSIONS
         for m in MICROBATCHES]
STEPS = 3
LR = 1e-2
WORLD = 2
EXPERIMENTS = {"exact": {"execution.compression": None,
                         "execution.microbatches": 1},
               "int8_mb2": {"execution.compression": 8,
                            "execution.microbatches": 2}}
RESUMES = {"mid_epoch": 3, "epoch_boundary": 2}   # 2 steps an epoch


def _cfgs():
    base = dict(in_dim=50, hidden_dim=16, out_dim=121, num_layers=2,
                dropout=0.0, multilabel=True)
    return {"dense": base, "sparse": dict(base, fuse_spmm=True)}


def _spec(name, **sets):
    from repro_torch.core.experiment import apply_overrides, preset
    spec = preset("ppi_tiny")
    spec.name = name
    spec.partition.cache = False
    spec.model.dropout = 0.0
    spec.run.epochs = 3
    spec.run.eval_every = 3
    spec.run.verbose = False
    spec.batch.sparse_adj = True
    spec.model.fuse_spmm = True
    spec.execution.data_shards = WORLD
    return apply_overrides(spec, sets)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Inputs of every comparison, written once: the stacked batches and
    params of the bare step, and the specs of the experiment runs."""
    import jax
    from repro.core.gcn import GCNConfig as RefCfg
    from repro.core.gcn import init_gcn
    from repro_torch.core.batching import ClusterBatcher
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.partition import partition_graph
    d = tmp_path_factory.mktemp("dp")
    g = make_dataset("ppi", scale=0.03, seed=0)
    parts, _ = partition_graph(g, 8, method="metis", seed=0, cache=False)
    arrays = {"cfgs": np.array(json.dumps(_cfgs()))}
    n = STEPS * WORLD * max(MICROBATCHES)
    for layout in LAYOUTS:
        b = ClusterBatcher(g, parts, clusters_per_batch=1, seed=0,
                           sparse_adj=layout == "sparse")
        batches = [x.astuple() for e in range(-(-n // 8))
                   for x in b.epoch(e)][:n]
        save_batches(arrays, layout, batches)
    p0 = init_gcn(jax.random.PRNGKey(0), RefCfg(**_cfgs()["dense"]))
    arrays.update({"p0_" + k: np.asarray(v) for k, v in
                   params_npz(jax.tree_util.tree_map(np.asarray,
                                                     p0)).items()})
    np.savez(d / "inputs.npz", **arrays)
    for name, sets in EXPERIMENTS.items():
        (d / f"{name}.json").write_text(_spec(name, **sets).to_json())
    (d / "resume.json").write_text(_spec(
        "resume", **{"execution.compression": 8, "run.eval_every": 0,
                     "run.checkpoint_dir": str(d / "port_ck")}).to_json())
    return d


REFERENCE = r"""
import json, pathlib, sys
import jax, jax.numpy as jnp, numpy as np
from _torch_dist import ADJ_FIELDS, load_batches, npz_params, params_npz
from repro.core.experiment import ExperimentSpec, build_experiment
from repro.core.gcn import GCNConfig
from repro.dist.steps import init_gcn_train_state, make_gcn_train_step
from repro.kernels.block_spmm import BlockEllAdj
from repro.nn import optim

d = pathlib.Path(WORK)
data = np.load(d / "inputs.npz")
cfgs = json.loads(str(data["cfgs"]))
p0 = npz_params({k[3:]: data[k] for k in data.files if k.startswith("p0_")})
from repro.runtime.checkpoint import _flatten_with_paths
mesh = jax.make_mesh((2,), ("data",))
leaves = lambda t: {k: np.asarray(v) for k, v in _flatten_with_paths(t)}
for layout, comp, m in CASES:
    cfg = GCNConfig(**cfgs[layout])
    opt = optim.adamw(LR)
    n = STEPS * 2 * m
    batches = load_batches(data, layout, n, lambda f: BlockEllAdj(
        *(f[k] for k in ADJ_FIELDS)))
    step = make_gcn_train_step(cfg, opt, mesh, compression=comp,
                               microbatches=m)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = init_gcn_train_state(params, opt, 2, comp)
    out = {}
    for s in range(STEPS):
        group = batches[s * 2 * m:(s + 1) * 2 * m]
        stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *group)
        state, loss, aux = step(state, jax.random.PRNGKey(0), stacked)
        out[f"loss_{s}"] = np.asarray(loss)
        for k, v in aux.items():
            out[f"aux_{s}_{k}"] = np.asarray(v)
    for k, v in leaves(state).items():
        out["state__" + k.replace("/", "__")] = v
    np.savez(d / f"ref_{layout}_{comp}_{m}.npz", **out)
for name in EXPERIMENTS:
    spec = ExperimentSpec.from_json((d / f"{name}.json").read_text())
    if name == "int8_mb2":
        spec.run.checkpoint_dir = str(d / "ref_ck")
    exp = build_experiment(spec)
    p = jax.tree_util.tree_map(np.asarray,
                               exp.engine.init_state()["dist"]["params"])
    np.savez(d / f"ref_{name}_p0.npz", **params_npz(p))
    res = exp.fit()
    state = exp.engine.state["dist"]
    np.savez(d / f"ref_{name}_state.npz", **{
        k.replace("/", "__"): v for k, v in leaves(state).items()})
    (d / f"ref_{name}.json").write_text(json.dumps(
        {"history": res.history, "global_step": exp.engine.global_step}))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(work):
    code = (f"WORK = {str(work)!r}\nCASES = {CASES!r}\nSTEPS = {STEPS}\n"
            f"LR = {LR}\nEXPERIMENTS = {list(EXPERIMENTS)!r}\n" + REFERENCE)
    assert "REF_OK" in run_reference(code, timeout=600)
    return work


@pytest.fixture(scope="module")
def port(reference):
    d = reference
    tasks = [{"kind": "steps", "inputs": str(d / "inputs.npz"),
              "cases": CASES, "steps": STEPS, "lr": LR,
              "out": str(d / "port_steps")}]
    tasks += [{"kind": "experiment", "spec": str(d / f"{name}.json"),
               "p0": str(d / f"ref_{name}_p0.npz"),
               "out": str(d / f"port_{name}")} for name in EXPERIMENTS]
    tasks.append({"kind": "experiment", "spec": str(d / "resume.json"),
                  "out": str(d / "resume_straight")})
    for tag, stop in RESUMES.items():
        spec = json.loads((d / "resume.json").read_text())
        spec["run"]["checkpoint_dir"] = str(d / f"ck_{tag}")
        (d / f"resume_{tag}.json").write_text(json.dumps(spec))
        tasks.append({"kind": "experiment",
                      "spec": str(d / f"resume_{tag}.json"),
                      "stop_at": stop, "out": str(d / f"stopped_{tag}")})
        tasks.append({"kind": "experiment",
                      "spec": str(d / f"resume_{tag}.json"),
                      "resume": True, "out": str(d / f"resumed_{tag}")})
    spec = json.loads((d / "resume.json").read_text())
    spec["run"]["checkpoint_dir"] = str(d / "ck_one_rank")
    (d / "stop_one_rank.json").write_text(json.dumps(spec))
    tasks.append({"kind": "experiment", "spec": str(d / "stop_one_rank.json"),
                  "stop_at": 3, "stop_rank": 1,
                  "out": str(d / "stopped_one_rank")})
    tasks.append({"kind": "wrapper", "spec": str(d / "exact.json"),
                  "out": str(d / "wrapper")})
    run_plan(tasks, d, world=WORLD, timeout=600)
    return d


# ----------------------------------------------------------------------
# _dp_groups
# ----------------------------------------------------------------------
def _mixed_stream(batchers, epoch, n, snapshot=lambda b: b):
    """Alternating batches of the given batchers (two K buckets), n in
    all (not a multiple of any group size, so the wrap-around fill
    runs). `snapshot` copies each batch as it is built, before a pooled
    builder recycles its buffers."""
    its = [b.epoch(epoch) for b in batchers]
    out = []
    while len(out) < n:
        for it in its:
            out.append(snapshot(next(it).astuple()))
    return out[:n]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_dp_groups_match_reference(n):
    import jax
    from repro.core import engine as ref_engine
    from repro.core.batching import ClusterBatcher as RefBatcher
    from repro.graph import make_dataset as ref_make_dataset
    from repro.graph import partition_graph as ref_partition
    from repro_torch.core.batching import ClusterBatcher
    from repro_torch.core.engine import _dp_groups
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.partition import partition_graph

    def batchers(make, part, cls):
        g = make("reddit", scale=0.02, seed=0)
        parts, _ = part(g, 5, method="metis", seed=0, cache=False)
        return [cls(g, parts, clusters_per_batch=1, seed=0, sparse_adj=True,
                    k_slots=k, reuse_tile_buffers=True)
                for k in ("auto", "cap")]
    # the reference's pooled tile buffers recycle within these 9
    # batches; the port's compact payloads own their buffers
    ref = _mixed_stream(batchers(ref_make_dataset, ref_partition,
                                 RefBatcher), 0, 9,
                        lambda b: jax.tree_util.tree_map(np.copy, b))
    got = _mixed_stream(batchers(make_dataset, partition_graph,
                                 ClusterBatcher), 0, 9)
    ref_groups = list(ref_engine._dp_groups(iter(ref), n))
    got_groups = list(_dp_groups(iter(got), n))
    assert len({b[0].shape for b in got}) == 2            # two buckets
    assert [len(g) for g in got_groups] == [len(g) for g in ref_groups]
    for rg, gg in zip(ref_groups, got_groups):
        assert len(gg) == n
        assert len({b[0].shape for b in gg}) == 1         # one K a group
        for rb, gb in zip(rg, gg):
            tiles = gb[0].to("cpu").blocks       # the compact adjacency's
            assert tuple(tiles.shape) == tuple(rb[0].blocks.shape)
            np.testing.assert_array_equal(tiles.numpy(),
                                          np.asarray(rb[0].blocks))
            np.testing.assert_array_equal(gb[1], rb[1])      # features
            assert int(gb[5]) == int(rb[5])                  # num_real


# ----------------------------------------------------------------------
# the bare step
# ----------------------------------------------------------------------
def _within(got, want, tol, tipped=0.0, cap=None):
    """|got − want| <= tol·max(1, max|want|) elementwise, except that a
    share `tipped` of the elements may exceed it (a quantizer tie tipped
    by fp32 noise), by at most `cap` when given."""
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert (diff > bound).mean() <= tipped, (diff.max(), bound)
    if cap is not None:
        assert diff.max() <= max(bound, cap)


@pytest.mark.parametrize("layout,comp,m", CASES,
                         ids=[f"{l}-{c}-mb{m}" for l, c, m in CASES])
def test_step_matches_reference(port, layout, comp, m):
    ref = np.load(port / f"ref_{layout}_{comp}_{m}.npz")
    ranks = [np.load(port / "port_steps" / f"{layout}_{comp}_{m}_rank{r}.npz")
             for r in range(WORLD)]
    got = ranks[0]
    for s in range(STEPS):
        for r in ranks[1:]:              # every rank holds the same
            assert float(r[f"loss_{s}"]) == float(got[f"loss_{s}"])
        want = float(ref[f"loss_{s}"])
        assert abs(float(got[f"loss_{s}"]) - want) <= 1e-5 * abs(want)
        for k in ("tp", "fp", "fn", "n"):
            assert abs(float(got[f"aux_{s}_{k}"])
                       - float(ref[f"aux_{s}_{k}"])) <= 1e-3
    quantized = isinstance(comp, int)
    tipped = 0.01 if quantized else 0.0
    keys = [k for k in ref.files if k.startswith("state__")]
    assert keys and all(k in got.files for k in keys)
    for key in keys:
        want = ref[key]
        if "__err__" in key:
            # rank r owns row r; a tipped tie moves a residual by one
            # quantization step, which is at least twice the largest
            # residual
            for r, rank in enumerate(ranks):
                step = 2.0 * float(np.abs(want[r]).max())
                _within(rank[key], want[r], 1e-4, tipped, 1.01 * step)
            continue
        cap = 2 * LR * STEPS if "__params__" in key else None
        _within(got[key], want, 1e-4, tipped, cap)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], got[key])


# ----------------------------------------------------------------------
# build_experiment, resume, checkpoints
# ----------------------------------------------------------------------
def _strip(history):
    return [{k: v for k, v in h.items() if k not in ("time", "flagged_steps")}
            for h in history]


def _own_rows(state, rank):
    """A rank's saved Engine state with the residual stacks cut to its
    own row (the other rows are the other ranks')."""
    return {k: (v[rank] if "__err__" in k else v) for k, v in state.items()}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_build_experiment_matches_reference(port, name):
    ref = json.loads((port / f"ref_{name}.json").read_text())
    got = json.loads((port / f"port_{name}" / "result.json").read_text())
    assert got["global_step"] == ref["global_step"] > 0
    exact = EXPERIMENTS[name]["execution.compression"] is None
    loss_tol, f1_tol = (1e-4, 1e-3) if exact else (1e-3, 2e-2)
    assert len(got["history"]) == len(ref["history"]) == 3
    for a, b in zip(got["history"], ref["history"]):
        assert abs(a["loss"] - b["loss"]) <= loss_tol * max(1, abs(b["loss"]))
    assert abs(got["history"][-1]["val_score"]
               - ref["history"][-1]["val_score"]) <= f1_tol
    want = np.load(port / f"ref_{name}_state.npz")
    for r in range(WORLD):
        state = _own_rows(dict(np.load(port / f"port_{name}"
                                       / f"state_{r}.npz")), r)
        for key in want.files:
            w = want[key][r] if key.startswith("err__") else want[key]
            _within(state["dist__" + key], w, 1e-4,
                    0.0 if exact else 0.01,
                    2 * LR * 6 if key.startswith("params__") else None)


@pytest.mark.parametrize("tag", sorted(RESUMES))
def test_resume_matches_straight_run(port, tag):
    stopped = json.loads((port / f"stopped_{tag}" / "result.json")
                         .read_text())
    assert stopped["preempted"]
    assert stopped["global_step"] == RESUMES[tag]
    a = json.loads((port / "resume_straight" / "result.json").read_text())
    b = json.loads((port / f"resumed_{tag}" / "result.json").read_text())
    assert not b["preempted"]
    assert b["global_step"] == a["global_step"] == 6
    assert _strip(a["history"]) == _strip(b["history"])
    for r in range(WORLD):
        sa = _own_rows(dict(np.load(port / "resume_straight"
                                    / f"state_{r}.npz")), r)
        sb = _own_rows(dict(np.load(port / f"resumed_{tag}"
                                    / f"state_{r}.npz")), r)
        assert sa.keys() == sb.keys()
        assert any("__err__" in k for k in sa)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_stop_on_one_rank_stops_every_rank(port):
    """A stop only rank 1 asks for (a preemption signal it alone saw)
    reaches rank 0 through the all-reduced flag, at the same step, and
    the checkpoint rank 0 writes is that step's."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    got = json.loads((port / "stopped_one_rank" / "result.json")
                     .read_text())
    assert got["preempted"] and got["global_step"] == 3
    assert got["stop_reason"] == "stop requested on another rank"
    assert CheckpointManager(str(port / "ck_one_rank")).latest_step() == 3
    for r in range(WORLD):
        state = np.load(port / "stopped_one_rank" / f"state_{r}.npz")
        assert int(state["dist__opt__.step"]) == 3


def test_train_cluster_gcn_with_a_group_matches_the_spec_engine(port):
    """`train_cluster_gcn(..., mesh=group)` — the reference's mesh= surface
    with the process group in the mesh's place — trains bitwise like
    build_experiment with execution.data_shards."""
    got = json.loads((port / "wrapper" / "result.json").read_text())
    assert got == {"same_history": True, "same_params": True, "epochs": 3}


def test_elastic_plan_matches_reference():
    from repro.runtime import ElasticPlan as RefPlan
    from repro_torch.runtime import ElasticPlan
    for old, healthy in ((512, 300), (512, 512), (8, 3), (2, 1)):
        a, b = ElasticPlan.plan(old, healthy), RefPlan.plan(old, healthy)
        assert (a.new_devices, a.new_mesh_shape, a.batch_adjustment,
                a.microbatch_multiplier()) == (
            b.new_devices, b.new_mesh_shape, b.batch_adjustment,
            b.microbatch_multiplier())


def _port_template(p0, world, comp):
    from repro_torch.dist.steps import init_gcn_train_state
    from repro_torch.nn import optim
    params = {"layers": [{k: torch.from_numpy(np.array(v))
                          for k, v in layer.items()}
                         for layer in p0["layers"]]}
    return init_gcn_train_state(params, optim.adamw(LR), world, comp)


def test_reference_checkpoint_restores_into_port(port):
    from repro_torch.nn.tree import tree_leaves
    from repro_torch.runtime.checkpoint import (CheckpointManager,
                                                _flatten_with_paths)
    p0 = npz_params(np.load(port / "ref_int8_mb2_p0.npz"))
    template = _port_template(p0, WORLD, 8)
    mgr = CheckpointManager(str(port / "ref_ck"))
    step = mgr.latest_valid_step()
    assert step == 3
    want = np.load(port / "ref_int8_mb2_state.npz")
    for sub in ("params", "opt", "err"):
        tree, _ = mgr.restore_subtree(template[sub], f"dist/{sub}",
                                      step=step)
        flat = dict(_flatten_with_paths(tree))
        assert len(flat) == len(tree_leaves(template[sub]))
        for k, v in flat.items():
            np.testing.assert_array_equal(
                v.numpy(), want[f"{sub}/{k}".replace("/", "__")])


def test_port_checkpoint_restores_into_reference(port):
    import jax
    import jax.numpy as jnp
    from repro.dist.steps import init_gcn_train_state as ref_init
    from repro.nn import optim as ref_optim
    from repro.runtime.checkpoint import CheckpointManager as RefManager
    from repro.runtime.checkpoint import _flatten_with_paths as ref_flat
    ck = port / "ck_mid_epoch"
    mgr = RefManager(str(ck))
    step = mgr.latest_valid_step()
    assert step == 6
    p0 = npz_params(np.load(port / "ref_exact_p0.npz"))
    template = ref_init(jax.tree_util.tree_map(jnp.asarray, p0),
                        ref_optim.adamw(LR), WORLD, 8)
    states = [dict(np.load(port / f"resumed_mid_epoch/state_{r}.npz"))
              for r in range(WORLD)]
    for sub in ("params", "opt", "err"):
        tree, _ = mgr.restore_subtree(template[sub], f"dist/{sub}",
                                      step=step)
        for k, v in ref_flat(tree):
            key = f"dist__{sub}__{k.replace('/', '__')}"
            if sub == "err":    # the rank axis first, one row per rank
                for r in range(WORLD):
                    np.testing.assert_array_equal(np.asarray(v)[r],
                                                  states[r][key][r])
            else:
                np.testing.assert_array_equal(np.asarray(v),
                                              states[0][key])


def test_step_rejects_bad_arguments():
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.dist.steps import make_gcn_train_step
    from repro_torch.nn import optim
    cfg = GCNConfig(**_cfgs()["dense"])
    for kw, match in (({"compression": 16}, "compression"),
                      ({"microbatches": 0}, "microbatches"),
                      ({"compression": 8, "compression_group_size": 0},
                       "group_size")):
        with pytest.raises(ValueError, match=match):
            make_gcn_train_step(cfg, optim.adamw(LR), None, **kw)


# ----------------------------------------------------------------------
# a world of one, in process
# ----------------------------------------------------------------------
@pytest.fixture
def world_of_one():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_equals_single_device(world_of_one):
    """data_shards=1 over a world of one: the all-reduce of one rank is
    the identity, so the run is bitwise the single-device run."""
    from repro_torch.core.experiment import build_experiment
    from repro_torch.nn.tree import tree_leaves
    runs = {}
    for shards in (None, 1):
        exp = build_experiment(_spec(f"one_{shards}", **{
            "execution.data_shards": shards}), device="cpu")
        if shards is None:
            params = exp.engine.init_state()["params"]
        backend = exp.engine.backend
        exp.engine.init_state = lambda b=backend: b.init(
            params, torch.Generator().manual_seed(1))
        runs[shards] = (exp.fit(), exp)
    (single, _), (dp, exp) = runs[None], runs[1]
    assert type(exp.engine.backend).__name__ == "DataParallelBackend"
    assert exp.engine.backend.group_size == 1
    assert _strip(dp.history) == _strip(single.history)
    for a, b in zip(tree_leaves(dp.params), tree_leaves(single.params)):
        assert torch.equal(a, b)


def test_cli_runs_data_shards_one_without_torchrun(tmp_path, monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch import run_experiment
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc = run_experiment.main([
        "--preset", "ppi_tiny", "--device", "cpu",
        "--results-dir", str(tmp_path),
        "--set", "execution.data_shards=1", "--set", "run.epochs=1",
        "--set", "partition.cache=false"])
    assert rc == 0 and not dist.is_initialized()
    metrics = json.loads((tmp_path / "ppi_tiny" / "metrics.json")
                         .read_text())
    assert metrics["global_step"] == 4 and metrics["device"] == "cpu"
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        run_experiment.main(["--preset", "ppi_tiny", "--device", "cpu",
                             "--set", "execution.data_shards=2"])


def test_rank_device(monkeypatch):
    from repro_torch.device import rank_device
    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert rank_device("cuda") == torch.device("cuda", 1)
    assert rank_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        rank_device("cuda")
