"""The port's sharding rules and sharded LM train step against the
reference (`repro.dist.sharding`, `repro.models.spec`).

`make_rules` and `pspec_tree` are pure logic: they must equal the
reference's for every arch × shape × policy on stub meshes. The local
shard shapes are checked on a fake 16 × 16 mesh (torch.distributed's
"fake" backend in this process, no ranks behind it). The sharded train,
prefill and decode steps run on 2 gloo ranks (tests/_torch_dist.py)
from the reference's params and tokens, and are held against the port's
unsharded steps and against the reference's 1-device steps on the same
inputs: the reference's own sharded step fails on jax 0.9 (ROADMAP C,
R3).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist
from repro.configs import get_arch as ref_get_arch
from repro.dist.sharding import CellPolicy as RefPolicy
from repro.dist.sharding import make_rules as ref_make_rules
from repro.nn.optim import adamw as ref_adamw
from repro.dist.steps import make_train_step as ref_make_train_step
from repro.dist.steps import spec_train_state as ref_spec_train_state
from repro.models.lm import decode_step as ref_decode_step
from repro.models.lm import prefill as ref_prefill
from repro.models.lm import spec_caches as ref_spec_caches
from repro.models.lm import spec_params as ref_spec_params
from repro.models.spec import init_tree as ref_init_tree
from repro.models.spec import pspec_tree as ref_pspec_tree
from repro.models.spec import shape_tree as ref_shape_tree
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.dist.sharding import (CellPolicy, fake_tree, local_shape,
                                       make_rules, placements, replicated,
                                       shardings_for)
from repro_torch.dist.steps import spec_train_state
from repro_torch.launch.mesh import axis_size
from repro_torch.models.config import SHAPES
from repro_torch.models.lm import spec_caches, spec_params
from repro_torch.models.spec import is_pspec, is_spec, pspec_tree, shape_tree
from repro_torch.nn.tree import tree_leaves
from repro_torch.runtime.checkpoint import _flatten_with_paths

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "debug": ((2, 2), ("data", "model"))}


@dataclasses.dataclass(frozen=True)
class _PortStub:
    """What the port's rules read of a DeviceMesh."""
    shape: tuple
    mesh_dim_names: tuple


class _RefStub:
    """What the reference's rules read of a jax Mesh."""
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _trees(cfg, shape, ref: bool):
    sp, sc = (ref_spec_params, ref_spec_caches) if ref else \
        (spec_params, spec_caches)
    return [sp(cfg), sc(cfg, shape.global_batch, shape.seq_len)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_and_pspecs_match_reference(arch, mesh):
    """Every shape × fsdp off/on: the rules dict, and each param and
    cache leaf's spec tuple against `tuple(PartitionSpec)`."""
    shp, names = MESHES[mesh]
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    for shape_name, shape in SHAPES.items():
        for fsdp in (False, True):
            rules = make_rules(_PortStub(shp, names), cfg, shape,
                               CellPolicy(fsdp=fsdp))
            want = ref_make_rules(_RefStub(shp, names), rcfg, shape,
                                  RefPolicy(fsdp=fsdp))
            assert rules == want, (shape_name, fsdp)
            for mine, theirs in zip(_trees(cfg, shape, False),
                                    _trees(rcfg, shape, True)):
                got = tree_leaves(pspec_tree(mine, rules), is_leaf=is_pspec)
                ref = jax.tree_util.tree_leaves(
                    ref_pspec_tree(theirs, want),
                    is_leaf=lambda x: isinstance(x, P))
                assert len(got) == len(ref)
                assert got == [tuple(p) for p in ref], (shape_name, fsdp)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shape_tree_matches_reference_on_meta(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    shape = SHAPES["decode_32k"]
    for mine, theirs in zip(_trees(cfg, shape, False),
                            _trees(rcfg, shape, True)):
        got = tree_leaves(shape_tree(mine))
        ref = jax.tree_util.tree_leaves(ref_shape_tree(theirs))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(r.shape)
            assert str(g.dtype).replace("torch.", "") == \
                jnp.dtype(r.dtype).name
    assert all(is_spec(s) for s in tree_leaves(spec_params(cfg)))
    assert not is_spec(tree_leaves(shape_tree(spec_params(cfg)))[0])


def test_placements_shard_a_dim_over_every_axis_its_entry_names():
    from torch.distributed.tensor import Replicate, Shard
    stub = _PortStub(*MESHES["multipod"])
    assert placements((("pod", "data"), None, "model"), stub) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), stub) == \
        (Replicate(), Shard(1), Replicate())
    assert placements((), stub) == (Replicate(),) * 3 == \
        replicated(stub).placements
    # one mesh axis on two dims: the first dim takes it
    assert placements((None, "model", "model"), stub) == \
        (Replicate(), Replicate(), Shard(1))


@pytest.fixture(scope="module")
def fake_pod():
    """The production (16, 16) mesh over a fake world of 256 ranks in
    this process (rank 0), torn down after the module."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(256)
    try:
        yield make_production_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,fsdp", [("llama3.2-1b", True),
                                       ("dbrx-132b", True),
                                       ("gemma3-1b", False)])
def test_local_shards_on_a_fake_pod_mesh(fake_pod, arch, fsdp):
    """Each leaf of the train state (and of the decode caches) is a
    DTensor of the global shape whose local shard is the global shape
    with every sharded dim divided by its mesh axes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    cfg = get_arch(arch)
    shape = SHAPES["train_4k"]
    rules = make_rules(fake_pod, cfg, shape, CellPolicy(fsdp=fsdp))
    trees = [spec_train_state(cfg),
             spec_caches(cfg, SHAPES["decode_32k"].global_batch,
                         SHAPES["decode_32k"].seq_len)]
    sharded = 0
    for specs in trees:
        with FakeTensorMode():
            made = fake_tree(specs, shardings_for(specs, fake_pod, rules))
        specs_l = tree_leaves(specs)
        pspecs = tree_leaves(pspec_tree(specs, rules), is_leaf=is_pspec)
        for s, p, t in zip(specs_l, pspecs, tree_leaves(made)):
            assert isinstance(t, DTensor)
            assert tuple(t.shape) == s.shape and t.dtype == s.dtype
            want = tuple(d // axis_size(fake_pod, e)
                         for d, e in zip(s.shape, p))
            assert tuple(t.to_local().shape) == want == local_shape(
                s.shape, shardings_for({"x": s}, fake_pod, rules)["x"])
            sharded += want != s.shape
    assert sharded > 0


# ----------------------------------------------------------------------
# the sharded step on 2 gloo ranks
# ----------------------------------------------------------------------
CASES = {"data2_fsdp": dict(arch="llama3.2-1b", mesh=[2, 1], fsdp=True,
                            microbatches=2, batch=4, seq=32),
         "model2": dict(arch="llama3.2-1b", mesh=[1, 2], fsdp=False,
                        microbatches=1, batch=4, seq=32),
         # the MoE FFN: experts over 'model' (one dispatch row, B·T ≤
         # 512), and per-row dispatch with capacity over 'data' (B·T 1024)
         "moe_model2": dict(arch="granite-moe-1b-a400m", mesh=[1, 2],
                            fsdp=False, microbatches=1, batch=4, seq=32),
         "moe_data2_fsdp": dict(arch="granite-moe-1b-a400m", mesh=[2, 1],
                                fsdp=True, microbatches=1, batch=8,
                                seq=128)}


# serving: a prefill of 29 tokens, then 3 decode steps (caches of 32)
SERVE = {"serve_gemma3_model2": dict(arch="gemma3-1b", mesh=[1, 2]),
         "serve_gemma3_data2": dict(arch="gemma3-1b", mesh=[2, 1]),
         "serve_llama_model2": dict(arch="llama3.2-1b", mesh=[1, 2]),
         "serve_moe_model2": dict(arch="granite-moe-1b-a400m", mesh=[1, 2])}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_train(case, path):
    """The reference's 1-device train step on the case's state and
    tokens (fp32 compute), the inputs saved to `path` for the ranks."""
    B, S = case["batch"], case["seq"]
    rcfg = dataclasses.replace(ref_get_arch(case["arch"], True),
                               compute_dtype="float32")
    state = _np_tree(ref_init_tree(ref_spec_train_state(rcfg),
                                   jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    np.savez(path, tokens=toks, **_torch_dist.tree_npz(state))
    step = jax.jit(ref_make_train_step(
        rcfg, RefPolicy(microbatches=case["microbatches"], loss_chunk=S // 2),
        ref_adamw(1e-3, weight_decay=0.01, eps=1e-4)))
    new, metrics = step(state, {"tokens": jnp.asarray(toks)})
    return {"state": [np.asarray(x, np.float32)
                      for x in jax.tree_util.tree_leaves(new)],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _ref_serve(case, path, B=2, S=29, gen=3):
    """The reference's prefill of S tokens and `gen` decode steps (fp32
    compute): every step's logits and the last caches."""
    rcfg = dataclasses.replace(ref_get_arch(case["arch"], True),
                               compute_dtype="float32")
    params = _np_tree(ref_init_tree(ref_spec_params(rcfg),
                                    jax.random.PRNGKey(0)))
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size,
                                             (B, S + gen), dtype=np.int32)
    np.savez(path, tokens=toks, **_torch_dist.tree_npz(params))
    prefill = jax.jit(lambda p, b, c: ref_prefill(p, rcfg, b, c))
    decode = jax.jit(lambda p, t, c, pos: ref_decode_step(p, rcfg, t, c,
                                                          pos))
    caches = ref_init_tree(ref_spec_caches(rcfg, B, S + gen),
                           jax.random.PRNGKey(1))
    logits, caches = prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                             caches)
    out = [np.asarray(logits)]
    for i in range(gen):
        logits, caches = decode(params, jnp.asarray(toks[:, S + i:S + i + 1]),
                                caches, jnp.asarray(S + i, jnp.int32))
        out.append(np.asarray(logits))
    return {"logits": out, "caches": [np.asarray(x, np.float32) for x in
                                      jax.tree_util.tree_leaves(caches)]}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Every training and serving case in one gloo world of 2 ranks (one
    spawn), from the reference's params and tokens; per case the ranks'
    readings, the sharded step's results and the reference's."""
    work = tmp_path_factory.mktemp("sharded")
    tasks, refs = [], {}
    for name, case in CASES.items():
        inputs = str(work / f"{name}_inputs.npz")
        refs[name] = _ref_train(case, inputs)
        tasks.append(dict(kind="sharded_lm", out=str(work / name),
                          inputs=inputs, **case))
    for name, case in SERVE.items():
        inputs = str(work / f"{name}_inputs.npz")
        refs[name] = _ref_serve(case, inputs)
        tasks.append(dict(kind="sharded_serve", out=str(work / name),
                          inputs=inputs, batch=2, seq=29, gen=3, **case))
    _torch_dist.run_plan(tasks, work, world=2, timeout=400)
    out = {}
    for t in tasks:
        name = t["out"].rsplit("/", 1)[1]
        out[name] = json.loads((work / name / f"{t['kind']}.json")
                               .read_text())
        out[name]["got"] = dict(np.load(work / name / f"{t['kind']}.npz"))
        out[name]["ref"] = refs[name]
    return out


def _err(got, want, floor=0.0) -> float:
    """max|Δ| / max(floor, max|want|)."""
    return float(np.abs(got - want).max()) / max(floor, float(
        np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_unsharded(sharded_runs, case):
    """SMOKE llama3.2-1b and granite-moe (fp32 compute): loss and
    metrics, every gradient leaf (AdamW's first moment / (1 − b1)) and
    second moment within 1e-5 relative (max|Δ| / max|ref| per leaf), the
    new params within 1e-5·max(1, max|p|); every state leaf a
    DTensor."""
    r = sharded_runs[case]
    assert r["all_dtensor"] and r["step"] == 1
    assert max(r["metrics"].values()) <= 1e-5, r["metrics"]
    for part in ("grads", "nu", "params"):
        assert r[part] <= 1e-5, (part, r[part])
    fsdp = CASES[case]["fsdp"]
    if CASES[case]["arch"] != "llama3.2-1b":
        return
    wq = r["layouts"]["params/groups/p0/attn/wq"]
    # (layers, embed, heads): embed over data under FSDP, heads over model
    # (a mesh dim of one rank replicates)
    assert wq == (["S(1)", "R"] if fsdp else ["R", "S(2)"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_reference(sharded_runs, case):
    """The same sharded step against the reference's 1-device
    `make_train_step` on the same params and tokens (fp32 compute; the
    reference's own sharded step fails on jax 0.9, R3): loss and
    metrics, every gradient leaf (AdamW's first moment / (1 − b1)), the
    second moment and the new params within 1e-5·max(1, max|ref|) (read
    on the CPU: ≤ 3.0e-7, 2.2e-7, 4.0e-11 and 3.4e-7)."""
    r = sharded_runs[case]
    got, want = r["got"], r["ref"]
    for k, v in want["metrics"].items():
        g = float(got[f"metric_{k}"])
        assert abs(g - v) <= 1e-5 * max(1.0, abs(v)), (k, g, v)
    cfg = get_arch(CASES[case]["arch"], smoke=True)
    errs = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for i, (key, _) in enumerate(_flatten_with_paths(spec_train_state(cfg))):
        part = key.split("/")[0]
        if part in errs:
            errs[part] = max(errs[part], _err(got[f"leaf_{i}"],
                                              want["state"][i], 1.0))
    assert errs["mu"] / 0.1 <= 1e-5 and errs["nu"] <= 1e-5, errs
    assert errs["params"] <= 1e-5, errs


def test_axis_size_and_data_axes_read_a_stub():
    """`axis_size`/`data_axes` read only `mesh_dim_names` and `shape`."""
    from repro_torch.launch.mesh import data_axes
    stub = _PortStub(*MESHES["multipod"])
    assert axis_size(stub, ("pod", "data")) == 32
    assert axis_size(stub, "model") == 16 and axis_size(stub, None) == 1
    assert data_axes(stub) == ("pod", "data")
    assert data_axes(_PortStub((4,), ("model",))) == ()


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_serving_matches_unsharded(sharded_runs, case):
    """`make_prefill_step` / `make_decode_step` with DTensor params and
    caches (SMOKE, fp32 compute, B 2): every step's logits and every
    cache leaf within 1e-5 relative of the unsharded steps. gemma3 on
    (1, 2) shards its KV caches over the sequence (kv = 1), sliding-
    window rings included; on (2, 1) over kv heads."""
    r = sharded_runs[case]
    assert r["logits"] <= 1e-5 and r["caches"] <= 1e-5, \
        {k: r[k] for k in ("logits", "caches")}
    if case == "serve_gemma3_model2":
        assert r["kv_seq"] == "model" and r["kv_heads"] is None


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_serving_matches_reference(sharded_runs, case):
    """The same sharded prefill and decode steps against the reference's
    `prefill` / `decode_step` on one device, same params and tokens
    (fp32 compute): every step's logits and every cache leaf within
    1e-5 relative (read on the CPU: ≤ 1.4e-6 and 1.8e-6)."""
    r = sharded_runs[case]
    got, want = r["got"], r["ref"]
    for j, w in enumerate(want["logits"]):
        assert _err(got[f"logits_{j}"], w) <= 1e-5, j
    for i, w in enumerate(want["caches"]):
        assert _err(got[f"cache_{i}"], w) <= 1e-5, i
