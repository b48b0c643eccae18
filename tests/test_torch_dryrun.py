"""The port's cost walker and dry-runs (`repro_torch.launch.
cost_analysis`, `dryrun`, `dryrun_gcn`) against the reference's HLO
walker (`repro.launch.hlo_analysis.analyze_hlo`).

The reference's LM dry-run fails on jax 0.9 (ROADMAP C, R5), and its
GCN dry-run does not partition its step there (R6): the walker is held
against `analyze_hlo` on the reference's 1-device programs, and against
exact counts of a sharded product whose local work is known. The
dry-runs join a fake process group in this process (torch.distributed's
"fake" backend), which the module tears down at its end.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import get_arch as ref_get_arch
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import lm as ref_lm
from repro.models.spec import init_tree as ref_init_tree
from repro_torch.configs import get_arch
from repro_torch.dist.sharding import CellPolicy
from repro_torch.dist.steps import (make_prefill_step, make_train_step,
                                    spec_train_state)
from repro_torch.launch import dryrun, dryrun_gcn
from repro_torch.launch.cost_analysis import analyze_step, run_step, top_costs
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.models.spec import init_tree
from repro_torch.nn.optim import adamw

SMOKE_PREFILL = dict(batch=2, seq=64)


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_walker_agrees_with_analyze_hlo_on_the_smoke_prefill():
    """SMOKE llama3.2-1b prefill, B 2 × 64: the walker's FLOPs on the
    port's eager prefill within 2% of `analyze_hlo` on the reference's
    compiled one (2.3200e7 against 2.3377e7 on the CPU, 0.76% apart)."""
    B, S = SMOKE_PREFILL["batch"], SMOKE_PREFILL["seq"]
    rcfg = ref_get_arch("llama3.2-1b", smoke=True)
    params = ref_init_tree(ref_lm.spec_params(rcfg), jax.random.PRNGKey(0))
    caches = ref_init_tree(ref_lm.spec_caches(rcfg, B, S),
                           jax.random.PRNGKey(1))
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    hlo = jax.jit(lambda p, b, c: ref_lm.prefill(p, rcfg, b, c)).lower(
        params, {"tokens": jnp.asarray(toks)}, caches).compile().as_text()
    want = analyze_hlo(hlo)["flops"]

    cfg = get_arch("llama3.2-1b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    got = analyze_step(make_prefill_step(cfg),
                       init_tree(lm.spec_params(cfg), gen, "cpu"),
                       {"tokens": torch.from_numpy(toks)},
                       init_tree(lm.spec_caches(cfg, B, S), gen, "cpu"))
    assert abs(got["flops"] - want) <= 0.02 * want, (got["flops"], want)
    assert got["bytes"] > 0 and got["collectives"] == {}


def test_sharded_product_counts_local_flops_and_its_all_gather():
    """x (64, 128, 2048) over data @ w (2048, 8192) with its rows over
    data (FSDP) and columns over model, on a fake 16 × 16 mesh: rank 0
    runs one local (512, 2048)·(2048, 512) product — 2·512·2048·512
    FLOP — after one all-gather of w's column block over data, 2048 ×
    512 fp32. DTensor's global-shape propagation is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_production_mesh
    dryrun.fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 128, 2048), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=torch.Size((64, 128, 2048)),
                               stride=(128 * 2048, 2048, 1))
        w = DTensor.from_local(torch.empty(128, 512), mesh,
                               [Shard(0), Shard(1)], run_check=False,
                               shape=torch.Size((2048, 8192)),
                               stride=(8192, 1))
        for _ in range(2):          # the second call hits DTensor's cache
            out, walker, memory = run_step(lambda a, b: a @ b, x, w)
            got = walker.summary()
            assert got["flops"] == 2 * 512 * 2048 * 512
            assert got["collectives"] == {
                "all-gather": {"count": 1.0, "bytes": 2048 * 512 * 4.0}}
            assert tuple(out.to_local().shape) == (4, 128, 512)
            assert memory["argument_size_in_bytes"] == (4 * 128 * 2048
                                                        + 128 * 512) * 4
            assert memory["output_size_in_bytes"] == 4 * 128 * 512 * 4
    top = top_costs(lambda a: a @ a, torch.ones(8, 8), k=1)
    assert top[0]["flops"] == 2 * 8 ** 3 and top[0]["count"] == 1


def _ref_gcn_one_device_flops() -> float:
    code = """
import jax
from repro.launch import dryrun_gcn
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import use_mesh
mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
with use_mesh(mesh):
    jitted, st, batch = dryrun_gcn.build("base", mesh)
    print(analyze_hlo(jitted.lower(st, batch).compile().as_text())["flops"])
"""
    env = _torch_dist._env()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return float(out.stdout.split()[-1])


def test_gcn_dryrun_is_one_cluster_per_data_shard():
    """`base` on the fake 16 × 16 mesh: per-device FLOPs within 2% of the
    reference's own 1-device step (1.5356e11 on jax 0.9: one cluster
    batch), and one gradient all-reduce over data whose ring bytes are
    2 × the params' fp32 bytes; `tp` splits the hidden products over
    model and reads fewer FLOPs per device."""
    want = _ref_gcn_one_device_flops()
    base = dryrun_gcn.run("base", save=False)
    assert base["status"] == "ok", base.get("error")
    assert abs(base["flops_per_device"] - want) <= 0.02 * want, \
        (base["flops_per_device"], want)
    c = dryrun_gcn.CFG
    dims = [c["in_dim"]] + [c["hidden_dim"]] * (c["num_layers"] - 1) \
        + [c["out_dim"]]
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    assert base["collectives"] == {
        "all-reduce": {"count": 1.0, "bytes": 2.0 * 4 * n_params}}
    assert base["num_devices"] == 256
    tp = dryrun_gcn.run("tp", save=False)
    assert tp["status"] == "ok", tp.get("error")
    assert tp["flops_per_device"] < base["flops_per_device"]
    assert tp["collectives"]["all-reduce"]["count"] > 1   # + model's


@pytest.mark.parametrize("variant", ["bf16", "ax", "q4", "sparse",
                                     "sparsek"])
def test_gcn_dryrun_variants_trace(variant):
    rec = dryrun_gcn.run(variant, save=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["roofline"]["bound_s"] > 0


def test_smoke_dryrun_on_a_2x2_mesh_divides_the_work():
    """SMOKE llama3.2-1b, train B 8 × 64, FSDP: rank 0 of a fake (2, 2)
    mesh reads at most 0.30 × the FLOPs of the unsharded step on one
    device (measured on the CPU: 0.2586; 0.25 is the perfect split, the
    rest is the head's whole-row softmax and the replicated norms)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_arch("llama3.2-1b", smoke=True)
    shape = ShapeConfig("t", "train", 64, 8)
    policy = CellPolicy(fsdp=True, microbatches=1, loss_chunk=64)
    state = init_tree(spec_train_state(cfg),
                      torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 64), dtype=np.int32))
    one = analyze_step(make_train_step(
        cfg, dataclasses.replace(policy, fsdp=False),
        adamw(3e-4, clip_norm=1.0)), state, {"tokens": toks})
    dryrun.fake_world(4)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = dryrun.trace_cell(cfg, shape, mesh, policy)
    _, walker, memory = run_step(step, *args)
    got = walker.summary()
    ratio = got["flops"] / one["flops"]
    assert ratio <= 0.30, ratio
    assert got["collectives"]["all-gather"]["count"] > 0
    assert memory["argument_size_in_bytes"] > 0


def test_vocab_parallel_loss_moves_nothing_vocab_sized():
    """SMOKE llama3.2-1b's train step (B 4 × 64, loss chunks of 32) on a
    fake (1, 16) mesh, the vocab over 'model': its collectives, kind by
    kind in count and bytes, are the same at vocab 512 and 1024, so
    neither the loss (`lm._ce_chunk`: row max, sum of exps, the target's
    logit and the argmax all-reduced per row) nor anything else moves a
    vocab-sized tensor. Gathering each chunk's logits over the vocab, as
    before, all-gathered 1,376,256 B at 512 and 2,424,832 B at 1024."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_debug_mesh
    dryrun.fake_world(16)
    mesh = make_debug_mesh(1, 16, device_type="cpu")
    shape = ShapeConfig("t", "train", 64, 4)
    policy = CellPolicy(fsdp=False, microbatches=1, loss_chunk=32)
    colls = []
    for V in (512, 1024):
        cfg = dataclasses.replace(get_arch("llama3.2-1b", smoke=True),
                                  vocab_size=V)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args = dryrun.trace_cell(cfg, shape, mesh, policy)
        _, walker, _ = run_step(step, *args)
        colls.append(walker.summary()["collectives"])
    assert colls[0] == colls[1], colls
    assert colls[0]["all-reduce"]["count"] > 0


def test_llama_train_4k_flops_per_device_match_the_shapes():
    """llama3.2-1b train_4k on the fake 16 × 16 mesh (FSDP, 2
    microbatches of 8 × 4096 tokens a device, remat): the walker's
    FLOPs equal the count from the shapes within 1%. Every product is
    local: the body's and the head's weights (vocab over 'model') take
    8·t·n per microbatch (forward, remat recompute, two backward
    products), less the one product the recompute never needs (the last
    MLP down projection of each group, 2·t·d·F/16), and the T² attention
    products 4 × their forward (2 · 2·b·(Hq/16)·T²·D). A product run
    at full width on every rank (its weight gathered over 'model') would
    add ≥ 1.6e13 to the 4.709e13."""
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", "pod", save=False)
    assert rec["status"] == "ok", rec.get("error")
    c = get_arch("llama3.2-1b")
    d, F, L, V, D = c.d_model, c.d_ff, c.num_layers, c.vocab_size, c.hd
    Hq, Hkv = c.num_heads, c.num_kv_heads
    M, m, b, T = 16, rec["policy"]["microbatches"], 8, 4096
    assert m == 2
    t = b * T
    body = L * (d * (Hq + 2 * Hkv) * D + Hq * D * d + 3 * d * F)
    linear = 8 * t * (body + d * V) / M - L * 2 * t * d * F / M
    attention = L * 4 * 2 * 2 * b * (Hq // M) * T * T * D
    want = m * (linear + attention)
    got = rec["flops_per_device"]
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_lm_dryrun_cell_records_and_skips(tmp_path, monkeypatch):
    """`run_cell` writes the reference's record fields; an unsupported
    cell is a skip and a failing one an error, never an exception."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", "pod")
    assert rec["status"] == "skip"
    monkeypatch.setattr(dryrun, "trace_cell", lambda *a: 1 / 0)
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", "pod", tag="t")
    assert rec["status"] == "error" and "ZeroDivisionError" in rec["error"]
    assert (tmp_path / "llama3.2-1b__decode_32k__pod__t.json").exists()
