"""Every arch's sharded branch against the reference, the serving CLI on
a mesh, and the vocab-parallel loss and argmax.

The sharded train step, prefill + 3 decode steps and hubert's encode run
on 2 gloo ranks (tests/_torch_dist.py, one spawn for the module) from
the reference's params and inputs, in SMOKE fp32, and are held against
the port's unsharded steps and the reference's 1-device steps: the
reference's own sharded steps fail on jax 0.9 (ROADMAP C, R3, R5). Every
arch runs on the (1, 2) mesh (the 'model' axis: heads, kv, ffn, experts,
vocab, the SSM and LSTM inner dims); zamba2-7b and xlstm-1.3b also on
(2, 1) with FSDP (the batch and the params' embed dim over 'data').
llama3.2-1b, granite-moe-1b-a400m and gemma3-1b are held in
tests/test_torch_sharding.py.

`launch.serve --mesh host` runs on the same ranks (a (2, 1) mesh)
against the one-device CLI in this process. The vocab-parallel pieces
(`lm._ce_chunk`, `layers.vocab_parallel_nll`, `layers.vocab_argmax`) run
on a (1, 2) mesh, the vocab split in two, against `jax.nn.log_softmax`
and `jnp.argmax` on the same logits, with ties inside a shard and across
the shard boundary.
"""
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from repro.configs import get_arch as ref_get_arch
from repro.dist.sharding import CellPolicy as RefPolicy
from repro.dist.steps import make_train_step as ref_make_train_step
from repro.dist.steps import spec_train_state as ref_spec_train_state
from repro.models.lm import decode_step as ref_decode_step
from repro.models.lm import encode as ref_encode
from repro.models.lm import prefill as ref_prefill
from repro.models.lm import spec_caches as ref_spec_caches
from repro.models.lm import spec_params as ref_spec_params
from repro.models.spec import init_tree as ref_init_tree
from repro.nn.optim import adamw as ref_adamw
from repro_torch.configs import get_arch
from repro_torch.dist.steps import spec_train_state
from repro_torch.launch import serve
from repro_torch.runtime.checkpoint import _flatten_with_paths

TOL = 1e-5
# the sLSTM recurrence's fp32 rounding over 32 steps, as the SSM fp32
# tests allow it (tests/test_torch_lm_ssm.py); read on the CPU below
SLSTM_TRAIN_TOL = 3e-5

B, S = 4, 32
TRAIN = {f"{arch}_model2": dict(arch=arch, mesh=[1, 2], fsdp=False)
         for arch in ("granite-3-2b", "internlm2-20b", "dbrx-132b",
                      "zamba2-7b", "xlstm-1.3b", "paligemma-3b",
                      "hubert-xlarge")}
TRAIN.update({f"{arch}_data2_fsdp": dict(arch=arch, mesh=[2, 1], fsdp=True)
              for arch in ("zamba2-7b", "xlstm-1.3b")})

# serving: a prefill of 29 tokens (after paligemma's prefix), then 3
# decode steps
SB, SS, GEN = 2, 29, 3
SERVE = {f"serve_{arch}_model2": dict(arch=arch, mesh=[1, 2])
         for arch in ("granite-3-2b", "internlm2-20b", "dbrx-132b",
                      "zamba2-7b", "xlstm-1.3b", "paligemma-3b")}
SERVE.update({f"serve_{arch}_data2": dict(arch=arch, mesh=[2, 1])
              for arch in ("zamba2-7b", "xlstm-1.3b")})
ENCODE = {"encode_hubert_model2": dict(arch="hubert-xlarge", mesh=[1, 2]),
          "encode_hubert_data2": dict(arch="hubert-xlarge", mesh=[2, 1])}
CLI = {f"cli_{arch}": arch for arch in ("llama3.2-1b", "gemma3-1b")}
CLI_ARGV = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "16", "--gen", "4", "--seed", "0"]
VOCAB = dict(batch=2, chunk=8, d=16, vocab=64, softcap=5.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rcfg(arch):
    return dataclasses.replace(ref_get_arch(arch, True),
                               compute_dtype="float32")


def _inputs(rcfg, batch, seq, seed):
    """The model inputs of one batch (numpy, `configs.input_specs`'s
    keys): tokens, after paligemma's prefix embeddings; hubert's frame
    embeddings and targets."""
    rng = np.random.default_rng(seed)
    V, d = rcfg.vocab_size, rcfg.d_model
    if rcfg.input_mode == "embeddings":
        return {"embeddings": rng.normal(size=(batch, seq, d)).astype(
                    np.float32),
                "targets": rng.integers(0, V, (batch, seq), dtype=np.int32)}
    out = {"tokens": rng.integers(0, V, (batch, seq), dtype=np.int32)}
    if rcfg.num_prefix_embeddings:
        out["prefix_embeddings"] = rng.normal(size=(
            batch, rcfg.num_prefix_embeddings, d)).astype(np.float32)
    return out


def _ref_train(case, path):
    """The reference's 1-device train step on the case's state and
    inputs (fp32 compute), the inputs saved to `path` for the ranks."""
    rcfg = _rcfg(case["arch"])
    state = _np_tree(ref_init_tree(ref_spec_train_state(rcfg),
                                   jax.random.PRNGKey(0)))
    batch = _inputs(rcfg, B, S, 1)
    np.savez(path, **batch, **_torch_dist.tree_npz(state))
    step = jax.jit(ref_make_train_step(
        rcfg, RefPolicy(microbatches=1, loss_chunk=S // 2),
        ref_adamw(1e-3, weight_decay=0.01, eps=1e-4)))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"state": [np.asarray(x, np.float32)
                      for x in jax.tree_util.tree_leaves(new)],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _ref_serve(case, path):
    """The reference's prefill of SS tokens (after the prefix) and GEN
    decode steps (fp32 compute): every step's logits and the last
    caches."""
    rcfg = _rcfg(case["arch"])
    npfx = rcfg.num_prefix_embeddings
    params = _np_tree(ref_init_tree(ref_spec_params(rcfg),
                                    jax.random.PRNGKey(0)))
    inputs = _inputs(rcfg, SB, SS + GEN, 2)
    np.savez(path, **inputs, **_torch_dist.tree_npz(params))
    toks = inputs.pop("tokens")
    prefill = jax.jit(lambda p, b, c: ref_prefill(p, rcfg, b, c))
    decode = jax.jit(lambda p, t, c, pos: ref_decode_step(p, rcfg, t, c,
                                                          pos))
    caches = ref_init_tree(ref_spec_caches(rcfg, SB, npfx + SS + GEN),
                           jax.random.PRNGKey(1))
    logits, caches = prefill(params, {k: jnp.asarray(v) for k, v in dict(
        inputs, tokens=toks[:, :SS]).items()}, caches)
    out = [np.asarray(logits)]
    for i in range(GEN):
        logits, caches = decode(params,
                                jnp.asarray(toks[:, SS + i:SS + i + 1]),
                                caches, jnp.asarray(npfx + SS + i,
                                                    jnp.int32))
        out.append(np.asarray(logits))
    return {"logits": out, "caches": [np.asarray(x, np.float32) for x in
                                      jax.tree_util.tree_leaves(caches)]}


def _ref_encode(case, path):
    """The reference's `encode` (frame logits) on one device."""
    rcfg = _rcfg(case["arch"])
    params = _np_tree(ref_init_tree(ref_spec_params(rcfg),
                                    jax.random.PRNGKey(0)))
    emb = _inputs(rcfg, SB, S, 3)["embeddings"]
    np.savez(path, embeddings=emb, **_torch_dist.tree_npz(params))
    return {"logits": np.asarray(jax.jit(lambda p, x: ref_encode(
        p, rcfg, {"embeddings": x}))(params, jnp.asarray(emb)))}


def _vocab_inputs(path):
    """hc (B, c, d) one-hot rows and w (d, V) in halves, so the logits
    hc @ w are w's rows exactly and tie where w's do: each row of w has
    its maximum twice, at j and j + V/2 (a tie across the two shards) or
    at two places in one shard; some targets hit the first maximum, some
    the second."""
    v = VOCAB
    rng = np.random.default_rng(4)
    Bv, c, d, V = v["batch"], v["chunk"], v["d"], v["vocab"]
    w = rng.integers(-6, 7, (d, V)).astype(np.float32) / 2
    for k in range(d):
        j = int(rng.integers(0, V // 2))
        other = j + V // 2 if k % 3 else (j + 3) % (V // 2)
        if k % 3 == 2:                  # both in the upper shard
            j, other = j + V // 2, (j + 5) % (V // 2) + V // 2
        w[k, [j, other]] = 4.0
    ks = rng.integers(0, d, (Bv, c))
    hc = np.eye(d, dtype=np.float32)[ks]
    first = np.argmax(w, -1)[ks]
    tc = rng.integers(0, V, (Bv, c))
    tc[:, ::3] = first[:, ::3]
    second = V - 1 - np.argmax(w[:, ::-1], -1)[ks]
    tc[:, 1::3] = second[:, 1::3]
    mc = (rng.random((Bv, c)) < 0.8).astype(np.float32)
    np.savez(path, hc=hc, w=w, tc=tc.astype(np.int32), mc=mc)
    return dict(hc=hc, w=w, tc=tc, mc=mc)


@pytest.fixture(scope="module")
def arch_runs(tmp_path_factory):
    """Every case of the module in one gloo world of 2 ranks (one spawn);
    per case the ranks' readings, the sharded results and the
    reference's (or the one-device CLI's)."""
    work = tmp_path_factory.mktemp("sharded_archs")
    tasks, refs = [], {}
    for name, case in TRAIN.items():
        inputs = str(work / f"{name}_inputs.npz")
        refs[name] = _ref_train(case, inputs)
        tasks.append(dict(kind="sharded_lm", out=str(work / name),
                          inputs=inputs, microbatches=1, batch=B, seq=S,
                          **case))
    for name, case in SERVE.items():
        inputs = str(work / f"{name}_inputs.npz")
        refs[name] = _ref_serve(case, inputs)
        tasks.append(dict(kind="sharded_serve", out=str(work / name),
                          inputs=inputs, batch=SB, seq=SS, gen=GEN, **case))
    for name, case in ENCODE.items():
        inputs = str(work / f"{name}_inputs.npz")
        refs[name] = _ref_encode(case, inputs)
        tasks.append(dict(kind="sharded_encode", out=str(work / name),
                          inputs=inputs, **case))
    for name, arch in CLI.items():
        argv = ["--arch", arch] + CLI_ARGV
        with mock.patch.object(serve, "get_arch", lambda n, smoke=False: (
                dataclasses.replace(get_arch(n, smoke=smoke),
                                    compute_dtype="float32"))):
            refs[name] = serve.main(argv)
        tasks.append(dict(kind="serve_cli", out=str(work / name), argv=argv))
    inputs = str(work / "vocab_inputs.npz")
    refs["vocab"] = _vocab_inputs(inputs)
    tasks.append(dict(kind="vocab", out=str(work / "vocab"), inputs=inputs,
                      softcap=VOCAB["softcap"]))
    _torch_dist.run_plan(tasks, work, world=2, timeout=600)
    out = {}
    for t in tasks:
        name = t["out"].rsplit("/", 1)[1]
        jpath = work / name / f"{t['kind']}.json"
        out[name] = json.loads(jpath.read_text()) if jpath.exists() else {}
        out[name]["got"] = dict(np.load(work / name / f"{t['kind']}.npz"))
        out[name]["ref"] = refs[name]
    return out


def _err(got, want, floor=0.0) -> float:
    """max|Δ| / max(floor, max|want|)."""
    return float(np.abs(got - want).max()) / max(floor, float(
        np.abs(want).max()), 1e-30)


def _train_tol(case) -> float:
    return SLSTM_TRAIN_TOL if TRAIN[case]["arch"] == "xlstm-1.3b" else TOL


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_sharded_arch_step_matches_unsharded(arch_runs, case):
    """The sharded train step (fp32) against the port's unsharded one:
    loss and metrics within TOL, every gradient leaf (AdamW's first
    moment / (1 − b1)) within TOL relative per leaf, the new params
    within TOL·max(1, max|p|), every state leaf a DTensor; xlstm-1.3b's
    within SLSTM_TRAIN_TOL. The second moment is (1 − b2)·g², so its
    relative error is twice the gradient's: it is held to 2 × the
    gradient's bound (read on the CPU: xlstm-1.3b gradients ≤ 1.5e-5,
    second moments ≤ 2.5e-5; zamba2-7b ≤ 6.9e-6 and 9.6e-6; every other
    case ≤ 1.3e-6 and 1.7e-6)."""
    r = arch_runs[case]
    tol = _train_tol(case)
    assert r["all_dtensor"] and r["step"] == 1
    assert max(r["metrics"].values()) <= TOL, r["metrics"]
    assert r["grads"] <= tol and r["params"] <= tol, r
    assert r["nu"] <= 2 * tol, r


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_sharded_arch_step_matches_reference(arch_runs, case):
    """The same sharded step against the reference's 1-device
    `make_train_step` on the same state and inputs (fp32): loss and
    metrics within TOL·max(1, |ref|), every gradient leaf (AdamW's first
    moment / (1 − b1)) and the new params within tol·max(1, max|ref|)
    per leaf, the second moment ((1 − b2)·g²) within 2·tol relative;
    tol is TOL, xlstm-1.3b's SLSTM_TRAIN_TOL (read on the CPU: xlstm-1.3b
    gradients ≤ 1.02e-5, second moments ≤ 2.6e-5, params ≤ 1.1e-5;
    zamba2-7b ≤ 3.5e-6, 1.02e-5 and 5.0e-6; the others ≤ 8.1e-7, 3.2e-6
    and 1.3e-6)."""
    r = arch_runs[case]
    tol = _train_tol(case)
    got, want = r["got"], r["ref"]
    for k, v in want["metrics"].items():
        g = float(got[f"metric_{k}"])
        assert abs(g - v) <= TOL * max(1.0, abs(v)), (k, g, v)
    cfg = get_arch(TRAIN[case]["arch"], smoke=True)
    errs = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for i, (key, _) in enumerate(_flatten_with_paths(spec_train_state(cfg))):
        part = key.split("/")[0]
        g, w = got[f"leaf_{i}"], want["state"][i]
        if part == "mu":
            errs[part] = max(errs[part], _err(g / 0.1, w / 0.1, 1.0))
        elif part in errs:
            errs[part] = max(errs[part], _err(g, w, part == "params"))
    assert errs["mu"] <= tol and errs["params"] <= tol, errs
    assert errs["nu"] <= 2 * tol, errs


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_arch_serving_matches_unsharded(arch_runs, case):
    """`make_prefill_step` / `make_decode_step` on DTensor params and
    caches (fp32, B 2): every step's logits and every cache leaf within
    TOL relative of the unsharded steps."""
    r = arch_runs[case]
    assert r["logits"] <= TOL and r["caches"] <= TOL, \
        {k: r[k] for k in ("logits", "caches")}


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_arch_serving_matches_reference(arch_runs, case):
    """The same sharded prefill and decode steps against the reference's
    `prefill` / `decode_step` on one device, same params and inputs
    (paligemma's prefix first, its decode positions after it): every
    step's logits and every cache leaf within TOL relative (read on the
    CPU: ≤ 4.0e-6 and 4.6e-6, the SSM archs; ≤ 1.1e-6, the others)."""
    r = arch_runs[case]
    got, want = r["got"], r["ref"]
    for j, w in enumerate(want["logits"]):
        assert _err(got[f"logits_{j}"], w) <= TOL, j
    for i, w in enumerate(want["caches"]):
        assert _err(got[f"cache_{i}"], w) <= TOL, i


@pytest.mark.parametrize("case", sorted(ENCODE))
def test_sharded_encode_matches_reference(arch_runs, case):
    """hubert's `make_encode_step` on DTensor params and embeddings
    (fp32): its frame logits within TOL relative of the port's
    unsharded step and of the reference's `encode` (read on the CPU:
    ≤ 4.3e-7 and 5.7e-7)."""
    r = arch_runs[case]
    assert r["logits"] <= TOL, r["logits"]
    assert _err(r["got"]["logits"], r["ref"]["logits"]) <= TOL


@pytest.mark.parametrize("case", sorted(CLI))
def test_serve_cli_mesh_host_matches_one_device(arch_runs, case):
    """`launch.serve --mesh host` on 2 gloo ranks (a (2, 1) mesh, SMOKE
    in fp32) against the one-device CLI: the same greedy tokens, the
    prefill and last logits within TOL relative (read on the CPU: ≤
    1.8e-7 and 7.7e-7), the prefill's flash calls one per attention
    layer in both, none in decode."""
    r = arch_runs[case]
    got, want = r["got"], r["ref"]
    assert r["mesh"] == "mesh {'data': 2, 'model': 1} on cpu"
    assert np.array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (2, 4)
    for k in ("prefill_logits", "last_logits"):
        assert _err(got[k], want[k].numpy()) <= TOL, k
    assert r["launches"] == want["launches"]
    assert r["decode_steps"] == want["decode_steps"] == 3


@pytest.mark.parametrize("mesh,ranks", [("pod", 256), ("multipod", 512)])
def test_serve_cli_production_mesh_needs_its_ranks(mesh, ranks):
    """Without torchrun `--mesh pod|multipod` stops with a message that
    names the ranks the mesh needs; nothing falls back to one device."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--mesh", mesh])
    assert f"needs {ranks} ranks" in str(e.value)


def _jax_vocab(v):
    """jax's chunk loss on the same inputs: the logits, per-row NLL and
    correctness, the sums, and the gradient of the NLL sum."""
    cap = VOCAB["softcap"]

    def logits_of(hc, w):
        return cap * jnp.tanh((hc @ w) / cap)

    def nll_sum(hc, w):
        lg = logits_of(hc, w)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(lg, -1),
                                   jnp.asarray(v["tc"])[..., None], -1)[..., 0]
        return (nll * v["mc"]).sum()
    hc, w = jnp.asarray(v["hc"]), jnp.asarray(v["w"])
    g_hc, g_w = jax.grad(nll_sum, (0, 1))(hc, w)
    return dict(logits=np.asarray(logits_of(hc, w)),
                nll_sum=float(nll_sum(hc, w)), grad_hc=np.asarray(g_hc),
                grad_w=np.asarray(g_w))


def test_vocab_parallel_loss_matches_jax(arch_runs):
    """`lm._ce_chunk` with the head's vocab split over 2 ranks and a
    softcap of 5, against jax on the same inputs: each row's
    −log_softmax[target] against `jax.nn.log_softmax` on the port's
    logits and the NLL sum within TOL, the gradients of the NLL sum in
    hc and w within TOL relative (read on the CPU: ≤ 9.3e-8 and 3.9e-7);
    the logits stay split over the vocab, and agree with jax's within
    1e-6 (the two tanh differ in the last bit: 1.5e-7 read)."""
    r = arch_runs["vocab"]
    got, v = r["got"], r["ref"]
    want = _jax_vocab(v)
    assert list(got["logits_placements"]) == ["R", "S(2)"]
    assert _err(got["logits"], want["logits"]) <= 1e-6
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(got["logits"]), -1))
    rows = -np.take_along_axis(logp, v["tc"][..., None], -1)[..., 0]
    assert _err(got["nll_rows"], rows) <= TOL
    assert abs(float(got["nll_sum"]) - want["nll_sum"]) <= \
        TOL * abs(want["nll_sum"])
    for k in ("grad_hc", "grad_w"):
        assert _err(got[k], want[k]) <= TOL, k


def test_vocab_parallel_argmax_takes_the_first_maximum(arch_runs):
    """`layers.vocab_argmax` and the loss's correct count on logits whose
    maximum ties inside a shard and across the shard boundary: the
    index `jnp.argmax` takes (the first), so a target at the second
    maximum is not correct."""
    r = arch_runs["vocab"]
    got, v = r["got"], r["ref"]
    first = np.asarray(jnp.argmax(jnp.asarray(got["logits"]), -1))
    assert np.array_equal(got["argmax"], first)
    V = VOCAB["vocab"]
    ties = (got["logits"] == got["logits"].max(-1, keepdims=True)).sum(-1)
    assert (ties >= 2).all()
    cross = [(got["logits"][b, c, :V // 2].max() ==
              got["logits"][b, c, V // 2:].max())
             for b in range(VOCAB["batch"]) for c in range(VOCAB["chunk"])]
    assert any(cross) and not all(cross)
    hits = (first == v["tc"]).astype(np.float32)
    assert np.array_equal(got["correct_rows"], hits)
    assert float(got["correct_sum"]) == float((hits * v["mc"]).sum())
    assert 0 < hits.sum() < hits.size
