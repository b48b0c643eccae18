"""LM training on the port — `lm_loss`, the attention gradient, the
train step, gradient accumulation and remat — against the reference on
the CPU.

Parameters come from the reference's `init_tree` and cross as numpy;
batches are made with numpy from a seed, with the reference's input
keys and shapes (`input_specs`: tokens, hubert's frame embeddings and
targets, paligemma's prefix embeddings). The reference differentiates
with `jax.value_and_grad` under `jax.jit`. Tolerances: fp32 loss ≤ 1e-5
relative, every grad leaf ≤ 1e-4·max(1, max|g_ref|) (the GCN training
bound). In bf16 (the reference compiled with per-primitive rounding)
the loss ≤ 3e-4 relative (worst reading 1.04e-4, hubert-xlarge) and
grads per arch (`BF16_GRAD_TOL`, readings beside them), all below the
reference's own bf16-vs-fp32 distance: the bf16 matmuls' fp32
summation order flips roundings that the backward carries.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import input_specs as ref_input_specs
from repro.dist.sharding import CellPolicy as RefCellPolicy
from repro.dist.steps import make_train_step as ref_make_train_step
from repro.dist.steps import spec_train_state as ref_spec_train_state
from repro.kernels.ref import blocked_attention as ref_blocked_attention
from repro.models import lm as ref_lm
from repro.models.config import ShapeConfig as RefShapeConfig
from repro.models.spec import init_tree as ref_init_tree
from repro.nn import accumulate_gradients as ref_accumulate_gradients
from repro.nn import count_params as ref_count_params
from repro.nn import tree_bytes as ref_tree_bytes
from repro.nn.optim import adamw as ref_adamw
from repro.nn.optim import warmup_cosine_schedule as ref_warmup_cosine
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.dist.sharding import CellPolicy
from repro_torch.dist.steps import make_train_step, spec_train_state
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import (blocked_attention,
                                     multi_head_attention_ref)
from repro_torch.models import lm
from repro_torch.models.spec import params_from_numpy, params_to_numpy
from repro_torch.nn import (REMAT_POLICIES, accumulate_gradients,
                            count_params, maybe_remat, tree_bytes)
from repro_torch.nn.optim import adamw, warmup_cosine_schedule
from repro_torch.nn.tree import tree_leaves

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_LOSS_TOL = 3e-4
# readings: llama 4.39e-3, gemma3 8.30e-3, granite-3-2b 3.91e-3,
# internlm2 1.11e-2, granite-moe 3.90e-3, dbrx 1.17e-2, hubert 4.89e-4,
# paligemma 2.93e-3, xlstm 3.91e-2, zamba2 2.15e-2 (the reference's own
# bf16 grads sit 4.6e-3 … 1.4e-1 from its fp32 ones)
BF16_GRAD_TOL = dict({n: 2e-2 for n in ARCH_NAMES},
                     **{"xlstm-1.3b": 8e-2, "zamba2-7b": 4e-2})
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}
B, S = 2, 24


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _grad_err(got, want) -> float:
    """max|Δ| / max(1, max|want|) of one leaf."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(1.0, np.abs(want).max()))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(ref_get_arch(name, True), compute_dtype=dtype),
            dataclasses.replace(get_arch(name, True), compute_dtype=dtype))


def _batch(ref_cfg, seed, batch=B, seq=S):
    """Numpy inputs with the reference's keys and shapes for a train
    cell: tokens (or targets) uniform in the vocab, embeddings normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, sd in ref_input_specs(
            ref_cfg, RefShapeConfig("t", "train", seq, batch)).items():
        if np.issubdtype(sd.dtype, np.integer):
            out[key] = rng.integers(0, ref_cfg.vocab_size, size=sd.shape,
                                    dtype=np.int32)
        else:
            out[key] = rng.normal(size=sd.shape).astype(np.float32)
    return out


def _port_loss_and_grads(params, cfg, batch, **kw):
    p = params_from_numpy(params, "cpu")
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = lm.lm_loss(p, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _ref_loss_and_grads(params, ref_cfg, batch, dtype, **kw):
    fn = jax.value_and_grad(lambda p, b: ref_lm.lm_loss(p, ref_cfg, b, **kw),
                            has_aux=True)
    opts = PER_OP_ROUNDING if dtype == "bfloat16" else None
    (loss, metrics), grads = jax.jit(fn, compiler_options=opts)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), metrics, jax.tree_util.tree_leaves(grads)


# ----------------------------------------------------------------------
# lm_loss and its gradient, every arch
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _fp32_case(name):
    """The reference's fp32 loss, metrics and grads of one arch (its
    chunking changes only the fp32 summation order of the loss sum)."""
    ref_cfg, _ = _cfgs(name)
    params = _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                    jax.random.PRNGKey(0)))
    batch = _batch(ref_cfg, 3)
    return params, batch, _ref_loss_and_grads(params, ref_cfg, batch,
                                              "float32", loss_chunk=8)


@pytest.mark.parametrize("loss_chunk", [8, 10])     # divides S=24 or not
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_lm_loss_and_grads_match_reference(name, loss_chunk):
    _, cfg = _cfgs(name)
    params, batch, (want, r_metrics, r_grads) = _fp32_case(name)
    loss, metrics, grads = _port_loss_and_grads(params, cfg, batch,
                                                loss_chunk=loss_chunk)
    assert abs(float(loss) - want) <= LOSS_TOL * abs(want)
    assert sorted(metrics) == sorted(r_metrics)
    for key in metrics:
        assert abs(float(metrics[key]) - float(r_metrics[key])) <= \
            LOSS_TOL * max(1.0, abs(float(r_metrics[key]))), key
    assert len(grads) == len(r_grads)
    for got, w in zip(grads, r_grads):
        assert got.shape == w.shape
        assert _grad_err(got.numpy(), w) <= GRAD_TOL


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bf16_lm_loss_and_grads_match_reference(name):
    """fp32 master params cast at each use, as the reference trains."""
    ref_cfg, cfg = _cfgs(name, "bfloat16")
    params = _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                    jax.random.PRNGKey(0)))
    batch = _batch(ref_cfg, 3)
    want, _, r_grads = _ref_loss_and_grads(params, ref_cfg, batch,
                                           "bfloat16", loss_chunk=10)
    loss, _, grads = _port_loss_and_grads(params, cfg, batch, loss_chunk=10)
    assert abs(float(loss) - want) <= BF16_LOSS_TOL * abs(want)
    for got, w in zip(grads, r_grads):
        assert got.dtype == torch.float32
        assert _grad_err(got.numpy(), w) <= BF16_GRAD_TOL[name]


def test_accuracy_takes_the_first_maximum_as_jax_does():
    """Tied logits: the argmax (and so `acc`) picks the first maximum."""
    cfg = get_arch("llama3.2-1b", True)
    w = torch.zeros((4, 5))
    w[0, 1] = w[0, 3] = 1.0                  # classes 1 and 3 tie
    hc = torch.tensor([[[1.0, 0.0, 0.0, 0.0]] * 2])
    for target, correct in ((1, 2.0), (3, 0.0)):
        tc = torch.full((1, 2), target)
        _, got = lm._ce_chunk(cfg, hc, tc, torch.ones((1, 2)), w)
        assert float(got) == correct
    logits = jnp.asarray((hc @ w).numpy())
    assert int(jnp.argmax(logits, -1)[0, 0]) == 1


# ----------------------------------------------------------------------
# attention under autograd
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=9, softcap=20.0),
    dict(causal=False),
])
@pytest.mark.parametrize("Hq,Hkv,Tq,Tk", [(4, 2, 40, 40), (4, 1, 33, 33),
                                          (2, 2, 12, 30)])
def test_blocked_attention_and_its_vjp_match_reference(Hq, Hkv, Tq, Tk, kw):
    """Windowed (the kv slice per q chunk), GQA (grouped heads), a
    ragged last chunk and Tq < Tk: forward and `jax.vjp`."""
    rng = np.random.default_rng(Hq + Tq)
    q = rng.normal(size=(2, Hq, Tq, 16)).astype(np.float32)
    k = rng.normal(size=(2, Hkv, Tk, 16)).astype(np.float32)
    v = rng.normal(size=(2, Hkv, Tk, 16)).astype(np.float32)
    ct = rng.normal(size=(2, Hq, Tq, 16)).astype(np.float32)
    want, vjp = jax.vjp(functools.partial(ref_blocked_attention, q_chunk=16,
                                          **kw),
                        *map(jnp.asarray, (q, k, v)))
    r_grads = vjp(jnp.asarray(ct))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = blocked_attention(*t, q_chunk=16, **kw)
    grads = torch.autograd.grad(got, t, torch.from_numpy(ct))
    assert _rel(got.detach().numpy(), want) <= LOSS_TOL
    for g, w in zip(grads, r_grads):
        assert _grad_err(g.numpy(), w) <= GRAD_TOL


def test_flash_function_backward_is_the_blocked_vjp(monkeypatch):
    """The autograd Function the CUDA path trains through, on CPU
    tensors with the launch swapped for the plain forward: its gradient
    is the VJP of `blocked_attention` on the saved q, k, v, equal to
    autograd of the plain version."""
    def plain_launch(q, k, v, **kw):
        fa.LAUNCHES += 1
        return multi_head_attention_ref(q, k, v, **kw)
    monkeypatch.setattr(fa, "_launch", plain_launch)
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 4, 150, 16), (2, 2, 150, 16), (2, 2, 150, 16)))
    ct = torch.from_numpy(rng.normal(size=(2, 4, 150, 16))
                          .astype(np.float32))
    kw = dict(causal=True, window=40, softcap=25.0, scale=0.3)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = fa.LAUNCHES
    out = fa._FlashAttention.apply(*a, kw["causal"], kw["window"],
                                   kw["softcap"], kw["scale"])
    got = torch.autograd.grad(out, a, ct)
    assert fa.LAUNCHES == before + 1          # the backward launches none
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(multi_head_attention_ref(*b, **kw), b, ct)
    for g, w in zip(got, want):
        assert _grad_err(g.numpy(), w.numpy()) <= GRAD_TOL
    # only k needs a gradient: the others come back None
    a2 = [torch.from_numpy(q), torch.from_numpy(k).requires_grad_(True),
          torch.from_numpy(v)]
    out = fa._FlashAttention.apply(*a2, True, None, None, 0.25)
    (gk,) = torch.autograd.grad(out, [a2[1]], ct)
    assert gk.shape == a2[1].shape
    # outside autograd (serving) the same Function launches once and
    # records no graph
    with torch.no_grad():
        out = fa._FlashAttention.apply(*a, True, None, None, 0.25)
    assert out.grad_fn is None and fa.LAUNCHES == before + 3


# ----------------------------------------------------------------------
# the train step, accumulation, remat
# ----------------------------------------------------------------------
def _ref_state(ref_cfg, seed):
    return _np_tree(ref_init_tree(ref_spec_train_state(ref_cfg),
                                  jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name,microbatches", [
    ("llama3.2-1b", 1), ("llama3.2-1b", 2), ("granite-moe-1b-a400m", 2),
    ("zamba2-7b", 2)])
def test_train_step_matches_reference_over_two_steps(name, microbatches):
    """Two steps of `make_train_step` from the same state: the metrics
    of each step (loss ≤ 1e-5, ≤ 7.6e-6 read; step 2's read the params
    step 1 made) and the moments after them (≤ 1e-4·max(1, max|ref|),
    ≤ 1.6e-6 read). The params are held to a tenth of the largest move
    two AdamW steps make (lr·(1 + wd·|w|) per step, ≈ 1.8e-3 here):
    AdamW divides each moment by its own root, so where a gradient
    element is within a few eps of 0 the grads' ~1e-7 summation noise
    moves its update by a few percent of lr (4.5e-4 read, zamba2-7b)."""
    ref_cfg, cfg = _cfgs(name)
    state = _ref_state(ref_cfg, 1)
    batches = [_batch(ref_cfg, 10 + i, batch=4, seq=16) for i in range(2)]
    r_step = jax.jit(ref_make_train_step(
        ref_cfg, RefCellPolicy(microbatches=microbatches, loss_chunk=8),
        ref_adamw(ref_warmup_cosine(1e-2, 1, 4), weight_decay=0.01,
                  clip_norm=1.0)))
    step = make_train_step(cfg, CellPolicy(microbatches=microbatches,
                                           loss_chunk=8),
                           adamw(warmup_cosine_schedule(1e-2, 1, 4),
                                 weight_decay=0.01, clip_norm=1.0))
    r_state, p_state = state, params_from_numpy(state, "cpu")
    for b in batches:
        r_state, r_metrics = r_step(r_state, {k: jnp.asarray(v)
                                              for k, v in b.items()})
        p_state, metrics = step(p_state, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        assert sorted(metrics) == ["acc", "grad_norm", "loss"]
        for key in metrics:
            assert abs(float(metrics[key]) - float(r_metrics[key])) <= \
                LOSS_TOL * max(1.0, abs(float(r_metrics[key]))), key
    assert int(p_state["step"]) == int(r_state["step"]) == 2
    got = params_to_numpy(p_state)
    for part in ("mu", "nu"):
        for g, w in zip(tree_leaves(got[part]),
                        jax.tree_util.tree_leaves(r_state[part])):
            assert _grad_err(g, w) <= GRAD_TOL, part
    lrs = [float(warmup_cosine_schedule(1e-2, 1, 4)(torch.tensor(t)))
           for t in (1, 2)]
    for g, w in zip(tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(r_state["params"])):
        bound = 0.1 * sum(lrs) * (1 + 0.01 * float(np.abs(w).max()))
        assert float(np.abs(g - np.asarray(w)).max()) <= bound


def test_spec_train_state_matches_reference():
    ref_cfg, cfg = ref_get_arch("zamba2-7b", True), get_arch("zamba2-7b",
                                                             True)
    r = jax.tree_util.tree_leaves_with_path(
        ref_spec_train_state(ref_cfg), is_leaf=lambda x: hasattr(x, "axes"))
    from repro_torch.runtime.checkpoint import _flatten_with_paths
    p = dict(_flatten_with_paths(spec_train_state(cfg)))
    assert len(r) == len(p)
    for path, rs in r:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        assert p[key].shape == rs.shape, key
        assert str(p[key].dtype).replace("torch.", "") == \
            jnp.dtype(rs.dtype).name, key


def test_train_step_raises_for_fsdp():
    """FSDP shards the state over a device mesh: a policy asking for it
    without a mesh raises instead of training unsharded."""
    with pytest.raises(ValueError, match="pass mesh="):
        make_train_step(get_arch("llama3.2-1b", smoke=True),
                        CellPolicy(fsdp=True), adamw(1e-2))


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_accumulation_matches_reference(m):
    """`accumulate_gradients` against the reference's: the full batch at
    m = 1, fp32-accumulated microbatch means at m > 1."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(8, 6)).astype(np.float32)

    def ref_fn(p, b):
        loss = jnp.mean((b @ p["w"]) ** 2)
        return loss, {"l": loss}

    def port_fn(p, b):
        loss = torch.mean((b @ p["w"]) ** 2)
        return loss, {"l": loss}
    r_loss, r_aux, r_g = ref_accumulate_gradients(
        ref_fn, {"w": jnp.asarray(w)}, jnp.asarray(x), m)
    loss, aux, g = accumulate_gradients(port_fn, {"w": torch.from_numpy(w)},
                                        torch.from_numpy(x), m)
    assert abs(float(loss) - float(r_loss)) <= LOSS_TOL * float(r_loss)
    assert abs(float(aux["l"]) - float(r_aux["l"])) <= LOSS_TOL * float(
        r_loss)
    assert _grad_err(g["w"].numpy(), r_g["w"]) <= GRAD_TOL
    assert not g["w"].requires_grad
    with pytest.raises(ValueError, match="divisible"):
        accumulate_gradients(port_fn, {"w": torch.from_numpy(w)},
                             torch.from_numpy(x[:7]), 2)


def test_train_step_gives_unread_params_zero_gradients():
    """zamba2-7b at one group calls only its first shared block: the
    second one's leaves get zero gradients (jax.grad's zeros), and the
    step matches the reference's."""
    kw = dict(num_layers=6, tail=("mamba2",) * 3)
    ref_cfg, cfg = (dataclasses.replace(c, **kw) for c in _cfgs("zamba2-7b"))
    state = _ref_state(ref_cfg, 1)
    batch = _batch(ref_cfg, 5, batch=2, seq=16)
    opt_args = (1e-2,)
    r_state, r_metrics = jax.jit(ref_make_train_step(
        ref_cfg, RefCellPolicy(loss_chunk=8), ref_adamw(*opt_args)))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    p_state, metrics = make_train_step(cfg, CellPolicy(loss_chunk=8),
                                       adamw(*opt_args))(
        params_from_numpy(state, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in metrics:
        assert abs(float(metrics[key]) - float(r_metrics[key])) <= \
            LOSS_TOL * max(1.0, abs(float(r_metrics[key]))), key
    for g in tree_leaves(p_state["mu"]["shared"]["s1"]):
        assert not torch.any(g)
    for g, w in zip(tree_leaves(params_to_numpy(p_state["mu"])),
                    jax.tree_util.tree_leaves(r_state["mu"])):
        assert _grad_err(g, w) <= GRAD_TOL


def test_remat_on_and_off_give_equal_results():
    """Group remat recomputes the same forward: loss and grads equal
    with and without it, for a hybrid arch (shared blocks inside each
    checkpointed group) and a MoE one (its aux term)."""
    for name in ("zamba2-7b", "granite-moe-1b-a400m"):
        ref_cfg, cfg = _cfgs(name)
        params = _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                        jax.random.PRNGKey(2)))
        batch = _batch(ref_cfg, 4)
        on = _port_loss_and_grads(params, cfg, batch, remat=True)
        off = _port_loss_and_grads(params, cfg, batch, remat=False)
        assert float(on[0]) == float(off[0])
        for a, b in zip(on[2], off[2]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_policies_keep_values_and_gradients(policy):
    """Every policy the reference names runs, and none changes what is
    computed; an unknown one raises."""
    rng = np.random.default_rng(1)
    w1, w2 = (torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
              .requires_grad_(True) for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(3, 5, 8)).astype(np.float32))

    def fn(x, a, b):
        h = torch.tanh(x @ a)
        return torch.einsum("bsd,bte->bde", h, h).sum() + (h @ b).square().sum()
    want = torch.autograd.grad(fn(x, w1, w2), (w1, w2))
    out = maybe_remat(fn, policy)(x, w1, w2)
    got = torch.autograd.grad(out, (w1, w2))
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown remat policy"):
        maybe_remat(fn, "everything")


def test_count_params_and_tree_bytes_match_reference():
    ref_cfg, cfg = _cfgs("xlstm-1.3b", "bfloat16")
    params = _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                    jax.random.PRNGKey(0)))
    p = lm.cast_matmul_weights(params_from_numpy(params, "cpu"), cfg.dtype)
    assert count_params(p) == ref_count_params(params)
    r_cast = jax.tree_util.tree_map(
        lambda a, t: jnp.asarray(a, jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(a), params,
        {k: v for k, v in p.items()})
    assert tree_bytes(p) == ref_tree_bytes(r_cast)
