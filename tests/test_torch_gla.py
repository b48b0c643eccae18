"""The port's SSM mixers (`repro_torch.models.gla`) against
`repro.models.gla`, on the CPU.

Inputs are made with numpy from a seed; the reference's params (its
`init_tree`, with the zero-initialised gates, biases and `A_log` redrawn
so every path carries signal) cross as numpy. Tolerances, relative to
max|ref| per output: ≤ 1e-5 in fp32 (summation order), gradients
(against `jax.vjp`, one random cotangent) ≤ 1e-4·max(1, max|g_ref|) per
leaf. bf16 forwards are held to 1e-3 against the reference compiled
with per-primitive rounding (`xla_allow_excess_precision` off): the
three mixers' outputs and the chunked GLA's come out bit for bit (0.0
measured; the fp32 GLA state 7.2e-8). The bound leaves room for a bf16
matmul whose fp32 summation order flips a rounding, which happens at
other inputs (≤ 0.04% of elements, 2.6e-5 of the output, at input
scale 0.02).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import gla as ref_gla
from repro.models.spec import init_tree as ref_init_tree
from repro_torch.configs import get_arch
from repro_torch.models import gla
from repro_torch.models.spec import params_from_numpy
from repro_torch.nn.tree import tree_leaves

FP32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-3
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}
B, S = 2, 21                      # S is not a multiple of the chunk (8)

MIXERS = {"mamba2": ("zamba2-7b", "spec_mamba2", "mamba2_apply",
                     "mamba2_cache_spec"),
          "mlstm": ("xlstm-1.3b", "spec_mlstm", "mlstm_apply",
                    "mlstm_cache_spec"),
          "slstm": ("xlstm-1.3b", "spec_slstm", "slstm_apply",
                    "slstm_cache_spec")}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _gla_inputs(seed, S=S, H=3, N=5, P=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, N)).astype(dtype)
    k = rng.normal(size=(B, S, H, N)).astype(dtype)
    v = rng.normal(size=(B, S, H, P)).astype(dtype)
    g = -rng.uniform(0.0, 1.0, size=(B, S, H)).astype(np.float32)
    state = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return q, k, v, g, state


# ----------------------------------------------------------------------
# the GLA core and the conv
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_gla_chunked_matches_reference(chunk):
    args = _gla_inputs(0)
    y_ref, s_ref = ref_gla.gla_chunked(*map(jnp.asarray, args), chunk)
    y, s = gla.gla_chunked(*map(_t, args), chunk)
    assert y.shape == y_ref.shape and s.shape == s_ref.shape
    assert _rel(y.numpy(), y_ref) <= FP32_TOL
    assert _rel(s.numpy(), s_ref) <= FP32_TOL


def test_gla_step_matches_reference():
    q, k, v, g, state = _gla_inputs(1)
    args = (q[:, 0], k[:, 0], v[:, 0], g[:, 0], state)
    y_ref, s_ref = ref_gla.gla_step(*map(jnp.asarray, args))
    y, s = gla.gla_step(*map(_t, args))
    assert _rel(y.numpy(), y_ref) <= FP32_TOL
    assert _rel(s.numpy(), s_ref) <= FP32_TOL


def test_gla_chunked_is_the_step_recurrence():
    """The chunked form against S single steps of the recurrence, from
    the same incoming state (the port against itself)."""
    q, k, v, g, state = map(_t, _gla_inputs(2))
    y, s_out = gla.gla_chunked(q, k, v, g, state, chunk=8)
    s, ys = state, []
    for t in range(S):
        yt, s = gla.gla_step(q[:, t], k[:, t], v[:, t], g[:, t], s)
        ys.append(yt)
    assert _rel(y.numpy(), torch.stack(ys, 1).numpy()) <= FP32_TOL
    assert _rel(s_out.numpy(), s.numpy()) <= FP32_TOL


def test_gla_chunked_rounds_each_chunk_to_v_dtype():
    args = _gla_inputs(3)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i < 3 else jnp.asarray(a)
             for i, a in enumerate(args)]
    y_ref, s_ref = jax.jit(lambda *a: ref_gla.gla_chunked(*a, 8),
                           compiler_options=PER_OP_ROUNDING)(*jargs)
    targs = [_t(a).to(torch.bfloat16) if i < 3 else _t(a)
             for i, a in enumerate(args)]
    y, s = gla.gla_chunked(*targs, 8)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert _rel(y.float().numpy(), y_ref.astype(jnp.float32)) <= BF16_TOL
    assert _rel(s.numpy(), s_ref) <= FP32_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 1 if with_state else S, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    st = rng.normal(size=(B, 3, 6)).astype(np.float32) if with_state \
        else None
    y_ref, s_ref = ref_gla.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                       None if st is None
                                       else jnp.asarray(st))
    y, s = gla.causal_conv(_t(x), _t(w), None if st is None else _t(st))
    assert _rel(y.numpy(), y_ref) <= FP32_TOL
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_kinks_take_the_reference_derivatives():
    """|x| (+1 at 0), max(x, 1) (a tie splits), softplus (logaddexp,
    also past 20) against jax's values and derivatives."""
    x = np.array([-2.0, -1.0, 0.0, 1.0, 3.0, 25.0, -30.0], np.float32)

    def jax_fn(v):
        return (jnp.maximum(jnp.abs(v), 1.0) * jnp.arange(1, 8)).sum() \
            + (jax.nn.softplus(v) * jnp.arange(7, 0, -1)).sum()
    want_val, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(x))
    t = _t(x).requires_grad_(True)
    w1 = torch.arange(1, 8, dtype=torch.float32)
    w2 = torch.arange(7, 0, -1, dtype=torch.float32)
    val = (gla._max1(gla._abs(t)) * w1).sum() + (gla._softplus(t) * w2).sum()
    val.backward()
    assert abs(float(val.detach()) - float(want_val)) <= \
        FP32_TOL * abs(float(want_val))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
# the mixers
# ----------------------------------------------------------------------
def _mixer(kind, dtype="float32"):
    name, spec_fn, apply_fn, cache_fn = MIXERS[kind]
    ref_cfg = dataclasses.replace(ref_get_arch(name, True),
                                  compute_dtype=dtype, ssm_chunk=8)
    cfg = dataclasses.replace(get_arch(name, True), compute_dtype=dtype,
                              ssm_chunk=8)
    params = jax.tree_util.tree_map(np.asarray, ref_init_tree(
        getattr(ref_gla, spec_fn)(ref_cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for key in ("w_gates", "b_gates", "A_log", "dt_bias", "b"):
        if key in params:     # zeros at init: give the gates signal
            params[key] = (0.5 * rng.normal(size=params[key].shape)
                           ).astype(np.float32)
    return (ref_cfg, cfg, params, getattr(ref_gla, apply_fn),
            getattr(gla, apply_fn), getattr(ref_gla, cache_fn),
            getattr(gla, cache_fn))


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_forward_and_gradient_match_jax_vjp(kind):
    ref_cfg, cfg, params, ref_apply, apply, _, _ = _mixer(kind)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda p, xx: ref_apply(p, ref_cfg, xx)[0],
                         jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(ct))
    p = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y = apply(p, cfg, xt)[0]
    grads = torch.autograd.grad(y, tree_leaves(p) + [xt], _t(ct))
    assert _rel(y.detach().numpy(), y_ref) <= FP32_TOL
    want = jax.tree_util.tree_leaves(g_params) + [g_x]
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= \
            GRAD_TOL * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_bf16_forward_matches_reference(kind):
    ref_cfg, cfg, params, ref_apply, apply, _, _ = _mixer(kind, "bfloat16")
    x = np.random.default_rng(7).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, xx: ref_apply(p, ref_cfg, xx)[0],
                   compiler_options=PER_OP_ROUNDING)(
        params, jnp.asarray(x, jnp.bfloat16))
    got = apply(params_from_numpy(params, "cpu"), cfg,
                _t(x).to(torch.bfloat16))[0]
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) <= BF16_TOL


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_cache_prefill_then_decode_matches_reference(kind):
    """Prefill with a cache (nonzero incoming states), then two decode
    steps: every output and cache leaf against the reference."""
    ref_cfg, cfg, params, ref_apply, apply, ref_cache_fn, cache_fn = \
        _mixer(kind)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S + 2, cfg.d_model)).astype(np.float32)
    cache = {k: rng.normal(size=s.shape).astype(np.float32)
             for k, s in cache_fn(cfg, B).items()}
    r_cache = {k: jnp.asarray(v, s.dtype) for (k, v), s in
               zip(sorted(cache.items()),
                   (ref_cache_fn(ref_cfg, B)[k] for k in sorted(cache)))}
    p_cache = {k: _t(v) for k, v in cache.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    for t0, t1, decode in ((0, S, False), (S, S + 1, True),
                           (S + 1, S + 2, True)):
        y_ref, r_cache = ref_apply(jp, ref_cfg, jnp.asarray(x[:, t0:t1]),
                                   cache=r_cache, decode=decode)
        y, p_cache = apply(tp, cfg, _t(x[:, t0:t1]), cache=p_cache,
                           decode=decode)
        assert _rel(y.numpy(), y_ref) <= FP32_TOL
        assert sorted(p_cache) == sorted(r_cache)
        for k in r_cache:
            assert p_cache[k].shape == r_cache[k].shape, k
            assert _rel(p_cache[k].float().numpy(),
                        np.asarray(r_cache[k], np.float32)) <= FP32_TOL, k
