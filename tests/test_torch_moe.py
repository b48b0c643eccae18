"""The port's MoE FFN (`repro_torch.models.layers` `spec_moe`,
`moe_capacity`, `moe_route`, `moe_apply`) against the reference's
`repro.models.layers`, on the CPU.

Parameters come from the reference's `init_tree` and cross as numpy;
activations are drawn with numpy from a seed. Both dispatch branches
run: B·T ≤ 512 flattens to one dropless row, larger batches dispatch
per row with the capacity factor's C slots per expert. The reference is
compiled with per-primitive rounding (`xla_allow_excess_precision`
off), the semantics the port follows in bf16. Relative error = max|Δ| /
max|ref|: ≤ 1e-5 in fp32, ≤ 1e-2 in bf16; the aux loss is fp32 in both
dtypes (fp32 softmax and one-hot means) and is held to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models.config import ArchConfig as RefArchConfig
from repro.models.spec import init_tree as ref_init_tree
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.spec import params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
AUX_TOL = 1e-5
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}

MOE = dict(name="moe", family="moe", num_layers=1, d_model=16,
           num_heads=2, num_kv_heads=1, d_ff=0, vocab_size=64,
           pattern=("moe",), head_dim=8, num_experts=8,
           experts_per_token=2, moe_d_ff=24)


def _cfgs(dtype: str, **kw):
    fields = dict(MOE, compute_dtype=dtype, **kw)
    return RefArchConfig(**fields), ArchConfig(**fields)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(ref_cfg, seed=0, zero_router=False):
    tree = jax.tree_util.tree_map(np.asarray, ref_init_tree(
        ref_layers.spec_moe(ref_cfg), jax.random.PRNGKey(seed)))
    # a norm scale away from 0, so the norm's gain is exercised
    tree["norm"]["scale"] = np.random.default_rng(seed).normal(
        size=tree["norm"]["scale"].shape).astype(np.float32) * 0.1
    if zero_router:
        tree["router"] = np.zeros_like(tree["router"])
    return tree


def _run_both(dtype, B, T, seed=0, zero_router=False, **kw):
    ref_cfg, cfg = _cfgs(dtype, **kw)
    params = _params(ref_cfg, seed, zero_router)
    x = np.random.default_rng(seed + 1).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, v: ref_layers.moe_apply(p, ref_cfg, v),
                  compiler_options=PER_OP_ROUNDING)
    want_y, want_aux = ref(params, jnp.asarray(x, ref_cfg.dtype))
    want_y = np.asarray(want_y.astype(jnp.float32))
    with torch.no_grad():
        got_y, got_aux = layers.moe_apply(
            params_from_numpy(params, "cpu"), cfg,
            torch.from_numpy(x).to(cfg.dtype))
    assert got_y.dtype == cfg.dtype and got_y.shape == (B, T, cfg.d_model)
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    return (got_y.float().numpy(), float(got_aux)), (want_y,
                                                     float(want_aux)), cfg


def _overflow(cfg, params, x, B, T) -> int:
    """Assignments past their expert's capacity, counted from the port's
    routing with numpy (per row; the flat branch never overflows)."""
    h = layers.rmsnorm(params["norm"], x, cfg.norm_eps)
    _, _, topi = layers.moe_route(params, cfg, h)
    if B * T <= 512:
        return 0
    C = layers.moe_capacity(cfg, T)
    counts = [np.bincount(row.reshape(-1), minlength=cfg.num_experts)
              for row in topi.numpy()]
    return int(sum(np.maximum(c - C, 0).sum() for c in counts))


# (B, T, extra config): the flat branch, the per-row branch with room
# to spare, and the per-row branch with a capacity factor that drops
CASES = {
    "flat": (2, 12, {}),
    "flat_at_512": (2, 256, {}),
    "per_row": (2, 320, dict(moe_capacity_factor=4.0)),
    "per_row_drops": (2, 320, dict(moe_capacity_factor=0.25)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, dtype):
    B, T, kw = CASES[case]
    (y, aux), (want_y, want_aux), _ = _run_both(dtype, B, T, **kw)
    assert _rel(y, want_y) <= TOL[dtype]
    assert abs(aux - want_aux) <= AUX_TOL * abs(want_aux)


@pytest.mark.parametrize("case,expect_drops", [
    ("flat", False), ("flat_at_512", False), ("per_row", False),
    ("per_row_drops", True)])
def test_cases_cover_the_capacity_drops(case, expect_drops):
    B, T, kw = CASES[case]
    ref_cfg, cfg = _cfgs("float32", **kw)
    params = params_from_numpy(_params(ref_cfg), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, T, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        dropped = _overflow(cfg, params, x, B, T)
    assert (dropped > 0) == expect_drops
    if expect_drops:
        # a dropped assignment contributes nothing: some token's output
        # then differs from a run with room for every assignment
        roomy = dataclasses.replace(cfg, moe_capacity_factor=8.0)
        with torch.no_grad():
            y, _ = layers.moe_apply(params, cfg, x)
            y_all, _ = layers.moe_apply(params, roomy, x)
        assert not torch.allclose(y, y_all)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["flat", "per_row_drops"])
def test_tied_router_picks_experts_as_the_reference(case, dtype):
    """Zero router weights tie every expert: jax's top_k takes the lowest
    indices first, and so must the port, in both branches (with drops,
    the tied choice decides which assignments overflow)."""
    B, T, kw = CASES[case]
    (y, aux), (want_y, want_aux), cfg = _run_both(dtype, B, T,
                                                  zero_router=True, **kw)
    assert _rel(y, want_y) <= TOL[dtype]
    assert abs(aux - want_aux) <= AUX_TOL * abs(want_aux)
    h = torch.zeros(1, 3, cfg.d_model)
    _, topv, topi = layers.moe_route(
        {"router": torch.zeros(cfg.d_model, cfg.num_experts)}, cfg, h)
    assert topi.tolist() == [[list(range(cfg.experts_per_token))] * 3]
    assert torch.all(topv == 1 / cfg.num_experts)


def test_router_ties_in_bf16_follow_jax_top_k():
    """Rows with many exact ties among 32 experts, as bf16-rounded
    logits give them: the port's top-k (values and indices) equals
    `jax.lax.top_k` of the reference's softmax. An identity router
    hands the logits through unchanged."""
    E, k = 32, 8
    cfg = ArchConfig(**dict(MOE, d_model=E, num_experts=E,
                            experts_per_token=k))
    logits = np.random.default_rng(3).integers(
        -2, 2, size=(2, 40, E)).astype(np.float32) / 8
    want_v, want_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                                   k)
    probs, topv, topi = layers.moe_route({"router": torch.eye(E)}, cfg,
                                         torch.from_numpy(logits))
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(topv.numpy(), np.asarray(want_v), rtol=1e-6)
    assert probs.shape == (2, 40, E)


@pytest.mark.parametrize("tokens", [1, 7, 64, 320, 2048, 8192])
@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0])
def test_moe_capacity_matches_reference(tokens, cf):
    ref_cfg, cfg = _cfgs("float32", moe_capacity_factor=cf)
    assert layers.moe_capacity(cfg, tokens) == \
        ref_layers.moe_capacity(ref_cfg, tokens)


def test_spec_moe_matches_reference():
    ref_cfg, cfg = _cfgs("bfloat16")
    want = jax.tree_util.tree_leaves_with_path(
        ref_layers.spec_moe(ref_cfg), is_leaf=lambda x: hasattr(x, "axes"))
    got = layers.spec_moe(cfg)
    assert len(want) == 5
    for path, rs in want:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        assert (leaf.shape, leaf.axes, leaf.init, leaf.scale) == \
            (rs.shape, rs.axes, rs.init, rs.scale), path
