"""The port's LM stack (`repro_torch.models`, `configs`, `dist.steps`,
`launch.serve`) against the reference's, on the CPU.

Parameters come from the reference's `init_tree` and cross as numpy
(`params_to_numpy` → `params_from_numpy`); prompts and decode tokens
are made with numpy from a seed. The reference's prefill runs its
Pallas flash kernel in interpret mode. Relative error = max|Δ| /
max|ref| per output: ≤ 1e-5 in fp32 (summation order) and ≤ 1e-2 in
bf16 (the bound of the reference's own prefill/decode consistency test).

In bf16 the reference is compiled with per-primitive rounding
(`xla_allow_excess_precision` off), the semantics its jaxpr states and
the port follows: XLA's default keeps fused elementwise chains in fp32,
which moves the reference's own SMOKE logits by 0.8–2.2% — more than
the bound. With per-primitive rounding one layer of the port is bit
for bit the reference's; what remains is fp32 summation order (the
rmsnorm mean) flipping a few bf16 roundings, 0.65–0.96% on the llama
logits after two layers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels.ops import multi_head_attention as ref_mha
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.config import ArchConfig as RefArchConfig
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.spec import init_tree as ref_init_tree
from repro_torch.configs import ARCH_NAMES, cell_supported, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers, lm
from repro_torch.models.config import SHAPES, ArchConfig
from repro_torch.models.spec import (TensorSpec, init_tree,
                                     params_from_numpy, params_to_numpy,
                                     spec_bytes, spec_params, stack_specs)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}
B, S, N_DECODE = 2, 20, 4

# gemma-style features on the ported block kinds: a sliding-window ring
# shorter than the prompt, a tail, qk-norm, post-norms, GeGLU, softcaps,
# a second rope theta, sqrt(d) embedding scale, untied head
FEATURES = dict(
    name="features", family="dense", num_layers=3, d_model=32,
    num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97,
    pattern=("local", "attn"), tail=("local",), head_dim=8,
    rope_theta=1e4, rope_theta_global=1e6, sliding_window=6,
    attn_softcap=20.0, logit_softcap=30.0, qk_norm=True, post_norm=True,
    act="gelu", emb_scale_by_sqrt_dim=True)


def _cfgs(which: str, dtype: str):
    if which == "llama":
        ref, port = ref_get_arch("llama3.2-1b", True), \
            get_arch("llama3.2-1b", True)
    else:
        ref, port = RefArchConfig(**FEATURES), ArchConfig(**FEATURES)
    return (dataclasses.replace(ref, compute_dtype=dtype),
            dataclasses.replace(port, compute_dtype=dtype))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _trajectories(which: str, dtype: str):
    """Prefill of S prompt tokens, then N_DECODE teacher-forced decode
    steps, in both packages from the same params: per step the logits
    and the cache tree (numpy, bf16 leaves as float32)."""
    ref_cfg, cfg = _cfgs(which, dtype)
    params = _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + N_DECODE),
                        dtype=np.int32)
    max_seq = S + N_DECODE

    interp = functools.partial(ref_mha, mode="interpret")
    r_prefill = jax.jit(lambda p, b, c: ref_lm.prefill(p, ref_cfg, b, c,
                                                       attn_fn=interp),
                        compiler_options=PER_OP_ROUNDING)
    r_decode = jax.jit(lambda p, t, c, pos: ref_lm.decode_step(
        p, ref_cfg, t, c, pos), compiler_options=PER_OP_ROUNDING)
    caches = ref_init_tree(ref_lm.spec_caches(ref_cfg, B, max_seq),
                           jax.random.PRNGKey(1))
    def snapshot(tree):
        return _np_tree(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16
            else a, tree))
    ref_steps = []
    logits, caches = r_prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                               caches)
    ref_steps.append((np.asarray(logits), snapshot(caches)))
    for i in range(N_DECODE):
        logits, caches = r_decode(params,
                                  jnp.asarray(toks[:, S + i:S + i + 1]),
                                  caches, jnp.asarray(S + i, jnp.int32))
        ref_steps.append((np.asarray(logits), snapshot(caches)))

    p = params_from_numpy(params, "cpu")
    c = init_tree(lm.spec_caches(cfg, B, max_seq), torch.Generator(), "cpu")
    port_steps = []
    before = fa.LAUNCHES
    with torch.no_grad():
        logits, c = lm.prefill(p, cfg, {"tokens": torch.from_numpy(
            toks[:, :S])}, c)
        port_steps.append((logits.numpy(), params_to_numpy(c)))
        for i in range(N_DECODE):
            logits, c = lm.decode_step(
                p, cfg, torch.from_numpy(toks[:, S + i:S + i + 1]), c, S + i)
            port_steps.append((logits.numpy(), params_to_numpy(c)))
    assert fa.LAUNCHES == before
    return ref_steps, port_steps


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["llama", "features"])
def test_prefill_logits_and_caches_match_reference(which, dtype):
    ref_steps, port_steps = _trajectories(which, dtype)
    (r_logits, r_caches), (p_logits, p_caches) = ref_steps[0], port_steps[0]
    assert p_logits.dtype == np.float32 and p_logits.shape == r_logits.shape
    assert _rel(p_logits, r_logits) <= TOL[dtype]
    r_leaves, p_leaves = dict(_leaves(r_caches)), dict(_leaves(p_caches))
    assert r_leaves.keys() == p_leaves.keys()
    for name, want in r_leaves.items():
        got = p_leaves[name]
        assert got.shape == want.shape, name
        if name.endswith("/pos"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert _rel(got, want) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["llama", "features"])
@pytest.mark.parametrize("step", range(1, N_DECODE + 1))
def test_teacher_forced_decode_matches_reference(which, dtype, step):
    ref_steps, port_steps = _trajectories(which, dtype)
    (r_logits, r_caches), (p_logits, p_caches) = ref_steps[step], \
        port_steps[step]
    assert _rel(p_logits, r_logits) <= TOL[dtype]
    for (name, want), (_, got) in zip(_leaves(r_caches), _leaves(p_caches)):
        if name.endswith("/pos"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert _rel(got, want) <= TOL[dtype], name


def test_bidirectional_prefill_matches_reference():
    """`enc` blocks: non-causal attention through the same prefill."""
    kw = dict(FEATURES, pattern=("enc",), tail=(), num_layers=2,
              sliding_window=None, compute_dtype="float32")
    ref_cfg, cfg = RefArchConfig(**kw), ArchConfig(**kw)
    params = _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                    jax.random.PRNGKey(3)))
    toks = np.random.default_rng(1).integers(0, 97, size=(B, 12),
                                             dtype=np.int32)
    interp = functools.partial(ref_mha, mode="interpret")
    want, _ = ref_lm.prefill(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                             ref_init_tree(ref_lm.spec_caches(ref_cfg, B, 12),
                                           jax.random.PRNGKey(1)),
                             attn_fn=interp)
    got, _ = lm.prefill(params_from_numpy(params, "cpu"), cfg,
                        {"tokens": torch.from_numpy(toks)},
                        init_tree(lm.spec_caches(cfg, B, 12),
                                  torch.Generator(), "cpu"))
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistency(dtype):
    """The port's own check, as the reference's test_models does it:
    logits of prefill(S) vs prefill(S-1) then one decode step."""
    _, cfg = _cfgs("llama", dtype)
    gen = torch.Generator().manual_seed(0)
    params = init_tree(lm.spec_params(cfg), gen, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32))
    caches = lambda: init_tree(lm.spec_caches(cfg, B, S + 4), gen, "cpu")
    full, _ = lm.prefill(params, cfg, {"tokens": toks}, caches())
    _, c = lm.prefill(params, cfg, {"tokens": toks[:, :S - 1]}, caches())
    dec, _ = lm.decode_step(params, cfg, toks[:, S - 1:], c, S - 1)
    assert _rel(dec.numpy(), full.numpy()) < 1e-2


def test_matmul_weights_cast_once_give_identical_logits():
    _, cfg = _cfgs("llama", "bfloat16")
    params = init_tree(lm.spec_params(cfg),
                       torch.Generator().manual_seed(4), "cpu")
    cast = lm.cast_matmul_weights(params, cfg.dtype)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["groups"]["p0"]["mlp"]["wg"].dtype == torch.bfloat16
    assert cast["groups"]["p0"]["attn"]["norm"]["scale"].dtype == \
        torch.float32
    assert cast["final_norm"]["scale"].dtype == torch.float32
    toks = {"tokens": torch.arange(2 * 9, dtype=torch.int32).view(2, 9)}
    mk = lambda: init_tree(lm.spec_caches(cfg, 2, 12), torch.Generator(),
                           "cpu")
    a, ca = lm.prefill(params, cfg, toks, mk())
    b, cb = lm.prefill(cast, cfg, toks, mk())
    assert torch.equal(a, b)
    da, _ = lm.decode_step(params, cfg, a.argmax(-1)[:, None], ca, 9)
    db, _ = lm.decode_step(cast, cfg, b.argmax(-1)[:, None], cb, 9)
    assert torch.equal(da, db)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rope_and_rmsnorm_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 11, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    pos = np.arange(5, 16)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(tdt)
    want = ref_layers.rope(jx, jnp.asarray(pos), 5e5)
    got = layers.rope(tx, torch.from_numpy(pos), 5e5)
    assert got.dtype == tdt
    tol = 1e-5 if dtype is np.float32 else 8e-3
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) <= tol
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6)
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) <= tol


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 10.0)])
def test_decode_attention_matches_reference(window, softcap):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 4, 1, 8)).astype(np.float32)
    kc = rng.normal(size=(2, 2, 12, 8)).astype(np.float32)
    vc = rng.normal(size=(2, 2, 12, 8)).astype(np.float32)
    kpos = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1, -1, -1], np.int32)
    want = ref_layers.decode_attention(
        *map(jnp.asarray, (q, kc, vc, kpos)), jnp.asarray(8), window=window,
        softcap=softcap)
    got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc, kpos)),
                                  8, window=window, softcap=softcap)
    assert _rel(got.numpy(), want) <= 1e-6


# ----------------------------------------------------------------------
# configs, specs, conversions
# ----------------------------------------------------------------------
def test_registry_matches_reference_for_ported_archs():
    assert ARCH_NAMES == ("llama3.2-1b",)
    for smoke in (False, True):
        ref, port = ref_get_arch("llama3.2-1b", smoke), \
            get_arch("llama3.2-1b", smoke)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert port.dtype == torch.bfloat16
        for name, shape in SHAPES.items():
            from repro.configs import cell_supported as ref_cell
            assert cell_supported(port, shape) == ref_cell(ref,
                                                           REF_SHAPES[name])


@pytest.mark.parametrize("name", ["gemma3-1b", "granite-moe-1b-a400m",
                                  "hubert-xlarge", "zamba2-7b"])
def test_later_archs_raise_naming_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        get_arch(name)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("kw,match", [
    (dict(pattern=("moe",)), "MoE"), (dict(pattern=("mamba2",)), "SSM"),
    (dict(pattern=("attn",), shared_attn=True), "shared")])
def test_unported_blocks_raise(kw, match):
    cfg = ArchConfig(**dict(FEATURES, num_layers=1, tail=(), **kw))
    with pytest.raises(NotImplementedError, match=match):
        lm.spec_params(cfg)


def test_specs_match_reference_shapes_and_counts():
    from repro.models.spec import spec_bytes as ref_bytes
    from repro.models.spec import spec_params as ref_count
    for full in (False, True):
        ref_cfg = ref_get_arch("llama3.2-1b", not full)
        cfg = get_arch("llama3.2-1b", not full)
        for r_tree, p_tree in (
                (ref_lm.spec_params(ref_cfg), lm.spec_params(cfg)),
                (ref_lm.spec_caches(ref_cfg, 4, 64),
                 lm.spec_caches(cfg, 4, 64))):
            r = jax.tree_util.tree_leaves_with_path(
                r_tree, is_leaf=lambda x: hasattr(x, "axes"))
            p = dict(_leaves(p_tree))
            assert len(r) == len(p)
            for path, rs in r:
                name = "".join(f"/{k.key}" for k in path)
                assert p[name].shape == rs.shape, name
                assert p[name].axes == rs.axes, name
                assert p[name].dtype.itemsize == jnp.dtype(rs.dtype).itemsize
            assert spec_bytes(p_tree) == ref_bytes(r_tree)
            assert spec_params(p_tree) == ref_count(r_tree)
    assert spec_params(lm.spec_params(get_arch("llama3.2-1b"))) == \
        1_235_814_400


def test_init_tree_draws_each_init_kind():
    tree = {"n": TensorSpec((400, 50), ("a", "b"), scale=0.5),
            "z": TensorSpec((3,), ("a",), init="zeros", dtype=torch.int32),
            "o": TensorSpec((2, 2), ("a", "b"), init="ones",
                            dtype=torch.bfloat16),
            "g": TensorSpec((300, 100), ("a", "b"), init="glorot")}
    stacked = stack_specs(tree, 3)
    assert stacked["n"].shape == (3, 400, 50) and \
        stacked["n"].axes == ("layers", "a", "b")
    out = init_tree(tree, torch.Generator().manual_seed(0), "cpu")
    again = init_tree(tree, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(out[k], again[k]) for k in tree)
    assert abs(float(out["n"].std()) - 0.5) < 0.02
    assert out["z"].dtype == torch.int32 and not out["z"].any()
    assert out["o"].dtype == torch.bfloat16 and bool((out["o"] == 1).all())
    bound = (6.0 / 400) ** 0.5
    assert float(out["g"].abs().max()) <= bound
    assert float(out["g"].abs().max()) > 0.9 * bound
    with pytest.raises(ValueError):
        TensorSpec((2, 3), ("a",))


def test_numpy_round_trip_keeps_values_and_bf16_bits():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "pos": np.array([0, -1], np.int32),
            "k": np.asarray(jnp.asarray([1.5, -2.25, 3.1], jnp.bfloat16))}
    t = params_from_numpy(tree, "cpu")
    assert t["k"].dtype == torch.bfloat16 and t["pos"].dtype == torch.int32
    np.testing.assert_array_equal(t["k"].float().numpy(),
                                  np.asarray(tree["k"], np.float32))
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    assert back["k"].dtype == np.float32


# ----------------------------------------------------------------------
# steps and the serving CLI
# ----------------------------------------------------------------------
def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    before = fa.LAUNCHES
    out = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                      "--batch", "3", "--prompt-len", "16", "--gen", "5"])
    assert fa.LAUNCHES == before
    assert out["launches"] == {"prefill": 0, "decode": 0}
    assert out["tokens"].shape == (3, 5) and out["decode_steps"] == 4
    assert out["prefill_logits"].shape == (3, 512)
    assert torch.isfinite(out["prefill_logits"]).all()
    assert torch.isfinite(out["last_logits"]).all()
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    printed = capsys.readouterr().out
    assert "prefill 3×16" in printed and "tok/s" in printed


def test_serve_cli_is_greedy_over_the_steps():
    """The CLI's tokens are the argmax chain of prefill + decode steps
    on the same params and prompts."""
    from repro_torch.dist.steps import make_decode_step, make_prefill_step
    from repro_torch.launch import serve
    out = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3",
                      "--seed", "5"])
    cfg = get_arch("llama3.2-1b", smoke=True)
    params, caches = serve.init_serving(cfg, 2, 11, 5, "cpu")
    batch = serve.make_batch(cfg, 2, 8, 5, "cpu")
    with torch.no_grad():
        logits, caches = make_prefill_step(cfg)(params, batch, caches)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(2):
            tok, _, caches = make_decode_step(cfg)(params, tok, caches, 8 + i)
            toks.append(tok)
    np.testing.assert_array_equal(out["tokens"], torch.cat(toks, 1).numpy())
    assert tok.dtype == torch.int32


def test_serve_cli_defaults_to_cuda_and_exits_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])
