"""Every attention-only LM arch of the reference on the port, against
`repro.models.lm` and `repro.configs`, on the CPU: gemma3-1b,
granite-3-2b, internlm2-20b, granite-moe-1b-a400m, dbrx-132b,
hubert-xlarge (encoder) and paligemma-3b (prefix embeddings).

Parameters come from the reference's `init_tree` and cross as numpy
(`params_to_numpy` → `params_from_numpy`); prompts, prefixes, frame
embeddings and decode tokens are made with numpy from a seed. The
reference runs under `jax.jit` with per-primitive rounding
(`xla_allow_excess_precision` off; see tests/test_torch_lm.py) and its
Pallas flash kernel in interpret mode. Relative error = max|Δ| /
max|ref| per output (logits, every cache leaf): ≤ 1e-5 in fp32; in bf16
the bound of each arch, `BF16_TOL`.

The port follows the reference's per-primitive bf16 rounding point for
point. gemma3-1b, internlm2-20b and hubert-xlarge come out bit for bit
in every bf16 activation and cache entry; only the fp32 head's
summation order differs (logits ≤ 1.5e-7), so bf16 is held to the fp32
bound there. paligemma-3b stays within the 1e-2 of
tests/test_torch_lm.py (3.7e-3 measured). In granite-3-2b,
granite-moe-1b-a400m and dbrx-132b the fp32 summation order of an
rmsnorm mean flips one bf16 rounding of a normed activation in the
first layer (granite-moe-1b-a400m: one token), and the two layers carry
it to 1.07e-2, 1.15e-2 and 1.02e-2 (worst of the logits and cache
leaves over prefill and 3 decode steps); their bound is 1.5e-2. No
expert choice differs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cell_supported as ref_cell_supported
from repro.configs import get_arch as ref_get_arch
from repro.configs import input_specs as ref_input_specs
from repro.kernels.ops import multi_head_attention as ref_mha
from repro.models import lm as ref_lm
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.spec import init_tree as ref_init_tree
from repro.models.spec import spec_bytes as ref_spec_bytes
from repro.models.spec import spec_params as ref_spec_params
from repro_torch.configs import (ARCH_NAMES, cell_supported, get_arch,
                                 input_specs, make_inputs)
from repro_torch.dist.steps import (make_decode_step, make_encode_step,
                                    make_prefill_step)
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.spec import (init_tree, params_from_numpy,
                                     params_to_numpy, spec_bytes,
                                     spec_params)

FP32_TOL = 1e-5
BF16_TOL = {"gemma3-1b": 1e-5, "internlm2-20b": 1e-5, "hubert-xlarge": 1e-5,
            "paligemma-3b": 1e-2, "granite-3-2b": 1.5e-2,
            "granite-moe-1b-a400m": 1.5e-2, "dbrx-132b": 1.5e-2}


def _tol(name: str, dtype: str) -> float:
    return FP32_TOL if dtype == "float32" else BF16_TOL[name]
PER_OP_ROUNDING = {"xla_allow_excess_precision": False}
B, S, N_DECODE = 2, 20, 3

DECODERS = ("gemma3-1b", "granite-3-2b", "internlm2-20b",
            "granite-moe-1b-a400m", "dbrx-132b", "paligemma-3b")
NEW_ARCHS = DECODERS + ("hubert-xlarge",)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(tree):
    return _np_tree(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _cfgs(name: str, dtype: str):
    return (dataclasses.replace(ref_get_arch(name, True), compute_dtype=dtype),
            dataclasses.replace(get_arch(name, True), compute_dtype=dtype))


def _ref_params(ref_cfg, seed=0):
    return _np_tree(ref_init_tree(ref_lm.spec_params(ref_cfg),
                                  jax.random.PRNGKey(seed)))


def _numpy_batch(cfg, seed, prompt_len):
    """Prompts (and a VLM's prefix embeddings after them) from one numpy
    stream, as the reference's serving CLI draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, prompt_len + N_DECODE),
                        dtype=np.int32)
    batch = {"tokens": toks}
    if cfg.num_prefix_embeddings:
        batch["prefix_embeddings"] = rng.normal(size=(
            B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _trajectories(name: str, dtype: str):
    """Prefill of S prompt tokens (after the prefix, if any), then
    N_DECODE teacher-forced decode steps at positions npfx + S + i, in
    both packages from the same params; per step the logits and the
    cache tree. The caches hold the whole context."""
    ref_cfg, cfg = _cfgs(name, dtype)
    params = _ref_params(ref_cfg)
    data = _numpy_batch(cfg, 7, S)
    toks = data["tokens"]
    npfx = cfg.num_prefix_embeddings
    max_seq = npfx + S + N_DECODE

    interp = functools.partial(ref_mha, mode="interpret")
    r_prefill = jax.jit(lambda p, b, c: ref_lm.prefill(p, ref_cfg, b, c,
                                                       attn_fn=interp),
                        compiler_options=PER_OP_ROUNDING)
    r_decode = jax.jit(lambda p, t, c, pos: ref_lm.decode_step(
        p, ref_cfg, t, c, pos), compiler_options=PER_OP_ROUNDING)
    caches = ref_init_tree(ref_lm.spec_caches(ref_cfg, B, max_seq),
                           jax.random.PRNGKey(1))
    r_batch = {"tokens": jnp.asarray(toks[:, :S])}
    p_batch = {"tokens": torch.from_numpy(toks[:, :S])}
    if npfx:
        r_batch["prefix_embeddings"] = jnp.asarray(data["prefix_embeddings"])
        p_batch["prefix_embeddings"] = torch.from_numpy(
            data["prefix_embeddings"])
    ref_steps = []
    logits, caches = r_prefill(params, r_batch, caches)
    ref_steps.append((np.asarray(logits), _f32(caches)))
    for i in range(N_DECODE):
        logits, caches = r_decode(params,
                                  jnp.asarray(toks[:, S + i:S + i + 1]),
                                  caches, jnp.asarray(npfx + S + i,
                                                      jnp.int32))
        ref_steps.append((np.asarray(logits), _f32(caches)))

    p = params_from_numpy(params, "cpu")
    c = init_tree(lm.spec_caches(cfg, B, max_seq), torch.Generator(), "cpu")
    port_steps = []
    before = fa.LAUNCHES
    with torch.no_grad():
        logits, c = make_prefill_step(cfg)(p, p_batch, c)
        port_steps.append((logits.numpy(), params_to_numpy(c)))
        for i in range(N_DECODE):
            _, logits, c = make_decode_step(cfg)(
                p, torch.from_numpy(toks[:, S + i:S + i + 1]), c,
                npfx + S + i)
            port_steps.append((logits.numpy(), params_to_numpy(c)))
    assert fa.LAUNCHES == before
    return ref_steps, port_steps


def _compare_step(ref_step, port_step, tol):
    (r_logits, r_caches), (p_logits, p_caches) = ref_step, port_step
    assert p_logits.dtype == np.float32 and p_logits.shape == r_logits.shape
    assert _rel(p_logits, r_logits) <= tol
    r_leaves, p_leaves = dict(_leaves(r_caches)), dict(_leaves(p_caches))
    assert r_leaves.keys() == p_leaves.keys()
    for leaf, want in r_leaves.items():
        got = p_leaves[leaf]
        assert got.shape == want.shape, leaf
        if leaf.endswith("/pos"):
            np.testing.assert_array_equal(got, want, err_msg=leaf)
        else:
            assert _rel(got, want) <= tol, leaf


# ----------------------------------------------------------------------
# serving: prefill + decode, and hubert's encode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DECODERS)
def test_prefill_matches_reference(name, dtype):
    ref_steps, port_steps = _trajectories(name, dtype)
    _compare_step(ref_steps[0], port_steps[0], _tol(name, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DECODERS)
@pytest.mark.parametrize("step", range(1, N_DECODE + 1))
def test_teacher_forced_decode_matches_reference(name, dtype, step):
    ref_steps, port_steps = _trajectories(name, dtype)
    _compare_step(ref_steps[step], port_steps[step], _tol(name, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_encode_matches_reference(dtype):
    """Frame logits (B, S, V) of the bidirectional encoder, fp32 from
    compute-dtype operands, through `make_encode_step`."""
    ref_cfg, cfg = _cfgs("hubert-xlarge", dtype)
    params = _ref_params(ref_cfg, seed=2)
    emb = np.random.default_rng(3).normal(
        size=(B, 24, cfg.d_model)).astype(np.float32)
    interp = functools.partial(ref_mha, mode="interpret")
    want = jax.jit(lambda p, b: ref_lm.encode(p, ref_cfg, b, attn_fn=interp),
                   compiler_options=PER_OP_ROUNDING)(
        params, {"embeddings": jnp.asarray(emb)})
    before = fa.LAUNCHES
    with torch.no_grad():
        got = make_encode_step(cfg)(params_from_numpy(params, "cpu"),
                                    {"embeddings": torch.from_numpy(emb)})
    assert fa.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == want.shape == \
        (B, 24, cfg.vocab_size)
    assert _rel(got.numpy(), want) <= _tol("hubert-xlarge", dtype)


def test_moe_model_prefill_dispatches_per_row_as_the_reference():
    """B·T > 512: the MoE blocks of a prefill take the per-row dispatch
    with capacity (decode and the smaller prefills above take the flat
    one)."""
    ref_cfg, cfg = _cfgs("granite-moe-1b-a400m", "float32")
    params = _ref_params(ref_cfg, seed=4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             size=(2, 300), dtype=np.int32)
    assert toks.size > 512
    ref = functools.partial(ref_mha, mode="ref")
    want, _ = ref_lm.prefill(params, ref_cfg, {"tokens": jnp.asarray(toks)},
                             ref_init_tree(ref_lm.spec_caches(ref_cfg, 2, 300),
                                           jax.random.PRNGKey(1)),
                             attn_fn=ref)
    with torch.no_grad():
        got, _ = lm.prefill(params_from_numpy(params, "cpu"), cfg,
                            {"tokens": torch.from_numpy(toks)},
                            init_tree(lm.spec_caches(cfg, 2, 300),
                                      torch.Generator(), "cpu"))
    assert _rel(got.numpy(), want) <= FP32_TOL


# ----------------------------------------------------------------------
# registry, specs and inputs
# ----------------------------------------------------------------------
def test_registry_names_every_attention_only_arch():
    """The attention-only archs come first, then the SSM archs (ported
    since ROADMAP A6.5, tests/test_torch_lm_ssm.py), which no longer
    raise."""
    assert ARCH_NAMES[:8] == ("llama3.2-1b", "gemma3-1b", "granite-3-2b",
                              "internlm2-20b", "granite-moe-1b-a400m",
                              "dbrx-132b", "hubert-xlarge", "paligemma-3b")
    assert ARCH_NAMES[8:] == ("xlstm-1.3b", "zamba2-7b")
    for name in ("xlstm-1.3b", "zamba2-7b"):
        assert get_arch(name).name == name


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_arch_matches_reference(name, smoke):
    ref, port = ref_get_arch(name, smoke), get_arch(name, smoke)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert port.dtype == torch.bfloat16
    for shape_name, shape in SHAPES.items():
        assert cell_supported(port, shape) == \
            ref_cell_supported(ref, REF_SHAPES[shape_name])


# the reference's parameter counts of the published configs
PARAMS = {"gemma3-1b": 999_885_952, "granite-3-2b": 2_533_531_648,
          "internlm2-20b": 19_861_149_696,
          "granite-moe-1b-a400m": 1_334_628_352,
          "dbrx-132b": 131_596_523_520, "hubert-xlarge": 1_259_060_480,
          "paligemma-3b": 2_508_662_784}


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_specs_match_reference_shapes_and_counts(name):
    """Params and caches of the published config, by spec alone (no
    tensor is made): every leaf's shape, axes and dtype width, the
    byte and parameter totals."""
    ref_cfg, cfg = ref_get_arch(name), get_arch(name)
    for r_tree, p_tree in ((ref_lm.spec_params(ref_cfg), lm.spec_params(cfg)),
                           (ref_lm.spec_caches(ref_cfg, 4, 640),
                            lm.spec_caches(cfg, 4, 640))):
        r = jax.tree_util.tree_leaves_with_path(
            r_tree, is_leaf=lambda x: hasattr(x, "axes"))
        p = dict(_leaves(p_tree))
        assert len(r) == len(p)
        for path, rs in r:
            leaf = "".join(f"/{k.key}" for k in path)
            assert p[leaf].shape == rs.shape, leaf
            assert p[leaf].axes == rs.axes, leaf
            assert p[leaf].dtype.itemsize == jnp.dtype(rs.dtype).itemsize
        assert spec_bytes(p_tree) == ref_spec_bytes(r_tree)
        assert spec_params(p_tree) == ref_spec_params(r_tree)
    assert spec_params(lm.spec_params(cfg)) == PARAMS[name]


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("name", ["hubert-xlarge", "paligemma-3b",
                                  "gemma3-1b"])
def test_input_specs_match_reference(name, shape_name):
    cfg, shape = get_arch(name), SHAPES[shape_name]
    want = ref_input_specs(ref_get_arch(name), REF_SHAPES[shape_name])
    got = input_specs(cfg, shape)
    assert list(got) == list(want)
    for key, sd in want.items():
        shp, dtype = got[key]
        assert shp == sd.shape, key
        assert str(dtype).replace("torch.", "") == jnp.dtype(sd.dtype).name


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["hubert-xlarge", "paligemma-3b"])
def test_make_inputs_follow_the_specs(name, kind):
    cfg = get_arch(name, smoke=True)
    shape = ShapeConfig("small", kind, 24, 3)
    a = make_inputs(cfg, shape, seed=1, device="cpu")
    b = make_inputs(cfg, shape, seed=1, device="cpu")
    specs = input_specs(cfg, shape)
    assert list(a) == list(specs)
    for key, (shp, dtype) in specs.items():
        assert a[key].shape == shp and a[key].dtype == dtype, key
        assert torch.equal(a[key], b[key]), key
        if not dtype.is_floating_point:
            assert int(a[key].min()) >= 0
            assert int(a[key].max()) < cfg.vocab_size


def test_make_inputs_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_inputs(get_arch("hubert-xlarge", True), SHAPES["prefill_32k"])


# ----------------------------------------------------------------------
# serving entry points
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "paligemma-3b"])
def test_init_serving_casts_each_leaf_as_the_fp32_init_would(name):
    """The cast-on-draw init gives the values of the fp32 init cast
    afterwards (`lm.cast_matmul_weights`), leaf for leaf, bit for bit."""
    cfg = get_arch(name, smoke=True)
    params, caches = serve.init_serving(cfg, 2, 12, 3, "cpu")
    want = lm.cast_matmul_weights(init_tree(
        lm.spec_params(cfg), torch.Generator().manual_seed(3), "cpu"),
        cfg.dtype)
    got, ref = dict(_leaves(params)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for leaf, t in ref.items():
        assert got[leaf].dtype == t.dtype and torch.equal(got[leaf], t), leaf
    assert got["/final_norm/scale"].dtype == torch.float32
    assert got["/groups/p0/moe/router" if "moe" in name
               else "/embed"].dtype == torch.bfloat16
    assert caches["groups"]["p0"]["attn"]["k"].shape[3] == 12   # slots


def test_paligemma_batch_is_the_reference_stream():
    """Prompts, then the prefix embeddings, from one numpy generator
    seeded with --seed: the reference CLI's draws, value for value."""
    cfg = get_arch("paligemma-3b", smoke=True)
    got = serve.make_batch(cfg, 3, 10, 11, "cpu")
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, size=(3, 10), dtype=np.int32)
    pfx = rng.normal(size=(3, cfg.num_prefix_embeddings,
                           cfg.d_model)).astype(np.float32)
    assert list(got) == ["tokens", "prefix_embeddings"]
    np.testing.assert_array_equal(got["tokens"].numpy(), prompts)
    np.testing.assert_array_equal(got["prefix_embeddings"].numpy(), pfx)
    assert "prefix_embeddings" not in serve.make_batch(
        get_arch("gemma3-1b", True), 3, 10, 11, "cpu")


def test_reference_cli_cache_sizing_raises_for_paligemma():
    """ROADMAP C, R4: the reference's CLI sizes the caches to
    prompt_len + gen, without the prefix; with gen < npfx the prefill's
    context (npfx + prompt_len) outgrows the global-attention cache and
    the reference's `attention_apply` raises."""
    ref_cfg = ref_get_arch("paligemma-3b", True)
    npfx, prompt_len, gen = ref_cfg.num_prefix_embeddings, 6, 4
    assert gen < npfx
    params = _ref_params(ref_cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(
        0, ref_cfg.vocab_size, size=(2, prompt_len), dtype=np.int32)),
        "prefix_embeddings": jnp.asarray(rng.normal(size=(
            2, npfx, ref_cfg.d_model)).astype(np.float32))}
    interp = functools.partial(ref_mha, mode="interpret")
    with pytest.raises(ValueError, match="global-attention cache has"):
        ref_lm.prefill(params, ref_cfg, batch,
                       ref_init_tree(ref_lm.spec_caches(ref_cfg, 2,
                                                        prompt_len + gen),
                                     jax.random.PRNGKey(1)),
                       attn_fn=interp)
    # the same call on caches of the whole context runs
    logits, _ = ref_lm.prefill(
        params, ref_cfg, batch,
        ref_init_tree(ref_lm.spec_caches(ref_cfg, 2, npfx + prompt_len + gen),
                      jax.random.PRNGKey(1)), attn_fn=interp)
    assert np.isfinite(np.asarray(logits)).all()


def test_serve_cli_serves_paligemma_with_a_short_generation():
    """The port's CLI sizes its caches to the whole context, so gen <
    npfx serves; its tokens are the greedy chain of prefill + decode at
    positions npfx + prompt_len + i."""
    cfg = get_arch("paligemma-3b", smoke=True)
    npfx = cfg.num_prefix_embeddings
    out = serve.main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--gen", "4",
                      "--seed", "5"])
    assert out["launches"] == {"prefill": 0, "decode": 0}
    params, caches = serve.init_serving(cfg, 2, npfx + 6 + 4, 5, "cpu")
    batch = serve.make_batch(cfg, 2, 6, 5, "cpu")
    with torch.no_grad():
        logits, caches = make_prefill_step(cfg)(params, batch, caches)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(3):
            tok, _, caches = make_decode_step(cfg)(params, tok, caches,
                                                   npfx + 6 + i)
            toks.append(tok)
    np.testing.assert_array_equal(out["tokens"], torch.cat(toks, 1).numpy())
    assert torch.equal(out["prefill_logits"], logits)


@pytest.mark.parametrize("name", ["gemma3-1b", "granite-3-2b",
                                  "internlm2-20b", "granite-moe-1b-a400m",
                                  "dbrx-132b"])
def test_serve_cli_runs_each_decoder_on_the_cpu(name):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    cfg = get_arch(name, smoke=True)
    assert out["launches"] == {"prefill": 0, "decode": 0}
    assert out["tokens"].shape == (2, 3)
    assert out["prefill_logits"].shape == (2, cfg.vocab_size)
    assert torch.isfinite(out["prefill_logits"]).all()
    assert torch.isfinite(out["last_logits"]).all()


def test_serve_cli_refuses_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    cfg = get_arch("hubert-xlarge", smoke=True)
    with pytest.raises(ValueError, match="encoder-only"):
        lm.decode_step({}, cfg, torch.zeros(1, 1, dtype=torch.int32), {}, 0)


def test_encode_step_is_the_encoder_forward():
    cfg = get_arch("hubert-xlarge", smoke=True)
    params = serve.init_params(cfg, 0, "cpu")
    batch = make_inputs(cfg, ShapeConfig("small", "prefill", 8, 2), 0, "cpu")
    with torch.no_grad():
        got = make_encode_step(cfg)(params, batch)
        want = lm.encode(params, cfg, batch)
    assert torch.equal(got, want) and got.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(got).all()
