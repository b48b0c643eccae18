"""The port's gradient compression (`repro_torch.dist.compression`)
against the reference's `repro.dist.compression`, on the CPU.

* `quantize_symmetric`/`dequantize` are bit-equal to the reference's
  (codes, scales and the dequantized values, compared as bits) for bits
  4 and 8, group None, 1024 and odd sizes, tensors that need padding, an
  all-zero tensor, and tensors holding inf and NaN.
* The reference's properties, in the port: the round trip errs by at
  most scale/2, error feedback keeps the signal, int4 errs more than
  int8, grouped scales beat one per tensor on mixed magnitudes, small
  tensors keep one scale, grouped scales need their group size.
* `psum_mean`, `bf16_psum_mean` and `compressed_psum_mean` on a world of
  1 (gloo) against the reference's arithmetic on one shard (the
  reference's bare `compressed_psum_mean` under shard_map fails on jax
  0.9, ROADMAP C R3; its full data-parallel step is compared on 2 ranks
  in tests/test_torch_dp.py). Bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.dist import compression as ref
from repro_torch.dist import compression as port


def _cases():
    rng = np.random.default_rng(0)
    mixed = np.concatenate([rng.normal(size=700) * 1e-3,
                            rng.normal(size=700) * 10.0])
    with_inf = rng.normal(size=300)
    with_inf[[3, 77]] = [np.inf, -np.inf]
    with_nan = rng.normal(size=50)
    with_nan[5] = np.nan
    # max 7: with 4 bits the scale is exactly 1, so x/scale lands on
    # halves and the rounding must go to even, as jnp.rint does
    ties = np.arange(-14, 15, dtype=np.float64) / 2.0
    return {
        "normal_2d": rng.normal(size=(40, 100)) * 2.0,
        "padded_4000": rng.normal(size=4000),
        "odd_1001": rng.normal(size=1001) * 0.1,
        "mixed": mixed,
        "tiny_7": rng.normal(size=7),
        "zeros": np.zeros((33, 5)),
        "ties": ties,
        "with_inf": with_inf,
        "with_nan": with_nan,
    }


CASES = _cases()
GROUPS = [None, 1024, 7, 100]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("group", GROUPS, ids=[f"g{g}" for g in GROUPS])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_is_bit_equal_to_reference(name, bits, group):
    x = CASES[name].astype(np.float32)
    rq, rs = ref.quantize_symmetric(jnp.asarray(x), bits=bits,
                                    group_size=group)
    q, s = port.quantize_symmetric(torch.from_numpy(x), bits=bits,
                                   group_size=group)
    assert q.dtype == torch.int8 and tuple(q.shape) == x.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert tuple(s.shape) == tuple(np.shape(rs))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(rs))
    rd = ref.dequantize(rq, rs, group_size=group)
    d = port.dequantize(q, s, group_size=group)
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(rd))


def test_quantize_roundtrip_bounded_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)) * 3.0
    q, scale = port.quantize_symmetric(x, bits=8)
    err = (port.dequantize(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


@pytest.mark.parametrize("group", [None, 32])
def test_error_feedback_preserves_signal(group):
    """The sum of dequantized messages tracks the sum of true gradients
    (the residual telescopes), per tensor and grouped, on a gradient of
    mixed magnitudes."""
    rng = np.random.default_rng(6)
    true = torch.from_numpy(np.concatenate([
        rng.normal(size=(32,)) * 1e-4,
        rng.normal(size=(32,)) * 0.1]).astype(np.float32))
    err = torch.zeros_like(true)
    sent = torch.zeros_like(true)
    for _ in range(50):
        x = true + err
        q, s = port.quantize_symmetric(x, bits=8, group_size=group)
        deq = port.dequantize(q, s, group_size=group)
        err = x - deq
        sent += deq
    np.testing.assert_allclose((sent / 50).numpy(), true.numpy(),
                               atol=2e-4)


def test_int4_more_error_than_int8():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32))
    e = {}
    for bits in (4, 8):
        q, s = port.quantize_symmetric(x, bits=bits)
        e[bits] = float((port.dequantize(q, s) - x).abs().max())
    assert e[4] > 4 * e[8]


def test_grouped_beats_per_tensor_on_heterogeneous_magnitudes():
    rng = np.random.default_rng(4)
    small = rng.normal(size=(1024,)).astype(np.float32) * 1e-3
    big = rng.normal(size=(1024,)).astype(np.float32) * 10.0
    x = torch.from_numpy(np.concatenate([small, big]))
    q_t, s_t = port.quantize_symmetric(x, bits=8)
    q_g, s_g = port.quantize_symmetric(x, bits=8, group_size=1024)
    assert tuple(s_g.shape) == (2,)
    err_t = np.abs(port.dequantize(q_t, s_t)[:1024].numpy() - small).max()
    err_g = np.abs(port.dequantize(q_g, s_g, group_size=1024)[:1024]
                   .numpy() - small).max()
    assert err_g < err_t / 100, (err_g, err_t)


def test_small_tensor_keeps_scalar_scale_and_grouped_needs_its_size():
    x = torch.linspace(-1, 1, 100)
    q, scale = port.quantize_symmetric(x, bits=8, group_size=1024)
    assert scale.dim() == 0
    q, scale = port.quantize_symmetric(torch.randn(300), bits=8,
                                       group_size=128)
    assert tuple(scale.shape) == (3,)
    with pytest.raises(ValueError, match="group_size"):
        port.dequantize(q, scale)
    with pytest.raises(ValueError, match="bits"):
        port.quantize_symmetric(x, bits=3)
    with pytest.raises(ValueError, match="group_size"):
        port.quantize_symmetric(torch.randn(300), group_size=0)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("bits", [4, 8])
def test_collectives_on_one_rank_match_reference_arithmetic(world_of_one,
                                                           bits):
    rng = np.random.default_rng(7)
    g = rng.normal(size=(3000,)).astype(np.float32)
    e = (rng.normal(size=(3000,)) * 1e-3).astype(np.float32)
    np.testing.assert_array_equal(
        port.psum_mean(torch.from_numpy(g)).numpy(), g)
    want = np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(
        _bits(port.bf16_psum_mean(torch.from_numpy(g)).numpy()),
        _bits(want))
    x = jnp.asarray(g) + jnp.asarray(e)
    rq, rs = ref.quantize_symmetric(x, bits=bits,
                                    group_size=ref.DEFAULT_GROUP_SIZE)
    rdeq = ref.dequantize(rq, rs, group_size=ref.DEFAULT_GROUP_SIZE)
    mean, new_err = port.compressed_psum_mean(
        torch.from_numpy(g), torch.from_numpy(e), bits=bits)
    np.testing.assert_array_equal(_bits(mean.numpy()), _bits(rdeq))
    np.testing.assert_array_equal(_bits(new_err.numpy()),
                                  _bits(x - rdeq))
