"""The port's kv8 wire format against the JAX functions (CPU).

``kv8_quantize`` must be byte-identical and ``kv8_dequantize`` value-identical
to ``chattts_tpu.ops.pallas_step``'s: a cache quantized by either package is
read by the other's decode step.

One fact of the CPU backend shapes the inputs.  XLA on the CPU computes
``exp2(n)`` through ``exp`` and is one unit in the last place off for most
integers with |n| >= 13, while the port builds powers of two from exponent
bits.  A stored scale ``m * 2^es`` with es <= -13 therefore differs by one
ulp between the two *on this backend*, which can move a value that sits on
a rounding tie.  The byte-identity tests use rows whose per-head absmax lies
in [2, 4e5), where every exponent the formula touches (e in [-6, 12], es in
[-12, 6]) is exact in both packages; there the tolerance is zero.  A further
test runs O(1) rows (es around -13), counts the differing bytes (limit: 1 in
10^4, each by one quantization step) and holds the scale bytes to equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.config import GPTConfig
from chattts_tpu.ops import pallas_step
from chattts_tpu_torch.ops import kv_quant
from torch_port_utils import port_config

CFG = GPTConfig(hidden_size=128, intermediate_size=256,
                num_attention_heads=2, num_hidden_layers=1,
                max_position_embeddings=64)
PCFG = port_config(CFG)
H, Dh = CFG.num_attention_heads, CFG.head_dim
HD = H * Dh


def _both(x: np.ndarray):
    ref = np.asarray(pallas_step.kv8_quantize(jnp.asarray(x), CFG))
    got = kv_quant.kv8_quantize(torch.from_numpy(x), PCFG).numpy()
    return got, ref


def test_pad_constant_matches():
    assert kv_quant.KV_PAD == pallas_step.KV_PAD


def test_quantize_random_rows_byte_identical():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 40, HD)) * 6.0).astype(np.float32)
    x *= rng.uniform(1.0, 2000.0, size=(3, 5, 40, 1)).astype(np.float32)
    amax = np.abs(x.reshape(-1, H, Dh)).max(-1)
    assert amax.min() >= 2.0 and amax.max() < 4e5  # the exact-exp2 range
    got, ref = _both(x)
    assert got.dtype == np.int8 and got.shape == ref.shape
    assert got.shape[-1] == HD + kv_quant.KV_PAD
    np.testing.assert_array_equal(got, ref)


def test_quantize_bf16_input_byte_identical():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, HD)) * 8.0).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    ref = np.asarray(pallas_step.kv8_quantize(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), CFG))
    got = kv_quant.kv8_quantize(xb, PCFG).numpy()
    np.testing.assert_array_equal(got, ref)


def test_all_zero_row_and_all_zero_head():
    x = np.zeros((3, HD), np.float32)
    x[1, :Dh] = np.linspace(-9.0, 9.0, Dh)   # head 0 live, head 1 zero
    x[2, Dh:] = 5.0
    got, ref = _both(x)
    np.testing.assert_array_equal(got, ref)
    # an all-zero head stores m = 0 (its exponent byte is that of 1e-30)
    assert not got[0, :HD + H].any()
    assert got[1, HD + 1] == 0 and got[1, HD] >= 64
    back = kv_quant.kv8_dequantize(torch.from_numpy(got), PCFG).numpy()
    assert not back[0].any() and not back[1, Dh:].any()


@pytest.mark.parametrize("k", list(range(-5, 12)))
@pytest.mark.parametrize("ulps", [-1, 0, 1])
def test_power_of_two_boundary(k, ulps):
    """absmax / 127 an exact power of two 2^k, one ulp below, one above: the
    mantissa wraps (m 128 -> 64, e + 1) exactly at the boundary."""
    sc = np.float32(2.0) ** np.float32(k)
    a = np.float32(127.0) * sc
    if ulps:
        a = np.nextafter(a, np.float32(np.inf if ulps > 0 else -np.inf),
                         dtype=np.float32)
    rng = np.random.default_rng(100 + k)
    x = (rng.uniform(-1, 1, size=(4, HD)) * a).astype(np.float32)
    x[:, 0] = a
    x[:, Dh] = -a
    got, ref = _both(x)
    np.testing.assert_array_equal(got, ref)
    m, es = got[:, HD:HD + H], got[:, HD + H:HD + 2 * H]
    if np.float32(a) / np.float32(127.0) == sc:
        assert (m == 64).all() and (es == k - 6).all()
        assert (np.abs(got[:, 0]) == 127).all()
    # the mantissa rounds up, so the absmax value lands at or just below 127
    assert 125 <= np.abs(got[:, 0]).min()


def test_dequantize_identical():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 9, HD)) * 7.0).astype(np.float32)
    rows = np.array(pallas_step.kv8_quantize(jnp.asarray(x), CFG))
    ref = np.asarray(pallas_step.kv8_dequantize(jnp.asarray(rows), CFG))
    got = kv_quant.kv8_dequantize(torch.from_numpy(rows), PCFG).numpy()
    np.testing.assert_array_equal(got, ref)
    # within half a quantization step of the input
    step = kv_quant.row_scales(torch.from_numpy(rows), PCFG).numpy()
    err = np.abs(got - x).reshape(4, 9, H, Dh)
    assert (err <= 0.5 * step[..., None] * (1 + 1e-6)).all()


def test_unit_scale_rows_differ_only_at_rounding_ties():
    """O(1) rows (cache-like magnitudes): es is about -13, where the CPU
    backend's exp2 is one ulp off.  Scale bytes stay equal; value bytes may
    differ at ties, by one step, in fewer than 1 of 10^4 bytes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 64, HD)).astype(np.float32)
    got, ref = _both(x)
    np.testing.assert_array_equal(got[..., HD:], ref[..., HD:])
    diff = got[..., :HD].astype(np.int32) - ref[..., :HD].astype(np.int32)
    n = int((diff != 0).sum())
    print(f"unit-scale rows: {n} of {diff.size} value bytes differ")
    assert np.abs(diff).max() <= 1
    assert n <= diff.size // 10_000


def test_too_many_heads_rejected():
    import dataclasses
    wide = dataclasses.replace(PCFG, num_attention_heads=128, hidden_size=8192)
    with pytest.raises(ValueError, match="too many heads"):
        kv_quant.kv8_quantize(torch.zeros((1, 8192)), wide)


# ---- the int4 rows ---------------------------------------------------------
# kv4 needs HD % 256 == 0, so these run tests/test_pallas_step.py's CFG4.
# Scales are absmax / 7: the exponents the formula touches are exact in both
# packages for per-head absmax in [0.125, 2e4) (e in [-6, 11]).

CFG4 = GPTConfig(hidden_size=256, intermediate_size=512,
                 num_attention_heads=2, num_hidden_layers=1,
                 max_position_embeddings=64)
PCFG4 = port_config(CFG4)
H4, Dh4 = CFG4.num_attention_heads, CFG4.head_dim
HD4 = H4 * Dh4


def _both4(x: np.ndarray):
    ref = np.array(pallas_step.kv4_quantize(jnp.asarray(x), CFG4))
    got = kv_quant.kv4_quantize(torch.from_numpy(x), PCFG4).numpy()
    return got, ref


def test_kv4_quantize_random_rows_byte_identical():
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((3, 5, 40, HD4)) * 2.0).astype(np.float32)
    x *= rng.uniform(1.0, 800.0, size=(3, 5, 40, 1)).astype(np.float32)
    amax = np.abs(x.reshape(-1, H4, Dh4)).max(-1)
    assert amax.min() >= 0.125 and amax.max() < 2e4  # the exact-exp2 range
    got, ref = _both4(x)
    assert got.dtype == np.int8 and got.shape == ref.shape
    assert got.shape[-1] == HD4 // 2 + kv_quant.KV_PAD
    np.testing.assert_array_equal(got, ref)
    assert not got[..., HD4 // 2 + 2 * H4:].any()


def test_kv4_nibble_order():
    """Feature f < HD/2 rides the low nibble of byte f, feature HD/2 + f the
    high nibble: head 0 is all low nibbles here, head 1 all high ones."""
    x = np.zeros((1, HD4), np.float32)
    x[0, :Dh4] = 7.0     # head 0: every value quantizes to 7
    x[0, Dh4:] = -3.5    # head 1: every value to -7
    got, ref = _both4(x)
    np.testing.assert_array_equal(got, ref)
    b = got[0, :HD4 // 2].astype(np.int32)
    assert ((b & 15) == 7).all() and ((b >> 4) == -7).all()
    vals = kv_quant.unpack_nibbles(torch.from_numpy(got[:, :HD4 // 2]))
    assert (vals[0, :Dh4] == 7).all() and (vals[0, Dh4:] == -7).all()


def test_kv4_zero_rows_and_heads():
    x = np.zeros((3, HD4), np.float32)
    x[1, :Dh4] = np.linspace(-9.0, 9.0, Dh4)
    x[2, Dh4:] = 5.0
    got, ref = _both4(x)
    np.testing.assert_array_equal(got, ref)
    back = kv_quant.kv4_dequantize(torch.from_numpy(got), PCFG4).numpy()
    assert not back[0].any() and not back[1, Dh4:].any()
    assert not back[2, :Dh4].any() and back[2, Dh4:].min() > 4.9


@pytest.mark.parametrize("k", list(range(-5, 10)))
@pytest.mark.parametrize("ulps", [-1, 0, 1])
def test_kv4_power_of_two_boundary(k, ulps):
    """absmax / 7 an exact power of two, one ulp below and one above."""
    sc = np.float32(2.0) ** np.float32(k)
    a = np.float32(7.0) * sc
    if ulps:
        a = np.nextafter(a, np.float32(np.inf if ulps > 0 else -np.inf),
                         dtype=np.float32)
    rng = np.random.default_rng(200 + k)
    x = (rng.uniform(-1, 1, size=(4, HD4)) * a).astype(np.float32)
    x[:, 0] = a
    x[:, Dh4] = -a
    got, ref = _both4(x)
    np.testing.assert_array_equal(got, ref)
    m = got[:, HD4 // 2:HD4 // 2 + H4]
    es = got[:, HD4 // 2 + H4:HD4 // 2 + 2 * H4]
    if np.float32(a) / np.float32(7.0) == sc:
        assert (m == 64).all() and (es == k - 6).all()


def test_kv4_dequantize_identical_and_within_half_a_step():
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((4, 9, HD4)) * 7.0).astype(np.float32)
    rows = np.array(pallas_step.kv4_quantize(jnp.asarray(x), CFG4))
    ref = np.asarray(pallas_step.kv4_dequantize(jnp.asarray(rows), CFG4))
    got = kv_quant.kv4_dequantize(torch.from_numpy(rows), PCFG4).numpy()
    np.testing.assert_array_equal(got, ref)
    step = kv_quant.row_scales(torch.from_numpy(rows), PCFG4).numpy()
    err = np.abs(got - x).reshape(4, 9, H4, Dh4)
    assert (err <= 0.5 * step[..., None] * (1 + 1e-6)).all()


def test_kv4_unit_scale_rows_differ_only_at_rounding_ties():
    """O(1) rows: es is about -9, inside the exact range of this backend's
    exp2 too; held to the kv8 test's limits all the same (scale bytes
    equal, value nibbles off by at most one step in 1 of 10^4)."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((64, 64, HD4)).astype(np.float32)
    got, ref = _both4(x)
    np.testing.assert_array_equal(got[..., HD4 // 2:], ref[..., HD4 // 2:])
    vg = kv_quant.unpack_nibbles(torch.from_numpy(got[..., :HD4 // 2])).numpy()
    vr = kv_quant.unpack_nibbles(torch.from_numpy(ref[..., :HD4 // 2])).numpy()
    n = int((vg != vr).sum())
    print(f"unit-scale kv4 rows: {n} of {vg.size} values differ")
    assert np.abs(vg - vr).max() <= 1
    assert n <= vg.size // 10_000


def test_kv4_rejects_unpackable_geometry():
    assert kv_quant.kv4_packable(PCFG4) and not kv_quant.kv4_packable(PCFG)
    with pytest.raises(ValueError, match="kv-int4-packable"):
        kv_quant.kv4_quantize(torch.zeros((1, HD)), PCFG)
