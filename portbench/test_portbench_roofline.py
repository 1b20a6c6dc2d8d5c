"""The frozen roofline count against bytes and operations worked out by
hand: K3 (bf16 weights, kv8 cache) at 8 rows and K2+K6+K4 (int8 weights,
kv4 cache, a position per row) at 64 slots, at ChatTTS's widths."""

import pytest

from harness import roofline

GPT = {"hidden_size": 768, "intermediate_size": 3072,
       "num_attention_heads": 12, "num_hidden_layers": 20,
       "num_audio_tokens": 626, "num_vq": 4}
BW, PEAK = 3.35e12, 989e12


def ms(nbytes):
    return nbytes / BW * 1e3


def test_k3_at_8_rows():
    seen = [257] * 8
    b = roofline.kernel_bounds(GPT, seen, kv_bits=8, weight_bits=0)
    # qkv: 2304 x 768 bf16 weights, 8 f32 input rows, the norm's 768
    # f32 weights, 8 f32 output rows
    assert b["gemv qkv"] == (pytest.approx(ms(
        2304 * 768 * 2 + 8 * 768 * 4 + 768 * 4 + 8 * 2304 * 4)), "bytes")
    # wo adds to its output: read and written
    assert b["gemv wo"][0] == pytest.approx(ms(
        768 * 768 * 2 + 8 * 768 * 4 + 2 * 8 * 768 * 4))
    assert b["gemv gate/up"][0] == pytest.approx(ms(
        6144 * 768 * 2 + 8 * 768 * 4 + 768 * 4 + 8 * 6144 * 4))
    # down reads the 2 x 3072 gate/up values of a row (silu in its
    # prologue)
    assert b["gemv down"][0] == pytest.approx(ms(
        768 * 3072 * 2 + 8 * 6144 * 4 + 2 * 8 * 768 * 4))
    # the pair: the 256 stored rows a row sees, k and v, 768 values and
    # one 32-byte sector of the 24 scale bytes; cos, sin, cur, lo; q; the
    # new k and v in and their 896-byte rows out; o
    assert b["attention pair"][0] == pytest.approx(ms(
        2 * 8 * 256 * 800 + (2 * 8 * 64 * 4 + 2 * 8 * 4) + 8 * 768 * 4
        + (8 * 2 * 768 * 4 + 2 * 8 * 896) + 8 * 768 * 4))
    assert "kv4_append_kernel" not in b


def test_k2k6k4_at_64_slots():
    seen = [100 + 3 * i for i in range(63)] + [0]   # one empty slot
    b = roofline.kernel_bounds(GPT, seen, kv_bits=4, weight_bits=8)
    rows = sum(seen)
    # int8 weights: a byte each and one f32 scale per (768-row group,
    # column)
    assert b["gemv qkv"][0] == pytest.approx(ms(
        2304 * 768 + 2304 * 4 + 64 * 768 * 4 + 768 * 4 + 64 * 2304 * 4))
    assert b["gemv down"][0] == pytest.approx(ms(
        768 * 3072 + 768 * 4 * 4 + 64 * 6144 * 4 + 2 * 64 * 768 * 4))
    # kv4: the append is its own kernel, the pair reads every visible row
    # (384 value bytes and a 32-byte sector of scales)
    assert b["attention pair"][0] == pytest.approx(ms(
        2 * rows * 416 + (2 * 64 * 64 * 4 + 2 * 64 * 4) + 2 * 64 * 768 * 4))
    assert b["kv4_append_kernel"][0] == pytest.approx(ms(
        64 * 2 * 768 * 4 + 2 * 63 * 512 + (2 * 64 * 64 * 4 + 2 * 64 * 4)))


def test_int4_weights_take_128_row_groups():
    b = roofline.kernel_bounds(GPT, [10], kv_bits=8, weight_bits=4)
    assert b["gemv wo"][0] == pytest.approx(ms(
        768 * 768 / 2 + 768 * 6 * 4 + 768 * 4 + 2 * 768 * 4))


def test_a_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_ms(1e6, 0) == (pytest.approx(1e6 / BW * 1e3),
                                         "bytes")
    assert roofline.bound_ms(0, 1e12) == (pytest.approx(1e12 / PEAK * 1e3),
                                          "operations")


def test_model_operations():
    P = 4 * 768 * 768 + 3 * 768 * 3072
    assert roofline.layer_params(GPT) * 20 == 188_743_680
    heads = 2 * 768 * 626 * 4
    assert roofline.decode_step_flops(GPT, [5, 7]) == pytest.approx(
        2 * (2 * 20 * P + heads) + 20 * 4 * 12 * 768)
    assert roofline.prefill_flops(GPT, [3]) == pytest.approx(
        2 * 20 * P * 3 + 20 * 4 * 768 * 6)
