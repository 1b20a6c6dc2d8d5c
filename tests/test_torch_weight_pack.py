"""The port's int8 and int4 weight packs against the JAX package's (CPU).

``pack_weights(weight_bits=8|4)`` must give the integers and the scales of
``pack_step_params(int8=|int4=)``, value for value: both packages then
compute the same step.  The port stores (N, K) matrices, the reference
square (D, D) slabs ``[q | k | v | wo | gate.. | up.. | down..]`` with
``down`` cut along its contraction; ``to_slabs`` rearranges the former into
the latter, integers and scales, and the comparison is equality.

The reference's int8 branch computes in the parameters' dtype (bf16
parameters: bf16 scales, bf16 division), its int4 branch in f32; the port
follows each, so equality holds for bf16 and for f32 parameters alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.config import GPTConfig
from chattts_tpu.models import llama as jl
from chattts_tpu.ops import pallas_step
from chattts_tpu_torch.ops import decode_step as ds
from torch_port_utils import bridge, port_config

GEOMETRIES = {
    # tests/test_pallas_step.py's CFG: int4 groups shrink to D/2 = 64 rows
    "d128": GPTConfig(hidden_size=128, intermediate_size=256,
                      num_attention_heads=2, num_hidden_layers=3,
                      max_position_embeddings=128),
    # its CFG4: groups of 128 rows, two to a slab
    "d256": GPTConfig(hidden_size=256, intermediate_size=512,
                      num_attention_heads=2, num_hidden_layers=2,
                      max_position_embeddings=128),
    # three slabs to the MLP's contraction, as at the full width (I = 4 D
    # there), and four heads
    "d128_i384": GPTConfig(hidden_size=128, intermediate_size=384,
                           num_attention_heads=4, num_hidden_layers=1,
                           max_position_embeddings=128),
}


def to_slabs(packed: dict, cfg):
    """The port's packed matrices -> (W (L*S, D, D) int32, wscale (L, S, G,
    D) f32) in the reference's slab order, G groups a slab."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    r = I // D
    L = packed["wqkv"].shape[0]
    W, scales = [], []
    for li in range(L):
        def rows(name, j):  # output columns [jD, (j+1)D) over all of K = D
            m = ds.unpack_matrix(packed[name][li], D)[j * D:(j + 1) * D]
            s = packed["s" + name[1:]][li][j * D:(j + 1) * D]
            return m.T, s.T                       # (K, N) and (G, N)

        def down(j):        # contraction rows [jD, (j+1)D) of all columns
            m = ds.unpack_matrix(packed["wd"][li], I)[:, j * D:(j + 1) * D]
            s = packed["sd"][li]
            G = s.shape[1] // r
            return m.T, s[:, j * G:(j + 1) * G].T

        parts = ([rows("wqkv", j) for j in range(3)] + [rows("wo", 0)]
                 + [rows("wgu", j) for j in range(2 * r)]
                 + [down(j) for j in range(r)])
        W += [m for m, _ in parts]
        scales.append(torch.stack([s for _, s in parts]))
    return (torch.stack(W).to(torch.int32).numpy(),
            torch.stack(scales).numpy())


def _reference_slabs(ref: dict, cfg, bits: int):
    W = np.asarray(ref["W"]).astype(np.int32)
    ws = np.asarray(ref["wscale"])
    if bits == 4:   # rows [0, D/2) in the low nibbles, [D/2, D) in the high
        W = np.concatenate([(W << 28) >> 28, W >> 4], axis=1)
    else:
        ws = ws[:, :, None, :]
    return W, ws


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_pack_equals_reference_pack(geom, bits, dtype):
    cfg = GEOMETRIES[geom]
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    if dtype == "f32":
        params = jax.tree_util.tree_map(
            lambda a: (a.astype(jnp.float32) * 1.37
                       if a.dtype == jnp.bfloat16 else a), params)
    ref = pallas_step.pack_step_params(params, cfg, int8=bits == 8,
                                       int4=bits == 4)
    got = ds.pack_weights(bridge(params), port_config(cfg), weight_bits=bits)
    assert ds.weight_bits_of(got, port_config(cfg)) == bits
    W_ref, ws_ref = _reference_slabs(ref, cfg, bits)
    W, ws = to_slabs(got, cfg)
    assert W.shape == W_ref.shape and ws.shape == ws_ref.shape
    assert np.abs(W).max() == (127 if bits == 8 else 7)
    np.testing.assert_array_equal(W, W_ref)
    np.testing.assert_array_equal(ws, ws_ref)
    np.testing.assert_array_equal(got["ln1"].numpy(), np.asarray(ref["ln1"]))
    np.testing.assert_array_equal(got["ln2"].numpy(), np.asarray(ref["ln2"]))


def test_pack_shapes_and_groups():
    cfg = port_config(GEOMETRIES["d256"])
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    gen = torch.Generator().manual_seed(0)
    from chattts_tpu_torch.models import llama as tl

    params = tl.init_params(gen, cfg)
    p0 = ds.pack_weights(params, cfg)
    assert p0["wqkv"].dtype == torch.bfloat16 and "sqkv" not in p0
    p8 = ds.pack_weights(params, cfg, weight_bits=8)
    assert p8["wd"].shape == (L, D, I) and p8["wd"].dtype == torch.int8
    # one scale a column, but I/D of them along down's contraction
    assert p8["sqkv"].shape == (L, 3 * D, 1) and p8["sd"].shape == (L, D, I // D)
    p4 = ds.pack_weights(params, cfg, weight_bits=4)
    assert ds.int4_group(D) == 128 and ds.int4_group(128) == 64
    assert p4["wgu"].shape == (L, 2 * I, D // 2)
    assert p4["sgu"].shape == (L, 2 * I, D // 128)
    assert p4["sd"].shape == (L, D, I // 128)
    assert [ds.weight_bits_of(p, cfg) for p in (p0, p8, p4)] == [0, 8, 4]


def test_nibble_pack_round_trip():
    q = torch.randint(-7, 8, (5, 16), generator=torch.Generator().manual_seed(1),
                      dtype=torch.int8)
    packed = ds.pack_nibbles(q)
    assert packed.shape == (5, 8) and packed.dtype == torch.int8
    # value 2j rides the low nibble of byte j, value 2j + 1 the high one
    b = packed.to(torch.int32)
    assert torch.equal((b << 28) >> 28, q[:, 0::2].to(torch.int32))
    assert torch.equal(b >> 4, q[:, 1::2].to(torch.int32))
    assert torch.equal(ds.unpack_matrix(packed, 16), q.float())


def test_dequantized_pack_within_half_a_scale():
    cfg = port_config(GEOMETRIES["d256"])
    from chattts_tpu_torch.models import llama as tl

    params = tl.init_params(torch.Generator().manual_seed(2), cfg,
                            dtype=torch.float32)
    w = params["layers"][0]["mlp"]["down"]                      # (I, D)
    for bits in (8, 4):
        p = ds.pack_weights(params, cfg, weight_bits=bits)
        q = ds.unpack_matrix(p["wd"][0], cfg.intermediate_size)  # (D, I)
        s = p["sd"][0]                                           # (D, G)
        deq = q * s.repeat_interleave(q.shape[1] // s.shape[1], dim=1)
        err = (deq - w.T).abs()
        lim = 0.5 * s.repeat_interleave(q.shape[1] // s.shape[1], dim=1)
        assert bool((err <= lim * (1 + 1e-5)).all())


def test_pack_rejects_bad_arguments():
    from chattts_tpu_torch.config import GPTConfig as PortConfig
    from chattts_tpu_torch.models import llama as tl

    cfg = port_config(GEOMETRIES["d128"])
    params = tl.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="weight_bits"):
        ds.pack_weights(params, cfg, weight_bits=2)
    ragged = PortConfig(hidden_size=96, intermediate_size=200,
                        num_attention_heads=3, num_hidden_layers=1,
                        max_position_embeddings=64)
    rp = tl.init_params(torch.Generator().manual_seed(0), ragged)
    assert ds.pack_weights(rp, ragged)["wd"].shape == (1, 96, 200)
    for bits in (8, 4):
        with pytest.raises(ValueError, match="slab geometry"):
            ds.pack_weights(rp, ragged, weight_bits=bits)
