"""The kv4 cache's append on its own (``decode_step.kv4_append``, CPU path
``kv4_append_plain``) against the JAX package's arithmetic, at two kv4
geometries on the CPU.

The reference kernel ropes k as ``k cos + (bf16(k) @ R) sin`` with R the +-1
rotate_half matrix (``pallas_step.rope_rotate_matrix``), then quantizes k
and v to kv4 rows (``pallas_step.kv4_quantize``).  The port's append must
give the same bytes at the rows it writes, for per-head absmax in the range
where both packages' powers of two are exact (tests/test_torch_kv_quant.py),
leave every other row untouched, and write what ``decode_step_plain``
writes into layer 0 for the same qkv.  The card's kernel is held to this
plain version byte for byte in tests/test_torch_kv4_append_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.config import GPTConfig
from chattts_tpu.ops import pallas_step
from chattts_tpu_torch.models import llama
from chattts_tpu_torch.ops import decode_step as k1
from chattts_tpu_torch.ops import kv_quant
from torch_port_utils import port_config

GEOMETRIES = {
    "pairs": GPTConfig(hidden_size=512, intermediate_size=1536,
                       num_attention_heads=8, num_hidden_layers=1,
                       max_position_embeddings=256),
    "kv4": GPTConfig(hidden_size=256, intermediate_size=512,
                     num_attention_heads=2, num_hidden_layers=1,
                     max_position_embeddings=256),
}


def _case(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    HD = cfg.num_attention_heads * cfg.head_dim
    qkv = (rng.standard_normal((B, 3 * HD)) * 2.0).astype(np.float32)
    cur = rng.integers(0, T, B)
    lo = rng.integers(0, T, B) % (cur + 1)
    if B > 2:
        cur[1], lo[2], cur[2] = T + 3, 9, 4  # past the cache; no key seen
    pos = np.maximum(cur - lo, 0)
    cos, sin = k1.rope_rows(port_config(cfg), torch.from_numpy(pos))
    W = kv_quant.row_width(4, cfg)
    kc = rng.integers(-128, 128, (B, T, W)).astype(np.int8)
    vc = rng.integers(-128, 128, (B, T, W)).astype(np.int8)
    return qkv, cos.numpy(), sin.numpy(), kc, vc, cur, lo


def _reference_rows(cfg, qkv, cos, sin):
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    rot = jnp.asarray(pallas_step.rope_rotate_matrix(Dh, HD), jnp.bfloat16)
    cosf, sinf = jnp.tile(cos, (1, H)), jnp.tile(sin, (1, H))
    k = jnp.asarray(qkv[:, HD:2 * HD])
    k = k * cosf + jnp.dot(k.astype(jnp.bfloat16), rot,
                           preferred_element_type=jnp.float32) * sinf
    return (np.asarray(pallas_step.kv4_quantize(k, cfg)),
            np.asarray(pallas_step.kv4_quantize(jnp.asarray(qkv[:, 2 * HD:]),
                                                cfg)))


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("B", [1, 8, 33])
def test_kv4_append_matches_reference(geom, B):
    cfg = GEOMETRIES[geom]
    qkv, cos, sin, kc, vc, cur, lo = _case(cfg, B, 48, B)
    amax = np.abs(qkv.reshape(B, 3, cfg.num_attention_heads, -1)).max(-1)
    assert amax.min() >= 0.125 and amax.max() < 2e4  # exact powers of two
    kk, vk = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    before = k1.decode_step.kv4_append_launches
    k1.kv4_append(torch.from_numpy(qkv), torch.from_numpy(cos),
                  torch.from_numpy(sin), kk, vk, torch.from_numpy(cur),
                  torch.from_numpy(lo), port_config(cfg))
    assert k1.decode_step.kv4_append_launches == before  # the CPU path
    want_k, want_v = _reference_rows(cfg, qkv, cos, sin)
    T = kc.shape[1]
    live = (cur >= 0) & (cur < T) & (cur >= lo)
    if B > 2:
        assert not live[1] and not live[2]
    for b in range(B):
        for got, base, want in ((kk, kc, want_k), (vk, vc, want_v)):
            g = got[b].numpy()
            others = np.ones(T, bool)
            if live[b]:
                np.testing.assert_array_equal(g[cur[b]], want[b])
                others[cur[b]] = False
            np.testing.assert_array_equal(g[others], base[b][others])


def test_kv4_append_is_the_steps_layer_0_append():
    """decode_step_plain appends at cur what kv4_append appends for the
    qkv of its first layer's gemv."""
    cfg = port_config(GEOMETRIES["pairs"])
    H, Dh, D = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    B, T = 4, 32
    g = torch.Generator().manual_seed(3)
    packed = k1.pack_weights(llama.init_params(g, cfg), cfg)
    emb = torch.randn((B, D), generator=g) * 0.3
    W = kv_quant.row_width(4, cfg)
    kc = torch.randint(-128, 128, (1, B, T, W), generator=g, dtype=torch.int8)
    vc = torch.randint(-128, 128, (1, B, T, W), generator=g, dtype=torch.int8)
    cur = torch.tensor([3, 31, 0, 17])
    lo = torch.tensor([0, 5, 0, 2])
    pos = cur - lo
    ks, vs = kc.clone(), vc.clone()
    k1.decode_step_plain(packed, emb, ks, vs, cur, lo, pos, cfg)
    qkv = k1._mm(k1._rms(emb, packed["ln1"][0], cfg.rms_norm_eps),
                 packed["wqkv"][0])
    cos, sin = k1.rope_rows(cfg, pos)
    ka, va = kc[0].clone(), vc[0].clone()
    k1.kv4_append(qkv, cos, sin, ka, va, cur, lo, cfg)
    assert torch.equal(ka, ks[0]) and torch.equal(va, vs[0])
    assert H * Dh == D


def test_kv4_append_checks_its_arguments():
    cfg = port_config(GEOMETRIES["kv4"])
    qkv, cos, sin, kc, vc, cur, lo = (torch.from_numpy(a) for a in _case(
        GEOMETRIES["kv4"], 2, 16, 0))
    with pytest.raises(ValueError, match="takes qkv"):
        k1.kv4_append(qkv, cos, sin, kc[..., :-1], vc[..., :-1], cur, lo, cfg)
    with pytest.raises(ValueError, match="takes qkv"):
        k1.kv4_append(qkv[:, :-8], cos, sin, kc, vc, cur, lo, cfg)
