"""chattts_tpu_torch.models.llama against chattts_tpu.models.llama (CPU).

Both run the bf16 transformer on bridged weights.  XLA and torch round
bf16 intermediates at slightly different places (XLA rounds each
elementwise op, torch's fused CPU kernels once), so activations agree to a
few bf16 ulps, not bit for bit: hidden states (rms-normed, O(1)) and cache
rows are held to atol 0.05, about six ulps at 1.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.models import llama as jl
from chattts_tpu_torch.models import llama as tl
from torch_port_utils import bridge, port_config, to_np

ACT_ATOL = 0.05


@pytest.fixture(scope="module")
def model(tiny_config):
    cfg = tiny_config.gpt
    jp = jl.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, port_config(cfg), jp, bridge(jp)


def test_rms_norm_matches(model):
    cfg, pcfg, _, _ = model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, cfg.hidden_size)).astype(np.float32)
    w = rng.standard_normal(cfg.hidden_size).astype(np.float32)
    ref = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), cfg.rms_norm_eps)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                      cfg.rms_norm_eps)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_rope_tables_and_apply_rope_match(model):
    cfg, pcfg, _, _ = model
    c_j, s_j = jl.rope_tables(cfg)
    c_t, s_t = tl.rope_tables(pcfg)
    np.testing.assert_array_equal(c_j, c_t)
    np.testing.assert_array_equal(s_j, s_t)
    rng = np.random.default_rng(1)
    B, T, H, Dh = 2, 6, cfg.num_attention_heads, cfg.head_dim
    x = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    pos = rng.integers(0, cfg.max_position_embeddings, (B, T))
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(c_j)[pos],
                        jnp.asarray(s_j)[pos])
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(c_t)[pos],
                        torch.from_numpy(s_t)[pos])
    # f32 throughout: only the order of two products and a sum may differ
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)


def _prompt(cfg, B=2, T0=9, seed=2):
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((B, T0, cfg.hidden_size)) * 0.3).astype(
        np.float32)
    attn = np.ones((B, T0), bool)
    attn[1, :3] = False  # left padding
    pos = np.maximum(np.cumsum(attn, axis=1) - 1, 0).astype(np.int32)
    return emb, attn, pos


def test_prefill_matches(model):
    cfg, pcfg, jp, tp = model
    emb, attn, pos = _prompt(cfg)
    B, T0 = attn.shape
    Tmax = T0 + 7
    h_ref, c_ref = jl.prefill(jp, jnp.asarray(emb), jnp.asarray(attn),
                              jnp.asarray(pos), jl.KVCache.create(cfg, B, Tmax),
                              cfg)
    cache = tl.KVCache.create(pcfg, B, Tmax)
    h_got, c_got = tl.prefill(tp, torch.from_numpy(emb),
                              torch.from_numpy(attn),
                              torch.from_numpy(pos).long(), cache, pcfg)
    h_got = to_np(h_got)
    assert np.isfinite(h_got).all()  # left-pad query rows stay finite
    np.testing.assert_allclose(h_got, np.asarray(h_ref), atol=ACT_ATOL)
    for li in range(cfg.num_hidden_layers):
        for ref, got in ((c_ref.k[li], c_got.k[li]), (c_ref.v[li], c_got.v[li])):
            np.testing.assert_allclose(to_np(got), np.asarray(ref, np.float32),
                                       atol=ACT_ATOL)


def test_prefill_bias_is_finite_and_causal(model):
    attn = np.array([[False, True, True], [True, True, True]])
    ref = np.asarray(jl.prefill_bias(jnp.asarray(attn)))
    got = to_np(tl.prefill_bias(torch.from_numpy(attn)))
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got).all()


def test_decode_step_matches(model):
    """The XLA step: scalar cur, write-then-attend, key_valid mask."""
    cfg, pcfg, jp, tp = model
    B, T, cur = 2, 16, 9
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    rng = np.random.default_rng(3)
    k0 = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    v0 = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    emb = (rng.standard_normal((B, cfg.hidden_size)) * 0.3).astype(np.float32)
    lo = np.array([0, 4])
    slots = np.arange(T)
    kv = (slots[None] >= lo[:, None]) & (slots[None] <= cur)
    pos = (cur - lo).astype(np.int32)
    L = cfg.num_hidden_layers
    jc = jl.KVCache(tuple(jnp.asarray(k0, jnp.bfloat16) for _ in range(L)),
                    tuple(jnp.asarray(v0, jnp.bfloat16) for _ in range(L)))
    h_ref, c_ref = jl.decode_step(jp, jnp.asarray(emb), jc, jnp.int32(cur),
                                  jnp.asarray(kv), jnp.asarray(pos), cfg)
    tc = tl.KVCache(tuple(torch.from_numpy(k0).bfloat16() for _ in range(L)),
                    tuple(torch.from_numpy(v0).bfloat16() for _ in range(L)))
    h_got, c_got = tl.decode_step(tp, torch.from_numpy(emb), tc, cur,
                                  torch.from_numpy(kv),
                                  torch.from_numpy(pos).long(), pcfg)
    np.testing.assert_allclose(to_np(h_got), np.asarray(h_ref), atol=ACT_ATOL)
    for li in range(L):
        np.testing.assert_allclose(
            to_np(c_got.k[li][:, cur]),
            np.asarray(c_ref.k[li][:, cur], np.float32), atol=ACT_ATOL)
        np.testing.assert_array_equal(
            to_np(c_got.k[li][:, :cur]),
            np.asarray(c_ref.k[li][:, :cur], np.float32))
