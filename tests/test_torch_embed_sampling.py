"""Embeddings, heads and sampling of the port against chattts_tpu (CPU).

Lookups are gathers from the same f32 tables, so they agree exactly.  The
heads are f32 matmuls whose sums may run in another order: atol 1e-5 on
O(1) logits.  Sampling is held token-exact: both sides get the same scores
and the same Gumbel noise (``jax.random.categorical`` is the argmax of the
scores plus ``jax.random.gumbel`` of its key), so every filter and the
sorted-space draw must pick the same column, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.models import embed as je
from chattts_tpu.ops import sampling as js
from chattts_tpu_torch.models import embed as te
from chattts_tpu_torch.ops import sampling as ts
from torch_port_utils import bridge, to_np

HEAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def emb(tiny_config):
    cfg = tiny_config.gpt
    jp = je.init_params(jax.random.PRNGKey(3), cfg)
    return cfg, jp, bridge(jp)


def test_embed_prompt_matches(emb):
    cfg, jp, tp = emb
    rng = np.random.default_rng(0)
    B, T = 3, 7
    ids = rng.integers(0, cfg.num_audio_tokens, (B, T, cfg.num_vq))
    ids[..., 0] = np.where(rng.random((B, T)) < 0.5,
                           rng.integers(0, cfg.num_text_tokens, (B, T)),
                           ids[..., 0])
    ids[0, 0, 0] = cfg.num_text_tokens + 5  # out of range: clamped by both
    tmask = rng.random((B, T)) < 0.5
    ref = je.embed_prompt(jp, jnp.asarray(ids, jnp.int32), jnp.asarray(tmask))
    got = te.embed_prompt(tp, torch.from_numpy(ids), torch.from_numpy(tmask))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_embed_steps_match(emb):
    cfg, jp, tp = emb
    rng = np.random.default_rng(1)
    codes = rng.integers(0, cfg.num_audio_tokens, (4, cfg.num_vq))
    text = rng.integers(0, cfg.num_text_tokens, (4,))
    np.testing.assert_array_equal(
        to_np(te.embed_code_step(tp, torch.from_numpy(codes))),
        np.asarray(je.embed_code_step(jp, jnp.asarray(codes, jnp.int32))))
    np.testing.assert_array_equal(
        to_np(te.embed_text_step(tp, torch.from_numpy(text))),
        np.asarray(je.embed_text_step(jp, jnp.asarray(text, jnp.int32))))


def test_heads_match(emb):
    cfg, jp, tp = emb
    h = np.random.default_rng(2).standard_normal(
        (3, cfg.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(te.head_code(tp, torch.from_numpy(h))),
        np.asarray(je.head_code(jp, jnp.asarray(h))), atol=HEAD_ATOL)
    np.testing.assert_allclose(
        to_np(te.head_text(tp, torch.from_numpy(h))),
        np.asarray(je.head_text(jp, jnp.asarray(h))), atol=HEAD_ATOL)


def test_repetition_penalty_matches():
    rng = np.random.default_rng(3)
    N, V, W = 4, 50, 16
    scores = rng.standard_normal((N, V)).astype(np.float32)
    win = rng.integers(0, V, (N, W))
    wmask = rng.random((N, W)) < 0.7
    ref = js.repetition_penalty(jnp.asarray(scores), jnp.asarray(win),
                                jnp.asarray(wmask), jnp.float32(1.3), 40)
    got = ts.repetition_penalty(torch.from_numpy(scores),
                                torch.from_numpy(win),
                                torch.from_numpy(wmask), 1.3, 40)
    # alpha = 1.3**freq: jnp.power and torch.pow may differ by an ulp
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-6)


def _case(name):
    """(logits, temperature, top_p, top_k, rep, step, min_new, eos, maxpen)."""
    rng = np.random.default_rng(4)
    if name == "code":  # 2 rows x 4 codebooks, per-codebook temperature
        V = 626
        logits = rng.standard_normal((8, V)).astype(np.float32) * 3
        return logits, np.array([0.3, 0.5, 0.7, 1.0], np.float32), 0.7, 20, \
            1.05, 3, 0, V - 1, V - 1
    if name == "code_min_new":  # EOS suppressed: make it the favourite
        V = 626
        logits = rng.standard_normal((8, V)).astype(np.float32)
        logits[:, V - 1] = 20.0
        return logits, np.full(4, 0.3, np.float32), 0.7, 20, 1.05, 2, 5, \
            V - 1, V - 1
    if name == "text":
        V = 300
        logits = rng.standard_normal((3, V)).astype(np.float32) * 2
        return logits, np.array([0.7], np.float32), 0.9, 5, 1.0, 0, 0, 7, V
    if name == "ties":  # many equal scores: tie order decides the column
        V = 40
        logits = np.zeros((4, V), np.float32)
        logits[0, ::3] = 1.0
        logits[1] = np.repeat(np.arange(8, dtype=np.float32), 5)
        logits[3, 5:9] = 2.0
        return logits, np.array([1.0], np.float32), 0.95, 12, 1.0, 0, 0, \
            0, V
    raise ValueError(name)


@pytest.mark.parametrize("name", ["code", "code_min_new", "text", "ties"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_token_exact(name, seed):
    logits, temp, top_p, top_k, rep, step, min_new, eos, maxpen = _case(name)
    N, V = logits.shape
    rng = np.random.default_rng(10 + seed)
    win = rng.integers(0, V, (N, 16))
    wmask = rng.random((N, 16)) < 0.8
    key = jax.random.PRNGKey(seed)
    ref = js.sample(
        key, jnp.asarray(logits),
        js.SamplingParams(jnp.asarray(temp), jnp.float32(top_p),
                          jnp.int32(top_k), jnp.float32(rep),
                          jnp.int32(min_new)),
        jnp.asarray(win, jnp.int32), jnp.asarray(wmask), jnp.int32(step),
        eos, maxpen)
    noise = torch.from_numpy(np.array(
        jax.random.gumbel(key, (N, V), jnp.float32)))
    got = ts.sample(
        torch.from_numpy(logits),
        ts.SamplingParams(torch.from_numpy(temp), top_p, top_k, rep,
                          min_new),
        torch.from_numpy(win), torch.from_numpy(wmask), step, eos, maxpen,
        noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if name == "code_min_new":
        assert not (got.numpy() == eos).any()


def test_sample_draws_from_generator_when_no_noise():
    logits = torch.zeros((2, 30))
    sp = ts.SamplingParams(torch.ones(1), 1.0, 30, 1.0, 0)
    win = torch.zeros((2, 16), dtype=torch.long)
    wmask = torch.zeros((2, 16), dtype=torch.bool)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return ts.sample(logits, sp, win, wmask, 0, 0, 30, generator=g)

    assert torch.equal(draw(5), draw(5))
    assert any(not torch.equal(draw(5), draw(s)) for s in range(6, 12))
