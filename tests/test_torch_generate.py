"""The port's Generator against chattts_tpu's (CPU).

The reference runs its XLA decode step (``CHATTTS_PALLAS_STEP=0``); the
port runs K1's plain version, the CPU path of the kernel wrapper.  Both get
the same bridged weights.  The two round differently (XLA rounds each bf16
elementwise op and keeps a bf16 residual; torch's prefill rounds in other
places and K1 keeps an f32 residual), so their logits differ by a few bf16
ulps from the first step on.  A free-running comparison is then not
token-exact even with the same Gumbel noise: the draw adds the noise in
*sorted* space, so two near-equal scores that swap rank hand their noise to
each other.  The comparison is therefore teacher-forced: the port's sampler
runs on its own logits with the reference's noise, but the generator is
handed the reference's token at every step.  Then

* the ids, the finished flags and the kept lengths are token-exact (the
  EOS, ``end_idx`` and window logic of the loop);
* every step's logits and the kept hiddens agree within atol 0.05 (O(1)
  values; about six bf16 ulps at 1.0, the drift of a 2-layer bf16 model);
* the port's own draw agrees with the reference's on most steps.

The EOS columns of the heads are scaled up so that some rows finish early.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.engine import generate as jg
from chattts_tpu.models import embed as je
from chattts_tpu.models import llama as jl
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.utils import profiling
from torch_port_utils import JaxGumbel, bridge, forced_tokens, port_config

LOGIT_ATOL = 0.05
EOS_SCALE = 3.0


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = tiny_config.gpt
    jgpt = jl.init_params(jax.random.PRNGKey(0), cfg)
    jemb = je.init_params(jax.random.PRNGKey(1), cfg)
    jemb["head_code"] = jemb["head_code"].at[
        :, :, cfg.num_audio_tokens - 1].multiply(EOS_SCALE)
    jemb["head_text"] = jemb["head_text"].at[
        :, cfg.num_text_tokens - 1].multiply(EOS_SCALE)
    return cfg, jgpt, jemb, port_config(cfg), bridge(jgpt), bridge(jemb)


def _request(cfg, infer_text, seed, B=2, T0=11, max_new=12):
    rng = np.random.default_rng(seed)
    hi = cfg.num_text_tokens - 1 if infer_text else cfg.num_audio_tokens - 1
    ids = rng.integers(1, hi, (B, T0, cfg.num_vq)).astype(np.int32)
    attn = np.ones((B, T0), bool)
    attn[1, :4] = False  # left padding
    ids[~attn] = 0
    tmask = attn.copy()
    if infer_text:
        temp = np.asarray([0.7], np.float32)
        eos = cfg.num_text_tokens - 1
    else:
        temp = np.full((cfg.num_vq,), 0.3, np.float32)
        eos = cfg.num_audio_tokens - 1
    return dict(ids=ids, attn_mask=attn, text_mask=tmask,
                infer_text=infer_text, eos_token=eos, temperature=temp,
                top_p=0.7, top_k=20, repetition_penalty=1.05,
                max_new=max_new, min_new=3, seed=seed, return_hidden=True)


def _noise_shape(cfg, req):
    B = req["ids"].shape[0]
    if req["infer_text"]:
        return (B, cfg.num_text_tokens)
    return (B * cfg.num_vq, cfg.num_audio_tokens)


@pytest.mark.parametrize("infer_text,seed", [(False, 3), (False, 4),
                                             (True, 3), (True, 4)])
def test_generator_teacher_forced(models, monkeypatch, infer_text, seed):
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "0")
    cfg, jgpt, jemb, pcfg, tgpt, temb = models
    kw = _request(cfg, infer_text, seed)
    ref = next(jg.Generator(cfg, jgpt, jemb, prefill_bucket=16).generate(
        jg.GenerateRequest(**kw)))
    ref_hid = np.asarray(ref.hiddens_dev)
    end = np.asarray(ref.end_dev)
    forced = forced_tokens(cfg.num_vq, infer_text, kw["eos_token"],
                           kw["max_new"], ref.ids)
    B = len(ref.ids)
    real_sample = tg.sampling.sample
    logits_seen, agree = [], []

    def teacher(logits, *args, **kwargs):
        step = args[3]
        own = real_sample(logits, *args, **kwargs).reshape(B, -1)
        want = torch.from_numpy(forced[step])
        if infer_text:
            want = want[:, 0]
        for b in range(B):
            if step < end[b]:
                agree.append(bool(torch.equal(own[b].reshape(-1),
                                              want[b].reshape(-1))))
        logits_seen.append(logits.reshape(B, -1).clone())
        return want.reshape(-1)

    monkeypatch.setattr(tg.sampling, "sample", teacher)
    gen = tg.Generator(pcfg, tgpt, temb, prefill_bucket=16)
    got = next(gen.generate(tg.GenerateRequest(
        **kw, noise=JaxGumbel(seed, _noise_shape(cfg, kw)))))

    assert sum(len(r) for r in ref.ids) > 0
    for g, r in zip(got.ids, ref.ids):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got.finished, ref.finished)
    np.testing.assert_array_equal(got.end_dev.numpy(), end)
    hid_got = got.hiddens_dev.numpy()
    assert hid_got.shape == ref_hid.shape
    head = je.head_text if infer_text else je.head_code
    for s in range(ref_hid.shape[1]):
        rows = end > s  # the steps a row kept
        np.testing.assert_allclose(hid_got[rows, s], ref_hid[rows, s],
                                   atol=LOGIT_ATOL)
        ref_logits = np.asarray(head(jemb, jnp.asarray(ref_hid[:, s])))
        np.testing.assert_allclose(
            logits_seen[s].numpy()[rows],
            ref_logits.reshape(B, -1)[rows], atol=LOGIT_ATOL)
    assert np.mean(agree) >= 0.5, agree


def test_generator_seeded_and_deterministic(models):
    cfg, _, _, pcfg, tgpt, temb = models
    kw = _request(cfg, False, 9)
    gen = tg.Generator(pcfg, tgpt, temb, prefill_bucket=16)
    a = next(gen.generate(tg.GenerateRequest(**kw)))
    b = next(gen.generate(tg.GenerateRequest(**kw)))
    kw["seed"] = 10
    c = next(gen.generate(tg.GenerateRequest(**kw)))
    for x, y in zip(a.ids, b.ids):
        np.testing.assert_array_equal(x, y)
    assert any(x.shape != y.shape or (x != y).any()
               for x, y in zip(a.ids, c.ids))


def test_ensure_non_empty_retries_unseeded(models, monkeypatch):
    """An attempt whose rows all end empty is retried with a fresh seed."""
    cfg, _, _, pcfg, tgpt, temb = models
    kw = _request(cfg, False, 7, max_new=4)
    kw.update(seed=None, min_new=1)  # the sampler never ends a row at step 0
    eos = cfg.num_audio_tokens - 1
    real_sample = tg.sampling.sample
    steps = []

    def first_draw_is_eos(logits, *args, **kwargs):
        steps.append(int(args[3]))  # the loop's step, advanced in place
        if len(steps) == 1:  # first attempt, first step: EOS everywhere
            return torch.full((logits.shape[0],), eos)
        return real_sample(logits, *args, **kwargs)

    monkeypatch.setattr(tg.sampling, "sample", first_draw_is_eos)
    gen = tg.Generator(pcfg, tgpt, temb, prefill_bucket=16)
    out = next(gen.generate(tg.GenerateRequest(**kw)))
    assert steps.count(0) == 2  # one retry, restarted at step 0
    assert all(len(i) > 0 for i in out.ids)


def test_interrupt_stops_generation(models):
    cfg, _, _, pcfg, tgpt, temb = models
    kw = _request(cfg, False, 8, max_new=40)
    kw.update(min_new=40)
    ctx = tg.Interrupt()
    ctx.set(True)
    gen = tg.Generator(pcfg, tgpt, temb, prefill_bucket=16)
    out = next(gen.generate(tg.GenerateRequest(**kw), ctx))
    assert out.steps == tg.SYNC_EVERY  # stopped at the first flag read


def test_cpu_steps_run_eagerly_and_min_new_holds_eos(models):
    """On CPU tensors the Generator captures no graph: every step runs op
    by op, each ``generator.steps`` span says none was replayed, and the
    step's device-held position still suppresses EOS below ``min_new``
    (the heads favour EOS here, so rows would stop early)."""
    cfg, _, _, pcfg, tgpt, temb = models
    kw = _request(cfg, False, 9, max_new=13)
    gen = tg.Generator(pcfg, tgpt, temb, prefill_bucket=16)
    free = next(gen.generate(tg.GenerateRequest(**kw)))
    assert free.finished.any()
    kw["min_new"] = 13
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear_spans()
        out = next(gen.generate(tg.GenerateRequest(**kw)))
        rec = profiling.spans()
    assert (gen.graph_captures, gen.graph_steps) == (0, 0)
    assert gen.eager_steps == free.steps + out.steps
    assert out.steps == 13 and not out.finished.any()
    np.testing.assert_array_equal(out.end_dev.numpy(), [13, 13])
    stretches = [s for s in rec if s.name == "generator.steps"]
    assert sum(s.attrs["steps"] for s in stretches) == 13
    assert all(s.attrs["graphed"] == 0 for s in stretches)
    assert not any(s.name == "generator.capture" for s in rec)
