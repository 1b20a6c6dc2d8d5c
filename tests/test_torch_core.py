"""``chattts_tpu_torch.Chat.infer`` end to end against ``chattts_tpu.Chat``.

Both facades run at the tiny config on the CPU with the same weights: the
reference draws them (``load(source="random")``) and the port takes them
through the bridge (``load_params``).  As in test_torch_generate.py, the
logits of the two differ by a few bf16 ulps, so the comparison is
teacher-forced: the reference's tokens of each pass are recorded and the
port's sampler is handed them step by step.  Then

* the prompts of both passes are token-exact (normalizer, refine-text
  filter ``ids < break_0``, tokenizer);
* the waveforms agree within 2e-2 of their peak before the |x| < 1e-5
  strip (measured: 0.8%): the decoder hiddens differ by up to ~0.05 (a few
  bf16 ulps) and pass the mel decoder, exp() in Vocos' head and an inverse
  FFT.  After the strip they are not compared sample by sample: a sample
  near the threshold that one side drops and the other keeps shifts every
  later sample.  The port's output is held to its own strip instead.
"""

import numpy as np
import pytest
import torch

from chattts_tpu.core import Chat as JChat
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.engine import generate as tg
from torch_port_utils import bridge, forced_tokens, port_config

WAV_RTOL_OF_PEAK = 2e-2
TEXTS = ["hello world.", "speech on a card"]


def _params(chat_cls):
    return (chat_cls.RefineTextParams(max_new_token=8, min_new_token=2,
                                      manual_seed=5, show_tqdm=False),
            chat_cls.InferCodeParams(max_new_token=16, min_new_token=4,
                                     manual_seed=7, show_tqdm=False))


@pytest.fixture(scope="module")
def chats(tiny_config):
    jchat = JChat(config=tiny_config)
    jchat.load(source="random", seed=0)
    tchat = TChat(config=port_config(tiny_config))
    tchat.load_params(gpt=bridge(jchat.gpt_params),
                      embed=bridge(jchat.embed_params),
                      decoder=bridge(jchat.decoder_params),
                      vocos=bridge(jchat.vocos_params), device="cpu")
    return jchat, tchat


def _record(generator, log):
    """Wrap generator.generate to log [request, output ids] per pass; a
    pass is logged when it starts, its ids copied before the facade
    destroys the output."""
    inner = generator.generate

    def generate(req, context=None):
        log.append([req, None])
        for out in inner(req, context):
            log[-1][1] = [np.array(i) for i in out.ids]
            yield out

    generator.generate = generate


def _record_wavs(chat, log):
    """Wrap chat._decode_to_wavs to log each batch's waveforms before the
    |x| < 1e-5 strip."""
    inner = chat._decode_to_wavs

    def decode(*args, **kwargs):
        wavs = inner(*args, **kwargs)
        log.append(np.array(wavs))
        return wavs

    chat._decode_to_wavs = decode


def test_infer_matches_reference(chats, monkeypatch):
    monkeypatch.delenv("CHATTTS_PIPELINED_DECODE", raising=False)
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "0")
    jchat, tchat = chats
    ref_log, port_log, ref_raw, port_raw = [], [], [], []
    _record(jchat.generator, ref_log)
    _record_wavs(jchat, ref_raw)
    ref = jchat.infer(TEXTS, split_text=False,
                      params_refine_text=_params(JChat)[0],
                      params_infer_code=_params(JChat)[1])
    assert len(ref_log) == 2  # refine pass, code pass

    real_sample = tg.sampling.sample

    def teacher(logits, *args, **kwargs):
        req, ids = ref_log[len(port_log) - 1]
        real_sample(logits, *args, **kwargs)  # the port's own draw runs too
        forced = forced_tokens(tchat.config.gpt.num_vq, req.infer_text,
                               req.eos_token, req.max_new, ids)
        want = torch.from_numpy(forced[args[3]])
        return (want[:, 0] if req.infer_text else want).reshape(-1)

    monkeypatch.setattr(tg.sampling, "sample", teacher)
    _record(tchat.generator, port_log)
    _record_wavs(tchat, port_raw)
    got = tchat.infer(TEXTS, split_text=False,
                      params_refine_text=_params(TChat)[0],
                      params_infer_code=_params(TChat)[1])

    assert len(port_log) == 2
    for (rq, r_ids), (pq, p_ids) in zip(ref_log, port_log):
        np.testing.assert_array_equal(pq.ids, rq.ids)
        np.testing.assert_array_equal(pq.attn_mask, rq.attn_mask)
        np.testing.assert_array_equal(pq.text_mask, rq.text_mask)
        assert len(p_ids) == len(r_ids) == len(TEXTS)
        for g, r in zip(p_ids, r_ids):
            np.testing.assert_array_equal(g, r)
    (raw_ref,), (raw_got,) = ref_raw, port_raw
    assert raw_got.shape == raw_ref.shape and raw_ref.shape[1] > 0
    np.testing.assert_allclose(raw_got, raw_ref,
                               atol=WAV_RTOL_OF_PEAK * np.abs(raw_ref).max())
    assert len(got) == len(ref) == len(TEXTS)
    for g, raw in zip(got, raw_got):
        assert g.dtype == np.float32 and g.size > 0
        np.testing.assert_array_equal(g, raw[np.abs(raw) > 1e-5])


def test_split_text_concatenates_one_wav(chats):
    _, tchat = chats
    wavs = tchat.infer("one segment only", split_text=True,
                       params_refine_text=_params(TChat)[0],
                       params_infer_code=_params(TChat)[1])
    assert len(wavs) == 1 and wavs[0].ndim == 1


def test_refine_text_only_and_empty_input(chats):
    _, tchat = chats
    txt = tchat.infer(["hello world"], split_text=False,
                      refine_text_only=True,
                      params_refine_text=_params(TChat)[0])
    assert isinstance(txt, list) and isinstance(txt[0], str)
    assert tchat.infer([]) == []


def test_later_slices_raise(chats):
    _, tchat = chats
    with pytest.raises(NotImplementedError, match="voice clone"):
        tchat.infer("First one. Second one. ", split_text=True,
                    skip_refine_text=True,
                    params_infer_code=_params(TChat)[1])
    with pytest.raises(NotImplementedError, match="streaming"):
        tchat.infer("hi", stream=True)
    with pytest.raises(NotImplementedError):
        tchat.sample_audio_speaker(np.zeros(4096, np.float32))


def test_speaker_embedding_conditions_the_code_pass(chats):
    _, tchat = chats
    spk = tchat.sample_random_speaker()
    assert isinstance(spk, str) and spk
    code = _params(TChat)[1]
    code.spk_emb = spk
    wavs = tchat.infer("hi", split_text=False, skip_refine_text=True,
                       params_infer_code=code)
    assert len(wavs) == 1 and np.isfinite(wavs[0]).all()
