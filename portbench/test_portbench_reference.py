"""The reference's tiers and resumes on the tiny configuration, and the hook
that keeps where the Engine preempted a request."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import program, weights
from reference import model as ref

HERE = os.path.dirname(os.path.abspath(__file__))
TEXT = "a short line of text"


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(HERE, "fixtures", "tiny-config.json")) as f:
        config = json.load(f)
    w = weights.draw(config, 2 ** 33 + 5, torch.device("cpu"))
    cfg = {"gpt": config["gpt"], "decoder": config["decoder"],
           "vocos": config["vocos"],
           "decode_pad": config["runtime"]["decode_bucket"] // 4}
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 625, size=(24, config["gpt"]["num_vq"]))
    spk = rng.standard_normal(config["gpt"]["hidden_size"])
    return w, cfg, codes, spk


def logits(tiny, kv_bits, weight_bits, prompt_bits=0, resumes=()):
    w, cfg, codes, spk = tiny
    with torch.no_grad():
        return ref.request_reference(w, cfg, TEXT, spk, codes, kv_bits,
                                     weight_bits, prompt_bits, resumes,
                                     with_wav=False)["logits"]


def test_a_resume_changes_nothing_on_the_bf16_cache(tiny):
    """With no quantized tier a prefill row and a decode row compute the
    same thing, so a resume leaves every logit as it was."""
    want = logits(tiny, 0, 0)
    got = logits(tiny, 0, 0, resumes=(7, 15))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_a_resume_moves_only_the_tokens_after_it(tiny):
    want = logits(tiny, 8, 8)
    got = logits(tiny, 8, 8, resumes=(10,))
    torch.testing.assert_close(got[:10], want[:10])
    assert not torch.allclose(got[10:], want[10:])


def test_the_prompt_reads_its_own_tier(tiny):
    """The first token's producer is the prompt's last row, so the
    generated rows' tier leaves its logits as they are; the prompt's tier
    moves them."""
    base = logits(tiny, 8, 0)
    steps_int8 = logits(tiny, 8, 8)
    torch.testing.assert_close(steps_int8[0], base[0])
    assert not torch.allclose(steps_int8[1:], base[1:])
    prompt_int8 = logits(tiny, 8, 8, prompt_bits=8)
    assert not torch.allclose(prompt_int8[0], base[0])


def test_preemptions_are_kept_by_request_key():
    a = SimpleNamespace(request_id="a", resume_len=0)
    b = SimpleNamespace(request_id="b", resume_len=0)

    class Engine:
        slots = [a, b, None]

        def _maybe_preempt(self):
            a.resume_len += 12
            self.slots = [None, b, None]

    class Service:
        def __init__(self):
            self.eng = Engine()

        def _engines(self):
            return [self.eng]

        def _code_reqs(self, texts, params, on_tokens=None):
            return [a, b]

    out, svc = program.Outputs(), Service()
    program.record_resumes(svc, out)
    out.local.keys = ["ka", "kb"]
    svc._code_reqs(["x", "y"], None)
    svc.eng._maybe_preempt()
    svc.eng._maybe_preempt()   # nobody left to preempt but b, kept
    assert out.resumes == {"ka": [12]}
