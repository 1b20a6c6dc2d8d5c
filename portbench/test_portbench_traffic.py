"""The traffic generator: what a seed decides and what it does not."""

import numpy as np
import pytest

from harness import traffic
from reference import model as ref

MIX = {"steps": [64, 512], "prompt_tokens": [20, 200],
       "length_quantiles": 8, "batch": 8}


def test_the_open_loop_schedule():
    a = traffic.arrival_times(2.0, 100, traffic.rng_for(2 ** 40 + 3, "arr"))
    b = traffic.arrival_times(2.0, 100, traffic.rng_for(2 ** 40 + 3, "arr"))
    c = traffic.arrival_times(2.0, 100, traffic.rng_for(2 ** 40 + 4, "arr"))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.diff(a) > 0)
    # another order of the same gaps: the exponential's quantiles
    assert np.allclose(np.sort(np.diff(a, prepend=0)),
                       np.sort(np.diff(c, prepend=0)))
    # the mean gap is the rate's, within the quantiles' discretization
    assert a[-1] / 100 == pytest.approx(0.5, rel=0.02)


def test_every_seed_gets_the_same_lengths_and_other_texts():
    a = traffic.items(MIX, 7, 32)
    b = traffic.items(MIX, 2 ** 33 + 1, 32)
    assert [x.steps for x in a] == [x.steps for x in b]
    assert [len(x.text) for x in a] == [len(x.text) for x in b]
    assert [x.text for x in a] != [x.text for x in b]
    # each cycle of 8 holds every quantile once, in a shuffled order
    q = traffic.quantiles_log_uniform(64, 512, 8)
    for k in range(0, 32, 8):
        assert sorted(x.steps for x in a[k:k + 8]) == q
    assert [x.steps for x in a[:8]] != q
    assert [x.greedy for x in a] == [i % 2 == 0 for i in range(32)]


def test_batches_share_a_length_and_greediness_a_call():
    calls = traffic.batches(MIX, 11, 8)
    assert all(len(c) == 8 for c in calls)
    assert sorted(c[0].steps for c in calls) == traffic.quantiles_log_uniform(
        64, 512, 8)
    for i, c in enumerate(calls):
        assert {x.steps for x in c} == {c[0].steps}
        assert {x.greedy for x in c} == {i % 2 == 0}


@pytest.mark.parametrize("n", [20, 21, 57, 200])
def test_texts_have_their_prompt_length(n):
    t = traffic.text_of_tokens(n, traffic.rng_for(1, "t"))
    assert len(ref.prompt_ids(t, 21178)) == n
    assert set(t) <= set(traffic.CHARSET) and t.endswith(".")


def test_the_charset_maps_to_distinct_ids():
    ids = {ref.char_id(c, 21178) for c in traffic.CHARSET}
    assert len(ids) == len(traffic.CHARSET)
    assert not ids & set(ref.control_ids(21178).values())


def test_the_programs_tokenizer_and_normalizer_agree_with_the_reference():
    from chattts_tpu_torch.models.speaker import Speaker
    from chattts_tpu_torch.models.tokenizer import Tokenizer
    from chattts_tpu_torch.norm import Normalizer

    tok = Tokenizer(None, vocab_size=21178)
    norm = Normalizer()
    for it in traffic.items(MIX, 3, 16):
        assert norm(it.text, True, True, None) == it.text
        prompt = Speaker.decorate_code_prompts([it.text], "[speed_5]", None,
                                               "spk")
        ids, attn, _ = tok.encode(prompt, 4)
        assert ids[0, attn[0], 0].tolist() == ref.prompt_ids(it.text, 21178)


def test_the_speaker_string_carries_the_vector():
    from chattts_tpu_torch import codecs

    vec = traffic.speaker_vector(traffic.rng_for(5, "speaker"), 768)
    assert np.array_equal(
        codecs.decode_spk_emb(traffic.speaker_string(vec)), vec)
