"""The port's ``tokenizer.json`` reader against ``BertTokenizerFast``.

A synthetic BERT WordPiece vocabulary with the ChatTTS control tokens added
(some as normal added tokens, some as special ones) is saved by
``BertTokenizerFast.save_pretrained``; the port reads the same directory
without ``transformers`` or ``tokenizers``.  Ids from ``encode`` and
strings from ``decode`` must be equal on texts mixing CJK, Latin, digits,
punctuation and accents, upper case, words longer than 100 characters and
every control token.
"""

import json
import shutil

import numpy as np
import pytest
from transformers import BertTokenizerFast

from chattts_tpu_torch.models.tokenizer import (CONTROL_TOKENS, Tokenizer,
                                                _HFBackend)
from torch_port_utils import write_tokenizer

TEXTS = [
    "Hello World! The quick brown fox.",
    "你好，世界。中文语音合成，我们！",
    "Café naïve résumé ÀÉÎ ñ ü",
    "[Stts][spk_emb][speed_5]hello[break_3] world[uv_break][Ptts]",
    "x" * 101 + " hello " + "ab" * 50 + " " + "a" * 100,
    "unbelievable unbelieving 12345 3.14 2,000",
    "[stts] [STTS] [Speed_5] [speed_5 ] [ speed_5]",
    "tab\there\nnew\x00line​ 　 wide\x1f\u0085",
    "it's don't can't 'quoted' ?! ... --",
    "[UNK] [MASK] [CLS]x [PAD][SEP]",
    "ΣΑΣ İstanbul ß ǅ",
    "hello[laugh_0]world[laugh]你好[lbreak]",
    "MiXeD CaSe WORDS Speech",
    "emoji 😀 and symbols $+<=>^`| ~ @#%&*",
    "",
    "   ",
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokenizer")
    write_tokenizer(str(d), 400)
    return str(d)


@pytest.fixture(scope="module")
def pair(tok_dir):
    return BertTokenizerFast.from_pretrained(tok_dir), _HFBackend(tok_dir)


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_encode_and_decode_match(pair, text):
    hf, port = pair
    ids = hf.encode(text, add_special_tokens=False)
    assert port.encode(text) == ids
    assert port.decode(ids) == hf.decode(ids)


@pytest.mark.parametrize("tok", CONTROL_TOKENS)
def test_control_token(pair, tok):
    hf, port = pair
    assert port.token_id(tok) == hf.convert_tokens_to_ids(tok)
    text = f"a{tok}b {tok} {tok.upper()}"
    ids = hf.encode(text, add_special_tokens=False)
    assert port.encode(text) == ids
    assert port.decode(ids) == hf.decode(ids)


def test_vocab_size_unknown_tokens_and_random_ids(pair):
    hf, port = pair
    assert port.vocab_size == len(hf) == 400
    assert port.token_id("[not_a_token]") == hf.convert_tokens_to_ids(
        "[not_a_token]") == hf.unk_token_id
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, 410, 40).tolist()  # ids past the vocab too
        assert port.decode(ids) == hf.decode(ids)


def test_tokenizer_wrapper_matches_the_jax_package(tok_dir):
    from chattts_tpu.models.tokenizer import Tokenizer as JTokenizer

    port, ref = Tokenizer(tok_dir), JTokenizer(tok_dir)
    texts = ["[Stts][spk_emb]Hello, 你好![Ptts]", "one more [uv_break]"]
    prompt = np.arange(8, dtype=np.int32).reshape(4, 2)
    for a, b in zip(port.encode(texts, 4, prompt), ref.encode(texts, 4,
                                                              prompt)):
        np.testing.assert_array_equal(a, b)
    ids = ref.encode(texts, 1)[0][..., 0]
    assert port.decode(ids) == ref.decode(ids)
    for attr in ("len", "spk_emb_ids", "break_0_ids", "eos_token"):
        assert getattr(port, attr) == getattr(ref, attr)


@pytest.mark.parametrize("override", [{"do_lower_case": False},
                                      {"strip_accents": False},
                                      {"tokenize_chinese_chars": False},
                                      {"clean_up_tokenization_spaces": False}])
def test_tokenizer_config_overrides(tok_dir, tmp_path, override):
    """``tokenizer_config.json`` overrides the normalizer's options and
    sets the decode clean-up, as ``BertTokenizerFast.from_pretrained``
    does."""
    d = tmp_path / "tok"
    shutil.copytree(tok_dir, d)
    conf = json.loads((d / "tokenizer_config.json").read_text())
    conf.update(override)
    (d / "tokenizer_config.json").write_text(json.dumps(conf))
    hf, port = BertTokenizerFast.from_pretrained(str(d)), _HFBackend(str(d))
    for text in TEXTS:
        ids = hf.encode(text, add_special_tokens=False)
        assert port.encode(text) == ids, text
        assert port.decode(ids) == hf.decode(ids), text


@pytest.mark.parametrize("part,value", [
    ("model", {"type": "BPE", "vocab": {}, "merges": []}),
    ("normalizer", {"type": "NFC"}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("decoder", None),
])
def test_other_pipelines_are_refused(tok_dir, tmp_path, part, value):
    d = tmp_path / "tok"
    shutil.copytree(tok_dir, d)
    spec = json.loads((d / "tokenizer.json").read_text())
    spec[part] = value
    (d / "tokenizer.json").write_text(json.dumps(spec))
    found = None if value is None else value["type"]
    with pytest.raises(ValueError, match=f"{part} is {found!r}"):
        _HFBackend(str(d))


@pytest.mark.parametrize("flag", ["single_word", "lstrip", "rstrip"])
def test_added_token_strip_flags_are_refused(tok_dir, tmp_path, flag):
    d = tmp_path / "tok"
    shutil.copytree(tok_dir, d)
    spec = json.loads((d / "tokenizer.json").read_text())
    spec["added_tokens"][-1][flag] = True
    (d / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=flag):
        _HFBackend(str(d))
