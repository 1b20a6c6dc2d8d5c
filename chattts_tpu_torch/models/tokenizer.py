"""Tokenizer: batch encoding with left-padding and code-prompt splicing.

Mirrors the reference wrapper (``ChatTTS/model/tokenizer.py:16-138``): encode
a batch of decorated prompts, left-pad to the batch max, expand ids to
``(B, T, num_vq)``, and - for zero-shot voice cloning - splice a decoded
``spk_smp`` code matrix into the tail with ``text_mask=0`` so those positions
embed through the audio-code tables.

Backends:
* **HF** - the reference ``asset/tokenizer`` dir (vocab 21,178), used
  whenever assets are available: its ``tokenizer.json`` read and run here in
  plain Python, the pipeline ``BertTokenizerFast`` runs on it (added tokens
  matched whole, ``BertNormalizer``, ``BertPreTokenizer``, ``WordPiece`` and
  its decoder), with no ``transformers`` or ``tokenizers`` import;
* **fallback** - a deterministic char-level tokenizer with the ChatTTS control
  tokens pinned at high ids (everything >= ``[break_0]`` is control, matching
  the ``ids < break_0`` filter at ``ChatTTS/core.py:426-427``), so the full
  pipeline runs and is testable without downloaded assets.
"""

from __future__ import annotations

import json
import logging
import os
import re
import string
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# Control tokens of the ChatTTS prompt language. [break_0] must sort first:
# every id >= break_0's is treated as non-text by the refine pass.
CONTROL_TOKENS = (
    ["[break_0]", "[break_1]", "[break_2]", "[break_3]", "[break_4]",
     "[break_5]", "[break_6]", "[break_7]"]
    + [f"[laugh_{i}]" for i in range(3)]
    + [f"[oral_{i}]" for i in range(10)]
    + [f"[speed_{i}]" for i in range(10)]
    + ["[uv_break]", "[v_break]", "[lbreak]", "[llbreak]", "[laugh]",
       "[music]", "[pure]",
       "[Sbreak]", "[Pbreak]", "[Ebreak]",
       "[Stts]", "[Ptts]", "[Etts]", "[spk_emb]", "[empty_spk]"]
)

_TAG_RE = re.compile(r"\[[\w_]+\]")


class _FallbackBackend:
    """Char-level deterministic tokenizer for asset-free operation."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        n_ctrl = len(CONTROL_TOKENS)
        base = vocab_size - n_ctrl
        self._ctrl = {t: base + i for i, t in enumerate(CONTROL_TOKENS)}
        self._ctrl_inv = {v: k for k, v in self._ctrl.items()}
        self._chars: dict[str, int] = {}
        self._chars_inv: dict[int, str] = {}
        self._ctrl_base = base

    def _char_id(self, c: str) -> int:
        if c not in self._chars:
            # stable hash into [100, ctrl_base); linear-probe collisions
            h = 100 + (ord(c) * 2654435761) % (self._ctrl_base - 100)
            while h in self._chars_inv:
                h = 100 + (h - 100 + 1) % (self._ctrl_base - 100)
            self._chars[c] = h
            self._chars_inv[h] = c
        return self._chars[c]

    def encode(self, text: str) -> List[int]:
        ids = []
        pos = 0
        for m in _TAG_RE.finditer(text):
            ids.extend(self._char_id(c) for c in text[pos : m.start()])
            tok = m.group(0)
            if tok in self._ctrl:
                ids.append(self._ctrl[tok])
            else:
                ids.extend(self._char_id(c) for c in tok)
            pos = m.end()
        ids.extend(self._char_id(c) for c in text[pos:])
        return ids

    def decode(self, ids: List[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in self._ctrl_inv:
                out.append(self._ctrl_inv[i])
            else:
                out.append(self._chars_inv.get(i, ""))
        return "".join(out)

    def token_id(self, tok: str) -> int:
        return self._ctrl[tok]


# Rust's ``char::is_whitespace`` (the Unicode White_Space property), which
# the tokenizers library's BERT normalizer and pre-tokenizer use
_WHITE_SPACE = frozenset(map(chr, [
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punct(c: str) -> bool:
    return ((c.isascii() and c in string.punctuation)
            or unicodedata.category(c).startswith("P"))


# the WordPiece decoder's cleanup of each token; ``clean_up_tokenization``
# of the decoded string is the same without " do not"
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
            (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
            (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
            (" 're", "'re"))
_CLEAN_UP_SPACES = tuple(p for p in _CLEANUP if p[0] != " do not")


def _replace_all(text: str, pairs) -> str:
    for a, b in pairs:
        text = text.replace(a, b)
    return text


class _HFBackend:
    """A BERT WordPiece ``tokenizer.json`` (as ``BertTokenizerFast``
    saves it) run in plain Python, as the tokenizers library runs it:

    1. added tokens whose ``normalized`` is false are matched whole on the
       raw text (leftmost, then longest), then each remaining piece is
       normalized and the normalized added tokens are matched on it (a
       token with ``single_word``, ``lstrip`` or ``rstrip`` is refused);
    2. ``BertNormalizer``: drop NUL, U+FFFD and control characters and map
       white space to ' ' (``clean_text``), pad CJK ideographs with spaces,
       strip accents (NFD, drop Mn) and lowercase; ``tokenizer_config.json``'s
       ``do_lower_case``, ``strip_accents`` and ``tokenize_chinese_chars``
       override the file's, as ``BertTokenizerFast`` does;
    3. ``BertPreTokenizer``: split on white space, isolate punctuation;
    4. ``WordPiece``: greedy longest match, later pieces with the
       continuing prefix; a word longer than ``max_input_chars_per_word``
       or with an unmatched piece is the unknown token.

    ``decode`` runs the WordPiece decoder and then
    ``clean_up_tokenization_spaces`` from ``tokenizer_config.json``.
    """

    def __init__(self, path: str):
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        conf_path = os.path.join(path, "tokenizer_config.json")
        conf = {}
        if os.path.isfile(conf_path):
            with open(conf_path, encoding="utf-8") as f:
                conf = json.load(f)
        model = spec.get("model") or {}
        norm = spec.get("normalizer") or {}
        pre = spec.get("pre_tokenizer") or {}
        dec = spec.get("decoder") or {}
        for part, got, want in (("model", model.get("type"), "WordPiece"),
                                ("normalizer", norm.get("type"),
                                 "BertNormalizer"),
                                ("pre_tokenizer", pre.get("type"),
                                 "BertPreTokenizer"),
                                ("decoder", dec.get("type"), "WordPiece")):
            if got != want:
                raise ValueError(f"{path}/tokenizer.json: {part} is {got!r}; "
                                 f"only a {want} {part} is read")
        self._vocab: Dict[str, int] = {k: int(v)
                                       for k, v in model["vocab"].items()}
        self._inv = {v: k for k, v in self._vocab.items()}
        self._unk = model.get("unk_token", "[UNK]")
        self._prefix = model.get("continuing_subword_prefix", "##")
        self._max_chars = int(model.get("max_input_chars_per_word", 100))
        self._clean_text = bool(norm.get("clean_text", True))
        self._cjk = bool(conf.get("tokenize_chinese_chars", True))
        self._lowercase = bool(conf.get("do_lower_case", True))
        strip = conf.get("strip_accents")
        self._strip_accents = self._lowercase if strip is None else bool(strip)
        self._dec_prefix = dec.get("prefix", "##")
        self._dec_cleanup = bool(dec.get("cleanup", True))
        self._clean_up_spaces = bool(
            conf.get("clean_up_tokenization_spaces", False))
        self._added: Dict[str, int] = {}
        self._added_inv: Dict[int, str] = {}
        raw, normed = [], []
        for d in spec.get("added_tokens") or []:
            flags = [f for f in ("single_word", "lstrip", "rstrip")
                     if d.get(f)]
            if flags:
                raise ValueError(f"{path}/tokenizer.json: added token "
                                 f"{d['content']!r} sets {flags}; not read")
            tid, content = int(d["id"]), d["content"]
            self._added[content] = tid
            self._added_inv[tid] = content
            if d.get("normalized", True):
                normed.append((self._normalize(content), tid))
            else:
                raw.append((content, tid))
        self._raw_patterns = self._pattern_index(raw)
        self._norm_patterns = self._pattern_index(normed)
        self.vocab_size = len(set(self._vocab) | set(self._added))

    @staticmethod
    def _pattern_index(patterns):
        """first character -> [(pattern, token id)], longest first."""
        index: Dict[str, list] = {}
        for pat, tid in patterns:
            if pat:
                index.setdefault(pat[0], []).append((pat, tid))
        for lst in index.values():
            lst.sort(key=lambda pt: -len(pt[0]))
        return index

    def _normalize(self, text: str) -> str:
        if self._clean_text:
            text = "".join(" " if c in _WHITE_SPACE else c for c in text
                           if not (c in "\0\ufffd" or _is_control(c)))
        if self._cjk:
            text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        if self._strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self._lowercase:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def _split_added(text: str, index) -> List[Tuple[str, Optional[int]]]:
        """``text`` -> pieces, each (text, None) or (matched text, token
        id): leftmost-longest matches that do not overlap."""
        out: List[Tuple[str, Optional[int]]] = []
        done = i = 0  # done: the end of the last piece emitted
        while i < len(text):
            hit = next(((pat, tid) for pat, tid in index.get(text[i], ())
                        if text.startswith(pat, i)), None)
            if hit is None:
                i += 1
                continue
            if done < i:
                out.append((text[done:i], None))
            out.append(hit)
            done = i = i + len(hit[0])
        if done < len(text):
            out.append((text[done:], None))
        return out

    @staticmethod
    def _pre_tokenize(text: str) -> List[str]:
        words, cur = [], []
        for c in text:
            if c in _WHITE_SPACE or _is_punct(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if c not in _WHITE_SPACE:
                    words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[int]:
        unk = [self._vocab[self._unk]]
        if len(word) > self._max_chars:
            return unk
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self._prefix + sub
                if sub in self._vocab:
                    ids.append(self._vocab[sub])
                    break
                end -= 1
            else:
                return unk
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(text, self._raw_patterns):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, sid in self._split_added(self._normalize(piece),
                                              self._norm_patterns):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in self._pre_tokenize(sub):
                    ids.extend(self._wordpiece(word))
        return ids

    def decode(self, ids: List[int]) -> str:
        toks = [t for t in (self._added_inv.get(i, self._inv.get(i))
                            for i in map(int, ids)) if t is not None]
        out = []
        for n, tok in enumerate(toks):
            if n:
                tok = (tok.replace(self._dec_prefix, "", 1)
                       if tok.startswith(self._dec_prefix) else " " + tok)
            out.append(_replace_all(tok, _CLEANUP) if self._dec_cleanup
                       else tok)
        text = "".join(out)
        return (_replace_all(text, _CLEAN_UP_SPACES) if self._clean_up_spaces
                else text)

    def token_id(self, tok: str) -> int:
        """The token's id; the unknown token's for a token not in the
        vocabulary (``convert_tokens_to_ids``)."""
        if tok in self._added:
            return self._added[tok]
        return self._vocab.get(tok, self._vocab.get(self._unk))


class Tokenizer:
    def __init__(self, tokenizer_path: Optional[str] = None,
                 vocab_size: int = 21178):
        if tokenizer_path is not None:
            self._backend = _HFBackend(tokenizer_path)
        else:
            self._backend = _FallbackBackend(vocab_size)
        self.len = self._backend.vocab_size
        self.spk_emb_ids = self._backend.token_id("[spk_emb]")
        self.break_0_ids = self._backend.token_id("[break_0]")
        self.eos_token = self._backend.token_id("[Ebreak]")
        # The refine pass strips control tokens as ``ids < break_0_ids``
        # (core.py filter; reference ChatTTS/core.py:426-427).  That silently
        # assumes the vocab places EVERY control token at or above [break_0]
        # - validate it at load, because a violating vocab would leak control
        # tokens into refined text with no error anywhere downstream.  A
        # token missing from an HF vocab maps to [UNK] (a low id) and is
        # flagged by the same check.
        bad = [t for t in CONTROL_TOKENS
               if (self._backend.token_id(t) or 0) < self.break_0_ids]
        if bad:
            logger.warning(
                "control tokens below [break_0] (id %d) in the vocab: %s - "
                "the refine-text filter will not strip them",
                self.break_0_ids, bad)

    def encode(
        self,
        text: List[str],
        num_vq: int,
        prompt: Optional[np.ndarray] = None,  # (num_vq, Tp) int code matrix
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (ids (B, T, num_vq) i32, attn_mask (B, T) bool, text_mask bool).

        Left padding + optional code-prompt tail, as tokenizer.py:35-126.
        """
        seqs = [np.asarray(self._backend.encode(t), np.int32) for t in text]
        prompt_size = 0
        if prompt is not None:
            if prompt.shape[0] != num_vq:
                raise ValueError("prompt dim 0 must equal num_vq")
            prompt_size = prompt.shape[1]
        T = max(len(s) for s in seqs) + prompt_size
        B = len(seqs)
        ids = np.zeros((B, T, num_vq), np.int32)
        attn = np.zeros((B, T), np.bool_)
        tmask = np.zeros((B, T), np.bool_)
        for b, s in enumerate(seqs):
            lo = T - prompt_size - len(s)
            ids[b, lo : T - prompt_size] = s[:, None]
            attn[b, lo:] = True
            tmask[b, lo : T - prompt_size] = True
        if prompt_size:
            ids[:, T - prompt_size :] = prompt.T[None]  # (Tp, num_vq)
        return ids, attn, tmask

    def decode(self, sequences: List) -> List[str]:
        return [self._backend.decode(list(map(int, s))) for s in sequences]
