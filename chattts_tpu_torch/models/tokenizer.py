"""Tokenizer: batch encoding with left-padding and code-prompt splicing.

Mirrors the reference wrapper (``ChatTTS/model/tokenizer.py:16-138``): encode
a batch of decorated prompts, left-pad to the batch max, expand ids to
``(B, T, num_vq)``, and - for zero-shot voice cloning - splice a decoded
``spk_smp`` code matrix into the tail with ``text_mask=0`` so those positions
embed through the audio-code tables.

Backends:
* **HF** - ``BertTokenizerFast`` over the reference ``asset/tokenizer`` dir
  (vocab 21,178), used whenever assets are available;
* **fallback** - a deterministic char-level tokenizer with the ChatTTS control
  tokens pinned at high ids (everything >= ``[break_0]`` is control, matching
  the ``ids < break_0`` filter at ``ChatTTS/core.py:426-427``), so the full
  pipeline runs and is testable without downloaded assets.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Tuple

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


class _HFBackend:
    def __init__(self, path: str):
        from transformers import BertTokenizerFast

        self._tok = BertTokenizerFast.from_pretrained(path)
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)

    def token_id(self, tok: str) -> int:
        return self._tok.convert_tokens_to_ids(tok)


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
