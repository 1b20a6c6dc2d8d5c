"""Text normalization frontend.

Behavioral rebuild of ``ChatTTS/norm.py``: language detection (zh/en by
char/word counts), pluggable per-language normalizer callables, tag-aware
splitting that protects ``[...]`` control tokens from normalization, homophone
replacement from a character map, half/full-width punctuation maps, and
invalid-character rejection.

The reference JIT-compiles its scan loops with numba (norm.py:13-68); these
are dict lookups over a few hundred characters per utterance - nowhere near
the audio hot path - so plain Python dict translation (O(1) per char, vs the
reference's O(map) linear scan per char) is both simpler and faster here.

The homophone map (16.4k zh pairs, upstream data from ChatTTS
res/homophones_map.json) is vendored under ``res/`` so zh
pronunciation fixes work out of the box; ``CHATTTS_HOMOPHONES_MAP``
overrides it.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Callable, Dict, List, Literal, Optional, Tuple

_DEFAULT_MAP_PATHS = [
    os.environ.get("CHATTTS_HOMOPHONES_MAP", ""),
    os.path.join(os.path.dirname(__file__), "res", "homophones_map.json"),
]


def split_tags(text: str) -> Tuple[List[str], List[str]]:
    """Split text into (plain segments, [tag] tokens); norm.py:37-56."""
    texts: List[str] = []
    tags: List[str] = []
    current_text = ""
    current_tag = ""
    for c in text:
        if c == "[":
            texts.append(current_text)
            current_text = ""
            current_tag = c
        elif current_tag:
            current_tag += c
        else:
            current_text += c
        if c == "]":
            tags.append(current_tag)
            current_tag = ""
    if current_text:
        texts.append(current_text)
    return texts, tags


def combine_tags(texts: List[str], tags: List[str]) -> str:
    tags = list(tags)
    out = ""
    for t in texts:
        tg = tags.pop(0) if tags else ""
        out += t + tg
    return out


_CHAR_SIMPLIFIER = str.maketrans({
    "：": "，", "；": "，", "！": "。", "（": "，", "）": "，",
    "【": "，", "】": "，", "『": "，", "』": "，", "「": "，",
    "」": "，", "《": "，", "》": "，", "－": "，",
    ":": ",", ";": ",", "!": ".", "(": ",", ")": ",",
    ">": ",", "<": ",", "-": ",",
})

_HALF_TO_FULL = str.maketrans({
    "!": "！", '"': "“", "'": "‘", "#": "＃", "$": "＄", "%": "％",
    "&": "＆", "(": "（", ")": "）", ",": "，", "-": "－", "*": "＊",
    "+": "＋", ".": "。", "/": "／", ":": "：", ";": "；", "<": "＜",
    "=": "＝", ">": "＞", "?": "？", "@": "＠", "\\": "＼", "^": "＾",
    "`": "｀", "{": "｛", "|": "｜", "}": "｝", "~": "～",
})


class Normalizer:
    def __init__(self, map_file_path: Optional[str] = None,
                 logger: logging.Logger = logging.getLogger(__name__)):
        self.logger = logger
        self.normalizers: Dict[str, Callable[[str], str]] = {}
        self.homophones_map = self._load_homophones_map(map_file_path)
        self.reject_pattern = re.compile(r"[^一-鿿A-Za-z，。、,\. ]")
        self.sub_pattern = re.compile(r"\[[\w_]+\]")
        self.chinese_char_pattern = re.compile(r"[一-鿿]")
        self.english_word_pattern = re.compile(r"\b[A-Za-z]+\b")

    def __call__(
        self,
        text: str,
        do_text_normalization: bool = True,
        do_homophone_replacement: bool = True,
        lang: Optional[Literal["zh", "en"]] = None,
    ) -> str:
        if do_text_normalization:
            _lang = self._detect_language(text) if lang is None else lang
            if _lang in self.normalizers:
                texts, tags = split_tags(text)
                texts = [self.normalizers[_lang](t) for t in texts]
                text = combine_tags(texts, tags) if tags else texts[0]
            if _lang == "zh":
                text = text.translate(_HALF_TO_FULL)
        invalid = self._count_invalid_characters(text)
        if invalid:
            self.logger.warning("found invalid characters: %s", invalid)
            text = text.translate(_CHAR_SIMPLIFIER)
        if do_homophone_replacement and self.homophones_map:
            replaced = []
            chars = list(text)
            for i, ch in enumerate(chars):
                rep = self.homophones_map.get(ch)
                if rep is not None:
                    chars[i] = rep
                    replaced.append((ch, rep))
            if replaced:
                text = "".join(chars)
                self.logger.info(
                    "replace homophones: %s",
                    ", ".join(f"{a}->{b}" for a, b in replaced))
        if invalid:
            texts, tags = split_tags(text)
            texts = [self.reject_pattern.sub("", t) for t in texts]
            text = combine_tags(texts, tags) if tags else texts[0]
        return text

    def register(self, name: str, normalizer: Callable[[str], str]) -> bool:
        if name in self.normalizers:
            self.logger.warning("name %s has been registered", name)
            return False
        try:
            if not isinstance(normalizer("test string 测试字符串"), str):
                self.logger.warning("normalizer must map str -> str")
                return False
        except Exception as e:  # noqa: BLE001 - mirror reference behavior
            self.logger.warning("%s", e)
            return False
        self.normalizers[name] = normalizer
        return True

    def unregister(self, name: str):
        self.normalizers.pop(name, None)

    def destroy(self):
        self.normalizers.clear()
        self.homophones_map = {}

    @staticmethod
    def _load_homophones_map(path: Optional[str]) -> Dict[str, str]:
        candidates = [path] if path else []
        candidates += [p for p in _DEFAULT_MAP_PATHS if p]
        for p in candidates:
            if p and os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    return json.load(f)
        return {}

    def _count_invalid_characters(self, s: str) -> set:
        return set(self.reject_pattern.findall(self.sub_pattern.sub("", s)))

    def _detect_language(self, sentence: str) -> Literal["zh", "en"]:
        zh = len(self.chinese_char_pattern.findall(sentence))
        en = len(self.english_word_pattern.findall(sentence))
        return "zh" if zh > en else "en"
