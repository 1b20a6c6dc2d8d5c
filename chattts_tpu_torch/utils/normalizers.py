"""Per-language text normalizer factories.

The reference registers external normalizers (NeMo for English,
WeTextProcessing for Chinese - ``tools/normalizer/en.py:5-12``, ``zh.py:4-7``),
neither of which exists in this environment.  These factories first try those
packages and otherwise fall back to built-in lightweight normalizers that
cover the common TTS needs: cardinal numbers, years, ordinals, percents,
currency and a few abbreviations - all dependency-free.

Register with the frontend::

    chat.normalizer.register("en", normalizer_en())
    chat.normalizer.register("zh", normalizer_zh())
"""

from __future__ import annotations

import re
from typing import Callable

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
          (100, "hundred")]

_ABBREV_EN = {
    "Mr.": "mister", "Mrs.": "missus", "Dr.": "doctor", "St.": "saint",
    "etc.": "et cetera", "vs.": "versus", "e.g.": "for example",
    "i.e.": "that is",
}


def _int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            out = _int_to_words(head) + " " + name
            if rest:
                out += " " + _int_to_words(rest)
            return out
    return _ONES[0]


def _year_to_words(n: int) -> str:
    """1984 -> nineteen eighty four (common speech form)."""
    if 1100 <= n <= 1999 or 2100 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return _int_to_words(hi) + " hundred"
        return _int_to_words(hi) + " " + (
            "oh " + _ONES[lo] if lo < 10 else _int_to_words(lo))
    return _int_to_words(n)


def _number_to_words_en(s: str) -> str:
    s = s.replace(",", "")
    if "." in s:
        intp, frac = s.split(".", 1)
        words = _int_to_words(int(intp or 0)) + " point " + " ".join(
            _ONES[int(c)] for c in frac if c.isdigit())
        return words
    return _int_to_words(int(s))


def _builtin_en(text: str) -> str:
    for k, v in _ABBREV_EN.items():
        text = text.replace(k, v)
    text = re.sub(r"\$\s?(\d[\d,]*(?:\.\d+)?)",
                  lambda m: _number_to_words_en(m.group(1)) + " dollars", text)
    text = re.sub(r"(\d[\d,]*(?:\.\d+)?)\s?%",
                  lambda m: _number_to_words_en(m.group(1)) + " percent", text)
    text = re.sub(r"\b(1[1-9]\d\d|20\d\d)\b",
                  lambda m: _year_to_words(int(m.group(1))), text)
    text = re.sub(r"(\d+)(st|nd|rd|th)\b",
                  lambda m: _ordinal_en(int(m.group(1))), text)
    text = re.sub(r"\d[\d,]*(?:\.\d+)?",
                  lambda m: _number_to_words_en(m.group(0)), text)
    return text


_ORDINAL_SPECIAL = {1: "first", 2: "second", 3: "third", 5: "fifth",
                    8: "eighth", 9: "ninth", 12: "twelfth"}


def _ordinal_en(n: int) -> str:
    if n in _ORDINAL_SPECIAL:
        return _ORDINAL_SPECIAL[n]
    words = _int_to_words(n)
    last = words.split()[-1]
    if last in _ORDINAL_SPECIAL.values():
        return words
    tail_map = {k: v for k, v in _ORDINAL_SPECIAL.items()}
    for k, v in tail_map.items():
        if words.endswith(_ONES[k] if k < 20 else ""):
            return words[: -len(_ONES[k])] + v
    if words.endswith("y"):
        return words[:-1] + "ieth"
    return words + "th"


_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_GROUPS = ["", "万", "亿"]


def _int_to_zh(n: int) -> str:
    if n == 0:
        return _ZH_DIGITS[0]
    if n < 0:
        return "负" + _int_to_zh(-n)
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            if parts and not parts[-1].endswith(_ZH_DIGITS[0]):
                parts.append(_ZH_DIGITS[0])
            continue
        s = ""
        zero_pending = False
        for pos in range(3, -1, -1):
            d = (g // 10 ** pos) % 10
            if d == 0:
                zero_pending = s != ""
                continue
            if zero_pending:
                s += _ZH_DIGITS[0]
                zero_pending = False
            if not (pos == 1 and d == 1 and s == "" and g < 100):
                s += _ZH_DIGITS[d]
            s += _ZH_UNITS[pos]
        parts.append(s + _ZH_GROUPS[gi])
    return "".join(parts).rstrip(_ZH_DIGITS[0])


def _builtin_zh(text: str) -> str:
    text = re.sub(r"(\d+)\.(\d+)",
                  lambda m: _int_to_zh(int(m.group(1))) + "点" + "".join(
                      _ZH_DIGITS[int(c)] for c in m.group(2)), text)
    text = re.sub(r"(\d+)%",
                  lambda m: "百分之" + _int_to_zh(int(m.group(1))), text)
    return re.sub(r"\d+", lambda m: _int_to_zh(int(m.group(0))), text)


def normalizer_en() -> Callable[[str], str]:
    """English normalizer: NeMo when installed, built-in otherwise."""
    try:  # pragma: no cover - external package
        from nemo_text_processing.text_normalization.normalize import (
            Normalizer as NeMo,
        )

        nemo = NeMo(input_case="cased", lang="en")
        return lambda text: nemo.normalize(text)
    except ImportError:
        return _builtin_en


def normalizer_zh() -> Callable[[str], str]:
    """Chinese normalizer: WeTextProcessing when installed, built-in else."""
    try:  # pragma: no cover - external package
        from tn.chinese.normalizer import Normalizer as WeTN

        wetn = WeTN()
        return lambda text: wetn.normalize(text)
    except ImportError:
        return _builtin_zh
