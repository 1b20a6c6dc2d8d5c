"""A configuration's family: the architecture it is, as a module of its own.

A configuration file names its family under ``"family"`` (``"chattts"``
where the key is absent); the family is the module
``portbench/families/<name>.py``.  The harness takes from it what depends
on the architecture, and nothing else:

* ``specs(cfg) -> (bf16 leaves, float32 leaves)``: the weight layout, as
  ``(path, shape, mean, std)`` tuples (``weights.draw`` draws them);
* ``load_chat(cfg, weights, device, use_engine=False)``: the program's
  ``Chat`` on those weights, at the configuration's tiers;
* ``reference``: the plain reference the judge calls, with
  ``request_reference(weights, cfg, text, spk, codes, kv_bits,
  weight_bits, prompt_bits=0, resumes=(), with_wav=True)`` (handed the
  whole configuration), ``prompt_ids(text, vocab)``,
  ``penalized(logits, codes, penalty, eos)``, ``gaps(scores, picked)``,
  ``relative_error(got, want)`` and ``tf32_off()``;
* ``lower_tier(weight_bits)``: the weight tier one below ``weight_bits``,
  the control's;
* ``sizes(cfg)``: the numbers the drivers and the judge read of any
  configuration: ``speaker_dim`` (the speaker vector's length),
  ``num_audio_tokens`` (a codebook's size; its last id is EOS) and
  ``num_text_tokens`` (the prompt's vocabulary).

Every configuration file also states ``weight_bits`` and ``kv_bits`` (the
judge hands them to the reference) and the ``vocos`` group of the shared
audio back end (``hop_length``, ``sample_rate``: the session's audio
seconds).
"""

from __future__ import annotations

import importlib
import os
import re

DEFAULT = "chattts"
FUNCTIONS = ("specs", "load_chat", "lower_tier", "sizes")
REFERENCE = ("request_reference", "prompt_ids", "penalized", "gaps",
             "relative_error", "tf32_off")
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")   # a module's name
FAMILIES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "families")


class Unknown(LookupError):
    """A family with no module under ``families/``, or one that lacks part
    of the interface."""


def missing(mod) -> list:
    """The parts of the interface that ``mod`` lacks."""
    out = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    ref = getattr(mod, "reference", None)
    return out + ["reference." + f for f in REFERENCE
                  if not callable(getattr(ref, f, None))]


def of(config: dict):
    """The family module of a configuration."""
    name = config.get("family", DEFAULT)
    if not (isinstance(name, str) and NAME.match(name)
            and os.path.isfile(os.path.join(FAMILIES, name + ".py"))):
        raise Unknown(f"unknown family {name!r}: no file "
                      f"portbench/families/{name}.py")
    mod = importlib.import_module("families." + name)
    lacks = missing(mod)
    if lacks:
        raise Unknown(f"family {name!r} (portbench/families/{name}.py) "
                      f"lacks {', '.join(lacks)}")
    return mod
