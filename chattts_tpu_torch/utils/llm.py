"""LLM text-preparation client (a copy of ``chattts_tpu/utils/llm.py``, the
reference's ``tools/llm/llm.py`` equivalent).

The reference wraps the ``openai`` SDK to ask an upstream chat model to
rewrite arbitrary text into TTS-friendly form (expand numbers, drop symbols
that cannot be spoken, shorten).  The ``openai`` package is not available
here, so this client speaks the OpenAI-compatible chat-completions HTTP
protocol directly with stdlib ``urllib`` - same capability, no dependency.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

# Prompt templates asking an upstream LLM to make text speakable.
PROMPT_DIRECT = (
    "Please rewrite the following text so it is natural to read aloud: "
    "expand numbers and abbreviations into words, remove symbols that "
    "cannot be spoken, and keep the meaning unchanged. Reply with the "
    "rewritten text only."
)
PROMPT_SHORTEN = (
    "Please condense the following text to its key points so it can be "
    "read aloud in under a minute, using only speakable words (no digits "
    "or symbols). Reply with the rewritten text only."
)


class ChatClient:
    """Minimal OpenAI-compatible chat-completions client."""

    def __init__(self, api_key: str, base_url: str,
                 model: str, timeout: float = 120.0):
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout = timeout

    def chat(self, user_content: str, system_prompt: Optional[str] = None
             ) -> str:
        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": user_content})
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps({"model": self.model,
                             "messages": messages}).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            })
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = json.load(r)
        return out["choices"][0]["message"]["content"]

    def prepare_tts_text(self, text: str, shorten: bool = False) -> str:
        prompt = PROMPT_SHORTEN if shorten else PROMPT_DIRECT
        return self.chat(f"{prompt}\n\n{text}")
