"""Speaker identity: sampling, portable codecs, prompt decoration.

Rebuild of ``ChatTTS/model/speaker.py``: speaker timbres are 768-dim Gaussian
samples from embedded population statistics, serialized as lzma+base16384
strings (wire-compatible via this package's ``codecs``), and injected into the
prompt embedding at the ``[spk_emb]`` position after L2 normalization.  The
injection itself happens inside the prefill (engine/generate.py), so this
module only carries host-side state and string logic.  Copied from
``chattts_tpu/models/speaker.py``; only :meth:`Speaker.apply` is rewritten in
torch.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from .. import codecs


class Speaker:
    def __init__(self, dim: int, spk_stat_str: str, seed: Optional[int] = None):
        std, mean = codecs.decode_spk_stat(spk_stat_str)
        std = std.astype(np.float32)
        mean = mean.astype(np.float32)
        if std.shape[0] != dim:
            # non-reference model width (e.g. test configs): tile/cut stats
            reps = -(-dim // std.shape[0])
            std = np.tile(std, reps)[:dim]
            mean = np.tile(mean, reps)[:dim]
        self.std = std
        self.mean = mean
        self.dim = dim
        self._rng = np.random.default_rng(seed)

    # -- sampling ----------------------------------------------------------

    def _sample_random(self) -> np.ndarray:
        return (self._rng.standard_normal(self.dim, dtype=np.float32)
                * self.std + self.mean)

    def sample_random(self) -> str:
        return codecs.encode_spk_emb(self._sample_random())

    @staticmethod
    def decode(spk_emb: Union[str, np.ndarray]) -> np.ndarray:
        if isinstance(spk_emb, str):
            return codecs.decode_spk_emb(spk_emb).astype(np.float32)
        return np.asarray(spk_emb, np.float32)

    @staticmethod
    def apply(emb, spk_emb: Union[str, np.ndarray], input_ids,
              spk_emb_ids: int):
        """Inject an L2-normalized speaker vector at [spk_emb] positions.

        Functional counterpart of the reference's in-place torch.where
        (speaker.py:21-52).  emb (B, T, D); input_ids
        (B, T, num_vq); returns the conditioned embeddings.  The jitted
        prefill paths inline this same math - exposed here for API parity
        and custom pipelines.
        """
        import torch

        vec = torch.as_tensor(Speaker.decode(spk_emb), device=emb.device)
        n = vec / torch.clamp(torch.linalg.vector_norm(vec), min=1e-12)
        ids = torch.as_tensor(input_ids, device=emb.device)
        cond = (ids[..., 0] == spk_emb_ids)[..., None]
        return torch.where(cond, n[None, None, :].to(emb.dtype), emb)

    # -- code-prompt codecs (zero-shot clone) ------------------------------

    @staticmethod
    def encode_prompt(prompt: np.ndarray) -> str:
        return codecs.encode_code_prompt(prompt)

    @staticmethod
    def decode_prompt(prompt: str) -> np.ndarray:
        return codecs.decode_code_prompt(prompt)

    # -- prompt decoration (speaker.py:54-87) ------------------------------

    @staticmethod
    def decorate_code_prompts(
        text: List[str],
        prompt: str,
        txt_smp: Optional[str],
        spk_emb: Optional[str],
    ) -> List[str]:
        out = []
        for t in text:
            t = (t.replace("[Stts]", "").replace("[spk_emb]", "")
                 .replace("[empty_spk]", "").strip())
            if prompt:
                t = prompt + t
            spk_tag = "[spk_emb]" if spk_emb is not None else "[empty_spk]"
            out.append(f"[Stts]{spk_tag}{txt_smp or ''}{t}[Ptts]")
        return out

    @staticmethod
    def decorate_text_prompts(text: List[str], prompt: str) -> List[str]:
        return [f"[Sbreak]{t}[Pbreak]{prompt}" for t in text]
