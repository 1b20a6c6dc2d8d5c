"""chattts_tpu_torch: the PyTorch / CUDA port of chattts_tpu.

The same text-to-speech system as ``chattts_tpu`` (a Llama decoder sampling
4-codebook speech tokens, a ConvNeXt mel decoder and a Vocos vocoder), in
PyTorch for an NVIDIA H100.  The JAX package stays the reference; this one
imports neither it nor JAX.  Every decode step runs the hand-written CUDA
kernels of ``ops/decode_step.py`` (``csrc/decode_step.cu``).  Weights come
from a ChatTTS asset tree, verified against ``res/sha256_map.json`` and read
without ``safetensors`` or ``transformers`` (``Chat.load(source="local" |
"custom")``), or are drawn from a seed (``source="random"``).
"""

from .config import Config
from .core import Chat
from .engine.generate import Interrupt

__version__ = "0.1.0"

__all__ = ["Chat", "Config", "Interrupt", "__version__"]
