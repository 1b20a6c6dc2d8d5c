"""chattts_tpu_torch: the PyTorch / CUDA port of chattts_tpu.

The same text-to-speech system as ``chattts_tpu`` (a Llama decoder sampling
4-codebook speech tokens, a ConvNeXt mel decoder and a Vocos vocoder), in
PyTorch for an NVIDIA H100.  The JAX package stays the reference; this one
imports neither it nor JAX.  Every decode step runs the hand-written CUDA
kernel K1 (``ops/decode_step.py``, ``csrc/decode_step.cu``).
"""

from .config import Config
from .core import Chat
from .engine.generate import Interrupt

__version__ = "0.1.0"

__all__ = ["Chat", "Config", "Interrupt", "__version__"]
