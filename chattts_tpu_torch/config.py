"""Model/runtime configuration tree.

Hyper-parameter values mirror the reference checkpoints so that real ChatTTS
weights load unchanged (reference: ``ChatTTS/config/config.py``).  Unlike the
reference we keep the config immutable (frozen dataclasses) and add TPU
runtime knobs (dtype, mesh axes, decode buckets) that have no upstream
counterpart.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

_RES_DIR = os.path.join(os.path.dirname(__file__), "res")


@dataclass(frozen=True)
class ConvStackConfig:
    """One DVAE-style ConvNeXt stack (encoder or decoder half).

    Reference: ``ChatTTS/model/dvae.py:131-160`` (DVAEDecoder ctor).
    """

    idim: int
    odim: int
    hidden: int = 256
    n_layer: int = 12
    bn_dim: int = 128
    kernel: int = 7
    dilation: int = 2


@dataclass(frozen=True)
class GFSQConfig:
    """Grouped-residual finite scalar quantizer (dvae.py:69-90)."""

    dim: int = 1024
    levels: Tuple[int, ...] = (5, 5, 5, 5)
    groups: int = 2  # "G"
    residuals: int = 2  # "R" (num_quantizers)

    @property
    def codebook_size(self) -> int:
        n = 1
        for l in self.levels:
            n *= l
        return n

    @property
    def num_codebooks(self) -> int:
        return self.groups * self.residuals


@dataclass(frozen=True)
class DVAEConfig:
    """Full DVAE: mel encoder + GFSQ + mel decoder (dvae.py:209-259)."""

    encoder: ConvStackConfig = field(
        default_factory=lambda: ConvStackConfig(idim=512, odim=1024)
    )
    decoder: ConvStackConfig = field(
        default_factory=lambda: ConvStackConfig(idim=512, odim=512)
    )
    vq: GFSQConfig = field(default_factory=GFSQConfig)
    # conv_out input width == decoder.odim; output is always 100 mel bins
    n_mels: int = 100


@dataclass(frozen=True)
class DecoderConfig:
    """Hidden-state->mel "Decoder" DVAE (no VQ). config.py:14-21."""

    stack: ConvStackConfig = field(
        default_factory=lambda: ConvStackConfig(idim=384, odim=384, hidden=512)
    )
    n_mels: int = 100


@dataclass(frozen=True)
class GPTConfig:
    """Llama-architecture decoder config (config.py:51-63 + HF defaults)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_attention_heads: int = 12
    num_hidden_layers: int = 20
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    num_audio_tokens: int = 626  # 625 GFSQ codes + 1 EOS
    num_text_tokens: int = 21178
    num_vq: int = 4
    spk_emb_dim: int = 192

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class MelConfig:
    """Mel feature extractor (config.py:75-80; torchaudio-compatible)."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    center: bool = True


@dataclass(frozen=True)
class VocosConfig:
    """Vocos vocoder: ConvNeXt backbone + ISTFT head (config.py:89-121)."""

    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    mel: MelConfig = field(default_factory=MelConfig)


@dataclass(frozen=True)
class RuntimeConfig:
    """TPU runtime knobs (no reference counterpart)."""

    # compute dtype for the transformer ("bfloat16" or "float32")
    dtype: str = "bfloat16"
    # prompt lengths are padded up to a multiple of this to bound recompiles
    prefill_bucket: int = 32
    # decode-loop buffer sizes are rounded up to a multiple of this
    decode_bucket: int = 256
    # mesh axis names built by parallel.mesh.make_mesh: data-parallel over
    # requests/batch, sequence-parallel (training prefill), tensor-parallel
    # over heads/FFN.  Informational - consumers address axes by name.
    mesh_axes: Tuple[str, str, str] = ("dp", "sp", "tp")
    # streaming: reduced receptive-field guard for the FIRST emission only
    # (time-to-first-audio lever; None = always exact). 8 positions lets the
    # very first decode chunk emit audio.
    stream_first_guard: Optional[int] = 8
    # transfer finished waveforms host-ward as int16 PCM (the product's
    # output format) instead of float32 - halves device->host traffic; the
    # public API still returns float32 (dequantized).  Serving and bench
    # enable it; default off to keep library numerics bit-identical.
    wire_int16: bool = False
    # dispatch each emission window's vocode + async PCM copy right after
    # the decode chunk is enqueued (before its status read), so the sample
    # transfer overlaps the status round trip; the provably-final chunk
    # speculates the whole final flush (streaming tail windows / the
    # pipelined path's flush window).  Exact - consumption requires an
    # argument-level plan match (see DeviceStreamingDecoder
    # .speculate_window/.speculate_final); off = always decode windows
    # inline after the status arrives.
    stream_window_ahead: bool = True
    # non-streaming synthesis pipelines chunked decode with windowed
    # vocoding and async PCM fetches (exact guard - no first-emission
    # approximation), overlapping the host-link transfers with device
    # compute.  None = off in the port (the reference turns it on for the
    # TPU backend only); env CHATTTS_PIPELINED_DECODE=0/1 overrides.
    pipelined_decode: Optional[bool] = None
    # decode chunk length (steps) for the pipelined non-streaming path
    pipeline_chunk: int = 96


@dataclass(frozen=True)
class PathConfig:
    """Asset file layout, identical to the reference download tree."""

    vocos_ckpt_path: str = "asset/Vocos.safetensors"
    dvae_ckpt_path: str = "asset/DVAE.safetensors"
    gpt_ckpt_path: str = "asset/gpt"
    decoder_ckpt_path: str = "asset/Decoder.safetensors"
    tokenizer_path: str = "asset/tokenizer"
    embed_path: str = "asset/Embed.safetensors"


@dataclass(frozen=True)
class Config:
    path: PathConfig = field(default_factory=PathConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    dvae: DVAEConfig = field(default_factory=DVAEConfig)
    gpt: GPTConfig = field(default_factory=GPTConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def with_runtime(self, **kw) -> "Config":
        return replace(self, runtime=replace(self.runtime, **kw))


def load_spk_stat_string() -> str:
    """Embedded speaker statistics (b14 string; reference config.py:132-134).

    Stored as a standalone data asset rather than inline source.
    """
    with open(os.path.join(_RES_DIR, "spk_stat.b14"), encoding="utf-8") as f:
        return f.read().strip()
