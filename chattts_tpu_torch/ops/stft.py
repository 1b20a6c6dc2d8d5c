"""Spectral ops: the log-mel spectrogram and the inverse STFT (port of
``chattts_tpu/ops/stft.py``).

The log-mel feeds the DVAE encoder (voice clone): reflect-padded frames
gathered from an index grid, the periodic Hann window, ``torch.fft.rfft``,
a triangular HTK mel filterbank (numpy, as the reference builds it) and
``log(clip(mel, 1e-5))``.  The inverse STFT has ``torch.istft`` semantics:
overlap-add, division by the squared-window sum clamped at 1e-11, and the
centre padding trimmed; the overlap-add is the JAX package's sum of
``n_fft // hop`` shifted slices.  The reference's spectral ops are XLA, not
Pallas kernels, so ``torch.fft`` serves here (cuFFT on the card).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import MelConfig


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (== torch.hann_window(n))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(
        np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=4)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None
                   ) -> np.ndarray:
    """HTK-scale triangular mel filterbank (n_freqs, n_mels), norm None
    (``torchaudio.functional.melscale_fbanks``' defaults)."""
    f_max = float(f_max if f_max is not None else sample_rate / 2)
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop: int
                   ) -> torch.Tensor:
    """|STFT| with centre (reflect) padding: audio (B, N) -> (B, F, T)."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(audio[:, None, :], (pad, pad),
                                mode="reflect")[:, 0]
    num_frames = 1 + audio.shape[-1] // hop
    idx = torch.from_numpy(np.arange(num_frames)[:, None] * hop
                           + np.arange(n_fft)[None, :]).to(audio.device)
    win = torch.from_numpy(hann_window(n_fft)).to(audio.device)
    spec = torch.fft.rfft(x[:, idx] * win, dim=-1)       # (B, T, F)
    return spec.abs().transpose(1, 2).to(torch.float32)


def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveform (B, N) -> log-mel features (B, n_mels, T): power-1
    magnitude mel, ``log(clip(mel, 1e-5))``."""
    mag = stft_magnitude(audio, cfg.n_fft, cfg.hop_length)
    fb = torch.from_numpy(mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels,
                                         cfg.sample_rate)).to(audio.device)
    mel = torch.einsum("bft,fm->bmt", mag, fb)
    return torch.log(torch.clamp(mel, min=1e-5))


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex spec (B, F, T) -> audio (B, (T - 1) * hop) f32."""
    if n_fft % hop != 0:
        raise ValueError("istft requires hop | n_fft")
    ratio = n_fft // hop
    B, _, T = spec.shape
    # a real signal's DC and Nyquist bins are real.  Their imaginary parts
    # are dropped here because FFT libraries disagree on them: pocketfft
    # (the CPU, and the reference's XLA on the CPU) ignores them, cuFFT
    # does not, and Vocos' head gives them random phases
    spec = spec.clone()
    spec[:, 0] = spec[:, 0].real
    spec[:, n_fft // 2] = spec[:, n_fft // 2].real
    win = torch.from_numpy(hann_window(n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * win
    pieces = frames.reshape(B, T, ratio, hop)
    win_pieces = (win * win).reshape(ratio, hop)
    total = (T - 1) * hop + n_fft
    out = torch.zeros((B, total // hop, hop), dtype=frames.dtype,
                      device=spec.device)
    wsum = torch.zeros((total // hop, hop), dtype=frames.dtype,
                       device=spec.device)
    for j in range(ratio):
        out[:, j:j + T] += pieces[:, :, j]
        wsum[j:j + T] += win_pieces[j]
    out = out.reshape(B, total)
    wsum = wsum.reshape(total)
    start, length = n_fft // 2, (T - 1) * hop
    out = out[:, start:start + length]
    wsum = wsum[start:start + length]
    return (out / torch.clamp(wsum, min=1e-11)).to(torch.float32)
