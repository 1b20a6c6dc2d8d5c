"""Spectral ops: the log-mel spectrogram and the inverse STFT (port of
``chattts_tpu/ops/stft.py``).

The log-mel feeds the DVAE encoder (voice clone): reflect-padded frames
gathered from an index grid, the periodic Hann window, ``torch.fft.rfft``,
a triangular HTK mel filterbank (numpy, as the reference builds it) and
``log(clip(mel, 1e-5))``.  The inverse STFT has ``torch.istft`` semantics:
overlap-add, division by the squared-window sum clamped at 1e-11, and the
centre padding trimmed; the overlap-add is the JAX package's sum of
``n_fft // hop`` shifted slices; ``istft_stream`` is the same overlap-add
on a carry, for the pipelined one-shot decode.  The reference's spectral
ops are XLA, not Pallas kernels, so ``torch.fft`` serves here (cuFFT on the
card).
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


def _real_edge_bins(spec: torch.Tensor, n_fft: int, dim: int
                    ) -> torch.Tensor:
    """``spec`` with the imaginary parts of its DC and Nyquist bins (along
    ``dim``) dropped.  A real signal's DC and Nyquist bins are real; FFT
    libraries disagree on what to do with their imaginary parts: pocketfft
    (the CPU, and the reference's XLA on the CPU) ignores them, cuFFT does
    not, and Vocos' head gives them random phases."""
    spec = spec.clone()
    for k in (0, n_fft // 2):
        edge = spec.select(dim, k)
        edge.copy_(edge.real)
    return spec


def istft_stream_init(batch: int, n_fft: int, hop: int, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(numerator carry (B, n_fft - hop), window-sum carry (n_fft - hop))."""
    return (torch.zeros((batch, n_fft - hop), dtype=torch.float32,
                        device=device),
            torch.zeros((n_fft - hop,), dtype=torch.float32, device=device))


def istft_stream(spec: torch.Tensor, carry, n_fft: int, hop: int):
    """Streaming overlap-add ISTFT: feed F frames, emit F * hop RAW samples.

    spec: complex (B, F, n_fft // 2 + 1), frames time-major.  The carry
    holds the partial overlap sums (numerator and squared-window sum) of
    the last n_fft - hop raw positions; a zero carry gives the full istft's
    left edge exactly.  The samples are the full istft's RAW timeline
    (before the centre trim): the caller drops the first n_fft // 2 once.
    The stream never finalizes; the utterance's tail comes from the
    caller's full-window flush.  DC and Nyquist are made real as in
    :func:`istft`.  Returns (samples (B, F * hop) f32, the new carry)."""
    if n_fft % hop != 0:
        raise ValueError("istft requires hop | n_fft")
    ratio = n_fft // hop
    B, F, _ = spec.shape
    win = torch.from_numpy(hann_window(n_fft)).to(spec.device)
    frames = torch.fft.irfft(_real_edge_bins(spec, n_fft, 2), n=n_fft,
                             dim=-1) * win                   # (B, F, n_fft)
    wsq = (win * win).reshape(ratio, hop)
    pieces = frames.reshape(B, F, ratio, hop)
    out = torch.zeros((B, F + ratio - 1, hop), dtype=frames.dtype,
                      device=spec.device)
    den = torch.zeros((F + ratio - 1, hop), dtype=frames.dtype,
                      device=spec.device)
    for j in range(ratio):
        out[:, j:j + F] += pieces[:, :, j]
        den[j:j + F] += wsq[j]
    num_c, den_c = carry
    out[:, :ratio - 1] += num_c.reshape(B, ratio - 1, hop)
    den[:ratio - 1] += den_c.reshape(ratio - 1, hop)
    emit = (out[:, :F].reshape(B, F * hop)
            / torch.clamp(den[:F].reshape(F * hop), min=1e-11)[None, :])
    new_carry = (out[:, F:].reshape(B, n_fft - hop),
                 den[F:].reshape(n_fft - hop))
    return emit.to(torch.float32), new_carry


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex spec (B, F, T) -> audio (B, (T - 1) * hop) f32."""
    if n_fft % hop != 0:
        raise ValueError("istft requires hop | n_fft")
    ratio = n_fft // hop
    B, _, T = spec.shape
    spec = _real_edge_bins(spec, n_fft, 1)
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
