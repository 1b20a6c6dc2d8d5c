"""Inverse STFT (port of ``istft`` in ``chattts_tpu/ops/stft.py``).

``torch.istft`` semantics: periodic Hann window, overlap-add, division by
the squared-window sum clamped at 1e-11, and the centre padding trimmed.
The overlap-add is the JAX package's sum of ``n_fft // hop`` shifted
slices.  The reference's ISTFT is XLA, not a Pallas kernel, so ``torch.fft``
serves here.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (== torch.hann_window(n))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(
        np.float32)


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
