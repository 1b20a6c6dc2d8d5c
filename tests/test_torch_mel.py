"""The port's log-mel front end (``chattts_tpu_torch/ops/stft.py``) against
``chattts_tpu/ops/stft.py``, on the same seeded numpy waveforms.

``mel_filterbank`` is the same numpy code on both sides: equal to the last
bit.  ``stft_magnitude`` and ``log_mel_spectrogram`` go through two FFT
libraries (pocketfft under both on the CPU, but reached through other
plans) and sum the filterbank in another order: held to rtol 1e-5, with an
absolute floor of 1e-5 of the peak for the near-zero bins whose relative
error is all rounding.  The log-mel is clipped at log(1e-5) on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.config import MelConfig
from chattts_tpu.ops import stft as jstft
from chattts_tpu_torch import config as tconfig
from chattts_tpu_torch.ops import stft as tstft

RTOL = 1e-5


def _wave(B, N, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 24000.0
    tone = np.sin(2 * np.pi * rng.uniform(100, 3000, (B, 1)) * t)
    return (0.3 * tone + 0.05 * rng.standard_normal((B, N))).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("args", [(513, 100, 24000), (257, 40, 16000),
                                  (513, 80, 24000, 50.0, 8000.0)])
def test_mel_filterbank_equal(args):
    np.testing.assert_array_equal(tstft.mel_filterbank(*args),
                                  jstft.mel_filterbank(*args))


@pytest.mark.parametrize("B,N,n_fft,hop", [(1, 4096, 1024, 256),
                                           (2, 5000, 1024, 256),
                                           (3, 777, 256, 64)])
def test_stft_magnitude_matches_reference(B, N, n_fft, hop):
    x = _wave(B, N)
    want = np.asarray(jstft.stft_magnitude(jnp.asarray(x), n_fft, hop))
    got = tstft.stft_magnitude(torch.from_numpy(x), n_fft, hop)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (B, n_fft // 2 + 1, 1 + N // hop)
    _close(got.numpy(), want)


@pytest.mark.parametrize("N", [4096, 10240, 6000])
def test_log_mel_matches_reference(N):
    x = _wave(2, N, seed=N)
    want = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(x), MelConfig()))
    got = tstft.log_mel_spectrogram(torch.from_numpy(x), tconfig.MelConfig())
    assert tuple(got.shape) == want.shape == (2, 100, 1 + N // 256)
    _close(got.numpy(), want)


def test_log_mel_of_silence_is_the_clip():
    got = tstft.log_mel_spectrogram(torch.zeros((1, 2048)),
                                    tconfig.MelConfig())
    assert torch.equal(got, torch.full_like(got, float(np.log(np.float32(
        1e-5)))))
