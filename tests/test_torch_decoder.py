"""The hidden -> mel -> waveform path of the port against chattts_tpu (CPU).

Everything here is float32 on both sides (convolutions, LayerNorm, GELU,
matmuls, FFT); only the order of the sums differs between XLA and torch.
Activations are O(1), so each stage is held to atol 1e-4 with rtol 1e-4.
The waveform passes exp() (magnitudes up to 1e2) and an inverse FFT, so it
is held to 1e-3 of its peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.models import convnext as jc
from chattts_tpu.models import dvae as jd
from chattts_tpu.models import vocos as jv
from chattts_tpu.ops import stft as jstft
from chattts_tpu_torch.models import convnext as tc
from chattts_tpu_torch.models import dvae as td
from chattts_tpu_torch.models import vocos as tv
from chattts_tpu_torch.ops import stft as tstft
from torch_port_utils import bridge, port_config, to_np

ATOL = RTOL = 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("stride,dilation,padding,groups",
                         [(1, 1, 1, 1), (2, 1, 1, 1), (1, 2, 2, 8),
                          (1, 1, 3, 16)])
def test_conv1d_matches(stride, dilation, padding, groups):
    x = _x((2, 13, 16), 0)
    w = _x((3, 16 // groups, 8 if groups == 1 else 16), 1)
    b = _x((w.shape[-1],), 2)
    ref = jc.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    stride=stride, dilation=dilation, padding=padding,
                    groups=groups)
    got = tc.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride=stride, dilation=dilation,
                    padding=padding, groups=groups)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_layer_norm_and_gelu_match():
    x = _x((3, 5, 32), 3) * 4
    s, b = _x((32,), 4), _x((32,), 5)
    np.testing.assert_allclose(
        to_np(tc.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                            torch.from_numpy(b))),
        np.asarray(jc.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(b))), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(to_np(tc.gelu(torch.from_numpy(x))),
                               np.asarray(jc.gelu(jnp.asarray(x))),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_convnext_block_matches(dilation):
    jp = jc.init_block(jax.random.PRNGKey(0), 32, 64, 7, layer_scale=0.5)
    x = _x((2, 11, 32), 6)
    ref = jc.apply_block(jp, jnp.asarray(x), kernel=7, dilation=dilation)
    got = tc.apply_block(bridge(jp), torch.from_numpy(x), kernel=7,
                         dilation=dilation)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_convnext_stack_matches(tiny_config):
    cfg = tiny_config.decoder.stack
    jp = jc.init_stack(jax.random.PRNGKey(1), cfg)
    x = _x((2, 10, cfg.idim), 7)
    ref = jc.apply_stack(jp, jnp.asarray(x), cfg)
    got = tc.apply_stack(bridge(jp), torch.from_numpy(x), port_config(cfg))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_interleave_groups_matches():
    x = _x((2, 5, 8), 8)
    np.testing.assert_array_equal(
        to_np(td.interleave_groups(torch.from_numpy(x))),
        np.asarray(jd.interleave_groups(jnp.asarray(x))))


def test_decode_from_hidden_matches(tiny_config):
    cfg = tiny_config.decoder
    jp = jd.init_decoder_params(jax.random.PRNGKey(2), cfg)
    hid = _x((2, 9, tiny_config.gpt.hidden_size), 9)
    ref = jd.decode_from_hidden(jp, jnp.asarray(hid), cfg)
    got = td.decode_from_hidden(bridge(jp), torch.from_numpy(hid),
                                port_config(cfg))
    assert got.shape == (2, 18, cfg.n_mels)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    assert td.coef_string(bridge(jp)) == jd.coef_string(jp)


def test_vocos_decode_matches(tiny_config):
    cfg = tiny_config.vocos
    jp = jv.init_params(jax.random.PRNGKey(3), cfg)
    mel = _x((2, 12, cfg.input_channels), 10)
    ref = np.asarray(jv.decode(jp, jnp.asarray(mel), cfg))
    got = to_np(tv.decode(bridge(jp), torch.from_numpy(mel),
                          port_config(cfg)))
    assert got.shape == ref.shape == (2, 11 * cfg.hop_length)
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("n_fft,hop,T", [(64, 16, 9), (1024, 256, 6)])
def test_istft_matches_reference_and_torch(n_fft, hop, T):
    rng = np.random.default_rng(11)
    F = n_fft // 2 + 1
    spec = (rng.standard_normal((2, F, T))
            + 1j * rng.standard_normal((2, F, T))).astype(np.complex64)
    # DC and Nyquist bins keep imaginary parts, as Vocos' head gives them:
    # every side ignores them (the port explicitly, so cuFFT agrees too)
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop))
    got = to_np(tstft.istft(torch.from_numpy(spec), n_fft, hop))
    lib = to_np(torch.istft(torch.from_numpy(spec), n_fft, hop,
                            window=torch.hann_window(n_fft), center=True))
    assert got.shape == ref.shape == lib.shape == (2, (T - 1) * hop)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, lib, atol=1e-5)
    hermitian = spec.copy()
    hermitian[:, 0] = hermitian[:, 0].real
    hermitian[:, -1] = hermitian[:, -1].real
    np.testing.assert_array_equal(
        to_np(tstft.istft(torch.from_numpy(hermitian), n_fft, hop)), got)


def test_istft_rejects_hop_not_dividing_n_fft():
    with pytest.raises(ValueError):
        tstft.istft(torch.zeros((1, 33, 4), dtype=torch.complex64), 64, 24)
