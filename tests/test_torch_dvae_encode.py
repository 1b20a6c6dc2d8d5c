"""The port's DVAE encoder and code decoder (``chattts_tpu_torch/models/
dvae.py``: ``encode_audio``, ``decode_from_indices``) against
``chattts_tpu.models.dvae`` at the tiny config, with the JAX package's
seeded DVAE bridged leaf by leaf, on the CPU in float32.

``encode_audio`` ends in a rounding (the GFSQ), so codes are compared as
integers: on the same wav at least 99% must be equal, and every code that
differs must be one whose reference bounded value lies within 1e-4 of a
rounding boundary (two libraries' convolutions, matmuls and tanh summed in
other orders).  ``decode_from_indices`` is float32 through a ConvNeXt
stack: its mel is held to 1e-5 of its peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.models import convnext as jconvnext
from chattts_tpu.models import dvae as jdvae
from chattts_tpu.ops.stft import log_mel_spectrogram as jlog_mel
from chattts_tpu_torch.models import dvae as tdvae
from torch_port_utils import bridge, gfsq_boundary_distance, port_config

BOUNDARY = 1e-4
MIN_EQUAL = 0.99
MEL_ATOL_OF_PEAK = 1e-5


@pytest.fixture(scope="module")
def dvae(tiny_config):
    jp = jdvae.init_dvae_params(jax.random.PRNGKey(1), tiny_config.dvae)
    return tiny_config, port_config(tiny_config), jp, bridge(jp)


def _wav(N, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 24000.0
    f = rng.uniform(80, 400)
    x = 0.4 * np.sin(2 * np.pi * f * t) * np.sin(2 * np.pi * 3 * t)
    return (x + 0.02 * rng.standard_normal(N)).astype(np.float32)[None]


def _encoder_features(jp, wav, cfg):
    """The reference's encode_audio up to the GFSQ input."""
    mel = jlog_mel(jnp.asarray(wav), cfg.vocos.mel)
    x = mel.transpose(0, 2, 1) / jp["coef"][None, None, :]
    ds = jp["downsample"]
    x = jconvnext.gelu(jconvnext.conv1d(x, ds["conv0"]["w"], ds["conv0"]["b"],
                                        padding=1))
    x = jconvnext.gelu(jconvnext.conv1d(x, ds["conv1"]["w"], ds["conv1"]["b"],
                                        stride=2, padding=1))
    return np.asarray(jconvnext.apply_stack(jp["encoder"], x,
                                            cfg.dvae.encoder))


@pytest.mark.parametrize("N,seed", [(4096, 0), (16384, 1), (9000, 2)])
def test_encode_audio_codes_match_reference(dvae, N, seed):
    jcfg, tcfg, jp, tp = dvae
    wav = _wav(N, seed)
    want = np.asarray(jdvae.encode_audio(jp, jnp.asarray(wav), jcfg.dvae,
                                         jcfg.vocos.mel))
    got = tdvae.encode_audio(tp, torch.from_numpy(wav), tcfg.dvae,
                             tcfg.vocos.mel)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (1, (1 + N // 256) // 2, 4)
    differ = got.numpy() != want
    assert 1 - differ.mean() >= MIN_EQUAL
    dist = gfsq_boundary_distance(jp["vq"], _encoder_features(jp, wav, jcfg),
                                  jcfg.dvae.vq)
    assert (dist[differ] <= BOUNDARY).all(), dist[differ]


def test_encode_audio_batch_rows_are_independent(dvae):
    _, tcfg, _, tp = dvae
    wav = np.concatenate([_wav(8192, 3), _wav(8192, 4)])
    both = tdvae.encode_audio(tp, torch.from_numpy(wav), tcfg.dvae,
                              tcfg.vocos.mel)
    one = tdvae.encode_audio(tp, torch.from_numpy(wav[1:]), tcfg.dvae,
                             tcfg.vocos.mel)
    assert torch.equal(both[1:], one)


@pytest.mark.parametrize("T", [8, 21])
def test_decode_from_indices_matches_reference(dvae, T):
    jcfg, tcfg, jp, tp = dvae
    ind = np.random.default_rng(T).integers(0, 625, (2, T, 4)).astype(
        np.int32)
    want = np.asarray(jdvae.decode_from_indices(jp, jnp.asarray(ind),
                                                jcfg.dvae))
    got = tdvae.decode_from_indices(tp, torch.from_numpy(ind), tcfg.dvae)
    assert tuple(got.shape) == want.shape == (2, 2 * T, 100)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MEL_ATOL_OF_PEAK * np.abs(want).max())


def test_decode_from_hidden_shares_the_decode_stack(dvae, tiny_config):
    """decode_from_hidden on the hidden decoder's tree and
    decode_from_indices on the DVAE's run one tail: with the GFSQ's
    features fed as hiddens, the two agree exactly."""
    _, tcfg, _, tp = dvae
    from chattts_tpu_torch.config import DecoderConfig
    from chattts_tpu_torch.models import gfsq

    ind = torch.from_numpy(np.random.default_rng(5).integers(
        0, 625, (1, 6, 4)).astype(np.int32))
    feats = gfsq.embed(tp["vq"], ind, tcfg.dvae.vq)
    via_hidden = tdvae.decode_from_hidden(
        tp, feats, DecoderConfig(stack=tcfg.dvae.decoder))
    assert torch.equal(via_hidden, tdvae.decode_from_indices(tp, ind,
                                                             tcfg.dvae))


def test_init_dvae_params_tree_matches_reference(dvae):
    """The port draws the tree the reference draws: same leaves, shapes and
    dtypes, zero biases, and the coef it is given."""
    jcfg, tcfg, jp, _ = dvae
    coef = np.linspace(0.1, 1.0, 100).astype(np.float32)
    tp = tdvae.init_dvae_params(torch.Generator().manual_seed(0), tcfg.dvae,
                                coef)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tp))[0]
    assert ([(p, v.shape) for p, v in jleaves]
            == [(p, v.shape) for p, v in tleaves])
    assert all(v.dtype == np.float32 for _, v in tleaves)
    np.testing.assert_array_equal(tp["coef"].numpy(), coef)
    assert not tp["downsample"]["conv1"]["b"].any()
