"""``chattts_tpu_torch.models.gfsq`` against ``chattts_tpu.models.gfsq``.

Both sides take the same seeded projections (drawn by the JAX package,
bridged leaf by leaf) and the same numpy inputs, float32 on the CPU.
``embed`` sums codebook entries times exact scales and one small matrix
product: held to rtol 1e-6 (plus 1e-6 of the output's peak for entries that
cancel).  ``quantize`` must give the same indices; an index may only differ
where the reference's bounded value sits within 1e-4 of a rounding
boundary (half-integers), where the two libraries' tanh and product may
land on either side.  The pinned golden vectors of tests/test_gfsq.py hold
the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.config import GFSQConfig
from chattts_tpu.models import gfsq as jgfsq
from chattts_tpu_torch import config as tconfig
from chattts_tpu_torch.models import gfsq as tgfsq
from torch_port_utils import bridge, gfsq_boundary_distance

CFG = GFSQConfig()
TCFG = tconfig.GFSQConfig()
BOUNDARY = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jgfsq.init_params(jax.random.PRNGKey(3), CFG)
    return jp, bridge(jp)


def test_codebook_and_scales_equal():
    np.testing.assert_array_equal(tgfsq.codebook(TCFG).numpy(),
                                  np.asarray(jgfsq.codebook(CFG)))
    np.testing.assert_array_equal(tgfsq._scales(TCFG), jgfsq._scales(CFG))


@pytest.mark.parametrize("shape", [(2, 7), (1, 50)])
def test_embed_matches_reference(params, shape):
    jp, tp = params
    ind = np.random.default_rng(1).integers(0, 625, shape + (4,)).astype(
        np.int32)
    want = np.asarray(jgfsq.embed(jp, jnp.asarray(ind), CFG))
    got = tgfsq.embed(tp, torch.from_numpy(ind), TCFG)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_quantize_matches_reference(params, scale):
    jp, tp = params
    x = (np.random.default_rng(2).standard_normal((2, 64, 1024))
         * scale).astype(np.float32)
    want = np.asarray(jgfsq.quantize(jp, jnp.asarray(x), CFG))
    got = tgfsq.quantize(tp, torch.from_numpy(x), TCFG)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    flips = got.numpy() != want
    dist = gfsq_boundary_distance(jp, x, CFG)
    assert (dist[flips] <= BOUNDARY).all(), dist[flips]
    assert flips.mean() <= 1e-3


def test_fsq_quantize_recovers_codebook():
    cb = tgfsq.codebook(TCFG).numpy()
    half_l = (5 - 1) * (1 + 1e-3) / 2
    z = np.arctanh(np.clip(cb * 2 / half_l, -0.999999, 0.999999))
    codes, idx = tgfsq._fsq_quantize(torch.from_numpy(z.astype(np.float32)),
                                     TCFG)
    np.testing.assert_array_equal(idx.numpy(), np.arange(625))
    np.testing.assert_allclose(codes.numpy(), cb, atol=1e-6)


def test_residual_fsq_pinned_golden_vectors():
    """tests/test_gfsq.py's golden of the residual FSQ core."""
    z = torch.tensor([[-2.1357, 1.8956, -1.306, -0.3888],
                      [-0.113, -1.1113, -2.0517, 0.9733],
                      [0.5416, -2.9293, 3.5211, 1.4527]])
    scales = torch.from_numpy(tgfsq._scales(TCFG))
    residual, inds = z, []
    for r in range(TCFG.residuals):
        codes, idx = tgfsq._fsq_quantize(residual / scales[r], TCFG)
        residual = residual - codes * scales[r]
        inds.append(idx.numpy())
    np.testing.assert_array_equal(np.stack(inds, -1),
                                  [[145, 395], [502, 256], [603, 602]])


def test_grouped_quantize_embed_pinned_golden():
    """tests/test_gfsq.py's golden of quantize() and embed() with pinned
    projections, both groups sharing them."""
    cfg = tconfig.GFSQConfig(dim=16, levels=(5, 5, 5, 5), groups=2,
                             residuals=2)
    w_in = torch.tensor([[-0.38, 0.451, -0.233, -0.03],
                         [0.394, -0.628, 0.288, 0.699],
                         [0.661, -0.15, 0.451, -0.811],
                         [-0.079, 0.225, -0.672, -0.041],
                         [0.862, 1.309, 0.389, 0.414],
                         [-0.479, -0.605, -0.706, 0.271],
                         [0.376, -0.329, -0.614, 0.129],
                         [0.156, -0.065, 0.635, -0.046]])
    b_in = torch.tensor([-0.007, -0.111, 0.014, 0.135])
    w_out = torch.tensor(
        [[0.031, 0.035, 0.217, 0.139, 0.265, 0.268, 0.309, -0.398],
         [0.15, -0.801, 0.133, -0.631, -0.036, 0.237, -0.207, 0.049],
         [-0.82, -0.429, 0.344, -0.577, 0.325, -0.694, -0.454, -0.548],
         [0.004, 0.267, -0.533, -0.091, 0.811, -0.159, -0.408, 0.193]])
    b_out = torch.tensor([-0.022, -0.07, -0.18, 0.082, -0.057, 0.0, -0.106,
                          0.13])
    xg = torch.tensor([[0.7479, 0.9809, -0.1104, 0.4679,
                        0.8906, 1.023, 0.3124, -0.0619],
                       [-0.3595, -0.7486, -0.9655, 0.36,
                        -0.2446, -1.9959, -0.1552, 1.0638]])
    expect_idx = np.array([[538, 516], [247, 497]])
    expect_emb = np.array(
        [[0.628375, 0.4985, -1.00625, 0.37425,
          0.807875, 0.451875, -0.1855, 0.639125],
         [-0.861, -1.707625, 0.616125, -1.393875,
          0.000125, -0.511625, -0.77925, -0.566125]], np.float32)
    params = {"groups": [{"project_in": {"w": w_in, "b": b_in},
                          "project_out": {"w": w_out, "b": b_out}}] * 2}
    idx = tgfsq.quantize(params, torch.cat([xg, xg], -1)[None], cfg)[0]
    np.testing.assert_array_equal(idx[:, :2].numpy(), expect_idx)
    np.testing.assert_array_equal(idx[:, 2:].numpy(), expect_idx)
    emb = tgfsq.embed(params, idx[None], cfg)[0].numpy()
    np.testing.assert_allclose(emb[:, :8], expect_emb, atol=1e-5)
    np.testing.assert_allclose(emb[:, 8:], expect_emb, atol=1e-5)


def test_init_params_shapes_and_scales():
    p = tgfsq.init_params(torch.Generator().manual_seed(0), TCFG)
    assert len(p["groups"]) == 2
    g = p["groups"][0]
    assert tuple(g["project_in"]["w"].shape) == (512, 4)
    assert tuple(g["project_out"]["w"].shape) == (4, 512)
    assert not g["project_in"]["b"].any() and not g["project_out"]["b"].any()
    # normal / sqrt(fan-in), as the reference draws them
    assert 0.8 < float(g["project_in"]["w"].std() * 512 ** 0.5) < 1.2
