"""K1's CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit; without a device they
skip.  They import neither JAX nor the JAX package, so on a machine that has
only PyTorch they run without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Both sides take the same bf16 inputs and round alike (f32 residual, bf16
matmul inputs, f32 sums), but the kernel sums in another order, so an
intermediate can land one bf16 ulp apart and carry through the layers: the
final-norm hidden (O(1)) is held to atol 0.05, the appended cache row to
two bf16 ulps (atol and rtol 0.02), and every other cache row must be
bit-unchanged.
"""

import pytest
import torch

from chattts_tpu_torch.config import GPTConfig
from chattts_tpu_torch.models import llama
from chattts_tpu_torch.ops import decode_step as k1
from chattts_tpu_torch.weights import to_device

HIDDEN_ATOL = 0.05
ROW_TOL = 0.02

GEOMETRIES = {
    # the geometry of tests/test_pallas_step.py
    "small": GPTConfig(hidden_size=128, intermediate_size=256,
                       num_attention_heads=2, num_hidden_layers=3,
                       max_position_embeddings=256),
    # widths that are not multiples of 128, Dh 32
    "ragged": GPTConfig(hidden_size=96, intermediate_size=200,
                        num_attention_heads=3, num_hidden_layers=2,
                        max_position_embeddings=256),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg, B, T, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = to_device(llama.init_params(gen, cfg), dev)
    L = cfg.num_hidden_layers
    HD = cfg.num_attention_heads * cfg.head_dim
    kc = torch.randn((L, B, T, HD), generator=gen).bfloat16().to(dev)
    vc = torch.randn((L, B, T, HD), generator=gen).bfloat16().to(dev)
    emb = (torch.randn((B, cfg.hidden_size), generator=gen) * 0.3).to(dev)
    return params, k1.pack_weights(params, cfg), kc, vc, emb


@pytest.mark.gpu
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("B,cur", [(1, 0), (3, 17), (8, 63), (16, 40)])
def test_kernel_matches_plain(cuda, geom, B, cur):
    cfg = GEOMETRIES[geom]
    T = 64
    params, packed, kc, vc, emb = _inputs(cfg, B, T, cuda)
    lo = torch.tensor([(7 * b) % (cur + 1) for b in range(B)], device=cuda)
    pos = cur - lo
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = k1.decode_step.launches
    xk = k1.decode_step(packed, emb, kk, vk, cur, lo, pos, cfg)
    torch.cuda.synchronize()
    assert k1.decode_step.launches == before + 1
    xp = k1.decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
    hk = llama.rms_norm(xk, params["norm"], cfg.rms_norm_eps)
    hp = llama.rms_norm(xp, params["norm"], cfg.rms_norm_eps)
    assert torch.isfinite(hk).all()
    torch.testing.assert_close(hk, hp, atol=HIDDEN_ATOL, rtol=0)
    for got, ref, base in ((kk, kp, kc), (vk, vp, vc)):
        torch.testing.assert_close(got[:, :, cur].float(),
                                   ref[:, :, cur].float(), atol=ROW_TOL,
                                   rtol=ROW_TOL)
        assert torch.equal(got[:, :, :cur], base[:, :, :cur])
        assert torch.equal(got[:, :, cur + 1:], base[:, :, cur + 1:])


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    cfg = GEOMETRIES["small"]
    _, packed, kc, vc, emb = _inputs(cfg, 2, 16, cuda)
    lo = torch.zeros(2, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="cur"):
        k1.decode_step(packed, emb, kc, vc, 16, lo, lo, cfg)
    with pytest.raises(ValueError, match="caches"):
        k1.decode_step(packed, emb, kc.float(), vc, 3, lo, lo, cfg)
    with pytest.raises(ValueError, match="packed"):
        k1.decode_step({**packed, "wo": packed["wo"].float()}, emb, kc, vc,
                       3, lo, lo, cfg)


@pytest.mark.gpu
def test_istft_on_card_matches_cpu(cuda):
    """cuFFT against pocketfft, with imaginary DC and Nyquist parts in the
    input (Vocos' head makes them): float32 sums, atol 1e-5 on O(1)
    samples."""
    from chattts_tpu_torch.ops.stft import istft

    gen = torch.Generator().manual_seed(3)
    spec = torch.complex(torch.randn((2, 513, 20), generator=gen),
                         torch.randn((2, 513, 20), generator=gen))
    got = istft(spec.to(cuda), 1024, 256).cpu()
    torch.testing.assert_close(got, istft(spec, 1024, 256), atol=1e-5,
                               rtol=0)
