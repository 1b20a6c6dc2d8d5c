"""``kv4_append_kernel`` (one warp per row, head pair and k or v) against
its plain version, through the one-append entry ``decode_step.kv4_append``.

The kernel keeps ``ops/kv_quant.py``'s kv4 arithmetic step for step, so its
appended rows must equal the plain version's bytes.  The plain version runs
on the CPU copy of the same inputs (the same cos and sin, made once): there
every torch operation rounds as IEEE float32 does, whereas on the card
torch divides by a Python scalar through its reciprocal, which the kernel
must not do.  Checked at the full model's heads (12 of 64), at 8 heads of
64 and at 2 heads of 128, on 1, 8, 16, 33, 64 and 96 rows, with rows that are
not live (a position past the cache, a window with no key, a negative
position): those rows, and every row but the appended ones, stay as they
were; the appended rows' pad is zero although the cache held random bytes
there.  Planted faults in the plain arithmetic (the two nibbles swapped, a
reciprocal multiply in place of the division, on inputs placed on rounding
ties) must give other bytes than the kernel.

Needs a CUDA device and the toolkit (skips without a device); imports no
JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kv4_append_gpu.py
"""

import pytest
import torch

from chattts_tpu_torch.config import GPTConfig
from chattts_tpu_torch.ops import decode_step as k1
from chattts_tpu_torch.ops import kv_quant

GEOMETRIES = {
    "full": GPTConfig(),
    "pairs": GPTConfig(hidden_size=512, intermediate_size=1536,
                       num_attention_heads=8, num_hidden_layers=2,
                       max_position_embeddings=256),
    "kv4": GPTConfig(hidden_size=256, intermediate_size=512,
                     num_attention_heads=2, num_hidden_layers=2,
                     max_position_embeddings=256),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(cfg, B, T, seed, dev, ties=False):
    """Inputs of one append, made on the CPU from ``seed``: qkv, cos, sin
    (computed on the card, as the step computes them), caches of random
    bytes, positions with rows 1, 2 and 3 not live where B allows.  With
    ``ties`` every v head has absmax 7 div for a scale div = m 2^e the
    format holds exactly, and its other values sit on rounding ties
    (n + 1/2) div."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, 3 * HD), generator=g) * 1.5
    if ties:
        m = torch.randint(64, 128, (B, H, 1), generator=g).float()
        div = m * torch.pow(2.0, torch.randint(-12, -4, (B, H, 1),
                                               generator=g).float())
        n = torch.randint(-7, 7, (B, H, Dh), generator=g).float()
        v = (n + 0.5) * div
        v[..., 0] = 7 * div[..., 0]
        qkv[:, 2 * HD:] = v.reshape(B, HD)
    W = kv_quant.row_width(4, cfg)
    kc = torch.randint(-128, 128, (B, T, W), generator=g, dtype=torch.int8)
    vc = torch.randint(-128, 128, (B, T, W), generator=g, dtype=torch.int8)
    cur = torch.randint(0, T, (B,), generator=g)
    lo = torch.randint(0, T, (B,), generator=g) % (cur + 1)
    for row, (c, low) in {1: (T, 0), 2: (5, 6), 3: (-1, 0)}.items():
        if row < B:
            cur[row], lo[row] = c, low
    cos, sin = k1.rope_rows(cfg, (cur - lo).clamp(min=0).to(dev))
    return qkv, cos.cpu(), sin.cpu(), kc, vc, cur, lo


def _kernel(case, cfg, dev):
    qkv, cos, sin, kc, vc, cur, lo = (t.to(dev) for t in case)
    before = k1.decode_step.kv4_append_launches
    k1.kv4_append(qkv, cos, sin, kc, vc, cur, lo, cfg)
    torch.cuda.synchronize()
    assert k1.decode_step.kv4_append_launches == before + 1
    return kc.cpu(), vc.cpu()


def _plain(case, cfg, fault=None):
    """The plain append on the CPU, or with a planted fault in its
    quantizer: "nibbles_swapped" or "reciprocal" (x * (1 / div))."""
    qkv, cos, sin, kc, vc, cur, lo = (t.clone() for t in case)
    if fault is None:
        k1.kv4_append_plain(qkv, cos, sin, kc, vc, cur, lo, cfg)
        return kc, vc
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh

    def quantize(x):
        xh = x.reshape(x.shape[0], H, Dh)
        mant, es, sdec = kv_quant.head_scales(xh.abs().amax(-1), 7.0)
        div = sdec[..., None]
        q = torch.round(xh * (1.0 / div) if fault == "reciprocal"
                        else xh / div).clamp(-7, 7).to(torch.int32)
        q = q.reshape(x.shape[0], HD)
        lo_n, hi_n = q[:, :HD // 2] & 15, q[:, HD // 2:] & 15
        u = (hi_n | (lo_n << 4) if fault == "nibbles_swapped"
             else lo_n | (hi_n << 4))
        lanes = torch.zeros((x.shape[0], kv_quant.KV_PAD), dtype=torch.int8)
        lanes[:, :H] = mant.to(torch.int8)
        lanes[:, H:2 * H] = es.to(torch.int8)
        return torch.cat([((u << 24) >> 24).to(torch.int8), lanes], -1)

    live = k1._append_rows(cur, lo, kc.shape[1])
    rows = torch.arange(qkv.shape[0])[live]
    k = k1._rope(qkv[:, HD:2 * HD], cos, sin, H)
    kc[rows, cur[live]] = quantize(k[live])
    vc[rows, cur[live]] = quantize(qkv[live, 2 * HD:])
    return kc, vc


@pytest.mark.gpu
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("B", [1, 8, 16, 33, 64, 96])
def test_appended_rows_equal_the_plain_bytes(cuda, geom, B):
    cfg = GEOMETRIES[geom]
    case = _case(cfg, B, 80, B, cuda)
    kk, vk = _kernel(case, cfg, cuda)
    kp, vp = _plain(case, cfg)
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    # rows not live are untouched, and so is every row but the appended
    _, _, _, kc, vc, cur, lo = case
    live = k1._append_rows(cur, lo, kc.shape[1])
    keep = torch.ones(kc.shape[:2], dtype=torch.bool)
    keep[torch.arange(B)[live], cur[live]] = False
    assert torch.equal(kk[keep], kc[keep]) and torch.equal(vk[keep], vc[keep])
    if B > 3:
        assert not live[1:4].any()
        assert live.sum() >= B - 3
    # the appended rows' pad, random before, is zero
    pad = kv_quant.row_width(4, cfg) - kv_quant.KV_PAD
    start = pad + 2 * cfg.num_attention_heads
    rows = torch.arange(B)[live]
    for got in (kk, vk):
        assert not got[rows, cur[live], start:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("fault", ["nibbles_swapped", "reciprocal"])
def test_byte_check_rejects_a_planted_fault(cuda, geom, fault):
    """On v rows placed on rounding ties, the kernel gives the plain
    version's bytes and not those of a copy with the fault."""
    cfg = GEOMETRIES[geom]
    case = _case(cfg, 16, 40, 7, cuda, ties=True)
    kk, vk = _kernel(case, cfg, cuda)
    kp, vp = _plain(case, cfg)
    kf, vf = _plain(case, cfg, fault)
    assert not torch.equal(vf, vp)  # the fault shows on these inputs
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    assert not torch.equal(vk, vf)


@pytest.mark.gpu
def test_kv4_append_rejects_what_the_kernel_does_not_take(cuda):
    import dataclasses

    cfg = dataclasses.replace(GEOMETRIES["pairs"], hidden_size=256,
                              num_attention_heads=8)  # Dh 32
    case = _case(cfg, 2, 16, 0, cuda)
    with pytest.raises(ValueError, match="head dim of 64 or 128"):
        _kernel(case, cfg, cuda)
    cfg = GEOMETRIES["pairs"]
    qkv, cos, sin, kc, vc, cur, lo = (t.to(cuda) for t in _case(cfg, 2, 16,
                                                                  0, cuda))
    with pytest.raises(ValueError, match="takes qkv"):
        k1.kv4_append(qkv[:, 1:], cos, sin, kc, vc, cur, lo, cfg)
    with pytest.raises(ValueError, match="one device"):
        k1.kv4_append(qkv, cos.cpu(), sin, kc, vc, cur, lo, cfg)
