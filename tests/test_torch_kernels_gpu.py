"""The decode step's CUDA kernel (K1-K6 and their combinations) against its
plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit; without a device they
skip.  They import neither JAX nor the JAX package, so on a machine that has
only PyTorch they run without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Both sides take the same bf16 inputs and round alike (f32 residual, bf16
matmul inputs, f32 sums), but the kernel sums in another order, so an
intermediate can land one bf16 ulp apart and carry through the layers: the
final-norm hidden (O(1)) is held to atol 0.05, the appended cache row to
two bf16 ulps (atol and rtol 0.02), and every other cache row must be
bit-unchanged.  An appended kv8 row is compared as bytes: layer 0's scale
bytes equal; at most 1% of layer 0's value bytes and 10% of all layers' may
differ (deeper layers quantize a residual that drifted within the hidden's
tolerance), every dequantized value within one quantization step, two where
the drift moved the head's scale.  An appended kv4 row is held the same way
on its unpacked values.  With quantized weights both sides multiply the
same integers by the same scales; the kernel adds each warp's share of a
group's sum (its tensor-core products of the group's steps in its slice of
K) times the scale where the plain version adds each group's sum times the
scale, f32 both, so the hidden's tolerance stays 0.05.  The step takes
any batch width the reference takes: every tier is held to the plain
version at 65, 96, 128 and 256 rows, and a row's result must not depend
on the batch it ran in, bit for bit: rows of a 128-row launch equal the
same rows launched at 64 rows and at 1.
"""

import pytest
import torch

from chattts_tpu_torch.config import GPTConfig
from chattts_tpu_torch.models import llama
from chattts_tpu_torch.ops import decode_step as k1
from chattts_tpu_torch.ops import kv_quant
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
# geometries that take quantized weights and kv4 rows (HD % 256 == 0)
QUANT_GEOMETRIES = {
    # tests/test_pallas_step.py's CFG4: two heads of 128, one to a nibble
    "kv4": GPTConfig(hidden_size=256, intermediate_size=512,
                     num_attention_heads=2, num_hidden_layers=2,
                     max_position_embeddings=256),
    # eight heads of 64: four head pairs share the bytes of a kv4 row, and
    # the MLP's contraction has three int8 groups
    "pairs": GPTConfig(hidden_size=512, intermediate_size=1536,
                       num_attention_heads=8, num_hidden_layers=2,
                       max_position_embeddings=256),
}
# (weight bits, cache bits, a position per row, the variant's name)
TIERS = [(8, 0, False, "k1k4"), (8, 8, True, "k2k3k4"), (4, 0, True, "k2k5"),
         (4, 8, False, "k3k5"), (0, 4, False, "k6"), (0, 4, True, "k2k6"),
         (4, 4, False, "k6k5"), (8, 4, True, "k2k6k4")]
# and the bf16-weight variants of the bf16 and kv8 caches
TIERS_ALL = TIERS + [(0, 0, False, "k1"), (0, 0, True, "k2"),
                     (0, 8, False, "k3"), (0, 8, True, "k2k3")]


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


def _variant_inputs(cfg, B, T, dev, variant, seed=0, shared_cur=11):
    """Inputs of one variant: kv8 caches for k3, ragged positions for k2
    (row 0 sees one key, row 1 writes the last cache row); a shared
    position is ``shared_cur`` with lo_b below 12."""
    params, packed, kc, vc, emb = _inputs(cfg, B, T, dev, seed)
    if "k3" in variant:
        kc = kv_quant.kv8_quantize(kc, cfg)
        vc = kv_quant.kv8_quantize(vc, cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    if "k2" in variant:
        cur = torch.randint(1, T, (B,), generator=gen)
        cur[0] = 7
        cur[min(1, B - 1)] = T - 1
        lo = torch.randint(0, T, (B,), generator=gen) % (cur + 1)
        lo[0] = cur[0]
        cur_arg = cur.to(dev)
    else:
        cur = torch.full((B,), shared_cur)
        lo = torch.randint(0, 12, (B,), generator=gen)
        cur_arg = shared_cur
    return params, packed, kc, vc, emb, cur_arg, cur.to(dev), lo.to(dev)


def _check_rows(got, ref, base, cur, cfg):
    """Row (b, cur_b) of every layer against the plain version's, all other
    rows against the input."""
    H = cfg.num_attention_heads
    HD = H * cfg.head_dim
    B = got.shape[1]
    rows = torch.arange(B, device=got.device)
    keep = torch.ones(got.shape[:3], dtype=torch.bool, device=got.device)
    keep[:, rows, cur] = False
    assert torch.equal(got[keep], base[keep])
    g, r = got[:, rows, cur], ref[:, rows, cur]      # (L, B, W)
    if got.dtype != torch.int8:
        torch.testing.assert_close(g.float(), r.float(), atol=ROW_TOL,
                                   rtol=ROW_TOL)
        return
    assert torch.equal(g[0, :, HD:], r[0, :, HD:])
    assert not g[..., HD + 2 * H:].any()
    sg, sr = kv_quant.row_scales(g, cfg), kv_quant.row_scales(r, cfg)
    assert bool(((sg - sr).abs() <= sr / 64 * (1 + 1e-6)).all())
    step = torch.where(sg == sr, sr, 2 * torch.maximum(sg, sr))
    err = (kv_quant.kv8_dequantize(g, cfg)
           - kv_quant.kv8_dequantize(r, cfg)).abs()
    err = err.reshape(err.shape[:-1] + (H, -1))
    assert bool((err <= step[..., None] * (1 + 1e-6)).all())
    differ = g[..., :HD] != r[..., :HD]
    assert int(differ[0].sum()) <= 0.01 * differ[0].numel()
    assert int(differ.sum()) <= 0.10 * differ.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("variant", ["k2", "k3", "k2k3"])
@pytest.mark.parametrize("B", [1, 3, 16, 32])
def test_variant_matches_plain(cuda, geom, variant, B):
    cfg = GEOMETRIES[geom]
    T = 64
    params, packed, kc, vc, emb, cur_arg, cur, lo = _variant_inputs(
        cfg, B, T, cuda, variant)
    pos = cur - lo
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = dict(k1.decode_step.variant_launches)
    xk = k1.decode_step(packed, emb, kk, vk, cur_arg, lo, pos, cfg)
    torch.cuda.synchronize()
    after = k1.decode_step.variant_launches
    assert after[variant] == before[variant] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    xp = k1.decode_step_plain(packed, emb, kp, vp, cur_arg, lo, pos, cfg)
    hk = llama.rms_norm(xk, params["norm"], cfg.rms_norm_eps)
    hp = llama.rms_norm(xp, params["norm"], cfg.rms_norm_eps)
    assert torch.isfinite(hk).all()
    torch.testing.assert_close(hk, hp, atol=HIDDEN_ATOL, rtol=0)
    _check_rows(kk, kp, kc, cur, cfg)
    _check_rows(vk, vp, vc, cur, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("T", ["64", "3C+5"])
@pytest.mark.parametrize("variant", ["k1", "k2", "k3", "k2k3", "k6", "k2k6"])
def test_row_result_does_not_depend_on_the_batch(cuda, variant, T):
    """Rows of a 32-row launch equal the same rows launched alone and in a
    batch of 16 (another gemv instantiation), bit for bit, on every cache
    tier; at 3C + 5 rows the windows span several attention chunks (the
    shared position is the last row)."""
    T = 64 if T == "64" else _keys("T")
    cfg = QUANT_GEOMETRIES["pairs"]
    _, kv_bits, per_slot, _ = next(t for t in TIERS_ALL if t[3] == variant)
    _, packed, kc, vc, emb, cur_arg, cur, lo = _tier_inputs(
        cfg, 32, T, cuda, 0, kv_bits, per_slot, shared_cur=T - 1)
    pos = cur - lo

    def run(sl):
        k, v = kc[:, sl].contiguous(), vc[:, sl].contiguous()
        c = cur_arg[sl] if isinstance(cur_arg, torch.Tensor) else cur_arg
        x = k1.decode_step(packed, emb[sl], k, v, c, lo[sl], pos[sl], cfg)
        torch.cuda.synchronize()
        return x, k, v

    x32, k32, v32 = run(slice(0, 32))
    for sl in (slice(0, 1), slice(17, 18), slice(31, 32), slice(8, 24)):
        x, k, v = run(sl)
        assert torch.equal(x, x32[sl])
        assert torch.equal(k, k32[:, sl]) and torch.equal(v, v32[:, sl])


def _tier_inputs(cfg, B, T, dev, wbits, kvbits, per_slot, seed=0,
                 shared_cur=11):
    """Inputs of one tier: packed weights of ``wbits``, caches of
    ``kvbits``, positions as ``_variant_inputs`` makes them."""
    params, _, kc, vc, emb, cur_arg, cur, lo = _variant_inputs(
        cfg, B, T, dev, "k2" if per_slot else "k1", seed, shared_cur)
    packed = k1.pack_weights(params, cfg, weight_bits=wbits)
    if kvbits:
        quant = {8: kv_quant.kv8_quantize, 4: kv_quant.kv4_quantize}[kvbits]
        kc, vc = quant(kc, cfg), quant(vc, cfg)
    return params, packed, kc, vc, emb, cur_arg, cur, lo


def _check_quantized_rows(got, ref, base, cur, cfg):
    """Row (b, cur_b) of every layer of a kv8 or kv4 cache against the plain
    version's, on the unpacked values; all other rows against the input."""
    H = cfg.num_attention_heads
    QW = got.shape[-1] - kv_quant.KV_PAD
    rows = torch.arange(got.shape[1], device=got.device)
    keep = torch.ones(got.shape[:3], dtype=torch.bool, device=got.device)
    keep[:, rows, cur] = False
    assert torch.equal(got[keep], base[keep])
    g, r = got[:, rows, cur], ref[:, rows, cur]      # (L, B, W)
    assert torch.equal(g[0, :, QW:], r[0, :, QW:])
    assert not g[..., QW + 2 * H:].any()
    sg, sr = kv_quant.row_scales(g, cfg), kv_quant.row_scales(r, cfg)
    assert bool(((sg - sr).abs() <= sr / 64 * (1 + 1e-6)).all())
    step = torch.where(sg == sr, sr, 2 * torch.maximum(sg, sr))
    vg, vr = k1.cache_values(g, cfg), k1.cache_values(r, cfg)
    err = (vg.reshape(vg.shape[:-1] + (H, -1)) * sg[..., None]
           - vr.reshape(vr.shape[:-1] + (H, -1)) * sr[..., None]).abs()
    assert bool((err <= step[..., None] * (1 + 1e-6)).all())
    differ = vg != vr
    assert int(differ[0].sum()) <= 0.01 * differ[0].numel()
    assert int(differ.sum()) <= 0.10 * differ.numel()


def _tier_case(cfg, B, T, dev, wbits, kvbits, per_slot, name):
    params, packed, kc, vc, emb, cur_arg, cur, lo = _tier_inputs(
        cfg, B, T, dev, wbits, kvbits, per_slot)
    pos = cur - lo
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = dict(k1.decode_step.variant_launches)
    xk = k1.decode_step(packed, emb, kk, vk, cur_arg, lo, pos, cfg)
    torch.cuda.synchronize()
    after = k1.decode_step.variant_launches
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    xp = k1.decode_step_plain(packed, emb, kp, vp, cur_arg, lo, pos, cfg)
    hk = llama.rms_norm(xk, params["norm"], cfg.rms_norm_eps)
    hp = llama.rms_norm(xp, params["norm"], cfg.rms_norm_eps)
    assert torch.isfinite(hk).all()
    torch.testing.assert_close(hk, hp, atol=HIDDEN_ATOL, rtol=0)
    for got, ref, base in ((kk, kp, kc), (vk, vp, vc)):
        if kvbits:
            _check_quantized_rows(got, ref, base, cur, cfg)
        else:
            _check_rows(got, ref, base, cur, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", sorted(QUANT_GEOMETRIES))
@pytest.mark.parametrize("wbits,kvbits,per_slot,name", TIERS,
                         ids=[t[3] for t in TIERS])
@pytest.mark.parametrize("B", [1, 3, 16, 33, 64])
def test_tier_matches_plain(cuda, geom, wbits, kvbits, per_slot, name, B):
    _tier_case(QUANT_GEOMETRIES[geom], B, 64, cuda, wbits, kvbits, per_slot,
               name)


@pytest.mark.gpu
@pytest.mark.parametrize("wbits,kvbits,per_slot,name",
                         [t for t in TIERS
                          if t[3] in ("k2k3k4", "k6k5", "k2k6k4")],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_tier_matches_plain_at_full_width(cuda, wbits, kvbits, per_slot,
                                          name):
    """The full config's widths (D 768, 12 heads of 64, I 3072) at 4 layers:
    int4 groups of 128, four int8 groups along the MLP's contraction, six
    head pairs to a kv4 row."""
    import dataclasses

    from chattts_tpu_torch.config import Config

    cfg = dataclasses.replace(Config().gpt, num_hidden_layers=4)
    _tier_case(cfg, 8, 512, cuda, wbits, kvbits, per_slot, name)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [65, 96, 128, 256])
@pytest.mark.parametrize("wbits,kvbits,per_slot,name", TIERS_ALL,
                         ids=[t[3] for t in TIERS_ALL])
def test_wide_batch_matches_plain(cuda, wbits, kvbits, per_slot, name, B):
    """Every tier past 64 rows (the gemv's third to eighth row groups of
    32, the attention grid's B) against the plain version, at the
    tolerances of the narrower cases."""
    _tier_case(QUANT_GEOMETRIES["pairs"], B, 64, cuda, wbits, kvbits,
               per_slot, name)


@pytest.mark.gpu
@pytest.mark.parametrize("wbits,kvbits,per_slot,name", TIERS_ALL,
                         ids=[t[3] for t in TIERS_ALL])
def test_tier_row_result_does_not_depend_on_the_batch(cuda, wbits, kvbits,
                                                      per_slot, name):
    """Rows of a 128-row launch (four row groups of the gemv) equal the same
    rows launched alone, among 16, among 32 and among 64, bit for bit; the
    slices cross the 32-row group boundaries and the 64-row one."""
    cfg = QUANT_GEOMETRIES["pairs"]
    _, packed, kc, vc, emb, cur_arg, cur, lo = _tier_inputs(
        cfg, 128, 64, cuda, wbits, kvbits, per_slot)
    pos = cur - lo

    def run(sl):
        k, v = kc[:, sl].contiguous(), vc[:, sl].contiguous()
        c = cur_arg[sl] if isinstance(cur_arg, torch.Tensor) else cur_arg
        x = k1.decode_step(packed, emb[sl], k, v, c, lo[sl], pos[sl], cfg)
        torch.cuda.synchronize()
        return x, k, v

    x128, k128, v128 = run(slice(0, 128))
    for sl in (slice(0, 1), slice(40, 41), slice(63, 64), slice(64, 65),
               slice(100, 101), slice(127, 128), slice(30, 46),
               slice(0, 32), slice(32, 64), slice(20, 60), slice(56, 72),
               slice(0, 64), slice(64, 128), slice(32, 96), slice(17, 81)):
        x, k, v = run(sl)
        assert torch.equal(x, x128[sl])
        assert torch.equal(k, k128[:, sl]) and torch.equal(v, v128[:, sl])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["k1", "k2k3"])
def test_rows_33_to_64_of_the_earlier_variants(cuda, variant):
    """K1-K3 keep their instantiations and gain the second row half."""
    cfg = GEOMETRIES["ragged"]
    params, packed, kc, vc, emb, cur_arg, cur, lo = _variant_inputs(
        cfg, 50, 64, cuda, variant)
    pos = cur - lo
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    xk = k1.decode_step(packed, emb, kk, vk, cur_arg, lo, pos, cfg)
    torch.cuda.synchronize()
    xp = k1.decode_step_plain(packed, emb, kp, vp, cur_arg, lo, pos, cfg)
    torch.testing.assert_close(
        llama.rms_norm(xk, params["norm"], cfg.rms_norm_eps),
        llama.rms_norm(xp, params["norm"], cfg.rms_norm_eps),
        atol=HIDDEN_ATOL, rtol=0)
    _check_rows(kk, kp, kc, cur, cfg)
    _check_rows(vk, vp, vc, cur, cfg)


# one layer's attention output, undiluted (MLP off, wo the identity), held
# to one bf16 ulp (2^-7 of the value) plus 3e-4: o's own rounding, and the
# attention pair's sums in another order than attend_plain's.  Both sides
# take the q of the kernel's own qkv gemv: a q summed in another order
# could put an element of bf16(q * scale) one bf16 ulp apart, which moves a
# score by up to 2^-8 of one of its terms and o by as much of the values'
# scale.  A key dropped at a chunk edge moves o by about |v - o| / n:
# test_attention_limit_rejects_a_dropped_edge_key shows the limit sees it.
ATTN_RTOL, ATTN_ATOL = 2 ** -7, 3e-4
# keys of a window as (a, b): a C + b, C the attention chunk the library
# was built with; "T" is a whole cache of 3C + 5 rows, not a multiple of C
WINDOWS = {"1": (0, 1), "C-1": (1, -1), "C": (1, 0), "C+1": (1, 1),
           "2C+1": (2, 1), "T": (3, 5)}


def _keys(window):
    """Keys of ``window`` (a name of WINDOWS) at the built chunk."""
    a, b = WINDOWS[window]
    return a * k1.decode_step.attn_chunk + b


def _attention_layer(kv_bits, B, T, windows, dev, seed=0):
    """One layer of the "pairs" geometry (D == HD) whose MLP is off and
    whose wo is the identity, so the step adds bf16(o) to the residual;
    rows of ``windows[b]`` keys placed across a cache of T rows, a position
    per row.  Returns the step's inputs and the packed weights."""
    import dataclasses

    cfg = dataclasses.replace(QUANT_GEOMETRIES["pairs"], num_hidden_layers=1)
    _, packed, kc, vc, emb, _, _, _ = _tier_inputs(cfg, B, T, dev, 0, kv_bits,
                                                   True, seed)
    packed["wgu"].zero_()
    packed["wd"].zero_()
    packed["wo"].copy_(torch.eye(cfg.hidden_size, dtype=torch.bfloat16)[None])
    n = torch.tensor(windows)
    lo = (torch.arange(B) * 37) % (T - n + 1)
    cur = lo + n - 1
    return cfg, packed, kc, vc, emb, cur.to(dev), lo.to(dev)


def _attention_error(cfg, packed, kc, vc, emb, cur, lo, drop=None):
    """The kernel's step against the plain version's: the caches as
    _check_rows and _check_quantized_rows hold them, and o against
    ``attend_plain`` on the caches the kernel appended to (so an appended
    quantized value that landed on the other side of a rounding tie is the
    same on both sides) and on the q the kernel's own qkv gemv gives (the
    one-gemv entry runs the step's instantiation on the same rows, so its
    q is the step's, bit for bit), roped as the plain version ropes it,
    after o's bf16 rounding: the largest |difference| / (ATTN_ATOL +
    ATTN_RTOL |o|), which passes at 1 or less.  ``drop``: a key (its index
    in the window) that the plain side leaves out, a fault planted on
    purpose."""
    H = cfg.num_attention_heads
    HD = H * cfg.head_dim
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    xk = k1.decode_step(packed, emb, kk, vk, cur, lo, cur - lo, cfg)
    torch.cuda.synchronize()
    k1.decode_step_plain(packed, emb, kp, vp, cur, lo, cur - lo, cfg)
    check = _check_quantized_rows if kc.dtype == torch.int8 else _check_rows
    check(kk, kp, kc, cur, cfg)
    check(vk, vp, vc, cur, cfg)
    cos, sin = k1.rope_rows(cfg, cur - lo)
    qkv = torch.empty((emb.shape[0], 3 * HD), device=emb.device)
    k1.gemv(emb.float().contiguous(), packed["ln1"][0], packed["wqkv"][0],
            None, 0, qkv, k1.GEMV_RMS, False, cfg.rms_norm_eps)
    q = k1._rope(qkv[:, :HD], cos, sin, H)
    t = torch.arange(kc.shape[2], device=emb.device)
    visible = (t[None, :] >= lo[:, None]) & (t[None, :] <= cur[:, None])
    if drop is not None:
        visible &= t[None, :] != (lo + drop)[:, None]
    o = k1.attend_plain(q, kk[0], vk[0], visible[:, None], cfg)
    got, want = xk - emb, (emb + k1._bf(o)) - emb
    lim = ATTN_ATOL + ATTN_RTOL * want.abs()
    assert torch.isfinite(got).all()
    return float(((got - want).abs() / lim).max())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 16, 64])
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_attention_chunk_edges(cuda, kv_bits, window, B):
    """Windows at the attention chunk's edges, every row of one size,
    placed from the first cache row onwards (T = 3C + 5)."""
    err = _attention_error(*_attention_layer(
        kv_bits, B, _keys("T"), [_keys(window)] * B, cuda))
    assert err <= 1, err


@pytest.mark.gpu
@pytest.mark.parametrize("drop", ["C-1", "C"])
@pytest.mark.parametrize("window", ["C+1", "2C+1", "T"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_attention_limit_rejects_a_dropped_edge_key(cuda, kv_bits, window,
                                                    drop):
    """The chunk-edge limit holds a schedule that loses one key at a chunk
    edge (the last of chunk 0, or the first of chunk 1) to account: the
    kernel's o against a plain window without that key fails it."""
    err = _attention_error(*_attention_layer(
        kv_bits, 8, _keys("T"), [_keys(window)] * 8, cuda), drop=_keys(drop))
    assert err > 1, err


@pytest.mark.gpu
def test_ticket_counters_are_reset(cuda):
    """Two steps back to back, the second with fewer rows and another T, so
    it reuses the first's (row, head) tickets: both right, and every ticket
    zero after each step."""
    sizes = [_keys(w) for w in WINDOWS]
    for B, T in ((16, _keys("T")), (8, _keys("2C+1") + 8)):
        windows = [min(sizes[b % len(sizes)], T) for b in range(B)]
        err = _attention_error(*_attention_layer(8, B, T, windows, cuda,
                                                 seed=B))
        assert err <= 1, err
        t = k1.decode_step.tickets(torch.cuda.current_stream(cuda), 1)
        assert t.numel() >= B * QUANT_GEOMETRIES["pairs"].num_attention_heads
        assert not t.any()


@pytest.mark.gpu
def test_steps_on_two_streams_keep_their_own_tickets(cuda):
    """Two steps issued at once on two streams take a ticket buffer each,
    and each equals the same step run alone, bit for bit."""
    sizes = [_keys(w) for w in WINDOWS]
    cases = [_attention_layer(8, 16, _keys("T"),
                              [sizes[(b + s) % len(sizes)] for b in range(16)],
                              cuda, seed=s) for s in (1, 2)]

    def run(cfg, packed, kc, vc, emb, cur, lo):
        return k1.decode_step(packed, emb, kc.clone(), vc.clone(), cur, lo,
                              cur - lo, cfg)

    alone = [run(*case) for case in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    got = []
    for stream, case in zip(streams, cases):
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            got.append(run(*case))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, alone))
    t0, t1 = (k1.decode_step.tickets(stream, 1) for stream in streams)
    assert t0.data_ptr() != t1.data_ptr()
    assert not t0.any() and not t1.any()


@pytest.mark.gpu
def test_kv4_rows_are_not_written_for_a_poisoned_row(cuda):
    cfg = QUANT_GEOMETRIES["pairs"]
    _, packed, kc, vc, emb, _, cur, lo = _tier_inputs(cfg, 3, 64, cuda, 4, 4,
                                                      True)
    cur = cur.clone()
    cur[2] = 64
    kk, vk = kc.clone(), vc.clone()
    x = k1.decode_step(packed, emb, kk, vk, cur, lo, cur - lo, cfg)
    torch.cuda.synchronize()
    assert torch.isnan(x[2]).all() and torch.isfinite(x[:2]).all()
    assert torch.equal(kk[:, 2], kc[:, 2]) and torch.equal(vk[:, 2], vc[:, 2])


@pytest.mark.gpu
def test_out_of_range_device_position_poisons_its_row_only(cuda):
    """A position the host cannot see is not clamped: the row turns NaN, the
    other rows and the cache stay as they were."""
    cfg = GEOMETRIES["small"]
    _, packed, kc, vc, emb, _, cur, lo = _variant_inputs(cfg, 3, 64, cuda,
                                                        "k2k3")
    cur = cur.clone()
    cur[2] = 64
    kk, vk = kc.clone(), vc.clone()
    x = k1.decode_step(packed, emb, kk, vk, cur, lo, cur - lo, cfg)
    torch.cuda.synchronize()
    assert torch.isnan(x[2]).all() and torch.isfinite(x[:2]).all()
    assert torch.equal(kk[:, 2], kc[:, 2]) and torch.equal(vk[:, 2], vc[:, 2])


@pytest.mark.gpu
def test_variant_wrapper_errors(cuda):
    cfg = GEOMETRIES["small"]
    HD = cfg.num_attention_heads * cfg.head_dim
    _, packed, kc, vc, emb = _inputs(cfg, 2, 16, cuda)
    lo = torch.zeros(2, dtype=torch.long, device=cuda)
    k8 = kv_quant.kv8_quantize(kc, cfg)
    with pytest.raises(ValueError, match="caches"):   # wrong width
        k1.decode_step(packed, emb, k8[..., :HD + 64].contiguous(),
                       k8[..., :HD + 64].contiguous(), 3, lo, lo, cfg)
    with pytest.raises(ValueError, match="caches"):   # wrong type
        k1.decode_step(packed, emb, k8.to(torch.int16), k8.to(torch.int16),
                       3, lo, lo, cfg)
    with pytest.raises(ValueError, match="differ"):   # mixed tiers
        k1.decode_step(packed, emb, k8, vc, 3, lo, lo, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((kc.shape[0], 2, 32, HD + kv_quant.KV_PAD),
                           dtype=torch.int8, device=cuda)
        k1.decode_step(packed, emb, wide[:, :, ::2], wide[:, :, ::2], 3, lo,
                       lo, cfg)
    with pytest.raises(ValueError, match="cur must be"):
        k1.decode_step(packed, emb, k8, k8.clone(), torch.zeros(
            3, dtype=torch.long, device=cuda), lo, lo, cfg)
    _, packed33, kc33, vc33, emb33 = _inputs(cfg, 33, 16, cuda)
    lo33 = torch.zeros(33, dtype=torch.long, device=cuda)
    x33 = k1.decode_step(packed33, emb33, kc33, vc33, 3, lo33, lo33, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(x33).all()
    _, packed65, kc65, vc65, emb65 = _inputs(cfg, 65, 16, cuda)
    lo65 = torch.zeros(65, dtype=torch.long, device=cuda)
    before = k1.decode_step.launches
    x65 = k1.decode_step(packed65, emb65, kc65, vc65, 3, lo65, lo65, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(x65).all()
    assert k1.decode_step.launches == before + 1
    with pytest.raises(ValueError, match="rows"):
        k1.decode_step(packed65, emb65[:0], kc65[:, :0].contiguous(),
                       vc65[:, :0].contiguous(), 3, lo65[:0], lo65[:0], cfg)


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


# the full model's heads, and a tensor-parallel rank's half of them
ATTEND_GEOMETRIES = {
    "12 heads": GPTConfig(hidden_size=768, intermediate_size=256,
                          num_attention_heads=12, num_hidden_layers=1,
                          max_position_embeddings=512),
    "6 heads": GPTConfig(hidden_size=384, intermediate_size=256,
                         num_attention_heads=6, num_hidden_layers=1,
                         max_position_embeddings=512),
}


@pytest.mark.gpu
@pytest.mark.parametrize("geom,kv_bits", [("12 heads", 0), ("12 heads", 8),
                                          ("12 heads", 4), ("6 heads", 0),
                                          ("6 heads", 8)])
def test_attend_is_the_attention_of_the_step(cuda, geom, kv_bits):
    """``decode_step_attend`` equals the attention of a whole-step launch,
    bit for bit: one layer whose wo is the identity and whose down is zero
    gives x + bf16(o) exactly, and the appended cache rows."""
    _attend_case(cuda, ATTEND_GEOMETRIES[geom], kv_bits, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_attend_at_96_rows(cuda, kv_bits):
    """The same at 96 rows on the full model's heads: gridDim.z 96."""
    _attend_case(cuda, ATTEND_GEOMETRIES["12 heads"], kv_bits, 96)


def _attend_case(cuda, cfg, kv_bits, B):
    T = 256
    D = cfg.hidden_size
    params, packed, kc, vc, emb = _inputs(cfg, B, T, cuda)
    packed["wo"] = torch.eye(D, device=cuda, dtype=torch.bfloat16)[None]
    packed["wd"] = torch.zeros_like(packed["wd"])
    if kv_bits:
        quantize = kv_quant.kv_quantizer(kv_bits, cfg)
        kc, vc = quantize(kc.float(), cfg), quantize(vc.float(), cfg)
    gen = torch.Generator().manual_seed(5)
    cur = torch.randint(1, T, (B,), generator=gen)
    cur[1] = T - 1
    lo = torch.randint(0, T, (B,), generator=gen) % (cur + 1)
    lo[0] = cur[0]
    cur, lo = cur.to(cuda), lo.to(cuda)
    pos = cur - lo
    ks, vs = kc.clone(), vc.clone()
    x = k1.decode_step(packed, emb, ks, vs, cur, lo, pos, cfg)

    HD = cfg.num_attention_heads * cfg.head_dim
    qkv = torch.empty((B, 3 * HD), device=cuda)
    k1.gemv(emb, packed["ln1"][0], packed["wqkv"][0], None, 1, qkv,
            k1.GEMV_RMS, False, cfg.rms_norm_eps)
    cos, sin = k1.rope_rows(cfg, pos)
    o = torch.empty((B, HD), device=cuda)
    ka, va = kc[0].clone(), vc[0].clone()
    before = k1.decode_step.attend_launches
    k1.attend(qkv, cos.contiguous(), sin.contiguous(), ka, va, cur, lo, o,
              cfg)
    torch.cuda.synchronize()
    assert k1.decode_step.attend_launches == before + 1
    assert torch.equal(emb + o.bfloat16().float(), x)
    assert torch.equal(ka, ks[0]) and torch.equal(va, vs[0])


def _tp_ranks(step, shards, emb, cur, lo, pos, cfg, heads):
    """``step`` on every rank's shards at once, one thread a rank, with an
    all_reduce that sums the ranks' partials in rank order (the threads
    share the card's stream, so the sum is queued after both partials)."""
    import threading

    tp = len(shards)
    barrier = threading.Barrier(tp)
    parts, out, errors = [None] * tp, [None] * tp, []

    def rank_main(rank):
        def all_reduce(t):
            parts[rank] = t.clone()
            barrier.wait(timeout=60)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            barrier.wait(timeout=60)
            return t.copy_(total)

        try:
            packed, k, v = shards[rank]
            out[rank] = step(packed, emb, k, v, cur, lo, pos, cfg, heads,
                             all_reduce)
        except BaseException as e:  # re-raised by the caller
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_tp_step_matches_its_plain_version(cuda, kv_bits):
    """Two tensor-parallel ranks of the full model's width at 2 layers on
    one card, a thread each: the kernels' step (``decode_step_tp``) against
    ``decode_step_plain`` of the same shards (their heads, the all_reduce)
    at the hidden's tolerance, both ranks' results equal, the launches
    counted."""
    cfg = GPTConfig(hidden_size=768, intermediate_size=3072,
                    num_attention_heads=12, num_hidden_layers=2,
                    max_position_embeddings=512)
    B, T, tp = 8, 128, 2
    params, packed, kc, vc, emb = _inputs(cfg, B, T, cuda)
    heads = k1.local_heads(cfg, tp)
    hl = heads.num_attention_heads * heads.head_dim
    gen = torch.Generator().manual_seed(6)
    cur = torch.randint(1, T, (B,), generator=gen).to(cuda)
    lo = torch.zeros(B, dtype=torch.long, device=cuda)

    def shards():
        out = []
        for rank in range(tp):
            sl = slice(rank * hl, (rank + 1) * hl)
            k, v = kc[..., sl].float(), vc[..., sl].float()
            if kv_bits:
                k, v = (kv_quant.kv8_quantize(k, heads),
                        kv_quant.kv8_quantize(v, heads))
            else:
                k, v = k.bfloat16(), v.bfloat16()
            out.append((k1.shard_packed(packed, cfg, tp, rank),
                        k.contiguous(), v.contiguous()))
        return out

    before = dict(k1.decode_step.tp_launches)
    got = _tp_ranks(k1.decode_step_tp, shards(), emb, cur, lo, cur, cfg,
                    heads)
    want = _tp_ranks(k1.decode_step_plain, shards(), emb, cur, lo, cur,
                     cfg, heads)
    torch.cuda.synchronize()
    variant = "k2k3" if kv_bits else "k2"
    assert k1.decode_step.tp_launches[variant] == before[variant] + tp
    assert torch.equal(got[0], got[1])
    hg = llama.rms_norm(got[0], params["norm"], cfg.rms_norm_eps)
    hw = llama.rms_norm(want[0], params["norm"], cfg.rms_norm_eps)
    assert torch.isfinite(hg).all()
    torch.testing.assert_close(hg, hw, atol=HIDDEN_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("wbits,kvbits,per_slot,name",
                         [t for t in TIERS_ALL
                          if t[3] in ("k2k3", "k2k6k4", "k2k5")],
                         ids=lambda t: t if isinstance(t, str) else None)
def test_step_tickets_are_zero_after_a_step_and_replays(cuda, wbits, kvbits,
                                                        per_slot, name):
    """The gemvs that finish rows (wo, down) take the attention pair's
    tickets, one a row group, and leave them zero: after an eager step of
    three row groups and after 8 replays of the same step captured into a
    CUDA graph with tickets of its own, each replay equal to the eager
    step bit for bit."""
    cfg = QUANT_GEOMETRIES["pairs"]
    B, H = 72, cfg.num_attention_heads
    _, packed, kc, vc, emb, cur_arg, cur, lo = _tier_inputs(
        cfg, B, 64, cuda, wbits, kvbits, per_slot)
    pos = cur - lo
    x = k1.decode_step(packed, emb, kc.clone(), vc.clone(), cur_arg, lo,
                       pos, cfg)
    torch.cuda.synchronize()
    assert not k1.decode_step.tickets(torch.cuda.current_stream(cuda),
                                      1).any()
    tickets = torch.zeros(B * H, dtype=torch.int32, device=cuda)
    kg, vg = kc.clone(), vc.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xg = k1.decode_step(packed, emb, kg, vg, cur_arg, lo, pos, cfg,
                            tickets)
    for _ in range(8):
        kg.copy_(kc)
        vg.copy_(vc)
        graph.replay()
        torch.cuda.synchronize()
        assert not tickets.any()
        assert torch.equal(xg, x)


@pytest.mark.gpu
@pytest.mark.parametrize("wbits", [0, 8, 4])
def test_step_gemvs_read_prepared_rows(cuda, wbits):
    """A step counts its 4 L gemvs as reading rows another kernel prepared
    and none as building its own; a replay of a captured step counts the
    same."""
    cfg = QUANT_GEOMETRIES["pairs"]
    L = cfg.num_hidden_layers
    _, packed, kc, vc, emb, cur_arg, cur, lo = _tier_inputs(
        cfg, 16, 64, cuda, wbits, 8, True)
    step = k1.decode_step
    before = (step.gemv_prepared, step.gemv_rebuilt)
    k1.decode_step(packed, emb, kc, vc, cur_arg, lo, cur - lo, cfg)
    torch.cuda.synchronize()
    assert (step.gemv_prepared, step.gemv_rebuilt) == (before[0] + 4 * L,
                                                       before[1])
    graph = torch.cuda.CUDAGraph()
    tickets = torch.zeros(16 * cfg.num_attention_heads, dtype=torch.int32,
                          device=cuda)
    with torch.cuda.graph(graph):
        k1.decode_step(packed, emb, kc, vc, cur_arg, lo, cur - lo, cfg,
                       tickets)
    assert step.gemv_prepared == before[0] + 4 * L
    graph.replay()
    step.replayed(k1.variant_of(kc, cur_arg, packed, cfg))
    torch.cuda.synchronize()
    assert (step.gemv_prepared, step.gemv_rebuilt) == (before[0] + 8 * L,
                                                       before[1])
