"""The plain decode step on the quantized tiers against the Pallas kernel
(CPU): K4 (int8 weights), K5 (int4 weights), K6 (int4 KV cache) and their
combinations with the caches and per-row positions of K1-K3.

``decode_step_fused(..., interpret=True)`` runs the TPU kernel's own body
on the reference's packed slabs; the port's ``decode_step`` takes
``decode_step_plain`` for CPU tensors, on its own pack of the same
parameters (equal integers and scales, tests/test_torch_weight_pack.py).
K4 and K5 run tests/test_pallas_step.py's CFG on the bf16 and kv8 caches;
whatever touches kv4 runs its CFG4 (kv4 needs HD % 256 == 0).

Tolerances.  The final-norm hidden is held to atol 0.05, the repository's
kernel tolerance: both sides multiply the same integers by the same scales
and differ in the order of f32 sums only.  Cache rows other than row
``cur_b`` of row b must be byte-unchanged.  Appended bf16 rows agree to two
bf16 ulps (0.02), appended kv8 rows as tests/test_torch_decode_step_variants
holds them.  An appended kv4 row is compared as bytes: layer 0's scale
bytes equal, a deeper layer's decoded scale within one mantissa step
(1/64); every dequantized value within one quantization step (two where
the scales differ); the values that differ are counted, at most 1% in
layer 0 (inputs equal to an ulp; a kv4 step is 1/7 of the head's absmax, so
few values sit near a tie) and 10% in all layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.config import GPTConfig
from chattts_tpu.models import llama as jl
from chattts_tpu.ops import pallas_step
from chattts_tpu_torch.models import llama as tl
from chattts_tpu_torch.ops import decode_step as ds
from chattts_tpu_torch.ops import kv_quant
from torch_port_utils import bridge, port_config, to_np

CFGS = {
    "cfg": GPTConfig(hidden_size=128, intermediate_size=256,
                     num_attention_heads=2, num_hidden_layers=3,
                     max_position_embeddings=128),
    "cfg4": GPTConfig(hidden_size=256, intermediate_size=512,
                      num_attention_heads=2, num_hidden_layers=2,
                      max_position_embeddings=128),
}
T = 32
HIDDEN_ATOL = 0.05
ROW_TOL = 0.02
DIFF_LAYER0, DIFF_ALL = 0.01, 0.10


@pytest.fixture(scope="module")
def weights():
    """{(geometry, weight_bits): (params, reference pack, port tree, port
    pack)}, built on first use."""
    made = {}

    def get(geom, bits):
        if (geom, bits) not in made:
            cfg = CFGS[geom]
            params = jl.init_params(jax.random.PRNGKey(0), cfg)
            tp = bridge(params)
            made[geom, bits] = (
                params, pallas_step.pack_step_params(
                    params, cfg, int8=bits == 8, int4=bits == 4),
                tp, ds.pack_weights(tp, port_config(cfg), weight_bits=bits))
        return made[geom, bits]

    return get


def _inputs(cfg, B, kv_bits, per_slot, seed=1):
    """Caches (numpy; quantized rows by the reference's quantizers), emb,
    ragged positions: row 0 sees one key, row 1 writes the last cache row."""
    L = cfg.num_hidden_layers
    HD = cfg.num_attention_heads * cfg.head_dim
    rng = np.random.default_rng(seed + 10 * B)
    kc = rng.standard_normal((L, B, T, HD)).astype(np.float32)
    vc = rng.standard_normal((L, B, T, HD)).astype(np.float32)
    emb = (rng.standard_normal((B, cfg.hidden_size)) * 0.3).astype(np.float32)
    if kv_bits:
        quant = {8: pallas_step.kv8_quantize, 4: pallas_step.kv4_quantize}
        kc = np.array(quant[kv_bits](jnp.asarray(kc), cfg))
        vc = np.array(quant[kv_bits](jnp.asarray(vc), cfg))
    else:
        kc = to_np(torch.from_numpy(kc).bfloat16())
        vc = to_np(torch.from_numpy(vc).bfloat16())
    if per_slot:
        cur = rng.integers(1, T, size=B)
        cur[0] = 7
        cur[1] = T - 1
        lo = (rng.integers(0, T, size=B) % (cur + 1))
        lo[0] = cur[0]
    else:
        cur = np.full((B,), 11)
        lo = rng.integers(0, 12, size=B)
        lo[0] = 11
    return kc, vc, emb, cur.astype(np.int32), lo.astype(np.int32)


def _run_port(w, cfg, kc, vc, emb, cur, lo, per_slot):
    tp, packed = w[2], w[3]
    pcfg = port_config(cfg)
    dt = torch.int8 if kc.dtype == np.int8 else torch.bfloat16
    k_t = torch.from_numpy(kc.copy()).to(dt)
    v_t = torch.from_numpy(vc.copy()).to(dt)
    cur_arg = torch.from_numpy(cur.copy()) if per_slot else int(cur[0])
    x = ds.decode_step(packed, torch.from_numpy(emb), k_t, v_t, cur_arg,
                       torch.from_numpy(lo.copy()).long(),
                       torch.from_numpy((cur - lo).astype(np.int64)), pcfg)
    name = ds.variant_of(k_t, cur_arg, packed, pcfg)
    return to_np(tl.rms_norm(x, tp["norm"], cfg.rms_norm_eps)), k_t, v_t, name


def _run_ref(w, cfg, kc, vc, emb, cur, lo, per_slot, t_chunk):
    params, jpacked = w[0], w[1]
    dt = jnp.int8 if kc.dtype == np.int8 else jnp.bfloat16
    cur_arg = jnp.asarray(cur) if per_slot else jnp.int32(cur[0])
    x, k2, v2 = pallas_step.decode_step_fused(
        jpacked, jnp.asarray(emb), jnp.asarray(kc, dt), jnp.asarray(vc, dt),
        cur_arg, jnp.asarray(lo), jnp.asarray(cur - lo, jnp.int32), cfg,
        t_chunk=t_chunk, interpret=True)
    h = np.asarray(jl.rms_norm(x, params["norm"], cfg.rms_norm_eps))
    return h, np.asarray(k2), np.asarray(v2)


def _others_unchanged(got, base, cur):
    mask = np.ones(got.shape[:3], bool)
    mask[:, np.arange(len(cur)), cur] = False
    np.testing.assert_array_equal(got[mask], base[mask])


def _appended(cache, cur):
    return cache[:, np.arange(len(cur)), cur]       # (L, B, W)


def _check_quantized_rows(got, ref, pcfg, kv_bits):
    """Appended kv8 or kv4 rows (L, B, W), as the module docstring says."""
    H = pcfg.num_attention_heads
    QW = got.shape[-1] - kv_quant.KV_PAD
    np.testing.assert_array_equal(got[0, :, QW:], ref[0, :, QW:])
    assert not got[..., QW + 2 * H:].any()
    tg, tr = torch.from_numpy(got.copy()), torch.from_numpy(ref.copy())
    step = kv_quant.row_scales(tr, pcfg).numpy()
    step_got = kv_quant.row_scales(tg, pcfg).numpy()
    assert (np.abs(step_got - step) <= step / 64 * (1 + 1e-6)).all()
    step = np.where(step == step_got, step, 2 * np.maximum(step, step_got))
    deq = kv_quant.kv4_dequantize if kv_bits == 4 else kv_quant.kv8_dequantize
    err = np.abs(deq(tg, pcfg).numpy() - deq(tr, pcfg).numpy())
    assert (err.reshape(got.shape[:-1] + (H, -1))
            <= step[..., None] * (1 + 1e-6)).all()
    vg, vr = (ds.cache_values(t, pcfg).numpy() for t in (tg, tr))
    differ = vg != vr
    n0, n = int(differ[0].sum()), int(differ.sum())
    assert n0 <= DIFF_LAYER0 * differ[0].size, (n0, differ[0].size)
    assert n <= DIFF_ALL * differ.size, (n, differ.size)
    return n0, n, differ.size


# (geometry, weight bits, cache bits, a position per row, variant's name)
TIERS = [
    ("cfg", 8, 0, False, "k1k4"), ("cfg", 8, 8, False, "k3k4"),
    ("cfg", 8, 8, True, "k2k3k4"),
    ("cfg", 4, 0, False, "k1k5"), ("cfg", 4, 8, False, "k3k5"),
    ("cfg", 4, 0, True, "k2k5"),
    ("cfg4", 0, 4, False, "k6"), ("cfg4", 0, 4, True, "k2k6"),
    ("cfg4", 4, 4, False, "k6k5"), ("cfg4", 4, 4, True, "k2k6k5"),
    ("cfg4", 8, 4, True, "k2k6k4"),
]


# every tier at 2 and 5 rows and two chunk sizes of the kernel's online
# softmax; 32 rows (slow in interpret mode) where both tiers are quantized
CASES = ([t + bt for t in TIERS for bt in ((2, 8), (5, 32))]
         + [t + (32, 16) for t in TIERS
            if t[4] in ("k3k4", "k2k6k5", "k2k6k4")])


@pytest.mark.parametrize("geom,wbits,kvbits,per_slot,name,B,t_chunk", CASES,
                         ids=[f"{c[4]}-{c[5]}-{c[6]}" for c in CASES])
def test_plain_matches_pallas_kernel(weights, geom, wbits, kvbits, per_slot,
                                     name, B, t_chunk):
    cfg = CFGS[geom]
    pcfg = port_config(cfg)
    w = weights(geom, wbits)
    kc, vc, emb, cur, lo = _inputs(cfg, B, kvbits, per_slot)
    h_ref, k_ref, v_ref = _run_ref(w, cfg, kc, vc, emb, cur, lo, per_slot,
                                   t_chunk)
    h, k_t, v_t, variant = _run_port(w, cfg, kc, vc, emb, cur, lo, per_slot)
    assert variant == name and name in ds.VARIANTS
    np.testing.assert_allclose(h, h_ref, atol=HIDDEN_ATOL)
    for got_t, ref, base in ((k_t, k_ref, kc), (v_t, v_ref, vc)):
        got = got_t.numpy() if kvbits else to_np(got_t)
        ref = ref if kvbits else np.asarray(ref, np.float32)
        _others_unchanged(got, base, cur)
        _others_unchanged(ref, base, cur)
        if kvbits:
            n0, n, size = _check_quantized_rows(
                _appended(got, cur), _appended(ref, cur), pcfg, kvbits)
            print(f"{name} B {B}: appended values that differ: {n0} in "
                  f"layer 0, {n} of {size} in all")
        else:
            np.testing.assert_allclose(_appended(got, cur),
                                       _appended(ref, cur), atol=ROW_TOL,
                                       rtol=ROW_TOL)


@pytest.mark.parametrize("geom,wbits,kvbits,per_slot,name",
                         [t for t in TIERS if t[4] in (
                             "k3k4", "k2k5", "k6", "k2k6k5", "k2k6k4")],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_row_result_does_not_depend_on_the_batch(weights, geom, wbits, kvbits,
                                                 per_slot, name):
    """A row among 64 equals the row alone, up to torch's CPU matmuls,
    which pick other routines at other batch sizes.  Their f32 sums differ
    in the last place, and where that flips the bf16 rounding of an
    activation the activation moves by 2^-8 of its value: the hidden is
    held to 5e-3 (measured: 1.5e-3 at D 256).  Appended quantized rows are
    compared as values: at most 1 in 1000 may sit on the other side of a
    rounding tie, by one step.  On the card the kernel is held to bit
    equality (tests/test_torch_kernels_gpu.py)."""
    cfg = CFGS[geom]
    pcfg = port_config(cfg)
    w = weights(geom, wbits)
    kc, vc, emb, cur, lo = _inputs(cfg, 64, kvbits, per_slot)
    h64, k64, v64, _ = _run_port(w, cfg, kc, vc, emb, cur, lo, per_slot)
    for b in (0, 1, 33, 63):
        sl = slice(b, b + 1)
        h1, k1, v1, _ = _run_port(w, cfg, kc[:, sl], vc[:, sl], emb[sl],
                                  cur[sl], lo[sl], per_slot)
        flipped = 0
        for one, many in ((k1, k64), (v1, v64)):
            a, m = one[:, 0, cur[b]], many[:, b, cur[b]]
            if kvbits:
                va, vm = ds.cache_values(a, pcfg), ds.cache_values(m, pcfg)
                flipped += int((va != vm).sum())
                assert float((va - vm).abs().max()) <= 1
                assert flipped <= max(1, 2 * va.numel() // 1000)
            else:
                np.testing.assert_allclose(to_np(a), to_np(m), atol=ROW_TOL,
                                           rtol=ROW_TOL)
        np.testing.assert_allclose(h1[0], h64[b], rtol=0, atol=5e-3)


def test_group_scale_multiplies_the_group_sum(weights):
    """``_mm`` on a quantized matrix is sum_g scale[g, n] * (f32 sum over
    group g of bf16(a) * q): checked against that sum written out, and a
    scale of one group changes the result by that group's share only."""
    w = weights("cfg4", 4)
    packed = w[3]
    D = CFGS["cfg4"].hidden_size
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    wq, s = packed["wqkv"][0], packed["sqkv"][0]          # (N, D/2), (N, 2)
    got = ds._mm(a, wq, s)
    q = ds.unpack_matrix(wq, D).double()
    ab = a.bfloat16().double()
    want = sum((ab[:, g * 128:(g + 1) * 128] @ q[:, g * 128:(g + 1) * 128].T)
               * s[:, g].double() for g in range(2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    s2 = s.clone()
    s2[:, 1] *= 2
    delta = ds._mm(a, wq, s2) - got
    share = (ab[:, 128:] @ q[:, 128:].T) * s[:, 1].double()
    np.testing.assert_allclose(delta.numpy(), share.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_tier_follows_from_the_arguments(weights):
    pcfg = port_config(CFGS["cfg4"])
    L, HD = pcfg.num_hidden_layers, 256
    emb = torch.zeros((2, pcfg.hidden_size))
    z = torch.zeros(2, dtype=torch.long)
    k4 = torch.zeros((L, 2, T, HD // 2 + kv_quant.KV_PAD), dtype=torch.int8)
    k8 = torch.zeros((L, 2, T, HD + kv_quant.KV_PAD), dtype=torch.int8)
    kb = torch.zeros((L, 2, T, HD), dtype=torch.bfloat16)
    assert [ds.kv_bits_of(c, pcfg) for c in (kb, k8, k4)] == [0, 8, 4]
    p8 = weights("cfg4", 8)[3]
    assert ds.variant_of(k4, z, p8, pcfg) == "k2k6k4"
    assert ds.variant_of(k8, 3, p8, pcfg) == "k3k4"
    assert ds.variant_of(kb, 3, weights("cfg4", 4)[3], pcfg) == "k1k5"
    with pytest.raises(ValueError, match="differ"):
        ds.decode_step(p8, emb, k4, k8, 3, z, z, pcfg)
    # a geometry without kv4 rows does not take a cache of their width
    small = port_config(CFGS["cfg"])
    bad = torch.zeros((3, 2, T, 64 + kv_quant.KV_PAD), dtype=torch.int8)
    with pytest.raises(ValueError, match="caches"):
        ds.kv_bits_of(bad, small)
    assert len(ds.VARIANTS) == 18 and len(set(ds.VARIANTS)) == 18
