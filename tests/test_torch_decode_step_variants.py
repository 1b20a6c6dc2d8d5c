"""The plain K2, K3 and K2+K3 decode steps against the Pallas kernel (CPU).

``decode_step_fused(..., interpret=True)`` runs the TPU kernel's own body;
the port's ``decode_step`` takes ``decode_step_plain`` for CPU tensors.  K2
gives every row its own write position ``cur_b``, K3 keeps the cache in the
kv8 row format, K2+K3 does both (what the continuous-batching engine
launches).  Geometry is that of tests/test_pallas_step.py.

Tolerances.  The final-norm hidden is held to atol 0.05, the repository's
kernel tolerance, at several chunk sizes of the kernel's online softmax.
Cache rows other than row ``cur_b`` of row b must be byte-unchanged.  The
appended bf16 row agrees to about one bf16 ulp (atol and rtol 0.02).  The
appended kv8 row is compared after dequantization, to within one
quantization step of its head (ulp-level differences of the f32 k, and the
CPU backend's inexact ``exp2``, can move a stored value by one).  Layer 0's
scale bytes must be equal; a deeper layer's head absmax has drifted, so its
decoded scale may sit one mantissa step (1/64) away, and under two unequal
scales the dequantized values may sit two steps apart.  The value bytes that
differ are counted: layer 0
quantizes inputs that agree to an ulp and may differ in 1% of its bytes;
deeper layers quantize a residual that has drifted by the hidden tolerance's
share (about 1e-3 against a step of 2e-2) and may differ in 10%.

Row independence: a row's result in a batch of 32 must equal its result
alone.  The plain version's matmuls pick other CPU routines at other batch
sizes, so here the hidden is held to 1e-4 and the appended kv8 bytes to
equality; on the card the kernel is held to bit equality
(tests/test_torch_kernels_gpu.py).
"""

import jax.numpy as jnp
import jax
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

CFG = GPTConfig(
    hidden_size=128,
    intermediate_size=256,
    num_attention_heads=2,
    num_hidden_layers=3,
    max_position_embeddings=128,
    num_audio_tokens=626,
    num_text_tokens=300,
    num_vq=4,
)
PCFG = port_config(CFG)
T = 32
H = CFG.num_attention_heads
HD = H * CFG.head_dim
L = CFG.num_hidden_layers
HIDDEN_ATOL = 0.05
ROW_TOL = 0.02
KV8_DIFF_LAYER0, KV8_DIFF_ALL = 0.01, 0.10


@pytest.fixture(scope="module")
def weights():
    params = jl.init_params(jax.random.PRNGKey(0), CFG)
    tp = bridge(params)
    return (params, pallas_step.pack_step_params(params, CFG), tp,
            ds.pack_weights(tp, PCFG))


def _inputs(B: int, kv8: bool, per_slot: bool, seed: int = 1):
    """Caches (numpy; kv8 rows made by the reference's quantizer), emb, and
    ragged positions: row 0 sees one key (cur = lo), row 1 writes the last
    cache row."""
    rng = np.random.default_rng(seed + 10 * B)
    kc = rng.standard_normal((L, B, T, HD)).astype(np.float32)
    vc = rng.standard_normal((L, B, T, HD)).astype(np.float32)
    emb = (rng.standard_normal((B, CFG.hidden_size)) * 0.3).astype(np.float32)
    if kv8:
        kc = np.array(pallas_step.kv8_quantize(jnp.asarray(kc), CFG))
        vc = np.array(pallas_step.kv8_quantize(jnp.asarray(vc), CFG))
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


def _run_port(weights, kc, vc, emb, cur, lo, per_slot):
    tp, packed = weights[2], weights[3]
    dt = torch.int8 if kc.dtype == np.int8 else torch.bfloat16
    k_t = torch.from_numpy(kc.copy()).to(dt)
    v_t = torch.from_numpy(vc.copy()).to(dt)
    cur_arg = torch.from_numpy(cur.copy()) if per_slot else int(cur[0])
    lo_t = torch.from_numpy(lo.copy()).long()
    pos = torch.from_numpy((cur - lo).astype(np.int64))
    x = ds.decode_step(packed, torch.from_numpy(emb), k_t, v_t, cur_arg, lo_t,
                       pos, PCFG)
    return to_np(tl.rms_norm(x, tp["norm"], CFG.rms_norm_eps)), k_t, v_t


def _run_ref(weights, kc, vc, emb, cur, lo, per_slot, t_chunk):
    params, jpacked = weights[0], weights[1]
    dt = jnp.int8 if kc.dtype == np.int8 else jnp.bfloat16
    cur_arg = jnp.asarray(cur) if per_slot else jnp.int32(cur[0])
    x, k2, v2 = pallas_step.decode_step_fused(
        jpacked, jnp.asarray(emb), jnp.asarray(kc, dt), jnp.asarray(vc, dt),
        cur_arg, jnp.asarray(lo), jnp.asarray(cur - lo, jnp.int32), CFG,
        t_chunk=t_chunk, interpret=True)
    h = np.asarray(jl.rms_norm(x, params["norm"], CFG.rms_norm_eps))
    return h, np.asarray(k2), np.asarray(v2)


def _others_unchanged(got: np.ndarray, base: np.ndarray, cur: np.ndarray):
    """Every row but (b, cur_b) of every layer equals the input, as bytes."""
    mask = np.ones(got.shape[:3], bool)
    mask[:, np.arange(len(cur)), cur] = False
    np.testing.assert_array_equal(got[mask], base[mask])


def _appended(cache: np.ndarray, cur: np.ndarray) -> np.ndarray:
    return cache[:, np.arange(len(cur)), cur]       # (L, B, W)


def _check_kv8_rows(got: np.ndarray, ref: np.ndarray):
    """Appended kv8 rows (L, B, W): layer 0's scale bytes equal, deeper
    scales within one mantissa step, values within one quantization step."""
    np.testing.assert_array_equal(got[0, :, HD:], ref[0, :, HD:])
    step = kv_quant.row_scales(torch.from_numpy(ref), PCFG).numpy()
    step_got = kv_quant.row_scales(torch.from_numpy(got), PCFG).numpy()
    assert (np.abs(step_got - step) <= step / 64 * (1 + 1e-6)).all()
    step = np.where(step == step_got, step, 2 * np.maximum(step, step_got))
    dq_got = kv_quant.kv8_dequantize(torch.from_numpy(got), PCFG).numpy()
    dq_ref = kv_quant.kv8_dequantize(torch.from_numpy(ref), PCFG).numpy()
    err = np.abs(dq_got - dq_ref).reshape(got.shape[:-1] + (H, -1))
    assert (err <= step[..., None] * (1 + 1e-6)).all()
    differ = got[..., :HD] != ref[..., :HD]
    n0, n = int(differ[0].sum()), int(differ.sum())
    assert n0 <= KV8_DIFF_LAYER0 * differ[0].size, (n0, differ[0].size)
    assert n <= KV8_DIFF_ALL * differ.size, (n, differ.size)
    return n0, n


CASES = [(2, 8), (2, 16), (2, 32), (5, 8), (5, 32), (32, 32)]


@pytest.mark.parametrize("variant", ["k2", "k3", "k2k3"])
@pytest.mark.parametrize("B,t_chunk", CASES)
def test_plain_matches_pallas_kernel(weights, variant, B, t_chunk):
    kv8, per_slot = "k3" in variant, "k2" in variant
    kc, vc, emb, cur, lo = _inputs(B, kv8, per_slot)
    h_ref, k_ref, v_ref = _run_ref(weights, kc, vc, emb, cur, lo, per_slot,
                                   t_chunk)
    h, k_t, v_t = _run_port(weights, kc, vc, emb, cur, lo, per_slot)
    assert ds.variant_of(k_t, torch.from_numpy(cur) if per_slot
                         else int(cur[0])) == variant
    np.testing.assert_allclose(h, h_ref, atol=HIDDEN_ATOL)
    for got_t, ref, base in ((k_t, k_ref, kc), (v_t, v_ref, vc)):
        got = got_t.numpy() if kv8 else to_np(got_t)
        ref = ref if kv8 else np.asarray(ref, np.float32)
        _others_unchanged(got, base, cur)
        _others_unchanged(ref, base, cur)
        if kv8:
            n0, n = _check_kv8_rows(_appended(got, cur), _appended(ref, cur))
            print(f"{variant} B {B}: appended value bytes that differ: "
                  f"{n0} in layer 0, {n} of {L * B * HD} in all")
            assert not _appended(got, cur)[..., HD + 2 * H:].any()
        else:
            np.testing.assert_allclose(_appended(got, cur),
                                       _appended(ref, cur), atol=ROW_TOL,
                                       rtol=ROW_TOL)


@pytest.mark.parametrize("variant", ["k1", "k2", "k3", "k2k3"])
def test_row_result_does_not_depend_on_the_batch(weights, variant):
    kv8, per_slot = "k3" in variant, "k2" in variant
    kc, vc, emb, cur, lo = _inputs(32, kv8, per_slot)
    h32, k32, v32 = _run_port(weights, kc, vc, emb, cur, lo, per_slot)
    for b in (0, 1, 17, 31):
        sl = slice(b, b + 1)
        h1, k1, v1 = _run_port(weights, kc[:, sl], vc[:, sl], emb[sl],
                               cur[sl], lo[sl], per_slot)
        np.testing.assert_allclose(h1[0], h32[b], atol=1e-4, rtol=0)
        for one, many in ((k1, k32), (v1, v32)):
            a, m = one[:, 0, cur[b]], many[:, b, cur[b]]
            if kv8:
                assert torch.equal(a, m)
            else:
                np.testing.assert_allclose(to_np(a), to_np(m), atol=ROW_TOL,
                                           rtol=ROW_TOL)


def test_scalar_cur_equals_equal_per_slot_cur(weights):
    """K1 is K2 with equal entries (and K3 is K2+K3): the kernel shares one
    instantiation, the plain version one formula."""
    for kv8 in (False, True):
        kc, vc, emb, cur, lo = _inputs(5, kv8, per_slot=False)
        h_s, k_s, v_s = _run_port(weights, kc, vc, emb, cur, lo, False)
        h_v, k_v, v_v = _run_port(weights, kc, vc, emb, cur, lo, True)
        np.testing.assert_allclose(h_s, h_v, atol=1e-5, rtol=0)
        assert torch.equal(k_s, k_v) and torch.equal(v_s, v_v)


def test_zero_dim_tensor_cur_is_the_scalar_variant(weights):
    kc, vc, emb, cur, lo = _inputs(2, True, per_slot=False)
    packed = weights[3]
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    c0 = torch.tensor(int(cur[0]))
    assert ds.variant_of(k_t, c0) == "k3"
    x = ds.decode_step(packed, torch.from_numpy(emb), k_t, v_t, c0,
                       torch.from_numpy(lo).long(),
                       torch.from_numpy(cur - lo).long(), PCFG)
    h, k_i, _ = _run_port(weights, kc, vc, emb, cur, lo, False)
    np.testing.assert_allclose(
        to_np(tl.rms_norm(x, weights[2]["norm"], CFG.rms_norm_eps)), h,
        atol=1e-4, rtol=0)
    assert torch.equal(k_t, k_i)


def test_plain_rejects_wrong_cache_width_and_type(weights):
    packed = weights[3]
    emb = torch.zeros((2, CFG.hidden_size))
    z = torch.zeros(2, dtype=torch.long)
    bad_w = torch.zeros((L, 2, T, HD + 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="caches"):
        ds.decode_step(packed, emb, bad_w, bad_w, 3, z, z, PCFG)
    f32 = torch.zeros((L, 2, T, HD))
    with pytest.raises(ValueError, match="caches"):
        ds.decode_step(packed, emb, f32, f32, 3, z, z, PCFG)
    k8 = torch.zeros((L, 2, T, HD + kv_quant.KV_PAD), dtype=torch.int8)
    kb = torch.zeros((L, 2, T, HD), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="differ"):
        ds.decode_step(packed, emb, k8, kb, 3, z, z, PCFG)


def test_launch_counts_per_variant():
    step = ds.DecodeStep()
    assert step.launches == 0 and set(step.variant_launches) == set(ds.VARIANTS)
    step.variant_launches["k2k3"] += 3
    step.variant_launches["k1"] += 1
    assert step.launches == 4
    step.launches = 0
    assert step.launches == 0 and step.variant_launches["k2k3"] == 0
    with pytest.raises(ValueError):
        step.launches = 5
