"""K1's plain version against the Pallas kernel it replaces (CPU).

``decode_step_fused(..., interpret=True)`` runs the TPU kernel's own body in
interpret mode; ``decode_step`` of the port takes ``decode_step_plain`` for
CPU tensors.  Geometry and tolerances are those of tests/test_pallas_step.py:
the final-norm hidden within atol 0.05, and every cache row other than
``cur`` bit-unchanged.  The two compute the same roundings, so the appended
rows agree to about one bf16 ulp (atol and rtol 0.02).  The kernel's chunk
size decides where its online softmax rescales, so each chunking is held to
the same tolerance.
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
from chattts_tpu_torch.ops import decode_step as k1
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
B, T = 2, 32
HD = CFG.num_attention_heads * CFG.head_dim
L = CFG.num_hidden_layers
HIDDEN_ATOL = 0.05
ROW_TOL = 0.02


@pytest.fixture(scope="module")
def setup():
    params = jl.init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(1)
    kc = rng.standard_normal((L, B, T, HD)).astype(np.float32)
    vc = rng.standard_normal((L, B, T, HD)).astype(np.float32)
    emb = (rng.standard_normal((B, CFG.hidden_size)) * 0.3).astype(np.float32)
    tp = bridge(params)
    return params, tp, k1.pack_weights(tp, port_config(CFG)), kc, vc, emb


def _run_port(setup, cur, lo):
    _, tp, packed, kc, vc, emb = setup
    pcfg = port_config(CFG)
    k_t = torch.from_numpy(kc).bfloat16()
    v_t = torch.from_numpy(vc).bfloat16()
    lo_t = torch.as_tensor(lo)
    x = k1.decode_step(packed, torch.from_numpy(emb), k_t, v_t, cur, lo_t,
                       cur - lo_t, pcfg)
    h = tl.rms_norm(x, tp["norm"], CFG.rms_norm_eps)
    return to_np(h), k_t, v_t


@pytest.mark.parametrize("t_chunk", [8, 16, T])
def test_plain_matches_pallas_kernel(setup, t_chunk):
    params, _, _, kc, vc, emb = setup
    cur, lo = 11, np.array([0, 3])
    packed = pallas_step.pack_step_params(params, CFG)
    x_ref, k_ref, v_ref = pallas_step.decode_step_fused(
        packed, jnp.asarray(emb), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.int32(cur),
        jnp.asarray(lo, jnp.int32), jnp.asarray(cur - lo, jnp.int32), CFG,
        t_chunk=t_chunk, interpret=True)
    h_ref = np.asarray(jl.rms_norm(x_ref, params["norm"], CFG.rms_norm_eps))
    h, k_t, v_t = _run_port(setup, cur, lo)
    np.testing.assert_allclose(h, h_ref, atol=HIDDEN_ATOL)
    for got, ref, base in ((k_t, k_ref, kc), (v_t, v_ref, vc)):
        got = to_np(got)
        np.testing.assert_allclose(got[:, :, cur],
                                   np.asarray(ref[:, :, cur], np.float32),
                                   atol=ROW_TOL, rtol=ROW_TOL)
        base_bf = to_np(torch.from_numpy(base).bfloat16())
        np.testing.assert_array_equal(got[:, :, :cur], base_bf[:, :, :cur])
        np.testing.assert_array_equal(got[:, :, cur + 1:],
                                      base_bf[:, :, cur + 1:])


def test_plain_last_row_and_full_window(setup):
    """cur at the last cache row with lo 0: the window is the whole cache."""
    params, _, _, kc, vc, emb = setup
    cur, lo = T - 1, np.array([0, 0])
    packed = pallas_step.pack_step_params(params, CFG)
    x_ref, _, _ = pallas_step.decode_step_fused(
        packed, jnp.asarray(emb), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.int32(cur),
        jnp.asarray(lo, jnp.int32), jnp.asarray(cur - lo, jnp.int32), CFG,
        t_chunk=T, interpret=True)
    h_ref = np.asarray(jl.rms_norm(x_ref, params["norm"], CFG.rms_norm_eps))
    h, _, _ = _run_port(setup, cur, lo)
    np.testing.assert_allclose(h, h_ref, atol=HIDDEN_ATOL)


def test_pack_weights_matches_slab_layout(setup):
    """The port's (N, K) matrices hold the TPU slabs' weights, transposed."""
    params, _, packed, _, _, _ = setup
    slabs = np.asarray(pallas_step.pack_step_params(params, CFG)["W"],
                       np.float32)
    D, I = CFG.hidden_size, CFG.intermediate_size
    S = 4 + 3 * (I // D)
    for li in range(L):
        s = slabs[li * S:(li + 1) * S]
        np.testing.assert_array_equal(to_np(packed["wqkv"][li]),
                                      np.concatenate(s[0:3], axis=1).T)
        np.testing.assert_array_equal(to_np(packed["wo"][li]), s[3].T)
        np.testing.assert_array_equal(to_np(packed["wgu"][li]),
                                      np.concatenate(s[4:8], axis=1).T)
        np.testing.assert_array_equal(to_np(packed["wd"][li]),
                                      np.concatenate(s[8:10], axis=0).T)
    assert packed["wqkv"].dtype == torch.bfloat16
    assert packed["ln1"].dtype == torch.float32


def test_wrapper_takes_plain_path_on_cpu_without_counting(setup):
    _, _, packed, kc, vc, emb = setup
    before = k1.decode_step.launches
    _run_port(setup, 5, np.array([0, 0]))
    assert k1.decode_step.launches == before  # counts kernel launches only


def test_wrapper_rejects_other_devices(setup):
    _, _, packed, _, _, _ = setup
    meta = torch.empty((B, CFG.hidden_size), device="meta")
    cache = torch.empty((L, B, T, HD), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k1.decode_step(packed, meta, cache, cache, 3,
                       torch.zeros(B, dtype=torch.long, device="meta"),
                       torch.zeros(B, dtype=torch.long, device="meta"),
                       port_config(CFG))
