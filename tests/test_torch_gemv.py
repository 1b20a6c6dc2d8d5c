"""The decode step's gemv on its own, on the CPU: ``gemv_plain`` against the
JAX package, and the one-gemv wrapper ``decode_step.gemv``.

The reference multiplies the same way inside its kernel
(``chattts_tpu/ops/pallas_step.py``): the input rows through ``_rms`` (or
``jax.nn.silu(gate) * up``, or as they are), rounded to bf16, then
``lax.dot_general`` on bf16 with f32 accumulation.  Inputs are made with
numpy from a seed and handed to both.  Both sides round the same f32 inputs
to bf16 and sum exact products in f32, in other orders: rtol 1e-5 with an
atol of 1e-5 of the output's largest magnitude (a sum that cancels to near
zero keeps the absolute error of its terms).  The quantized tiers are held
against the reference through ``tests/test_torch_decode_step_tiers.py``;
here they are held to an f64 sum of the same integers and scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from chattts_tpu.ops import pallas_step
from chattts_tpu_torch.ops import decode_step as ds

EPS = 1e-6
MODES = {"none": ds.GEMV_NONE, "rms": ds.GEMV_RMS, "silu": ds.GEMV_SILU}


def _inputs(B, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 2 * K)).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    w = (0.05 * rng.standard_normal((N, K))).astype(np.float32)
    out = rng.standard_normal((B, N)).astype(np.float32)
    return x, lnw, w, out


def _jax_gemv(x, lnw, w_nk, out, mode, add):
    """The reference's arithmetic on bf16 weights (N, K) f32 values."""
    K = w_nk.shape[1]
    xj = jnp.asarray(x)
    if mode == "rms":
        a = pallas_step._rms(xj[:, :K], jnp.asarray(lnw), EPS)
    elif mode == "silu":
        a = jax.nn.silu(xj[:, :K]) * xj[:, K:]
    else:
        a = xj[:, :K]
    w_kn = jnp.asarray(w_nk.T).astype(jnp.bfloat16)
    y = lax.dot_general(a.astype(jnp.bfloat16), w_kn,
                        (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
    return np.asarray(jnp.asarray(out) + y if add else y)


def _port_args(x, lnw, w, out, mode):
    K = w.shape[1]
    xt = torch.from_numpy(x if mode == "silu" else x[:, :K].copy())
    return (xt, torch.from_numpy(lnw), torch.from_numpy(w).bfloat16(),
            torch.from_numpy(out))


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("B,K,N", [(1, 64, 24), (5, 96, 40), (8, 200, 72)])
def test_gemv_plain_matches_the_reference(mode, add, B, K, N):
    x, lnw, w, out = _inputs(B, K, N, seed=B + K)
    want = _jax_gemv(x, lnw, w, out, mode, add)
    xt, lt, wt, ot = _port_args(x, lnw, w, out, mode)
    got = ds.gemv_plain(xt, lt, wt, None, 0, ot, MODES[mode], add,
                        EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gemv_on_cpu_tensors_takes_the_plain_version(mode):
    """The wrapper writes gemv_plain's result into ``out`` for CPU tensors
    and launches nothing."""
    x, lnw, w, out = _inputs(3, 64, 16)
    xt, lt, wt, ot = _port_args(x, lnw, w, out, mode)
    before = ds.decode_step.gemv_launches
    for add in (False, True):
        o = ot.clone()
        want = ds.gemv_plain(xt, lt, wt, None, 0, o, MODES[mode], add, EPS)
        assert ds.gemv(xt, lt, wt, None, 0, o, MODES[mode], add, EPS) is o
        assert torch.equal(o, want)
    assert ds.decode_step.gemv_launches == before


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_gemv_plain_is_the_groups_scaled_sums(bits):
    """int8 and int4 weights: each group's sum of bf16 inputs times the
    integers, times the group's scale, against the same in f64."""
    B, K, N, group = 4, 128, 24, 32
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-7, 8, (N, K)).astype(np.int8))
    w = ds.pack_nibbles(q) if bits == 4 else q
    scale = torch.from_numpy(rng.uniform(0.01, 0.1, (N, K // group))
                             .astype(np.float32))
    out = torch.zeros((B, N))
    got = ds.gemv_plain(x, None, w, scale, group, out, ds.GEMV_NONE, False)
    xb = ds._bf(x).double().reshape(B, K // group, group)
    want = torch.einsum("bgk,ngk,ng->bn", xb,
                        q.double().reshape(N, K // group, group),
                        scale.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    assert bool((ds.gemv_tolerance(x, None, w, scale, group, out,
                                   ds.GEMV_NONE, False)
                 >= (got.double() - want).abs()).all())


def test_gemv_tolerance_holds_the_plain_version_to_an_f64_sum():
    """The stated bound covers the plain version's own f32 error, and a
    planted fault (one 32-value step of the weights dropped) exceeds it."""
    x, lnw, w, out = _inputs(8, 256, 48, seed=3)
    xt, lt, wt, ot = _port_args(x, lnw, w, out, "rms")
    got = ds.gemv_plain(xt, lt, wt, None, 0, ot, ds.GEMV_RMS, False, EPS)
    a = ds._bf(ds._rms(xt, lt, EPS)).double()
    exact = a @ wt.double().T
    bound = ds.gemv_tolerance(xt, lt, wt, None, 0, ot, ds.GEMV_RMS, False,
                              EPS)
    assert bool(((got.double() - exact).abs() <= bound).all())
    dropped = wt.clone()
    dropped[:, 64:96] = 0
    bad = ds.gemv_plain(xt, lt, dropped, None, 0, ot, ds.GEMV_RMS, False, EPS)
    assert bool(((bad.double() - got.double()).abs() > bound).any())


def test_gemv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 64))
    w = torch.zeros((16, 64), dtype=torch.bfloat16)
    q = torch.zeros((16, 64), dtype=torch.int8)
    out = torch.zeros((2, 16))
    scale = torch.ones((16, 4))
    with pytest.raises(ValueError, match="group"):    # group % 32 != 0
        ds.gemv(x, None, q, scale, 16, out, ds.GEMV_NONE, False)
    with pytest.raises(ValueError, match="group"):    # K % group != 0
        ds.gemv(x, None, q, torch.ones((16, 1)), 96, out, ds.GEMV_NONE,
                False)
    with pytest.raises(ValueError, match="scale"):
        ds.gemv(x, None, q, None, 32, out, ds.GEMV_NONE, False)
    with pytest.raises(ValueError, match="lnw"):
        ds.gemv(x, None, w, None, 0, out, ds.GEMV_RMS, False)
    with pytest.raises(ValueError, match="mode"):
        ds.gemv(x, None, w, None, 0, out, 3, False)
    with pytest.raises(ValueError, match="out"):
        ds.gemv(x, None, w, None, 0, torch.zeros((2, 8)), ds.GEMV_NONE,
                False)
    with pytest.raises(ValueError, match="rows"):
        ds.gemv(torch.zeros((0, 64)), None, w, None, 0,
                torch.zeros((0, 16)), ds.GEMV_NONE, False)
    # past 64 rows too: the kernel takes its rows in groups of 32
    wide = ds.gemv(torch.ones((65, 64)), None, w, None, 0,
                   torch.ones((65, 16)), ds.GEMV_NONE, False)
    assert torch.equal(wide, torch.zeros((65, 16)))
    with pytest.raises(ValueError, match="K"):        # w of another width
        ds.gemv(x, None, w[:, :32].contiguous(), None, 0, out,
                ds.GEMV_NONE, False)


def _bf16_steps(a, b):
    """|a - b| in bf16 steps, element by element (same signs)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.parametrize("mode", ["rms", "silu"])
@pytest.mark.parametrize("B,K", [(1, 64), (7, 200), (33, 768)])
def test_rows_plain_is_the_prologue_arithmetic(mode, B, K):
    """The bf16 rows the kernel builds once a gemv (``gemv_rows_plain``)
    are the former prologue's: silu rows bit for bit its
    (g / (1 + exp(-g))) * u; rms rows within one bf16 step of ``_rms``
    rounded to bf16 (the squares are summed in the kernel's order), and bit
    for bit where every square and sum is exact in any order."""
    x, lnw, _, _ = _inputs(B, K, 8, seed=B + K)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lnw)
    if mode == "silu":
        g, u = xt[:, :K], xt[:, K:]
        got = ds.gemv_rows_plain(xt, None, ds.GEMV_SILU)
        assert torch.equal(got, ((g / (1 + torch.exp(-g))) * u).bfloat16())
        want = ds._gemv_input(xt, None, ds.GEMV_SILU, EPS).bfloat16()
        assert int(_bf16_steps(got, want).max()) <= 1
        return
    xt = xt[:, :K].contiguous()
    got = ds.gemv_rows_plain(xt, lt, ds.GEMV_RMS, EPS)
    want = ds._bf(ds._rms(xt, lt, EPS)).bfloat16()
    assert got.shape == (B, K) and got.dtype == torch.bfloat16
    assert int(_bf16_steps(got, want).max()) <= 1
    assert int((got != want).sum()) <= max(1, got.numel() // 100)
    small = torch.from_numpy(np.random.default_rng(K).integers(
        -3, 4, (B, K)).astype(np.float32))
    assert torch.equal(ds.gemv_rows_plain(small, lt, ds.GEMV_RMS, EPS),
                       ds._bf(ds._rms(small, lt, EPS)).bfloat16())


def test_rows_plain_of_a_row_does_not_depend_on_the_batch():
    """A row's bf16 rows are its own: rows of a 40-row call equal the same
    rows built alone and among 5, bit for bit."""
    x, lnw, _, _ = _inputs(40, 200, 8, seed=11)
    xt, lt = torch.from_numpy(x[:, :200].copy()), torch.from_numpy(lnw)
    rows = ds.gemv_rows_plain(xt, lt, ds.GEMV_RMS, EPS)
    for sl in (slice(0, 1), slice(31, 32), slice(30, 35), slice(39, 40)):
        assert torch.equal(ds.gemv_rows_plain(xt[sl], lt, ds.GEMV_RMS, EPS),
                           rows[sl])


@pytest.mark.parametrize("epilogue", ["store", "add", "norm", "silu"])
def test_gemv_on_rows_on_cpu_tensors(epilogue):
    """The step's gemv on prepared rows takes the plain version on the CPU
    and launches nothing: ``_mm`` of the rows, then the epilogue's rows
    through ``gemv_rows_plain``; the prepared rows give the same sums as
    ``gemv_plain`` on f32 rows of the same values."""
    B, K, N = 5, 64, 48
    x, lnw, w, out = _inputs(B, K, N, seed=5)
    rows = torch.from_numpy(x[:, :K].copy()).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    ot = torch.from_numpy(out)
    lt = torch.from_numpy(lnw[:1].repeat(N))
    step = ds.decode_step
    before = step.gemv_rows_launches
    y = ds.gemv_plain(rows.float(), None, wt, None, 0, ot, ds.GEMV_NONE,
                      False)
    o = None if epilogue == "silu" else ot.clone()
    got = step.gemv_on_rows(rows, wt, None, 0, o, epilogue, lt, EPS)
    if epilogue == "store":
        assert got is o and torch.equal(o, y)
    elif epilogue == "add":
        assert got is o and torch.equal(o, ot + y)
    elif epilogue == "norm":
        assert torch.equal(o, ot + y)
        assert torch.equal(got, ds.gemv_rows_plain(ot + y, lt, ds.GEMV_RMS,
                                                   EPS))
    else:
        assert torch.equal(got, ds.gemv_rows_plain(y, None, ds.GEMV_SILU))
        assert got.shape == (B, N // 2)
    assert step.gemv_rows_launches == before


def test_rows_entry_on_cpu_and_what_it_does_not_take():
    x, lnw, _, _ = _inputs(3, 64, 8)
    xt, lt = torch.from_numpy(x[:, :64].copy()), torch.from_numpy(lnw)
    before = ds.decode_step.rows_launches
    assert torch.equal(ds.decode_step.rows(xt, lt, ds.GEMV_RMS, EPS),
                       ds.gemv_rows_plain(xt, lt, ds.GEMV_RMS, EPS))
    assert ds.decode_step.rows_launches == before
    with pytest.raises(ValueError, match="mode"):
        ds.decode_step.rows(xt, lt, ds.GEMV_NONE)
    with pytest.raises(ValueError, match="lnw"):
        ds.decode_step.rows(xt, None, ds.GEMV_RMS)
    with pytest.raises(ValueError, match="epilogue"):
        ds.decode_step.gemv_on_rows(xt.bfloat16(), torch.zeros(
            (8, 64), dtype=torch.bfloat16), None, 0, None, "max")
    with pytest.raises(ValueError, match="lnw"):
        ds.decode_step.gemv_on_rows(xt.bfloat16(), torch.zeros(
            (8, 64), dtype=torch.bfloat16), None, 0, torch.zeros((3, 8)),
            "norm")
