"""The decode step's gemv (``gemv_kernel``, tensor-core mma.sync) alone
against its plain version, on the card.

These tests need a CUDA device and the CUDA toolkit; without a device they
skip.  They import neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gemv_gpu.py

The bound.  Both sides multiply the same bf16 inputs by the same exactly
widened weights and sum in f32, in other orders; the kernel's tensor cores
add with truncation.  ``ops/decode_step.py::gemv_tolerance`` derives, element
by element, (4 K + 64) 2^-24 sum_k |a_k v_k| (a the bf16 input, v the
weight times its group's scale), plus one bf16 ulp of |v_k| for every input
the rms or silu prologue leaves within a relative max(2^-14, 2 K 2^-24) of a
bf16 rounding tie, plus 2^-23 (|out| + |y|) where the gemv adds into out.
Planted faults on the plain side must exceed it: one 32-value step of the
weights dropped, and one group's scales taken from the next group.  A row's
result must not depend on the batch, bit for bit: rows of a 128-row launch
(four row groups of 32) equal the same rows launched at 64 rows and at 1.
"""

import pytest
import torch

from chattts_tpu_torch.ops import decode_step as ds

# the full model's four gemvs (D 768, I 3072): (N, K, prologue, add)
FULL = {"qkv": (2304, 768, ds.GEMV_RMS, False),
        "wo": (768, 768, ds.GEMV_NONE, True),
        "gate/up": (6144, 768, ds.GEMV_RMS, False),
        "down": (768, 3072, ds.GEMV_SILU, True)}
# rows of a scale group: the full model's int8 (D) and int4 groups
FULL_GROUP = {0: 0, 8: 768, 4: 128}
# ragged widths: N not a multiple of 8 columns a tile, K not of 32 (bf16;
# the quantized tiers need K % group == 0, group % 32 == 0)
RAGGED = {0: (400, 200, 0), 8: (400, 192, 64), 4: (400, 192, 32)}
ROWS = [1, 7, 8, 16, 17, 32, 33, 64, 96]
MODES = {"none": ds.GEMV_NONE, "rms": ds.GEMV_RMS, "silu": ds.GEMV_SILU}
TIERS = [0, 8, 4]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, N, K, mode, bits, group, seed=0):
    """Seeded inputs of one gemv: x, lnw, packed weights and scales, out."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, 2 * K if mode == ds.GEMV_SILU else K), generator=gen)
    lnw = 1 + 0.1 * torch.randn((K,), generator=gen)
    w = 0.02 * torch.randn((K, N), generator=gen)
    out = torch.randn((B, N), generator=gen)
    if bits:
        q, scale = ds._quantize_matrix(w, group, bits)
        w = ds.pack_nibbles(q) if bits == 4 else q
    else:
        w, scale = w.T.contiguous().bfloat16(), None
    return [t if t is None else t.to(dev) for t in (x, lnw, w, scale, out)]


def _run(x, lnw, w, scale, out, group, mode, add):
    """Kernel and plain results and the bound, launches counted."""
    o = out.clone()
    before = ds.decode_step.gemv_launches
    ds.gemv(x, lnw, w, scale, group, o, mode, add)
    torch.cuda.synchronize()
    assert ds.decode_step.gemv_launches == before + 1
    want = ds.gemv_plain(x, lnw, w, scale, group, out, mode, add)
    bound = ds.gemv_tolerance(x, lnw, w, scale, group, out, mode, add)
    return o, want, bound


def _reading(got, want, bound):
    """max |got - want| / bound: 1 or less passes."""
    return float(((got.double() - want.double()).abs() / bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("bits", TIERS)
def test_gemv_matches_plain_on_ragged_widths(cuda, bits, mode, add, B):
    N, K, group = RAGGED[bits]
    x, lnw, w, scale, out = _case(cuda, B, N, K, MODES[mode], bits, group,
                                  seed=B)
    got, want, bound = _run(x, lnw, w, scale, out, group, MODES[mode], add)
    assert torch.isfinite(got).all()
    assert _reading(got, want, bound) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("shape", sorted(FULL))
@pytest.mark.parametrize("bits", TIERS)
def test_gemv_matches_plain_at_full_width(cuda, bits, shape, B):
    """The full model's four shapes with the step's own prologue and add."""
    N, K, mode, add = FULL[shape]
    x, lnw, w, scale, out = _case(cuda, B, N, K, mode, bits,
                                  FULL_GROUP[bits], seed=B)
    got, want, bound = _run(x, lnw, w, scale, out, FULL_GROUP[bits], mode,
                            add)
    assert _reading(got, want, bound) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("bits", TIERS)
def test_bound_rejects_a_dropped_step(cuda, bits, B):
    """The plain version without one 32-value step of K (step 5 of down's
    96) differs from the kernel by more than the bound."""
    N, K, mode, add = FULL["down"]
    group = FULL_GROUP[bits]
    x, lnw, w, scale, out = _case(cuda, B, N, K, mode, bits, group)
    got, want, bound = _run(x, lnw, w, scale, out, group, mode, add)
    assert _reading(got, want, bound) <= 1
    dropped = w.clone()
    per = 2 if bits == 4 else 1  # values a byte holds
    dropped[:, 160 // per:192 // per] = 0
    bad = ds.gemv_plain(x, lnw, dropped, scale, group, out, mode, add)
    assert _reading(got, bad, bound) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("bits,shape", [(8, "down"), (4, "qkv"),
                                        (4, "down")])
def test_bound_rejects_a_group_scale_of_the_next_group(cuda, bits, shape):
    """One group's scales taken from the next group (int8: down's 4 groups
    of 768, the only int8 shape of more than one; int4: groups of 128)
    exceed the bound."""
    N, K, mode, add = FULL[shape]
    group = FULL_GROUP[bits]
    x, lnw, w, scale, out = _case(cuda, 16, N, K, mode, bits, group)
    got, want, bound = _run(x, lnw, w, scale, out, group, mode, add)
    assert _reading(got, want, bound) <= 1
    shifted = scale.clone()
    shifted[:, 1] = scale[:, 2]
    bad = ds.gemv_plain(x, lnw, w, shifted, group, out, mode, add)
    assert _reading(got, bad, bound) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("bits", TIERS)
def test_row_result_does_not_depend_on_the_batch(cuda, bits, mode):
    """Rows of a 128-row launch (four row groups of 32) equal the same rows
    launched alone, among 16 and among 64, bit for bit, the 64-row slices
    crossing the group boundaries and the 64-row one."""
    N, K, group = RAGGED[bits]
    x, lnw, w, scale, out = _case(cuda, 128, N, K, MODES[mode], bits, group)

    def run(sl):
        o = out[sl].clone()
        ds.gemv(x[sl].contiguous(), lnw, w, scale, group, o, MODES[mode],
                True)
        torch.cuda.synchronize()
        return o

    y128 = run(slice(0, 128))
    for sl in (slice(0, 1), slice(40, 41), slice(63, 64), slice(64, 65),
               slice(127, 128), slice(0, 16), slice(24, 40), slice(56, 72),
               slice(0, 64), slice(64, 128), slice(17, 81), slice(40, 104)):
        assert torch.equal(run(sl), y128[sl])


@pytest.mark.gpu
def test_gemv_rejects_what_the_kernel_does_not_take(cuda):
    """A geometry the kernel does not take raises before any launch."""
    x, lnw, w, scale, out = _case(cuda, 4, 64, 256, ds.GEMV_NONE, 8, 64)
    before = ds.decode_step.gemv_launches
    with pytest.raises(ValueError, match="group"):
        ds.gemv(x, lnw, w, scale.repeat(1, 4).contiguous(), 16, out,
                ds.GEMV_NONE, False)
    with pytest.raises(ValueError, match="contiguous"):
        ds.gemv(x, lnw, w, scale, 64, out.T.contiguous().T, ds.GEMV_NONE,
                False)
    with pytest.raises(ValueError, match="one device"):
        ds.gemv(x.cpu(), lnw, w, scale, 64, out, ds.GEMV_NONE, False)
    assert ds.decode_step.gemv_launches == before


# the step's prepared rows: rows of every row-group shape, on every tier
PREPARED_ROWS = [1, 8, 16, 33, 64, 96, 128]


def _ulps(a, b):
    """|a - b| in bf16 steps, element by element (same signs)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("B", PREPARED_ROWS)
@pytest.mark.parametrize("bits", TIERS)
def test_prepared_silu_rows_equal_the_prologue_rows(cuda, bits, B):
    """The gate/up gemv's epilogue writes down's bf16 input rows,
    silu(gate) * up, equal bit for bit to the rows that the rows pass (the
    former prologue's arithmetic) and the plain version on the card build
    from the same gemv's f32 sums."""
    N, K, _, _ = FULL["gate/up"]
    group = FULL_GROUP[bits]
    x, lnw, w, scale, _ = _case(cuda, B, N, K, ds.GEMV_RMS, bits, group,
                                seed=B)
    h = ds.decode_step.rows(x, lnw, ds.GEMV_RMS)
    gu = ds.decode_step.gemv_on_rows(h, w, scale, group,
                                     torch.empty((B, N), device=cuda),
                                     "store")
    a = ds.decode_step.gemv_on_rows(h, w, scale, group, None, "silu")
    torch.cuda.synchronize()
    assert a.shape == (B, N // 2) and a.dtype == torch.bfloat16
    assert torch.equal(a, ds.decode_step.rows(gu, None, ds.GEMV_SILU))
    assert torch.equal(a, ds.gemv_rows_plain(gu, None, ds.GEMV_SILU))


@pytest.mark.gpu
@pytest.mark.parametrize("B", PREPARED_ROWS)
@pytest.mark.parametrize("bits", TIERS)
def test_prepared_rms_rows_equal_the_plain_rows(cuda, bits, B):
    """A gemv that adds into the residual (down here) ends with the normed
    bf16 rows of the new residual, built by the last block of each row
    group: equal bit for bit to the plain version that sums the squares in
    the kernel's order, to the rows pass on the same residual, and within
    one bf16 step of the former prologue's arithmetic (``_rms``)."""
    N, K, _, _ = FULL["down"]
    group = FULL_GROUP[bits]
    _, lnw, w, scale, out = _case(cuda, B, N, K, ds.GEMV_NONE, bits, group,
                                  seed=B)
    gen = torch.Generator().manual_seed(B)
    a = torch.randn((B, K), generator=gen).bfloat16().to(cuda)
    lnw = (1 + 0.1 * torch.randn((N,), generator=gen)).to(cuda)
    x = out.clone()
    before = ds.decode_step.gemv_rows_launches
    got = ds.decode_step.gemv_on_rows(a, w, scale, group, x, "norm", lnw)
    torch.cuda.synchronize()
    assert ds.decode_step.gemv_rows_launches == before + 1
    added = ds.decode_step.gemv_on_rows(a, w, scale, group, out.clone(),
                                        "add")
    assert torch.equal(x, added)
    assert torch.equal(got, ds.gemv_rows_plain(x, lnw, ds.GEMV_RMS))
    assert torch.equal(got, ds.decode_step.rows(x, lnw, ds.GEMV_RMS))
    assert int(_ulps(got, ds._rms(x, lnw, 1e-6).bfloat16()).max()) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", ["norm", "silu"])
@pytest.mark.parametrize("bits", TIERS)
def test_prepared_rows_do_not_depend_on_the_batch(cuda, bits, epilogue):
    """Rows built by a 128-row launch (four row groups, four finishers)
    equal the same rows built alone and among 64, bit for bit."""
    N, K, group = RAGGED[bits]
    N = 2 * N if epilogue == "silu" else N
    _, lnw, w, scale, out = _case(cuda, 128, N, K, ds.GEMV_NONE, bits, group)
    gen = torch.Generator().manual_seed(7)
    a = torch.randn((128, K), generator=gen).bfloat16().to(cuda)
    lnw = (1 + 0.1 * torch.randn((N,), generator=gen)).to(cuda)

    def run(sl):
        o = None if epilogue == "silu" else out[sl].clone()
        return ds.decode_step.gemv_on_rows(a[sl].contiguous(), w, scale,
                                           group, o, epilogue, lnw)

    r128 = run(slice(0, 128))
    for sl in (slice(0, 1), slice(63, 64), slice(127, 128), slice(17, 81),
               slice(64, 128)):
        assert torch.equal(run(sl), r128[sl])


@pytest.mark.gpu
def test_one_gemv_entry_counts_its_own_rows(cuda):
    """Every call of the one-gemv entry builds its own rows (a rows pass
    for the rms and silu prologues, f32 rounded as loaded for none)."""
    N, K, group = RAGGED[0]
    step = ds.decode_step
    before = (step.gemv_rebuilt, step.gemv_prepared, step.gemv_launches)
    for mode in MODES.values():
        x, lnw, w, scale, out = _case(cuda, 5, N, K, mode, 0, group)
        ds.gemv(x, lnw, w, scale, group, out, mode, False)
    torch.cuda.synchronize()
    assert (step.gemv_rebuilt, step.gemv_prepared, step.gemv_launches) == (
        before[0] + 3, before[1], before[2] + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("bits", TIERS)
def test_prepared_rms_rows_of_rows_wider_than_a_lane_holds(cuda, bits, B):
    """Rows wider than the finisher keeps in registers (K > 768) take its
    second path, reading the row twice: the same rows, bit for bit, as the
    plain version and the rows pass."""
    N, K, group = 1032, 256, {0: 0, 8: 256, 4: 128}[bits]
    _, _, w, scale, out = _case(cuda, B, N, K, ds.GEMV_NONE, bits, group,
                                seed=B)
    gen = torch.Generator().manual_seed(B)
    a = torch.randn((B, K), generator=gen).bfloat16().to(cuda)
    lnw = (1 + 0.1 * torch.randn((N,), generator=gen)).to(cuda)
    got = ds.decode_step.gemv_on_rows(a, w, scale, group, out, "norm", lnw)
    torch.cuda.synchronize()
    assert torch.equal(got, ds.gemv_rows_plain(out, lnw, ds.GEMV_RMS))
    assert torch.equal(got, ds.decode_step.rows(out, lnw, ds.GEMV_RMS))
