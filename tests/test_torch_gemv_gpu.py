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
