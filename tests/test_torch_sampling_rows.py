"""Per-row sampling and the engine's per-row noise against JAX (CPU).

``sample`` takes ``top_p``, ``top_k``, ``repetition_penalty``, ``min_new``,
``step`` and ``eos_token`` as scalars or per row, as the reference's does
for continuous batching.  With the reference's per-row keys and its Gumbel
noise handed over, the drawn tokens must be equal (integer comparison).

The noise itself: ``ops/threefry.py`` reproduces the reference's generator.
Keys and random words are integers and must be equal; the Gumbel value
passes through two logarithms, where torch and XLA differ by a few units in
the last place, so the noise is held to rtol 1e-5 and atol 1e-6.  That a
row's noise depends on (seed, attempt, depth, codebook) only follows from
the construction and is shown by permuting and subsetting the rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.engine import batching as jb
from chattts_tpu.ops import sampling as js
from chattts_tpu_torch.ops import sampling as ts
from chattts_tpu_torch.ops import threefry

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5, 2**40 + 3]


def _jax_keys(seeds, attempts):
    return np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(s), a))) for s, a in zip(seeds, attempts)])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("attempt", [0, 1, 3])
def test_host_slot_key_matches_fold_in(seed, attempt):
    got = threefry.host_slot_key(seed, attempt)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jb._host_slot_key(seed, attempt))
    if seed < 2**32:  # without x64, PRNGKey keeps a seed's low word only
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.PRNGKey(seed), attempt)))
        np.testing.assert_array_equal(got, want)


def test_device_fold_in_matches_jax():
    keys = _jax_keys(SEEDS[:5] + [3, 4], [0, 1, 2, 3, 0, 1, 2])
    data = np.array([0, 1, 5, 2047, 31, 2**20, 3], np.int64)
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.wrap_key_data(jnp.asarray(k)), int(d))))
        for k, d in zip(keys, data)])
    got = threefry.fold_in(torch.from_numpy(keys.astype(np.int64)),
                           torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("V", [626, 300, 21178])
def test_gumbel_rows_matches_jax(V):
    keys = _jax_keys(SEEDS[:5], [0, 1, 0, 2, 0])
    kt = torch.from_numpy(keys.astype(np.int64))
    want_bits = np.stack([np.asarray(jax.random.bits(
        jax.random.wrap_key_data(jnp.asarray(k)), (V,), jnp.uint32))
        for k in keys])
    np.testing.assert_array_equal(
        threefry.random_bits_rows(kt, V).numpy().astype(np.uint32), want_bits)
    want = np.stack([np.asarray(jax.random.gumbel(
        jax.random.wrap_key_data(jnp.asarray(k)), (V,), jnp.float32))
        for k in keys])
    got = threefry.gumbel_rows(kt, V).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_row_noise_is_a_function_of_its_own_key_only():
    keys = torch.from_numpy(_jax_keys(range(7), [0] * 7).astype(np.int64))
    depth = torch.tensor([0, 3, 3, 9, 100, 2047, 1])

    def noise(k, d):
        sub = threefry.fold_in(k, d)                       # by depth
        rows = threefry.fold_in(sub.repeat_interleave(4, 0),
                                torch.arange(4).repeat(len(k)))  # codebook
        return threefry.gumbel_rows(rows, 50).reshape(len(k), 4, 50)

    full = noise(keys, depth)
    perm = torch.tensor([4, 0, 6, 2])
    assert torch.equal(noise(keys[perm], depth[perm]), full[perm])
    assert torch.equal(noise(keys[2:3], depth[2:3]), full[2:3])
    # another depth, codebook or seed is another draw
    assert not torch.equal(noise(keys[:1], depth[:1] + 1), full[:1])
    assert not torch.equal(full[0, 0], full[0, 1])
    assert not torch.equal(full[1], full[2])


def _rows_case(name, rng):
    V = 626 if name != "text" else 300
    N = 8
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    case = dict(
        logits=logits,
        temp=rng.uniform(0.2, 1.2, N).astype(np.float32),
        top_p=rng.uniform(0.5, 1.0, N).astype(np.float32),
        top_k=rng.integers(1, 40, N).astype(np.int32),
        rep=rng.choice([1.0, 1.05, 1.3], N).astype(np.float32),
        min_new=rng.integers(0, 6, N).astype(np.int32),
        step=rng.integers(0, 6, N).astype(np.int32),
        eos=np.full(N, V - 1, np.int32), maxpen=V - 1)
    if name == "eos_favourite":   # suppression decides rows with step < min_new
        logits[:, V - 1] = 25.0
    if name == "text":            # per-request EOS ids, everything penalized
        case["eos"] = rng.integers(0, V, N).astype(np.int32)
        case["maxpen"] = V
        logits[np.arange(N), case["eos"]] = 25.0
    return case


@pytest.mark.parametrize("name", ["code", "eos_favourite", "text"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_row_sample_token_exact(name, seed):
    rng = np.random.default_rng(20 + seed)
    c = _rows_case(name, rng)
    N, V = c["logits"].shape
    win = rng.integers(0, V, (N, 16))
    wmask = rng.random((N, 16)) < 0.8
    keys = _jax_keys(range(seed, seed + N), [0] * N)
    ref = js.sample(
        jnp.asarray(keys), jnp.asarray(c["logits"]),
        js.SamplingParams(jnp.asarray(c["temp"]), jnp.asarray(c["top_p"]),
                          jnp.asarray(c["top_k"]), jnp.asarray(c["rep"]),
                          jnp.asarray(c["min_new"])),
        jnp.asarray(win, jnp.int32), jnp.asarray(wmask),
        jnp.asarray(c["step"]), jnp.asarray(c["eos"]), c["maxpen"])
    noise = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        jax.random.wrap_key_data(jnp.asarray(k)), (V,), jnp.float32))
        for k in keys]))
    t = torch.from_numpy
    got = ts.sample(
        t(c["logits"]),
        ts.SamplingParams(t(c["temp"]), t(c["top_p"]), t(c["top_k"]),
                          t(c["rep"]), t(c["min_new"])),
        t(win), t(wmask), t(c["step"]), t(c["eos"]), c["maxpen"],
        noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sup = c["step"] < c["min_new"]
    assert not (got.numpy()[sup] == c["eos"][sup]).any()
    if name != "code":
        assert (got.numpy()[~sup] == c["eos"][~sup]).all()
    # the port's own noise for the same keys draws the same tokens
    own = ts.sample(
        t(c["logits"]),
        ts.SamplingParams(t(c["temp"]), t(c["top_p"]), t(c["top_k"]),
                          t(c["rep"]), t(c["min_new"])),
        t(win), t(wmask), t(c["step"]), t(c["eos"]), c["maxpen"],
        noise=threefry.gumbel_rows(t(keys.astype(np.int64)), V))
    np.testing.assert_array_equal(own.numpy(), np.asarray(ref))


def test_scalar_and_per_row_parameters_agree():
    rng = np.random.default_rng(5)
    N, V = 6, 80
    logits = torch.from_numpy(rng.standard_normal((N, V)).astype(np.float32))
    win = torch.from_numpy(rng.integers(0, V, (N, 16)))
    wmask = torch.from_numpy(rng.random((N, 16)) < 0.7)
    noise = torch.from_numpy(rng.gumbel(size=(N, V)).astype(np.float32))
    temp = torch.full((2,), 0.6)
    scalar = ts.sample(logits, ts.SamplingParams(temp, 0.8, 10, 1.2, 4),
                       win, wmask, 2, 5, V - 1, noise=noise)
    rows = ts.sample(
        logits, ts.SamplingParams(
            temp.repeat(3), torch.full((N,), 0.8), torch.full((N,), 10),
            torch.full((N,), 1.2), torch.full((N,), 4)),
        win, wmask, torch.full((N,), 2), torch.full((N,), 5), V - 1,
        noise=noise)
    assert torch.equal(scalar, rows)
