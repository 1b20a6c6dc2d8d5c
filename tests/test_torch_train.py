"""chattts_tpu_torch.train against chattts_tpu.train (CPU).

Both packages run the same loss, gradients and AdamW chain on the same
parameters and batches, drawn once (torch's seeded init, numpy) and
handed to each (JAX's random ops would compile for every shape; this
file keeps to a few compiles).  Tolerances:

* loss: f32 ``gpt`` leaves 1e-5 relative; bf16 leaves 5e-4 (XLA and torch
  round bf16 activations at other places, a few ulps of 2^-8 each, which
  the mean over positions shrinks);
* gradients, per leaf against its largest value, at the worst element and
  on average: f32 ``gpt`` 5e-3 and 2e-4 (the forward rounds the embedding
  and the first norm's output to bf16 in both packages, so the embedding
  tables' gradients pass a bf16 ulp, 2^-8), bf16 2^-5 and 2^-7, eight and
  two bf16 ulps (a bf16 gradient is a rounding of sums that the two
  packages add in another order);
* the optimizer on identical gradients: bf16 leaves bit for bit (optax's
  order, dtypes and bf16 constants); f32 leaves 1e-5 of the leaf's
  largest update (XLA contracts f32 multiply-adds and sums the global
  norm in another order, an ulp here and there);
* the schedule: 4 f32 ulps of the value or of the peak (XLA's cos, and
  its multiply-adds, are not torch's);
* four whole steps: each loss within 5e-4 relative a step taken; the
  parameters' largest mean gap over a leaf 5e-4, and at most 1e-2 of all
  elements more than the peak learning rate apart (a gradient element
  near zero may take Adam's step, about lr, the other way in one
  package).  Each limit lies between the sound run's reading and those of
  three faults planted in the port's run, which the check must reject:
  half the batch dropped, the moments not carried between steps, the
  gradient negated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chattts_tpu import train as jt
from chattts_tpu_torch import train as tt
from chattts_tpu_torch.models import embed as tembed
from chattts_tpu_torch.models import llama as tllama
from chattts_tpu_torch.utils import checkpoint as tcheckpoint
from chattts_tpu_torch.weights import map_tree
from torch_port_utils import bridge, port_config, to_np

LR, WARMUP = 3e-3, 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny shapes: under the suite's
    parallel workers every worker's torch thread pool oversubscribes the
    cores, and its barriers stalled 0.1 s tests for 10-17 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, B=2, T=16, seed=2):
    """``jt.random_batch``'s structure drawn with numpy (so no JAX random
    op compiles), with row 1 left-padded by 3 (the bias and the valid
    count)."""
    rng = np.random.default_rng(seed)
    shape = (B, T, cfg.num_vq)
    text_mask = np.broadcast_to(np.arange(T) < T // 2, (B, T))
    ids = np.where(text_mask[..., None],
                   rng.integers(0, cfg.num_text_tokens, shape),
                   rng.integers(0, cfg.num_audio_tokens - 1, shape))
    am = np.ones((B, T), bool)
    am[1, :3] = False
    return jt.TrainBatch(jnp.asarray(ids, jnp.int32), jnp.asarray(am),
                         jnp.asarray(text_mask))


def _params(cfg, gpt_dtype=jnp.bfloat16, seed=0):
    """Seeded (gpt, embed) trees, drawn by the port's init (no JAX random
    op compiles), as JAX arrays."""
    gen = torch.Generator().manual_seed(seed)
    pcfg = port_config(cfg)
    trees = (tllama.init_params(gen, pcfg, dtype=torch.float32),
             tembed.init_params(gen, pcfg))
    gpt = jax.tree.map(lambda t: jnp.asarray(
        t.numpy(), gpt_dtype if t.ndim > 1 else jnp.float32), trees[0])
    return gpt, jax.tree.map(lambda t: jnp.asarray(t.numpy()), trees[1])


def _jstate(cfg, opt):
    """``jt.init_train_state``'s state on :func:`_params` trees."""
    gpt, emb = _params(cfg)
    return jt.TrainState(gpt, emb, jax.jit(opt.init)((gpt, emb)),
                         jnp.int32(0))


def _tbatch(b) -> tt.TrainBatch:
    return tt.TrainBatch(*(torch.from_numpy(np.array(x)) for x in b))


def _tstate(js: jt.TrainState) -> tt.TrainState:
    """A JAX train state (optax chain state) -> the port's."""
    adam = js.opt_state[1][0]
    return tt.TrainState(
        bridge(js.gpt), bridge(js.embed),
        tt.AdamWState(torch.from_numpy(np.array(adam.count)),
                      bridge(adam.mu), bridge(adam.nu)),
        torch.tensor(int(js.step), dtype=torch.int64))


def _clone(state):
    return map_tree(torch.clone, state)


CASES = {  # name: (gpt dtype, num_text_tokens)
    # 300 text ids: code ids (to 624) leave the text head's table at code
    # positions; 1000: text ids leave the 626 code entries at text
    # positions (NaN in the reference, discarded)
    "bf16": (jnp.bfloat16, None),
    "f32-text-past-codes": (jnp.float32, 1000),
}


@pytest.fixture(scope="module", params=list(CASES))
def grad_case(request, tiny_config):
    dt, n_text = CASES[request.param]
    cfg = tiny_config.gpt
    if n_text:
        cfg = dataclasses.replace(cfg, num_text_tokens=n_text)
    gp, ep = _params(cfg, dt)
    b = _batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda g, e: jt.loss_fn(g, e, b, cfg), argnums=(0, 1)))(gp, ep)
    params = bridge((gp, ep))
    leaves = tt.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss = tt.loss_fn(params[0], params[1], _tbatch(b), port_config(cfg))
    tgrads = torch.autograd.grad(tloss, leaves)
    return (dt, float(loss), jax.tree.leaves(grads), float(tloss.detach()),
            tgrads)


def test_loss_fn_matches(grad_case):
    dt, loss, _, tloss, _ = grad_case
    assert np.isfinite(loss) and np.isfinite(tloss)
    rtol = 1e-5 if dt == jnp.float32 else 5e-4
    np.testing.assert_allclose(tloss, loss, rtol=rtol)


def test_grads_match_every_leaf(grad_case):
    dt, _, grads, _, tgrads = grad_case
    assert len(grads) == len(tgrads)
    worst, mean = (5e-3, 2e-4) if dt == jnp.float32 else (2.0 ** -5,
                                                          2.0 ** -7)
    for i, (ref, got) in enumerate(zip(grads, tgrads)):
        ref = np.asarray(ref, np.float32)
        got = to_np(got)
        assert np.isfinite(got).all(), i
        scale = np.abs(ref).max()
        d = np.abs(got - ref)
        assert d.max() <= worst * scale, (i, d.max(), scale)
        assert d.mean() <= mean * scale, (i, d.mean(), scale)


def test_optimizer_matches_optax_on_identical_grads(tiny_config):
    """Four updates on the same gradients (seeded, in each leaf's dtype)
    handed to both: count 0's zero update, an unclipped one (norm < 1), a
    clipped one (norm ~ 500) and one more."""
    cfg = tiny_config.gpt
    opt_j = jt.make_optimizer(lr=LR, warmup=WARMUP)
    opt_t = tt.make_optimizer(lr=LR, warmup=WARMUP)
    st = _jstate(cfg, opt_j)
    params = (st.gpt, st.embed)
    rng = np.random.default_rng(3)
    leaves, tree = jax.tree.flatten(params)
    base = [rng.standard_normal(x.shape) * 0.05 for x in leaves]
    update, apply = jax.jit(opt_j.update), jax.jit(optax.apply_updates)
    ostate, tparams = st.opt_state, bridge(params)
    tstate = opt_t.init(tparams)
    norms = []
    for i, scale in enumerate((1.0, 1e-3, 40.0, 1.0)):
        g = jax.tree.unflatten(tree, [
            jnp.asarray(b * scale * (1 + i / 7), x.dtype)
            for b, x in zip(base, leaves)])
        norms.append(float(jax.jit(optax.global_norm)(g)))
        u, ostate = update(g, ostate, params)
        tu, tstate = opt_t.update(bridge(g), tstate, tparams)
        for ref, got, p in zip(jax.tree.leaves(u), tt.tree_leaves(tu),
                               jax.tree.leaves(params)):
            ref, got = np.asarray(ref, np.float32), to_np(got)
            if i == 0:  # the schedule's count-0 learning rate is 0.0
                assert not np.any(ref) and not np.any(got)
            if p.dtype == jnp.bfloat16:
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(
                    got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        params = apply(params, u)
        tparams = tt.apply_updates(tparams, tu)
    assert norms[1] < 1.0 < norms[0] < norms[2]  # both sides of the clip
    adam = ostate[1][0]
    assert int(tstate.count) == int(adam.count) == 4
    for ref, got in zip(jax.tree.leaves((adam.mu, adam.nu)),
                        tt.tree_leaves((tstate.mu, tstate.nu))):
        assert str(got.dtype).endswith(str(ref.dtype))  # moments keep dtype
        if ref.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(to_np(got), np.asarray(ref,
                                                                 np.float32))


@pytest.mark.parametrize("lr,warmup", [(3e-3, 1), (1e-4, 100), (2.5e-4, 333),
                                       (1e-3, 0)])
def test_schedule_matches_optax(lr, warmup):
    counts = np.array([0, 1, 2, 50, warmup - 1, warmup, warmup + 1, 500,
                       1234, 5000, 9876, 9999, 10_000, 10_001, 20_000],
                      np.int32)
    ref = np.asarray(jax.jit(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, 10_000))(jnp.asarray(counts)))
    got = tt.warmup_cosine_decay_schedule(0.0, lr, warmup, 10_000)(
        torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32
    assert got[0] == (np.float32(lr) if warmup == 0 else 0.0)  # init_value
    ulp = 2.0 ** -23  # f32; the ramp's peak - peak * frac cancels to an
    # ulp of the peak, and so does 1 + cos near the end of the decay
    np.testing.assert_allclose(got, ref, rtol=4 * ulp, atol=4 * ulp * lr)
    assert got[-1] == ref[-1] == 0.0  # end_value past decay_steps


# the four-step check's limits, each set between the sound run's reading
# and those of the planted faults below (readings in PERF.md section 6)
LOSS_RTOL, PARAM_MEAN, PARAM_SHARE = 5e-4, 5e-4, 1e-2
FAULTS = ("half the batch dropped", "moments not carried",
          "gradient negated")


@pytest.fixture(scope="module")
def four_steps(tiny_config):
    """The reference's state layout (bf16 ``gpt``) and a batch; JAX's four
    steps from them: (cfg, port state, batch, JAX losses, JAX leaves)."""
    cfg = tiny_config.gpt
    opt_j = jt.make_optimizer(lr=LR, warmup=WARMUP)
    st = _jstate(cfg, opt_j)
    ts = _tstate(st)
    b = _batch(cfg, T=24)
    step_j = jt.make_train_step(cfg, opt_j)
    losses = []
    for _ in range(4):
        st, m = step_j(st, b)
        losses.append(float(m["loss"]))
    return (cfg, ts, b, losses,
            [np.asarray(x, np.float32) for x in jax.tree.leaves(
                (st.gpt, st.embed))])


def _port_four_steps(cfg, state, b, fault=None):
    """The port's four steps, with one of FAULTS planted if asked:
    (losses, final state, the learning rates read)."""
    opt = tt.make_optimizer(lr=LR, warmup=WARMUP)
    if fault == "gradient negated":
        base = opt
        opt = base._replace(update=lambda g, s, p: base.update(
            map_tree(torch.neg, g), s, p))
    batch = _tbatch(b)
    if fault == "half the batch dropped":
        batch = tt.TrainBatch(*(x[:x.shape[0] // 2] for x in batch))
    step = tt.make_train_step(port_config(cfg), opt)
    state, losses, lrs = _clone(state), [], []
    for i in range(4):
        if fault == "moments not carried":
            o = state.opt_state
            state = state._replace(opt_state=o._replace(
                mu=map_tree(torch.zeros_like, o.mu),
                nu=map_tree(torch.zeros_like, o.nu)))
        lrs.append(float(opt.schedule(torch.tensor(i, dtype=torch.int32))))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, state, lrs


def _four_step_readings(four_steps, fault=None):
    """(loss gap / JAX loss / steps taken, largest leaf mean gap, share of
    elements more than the peak learning rate apart) of the port's four
    steps against JAX's."""
    cfg, ts, b, jl, jleaves = four_steps
    tl, ts, lrs = _port_four_steps(cfg, ts, b, fault)
    assert lrs[0] == 0.0 and int(ts.step) == 4
    loss = max(abs(a - r) / ((1 + i) * abs(r))
               for i, (a, r) in enumerate(zip(tl, jl)))
    gaps = [np.abs(to_np(got) - ref) for ref, got in
            zip(jleaves, tt.tree_leaves((ts.gpt, ts.embed)))]
    share = sum(int((d > max(lrs)).sum()) for d in gaps) / sum(
        d.size for d in gaps)
    return loss, max(float(d.mean()) for d in gaps), share


def test_train_step_matches_jax_for_four_steps(four_steps):
    """Losses at each step and the final parameters.  A gradient element
    near zero may take Adam's step the other way in one package, so the
    largest gap alone (about two opposite steps) cannot tell a sound run
    from a faulty one; the share of elements that went apart can."""
    loss, mean, share = _four_step_readings(four_steps)
    print(f"sound: readings {loss:.3e} {mean:.3e} {share:.3e}")
    assert loss <= LOSS_RTOL and mean <= PARAM_MEAN and \
        share <= PARAM_SHARE, (loss, mean, share)


@pytest.mark.parametrize("fault", FAULTS)
def test_four_step_check_rejects_a_planted_fault(four_steps, fault):
    """Each fault, planted in the port's steps, takes every reading of the
    four-step check past its limit."""
    loss, mean, share = _four_step_readings(four_steps, fault)
    print(f"{fault}: readings {loss:.3e} {mean:.3e} {share:.3e}")
    assert loss > LOSS_RTOL and mean > PARAM_MEAN and \
        share > PARAM_SHARE, (loss, mean, share)


def test_first_step_leaves_params_and_input_state_unchanged(tiny_config):
    cfg = port_config(tiny_config.gpt)
    opt = tt.make_optimizer(lr=LR, warmup=WARMUP)
    state = tt.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device="cpu")
    before = _clone(state)
    batch = tt.random_batch(torch.Generator().manual_seed(1), cfg, 2, 16,
                            device="cpu")
    step = tt.make_train_step(cfg, opt)
    s1, _ = step(state, batch)
    s2, _ = step(s1, batch)
    for a, b in zip(tt.tree_leaves(before), tt.tree_leaves(state)):
        assert torch.equal(a, b)  # nothing written in place
    for a, c in zip(tt.tree_leaves((before.gpt, before.embed)),
                    tt.tree_leaves((s1.gpt, s1.embed))):
        assert torch.equal(a, c)  # count 0: learning rate 0
    moved = [not torch.equal(a, c) for a, c in zip(
        tt.tree_leaves((s1.gpt, s1.embed)), tt.tree_leaves((s2.gpt,
                                                             s2.embed)))]
    assert all(moved)


def test_loss_decreases_on_fixed_batch(tiny_config):
    cfg = port_config(tiny_config.gpt)
    opt = tt.make_optimizer(lr=LR, warmup=WARMUP)
    state = tt.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device="cpu")
    step = tt.make_train_step(cfg, opt)
    batch = tt.random_batch(torch.Generator().manual_seed(1), cfg, 2, 24,
                            device="cpu")
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # memorizing a fixed batch


def test_grads_reach_all_params(tiny_config):
    cfg = port_config(tiny_config.gpt)
    gen = torch.Generator().manual_seed(0)
    params = (tllama.init_params(gen, cfg, dtype=torch.float32),
              tembed.init_params(gen, cfg))
    batch = tt.random_batch(torch.Generator().manual_seed(2), cfg, 2, 16,
                            device="cpu")
    leaves = tt.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    grads = torch.autograd.grad(tt.loss_fn(*params, batch, cfg), leaves)
    for g in grads:
        assert torch.isfinite(g).all()
    nonzero = [float(g.abs().max()) > 0 for g in grads]
    assert sum(nonzero) >= len(nonzero) - 1  # text head may miss rare ids


def test_random_batch_shapes_ranges_and_masks(tiny_config):
    cfg = port_config(tiny_config.gpt)
    B, T = 3, 17
    b = tt.random_batch(torch.Generator().manual_seed(0), cfg, B, T,
                        device="cpu")
    assert b.ids.shape == (B, T, cfg.num_vq)
    assert b.attn_mask.shape == b.text_mask.shape == (B, T)
    assert b.attn_mask.dtype == b.text_mask.dtype == torch.bool
    assert bool(b.attn_mask.all())
    want_text = torch.arange(T) < T // 2
    assert torch.equal(b.text_mask, want_text.expand(B, T))
    text, code = b.ids[:, :T // 2], b.ids[:, T // 2:]
    assert int(text.min()) >= 0 and int(text.max()) < cfg.num_text_tokens
    assert int(code.min()) >= 0
    assert int(code.max()) < cfg.num_audio_tokens - 1
    # the text prefix reaches past the code vocabulary (num_text_tokens 300
    # here is below 626, so the reverse: code ids past the text table)
    assert int(code.max()) >= cfg.num_text_tokens
    again = tt.random_batch(torch.Generator().manual_seed(0), cfg, B, T,
                            device="cpu")
    assert torch.equal(again.ids, b.ids)  # seeded


def test_train_state_round_trip(tmp_path, tiny_config):
    cfg = port_config(tiny_config.gpt)
    opt = tt.make_optimizer()
    state = tt.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device="cpu")
    step_fn = tt.make_train_step(cfg, opt)
    batch = tt.random_batch(torch.Generator().manual_seed(1), cfg, 2, 16,
                            device="cpu")
    for _ in range(2):  # a nonzero update, so the moments are not zero
        state, metrics = step_fn(state, batch)
    assert np.isfinite(float(metrics["loss"]))

    path = tcheckpoint.save_train_state(str(tmp_path / "ckpt"), state)
    assert path.endswith("/2")
    template = tt.init_train_state(torch.Generator().manual_seed(2), cfg,
                                   opt, device="cpu")
    restored = tcheckpoint.restore_train_state(path, template)
    assert int(restored.step) == int(state.step) == 2
    assert int(template.step) == 0  # the template is left as it was
    assert type(restored.opt_state) is tt.AdamWState
    for a, b in zip(tt.tree_leaves(state), tt.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # training continues from the restored state exactly as from the original
    s_a, m_a = step_fn(state, batch)
    s_b, m_b = step_fn(restored, batch)
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(tt.tree_leaves(s_a), tt.tree_leaves(s_b)):
        assert torch.equal(a, b)


def test_restore_refuses_a_template_of_another_shape(tmp_path, tiny_config):
    cfg = port_config(tiny_config.gpt)
    opt = tt.make_optimizer()
    state = tt.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device="cpu")
    path = tcheckpoint.save_train_state(str(tmp_path), state, step=7)
    other = dataclasses.replace(cfg, num_hidden_layers=1)
    small = tt.init_train_state(torch.Generator().manual_seed(0), other, opt,
                                device="cpu")
    with pytest.raises(KeyError):
        tcheckpoint.restore_train_state(path, small)
    wide = dataclasses.replace(cfg,
                               intermediate_size=2 * cfg.intermediate_size)
    with pytest.raises(ValueError):
        tcheckpoint.restore_train_state(path, tt.init_train_state(
            torch.Generator().manual_seed(0), wide, opt, device="cpu"))


def test_entry_points_default_to_cuda(tiny_config):
    cfg = port_config(tiny_config.gpt)
    opt = tt.make_optimizer()
    if torch.cuda.is_available():
        state = tt.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    opt)
        assert state.step.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_train_state(torch.Generator().manual_seed(0), cfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.random_batch(torch.Generator().manual_seed(0), cfg, 2, 8)
