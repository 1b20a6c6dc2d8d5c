"""The port's sharded and pipelined training against ``chattts_tpu`` (CPU).

One spawn of 8 gloo CPU ranks (one intra-op thread each) runs every case
(``tests/torch_train_mesh_workers.py``); the JAX references run here, on
the 8 virtual devices of tests/conftest.py, and go to the ranks as tensors
of their numbers.  Every run starts from the same seeded trees (the port's
init, bf16 ``gpt`` matrices) and batch, drawn once with numpy, with rows
left-padded by 3 and 18 (the second past the first sp shard).

(a) ``train.make_train_step(mesh=make_mesh(dp=2, sp=2, tp=2))`` for four
    steps (B 4, T 32; lr 3e-3 after one warmup count, so step 1 moves
    nothing), held to the port's unsharded step and to JAX's step on
    ``make_mesh(dp=2, sp=2, tp=2)`` (tests/test_train.py) with the
    four-step limits of tests/test_torch_train.py: each loss within 5e-4
    relative a step taken; the largest mean gap over a leaf 5e-4; at most
    1e-2 of all elements more than the peak learning rate apart (a
    gradient element near zero may take Adam's step, about lr, the other
    way).  The readings gather every rank's shards.  Against JAX also
    JAX's own rtol 2e-4 on step 1's loss (the initial parameters; its
    test of the sharded step takes one step).  The sharded sums round otherwise
    than the unsharded ones: a rank's products run at its rows, positions,
    heads and columns (wo's and down's contractions split in two f32
    sums), its bf16 weight gradients are its rows' and positions' sums,
    rounded, then summed over dp and sp in bf16, and the clip's norm
    rounds each tp part's sum of squares to bf16 before the parts are
    added over tp (f32), where the unsharded norm rounds each whole leaf's.
(b) ``pipeline.make_pp_forward`` at pp=4, n_micro=3 (4 layers, B 6, T 16,
    a row left-padded by 3) against JAX's, within 0.05 (the bf16
    residual's gap between the frameworks, tests/test_torch_llama.py), and
    equal to the port's unsharded layer stack bit for bit; the round trip
    of ``stack_layers``/``unstack_layers``.
(c) ``pipeline.make_pp_train_step`` at pp=2, n_micro=2 (4 layers, B 4, T
    24) for four steps against JAX's and against the port's unsharded
    step, with (a)'s limits; each rank's hand-offs in GPipe's order;
    ``pp_loss_fn`` on every stage equal to the step's first loss (1e-6
    relative: the same products) and within 2e-4 of JAX's.
(d) Faults planted in the ranks' steps, which the limits of (a) and (c)
    must reject (at least one reading past its limit): dp gradients not
    summed; the "copy onto tp" backward left out; the sp gather's backward
    not summed; the pp embedding tables' gradient not shared.

Also the three differentiable collectives against their definitions on
the 8 ranks, and the checks that need no process group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from chattts_tpu import train as jt
from chattts_tpu.parallel import mesh as jmesh
from chattts_tpu.parallel import pipeline as jpl
from chattts_tpu_torch import train as tt
from chattts_tpu_torch.models import embed as tembed
from chattts_tpu_torch.models import llama as tllama
from chattts_tpu_torch.parallel import comm
from chattts_tpu_torch.parallel import mesh as tmesh
from chattts_tpu_torch.parallel import pipeline as tpl
from torch_port_utils import bridge, port_config, to_np
from torch_train_mesh_workers import (LR, MESH_FAULTS, PP_FAULTS, WARMUP,
                                      train_mesh_rank)

STEPS = 4
LOSS_RTOL, PARAM_MEAN, PARAM_SHARE = 5e-4, 5e-4, 1e-2
JAX_LOSS_RTOL = 2e-4
PP_FORWARD_ATOL = 0.05
MESH = dict(dp=2, sp=2, tp=2)


def _params(cfg, seed=0):
    """Seeded (gpt, embed) JAX trees drawn by the port's init (matrices
    bf16, norms and embed f32)."""
    gen = torch.Generator().manual_seed(seed)
    pcfg = port_config(cfg)
    gpt, emb = (tllama.init_params(gen, pcfg, dtype=torch.float32),
                tembed.init_params(gen, pcfg))
    gpt = jax.tree.map(lambda t: jnp.asarray(
        t.numpy(), jnp.bfloat16 if t.ndim > 1 else jnp.float32), gpt)
    return gpt, jax.tree.map(lambda t: jnp.asarray(t.numpy()), emb)


def _batch(cfg, B, T, pads, seed=2):
    rng = np.random.default_rng(seed)
    shape = (B, T, cfg.num_vq)
    text_mask = np.broadcast_to(np.arange(T) < T // 2, (B, T))
    ids = np.where(text_mask[..., None],
                   rng.integers(0, cfg.num_text_tokens, shape),
                   rng.integers(0, cfg.num_audio_tokens - 1, shape))
    am = np.ones((B, T), bool)
    for row, n in pads.items():
        am[row, :n] = False
    return jt.TrainBatch(jnp.asarray(ids, jnp.int32), jnp.asarray(am),
                         jnp.asarray(text_mask))


def _tbatch(b) -> tt.TrainBatch:
    return tt.TrainBatch(*(torch.from_numpy(np.array(x)) for x in b))


def _jax_steps(step, state, batch, mesh=None):
    """JAX's steps: (losses, final (gpt, embed) as tensors)."""
    losses = []
    for _ in range(STEPS):
        if mesh is None:
            state, m = step(state, batch)
        else:
            with mesh:
                state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, bridge((state.gpt, state.embed))


def _port_steps(cfg, gpt, emb, batch):
    """The port's unsharded steps: (losses, final (gpt, embed))."""
    opt = tt.make_optimizer(lr=LR, warmup=WARMUP)
    state = tt.TrainState(gpt, emb, opt.init((gpt, emb)),
                          torch.zeros((), dtype=torch.int64))
    step = tt.make_train_step(cfg, opt)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, (state.gpt, state.embed)


@pytest.fixture(scope="module")
def runs(tiny_config):
    cfg = tiny_config.gpt
    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    opt = jt.make_optimizer(lr=LR, warmup=WARMUP)
    out = {"cfg": cfg, "cfg4": cfg4}

    # (a) JAX's dp x sp x tp step, the port's unsharded step (the trees
    # bridged first: JAX's step donates its state's buffers)
    gpt, emb = _params(cfg)
    tgpt, temb = bridge(gpt), bridge(emb)
    batch = _batch(cfg, 4, 32, {1: 3, 3: 18})
    jm = jmesh.make_mesh(devices=jax.devices()[:8], **MESH)
    gs = jmesh.shard_params(gpt, jmesh.gpt_param_specs(cfg), jm)
    es = jmesh.shard_params(emb, jmesh.embed_param_specs(cfg), jm)
    state = jt.TrainState(gs, es, opt.init((gs, es)), jnp.int32(0))
    bs = jmesh.shard_params(batch, jmesh.train_batch_specs(), jm)
    out["jax"] = _jax_steps(jt.make_train_step(cfg, opt), state, bs, jm)
    out["port"] = _port_steps(port_config(cfg), tgpt, temb, _tbatch(batch))

    # (b) JAX's pp forward
    gpt4, emb4 = _params(cfg4, seed=1)
    tgpt4, temb4 = bridge(gpt4), bridge(emb4)
    out["gpt4"] = jax.tree.map(np.asarray, gpt4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 16, cfg.hidden_size)).astype(np.float32)
    am = np.ones((6, 16), bool)
    am[1, :3] = False
    pos = np.maximum(np.cumsum(am, axis=1) - 1, 0).astype(np.int32)
    pm4 = jpl.make_pp_mesh(4, devices=jax.devices()[:4])
    stacked = jax.device_put(jpl.stack_layers(gpt4["layers"]),
                             NamedSharding(pm4, P("pp")))
    jfwd = jax.jit(jpl.make_pp_forward(cfg4, pm4, n_micro=3))
    out["pp_fwd"] = np.asarray(jfwd(stacked, jnp.asarray(x), jnp.asarray(am),
                                    jnp.asarray(pos)), np.float32)

    # (c) JAX's pp=2 step, the port's unsharded step at 4 layers
    pbatch = _batch(cfg4, 4, 24, {1: 3}, seed=3)
    pm2 = jpl.make_pp_mesh(2, devices=jax.devices()[:2])
    gpp = {"stacked": jax.device_put(jpl.stack_layers(gpt4["layers"]),
                                     NamedSharding(pm2, P("pp"))),
           "norm": gpt4["norm"]}
    state = jt.TrainState(gpp, emb4, opt.init((gpp, emb4)), jnp.int32(0))
    out["pp_jax"] = _jax_steps(jpl.make_pp_train_step(cfg4, opt, pm2, 2),
                               state, pbatch)
    out["pp_port"] = _port_steps(port_config(cfg4), tgpt4, temb4,
                                 _tbatch(pbatch))

    pcfg, pcfg4 = port_config(cfg), port_config(cfg4)
    mesh_job = dict(kind="mesh", cfg=pcfg, gpt=tgpt, embed=temb,
                    batch=_tbatch(batch), steps=STEPS, **MESH)
    pp_job = dict(kind="pp_train", cfg=pcfg4, pp=2, n_micro=2,
                  gpt=tgpt4, embed=temb4, batch=_tbatch(pbatch),
                  steps=STEPS)
    jobs = ([mesh_job] + [dict(mesh_job, fault=f) for f in MESH_FAULTS]
            + [dict(kind="pp_forward", cfg=pcfg4, pp=4, n_micro=3,
                    gpt=tgpt4, emb=torch.from_numpy(x),
                    attn=torch.from_numpy(am),
                    positions=torch.from_numpy(pos).long()),
               pp_job] + [dict(pp_job, fault=f) for f in PP_FAULTS]
            + [dict(kind="collectives")])
    ranks = comm.spawn(train_mesh_rank, 8, (jobs,), backend="gloo",
                       threads=1)
    names = (["mesh"] + list(MESH_FAULTS) + ["pp_forward", "pp"]
             + list(PP_FAULTS) + ["collectives"])
    out["ranks"] = {name: [r[i] for r in ranks]
                    for i, name in enumerate(names)}
    out["x"], out["am"], out["pos"] = x, am, pos
    return out


def _peak_lr():
    sched = tt.make_optimizer(lr=LR, warmup=WARMUP).schedule
    return max(float(sched(torch.tensor(i, dtype=torch.int32)))
               for i in range(STEPS))


def _readings(losses, ref_losses, pairs):
    """(loss gap / reference loss / steps taken, largest leaf mean gap,
    share of elements more than the peak learning rate apart) over
    ``pairs`` of (got, want) arrays."""
    loss = max(abs(a - r) / ((1 + i) * abs(r))
               for i, (a, r) in enumerate(zip(losses, ref_losses)))
    gaps = [np.abs(got - want) for got, want in pairs]
    lr = _peak_lr()
    share = sum(int((d > lr).sum()) for d in gaps) / sum(d.size for d in gaps)
    return loss, max(float(d.mean()) for d in gaps), share


def _within(r):
    return r[0] <= LOSS_RTOL and r[1] <= PARAM_MEAN and r[2] <= PARAM_SHARE


def _mesh_readings(runs, name, ref):
    """Readings of a dp x sp x tp run (every rank's shards) against a
    reference (losses, final (gpt, embed) tree of tensors)."""
    cfg = port_config(runs["cfg"])
    specs = (tmesh.gpt_param_specs(cfg), tmesh.embed_param_specs(cfg))
    desc = tmesh.make_mesh(ranks=range(8), **MESH)
    ref_losses, tree = ref
    pairs = []
    for r in runs["ranks"][name]:
        want = tt.tree_leaves(tmesh.shard_params(tree, specs, desc,
                                                 coords=r["coords"]))
        pairs += [(g, to_np(w)) for g, w in zip(r["leaves"], want)]
    losses = runs["ranks"][name][0]["losses"]
    assert all(r["losses"] == losses for r in runs["ranks"][name])
    return _readings(losses, ref_losses, pairs)


def _pp_readings(runs, name, ref):
    """Readings of a pp=2 run (both stages' trees) against a reference
    (losses, final ({"stacked" or "layers", "norm"}, embed))."""
    ref_losses, (gpt, emb) = ref
    stacked = (gpt["stacked"] if "stacked" in gpt
               else tpl.stack_layers(gpt["layers"]))
    n = tt.tree_leaves(stacked)[0].shape[0] // 2
    pairs = []
    for r in runs["ranks"][name][:2]:
        s = r["stage"]
        stage = tt.map_tree(lambda x: x[s * n:(s + 1) * n], stacked)
        want = tt.tree_leaves(({"norm": gpt["norm"], "stacked": stage}, emb))
        pairs += [(g, to_np(w)) for g, w in zip(r["leaves"], want)]
    losses = runs["ranks"][name][0]["losses"]
    assert runs["ranks"][name][1]["losses"] == losses
    assert all(r is None for r in runs["ranks"][name][2:])
    return _readings(losses, ref_losses, pairs)


def test_sharded_step_matches_the_unsharded_port_step(runs):
    r = _mesh_readings(runs, "mesh", runs["port"])
    print(f"dp2 x sp2 x tp2 against the port's unsharded step: {r}")
    assert _within(r), r
    assert runs["ranks"]["mesh"][0]["losses"][0] == pytest.approx(
        runs["port"][0][0], rel=1e-6)


def test_sharded_step_matches_the_jax_sharded_step(runs):
    r = _mesh_readings(runs, "mesh", runs["jax"])
    print(f"dp2 x sp2 x tp2 against JAX's dp2 x sp2 x tp2 step: {r}")
    assert _within(r), r
    # step 1's loss (the initial parameters), as JAX's own test holds it
    np.testing.assert_allclose(runs["ranks"]["mesh"][0]["losses"][0],
                               runs["jax"][0][0], rtol=JAX_LOSS_RTOL)


@pytest.mark.parametrize("fault", MESH_FAULTS)
def test_sharded_step_check_rejects_a_planted_fault(runs, fault):
    for ref, what in ((runs["port"], "port"),
                      (runs["jax"], "JAX")):
        r = _mesh_readings(runs, fault, ref)
        print(f"{fault} against the {what} step: {r}")
        assert not _within(r), (what, r)


def test_pp_forward_matches_jax(runs):
    cfg4 = port_config(runs["cfg4"])
    got = runs["ranks"]["pp_forward"]
    assert all(g is None for g in got[4:])
    for g in got[1:4]:  # every stage holds the last stage's output
        np.testing.assert_array_equal(g["hidden"], got[0]["hidden"])
    hidden = got[0]["hidden"]
    err = float(np.abs(hidden - runs["pp_fwd"]).max())
    print(f"pp=4 forward against JAX's: max-abs {err:.3e}")
    assert err <= PP_FORWARD_ATOL, err
    # the port's unsharded layer stack on the same inputs
    gpt = bridge(runs["gpt4"])
    am = torch.from_numpy(runs["am"])
    pos = torch.from_numpy(runs["pos"]).long()
    cos_t, sin_t = tllama.rope_tables_torch(cfg4, am.device)
    x = torch.from_numpy(runs["x"]).to(torch.bfloat16)
    with torch.no_grad():
        for lp in gpt["layers"]:
            x, _, _ = tllama.prefill_block(lp, x, tllama.prefill_bias(am),
                                           cos_t[pos], sin_t[pos], cfg4)
    np.testing.assert_array_equal(hidden, to_np(x))


def test_stack_unstack_round_trip(runs):
    layers = bridge(runs["gpt4"])["layers"]
    stacked = tpl.stack_layers(layers)
    assert tt.tree_leaves(stacked)[0].shape[0] == len(layers)
    back = tpl.unstack_layers(stacked, len(layers))
    for a, b in zip(tt.tree_leaves(back), tt.tree_leaves(layers)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jstacked = jpl.stack_layers(runs["gpt4"]["layers"])
    for a, b in zip(tt.tree_leaves(stacked), jax.tree.leaves(jstacked)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b, np.float32))


def test_pp_train_step_matches_jax(runs):
    r = _pp_readings(runs, "pp", runs["pp_jax"])
    print(f"pp=2 against JAX's pp=2 step: {r}")
    assert _within(r), r
    np.testing.assert_allclose(runs["ranks"]["pp"][0]["losses"][0],
                               runs["pp_jax"][0][0], rtol=JAX_LOSS_RTOL)


def test_pp_train_step_matches_the_unsharded_port_step(runs):
    r = _pp_readings(runs, "pp", runs["pp_port"])
    print(f"pp=2 against the port's unsharded step: {r}")
    assert _within(r), r


def test_pp_loss_fn_is_the_step_loss(runs):
    """``pp_loss_fn`` through ``make_pp_forward`` on every stage: the pp
    step's first loss (the same products), within JAX_LOSS_RTOL of JAX's."""
    for r in runs["ranks"]["pp"][:2]:
        assert r["loss_fn"] == pytest.approx(r["losses"][0], rel=1e-6)
        assert r["loss_fn"] == pytest.approx(runs["pp_jax"][0][0],
                                             rel=JAX_LOSS_RTOL)


def test_pp_hand_offs_run_in_gpipe_order(runs):
    """One step's hand-offs on each stage: every microbatch forward, then
    every backward, in the order the code fixes."""
    first, last = runs["ranks"]["pp"][:2]
    assert (first["stage"], last["stage"]) == (0, 1)
    assert first["events"] == ["send"] * 2 + ["recv_back"] * 2
    assert last["events"] == ["recv"] * 2 + ["send_back"] * 2


@pytest.mark.parametrize("fault", PP_FAULTS)
def test_pp_check_rejects_a_planted_fault(runs, fault):
    for ref, what in ((runs["pp_port"], "port"),
                      (runs["pp_jax"], "JAX")):
        r = _pp_readings(runs, fault, ref)
        print(f"{fault} against the {what} step: {r}")
        assert not _within(r), (what, r)


def test_differentiable_collectives_on_eight_ranks(runs):
    n = 8
    xs = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(n)]
    ws = {}
    for r, got in enumerate(runs["ranks"]["collectives"]):
        for name, (y, g) in got.items():
            w = r + 1 + np.arange(y.size, dtype=np.float64).reshape(y.shape)
            ws.setdefault(name, []).append(w)
    for r, got in enumerate(runs["ranks"]["collectives"]):
        y, g = got["reduce"]  # sum; backward the identity
        np.testing.assert_array_equal(y, sum(xs))
        np.testing.assert_array_equal(g, ws["reduce"][r])
        y, g = got["copy"]  # identity; backward the sum
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_array_equal(g, sum(ws["copy"]))
        y, g = got["gather"]  # concatenated; backward the sum's slice
        np.testing.assert_array_equal(y, np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(g, sum(ws["gather"])[:, 3 * r:3 * r + 3])


def test_in_place_reduce_refuses_a_tensor_that_needs_a_gradient():
    a = torch.randn(2, 3, 4, requires_grad=True)
    w = torch.randn(4, 5)
    with pytest.raises(RuntimeError, match="gradient"):
        tllama._project(a, w, lambda t: t)
    with torch.no_grad():  # serving's form is unchanged
        out = tllama._project(a, w, lambda t: t.mul_(2))
    torch.testing.assert_close(out, 2 * (a.detach() @ w))


def test_prefill_bias_rows_at_an_offset():
    am = torch.ones(2, 12, dtype=torch.bool)
    am[1, :5] = False
    whole = tllama.prefill_bias(am)
    for start in (0, 4, 8):
        torch.testing.assert_close(tllama.prefill_bias(am, start, 4),
                                   whole[:, :, start:start + 4], rtol=0,
                                   atol=0)


def test_one_rank_mesh_is_the_unsharded_step(tiny_config):
    """A mesh of one rank without a process group: the sharded step's
    code path, bit for bit the unsharded step."""
    cfg = port_config(tiny_config.gpt)
    gpt, emb = bridge(_params(tiny_config.gpt))
    batch = _tbatch(_batch(tiny_config.gpt, 2, 16, {1: 3}))
    opt = tt.make_optimizer(lr=LR, warmup=WARMUP)
    states = []
    for mesh in (None, tmesh.make_mesh()):
        state = tt.TrainState(gpt, emb, opt.init((gpt, emb)),
                              torch.zeros((), dtype=torch.int64))
        step = tt.make_train_step(cfg, opt, mesh)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"])
        states.append((losses, state))
    (la, a), (lb, b) = states
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for x, y in zip(tt.tree_leaves(a), tt.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_shapes_a_mesh_does_not_divide_are_refused(tiny_config):
    cfg = port_config(tiny_config.gpt)
    batch = _tbatch(_batch(tiny_config.gpt, 4, 30, {}))
    mesh = tmesh.make_mesh(dp=2, sp=4, tp=1, ranks=range(8))
    with pytest.raises(ValueError):  # T 30 over sp 4
        tmesh.shard_params(batch, tmesh.train_batch_specs(), mesh,
                           coords=(0, 0, 0))
    with pytest.raises(ValueError):  # 2 layers over 4 stages
        tpl.make_pp_forward(cfg, tpl.PPMesh(np.arange(4), 0, None, []), 1)
