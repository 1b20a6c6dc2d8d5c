"""The port's sharded Engine (``Engine(..., mesh=)``) on one gloo group of
4 CPU processes, against the unsharded port Engine and the JAX
``Engine(mesh=...)`` (CPU).

One spawn runs every sharded case (``tests/torch_mesh_workers.py``; each
rank runs the cases in order, one intra-op thread):

* dp=4, 1 slot a rank, int8 cache, teacher-forced with the unsharded port
  Engine's tokens (run on the same ranks): the same ids, finish reasons,
  order and counters, and bit-equal on every rank.
* dp=2 x tp=2, teacher-forced as tests/test_torch_engine.py forces (the
  forced run's own draws must agree on at least 0.8 of the steps): on the
  bf16 cache against the JAX Engine(mesh=make_mesh(dp=2, tp=2)), the tier
  that engine runs; against the unsharded port Engine on the bf16 cache
  forced alike and on the kv8 cache forced with the unsharded run's own
  tokens.

Every sharded run's hiddens are held within 0.05 (HIDDEN_ATOL of
tests/test_torch_engine.py) of the run they are compared with.  Against
JAX that is a few bf16 ulps of O(1) values between the XLA step and the
kernel's roundings.  Against the unsharded port Engine the products run at
other shapes: a dp rank's prefill and heads at its own batch, a tp rank's
at its heads and its half of the contractions of wo and down (two f32 sums
added, see tests/test_torch_mesh.py).  A row's f32 sums then round in
another order, and where a cached k or v or a prefill output lies near a
bf16 rounding boundary it stores the neighbouring bf16 value, one ulp
(2^-8) of an O(1) value, which the later steps read.  Measured on the CPU:
dp=4 3.6e-7 (no such flip), dp=2 x tp=2 1.7e-3 on the bf16 cache (one
flip in a step's appended row), 4.8e-7 on kv8; against JAX 2.1e-2.

Two dp=2 x tp=2 engines, free-running, give the same ids (seed
determinism) on every rank.  Meshes the engine refuses are checked without
a process group.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chattts_tpu.engine import batching as jb
from chattts_tpu.models import embed as je
from chattts_tpu.models import llama as jl
from chattts_tpu.parallel import mesh as jmesh
from chattts_tpu_torch.engine import batching as tb
from chattts_tpu_torch.models import llama as tl
from chattts_tpu_torch.ops import decode_step as ds
from chattts_tpu_torch.parallel import comm
from chattts_tpu_torch.parallel import mesh as tmesh
from torch_mesh_workers import engine_rank
from torch_port_utils import bridge, port_config

HIDDEN_ATOL = 0.05
EOS_SCALE = 8.0
GEOM = dict(max_num_seqs=4, max_prompt_len=16, max_new_tokens=12,
            chunk_steps=4, chunk_steps_max=4, prompt_buckets=(8, 16))


def _requests(cls, cfg):
    rng = np.random.default_rng(3)
    return [cls(
        request_id=f"m{i}",
        ids=rng.integers(5, 50, (4 + 2 * i, cfg.num_vq)).astype(np.int32),
        text_mask=np.ones((4 + 2 * i,), bool),
        temperature=np.full((cfg.num_vq,), 0.7, np.float32),
        top_p=0.8, top_k=15, repetition_penalty=1.05,
        # request 1 cannot stop on EOS: a length finish among EOS finishes
        min_new=8 if i == 1 else 3 + (i % 3), max_new=6 + i, seed=40 + i)
        for i in range(6)]


def _as_ref(outs):
    return {o.request_id: {"ids": o.ids, "finish_reason": o.finish_reason}
            for o in outs}


@pytest.fixture(scope="module")
def runs(tiny_config):
    cfg = tiny_config.gpt
    gp = jl.init_params(jax.random.PRNGKey(0), cfg)
    ep = je.init_params(jax.random.PRNGKey(1), cfg)
    ep["head_code"] = ep["head_code"].at[
        :, :, cfg.num_audio_tokens - 1].multiply(EOS_SCALE)
    jm = jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    jb._build_kernels.cache_clear()
    try:
        jeng = jb.Engine(cfg, jb.EngineConfig(**GEOM), gp, ep, mesh=jm)
        with jm:
            jouts = jeng.generate(_requests(jb.EngineRequest, cfg))
    finally:
        jb._build_kernels.cache_clear()
    pcfg = port_config(cfg)
    jobs = [dict(mesh=None, kv_bits=8),                  # 0
            dict(mesh=(4, 1), kv_bits=8, ref=0),         # 1
            dict(mesh=None, kv_bits=0, ref=_as_ref(jouts)),   # 2
            dict(mesh=(2, 2), kv_bits=0, ref=_as_ref(jouts)),  # 3
            dict(mesh=(2, 2), kv_bits=8, ref=0),         # 4
            dict(mesh=(2, 2), kv_bits=8),                # 5
            dict(mesh=(2, 2), kv_bits=8)]                # 6
    res = comm.spawn(engine_rank, 4,
                     (pcfg, tb.EngineConfig(**GEOM), bridge(gp), bridge(ep),
                      _requests(tb.EngineRequest, pcfg), jobs),
                     threads=1, timeout_s=300)
    return ({o.request_id: o for o in jouts}, [r["jobs"] for r in res],
            [r["collectives"] for r in res])


def test_collectives_on_every_rank(runs):
    """comm.broadcast from the last rank and a dp gather (an all_reduce of
    zero-padded parts) on the group of 4."""
    for got in runs[2]:
        assert got == {
            "broadcast": [3.0, 3.0],
            "gather": [[float(r), -float(r)] for r in range(4)]}


def _ids_equal(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[k]["ids"], b[k]["ids"]) for k in a)


def _held(got, want, atol):
    assert got["order"] == want["order"] and got["stats"] == want["stats"]
    assert got["agree"] >= 0.8, got["agree"]
    err = 0.0
    for rid, w in want["outs"].items():
        g = got["outs"][rid]
        np.testing.assert_array_equal(g["ids"], w["ids"])
        assert g["finish_reason"] == w["finish_reason"]
        err = max(err, float(np.abs(g["hiddens"] - w["hiddens"]).max()))
    assert err <= atol, err
    return err


def test_dp4_teacher_forced_against_unsharded_on_every_rank(runs):
    _, res, _ = runs
    base = res[0][0]
    assert {o["finish_reason"] for o in base["outs"].values()} == {
        "eos", "length"}
    assert base["stats"]["peak_slots"] == 4 and base["stats"]["prefills"] == 6
    first = res[0][1]
    for rank in res:
        err = _held(rank[1], base, HIDDEN_ATOL)
        for rid, want in first["outs"].items():
            np.testing.assert_array_equal(rank[1]["outs"][rid]["hiddens"],
                                          want["hiddens"])
    print(f"dp=4 hidden max-abs against the unsharded engine {err:.3e}; "
          f"own draws agreeing {first['agree']:.3f}")


def test_dp2_tp2_teacher_forced_against_jax_and_unsharded(runs):
    jouts, res, _ = runs
    jax_run = {"order": list(jouts), "stats": None, "agree": 1.0,
               "outs": {k: {"ids": o.ids, "finish_reason": o.finish_reason,
                            "hiddens": np.asarray(o.host_hiddens())}
                        for k, o in jouts.items()}}
    for rank in res:
        sharded, unsharded = rank[3], rank[2]
        assert sharded["stats"] == unsharded["stats"]
        errs = (_held(dict(sharded, stats=None), jax_run, HIDDEN_ATOL),
                _held(sharded, unsharded, HIDDEN_ATOL),
                # the kv8 cache, forced with the unsharded engine's tokens
                _held(rank[4], rank[0], HIDDEN_ATOL))
        print(f"hidden max-abs: against JAX {errs[0]:.3e}, against the "
              f"unsharded engine bf16 {errs[1]:.3e}, kv8 {errs[2]:.3e}; "
              f"own draws agreeing {sharded['agree']:.3f}, "
              f"{rank[4]['agree']:.3f}")


def test_sharded_engine_seed_deterministic_on_every_rank(runs):
    _, res, _ = runs
    first = res[0][5]["outs"]
    assert any(len(o["ids"]) > 2 for o in first.values())
    for rank in res:
        assert _ids_equal(rank[5]["outs"], first)
        assert _ids_equal(rank[6]["outs"], first)


def _one_rank_mesh(dp, tp):
    """Rank 0 of a dp x tp mesh described without a process group."""
    return tmesh.Mesh(np.arange(dp * tp).reshape(dp, 1, tp), 0, None)


@pytest.mark.parametrize("case", ["slots_not_divisible", "heads_not_divisible",
                                  "kv4_under_tp", "int8_weights_under_tp"])
def test_refused_meshes_raise(tiny_config, case):
    cfg = port_config(tiny_config.gpt)
    ecfg = tb.EngineConfig(**GEOM)
    kw = dict(kv_bits=0)
    mesh = _one_rank_mesh(1, 2)
    if case == "slots_not_divisible":
        ecfg, mesh = dataclasses.replace(ecfg, max_num_seqs=6), \
            _one_rank_mesh(4, 1)
    elif case == "heads_not_divisible":
        cfg = dataclasses.replace(cfg, hidden_size=96, num_attention_heads=6,
                                  intermediate_size=192)
        mesh = _one_rank_mesh(1, 4)
    elif case == "kv4_under_tp":
        kw = dict(kv_bits=4)
    gp = tl.init_params(torch.Generator().manual_seed(0), cfg)
    ep = {"norm": gp["norm"]}
    if case == "int8_weights_under_tp":
        packed = ds.pack_weights(gp, cfg)
        kw["packed"] = {**packed, **{n: packed[n].to(torch.int8)
                                     for n in ds.MATRICES}}
    match = {"slots_not_divisible": "divide dp", "heads_not_divisible":
             "must divide", "kv4_under_tp": "kv4",
             "int8_weights_under_tp": "quantized"}[case]
    with pytest.raises(ValueError, match=match):
        tb.Engine(cfg, ecfg, gp, ep, mesh=mesh, **kw)


def test_state_is_the_shard_of_the_state_specs(tiny_config):
    """A dp=2 x tp=2 rank's SlotState (bf16 cache) has, tensor by tensor,
    the shape of its shard under the engine's state specs."""
    cfg = port_config(tiny_config.gpt)
    ecfg = tb.EngineConfig(**GEOM)
    gp = tl.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = _one_rank_mesh(2, 2)
    sharded = tb.Engine(cfg, ecfg, gp, {}, kv_bits=0, mesh=mesh).state
    whole = tb.SlotState(cfg, ecfg, 0, torch.device("cpu"))
    specs = tb._state_specs(cfg, ecfg)
    assert set(specs) == set(vars(whole))
    for name, placements in specs.items():
        want = tmesh.local_shape(getattr(whole, name).shape, placements, mesh)
        assert tuple(getattr(sharded, name).shape) == want, name
