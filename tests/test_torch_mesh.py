"""The port's mesh and sharding layouts against ``chattts_tpu.parallel.mesh``
(CPU, no process group).

* ``make_mesh`` validates as the JAX one does.
* The spec trees mirror the PartitionSpec trees leaf for leaf (the
  training batch's too).
* On the 8 virtual CPU devices of tests/conftest.py, at dp=2 x sp=2 x tp=2
  and at dp=4 x tp=2, ``shard_params(..., coords=c)`` equals, bit for bit,
  the ``addressable_shards`` data of the JAX ``shard_params`` for the device
  at coordinate c: every gpt and embed leaf, every decode-state leaf and
  every leaf of a training batch.
* ``shard_packed`` of the packed weights equals the packing of the sharded
  tree.
* The plain tp step (``decode_step_tp`` on CPU tensors: ``decode_step_plain``
  given a rank's heads and the all_reduce) on tp=2 ranks, run as two
  threads whose all_reduce sums the two partials by hand, against
  ``decode_step_plain`` on the whole weights, on the bf16 and kv8
  caches.  The ranks' products split each contraction of wo and down in
  two f32 sums, and the split moves a rounding: a bf16-rounded matmul
  input may land one ulp apart (2^-8 of it), times weights of 0.02 over 2
  layers.  The residual (O(1)) is held to 2e-3, a tenth of the one-ulp
  change of a whole row; measured 1.2e-7 (bf16) and 2.4e-7 (kv8).  An
  appended bf16 row is held within one bf16 ulp; kv8 rows
  compared as values of the rank's heads, at most 1% of them one step
  apart.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from chattts_tpu.models import embed as je
from chattts_tpu.models import llama as jl
from chattts_tpu.parallel import mesh as jmesh
from chattts_tpu.train import TrainBatch as JTrainBatch
from chattts_tpu_torch.ops import decode_step as ds
from chattts_tpu_torch.ops import kv_quant
from chattts_tpu_torch.parallel import mesh as tmesh
from torch_port_utils import bridge, port_config, to_np

TP_ATOL = 2e-3


def test_make_mesh_validation():
    m = tmesh.make_mesh(dp=2, tp=2, sp=2, ranks=range(8))
    assert m.shape == {"dp": 2, "sp": 2, "tp": 2} and m.size == 8
    assert m.coords is None and m.groups is None
    assert tmesh.make_mesh(tp=2, ranks=range(8)).shape["dp"] == 4
    assert tmesh.make_mesh(tp=2, sp=2, ranks=range(8)).shape["dp"] == 2
    one = tmesh.make_mesh()
    assert one.shape == {"dp": 1, "sp": 1, "tp": 1}
    assert one.coords == {"dp": 0, "sp": 0, "tp": 0}
    x = torch.ones(3)
    assert one.all_reduce(x, "dp") is x and torch.equal(one.gather(x, "tp"),
                                                        x[None])
    for kw in (dict(dp=3, tp=2), dict(dp=1, tp=4), dict(tp=3)):
        with pytest.raises(ValueError):
            tmesh.make_mesh(ranks=range(8), **kw)
        with pytest.raises(ValueError):
            jmesh.make_mesh(devices=jax.devices()[:8], **kw)


def _placements(p):
    return tmesh.spec(*tuple(p))


def _same_tree(jtree, ttree):
    """JAX spec tree against the port's, leaf for leaf."""
    if isinstance(jtree, PartitionSpec):
        assert tmesh.is_spec(ttree) and ttree == _placements(jtree)
        return 1
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and set(jtree) == set(ttree)
        return sum(_same_tree(jtree[k], ttree[k]) for k in jtree)
    assert type(jtree) is type(ttree) and len(jtree) == len(ttree)
    return sum(_same_tree(a, b) for a, b in zip(jtree, ttree))


def test_spec_trees_mirror_the_jax_specs(tiny_config):
    cfg = tiny_config.gpt
    pcfg = port_config(cfg)
    n = _same_tree(jmesh.gpt_param_specs(cfg), tmesh.gpt_param_specs(pcfg))
    assert n == 6 * cfg.num_hidden_layers + 1
    assert _same_tree(jmesh.embed_param_specs(cfg),
                      tmesh.embed_param_specs(pcfg)) == 4
    assert _same_tree(jmesh.state_specs(cfg), tmesh.state_specs(pcfg)) \
        == 2 * cfg.num_hidden_layers + 10
    jbatch, tbatch = jmesh.train_batch_specs(), tmesh.train_batch_specs()
    assert jbatch._fields == tbatch._fields  # two TrainBatch classes
    assert sum(_same_tree(a, b) for a, b in zip(jbatch, tbatch)) == 3
    assert tmesh.spec("dp", None, "tp", None) == (
        tmesh.Shard(0), tmesh.Replicate(), tmesh.Shard(2))


def _state_tree(cfg, rng):
    """A decode-state tree of the JAX state_specs' structure, 8 rows."""
    B, T, H, Dh = 8, 16, cfg.num_attention_heads, cfg.head_dim
    L = cfg.num_hidden_layers

    def a(*shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    return {
        "cache": {"k": tuple(a(B, T, H, Dh) for _ in range(L)),
                  "v": tuple(a(B, T, H, Dh) for _ in range(L))},
        "ids": a(B, T, cfg.num_vq), "key_valid": a(B, T), "hidden":
        a(B, cfg.hidden_size), "cur": a(), "pos_next": a(B),
        "finish": a(B), "end_idx": a(B), "hiddens": a(B, 6, cfg.hidden_size),
        "step": a(), "rng": a(2),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("dp,sp,tp", [(2, 2, 2), (4, 1, 2)])
def test_shard_params_matches_addressable_shards(tiny_config, dp, sp, tp):
    cfg = tiny_config.gpt
    pcfg = port_config(cfg)
    jm = jmesh.make_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:8])
    tm = tmesh.make_mesh(dp=dp, tp=tp, sp=sp, ranks=range(8))
    gp = jl.init_params(jax.random.PRNGKey(0), cfg)
    ep = je.init_params(jax.random.PRNGKey(1), cfg)
    state = _state_tree(cfg, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    batch = JTrainBatch(rng.integers(0, 300, (8, 16, cfg.num_vq), np.int32),
                        rng.random((8, 16)) < 0.8, rng.random((8, 16)) < 0.5)
    trees = [(gp, jmesh.gpt_param_specs(cfg), tmesh.gpt_param_specs(pcfg)),
             (ep, jmesh.embed_param_specs(cfg),
              tmesh.embed_param_specs(pcfg)),
             (state, jmesh.state_specs(cfg), tmesh.state_specs(pcfg)),
             (batch, jmesh.train_batch_specs(), tmesh.train_batch_specs())]
    checked = 0
    for tree, jspecs, tspecs in trees:
        jsharded = _leaves(jmesh.shard_params(
            jax.tree.map(jnp.asarray, tree), jspecs, jm))
        full = bridge(tree)
        for coord in np.ndindex(dp, sp, tp):
            device = jm.devices[coord]
            mine = _leaves(tmesh.shard_params(full, tspecs, tm, coords=coord))
            assert len(mine) == len(jsharded)
            for j, t in zip(jsharded, mine):
                want = next(s.data for s in j.addressable_shards
                            if s.device == device)
                assert tuple(t.shape) == tuple(want.shape)
                np.testing.assert_array_equal(
                    to_np(t), np.asarray(want, np.float32))
                checked += 1
    assert checked == 8 * (6 * cfg.num_hidden_layers + 1 + 4
                           + 2 * cfg.num_hidden_layers + 10 + 3)


def test_shard_packed_is_the_packing_of_the_shards(tiny_config):
    """shard_packed(pack_weights(tree)) == pack_weights(shard of the tree)
    at tp=2, every rank, every slab."""
    from types import SimpleNamespace

    from chattts_tpu_torch.models import llama as tl

    cfg = port_config(tiny_config.gpt)
    gp = tl.init_params(torch.Generator().manual_seed(0), cfg)
    packed = ds.pack_weights(gp, cfg)
    tm = tmesh.make_mesh(tp=2, ranks=range(2))
    heads = ds.local_heads(cfg, 2)
    local_cfg = SimpleNamespace(
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size // 2,
        num_attention_heads=heads.num_attention_heads,
        head_dim=heads.head_dim)
    for rank in range(2):
        mine = ds.shard_packed(packed, cfg, 2, rank)
        want = ds.pack_weights(tmesh.shard_params(
            gp, tmesh.gpt_param_specs(cfg), tm, coords=(0, 0, rank)),
            local_cfg)
        assert set(mine) == set(want)
        for name in want:
            assert torch.equal(mine[name], want[name]), name
            assert mine[name].is_contiguous()
    int8 = {**packed, **{n: packed[n].to(torch.int8) for n in ds.MATRICES}}
    assert ds.weight_bits_of(int8, cfg) == 8
    with pytest.raises(ValueError, match="shard"):
        ds.shard_packed(int8, cfg, 2, 0)
    with pytest.raises(ValueError):
        ds.local_heads(cfg, 3)


def _tp_inputs(cfg, kv_bits, B=4, T=24, seed=0):
    """Whole-model inputs of one step: packed weights, emb, f32 cache
    contents (L, B, T, HD) of a past, per-row cur and lo, positions."""
    from chattts_tpu_torch.models import llama as tl

    g = torch.Generator().manual_seed(seed)
    gp = tl.init_params(g, cfg)
    packed = ds.pack_weights(gp, cfg)
    HD = cfg.num_attention_heads * cfg.head_dim
    L = cfg.num_hidden_layers
    emb = torch.randn((B, cfg.hidden_size), generator=g)
    kf = torch.randn((L, B, T, HD), generator=g)
    vf = torch.randn((L, B, T, HD), generator=g)
    cur = torch.tensor([5, 23, 11, 1])[:B]
    lo = torch.tensor([0, 3, 11, 0])[:B]
    return packed, emb, kf, vf, cur, lo, cur - lo


def _caches(kf, vf, kv_bits, heads):
    if kv_bits == 8:
        return (kv_quant.kv8_quantize(kf, heads),
                kv_quant.kv8_quantize(vf, heads))
    return kf.bfloat16(), vf.bfloat16()


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_decode_step_tp_plain_summed_by_hand(tiny_config, kv_bits):
    cfg = port_config(tiny_config.gpt)
    tp = 2
    packed, emb, kf, vf, cur, lo, pos = _tp_inputs(cfg, kv_bits)
    kc, vc = _caches(kf, vf, kv_bits, cfg)
    x_full = ds.decode_step_plain(packed, emb, kc, vc, cur, lo, pos, cfg)

    heads = ds.local_heads(cfg, tp)
    hl = heads.num_attention_heads * heads.head_dim
    barrier = threading.Barrier(tp)
    parts = [None] * tp
    out, caches, errors = [None] * tp, [None] * tp, []

    def reduce_for(rank):
        def all_reduce(t):
            parts[rank] = t.clone()
            barrier.wait(timeout=60)
            total = parts[0] + parts[1]  # rank order, as a sum of two
            barrier.wait(timeout=60)
            t.copy_(total)
            return t
        return all_reduce

    def rank_main(rank):
        try:
            sl = slice(rank * hl, (rank + 1) * hl)
            kr, vr = _caches(kf[..., sl].contiguous(),
                             vf[..., sl].contiguous(), kv_bits, heads)
            mine = ds.shard_packed(packed, cfg, tp, rank)
            out[rank] = ds.decode_step_tp(mine, emb, kr, vr, cur, lo, pos,
                                          cfg, heads, reduce_for(rank))
            caches[rank] = (kr, vr)
        except BaseException as e:  # re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert torch.equal(out[0], out[1])
    err = (out[0] - x_full).abs().max().item()
    print(f"kv_bits={kv_bits}: tp=2 residual against the whole step, "
          f"max-abs {err:.3e}")
    assert err <= TP_ATOL, err
    rows = torch.arange(emb.shape[0])
    for rank, (kr, vr) in enumerate(caches):
        sl = slice(rank * hl, (rank + 1) * hl)
        for mine, whole in ((kr, kc), (vr, vc)):
            got = ds.cache_values(mine[:, rows, cur], heads)
            want = ds.cache_values(whole[:, rows, cur], cfg)[..., sl]
            if kv_bits:
                assert (got != want).float().mean().item() <= 0.01
                assert (got - want).abs().max().item() <= 1
            else:
                torch.testing.assert_close(got, want, atol=0, rtol=2 ** -7)
