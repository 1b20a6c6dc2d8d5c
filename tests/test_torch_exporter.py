"""The port's graph exporter against the JAX package's (CPU, tiny config).

Both exporters write their four graphs; the JAX ``.stablehlo`` and the
port's ``.pt2`` are loaded and called with the same parameters (the JAX
exporter's ``PRNGKey(0..3)`` trees, bridged) and the same seeded inputs.
The transformer stages are bf16 and held as ``test_torch_llama.py`` holds
them (atol 0.05, a few bf16 ulps at 1.0); the heads are f32 products held
as ``test_torch_embed_sampling.py`` holds them (1e-5); the vocoder's wav as
``test_torch_decoder.py`` holds a waveform (1e-3 of its peak).  Each loaded
``.pt2`` is also held to the port's eager function bit for bit.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu_torch.examples import exporter as tex
from chattts_tpu_torch.models import llama as tl
from chattts_tpu_torch.weights import tree_leaves, unflatten
from torch_port_utils import bridge, port_config, to_np

REPO = Path(__file__).resolve().parents[1]
ACT_ATOL = 0.05
HEAD_ATOL = 1e-5
WAV_OF_PEAK = 1e-3
B, T0, NEW = 2, 8, 16
TBUF = T0 + NEW
CURS = (T0 + 3, T0 + 11)  # neither is the traced cur (T0)


@pytest.fixture(scope="module")
def exported(tiny_config, tmp_path_factory):
    """Both exporters' graphs, loaded, and the JAX exporter's trees."""
    torch.set_num_threads(1)
    jdir = tmp_path_factory.mktemp("jax_export")
    tdir = tmp_path_factory.mktemp("torch_export")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CHATTTS_PALLAS_STEP", "0")
        mp.setattr("chattts_tpu.config.Config", lambda: tiny_config)
        import examples.exporter as jex

        jsizes = jex.export_all(str(jdir), batch=B, prompt_len=T0,
                                max_new=NEW)
    pcfg = port_config(tiny_config)
    tsizes = tex.export_all(str(tdir), batch=B, prompt_len=T0, max_new=NEW,
                            device="cpu", config=pcfg)
    from chattts_tpu.models import dvae as jd
    from chattts_tpu.models import embed as je
    from chattts_tpu.models import llama as jl
    from chattts_tpu.models import vocos as jv

    jtrees = {"gp": jl.init_params(jax.random.PRNGKey(0), tiny_config.gpt),
              "ep": je.init_params(jax.random.PRNGKey(1), tiny_config.gpt),
              "dp": jd.init_decoder_params(jax.random.PRNGKey(2),
                                           tiny_config.decoder),
              "vp": jv.init_params(jax.random.PRNGKey(3), tiny_config.vocos)}
    jgraphs = {n: jax.export.deserialize((jdir / f"{n}.stablehlo")
                                         .read_bytes())
               for n in tex.GRAPHS}
    tgraphs = {n: torch.export.load(str(tdir / f"{n}.pt2")).module()
               for n in tex.GRAPHS}
    # the port's layout: a graph takes a dict's leaves in the order of the
    # port's own trees, while a JAX tree's keys come sorted
    like = tex.random_params(pcfg, torch.device("cpu"))
    ttrees = {k: unflatten(like[k], tree_leaves(bridge(v)))
              for k, v in jtrees.items()}
    return dict(cfg=tiny_config, pcfg=pcfg, jsizes=jsizes, tsizes=tsizes,
                tdir=tdir, jtrees=jtrees, ttrees=ttrees, jgraphs=jgraphs,
                tgraphs=tgraphs)


def _params(ex, name, side):
    trees = ex["jtrees" if side == "jax" else "ttrees"]
    return tuple(trees[p] for p in tex.STAGE_PARAMS[name])


def _eager(ex, name):
    return tex.stage_functions(ex["pcfg"], B, T0, NEW)[name]


def _prompt(cfg, seed=4):
    g = cfg.gpt
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, g.num_audio_tokens, (B, T0, g.num_vq))
    tmask = np.zeros((B, T0), bool)
    tmask[:, : T0 // 2] = True  # text first, then codes
    ids[..., 0] = np.where(tmask, rng.integers(0, g.num_text_tokens,
                                               (B, T0)), ids[..., 0])
    attn = np.ones((B, T0), bool)
    attn[1, :3] = False  # left padding
    return ids, attn, tmask


def _cache(cfg, seed):
    g = cfg.gpt
    rng = np.random.default_rng(seed)
    shape = (B, TBUF, g.num_attention_heads, g.head_dim)
    L = g.num_hidden_layers
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(2 * L)]


def _jax_cache(leaves, L):
    from chattts_tpu.models.llama import KVCache

    return KVCache(tuple(jnp.asarray(a, jnp.bfloat16) for a in leaves[:L]),
                   tuple(jnp.asarray(a, jnp.bfloat16) for a in leaves[L:]))


def _torch_cache(leaves, L):
    return tl.KVCache(
        tuple(torch.from_numpy(a).bfloat16() for a in leaves[:L]),
        tuple(torch.from_numpy(a).bfloat16() for a in leaves[L:]))


def _decode_inputs(cfg, cur, seed=5):
    g = cfg.gpt
    rng = np.random.default_rng(seed)
    token = rng.integers(0, g.num_audio_tokens, (B, g.num_vq))
    lo = np.array([0, 5])
    kv = np.arange(TBUF)[None] >= lo[:, None]
    return token, kv, cur - lo


def test_artifacts_are_non_trivial_and_weight_free(exported):
    assert set(exported["tsizes"]) == set(exported["jsizes"]) == set(
        tex.GRAPHS)
    for name, size in exported["tsizes"].items():
        nbytes = sum(t.numel() * t.element_size()
                     for t in torch.utils._pytree.tree_leaves(
                         _params(exported, name, "torch")))
        assert 1000 < size < nbytes / 4, (name, size, nbytes)


def test_heads_match_jax(exported):
    h = np.random.default_rng(1).standard_normal(
        (B, exported["cfg"].gpt.hidden_size)).astype(np.float32)
    ref = np.asarray(exported["jgraphs"]["heads"].call(
        *_params(exported, "heads", "jax"), jnp.asarray(h)))
    args = _params(exported, "heads", "torch") + (torch.from_numpy(h),)
    got = exported["tgraphs"]["heads"](*args)
    assert got.shape == ref.shape == (B, 4, 626)
    np.testing.assert_allclose(to_np(got), ref, atol=HEAD_ATOL)
    assert torch.equal(got, _eager(exported, "heads")(*args))


def test_prefill_matches_jax(exported):
    cfg = exported["cfg"]
    ids, attn, tmask = _prompt(cfg)
    h_ref, c_ref = exported["jgraphs"]["prefill"].call(
        *_params(exported, "prefill", "jax"), jnp.asarray(ids, jnp.int32),
        jnp.asarray(attn), jnp.asarray(tmask))
    args = _params(exported, "prefill", "torch") + (
        torch.from_numpy(ids), torch.from_numpy(attn),
        torch.from_numpy(tmask))
    h_got, c_got = exported["tgraphs"]["prefill"](*args)
    assert isinstance(c_got, tl.KVCache)
    np.testing.assert_allclose(to_np(h_got), np.asarray(h_ref),
                               atol=ACT_ATOL)
    for li in range(cfg.gpt.num_hidden_layers):
        for ref, got in ((c_ref.k[li], c_got.k[li]),
                         (c_ref.v[li], c_got.v[li])):
            assert got.shape == (B, TBUF, 4, 16)
            np.testing.assert_allclose(to_np(got[:, :T0]),
                                       np.asarray(ref[:, :T0], np.float32),
                                       atol=ACT_ATOL)
            assert not got[:, T0:].any() and not np.asarray(ref[:, T0:]).any()
    h_e, c_e = _eager(exported, "prefill")(*args)
    assert torch.equal(h_got, h_e)
    assert all(torch.equal(a, b) for a, b in zip(c_got.k + c_got.v,
                                                 c_e.k + c_e.v))


@pytest.mark.parametrize("cur", CURS)
def test_decode_step_matches_jax_at_any_cur(exported, cur):
    """The loaded step writes row ``cur`` (not the traced row) in the
    returned cache and in the caller's alike, leaves every other row, and
    attends over [lo, cur]."""
    cfg = exported["cfg"]
    L = cfg.gpt.num_hidden_layers
    leaves = _cache(cfg, seed=cur)
    token, kv, pos = _decode_inputs(cfg, cur)
    h_ref, c_ref = exported["jgraphs"]["decode_step"].call(
        *_params(exported, "decode_step", "jax"),
        jnp.asarray(token, jnp.int32), _jax_cache(leaves, L), jnp.int32(cur),
        jnp.asarray(kv), jnp.asarray(pos, jnp.int32))
    mine = _torch_cache(leaves, L)
    before = _torch_cache(leaves, L)
    args = _params(exported, "decode_step", "torch") + (
        torch.from_numpy(token), mine, torch.tensor(cur),
        torch.from_numpy(kv), torch.from_numpy(pos))
    h_got, c_got = exported["tgraphs"]["decode_step"](*args)
    np.testing.assert_allclose(to_np(h_got), np.asarray(h_ref),
                               atol=ACT_ATOL)
    other = np.arange(TBUF) != cur
    for li in range(2 * L):
        ref = np.asarray((c_ref.k + c_ref.v)[li], np.float32)
        got, passed = (c_got.k + c_got.v)[li], (mine.k + mine.v)[li]
        old = (before.k + before.v)[li]
        assert torch.equal(got, passed)  # the caller's cache was written
        assert not torch.equal(got[:, cur], old[:, cur])
        np.testing.assert_allclose(to_np(got[:, cur]), ref[:, cur],
                                   atol=ACT_ATOL)
        assert torch.equal(got[:, other], old[:, other])
        np.testing.assert_array_equal(ref[:, other], to_np(old[:, other]))
    eager = _eager(exported, "decode_step")
    fresh = _torch_cache(leaves, L)
    h_e, c_e = eager(*(args[:3] + (fresh,) + args[4:]))
    assert torch.equal(h_got, h_e)
    assert all(torch.equal(a, b) for a, b in zip(c_got.k + c_got.v,
                                                 c_e.k + c_e.v))


def test_vocoder_matches_jax(exported):
    hid = np.random.default_rng(6).standard_normal(
        (B, 128, exported["cfg"].gpt.hidden_size)).astype(np.float32)
    ref = np.asarray(exported["jgraphs"]["vocoder"].call(
        *_params(exported, "vocoder", "jax"), jnp.asarray(hid)))
    args = _params(exported, "vocoder", "torch") + (torch.from_numpy(hid),)
    got = exported["tgraphs"]["vocoder"](*args)
    assert got.shape == ref.shape == (B, 255 * 256)
    np.testing.assert_allclose(to_np(got), ref,
                               atol=WAV_OF_PEAK * np.abs(ref).max())
    assert torch.equal(got, _eager(exported, "vocoder")(*args))


def test_decode_step_loads_after_importing_only_the_exporter(exported):
    """A fresh interpreter that imports the exporter module alone can load
    ``decode_step.pt2`` (its KVCache is registered on import) and run it:
    the cache comes back a KVCache, row T0 written."""
    script = f"""
import sys, torch
from chattts_tpu_torch.examples import exporter
cfg = eval(sys.argv[2], vars(sys.modules["chattts_tpu_torch.config"]))
step = torch.export.load(sys.argv[1]).module()
p = exporter.random_params(cfg, torch.device("cpu"))
ins = exporter.example_inputs(cfg, {B}, {T0}, {NEW}, torch.device("cpu"))
_, cache = step(p["gp"], p["ep"], *ins["decode_step"])
print(type(cache).__qualname__, bool(cache.k[0][:, {T0}].any()))
"""
    out = subprocess.run(
        [sys.executable, "-c", script, str(exported["tdir"] / "decode_step.pt2"),
         repr(exported["pcfg"])], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["KVCache", "True"]


def test_export_leaves_no_traced_tensor_for_eager_calls(tiny_config):
    """A trace is the first to ask for a config's rope tables: later eager
    calls still get plain tensors, equal to those of a run before the
    export (on a config whose tables agree at these positions), and the
    tables are built once per device."""
    torch.set_num_threads(1)
    g = tiny_config.gpt
    first = port_config(dataclasses.replace(g, max_position_embeddings=320))
    twin = port_config(dataclasses.replace(g, max_position_embeddings=336))
    cfg = dataclasses.replace(port_config(tiny_config), gpt=first)
    params = tex.random_params(cfg, torch.device("cpu"))
    leaves = _cache(tiny_config, seed=7)
    token, kv, pos = _decode_inputs(tiny_config, CURS[0])
    emb = torch.randn((B, g.hidden_size), generator=torch.Generator()
                      .manual_seed(8))

    def step(c):
        return tl.decode_step(params["gp"], emb, _torch_cache(leaves, 2),
                              torch.tensor(CURS[0]), torch.from_numpy(kv),
                              torch.from_numpy(pos), c)

    want, _ = step(twin)
    fns = tex.stage_functions(cfg, B, T0, NEW)
    inputs = tex.example_inputs(cfg, B, T0, NEW, torch.device("cpu"))
    torch.export.export(tex._Stage(fns["decode_step"]),
                        (params["gp"], params["ep"]) + inputs["decode_step"],
                        strict=False)
    cos, sin = tl.rope_tables_torch(first, torch.device("cpu"))
    assert type(cos) is torch.Tensor and type(sin) is torch.Tensor
    assert tl.rope_tables_torch(first, torch.device("cpu"))[0] is cos
    got, cache = step(first)
    assert type(got) is torch.Tensor and type(cache.k[0]) is torch.Tensor
    assert torch.equal(got, want)
