"""``chattts_tpu_torch.Chat`` loading an asset tree, against ``chattts_tpu``.

Trees in the reference layout are built here at the tiny config (random
state dicts in the torch formats, as ``test_weight_loading._synth_state``
builds them, written with ``safetensors``; a tokenizer saved by
``BertTokenizerFast``), in float32, float16 and bfloat16.  A synthetic
tree never passes the trusted checksum map, so the leaf comparisons call
``_load_assets`` directly, as the JAX package's tests do; the public path
is driven with the map patched to the tree's own.

* every leaf of the five trees equals the JAX loader's in value, dtype and
  shape (bf16 GPT matrices, float32 norms, the checkpoint's dtype
  elsewhere, the Embed heads' weight norm folded in float64), bf16 leaves
  bit for bit;
* a float32 tree's mel decoder runs in both packages; a float16 or
  bfloat16 one raises in both (float32 activations meet the file's
  weights in the first convolution);
* ``load()`` with no tree warns and draws random weights from ``seed``;
  with a tree the trusted map refuses it returns False and stays unloaded;
  ``coef=`` replaces the coefficients the reference replaces;
* ``unload()`` drops every tree and the packed weights, and a new load
  gives a fresh Chat's outputs.
"""

import logging

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chattts_tpu.core import Chat as JChat
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch import codecs
from chattts_tpu_torch.models.tokenizer import Tokenizer
from chattts_tpu_torch.utils import dl as dl_utils
from torch_port_utils import port_config, write_tiny_tree

TREES = ("gpt_params", "embed_params", "decoder_params", "vocos_params",
         "dvae_params")


@pytest.fixture(scope="module",
                params=[np.float32, np.float16, ml_dtypes.bfloat16],
                ids=["f32", "f16", "bf16"])
def tree(request, tiny_config, tmp_path_factory):
    base = tmp_path_factory.mktemp(f"tree_{np.dtype(request.param).name}")
    write_tiny_tree(str(base), tiny_config, request.param,
                    np.random.default_rng(0))
    return str(base), np.dtype(request.param)


@pytest.fixture(scope="module")
def f32_tree(tiny_config, tmp_path_factory):
    base = tmp_path_factory.mktemp("tree_reload")
    write_tiny_tree(str(base), tiny_config, np.float32,
                    np.random.default_rng(1))
    return str(base)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _assert_same_tree(jtree, ttree, what):
    jf, tf = _flat(jtree), _flat(ttree)
    assert set(jf) == set(tf), what
    for k, j in jf.items():
        t = tf[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", k
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (
            f"{what}/{k}: {t.dtype} vs {j.dtype}")
        assert tuple(t.shape) == tuple(j.shape), f"{what}/{k}"
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(j).view(np.int16), err_msg=f"{what}/{k}")
        np.testing.assert_array_equal(
            t.to(torch.float32).numpy()
            if t.dtype == torch.bfloat16 else t.numpy(),
            np.asarray(jnp.asarray(j, jnp.float32)
                       if str(j.dtype) == "bfloat16" else j),
            err_msg=f"{what}/{k}")


def test_leaves_equal_the_jax_loader(tree, tiny_config):
    base, dtype = tree
    jchat = JChat(config=tiny_config)
    jchat._load_assets(base)
    tchat = TChat(config=port_config(tiny_config))
    tchat._load_assets(base, device="cpu")
    for name in TREES:
        _assert_same_tree(getattr(jchat, name), getattr(tchat, name), name)
    assert str(tchat.embed_params["emb_text"].dtype) == f"torch.{dtype}"
    assert tchat.gpt_params["layers"][0]["attn"]["wqkv"].dtype == torch.bfloat16
    assert tchat.gpt_params["norm"].dtype == torch.float32
    assert tchat.coef == jchat.coef
    # the tokenizer is the tree's, read without transformers
    assert type(tchat.tokenizer._backend).__name__ == "_HFBackend"
    text = ["[Stts][spk_emb][speed_5]Hello, world! 你好[uv_break]"]
    for a, b in zip(tchat.tokenizer.encode(text, 4),
                    jchat.tokenizer.encode(text, 4)):
        np.testing.assert_array_equal(a, b)
    for attr in ("spk_emb_ids", "break_0_ids", "eos_token", "len"):
        assert getattr(tchat.tokenizer, attr) == getattr(jchat.tokenizer,
                                                         attr), attr


def test_mel_decoder_runs_on_the_tree_in_both_or_neither(tree, tiny_config):
    """The same outcome in both packages: a float16 or bfloat16 tree
    raises in the first convolution, where float32 hiddens meet the file's
    weights (ROADMAP "Known differences"); a float32 tree decodes (the
    port's mels finite here; it infers on such a tree in
    test_unload_then_reload_gives_a_fresh_chat)."""
    from chattts_tpu.models import dvae as jdvae
    from chattts_tpu_torch.models import dvae as tdvae

    base, dtype = tree
    tchat = TChat(config=port_config(tiny_config))
    tchat._load_assets(base, device="cpu")
    hid = np.random.default_rng(2).standard_normal(
        (1, 8, tiny_config.gpt.hidden_size)).astype(np.float32)
    if dtype == np.float32:
        got = tdvae.decode_from_hidden(tchat.decoder_params,
                                       torch.from_numpy(hid),
                                       tchat.config.decoder)
        assert got.shape[1] == 16 and torch.isfinite(got).all()
        return
    jchat = JChat(config=tiny_config)
    jchat._load_assets(base)
    with pytest.raises(TypeError, match="same dtypes"):
        jdvae.decode_from_hidden(jchat.decoder_params, jnp.asarray(hid),
                                 tiny_config.decoder)
    with pytest.raises(RuntimeError, match="should be the same"):
        tdvae.decode_from_hidden(tchat.decoder_params, torch.from_numpy(hid),
                                 tchat.config.decoder)


def test_coef_replaces_the_full_dvae_coef(tree, tiny_config):
    base, _ = tree
    coef = codecs.encode_coef(np.linspace(
        0.5, 1.5, tiny_config.dvae.n_mels).astype(np.float32))
    jchat = JChat(config=tiny_config)
    jchat._load_assets(base, coef=coef)
    tchat = TChat(config=port_config(tiny_config))
    tchat._load_assets(base, coef=coef, device="cpu")
    for name in ("dvae_params", "decoder_params"):
        _assert_same_tree(getattr(jchat, name), getattr(tchat, name), name)
    np.testing.assert_array_equal(tchat.dvae_params["coef"].numpy(),
                                  codecs.decode_coef(coef))
    assert tchat.coef == jchat.coef != coef  # the decoder keeps the file's


def test_load_without_a_tree_falls_back_to_random(tiny_config, tmp_path,
                                                 monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CHATTTS_ASSETS", raising=False)
    cfg = port_config(tiny_config)
    chat = TChat(config=cfg)
    with caplog.at_level(logging.WARNING):
        assert chat.load(seed=3, device="cpu") is True
    assert "falling back to random init" in caplog.text
    assert chat.has_loaded()
    ref = TChat(config=cfg)
    ref.load(source="random", seed=3, device="cpu")
    for name in TREES:
        for k, v in _flat(getattr(ref, name)).items():
            assert torch.equal(_flat(getattr(chat, name))[k], v), (name, k)


def test_refused_tree_is_not_loaded(tree, tiny_config, caplog):
    base, _ = tree
    chat = TChat(config=port_config(tiny_config))
    with caplog.at_level(logging.WARNING):
        assert chat.load(source="custom", custom_path=base,
                         device="cpu") is False
    assert "asset verification failed" in caplog.text
    assert not chat.has_loaded()
    assert not hasattr(chat, "gpt_params")


def test_verified_tree_loads_through_load(tree, tiny_config, monkeypatch):
    """With the trusted map standing for the tree's own, the public path
    verifies and reads the tree: the same leaves as ``_load_assets``."""
    base, _ = tree
    monkeypatch.setattr(dl_utils, "trusted_sha256_map",
                        lambda: dl_utils.generate_sha256_map(base))
    monkeypatch.setenv("CHATTTS_ASSETS", base)
    cfg = port_config(tiny_config)
    chat = TChat(config=cfg)
    assert chat.load(device="cpu") is True  # source="local" by default
    ref = TChat(config=cfg)
    ref._load_assets(base, device="cpu")
    for name in TREES:
        _assert_same_tree(_numpy_tree(getattr(ref, name)),
                          getattr(chat, name), name)


def _numpy_tree(tree):
    """A tree of tensors -> numpy leaves with a ``dtype`` name as JAX's
    (bf16 kept as JAX arrays)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)
        return t.numpy()
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return leaf(tree)


def test_download_models_without_huggingface_hub(tiny_config, monkeypatch,
                                                 caplog):
    """``huggingface`` needs the package; without it the error is logged
    and None returned (no network is tried)."""
    import sys

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    chat = TChat(config=port_config(tiny_config))
    with caplog.at_level(logging.ERROR):
        assert chat.download_models(source="huggingface") is None
    assert "huggingface download failed" in caplog.text


def _infer(chat):
    p = TChat.InferCodeParams(max_new_token=12, min_new_token=4,
                              manual_seed=7, show_tqdm=False)
    return chat.infer(["hello world."], skip_refine_text=True,
                      split_text=False, params_infer_code=p)


def test_unload_then_reload_gives_a_fresh_chat(f32_tree, tiny_config):
    base = f32_tree
    cfg = port_config(tiny_config)
    chat = TChat(config=cfg)
    chat._load_assets(base, device="cpu")
    loaded = _infer(chat)
    chat.unload()
    assert not chat.has_loaded()
    for attr in TREES + ("packed", "_pack_cache", "generator", "tokenizer",
                         "speaker", "_code_engines", "_text_engine"):
        assert not hasattr(chat, attr), attr
    assert chat.load(source="random", seed=0, device="cpu")
    fresh = TChat(config=cfg)
    fresh.load(source="random", seed=0, device="cpu")
    got, want = _infer(chat), _infer(fresh)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert not np.array_equal(loaded[0][:want[0].size], want[0][:loaded[0].size])
    # and back to the tree: the packed weights follow the new load
    chat.unload()
    chat._load_assets(base, device="cpu")
    np.testing.assert_array_equal(_infer(chat)[0], loaded[0])


def test_tokenizer_of_the_tree_keeps_control_tokens_above_break_0(
        tree, tiny_config, caplog):
    base, _ = tree
    with caplog.at_level(logging.WARNING):
        tok = Tokenizer(f"{base}/asset/tokenizer")
    assert "control tokens below" not in caplog.text
    assert tok.len == tiny_config.gpt.num_text_tokens
    assert tok.break_0_ids < tok.spk_emb_ids < tok.len
