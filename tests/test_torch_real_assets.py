"""The port on a real ChatTTS asset tree (skipped until one exists).

The counterpart of ``test_real_assets.py``: point ``CHATTTS_ASSETS`` at the
tree (or place ``asset/`` in the working directory) and these run on the
CPU:

* every file's checksum against the trusted map the port vendors;
* the tree loads through ``Chat.load(source="custom")`` and every leaf of
  the five checkpoints is finite, the tokenizer the tree's own;
* every leaf equals the JAX package's loader's in value, dtype and shape;
* the port's ``tokenizer.json`` reader gives the JAX package's tokenizer's
  ids and decoded strings on the real vocabulary.
"""

import os

import numpy as np
import pytest
import torch

from chattts_tpu_torch.utils import io as io_utils

ASSETS = io_utils.find_assets_dir(os.environ.get("CHATTTS_ASSETS"))

pytestmark = pytest.mark.skipif(
    ASSETS is None, reason="no ChatTTS asset tree (set CHATTTS_ASSETS)")

TREES = ("gpt_params", "embed_params", "decoder_params", "vocos_params",
         "dvae_params")


@pytest.fixture(scope="module")
def port_chat():
    from chattts_tpu_torch import Chat

    c = Chat()
    assert c.load(source="custom", custom_path=ASSETS, device="cpu"), \
        "load failed"
    return c


@pytest.fixture(scope="module")
def jax_chat():
    from chattts_tpu.core import Chat as JChat

    j = JChat()
    assert j.load(source="custom", custom_path=ASSETS), "JAX load failed"
    return j


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def test_real_assets_checksums():
    from chattts_tpu_torch.utils import dl

    assert dl.check_all_assets(ASSETS), "sha256 verification failed"


def test_real_assets_all_checkpoints_load(port_chat):
    for name in TREES:
        leaves = _flat(getattr(port_chat, name))
        assert leaves, name
        for k, t in leaves.items():
            assert bool(torch.isfinite(t.float()).all()), f"{name}/{k}"
    assert type(port_chat.tokenizer._backend).__name__ == "_HFBackend"
    assert port_chat.tokenizer.len == 21178


def test_real_assets_leaves_equal_jax(port_chat, jax_chat):
    import jax.numpy as jnp

    j = jax_chat
    for name in TREES:
        jf, tf = _flat(getattr(j, name)), _flat(getattr(port_chat, name))
        assert set(jf) == set(tf), name
        for k, a in jf.items():
            t = tf[k]
            assert str(t.dtype).removeprefix("torch.") == str(a.dtype), k
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(jnp.asarray(a, jnp.float32)),
                err_msg=f"{name}/{k}")


def test_real_assets_tokenizer_equals_jax(port_chat, jax_chat):
    """Mixed CJK, Latin, digits, punctuation, accents, case and every
    control token, batched (left padding) and one text at a time."""
    from chattts_tpu_torch.models.tokenizer import CONTROL_TOKENS

    texts = ["[Stts][spk_emb]Hello, 你好！今天天气真不错。[Ptts]",
             "Café déjà vu: 3.14 × 2 = 6.28 [uv_break] OK?",
             "四川美食确实以辣闻名[laugh]但也有不辣的选择[lbreak]",
             "UPPER lower MiXeD " + "x" * 120 + " end",
             "".join(CONTROL_TOKENS) + " [break_0]a[break_7]b"]
    tt, jt = port_chat.tokenizer, jax_chat.tokenizer
    assert tt.len == jt.len
    for tok in CONTROL_TOKENS:
        assert tt._backend.token_id(tok) == jt._backend.token_id(tok), tok
    for batch in [texts] + [[t] for t in texts]:
        got = tt.encode(batch, 4)
        want = jt.encode(batch, 4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(batch))
        rows = [got[0][b, got[2][b], 0] for b in range(len(batch))]
        assert tt.decode(rows) == jt.decode(rows), batch
