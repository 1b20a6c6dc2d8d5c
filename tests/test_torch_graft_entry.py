"""The port's check entry points (``chattts_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py`` (CPU).

* ``entry()``: the JAX entry and the port's at the tiny config (the JAX
  entry reads its config from ``chattts_tpu.config.Config``, which the test
  points at the tiny one): the same output shapes, and the port's forward
  on the JAX entry's parameters, bridged, within 0.05 of its logits: the
  bf16 prefill's hidden is held to 0.05 in tests/test_torch_llama.py (the
  two frameworks round bf16 at other places), and the code heads, weights
  of 1/sqrt(D) over D hidden values of O(1), keep an error of that size
  (measured 1.7e-2).
* ``dryrun_multichip(4)`` on a gloo group of 4 CPU processes, the real
  width at 2 layers: the training half (one sharded step on dp=2 x tp=2,
  the mesh the JAX dry run picks for 4 devices, its loss finite and equal
  on every rank; the GPipe step at pp=2 on ranks 0 and 1, its loss within
  the JAX dry run's rtol 2e-4 of the plain step's) and the serving half
  (dp=2 x tp=2).
"""

import dataclasses
import importlib

import jax
import numpy as np

import chattts_tpu.config as jconfig
from chattts_tpu_torch import graft_entry
from torch_port_utils import bridge, port_config

LOGITS_ATOL = 0.05


def test_entry_matches_the_jax_entry(tiny_config, monkeypatch):
    monkeypatch.setenv("CHATTTS_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(jconfig, "Config", lambda: tiny_config)
    jentry = importlib.import_module("__graft_entry__")
    jfn, jargs = jentry.entry()
    jlogits, jcache = jax.jit(jfn)(*jargs)

    cfg = port_config(tiny_config.gpt)
    fn, args = graft_entry.entry(cfg, device="cpu")
    logits, cache = fn(*args)
    assert tuple(logits.shape) == tuple(jlogits.shape)
    assert [tuple(k.shape) for k in cache.k] == [
        tuple(k.shape) for k in jcache.k]
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(jargs[2]))
    # the port's forward on the JAX entry's own weights
    logits, _ = fn(bridge(jargs[0]), bridge(jargs[1]), *args[2:])
    err = float(np.abs(logits.numpy() - np.asarray(jlogits)).max())
    print(f"entry logits against the JAX entry's: max-abs {err:.3e}")
    assert err <= LOGITS_ATOL, err
    full = dataclasses.asdict(graft_entry.Config().gpt)
    assert full == dataclasses.asdict(port_config(jconfig.GPTConfig()))


def test_dryrun_multichip_on_four_cpu_ranks():
    out = graft_entry.dryrun_multichip(4, device="cpu", threads=1)
    assert [o["mesh"] for o in out] == [(2, 2)] * 4
    assert all(o["requests"] == 5 and o["wav_shape"][0] == 4 for o in out)
    assert all(o["decode_err"] <= 1e-5 for o in out)
    assert all(ids.shape == (8, 4) for ids in out[0]["ids"])
    train = [o["train"] for o in out]
    assert all(t["mesh"] == (2, 1, 2) for t in train)
    assert np.isfinite(train[0]["loss"])
    assert all(t["loss"] == train[0]["loss"] for t in train)
    assert train[2]["pp"] is None and train[3]["pp"] is None
    for t in train[:2]:
        assert np.isclose(t["pp"]["loss"], t["pp"]["plain"], rtol=2e-4,
                          atol=1e-5), t["pp"]
