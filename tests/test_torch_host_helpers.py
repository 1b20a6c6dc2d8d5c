"""The port's small host pieces against ``chattts_tpu``'s: ``show_tqdm``
and its progress hooks, ``top_p_mask``/``top_k_mask``, ``Metrics`` and
``trace``, the ``urllib`` LLM client, ``Chat.load``'s signature, and the
Embed heads' weight-norm fold on BF16 leaves.

* ``show_tqdm=True`` reports up to ``max_new_token`` on the Generator and
  on the engine route (the reference's spy, tests/test_core.py); the
  Generator's hook fires only at the host reads it already makes (every
  ``SYNC_EVERY`` steps, a streamed chunk's status, the final outputs).
* The masks equal HF's ``TopPLogitsWarper``/``TopKLogitsWarper`` and the
  JAX functions, with one value for all rows and one per row, and
  ``sample`` draws among the columns they keep.
* ``Metrics`` gives the JAX one's snapshot on the same records; ``trace``
  writes a Chrome trace on the CPU.
* ``ChatClient`` posts the OpenAI chat-completions request to a stub
  server on 127.0.0.1 and reads its answer.
* ``load`` takes the reference's positional order (``source, custom_path,
  compile, coef, seed, use_engine``) and ``compile=False``, with the same
  weights as the keyword call.
* The fold rounds float64 to bf16 through float32 as the JAX package's
  ``ml_dtypes`` does: a weight whose float64 value rounds to 0.98828125
  directly and to 0.9921875 through float32 comes out 0.9921875, bit for
  bit the JAX function's.
"""

import http.server
import json
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from transformers.generation import TopKLogitsWarper, TopPLogitsWarper

from chattts_tpu.ops import sampling as jsampling
from chattts_tpu.utils import io as jio
from chattts_tpu.utils import llm as jllm
from chattts_tpu.utils import profiling as jprof
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.ops import sampling as tsampling
from chattts_tpu_torch.utils import io as tio
from chattts_tpu_torch.utils import llm as tllm
from chattts_tpu_torch.utils import profiling as tprof
from chattts_tpu_torch.utils import progress
from torch_port_utils import port_config

TREES = ("gpt_params", "embed_params", "decoder_params", "vocos_params",
         "dvae_params")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and
    under the tier-1 command's six workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chats(tiny_config):
    """The port's facade on seeded random weights, and an engine-route
    twin of the same weights."""
    chat = TChat(config=port_config(tiny_config))
    chat.load(source="random", seed=0, device="cpu")
    twin = TChat(config=chat.config)
    twin.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                     decoder=chat.decoder_params, vocos=chat.vocos_params,
                     dvae=chat.dvae_params, device="cpu", use_engine=True)
    return chat, twin


# ---------------------------------------------------------------------------
# show_tqdm and the progress hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["generator", "engine"])
def test_show_tqdm_reports_progress(chats, monkeypatch, route):
    chat = chats[0] if route == "generator" else chats[1]
    calls, made = [], []

    class Spy(progress.ProgressBar):
        def __init__(self, total, desc="generate"):
            made.append((total, desc))
            super().__init__(total, desc)

        def report(self, key, done):
            calls.append(int(done))
            super().report(key, done)

    monkeypatch.setattr(progress, "ProgressBar", Spy)
    chat.infer("progress check", skip_refine_text=True, split_text=False,
               params_infer_code=TChat.InferCodeParams(
                   max_new_token=8, min_new_token=8, manual_seed=3,
                   show_tqdm=True))
    assert calls and max(calls) == 8
    assert made == [(8, "infer_code")]  # one request: the same total
    calls.clear()
    made.clear()
    chat.infer("progress check", refine_text_only=True, split_text=False,
               params_refine_text=TChat.RefineTextParams(
                   max_new_token=6, min_new_token=6, manual_seed=3))
    assert calls and max(calls) == 6 and made == [(6, "refine_text")]


def test_show_tqdm_false_makes_no_bar(chats, monkeypatch):
    made = []
    monkeypatch.setattr(progress, "ProgressBar",
                        lambda *a, **k: made.append(a))
    chats[0].infer("no bar", skip_refine_text=True, split_text=False,
                   params_infer_code=TChat.InferCodeParams(
                       max_new_token=8, manual_seed=3, show_tqdm=False))
    assert not made


@pytest.mark.parametrize("stream_batch", [0, 12])
def test_generator_reports_progress_at_its_host_reads(chats, stream_batch):
    """The Generator calls ``on_progress`` where the host already reads the
    device: one-shot, at every SYNC_EVERY-th step's finished-flag read and
    the final outputs; streamed, at each chunk's status read too."""
    chat = chats[0]
    ids, attn, tmask, temp, _ = chat._code_inputs(
        ["hello"], TChat.InferCodeParams())
    seen = []
    req = tg.GenerateRequest(
        ids=ids, attn_mask=attn, text_mask=tmask, infer_text=False,
        eos_token=chat.config.gpt.num_audio_tokens - 1, temperature=temp,
        max_new=20, min_new=20, seed=1, stream_batch=stream_batch,
        return_hidden=True, on_progress=seen.append)
    outs = list(chat.generator.generate(req))
    assert outs[-1].steps == 20
    assert seen == ([8, 16, 20] if not stream_batch else [8, 12, 16, 20, 20])


# ---------------------------------------------------------------------------
# top-p / top-k masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.7, 0.2])
def test_top_p_mask_matches_hf_and_jax(rng, p):
    scores = rng.standard_normal((5, 40)).astype(np.float32) * 3
    ref = TopPLogitsWarper(p, min_tokens_to_keep=3)(
        None, torch.tensor(scores)).numpy()
    got = tsampling.top_p_mask(torch.from_numpy(scores), p)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsampling.top_p_mask(jnp.asarray(scores),
                                                     jnp.float32(p))))
    np.testing.assert_allclose(np.where(got.numpy(), -np.inf, scores), ref,
                               atol=1e-6)


@pytest.mark.parametrize("k", [7, 1])
def test_top_k_mask_matches_hf_and_jax(rng, k):
    scores = rng.standard_normal((5, 40)).astype(np.float32) * 3
    ref = TopKLogitsWarper(k, min_tokens_to_keep=3)(
        None, torch.tensor(scores)).numpy()
    got = tsampling.top_k_mask(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsampling.top_k_mask(jnp.asarray(scores),
                                                     jnp.int32(k))))
    np.testing.assert_allclose(np.where(got.numpy(), -np.inf, scores), ref,
                               atol=1e-6)


def test_masks_per_row_match_jax(rng):
    """One value per row, as continuous batching carries them."""
    scores = rng.standard_normal((4, 50)).astype(np.float32) * 2
    p = np.array([0.1, 0.5, 0.7, 0.95], np.float32)
    k = np.array([3, 5, 20, 60], np.int32)
    np.testing.assert_array_equal(
        tsampling.top_p_mask(torch.from_numpy(scores),
                             torch.from_numpy(p)).numpy(),
        np.asarray(jsampling.top_p_mask(jnp.asarray(scores),
                                        jnp.asarray(p))))
    np.testing.assert_array_equal(
        tsampling.top_k_mask(torch.from_numpy(scores),
                             torch.from_numpy(k)).numpy(),
        np.asarray(jsampling.top_k_mask(jnp.asarray(scores),
                                        jnp.asarray(k))))


def test_sample_draws_among_the_masks_survivors(rng):
    """``sample`` applies the masks' rule: with temperature 1, no penalty
    and no EOS suppression, its token is the Gumbel argmax over the
    columns that neither mask removes (the draw's noise sits at sorted
    positions, so it is put back on the columns first)."""
    N, V = 6, 40
    scores = torch.from_numpy(rng.standard_normal((N, V)).astype(
        np.float32) * 3)
    noise = torch.from_numpy(rng.gumbel(size=(N, V)).astype(np.float32))
    p = torch.tensor([0.1, 0.3, 0.5, 0.7, 0.9, 1.0])
    k = torch.tensor([1, 3, 5, 8, 20, 40])
    got = tsampling.sample(
        scores, tsampling.SamplingParams(torch.ones(N), p, k, 1.0, 0),
        torch.zeros((N, 1), dtype=torch.long), torch.zeros((N, 1)), step=0,
        eos_token=V - 1, max_penalized=V, noise=noise)
    order = torch.sort(scores, dim=-1, stable=True).indices
    col_noise = torch.zeros_like(noise).scatter(1, order, noise)
    removed = (tsampling.top_p_mask(scores, p)
               | tsampling.top_k_mask(scores, k))
    want = torch.argmax(torch.where(removed, float("-inf"), scores)
                        + col_noise, dim=-1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Metrics and trace
# ---------------------------------------------------------------------------


def test_metrics_match_jax():
    records = [("steps", (40, 4)), ("ttfa", 0.31), ("steps", (8, 1)),
               ("ttfa", 0.12), ("ttfa", 0.5), ("seq", 3), ("steps", (1, 2))]
    snaps = []
    for mod in (jprof, tprof):
        m = mod.Metrics(started=0.0, busy_seconds=2.5)
        for kind, v in records:
            if kind == "steps":
                m.record_steps(*v)
            elif kind == "ttfa":
                m.record_ttfa(v)
            else:
                m.record_sequences(v)
        with m.timed():
            pass
        snap = m.snapshot()
        snap.pop("wall_seconds")
        snap.pop("busy_seconds")
        snaps.append((snap, m.steps, m.audio_samples))
    assert snaps[0][1:] == snaps[1][1:] == (170, 170 * 512)
    for key, want in snaps[0][0].items():
        assert snaps[1][0][key] == pytest.approx(want, rel=1e-3), key
    assert snaps[1][0]["ttfa_p50"] == 0.31 and snaps[1][0]["ttfa_p90"] == 0.5
    for q in (0.0, 0.5, 0.9, 1.0):
        for vals in ([], [1.0], [3.0, 1.0, 2.0, 5.0]):
            got, want = (tprof._percentile(sorted(vals), q),
                         jprof._percentile(sorted(vals), q))
            assert got == want or (np.isnan(got) and np.isnan(want))


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "t")
    with tprof.trace(d) as where:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert where == d
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
    with pytest.raises(RuntimeError):  # the trace is written all the same
        with tprof.trace(d):
            raise RuntimeError("inside")
    assert len(list((tmp_path / "t").glob("trace_*.json"))) == 2


# ---------------------------------------------------------------------------
# the LLM client
# ---------------------------------------------------------------------------


def test_chat_client_against_a_stub_server():
    got = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            got.append((self.path, self.headers["Authorization"], body))
            reply = json.dumps({"choices": [{"message": {
                "content": f"spoken {len(got)}"}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(reply)))
            self.end_headers()
            self.wfile.write(reply)

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}/v1/"
        client = tllm.ChatClient("k3y", base, "m", timeout=30)
        assert client.chat("hi", system_prompt="sys") == "spoken 1"
        assert client.prepare_tts_text("3 cats", shorten=True) == "spoken 2"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
    assert got[0] == ("/v1/chat/completions", "Bearer k3y", {
        "model": "m", "messages": [{"role": "system", "content": "sys"},
                                   {"role": "user", "content": "hi"}]})
    assert got[1][2]["messages"] == [{
        "role": "user", "content": f"{jllm.PROMPT_SHORTEN}\n\n3 cats"}]
    assert (tllm.PROMPT_DIRECT, tllm.PROMPT_SHORTEN) == (
        jllm.PROMPT_DIRECT, jllm.PROMPT_SHORTEN)


# ---------------------------------------------------------------------------
# Chat.load's signature
# ---------------------------------------------------------------------------


def _same_weights(a, b):
    for name in TREES:
        la = [t for t in _leaves(getattr(a, name))]
        lb = [t for t in _leaves(getattr(b, name))]
        if len(la) != len(lb) or not all(torch.equal(x, y)
                                         for x, y in zip(la, lb)):
            return False
    return True


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_load_takes_the_references_positional_order(tiny_config):
    """``load(source, custom_path, compile, coef, seed, use_engine)``:
    the third argument is ``compile`` (ignored), the fifth the seed; the
    port's own arguments are keyword-only."""
    import inspect

    names = list(inspect.signature(TChat.load).parameters)
    assert names[:7] == ["self", "source", "custom_path", "compile", "coef",
                         "seed", "use_engine"]
    cfg = port_config(tiny_config)
    by_kw = TChat(config=cfg)
    assert by_kw.load(source="random", seed=3, device="cpu")
    by_pos = TChat(config=cfg)
    assert by_pos.load("random", None, False, None, 3, True, device="cpu")
    assert by_pos.use_engine and not by_kw.use_engine
    assert _same_weights(by_pos, by_kw)
    no_compile = TChat(config=cfg)
    assert no_compile.load(source="random", compile=False, seed=3,
                           device="cpu")
    assert _same_weights(no_compile, by_kw)
    other = TChat(config=cfg)
    other.load("random", None, True, None, 4, device="cpu")
    assert not _same_weights(other, by_kw)
    with pytest.raises(TypeError):
        TChat(config=cfg).load("random", None, True, None, 3, False, "cpu")


# ---------------------------------------------------------------------------
# the weight-norm fold on BF16 leaves
# ---------------------------------------------------------------------------


def test_fold_weight_norm_rounds_bf16_as_the_jax_loader():
    g = [[1.25], [-0.90234375], [0.5]]
    v = [[2.109375, 1.625], [0.1845703125, 0.7265625], [3.0, -4.0]]
    pre = "head_code.0.parametrizations.weight."
    jstate = {pre + "original0": np.array(g, ml_dtypes.bfloat16),
              pre + "original1": np.array(v, ml_dtypes.bfloat16),
              "emb_text.weight": np.ones((2, 2), ml_dtypes.bfloat16)}
    tstate = {pre + "original0": torch.tensor(g, dtype=torch.bfloat16),
              pre + "original1": torch.tensor(v, dtype=torch.bfloat16),
              "emb_text.weight": torch.ones((2, 2), dtype=torch.bfloat16)}
    want = jio.fold_weight_norm(jstate)["head_code.0.weight"]
    got = tio.fold_weight_norm(tstate)
    assert set(got) == {"head_code.0.weight", "emb_text.weight"}
    w = got["head_code.0.weight"]
    assert w.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  want.view(np.int16))
    # float64 0.99023437440..., a bf16 tie once in float32: 0.9921875,
    # where rounding straight from float64 gives 0.98828125
    exact = 1.25 * 2.109375 / np.hypot(2.109375, 1.625)
    assert abs(exact - 0.990234375) < 2 ** -26 and exact != 0.990234375
    assert w[0, 0].item() == 0.9921875
    assert w[1, 0].item() == -0.22265625
    assert torch.equal(got["emb_text.weight"], tstate["emb_text.weight"])
