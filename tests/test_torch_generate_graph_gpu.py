"""The Generator's CUDA graph of one step against its eager step, on the
card.

On CUDA the Generator captures one decode step (head, sampling, the token
and hidden writes, embedding, the decode step kernel, the final norm) into
a ``torch.cuda.CUDAGraph`` once an attempt and replays it every step.  A
request whose ``noise`` hands the draws from the host runs the same step
eagerly; here that noise is drawn from a ``torch.Generator`` seeded as the
Generator seeds its own, so both paths see the same Gumbel numbers only if
every replay draws the Philox numbers the eager step draws.  Checked, at
one seed per case: ids, finished flags and kept counts equal; the kept
hiddens within the decode step's hidden tolerance (atol 0.05, as
``test_torch_kernels_gpu.py`` holds the kernel to its plain version);
the counters (``graph_captures``, ``graph_steps``, ``eager_steps``,
``decode_step.launches``) and the spans (a ``decode_step`` span a step,
``generator.steps``' ``graphed``).  Cases: code and text passes, every
cache and weight tier, 1 to 96 rows, ``max_new`` not a multiple of 8, EOS
suppressed by ``min_new`` past the steps rows stop at, repetition penalty
1.0 and 1.05, greedy and temperature 0.3, streaming with dispatch-ahead
and ``on_dispatch`` (a chunk's kept counts do not move once later steps
run).

Needs a CUDA device (skips without one); imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_generate_graph_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chattts_tpu_torch.config import GPTConfig
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.models import embed as embed_mod
from chattts_tpu_torch.models import llama
from chattts_tpu_torch.ops import decode_step as k1
from chattts_tpu_torch.ops import sampling
from chattts_tpu_torch.utils import profiling
from chattts_tpu_torch.weights import to_device

pytestmark = pytest.mark.gpu

HIDDEN_ATOL = 0.05
GREEDY = 1e-5   # a temperature far below any gap between logits
# heads of 128 (a kv4 row's nibble pairs), D 256: every weight and cache
# tier takes it
CFG = GPTConfig(hidden_size=256, intermediate_size=512, num_attention_heads=2,
                num_hidden_layers=2, max_position_embeddings=1024)
TIERS = [(kv, wb) for kv in (0, 8, 4) for wb in (0, 8, 4)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def weights(cuda):
    gen = torch.Generator().manual_seed(0)
    gpt = llama.init_params(gen, CFG)
    emb = embed_mod.init_params(gen, CFG)
    return to_device(gpt, cuda), to_device(emb, cuda)


def _generator(weights, kv_bits=8, weight_bits=0):
    gpt, emb = weights
    return tg.Generator(CFG, gpt, emb, prefill_bucket=16, kv_bits=kv_bits,
                        packed=k1.pack_weights(gpt, CFG,
                                               weight_bits=weight_bits))


def _request(infer_text, B, seed, max_new=37, min_new=3, temperature=0.3,
             penalty=1.05, **kw):
    rng = np.random.default_rng(seed)
    T0 = 21
    hi = CFG.num_text_tokens - 1 if infer_text else CFG.num_audio_tokens - 1
    ids = rng.integers(1, hi, (B, T0, CFG.num_vq)).astype(np.int32)
    attn = np.ones((B, T0), bool)
    for b in range(B):
        attn[b, :rng.integers(0, 8)] = False  # left padding
    ids[~attn] = 0
    streams = 1 if infer_text else CFG.num_vq
    return tg.GenerateRequest(
        ids=ids, attn_mask=attn, text_mask=attn.copy(),
        infer_text=infer_text,
        eos_token=(CFG.num_text_tokens if infer_text
                   else CFG.num_audio_tokens) - 1,
        temperature=np.full((streams,), temperature, np.float32),
        top_p=0.7, top_k=20, repetition_penalty=penalty, max_new=max_new,
        min_new=min_new, seed=seed, return_hidden=True, **kw)


def _host_noise(req):
    """The Gumbel draws of the Generator's own sampling generator at
    ``req.seed``, handed from the host: the eager path on the same
    numbers."""
    B = req.ids.shape[0]
    shape = ((B, CFG.num_text_tokens) if req.infer_text
             else (B * CFG.num_vq, CFG.num_audio_tokens))
    gen = torch.Generator(device="cuda").manual_seed(int(req.seed))
    return lambda step: sampling.gumbel(shape, gen, "cuda")


def _both(g, req, **kw):
    """(graphed outputs, eager outputs) of ``req`` (every yield), with the
    counters' changes checked."""
    before = (g.graph_captures, g.graph_steps, g.eager_steps)
    launches = k1.decode_step.launches
    graphed = list(g.generate(req, **kw))
    steps = graphed[-1].steps
    assert steps > 0
    assert (g.graph_captures, g.graph_steps, g.eager_steps) == (
        before[0] + 1, before[1] + steps, before[2])
    assert k1.decode_step.launches == launches + steps
    eager = list(g.generate(dataclasses.replace(req,
                                                noise=_host_noise(req)),
                            **kw))
    assert (g.graph_captures, g.graph_steps) == (before[0] + 1,
                                                 before[1] + steps)
    assert g.eager_steps == before[2] + eager[-1].steps
    assert k1.decode_step.launches == launches + steps + eager[-1].steps
    return graphed, eager


def _assert_same(got, want):
    assert got.steps == want.steps and got.partial == want.partial
    assert len(got.ids) == len(want.ids)
    for a, b in zip(got.ids, want.ids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.finished, want.finished)
    end = want.end_dev.cpu()
    torch.testing.assert_close(got.end_dev.cpu(), end, rtol=0, atol=0)
    hg, hw = got.hiddens_dev.cpu(), want.hiddens_dev.cpu()
    assert hg.shape == hw.shape
    for b in range(hg.shape[0]):
        n = int(end[b])
        torch.testing.assert_close(hg[b, :n], hw[b, :n], atol=HIDDEN_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("infer_text", [False, True], ids=["code", "text"])
@pytest.mark.parametrize("kv_bits,weight_bits", TIERS,
                         ids=[f"kv{kv}-w{wb}" for kv, wb in TIERS])
def test_graph_matches_eager_on_every_tier(weights, kv_bits, weight_bits,
                                           infer_text):
    g = _generator(weights, kv_bits, weight_bits)
    graphed, eager = _both(g, _request(infer_text, 8, 11))
    _assert_same(graphed[-1], eager[-1])


@pytest.mark.parametrize("B", [1, 8, 64, 96])
@pytest.mark.parametrize("infer_text", [False, True], ids=["code", "text"])
def test_graph_matches_eager_at_every_width(weights, B, infer_text):
    g = _generator(weights)
    graphed, eager = _both(g, _request(infer_text, B, 12, max_new=29))
    _assert_same(graphed[-1], eager[-1])


@pytest.mark.parametrize("temperature", [GREEDY, 0.3],
                         ids=["greedy", "t0.3"])
@pytest.mark.parametrize("penalty", [1.0, 1.05])
def test_graph_matches_eager_in_sampling(weights, temperature, penalty):
    g = _generator(weights)
    graphed, eager = _both(g, _request(False, 8, 13, max_new=45,
                                       temperature=temperature,
                                       penalty=penalty))
    _assert_same(graphed[-1], eager[-1])


def test_min_new_suppresses_eos_in_the_graph(weights):
    """Rows that stop early at this seed (on random weights a row draws an
    EOS code by chance) run to ``max_new`` once EOS is suppressed past
    their stopping step; the Generator captures a graph for each call."""
    g = _generator(weights)
    free = next(g.generate(_request(False, 8, 14, max_new=203)))
    assert free.finished.any() and int(free.end_dev.min()) < 203 - 8
    graphed, eager = _both(g, _request(False, 8, 14, max_new=203,
                                       min_new=203))
    _assert_same(graphed[-1], eager[-1])
    assert not graphed[-1].finished.any()
    assert (graphed[-1].end_dev.cpu() == 203).all()


@pytest.mark.parametrize("infer_text", [False, True], ids=["code", "text"])
def test_streamed_chunks_match_eager_and_stay_put(weights, infer_text):
    """Streaming with dispatch-ahead: every partial and the final equal the
    eager path's, ``on_dispatch`` sees the same step counts and kept
    counts, and a partial's kept counts read the same after later steps
    ran as when it was yielded."""
    g = _generator(weights)
    seen = {"graph": [], "eager": []}

    def on_dispatch(key):
        return lambda st, hi: seen[key].append((hi,
                                                st.end_idx.cpu().clone()))

    req = _request(infer_text, 8, 15, max_new=70, stream_batch=16,
                   speculate=True, speculate_from=2,
                   on_dispatch=on_dispatch("graph"))
    graphed, yielded_ends = [], []
    for out in g.generate(req):
        graphed.append(out)
        if out.partial:
            yielded_ends.append(out.end_dev.cpu().clone())
    eager = list(g.generate(dataclasses.replace(
        req, noise=_host_noise(req), on_dispatch=on_dispatch("eager"))))
    assert sum(o.partial for o in graphed) >= 2
    assert len(graphed) == len(eager)
    for got, want in zip(graphed, eager):
        _assert_same(got, want)
    partials = [o for o in graphed if o.partial]
    for out, end in zip(partials, yielded_ends):
        torch.testing.assert_close(out.end_dev.cpu(), end, rtol=0, atol=0)
    assert [hi for hi, _ in seen["graph"]] == [hi for hi, _ in seen["eager"]]
    for (_, a), (_, b) in zip(seen["graph"], seen["eager"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_every_replay_is_a_span_and_counts(weights):
    """Under a profiler each replayed step is one ``decode_step`` span
    inside a ``generator.steps`` span whose ``graphed`` counts it; the
    capture is its own span."""
    g = _generator(weights)
    req = _request(False, 8, 16, max_new=27, min_new=27)
    next(g.generate(req))  # warm: the library and the rope tables
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear_spans()
        out = next(g.generate(req))
        rec = profiling.spans()
    stretches = [s for s in rec if s.name == "generator.steps"]
    ids = {s.index for s in stretches}
    steps = [s for s in rec if s.name == "decode_step" and s.parent in ids]
    assert out.steps == 27 == len(steps)
    assert sum(s.attrs["steps"] for s in stretches) == 27
    assert sum(s.attrs["graphed"] for s in stretches) == 27
    assert [s.attrs["rows"] for s in rec if s.name == "generator.capture"
            ] == [8]
