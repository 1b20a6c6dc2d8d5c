"""Autoregressive generation (port of ``chattts_tpu/engine/generate.py``).

The JAX package runs its decode loop inside one jitted ``lax.while_loop``;
here the loop is Python over steps, each step being the same sequence as
the reference's ``step_body``: head -> sample -> embed -> the decode step
kernel (``ops/decode_step.py``: K3 on the default int8 KV cache, K1 with
``kv_bits=0``, K6 with ``kv_bits=4``; K4 or K5 on top with int8 or int4
packed weights) -> final ``rms_norm``.  Everything stays on the
device; the host reads the all-finished flag every ``SYNC_EVERY`` steps
(steps run after every row finished change no output: finished rows no
longer count toward ``end_idx``).

This is the scalar-``cur`` generator: a flat KV cache (L, B, T, W), int8
rows with embedded scales by default as in the reference (quantized at the
prefill -> decode boundary, ``ops/kv_quant.py``), int4 rows or bf16, prompt
bucketing, the repetition-penalty window, EOS handling and the
``ensure_non_empty`` retry.  The per-slot engine is ``engine/batching.py``.

Streaming (``stream_batch > 0``) runs the steps in chunks of
``stream_batch`` and yields a partial output after each chunk that left a
row unfinished, at the reference's step counts whatever ``SYNC_EVERY`` is.
At each chunk's end the finished flags, the kept counts and the ids go to
the host as one non-blocking copy into pinned memory with an event
(``streaming.HostCopy``).  With ``speculate``, chunk k+1's steps are
enqueued before the host waits on chunk k's copy (the reference's
dispatch-ahead); while it enqueues them, the host stops early once chunk
k's copy has landed and says every row finished.

Under a profiler (``utils/profiling.span``) a call records
``generator.prefill``, a ``generator.steps`` span around each stretch of
steps enqueued between two host reads (each step's ``decode_step``
inside), ``generator.sync`` around the host read of the finished flags
and ``generator.materialize`` around the final outputs' reads.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import GPTConfig
from ..models import embed as embed_mod
from ..models import llama
from ..ops import decode_step as k1
from ..ops import sampling
from ..ops.kv_quant import kv_quantizer
from ..utils import profiling
from .streaming import HostCopy

REP_WINDOW = 16  # trailing-token window of the repetition penalty
SYNC_EVERY = 8   # decode steps between host reads of the finished flags


@dataclass
class GenerationOutputs:
    """Results of one generation call.

    ``hiddens_dev`` (B, n_max, D) f32 and ``end_dev`` (B,) stay on the
    device for the mel decoder when the request asked for hiddens.
    """

    ids: List[np.ndarray]       # per-seq (Ti,) text ids or (Ti, num_vq) codes
    finished: np.ndarray        # (B,) bool
    hiddens_dev: Optional[torch.Tensor] = None
    end_dev: Optional[torch.Tensor] = None
    steps: int = 0              # decode steps run so far (kernel launches)
    # per-seq (Ti, D) host copies: only engine outputs whose hiddens were
    # streamed to the host carry them
    hiddens: List[np.ndarray] = field(default_factory=list)
    # valid prefix length of hiddens_dev when the buffer is LARGER than the
    # kept max (engine streaming hands fixed-shape full slot rows; rows >=
    # n_valid are garbage)
    n_valid: Optional[int] = None
    # True for streaming partials; False for an attempt's final output.
    # A yield AFTER a final one means the empty-generation retry restarted
    # the attempt - streaming consumers must reset their accumulation.
    partial: bool = False

    @property
    def hid_n(self) -> int:
        """Valid hidden positions in ``hiddens_dev`` (buffer may be larger)."""
        if self.hiddens_dev is None:
            return 0
        return (self.n_valid if self.n_valid is not None
                else self.hiddens_dev.shape[1])

    def materialize_hiddens(self) -> List[np.ndarray]:
        """Per-seq host copies of the hiddens (device path included)."""
        if self.hiddens or self.hiddens_dev is None:
            return self.hiddens
        hid = self.hiddens_dev.cpu().numpy()
        end = self.end_dev.cpu().numpy()
        return [hid[b, : int(end[b])].copy() for b in range(hid.shape[0])]

    def destroy(self):
        self.ids = []
        self.hiddens = []
        self.hiddens_dev = None
        self.end_dev = None


class Interrupt:
    """Cooperative cancel flag, polled between decode steps."""

    def __init__(self):
        self._flag = False

    def set(self, v: bool):
        self._flag = v

    def get(self) -> bool:
        return self._flag


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class GenerateRequest:
    """Host-side inputs for one generation call."""

    ids: np.ndarray          # (B, T0, num_vq) int32, left-padded
    attn_mask: np.ndarray    # (B, T0) bool
    text_mask: np.ndarray    # (B, T0) bool
    infer_text: bool
    eos_token: int           # text eos id (code path uses num_audio_tokens-1)
    temperature: np.ndarray  # (num_vq,) or (1,)
    top_p: float = 0.7
    top_k: int = 20
    repetition_penalty: float = 1.0
    max_new: int = 2048
    min_new: int = 0
    spk_vec: Optional[np.ndarray] = None  # (D,) raw speaker embedding
    spk_emb_ids: int = 0
    seed: Optional[int] = None
    ensure_non_empty: bool = True
    stream_batch: int = 0    # >0: yield partial outputs every N steps
    return_hidden: bool = False
    # enqueue chunk k+1 before the host waits on chunk k's status, so the
    # wait overlaps the device's work; partial yields then see a buffer
    # the next chunk is writing, which is safe: every reader takes rows
    # below the chunk's kept counts, and those are final
    speculate: bool = False
    # with speculate=True, run this many chunks synchronously before
    # dispatch-ahead starts (streaming sets 2: the first emission is not
    # queued behind a speculative chunk)
    speculate_from: int = 0
    # fn(state, predicted kept-step count), called right after each chunk's
    # steps are ENQUEUED, before the host waits on its status; ``state``
    # has the full ``hiddens`` buffer and the ``end_idx`` after the chunk.
    # A streaming consumer enqueues its window vocode there.  The count is
    # exact unless generation finishes mid-chunk.
    on_dispatch: Optional[Callable] = None
    # progress hook fn(steps run), called only where the host already reads
    # the device (the finished flags every SYNC_EVERY steps, a streamed
    # chunk's status, the final outputs): it adds no synchronisation.  The
    # facade wires it to a bar for ``show_tqdm``
    on_progress: Optional[Callable[[int], None]] = None
    # noise(step) -> (N, V) Gumbel noise of that step's draw, to reproduce
    # another sampler's draws; None draws from a torch.Generator
    noise: Optional[Callable[[int], torch.Tensor]] = None


class _LoopState:
    """The step loop's state in one attempt: device tensors, and the host's
    step count and write row."""

    def __init__(self, hidden, hiddens, finish, end_idx, pos_next, cur):
        self.hidden = hidden        # (B, D) makes the next token's logits
        self.hiddens = hiddens      # (B, n_buf, D) every kept step's hidden
        self.finish = finish        # (B,) bool
        self.end_idx = end_idx      # (B,) kept tokens (pre-EOS)
        self.pos_next = pos_next    # (B,) rope position of the next token
        self.cur = cur              # cache row of the next token
        self.step = 0


class _Chunk:
    """One dispatched chunk: its step count, its kept counts on the device,
    and the host copies (in flight) of its finished flags, kept counts and
    ids."""

    def __init__(self, st: _LoopState, ids_buf: torch.Tensor, T0: int):
        self.steps = st.step
        self.end_idx = st.end_idx
        self.status = HostCopy(torch.stack([st.finish.long(), st.end_idx]))
        self.ids = HostCopy(ids_buf[:, T0:T0 + st.step])

    def all_finished(self) -> bool:
        return bool(np.asarray(self.status)[0].all())


class Generator:
    """Bucketing, the step loop, retry and output trimming."""

    def __init__(self, cfg: GPTConfig, gpt_params: dict, embed_params: dict,
                 prefill_bucket: int = 32, kv_bits: int = 8,
                 packed: Optional[dict] = None):
        """``kv_bits``: 8 keeps the KV cache in int8 rows with embedded
        scales (the default, as the reference's), 4 in nibble-packed rows
        with the same scales, 0 in bf16.  ``packed``: the decode kernel's
        weight layout, of any weight tier (``pack_weights(weight_bits=)``),
        when it is shared with engines of the same weights; bf16 if None."""
        self._quantize = kv_quantizer(kv_bits, cfg)
        self.cfg = cfg
        self.gpt_params = gpt_params
        self.embed_params = embed_params
        self.prefill_bucket = prefill_bucket
        self.kv_bits = kv_bits
        self.packed = (packed if packed is not None
                       else k1.pack_weights(gpt_params, cfg))
        self.device = gpt_params["norm"].device
        self._rng_counter = 0

    def _pad_prompt(self, req: GenerateRequest):
        """Left-extend prompts to the bucketed length (padding stays left)."""
        B, T0, _ = req.ids.shape
        Tpad = max(_round_up(T0, self.prefill_bucket), self.prefill_bucket)
        if Tpad == T0:
            return req.ids, req.attn_mask, req.text_mask, T0
        d = Tpad - T0
        ids = np.pad(req.ids, ((0, 0), (d, 0), (0, 0)))
        attn = np.pad(req.attn_mask, ((0, 0), (d, 0)))
        tmask = np.pad(req.text_mask, ((0, 0), (d, 0)))
        return ids, attn, tmask, Tpad

    def _next_seed(self, req: GenerateRequest, attempt: int) -> int:
        if req.seed is not None:
            return int(req.seed)
        self._rng_counter += 1
        seed = np.random.SeedSequence(
            [self._rng_counter, attempt]).generate_state(1)[0]
        return int(seed) & 0x7FFFFFFF

    def generate(self, req: GenerateRequest,
                 context: Optional[Interrupt] = None):
        """Generator yielding GenerationOutputs: when streaming, a partial
        one after each chunk that left a row unfinished, then the final."""
        context = context or Interrupt()
        max_attempts = 4 if (req.ensure_non_empty and req.seed is None) else 1
        for attempt in range(max_attempts):
            out, any_empty = yield from self._run_once(req, context, attempt)
            if not any_empty or attempt == max_attempts - 1 or context.get():
                yield out
                return
            if req.stream_batch > 0:
                # streaming consumers see the retry's restart as a yield
                # after an attempt's final (partial=False) output; without
                # it they would stitch two attempts together
                yield out

    def _prefill(self, req, ids, attn, tmask, T0, Tbuf):
        cfg, dev = self.cfg, self.device
        B = ids.shape[0]
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        attn_t = torch.as_tensor(attn, dtype=torch.bool, device=dev)
        tmask_t = torch.as_tensor(tmask, dtype=torch.bool, device=dev)
        emb0 = embed_mod.embed_prompt(self.embed_params, ids_t, tmask_t)
        if req.spk_vec is not None:
            spk = torch.as_tensor(req.spk_vec, dtype=torch.float32, device=dev)
            n = spk / torch.clamp(torch.linalg.vector_norm(spk), min=1e-12)
            cond = (ids_t[..., 0] == req.spk_emb_ids)[..., None]
            emb0 = torch.where(cond, n[None, None, :].to(emb0.dtype), emb0)
        positions = torch.clamp(torch.cumsum(attn_t.long(), dim=1) - 1, min=0)
        cache = llama.KVCache.create(cfg, B, Tbuf, device=dev)
        hidden_all, cache = llama.prefill(self.gpt_params, emb0, attn_t,
                                          positions, cache, cfg)
        HD = cfg.num_attention_heads * cfg.head_dim
        kc = torch.stack([c.reshape(B, Tbuf, HD) for c in cache.k])
        vc = torch.stack([c.reshape(B, Tbuf, HD) for c in cache.v])
        if self._quantize:  # the prefill -> decode boundary
            kc, vc = self._quantize(kc, cfg), self._quantize(vc, cfg)
        return hidden_all[:, -1], kc, vc, ids_t, attn_t

    def _run_once(self, req: GenerateRequest, context: Interrupt,
                  attempt: int):
        cfg, dev = self.cfg, self.device
        num_vq = cfg.num_vq
        ids, attn, tmask, T0 = self._pad_prompt(req)
        B = ids.shape[0]
        # buffer lengths are multiples of 8, as the reference's; generation
        # still stops at max_new and the rounded tail is never written
        n_buf = _round_up(req.max_new, 8)
        Tbuf = T0 + n_buf
        with profiling.span("generator.prefill", rows=B):
            hidden, kc, vc, ids0, attn_t = self._prefill(req, ids, attn,
                                                         tmask, T0, Tbuf)
        ids_buf = torch.zeros((B, Tbuf, num_vq), dtype=torch.long, device=dev)
        ids_buf[:, :T0] = ids0
        # first readable cache slot per row: left padding never changes, so
        # this is the reference's per-step argmax(key_valid) computed once
        # (a row with no prompt token first sees its own slot T0)
        lo = torch.where(attn_t.any(1), attn_t.int().argmax(1),
                         torch.full((B,), T0, dtype=torch.long, device=dev))
        pos_next = attn_t.long().sum(1)
        finish = torch.zeros((B,), dtype=torch.bool, device=dev)
        end_idx = torch.zeros((B,), dtype=torch.long, device=dev)
        hiddens = torch.zeros((B, n_buf, cfg.hidden_size), dtype=torch.float32,
                              device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._next_seed(req, attempt))
        sp = sampling.SamplingParams(
            temperature=torch.as_tensor(req.temperature, dtype=torch.float32,
                                        device=dev),
            top_p=float(req.top_p), top_k=int(req.top_k),
            repetition_penalty=float(req.repetition_penalty),
            min_new=int(req.min_new))
        if req.infer_text:
            eos, max_penalized = int(req.eos_token), cfg.num_text_tokens
        else:
            eos = max_penalized = cfg.num_audio_tokens - 1
        wpos_base = torch.arange(REP_WINDOW, device=dev)

        st = _LoopState(hidden=hidden, hiddens=hiddens, finish=finish,
                        end_idx=end_idx, pos_next=pos_next, cur=T0)

        def run_to(hi, stop):
            """Enqueue decode steps until ``st.step == hi``; at every
            SYNC_EVERY-th step leave early when ``stop()`` says so.  Each
            stretch between two such checks is one ``generator.steps``
            span."""
            while st.step < hi:
                if st.step % SYNC_EVERY == 0 and st.step and stop():
                    return
                n = min(hi, (st.step // SYNC_EVERY + 1) * SYNC_EVERY)
                with profiling.span("generator.steps", steps=n - st.step):
                    while st.step < n:
                        one_step()

        def one_step():
            step, cur = st.step, st.cur
            if req.infer_text:
                logits = embed_mod.head_text(self.embed_params, st.hidden)
            else:
                logits = embed_mod.head_code(
                    self.embed_params, st.hidden).reshape(
                        B * num_vq, cfg.num_audio_tokens)
            start = min(max(cur - REP_WINDOW, 0), Tbuf - REP_WINDOW)
            win = ids_buf[:, start:start + REP_WINDOW]
            wpos = start + wpos_base
            wmask = (wpos >= T0) & (wpos < cur)
            if req.infer_text:
                win_rows = win[:, :, 0]
            else:
                win_rows = win.transpose(1, 2).reshape(B * num_vq,
                                                       REP_WINDOW)
            wmask_rows = wmask[None].expand(win_rows.shape[0], REP_WINDOW)
            ids_next = sampling.sample(
                logits, sp, win_rows, wmask_rows, step, eos,
                max_penalized,
                noise=None if req.noise is None else req.noise(step),
                generator=gen)
            if req.infer_text:
                token = ids_next[:, None].expand(B, num_vq)
                eos_hit = ids_next == eos
            else:
                token = ids_next.reshape(B, num_vq)
                eos_hit = (token == eos).any(-1)
            # finish and end_idx are new tensors each step (a chunk's
            # snapshot keeps its own); the buffers are written in place
            st.finish = st.finish | eos_hit
            ids_buf[:, cur] = token
            hiddens[:, step] = st.hidden
            st.end_idx = st.end_idx + (~st.finish).long()

            emb = (embed_mod.embed_text_step(self.embed_params,
                                             token[:, 0])
                   if req.infer_text
                   else embed_mod.embed_code_step(self.embed_params,
                                                  token))
            x_out = k1.decode_step(self.packed, emb, kc, vc, cur, lo,
                                   st.pos_next, cfg)
            st.hidden = llama.rms_norm(x_out, self.gpt_params["norm"],
                                       cfg.rms_norm_eps)
            st.cur += 1
            st.pos_next = st.pos_next + 1
            st.step += 1

        def sync_stop():
            with profiling.span("generator.sync"):
                stop = bool(st.finish.all()) or context.get()
            if req.on_progress is not None:
                req.on_progress(st.step)
            return stop

        if req.stream_batch > 0:
            yield from self._stream_chunks(req, context, st, run_to,
                                           sync_stop, ids_buf, T0)
        else:
            run_to(req.max_new, sync_stop)
        return self._materialize(req, ids_buf, T0, st.end_idx, st.finish,
                                 hiddens, st.step)

    def _stream_chunks(self, req, context, st, run_to, sync_stop, ids_buf,
                       T0):
        """The streaming loop: chunks of ``stream_batch`` steps, a partial
        output after each chunk that left a row unfinished and stopped
        short of ``max_new`` (the reference's ``_run_once`` and
        ``_run_speculative``).  The first ``speculate_from`` chunks (all
        without ``speculate``) run synchronously; after them, chunk k+1 is
        enqueued before the host waits on chunk k's status copy, and stops
        early once chunk k's copy has landed and says every row finished
        (steps after that change nothing)."""
        chunk = req.stream_batch
        sync_until = (req.speculate_from * chunk if req.speculate
                      else req.max_new)
        pending = collections.deque()  # dispatched, not yet read
        hi = 0

        def ahead_stop(prev):
            if prev is None:
                return context.get
            return lambda: context.get() or (prev.status.ready()
                                             and prev.all_finished())

        def dispatch(stop):
            nonlocal hi
            hi = min(hi + chunk, req.max_new)
            run_to(hi, stop)
            pending.append(_Chunk(st, ids_buf, T0))
            if req.on_dispatch is not None:
                req.on_dispatch(st, hi)

        while hi < req.max_new or pending:
            ahead = hi >= sync_until
            if not pending:
                dispatch(ahead_stop(None) if ahead else sync_stop)
            if (ahead and hi < req.max_new and len(pending) < 2
                    and not context.get()):
                dispatch(ahead_stop(pending[-1]))
            done = pending.popleft()
            finished = done.all_finished()
            if req.on_progress is not None:
                req.on_progress(done.steps)
            if finished or context.get():
                break  # chunks in flight change no kept output
            if done.steps < req.max_new:
                yield self._partial(req, done, st.hiddens)

    def _partial(self, req, chunk: "_Chunk", hiddens) -> GenerationOutputs:
        """A streaming partial from a chunk's status and ids (its kept
        counts bound every read of the live buffers)."""
        status = np.asarray(chunk.status)
        return _outputs(req, np.asarray(chunk.ids).astype(np.int32),
                        status[1], status[0].astype(bool), hiddens,
                        chunk.end_idx, chunk.steps, partial=True)

    def _materialize(self, req, ids_buf, T0, end_idx, finish, hiddens, steps):
        with profiling.span("generator.materialize"):
            end = end_idx.cpu().numpy()
            if req.on_progress is not None:
                req.on_progress(steps)
            fin = finish.cpu().numpy()
            gen_ids = ids_buf[:, T0:].cpu().numpy().astype(np.int32)
            out = _outputs(req, gen_ids, end, fin, hiddens, end_idx, steps)
            return out, bool((fin & (end == 0)).any())


def _outputs(req: GenerateRequest, gen_ids: np.ndarray, end: np.ndarray,
             fin: np.ndarray, hiddens: torch.Tensor, end_dev: torch.Tensor,
             steps: int, partial: bool = False) -> GenerationOutputs:
    """GenerationOutputs from the generated ids on the host (B, >= kept,
    num_vq), the kept counts and finished flags; the hiddens stay on the
    device, up to the kept max."""
    out_ids = []
    for b in range(gen_ids.shape[0]):
        seq = gen_ids[b, : int(end[b])]
        out_ids.append(seq[:, 0].copy() if req.infer_text else seq.copy())
    out = GenerationOutputs(ids=out_ids, finished=fin, steps=steps,
                            partial=partial)
    if req.return_hidden:
        out.hiddens_dev = hiddens[:, :int(end.max()) if end.size else 0]
        out.end_dev = end_dev
    return out
