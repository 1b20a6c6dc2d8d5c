"""Concurrent TTS service: many requests share the engine's decode slots
(port of ``chattts_tpu/serving.py``).

The reference's OpenAI API serializes the whole model behind one asyncio
lock (``examples/api/openai_api.py:67,205``) even when the vLLM engine
could batch.  Here a single engine thread owns engine stepping while
request threads submit work and wait:

    request thread: normalize -> tokenize -> submit(refine) -> wait
                    -> submit(code) -> wait/stream -> vocode -> PCM
    engine thread:  while work: step(text engine); step(code engine);
                    fulfill futures / push stream increments

Two overlapping requests therefore run in ADJACENT SLOTS of the same
decode chunk instead of back-to-back (velocity/llm_engine.py:637-665
continuous batching, made end-to-end).  Engine mutations (add_request,
step, harvest) all happen under one mutex; the window vocode runs in the
request threads.  On the card every thread enqueues on the default stream,
so a request thread's window decode runs after the engine thread's copy of the
hidden row it reads.

Every blocking wait of a request thread has a limit (``timeout``): a
waiter that hears nothing for that long gets a ``TimeoutError`` and its
request is aborted, so a stalled engine fails its callers instead of
hanging them.

Under a profiler (``utils/profiling.span``) the engine thread records
``service.lock`` (waiting for the mutex) and ``service.step`` (its pass
over the engines), a ``synthesize`` thread ``service.synthesize`` around
its request, with ``service.wait`` while it is blocked on its mailbox
and its own vocode's ``chat.decode_to_wavs``.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import uuid
from typing import Iterator, List, Optional

import numpy as np

from .core import Chat
from .engine.batching import EngineRequest, outputs_to_generation
from .engine.streaming import EmissionPacer
from .models.speaker import Speaker
from .utils import profiling
from .utils.logger import get_logger

logger = get_logger("chattts_tpu_torch.serving")


class _IncQueue:
    """Bounded streaming-increment queue (defense against slow consumers).

    Each item is ``(cum_hiddens_row, count, finished)`` where the hidden row
    is the request's CUMULATIVE device buffer - a later item strictly
    supersedes an earlier non-final one.  When the consumer lags more than
    ``maxsize`` chunks behind, the newest non-final increment REPLACES the
    previous one instead of appending, so an abandoned or stalled consumer
    pins at most ``maxsize`` device hidden-row snapshots (~6 MB each at
    capacity shape) instead of one per decode chunk.  Final notifications
    always append (they carry the terminal state and must not be dropped).
    """

    def __init__(self, maxsize: int = 4):
        self._cv = threading.Condition()
        self._items: collections.deque = collections.deque()
        self.maxsize = maxsize

    def put(self, item) -> None:
        with self._cv:
            if (len(self._items) >= self.maxsize and not item[2]
                    and self._items and not self._items[-1][2]):
                self._items[-1] = item  # cumulative row: newest supersedes
            else:
                self._items.append(item)
            self._cv.notify()

    def get(self, timeout: Optional[float] = None):
        """The next item; raises TimeoutError after ``timeout`` seconds
        without one."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._items, timeout):
                raise TimeoutError(f"no stream increment in {timeout} s")
            return self._items.popleft()

    def drain(self) -> None:
        with self._cv:
            self._items.clear()

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)


class TTSService:
    """Thread-safe concurrent synthesis over one loaded :class:`Chat`.

    The service's engine thread exclusively steps the capacity code engine
    and the text engine.  While a service is attached, submit through the
    service API; calling ``chat.infer(use_engine=True)`` concurrently on
    the SAME chat would step a shared engine from a second thread (small
    requests that route to the facade's private "fast" tier are safe).
    """

    def __init__(self, chat: Chat, warmup: Optional[bool] = None,
                 timeout: float = 600.0):
        """``warmup``: run ``Engine.warmup`` and one stream at construction;
        None means on where the chat runs on CUDA.  ``timeout``: seconds a
        request thread waits for its next result before it gives up."""
        if not chat.has_loaded():
            raise ValueError("Chat must be loaded")
        self.chat = chat
        self.timeout = timeout
        # The engine thread owns a FIXED engine set, snapshotted here (lazy
        # creation would race submitters).  The service always submits to
        # the capacity code tier + the text engine; other tiers the facade
        # creates lazily for its own direct calls (e.g. "fast") are stepped
        # by their creating thread's loop and must never be stepped here
        # too - Engine is not thread-safe, and re-scanning the tier dict
        # would also race its mutation.
        self._engs = [chat._engine_for_code(), chat._engine_for_text()]
        # stream_batch values whose window decode has run in this process
        # (warmup_stream or a stream that decoded a window).  The
        # engine-thread first-window dispatch (see synthesize_stream's
        # on_tokens) is gated on this: a window shape's first decode pays
        # first-hit costs (on the card: cuDNN and cuFFT set-up for the new
        # shape), and paying them in the engine thread under self._mu
        # would stall every concurrent stream - the stall class
        # Engine.warmup exists to prevent.  A cold cadence's first stream
        # pays them in its own consumer thread instead (slower for that one
        # request only) and warms the set.
        self._warm_windows: set = set()
        if warmup is None:
            # on where first-hit costs are large: on the card, the first
            # build of the decode kernel (nvcc) and cuDNN/cuFFT set-up per
            # new shape; on the CPU they are small, and tests skip them
            warmup = chat.device.type == "cuda"
        if warmup:
            for eng in self._engs:
                eng.warmup()
        self._mu = threading.Lock()      # guards both engines + pending map
        self._work = threading.Event()
        # rid -> (mailbox, owning engine): failures are scoped per engine
        self._pending: dict[str, tuple] = {}
        self._stop = False
        self.max_concurrent_slots = 0    # peak code-engine occupancy (stats)
        self._thread = threading.Thread(target=self._step_engines,
                                        daemon=True, name="tts-engine-thread")
        self._thread.start()
        if warmup:
            self.warmup_stream()

    def warmup_stream(self,
                      params_code: Optional[Chat.InferCodeParams] = None,
                      ) -> None:
        """Run ONE short synthetic stream end-to-end, then reset stats.

        ``Engine.warmup`` covers the engine's first-hit costs (the kernel
        build, a prefill per bucket, a decode chunk), but the STREAMING
        surface has its own: the per-``stream_batch`` window shape's
        cuDNN/cuFFT set-up and the final flush's shapes.  Construction runs
        this with DEFAULT cadence params; deployments using a custom
        ``stream_batch``/``stream_speed`` should call it once with those
        params at startup (each distinct ``stream_batch`` is a distinct
        window shape).  Latency windows and counters reset afterwards so
        production percentiles measure real traffic only (vLLM's
        profile-run analog: velocity/worker.py:91-123 sizes caches with a
        dummy forward at init for the same keep-it-out-of-the-request-path
        reason)."""
        p = params_code or Chat.InferCodeParams(show_tqdm=False)
        # 96 steps: enough for the withheld first yields AND >= one
        # mid-stream emission window AND the silence-stripped tail flush
        # at the default cadence
        p = dataclasses.replace(p, max_new_token=96, min_new_token=96,
                                manual_seed=0)
        for _ in self.synthesize_stream("Warm up the streaming path.", p):
            pass
        # under _mu: the engine thread lazily inserts stats keys inside
        # step() (also under _mu) - resetting concurrently would die with
        # "dictionary changed size during iteration" and silently wipe
        # live traffic's counters
        with self._mu:
            for eng in self._engines():
                eng.reset_stats()
            self.max_concurrent_slots = 0

    def close(self):
        self._stop = True
        self._work.set()
        self._thread.join(timeout=5)

    # -- the engine thread -------------------------------------------------

    def _engines(self):
        return self._engs

    def _step_engines(self):
        was_busy = False
        while not self._stop:
            self._work.wait(timeout=0.25)
            if not was_busy and self._work.is_set() and not self._stop:
                # admission coalescing at the idle->busy transition: a wave
                # of concurrent submissions (the serving norm - N clients
                # fire together) lands in ONE prefill wave instead of the
                # first racer taking a solo chunk that delays the rest by
                # two chunk quanta.  Costs the first racer ~4 ms; the
                # steady-state busy loop never sleeps.
                time.sleep(0.004)
            with profiling.span("service.lock"):
                self._mu.acquire()
            try:
                busy = self._step_pass()
            finally:
                self._mu.release()
            was_busy = busy
            # let a request thread waiting on the mutex (a submission, an
            # abort, stats) take it before the next step: the lock is not
            # fair, and this loop would otherwise re-take it at once
            time.sleep(0)

    def _step_pass(self) -> bool:
        """One pass of the engine thread over the engines, under the
        mutex (a ``service.step`` span); whether any had work."""
        busy = False
        with profiling.span("service.step"):
            for eng in self._engines():
                if not eng.has_unfinished():
                    continue
                busy = True
                try:
                    outs = eng.step()
                except Exception:  # noqa: BLE001 - a dead engine would
                    # leave its waiters blocked; fail THEM (and only
                    # them - requests on the other, healthy engine keep
                    # running: per-engine abort semantics, reference
                    # llm_engine.py:365-371)
                    logger.exception("engine step failed; failing its "
                                     "in-flight requests")
                    eng.interrupt()
                    for rid in [r for r, (_, owner) in
                                self._pending.items() if owner is eng]:
                        self._pending.pop(rid)[0].put(None)
                    continue
                if not eng.ecfg.infer_text:
                    self.max_concurrent_slots = max(
                        self.max_concurrent_slots,
                        eng.stats.get("peak_slots", 0))
                for o in outs:
                    entry = self._pending.pop(o.request_id, None)
                    if entry is not None:
                        entry[0].put(o)
            if not busy:
                self._work.clear()
        return busy

    def stats(self) -> dict:
        """Live service snapshot: per-engine occupancy + rolling latency
        percentiles (Engine.latency_stats), so serving collapses are
        observable (reference analog: record_metrics-style logging,
        velocity/llm_engine.py:667-740).  Taken under the mutex: the
        engine thread mutates the engines' statistics inside step()."""
        with self._mu:
            snap: dict = {"peak_slots": self.max_concurrent_slots,
                          "pending": len(self._pending)}
            for eng in self._engines():
                key = "text" if eng.ecfg.infer_text else "code"
                snap[key] = {
                    "slots_busy": sum(r is not None for r in eng.slots),
                    "slots": eng.ecfg.max_num_seqs,
                    "waiting": len(eng.waiting),
                    **eng.stats, **eng.latency_stats()}
            return snap

    def abort(self, request_id: str) -> bool:
        """Drop ONE queued or running request (engine ``abort_request``
        parity, reference llm_engine.py:365-371).  Its blocked waiter
        unblocks: a ``synthesize`` mailbox raises InterruptedError, a
        ``synthesize_stream`` iterator receives its final notification and
        ends - nothing hangs."""
        with self._mu:
            for eng in self._engines():
                if eng.abort_request(request_id) is not None:
                    entry = self._pending.pop(request_id, None)
                    if entry is not None:
                        entry[0].put(None)
                    return True
        return False

    def interrupt(self) -> int:
        """Drop all queued/running work; blocked waiters get an
        InterruptedError instead of hanging."""
        n = 0
        with self._mu:
            for eng in self._engines():
                dropped = eng.interrupt()
                n += len(dropped)
                for r in dropped:
                    entry = self._pending.pop(r.request_id, None)
                    if entry is not None:
                        entry[0].put(None)
        return n

    def _result(self, mailbox, request_id: str):
        """The request's output; aborts it and raises TimeoutError when
        none arrives within ``self.timeout`` seconds."""
        try:
            with profiling.span("service.wait", rids=(request_id,)):
                out = mailbox.get(timeout=self.timeout)
        except queue.Empty:
            self.abort(request_id)
            raise TimeoutError(f"request {request_id} got no result in "
                               f"{self.timeout} s") from None
        if out is None:
            raise InterruptedError("request dropped (interrupt/failure)")
        return out

    def _submit(self, eng, reqs) -> List["queue.Queue"]:
        futs = []
        with self._mu:
            for r in reqs:
                mailbox = queue.Queue(maxsize=1)
                self._pending[r.request_id] = (mailbox, eng)
                eng.add_request(r)
                futs.append(mailbox)
        self._work.set()
        return futs

    def _results(self, eng, reqs) -> list:
        futs = self._submit(eng, reqs)
        return [self._result(f, r.request_id) for f, r in zip(futs, reqs)]

    # -- public API --------------------------------------------------------

    def refine(self, texts: List[str],
               params: Optional[Chat.RefineTextParams] = None) -> List[str]:
        """Refine-text pass through the shared text engine."""
        c = self.chat
        params = params or Chat.RefineTextParams()
        texts = [c.normalizer(t, True, True, None) for t in texts]
        prompts = Speaker.decorate_text_prompts(texts, params.prompt)
        ids, attn, tmask = c.tokenizer.encode(prompts, c.config.gpt.num_vq)
        reqs = []
        for b in range(ids.shape[0]):
            n = int(attn[b].sum())
            reqs.append(EngineRequest(
                request_id=f"svc-refine-{uuid.uuid4().hex[:12]}",
                ids=ids[b, ids.shape[1] - n:],
                text_mask=tmask[b, ids.shape[1] - n:],
                temperature=np.asarray([params.temperature], np.float32),
                top_p=params.top_P, top_k=params.top_K,
                repetition_penalty=params.repetition_penalty,
                min_new=params.min_new_token, max_new=params.max_new_token,
                seed=params.manual_seed,
                ensure_non_empty=params.ensure_non_empty))
        outs = self._results(c._engine_for_text(), reqs)
        kept = [o.ids[o.ids < c.tokenizer.break_0_ids] for o in outs]
        return c.tokenizer.decode(kept)

    def _code_reqs(self, texts, params, on_tokens=None):
        reqs = self.chat._code_requests(texts, params, on_tokens=on_tokens)
        for r in reqs:
            r.request_id = f"svc-code-{uuid.uuid4().hex[:12]}"
        return reqs

    def synthesize(self, text: str,
                   params_refine: Optional[Chat.RefineTextParams] = None,
                   params_code: Optional[Chat.InferCodeParams] = None,
                   skip_refine_text: bool = False) -> np.ndarray:
        """Text -> float32 waveform; blocking, but engine work overlaps with
        every other in-flight request."""
        c = self.chat
        params_code = params_code or Chat.InferCodeParams()
        with profiling.span("service.synthesize") as sp:
            texts = [text] if skip_refine_text else self.refine(
                [text], params_refine)
            reqs = self._code_reqs(texts, params_code)
            sp.set(rids=[r.request_id for r in reqs])
            outs = self._results(c._engine_for_code(), reqs)
            # device-resident hiddens (when kept) feed the device decode
            # path
            wavs = c._decode_to_wavs(outputs_to_generation(outs),
                                     use_decoder=True)
            keep = [w[np.abs(w) > 1e-5] for w in wavs]
            return (np.concatenate(keep) if keep
                    else np.zeros((0,), np.float32))

    def synthesize_stream(self, text: str,
                          params_code: Optional[Chat.InferCodeParams] = None,
                          ) -> Iterator[np.ndarray]:
        """Streaming synthesis; chunks arrive as the shared engine decodes.

        Device-resident end to end: the engine hands a copy of the slot's
        whole hidden row on the device (stream_hiddens_dev), the window
        vocode slices/pads/decodes there, and only finished PCM goes to
        the host - no per-chunk hidden download or per-window re-upload
        (the velocity fork keeps hiddens in outputs for exactly this
        consumer, sequence.py:84-88).

        Emission follows the facade's streaming machinery exactly: the
        reference cadence (withhold ``pass_first_n_batches`` yields, then
        ``stream_speed``-sample windows, silence-stripped tail - reference
        core.py:487-503) and deferred PCM (AsyncDeviceWindows: chunk k's
        sample copies transfer while chunk k+1 decodes), both via the
        shared :class:`EmissionPacer`."""
        c = self.chat
        params = params_code or Chat.InferCodeParams()
        rt = c.config.runtime
        inc_q = _IncQueue()
        count = [0]
        first_spec = [rt.stream_window_ahead]

        defer = rt.stream_window_ahead
        sd = c._device_stream_decoder(1, params.stream_batch,
                                      async_windows=defer)
        pacer = EmissionPacer(1, params.pass_first_n_batches,
                              params.stream_speed, rt.wire_int16)

        def on_tokens(rid, new_ids, new_hid, finished):
            # new_hid is a copy of the FULL (max_new, D) device hiddens
            # row; the true kept length rides the id counts (no device
            # sync needed)
            if new_ids is not None:
                count[0] += new_ids.shape[0]
            if first_spec[0] and new_hid is not None and count[0] \
                    and not finished:
                # dispatch the FIRST emission's window vocode + its host
                # copy HERE, in the engine thread at harvest time -
                # before that thread dispatches the next decode chunk.  The
                # consumer thread then materializes a window that is
                # already enqueued instead of racing the next chunk for
                # the device queue.  First increment only: the consumer
                # is still blocked on the queue, so touching the decoder
                # from this thread cannot race it (exactness contract:
                # speculate_window entries are consumed only on an exact
                # (emitted, lo, hi, pad_left) key match).  first_spec is
                # consumed HERE even when the warm gate below skips the
                # dispatch: later increments run concurrently with the
                # consumer, so the thread-safety argument only holds for
                # the very first one.
                first_spec[0] = False
                if params.stream_batch in self._warm_windows:
                    # a cold cadence's first window decode pays first-hit
                    # costs, which in this thread (under the service
                    # mutex, via _drive) would stall every concurrent
                    # stream - let the consumer thread pay them
                    sd.speculate_window(new_hid[None], count[0])
            inc_q.put((new_hid, count[0], finished))

        reqs = self._code_reqs([text], params, on_tokens=on_tokens)
        for r in reqs:
            r.stream_hiddens_dev = True
        rid = reqs[0].request_id
        self._submit(c._engine_for_code(), reqs)
        cum = None
        n = 0
        finished = False
        try:
            while not finished:
                new_hid, n, finished = inc_q.get(timeout=self.timeout)
                if new_hid is not None:
                    cum = new_hid  # full (max_new, D) device row
                if cum is None or n == 0:
                    continue
                # full fixed-shape row: one window shape; rows beyond n
                # are garbage but every decode window ends at <= n
                chunk = sd.update_dev(cum[None], n, final=finished)
                # the cadence is warm only once a window has really been
                # decoded (emitted advances only through a window decode;
                # an increment within the first guard decodes none): later
                # streams may then dispatch their first window from the
                # engine thread (see on_tokens).  The reference
                # marks it warm after the first update_dev, decoded or not.
                if sd.emitted:
                    self._warm_windows.add(params.stream_batch)
                emit = pacer.push(chunk, final=finished)
                if emit is not None:
                    yield emit
            tail = None
            if cum is not None and n and sd.emitted < sd.available:
                tail = sd.update_dev(cum[None], n, final=True)
            final_chunk = pacer.flush(tail)
            if final_chunk.size:
                yield final_chunk
        finally:
            # consumer abandonment (GeneratorExit when an HTTP client
            # disconnects mid-stream, a timeout, or any exception in the
            # consumer): without the abort the slot keeps decoding to
            # max_new and on_tokens keeps copying device hidden rows nobody
            # reads - abort frees the shared slot NOW (reference semantics:
            # cooperative interrupt gpt.py:103-111,592 + engine abort
            # llm_engine.py:365-371).  Harmless after normal completion.
            if not finished:
                self.abort(rid)
            inc_q.drain()
