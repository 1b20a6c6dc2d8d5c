"""Incremental streaming vocoder: decode only what's new, emit what's final
(port of ``chattts_tpu/engine/streaming.py``).

The reference's streaming path re-runs the full DVAE+Vocos stack over ALL
accumulated hidden states on every yield and then slices out a window
(``ChatTTS/core.py:475-503``) - O(T^2) total vocoder work and a growing
per-yield latency.  The conv stacks have a finite receptive field, so a
sample is *final* once its full receptive cone of hidden positions exists.
This module decodes a fixed-size sliding window per yield:

    window = [emitted - ctx, n)      decode
    emit   = [emitted, n - guard)    new final samples

``guard`` >= the total receptive field (decoder ConvNeXt stack + Vocos
backbone + ISTFT overlap, in hidden positions) makes the emitted samples
equal to a full-sequence decode up to float reassociation; ``ctx`` >= the
same bound provides the left context.  Each yield costs O(window) instead of
O(T), and the window has one shape, so cuDNN and cuFFT set up once.

Frame math: 1 hidden position -> 2 mel frames -> 512 samples (hop 256).

The numpy pieces (``plan_windows``, ``StreamingDecoder``, ``EmissionPacer``)
are the reference's, unchanged.  The device pieces take torch tensors: a
window decoded on the card goes to the host through :func:`copy_to_host_async`,
a non-blocking copy into pinned memory with a CUDA event recorded after it;
every reader waits on that event (``np.asarray`` of the returned
:class:`HostCopy`).  Windows of one stream are enqueued on the stream that
writes the hidden buffer, so a window reads its positions in stream order.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

SAMPLES_PER_HIDDEN = 512  # 2 mel frames x hop 256


class HostCopy:
    """A tensor's copy on the host, possibly still in flight.

    For a CUDA tensor: a non-blocking copy into pinned memory, and a CUDA
    event recorded after it on the tensor's current stream; reading
    (``np.asarray``) waits on that event.  For a CPU tensor
    no copy is made: the tensor is its own host copy."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cpu":
            self._host, self._event = t, None
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    @property
    def shape(self):
        return self._host.shape

    def ready(self) -> bool:
        """Whether the copy has landed (never waits)."""
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


def copy_to_host_async(t: torch.Tensor) -> HostCopy:
    """Start a device->host copy of ``t``; returns its :class:`HostCopy`.
    A documented no-op on a CPU tensor; on CUDA it works or raises."""
    return HostCopy(t)


def conv_stack_receptive(n_layer: int, kernel: int, dilation: int) -> int:
    """One-sided receptive field of a DVAE-style stack, in its own frames."""
    rf = 1 + 1  # conv_in: two k=3 p=1 convs
    rf += n_layer * dilation * (kernel // 2)  # dilated depthwise convs
    rf += 1  # out_conv k=3 (DVAE-level)
    return rf


def plan_windows(decoder_stack, vocos_cfg, stream_batch: int = 24
                 ) -> tuple[int, int, int]:
    """(ctx, guard, window) in hidden positions from actual receptive fields.

    guard must cover the mel-domain receptive cone of the decoder stack +
    Vocos backbone + the ISTFT overlap (n_fft/hop frames), halved into
    hidden positions (1 hidden -> 2 mel frames).
    """
    rf_mel = conv_stack_receptive(
        decoder_stack.n_layer, decoder_stack.kernel, decoder_stack.dilation)
    rf_mel += 3 + vocos_cfg.num_layers * 3  # embed k7 + ConvNeXt k7 blocks
    rf_mel += vocos_cfg.n_fft // vocos_cfg.hop_length  # ISTFT overlap
    guard = -(-rf_mel // 2) + 2
    ctx = guard + 8
    window = ctx + guard + max(stream_batch + 8, 16)
    window = ((window + 15) // 16) * 16  # bucket the compile shape
    return ctx, guard, window


class StreamingDecoder:
    """Stateful incremental hidden(or code)->waveform decoder for one batch.

    ``decode_fn(batch) -> np.ndarray (B, n_samples)`` must run the full
    mel+vocoder chain on a (B, W, C) window (the facade passes its
    decoder+vocos pipeline).  ``feature_dim`` is 768 hidden dims or num_vq
    code ids; dtype float32 / int32 respectively.
    """

    def __init__(
        self,
        decode_fn: Callable[[np.ndarray], np.ndarray],
        batch: int,
        feature_dim: int,
        ctx: int = 64,
        guard: int = 56,
        window: int = 160,
        int_features: bool = False,
        first_guard: Optional[int] = None,
    ):
        """``first_guard`` (< guard) trades exactness of the very first
        emission for latency: until anything has been emitted, samples only
        ``first_guard`` positions from the cone edge may go out.  Conv-tail
        influence decays fast with distance (see test_streaming first-guard
        decay test), so a small first_guard is a TTFA lever with a bounded,
        front-of-utterance-only approximation; everything after the first
        emission uses the exact guard."""
        if window < ctx + guard + 8:
            raise ValueError("window too small for ctx + guard")
        self.decode_fn = decode_fn
        self.ctx = ctx
        self.guard = guard
        self.first_guard = guard if first_guard is None else min(first_guard,
                                                                 guard)
        self.window = window
        self.emitted = 0  # hidden positions fully emitted
        self.dtype = np.int32 if int_features else np.float32
        self._feats = np.zeros((batch, 0, feature_dim), self.dtype)

    @property
    def available(self) -> int:
        return self._feats.shape[1]

    def update(self, feats_list: List[np.ndarray], final: bool = False
               ) -> np.ndarray:
        """Feed cumulative per-sequence features; returns newly-final samples.

        feats_list: one (Ti, C) array per sequence (cumulative, as produced
        by the generator's partial outputs).  Returns (B, new_samples).
        """
        n = max((f.shape[0] for f in feats_list), default=0)
        B = self._feats.shape[0]
        if n > self.available:
            grown = np.zeros((B, n, self._feats.shape[2]), self.dtype)
            grown[:, : self.available] = self._feats
            for b, f in enumerate(feats_list):
                grown[b, : f.shape[0]] = f
            self._feats = grown
        return self._walk(n, final)

    def _decode_window(self, lo: int, hi: int, pad_left: int) -> np.ndarray:
        """Decode hidden positions [lo, hi) zero-padded to the window shape;
        returns the full (B, (2*window-1)*hop) sample window."""
        win = self._feats[:, lo:hi]
        pad = self.window - win.shape[1]
        if pad:
            win = np.pad(win, ((0, 0), (pad_left, pad - pad_left), (0, 0)))
        return np.asarray(self.decode_fn(win))

    def _batch(self) -> int:
        return self._feats.shape[0]

    def _plan_walk(self, e: int, n: int, final: bool):
        """Yield the window decodes a ``_walk(n, final)`` starting at
        ``emitted == e`` performs: (e, lo, hi, emit_hi, pad_left, is_last).

        A PURE function of (e, n, geometry) - the walk itself consumes it,
        and the speculation paths replay it ahead of time to key
        decoded-ahead windows (the prediction and the consumption can
        therefore never drift apart)."""
        g = self.first_guard if e == 0 else self.guard
        target = n if final else n - g
        while e < target:
            lo = max(0, e - self.ctx)
            hi = min(n, lo + self.window)
            is_last = final and hi == n
            if is_last:
                # right-align so the true sequence end sits ON the window
                # edge: the convs' own zero padding then matches a
                # full-sequence decode exactly.  Mid-stream windows pad on
                # the right instead, where the guard shields the emission
                # region; zero padding is NOT inert inside the tensor
                # (LayerNorm maps zero vectors to its bias), so which side
                # gets padded matters.
                lo = max(0, hi - self.window)
            emit_hi = hi if is_last else min(hi - g, target)
            if emit_hi <= e:
                break  # window cannot make progress (guard >= window - ctx)
            # left padding is only safe when the emission start is at least
            # a receptive field away from it; very short utterances fall
            # back to right padding - the same zero-pad tail the reference's
            # batched decode produces (core.py:522-530 pads to batch max)
            pad_left = (self.window - (hi - lo)
                        if (is_last and e - lo >= self.guard) else 0)
            yield e, lo, hi, emit_hi, pad_left, is_last
            e = emit_hi

    def _walk(self, n: int, final: bool) -> np.ndarray:
        """Advance emission as far as the guard allows over [0, n)."""
        out = []
        for e, lo, hi, emit_hi, pad_left, is_last in self._plan_walk(
                self.emitted, n, final):
            wav = self._decode_window(lo, hi, pad_left)
            a = (pad_left + e - lo) * SAMPLES_PER_HIDDEN
            b = (pad_left + emit_hi - lo) * SAMPLES_PER_HIDDEN
            if is_last:
                # true signal ends at frame 2*(pad_left + hi - lo); its last
                # sample in a full decode is (2*len - 1) * hop
                b = min(b, (2 * (pad_left + hi - lo) - 1)
                        * (SAMPLES_PER_HIDDEN // 2))
            b = min(b, wav.shape[1])
            out.append(self._slice(wav, a, b))
            self.emitted = emit_hi
        return self._cat(out)

    def _slice(self, wav, a: int, b: int):
        return wav[:, a:b]

    def _cat(self, out: list):
        if not out:
            return np.zeros((self._batch(), 0), np.float32)
        return np.concatenate(out, axis=1)


class DeviceStreamingDecoder(StreamingDecoder):
    """Streaming decoder whose features never leave the accelerator.

    The generator's partial outputs keep hidden states device-resident
    (GenerationOutputs.hiddens_dev); each emission slices/pads/masks the
    window ON DEVICE, vocodes there, and transfers only the finished sample
    window (optionally as int16 PCM).  Eliminates the per-chunk hidden
    download and per-window upload of the host-side decoder.

    ``decode_window_dev(feats_dev, lo, hi, pad_left, end_dev) -> device wav
    window`` is built by the facade (``core.Chat._device_window_fn``).
    Speculated windows are kept as :class:`HostCopy` objects.
    """

    def __init__(self, decode_window_dev, batch: int, feature_dim: int,
                 wire_int16: bool = False, **kw):
        super().__init__(decode_fn=None, batch=batch,
                         feature_dim=feature_dim, **kw)
        self._decode_window_dev = decode_window_dev
        self._wire_int16 = wire_int16
        self._feats_dev = None
        self._end_dev = None
        self._n = 0
        self._feats = np.zeros((batch, 0, 1), np.float32)  # unused storage
        # window speculation (speculate_window): decoded-ahead sample
        # windows keyed by (emitted, lo, hi), host copies in flight
        self._specs: dict = {}
        self._plan_e = 0  # predicted ``emitted`` after in-flight chunks
        # strictly-increasing chunk counts speculated but not yet consumed
        # by update_dev; _plan_e is re-derived from (emitted, _plan_ns) at
        # each consume so a dispatch-ahead chunk's plan survives the
        # consume of the chunk before it
        self._plan_ns: list = []

    @property
    def available(self) -> int:
        return self._n

    def _batch(self) -> int:
        return self._bsz

    def update_dev(self, feats_dev, n: int, final: bool = False,
                   end_dev=None) -> np.ndarray:
        """feats_dev: (B, N, C) device array (cumulative, N >= n).

        ``end_dev``: optional (B,) device per-row generated lengths; hidden
        positions at/after a row's end are zero-masked inside the window
        decode (finished rows keep accumulating garbage hiddens in the
        generation buffer - without the mask they'd bleed into the last
        receptive-field positions of shorter rows, where the one-shot
        decode uses zeros)."""
        self._feats_dev = feats_dev
        if end_dev is not None:
            self._end_dev = end_dev
        self._bsz = feats_dev.shape[0]
        self._n = max(self._n, int(n))
        out = self._walk(self._n, final)
        # Reconcile the speculation plan.  Chunks are consumed in order,
        # so any speculated count <= the consumed n is behind us
        # (including a mispredicted final chunk's larger count - final
        # clears everything); the plan position is then re-derived from
        # the TRUE emitted state through the still-in-flight chunks, so
        # a dispatch-ahead speculation issued before this consume keeps
        # its (correct) forward-keyed plan instead of being clobbered.
        if final:
            self._plan_ns = []
            self._specs = {}
        else:
            self._plan_ns = [m for m in self._plan_ns if m > self._n]
        e = self.emitted
        for m in self._plan_ns:
            e = self._sim_walk(e, m)
        self._plan_e = e
        return out

    def update(self, feats_list, final: bool = False) -> np.ndarray:
        raise TypeError("device decoder consumes update_dev()")

    def _sim_walk(self, e: int, n: int) -> int:
        """Predict ``emitted`` after a NON-final ``_walk(n)`` from ``e``."""
        for step in self._plan_walk(e, n, False):
            e = step[3]  # emit_hi
        return e

    def speculate_window(self, feats_dev, n: int, end_dev=None) -> None:
        """Dispatch the next emission window AHEAD of the chunk status read.

        Decode chunks advance in host-predictable step counts, and the
        emission plan depends only on (emitted, n, geometry) - so right
        after chunk k is *dispatched* the consumer already knows which
        window ``_walk`` will decode when chunk k's status arrives.
        Dispatching that window decode + async PCM copy here makes the
        sample transfer overlap the blocking status round trip (~25 ms
        on the reference's host link) instead of serializing after it.

        Exactness: a speculated window is consumed (``_take_spec``) only
        when the inline call's (emitted, lo, hi, pad_left=0) arguments
        match the speculated key - the same torch ops on the same window
        values = bit-identical output.  Content under the window is stable
        between speculation and consumption: generation buffers are
        append-only below ``n``, and the end-mask agrees because
        ``hi <= n`` keeps unfinished rows (end >= n) unmasked while
        finished rows' ends are frozen.  A wrong prediction (generation
        finished mid-chunk, empty-generation restart) just leaves an
        unconsumed entry.

        ``feats_dev`` may be the FULL generation buffer - the window fn
        masks positions >= hi.  The window decode is enqueued on the
        current stream, after the decode steps that write positions < hi.
        """
        n = int(n)
        last = self._plan_ns[-1] if self._plan_ns else self._n
        if n <= last:
            return  # no-op speculative chunk: adds no new positions
        e = max(self.emitted, self._plan_e)
        for e0, lo, hi, _, pad_left, _ in self._plan_walk(e, n, False):
            key = (e0, lo, hi, pad_left)
            if len(self._specs) >= 4 and key not in self._specs:
                break  # bound in-flight windows; NEVER evict older
                # entries - specs are consumed oldest-first, so evicting
                # the head discards exactly the window the pending
                # update_dev needs and re-decodes it inline
            if key not in self._specs:
                self._specs[key] = copy_to_host_async(self._decode_window_dev(
                    feats_dev, lo, hi, pad_left, end_dev))
        self._plan_ns.append(n)
        self._plan_e = self._sim_walk(e, n)

    def speculate_final(self, feats_dev, n: int, end_dev=None) -> None:
        """Dispatch the FINAL flush's windows at final-chunk dispatch time.

        When the host knows the chunk it just enqueued ends generation
        (its predicted kept-step count reaches max_new), the final
        ``_walk(n, final=True)`` plan - including the right-aligned
        pad_left tail windows - is already determined.  Dispatching those
        vocodes + async PCM copies here overlaps the last chunk's status
        round trip AND the final assembly's serial vocode tail.  Same
        exactness contract as ``speculate_window``: entries are consumed
        only on an exact (emitted, lo, hi, pad_left) match, and the
        enqueued decodes read the generation buffer AFTER the final chunk
        writes it (stream order).  A misprediction (a row
        EOSed mid-chunk, shrinking the kept max) strands the entries,
        which the final consume then clears.

        Unbounded on purpose (unlike the in-flight window bound): the
        flush may span several windows and every entry is consumed or
        cleared by the final ``update_dev``.
        """
        n = int(n)
        e = max(self.emitted, self._plan_e)
        for e0, lo, hi, _, pad_left, _ in self._plan_walk(e, n, True):
            key = (e0, lo, hi, pad_left)
            if key not in self._specs:
                self._specs[key] = copy_to_host_async(self._decode_window_dev(
                    feats_dev, lo, hi, pad_left, end_dev))

    def _take_spec(self, lo: int, hi: int, pad_left: int):
        """Pop a speculated window matching the inline decode arguments."""
        if not self._specs:
            return None
        wav = self._specs.pop((self.emitted, lo, hi, pad_left), None)
        if self._specs:
            # entries planned for an already-passed emitted state can
            # never match again (emitted is monotonic)
            self._specs = {k: v for k, v in self._specs.items()
                           if k[0] >= self.emitted}
        return wav

    def _decode_window(self, lo: int, hi: int, pad_left: int) -> np.ndarray:
        wav = self._take_spec(lo, hi, pad_left)
        if wav is None:
            wav = copy_to_host_async(self._decode_window_dev(
                self._feats_dev, lo, hi, pad_left, self._end_dev))
        out = np.asarray(wav)
        if self._wire_int16:
            return out.astype(np.float32) / 32767.0
        return out


class AsyncDeviceWindows(DeviceStreamingDecoder):
    """Window collector for the PIPELINED non-streaming path.

    Same emission plan as the parent, but nothing is materialized inline:
    ``update_dev`` returns a LIST of sample-window slices whose host copies
    are in flight (:class:`HostCopy`) - they transfer while the next decode
    chunk computes on device, and the caller materializes them (waiting on
    each copy's event) one push later.  int16 wire scaling is the caller's
    job at assembly.  A speculated window's host copy is whole already; it
    is sliced on the host once it has landed."""

    def _decode_window(self, lo: int, hi: int, pad_left: int):
        wav = self._take_spec(lo, hi, pad_left)
        if wav is not None:
            return wav
        return self._decode_window_dev(self._feats_dev, lo, hi, pad_left,
                                       self._end_dev)

    def _slice(self, wav, a: int, b: int):
        if isinstance(wav, HostCopy):
            return _HostSlice(wav, a, b)
        return copy_to_host_async(wav[:, a:b])

    def _cat(self, out: list):
        return out


class _HostSlice:
    """Columns [a, b) of a :class:`HostCopy`, read when materialized."""

    def __init__(self, src: HostCopy, a: int, b: int):
        self._src, self._a, self._b = src, a, b

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self._src)[:, self._a:self._b]
        return out if dtype is None else out.astype(dtype)


class EmissionPacer:
    """Reference emission cadence + deferred-PCM assembly, shared by every
    streaming consumer (Chat._stream_batch and TTSService.synthesize_stream
    - keep them from drifting).

    Cadence mirrors the reference (core.py:487-503): withhold the first
    ``pass_first_n`` pushes, then each push emits UP TO ``stream_speed``
    samples (excess stays pending for the next push); ``flush`` emits
    whatever remains, silence-stripped (core.py:501-503).

    A push accepts either a materialized (B, n) array (plain decoders) or a
    LIST of device sample slices with async host copies in flight
    (:class:`AsyncDeviceWindows`).  Deferred lists materialize one push
    LATE - chunk k's PCM transfers while chunk k+1 computes - except the
    TTFA-critical pushes before the first emission and the final one, which
    materialize immediately.  ``wire_int16`` dequantizes deferred int16
    slices at materialization (non-deferred decoders scale internally)."""

    def __init__(self, batch: int, pass_first_n: int, stream_speed: int,
                 wire_int16: bool):
        self.pass_first_n = pass_first_n
        self.stream_speed = stream_speed
        self.wire = wire_int16
        self.pending = np.zeros((batch, 0), np.float32)
        self.deferred: list = []
        self.push_count = 0
        self.emitted_any = False

    def _mat(self, parts: list) -> np.ndarray:
        if not parts:
            return np.zeros((self.pending.shape[0], 0), np.float32)
        out = np.concatenate([np.asarray(p) for p in parts], axis=1)
        return out.astype(np.float32) / 32767.0 if self.wire else out

    def push(self, chunk, final: bool = False) -> Optional[np.ndarray]:
        """Absorb one decode chunk's samples; returns the window to emit
        (None when nothing should be yielded this push)."""
        if isinstance(chunk, list):
            if final or not self.emitted_any:
                chunk = self._mat(self.deferred + chunk)
                self.deferred = []
            else:
                self.deferred, chunk = chunk, self._mat(self.deferred)
        self.pending = np.concatenate([self.pending, chunk], axis=1)
        self.push_count += 1
        if self.push_count <= self.pass_first_n:
            return None
        emit = self.pending[:, : self.stream_speed]
        self.pending = self.pending[:, self.stream_speed :]
        if emit.size:
            self.emitted_any = True
            return emit
        return None

    def flush(self, tail=None) -> np.ndarray:
        """Final emission: absorb an optional tail chunk, materialize any
        deferred windows, silence-strip, and return the remainder."""
        if tail is not None:
            if isinstance(tail, list):
                self.deferred = self.deferred + tail
            else:
                if self.deferred:
                    self.pending = np.concatenate(
                        [self.pending, self._mat(self.deferred)], axis=1)
                    self.deferred = []
                self.pending = np.concatenate([self.pending, tail], axis=1)
        if self.deferred:
            self.pending = np.concatenate(
                [self.pending, self._mat(self.deferred)], axis=1)
            self.deferred = []
        keep = np.sum(np.abs(self.pending) > 1e-5, axis=0) > 0
        return self.pending[:, keep]
