"""Continuous-batching serving engine (port of
``chattts_tpu/engine/batching.py``).

The engine owns one decode state of ``max_num_seqs`` slots (a dense KV
region per slot).  ``step()`` admits waiting requests into free slots (one
wave prefill per prompt bucket), runs one decode chunk, and harvests the
slots that finished; ``generate()`` is the offline loop over it.  The
scheduling policy is the reference's: FCFS admission, iteration-level
batching, per-request sampling state and seeds, any-codebook EOS, the
16-token repetition window, empty-generation retry, preemption by recompute
for fairness, interrupt, throughput and latency statistics.

What differs from the JAX package, and why:

* The reference compiles its chunk into one ``lax.while_loop``; here a chunk
  is a Python loop of decode steps, every one of them the whole-step CUDA
  kernel with a position per slot (``ops/decode_step.py``: K2+K3 on the
  default int8 cache, K2 with ``kv_bits=0``, K2+K6 with ``kv_bits=4``, on
  packed weights of any tier).  **No step reads anything back
  to the host**: positions, flags and counters live in device tensors that
  are updated in place, and one packed transfer (status scalars and the
  chunk's ids) follows the chunk.  On CUDA that transfer is a non-blocking
  copy into pinned memory plus an event, so with ``speculate`` chunk k+1 is
  enqueued before chunk k's status is read; on the CPU it is sequential.
* The per-row Gumbel noise (``ops/threefry.py``, the reference's generator
  in torch integer ops) is drawn for a block of steps at once: a live
  slot's depth grows by one a step, so the depths are known ahead.
* A Python loop cannot leave early when every slot has finished, so the
  host bounds the chunk by the most steps any running slot can still take
  (known from the last status).  Steps past a slot's end change none of its
  state: every write is gated on ``active & ~finish``.
* The state is a small class of tensors updated in place instead of a
  functional NamedTuple, and ``lo`` (a slot's first readable cache row,
  fixed at its prefill) replaces the reference's ``key_valid`` mask, whose
  only use in the fused path is to derive it.
* The XLA compile-population helpers (traced-index gathers, power-of-two
  padding, wave-size buckets, ahead-of-time compilation) have no
  counterpart: plain indexing.  ``warmup()`` builds the kernel and runs one
  request per prompt bucket.

Sharded over a mesh (``Engine(..., mesh=parallel.mesh.make_mesh(dp, tp))``,
the JAX engine's ``mesh=``), every rank runs this same scheduler on the
same requests (SPMD), so admission, preemption and harvest decide alike
everywhere; the host RNG of unseeded requests is drawn for every request
of a wave on every rank, in one order.  Slots split over ``dp`` in
contiguous blocks: a rank prefills and steps only its own ``S / dp``, and
its device state holds only those.  A chunk's packed transfer (the 7 x S
status block and every slot's ids) is one all_reduce over dp of each
rank's zero-padded block, so every rank reads every slot's status; at
harvest the finished slots' hiddens are gathered the same way from their
owners.  A slot's noise depends on its request's seed, attempt, depth and
codebook only, so where a slot lives changes no draw; but a rank's
products (the prefill, the heads) run at its own batch's shape, and a
library product may sum a row in an order its shape picks, so a dp
engine's hiddens agree with the unsharded one's to rounding, not bit for
bit (one rank of dp=1 is the unsharded engine exactly).  Under
``tp`` a rank holds its heads' caches and its slabs of the decoder
(``shard_params``, ``ops.decode_step.shard_packed``); the prefill and each
step (``ops.decode_step.decode_step_tp``: the step's gemvs and a layer's
attention as separate launches) sum the partials of ``wo`` and ``down``
over tp.  The embedding heads stay whole on every rank (the JAX specs
shard their vocab columns), so every tp rank samples the same token from
the same logits.  Under tp > 1 only bf16 weights and the bf16 or kv8
cache shard: ``shard_packed`` slices bf16 slabs only (an int8 scale group
spans D rows of the contraction, which wo's HD/tp does not hold), and kv4
rows need HD % 256 == 0 a rank; sp stays 1.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import GPTConfig
from ..models import embed as embed_mod
from ..models import llama
from ..ops import decode_step as step_mod
from ..ops import sampling, threefry
from ..ops.kv_quant import kv_quantizer, row_width
from ..parallel import mesh as mesh_mod
from ..utils import profiling
from .generate import REP_WINDOW, GenerationOutputs

# steps whose sampling noise is drawn in one go (bounds its memory: a block
# of the text vocabulary at 8 slots is 32 x 8 x 21178 values; at 128 slots
# it is 347 MB of f32, which a card holds)
NOISE_BLOCK = 32
# slots of the reference's documented int4-cache configuration (slot count
# over throughput; its CHATTTS_ENGINE_FUSED_SLOTS=64), not a kernel limit
KV4_SLOTS = 64
# rows of the per-chunk status block
_FINISH, _ACTIVE, _END, _STEP_IN, _MAX_NEW, _SEQ_OFF, _RAN = range(7)


def fused_slot_limit(kv_bits: int) -> int:
    """Widest slot count an engine serves on the cache tier it was asked
    for: 32 with the int8 cache, 16 with the bf16 cache (the reference's
    defaults; the 32-slot "wide" tier exists only with a quantized cache),
    and 64 with the int4 cache (the reference's documented 64-slot
    configuration).  A wider engine serves on the bf16 cache with bf16
    weights, as the reference's engine past its limit serves on its XLA
    step (``chattts_tpu/engine/batching.py``, ``_fused`` and ``_kvb``)."""
    return {0: 16, 8: 32, 4: KV4_SLOTS}[kv_bits]


@dataclass(frozen=True)
class EngineConfig:
    """Static engine geometry."""

    max_num_seqs: int = 8          # decode slots
    max_prompt_len: int = 256      # prompt region size in the slot cache
    # prompts left-pad to the smallest bucket that fits; None = one bucket
    # of max_prompt_len
    prompt_buckets: tuple = None
    max_new_tokens: int = 2048     # per-slot generation region
    chunk_steps: int = 16          # decode steps between host scheduling
    # chunk length of the offline ``generate`` loop when nothing is waiting:
    # the scheduler has nothing to decide between chunks, so longer chunks
    # amortize the per-chunk host sync.  ``step()`` keeps ``chunk_steps``:
    # the serving loop admits, aborts and preempts only at chunk boundaries.
    chunk_steps_max: int = 128
    # enqueue chunk k+1 before reading chunk k's status whenever the
    # scheduler is idle; costs at most one chunk of admission latency
    speculate: bool = True
    infer_text: bool = False       # text mode (refine pass) vs code mode
    text_eos_token: int = 0        # default EOS id in text mode
    collect_hidden: bool = True    # keep per-step hiddens (decoder path)
    # with requests waiting and no free slot, the running request with the
    # most steps left is preempted by recompute once it has held its slot
    # for this many chunks (None disables); it re-queues at the back with
    # its generated tokens as a teacher-forced prompt extension
    preempt_after_chunks: Optional[int] = None
    # at most this many device-streaming slots run at once (None = no cap)
    max_stream_slots: Optional[int] = None

    def __post_init__(self):
        # the per-chunk id transfer carries at most chunk_steps_max ids a slot
        if self.chunk_steps > self.chunk_steps_max:
            raise ValueError(
                f"chunk_steps ({self.chunk_steps}) must be <= "
                f"chunk_steps_max ({self.chunk_steps_max})")

    @property
    def cache_len(self) -> int:
        raw = self.max_prompt_len + self.max_new_tokens
        return ((raw + 7) // 8) * 8  # as the reference's; the tail is unused

    @property
    def buckets(self) -> tuple:
        bs = self.prompt_buckets or (self.max_prompt_len,)
        if any(b > self.max_prompt_len for b in bs):
            raise ValueError("prompt bucket exceeds max_prompt_len")
        return tuple(sorted(bs))


@dataclass
class EngineRequest:
    """One queued generation request."""

    request_id: str
    ids: np.ndarray              # (T0, num_vq) int32 prompt (unpadded)
    text_mask: np.ndarray        # (T0,) bool
    temperature: np.ndarray      # (num_vq,) or (1,)
    top_p: float = 0.7
    top_k: int = 20
    repetition_penalty: float = 1.0
    min_new: int = 0
    max_new: int = 2048
    eos_token: Optional[int] = None  # text mode: per-request EOS override
    spk_vec: Optional[np.ndarray] = None
    seed: Optional[int] = None   # per-request determinism (manual_seed)
    ensure_non_empty: bool = True  # retry on immediate EOS
    # streaming callback: fn(request_id, new_ids, new_hiddens, finished)
    on_tokens: Optional[Callable] = None
    # device-resident streaming: ``on_tokens`` receives a copy of the
    # request's whole (max_new, D) hiddens row on the device (rows past the
    # kept count are garbage; the id counts give the length)
    stream_hiddens_dev: bool = False
    # progress hook fn(tokens made), called at harvest from the chunk's
    # status read (no extra synchronisation); ``show_tqdm``'s bar
    on_progress: Optional[Callable] = None
    arrival: float = field(default_factory=time.monotonic)
    # -- engine-managed ----------------------------------------------------
    _attempts: int = 0           # ensure_non_empty retries so far
    _resume_ids: Optional[np.ndarray] = None      # (n, num_vq) generated
    _emitted: int = 0            # tokens already streamed via on_tokens
    _admit_t: float = 0.0        # first admission time (latency stats)
    _first_done: bool = False    # admit->first-emission already recorded

    @property
    def resume_len(self) -> int:
        return 0 if self._resume_ids is None else self._resume_ids.shape[0]


@dataclass
class EngineOutput:
    request_id: str
    ids: np.ndarray              # (T, num_vq) or (T,) generated tokens
    hiddens: Optional[np.ndarray]  # (T, D) host copy, or None (see below)
    finish_reason: str           # "eos" | "length"
    metrics: Dict[str, float] = field(default_factory=dict)
    # non-streaming requests keep their hiddens on the device (their only
    # consumer is the mel decoder); materialized on demand
    hiddens_dev: Optional[torch.Tensor] = None
    # all slots finishing in one chunk share one gathered (W, max_new, D)
    # batch; this output is row ``_hb_row``, length ``_hb_n``
    _hb: Optional[torch.Tensor] = None
    _hb_row: int = 0
    _hb_n: int = 0

    def dev_hiddens(self) -> Optional[torch.Tensor]:
        if self.hiddens_dev is None and self._hb is not None:
            self.hiddens_dev = self._hb[self._hb_row, : self._hb_n]
        return self.hiddens_dev

    def host_hiddens(self) -> Optional[np.ndarray]:
        if self.hiddens is None and self.dev_hiddens() is not None:
            self.hiddens = self.hiddens_dev.cpu().numpy()
        return self.hiddens


def outputs_to_generation(outs: List[EngineOutput]) -> GenerationOutputs:
    """Stack finished EngineOutputs into a GenerationOutputs batch.

    When every output kept its hiddens on the device, the batch stays there
    (``hiddens_dev`` + ``end_dev``) and feeds the device decode path.
    Outputs that share one harvest gather reuse it."""
    finished = np.asarray([o.finish_reason == "eos" for o in outs])
    ids = [o.ids for o in outs]
    if outs and all(o.hiddens_dev is not None or o._hb is not None
                    for o in outs):
        lens = [o._hb_n if o.hiddens_dev is None else o.hiddens_dev.shape[0]
                for o in outs]
        n_max = max(lens)
        hb0 = outs[0]._hb
        dev = (hb0 if hb0 is not None else outs[0].hiddens_dev).device
        end = torch.as_tensor(lens, dtype=torch.long, device=dev)
        if hb0 is not None and all(o._hb is hb0 for o in outs):
            rows = [o._hb_row for o in outs]
            hb = (hb0 if rows == list(range(hb0.shape[0]))
                  else hb0[torch.as_tensor(rows, device=dev)])
            # rows past a request's own length hold garbage from the
            # generation buffer; end_dev masks them in the decode
            return GenerationOutputs(ids=ids, finished=finished,
                                     hiddens_dev=hb[:, :n_max], end_dev=end)
        hb = torch.stack([
            torch.nn.functional.pad(
                o.dev_hiddens(), (0, 0, 0, n_max - o.dev_hiddens().shape[0]))
            for o in outs])
        return GenerationOutputs(ids=ids, finished=finished, hiddens_dev=hb,
                                 end_dev=end)
    return GenerationOutputs(ids=ids, finished=finished,
                             hiddens=[o.host_hiddens() for o in outs])


class SlotState:
    """Device-side engine state, one entry per slot along the first axis;
    every tensor is updated in place.  ``slots`` (default all) is a dp
    rank's share and ``heads`` (default the config's) a tp rank's."""

    def __init__(self, cfg: GPTConfig, ecfg: EngineConfig, kv_bits: int,
                 device, slots: Optional[int] = None, heads=None):
        S, Tc = slots or ecfg.max_num_seqs, ecfg.cache_len
        D, L = cfg.hidden_size, cfg.num_hidden_layers

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        # flat stacked caches, the decode kernel's layout
        cshape = (L, S, Tc, row_width(kv_bits, heads or cfg))
        cdtype = torch.int8 if kv_bits else torch.bfloat16
        self.kc = full(cshape, 0, cdtype)
        self.vc = full(cshape, 0, cdtype)
        self.ids = full((S, Tc, cfg.num_vq), 0, torch.long)
        self.lo = full((S,), 0, torch.long)       # first readable cache row
        self.hidden = full((S, D), 0.0, torch.float32)  # makes the next token
        self.cur = full((S,), ecfg.max_prompt_len, torch.long)  # next write row
        self.pos_next = full((S,), 0, torch.long)  # rope position of next token
        self.step_in = full((S,), 0, torch.long)   # tokens made this tenure
        self.active = full((S,), False, torch.bool)
        self.finish = full((S,), False, torch.bool)
        self.end_idx = full((S,), 0, torch.long)   # kept tokens (pre-EOS)
        hshape = ((S, ecfg.max_new_tokens, D) if ecfg.collect_hidden
                  else (S, 1, 1))
        self.hiddens = full(hshape, 0.0, torch.float32)
        self.temperature = full((S, cfg.num_vq), 1.0, torch.float32)
        self.top_p = full((S,), 1.0, torch.float32)
        self.top_k = full((S,), 0, torch.long)
        self.rep_penalty = full((S,), 1.0, torch.float32)
        self.min_new = full((S,), 0, torch.long)   # global bounds (against
        self.max_new = full((S,), ecfg.max_new_tokens, torch.long)  # seq_off
        self.eos = full((S,), 0, torch.long)       # + step_in)
        self.seq_off = full((S,), 0, torch.long)   # tokens made before this
        #                                            tenure (preemption resume)
        self.rng = full((S, 2), 0, torch.long)     # per-slot threefry keys
        self.ran = full((), 0, torch.long)         # steps of this chunk with
        #                                            a live slot


def _state_specs(cfg: GPTConfig, ecfg: EngineConfig) -> dict:
    """Placements of the :class:`SlotState` tensors on a (dp, sp, tp)
    mesh: slots over dp, the caches' heads over tp (a bf16 row is the heads'
    features in order; a kv8 rank's row is the same format over its own
    heads, so its shape is that of a shard but its scale lanes are made
    locally), everything else per slot.  The engine allocates each rank's
    shard directly."""
    P = mesh_mod.spec
    slot, cache = P("dp"), P(None, "dp", None, "tp")
    return {"kc": cache, "vc": cache, "ids": P("dp", None, None),
            "lo": slot, "hidden": P("dp", None), "cur": slot,
            "pos_next": slot, "step_in": slot, "active": slot,
            "finish": slot, "end_idx": slot, "hiddens": P("dp", None, None),
            "temperature": P("dp", None), "top_p": slot, "top_k": slot,
            "rep_penalty": slot, "min_new": slot, "max_new": slot,
            "eos": slot, "seq_off": slot, "rng": P("dp", None), "ran": P()}


class Engine:
    """FCFS continuous-batching engine over the slot state."""

    def __init__(self, cfg: GPTConfig, ecfg: EngineConfig, gpt_params: dict,
                 embed_params: dict, spk_emb_ids: int = 0, seed: int = 0,
                 packed: Optional[dict] = None, kv_bits: int = 8,
                 mesh: Optional[mesh_mod.Mesh] = None):
        """``packed``: the decode kernel's weight layout, shared with other
        engines and the Generator of the same weights (one copy).
        ``kv_bits``: 8 (int8 cache, the default), 4 (int4 cache) or 0
        (bf16 cache).  A rank's slots past ``fused_slot_limit(kv_bits)``
        are served as the reference serves them: on the bf16 cache with
        bf16 weights (``kv_bits`` then reads 0, and one line is logged),
        by the same CUDA step at that width.  ``mesh``: a (dp, sp, tp)
        mesh of which this process is a rank (see the module's
        docstring); the weights given are the full ones, every rank the
        same.  ``max_num_seqs`` must divide by dp."""
        dp, tp = 1, 1
        if mesh is not None:
            if mesh.coords is None:
                raise ValueError("this process is not a rank of the mesh")
            if mesh.shape["sp"] != 1:
                raise ValueError("a serving mesh keeps sp=1")
            dp, tp = mesh.shape["dp"], mesh.shape["tp"]
            if ecfg.max_num_seqs % dp:
                raise ValueError("max_num_seqs must divide dp size")
        self.mesh = mesh
        self._heads = step_mod.local_heads(cfg, tp)
        S_loc = ecfg.max_num_seqs // dp
        if kv_bits in (0, 8, 4) and S_loc > fused_slot_limit(kv_bits):
            logging.getLogger(__name__).warning(
                "%d slots (a rank's) exceed the %d of kv_bits=%d: serving "
                "on the bf16 cache with bf16 weights", S_loc,
                fused_slot_limit(kv_bits), kv_bits)
            kv_bits = 0
            if packed is not None and step_mod.weight_bits_of(packed, cfg):
                packed = None
        if tp > 1 and kv_bits == 4:
            raise ValueError("the kv4 cache does not shard over tp: its rows "
                             "need heads * head_dim % 256 == 0 on a rank")
        self._quantize = kv_quantizer(kv_bits, self._heads)
        ecfg.buckets  # validates the prompt buckets
        self.cfg = cfg
        self.ecfg = ecfg
        self.kv_bits = kv_bits
        self.embed_params = embed_params
        self.spk_emb_ids = spk_emb_ids
        self.device = gpt_params["norm"].device
        if packed is None:
            packed = step_mod.pack_weights(gpt_params, cfg)
        self._reduce = None  # the prefill's and the step's sum over tp
        if tp > 1:
            rank = mesh.coords["tp"]
            packed = step_mod.shard_packed(packed, cfg, tp, rank)
            gpt_params = mesh_mod.shard_params(
                gpt_params, mesh_mod.gpt_param_specs(cfg), mesh)
            self._reduce = lambda t: mesh.all_reduce(t, "tp")
        self.gpt_params = gpt_params
        self.packed = packed
        # global slots [base, base + S_loc) are this rank's
        self._base = mesh.coords["dp"] * S_loc if mesh is not None else 0
        self._slots_local = S_loc
        self.state = SlotState(cfg, ecfg, kv_bits, self.device, S_loc,
                               self._heads)
        self.waiting: collections.deque[EngineRequest] = collections.deque()
        self.slots: List[Optional[EngineRequest]] = [None] * ecfg.max_num_seqs
        self._slot_chunks = [0] * ecfg.max_num_seqs
        self._status = None  # per-slot scalars of the last processed chunk
        self._spec = None    # a chunk enqueued ahead: (transfer, event, steps)
        # per-slot generated ids on the host, fed by the per-chunk transfer;
        # harvest and preemption read these, never live device state
        Z = np.zeros((0, cfg.num_vq), np.int32)
        self._acc_ids: List[np.ndarray] = [Z] * ecfg.max_num_seqs
        self._entry_steps = [0] * ecfg.max_num_seqs
        self._host_rng = np.random.default_rng(seed ^ 0x5EED)
        # recomputed_tokens: prompt tokens prefilled again to resume
        # requests preempted by recompute (their prompts and the tokens
        # generated before the preemption)
        self.stats = {"tokens_generated": 0, "requests_finished": 0,
                      "steps": 0, "steps_launched": 0, "prefills": 0,
                      "recomputed_tokens": 0}
        self._lat_queue: collections.deque = collections.deque(maxlen=512)
        self._lat_first: collections.deque = collections.deque(maxlen=512)
        self._last_log = time.monotonic()
        S, nvq = S_loc, cfg.num_vq
        dev = self.device
        self._rows = torch.arange(S, device=dev)
        self._win = torch.arange(REP_WINDOW, device=dev)[None, :]
        self._codebooks = torch.arange(nvq, device=dev).repeat(S)

    # -- public API ----------------------------------------------------

    def add_request(self, req: EngineRequest) -> None:
        limit = max(self.ecfg.buckets)
        if req.ids.shape[0] > limit:
            raise ValueError(
                f"prompt length {req.ids.shape[0]} exceeds engine "
                f"prompt capacity {limit}")
        self.waiting.append(req)

    def abort_request(self, request_id: str) -> Optional[EngineRequest]:
        """Drop a queued or running request.  Fires the final
        ``on_tokens(rid, None, None, True)`` so a streaming consumer
        unblocks, and returns the dropped request (None when unknown)."""
        req = None
        for i, r in enumerate(self.waiting):
            if r.request_id == request_id:
                del self.waiting[i]
                req = r
                break
        if req is None:
            for s, r in enumerate(self.slots):
                if r is not None and r.request_id == request_id:
                    self.slots[s] = None
                    self._deactivate([s])
                    req = r
                    break
        if req is not None and req.on_tokens is not None:
            req.on_tokens(req.request_id, None, None, True)
        return req

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def interrupt(self) -> List[EngineRequest]:
        """Drain all queued and running requests; returns them.  Streaming
        callbacks get a final ``finished=True`` notification."""
        dropped = list(self.waiting)
        self.waiting.clear()
        for s, r in enumerate(self.slots):
            if r is not None:
                self.slots[s] = None
                dropped.append(r)
        self._spec = None  # an in-flight chunk's status is now irrelevant
        self.state.active.zero_()
        for r in dropped:
            if r.on_tokens is not None:
                r.on_tokens(r.request_id, None, None, True)
        return dropped

    def generate(self, requests: List[EngineRequest],
                 context=None) -> List[EngineOutput]:
        """Offline batch entry point.  ``context``: optional Interrupt flag
        polled between chunks; when set, active work is drained and whatever
        finished is returned."""
        for r in requests:
            self.add_request(r)
        outputs: List[EngineOutput] = []
        while self.has_unfinished():
            if context is not None and context.get():
                self.interrupt()
                break
            outputs.extend(self.step(long_chunk=True))
        order = {r.request_id: i for i, r in enumerate(requests)}
        outputs.sort(key=lambda o: order.get(o.request_id, 1 << 30))
        return outputs

    def warmup(self) -> None:
        """Build the decode kernel and run one one-token request per prompt
        bucket, so the first real request pays neither; leaves the engine
        empty with zeroed statistics."""
        nvq = self.cfg.num_vq
        prev_len = 0
        for b in self.ecfg.buckets:
            plen = max(1, prev_len + 1)  # smallest length mapping to b
            prev_len = b
            self.generate([EngineRequest(
                request_id=f"warmup-{b}",
                ids=np.zeros((plen, nvq), np.int32),
                text_mask=np.ones((plen,), bool),
                temperature=np.ones((nvq,), np.float32),
                min_new=1, max_new=1, seed=0, ensure_non_empty=False)])
        self.reset_stats()

    def step(self, long_chunk: bool = False) -> List[EngineOutput]:
        """Admit, run one decode chunk and harvest; one ``engine.step``
        span, its parts ``engine.preempt``, ``engine.admit`` (a
        ``engine.prefill`` a wave), ``engine.dispatch``, ``engine.ingest``
        and ``engine.harvest``."""
        with profiling.span("engine.step"):
            return self._step(long_chunk)

    def _step(self, long_chunk: bool) -> List[EngineOutput]:
        if self._spec is not None and all(r is None for r in self.slots):
            # the chunk enqueued ahead outlived its batch: it changed
            # nothing; drop its status so this step admits new work
            self._spec = None
        if self._spec is None:
            with profiling.span("engine.preempt"):
                self._maybe_preempt()
            with profiling.span("engine.admit"):
                self._admit()
            occ = sum(r is not None for r in self.slots)
            self.stats["peak_slots"] = max(
                self.stats.get("peak_slots", 0), occ)
            if not occ:
                return []
            pending = self._dispatch(long_chunk, inflight=0)
        else:
            pending = self._spec
            self._spec = None
        # Enqueue chunk k+1 before blocking on chunk k's status.  Safe
        # whenever no admission is pending: chunk k's status and ids ride
        # one transfer made before chunk k+1 starts, device writes are
        # append-only, and steps after every slot finished write nothing.
        # Not with host-hidden streamers (their harvest reads live state
        # and would wait out chunk k+1), and not while a device-streaming
        # slot has yet to emit its first window (its consumer's first
        # vocode would queue behind the extra chunk).
        if (self.ecfg.speculate and not self.waiting
                and any(r is not None for r in self.slots)
                and not (self.ecfg.collect_hidden and any(
                    r is not None and r.on_tokens is not None
                    and not r.stream_hiddens_dev for r in self.slots))
                and not any(r is not None and r.stream_hiddens_dev
                            and r.on_tokens is not None
                            and not r._first_done for r in self.slots)):
            # None when the in-flight chunk already covers every slot's end
            self._spec = self._dispatch(long_chunk, inflight=pending[2])
        with profiling.span("engine.ingest"):
            self._ingest(*pending)  # the one host read of the chunk
        # a rank's live steps are a prefix of the chunk: the longest counts
        self.stats["steps"] += int(self._status[_RAN].max())
        with profiling.span("engine.harvest") as sp:
            outs = self._harvest()
            sp.set(rids=[o.request_id for o in outs])
        return outs

    def _dispatch(self, long_chunk: bool, inflight: int):
        with profiling.span("engine.dispatch") as sp:
            pending = self._dispatch_chunk(long_chunk, inflight)
            sp.set(steps=0 if pending is None else pending[2])
        return pending

    # -- the decode chunk ------------------------------------------------

    def _noise_block(self, n: int) -> torch.Tensor:
        """Gumbel noise of the next ``n`` steps, (n, rows, V), rows = slots
        (text mode) or slots x codebooks.  A slot's key is folded by its
        global depth and then by the codebook, so a row's noise depends on
        (request seed, attempt, depth, codebook) only.  A live slot's depth
        grows by one a step, so step i of the block draws at today's depth
        + i; a slot that is dead or dies on the way uses none of its later
        rows.  One block costs what one step's noise would (the generator's
        rounds are elementwise), which keeps its few hundred small launches
        out of every step."""
        st, nvq = self.state, self.cfg.num_vq
        gstep = st.seq_off + st.step_in
        depth = (gstep[None, :] + torch.arange(
            n, device=self.device)[:, None]).reshape(-1)          # (n*S,)
        keys = threefry.fold_in(st.rng.repeat(n, 1), depth)
        if self.ecfg.infer_text:
            V = self.cfg.num_text_tokens
        else:
            V = self.cfg.num_audio_tokens
            keys = threefry.fold_in(keys.repeat_interleave(nvq, dim=0),
                                    self._codebooks.repeat(n))
        return threefry.gumbel_rows(keys, V).reshape(n, -1, V)

    def _decode_step(self, noise: torch.Tensor) -> None:
        """One step for every slot: head -> sample (with this step's
        ``noise``) -> embed -> decode kernel.  Device ops only; only live
        slots change state."""
        st, cfg, ecfg = self.state, self.cfg, self.ecfg
        S, nvq = self._slots_local, cfg.num_vq
        Tp, Tc = ecfg.max_prompt_len, ecfg.cache_len
        ep = self.embed_params
        live = st.active & ~st.finish
        gstep = st.seq_off + st.step_in  # global generated count per slot

        if ecfg.infer_text:
            logits = embed_mod.head_text(ep, st.hidden)
            temp = st.temperature[:, 0]

            def per_row(v):
                return v
            max_penalized = cfg.num_text_tokens
        else:
            logits = embed_mod.head_code(ep, st.hidden).reshape(
                S * nvq, cfg.num_audio_tokens)
            temp = st.temperature.reshape(-1)

            def per_row(v):
                return v.repeat_interleave(nvq, dim=0)
            max_penalized = cfg.num_audio_tokens - 1

        # per-slot trailing window over generated tokens: the generated
        # region starts at Tp - seq_off (a resumed request's earlier tokens
        # sit at the tail of its prompt and stay visible to the penalty)
        start = (st.cur - REP_WINDOW).clamp(0, Tc - REP_WINDOW)
        gather_pos = start[:, None] + self._win           # (S, W)
        win = st.ids.gather(
            1, gather_pos[:, :, None].expand(S, REP_WINDOW, nvq))
        wmask = ((gather_pos >= (Tp - st.seq_off)[:, None])
                 & (gather_pos < st.cur[:, None]))
        if ecfg.infer_text:
            win_rows = win[:, :, 0]
        else:
            win_rows = win.transpose(1, 2).reshape(S * nvq, REP_WINDOW)

        sp = sampling.SamplingParams(
            temperature=temp, top_p=per_row(st.top_p),
            top_k=per_row(st.top_k),
            repetition_penalty=per_row(st.rep_penalty),
            min_new=per_row(st.min_new))
        ids_next = sampling.sample(
            logits, sp, win_rows, per_row(wmask), per_row(gstep),
            per_row(st.eos), max_penalized, noise=noise)

        if ecfg.infer_text:
            token = ids_next[:, None].expand(S, nvq)
            eos_hit = ids_next == st.eos
        else:
            token = ids_next.reshape(S, nvq)
            eos_hit = (token == st.eos[:, None]).any(-1)

        # EOS drops the final token; a length stop keeps it
        eos_finish = live & eos_hit
        length_hit = (gstep + 1) >= st.max_new
        finish = st.finish | eos_finish | (live & length_hit)

        rows = self._rows
        # a slot that ran to the end of its region is dead with cur == Tc:
        # the row index is held inside the buffers for it (dead slots are
        # computed like any other and write nothing that is read again)
        cur = st.cur.clamp(max=Tc - 1)
        st.ids[rows, cur] = torch.where(live[:, None], token,
                                        st.ids[rows, cur])
        if ecfg.collect_hidden:
            # global position: the buffer index is the request's generated-
            # token index even across a preemption resume
            hid_pos = gstep.clamp(0, ecfg.max_new_tokens - 1)
            st.hiddens[rows, hid_pos] = torch.where(
                live[:, None], st.hidden, st.hiddens[rows, hid_pos])
        st.end_idx += (live & ~eos_finish).long()

        emb = (embed_mod.embed_text_step(ep, token[:, 0])
               if ecfg.infer_text else embed_mod.embed_code_step(ep, token))
        if self._reduce is None:
            x_out = step_mod.decode_step(self.packed, emb, st.kc, st.vc, cur,
                                         st.lo, st.pos_next, cfg)
        else:
            x_out = step_mod.decode_step_tp(
                self.packed, emb, st.kc, st.vc, cur, st.lo, st.pos_next, cfg,
                self._heads, self._reduce)
        hidden = llama.rms_norm(x_out, self.gpt_params["norm"],
                                cfg.rms_norm_eps)
        st.hidden = torch.where(live[:, None], hidden, st.hidden)
        inc = live.long()
        st.cur += inc
        st.pos_next += inc
        st.step_in += inc
        st.finish = finish
        st.ran += live.any().long()

    def _dispatch_chunk(self, long_chunk: bool, inflight: int):
        """Enqueue one chunk and its packed status transfer; returns
        (transfer, event, steps).  ``inflight``: steps of a chunk enqueued
        before this one whose status has not been read yet; when that chunk
        already reaches every running slot's end, nothing is enqueued and
        None is returned."""
        ecfg, st = self.ecfg, self.state
        chunk = ecfg.chunk_steps
        if (long_chunk and chunk < ecfg.chunk_steps_max
                and not self.waiting):
            # nothing to admit: amortize the per-chunk host sync
            chunk = ecfg.chunk_steps_max
        # the most steps a running slot can still take, from the last status
        # read; a slot that takes fewer of the in-flight chunk's steps has
        # finished in it
        left = max(min(r.max_new, ecfg.max_new_tokens) - r.resume_len
                   - self._entry_steps[s]
                   for s, r in enumerate(self.slots) if r is not None)
        if inflight and left <= inflight:
            return None
        n_steps = max(1, min(chunk, left - inflight))
        cur0 = st.cur.clone()  # per-slot write position at chunk entry
        st.ran.zero_()
        for i in range(n_steps):
            if i % NOISE_BLOCK == 0:
                noise = self._noise_block(min(NOISE_BLOCK, n_steps - i))
            self._decode_step(noise[i % NOISE_BLOCK])
        self.stats["steps_launched"] += n_steps
        S = self._slots_local
        status = torch.stack([
            st.finish.long(), st.active.long(), st.end_idx, st.step_in,
            st.max_new, st.seq_off, st.ran.expand(S)])
        gather_pos = (cur0[:, None] + torch.arange(
            n_steps, device=self.device)[None, :]).clamp(0, ecfg.cache_len - 1)
        ids_new = st.ids.gather(
            1, gather_pos[:, :, None].expand(S, n_steps, self.cfg.num_vq))
        if self.mesh is not None:
            # every slot's status and ids: this rank's block in its columns
            # of a zero block, summed over dp below (exact)
            status = self._all_slots(status, 1)
            ids_new = self._all_slots(ids_new, 0)
        flat = torch.cat([status.reshape(-1), ids_new.reshape(-1)])
        if self.mesh is not None:
            self.mesh.all_reduce(flat, "dp")
        event = None
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            flat = host
        for s, r in enumerate(self.slots):
            if r is not None:
                self._slot_chunks[s] += 1
        return flat, event, n_steps

    def _all_slots(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's per-slot block (its slots along ``dim``) in its place
        of a zero block over every slot."""
        shape = list(local.shape)
        shape[dim] = self.ecfg.max_num_seqs
        out = torch.zeros(shape, dtype=local.dtype, device=local.device)
        out.narrow(dim, self._base, self._slots_local).copy_(local)
        return out

    def _local(self, slots: List[int]) -> List[tuple]:
        """(position in ``slots``, local row) of the global slots this rank
        owns."""
        base, n = self._base, self._slots_local
        return [(i, s - base) for i, s in enumerate(slots)
                if base <= s < base + n]

    def _deactivate(self, slots: List[int]) -> None:
        rows = [r for _, r in self._local(slots)]
        if rows:
            self.state.active[torch.as_tensor(rows, device=self.device)] = \
                False

    def _slot_hiddens(self, slots: List[int],
                      rows: Optional[int] = None) -> torch.Tensor:
        """A copy of the first ``rows`` (default all) hidden rows of each of
        the global ``slots``, (len(slots), rows, D), on every rank: gathered
        from their owners by an all_reduce over dp of zero-padded parts."""
        st = self.state
        if self.mesh is None:
            idx = torch.as_tensor(slots, device=self.device)
            return st.hiddens[idx] if rows is None else st.hiddens[idx, :rows]
        rows = st.hiddens.shape[1] if rows is None else rows
        out = torch.zeros((len(slots), rows, st.hiddens.shape[2]),
                          dtype=st.hiddens.dtype, device=self.device)
        mine = self._local(slots)
        if mine:
            at = torch.as_tensor([i for i, _ in mine], device=self.device)
            loc = torch.as_tensor([r for _, r in mine], device=self.device)
            out[at] = st.hiddens[loc, :rows]
        return self.mesh.all_reduce(out, "dp")

    def _ingest(self, flat: torch.Tensor, event, n_steps: int) -> None:
        """Read a chunk's packed transfer: scheduling scalars and the ids
        generated in that chunk, appended to the per-slot host buffers."""
        if event is not None:
            event.synchronize()
        raw = flat.numpy()
        S, nvq = self.ecfg.max_num_seqs, self.cfg.num_vq
        self._status = raw[: 7 * S].reshape(7, S)
        deltas = raw[7 * S:].reshape(S, n_steps, nvq).astype(np.int32)
        step_in = self._status[_STEP_IN]
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            ran = int(step_in[s]) - self._entry_steps[s]
            if ran > 0:
                self._acc_ids[s] = np.concatenate(
                    [self._acc_ids[s], deltas[s, :ran]])
                self._entry_steps[s] = int(step_in[s])

    # -- admission ---------------------------------------------------------

    def _prompt_arrays(self, req: EngineRequest):
        """Prompt + teacher-forced resume tokens (preemption recompute)."""
        if req._resume_ids is None:
            return req.ids, req.text_mask
        ids = np.concatenate([req.ids, req._resume_ids.astype(np.int32)])
        tmask = np.concatenate(
            [req.text_mask, np.zeros((req.resume_len,), bool)])
        return ids, tmask

    def _admit(self):
        """Admit waiting requests into free slots: one wave prefill per
        prompt bucket, every host array of a wave uploaded once."""
        ecfg = self.ecfg
        wave: List = []  # (slot, req, bucket)
        free = [s for s in range(ecfg.max_num_seqs) if self.slots[s] is None]
        cap = ecfg.max_stream_slots
        stream_live = sum(1 for r in self.slots
                          if r is not None and r.stream_hiddens_dev)
        deferred: List[EngineRequest] = []  # streamers past the cap
        fi = 0
        while fi < len(free) and self.waiting:
            req = self.waiting.popleft()
            if (cap is not None and req.stream_hiddens_dev
                    and stream_live >= cap):
                deferred.append(req)  # later non-streaming work admits past
                continue
            s = free[fi]
            fi += 1
            stream_live += bool(req.stream_hiddens_dev)
            pids, _ = self._prompt_arrays(req)
            Tpb = next(b for b in ecfg.buckets if b >= pids.shape[0])
            wave.append((s, req, Tpb))
        for r in reversed(deferred):  # keep the queue's order at the front
            self.waiting.appendleft(r)
        for Tpb in sorted({b for _, _, b in wave}):
            group = [(s, r) for s, r, b in wave if b == Tpb]
            tokens = [r.ids.shape[0] + r.resume_len for _, r in group]
            resumed = [n for n, (_, r) in zip(tokens, group)
                       if r._resume_ids is not None]
            self.stats["recomputed_tokens"] += sum(resumed)
            with profiling.span(
                    "engine.prefill", rids=[r.request_id for _, r in group],
                    rows=len(group), tokens=sum(tokens),
                    resumed_rows=len(resumed), resumed_tokens=sum(resumed)):
                self._prefill_wave(Tpb, group)
            for s, req in group:
                self.slots[s] = req
                self._slot_chunks[s] = 0
                self._acc_ids[s] = np.zeros((0, self.cfg.num_vq), np.int32)
                self._entry_steps[s] = 0
                self.stats["prefills"] += 1
                if not req._admit_t:  # first admission only (not resumes)
                    req._admit_t = time.monotonic()
                    self._lat_queue.append(req._admit_t - req.arrival)

    def _prefill_wave(self, Tpb: int, group: List) -> None:
        """Prefill the prompts of ``group`` [(slot, request)], all of bucket
        ``Tpb``, in one batch, into cache rows [Tp - Tpb, Tp) of their
        slots, and set the slots' state.  Every rank reads every request
        of the wave (the host RNG of unseeded requests advances alike); a
        dp rank prefills only its own slots' rows."""
        cfg, ecfg, st, dev = self.cfg, self.ecfg, self.state, self.device
        nvq, D = cfg.num_vq, cfg.hidden_size
        Tp = ecfg.max_prompt_len
        off = Tp - Tpb
        W = len(group)
        ids_h = np.zeros((W, Tpb, nvq), np.int64)
        attn_h = np.zeros((W, Tpb), bool)
        tmask_h = np.zeros((W, Tpb), bool)
        spk_h = np.zeros((W, D), np.float32)
        has_spk_h = np.zeros((W,), bool)
        temp_h = np.zeros((W, nvq), np.float32)
        # top_p, rep | top_k, min_new, max_new, eos, seq_off, key0, key1
        fl_h = np.zeros((W, 2), np.float32)
        in_h = np.zeros((W, 7), np.int64)
        for i, (_, req) in enumerate(group):
            pids, ptmask = self._prompt_arrays(req)
            T0 = pids.shape[0]
            ids_h[i, Tpb - T0:] = pids
            attn_h[i, Tpb - T0:] = True
            tmask_h[i, Tpb - T0:] = ptmask
            if req.spk_vec is not None:
                spk_h[i] = req.spk_vec
                has_spk_h[i] = True
            temp = np.asarray(req.temperature, np.float32)
            temp_h[i] = temp if temp.shape[0] == nvq else float(temp[0])
            eos = (req.eos_token if req.eos_token is not None
                   else (ecfg.text_eos_token if ecfg.infer_text
                         else cfg.num_audio_tokens - 1))
            # the slot key derives from the request's seed alone (a retry
            # folds the attempt index in), on the host
            seed = (req.seed if req.seed is not None
                    else int(self._host_rng.integers(1 << 31)))
            key = threefry.host_slot_key(seed, req._attempts)
            fl_h[i] = (req.top_p, req.repetition_penalty)
            in_h[i] = (req.top_k, req.min_new,
                       min(req.max_new, ecfg.max_new_tokens), eos,
                       req.resume_len, int(key[0]), int(key[1]))

        mine = self._local([s for s, _ in group])
        if not mine:
            return  # another dp rank's slots
        pick = [i for i, _ in mine]
        W = len(mine)

        def up(a):
            return torch.from_numpy(a[pick]).to(dev)

        slots = torch.as_tensor([r for _, r in mine], device=dev)
        ids, attn, tmask = up(ids_h), up(attn_h), up(tmask_h)
        spk, has_spk, temp = up(spk_h), up(has_spk_h), up(temp_h)
        fl, ints = up(fl_h), up(in_h)
        seq_off = ints[:, 4]

        emb = embed_mod.embed_prompt(self.embed_params, ids, tmask)
        nvec = spk / torch.linalg.vector_norm(
            spk, dim=-1, keepdim=True).clamp(min=1e-12)
        cond = ((ids[..., 0] == self.spk_emb_ids)
                & has_spk[:, None])[..., None]
        emb = torch.where(cond, nvec[:, None, :].to(emb.dtype), emb)
        attn_i = attn.long()
        positions = (torch.cumsum(attn_i, dim=1) - 1).clamp(min=0)
        heads = self._heads
        mini = llama.KVCache.create(heads, W, Tpb, device=dev)
        hidden_all, mini = llama.prefill(self.gpt_params, emb, attn,
                                         positions, mini, cfg,
                                         reduce=self._reduce)
        HD = heads.num_attention_heads * heads.head_dim
        mk = torch.stack([c.reshape(W, Tpb, HD) for c in mini.k])
        mv = torch.stack([c.reshape(W, Tpb, HD) for c in mini.v])
        if self._quantize:
            # quantize at the prefill -> decode boundary; appended rows use
            # the same scheme in the kernel
            mk, mv = self._quantize(mk, heads), self._quantize(mv, heads)
        st.kc[:, slots, off:off + Tpb] = mk
        st.vc[:, slots, off:off + Tpb] = mv

        ids_pad = torch.zeros((W,) + tuple(st.ids.shape[1:]),
                              dtype=torch.long, device=dev)
        ids_pad[:, off:Tp] = ids
        st.ids[slots] = ids_pad
        if ecfg.collect_hidden:
            # preemption resume: the hiddens buffer uses global token
            # positions, so [0, seq_off) is re-seeded with the teacher-forced
            # prefix's hiddens, recomputed by this very prefill.  The
            # producer of generated token j sits at prompt position
            # Tpb - seq_off + j - 1.  Rows >= seq_off are zeroed.
            Hp = min(Tpb, ecfg.max_new_tokens)
            jr = torch.arange(Hp, device=dev)
            src = (Tpb - seq_off[:, None] - 1 + jr[None, :]).clamp(0, Tpb - 1)
            prefix = hidden_all.gather(
                1, src[:, :, None].expand(W, Hp, D))
            prefix = torch.where((jr[None, :] < seq_off[:, None])[:, :, None],
                                 prefix.to(st.hiddens.dtype), 0.0)
            st.hiddens[slots, :Hp] = prefix
        st.hidden[slots] = hidden_all[:, -1].to(st.hidden.dtype)
        st.lo[slots] = off + torch.where(
            attn.any(1), attn_i.argmax(1), torch.zeros_like(seq_off))
        st.cur[slots] = Tp
        st.pos_next[slots] = attn_i.sum(1)
        st.step_in[slots] = 0
        st.active[slots] = True
        st.finish[slots] = False
        st.end_idx[slots] = 0
        st.temperature[slots] = temp
        st.top_p[slots] = fl[:, 0]
        st.rep_penalty[slots] = fl[:, 1]
        st.top_k[slots] = ints[:, 0]
        st.min_new[slots] = ints[:, 1]
        st.max_new[slots] = ints[:, 2]
        st.eos[slots] = ints[:, 3]
        st.seq_off[slots] = seq_off
        st.rng[slots] = ints[:, 5:7]

    def _maybe_preempt(self):
        """Starvation control: preempt by recompute the running slot with
        the most steps left once the queue is blocked."""
        pa = self.ecfg.preempt_after_chunks
        if pa is None or not self.waiting or self._status is None:
            return
        if any(r is None for r in self.slots):
            return
        finish, _, end_idx, step_in, _, seq_off = self._status[:6]
        max_bucket = max(self.ecfg.buckets)
        cands = []
        for s, req in enumerate(self.slots):
            if req is None or finish[s] or self._slot_chunks[s] < pa:
                continue
            gen = int(end_idx[s])
            resume_total = req.ids.shape[0] + int(seq_off[s]) + gen
            if resume_total > max_bucket:
                continue  # the resume prompt would not fit; keep running
            remaining = req.max_new - int(seq_off[s]) - int(step_in[s])
            cands.append((remaining, s))
        if not cands:
            return
        _, s = max(cands)
        req = self.slots[s]
        gen = int(end_idx[s])
        # the ids are on the host already; the hiddens need no capture: the
        # resume prefill recomputes the prefix's hiddens into the new slot
        new_ids = self._acc_ids[s][:gen]
        prev = req._resume_ids
        req._resume_ids = (new_ids if prev is None
                           else np.concatenate([prev, new_ids]))
        self.slots[s] = None
        self._deactivate([s])
        # requeue at the back: long requests round-robin in time slices of
        # preempt_after_chunks chunks
        self.waiting.append(req)
        self.stats["preemptions"] = self.stats.get("preemptions", 0) + 1

    # -- harvest -----------------------------------------------------------

    def _new_ids_slice(self, s: int, req: EngineRequest, lo: int, n: int
                       ) -> np.ndarray:
        """Generated ids [lo, n) in global counts: the stashed resume prefix
        (tokens made before this tenure that were never streamed) stitched
        with this tenure's accumulated ids."""
        off = req.resume_len
        parts = []
        if lo < off:
            parts.append(req._resume_ids[lo:off].astype(np.int32))
        if n > off:
            parts.append(self._acc_ids[s][max(0, lo - off): n - off])
        if not parts:
            return np.zeros((0, self.cfg.num_vq), np.int32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _harvest(self) -> List[EngineOutput]:
        st = self.state
        finish, active, end_idx, step_in, max_new, _ = self._status[:6]
        outputs: List[EngineOutput] = []
        freed: List[int] = []  # slots released this harvest
        D = self.cfg.hidden_size

        def dev_hiddens_ok(req):
            # non-streaming and device-streaming requests keep hiddens on
            # the device; only host-streaming consumers need host windows
            return (self.ecfg.collect_hidden
                    and (req.on_tokens is None or req.stream_hiddens_dev))

        need_hid = 0
        need_rows: List[int] = []  # slots whose hiddens must reach the host
        for s, req in enumerate(self.slots):
            if req is None or not active[s]:
                continue
            off = req.resume_len
            need_s = 0
            if (req.on_tokens is not None and not req.stream_hiddens_dev
                    and off + step_in[s] > req._emitted):
                need_s = off + int(min(end_idx[s], step_in[s]))
            if finish[s] and not dev_hiddens_ok(req):
                need_s = max(need_s, off + int(end_idx[s]))
            if need_s:
                need_rows.append(s)
                need_hid = max(need_hid, need_s)
        hid_np = None
        hid_row = {}
        if need_rows and self.ecfg.collect_hidden:
            # one read of only the needing slots' windows
            nb = min(need_hid, st.hiddens.shape[1])
            hid_np = self._slot_hiddens(need_rows, nb).cpu().numpy()
            hid_row = {s: i for i, s in enumerate(need_rows)}
        dev_gather: List = []  # (output_index, slot, total) finishing slots
        for s, req in enumerate(self.slots):
            if req is None or not active[s]:
                continue
            off = req.resume_len  # tokens made before this slot tenure
            if req.on_progress is not None:
                req.on_progress(off + int(step_in[s]))
            fin = bool(finish[s])
            # decided before the streaming callback: a silently retried
            # attempt must not emit its finished=True notification
            total_fin = off + int(end_idx[s])
            will_retry = (fin and total_fin == 0
                          and total_fin < int(max_new[s])
                          and req.ensure_non_empty and req._attempts < 3)
            # streaming callback with the new tokens (global counts).  A
            # finishing slot always gets its final notification, even when
            # the chunk added no kept token.
            if (req.on_tokens is not None and not will_retry
                    and off + step_in[s] > req._emitted):
                n = off + int(min(end_idx[s], step_in[s]))
                lo = req._emitted
                if n > lo or fin:
                    new_ids = self._new_ids_slice(s, req, lo, n)
                    if not self.ecfg.collect_hidden:
                        new_hid = None
                    elif req.stream_hiddens_dev:
                        # a copy of the slot's whole row, made before any
                        # later chunk or prefill rewrites it (stream order)
                        new_hid = self._slot_hiddens([s])[0]
                    else:
                        new_hid = (hid_np[hid_row[s], lo:n] if n > lo
                                   else np.zeros((0, D), np.float32))
                    req.on_tokens(req.request_id, new_ids, new_hid, fin)
                    req._emitted = n
                    if not req._first_done:
                        req._first_done = True
                        self._lat_first.append(
                            time.monotonic() - req._admit_t)
            if not finish[s]:
                continue
            n = int(end_idx[s])
            seq = self._acc_ids[s][:n]
            if req._resume_ids is not None:
                seq = np.concatenate([req._resume_ids.astype(np.int32), seq])
            total = off + n
            out_ids = seq[:, 0].copy() if self.ecfg.infer_text else seq.copy()
            hid = None
            use_gather = False
            if self.ecfg.collect_hidden:
                if dev_hiddens_ok(req):
                    use_gather = True  # one batched gather below
                else:
                    hid = (hid_np[hid_row[s], :total].copy() if total
                           else np.zeros((0, D), np.float32))
            reason = "length" if total >= int(max_new[s]) else "eos"
            self.slots[s] = None
            freed.append(s)
            if will_retry:
                # empty generation: re-dispatch with the attempt index
                # folded into the key
                req._attempts += 1
                self.waiting.appendleft(req)
                self.stats["retries"] = self.stats.get("retries", 0) + 1
                continue
            if not req._first_done:  # non-streaming: the output is the
                req._first_done = True  # first emission
                self._lat_first.append(time.monotonic() - req._admit_t)
            out = EngineOutput(
                request_id=req.request_id, ids=out_ids, hiddens=hid,
                finish_reason=reason,
                metrics={"gen_tokens": float(total),
                         "latency_s": time.monotonic() - req.arrival})
            if use_gather:
                dev_gather.append((len(outputs), s, total))
            outputs.append(out)
            self.stats["tokens_generated"] += total
            self.stats["requests_finished"] += 1
        if freed:
            self._deactivate(freed)
        if dev_gather:
            # one gather for every slot finishing in this chunk; a copy, made
            # before the freed slots' rows can be rewritten (stream order).
            # Sharded, only the rows the outputs keep cross ranks
            rows = (None if self.mesh is None
                    else max(1, max(n for _, _, n in dev_gather)))
            hb = self._slot_hiddens([s for _, s, _ in dev_gather], rows)
            for row, (oi, _, n) in enumerate(dev_gather):
                outputs[oi]._hb = hb
                outputs[oi]._hb_row = row
                outputs[oi]._hb_n = n
        self._maybe_log()
        return outputs

    # -- statistics ----------------------------------------------------------

    def latency_stats(self) -> Dict[str, float]:
        """Rolling-window latency percentiles (seconds): submit->admit queue
        delay and admit->first-emission."""
        out: Dict[str, float] = {}
        for name, window in (("queue_delay", self._lat_queue),
                             ("first_emission", self._lat_first)):
            if window:
                v = np.sort(np.asarray(window, np.float64))
                out[f"{name}_p50_s"] = float(v[len(v) // 2])
                out[f"{name}_p90_s"] = float(v[(len(v) * 9) // 10])
                out[f"{name}_max_s"] = float(v[-1])
                out[f"{name}_n"] = len(v)
        return out

    def _maybe_log(self):
        now = time.monotonic()
        if now - self._last_log < 5.0:
            return
        self._last_log = now
        occ = sum(r is not None for r in self.slots)
        lat = self.latency_stats()
        logging.getLogger(__name__).info(
            "engine: %d/%d slots, %d waiting, %d finished, %d tokens, "
            "queue p50 %.0f ms, first-emission p50 %.0f ms",
            occ, self.ecfg.max_num_seqs, len(self.waiting),
            self.stats["requests_finished"], self.stats["tokens_generated"],
            lat.get("queue_delay_p50_s", 0.0) * 1e3,
            lat.get("first_emission_p50_s", 0.0) * 1e3)

    def reset_stats(self) -> None:
        """Zero the counters and drop the latency windows, so percentiles
        measure real traffic rather than warm-up requests."""
        for k in self.stats:
            self.stats[k] = 0
        self.stats.pop("peak_slots", None)
        self._lat_queue.clear()
        self._lat_first.clear()
