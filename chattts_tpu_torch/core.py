"""Chat: the public facade (port of ``chattts_tpu/core.py``).

Two passes per batch of texts, as in the reference: the refine-text pass
rewrites the normalized text through the text head, then the code pass
samples 4-codebook audio codes and keeps the hidden states, which the mel
decoder and Vocos turn into 24 kHz audio in one shot (the reference's
``_device_decode``) or, pipelined, chunk by chunk as it is generated.  Both passes run the
Generator, or with ``use_engine=True`` the continuous-batching Engine
(``engine/batching.py``), whose slots concurrent callers share; either way
every decode step is the hand-written kernel of ``ops/decode_step.py`` on
CUDA, on the int8 KV cache unless ``kv_bits=0`` asks for bf16 or
``kv_bits=4`` for int4 rows, with bf16 weights unless ``weight_bits=8`` or
``4`` asks for the quantized tiers.

A text that ``split_text`` cuts into several segments, with no ``spk_smp``
given, takes the reference's auto-clone branch: segment 0 is synthesized
first, its wav encoded to codes by the DVAE encoder
(:meth:`Chat.sample_audio_speaker`), and those codes prompt every segment.
``use_decoder=False`` decodes the sampled codes through the DVAE's GFSQ
embed and its own decoder stack instead of the hiddens.

With ``runtime.pipelined_decode`` (off unless set; the environment variable
``CHATTTS_PIPELINED_DECODE=0/1`` overrides it both ways), non-streaming
synthesis vocodes while it generates (:meth:`Chat._pipelined_wavs`): the
code pass yields every ``pipeline_chunk`` steps, each chunk goes through
the conv-state stream functions (``models/convnext.py``, ``dvae.py``,
``vocos.py``, ``ops/stft.py``) or, for a chunk too short for the conv
stacks' offset, through exact-guard windows, and each piece of PCM starts
its copy to the host at once.  ``show_tqdm`` draws a bar over each pass
(``utils/progress.py``), fed at the host reads the passes already make.

``infer(stream=True)`` returns a generator of audio chunks, on both routes
and with ``use_decoder=False``, with the reference's cadence: the first
``pass_first_n_batches`` chunks of ``stream_batch`` steps are withheld,
then each yield emits up to ``stream_speed`` samples, then the tail comes
silence-stripped (``engine/streaming.EmissionPacer``).  Samples are
vocoded in fixed windows as soon as their receptive cone exists
(``engine/streaming.py``): on the device from the hiddens there, with one
window of the next chunk decoded ahead of the chunk's status read when
``runtime.stream_window_ahead`` (the Generator route), and each window's
PCM copied to pinned memory one chunk before it is read.

:meth:`Chat.load` reads a ChatTTS asset tree in the reference layout
(``source="local"`` or ``"custom"``), after checking every file against the
trusted checksums (``utils/dl.py``): ``Chat._load_assets`` maps each
checkpoint into the JAX package's trees (``utils/io.py``, the per-module key
maps) on the host and :meth:`Chat.load_params` moves them to the device.
:meth:`Chat.unload` drops all of it.

Entry points run on CUDA unless ``device="cpu"`` is passed to :meth:`load`
or :meth:`load_params`.
"""

from __future__ import annotations

import functools
import logging
import os
import re
from dataclasses import dataclass
from typing import List, Literal, Optional, Union

import numpy as np
import torch

from . import codecs
from .config import Config, load_spk_stat_string
from .engine.generate import (GenerateRequest, GenerationOutputs, Generator,
                              Interrupt, _round_up)
from .engine.streaming import (AsyncDeviceWindows, DeviceStreamingDecoder,
                               EmissionPacer, StreamingDecoder,
                               copy_to_host_async, plan_windows)
from .models import dvae as dvae_mod
from .models import embed as embed_mod
from .models import llama as llama_mod
from .models import vocos as vocos_mod
from .models.speaker import Speaker
from .models.tokenizer import Tokenizer
from .norm import Normalizer
from .ops import stft as stft_ops
from .ops.decode_step import pack_weights
from .utils import dl as dl_utils
from .utils import io as io_utils
from .weights import resolve_device, to_device


def _template(init) -> dict:
    """The tree ``init(generator)`` builds, on the meta device: shapes
    only, nothing drawn.  A leaf no key map fills stays on meta, and its
    copy to a device raises."""
    with torch.device("meta"):
        return init(torch.Generator())


class Chat:
    def __init__(self, logger: logging.Logger = logging.getLogger(__name__),
                 config: Optional[Config] = None):
        self.logger = logger
        self.config = config or Config()
        self.normalizer = Normalizer(logger=logger)
        self.context = Interrupt()
        self._loaded = False
        # (B, chunk, device, wire_int16, decoder, vocos config) -> the
        # pipelined decode's steps (``_incremental_fns``)
        self._incr_fns = {}

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    def has_loaded(self, use_decoder=True) -> bool:
        return self._loaded

    def download_models(
        self,
        source: Literal["huggingface", "local", "custom"] = "local",
        force_redownload: bool = False,
        custom_path: Optional[str] = None,
    ) -> Optional[str]:
        """Locate (or fetch) the asset tree; returns its directory or None.

        ``local``/``custom`` verify an existing tree against the trusted
        checksum map (``utils/dl.py``) and return None for a tree that
        fails it.  ``huggingface`` downloads the 2Noise/ChatTTS snapshot
        through ``huggingface_hub`` where it is installed and the network
        reachable, and logs the error and returns None otherwise.
        """
        if source in ("local", "custom"):
            base = io_utils.find_assets_dir(custom_path)
            if base is None:
                self.logger.error("no asset tree found")
                return None
            if not dl_utils.check_all_assets(base):
                # never hand back a tree that fails the trusted checksums
                self.logger.error("asset verification failed for %s", base)
                return None
            return base
        try:
            from huggingface_hub import snapshot_download

            return snapshot_download(
                repo_id="2Noise/ChatTTS",
                allow_patterns=["*.yaml", "*.json", "*.safetensors"],
                cache_dir=custom_path,
                force_download=force_redownload)
        except Exception as e:  # noqa: BLE001 - the package and network are optional
            self.logger.error("huggingface download failed: %s", e)
            return None

    def load(self, source: Literal["local", "custom", "random"] = "local",
             custom_path: Optional[str] = None,
             compile: bool = True,  # noqa: A002 - the reference's name
             coef: Optional[str] = None, seed: int = 0,
             use_engine: bool = False, *, device=None, weight_bits: int = 0,
             kv_bits: int = 8) -> bool:
        """Load weights from a ChatTTS asset tree, or seeded random weights.

        The positional order is the reference's (``source, custom_path,
        compile, coef, seed, use_engine``); the port's own arguments
        (``device``, ``weight_bits``, ``kv_bits``) are keyword-only.
        ``compile`` is accepted and ignored, as in the reference, which keeps
        it for API parity: the port runs eagerly.

        ``source="local"``/``"custom"``: find the reference layout
        (``custom_path``, the ``CHATTTS_ASSETS`` environment variable, or
        ``./asset``), verify it against the trusted checksum map and read
        it (:meth:`_load_assets`).  A tree that fails verification is not
        loaded: ``load`` returns False and the Chat stays unloaded.  With no
        tree found it warns and falls back to random weights from ``seed``,
        as the reference does.

        ``source="random"``: weights drawn on the CPU from a
        ``torch.Generator`` seeded with ``seed`` and then moved to
        ``device``, so every device gets the same weights.  The full DVAE
        (encoder, GFSQ and its own decoder, for voice clone and
        ``use_decoder=False``) is drawn after the other parts and shares
        the decoder's ``coef``.

        Either way the weights go to ``device`` (CUDA by default).
        ``use_engine=True`` routes the refine-text pass and code generation
        through the continuous-batching engine (the reference's
        ``load(use_engine=True)``): per-request ``manual_seed``,
        ``ensure_non_empty`` and interrupt keep the generator path's meaning.
        ``weight_bits``: the decode step's weights, 0 bf16 (the default), 8
        int8 with a scale per output column, 4 int4 with a scale per
        128-row group and column (the reference's ``CHATTTS_STEP_INT8`` and
        ``CHATTTS_STEP_INT4``; one value is passed, so neither wins).
        ``kv_bits``: 8 keeps the KV cache in int8 rows with embedded scales
        (the reference's default), 4 in nibble-packed rows with the same
        scales (its ``CHATTTS_KV_INT4``; an engine then keeps it up to 64
        slots), 0 in bf16.  An engine wider than its tier's slot limit (16
        on bf16, 32 on int8) serves on the bf16 cache with bf16 weights, as
        the reference's does; the facade's own engines fit their limits.
        """
        dev = resolve_device(device)
        tiers = dict(device=dev, use_engine=use_engine,
                     weight_bits=weight_bits, kv_bits=kv_bits)
        assets = None
        if source != "random":
            if io_utils.find_assets_dir(custom_path) is None:
                self.logger.warning(
                    "no ChatTTS assets found; falling back to random init")
            else:
                assets = self.download_models(source, custom_path=custom_path)
                if assets is None:
                    return False
        if assets is None:
            self._load_random(seed, coef, **tiers)
        else:
            self._load_assets(assets, coef, **tiers)
        return True

    def _load_random(self, seed: int, coef: Optional[str] = None, **tiers):
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        coef_arr = None if coef is None else codecs.decode_coef(coef)
        gpt = llama_mod.init_params(gen, cfg.gpt)
        embed = embed_mod.init_params(gen, cfg.gpt)
        decoder = dvae_mod.init_decoder_params(gen, cfg.decoder, coef_arr)
        vocos = vocos_mod.init_params(gen, cfg.vocos)
        dvae = dvae_mod.init_dvae_params(gen, cfg.dvae,
                                         decoder["coef"].numpy())
        self.load_params(gpt=gpt, embed=embed, decoder=decoder, vocos=vocos,
                         dvae=dvae, **tiers)

    def _load_assets(self, assets_dir: str, coef: Optional[str] = None,
                     **tiers):
        """Read the asset tree under ``assets_dir`` (no verification here:
        :meth:`load` verifies first) into CPU trees in the dtypes the JAX
        package's loader gives (the checkpoint's float dtype for the DVAE,
        Decoder, Vocos and Embed leaves, the Embed heads' weight norm folded
        in float64 and cast back; bf16 GPT matrices, float32 GPT norms),
        then hand them to :meth:`load_params` with ``tiers`` (``device``,
        ``use_engine``, ``weight_bits``, ``kv_bits``).  The GPT's matrices
        are built in bf16 on the host, so its float32 state never reaches
        the card.  ``coef`` replaces the full DVAE's; the decoder keeps the
        file's."""
        cfg, p = self.config, self.config.path

        def path(rel):
            return os.path.join(assets_dir, rel)

        def mapped(init, rel, key_map):
            return io_utils.apply_key_map(
                _template(init), io_utils.load_safetensors(path(rel)),
                key_map)

        gpt_state = io_utils.load_safetensors(
            path(os.path.join(p.gpt_ckpt_path, "model.safetensors")))
        trees = {
            "dvae": mapped(lambda g: dvae_mod.init_dvae_params(g, cfg.dvae),
                           p.dvae_ckpt_path,
                           dvae_mod.dvae_torch_key_map(cfg.dvae)),
            "decoder": mapped(
                lambda g: dvae_mod.init_decoder_params(g, cfg.decoder),
                p.decoder_ckpt_path,
                dvae_mod.decoder_torch_key_map(cfg.decoder)),
            "vocos": mapped(lambda g: vocos_mod.init_params(g, cfg.vocos),
                            p.vocos_ckpt_path,
                            vocos_mod.torch_key_map(cfg.vocos)),
            "embed": embed_mod.load_from_state(
                io_utils.fold_weight_norm(
                    io_utils.load_safetensors(path(p.embed_path))),
                cfg.gpt),
            "gpt": llama_mod.load_from_state(
                {k.removeprefix("model."): v for k, v in gpt_state.items()},
                cfg.gpt),
        }
        if coef is not None:
            trees["dvae"]["coef"] = torch.from_numpy(codecs.decode_coef(coef))
        self.load_params(**trees, tokenizer=Tokenizer(path(p.tokenizer_path)),
                         **tiers)

    def unload(self):
        """Drop every parameter tree, the packed weights, the generator,
        the engines, the tokenizer and the speaker, and start afresh as
        ``Chat(logger, config)``; a later :meth:`load` packs anew."""
        logger = self.logger
        for attr in ("dvae_params", "decoder_params", "vocos_params",
                     "embed_params", "gpt_params", "packed", "_pack_cache",
                     "generator", "_code_engines", "_text_engine",
                     "tokenizer", "speaker", "coef"):
            if hasattr(self, attr):
                delattr(self, attr)
        self.normalizer.destroy()
        self.__init__(logger, self.config)

    def load_params(self, gpt: dict, embed: dict, decoder: dict, vocos: dict,
                    dvae: Optional[dict] = None, device=None,
                    use_engine: bool = False, weight_bits: int = 0,
                    kv_bits: int = 8,
                    tokenizer: Optional[Tokenizer] = None) -> "Chat":
        """Load parameter trees in the JAX package's layouts (numpy arrays
        or tensors, e.g. bridged with ``weights.from_numpy``);
        ``weight_bits`` and ``kv_bits`` as in :meth:`load`.  ``dvae``, the
        full DVAE, is needed only by voice clone (``sample_audio_speaker``
        and the auto-clone branch of a split text) and ``use_decoder=False``;
        those raise without it.  ``tokenizer`` defaults to the asset-free
        fallback at the config's text vocabulary."""
        cfg = self.config
        self.use_engine = use_engine
        self.weight_bits = weight_bits
        self.kv_bits = kv_bits
        self._code_engines = {}
        self._text_engine = None
        self.device = resolve_device(device)
        self.gpt_params = to_device(gpt, self.device)
        self.embed_params = to_device(embed, self.device)
        self.decoder_params = to_device(decoder, self.device)
        self.vocos_params = to_device(vocos, self.device)
        self.dvae_params = (None if dvae is None
                            else to_device(dvae, self.device))
        self.tokenizer = tokenizer or Tokenizer(
            None, vocab_size=cfg.gpt.num_text_tokens)
        self.speaker = Speaker(cfg.gpt.hidden_size, load_spk_stat_string())
        self.coef = dvae_mod.coef_string(self.decoder_params)
        self.packed = self._step_weights()
        self.generator = Generator(
            cfg.gpt, self.gpt_params, self.embed_params,
            prefill_bucket=cfg.runtime.prefill_bucket, kv_bits=kv_bits,
            packed=self.packed)
        self._loaded = True
        return self

    def _step_weights(self) -> dict:
        """One packed copy of the decoder weights (``ops/decode_step.py``)
        for the generator and every engine tier.  Kept across loads and
        packed anew when the weight tier or a parameter tensor changed (a
        stale copy would decode with the previous load's weights)."""
        leaves = [t for lp in self.gpt_params["layers"]
                  for t in (lp["attn"]["wqkv"], lp["attn"]["wo"],
                            lp["mlp"]["wgu"], lp["mlp"]["down"], lp["ln1"],
                            lp["ln2"])]
        kept = getattr(self, "_pack_cache", None)
        if (kept is None or kept[0] != self.weight_bits
                or len(kept[1]) != len(leaves)
                or any(a is not b for a, b in zip(kept[1], leaves))):
            self._pack_cache = (self.weight_bits, leaves, pack_weights(
                self.gpt_params, self.config.gpt, self.weight_bits))
        return self._pack_cache[2]

    def interrupt(self):
        self.context.set(True)

    # ------------------------------------------------------------------
    # Speakers
    # ------------------------------------------------------------------

    def sample_random_speaker(self) -> str:
        return self.speaker.sample_random()

    def sample_audio_speaker(self, wav: np.ndarray) -> str:
        """Zero-shot clone: waveform -> ``spk_smp`` code string (the DVAE
        encoder's (num_vq, T) codes)."""
        ind = dvae_mod.encode_audio(
            self._dvae("voice clone"),
            torch.as_tensor(np.asarray(wav, np.float32).reshape(1, -1),
                            device=self.device),
            self.config.dvae, self.config.vocos.mel)
        return Speaker.encode_prompt(ind[0].T.cpu().numpy())

    def _dvae(self, what: str) -> dict:
        if self.dvae_params is None:
            raise ValueError(f"{what} needs the full DVAE: pass dvae= to "
                             "load_params")
        return self.dvae_params

    # ------------------------------------------------------------------
    # Inference params (API parity with the reference)
    # ------------------------------------------------------------------

    @dataclass(repr=False, eq=False)
    class RefineTextParams:
        prompt: str = ""
        top_P: float = 0.7
        top_K: int = 20
        temperature: float = 0.7
        repetition_penalty: float = 1.0
        max_new_token: int = 384
        min_new_token: int = 0
        show_tqdm: bool = True
        ensure_non_empty: bool = True
        manual_seed: Optional[int] = None

    @dataclass(repr=False, eq=False)
    class InferCodeParams(RefineTextParams):
        prompt: str = "[speed_5]"
        spk_emb: Optional[str] = None
        spk_smp: Optional[str] = None
        txt_smp: Optional[str] = None
        temperature: float = 0.3
        repetition_penalty: float = 1.05
        max_new_token: int = 2048
        stream_batch: int = 24
        stream_speed: int = 12000
        pass_first_n_batches: int = 2

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def infer(
        self,
        text: Union[str, List[str]],
        stream: bool = False,
        lang: Optional[str] = None,
        skip_refine_text: bool = False,
        refine_text_only: bool = False,
        use_decoder: bool = True,
        do_text_normalization: bool = True,
        do_homophone_replacement: bool = True,
        split_text: bool = True,
        max_split_batch: int = 4,
        params_refine_text: Optional["Chat.RefineTextParams"] = None,
        params_infer_code: Optional["Chat.InferCodeParams"] = None,
    ):
        params_refine_text = params_refine_text or Chat.RefineTextParams()
        params_infer_code = params_infer_code or Chat.InferCodeParams()
        self.context.set(False)

        if split_text and isinstance(text, str):
            if "\n" in text:
                text = text.split("\n")
            else:
                text = [t for t in re.split(r"(?<=。)|(?<=\.\s)", text) if t]
            self.logger.info("split text into %d parts", len(text))
        if isinstance(text, str):
            text = [text]
        if len(text) == 0:
            return []

        res_gen = self._infer(
            text, stream, lang, skip_refine_text, refine_text_only,
            use_decoder, do_text_normalization, do_homophone_replacement,
            split_text, max_split_batch, params_refine_text,
            params_infer_code)
        if stream:
            return res_gen
        if refine_text_only:
            return next(res_gen)
        stripped = []
        thr = np.float32(1e-5)
        for wavs in res_gen:
            for wav in wavs:
                stripped.append(wav[np.abs(wav) > thr])
        if split_text:
            return [np.concatenate(stripped) if stripped else
                    np.array([], np.float32)]
        return stripped

    def _infer(self, text, stream, lang, skip_refine_text, refine_text_only,
               use_decoder, do_text_normalization, do_homophone_replacement,
               split_text, max_split_batch, params_refine_text,
               params_infer_code):
        text = [self.normalizer(t, do_text_normalization,
                                do_homophone_replacement, lang)
                for t in text]
        if not skip_refine_text:
            refined = self._refine_text(text, params_refine_text)
            text_tokens = [t[t < self.tokenizer.break_0_ids]
                           for t in refined.ids]
            text = self.tokenizer.decode(text_tokens)
            refined.destroy()
            if refine_text_only:
                yield "\n".join(text) if split_text else text
                return
        if split_text and len(text) > 1 and params_infer_code.spk_smp is None:
            # auto voice clone: synthesize segment 0 once and prompt every
            # segment with its codes (the caller's params keep them, as in
            # the reference)
            self._dvae("the auto-clone branch of a split text")
            refer_text = text[0]
            wavs = self._generate_wavs([refer_text], use_decoder,
                                       params_infer_code)
            if len(wavs) and wavs[0].size:
                params_infer_code.spk_smp = self.sample_audio_speaker(wavs[0])
                params_infer_code.txt_smp = refer_text
        if split_text:
            batches = [text[i:i + max_split_batch]
                       for i in range(0, len(text), max_split_batch)]
        else:
            batches = [text]
        for batch in batches:
            if stream:
                yield from self._stream_batch(batch, use_decoder,
                                              params_infer_code)
            else:
                yield self._generate_wavs(batch, use_decoder,
                                          params_infer_code)

    @staticmethod
    def _progress_bar(params, n_requests: int, desc: str, per_request: bool):
        """A progress bar over a generation pass when ``show_tqdm`` asks
        (``utils/progress.py``: tqdm where it is installed, nothing drawn
        where not).  ``per_request``: engine slots advance on their own,
        so the total scales with the batch; the Generator's rows advance
        together, so the total is one request's step budget."""
        if not params.show_tqdm:
            return None
        from .utils.progress import ProgressBar

        total = params.max_new_token * (n_requests if per_request else 1)
        return ProgressBar(total, desc=desc)

    @staticmethod
    def _closing_bar(gen, bar):
        try:
            yield from gen
        finally:
            bar.close()

    @staticmethod
    def _attempt_stream(gen):
        """Wrap a generation stream as (restarted, result) pairs.

        ``restarted`` is True when this yield follows an attempt's FINAL
        output - the empty-generation retry restarted generation, and
        streaming consumers must drop accumulation from the discarded
        attempt (the retry only fires when some sequence produced
        nothing)."""
        saw_final = False
        for result in gen:
            yield saw_final, result
            saw_final = not result.partial

    def _stream_batch(self, batch, use_decoder, params):
        """Streaming synthesis with incremental windowed vocoding.

        The reference re-decodes ALL accumulated hidden states on every
        yield (core.py:475-503, O(T^2) total); here a StreamingDecoder
        finalizes samples as soon as their conv receptive cone is complete,
        so each yield costs one fixed-size window.  When the generation
        provides hiddens on the device, the window slicing, padding and
        vocoding run there and only finished samples go to the host
        (DeviceStreamingDecoder).  Emission cadence keeps the reference
        semantics: withhold the first ``pass_first_n_batches`` yields, then
        emit ``stream_speed``-sample windows, then flush the
        silence-stripped tail.
        """
        if not use_decoder:
            self._dvae("use_decoder=False")
        ctx, guard, window = plan_windows(
            self.config.decoder.stack if use_decoder
            else self.config.dvae.decoder,
            self.config.vocos, params.stream_batch)
        fg = self.config.runtime.stream_first_guard
        fg = None if fg is None else min(fg, guard)
        sd = None
        # Defer PCM materialization by one chunk (AsyncDeviceWindows): the
        # window decode and its host copy are enqueued at consume time but
        # read on the NEXT yield, so both overlap the next chunk's steps.
        # A constant one-chunk shift in emission latency, not a rate
        # change; the windows before the first emission (and the final
        # flush) are read at once.  The deferred swap and the reference
        # cadence both live in EmissionPacer (shared with
        # TTSService.synthesize_stream).
        defer = self.config.runtime.stream_window_ahead
        wire = self.config.runtime.wire_int16

        def _mk_pacer():
            return EmissionPacer(len(batch), params.pass_first_n_batches,
                                 params.stream_speed, wire)

        def _mk_device_sd():
            return self._device_stream_decoder(len(batch),
                                               params.stream_batch,
                                               async_windows=defer)

        # window speculation: right after the Generator ENQUEUES a chunk's
        # steps, enqueue the vocode of the window that chunk will allow and
        # start its host copy, before the host waits on the chunk's status.
        # Fires only on the Generator route; the callback sees the full
        # hidden buffer.
        def on_dispatch(st, hi):
            nonlocal sd
            if not use_decoder:
                return
            if sd is None:
                sd = _mk_device_sd()
            if isinstance(sd, DeviceStreamingDecoder):
                if hi >= params.max_new_token:
                    # provably the final chunk: speculate the final flush
                    # (right-aligned tail windows included) instead of the
                    # mid-stream plan
                    sd.speculate_final(st.hiddens, hi, st.end_idx)
                else:
                    sd.speculate_window(st.hiddens, hi, st.end_idx)

        if not self.config.runtime.stream_window_ahead:
            on_dispatch = None
        pacer = _mk_pacer()
        last = None  # (device feats, n) or np items for the tail flush
        # dispatch-ahead after the first two chunks: the first emission's
        # chunks stay synchronous, later ones overlap the status wait with
        # the next chunk's steps
        for restarted, result in self._attempt_stream(
                self._infer_code(batch, True, use_decoder, params,
                                 speculate=True, speculate_from=2,
                                 on_dispatch=on_dispatch)):
            if restarted:
                sd = None
                pacer = _mk_pacer()  # reapply the first-yields suppression
            final = bool(result.finished.all())
            if use_decoder and result.hiddens_dev is not None:
                if sd is None:
                    sd = _mk_device_sd()
                last = ("dev", result.hiddens_dev, result.hid_n,
                        result.end_dev)
                chunk = sd.update_dev(result.hiddens_dev, result.hid_n,
                                      final=final, end_dev=result.end_dev)
            else:
                if sd is None:
                    sd = StreamingDecoder(
                        self._stream_decode_fn(use_decoder), len(batch),
                        self.config.gpt.hidden_size if use_decoder
                        else self.config.gpt.num_vq,
                        ctx=ctx, guard=guard, window=window,
                        int_features=not use_decoder, first_guard=fg)
                items = (result.materialize_hiddens() if use_decoder
                         else result.ids)
                last = ("np", items, None, None)
                chunk = sd.update(items, final=final)
            result.destroy()
            emit = pacer.push(chunk, final=final)
            if emit is not None:
                yield emit
        # tail flush: whatever remains, silence-stripped (core.py:501-503)
        tail = None
        if sd is not None and sd.emitted < sd.available and last is not None:
            kind, payload, n, end_dev = last
            tail = (sd.update_dev(payload, n, final=True, end_dev=end_dev)
                    if kind == "dev"
                    else sd.update(payload, final=True))
        yield pacer.flush(tail)

    def _device_stream_decoder(self, batch: int, stream_batch: int,
                               async_windows: bool = False):
        """Device streaming decoder with the facade's geometry recipe
        (plan_windows receptive cones, clamped first guard, wire scaling).
        The ONE construction shared by _stream_batch and
        TTSService.synthesize_stream - keep them from drifting.

        ``async_windows``: return the AsyncDeviceWindows variant whose
        update_dev yields sample slices with host copies in flight instead
        of materialized arrays (int16 wire scaling then becomes the
        caller's job at materialization)."""
        ctx, guard, window = plan_windows(self.config.decoder.stack,
                                          self.config.vocos, stream_batch)
        fg = self.config.runtime.stream_first_guard
        cls = AsyncDeviceWindows if async_windows else DeviceStreamingDecoder
        return cls(
            self._device_window_fn(window), batch,
            self.config.gpt.hidden_size,
            wire_int16=self.config.runtime.wire_int16 and not async_windows,
            ctx=ctx, guard=guard, window=window,
            first_guard=None if fg is None else min(fg, guard))

    def _stream_decode_fn(self, use_decoder: bool):
        """Host-window decode of the plain StreamingDecoder: (B, W, C)
        hiddens (float32) or codes (int32) -> (B, n) float32 samples."""
        cfg = self.config

        def decode(win: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(win).to(self.device)
            mel = (dvae_mod.decode_from_hidden(self.decoder_params, x,
                                               cfg.decoder)
                   if use_decoder
                   else dvae_mod.decode_from_indices(self.dvae_params, x,
                                                     cfg.dvae))
            return vocos_mod.decode(self.vocos_params, mel,
                                    cfg.vocos).cpu().numpy()

        return decode

    def _device_window_fn(self, window: int):
        """Device-side window decode for streaming: slice/pad/mask/roll the
        hidden window, run the mel decoder + vocoder, and (optionally)
        quantize - all on the device; only the finished sample window goes
        to the host.  Semantics mirror StreamingDecoder._decode_window
        exactly.  When a per-row ``end`` (generated lengths, device (B,))
        is supplied, hidden positions at/after a row's end are zeroed
        before the convs - the generation buffer keeps accumulating
        garbage hiddens for finished rows, and the one-shot decode
        (_device_decode) zero-masks the same region.  Plain torch ops,
        enqueued on the current stream."""
        cfg = self.config
        wire_int16 = cfg.runtime.wire_int16

        def call(feats, lo, hi, pad_left, end=None):
            sl = feats[:, lo:lo + window]
            if sl.shape[1] < window:  # the window runs past the buffer
                sl = torch.nn.functional.pad(
                    sl, (0, 0, 0, window - sl.shape[1]))
            t = torch.arange(window, device=feats.device)
            keep = (t < (hi - lo))[None, :]
            if end is not None:
                keep = keep & ((lo + t)[None, :] < end[:, None])
            sl = torch.where(keep[:, :, None], sl, 0.0)
            sl = torch.roll(sl, pad_left, dims=1)
            sl = torch.where((t >= pad_left)[None, :, None], sl, 0.0)
            mel = dvae_mod.decode_from_hidden(self.decoder_params, sl,
                                              cfg.decoder)
            wav = vocos_mod.decode(self.vocos_params, mel, cfg.vocos)
            if wire_int16:
                return torch.clamp(wav * 32767.0, -32767,
                                   32767).to(torch.int16)
            return wav

        return call

    def _pipelined(self) -> bool:
        """Whether non-streaming synthesis takes the pipelined decode:
        ``runtime.pipelined_decode`` (None is off here; the reference turns
        it on only on a TPU backend), overridden both ways by the
        environment variable ``CHATTTS_PIPELINED_DECODE`` (``1`` on, any
        other value off), as in the reference."""
        env = os.environ.get("CHATTTS_PIPELINED_DECODE")
        if env is not None:
            return env == "1"
        return bool(self.config.runtime.pipelined_decode)

    def _generate_wavs(self, batch: List[str], use_decoder: bool,
                       params: "Chat.InferCodeParams") -> np.ndarray:
        """Non-streaming synthesis of one batch of texts: the pipelined
        decode (:meth:`_pipelined_wavs`) when it is on and the hiddens are
        decoded, else the one-shot decode."""
        if not use_decoder:
            self._dvae("use_decoder=False")
        elif self._pipelined():
            return self._pipelined_wavs(batch, params)
        result = next(self._infer_code(batch, False, use_decoder, params))
        wavs = self._decode_to_wavs(result, use_decoder)
        result.destroy()
        return wavs

    def _incremental_fns(self, B: int, Fh: int):
        """The conv-state incremental hidden -> PCM steps of the pipelined
        decode, for B rows and chunks of Fh hidden positions.

        Returns (init_state, first_fn, step_fn), or None when the chunk is too small for the delayed ISTFT consume (the mel
        offset is above 2 * Fh).  ``first_fn`` primes the stream (no PCM
        yet); ``step_fn`` feeds Fh hidden positions and returns exactly
        Fh * 2 * hop RAW samples (the caller drops the first n_fft // 2
        once).  O(new frames) a call, and exact against the full decode
        (``models/convnext.py``'s streaming notes).  The state is plain
        tensors, each made anew by a call and never written in place.

        The steps are cached by (B, Fh) and by everything they capture
        (the device, ``runtime.wire_int16``, the decoder and Vocos
        configs), so a later ``load_params`` or a new ``config`` gets its
        own."""
        cfg = self.config
        key = (B, Fh, self.device, cfg.runtime.wire_int16, cfg.decoder,
               cfg.vocos)
        cached = self._incr_fns.get(key)
        if cached is not None:
            return cached
        F = 2 * Fh
        Dc = (dvae_mod.decoder_stream_offset(cfg.decoder)
              + vocos_mod.stream_offset(cfg.vocos))
        if Dc > F:
            return None
        wire = cfg.runtime.wire_int16
        n_fft, hop = cfg.vocos.n_fft, cfg.vocos.hop_length
        dev = self.device

        def init_state():
            return {
                "dec": dvae_mod.decoder_stream_init(B, cfg.decoder,
                                                    device=dev),
                "voc": vocos_mod.stream_init(B, cfg.vocos, device=dev),
                "spec": None,  # the previous chunk's spec frames
                "carry": stft_ops.istft_stream_init(B, n_fft, hop,
                                                    device=dev),
            }

        def core(dp, vp, state, hid, c, end):
            pos = c * Fh + torch.arange(Fh, device=hid.device)
            # finished rows: zeros, as the one-shot decode masks them
            hid = torch.where((pos[None, :] < end[:, None])[:, :, None],
                              hid, 0.0)
            t0 = c * F
            mel, dstate, cum = dvae_mod.decode_from_hidden_stream(
                dp, hid, state["dec"], cfg.decoder, t0=t0)
            spec, vstate = vocos_mod.features_stream(
                vp, mel, state["voc"], cfg.vocos, t0=t0, cum_off=cum)
            return spec, dstate, vstate

        def first(dp, vp, state, hid, end):
            spec, dstate, vstate = core(dp, vp, state, hid, 0, end)
            return {**state, "dec": dstate, "voc": vstate, "spec": spec}

        def step(dp, vp, state, hid, c, end):
            spec, dstate, vstate = core(dp, vp, state, hid, c, end)
            # the ISTFT lags one chunk: it consumes full-decode frames
            # [(c - 1) * F, c * F), which sit at stream offset Dc in the
            # last two spec chunks
            take = torch.cat([state["spec"], spec], dim=1)[:, Dc:Dc + F]
            raw, carry = stft_ops.istft_stream(take, state["carry"], n_fft,
                                               hop)
            if wire:
                raw = torch.clamp(raw * 32767.0, -32767,
                                  32767).to(torch.int16)
            return raw, {"dec": dstate, "voc": vstate, "spec": spec,
                         "carry": carry}

        fns = (init_state, first, step)
        self._incr_fns[key] = fns
        return fns

    def _pipelined_wavs(self, batch: List[str],
                        params: "Chat.InferCodeParams") -> np.ndarray:
        """Chunked decode -> vocode on the card as the chunks come -> PCM
        copied to the host as it is made (the reference's
        ``_pipelined_wavs``).

        The one-shot path runs [decode all steps] -> [vocode] -> [one
        blocking copy]; here generation yields every ``pipeline_chunk``
        steps (at least 16; on the engine route, long chunks), each yield
        advances the vocoder on the card, and every emitted sample window
        starts a non-blocking copy to pinned memory at once.  With 2 *
        chunk at least the conv stacks' mel offset, the vocoder is the
        conv-state chain (:meth:`_incremental_fns`) and a right-aligned
        full flush window decodes the tail; below it, the exact-guard
        sliding windows of ``engine/streaming.AsyncDeviceWindows``.  An
        utterance shorter than the flush window, or a stream that fell
        behind, takes the one-shot decode; so do hiddens that never reached
        the card.  The rows are masked at their ends as the one-shot
        decode masks them, and each row's wav is zeroed past its end."""
        rt = self.config.runtime
        B = len(batch)
        chunk = max(16, rt.pipeline_chunk)
        ctx, guard, window = plan_windows(self.config.decoder.stack,
                                          self.config.vocos, chunk)
        hop = self.config.vocos.hop_length
        spc = 2 * hop
        nfft2 = self.config.vocos.n_fft // 2
        incr = self._incremental_fns(B, chunk)
        if incr is not None:
            # the flush window covers the tail not yet emitted (up to 2
            # chunks: the ISTFT's one-chunk lag and a ragged last chunk)
            # and the guard of its inexact left edge
            init_state, first_fn, step_fn = incr
            flush_w = _round_up(2 * chunk + guard + 8, 16)
            state = init_state()
        else:
            flush_w = window  # the windowed walk (chunk below the offset)
        sd = None
        last = None
        ends = None
        parts: List = []
        final_res = None
        fed = 0
        emitted = 0  # samples emitted by the incremental stream
        broken = False  # no hiddens on the card: one-shot at the end

        # flush speculation: when the dispatched chunk provably ends the
        # generation (its step count reaches max_new), the flush window's
        # (lo, n) and the stream's final emitted count are known, so the
        # flush vocode and its tail's host copy are enqueued here, before
        # the host waits on the chunk's status.  The decode reads the
        # buffer after the last chunk wrote it (stream order), so a hit is
        # bit-equal to the flush made after; a miss (a row ended early)
        # decodes the flush again.
        stash: List = [None]  # (lo, n, predicted emitted, host copy)

        def on_dispatch(st, hi):
            if incr is None or hi < params.max_new_token:
                return
            n_p, lo_p = int(hi), int(hi) - flush_w
            fed_p = n_p // chunk
            em_p = (fed_p - 1) * chunk * spc - nfft2 if fed_p >= 2 else 0
            if lo_p < 0 or em_p < lo_p * spc:
                return
            wav = self._device_window_fn(flush_w)(
                st.hiddens, lo_p, n_p, 0, st.end_idx)
            stash[0] = (lo_p, n_p, em_p,
                        copy_to_host_async(wav[:, em_p - lo_p * spc:]))

        if not rt.stream_window_ahead:
            on_dispatch = None
        for restarted, result in self._attempt_stream(self._infer_code(
                batch, True, True, params, stream_batch_override=chunk,
                speculate=True, on_dispatch=on_dispatch)):
            if restarted:
                # the empty-generation retry restarted: drop the discarded
                # attempt's audio
                parts.clear()
                fed = emitted = 0
                sd = None
                stash[0] = None
                if incr is not None:
                    state = init_state()
            ends = [ids.shape[0] for ids in result.ids]
            if final_res is not None:
                final_res.destroy()
            final_res = result
            if result.hiddens_dev is None:
                broken = True
            if broken:
                continue
            n = result.hid_n  # the buffer may hold more (the engine's rows)
            if incr is not None:
                while (fed + 1) * chunk <= n:
                    hidc = result.hiddens_dev[:, fed * chunk:
                                              (fed + 1) * chunk]
                    if fed == 0:
                        state = first_fn(self.decoder_params,
                                         self.vocos_params, state, hidc,
                                         result.end_dev)
                    else:
                        pcm, state = step_fn(
                            self.decoder_params, self.vocos_params, state,
                            hidc, fed, result.end_dev)
                        if fed == 1:  # the ISTFT's centre padding, once
                            pcm = pcm[:, nfft2:]
                        parts.append(copy_to_host_async(pcm))
                        emitted += pcm.shape[1]
                    fed += 1
            else:
                if sd is None:
                    sd = AsyncDeviceWindows(
                        self._device_window_fn(window), B,
                        self.config.gpt.hidden_size,
                        wire_int16=rt.wire_int16,
                        ctx=ctx, guard=guard, window=window)
                parts += sd.update_dev(result.hiddens_dev, n,
                                       end_dev=result.end_dev,
                                       final=bool(result.finished.all()))
            last = (result.hiddens_dev, n, result.end_dev)
        if broken and final_res is not None:
            wavs = self._decode_to_wavs(final_res, True)
            final_res.destroy()
            return wavs
        if last is None or ends is None:
            if final_res is not None:
                final_res.destroy()
            return np.zeros((B, 0), np.float32)
        n = last[1]
        emitted_h = emitted // spc  # hidden positions fully emitted
        if n < flush_w or (incr is not None
                           and emitted_h - (n - flush_w) < guard):
            # shorter than one flush window, or the stream fell too far
            # behind: the flush would pad INSIDE the tensor, whose zeros
            # are live through the conv and norm stacks; only a full final
            # window has exact edges.  Decode one-shot instead.
            wavs = self._decode_to_wavs(final_res, True)
            final_res.destroy()
            return wavs
        if incr is not None:
            # the right-aligned FULL flush window [n - flush_w, n): exact
            # from guard positions in, and emission is past that (above)
            lo = n - flush_w
            if stash[0] is not None and stash[0][:3] == (lo, n, emitted):
                tail = stash[0][3]  # speculated, its copy in flight
            else:
                wav_w = self._device_window_fn(flush_w)(
                    last[0], lo, n, 0, last[2])
                tail = copy_to_host_async(wav_w[:, emitted - lo * spc:])
            parts.append(tail)
        elif sd is not None and sd.emitted < sd.available:
            parts += sd.update_dev(last[0], last[1], end_dev=last[2],
                                   final=True)
        final_res.destroy()
        if not parts:
            return np.zeros((B, 0), np.float32)
        wav = np.concatenate([np.asarray(p) for p in parts], axis=1)
        if rt.wire_int16:
            wav = wav.astype(np.float32) / 32767.0
        # each row's generation tail (emission runs to the batch's longest
        # row; a shorter row decodes zeros there, but keep the cut exact)
        for b, nb in enumerate(ends):
            wav[b, nb * spc:] = 0.0
        return wav

    def _device_decode(self, hid: torch.Tensor, end: torch.Tensor
                       ) -> torch.Tensor:
        """hid (B, Tpad, D), end (B,) kept lengths -> wav (B, N).

        Zeroes each row's tail before the conv stacks (zero features are not
        inert through norm and conv) and again on the waveform."""
        cfg = self.config
        tmask = torch.arange(hid.shape[1], device=hid.device)[None, :] < end[:, None]
        mel = dvae_mod.decode_from_hidden(self.decoder_params,
                                          hid * tmask[..., None], cfg.decoder)
        wav = vocos_mod.decode(self.vocos_params, mel, cfg.vocos)
        return self._zero_tail(wav, end)

    def _zero_tail(self, wav: torch.Tensor, end: torch.Tensor
                   ) -> torch.Tensor:
        """wav (B, N) with each row zeroed past its ``end`` (B,) code
        steps."""
        spc = 2 * self.config.vocos.hop_length  # samples per code step
        t = torch.arange(wav.shape[1], device=wav.device)
        return wav * (t[None, :] < (end * spc)[:, None])

    def _decode_to_wavs(self, result: GenerationOutputs, use_decoder: bool
                        ) -> np.ndarray:
        cfg = self.config
        bucket = cfg.runtime.decode_bucket // 4 or 1
        if use_decoder:
            hid = result.hiddens_dev  # (B, n_max, D)
            B, n_max = hid.shape[0], result.hid_n
            if n_max == 0:
                return np.zeros((B, 0), np.float32)
            # an engine partial holds the whole fixed-shape buffer: decode
            # the valid prefix only (a zero-masked tail is not silent
            # through the conv and norm stacks)
            hid = hid[:, :n_max]
            hid = torch.nn.functional.pad(
                hid, (0, 0, 0, _round_up(n_max, bucket) - n_max))
            return self._device_decode(hid, result.end_dev).cpu().numpy()
        # codes -> GFSQ embed -> the DVAE's decoder -> Vocos; each row's
        # bucket-padding tail is zeroed on the waveform (zero codes are not
        # silence)
        items = result.ids
        n_max = max((x.shape[0] for x in items), default=0)
        if n_max == 0:
            return np.zeros((len(items), 0), np.float32)
        codes = np.zeros((len(items), _round_up(n_max, bucket),
                          cfg.gpt.num_vq), np.int32)
        for i, ids in enumerate(items):
            codes[i, :ids.shape[0]] = ids
        mel = dvae_mod.decode_from_indices(
            self.dvae_params, torch.from_numpy(codes).to(self.device),
            cfg.dvae)
        wav = vocos_mod.decode(self.vocos_params, mel, cfg.vocos)
        ends = torch.as_tensor([x.shape[0] for x in items], device=wav.device)
        return self._zero_tail(wav, ends).cpu().numpy()

    # -- generation passes ---------------------------------------------

    def _refine_text(self, text: List[str],
                     params: "Chat.RefineTextParams") -> GenerationOutputs:
        cfg = self.config.gpt
        prompts = Speaker.decorate_text_prompts(text, params.prompt)
        ids, attn, tmask = self.tokenizer.encode(prompts, cfg.num_vq)
        if self.use_engine:
            from .engine.batching import EngineRequest

            eng = self._engine_for_text()
            lens = attn.sum(1)
            if lens.max() <= max(eng.ecfg.buckets):
                reqs = []
                for b in range(ids.shape[0]):
                    n = int(lens[b])
                    reqs.append(EngineRequest(
                        request_id=f"refine-{id(params)}-{b}",
                        ids=ids[b, ids.shape[1] - n:],
                        text_mask=tmask[b, ids.shape[1] - n:],
                        temperature=np.asarray([params.temperature],
                                               np.float32),
                        top_p=params.top_P, top_k=params.top_K,
                        repetition_penalty=params.repetition_penalty,
                        min_new=params.min_new_token,
                        max_new=params.max_new_token,
                        seed=params.manual_seed,
                        ensure_non_empty=params.ensure_non_empty))
                bar = self._progress_bar(params, len(reqs), "refine_text",
                                         per_request=True)
                if bar is not None:
                    for r in reqs:
                        r.on_progress = functools.partial(bar.report,
                                                          r.request_id)
                try:
                    outs = eng.generate(reqs, context=self.context)
                finally:
                    if bar is not None:
                        bar.close()
                return GenerationOutputs(
                    ids=[o.ids for o in outs],
                    finished=np.asarray(
                        [o.finish_reason == "eos" for o in outs]))
            # prompts past the engine's bucket capacity: the one-shot
            # generator takes any length
        req = GenerateRequest(
            ids=ids, attn_mask=attn, text_mask=tmask, infer_text=True,
            eos_token=self.tokenizer.eos_token,
            temperature=np.asarray([params.temperature], np.float32),
            top_p=params.top_P, top_k=params.top_K,
            repetition_penalty=params.repetition_penalty,
            max_new=params.max_new_token, min_new=params.min_new_token,
            seed=params.manual_seed, ensure_non_empty=params.ensure_non_empty)
        bar = self._progress_bar(params, len(text), "refine_text",
                                 per_request=False)
        if bar is not None:
            req.on_progress = functools.partial(bar.report, "batch")
        try:
            return next(self.generator.generate(req, self.context))
        finally:
            if bar is not None:
                bar.close()

    def _code_inputs(self, text, params: "Chat.InferCodeParams"):
        """Tokenized inputs of the code pass: (ids, attn, tmask, temp, spk)."""
        cfg = self.config.gpt
        prompts = Speaker.decorate_code_prompts(
            list(text), params.prompt, params.txt_smp, params.spk_emb)
        code_prompt = (Speaker.decode_prompt(params.spk_smp)
                       if params.spk_smp is not None else None)
        ids, attn, tmask = self.tokenizer.encode(
            prompts, cfg.num_vq, prompt=code_prompt)
        temp = (np.asarray(params.temperature, np.float32)
                if isinstance(params.temperature, list)
                else np.full((cfg.num_vq,), params.temperature, np.float32))
        spk = (Speaker.decode(params.spk_emb)
               if params.spk_emb is not None else None)
        return ids, attn, tmask, temp, spk

    # -- the engine route ------------------------------------------------

    def _code_engine_geometry(self, tier: str):
        """Static engine geometry of a code-engine tier.

        Every tier carries the full generation region (``decode_bucket * 8``
        new tokens): a step's cost follows the slot count and the cache rows
        actually filled, not the configured cache length, so tiering is
        about width only.

        * ``"fast"``: 8 slots, the facade's usual split-batch workload.
        * ``"capacity"``: 16 slots, the concurrent serving tier; device-
          streaming slots are capped at 14 so queued work stays preemptable.
        * ``"wide"``: 32 slots for saturated offline work; exists only with
          a quantized KV cache.

        Prompt capacity is sized from the position-embedding budget.
        """
        from .engine.batching import EngineConfig

        rt = self.config.runtime
        max_new = rt.decode_bucket * 8
        if tier == "fast":
            slots, prompt_cap, stream_cap = 8, 256, None
        elif tier == "wide":
            slots, prompt_cap, stream_cap = 32, 512, 28
        else:
            slots, prompt_cap, stream_cap = 16, 512, 14
        budget = self.config.gpt.max_position_embeddings - max_new
        max_prompt = max(64, min(prompt_cap, (budget // 64) * 64))
        buckets = tuple(b for b in (64, 128, 256, 512)
                        if b <= max_prompt) or (max_prompt,)
        return EngineConfig(
            max_num_seqs=slots, max_prompt_len=max_prompt,
            max_new_tokens=max_new, chunk_steps=24, infer_text=False,
            collect_hidden=True, prompt_buckets=buckets,
            preempt_after_chunks=4, max_stream_slots=stream_cap)

    def _engine_for_code(self, tier: str = "capacity"):
        """Build the continuous-batching code engine of ``tier`` on first
        use."""
        from .engine import batching

        if tier == "wide" and batching.fused_slot_limit(self.kv_bits) < 32:
            self.logger.warning(
                "the wide tier needs a quantized KV cache; falling back to "
                "capacity")
            tier = "capacity"
        if tier not in self._code_engines:
            self._code_engines[tier] = batching.Engine(
                self.config.gpt, self._code_engine_geometry(tier),
                self.gpt_params, self.embed_params,
                spk_emb_ids=self.tokenizer.spk_emb_ids, packed=self.packed,
                kv_bits=self.kv_bits)
        return self._code_engines[tier]

    def _code_tier_for(self, n_requests: int, max_new: int,
                       prompt_len: int) -> str:
        """The cheapest code-engine tier that fits the workload.  Routing is
        by batch width and prompt length; ``max_new`` is only a capacity
        check (the default ceiling says nothing about how long a request
        that ends on EOS runs).  Batches wider than the 16-slot tier go to
        the 32-slot tier when the KV cache is quantized.  Builds no
        engine."""
        from .engine import batching

        fast = self._code_engine_geometry("fast")
        if (n_requests <= fast.max_num_seqs
                and max_new <= fast.max_new_tokens
                and prompt_len <= max(fast.buckets)):
            return "fast"
        cap = self._code_engine_geometry("capacity")
        wide = self._code_engine_geometry("wide")
        if (n_requests > cap.max_num_seqs and prompt_len <= max(wide.buckets)
                and batching.fused_slot_limit(self.kv_bits)
                >= wide.max_num_seqs):
            return "wide"
        return "capacity"

    def _engine_for_text(self):
        """Text-mode engine of the refine pass under ``use_engine``."""
        if self._text_engine is None:
            from .engine.batching import Engine, EngineConfig

            self._text_engine = Engine(
                self.config.gpt,
                EngineConfig(
                    max_num_seqs=8, max_prompt_len=256, max_new_tokens=512,
                    chunk_steps=24, infer_text=True,
                    text_eos_token=self.tokenizer.eos_token,
                    collect_hidden=False, prompt_buckets=(64, 128, 256),
                    preempt_after_chunks=4),
                self.gpt_params, self.embed_params,
                spk_emb_ids=self.tokenizer.spk_emb_ids, packed=self.packed,
                kv_bits=self.kv_bits)
        return self._text_engine

    def _code_requests(self, text, params: "Chat.InferCodeParams",
                       on_tokens=None, inputs=None):
        from .engine.batching import EngineRequest

        ids, attn, tmask, temp, spk = (inputs if inputs is not None
                                       else self._code_inputs(text, params))
        reqs = []
        for b in range(ids.shape[0]):
            n = int(attn[b].sum())
            reqs.append(EngineRequest(
                request_id=f"chat-{id(params)}-{b}",
                ids=ids[b, ids.shape[1] - n:],
                text_mask=tmask[b, ids.shape[1] - n:],
                temperature=temp, top_p=params.top_P, top_k=params.top_K,
                repetition_penalty=params.repetition_penalty,
                min_new=params.min_new_token,
                max_new=params.max_new_token, spk_vec=spk,
                seed=params.manual_seed,
                ensure_non_empty=params.ensure_non_empty,
                on_tokens=on_tokens))
        return reqs

    def _infer_code_engine(self, text, params: "Chat.InferCodeParams",
                           stream: bool = False, inputs=None, engine=None,
                           device_stream: bool = True,
                           long_chunk: bool = False):
        """Engine-backed code generation, streaming included: slot
        callbacks accumulate per-request increments and each engine chunk
        yields cumulative partials in the Generator's output format.

        Non-streaming outputs keep their hiddens on the device and feed the
        device decode path.  ``device_stream``: streaming requests keep
        their hidden states on the device (``stream_hiddens_dev``: the
        engine hands a copy of each row's whole buffer) and the partials
        carry batched ``hiddens_dev``/``end_dev``, so the window vocode
        runs on the device and only PCM goes to the host.  ``long_chunk``:
        a bulk consumer (the pipelined decode) takes the engine's long
        chunks between yields; a live stream keeps the short quantum."""
        eng = engine if engine is not None else self._engine_for_code()
        bar = self._progress_bar(params, len(text), "infer_code",
                                 per_request=True)

        def attach(reqs):
            if bar is not None:
                for r in reqs:
                    r.on_progress = functools.partial(bar.report,
                                                      r.request_id)
            return reqs

        if not stream:
            from .engine.batching import outputs_to_generation

            try:
                outs = eng.generate(
                    attach(self._code_requests(text, params, inputs=inputs)),
                    context=self.context)
            finally:
                if bar is not None:
                    bar.close()
            yield outputs_to_generation(outs)
            return

        B = len(text)
        D = self.config.gpt.hidden_size
        acc_ids: List[List[np.ndarray]] = [[] for _ in text]
        acc_hid: List[List[np.ndarray]] = [[] for _ in text]
        cum_dev: List[Optional[torch.Tensor]] = [None] * B
        done = [False] * B
        index = {}

        def on_tokens(rid, new_ids, new_hid, finished):
            b = index[rid]
            if new_ids is not None:  # None = dropped by interrupt
                acc_ids[b].append(np.asarray(new_ids))
            if new_hid is not None:
                if device_stream:
                    # full (max_new, D) device row; true length = id count
                    cum_dev[b] = new_hid
                else:
                    acc_hid[b].append(np.asarray(new_hid))
            done[b] = done[b] or finished

        reqs = attach(self._code_requests(text, params, on_tokens=on_tokens,
                                          inputs=inputs))
        for r in reqs:
            r.stream_hiddens_dev = device_stream
        index.update({r.request_id: b for b, r in enumerate(reqs)})
        for r in reqs:
            eng.add_request(r)
        Z = np.zeros((0, self.config.gpt.num_vq), np.int32)
        Zh = np.zeros((0, D), np.float32)

        def partial_out():
            out_ids = [np.concatenate(a) if a else Z for a in acc_ids]
            fin = np.asarray(done)
            if device_stream:
                # the FULL fixed-shape (max_new, D) slot rows stacked on
                # the device; rows beyond a request's own count are masked
                # by end_dev.  ``n_valid`` is bounded by the SLOWEST
                # UNFINISHED request: with staggered admission (more
                # requests than slots, or preemption) a late row's content
                # for positions [0, k) only appears once it is admitted,
                # and the windowed walk never revisits positions behind its
                # emission cursor - consuming past a lagging row would bake
                # its not-yet-generated positions in as silence.  Lockstep
                # batches lose nothing: all unfinished rows share one count.
                lens = [sum(a.shape[0] for a in acc) for acc in acc_ids]
                n_safe = min((n for n, d in zip(lens, done) if not d),
                             default=max(lens))
                Tbuf = next((h.shape[0] for h in cum_dev if h is not None),
                            0)
                hb = (torch.stack([
                    torch.zeros((Tbuf, D), dtype=torch.float32,
                                device=self.device) if h is None else h
                    for h in cum_dev]) if Tbuf
                    else torch.zeros((B, 0, D), dtype=torch.float32,
                                     device=self.device))
                return GenerationOutputs(
                    ids=out_ids, finished=fin, hiddens_dev=hb,
                    end_dev=torch.as_tensor(lens, dtype=torch.long,
                                            device=self.device),
                    n_valid=n_safe, partial=not all(done))
            return GenerationOutputs(
                ids=out_ids,
                hiddens=[np.concatenate(a) if a else Zh for a in acc_hid],
                finished=fin, partial=not all(done))

        try:
            while eng.has_unfinished():
                if self.context.get():
                    eng.interrupt()
                    break
                eng.step(long_chunk=long_chunk)
                yield partial_out()
        finally:
            if bar is not None:
                bar.close()

    def _infer_code(self, text: List[str], stream: bool, return_hidden: bool,
                    params: "Chat.InferCodeParams",
                    stream_batch_override: Optional[int] = None,
                    speculate: bool = False, speculate_from: int = 0,
                    on_dispatch=None):
        """The code pass: a generator of GenerationOutputs (partials when
        streaming).  ``stream_batch_override`` marks the pipelined decode,
        a bulk consumer: the Generator yields every that many steps, and
        the engine route steps long chunks."""
        cfg = self.config.gpt
        inputs = self._code_inputs(text, params)
        ids, attn, tmask, temperature, spk_vec = inputs
        if self.use_engine:
            plen = int(attn.sum(1).max())
            cap = max(self._code_engine_geometry("capacity").buckets)
            if plen <= cap:
                eng = self._engine_for_code(self._code_tier_for(
                    len(text), params.max_new_token, plen))
                return self._infer_code_engine(
                    text, params, stream=stream, inputs=inputs, engine=eng,
                    device_stream=return_hidden,
                    long_chunk=stream_batch_override is not None)
            # a prompt longer than the engine's prompt capacity falls back
            # to the one-shot generator, which buckets any length
            self.logger.info(
                "prompt length %d exceeds engine capacity %d; using the "
                "generator path", plen, cap)
        req = GenerateRequest(
            ids=ids, attn_mask=attn, text_mask=tmask, infer_text=False,
            eos_token=cfg.num_audio_tokens - 1, temperature=temperature,
            top_p=params.top_P, top_k=params.top_K,
            repetition_penalty=params.repetition_penalty,
            max_new=params.max_new_token, min_new=params.min_new_token,
            spk_vec=spk_vec, spk_emb_ids=self.tokenizer.spk_emb_ids,
            seed=params.manual_seed, ensure_non_empty=params.ensure_non_empty,
            stream_batch=(stream_batch_override if stream_batch_override
                          else (params.stream_batch if stream else 0)),
            return_hidden=return_hidden, speculate=speculate,
            speculate_from=speculate_from,
            on_dispatch=on_dispatch)  # the Generator's only: the engine
        # route above returns earlier (its windows are decoded at harvest)
        bar = self._progress_bar(params, len(text), "infer_code",
                                 per_request=False)
        gen = self.generator.generate(req, self.context)
        if bar is not None:
            req.on_progress = functools.partial(bar.report, "batch")
            gen = self._closing_bar(gen, bar)
        return gen
