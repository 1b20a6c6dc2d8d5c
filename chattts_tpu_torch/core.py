"""Chat: the public facade (port of ``chattts_tpu/core.py``, non-streaming).

Two passes per batch of texts, as in the reference: the refine-text pass
rewrites the normalized text through the text head, then the code pass
samples 4-codebook audio codes and keeps the hidden states, which the mel
decoder and Vocos turn into 24 kHz audio in one shot (the reference's
``_device_decode`` with ``pipelined_decode=False``).  Both passes run the
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
                               EmissionPacer, StreamingDecoder, plan_windows)
from .models import dvae as dvae_mod
from .models import embed as embed_mod
from .models import llama as llama_mod
from .models import vocos as vocos_mod
from .models.speaker import Speaker
from .models.tokenizer import Tokenizer
from .norm import Normalizer
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
             custom_path: Optional[str] = None, seed: int = 0, device=None,
             coef: Optional[str] = None, use_engine: bool = False,
             weight_bits: int = 0, kv_bits: int = 8) -> bool:
        """Load weights from a ChatTTS asset tree, or seeded random weights.

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
        scales (its ``CHATTTS_KV_INT4``; engines then take up to 64 slots),
        0 in bf16.
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

    def _generate_wavs(self, batch: List[str], use_decoder: bool,
                       params: "Chat.InferCodeParams") -> np.ndarray:
        if not use_decoder:
            self._dvae("use_decoder=False")
        result = next(self._infer_code(batch, False, use_decoder, params))
        wavs = self._decode_to_wavs(result, use_decoder)
        result.destroy()
        return wavs

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
            B, n_max = hid.shape[0], hid.shape[1]
            if n_max == 0:
                return np.zeros((B, 0), np.float32)
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
                outs = eng.generate(reqs, context=self.context)
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
        return next(self.generator.generate(req, self.context))

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
                           device_stream: bool = True):
        """Engine-backed code generation, streaming included: slot
        callbacks accumulate per-request increments and each engine chunk
        yields cumulative partials in the Generator's output format.

        Non-streaming outputs keep their hiddens on the device and feed the
        device decode path.  ``device_stream``: streaming requests keep
        their hidden states on the device (``stream_hiddens_dev``: the
        engine hands a copy of each row's whole buffer) and the partials
        carry batched ``hiddens_dev``/``end_dev``, so the window vocode
        runs on the device and only PCM goes to the host."""
        eng = engine if engine is not None else self._engine_for_code()
        if not stream:
            from .engine.batching import outputs_to_generation

            outs = eng.generate(self._code_requests(text, params,
                                                    inputs=inputs),
                                context=self.context)
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

        reqs = self._code_requests(text, params, on_tokens=on_tokens,
                                   inputs=inputs)
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

        while eng.has_unfinished():
            if self.context.get():
                eng.interrupt()
                break
            eng.step()  # the short serving quantum: live listeners
            yield partial_out()

    def _infer_code(self, text: List[str], stream: bool, return_hidden: bool,
                    params: "Chat.InferCodeParams", speculate: bool = False,
                    speculate_from: int = 0, on_dispatch=None):
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
                    device_stream=return_hidden)
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
            stream_batch=params.stream_batch if stream else 0,
            return_hidden=return_hidden, speculate=speculate,
            speculate_from=speculate_from,
            on_dispatch=on_dispatch)  # the Generator's only: the engine
        # route above returns earlier (its windows are decoded at harvest)
        return self.generator.generate(req, self.context)
