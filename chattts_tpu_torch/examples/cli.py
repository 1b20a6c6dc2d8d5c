"""Command-line text-to-speech on the port (the counterpart of the JAX
package's ``examples/cli.py``).

    python -m chattts_tpu_torch.examples.cli "Hello world." --output out
    python -m chattts_tpu_torch.examples.cli "text one" "text two" --seed 42 --stream
    python -m chattts_tpu_torch.examples.cli "Hi." --source custom --custom-path /path/to/tree

Writes one 24 kHz 16-bit wav per result (``<output>.wav``, or
``<output><i>.wav`` for several).  Runs on CUDA unless ``--device cpu``.
``--source local`` (the default) loads ``./asset`` or ``$CHATTTS_ASSETS``
after checking it against the trusted checksums, and falls back to random
weights, with a warning, where there is no tree.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from chattts_tpu_torch import Chat
from chattts_tpu_torch.utils.audio import SAMPLE_RATE, write_wav
from chattts_tpu_torch.utils.logger import get_logger
from chattts_tpu_torch.utils.seeder import SpeakerSeedContext

logger = get_logger("chattts.cli")


def main(argv: Optional[List[str]] = None, config=None) -> int:
    """Parse ``argv`` (``sys.argv[1:]`` by default), synthesize, write the
    wavs; returns the exit code.  ``config`` overrides the model config
    (tests pass a small one)."""
    ap = argparse.ArgumentParser(description="chattts_tpu_torch text-to-speech")
    ap.add_argument("texts", nargs="+", help="texts to synthesize")
    ap.add_argument("--output", "-o", default="output",
                    help="output wav path prefix")
    ap.add_argument("--source", default="local",
                    choices=["local", "custom", "random"])
    ap.add_argument("--custom-path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--spk", default=None, help="speaker embedding string")
    ap.add_argument("--seed", type=int, default=None,
                    help="speaker timbre seed (ignored with --spk)")
    ap.add_argument("--manual-seed", type=int, default=None,
                    help="sampling seed for reproducible generation")
    ap.add_argument("--temperature", type=float, default=0.3)
    ap.add_argument("--top-p", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--max-new", type=int, default=2048)
    ap.add_argument("--min-new", type=int, default=0)
    ap.add_argument("--skip-refine", action="store_true")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--no-progress", action="store_true",
                    help="show_tqdm=False (the port shows no progress bar "
                         "yet)")
    args = ap.parse_args(argv)

    chat = Chat(logger=logger, config=config)
    logger.info("loading models (source=%s)", args.source)
    if not chat.load(source=args.source, custom_path=args.custom_path,
                     device=args.device):
        logger.error("model load failed")
        return 1

    spk = args.spk
    if spk is None and args.seed is not None:
        with SpeakerSeedContext(chat.speaker, args.seed):
            spk = chat.sample_random_speaker()
        logger.info("sampled speaker with seed %d", args.seed)

    params = Chat.InferCodeParams(
        spk_emb=spk, temperature=args.temperature, top_P=args.top_p,
        top_K=args.top_k, max_new_token=args.max_new,
        min_new_token=args.min_new, manual_seed=args.manual_seed,
        show_tqdm=not args.no_progress)

    t0 = time.time()
    if args.stream:
        gen = chat.infer(list(args.texts), stream=True,
                         skip_refine_text=args.skip_refine,
                         params_infer_code=params)
        chunks = []
        for i, chunk in enumerate(gen):
            logger.info("stream chunk %d: %s", i, chunk.shape)
            chunks.append(chunk)
        wavs = [np.concatenate([c[0] for c in chunks if c.size])]
    else:
        wavs = chat.infer(list(args.texts), skip_refine_text=args.skip_refine,
                          params_infer_code=params)
    dt = time.time() - t0
    total = 0.0
    for i, wav in enumerate(wavs):
        path = f"{args.output}{i if len(wavs) > 1 else ''}.wav"
        write_wav(path, wav)
        total += wav.shape[-1] / SAMPLE_RATE
        logger.info("wrote %s (%.2fs audio)", path, wav.shape[-1] / SAMPLE_RATE)
    logger.info("done: %.2fs audio in %.2fs wall (RTF %.2f)",
                total, dt, total / max(dt, 1e-9))
    return 0


if __name__ == "__main__":
    sys.exit(main())
