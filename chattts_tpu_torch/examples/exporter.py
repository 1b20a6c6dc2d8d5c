"""Export the model's four stages as serialized ``torch.export`` graphs (the
counterpart of the JAX package's ``examples/exporter.py``).

Each stage is exported with ``torch.export.export`` and written with
``torch.export.save``: an ``ExportedProgram``, an ATen graph that
``torch.export.load`` runs without the package's model code, takes the
place of the JAX exporter's StableHLO.  The signatures are the JAX
graphs':

  * ``prefill.pt2``      - ``(gp, ep, ids, attn, tmask) -> (last hidden,
    cache)``: prompt embedding and the full-sequence forward into a new
    static KV cache of ``prompt_len + max_new`` rows
  * ``decode_step.pt2``  - ``(gp, ep, token, cache, cur, key_valid, pos)
    -> (hidden, cache)``: one AR step against that cache; ``cur`` is a 0-d
    and ``pos`` a (B,) integer tensor, so the graph writes and attends at
    whatever row it is given (a Python int would be baked in)
  * ``heads.pt2``        - ``(ep, hidden) -> logits (B, num_vq, V)``
  * ``vocoder.pt2``      - ``(dp, vp, hiddens (B, 128, D)) -> wav``

The parameter trees are inputs, so an artifact holds no weights (the
random ones drawn here only give the shapes; the example inputs
``torch.export`` would keep are dropped before saving) and runs on any
weights of its config.  The rope tables are the graphs' only constants.

The decode step exported is the plain ``models.llama.decode_step`` on the
bf16 cache, not the port's CUDA kernel, as the JAX exporter exports the
XLA step and not the Pallas kernel: a ``ctypes`` launch cannot be traced,
and carrying the hand-written kernels into a graph as ``torch.library``
custom ops is more than the reference does, so it is left out.  AOTInductor
packaging is left out too.  The step writes the caller's cache in place;
in the exported graph that write is functionalised, and the loaded
program's ``module()`` copies it back, so the returned cache and the one
passed in hold the new row alike.

``KVCache`` is registered for pytree serialization under a stable name
when this module is imported (the JAX exporter registers its namedtuple
the same way), so the graphs keep the port's ``KVCache`` in and out, as
``llama.decode_step`` takes and returns it, and a process that imports
this module can ``torch.export.load`` them.

    python -m chattts_tpu_torch.examples.exporter --out exported/ [--steps N]
    python -m chattts_tpu_torch.examples.exporter --out exported/ --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import torch
import torch.utils._pytree as pytree

from chattts_tpu_torch.config import Config
from chattts_tpu_torch.models import dvae as dvae_mod
from chattts_tpu_torch.models import embed as embed_mod
from chattts_tpu_torch.models import llama
from chattts_tpu_torch.models import vocos as vocos_mod
from chattts_tpu_torch.models.llama import KVCache
from chattts_tpu_torch.weights import resolve_device, to_device

GRAPHS = ("prefill", "decode_step", "heads", "vocoder")

try:  # a namedtuple in a graph's signature needs a name to serialize
    pytree._register_namedtuple(
        KVCache, serialized_type_name="chattts_tpu_torch.KVCache")
except ValueError:
    pass  # already registered


class _Stage(torch.nn.Module):
    """One stage function as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def stage_functions(cfg: Config, batch: int, prompt_len: int,
                    max_new: int) -> dict:
    """The four stages as plain functions of (parameter trees, inputs),
    the eager counterparts of the exported graphs."""
    g = cfg.gpt
    Tbuf = prompt_len + max_new

    def prefill_fn(gp, ep, ids, attn, tmask):
        emb = embed_mod.embed_prompt(ep, ids, tmask)
        pos = torch.clamp(torch.cumsum(attn.to(torch.int64), dim=1) - 1,
                          min=0)
        cache = KVCache.create(g, batch, Tbuf, device=emb.device)
        hidden, cache = llama.prefill(gp, emb, attn, pos, cache, g)
        return hidden[:, -1], cache

    def decode_fn(gp, ep, token, cache, cur, key_valid, pos):
        emb = embed_mod.embed_code_step(ep, token)
        return llama.decode_step(gp, emb, cache, cur, key_valid, pos, g)

    def heads_fn(ep, hidden):
        return embed_mod.head_code(ep, hidden)

    def vocoder_fn(dp, vp, hiddens):
        mel = dvae_mod.decode_from_hidden(dp, hiddens, cfg=cfg.decoder)
        return vocos_mod.decode(vp, mel, cfg=cfg.vocos)

    return {"prefill": prefill_fn, "decode_step": decode_fn,
            "heads": heads_fn, "vocoder": vocoder_fn}


def example_inputs(cfg: Config, batch: int, prompt_len: int, max_new: int,
                   device: torch.device) -> dict:
    """Each stage's inputs after its parameter trees, as the JAX exporter
    traces them: a zero prompt, a full mask, a zero cache, ``cur`` and the
    positions at ``prompt_len``."""
    g = cfg.gpt
    B, T0, Tbuf = batch, prompt_len, prompt_len + max_new

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = torch.ones((B, T0), dtype=torch.bool, device=device)
    return {
        # two tensors: an input passed twice is traced as one input
        "prefill": (z(B, T0, g.num_vq, dtype=torch.int64), attn,
                    attn.clone()),
        "decode_step": (
            z(B, g.num_vq, dtype=torch.int64),
            KVCache.create(g, B, Tbuf, device=device),
            torch.tensor(T0, device=device),
            torch.ones((B, Tbuf), dtype=torch.bool, device=device),
            torch.full((B,), T0, device=device)),
        "heads": (z(B, g.hidden_size),),
        "vocoder": (z(B, 128, g.hidden_size),),
    }


def random_params(cfg: Config, device: torch.device) -> dict:
    """The seeded trees the graphs are traced with (seeds 0-3, as the JAX
    exporter's ``PRNGKey(0..3)``), by name: gp, ep, dp, vp."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    trees = {"gp": llama.init_params(gen(0), cfg.gpt),
             "ep": embed_mod.init_params(gen(1), cfg.gpt),
             "dp": dvae_mod.init_decoder_params(gen(2), cfg.decoder),
             "vp": vocos_mod.init_params(gen(3), cfg.vocos)}
    return {k: to_device(v, device) for k, v in trees.items()}


# the parameter trees each stage takes before its inputs
STAGE_PARAMS = {"prefill": ("gp", "ep"), "decode_step": ("gp", "ep"),
                "heads": ("ep",), "vocoder": ("dp", "vp")}


def export_all(out_dir: str, batch: int = 1, prompt_len: int = 64,
               max_new: int = 512, device=None,
               config: Optional[Config] = None) -> dict:
    """Export the four graphs into ``out_dir`` as ``<name>.pt2``; returns
    their sizes in bytes by name.  Runs on CUDA unless ``device`` says
    otherwise; a graph runs on the device it was exported on."""
    cfg = config or Config()
    dev = resolve_device(device)
    params = random_params(cfg, dev)
    fns = stage_functions(cfg, batch, prompt_len, max_new)
    inputs = example_inputs(cfg, batch, prompt_len, max_new, dev)
    os.makedirs(out_dir, exist_ok=True)
    sizes = {}
    for name in GRAPHS:
        args = tuple(params[p] for p in STAGE_PARAMS[name]) + inputs[name]
        t0 = time.perf_counter()
        prog = torch.export.export(_Stage(fns[name]), args, strict=False)
        prog.example_inputs = None  # they hold the random weights
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(prog, path)
        sizes[name] = os.path.getsize(path)
        print(f"exported {name}: {sizes[name] / 1e6:.2f} MB in "
              f"{time.perf_counter() - t0:.2f} s -> {path}", flush=True)
    return sizes


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="export the model's graphs")
    ap.add_argument("--out", default="exported")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    export_all(args.out, args.batch, args.prompt_len, args.steps,
               device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
