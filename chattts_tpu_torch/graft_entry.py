"""Entry points of the port for a quick check (counterpart of
``__graft_entry__.py``): the full-width forward for a compile-and-run
check, and the multi-rank dry run of training and serving.

    python -m chattts_tpu_torch.graft_entry            # entry() on the card
    python -m chattts_tpu_torch.graft_entry --dryrun 4 # 4 ranks on this host
    torchrun --nproc-per-node 4 -m chattts_tpu_torch.graft_entry --torchrun

The dry run spawns its ranks on this host (``parallel/comm.spawn``): NCCL
where each rank has a GPU of its own, gloo otherwise (also on one card, and
on the CPU with ``device="cpu"``).  Under ``torchrun`` each process is one
rank of the same dry run (``--torchrun cpu`` keeps it on the CPU).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from .config import (Config, ConvStackConfig, DecoderConfig, GPTConfig,
                     VocosConfig)
from .models import dvae as dvae_mod
from .models import embed as embed_mod
from .models import llama
from .models import vocos as vocos_mod
from .parallel import comm
from .parallel import mesh as mesh_mod
from .weights import resolve_device, to_device


def entry(cfg: Optional[GPTConfig] = None, device=None):
    """(fn, example_args): one forward of the flagship model, the core
    compute of both generation passes: the prompt embedding (text/code),
    the decoder's prefill into a KV cache and the 4-codebook heads of the
    last position, at B 2, T 32, weights drawn from seed 0.  ``fn(*args)``
    returns (logits (B, num_vq, V_audio) f32, the cache).  Runs on CUDA
    unless ``device`` says otherwise; ``cfg`` (default the full model's)
    lets a test run it small."""
    cfg = cfg or Config().gpt
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    gpt_params = to_device(llama.init_params(gen, cfg), dev)
    embed_params = to_device(embed_mod.init_params(gen, cfg), dev)

    B, T = 2, 32
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 500, (B, T, cfg.num_vq))).to(dev)
    attn = torch.ones((B, T), dtype=torch.bool, device=dev)
    tmask = torch.ones((B, T), dtype=torch.bool, device=dev)

    def forward_step(gp, ep, ids, attn, tmask):
        emb = embed_mod.embed_prompt(ep, ids, tmask)
        positions = (torch.cumsum(attn.long(), dim=1) - 1).clamp(min=0)
        cache = llama.KVCache.create(cfg, B, T + 64, device=ids.device)
        hidden, cache = llama.prefill(gp, emb, attn, positions, cache, cfg)
        return embed_mod.head_code(ep, hidden[:, -1]), cache

    return forward_step, (gpt_params, embed_params, ids, attn, tmask)


def decode_dp(decoder_params: dict, vocos_params: dict,
              hiddens: torch.Tensor, mesh: mesh_mod.Mesh,
              dcfg: DecoderConfig, vcfg: VocosConfig) -> torch.Tensor:
    """The dp-sharded decode stage: rank i along dp turns its share of the
    finished hiddens (B, T, D), rows [i B/dp, (i + 1) B/dp), into mel and
    then waveform, and the waveforms (B, samples) are gathered on every
    rank (``Mesh.gather``: zero-padded parts summed, exact).  The decoder
    and Vocos weights are whole on every rank; no collective but the
    gather."""
    dp = mesh.shape["dp"]
    B = hiddens.shape[0]
    if B % dp:
        raise ValueError(f"{B} rows do not split over dp={dp}")
    share = B // dp
    i = mesh.coords["dp"]
    mel = dvae_mod.decode_from_hidden(
        decoder_params, hiddens[i * share:(i + 1) * share], dcfg)
    wav = vocos_mod.decode(vocos_params, mel, vcfg)
    return mesh.gather(wav, "dp").reshape((B,) + tuple(wav.shape[1:]))


def _dryrun_cfg() -> GPTConfig:
    """The real hidden and head geometry at 2 layers, as the JAX dry run."""
    return GPTConfig(num_hidden_layers=2, max_position_embeddings=128)


def _dryrun_requests(cfg: GPTConfig, n: int):
    from .engine.batching import EngineRequest

    reqs = []
    for i in range(n):
        rng = np.random.default_rng(i)
        reqs.append(EngineRequest(
            request_id=f"dry-{i}",
            ids=rng.integers(5, 50, (6, cfg.num_vq)).astype(np.int32),
            text_mask=np.ones((6,), bool),
            temperature=np.full((cfg.num_vq,), 0.7, np.float32),
            # equal lengths, so the finished hiddens stack for the decode
            min_new=8, max_new=8, seed=100 + i))
    return reqs


def _train_mesh_shape(n: int) -> tuple:
    """(dp, sp, tp) of the dry run's training step, as the JAX dry run
    picks them: tp 2 when ``n`` is even, sp 2 when that still leaves an
    even dp, dp the rest."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (2 * tp * 2) == 0 else 1
    return n // (tp * sp), sp, tp


def _dryrun_train(n: int, dev: torch.device) -> dict:
    """The training half of :func:`dryrun_multichip` on this rank: one
    sharded step on the (dp, sp, tp) mesh of :func:`_train_mesh_shape`
    (B 2 dp, T 32), its loss finite; then, on ranks 0 and 1, one GPipe step
    at pp=2, n_micro=2 (B 4, T 32) whose loss must match the plain step's
    (rtol 2e-4, atol 1e-5, as the JAX dry run holds it)."""
    from . import train
    from .parallel import pipeline

    cfg = _dryrun_cfg()
    opt = train.make_optimizer()
    dp, sp, tp = _train_mesh_shape(n)
    mesh = mesh_mod.make_mesh(dp=dp, sp=sp, tp=tp)
    whole = train.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   opt, device=dev)
    gpt = mesh_mod.shard_params(whole.gpt, mesh_mod.gpt_param_specs(cfg),
                                mesh)
    emb = mesh_mod.shard_params(whole.embed,
                                mesh_mod.embed_param_specs(cfg), mesh)
    state = train.TrainState(gpt, emb, opt.init((gpt, emb)), whole.step)
    batch = mesh_mod.shard_params(
        train.random_batch(torch.Generator().manual_seed(1), cfg, 2 * dp, 32,
                           device=dev), mesh_mod.train_batch_specs(), mesh)
    _, m = train.make_train_step(cfg, opt, mesh)(state, batch)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"the sharded train step's loss is {loss}")
    out = {"mesh": (dp, sp, tp), "loss": loss, "pp": None}
    del whole, gpt, emb, state, batch

    pp_mesh = pipeline.make_pp_mesh(2) if n >= 2 else None
    if pp_mesh is not None and pp_mesh.coords is not None:
        batch = train.random_batch(torch.Generator().manual_seed(1), cfg, 4,
                                   32, device=dev)
        plain = train.init_train_state(torch.Generator().manual_seed(0), cfg,
                                       opt, device=dev)
        _, plain_m = train.make_train_step(cfg, opt)(plain, batch)
        del plain
        pstate = pipeline.init_pp_state(torch.Generator().manual_seed(0),
                                        cfg, opt, pp_mesh, device=dev)
        _, pp_m = pipeline.make_pp_train_step(cfg, opt, pp_mesh, 2)(
            pstate, batch)
        pp_loss, plain_loss = float(pp_m["loss"]), float(plain_m["loss"])
        if not np.isclose(pp_loss, plain_loss, rtol=2e-4, atol=1e-5):
            raise RuntimeError(f"the GPipe step's loss {pp_loss} is not the "
                               f"plain step's {plain_loss}")
        out["pp"] = {"loss": pp_loss, "plain": plain_loss}
    return out


def _dryrun_rank(rank: int, n: int, dp: int, tp: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    from .engine.batching import Engine, EngineConfig

    if device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
    trained = _dryrun_train(n, dev)
    cfg = _dryrun_cfg()
    mesh = mesh_mod.make_mesh(dp=dp, tp=tp)
    gp = to_device(llama.init_params(torch.Generator().manual_seed(0), cfg),
                   dev)
    ep = to_device(embed_mod.init_params(torch.Generator().manual_seed(1),
                                         cfg), dev)
    ecfg = EngineConfig(max_num_seqs=2 * dp, max_prompt_len=16,
                        max_new_tokens=8, chunk_steps=4)
    reqs = _dryrun_requests(cfg, 2 * dp + 1)
    outs = Engine(cfg, ecfg, gp, ep, mesh=mesh).generate(reqs)
    if [o.request_id for o in outs] != [r.request_id for r in reqs]:
        raise RuntimeError("the sharded engine lost or reordered requests")
    # per-request-seed determinism on a second sharded engine
    again = Engine(cfg, ecfg, gp, ep, mesh=mesh).generate(
        _dryrun_requests(cfg, 1))
    if not np.array_equal(outs[0].ids, again[0].ids):
        raise RuntimeError("the sharded engine is not seed-deterministic")

    dcfg = DecoderConfig(stack=ConvStackConfig(
        idim=cfg.hidden_size // 2, odim=96, hidden=64, n_layer=2))
    vcfg = VocosConfig(dim=64, intermediate_dim=128, num_layers=2)
    dec = to_device(dvae_mod.init_decoder_params(
        torch.Generator().manual_seed(2), dcfg), dev)
    voc = to_device(vocos_mod.init_params(
        torch.Generator().manual_seed(3), vcfg), dev)
    hid = torch.stack([o.dev_hiddens() for o in outs[:2 * dp]])
    if tuple(hid.shape) != (2 * dp, 8, cfg.hidden_size):
        raise RuntimeError(f"finished hiddens {tuple(hid.shape)}")
    wav = decode_dp(dec, voc, hid, mesh, dcfg, vcfg)
    single = vocos_mod.decode(voc, dvae_mod.decode_from_hidden(dec, hid, dcfg),
                              vcfg)
    err = float((wav - single).abs().max())
    if tuple(wav.shape) != tuple(single.shape) or not err <= 1e-5:
        raise RuntimeError(f"dp-sharded decode {tuple(wav.shape)} differs "
                           f"from the single-rank decode by {err}")
    return {"mesh": (dp, tp), "requests": len(outs),
            "ids": [o.ids for o in outs], "wav_shape": tuple(wav.shape),
            "decode_err": err, "train": trained}


def dryrun_multichip(n_ranks: int, device: Optional[str] = None,
                     threads: Optional[int] = None) -> list:
    """The JAX dry run on ``n_ranks`` spawned ranks, at the real width and
    2 layers.  Training: one sharded step on a dp x sp x tp mesh
    (:func:`_train_mesh_shape`), its loss finite, and the GPipe step at
    pp=2 against the plain step's loss (:func:`_dryrun_train`).  Serving:
    a dp x tp mesh (tp 2 when ``n_ranks`` is even, dp the rest; serving
    keeps sp 1), the sharded Engine on 2 dp + 1 requests, seed determinism
    on a second engine, and the dp-sharded decode stage against the
    single-rank decode within 1e-5.  ``device``: "cuda" (the default;
    raises without a card) or "cpu".  Raises if any rank fails; returns
    the ranks' summaries."""
    device = resolve_device(device).type
    tp = 2 if n_ranks % 2 == 0 else 1
    dp = n_ranks // tp
    backend = "gloo" if device == "cpu" else comm.choose_backend(n_ranks)
    out = comm.spawn(_dryrun_rank, n_ranks, (dp, tp, device),
                     backend=backend, threads=threads)
    ids = out[0]["ids"]
    for r in out[1:]:
        if not all(np.array_equal(a, b) for a, b in zip(r["ids"], ids)):
            raise RuntimeError("the ranks' outputs differ")
        if r["train"]["loss"] != out[0]["train"]["loss"]:
            raise RuntimeError("the ranks' train losses differ")
    tr = out[0]["train"]
    print(f"dryrun_multichip train ok: mesh dp={tr['mesh'][0]} "
          f"sp={tr['mesh'][1]} tp={tr['mesh'][2]}, loss={tr['loss']:.4f}")
    if tr["pp"] is not None:
        print(f"dryrun_multichip pp ok: GPipe pp=2 n_micro=2 loss="
              f"{tr['pp']['loss']:.4f} matches plain step "
              f"{tr['pp']['plain']:.4f}")
    print(f"dryrun_multichip engine ok: mesh dp={dp} tp={tp} on {backend}, "
          f"{out[0]['requests']} requests over {2 * dp} sharded slots, "
          f"seed-deterministic")
    print(f"dryrun_multichip decode ok: dp-sharded hidden->mel->wav "
          f"{out[0]['wav_shape']} within {out[0]['decode_err']:.2e} of the "
          f"single-rank decode")
    return out


def _torchrun_rank(device: str) -> None:
    """This process's rank of the dry run, in a group that ``torchrun``
    describes in the environment."""
    import torch.distributed as dist

    n = int(os.environ["WORLD_SIZE"])
    comm.initialize_distributed(backend="gloo" if device == "cpu" else None)
    try:
        tp = 2 if n % 2 == 0 else 1
        out = _dryrun_rank(dist.get_rank(), n, n // tp, tp, device)
        print(f"rank {dist.get_rank()} of {n}: train mesh "
              f"{out['train']['mesh']} loss {out['train']['loss']:.4f}; "
              f"serving mesh dp={n // tp} tp={tp}, "
              f"{out['requests']} requests, decode within "
              f"{out['decode_err']:.2e} of the single-rank decode")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        dryrun_multichip(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--torchrun"]:
        _torchrun_rank(sys.argv[2] if len(sys.argv) > 2 else "cuda")
    else:
        fn, args = entry()
        logits, _ = fn(*args)
        print("entry ok:", tuple(logits.shape))
