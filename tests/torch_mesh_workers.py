"""Rank functions of the port's mesh tests, run in spawned processes of one
process group (``chattts_tpu_torch.parallel.comm.spawn``).  They import the
port only, so a rank loads neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from chattts_tpu_torch.engine import batching
from chattts_tpu_torch.parallel import mesh as mesh_mod


def teacher(eng, ref, nvq: int, eos: int, agree: list):
    """A stand-in for ``sampling.sample`` that forces ``ref``'s tokens
    ({request_id: {"ids", "finish_reason"}}) on ``eng``'s rows: row r is
    global slot ``eng._base + r``; at depth g a slot takes its request's
    token g, and EOS past an EOS finish.  Each of its own draws is recorded
    in ``agree`` as equal to the forced token or not."""
    real = batching.sampling.sample

    def sample(logits, *args, **kwargs):
        own = real(logits, *args, **kwargs).reshape(-1, nvq)
        depth = args[3].reshape(-1, nvq)[:, 0].tolist()
        want = own.clone()
        for row in range(eng._slots_local):
            req = eng.slots[eng._base + row]
            if req is None:
                continue
            r = ref[req.request_id]
            if depth[row] < len(r["ids"]):
                want[row] = torch.from_numpy(
                    r["ids"][depth[row]].astype(np.int64))
                agree.append(bool(torch.equal(own[row], want[row])))
            elif r["finish_reason"] == "eos":
                want[row] = eos
        return want.reshape(-1)

    return sample


def run_engine(cfg, ecfg, gp, ep, reqs, mesh=None, kv_bits=8, ref=None):
    """``Engine.generate`` on fresh copies of ``reqs``: {request_id:
    {"ids", "hiddens", "finish_reason"}} with the engine's counters, and
    the share of own draws equal to ``ref``'s tokens where forced."""
    import copy

    eng = batching.Engine(cfg, ecfg, gp, ep, kv_bits=kv_bits, mesh=mesh)
    agree = []
    real = batching.sampling.sample
    if ref is not None:
        batching.sampling.sample = teacher(eng, ref, cfg.num_vq,
                                           cfg.num_audio_tokens - 1, agree)
    try:
        outs = eng.generate(copy.deepcopy(reqs))
    finally:
        batching.sampling.sample = real
    got = {o.request_id: {"ids": o.ids, "hiddens": o.host_hiddens(),
                          "finish_reason": o.finish_reason} for o in outs}
    stats = {k: eng.stats[k] for k in ("prefills", "steps", "steps_launched",
                                       "requests_finished",
                                       "tokens_generated", "peak_slots")}
    return {"outs": got, "order": [o.request_id for o in outs],
            "stats": stats,
            "agree": float(np.mean(agree)) if agree else None}


def engine_rank(rank: int, n: int, cfg, ecfg, gp, ep, reqs, jobs):
    """Run ``jobs`` in order on every rank: {"jobs": their results,
    "collectives": what a broadcast from rank n - 1 and a dp gather gave
    this rank}.  A job is {"mesh": (dp, tp) or None, "kv_bits", "ref": an
    earlier job's index or a result dict, or None}."""
    from chattts_tpu_torch.parallel import comm

    t = torch.full((2,), float(rank))
    got = {"broadcast": comm.broadcast(t, n - 1, None).tolist(),
           "gather": mesh_mod.make_mesh(dp=n).gather(
               torch.tensor([float(rank), -float(rank)]), "dp").tolist()}
    results = []
    for job in jobs:
        mesh = None
        if job["mesh"] is not None:
            dp, tp = job["mesh"]
            mesh = mesh_mod.make_mesh(dp=dp, tp=tp)
        ref = job.get("ref")
        if isinstance(ref, int):
            ref = results[ref]["outs"]
        results.append(run_engine(cfg, ecfg, gp, ep, reqs, mesh,
                                  job["kv_bits"], ref))
    return {"jobs": results, "collectives": got}
