"""Whether what the timed path produced is correct: the comparison with the
plain reference, once the window has closed and the program is freed.

A sample of the greedy requests that finished in the window, drawn from
the seed with the longest among them, is run through the reference with
its prompt and its served code tokens (teacher-forced).  Two numbers are
compared with their limits (the workload file's ``limits``):

* ``logit_gap``: the widest gap by which a served token's score lies
  below the reference's best at that step, over every step and codebook
  of the sample (the score is the logit with the request's repetition
  penalty, EOS removed while the length is forced);
* ``wav_rel_err``: the largest relative L2 distance between a request's
  audio as served and the reference's audio of the same tokens.

The reference runs the prompt on the weights as drawn (bf16) and the
generated rows on the configuration's weight tier, as the deployment
does: ``weight_bits`` is the decode step's.  A request the Engine
preempted is followed through its resumes (the generated lengths at
which it was recomputed, which the program's scheduler chose and
``program.record_resumes`` kept).

The control puts the reference in the program's place one weight tier
below the configuration's on every row (int8 for bf16 weights, int4 for
int8), at the same prompts and tokens: the gap of the token it puts
first, and the distance of its audio.  A run with ``--control 1`` judges
the control's numbers in place of the program's, so it comes out not
correct; the control's readings set the upper end of each limit (PERF.md
gives the readings).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference import model as ref
from . import traffic

LOWER_TIER = {0: 8, 8: 4}   # a weight tier -> the next below it


def chosen(samples: Dict, count: int, seed: int) -> List:
    """The longest request and ``count - 1`` others, drawn from the seed."""
    keys = sorted(samples, key=lambda k: (len(samples[k][1]), str(k)))
    if not keys:
        return []
    longest, rest = keys[-1], keys[:-1]
    rng = traffic.rng_for(seed, "judge")
    pick = ([rest[i] for i in rng.choice(len(rest), min(count - 1, len(rest)),
                                         replace=False)] if rest else [])
    return [longest] + pick


def compare(s, samples: Dict, control: bool = False) -> Dict[str, dict]:
    """The numbers compared and their limits: {name: {"value", "limit"}}.
    With ``control`` the values are the control's, and the program's own
    readings stand beside them under "program"."""
    import torch

    ref.tf32_off()
    cfg = {"gpt": s.config["gpt"], "decoder": s.config["decoder"],
           "vocos": s.config["vocos"],
           "decode_pad": s.config["runtime"]["decode_bucket"] // 4}
    kvb, wb = s.config["kv_bits"], s.config["weight_bits"]
    eos = s.config["gpt"]["num_audio_tokens"] - 1
    penalty = s.traffic.get("repetition_penalty", 1.05)
    keys = chosen(samples, s.workload["judge"]["requests"], s.seed)
    worst = {"logit_gap": 0.0, "wav_rel_err": 0.0}
    ctl = {"logit_gap": 0.0, "wav_rel_err": 0.0}
    tokens = 0
    with torch.no_grad():
        for key in keys:
            text, codes, audio = samples[key]
            resumes = s.outputs.resumes.get(key, [])
            tokens += len(codes)
            r = ref.request_reference(s.weights, cfg, text,
                                      s.state["spk_vec"], codes, kvb, wb,
                                      resumes=resumes)
            scores = ref.penalized(r["logits"], codes, penalty, eos)
            gap = float(ref.gaps(scores, codes).max())
            err = ref.relative_error(audio, r["wav"][:len(audio)])
            worst["logit_gap"] = max(worst["logit_gap"], gap)
            worst["wav_rel_err"] = max(worst["wav_rel_err"], err)
            s.say(f"judged {key}: {len(codes)} steps, prompt "
                  f"{len(ref.prompt_ids(text, cfg['gpt']['num_text_tokens']))}"
                  f" tokens, resumed at {resumes}, logit gap {gap!r}, wav "
                  f"rel err {err!r}")
            if control:
                c = ref.request_reference(s.weights, cfg, text,
                                          s.state["spk_vec"], codes, kvb,
                                          LOWER_TIER[wb], LOWER_TIER[0],
                                          resumes=resumes)
                picked = ref.penalized(c["logits"], codes, penalty,
                                       eos).argmax(-1).cpu().numpy()
                cg = float(ref.gaps(scores, picked).max())
                ce = ref.relative_error(c["wav"][:len(audio)].cpu().numpy(),
                                        r["wav"][:len(audio)])
                ctl["logit_gap"] = max(ctl["logit_gap"], cg)
                ctl["wav_rel_err"] = max(ctl["wav_rel_err"], ce)
                s.say(f"control {key} (prompt int8, steps int"
                      f"{LOWER_TIER[wb]}): logit gap {cg!r}, wav rel err "
                      f"{ce!r}")
    limits = s.workload["limits"]
    s.counters["judged_requests"] = len(keys)
    s.counters["judged_tokens"] = tokens
    if control:
        return {k: {"value": ctl[k], "limit": limits[k],
                    "program": worst[k]} for k in worst}
    return {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}


def correct(checks: Dict[str, dict], judged: int) -> bool:
    return judged > 0 and all(np.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
