"""What the serving drivers share: one in-process ``TTSService`` on the
configuration's tiers, the request parameters, and the warm-up."""

from __future__ import annotations

import threading

from . import family, program, traffic

GREEDY_TEMPERATURE = 1e-5
TIMEOUT_S = 120.0   # the service's own limit on a request thread's waits


def params(s, item):
    """A request's code parameters: the server's default cadence, its
    length forced, greedy or at ChatTTS's default temperature."""
    from chattts_tpu_torch.core import Chat

    return Chat.InferCodeParams(
        prompt="[speed_5]", spk_emb=s.state["spk"],
        temperature=GREEDY_TEMPERATURE if item.greedy else 0.3,
        top_P=0.7, top_K=20, repetition_penalty=1.05,
        max_new_token=item.steps, min_new_token=item.steps,
        manual_seed=(s.seed + 7919 * item.index) % (1 << 31),
        show_tqdm=False, **s.traffic.get("cadence", {}))


def start_service(s):
    """Load the chat and start its service (which warms its engines and
    one stream at the default cadence on the card)."""
    from chattts_tpu_torch.serving import TTSService

    rng = traffic.rng_for(s.seed, "speaker")
    fam = family.of(s.config)
    vec = traffic.speaker_vector(rng, fam.sizes(s.config)["speaker_dim"])
    s.state["spk_vec"] = vec
    s.state["spk"] = traffic.speaker_string(vec)
    chat = fam.load_chat(s.config, s.weights, s.device)
    program.record_decodes(chat, s.outputs)
    service = TTSService(chat, timeout=TIMEOUT_S)
    program.record_streamed_codes(service, s.outputs)
    program.record_resumes(service, s.outputs)
    s.state["chat"], s.state["service"] = chat, service
    return service


def warm(s, call) -> None:
    """Every length the window will use once, all at once, on prompts as
    long as the window's longest: ``call(item)`` in a thread each."""
    mix = dict(s.traffic, prompt_tokens=[s.traffic["prompt_tokens"][1]] * 2)
    items = traffic.items(mix, s.seed + 1, mix["length_quantiles"])
    threads = [threading.Thread(target=call, args=(it,)) for it in items]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def stop_service(s) -> None:
    service = s.state.pop("service", None)
    if service is not None:
        service.interrupt()
        service.close()
    s.state.pop("chat", None)


def code_stats(s) -> dict:
    return s.state["service"].stats()["code"]
