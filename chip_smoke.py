#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA source of ``chattts_tpu_torch/csrc`` with nvcc, one
   process each, all started together, and prints the build seconds.
2. Holds K1 (the whole decode step, ``ops/decode_step.py``) against its
   plain PyTorch version on the card at the full model width (B 8, T 512,
   left-padded rows, ``cur`` at the first step, mid-cache and the last
   row): hidden max-abs error, the appended cache row, and every other
   cache row bit-unchanged.  Times the kernel, the plain version and one
   yardstick written with torch.matmul and scaled_dot_product_attention
   (``library_ms``; the port never calls it), beside the least time the
   card needs for the same bytes and operations.
3. Holds K1 against the plain version on one full-width layer with the MLP
   off and wo the identity, so attention's output is compared undiluted,
   and shows that this check rejects four planted attention faults.
4. Runs ``Chat.load(source="random", seed=0)`` and ``Chat.infer`` at the
   full config on 4 short texts, with K1's launch count set to 0 just
   before and read just after, and checks 4 finite non-empty waveforms.
   K1 calls of that run (the first step and step 63 of each pass) are
   kept and held against the plain version on their own inputs.

TF32 is switched off for matmuls and cuDNN convolutions, so float32 math on
the card is float32.  Exits non-zero without a result line when no CUDA
device is present or any check fails; the last line is the device JSON.
"""

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
# final-norm hidden, O(1) values: kernel and plain round alike, but f32
# sums run in another order, so an intermediate can land one bf16 ulp apart
# and carry through 20 layers; 0.05 is the repository's kernel tolerance
# (tests/test_pallas_step.py)
HIDDEN_ATOL = 0.05
ROW_ATOL, ROW_RTOL = 0.02, 0.02  # appended bf16 k/v row: ~2 bf16 ulps
# one layer's attention output o, which is rounded to bf16 before wo: two
# roundings of f32 values summed in another order differ by one bf16 ulp,
# at most 2^-7 of the value; near-zero outputs move when a q element rounds
# to the other bf16 neighbour, ~1e-6 a row, far below the 1e-4 allowed
ATTN_RTOL, ATTN_ATOL = 2 ** -7, 1e-4
# planted faults the one-layer check must catch (see _attention_o)
FAULTS = ("lo_ignored", "lo_plus_one", "cur_not_attended", "p_unrounded")


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(msg)


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_profile(fn):
    """Run fn once under torch.profiler: (seconds, [(kernel, launches,
    device us)] by device time).  The profiler slows the host, so its
    wall time is not reported; kernel times are the card's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    def name(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0].strip()[:60]

    rows = [(name(e.key), e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows) / 1e6, rows


def _print_profile(title, device_s, rows, top=8):
    print(f"{title}: device kernel time {device_s * 1e3:.3f} ms in "
          f"{sum(r[1] for r in rows)} launches")
    for name, count, us in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name}")


def _library_step(packed, emb, kc, vc, cur, lo, positions, cfg):
    """The same step in torch.matmul + SDPA (timed only, as a yardstick)."""
    import torch
    import torch.nn.functional as F
    from chattts_tpu_torch.ops.decode_step import rope_rows

    H, Dh, I = cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size
    HD, eps = H * Dh, cfg.rms_norm_eps
    B = emb.shape[0]
    cos, sin = rope_rows(cfg, positions)
    cos, sin = cos[:, None, :], sin[:, None, :]
    t = torch.arange(cur + 1, device=emb.device)
    mask = (t[None, :] >= lo[:, None])[:, None, None, :]
    x = emb.float()

    def rms(v, w):
        return (v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps) * w)

    def rope(v):
        v = v.reshape(B, H, Dh)
        rot = torch.cat([-v[..., Dh // 2:], v[..., :Dh // 2]], -1)
        return v * cos + rot * sin

    for li in range(packed["wqkv"].shape[0]):
        qkv = (rms(x, packed["ln1"][li]).bfloat16()
               @ packed["wqkv"][li].T).float()
        q, k = rope(qkv[:, :HD]), rope(qkv[:, HD:2 * HD])
        kc[li, :, cur] = k.reshape(B, HD).bfloat16()
        vc[li, :, cur] = qkv[:, 2 * HD:].bfloat16()
        keys = kc[li, :, :cur + 1].view(B, cur + 1, H, Dh).transpose(1, 2)
        vals = vc[li, :, :cur + 1].view(B, cur + 1, H, Dh).transpose(1, 2)
        o = F.scaled_dot_product_attention(q.bfloat16()[:, :, None], keys,
                                           vals, attn_mask=mask)
        x = x + (o.reshape(B, HD) @ packed["wo"][li].T).float()
        gu = rms(x, packed["ln2"][li]).bfloat16() @ packed["wgu"][li].T
        g, u = gu[:, :I], gu[:, I:]
        x = x + (F.silu(g) * u) @ packed["wd"][li].T
    return x


def _k1_bound_ms(cfg, B, cur, lo):
    """Least time for one K1 step: bytes it must move vs operations."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    HD = cfg.num_attention_heads * cfg.head_dim
    rows = sum(cur - int(v) + 1 for v in lo)          # visible rows, all b
    weight_bytes = L * (4 * D * D + 3 * D * I) * 2 + 2 * L * D * 4
    kv_bytes = L * (2 * rows * HD * 2 + 2 * B * HD * 2)  # read + append
    io_bytes = 2 * B * D * 4 + 2 * B * cfg.head_dim * 4 + B * 4
    nbytes = weight_bytes + kv_bytes + io_bytes
    flops = 2 * B * L * (4 * D * D + 3 * D * I) + 4 * L * rows * HD
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from chattts_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    seconds = _build.build(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.2f} s "
          f"(per source {seconds})")
    from chattts_tpu_torch.ops.decode_step import decode_step

    report = [ln.strip() for ln in decode_step.library.ptxas_report()
              .splitlines() if "entry function" in ln or "registers" in ln
              or "spill" in ln]
    for ln in report:
        print("ptxas:", ln)


def _compare_step(xk, kk, vk, xp, kp, vp, base_k, base_v, cur, norm, cfg,
                  where):
    """K1's step (xk and caches kk/vk) against the plain version's on the
    same inputs (base_k/base_v before the step): final-norm hidden within
    HIDDEN_ATOL, row cur within the row tolerance, every other row
    bit-unchanged.  Returns the hidden's (max-abs, mean-abs) error."""
    import torch
    from chattts_tpu_torch.models import llama

    torch.cuda.synchronize()
    hk = llama.rms_norm(xk, norm, cfg.rms_norm_eps)
    hp = llama.rms_norm(xp, norm, cfg.rms_norm_eps)
    err = float((hk - hp).abs().max())
    check(bool(torch.isfinite(hk).all()), f"K1 hidden is not finite ({where})")
    check(err <= HIDDEN_ATOL, f"K1 hidden err {err} ({where})")
    for got, ref, base in ((kk, kp, base_k), (vk, vp, base_v)):
        g, r = got[:, :, cur].float(), ref[:, :, cur].float()
        check(bool(torch.all((g - r).abs() <= ROW_ATOL + ROW_RTOL * r.abs())),
              f"K1 appended row differs ({where})")
        check(torch.equal(got[:, :, :cur], base[:, :, :cur]),
              f"K1 wrote a row before cur ({where})")
        check(torch.equal(got[:, :, cur + 1:], base[:, :, cur + 1:]),
              f"K1 wrote a row after cur ({where})")
    return err, float((hk - hp).abs().mean())


def phase_kernel(dev):
    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain,
                                                   pack_weights)
    from chattts_tpu_torch.weights import to_device

    cfg = Config().gpt
    B, T = 8, 512
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    gen = torch.Generator().manual_seed(1)
    params = to_device(llama.init_params(gen, cfg), dev)
    packed = pack_weights(params, cfg)
    base_k = torch.randn((L, B, T, HD), generator=gen).to(torch.bfloat16).to(dev)
    base_v = torch.randn((L, B, T, HD), generator=gen).to(torch.bfloat16).to(dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    lo = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64], device=dev)
    norm = params["norm"]
    worst = 0.0
    for cur in (96, T // 2, T - 1):
        pos = cur - lo
        kk, vk = base_k.clone(), base_v.clone()
        kp, vp = base_k.clone(), base_v.clone()
        xk = decode_step(packed, emb, kk, vk, cur, lo, pos, cfg)
        xp = decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
        err, mean_err = _compare_step(xk, kk, vk, xp, kp, vp, base_k, base_v,
                                      cur, norm, cfg, f"cur {cur}")
        worst = max(worst, err)
        kl, vl = base_k.clone(), base_v.clone()
        hl = llama.rms_norm(_library_step(packed, emb, kl, vl, cur, lo, pos,
                                          cfg), norm, cfg.rms_norm_eps)
        hp = llama.rms_norm(xp, norm, cfg.rms_norm_eps)
        print(f"k1 vs plain: cur {cur}: hidden max-abs {err:.3e}, mean-abs "
              f"{mean_err:.3e}; library vs plain max-abs "
              f"{float((hl - hp).abs().max()):.3e}")

    cur = T // 2
    pos = cur - lo
    kk, vk = base_k.clone(), base_v.clone()
    k1_ms = _time_ms(lambda: decode_step(packed, emb, kk, vk, cur, lo, pos,
                                         cfg))
    plain_ms = _time_ms(lambda: decode_step_plain(packed, emb, kk, vk, cur,
                                                  lo, pos, cfg), iters=5)
    lib_ms = _time_ms(lambda: _library_step(packed, emb, kk, vk, cur,
                                            lo, pos, cfg))
    bound_ms, bound_by = _k1_bound_ms(cfg, B, cur, lo.tolist())
    device_s, rows = _device_profile(lambda: [decode_step(
        packed, emb, kk, vk, cur, lo, pos, cfg) for _ in range(5)])
    _print_profile("k1 profile, 5 steps at B 8, cur 256", device_s, rows)
    print(f"k1 timing at B {B}, T {T}, cur {cur}: kernel {k1_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "k1_decode_step", "route": "cuda",
            "source": "chattts_tpu_torch/csrc/decode_step.cu",
            "replaces": "chattts_tpu/ops/pallas_step.py:268",
            "max_abs_err": worst, "ms": k1_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def _attention_o(packed, emb, kc, vc, cur, lo, positions, cfg, fault=None):
    """Layer 0's attention output o (B, HD) as decode_step_plain computes
    it, with one planted fault of FAULTS or none; kc/vc get row cur."""
    import torch
    from chattts_tpu_torch.ops.decode_step import (NEG, _bf, _mm, _rms,
                                                   _rope, rope_rows)

    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD, B = H * Dh, emb.shape[0]
    cos, sin = rope_rows(cfg, positions)
    qkv = _mm(_rms(emb.float(), packed["ln1"][0], cfg.rms_norm_eps),
              packed["wqkv"][0])
    q, k = _rope(qkv[:, :HD], cos, sin, H), _rope(qkv[:, HD:2 * HD], cos,
                                                  sin, H)
    kc[0, :, cur] = k.bfloat16()
    vc[0, :, cur] = qkv[:, 2 * HD:].bfloat16()
    first = {"lo_ignored": torch.zeros_like(lo),
             "lo_plus_one": lo + 1}.get(fault, lo)
    t = torch.arange(cur + 1, device=emb.device)
    visible = t[None, :] >= first[:, None]
    if fault == "cur_not_attended":
        visible = visible & (t[None, :] < cur)
    qs = _bf(q / Dh ** 0.5).reshape(B, H, Dh)
    keys = kc[0, :, :cur + 1].float().reshape(B, cur + 1, H, Dh)
    vals = vc[0, :, :cur + 1].float().reshape(B, cur + 1, H, Dh)
    s = torch.einsum("bhd,bthd->bht", qs, keys)
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    num = p if fault == "p_unrounded" else _bf(p)
    return (torch.einsum("bht,bthd->bhd", num, vals)
            / p.sum(-1)[..., None]).reshape(B, HD)


def phase_attention(dev):
    """K1 against the plain version on one full-width layer whose MLP is
    off and whose wo is the identity, so the step adds exactly bf16(o) to
    the residual and attention is compared undiluted.  Then the same check
    between the plain version and copies of its attention with a planted
    fault, each of which it must reject.  Returns the kernel's reading:
    max |got - want| / (ATTN_ATOL + ATTN_RTOL |want|), passing at <= 1."""
    import dataclasses

    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain,
                                                   pack_weights)
    from chattts_tpu_torch.weights import to_device

    cfg = dataclasses.replace(Config().gpt, num_hidden_layers=1)
    B, T, D = 8, 512, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    check(D == HD, "the identity wo needs hidden_size == heads * head_dim")
    gen = torch.Generator().manual_seed(2)
    packed = pack_weights(to_device(llama.init_params(gen, cfg), dev), cfg)
    packed["wgu"].zero_()
    packed["wd"].zero_()
    packed["wo"].copy_(torch.eye(D, dtype=torch.bfloat16)[None])
    base_k = torch.randn((1, B, T, HD), generator=gen).bfloat16().to(dev)
    base_v = torch.randn((1, B, T, HD), generator=gen).bfloat16().to(dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    lo = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64], device=dev)

    def reading(got, want):
        lim = ATTN_ATOL + ATTN_RTOL * want.abs()
        return float(((got - want).abs() / lim).max())

    worst = 0.0
    for cur in (96, T // 2, T - 1):
        pos = cur - lo
        step = {}
        for name, fn in (("kernel", decode_step), ("plain", decode_step_plain)):
            kc, vc = base_k.clone(), base_v.clone()
            step[name] = fn(packed, emb, kc, vc, cur, lo, pos, cfg) - emb
        want = step["plain"]
        kern = reading(step["kernel"], want)
        sane = reading((emb + _bf16(_attention_o(
            packed, emb, base_k.clone(), base_v.clone(), cur, lo, pos,
            cfg))) - emb, want)
        faults = {f: reading((emb + _bf16(_attention_o(
            packed, emb, base_k.clone(), base_v.clone(), cur, lo, pos, cfg,
            f))) - emb, want) for f in FAULTS}
        print(f"k1 one layer, o undiluted: cur {cur}: kernel reading "
              f"{kern:.3e} (limit 1), unfaulted copy {sane:.3e}, planted "
              + ", ".join(f"{f} {r:.3e}" for f, r in faults.items()))
        check(kern <= 1.0, f"K1 attention differs at cur {cur}: {kern}")
        check(sane <= 1.0, f"the unfaulted attention copy reads {sane}")
        for f, r in faults.items():
            check(r > 1.0, f"the one-layer check misses fault {f} ({r})")
        worst = max(worst, kern)
    return worst


def _bf16(x):
    return x.bfloat16().float()


def check_decode_on_cpu(chat, hid, end):
    """The card's hidden -> mel -> wav decode against the same decode on
    the CPU (float32 both; TF32 is off, so only the order of sums, the
    convolution algorithms and the FFT differ): within 1e-3 of the peak."""
    import torch
    from chattts_tpu_torch.weights import to_device

    got = chat._device_decode(hid, end).cpu()
    cpu = torch.device("cpu")
    saved = chat.decoder_params, chat.vocos_params
    chat.decoder_params = to_device(saved[0], cpu)
    chat.vocos_params = to_device(saved[1], cpu)
    try:
        ref = chat._device_decode(hid.cpu(), end.cpu())
    finally:
        chat.decoder_params, chat.vocos_params = saved
    err = float((got - ref).abs().max())
    peak = float(ref.abs().max())
    print(f"decode card vs cpu: {tuple(ref.shape)} max-abs {err:.3e}, "
          f"peak {peak:.3e}")
    check(err <= 1e-3 * peak, f"decode on the card differs from the CPU: "
          f"{err} of peak {peak}")


def check_kept_calls(chat, calls):
    """K1 calls kept during Chat.infer against the plain version on the
    same inputs: the batch, cache length, left padding and positions of
    the run that is timed."""
    from chattts_tpu_torch.ops.decode_step import decode_step_plain

    cfg, packed = chat.config.gpt, chat.generator.packed
    norm = chat.gpt_params["norm"]
    n = 0
    for i, pass_ in enumerate(calls):
        for (emb, kc0, vc0, lo, pos), cur, xk, kk, vk in pass_["kept"]:
            kp, vp = kc0.clone(), vc0.clone()
            xp = decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
            where = (f"infer pass {i}, B {emb.shape[0]}, T {kc0.shape[2]}, "
                     f"cur {cur}, lo {lo.tolist()}")
            err, mean_err = _compare_step(xk, kk, vk, xp, kp, vp, kc0, vc0,
                                          cur, norm, cfg, where)
            print(f"k1 vs plain in {where}: hidden max-abs {err:.3e}, "
                  f"mean-abs {mean_err:.3e}")
            n += 1
    check(n >= 2, f"kept {n} K1 calls of Chat.infer, expected one a pass")


def phase_infer():
    import numpy as np
    import torch
    from chattts_tpu_torch import Chat
    from chattts_tpu_torch.ops import decode_step as k1_mod
    from chattts_tpu_torch.ops.decode_step import decode_step

    chat = Chat()
    t0 = time.perf_counter()
    chat.load(source="random", seed=0)
    torch.cuda.synchronize()
    print(f"load: {time.perf_counter() - t0:.2f} s")
    steps = []
    generate = chat.generator.generate

    def counted(req, context=None):
        for out in generate(req, context):
            steps.append(out.steps)
            yield out

    chat.generator.generate = counted
    texts = ["Hello from the port.", "The quick brown fox.",
             "Speech on a graphics card.", "One more short sentence."]
    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=11, show_tqdm=False)
    code = Chat.InferCodeParams(max_new_token=256, min_new_token=64,
                                manual_seed=12, show_tqdm=False)
    # warm-up: cuBLAS/cuDNN handles and the kernel library load
    chat.infer(texts[:1], split_text=False, params_refine_text=refine,
               params_infer_code=Chat.InferCodeParams(
                   max_new_token=8, manual_seed=1, show_tqdm=False))
    steps.clear()

    decoded = []
    device_decode = chat._device_decode

    def capture(hid, end):
        decoded.append((hid, end))
        return device_decode(hid, end)

    chat._device_decode = capture

    # Keep K1's inputs and results at the first step and at step 63 of each
    # pass (a cur that does not follow the last one marks a new pass), to
    # hold those calls against the plain version afterwards.  The kept
    # tensors are device copies, made without a host sync.
    calls = []

    def keeping(packed, emb, kc, vc, cur, lo, pos, cfg):
        if not calls or calls[-1]["next_cur"] != cur:
            calls.append({"n": 0, "kept": []})
        pass_ = calls[-1]
        keep = pass_["n"] in (0, 63)
        pass_["n"] += 1
        pass_["next_cur"] = cur + 1
        if not keep:
            return decode_step(packed, emb, kc, vc, cur, lo, pos, cfg)
        before = [t.clone() for t in (emb, kc, vc, lo, pos)]
        x = decode_step(packed, emb, kc, vc, cur, lo, pos, cfg)
        pass_["kept"].append((before, cur, x.clone(), kc.clone(), vc.clone()))
        return x

    def run():
        return chat.infer(texts, split_text=False,
                          params_refine_text=refine, params_infer_code=code)

    decode_step.launches = 0
    k1_mod.decode_step = keeping
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        wavs = run()
        torch.cuda.synchronize()
    finally:
        k1_mod.decode_step = decode_step
    wall = time.perf_counter() - t0
    launches = decode_step.launches
    check_kept_calls(chat, calls)

    n_steps = sum(steps)
    check(len(wavs) == 4, f"expected 4 waveforms, got {len(wavs)}")
    for w in wavs:
        check(w.ndim == 1 and w.size > 0, "empty waveform")
        check(bool(np.isfinite(w).all()), "waveform is not finite")
    check(launches > 0 and launches >= n_steps,
          f"K1 launched {launches} times for {n_steps} decode steps")
    audio_s = sum(w.size for w in wavs) / chat.config.vocos.mel.sample_rate
    print(f"infer: 4 texts, steps per pass {steps}, wall {wall:.3f} s, "
          f"{n_steps / wall:.1f} steps/s, audio {audio_s:.2f} s, "
          f"audio s / wall s {audio_s / wall:.3f}, K1 launches {launches}")
    check_decode_on_cpu(chat, *decoded[-1])

    # the same request again under the profiler: where the card's time goes
    chat._device_decode = device_decode
    steps.clear()
    device_s, rows = _device_profile(run)
    _print_profile("infer profile", device_s, rows)
    print(f"infer: card busy {device_s:.3f} s of the {wall:.3f} s wall "
          f"({100 * device_s / wall:.1f}%)")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase_build()
    k1 = phase_kernel(dev)
    phase_attention(dev)
    k1["launches"] = phase_infer()
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: k1[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
