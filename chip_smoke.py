#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA source of ``chattts_tpu_torch/csrc`` with nvcc, one
   process each, all started together, and prints the build seconds.
2. Holds the decode step kernel (``ops/decode_step.py``) against its plain
   PyTorch version on the card at the full model width, in its four
   variants: K1 (bf16 cache, one position), K2 (a position per row), K3
   (int8 cache with embedded scales), K2+K3.  K1 at B 8, T 512 with
   ``cur`` at 96, 256 and the last row, and at B 32; the others at B 8, 16
   and 32, one case at T 2560 and, per row, one at the fast engine tier's
   8 x 2304, rows with different ``lo`` and ``cur`` including one visible
   key and the last cache row.  Checked: the final-norm hidden,
   every cache byte outside the appended rows unchanged, the appended row
   (kv8 rows as bytes, the differing bytes counted against a stated limit,
   and dequantized within one quantization step).  Times each variant, its
   plain version and one yardstick written with torch.matmul and
   scaled_dot_product_attention (``library_ms``; the port never calls it),
   beside the least time the card needs for the same bytes and operations
   (K2 is timed in phase 5, on a call of its own run).
3. Holds every variant against the plain version on one full-width layer
   with the MLP off and wo the identity, so attention's output is compared
   undiluted, and shows that this check rejects planted attention faults:
   four common ones, a neighbouring head's k or v scale (kv8), and row 0's
   position used for every row (per-row positions).
4. Runs ``Chat.load(source="random", seed=0)`` and ``Chat.infer`` at the
   full config on 4 short texts on the Generator, once with ``kv_bits=0``
   (K1) and once with the default int8 cache (K3), with the launch counts
   set to 0 just before and read just after, and checks 4 finite non-empty
   waveforms.  Kernel calls of those runs (the first step and a later one
   of each pass) are kept and held against the plain version on their own
   inputs.
5. Runs the continuous-batching ``Engine`` at the capacity geometry (16
   slots, 512-token prompt region, 2048 new tokens, int8 cache) on 24
   seeded requests, two of them twins submitted in different waves, checks
   every output, that the twins agree, that K2+K3 launched once per engine
   step, and kept K2+K3 calls (first chunk, and after slots turned over)
   against the plain version; again as the facade configures that tier,
   with preemption by recompute, which must happen, and a call kept after
   a resume prefill; then ``Chat.infer`` with ``use_engine=True`` on the 4
   texts, on the int8 cache (K2+K3) and on bf16 (K2), with calls of both
   its engines kept and held against the plain version, and K2 timed on
   one of them.

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
# appended bf16 k/v row: ~2 bf16 ulps in layer 0, whose inputs are equal;
# a deeper layer's row is a projection of the drifted residual and is held
# to HIDDEN_ATOL beside the same relative part
ROW_ATOL, ROW_RTOL = 0.02, 0.02
# one layer's attention output o, which is rounded to bf16 before wo: two
# roundings of f32 values summed in another order differ by one bf16 ulp,
# at most 2^-7 of the value; near-zero outputs move when a q element rounds
# to the other bf16 neighbour, ~1e-6 a row, far below the 1e-4 allowed
ATTN_RTOL, ATTN_ATOL = 2 ** -7, 1e-4
# planted faults the one-layer check must catch (see _attention_o): four
# that every variant can have, two of the int8 cache, one of per-row cur
FAULTS = ("lo_ignored", "lo_plus_one", "cur_not_attended", "p_unrounded")
FAULTS_KV8 = ("k_scale_of_next_head", "v_scale_of_next_head")
FAULTS_PER_ROW = ("cur_0_for_every_row",)
# appended kv8 rows, kernel against plain, as bytes: layer 0 quantizes
# inputs equal to a rounding, so at most 1% of its value bytes may differ
# (a value on a rounding tie moves by one); by layer 20 the residual has
# drifted by about 4e-3 on average against a quantization step of about
# 2.4e-2, which alone flips about one byte in six, so all layers together
# are held to 35%
KV8_DIFF_LAYER0, KV8_DIFF_ALL = 0.01, 0.35
VARIANT_NAMES = {"k1": "k1_decode_step", "k2": "k2_decode_step_per_slot",
                 "k3": "k3_decode_step_kv8",
                 "k2k3": "k2k3_decode_step_per_slot_kv8"}


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
    """Run fn once under torch.profiler: (device seconds, wall seconds of
    the same run, [(kernel, launches, device us)] by device time).  The
    profiler slows the host, so this wall is longer than an unprofiled
    run's; kernel times are the card's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    def name(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0].strip()[:60]

    rows = [(name(e.key), e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows) / 1e6, wall, rows


def _print_profile(title, device_s, rows, top=8):
    print(f"{title}: device kernel time {device_s * 1e3:.3f} ms in "
          f"{sum(r[1] for r in rows)} launches")
    for name, count, us in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name}")


def _cur_rows(cur, B, dev):
    """``cur`` (int or (B,) tensor) as a (B,) long tensor on dev."""
    import torch

    if isinstance(cur, torch.Tensor):
        return cur.to(dev).long().expand(B)
    return torch.full((B,), cur, dtype=torch.long, device=dev)


def _library_step(packed, emb, kc, vc, cur, lo, positions, cfg):
    """The same step in torch.matmul + SDPA (timed only, as a yardstick);
    an int8 cache is dequantized to bf16 for the attention call."""
    import torch
    import torch.nn.functional as F
    from chattts_tpu_torch.ops.decode_step import rope_rows
    from chattts_tpu_torch.ops.kv_quant import kv8_dequantize, kv8_quantize

    H, Dh, I = cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size
    HD, eps = H * Dh, cfg.rms_norm_eps
    B, T = emb.shape[0], kc.shape[2]
    kv8 = kc.dtype == torch.int8
    cos, sin = rope_rows(cfg, positions)
    cos, sin = cos[:, None, :], sin[:, None, :]
    cur_rows = _cur_rows(cur, B, emb.device)
    rows = torch.arange(B, device=emb.device)
    Tv = cur + 1 if isinstance(cur, int) else T
    t = torch.arange(Tv, device=emb.device)
    mask = ((t[None, :] >= lo[:, None])
            & (t[None, :] <= cur_rows[:, None]))[:, None, None, :]
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
        k, v = k.reshape(B, HD), qkv[:, 2 * HD:]
        if kv8:
            kc[li, rows, cur_rows] = kv8_quantize(k, cfg)
            vc[li, rows, cur_rows] = kv8_quantize(v, cfg)
            keys = kv8_dequantize(kc[li, :, :Tv], cfg).bfloat16()
            vals = kv8_dequantize(vc[li, :, :Tv], cfg).bfloat16()
        else:
            kc[li, rows, cur_rows] = k.bfloat16()
            vc[li, rows, cur_rows] = v.bfloat16()
            keys, vals = kc[li, :, :Tv], vc[li, :, :Tv]
        keys = keys.view(B, Tv, H, Dh).transpose(1, 2)
        vals = vals.view(B, Tv, H, Dh).transpose(1, 2)
        o = F.scaled_dot_product_attention(q.bfloat16()[:, :, None], keys,
                                           vals, attn_mask=mask)
        x = x + (o.reshape(B, HD) @ packed["wo"][li].T).float()
        gu = rms(x, packed["ln2"][li]).bfloat16() @ packed["wgu"][li].T
        g, u = gu[:, :I], gu[:, I:]
        x = x + (F.silu(g) * u) @ packed["wd"][li].T
    return x


def _step_bound_ms(cfg, seen, kv8):
    """Least time for one decode step whose row b attends ``seen[b]`` keys:
    the bytes it must move (weights once, the visible KV rows, the appended
    rows) against its operations."""
    from chattts_tpu_torch.ops.kv_quant import KV_PAD

    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    HD = cfg.num_attention_heads * cfg.head_dim
    B = len(seen)
    row_bytes = HD + KV_PAD if kv8 else 2 * HD
    rows = sum(seen)
    weight_bytes = L * (4 * D * D + 3 * D * I) * 2 + 2 * L * D * 4
    kv_bytes = 2 * L * (rows + B) * row_bytes            # read + append
    io_bytes = 2 * B * D * 4 + 2 * B * cfg.head_dim * 4 + 3 * B * 4
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


def _compare_kv8_rows(g, r, cfg, where):
    """Appended kv8 rows (L, B, W), kernel g against plain r, as bytes.
    Layer 0 quantizes inputs equal to a rounding: scale bytes equal, every
    dequantized value within one quantization step, at most KV8_DIFF_LAYER0
    of its value bytes different.  A deeper layer quantizes a projection of
    the residual, which may have drifted as the hidden may: its head scales
    within two mantissa steps (2/64), its values within a step plus
    HIDDEN_ATOL, its differing bytes counted against KV8_DIFF_ALL.  Pad
    lanes are zero everywhere.  Returns (differing bytes in layer 0, in all
    layers, value bytes)."""
    import torch
    from chattts_tpu_torch.ops.kv_quant import kv8_dequantize, row_scales

    H = cfg.num_attention_heads
    HD = H * cfg.head_dim
    check(torch.equal(g[0, :, HD:], r[0, :, HD:]),
          f"layer 0's appended scale bytes differ ({where})")
    check(not bool(g[..., HD + 2 * H:].any()),
          f"pad lanes of the appended row are not zero ({where})")
    sg, sr = row_scales(g, cfg), row_scales(r, cfg)
    check(bool(((sg - sr).abs() <= sr / 32 * (1 + 1e-6)).all()),
          f"an appended head scale is off by more than 2/64 ({where})")
    step = torch.maximum(sg, sr)[..., None] * (1 + 1e-6)
    err = (kv8_dequantize(g, cfg) - kv8_dequantize(r, cfg)).abs()
    err = err.reshape(err.shape[:-1] + (H, -1))
    check(bool((err[0] <= step[0]).all()),
          f"an appended kv8 value of layer 0 is off by more than a step "
          f"({where}): {float((err[0] / step[0]).max()):.3f} steps")
    check(bool((err <= step + HIDDEN_ATOL).all()),
          f"an appended kv8 value is off by more than a step and the "
          f"hidden's tolerance ({where}): {float((err - step).max()):.4f}")
    differ = g[..., :HD] != r[..., :HD]
    n0, n = int(differ[0].sum()), int(differ.sum())
    check(n0 <= KV8_DIFF_LAYER0 * differ[0].numel(),
          f"{n0} appended bytes of layer 0 differ ({where})")
    check(n <= KV8_DIFF_ALL * differ.numel(),
          f"{n} of {differ.numel()} appended bytes differ ({where})")
    return n0, n, differ.numel()


def _compare_step(xk, kk, vk, xp, kp, vp, base_k, base_v, cur, norm, cfg,
                  where):
    """The kernel's step (xk and caches kk/vk) against the plain version's
    on the same inputs (base_k/base_v before the step): final-norm hidden
    within HIDDEN_ATOL, row cur_b of row b within the row tolerance (kv8:
    see _compare_kv8_rows), every other byte unchanged.  Returns the
    hidden's (max-abs, mean-abs) error and the kv8 byte counts (or None)."""
    import torch
    from chattts_tpu_torch.models import llama

    torch.cuda.synchronize()
    hk = llama.rms_norm(xk, norm, cfg.rms_norm_eps)
    hp = llama.rms_norm(xp, norm, cfg.rms_norm_eps)
    err = float((hk - hp).abs().max())
    check(bool(torch.isfinite(hk).all()), f"hidden is not finite ({where})")
    check(err <= HIDDEN_ATOL, f"hidden err {err} ({where})")
    B = xk.shape[0]
    rows = torch.arange(B, device=xk.device)
    cur_rows = _cur_rows(cur, B, xk.device)
    keep = torch.ones(kk.shape[:3], dtype=torch.bool, device=xk.device)
    keep[:, rows, cur_rows] = False
    counts = [0, 0, 0]
    for got, ref, base in ((kk, kp, base_k), (vk, vp, base_v)):
        check(torch.equal(got[keep], base[keep]),
              f"the kernel wrote outside the appended rows ({where})")
        g, r = got[:, rows, cur_rows], ref[:, rows, cur_rows]
        if got.dtype == torch.int8:
            for i, c in enumerate(_compare_kv8_rows(g, r, cfg, where)):
                counts[i] += c
        else:
            # layer 0 appends values that agree to a rounding; deeper layers
            # project a residual that drifted as the hidden may
            g, r = g.float(), r.float()
            over = (g - r).abs() - ROW_RTOL * r.abs()
            per_layer = [round(float(v), 4) for v in over.amax(dim=(1, 2))]
            check(per_layer[0] <= ROW_ATOL and max(per_layer) <= HIDDEN_ATOL,
                  f"appended row differs ({where}): per-layer excess over "
                  f"{ROW_RTOL} |ref| is {per_layer}")
    kv8 = tuple(counts) if kk.dtype == torch.int8 else None
    return err, float((hk - hp).abs().mean()), kv8


def _ragged(B, T, gen, per_row, floor=0, cur=None):
    """Positions of a case: (cur argument, cur rows, lo).  Per row: row 0
    sees one key (cur = lo), row 1 writes the last cache row from lo 0, the
    rest are random; shared: ``cur`` (mid-cache unless given), row 0 sees
    one key."""
    import torch

    if per_row:
        cur = torch.randint(max(floor, 1), T, (B,), generator=gen)
        cur[0] = max(floor, 7)
        cur[1] = T - 1
        lo = torch.randint(0, T, (B,), generator=gen) % (cur + 1)
        lo[0], lo[1] = cur[0], 0
        return cur, cur, lo
    c = T // 2 if cur is None else cur
    lo = torch.randint(0, c + 1, (B,), generator=gen)
    lo[0] = c
    return c, torch.full((B,), c), lo


def _random_caches(shape, kv8, cfg, gen, dev):
    """Two seeded standard-normal caches drawn on the card (the seed comes
    from ``gen``), bf16 or quantized to kv8 rows."""
    import torch
    from chattts_tpu_torch.ops.kv_quant import kv8_quantize

    dgen = torch.Generator(device=dev)
    dgen.manual_seed(int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    out = []
    for _ in range(2):
        c = torch.randn(shape, generator=dgen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        out.append(kv8_quantize(c, cfg) if kv8 else c)
    return out


def _kernel_case(variant, cfg, packed, norm, B, T, gen, dev, cur=None):
    """One full-width case of a variant against the plain version (``cur``:
    the shared position of a scalar-cur variant, mid-cache unless given);
    returns the hidden's max-abs error.  The library yardstick's distance
    from the plain version is printed beside it, and held to nothing."""
    import torch
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain)

    L, D = cfg.num_hidden_layers, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    base_k, base_v = _random_caches((L, B, T, HD), "k3" in variant, cfg, gen,
                                    dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    cur, cur_rows, lo = _ragged(B, T, gen, "k2" in variant, cur=cur)
    cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
    cur_rows, lo = cur_rows.to(dev), lo.to(dev)
    pos = cur_rows - lo
    kk, vk, kp, vp = (base_k.clone(), base_v.clone(), base_k.clone(),
                      base_v.clone())
    xk = decode_step(packed, emb, kk, vk, cur, lo, pos, cfg)
    xp = decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
    where = f"{variant}, B {B}, T {T}"
    err, mean_err, kv8 = _compare_step(xk, kk, vk, xp, kp, vp, base_k,
                                       base_v, cur, norm, cfg, where)
    note = ""
    if kv8 is not None:
        note = (f"; appended kv8 value bytes that differ: {kv8[0]} in layer "
                f"0, {kv8[1]} of {kv8[2]} in all (limits "
                f"{KV8_DIFF_LAYER0:.0%} and {KV8_DIFF_ALL:.0%})")
    xl = _library_step(packed, emb, base_k.clone(), base_v.clone(), cur, lo,
                       pos, cfg)
    lib = float((llama.rms_norm(xl, norm, cfg.rms_norm_eps)
                 - llama.rms_norm(xp, norm, cfg.rms_norm_eps)).abs().max())
    print(f"{variant} vs plain: B {B}, T {T}, cur {int(cur_rows.min())}.."
          f"{int(cur_rows.max())}, visible keys "
          f"{int((cur_rows - lo + 1).min())}..{int((cur_rows - lo + 1).max())}"
          f": hidden max-abs {err:.3e}, mean-abs {mean_err:.3e}; library vs "
          f"plain max-abs {lib:.3e}{note}")
    return err


def _time_call(variant, cfg, packed, emb, kk, vk, cur, lo, pos, what,
               profile=False):
    """Kernel, plain and library milliseconds of one call of a variant on
    the given tensors (the caches are overwritten at row cur_b), and the
    call's bound from its own positions."""
    import torch
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain)

    B, T = emb.shape[0], kk.shape[2]
    ms = _time_ms(lambda: decode_step(packed, emb, kk, vk, cur, lo, pos, cfg))
    plain_ms = _time_ms(lambda: decode_step_plain(packed, emb, kk, vk, cur,
                                                  lo, pos, cfg), iters=5)
    lib_ms = _time_ms(lambda: _library_step(packed, emb, kk, vk, cur, lo,
                                            pos, cfg), iters=5)
    cur_rows = _cur_rows(cur, B, emb.device)
    # a row whose window is empty (a slot that holds no request) reads no key
    seen = (cur_rows - lo.to(emb.device) + 1).clamp(min=0)
    bound_ms, bound_by = _step_bound_ms(cfg, seen.tolist(),
                                        kk.dtype == torch.int8)
    if profile:
        device_s, _, rows = _device_profile(lambda: [decode_step(
            packed, emb, kk, vk, cur, lo, pos, cfg) for _ in range(5)])
        _print_profile(f"{variant} profile, 5 steps", device_s, rows)
    print(f"{variant} timing on {what}: B {B}, T {T}, visible keys "
          f"{int(seen.min())}..{int(seen.max())}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _time_variant(variant, cfg, packed, B, T, cur, cur_rows, lo, gen, dev):
    """``_time_call`` of a variant on seeded caches of one shape."""
    import torch

    L, D = cfg.num_hidden_layers, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    kk, vk = _random_caches((L, B, T, HD), "k3" in variant, cfg, gen, dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
    cur_rows, lo = cur_rows.to(dev), lo.to(dev)
    return _time_call(variant, cfg, packed, emb, kk, vk, cur, lo,
                      cur_rows - lo, "seeded caches", profile=True)


def phase_kernel(dev):
    """Every variant against its plain version at the full width, and its
    times.  Returns {variant: entry of the kernels line}."""
    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import pack_weights
    from chattts_tpu_torch.weights import to_device

    cfg = Config().gpt
    gen = torch.Generator().manual_seed(1)
    params = to_device(llama.init_params(gen, cfg), dev)
    packed = pack_weights(params, cfg)
    norm = params["norm"]
    worst = dict.fromkeys(VARIANT_NAMES, 0.0)
    for cur in (96, 256, 511):
        worst["k1"] = max(worst["k1"], _kernel_case(
            "k1", cfg, packed, norm, 8, 512, gen, dev, cur=cur))

    # the new variants: B 8 and 32 at T 512, B 16 at the capacity tier's
    # cache length; K1 once more at 32 rows (the lifted row limit)
    for variant in ("k2", "k3", "k2k3"):
        for Bv, Tv in ((8, 512), (16, 2560), (32, 512)):
            worst[variant] = max(worst[variant], _kernel_case(
                variant, cfg, packed, norm, Bv, Tv, gen, dev))
    # the facade's fast engine tier: 8 slots on a 2304-row cache
    for variant in ("k2", "k2k3"):
        worst[variant] = max(worst[variant], _kernel_case(
            variant, cfg, packed, norm, 8, 2304, gen, dev))
    worst["k1"] = max(worst["k1"], _kernel_case("k1", cfg, packed, norm, 32,
                                                512, gen, dev))

    # times: the scalar-cur variants at the Generator's shape of phase 4's
    # kind (B 8, T 512, cur 256), K2+K3 at the engine phase's (16 slots,
    # T 2560, 100..200 prompt tokens and 0..255 generated); K2 is timed in
    # phase 5, on a call its own run made
    entries = {}
    tgen = torch.Generator().manual_seed(5)
    cur_e = 512 + torch.randint(0, 256, (16,), generator=tgen)
    lo_e = 512 - torch.randint(100, 201, (16,), generator=tgen)
    lo_g = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64])
    shapes = {"k1": (8, 512, 256, torch.full((8,), 256), lo_g),
              "k3": (8, 512, 256, torch.full((8,), 256), lo_g),
              "k2k3": (16, 2560, cur_e, cur_e, lo_e)}
    for variant in VARIANT_NAMES:
        entries[variant] = {
            "name": VARIANT_NAMES[variant], "route": "cuda",
            "source": "chattts_tpu_torch/csrc/decode_step.cu",
            "replaces": "chattts_tpu/ops/pallas_step.py:268",
            "max_abs_err": worst[variant]}
        if variant in shapes:
            entries[variant].update(_time_variant(
                variant, cfg, packed, *shapes[variant], gen, dev))
    return entries


def _attention_o(packed, emb, kc, vc, cur, lo, positions, cfg, fault=None):
    """Layer 0's attention output o (B, HD) as decode_step_plain computes
    it for any variant (its own helpers and ``attend_plain``), with one
    planted fault or none; kc/vc get row cur_b of row b."""
    import torch
    from chattts_tpu_torch.ops.decode_step import (_mm, _rms, _rope,
                                                   attend_plain, rope_rows)
    from chattts_tpu_torch.ops.kv_quant import kv8_quantize, row_scales

    H = cfg.num_attention_heads
    HD, B, T = H * cfg.head_dim, emb.shape[0], kc.shape[2]
    kv8 = kc.dtype == torch.int8
    cos, sin = rope_rows(cfg, positions)
    qkv = _mm(_rms(emb.float(), packed["ln1"][0], cfg.rms_norm_eps),
              packed["wqkv"][0])
    q, k = _rope(qkv[:, :HD], cos, sin, H), _rope(qkv[:, HD:2 * HD], cos,
                                                  sin, H)
    v = qkv[:, 2 * HD:]
    cur_rows = _cur_rows(cur, B, emb.device)
    if fault == "cur_0_for_every_row":
        cur_rows = cur_rows[:1].expand(B)
    rows = torch.arange(B, device=emb.device)
    kc[0, rows, cur_rows] = kv8_quantize(k, cfg) if kv8 else k.bfloat16()
    vc[0, rows, cur_rows] = kv8_quantize(v, cfg) if kv8 else v.bfloat16()
    first = {"lo_ignored": torch.zeros_like(lo),
             "lo_plus_one": lo + 1}.get(fault, lo)
    t = torch.arange(T, device=emb.device)
    visible = (t[None, :] >= first[:, None]) & (t[None, :] <= cur_rows[:, None])
    if fault == "cur_not_attended":
        visible = visible & (t[None, :] < cur_rows[:, None])
    hooks = {}
    if fault == "k_scale_of_next_head":
        hooks["k_scales"] = row_scales(kc[0], cfg).transpose(1, 2).roll(-1, 1)
    if fault == "v_scale_of_next_head":
        hooks["v_scales"] = row_scales(vc[0], cfg).transpose(1, 2).roll(-1, 1)
    if fault == "p_unrounded":
        hooks["round_p"] = lambda p: p
    return attend_plain(q, kc[0], vc[0], visible[:, None, :], cfg, **hooks)


def phase_attention(dev):
    """Every variant against the plain version on one full-width layer
    whose MLP is off and whose wo is the identity, so the step adds exactly
    bf16(o) to the residual and attention is compared undiluted.  Then the
    same check between the plain version and copies of its attention with a
    planted fault, each of which it must reject.  A reading is
    max |got - want| / (ATTN_ATOL + ATTN_RTOL |want|), passing at <= 1;
    a result that is not finite reads infinity."""
    import dataclasses

    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain,
                                                   pack_weights)
    from chattts_tpu_torch.ops.kv_quant import kv8_quantize
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
    bf_k = torch.randn((1, B, T, HD), generator=gen).bfloat16().to(dev)
    bf_v = torch.randn((1, B, T, HD), generator=gen).bfloat16().to(dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    lo_k1 = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64], device=dev)

    def reading(got, want):
        lim = ATTN_ATOL + ATTN_RTOL * want.abs()
        r = ((got - want).abs() / lim).max()
        return float(r) if bool(torch.isfinite(r)) else float("inf")

    cases = [("k1", cur, lo_k1) for cur in (96, T // 2, T - 1)]
    pgen = torch.Generator().manual_seed(6)
    for variant in ("k2", "k3", "k2k3"):
        cur, _, lo = _ragged(B, T, pgen, "k2" in variant, floor=8)
        if "k2" not in variant:
            lo[0] = cur - 1  # two visible keys: lo + 1 still leaves one
        else:
            lo[0] = cur[0] - 1
        cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
        cases.append((variant, cur, lo.to(dev)))
    worst = 0.0
    for variant, cur, lo in cases:
        kv8 = "k3" in variant
        base_k = kv8_quantize(bf_k, cfg) if kv8 else bf_k
        base_v = kv8_quantize(bf_v, cfg) if kv8 else bf_v
        pos = _cur_rows(cur, B, dev) - lo
        step = {}
        for name, fn in (("kernel", decode_step), ("plain", decode_step_plain)):
            kc, vc = base_k.clone(), base_v.clone()
            step[name] = fn(packed, emb, kc, vc, cur, lo, pos, cfg) - emb
        want = step["plain"]

        def copy_reading(fault=None):
            return reading((emb + _bf16(_attention_o(
                packed, emb, base_k.clone(), base_v.clone(), cur, lo, pos,
                cfg, fault))) - emb, want)

        kern, sane = reading(step["kernel"], want), copy_reading()
        names = (FAULTS + (FAULTS_KV8 if kv8 else ())
                 + (FAULTS_PER_ROW if "k2" in variant else ()))
        faults = {f: copy_reading(f) for f in names}
        where = f"cur {cur}" if isinstance(cur, int) else "ragged cur"
        print(f"{variant} one layer, o undiluted: {where}: kernel reading "
              f"{kern:.3e} (limit 1), unfaulted copy {sane:.3e}, planted "
              + ", ".join(f"{f} {r:.3e}" for f, r in faults.items()))
        check(kern <= 1.0, f"{variant} attention differs ({where}): {kern}")
        check(sane <= 1.0, f"the unfaulted attention copy reads {sane}")
        for f, r in faults.items():
            check(r > 1.0, f"the one-layer check misses fault {f} of "
                  f"{variant} ({r})")
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


def check_kept_calls(packed, norm, cfg, kept, what, at_least):
    """Kernel calls kept during a run against the plain version on the same
    inputs: the batch, cache, positions and left padding of the run.
    Returns the largest hidden error."""
    from chattts_tpu_torch.ops.decode_step import (decode_step_plain,
                                                   variant_of)

    worst = 0.0
    for (emb, kc0, vc0, cur, lo, pos), xk, kk, vk in kept:
        kp, vp = kc0.clone(), vc0.clone()
        xp = decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
        cur_rows = _cur_rows(cur, emb.shape[0], emb.device)
        where = (f"{what}, {variant_of(kc0, cur)}, B {emb.shape[0]}, "
                 f"T {kc0.shape[2]}, cur {int(cur_rows.min())}.."
                 f"{int(cur_rows.max())}, lo {int(lo.min())}..{int(lo.max())}")
        err, mean_err, kv8 = _compare_step(xk, kk, vk, xp, kp, vp, kc0, vc0,
                                           cur, norm, cfg, where)
        note = "" if kv8 is None else (
            f"; appended kv8 bytes that differ: {kv8[0]} in layer 0, "
            f"{kv8[1]} of {kv8[2]}")
        print(f"kept call vs plain in {where}: hidden max-abs {err:.3e}, "
              f"mean-abs {mean_err:.3e}{note}")
        worst = max(worst, err)
    check(len(kept) >= at_least,
          f"kept {len(kept)} kernel calls of {what}, expected {at_least}")
    return worst


class Keeper:
    """Stands in for ``decode_step`` in a module's namespace: calls through,
    and keeps the inputs and results of the calls ``want(n, cur, kc)`` picks
    (device copies, made without a host sync)."""

    def __init__(self, want):
        from chattts_tpu_torch.ops.decode_step import decode_step

        self.inner, self.want, self.kept, self.n = decode_step, want, [], 0

    def __call__(self, packed, emb, kc, vc, cur, lo, pos, cfg):
        import torch

        keep = self.want(self.n, cur, kc)
        self.n += 1
        if not keep:
            return self.inner(packed, emb, kc, vc, cur, lo, pos, cfg)
        before = tuple(t.clone() if isinstance(t, torch.Tensor) else t
                       for t in (emb, kc, vc, cur, lo, pos))
        x = self.inner(packed, emb, kc, vc, cur, lo, pos, cfg)
        self.kept.append((before, x.clone(), kc.clone(), vc.clone()))
        return x


TEXTS = ["Hello from the port.", "The quick brown fox.",
         "Speech on a graphics card.", "One more short sentence."]


def _check_wavs(wavs):
    import numpy as np

    check(len(wavs) == 4, f"expected 4 waveforms, got {len(wavs)}")
    for w in wavs:
        check(w.ndim == 1 and w.size > 0, "empty waveform")
        check(bool(np.isfinite(w).all()), "waveform is not finite")


def phase_infer(chat, kv_bits, max_new, profile):
    """``Chat.infer`` on the Generator with the given cache tier: 4 texts,
    the launch counts read around it, kept calls checked.  Returns the
    launches of the tier's variant (k1 or k3) and the kept calls' largest
    hidden error."""
    import torch
    from chattts_tpu_torch import Chat
    from chattts_tpu_torch.engine import generate as gen_mod
    from chattts_tpu_torch.ops.decode_step import decode_step

    variant = "k3" if kv_bits else "k1"
    steps = []
    generate = chat.generator.generate

    def counted(req, context=None):
        for out in generate(req, context):
            steps.append(out.steps)
            yield out

    chat.generator.generate = counted
    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=11, show_tqdm=False)
    code = Chat.InferCodeParams(max_new_token=max_new, min_new_token=64,
                                manual_seed=12, show_tqdm=False)
    # warm-up: cuBLAS/cuDNN handles and the kernel library load
    chat.infer(TEXTS[:1], split_text=False, params_refine_text=refine,
               params_infer_code=Chat.InferCodeParams(
                   max_new_token=8, manual_seed=1, show_tqdm=False))
    steps.clear()

    decoded = []
    device_decode = chat._device_decode

    def capture(hid, end):
        decoded.append((hid, end))
        return device_decode(hid, end)

    chat._device_decode = capture

    # keep the first step and step 63 of each pass (a cur that does not
    # follow the last one marks a new pass)
    state = {"n": 0, "next": None}

    def want(n, cur, kc):
        if state["next"] != cur:
            state["n"] = 0
        keep = state["n"] in (0, 63)
        state["n"] += 1
        state["next"] = cur + 1
        return keep

    keeper = Keeper(want)

    def run():
        return chat.infer(TEXTS, split_text=False,
                          params_refine_text=refine, params_infer_code=code)

    decode_step.launches = 0
    gen_mod.k1.decode_step = keeper
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        wavs = run()
        torch.cuda.synchronize()
    finally:
        gen_mod.k1.decode_step = decode_step
    wall = time.perf_counter() - t0
    counts = dict(decode_step.variant_launches)
    launches = counts[variant]
    kept_err = check_kept_calls(chat.packed, chat.gpt_params["norm"],
                                chat.config.gpt, keeper.kept,
                                f"infer kv_bits={kv_bits}", 2)

    n_steps = sum(steps)
    _check_wavs(wavs)
    check(launches > 0 and launches >= n_steps
          and launches == sum(counts.values()),
          f"{variant} launched {launches} times for {n_steps} decode steps "
          f"(all variants: {counts})")
    audio_s = sum(w.size for w in wavs) / chat.config.vocos.mel.sample_rate
    print(f"infer kv_bits={kv_bits}: 4 texts, steps per pass {steps}, wall "
          f"{wall:.3f} s, {n_steps / wall:.1f} steps/s, audio {audio_s:.2f} s, "
          f"audio s / wall s {audio_s / wall:.3f}, {variant} launches "
          f"{launches}")
    chat._device_decode = device_decode
    if profile:
        check_decode_on_cpu(chat, *decoded[-1])
        # the same request again under the profiler
        device_s, prof_wall, rows = _device_profile(run)
        _print_profile(f"infer kv_bits={kv_bits} profile", device_s, rows)
        print(f"infer kv_bits={kv_bits}: card busy {device_s:.3f} s of the "
              f"profiled run's {prof_wall:.3f} s wall "
              f"({100 * device_s / prof_wall:.1f}%; unprofiled wall "
              f"{wall:.3f} s)")
    chat.generator.generate = generate
    return launches, kept_err


def _engine_requests(cfg):
    """24 seeded code-mode requests: prompts of 20-200 tokens, max_new
    64-256, min_new 32; requests 3 and 20 are twins (same seed, prompt and
    knobs), admitted in different waves of a 16-slot engine."""
    import numpy as np
    from chattts_tpu_torch.engine.batching import EngineRequest

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(24):
        n = int(rng.integers(20, 201))
        spec = dict(
            ids=np.repeat(rng.integers(5, cfg.num_text_tokens - 200,
                                       (n, 1)), cfg.num_vq, 1).astype(np.int32),
            text_mask=np.ones((n,), bool),
            temperature=np.full((cfg.num_vq,), 0.3, np.float32),
            top_p=0.7, top_k=20, repetition_penalty=1.05, min_new=32,
            max_new=int(rng.integers(64, 257)), seed=1000 + i)
        if i == 20:
            spec = {k: v for k, v in reqs[3].__dict__.items()
                    if k in spec}
        reqs.append(EngineRequest(request_id=f"e{i}", **spec))
    return reqs


def _check_engine_outputs(outs, reqs, cfg):
    """Every request returned once, in order, with a valid finish reason,
    a length inside its bounds and finite hiddens of that length."""
    import torch

    check([o.request_id for o in outs] == [r.request_id for r in reqs],
          "not every request returned exactly once, in order")
    for o, r in zip(outs, reqs):
        n = o.ids.shape[0]
        check(o.finish_reason in ("eos", "length"), o.finish_reason)
        check(r.min_new <= n <= r.max_new,
              f"{o.request_id}: {n} tokens outside [{r.min_new}, {r.max_new}]")
        check(o.finish_reason == "eos" or n == r.max_new,
              f"{o.request_id}: a length finish at {n} of {r.max_new}")
        hid = o.dev_hiddens()
        check(tuple(hid.shape) == (n, cfg.hidden_size)
              and bool(torch.isfinite(hid).all()),
              f"{o.request_id}: hiddens {tuple(hid.shape)} or not finite")


def _engine_run(eng, reqs, want):
    """``eng.generate(reqs)`` with the launch counts set to 0 just before
    and read just after, and the calls ``want`` picks kept.  Returns
    (outputs, wall seconds, launches by variant, the keeper)."""
    import torch
    from chattts_tpu_torch.engine import batching
    from chattts_tpu_torch.ops.decode_step import decode_step

    keeper = Keeper(want)
    decode_step.launches = 0
    batching.step_mod.decode_step = keeper
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        outs = eng.generate(reqs)
        torch.cuda.synchronize()
    finally:
        batching.step_mod.decode_step = decode_step
    wall = time.perf_counter() - t0
    counts = dict(decode_step.variant_launches)
    check(counts["k2k3"] == eng.stats["steps_launched"] == keeper.n
          and counts["k2k3"] == sum(counts.values()),
          f"k2k3 launches {counts} against {eng.stats['steps_launched']} "
          f"engine steps")
    return outs, wall, counts, keeper


def _print_engine_run(title, eng, outs, wall):
    reasons = [o.finish_reason for o in outs]
    tokens = eng.stats["tokens_generated"]
    print(f"{title}: {len(outs)} requests on {eng.ecfg.max_num_seqs} slots, "
          f"{eng.stats['steps']} steps ({eng.stats['steps_launched']} "
          f"launched), {tokens} kept slot-steps, "
          f"{eng.stats.get('preemptions', 0)} preemptions, finish reasons "
          f"{reasons.count('eos')} eos / {reasons.count('length')} length, "
          f"wall {wall:.3f} s, {eng.stats['steps'] / wall:.1f} steps/s, "
          f"{tokens / wall:.1f} slot-steps/s")
    lat = eng.latency_stats()
    print(f"{title}: queue delay p50 {lat['queue_delay_p50_s']:.3f} s, max "
          f"{lat['queue_delay_max_s']:.3f} s; first emission p50 "
          f"{lat['first_emission_p50_s']:.3f} s")


def phase_engine(chat, kernels):
    """The Engine at the capacity geometry on 24 requests, with preemption
    off (twins held to equality) and as the facade configures it; then the
    facade's engine route on both caches.  Adds the launches of its runs to
    ``kernels``, folds the kept calls' errors in, and times K2 on a call
    its run made."""
    import dataclasses

    import numpy as np
    import torch
    from chattts_tpu_torch import Chat
    from chattts_tpu_torch.engine import batching
    from chattts_tpu_torch.ops.decode_step import decode_step

    cfg = chat.config.gpt
    norm = chat.gpt_params["norm"]
    tier = chat._code_engine_geometry("capacity")
    check((tier.max_num_seqs, tier.max_prompt_len, tier.max_new_tokens,
           tier.preempt_after_chunks) == (16, 512, 2048, 4),
          f"capacity geometry is {tier}")

    def engine(ecfg):
        return batching.Engine(cfg, ecfg, chat.gpt_params, chat.embed_params,
                               spk_emb_ids=chat.tokenizer.spk_emb_ids,
                               packed=chat.packed)

    def fold(variant, counts, err):
        kernels[variant]["launches"] = (kernels[variant].get("launches", 0)
                                        + counts[variant])
        kernels[variant]["max_abs_err"] = max(kernels[variant]["max_abs_err"],
                                              err)

    # preemption by recompute is left off in the first run: a resumed
    # request is token-exact only up to the margins of its draws, and this
    # run holds two twin requests to equality
    ecfg = dataclasses.replace(tier, preempt_after_chunks=None)
    eng = engine(ecfg)
    check(eng.state.kc.dtype == torch.int8 and eng.state.kc.shape[2] == 2560,
          "the engine's cache is not the 2560-row int8 cache")
    eng.warmup()

    # keep the first call, and the first call after slots have turned over
    # (more prefills than slots), when cur is ragged
    marks = {}

    def want(n, cur, kc):
        if n == 0:
            return True
        if "turned" not in marks and eng.stats["prefills"] > ecfg.max_num_seqs:
            marks["turned"] = n
            return True
        return False

    reqs = _engine_requests(cfg)
    outs, wall, counts, keeper = _engine_run(eng, reqs, want)
    _check_engine_outputs(outs, reqs, cfg)
    check(eng.stats["peak_slots"] == 16,
          f"peak slots {eng.stats['peak_slots']}")
    check(eng.stats["prefills"] == 24 and not eng.has_unfinished(),
          f"prefills {eng.stats['prefills']}")
    check(np.array_equal(outs[3].ids, outs[20].ids) and outs[3].ids.size > 0,
          "the twin requests (same seed and prompt, different waves) differ")
    check("turned" in marks, "no call was kept after the slots turned over")
    fold("k2k3", counts, check_kept_calls(chat.packed, norm, cfg, keeper.kept,
                                          "engine", 2))
    _print_engine_run("engine", eng, outs, wall)
    del keeper, outs, eng

    # the same requests as the facade's capacity tier runs them: a request
    # that has held its slot for 4 chunks while others wait is preempted and
    # later resumed by a prefill of its prompt and its tokens so far
    eng = engine(tier)
    marks.clear()

    def want_resumed(n, cur, kc):
        if "resumed" not in marks and eng.stats.get("preemptions", 0) > 0 \
                and eng.stats["prefills"] > 24:
            marks["resumed"] = n
            return True
        return False

    reqs = _engine_requests(cfg)
    outs, wall, counts, keeper = _engine_run(eng, reqs, want_resumed)
    _check_engine_outputs(outs, reqs, cfg)
    check(eng.stats.get("preemptions", 0) > 0
          and eng.stats["prefills"] == 24 + eng.stats["preemptions"]
          and not eng.has_unfinished(),
          f"the tier's own configuration preempted "
          f"{eng.stats.get('preemptions', 0)} times in "
          f"{eng.stats['prefills']} prefills")
    check("resumed" in marks, "no call was kept after a resume prefill")
    fold("k2k3", counts, check_kept_calls(chat.packed, norm, cfg, keeper.kept,
                                          "engine with preemption", 1))
    _print_engine_run("engine with preemption", eng, outs, wall)
    del keeper, outs, eng

    # the first run's workload on a fresh engine under the profiler
    eng = engine(ecfg)
    device_s, prof_wall, rows = _device_profile(
        lambda: eng.generate(_engine_requests(cfg)))
    _print_profile("engine profile", device_s, rows)
    print(f"engine: card busy {device_s:.3f} s of the profiled run's "
          f"{prof_wall:.3f} s wall ({100 * device_s / prof_wall:.1f}%)")
    del eng

    # the facade's engine route: int8 cache (K2+K3), then bf16 (K2).  Kept:
    # the first call on each engine's cache (the text engine's, then the
    # fast code tier's) and the code engine's 40th
    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=11, show_tqdm=False)
    code = Chat.InferCodeParams(max_new_token=128, min_new_token=64,
                                manual_seed=12, show_tqdm=False)
    for kv_bits, variant in ((8, "k2k3"), (0, "k2")):
        echat = Chat(config=chat.config)
        echat.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                          decoder=chat.decoder_params,
                          vocos=chat.vocos_params, use_engine=True,
                          kv_bits=kv_bits)
        seen = {}

        def want_each(n, cur, kc):
            seen[kc.shape[2]] = seen.get(kc.shape[2], 0) + 1
            return seen[kc.shape[2]] == 1 or (
                kc.shape[2] == max(seen) and seen[kc.shape[2]] == 40)

        keeper = Keeper(want_each)
        decode_step.launches = 0
        batching.step_mod.decode_step = keeper
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            wavs = echat.infer(TEXTS, split_text=False,
                               params_refine_text=refine,
                               params_infer_code=code)
            torch.cuda.synchronize()
        finally:
            batching.step_mod.decode_step = decode_step
        wall = time.perf_counter() - t0
        counts = dict(decode_step.variant_launches)
        _check_wavs(wavs)
        engines = [echat._text_engine, *echat._code_engines.values()]
        steps = sum(e.stats["steps_launched"] for e in engines)
        check(counts[variant] == steps == sum(counts.values()) and steps > 0,
              f"use_engine kv_bits={kv_bits}: launches {counts}, engine "
              f"steps {steps}")
        check(list(echat._code_engines) == ["fast"],
              f"tiers built: {list(echat._code_engines)}")
        code_T = echat._code_engines["fast"].state.kc.shape[2]
        check(sorted(seen) == [echat._text_engine.state.kc.shape[2], code_T]
              and code_T == 2304 and seen[code_T] >= 40,
              f"use_engine kv_bits={kv_bits}: calls by cache length {seen}")
        fold(variant, counts, check_kept_calls(
            echat.packed, norm, cfg, keeper.kept,
            f"infer use_engine kv_bits={kv_bits}", 3))
        audio_s = sum(w.size for w in wavs) / chat.config.vocos.mel.sample_rate
        print(f"infer use_engine kv_bits={kv_bits}: 4 texts, {steps} engine "
              f"steps, wall {wall:.3f} s (first use of its engines), audio "
              f"{audio_s:.2f} s, {variant} launches {counts[variant]}")
        if variant == "k2":
            # K2's times, on the code engine's 40th call: 8 slots, 4 of them
            # holding no request, on the 2304-row bf16 cache
            (emb, kc0, vc0, cur, lo, pos), _, _, _ = keeper.kept[-1]
            check(kc0.shape[1:3] == (8, code_T), f"kept {tuple(kc0.shape)}")
            kernels["k2"].update(_time_call(
                "k2", cfg, echat.packed, emb, kc0, vc0, cur, lo, pos,
                "the use_engine run's 40th code step", profile=True))
        del echat, keeper


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
    t_start = time.perf_counter()

    phase_build()
    kernels = phase_kernel(dev)
    phase_attention(dev)
    torch.cuda.empty_cache()

    from chattts_tpu_torch import Chat

    chat = Chat()
    t0 = time.perf_counter()
    chat.load(source="random", seed=0)
    torch.cuda.synchronize()
    print(f"load: {time.perf_counter() - t0:.2f} s")
    chat0 = Chat(config=chat.config)
    chat0.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                      decoder=chat.decoder_params, vocos=chat.vocos_params,
                      kv_bits=0)
    for variant, c, kv_bits, max_new in (("k1", chat0, 0, 128),
                                         ("k3", chat, 8, 256)):
        launches, err = phase_infer(c, kv_bits=kv_bits, max_new=max_new,
                                    profile=bool(kv_bits))
        kernels[variant]["launches"] = launches
        kernels[variant]["max_abs_err"] = max(kernels[variant]["max_abs_err"],
                                              err)
    del chat0, c
    phase_engine(chat, kernels)
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels.values():
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": [{k: kernels[v][k] for k in keys}
                                  for v in ("k1", "k2", "k3", "k2k3")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
