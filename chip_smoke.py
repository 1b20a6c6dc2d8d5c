#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA source of ``chattts_tpu_torch/csrc`` with nvcc, one
   process each, all started together, and prints the build seconds.
   Then the step's gemv alone (``phase_gemv``): the full model's four
   shapes at 8, 16 and 64 rows on bf16, int8 and int4 weights through the
   one-gemv entry, each held to ``gemv_plain`` within its stated error
   bound, with its device us, ``torch.matmul``'s and its bytes bound.  And
   the kv4 cache's append alone (``phase_kv4_append``) at the full model's
   heads on 8, 16 and 64 rows: its bytes equal to ``kv4_append_plain``'s
   on the CPU copy of the same inputs, its device us, the plain version's
   and its bytes bound.
2. Holds the decode step kernel (``ops/decode_step.py``) against its plain
   PyTorch version on the card at the full model width, in every variant:
   K1 (bf16 cache, one position), K2 (a position per row), K3 (int8 cache
   with embedded scales), K2+K3; K4 (int8 weights) and K5 (int4 weights) on
   the bf16 and int8 caches, K6 (int4 cache) with bf16 weights, K5 on K6,
   each with one position and per row, and K2+K6+K4, at 8, 16, 32 and 64
   rows.  K1 at B 8, T 512 with
   ``cur`` at 96, 256 and the last row, and at B 32; the others at B 8, 16
   and 32, one case at T 2560 and, per row, one at the fast engine tier's
   8 x 2304, rows with different ``lo`` and ``cur`` including one visible
   key and the last cache row.  Checked: the final-norm hidden,
   every cache byte outside the appended rows unchanged, the appended row
   (kv8 and kv4 rows as bytes, the differing values counted against a
   stated limit, and dequantized within one quantization step); on the
   kv4 cache the full-depth hidden of rows that see at least 16 keys, on
   kv8 of every row, those that see fewer within twice the plain version's
   own movement under a 1e-6 change of its input (a row that sees one key
   takes its own appended v as o, so a quantization tie moves it by a
   whole step: chaotic at 20 layers), and on both every row layer by
   layer on equal inputs.  Times each variant, its
   plain version and one yardstick written with torch.matmul and
   scaled_dot_product_attention (``library_ms``; the port never calls it),
   beside the least time the card needs for the same bytes and operations
   (K2 is timed in phase 5, on a call of its own run).  Every timed call
   also gets one row per CUDA kernel of the step ("kernel rows"): its
   launches a step, device ms a launch and a step from a profile, its own
   bound, and the one PyTorch call that computes the same function
   (torch.matmul per gemv shape, SDPA for the attention pair).
3. Holds every variant against the plain version on one full-width layer
   with the MLP off and wo the identity, so attention's output is compared
   undiluted, and shows that this check rejects planted attention faults:
   four common ones, a neighbouring head's k or v scale (kv8, kv4), the
   two nibbles of every key byte swapped (kv4), and row 0's position used
   for every row (per-row positions).  On the kv4 cache the rows the step
   appended must equal, byte for byte, the plain append of the q, k and v
   of the kernel's own qkv gemv.  Then one full-width layer whose
   attention is off, so the MLP's output is compared undiluted, for the
   int8 and int4 weights, with planted faults in the weight scales: the
   int8 ``down`` scales of a neighbouring contraction group, and one int4
   group's scales taken from the next group.
4. Runs ``Chat.load(source="random", seed=0)`` and ``Chat.infer`` at the
   full config on 4 short texts on the Generator, once with ``kv_bits=0``
   (K1) and once with the default int8 cache (K3), with the launch counts
   set to 0 just before and read just after, and checks 4 finite non-empty
   waveforms.  Kernel calls of those runs (the first step and a later one
   of each pass) are kept and held against the plain version on their own
   inputs.  Then ``Chat.infer`` with its default arguments on the 4 texts
   joined as sentences, on the Generator and on the engine route: the
   auto-clone branch (segment 0 synthesized, its wav encoded by the DVAE
   encoder, the codes prompting all 4 segments) gives one finite wav; the
   clone branch is timed, and the share of its codes that the card's
   encoder gives equal to the CPU's encode of the same wav is printed with
   TF32 as PyTorch leaves it and off (at least 0.99 off).  Then
   ``use_decoder=False`` (codes through the GFSQ and the DVAE's decoder).
   These runs too keep the first step and a later one of each pass and
   hold them against the plain version, and their launches against the
   decode steps the passes report.
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
   one of them.  The wide tier (32 slots on the int8 cache), as the facade
   routes more than 16 requests to it, on 40 requests, kept calls held.
6. The quantized tiers' main paths, each with the launch counts set to 0
   just before and read just after, and kept calls held to the plain
   version: ``Chat.infer`` on the Generator with ``weight_bits=8,
   kv_bits=8`` (K4 on K3) and with ``weight_bits=4, kv_bits=4`` (K5 on K6);
   an Engine of 64 slots on ``kv_bits=4, weight_bits=8`` at the capacity
   geometry's cache (512 + 2048 rows) on 96 seeded requests, more than 32
   slots live at its peak (K2+K6+K4, timed on a call of that run); and
   ``Chat.infer`` with ``use_engine=True, weight_bits=8`` (K2+K3+K4).

7. Streaming and serving, each a main path with kept calls held to the
   plain version: ``Chat.infer(stream=True)`` on the 4 texts at 256 new
   tokens with the default cadence, on the Generator (K3) and on the
   engine route (K2+K3), and with ``use_decoder=False``
   (``phase_stream``): every chunk checked, the codes equal to a
   non-streamed run's, the samples to the one-shot decode of the same
   hiddens within the windowing tolerance, ``stream_window_ahead`` off
   bit-equal; time to the first chunk, gaps, audio s per wall s, busy
   share.  Then a ``TTSService`` on the capacity tier under 8 streaming
   and 8 blocking requests at once, an aborted stream, and the port's
   HTTP server on 127.0.0.1 (``phase_serving``).

``python3 chip_smoke.py --sweep-chunk`` runs only ``sweep_chunk``: the
attention chunk at 32, 64 and 128 keys, side by side.
``python3 chip_smoke.py --gemv`` builds and runs only ``phase_gemv``.

TF32 is switched off for matmuls and cuDNN convolutions (the multi-segment
phase turns cuDNN's back on for one encode, then restores it), so float32
math on the card is float32.  Exits non-zero without a result line when no
CUDA device is present or any check fails; the last line is the device
JSON.
"""

import collections
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
FAULTS_QUANT = ("k_scale_of_next_head", "v_scale_of_next_head")
FAULTS_KV4 = ("key_nibbles_swapped",)
FAULTS_PER_ROW = ("cur_0_for_every_row",)
# one layer's MLP output with quantized weights (see phase_weight_scales):
# kernel and plain multiply the same integers by the same scales in f32 and
# differ in the order of sums, and by a bf16 ulp (2^-8) of one of 3072
# activations where the gate's f32 value rounds the other way; 1e-3 of the
# value plus 1e-3 of the output's rms is far above both and far below what
# a wrong scale does
MLP_RTOL = 1e-3
# appended kv8 and kv4 rows, kernel against plain, as stored values: layer 0
# quantizes inputs equal to a rounding, so at most 1% of its values may differ
# (a value on a rounding tie moves by one); by layer 20 the residual has
# drifted by about 4e-3 on average against a quantization step of about
# 2.4e-2, which alone flips about one byte in six, so all layers together
# are held to 35%
KV8_DIFF_LAYER0, KV8_DIFF_ALL = 0.01, 0.35
# On a quantized cache a stored value that the drift moves across a
# rounding tie moves by a whole step, 1/7 (kv4) or 1/127 (kv8) of its
# head's absmax, and a row that sees n keys feels a flipped value of its own
# appended row at weight about 1/n: a one-key row's o is its own appended v.
# The plain version against itself with emb scaled by 1 + 1e-6 moves a
# one-key row's hidden by 0.1 to 0.6 on kv4 and by 0.018 to 0.066 on kv8
# (up to 1.3 times HIDDEN_ATOL), the other rows by 0.02 to 0.03
# (_kernel_case measures it in every quantized case).  So on kv4 the
# full-depth hidden and the deeper layers' appended rows are held for rows
# that see at least this many keys; on kv8 every row is held at full
# depth, the rows that see fewer keys to the larger of HIDDEN_ATOL and
# FEW_KEYS_CHAOS times the plain version's own movement on those rows in
# the same case; on both, every row, whatever it sees, is held layer by
# layer on equal inputs (_layerwise_case).
KEYS_HELD = 16
# the kernel sums in another order than the plain version, a change of
# the same size as the 1e-6 perturbation; either may move a few-key row
# its own way, so their distance may reach twice the movement
FEW_KEYS_CHAOS = 2.0
# one layer on equal inputs (_layerwise_case): the residual after the layer,
# O(1); kernel and plain differ by the order of f32 sums and by a bf16 ulp
# of an o or an activation element, each times a weight of about 0.02
LAYER_ATOL = 5e-3
VARIANT_NAMES = {"k1": "k1_decode_step", "k2": "k2_decode_step_per_slot",
                 "k3": "k3_decode_step_kv8",
                 "k2k3": "k2k3_decode_step_per_slot_kv8"}
# rows of the kernels line beyond those four.  K4, K5 and K6 are rows by
# feature: their launches are those of every variant whose name holds the
# feature, their error the largest over those variants' cases, and their
# times those of the variant named here at K3's shape (B 8, T 512, cur 256)
FEATURE_ROWS = {"k4": ("k4_decode_step_w8", "k3k4"),
                "k5": ("k5_decode_step_w4", "k6k5"),
                "k6": ("k6_decode_step_kv4", "k6")}
COMBINATION_ROWS = {"k2k6k4": "k2k6k4_decode_step_per_slot_kv4_w8"}


def _tier(variant):
    """(weight_bits, kv_bits, a position per row) of a variant's name."""
    return (8 if "k4" in variant else 4 if "k5" in variant else 0,
            4 if "k6" in variant else 8 if "k3" in variant else 0,
            variant.startswith("k2"))


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

    # the profiler's raw events, summed by kernel: the same counts and
    # device time as key_averages(), whose per-op tables are slow to build
    # for a run of tens of thousands of launches
    totals = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t = totals[name(e.name())]
            t[0] += 1
            t[1] += e.duration_ns() / 1e3
    rows = sorted(((k, n, us) for k, (n, us) in totals.items()),
                  key=lambda r: -r[2])
    return sum(r[2] for r in rows) / 1e6, wall, rows


def _kernel_events(fn):
    """Run fn once under torch.profiler: its device kernels in the order
    they ran, [(name, device us)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name.replace("(anonymous namespace)::", "")
             .removeprefix("void ").split("(")[0].strip(),
             e.time_range.elapsed_us()) for e in events]


# the step's kernels by the row each launch gets: the gemv's instantiation
# <mode, add, ...> names its matrix; qkv and gate/up share mode 1, and the
# one that the attention (or the kv4 append) follows is qkv
GEMV_ROWS = {"0": "gemv wo", "2": "gemv down"}
ATTN_ROWS = ("attend_scores", "attend_values")


def _kernel_rows_of(names):
    """The row of each launch of a run of steps (see GEMV_ROWS), None for
    a kernel of the wrapper's torch ops."""
    rows = []
    for i, name in enumerate(names):
        row = None
        if name.startswith("gemv_kernel<"):
            mode = name[len("gemv_kernel<")]
            after = names[i + 1] if i + 1 < len(names) else ""
            row = GEMV_ROWS.get(mode) or (
                "gemv qkv" if after.startswith(ATTN_ROWS + ("kv4_append",))
                else "gemv gate/up")
        for kernel in ATTN_ROWS + ("kv4_append_kernel",):
            if name.startswith(kernel):
                row = kernel
        rows.append(row)
    return rows


def _kv_row_bytes(cfg, kv_bits):
    """(bytes of a cache row, bytes of it that attention reads): a row is
    2 HD, HD + 128 or HD/2 + 128 bytes wide, and the kernels read the bf16
    row whole, of a quantized one only its values and the 2 H head-scale
    bytes, one 32-byte sector here (the pad past the scales is written by
    an append, never read)."""
    from chattts_tpu_torch.ops.kv_quant import KV_PAD

    H = cfg.num_attention_heads
    HD = H * cfg.head_dim
    if not kv_bits:
        return 2 * HD, 2 * HD
    qw = HD if kv_bits == 8 else HD // 2
    return qw + KV_PAD, qw + -(-2 * H // 32) * 32


def _kernel_bounds(cfg, seen, kv_bits, weight_bits):
    """Least time of one launch of each kernel of the step, the step's
    bound (_step_bound_ms) split by kernel: {row: (ms, "bytes" or
    "operations")}.  Each input byte read once, each output byte written
    once: a gemv's weights and scales, its f32 input rows (and the norm's
    weights), its output rows (read too where it adds to them); the
    attention pair's visible KV rows as it reads them (_kv_row_bytes; on
    bf16 and kv8 the row it appends is its output, on kv4 kv4_append's
    output is its input), q (and k, v where it appends), cos and sin, its
    appended rows and o; kv4's append its k and v, cos and sin, and the
    two rows it writes.  Rows whose window is empty append nothing."""
    from chattts_tpu_torch.ops.decode_step import int4_group

    D, I = cfg.hidden_size, cfg.intermediate_size
    Dh = cfg.head_dim
    HD = cfg.num_attention_heads * Dh
    B, rows = len(seen), sum(seen)
    live = sum(1 for n in seen if n > 0)
    row_bytes, read_bytes = _kv_row_bytes(cfg, kv_bits)
    group = {0: None, 8: D, 4: int4_group(D)}[weight_bits]

    def gemv(N, K, in_floats, adds, norm):
        return _gemv_work(B, N, K, weight_bits, group, in_floats, adds, norm)

    rope = 2 * B * Dh * 4 + 2 * B * 4                     # cos, sin, cur, lo
    appends = kv_bits != 4
    append = B * 2 * HD * 4 + 2 * live * row_bytes       # k, v in; rows out
    work = {
        "gemv qkv": gemv(3 * HD, D, D, False, True),
        "gemv wo": gemv(D, HD, HD, True, False),
        "gemv gate/up": gemv(2 * I, D, D, False, True),
        "gemv down": gemv(D, I, 2 * I, True, False),
        "attention pair": (2 * (rows - live if appends else rows) * read_bytes
                           + rope + B * HD * 4 + (append if appends else 0)
                           + B * HD * 4, 4 * rows * HD)}
    if not appends:
        work["kv4_append_kernel"] = (append + rope, 0)
    return {row: _bound_ms(*w) for row, w in work.items()}


def _gemv_work(B, N, K, weight_bits, group, in_floats, adds, norm):
    """(bytes, operations) of one gemv: its weights (2, 1 or 1/2 bytes a
    value) and f32 scales (N, K / group), its B f32 input rows of
    ``in_floats`` (K, or 2K for the silu prologue) and the norm's K
    weights, its output rows (read too where it adds to them); 2 B N K
    operations."""
    wb = {0: 2, 8: 1, 4: 0.5}[weight_bits]
    scales = N * (K // group) * 4 if weight_bits else 0
    return (N * K * wb + scales + B * in_floats * 4 + (K * 4 if norm else 0)
            + B * N * 4 * (2 if adds else 1), 2 * B * N * K)


def _bound_ms(nbytes, flops):
    """The least time for ``nbytes`` and ``flops`` on the card: (ms,
    "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_kernels(cfg, packed, emb, kk, vk, cur, lo, pos):
    """Device milliseconds of the one PyTorch call that computes each
    kernel's function on one layer's inputs (a yardstick; the port never
    calls them): torch.matmul of bf16 weights (dequantized ahead, as
    _library_weights does) for each gemv, scaled_dot_product_attention on
    layer 0's roped q and each row's window [lo_b, cur_b] of K and V,
    gathered ahead of the call into (B, H, N, Dh) bf16 (a quantized cache
    dequantized), N the longest window, under a mask of each row's own
    length.  {row: ms a launch}."""
    import torch
    import torch.nn.functional as F
    from chattts_tpu_torch.ops import kv_quant
    from chattts_tpu_torch.ops.decode_step import (_mm, _rms, _rope,
                                                   kv_bits_of, rope_rows)

    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD, D, I = H * Dh, cfg.hidden_size, cfg.intermediate_size
    B = emb.shape[0]
    lib = _library_weights(packed, cfg)
    gen = torch.Generator(device=emb.device).manual_seed(9)
    out = {}
    for row, name, K in (("gemv qkv", "wqkv", D), ("gemv wo", "wo", HD),
                         ("gemv gate/up", "wgu", D), ("gemv down", "wd", I)):
        w = lib[name][0]
        x = torch.randn((B, K), generator=gen, device=emb.device
                        ).bfloat16()
        out[row] = _device_ms(lambda: x @ w.T)
    cos, sin = rope_rows(cfg, pos)
    qkv = _mm(_rms(emb.float(), packed["ln1"][0], cfg.rms_norm_eps),
              lib["wqkv"][0])
    q = _rope(qkv[:, :HD], cos, sin, H).bfloat16().reshape(B, H, 1, Dh)
    cur_rows = _cur_rows(cur, B, emb.device)
    n = (cur_rows - lo + 1).clamp(min=0)
    t = torch.arange(max(int(n.max()), 1), device=emb.device)
    # row b's keys lo_b, lo_b + 1, ...; the rows past its window are masked
    at = (lo[:, None] + t[None, :]).clamp(0, kk.shape[2] - 1)
    rows = torch.arange(B, device=emb.device)[:, None]
    dequantize = {0: lambda r, c: r, 8: kv_quant.kv8_dequantize,
                  4: kv_quant.kv4_dequantize}[kv_bits_of(kk, cfg)]
    keys, vals = (dequantize(c[0][rows, at], cfg).bfloat16()
                  .reshape(B, len(t), H, Dh).transpose(1, 2).contiguous()
                  for c in (kk, vk))
    mask = (t[None, :] < n[:, None])[:, None, None, :]
    out["attention pair"] = _device_ms(lambda: F.scaled_dot_product_attention(
        q, keys, vals, attn_mask=mask))
    return out


def _device_ms(fn, iters=50):
    """Device milliseconds of one call of fn: CUDA events around ``iters``
    calls queued behind a spin of the card (torch.cuda._sleep, about 25
    ms), so all of them are queued before the first runs and a loop of
    small calls times the card, not the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _print_kernel_rows(variant, cfg, packed, emb, kk, vk, cur, lo, pos,
                       seen, steps=5):
    """The step's kernels, one row each: launches a step, device ms a
    launch (from a profile of ``steps`` steps) and a step, the bound a step
    (_kernel_bounds) and the library call's device ms a step
    (_library_kernels, once a layer).  Prints the rows and one JSON line of
    them."""
    from chattts_tpu_torch.ops.decode_step import (decode_step, kv_bits_of,
                                                   weight_bits_of)

    L = cfg.num_hidden_layers
    events = _kernel_events(lambda: [decode_step(
        packed, emb, kk, vk, cur, lo, pos, cfg) for _ in range(steps)])
    rows, names = {}, {}
    for (name, us), row in zip(events,
                               _kernel_rows_of([n for n, _ in events])):
        row = row or "torch ops of the wrapper"
        names.setdefault(row, name)
        n, total = rows.get(row, (0, 0.0))
        rows[row] = (n + 1, total + us)
    pair = [rows[r] for r in ATTN_ROWS]
    rows["attention pair"] = (pair[0][0], sum(t for _, t in pair))
    names["attention pair"] = "attend_scores + attend_values"
    bounds = _kernel_bounds(cfg, seen, kv_bits_of(kk, cfg),
                            weight_bits_of(packed, cfg))
    library = _library_kernels(cfg, packed, emb, kk, vk, cur, lo, pos)
    print(f"{variant} kernels, {steps} steps profiled: launches a step, ms a "
          f"launch, ms a step, bound ms a step, library ms a step (one call "
          f"a layer, device time)")
    table = []
    for row, (n, us) in rows.items():
        # a profile can miss a launch at its start: a step's launches are
        # the nearest whole number
        per_step = max(1, round(n / steps))
        entry = {"row": row, "kernel": names[row],
                 "launches_a_step": per_step, "ms_a_launch": us / n / 1e3}
        entry["ms_a_step"] = entry["ms_a_launch"] * per_step
        if row in bounds:
            entry["bound_ms_a_step"] = bounds[row][0] * per_step
            entry["bound_by"] = bounds[row][1]
        entry["library_ms_a_step"] = (library[row] * L if row in library
                                      else None)
        table.append(entry)
        lib = entry["library_ms_a_step"]
        print(f"  {row:24s} {names[row][:40]:40s} {per_step:5d} "
              f"{entry['ms_a_launch']:9.5f} {entry['ms_a_step']:8.4f}"
              + (f"  bound {entry['bound_ms_a_step']:.5f} "
                 f"({entry['bound_by']})" if row in bounds else "")
              + ("" if lib is None else
                 f"  library {lib:.4f} "
                 f"({'SDPA' if row == 'attention pair' else 'matmul'})"))
    print("kernel rows " + json.dumps({"variant": variant, "rows": table}))


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


def _library_weights(packed, cfg):
    """The packed matrices as bf16 for the library yardstick: quantized
    tiers are dequantized ahead of the timed call (integer times scale,
    rounded to bf16), so the yardstick reads bf16 weights whatever the
    tier."""
    import torch
    from chattts_tpu_torch.ops.decode_step import (MATRICES, unpack_matrix,
                                                   weight_bits_of)

    if not weight_bits_of(packed, cfg):
        return packed
    out = dict(packed)
    for name in MATRICES:
        scale = packed["s" + name[1:]]                     # (L, N, G)
        K = {"wqkv": cfg.hidden_size, "wgu": cfg.hidden_size,
             "wo": cfg.num_attention_heads * cfg.head_dim,
             "wd": cfg.intermediate_size}[name]
        out[name] = torch.stack([
            (unpack_matrix(w, K) * s.repeat_interleave(K // s.shape[1], dim=1)
             ).bfloat16() for w, s in zip(packed[name], scale)])
    return out


def _library_step(packed, emb, kc, vc, cur, lo, positions, cfg):
    """The same step in torch.matmul + SDPA (timed only, as a yardstick) on
    bf16 weights (``_library_weights``); a quantized cache is dequantized
    to bf16 for the attention call."""
    import torch
    import torch.nn.functional as F
    from chattts_tpu_torch.ops import kv_quant
    from chattts_tpu_torch.ops.decode_step import kv_bits_of, rope_rows

    H, Dh, I = cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size
    HD, eps = H * Dh, cfg.rms_norm_eps
    B, T = emb.shape[0], kc.shape[2]
    quantize, dequantize = {
        0: (None, None),
        8: (kv_quant.kv8_quantize, kv_quant.kv8_dequantize),
        4: (kv_quant.kv4_quantize, kv_quant.kv4_dequantize)}[
            kv_bits_of(kc, cfg)]
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
        if quantize:
            kc[li, rows, cur_rows] = quantize(k, cfg)
            vc[li, rows, cur_rows] = quantize(v, cfg)
            keys = dequantize(kc[li, :, :Tv], cfg).bfloat16()
            vals = dequantize(vc[li, :, :Tv], cfg).bfloat16()
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


def _step_bound_ms(cfg, seen, kv_bits, weight_bits=0):
    """Least time for one decode step whose row b attends ``seen[b]`` keys:
    the bytes it must move (weights and their scales once, the visible KV
    rows, the appended rows) against its operations.  Weights take 2, 1 or
    1/2 bytes a value by tier, with an f32 scale per (D-row group, column)
    on int8 and per (128-row group, column) on int4; a cache row takes
    2 HD, HD + 128 or HD/2 + 128 bytes.  The products are bf16 by f32-exact
    integers on every tier, so the operations go against the bf16 peak.
    Row b reads seen[b] - 1 cache rows as attention reads them and appends
    one whole row (_kv_row_bytes), none where its window is empty."""
    from chattts_tpu_torch.ops.decode_step import int4_group

    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    HD = cfg.num_attention_heads * cfg.head_dim
    B = len(seen)
    row_bytes, read_bytes = _kv_row_bytes(cfg, kv_bits)
    rows = sum(seen)
    live = sum(1 for n in seen if n > 0)
    values = L * (4 * D * D + 3 * D * I)
    scale_bytes = {0: 0, 8: L * (3 * HD + D + 2 * I + D * (I // D)) * 4,
                   4: values // int4_group(D) * 4 if weight_bits == 4 else 0
                   }[weight_bits]
    weight_bytes = (values * {0: 4, 8: 2, 4: 1}[weight_bits] // 2
                    + scale_bytes + 2 * L * D * 4)
    kv_bytes = 2 * L * ((rows - live) * read_bytes + live * row_bytes)
    io_bytes = 2 * B * D * 4 + 2 * B * cfg.head_dim * 4 + 3 * B * 4
    nbytes = weight_bytes + kv_bytes + io_bytes
    flops = 2 * B * L * (4 * D * D + 3 * D * I) + 4 * L * rows * HD
    return _bound_ms(nbytes, flops)


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


def _compare_quantized_rows(g, r, cfg, where, held, atol):
    """Appended kv8 or kv4 rows (L, B, W), kernel g against plain r, as
    bytes.  Layer 0 quantizes inputs equal to a rounding: scale bytes equal
    but for a head whose absmax sits on a step of the 7-bit mantissa (at
    most one head in 1000, and one), every dequantized value within one
    quantization step, at most KV8_DIFF_LAYER0 of its stored values (in
    heads of equal scale) different.  A deeper layer
    quantizes a projection of the residual, which may have drifted as the
    hidden may: its head scales within two mantissa steps (2/64), its values
    within a step plus the row's hidden limit ``atol`` (B,), its differing
    values counted against KV8_DIFF_ALL; the deeper layers are held for the
    rows of ``held`` (B,) only.  Pad lanes are zero everywhere.  Returns (differing values in
    layer 0, in the held rows of all layers, held values)."""
    import torch
    from chattts_tpu_torch.ops.decode_step import cache_values
    from chattts_tpu_torch.ops.kv_quant import KV_PAD, row_scales

    H = cfg.num_attention_heads
    QW = g.shape[-1] - KV_PAD      # value bytes: HD (kv8) or HD/2 (kv4)
    lanes = g[0, :, QW:QW + 2 * H] != r[0, :, QW:QW + 2 * H]
    tied0 = lanes[:, :H] | lanes[:, H:]                # (B, H) heads
    check(int(tied0.sum()) <= max(1, tied0.numel() // 1000),
          f"{int(tied0.sum())} of {tied0.numel()} appended head scales of "
          f"layer 0 differ ({where})")
    check(not bool(g[..., QW + 2 * H:].any()),
          f"pad lanes of the appended row are not zero ({where})")
    sg, sr = row_scales(g, cfg), row_scales(r, cfg)
    check(bool(((sg - sr).abs() <= sr / 32 * (1 + 1e-6))[:, held].all()),
          f"an appended head scale is off by more than 2/64 ({where})")
    step = torch.maximum(sg, sr)[..., None] * (1 + 1e-6)
    vg, vr = cache_values(g, cfg), cache_values(r, cfg)
    heads = vg.shape[:-1] + (H, -1)
    err = (vg.reshape(heads) * sg[..., None]
           - vr.reshape(heads) * sr[..., None]).abs()
    check(bool((err[0] <= step[0]).all()),
          f"an appended quantized value of layer 0 is off by more than a "
          f"step ({where}): {float((err[0] / step[0]).max()):.3f} steps")
    if bool(held.any()):
        check(bool((err <= step + atol[:, None, None])[:, held].all()),
              f"an appended quantized value is off by more than a step and "
              f"the hidden's tolerance ({where}): "
              f"{float((err - step)[:, held].max()):.4f}")
    differ0 = (vg[0] != vr[0]).reshape(heads[1:])[~tied0]
    differ = (vg != vr)[:, held]
    n0, n = int(differ0.sum()), int(differ.sum())
    check(n0 <= KV8_DIFF_LAYER0 * differ0.numel(),
          f"{n0} appended values of layer 0 differ ({where})")
    check(n <= KV8_DIFF_ALL * differ.numel(),
          f"{n} of {differ.numel()} appended values differ ({where})")
    return n0, n, differ.numel()


def _compare_step(xk, kk, vk, xp, kp, vp, base_k, base_v, cur, lo, norm, cfg,
                  where, few_atol=HIDDEN_ATOL):
    """The kernel's step (xk and caches kk/vk) against the plain version's
    on the same inputs (base_k/base_v before the step): final-norm hidden
    within HIDDEN_ATOL, row cur_b of row b within the row tolerance (kv8,
    kv4: see _compare_quantized_rows), every other byte unchanged.  On the
    int4 cache the hidden and the deeper layers' rows are held for rows
    that see at least KEYS_HELD keys; the others' hidden must be finite.
    On the int8 cache the hidden and deeper rows of rows that see fewer than
    KEYS_HELD keys are held within ``few_atol`` (at least HIDDEN_ATOL).
    Returns the held rows' (max-abs, mean-abs) hidden error and the
    quantized rows' counts (or None)."""
    import torch
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import kv_bits_of

    torch.cuda.synchronize()
    B = xk.shape[0]
    rows = torch.arange(B, device=xk.device)
    cur_rows = _cur_rows(cur, B, xk.device)
    held = torch.ones(B, dtype=torch.bool, device=xk.device)
    few = (cur_rows - lo.to(xk.device) + 1) < KEYS_HELD
    limit = torch.full((B,), HIDDEN_ATOL, device=xk.device)
    if kv_bits_of(kk, cfg) == 4:
        held = ~few
    elif kv_bits_of(kk, cfg) == 8:
        limit[few] = max(HIDDEN_ATOL, few_atol)
    hk = llama.rms_norm(xk, norm, cfg.rms_norm_eps)
    hp = llama.rms_norm(xp, norm, cfg.rms_norm_eps)
    # no row held (the first steps of short prompts): 0, and the caller's
    # layer-by-layer check is the one that holds
    row_err = (hk - hp).abs().amax(dim=1)
    err = float(row_err[held].max()) if bool(held.any()) else 0.0
    check(bool(torch.isfinite(hk).all()), f"hidden is not finite ({where})")
    over = held & (row_err > limit)
    check(not bool(over.any()),
          f"hidden err {err} ({where}): rows "
          f"{over.nonzero().flatten().tolist()} at {row_err[over].tolist()} "
          f"over their limits {limit[over].tolist()}")
    keep = torch.ones(kk.shape[:3], dtype=torch.bool, device=xk.device)
    keep[:, rows, cur_rows] = False
    counts = [0, 0, 0]
    for got, ref, base in ((kk, kp, base_k), (vk, vp, base_v)):
        check(torch.equal(got[keep], base[keep]),
              f"the kernel wrote outside the appended rows ({where})")
        g, r = got[:, rows, cur_rows], ref[:, rows, cur_rows]
        if got.dtype == torch.int8:
            for i, c in enumerate(_compare_quantized_rows(g, r, cfg, where,
                                                          held, limit)):
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
    mean_err = float((hk - hp)[held].abs().mean()) if bool(held.any()) else 0.0
    return err, mean_err, kv8


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


def _random_caches(shape, kv_bits, cfg, gen, dev):
    """Two seeded standard-normal caches drawn on the card (the seed comes
    from ``gen``), bf16 or quantized to kv8 or kv4 rows."""
    import torch
    from chattts_tpu_torch.ops.kv_quant import kv_quantizer

    quantize = kv_quantizer(kv_bits, cfg)

    dgen = torch.Generator(device=dev)
    dgen.manual_seed(int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    out = []
    for _ in range(2):
        c = torch.randn(shape, generator=dgen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        out.append(quantize(c, cfg) if quantize else c)
    return out


def _layerwise_case(variant, cfg, packed, emb, base_k, base_v, cur, lo, pos,
                    where):
    """Every layer of a case on equal inputs: layer l of the kernel (a
    one-layer step on layer l's weights and cache) against layer l of the
    plain version, both given the plain chain's residual before that layer.
    With equal inputs an appended value or scale byte differs only on a
    rounding tie (a value on a half, a head's absmax on a step of the scale's
    7-bit mantissa), so every row is held, whatever it sees: the residual
    after the layer within LAYER_ATOL, or within HIDDEN_ATOL for a row whose
    appended row did land on a tie.  Ties are counted: at most 1 value in
    10^4 (in rows whose scale bytes agree) and 1 scale byte in 10^3.
    Returns the sentence for the case's line."""
    import dataclasses

    import torch
    from chattts_tpu_torch.ops.decode_step import (cache_values, decode_step,
                                                   decode_step_plain)
    from chattts_tpu_torch.ops.kv_quant import KV_PAD

    one = dataclasses.replace(cfg, num_hidden_layers=1)
    B = emb.shape[0]
    rows = torch.arange(B, device=emb.device)
    cur_rows = _cur_rows(cur, B, emb.device)
    x = emb.float()
    worst, ties, values, scale_ties, scales = 0.0, 0, 0, 0, 0
    for li in range(cfg.num_hidden_layers):
        sub = {name: t[li:li + 1] for name, t in packed.items()}
        caches = [c[li:li + 1].clone() for c in (base_k, base_v, base_k,
                                                 base_v)]
        xk = decode_step(sub, x, caches[0], caches[1], cur, lo, pos, one)
        xp = decode_step_plain(sub, x, caches[2], caches[3], cur, lo, pos, one)
        tied = torch.zeros(B, dtype=torch.bool, device=emb.device)
        for got, ref in ((caches[0], caches[2]), (caches[1], caches[3])):
            g, r = got[0, rows, cur_rows], ref[0, rows, cur_rows]
            QW = g.shape[-1] - KV_PAD
            off = g[:, QW:] != r[:, QW:]
            scale_ties += int(off.sum())
            scales += 2 * cfg.num_attention_heads * B
            differ = cache_values(g, one) != cache_values(r, one)
            tied |= differ.any(dim=1) | off.any(dim=1)
            ties += int(differ[~off.any(dim=1)].sum())
            values += differ.numel()
        err = (xk - xp).abs().amax(dim=1)
        check(bool(torch.isfinite(xk).all()) and bool(
            (err <= torch.where(tied, HIDDEN_ATOL, LAYER_ATOL)).all()),
            f"layer {li} differs on equal inputs ({where}): per-row max-abs "
            f"{[round(float(e), 5) for e in err]}, rows with a tie "
            f"{tied.tolist()}")
        worst = max(worst, float(err[~tied].max()) if bool((~tied).any())
                    else 0.0)
        x = xp
    check(ties <= max(2, values // 10_000)
          and scale_ties <= max(2, scales // 1000),
          f"{ties} of {values} appended values and {scale_ties} of {scales} "
          f"scale bytes differ on equal inputs ({where})")
    return (f"layer by layer on equal inputs: residual max-abs {worst:.3e} "
            f"(limit {LAYER_ATOL}), {ties} of {values} appended values and "
            f"{scale_ties} of {scales} scale bytes on a tie")


def _kernel_case(variant, cfg, packs, norm, B, T, gen, dev, cur=None):
    """One full-width case of a variant against the plain version (``cur``:
    the shared position of a scalar-cur variant, mid-cache unless given;
    ``packs``: the packed weights by weight_bits); returns the hidden's
    max-abs error.  The library yardstick's distance from the plain version
    is printed beside it, and held to nothing."""
    import torch
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain)

    L, D = cfg.num_hidden_layers, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    weight_bits, kv_bits, per_row = _tier(variant)
    packed = packs[weight_bits]
    base_k, base_v = _random_caches((L, B, T, HD), kv_bits, cfg, gen, dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    cur, cur_rows, lo = _ragged(B, T, gen, per_row, cur=cur)
    cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
    cur_rows, lo = cur_rows.to(dev), lo.to(dev)
    pos = cur_rows - lo
    kk, vk, kp, vp = (base_k.clone(), base_v.clone(), base_k.clone(),
                      base_v.clone())
    xk = decode_step(packed, emb, kk, vk, cur, lo, pos, cfg)
    xp = decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
    where = f"{variant}, B {B}, T {T}"
    few = (cur_rows - lo + 1) < KEYS_HELD
    moved = 0.0
    if kv_bits:
        # how far the plain version's few-key rows move under a 1e-6
        # change of its input: sets their limit on kv8 (FEW_KEYS_CHAOS)
        xs = decode_step_plain(packed, emb * (1 + 1e-6), base_k.clone(),
                               base_v.clone(), cur, lo, pos, cfg)
        hp = llama.rms_norm(xp, norm, cfg.rms_norm_eps)
        d = (llama.rms_norm(xs, norm, cfg.rms_norm_eps) - hp).abs().amax(1)
        dk = (llama.rms_norm(xk, norm, cfg.rms_norm_eps) - hp).abs().amax(1)
        moved = float(d[few].max()) if bool(few.any()) else 0.0
        print(f"{variant} B {B}, T {T}: plain against itself with emb "
              f"scaled by 1 + 1e-6: rows that see fewer than {KEYS_HELD} "
              f"keys move by {moved:.3e} (the kernel: "
              f"{float(dk[few].max()) if bool(few.any()) else 0.0:.3e}, "
              + (f"limit {max(HIDDEN_ATOL, FEW_KEYS_CHAOS * moved):.3e}"
                 if kv_bits == 8 else "held layer by layer only")
              + f"), the others by {float(d[~few].max()):.3e}")
    err, mean_err, kv8 = _compare_step(xk, kk, vk, xp, kp, vp, base_k,
                                       base_v, cur, lo, norm, cfg, where,
                                       few_atol=FEW_KEYS_CHAOS * moved)
    note = ""
    if kv8 is not None:
        note = (f"; appended quantized values that differ: {kv8[0]} in layer "
                f"0, {kv8[1]} of {kv8[2]} in all (limits "
                f"{KV8_DIFF_LAYER0:.0%} and {KV8_DIFF_ALL:.0%})")
    xl = _library_step(_library_weights(packed, cfg), emb, base_k.clone(),
                       base_v.clone(), cur, lo, pos, cfg)
    lib = float((llama.rms_norm(xl, norm, cfg.rms_norm_eps)
                 - llama.rms_norm(xp, norm, cfg.rms_norm_eps)).abs().max())
    if kv_bits:
        note += (f"; {int(few.sum())} rows see fewer than {KEYS_HELD} "
                 "keys" + (" and are held layer by layer only"
                           if kv_bits == 4 else ""))
        note += "; " + _layerwise_case(variant, cfg, packed, emb, base_k,
                                       base_v, cur, lo, pos, where)
    print(f"{variant} vs plain: B {B}, T {T}, cur {int(cur_rows.min())}.."
          f"{int(cur_rows.max())}, visible keys "
          f"{int((cur_rows - lo + 1).min())}..{int((cur_rows - lo + 1).max())}"
          f": hidden max-abs {err:.3e}, mean-abs {mean_err:.3e}; library vs "
          f"plain max-abs {lib:.3e}{note}")
    return err


def _time_call(variant, cfg, packed, emb, kk, vk, cur, lo, pos, what,
               profile=False):
    """Kernel, plain and library milliseconds of one call of a variant on
    the given tensors (the caches are overwritten at row cur_b), the call's
    bound from its own positions, and the host time of the wrapper's call
    (printed)."""
    import torch
    from chattts_tpu_torch.ops.decode_step import (decode_step,
                                                   decode_step_plain,
                                                   kv_bits_of, weight_bits_of)

    B, T = emb.shape[0], kk.shape[2]
    ms = _time_ms(lambda: decode_step(packed, emb, kk, vk, cur, lo, pos, cfg))
    plain_ms = _time_ms(lambda: decode_step_plain(packed, emb, kk, vk, cur,
                                                  lo, pos, cfg), iters=5)
    lib = _library_weights(packed, cfg)
    lib_ms = _time_ms(lambda: _library_step(lib, emb, kk, vk, cur, lo, pos,
                                            cfg), iters=5)
    del lib
    cur_rows = _cur_rows(cur, B, emb.device)
    # a row whose window is empty (a slot that holds no request) reads no key
    seen = (cur_rows - lo.to(emb.device) + 1).clamp(min=0)
    bound_ms, bound_by = _step_bound_ms(cfg, seen.tolist(),
                                        kv_bits_of(kk, cfg),
                                        weight_bits_of(packed, cfg))
    # the host's share: the wrapper's call with the card idle, so no launch
    # waits for a free queue slot (median of 10)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(packed, emb, kk, vk, cur, lo, pos, cfg)
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    host_ms = sorted(enqueue)[5] * 1e3
    if profile:
        _print_kernel_rows(variant, cfg, packed, emb, kk, vk, cur, lo, pos,
                           seen.tolist())
    print(f"{variant} timing on {what}: B {B}, T {T}, visible keys "
          f"{int(seen.min())}..{int(seen.max())}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}); the wrapper's host time {host_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _time_variant(variant, cfg, packs, B, T, cur, cur_rows, lo, gen, dev):
    """``_time_call`` of a variant on seeded caches of one shape."""
    import torch

    L, D = cfg.num_hidden_layers, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    weight_bits, kv_bits, _ = _tier(variant)
    packed = packs[weight_bits]
    kk, vk = _random_caches((L, B, T, HD), kv_bits, cfg, gen, dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
    cur_rows, lo = cur_rows.to(dev), lo.to(dev)
    return _time_call(variant, cfg, packed, emb, kk, vk, cur, lo,
                      cur_rows - lo, "seeded caches", profile=True)


def phase_kernel(dev):
    """Every variant against its plain version at the full width, and its
    times.  Returns {row: entry of the kernels line}."""
    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import VARIANTS, pack_weights
    from chattts_tpu_torch.weights import to_device

    cfg = Config().gpt
    gen = torch.Generator().manual_seed(1)
    params = to_device(llama.init_params(gen, cfg), dev)
    packs = {bits: pack_weights(params, cfg, weight_bits=bits)
             for bits in (0, 8, 4)}
    norm = params["norm"]
    worst = dict.fromkeys(VARIANTS, 0.0)

    def case(variant, B, T, **kw):
        worst[variant] = max(worst[variant], _kernel_case(
            variant, cfg, packs, norm, B, T, gen, dev, **kw))

    for cur in (96, 256, 511):
        case("k1", 8, 512, cur=cur)
    # K2, K3, K2+K3: B 8 and 32 at T 512, B 16 at the capacity tier's cache
    # length; K1 once more at 32 rows
    for variant in ("k2", "k3", "k2k3"):
        for Bv, Tv in ((8, 512), (16, 2560), (32, 512)):
            case(variant, Bv, Tv)
    # the facade's fast engine tier: 8 slots on a 2304-row cache
    for variant in ("k2", "k2k3"):
        case(variant, 8, 2304)
    case("k1", 32, 512)
    # the quantized tiers: K4 and K5 on the bf16 and kv8 caches, K6 with
    # bf16 weights, K5 on K6, each with one position and per row, and the
    # 64-slot engine's K2+K6+K4; 8, 16, 32 and 64 rows (two row halves of
    # the gemv), the 16-row case on the capacity tier's 2560-row cache
    for variant in ("k1k4", "k2k4", "k3k4", "k2k3k4", "k1k5", "k2k5", "k3k5",
                    "k2k3k5", "k6", "k2k6", "k6k5", "k2k6k5", "k2k6k4"):
        for Bv, Tv in ((8, 512), (16, 2560), (32, 512), (64, 512)):
            case(variant, Bv, Tv)
    # the earlier variants on the second row half
    for variant in ("k1", "k2k3"):
        case(variant, 64, 512)

    # times: the scalar-cur variants at the Generator's shape of phase 4's
    # kind (B 8, T 512, cur 256), K2+K3 at the engine phase's (16 slots,
    # T 2560, 100..200 prompt tokens and 0..255 generated); K2 and K2+K6+K4
    # are timed in the engine phases, on calls their own runs made
    entries = {}
    tgen = torch.Generator().manual_seed(5)
    cur_e = 512 + torch.randint(0, 256, (16,), generator=tgen)
    lo_e = 512 - torch.randint(100, 201, (16,), generator=tgen)
    lo_g = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64])
    generator_shape = (8, 512, 256, torch.full((8,), 256), lo_g)
    rows = {v: (name, v) for v, name in VARIANT_NAMES.items()}
    rows.update(FEATURE_ROWS)
    rows.update({v: (name, None) for v, name in COMBINATION_ROWS.items()})
    for row, (name, timed) in rows.items():
        entries[row] = {
            "name": name, "route": "cuda",
            "source": "chattts_tpu_torch/csrc/decode_step.cu",
            "replaces": "chattts_tpu/ops/pallas_step.py:268",
            "max_abs_err": max(e for v, e in worst.items()
                               if (row in v if row in FEATURE_ROWS
                                   else row == v))}
        if timed == "k2k3":
            entries[row].update(_time_variant(
                timed, cfg, packs, 16, 2560, cur_e, cur_e, lo_e, gen, dev))
        elif timed not in (None, "k2"):
            entries[row].update(_time_variant(
                timed, cfg, packs, *generator_shape, gen, dev))
    return entries


def _attention_o(packed, emb, kc, vc, cur, lo, positions, cfg, fault=None):
    """Layer 0's attention output o (B, HD) as decode_step_plain computes
    it for any variant (its own helpers and ``attend_plain``), with one
    planted fault or none; kc/vc get row cur_b of row b."""
    import torch
    from chattts_tpu_torch.ops.decode_step import (_mm, _rms, _rope,
                                                   attend_plain, kv_bits_of,
                                                   rope_rows)
    from chattts_tpu_torch.ops.kv_quant import kv_quantizer, row_scales

    H = cfg.num_attention_heads
    HD, B, T = H * cfg.head_dim, emb.shape[0], kc.shape[2]
    quantize = kv_quantizer(kv_bits_of(kc, cfg), cfg)
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
    kc[0, rows, cur_rows] = quantize(k, cfg) if quantize else k.bfloat16()
    vc[0, rows, cur_rows] = quantize(v, cfg) if quantize else v.bfloat16()
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
    keys = kc[0]
    if fault == "key_nibbles_swapped":  # of every value byte of a kv4 row
        b = keys[..., :HD // 2].to(torch.int32)
        swapped = ((b & 15) << 4) | ((b >> 4) & 15)
        keys = torch.cat([((swapped << 24) >> 24).to(torch.int8),
                          keys[..., HD // 2:]], dim=-1)
    return attend_plain(q, keys, vc[0], visible[:, None, :], cfg, **hooks)


def _check_kv4_step_rows(packed, emb, base_k, base_v, kk, vk, cur, lo, pos,
                         cfg, variant):
    """The rows a one-layer kv4 step appended (kk, vk) against
    ``kv4_append_plain`` on the CPU, fed the q, k and v of the kernel's own
    qkv gemv (the one-gemv entry runs the step's instantiation on the same
    rows: bit for bit the step's): every byte of both caches equal."""
    import torch
    from chattts_tpu_torch.ops import decode_step as ds

    B, HD = emb.shape[0], cfg.num_attention_heads * cfg.head_dim
    qkv = torch.empty((B, 3 * HD), device=emb.device)
    ds.gemv(emb.float().contiguous(), packed["ln1"][0], packed["wqkv"][0],
            None, 0, qkv, ds.GEMV_RMS, False, cfg.rms_norm_eps)
    cos, sin = ds.rope_rows(cfg, pos)
    kp, vp = base_k[0].cpu(), base_v[0].cpu()
    ds.kv4_append_plain(qkv.cpu(), cos.cpu(), sin.cpu(), kp, vp,
                        _cur_rows(cur, B, emb.device).cpu(), lo.cpu(), cfg)
    torch.cuda.synchronize()
    differ = int((kk[0].cpu() != kp).sum() + (vk[0].cpu() != vp).sum())
    print(f"{variant} one layer: the step's appended kv4 rows against the "
          f"plain append of the kernel's own qkv: {differ} bytes differ")
    check(differ == 0, f"{variant}: the step's kv4 rows differ from the "
          f"plain append in {differ} bytes")


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
    from chattts_tpu_torch.ops.kv_quant import kv_quantizer
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
    for variant in ("k2", "k3", "k2k3", "k6", "k2k6"):
        cur, _, lo = _ragged(B, T, pgen, "k2" in variant, floor=8)
        if "k2" not in variant:
            lo[0] = cur - 1  # two visible keys: lo + 1 still leaves one
        else:
            lo[0] = cur[0] - 1
        cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
        cases.append((variant, cur, lo.to(dev)))
    worst = 0.0
    for variant, cur, lo in cases:
        kv_bits = _tier(variant)[1]
        quantize = kv_quantizer(kv_bits, cfg)
        base_k = quantize(bf_k, cfg) if quantize else bf_k
        base_v = quantize(bf_v, cfg) if quantize else bf_v
        pos = _cur_rows(cur, B, dev) - lo
        step, caches = {}, {}
        for name, fn in (("kernel", decode_step), ("plain", decode_step_plain)):
            kc, vc = base_k.clone(), base_v.clone()
            step[name] = fn(packed, emb, kc, vc, cur, lo, pos, cfg) - emb
            caches[name] = kc, vc
        want = step["plain"]
        if kv_bits == 4:
            _check_kv4_step_rows(packed, emb, base_k, base_v,
                                 *caches["kernel"], cur, lo, pos, cfg,
                                 variant)

        def copy_reading(fault=None):
            return reading((emb + _bf16(_attention_o(
                packed, emb, base_k.clone(), base_v.clone(), cur, lo, pos,
                cfg, fault))) - emb, want)

        kern, sane = reading(step["kernel"], want), copy_reading()
        names = (FAULTS + (FAULTS_QUANT if kv_bits else ())
                 + (FAULTS_KV4 if kv_bits == 4 else ())
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


def phase_weight_scales(dev):
    """The int8 and int4 weights on one full-width layer whose attention is
    off (wo zero), so the step adds exactly the MLP's output to the
    residual and the weight scales are seen undiluted: the kernel against
    the plain version, then the plain version against copies of itself with
    a planted fault in the scales, each of which the same check must
    reject.  A reading is max |got - want| / (MLP_RTOL (|want| + rms
    want)), passing at <= 1."""
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
    gen = torch.Generator().manual_seed(3)
    params = to_device(llama.init_params(gen, cfg), dev)
    kc = torch.randn((1, B, T, HD), generator=gen).bfloat16().to(dev)
    vc = torch.randn((1, B, T, HD), generator=gen).bfloat16().to(dev)
    emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
    lo = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64], device=dev)
    cur = T // 2
    pos = cur - lo

    def mlp(fn, packed):
        return fn(packed, emb, kc.clone(), vc.clone(), cur, lo, pos, cfg) - emb

    def reading(got, want):
        lim = MLP_RTOL * (want.abs() + want.pow(2).mean().sqrt())
        r = ((got - want).abs() / lim).max()
        return float(r) if bool(torch.isfinite(r)) else float("inf")

    def faulted(packed, fault):
        bad = dict(packed)
        if fault == "down_scale_of_next_group":     # int8: I/D groups of D
            bad["sd"] = packed["sd"].roll(-1, dims=2)
        elif fault == "down_scale_of_group_0":      # one scale a column
            bad["sd"] = packed["sd"][:, :, :1].expand_as(
                packed["sd"]).contiguous()
        elif fault == "one_group_scale_of_next_group":  # int4: groups of 128
            bad["sgu"] = packed["sgu"].clone()
            bad["sgu"][:, :, 2] = packed["sgu"][:, :, 3]
        else:
            raise ValueError(fault)
        return bad

    faults = {8: ("down_scale_of_next_group", "down_scale_of_group_0"),
              4: ("one_group_scale_of_next_group",)}
    worst = {}
    for bits, variant in ((8, "k1k4"), (4, "k1k5")):
        packed = pack_weights(params, cfg, weight_bits=bits)
        packed["wo"].zero_()
        check(packed["sd"].shape[2] == cfg.intermediate_size // (
            D if bits == 8 else 128), f"sd is {tuple(packed['sd'].shape)}")
        want = mlp(decode_step_plain, packed)
        kern = reading(mlp(decode_step, packed), want)
        planted = {f: reading(mlp(decode_step_plain, faulted(packed, f)), want)
                   for f in faults[bits]}
        # the kernel reads the scales it is given: the same fault in its
        # input moves its output as it moves the plain version's
        kern_faulted = reading(
            mlp(decode_step, faulted(packed, faults[bits][0])), want)
        print(f"{variant} one layer, MLP undiluted: kernel reading "
              f"{kern:.3e} (limit 1), planted "
              + ", ".join(f"{f} {r:.3e}" for f, r in planted.items())
              + f"; kernel given {faults[bits][0]}: {kern_faulted:.3e}")
        check(kern <= 1.0, f"{variant} MLP differs: {kern}")
        for f, r in planted.items():
            check(r > 1.0, f"the one-layer check misses fault {f} ({r})")
        check(kern_faulted > 1.0,
              f"the {variant} kernel ignores its scales ({kern_faulted})")
        worst[variant] = kern
    return worst


GEMV_ROWS_TIMED = (8, 16, 64)


def _gemv_cases(dev, weight_bits):
    """The full model's four gemvs on one weight tier, seeded, at 64 rows
    (a case takes its first B): {shape: (x, lnw, w, scale, out, group,
    mode, add, N, K)}.  The weights are a seeded normal matrix of the
    initializer's scale (0.02), quantized as ``pack_weights`` does."""
    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.ops import decode_step as ds

    cfg = Config().gpt
    D, I = cfg.hidden_size, cfg.intermediate_size
    HD = cfg.num_attention_heads * cfg.head_dim
    group = {0: 0, 8: D, 4: ds.int4_group(D)}[weight_bits]
    gen = torch.Generator(device=dev).manual_seed(10 + weight_bits)
    cases = {}
    for shape, N, K, mode, add in (
            ("qkv", 3 * HD, D, ds.GEMV_RMS, False),
            ("wo", D, HD, ds.GEMV_NONE, True),
            ("gate/up", 2 * I, D, ds.GEMV_RMS, False),
            ("down", D, I, ds.GEMV_SILU, True)):
        x = torch.randn((64, 2 * K if mode == ds.GEMV_SILU else K),
                        generator=gen, device=dev)
        lnw = 1 + 0.1 * torch.randn((K,), generator=gen, device=dev)
        w = 0.02 * torch.randn((K, N), generator=gen, device=dev)
        out = torch.randn((64, N), generator=gen, device=dev)
        if weight_bits:
            q, scale = ds._quantize_matrix(w, group, weight_bits)
            w = ds.pack_nibbles(q) if weight_bits == 4 else q
        else:
            w, scale = w.T.contiguous().bfloat16(), None
        cases[shape] = (x, lnw, w, scale, out, group, mode, add, N, K)
    return cases


def _gemv_reading(step, case, B):
    """The kernel's gemv (``step.gemv``) on the first B rows of a case
    against ``gemv_plain``: max |kernel - plain| / ``gemv_tolerance``,
    passing at 1 or less (infinity where the kernel's result is not
    finite), and the largest |kernel - plain|."""
    import torch
    from chattts_tpu_torch.ops import decode_step as ds

    x, lnw, w, scale, out, group, mode, add, _, _ = case
    x, out = x[:B].contiguous(), out[:B].contiguous()
    got = out.clone()
    step.gemv(x, lnw, w, scale, group, got, mode, add)
    torch.cuda.synchronize()
    want = ds.gemv_plain(x, lnw, w, scale, group, out, mode, add)
    bound = ds.gemv_tolerance(x, lnw, w, scale, group, out, mode, add)
    err = (got.double() - want.double()).abs()
    reading = float((err / bound).max())
    if not bool(torch.isfinite(got).all()):
        reading = float("inf")
    return reading, float(err.max())


def _cold_copies(*tensors, nbytes=64 << 20):
    """An endless cycle of copies of ``tensors`` (None stays None), enough
    of them to exceed the card's 50 MB L2 cache, so that each launch timed
    over them reads its weights from device memory, as the step's launches
    do (20 layers of weights stream through L2)."""
    import itertools

    per = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    copies = [tuple(None if t is None else t.clone() for t in tensors)
              for _ in range(max(2, -(-nbytes // per)))]
    return itertools.cycle(copies)


def phase_gemv(dev):
    """The gemv alone (``decode_step.gemv``, the step's kernel through its
    one-gemv entry) on the full model's four shapes at 8, 16 and 64 rows on
    each weight tier: its error against ``gemv_plain`` beside the stated
    bound (``gemv_tolerance``; fails the run above it), its device us a
    launch, the plain version's, one ``torch.matmul`` of bf16 inputs and
    weights (a yardstick; the port never calls it) and the bytes bound.
    The kernel and matmul are timed on cold weights (_cold_copies) and warm
    inputs, as the step finds them: its inputs were just written by the
    previous kernel.  Returns {(tier, B): us of the four gemvs a layer}."""
    import torch
    from chattts_tpu_torch.ops import decode_step as ds

    step = ds.decode_step
    totals = {}
    worst = 0.0
    for bits in (0, 8, 4):
        cases = _gemv_cases(dev, bits)
        for shape, case in cases.items():
            x, lnw, w, scale, out, group, mode, add, N, K = case
            wlib = (w if not bits else
                    (ds.unpack_matrix(w, K) * scale.repeat_interleave(
                        group, dim=1)).bfloat16())
            for B in GEMV_ROWS_TIMED:
                reading, err = _gemv_reading(step, case, B)
                # the timed launches add into a copy: out[:B] is a view
                xb, ob = x[:B].contiguous(), out[:B].clone()
                cold = _cold_copies(w, scale)

                def kernel():
                    wc, sc = next(cold)
                    step.gemv(xb, lnw, wc, sc, group, ob, mode, add)

                us = 1e3 * _device_ms(kernel)
                plain_us = 1e3 * _device_ms(lambda: ds.gemv_plain(
                    xb, lnw, w, scale, group, ob, mode, add), iters=10)
                xm = torch.randn((B, K), device=dev).bfloat16()
                cold = _cold_copies(wlib)
                lib_us = 1e3 * _device_ms(lambda: xm @ next(cold)[0].T)
                del cold
                bound_ms, by = _bound_ms(*_gemv_work(
                    B, N, K, bits, group, x.shape[1], add,
                    mode == ds.GEMV_RMS))
                totals[(bits, B)] = totals.get((bits, B), 0.0) + us
                print(f"gemv {shape} {N}x{K} w{bits or 16} B {B}: kernel "
                      f"{us:.2f} us, matmul {lib_us:.2f} us, plain "
                      f"{plain_us:.2f} us, bound {1e3 * bound_ms:.3f} us "
                      f"({by}); max-abs err {err:.3e}, reading "
                      f"{reading:.3e} of its bound (limit 1)")
                check(reading <= 1.0, f"gemv {shape} w{bits or 16} B {B} "
                      f"exceeds its error bound: {reading}")
                worst = max(worst, reading)
        del cases
    L = 20
    for (bits, B), us in totals.items():
        print(f"gemv w{bits or 16} B {B}: the four gemvs {us:.2f} us a "
              f"layer, {us * L / 1e3:.4f} ms a step of {L} layers")
    print(f"gemv: worst reading {worst:.3e} of the bound, "
          f"{step.gemv_launches} launches of the one-gemv entry")
    return totals


KV4_ROWS_TIMED = (8, 16, 64)


def _kv4_append_inputs(cfg, B, T, dev, seed):
    """One full-width kv4 append on the card, seeded: qkv (B, 3 HD) f32,
    the rope rows, two caches of random bytes (B, T, HD/2 + 128) int8 and
    int32 positions across the cache; with 8 or more rows, row 1 sits past
    the cache and row 2 sees no key (neither is written)."""
    import torch
    from chattts_tpu_torch.ops.decode_step import rope_rows
    from chattts_tpu_torch.ops.kv_quant import row_width

    HD = cfg.num_attention_heads * cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, 3 * HD), generator=gen, device=dev)
    caches = [torch.randint(-128, 128, (B, T, row_width(4, cfg)),
                            generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2)]
    cur = torch.randint(0, T, (B,), generator=gen, device=dev)
    lo = torch.randint(0, T, (B,), generator=gen, device=dev) % (cur + 1)
    if B >= 8:
        cur[1], lo[1], cur[2], lo[2] = T, 0, 5, 6
    cos, sin = rope_rows(cfg, (cur - lo).clamp(min=0))
    return (qkv, cos.contiguous(), sin.contiguous(), *caches,
            cur.to(torch.int32), lo.to(torch.int32))


def _kv4_append_bytes(case, cfg, where):
    """The kernel's append (``decode_step.kv4_append``) on copies of
    ``case`` against ``kv4_append_plain`` on the CPU copy of the same
    inputs, where torch divides as IEEE does: every byte of both caches
    equal.  Returns the rows written."""
    import torch
    from chattts_tpu_torch.ops import decode_step as ds

    qkv, cos, sin, kc, vc, cur, lo = case
    kk, vk = kc.clone(), vc.clone()
    ds.kv4_append(qkv, cos, sin, kk, vk, cur, lo, cfg)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in case]
    ds.kv4_append_plain(*cpu, cfg)
    for got, want, name in ((kk, cpu[3], "k"), (vk, cpu[4], "v")):
        got = got.cpu()
        differ = int((got != want).sum())
        check(differ == 0, f"kv4 append ({where}): {differ} bytes of the "
              f"{name} cache differ from the plain version")
    return int(ds._append_rows(cpu[5], cpu[6], kc.shape[1]).sum())


def phase_kv4_append(dev):
    """The kv4 append alone (``decode_step.kv4_append``, one warp per row,
    head pair and k or v) at the full model's heads on 8, 16 and 64 rows of
    a 2560-row cache: its bytes against the plain version's
    (_kv4_append_bytes), its device us a launch (CUDA events over launches
    queued behind a spin, and the profiler's time of the kernel itself),
    the plain version's on the card and the bytes bound (every row's cur
    and lo read; k, v, cos and sin read and the two cache rows written for
    the rows that are written).  Prints one JSON line."""
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.ops import decode_step as ds
    from chattts_tpu_torch.ops.kv_quant import row_width

    cfg = Config().gpt
    HD = cfg.num_attention_heads * cfg.head_dim
    rows = []
    for B in KV4_ROWS_TIMED:
        case = _kv4_append_inputs(cfg, B, 2560, dev, 40 + B)
        live = _kv4_append_bytes(case, cfg, f"B {B}")
        us = 1e3 * _device_ms(lambda: ds.kv4_append(*case, cfg), iters=100)
        # a profile can miss a launch at its start: profile again, up to
        # three times, until it holds all 20
        for _ in range(3):
            events = _kernel_events(lambda: [ds.kv4_append(*case, cfg)
                                             for _ in range(20)])
            kern = [t for n, t in events
                    if n.startswith("kv4_append_kernel")]
            if len(kern) == 20:
                break
        check(len(kern) == 20, f"profiled {len(kern)} of 20 kv4 appends")
        prof_us = sum(kern) / len(kern)
        plain_us = 1e3 * _device_ms(lambda: ds.kv4_append_plain(*case, cfg),
                                    iters=10)
        # a row that is not written needs only its cur and lo
        nbytes = (live * (2 * HD * 4 + 2 * cfg.head_dim * 4
                          + 2 * row_width(4, cfg)) + 2 * B * 4)
        bound_ms, by = _bound_ms(nbytes, 0)
        rows.append({"B": B, "rows_written": live, "us": us,
                     "profiled_us": prof_us, "plain_us": plain_us,
                     "bound_us": 1e3 * bound_ms, "bound_by": by})
        print(f"kv4 append alone B {B} (T 2560, {live} rows written): "
              f"kernel {us:.3f} us a launch back to back, {prof_us:.3f} us "
              f"profiled, plain {plain_us:.2f} us, bound {1e3 * bound_ms:.4f} "
              f"us ({by}); bytes equal to the plain version's")
    print("kv4 append rows " + json.dumps(rows))
    print(f"kv4 append: {ds.decode_step.kv4_append_launches} launches of "
          f"the one-append entry")


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
                                                   kv_bits_of, variant_of)

    worst = 0.0
    for (emb, kc0, vc0, cur, lo, pos), xk, kk, vk in kept:
        kp, vp = kc0.clone(), vc0.clone()
        xp = decode_step_plain(packed, emb, kp, vp, cur, lo, pos, cfg)
        cur_rows = _cur_rows(cur, emb.shape[0], emb.device)
        where = (f"{what}, {variant_of(kc0, cur, packed, cfg)}, "
                 f"B {emb.shape[0]}, "
                 f"T {kc0.shape[2]}, cur {int(cur_rows.min())}.."
                 f"{int(cur_rows.max())}, lo {int(lo.min())}..{int(lo.max())}")
        err, mean_err, kv8 = _compare_step(xk, kk, vk, xp, kp, vp, kc0, vc0,
                                           cur, lo, norm, cfg, where)
        note = "" if kv8 is None else (
            f"; appended quantized values that differ: {kv8[0]} in layer 0, "
            f"{kv8[1]} of {kv8[2]}")
        if kv_bits_of(kc0, cfg):
            seen = cur_rows - lo + 1
            note += (f"; {int((seen < KEYS_HELD).sum())} rows see fewer "
                     f"than {KEYS_HELD} keys; " + _layerwise_case(
                         variant_of(kc0, cur, packed, cfg), cfg, packed, emb,
                         kc0, vc0, cur, lo, pos, where))
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


SAMPLES_PER_STEP = 512  # one code step: 2 mel frames of hop 256
TEXTS = ["Hello from the port.", "The quick brown fox.",
         "Speech on a graphics card.", "One more short sentence."]


def _check_wavs(wavs):
    import numpy as np

    check(len(wavs) == 4, f"expected 4 waveforms, got {len(wavs)}")
    for w in wavs:
        check(w.ndim == 1 and w.size > 0, "empty waveform")
        check(bool(np.isfinite(w).all()), "waveform is not finite")


def phase_infer(chat, variant, max_new, profile):
    """``Chat.infer`` on the Generator of ``chat``, whose tiers make every
    step the given variant: 4 texts as a main path (_main_path_run:
    launches counted around it, kept calls checked).  Returns the launches
    by variant and the kept calls' largest hidden error."""
    from chattts_tpu_torch import Chat

    title = f"infer weight_bits={chat.weight_bits} kv_bits={chat.kv_bits}"
    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=11, show_tqdm=False)
    code = Chat.InferCodeParams(max_new_token=max_new, min_new_token=64,
                                manual_seed=12, show_tqdm=False)
    # warm-up: cuBLAS/cuDNN handles and the kernel library load
    chat.infer(TEXTS[:1], split_text=False, params_refine_text=refine,
               params_infer_code=Chat.InferCodeParams(
                   max_new_token=8, manual_seed=1, show_tqdm=False))

    decoded = []
    device_decode = chat._device_decode

    def capture(hid, end):
        decoded.append((hid, end))
        return device_decode(hid, end)

    def run():
        return chat.infer(TEXTS, split_text=False,
                          params_refine_text=refine, params_infer_code=code)

    chat._device_decode = capture
    try:
        # refine and code pass: the first step of each kept, and a later
        # one of the code pass
        wavs, wall, counts, errs, steps = _main_path_run(chat, run, title, 3)
    finally:
        del chat._device_decode
    n_steps = sum(steps)
    _check_wavs(wavs)
    check(set(counts) == {variant},
          f"{title}: launches {counts}, expected only {variant}")
    audio_s = sum(w.size for w in wavs) / chat.config.vocos.mel.sample_rate
    print(f"{title}: 4 texts, steps per pass {steps}, wall "
          f"{wall:.3f} s, {n_steps / wall:.1f} steps/s, audio {audio_s:.2f} s, "
          f"audio s / wall s {audio_s / wall:.3f}, {variant} launches "
          f"{counts[variant]}")
    if profile:
        check_decode_on_cpu(chat, *decoded[-1])
        # the same request again under the profiler
        device_s, prof_wall, rows = _device_profile(run)
        _print_profile(f"{title} profile", device_s, rows)
        print(f"{title}: card busy {device_s:.3f} s of the "
              f"profiled run's {prof_wall:.3f} s wall "
              f"({100 * device_s / prof_wall:.1f}%; unprofiled wall "
              f"{wall:.3f} s)")
    return counts, errs[variant]


def _encode_share(chat, wav, cpu_codes):
    """Codes of ``chat.sample_audio_speaker``-style encodes of ``wav`` on
    the card, with TF32 as PyTorch leaves it (cuDNN convolutions in TF32,
    matmuls in float32) and with TF32 off, each as the share equal to the
    CPU's codes ``cpu_codes``; the flags are restored."""
    import numpy as np
    import torch
    from chattts_tpu_torch.models import dvae as dvae_mod

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    shares = {}
    try:
        for name, cudnn_tf32 in (("tf32 as the facade leaves it", True),
                                 ("tf32 off", False)):
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            codes = dvae_mod.encode_audio(
                chat.dvae_params, torch.from_numpy(wav[None]).cuda(),
                chat.config.dvae, chat.config.vocos.mel)[0].cpu().numpy()
            shares[name] = float(np.mean(codes == cpu_codes))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return shares


def _main_path_run(c, run, title, at_least, later=48):
    """``run()`` on the facade ``c`` as a main path: the launch counts set
    to 0 just before and read just after, ``decode_step`` (the Generator's
    and the engine's) replaced by a Keeper that keeps the first call of
    each pass (a Generator's ``generate``, an Engine's ``generate``, or a
    streamed engine pass of ``_infer_code_engine``) and the call ``later``
    steps on, and the decode steps the passes report counted (a streamed
    Generator pass: its last output's).
    Every call must have launched one kernel, the launches cover the
    steps, at least ``at_least`` calls are kept, and the kept calls are
    held to the plain version variant by variant.  Returns (the result,
    wall seconds, launches by variant, {variant: the kept calls' largest
    hidden error}, the decode steps of each pass)."""
    import torch
    from chattts_tpu_torch.engine import batching
    from chattts_tpu_torch.engine import generate as gen_mod
    from chattts_tpu_torch.ops.decode_step import decode_step, variant_of

    state = {"n": 0}
    steps = []

    def want(n, cur, kc):
        keep = state["n"] in (0, later)
        state["n"] += 1
        return keep

    gen_generate, eng_generate = c.generator.generate, batching.Engine.generate
    eng_stream = c._infer_code_engine

    def gen_counted(req, context=None):
        # a pass's steps are its latest output's (a streamed pass yields
        # partials; the facade reads a one-shot pass's first output only)
        state["n"] = 0
        steps.append(0)
        i = len(steps) - 1
        for out in gen_generate(req, context):
            steps[i] = out.steps
            yield out

    def eng_counted(eng, requests, context=None):
        state["n"] = 0
        before = eng.stats["steps_launched"]
        outs = eng_generate(eng, requests, context)
        steps.append(eng.stats["steps_launched"] - before)
        return outs

    def eng_stream_counted(text, params, stream=False, engine=None, **kw):
        if not stream:  # Engine.generate counts it
            yield from eng_stream(text, params, stream=stream, engine=engine,
                                  **kw)
            return
        state["n"] = 0
        before = engine.stats["steps_launched"]
        steps.append(0)
        i = len(steps) - 1
        for out in eng_stream(text, params, stream=stream, engine=engine,
                              **kw):
            steps[i] = engine.stats["steps_launched"] - before
            yield out

    keeper = Keeper(want)
    c.generator.generate, batching.Engine.generate = gen_counted, eng_counted
    c._infer_code_engine = eng_stream_counted
    gen_mod.k1.decode_step = keeper  # the engine's step_mod is this module
    decode_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        gen_mod.k1.decode_step = decode_step
        batching.Engine.generate = eng_generate
        del c.generator.generate, c._infer_code_engine
    wall = time.perf_counter() - t0
    counts = {v: n for v, n in decode_step.variant_launches.items() if n}
    launched = sum(counts.values())
    check(launched == keeper.n and launched >= sum(steps) > 0,
          f"{title}: {launched} launches ({counts}) for {keeper.n} calls and "
          f"{sum(steps)} decode steps")
    check(len(keeper.kept) >= at_least,
          f"{title}: kept {len(keeper.kept)} calls, expected {at_least}")
    cfg = c.config.gpt
    errs = {}
    for v in counts:
        kept = [k for k in keeper.kept
                if variant_of(k[0][1], k[0][3], c.packed, cfg) == v]
        errs[v] = check_kept_calls(c.packed, c.gpt_params["norm"], cfg, kept,
                                   f"{title} {v}", 1)
    return out, wall, counts, errs, steps


def phase_multi_segment(chat, engine_chat, kernels, launches):
    """``Chat.infer`` with its default arguments on the 4 texts joined as
    sentences: ``split_text`` cuts 4 segments and, with no ``spk_smp``
    given, the auto-clone branch synthesizes segment 0, encodes its wav to
    codes with the DVAE encoder and prompts all 4 segments with them; on
    the Generator (``chat``) and on the engine route (``engine_chat``).
    Checks one finite float32 wav each and the clone prompt's codes; each
    run is a main path (_main_path_run: launches counted around it, the
    first and a later step of the refine pass, segment 0's pass and the
    4 segments' pass kept and held to the plain version, the errors folded
    into ``kernels``).  On the Generator run it times the clone branch
    (segment 0's synthesis and the encode), and measures the share of the
    clone codes the card's encoder gives equal to the CPU's encode of the
    same wav, with TF32 as the facade leaves it and off.  Then
    ``use_decoder=False`` on the 4 texts, the same way: codes through the
    GFSQ embed and the DVAE's decoder, 4 finite waveforms."""
    import numpy as np
    import torch
    from chattts_tpu_torch import Chat
    from chattts_tpu_torch.models import dvae as dvae_mod
    from chattts_tpu_torch.models.speaker import Speaker
    from chattts_tpu_torch.weights import to_device

    def refine_params():
        return Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                     manual_seed=11, show_tqdm=False)

    def code_params():
        return Chat.InferCodeParams(max_new_token=128, min_new_token=64,
                                    manual_seed=12, show_tqdm=False)

    def fold(counts, errs):
        for v in counts:
            _fold(kernels, launches, {v: counts[v]}, v, errs[v])

    text = " ".join(TEXTS)
    for route, c in (("generator", chat), ("engine", engine_chat)):
        refine, code = refine_params(), code_params()
        clone = {}
        generate_wavs, speaker = c._generate_wavs, c.sample_audio_speaker

        def timed_generate(batch, use_decoder, params):
            t0 = time.perf_counter()
            wavs = generate_wavs(batch, use_decoder, params)
            torch.cuda.synchronize()
            clone.setdefault("batches", []).append(
                (len(batch), time.perf_counter() - t0))
            if "wav" not in clone:
                clone["wav"] = wavs[0]
            return wavs

        def timed_speaker(wav):
            t0 = time.perf_counter()
            smp = speaker(wav)
            clone["encode_s"] = time.perf_counter() - t0
            return smp

        c._generate_wavs, c.sample_audio_speaker = (timed_generate,
                                                    timed_speaker)
        try:
            # refine (1 kept), segment 0 and the 4 segments (2 kept each)
            wavs, wall, counts, errs, _ = _main_path_run(
                c, lambda: c.infer(text, params_refine_text=refine,
                                   params_infer_code=code),
                f"infer 4 segments ({route})", 5)
        finally:
            del c._generate_wavs, c.sample_audio_speaker
        fold(counts, errs)
        check(len(wavs) == 1 and wavs[0].ndim == 1 and wavs[0].size > 0
              and wavs[0].dtype == np.float32
              and bool(np.isfinite(wavs[0]).all()),
              f"multi-segment infer ({route}) gave {len(wavs)} waveforms")
        check([n for n, _ in clone["batches"]] == [1, 4],
              f"batches of the multi-segment run: {clone['batches']}")
        codes = Speaker.decode_prompt(code.spk_smp)
        check(codes.shape[0] == 4 and codes.shape[1] > 0,
              f"clone prompt codes {codes.shape}")
        seg0_s = clone["batches"][0][1]
        audio_s = wavs[0].size / chat.config.vocos.mel.sample_rate
        print(f"infer 4 segments ({route}, default arguments): wall "
              f"{wall:.3f} s, audio {audio_s:.2f} s, the clone branch "
              f"{seg0_s + clone['encode_s']:.3f} s (segment 0's synthesis "
              f"{seg0_s:.3f} s, its encode {clone['encode_s']:.3f} s, "
              f"{codes.shape[1]} prompt codes), launches {counts}, kept "
              f"calls' hidden max-abs {errs}")
        if route == "generator":
            wav = np.asarray(clone["wav"], np.float32)
            cpu = torch.device("cpu")
            cpu_codes = dvae_mod.encode_audio(
                to_device(chat.dvae_params, cpu),
                torch.from_numpy(wav[None]), chat.config.dvae,
                chat.config.vocos.mel)[0].numpy()
            shares = _encode_share(chat, wav, cpu_codes)
            print(f"clone codes on the card equal to the CPU encode of the "
                  f"same wav ({cpu_codes.shape[0]} x {cpu_codes.shape[1]}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
            check(shares["tf32 off"] >= 0.99,
                  f"the card's encode with TF32 off matches the CPU's on "
                  f"only {shares['tf32 off']:.4f} of the codes")

    # refine (1 kept) and the code pass (2 kept)
    wavs, wall, counts, errs, _ = _main_path_run(
        chat, lambda: chat.infer(TEXTS, split_text=False, use_decoder=False,
                                 params_refine_text=refine_params(),
                                 params_infer_code=code_params()),
        "infer use_decoder=False", 3)
    fold(counts, errs)
    _check_wavs(wavs)
    audio_s = sum(w.size for w in wavs) / chat.config.vocos.mel.sample_rate
    print(f"infer use_decoder=False: 4 texts, wall {wall:.3f} s, audio "
          f"{audio_s:.2f} s, launches {counts}, kept calls' hidden max-abs "
          f"{errs}")


# folded Embed heads: the tree holds each head as a weight-norm pair (v the
# head scaled by a random factor a row, g its row norm, both rounded to
# f32) and the loader folds g * v / ||v|| in f64 and rounds to f32: three
# f32 roundings of a product, each within 2^-24 of the value, so within
# 1e-6 of each element (about 5e-7 allowed for, twice that held)
HEAD_RTOL = 1e-6
# the loaded Chat and its twin give equal codes, so equal hiddens, and
# decode them with equal weights on one card: only the convolution and FFT
# algorithms cuDNN and cuFFT pick for each call could differ
LOAD_WAV_RTOL_OF_PEAK = 1e-5
UNLOAD_SHARE = 0.9  # of the memory the load added, given back by unload


def _tree_state(tree, key_map):
    """A parameter tree -> its reference state dict (numpy f32), through
    the key map and the inverse of each transform."""
    from chattts_tpu_torch.utils import io as io_utils

    state = {}
    for path, (key, how) in key_map.items():
        a = io_utils.get_path(tree, path).float().cpu().numpy()
        state[key] = (a.T if how == "T" else a.transpose(2, 1, 0)
                      if how in ("C", "D") else a.reshape(1, -1, 1)
                      if how == "SQUEEZE" else a)
    return state


def _write_tokenizer(path, vocab_size):
    """A BERT WordPiece tokenizer.json of ``vocab_size`` ids, with its
    tokenizer_config.json and special_tokens_map.json: the special tokens,
    lowercase letters, digits and punctuation, their '##' pieces, padding
    entries, and the ChatTTS control tokens last as added tokens (so every
    one sits at or above [break_0])."""
    import os
    import string

    from chattts_tpu_torch.models.tokenizer import CONTROL_TOKENS

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = list(string.ascii_lowercase + string.digits + string.punctuation)
    vocab = specials + chars + ["##" + c for c in chars]
    base = vocab_size - len(CONTROL_TOKENS)
    vocab += [f"[unused{i}]" for i in range(base - len(vocab))]
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    added += [{"id": base + i, "content": t, "single_word": False,
               "lstrip": False, "rstrip": False, "normalized": False,
               "special": True} for i, t in enumerate(CONTROL_TOKENS)]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": None,
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100,
                  "vocab": {t: i for i, t in enumerate(vocab)}},
    }
    conf = {"do_lower_case": True, "strip_accents": None,
            "tokenize_chinese_chars": True,
            "clean_up_tokenization_spaces": True,
            "tokenizer_class": "BertTokenizer", "unk_token": "[UNK]",
            "additional_special_tokens": list(CONTROL_TOKENS)}
    smap = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
            "cls_token": "[CLS]", "mask_token": "[MASK]",
            "additional_special_tokens": list(CONTROL_TOKENS)}
    os.makedirs(path, exist_ok=True)
    for name, obj in (("tokenizer.json", spec),
                      ("tokenizer_config.json", conf),
                      ("special_tokens_map.json", smap)):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)


def _write_tree(chat, base):
    """``chat``'s leaves as a ChatTTS asset tree under ``base/asset``,
    written by the port's own safetensors writer: the DVAE, Decoder, Vocos
    and Embed files in f32 (the Embed heads as weight-norm pairs), the GPT
    with HF LlamaModel names (its bf16 matrices widened to f32, exactly),
    gpt/config.json and a tokenizer of the config's text vocabulary."""
    import os

    import numpy as np
    from chattts_tpu_torch.models import dvae as dvae_mod
    from chattts_tpu_torch.models import vocos as vocos_mod
    from chattts_tpu_torch.utils.io import save_safetensors

    cfg = chat.config
    a = os.path.join(base, "asset")
    os.makedirs(os.path.join(a, "gpt"))
    save_safetensors(os.path.join(a, "DVAE.safetensors"), _tree_state(
        chat.dvae_params, dvae_mod.dvae_torch_key_map(cfg.dvae)))
    save_safetensors(os.path.join(a, "Decoder.safetensors"), _tree_state(
        chat.decoder_params, dvae_mod.decoder_torch_key_map(cfg.decoder)))
    save_safetensors(os.path.join(a, "Vocos.safetensors"), _tree_state(
        chat.vocos_params, vocos_mod.torch_key_map(cfg.vocos)))
    rng = np.random.default_rng(0)
    emb = {k: v.float().cpu().numpy() for k, v in chat.embed_params.items()}
    state = {"emb_text.weight": emb["emb_text"]}

    def wn_pair(prefix, w):  # w (V, D), a torch Linear's layout
        norm = np.sqrt(np.sum(w.astype(np.float64) ** 2, 1, keepdims=True))
        scale = rng.uniform(0.5, 2.0, (w.shape[0], 1)).astype(np.float32)
        state[f"{prefix}.parametrizations.weight.original0"] = norm.astype(
            np.float32)
        state[f"{prefix}.parametrizations.weight.original1"] = w * scale

    wn_pair("head_text", emb["head_text"].T)
    for q in range(cfg.gpt.num_vq):
        state[f"emb_code.{q}.weight"] = emb["emb_code"][q]
        wn_pair(f"head_code.{q}", emb["head_code"][q].T)
    save_safetensors(os.path.join(a, "Embed.safetensors"), state)
    g = cfg.gpt
    HD = g.num_attention_heads * g.head_dim
    state = {"model.norm.weight": chat.gpt_params["norm"].float().cpu().numpy()}
    for i, lp in enumerate(chat.gpt_params["layers"]):
        p = f"model.layers.{i}."
        qkv = lp["attn"]["wqkv"].float().cpu().numpy()  # (D, 3, H, Dh)
        gu = lp["mlp"]["wgu"].float().cpu().numpy()     # (D, 2, I)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            state[f"{p}self_attn.{name}.weight"] = qkv[:, j].reshape(-1, HD).T
        state[f"{p}self_attn.o_proj.weight"] = (
            lp["attn"]["wo"].float().cpu().numpy().T)
        state[f"{p}mlp.gate_proj.weight"] = gu[:, 0].T
        state[f"{p}mlp.up_proj.weight"] = gu[:, 1].T
        state[f"{p}mlp.down_proj.weight"] = (
            lp["mlp"]["down"].float().cpu().numpy().T)
        state[f"{p}input_layernorm.weight"] = lp["ln1"].float().cpu().numpy()
        state[f"{p}post_attention_layernorm.weight"] = (
            lp["ln2"].float().cpu().numpy())
    save_safetensors(os.path.join(a, "gpt", "model.safetensors"), state)
    with open(os.path.join(a, "gpt", "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaModel"], "model_type": "llama",
                   "hidden_size": g.hidden_size,
                   "intermediate_size": g.intermediate_size,
                   "num_attention_heads": g.num_attention_heads,
                   "num_key_value_heads": g.num_attention_heads,
                   "num_hidden_layers": g.num_hidden_layers,
                   "max_position_embeddings": g.max_position_embeddings,
                   "rms_norm_eps": g.rms_norm_eps,
                   "rope_theta": g.rope_theta}, f)
    _write_tokenizer(os.path.join(a, "tokenizer"), g.num_text_tokens)


def _check_loaded_leaves(chat, src):
    """Every loaded leaf equals its source leaf in dtype, shape and value,
    but the folded Embed heads, held to HEAD_RTOL of each element."""
    import torch

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            items = enumerate(tree)
        else:
            return {prefix.rstrip("/"): tree}
        out = {}
        for k, v in items:
            out.update(flat(v, f"{prefix}{k}/"))
        return out

    n, head_err = 0, 0.0
    for name in ("gpt_params", "embed_params", "decoder_params",
                 "vocos_params", "dvae_params"):
        got, want = flat(getattr(chat, name)), flat(getattr(src, name))
        check(set(got) == set(want), f"{name}: the loaded tree's leaves "
              f"differ: {sorted(set(got) ^ set(want))[:4]}")
        for k, w in want.items():
            g = got[k]
            where = f"{name}/{k}"
            check(g.dtype == w.dtype and g.shape == w.shape
                  and g.device == w.device,
                  f"{where}: {g.dtype} {tuple(g.shape)} on {g.device} vs "
                  f"{w.dtype} {tuple(w.shape)} on {w.device}")
            if name == "embed_params" and k.startswith("head_"):
                rel = float(((g - w).abs() / w.abs().clamp_min(1e-30))
                            .max())
                head_err = max(head_err, rel)
                check(bool(((g - w).abs() <= HEAD_RTOL * w.abs()).all()),
                      f"{where}: folded head off by {rel:.3e} of a value")
            else:
                check(torch.equal(g, w), f"{where}: loaded values differ")
            n += 1
    return n, head_err


def _recording_codes(c):
    """Wrap ``c._infer_code`` so that the code pass's ids are kept; returns
    the list they land in."""
    import numpy as np

    codes, inner = [], c._infer_code

    def recording(*a, **k):
        for out in inner(*a, **k):
            codes[:] = [np.array(i) for i in out.ids]
            yield out

    c._infer_code = recording
    return codes


def phase_load(chat, kernels, launches):
    """Loading an asset tree at full width.  ``chat``'s seeded random
    leaves are written as a tree in the reference layout (``_write_tree``)
    to a temporary directory; the trusted checksum map refuses it through
    ``Chat.load(source="custom")`` (False, nothing loaded), its own map
    passes it and refuses a copy with one byte flipped.  ``_load_assets``
    reads it onto the card: the GB read, the seconds to hash and to load,
    and the rate are printed, and every leaf must equal its source
    (``_check_loaded_leaves``).  ``Chat.infer`` on the 4 texts with the
    refine pass through the tree's tokenizer runs as a main path (launches
    into K3, kept calls held to the plain version); its codes must equal a
    ``load_params`` twin's, given the source leaves and the same tokenizer,
    and its waveforms the twin's within LOAD_WAV_RTOL_OF_PEAK.  ``unload``
    must give back UNLOAD_SHARE of the memory the load added.  Last, the
    command-line program runs in a subprocess with ``--source local`` from
    a directory with no tree (random weights, a warning) and its wav is
    read back: 24 kHz, not empty."""
    import gc
    import os
    import shutil
    import tempfile
    import wave

    import numpy as np
    import torch
    from chattts_tpu_torch import Chat
    from chattts_tpu_torch.utils import dl as dl_utils

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "tree")
        t0 = time.perf_counter()
        _write_tree(chat, base)
        files = [os.path.join(base, r) for r in dl_utils.ASSET_FILES]
        gb = sum(os.path.getsize(f) for f in files) / 1e9
        print(f"load: wrote a {gb:.3f} GB tree in "
              f"{time.perf_counter() - t0:.2f} s")

        refused = Chat(config=chat.config)
        check(refused.load(source="custom", custom_path=base) is False
              and not refused.has_loaded(),
              "the trusted checksum map did not refuse a synthetic tree")
        del refused
        t0 = time.perf_counter()
        own = dl_utils.generate_sha256_map(base)
        t_hash = time.perf_counter() - t0
        check(dl_utils.check_all_assets(base, sha256_map=own),
              "the tree fails its own checksum map")
        flipped = os.path.join(tmp, "flipped")
        shutil.copytree(base, flipped, copy_function=os.link)
        victim = os.path.join(flipped, "asset", "Vocos.safetensors")
        os.unlink(victim)
        shutil.copyfile(os.path.join(base, "asset", "Vocos.safetensors"),
                        victim)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 1]))
        check(not dl_utils.check_all_assets(flipped, sha256_map=own),
              "a flipped byte passed the checksum check")

        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        loaded = Chat(config=chat.config)
        t0 = time.perf_counter()
        loaded._load_assets(base)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        mem1 = torch.cuda.memory_allocated()
        print(f"load: {gb:.3f} GB read, hash {t_hash:.2f} s, load to the "
              f"card {t_load:.2f} s, {gb / t_load:.3f} GB/s; "
              f"{(mem1 - mem0) / 1e9:.3f} GB allocated on the card")
        n, head_err = _check_loaded_leaves(loaded, chat)
        print(f"load: {n} leaves equal to their source; folded heads within "
              f"{head_err:.3e} of a value (limit {HEAD_RTOL})")
        check(type(loaded.tokenizer._backend).__name__ == "_HFBackend"
              and loaded.tokenizer.len == chat.config.gpt.num_text_tokens,
              "the tree's tokenizer was not loaded")

    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=11, show_tqdm=False)

    def code():
        return Chat.InferCodeParams(max_new_token=128, min_new_token=64,
                                    manual_seed=12, show_tqdm=False)

    def run(c):
        return c.infer(TEXTS, split_text=False, params_refine_text=refine,
                       params_infer_code=code())

    title = "infer on the loaded tree"
    run(loaded)  # warm-up: the tree's tokenizer and prompt shapes
    codes = _recording_codes(loaded)
    try:
        wavs, wall, counts, errs, steps = _main_path_run(
            loaded, lambda: run(loaded), title, 3)
    finally:
        del loaded._infer_code
    _check_wavs(wavs)
    check(set(counts) == {"k3"}, f"{title}: launches {counts}, expected k3")
    _fold(kernels, launches, counts, "k3", errs["k3"])
    twin = Chat(config=chat.config)
    twin.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                     decoder=chat.decoder_params, vocos=chat.vocos_params,
                     dvae=chat.dvae_params, tokenizer=loaded.tokenizer)
    twin_codes = _recording_codes(twin)
    twin_wavs = run(twin)
    diff = _first_code_difference(codes, twin_codes)
    check(diff is None, f"{title}: codes differ from the twin's: {diff}")
    err = 0.0
    for w, t in zip(wavs, twin_wavs):
        check(w.shape == t.shape, f"{title}: wav {w.shape} vs the twin's "
              f"{t.shape}")
        err = max(err, float(np.abs(w - t).max()) / float(np.abs(t).max()))
    check(err <= LOAD_WAV_RTOL_OF_PEAK,
          f"{title}: wavs differ from the twin's by {err:.3e} of the peak")
    print(f"{title}: steps per pass {steps}, wall {wall:.3f} s, k3 launches "
          f"{counts['k3']}, codes equal to the twin's ({len(codes)} rows, "
          f"{sum(len(c) for c in codes)} steps), wavs within {err:.3e} of "
          f"the peak (limit {LOAD_WAV_RTOL_OF_PEAK})")
    del twin, twin_wavs, wavs
    gc.collect()
    torch.cuda.synchronize()
    mem2 = torch.cuda.memory_allocated()
    loaded.unload()
    check(not loaded.has_loaded() and not hasattr(loaded, "gpt_params")
          and not hasattr(loaded, "packed"), "unload left the weights")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem3 = torch.cuda.memory_allocated()
    # from just after the load: what infer left allocated elsewhere counts
    # against the unload
    added, back = mem1 - mem0, mem1 - mem3
    print(f"unload: the load added {added / 1e9:.3f} GB, unload gave back "
          f"{back / 1e9:.3f} GB ({100 * back / max(added, 1):.1f}%; "
          f"{mem2 / 1e9:.3f} GB allocated before the unload, "
          f"{mem3 / 1e9:.3f} after, {mem0 / 1e9:.3f} before the load)")
    check(back >= UNLOAD_SHARE * added,
          f"unload gave back {back} of the {added} bytes the load added")
    del loaded

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env.pop("CHATTTS_ASSETS", None)
        repo = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "chattts_tpu_torch.examples.cli",
             "Hello from the command line.", "--source", "local",
             "--max-new", "48", "--manual-seed", "3", "-o", "cli"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        t_cli = time.perf_counter() - t0
        check(out.returncode == 0, f"cli exited {out.returncode}: "
              f"{out.stderr[-2000:]}")
        check("falling back to random init" in out.stderr,
              "cli: no fallback warning without a tree")
        with wave.open(os.path.join(tmp, "cli.wav"), "rb") as w:
            rate, frames = w.getframerate(), w.getnframes()
        check(rate == 24000 and frames > 0,
              f"cli wav: {rate} Hz, {frames} frames")
        print(f"cli: --source local without a tree, {frames} samples at "
              f"{rate} Hz in {t_cli:.1f} s (process start, random weights, "
              f"refine and code passes)")


STREAM_TOL = 2e-4       # window vs one-shot decode past the first window
FIRST_WINDOW_SNR_DB = 60.0  # the first window, emitted under first_guard


def _gaps(times):
    """(p50, max) of the gaps between successive chunk arrivals, s."""
    import numpy as np

    if len(times) < 2:
        return 0.0, 0.0
    d = np.diff(np.asarray(times))
    return float(np.median(d)), float(d.max())


def _streamed(c, run):
    """``run()`` returns a stream; consume it and return (chunks, arrival
    seconds of each chunk after the call, the code pass's ids, the
    decoders the facade made with their ``emitted`` after each update)."""
    import numpy as np
    import torch

    codes, made = [], []
    infer_code, mk_sd = c._infer_code, c._device_stream_decoder

    def recording_infer_code(*a, **k):
        for out in infer_code(*a, **k):
            codes[:] = [np.array(i) for i in out.ids]
            yield out

    def recording_sd(*a, **k):
        sd = mk_sd(*a, **k)
        sd.trace, upd = [], sd.update_dev

        def update_dev(*a2, **k2):
            out = upd(*a2, **k2)
            sd.trace.append(sd.emitted)
            return out

        sd.update_dev = update_dev
        made.append(sd)
        return sd

    c._infer_code, c._device_stream_decoder = (recording_infer_code,
                                               recording_sd)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, times = [], []
        for ch in run():
            times.append(time.perf_counter() - t0)
            chunks.append(ch)
    finally:
        del c._infer_code, c._device_stream_decoder
    return chunks, times, codes, made


def _exact_decode(c, hid, end):
    """The one-shot decode of exactly the kept positions (no bucket pad,
    no waveform tail zeroed): what the windows must reassemble to."""
    import torch
    from chattts_tpu_torch.models import dvae as dvae_mod
    from chattts_tpu_torch.models import vocos as vocos_mod

    t = torch.arange(hid.shape[1], device=hid.device)
    mel = dvae_mod.decode_from_hidden(
        c.decoder_params, hid * (t[None, :] < end[:, None])[..., None],
        c.config.decoder)
    return vocos_mod.decode(c.vocos_params, mel, c.config.vocos).cpu().numpy()


def _check_chunks(chunks, B, stream_speed, where):
    import numpy as np

    check(len(chunks) >= 2, f"{where}: {len(chunks)} chunks")
    for i, ch in enumerate(chunks):
        check(isinstance(ch, np.ndarray) and ch.dtype == np.float32
              and ch.ndim == 2 and ch.shape[0] == B
              and bool(np.isfinite(ch).all()),
              f"{where}: chunk {i} is {getattr(ch, 'shape', ch)} "
              f"{getattr(ch, 'dtype', '')}")
        if i < len(chunks) - 1:
            check(0 < ch.shape[1] <= stream_speed,
                  f"{where}: chunk {i} has {ch.shape[1]} samples")


def _first_code_difference(got, want):
    """'row b, step t: streamed ... one-shot ...' for the first step where
    two runs' codes differ, or None."""
    import numpy as np

    for b, (g, w) in enumerate(zip(got, want)):
        n = min(len(g), len(w))
        bad = np.nonzero((g[:n] != w[:n]).any(-1))[0]
        if bad.size:
            t = int(bad[0])
            return f"row {b}, step {t}: streamed {g[t]} one-shot {w[t]}"
        if len(g) != len(w):
            return f"row {b}: {len(g)} steps streamed, {len(w)} one-shot"
    if len(got) != len(want):
        return f"{len(got)} rows streamed, {len(want)} one-shot"
    return None


def phase_stream(chat, engine_chat, kernels, launches):
    """``Chat.infer(stream=True)`` on the 4 texts at 256 new tokens with the
    default cadence (``stream_batch`` 24, ``stream_speed`` 12000,
    ``pass_first_n_batches`` 2), refine pass skipped, on the Generator (K3)
    and on the engine route (K2+K3): a first call (the window shapes
    cold) and a warm one run as a main path (_main_path_run: the first and
    the 49th step of the pass kept and held to the plain version).  Checks
    every chunk (float32, finite, (4, n), at most ``stream_speed`` samples
    before the flush); the streamed codes equal a non-streamed ``infer``'s
    with the same seed on the same route (else the first differing step is
    reported); the stream's length and samples equal the one-shot decode of
    the same hiddens (no bucket pad) within the reference's windowing
    tolerance (2e-4 past the first emitted window, 60 dB over it); on the
    Generator, ``stream_window_ahead`` off gives the same samples; then
    ``use_decoder=False`` streams on the Generator.  Prints the time to the
    first chunk (cold, warm), the gaps between chunks, audio seconds per
    wall second, and the card's busy share in one profiled call."""
    import numpy as np
    from chattts_tpu_torch import Chat

    sr = chat.config.vocos.mel.sample_rate

    def code_params():
        return Chat.InferCodeParams(max_new_token=256, min_new_token=64,
                                    manual_seed=21, show_tqdm=False)

    def stream(c, **kw):
        return lambda: c.infer(TEXTS, stream=True, split_text=False,
                               skip_refine_text=True,
                               params_infer_code=code_params(), **kw)

    for route, c in (("generator", chat), ("engine", engine_chat)):
        title = f"stream ({route})"
        p = code_params()
        cold, cold_t, _, _ = _streamed(c, stream(c))
        _check_chunks(cold, 4, p.stream_speed, f"{title}, first call")
        (chunks, times, codes, made), wall, counts, errs, steps = \
            _main_path_run(c, lambda: _streamed(c, stream(c)), title, 2)
        for v in counts:
            _fold(kernels, launches, {v: counts[v]}, v, errs[v])
        _check_chunks(chunks, 4, p.stream_speed, title)
        check(sum(ch.shape[1] for ch in chunks)
              == sum(ch.shape[1] for ch in cold),
              f"{title}: the first and the warm call differ in length")
        # the same request, not streamed: its codes and its hiddens
        got = {}
        decode = c._decode_to_wavs

        def capture(result, use_decoder):
            got["codes"] = [np.array(i) for i in result.ids]
            got["hid"], got["end"] = result.hiddens_dev, result.end_dev
            return decode(result, use_decoder)

        c._decode_to_wavs = capture
        try:
            c.infer(TEXTS, split_text=False, skip_refine_text=True,
                    params_infer_code=code_params())
        finally:
            del c._decode_to_wavs
        diff = _first_code_difference(codes, got["codes"])
        check(diff is None, f"{title}: streamed codes differ from the "
              f"non-streamed run's at {diff}")
        n_max = max(len(x) for x in codes)
        exact = _exact_decode(c, got["hid"][:, :n_max], got["end"])
        full = (2 * n_max - 1) * (SAMPLES_PER_STEP // 2)
        check(exact.shape[1] == full, f"{title}: one-shot decode "
              f"{exact.shape}, expected {full} samples")
        stream_wav = np.concatenate(chunks, axis=1)
        # the last chunk is the flush: what was left, its columns silent
        # in every row stripped (core.py:501-503)
        m = stream_wav.shape[1] - chunks[-1].shape[1]
        rest = exact[:, m:]
        ref = np.concatenate(
            [exact[:, :m], rest[:, (np.abs(rest) > 1e-5).any(0)]], axis=1)
        check(ref.shape == stream_wav.shape,
              f"{title}: {stream_wav.shape[1]} samples streamed, the "
              f"one-shot decode has {full}, {ref.shape[1]} after the "
              f"flush's strip")
        first = made[0].trace
        e1 = next(e for e in first if e) * SAMPLES_PER_STEP
        err = np.abs(stream_wav - ref)
        snr = 10 * np.log10(float((ref[:, :e1] ** 2).sum())
                            / max(float(((stream_wav[:, :e1]
                                          - ref[:, :e1]) ** 2).sum()), 1e-30))
        late = float(err[:, e1:].max())
        print(f"{title}: {len(chunks)} chunks, {stream_wav.shape[1]} samples "
              f"a row (one-shot {full}), peak {float(np.abs(ref).max()):.3e}; "
              f"first window {e1} samples at {snr:.1f} dB, after it max-abs "
              f"{late:.3e}; codes equal to the non-streamed run's "
              f"({n_max} steps)")
        check(late <= STREAM_TOL, f"{title}: the stream differs from the "
              f"one-shot decode by {late} past the first window")
        check(snr >= FIRST_WINDOW_SNR_DB,
              f"{title}: the first window at {snr:.1f} dB")
        gap50, gapmax = _gaps(times)
        audio_s = stream_wav.shape[1] * 4 / sr
        print(f"{title}: first chunk {cold_t[0]:.3f} s on the first call, "
              f"{times[0]:.3f} s warm; gaps between chunks p50 "
              f"{gap50:.3f} s, max {gapmax:.3f} s; wall {wall:.3f} s, "
              f"steps {steps}, audio {audio_s:.2f} s (4 rows), audio s / "
              f"wall s {audio_s / wall:.3f}; launches {counts}, kept "
              f"calls' hidden max-abs {errs}")
        if route == "generator":
            device_s, prof_wall, rows = _device_profile(
                lambda: list(stream(c)()))
            _print_profile(f"{title} profile", device_s, rows)
            print(f"{title}: card busy {device_s:.3f} s of the profiled "
                  f"call's {prof_wall:.3f} s wall "
                  f"({100 * device_s / prof_wall:.1f}%)")
            twin = Chat(config=c.config.with_runtime(
                stream_window_ahead=False))
            twin.load_params(gpt=c.gpt_params, embed=c.embed_params,
                             decoder=c.decoder_params, vocos=c.vocos_params,
                             dvae=c.dvae_params, device=c.device)
            off, _, off_codes, _ = _streamed(twin, stream(twin))
            off_wav = np.concatenate(off, axis=1)
            check(_first_code_difference(off_codes, codes) is None
                  and off_wav.shape == stream_wav.shape
                  and np.array_equal(off_wav, stream_wav),
                  f"{title}: stream_window_ahead off gives other samples "
                  f"({off_wav.shape} against {stream_wav.shape})")
            print(f"{title}: stream_window_ahead off: {len(off)} chunks "
                  f"(on: {len(chunks)}), the same {off_wav.shape[1]} "
                  f"samples a row bit for bit")
            del twin
    (chunks, times, codes, _), wall, counts, errs, _ = _main_path_run(
        chat, lambda: _streamed(chat, stream(chat, use_decoder=False)),
        "stream use_decoder=False", 2)
    for v in counts:
        _fold(kernels, launches, {v: counts[v]}, v, errs[v])
    _check_chunks(chunks, 4, code_params().stream_speed,
                  "stream use_decoder=False")
    n = sum(ch.shape[1] for ch in chunks)
    n_max = max(len(x) for x in codes)
    check(n <= (2 * n_max - 1) * (SAMPLES_PER_STEP // 2),
          f"stream use_decoder=False: {n} samples for {n_max} steps")
    print(f"stream use_decoder=False: {len(chunks)} chunks, {n} samples a "
          f"row, first chunk {times[0]:.3f} s, wall {wall:.3f} s, launches "
          f"{counts}, kept calls' hidden max-abs {errs}")


SERVING_THREADS = 8     # streams, and as many blocking requests


def _quantiles(xs):
    import numpy as np

    v = np.sort(np.asarray(xs))
    return float(v[len(v) // 2]), float(v[min(len(v) - 1,
                                              int(0.95 * len(v)))])


def phase_serving(chat, kernels, launches):
    """``TTSService`` over ``chat`` (engine route, capacity tier: 16 slots
    on the int8 cache), built with its CUDA default (engine warm-up and one
    warm-up stream).  Load: 8 threads each run ``synthesize_stream`` while
    8 threads each run ``synthesize`` (refine pass included), every wait
    bounded.  Checks every output non-empty and finite, the peak occupancy
    at least 2 slots, that launches cover the engine's steps and kept calls
    (the first step of the load and the one 48 steps on) against the plain
    version.  Then an aborted stream frees its slot and a later request is
    admitted and served, and the port's HTTP server on 127.0.0.1 answers
    ``/health``, ``/generate_voice`` and a streamed ``/v1/audio/speech``.
    Prints the time to the first chunk (p50, p95), requests per second and
    the peak slots."""
    import threading
    import urllib.request

    import numpy as np
    import torch
    from chattts_tpu_torch import Chat
    from chattts_tpu_torch.engine import generate as gen_mod
    from chattts_tpu_torch.examples import api_server
    from chattts_tpu_torch.ops.decode_step import decode_step
    from chattts_tpu_torch.serving import TTSService
    from chattts_tpu_torch.utils.audio import read_wav_stream

    t0 = time.perf_counter()
    svc = TTSService(chat, timeout=120.0)
    eng = chat._engine_for_code()
    check(eng.ecfg.max_num_seqs == 16 and svc.max_concurrent_slots == 0,
          f"the service's code engine has {eng.ecfg.max_num_seqs} slots")
    print(f"serving: service built and warmed in "
          f"{time.perf_counter() - t0:.2f} s")

    def code(seed, max_new=192):
        return Chat.InferCodeParams(max_new_token=max_new, min_new_token=64,
                                    manual_seed=seed, show_tqdm=False)

    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=5, show_tqdm=False)
    results, errors = {}, []

    def streamer(i):
        try:
            t = time.perf_counter()
            chunks, first = [], None
            for ch in svc.synthesize_stream(TEXTS[i % 4], code(100 + i)):
                first = first or time.perf_counter() - t
                chunks.append(ch)
            results[("stream", i)] = (first, np.concatenate(chunks, axis=1))
        except Exception as e:  # noqa: BLE001 - reported by the check
            errors.append(f"stream {i}: {e!r}")

    def blocking(i):
        try:
            results[("synth", i)] = (None, svc.synthesize(
                TEXTS[i % 4], refine, code(200 + i)))
        except Exception as e:  # noqa: BLE001 - reported by the check
            errors.append(f"synthesize {i}: {e!r}")

    # the engine thread's code-engine steps: (start, end, steps launched)
    # of each call
    calls = []
    step = eng.step

    def timed_step(*a, **k):
        t, n = time.perf_counter(), eng.stats["steps_launched"]
        out = step(*a, **k)
        calls.append((t, time.perf_counter(),
                      eng.stats["steps_launched"] - n))
        return out

    eng.step = timed_step
    keeper = Keeper(lambda n, cur, kc: n in (0, 48))
    gen_mod.k1.decode_step = keeper
    decode_step.launches = 0
    before = eng.stats["steps_launched"]
    threads = [threading.Thread(target=f, args=(i,))
               for i in range(SERVING_THREADS) for f in (streamer, blocking)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
    finally:
        gen_mod.k1.decode_step = decode_step
        del eng.step
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "serving: a request thread is still running after 300 s")
    check(not errors, f"serving: {errors}")
    check(len(results) == 2 * SERVING_THREADS, f"serving: {len(results)} "
          f"results")
    for key, (_, wav) in results.items():
        check(wav.size > 0 and bool(np.isfinite(wav).all()),
              f"serving: {key} gave {wav.shape}, finite "
              f"{bool(np.isfinite(wav).all())}")
    counts = {v: n for v, n in decode_step.variant_launches.items() if n}
    steps = eng.stats["steps_launched"] - before
    check(sum(counts.values()) == keeper.n and keeper.n >= steps > 0,
          f"serving: {counts} launches for {keeper.n} calls and {steps} "
          f"code-engine steps")
    err = check_kept_calls(chat.packed, chat.gpt_params["norm"],
                           chat.config.gpt, keeper.kept, "serving", 2)
    for v in counts:
        _fold(kernels, launches, {v: counts[v]}, v, err)
    stats = svc.stats()
    check(stats["peak_slots"] >= 2, f"serving: peak slots "
          f"{stats['peak_slots']}")
    ttfc = [first for (kind, _), (first, _) in results.items()
            if kind == "stream"]
    p50, p95 = _quantiles(ttfc)
    print(f"serving: {SERVING_THREADS} streams + {SERVING_THREADS} blocking "
          f"requests in {wall:.3f} s, {SERVING_THREADS / wall:.2f} streams/s, "
          f"{2 * SERVING_THREADS / wall:.2f} requests/s; first chunk p50 {p50:.3f} s, p95 {p95:.3f} s "
          f"(max {max(ttfc):.3f}); peak slots {stats['peak_slots']}; "
          f"{steps} code-engine steps; launches {counts}; kept calls' "
          f"hidden max-abs {err:.3e}; code engine first emission p50 "
          f"{stats['code'].get('first_emission_p50_s', 0.0):.3f} s")
    per_step = [(e - b) / n for b, e, n in calls if n]
    held = sum(e - b for b, e, _ in calls)
    print(f"serving: the engine thread's code-engine step(): "
          f"{len(calls)} calls, "
          f"{1e3 * held / max(steps, 1):.2f} ms a decode step (calls' p50 "
          f"{1e3 * float(np.median(per_step)):.2f}, max "
          f"{1e3 * max(per_step):.2f}), {100 * held / wall:.1f}% of the "
          f"wall")

    # an abandoned stream frees its slot, and a later request is served
    gen = svc.synthesize_stream(TEXTS[0], code(300, max_new=1024))
    next(gen)
    gen.close()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            any(r is not None for r in eng.slots) or svc._pending):
        time.sleep(0.01)
    check(not any(r is not None for r in eng.slots) and not svc._pending,
          "serving: the aborted stream still holds a slot")
    after = svc.synthesize(TEXTS[1], params_code=code(301, max_new=64),
                           skip_refine_text=True)
    check(after.size > 0 and bool(np.isfinite(after).all()),
          "serving: the request after the abort failed")
    print("serving: an aborted stream freed its slot; the next request "
          f"gave {after.size} samples")

    # the port's HTTP server over the same service
    httpd = api_server.Server(("127.0.0.1", 0), chat, svc)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def post(path, body):
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers["Content-Type"], r.read()

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.load(r)
        check(health["status"] == "ok" and health["code"]["slots"] == 16,
              f"/health: {health}")
        ctype, wav = post("/generate_voice", {
            "text": "Hello over HTTP.", "skip_refine_text": True,
            "max_new_token": 96, "min_new_token": 48, "manual_seed": 7})
        check(ctype == "audio/wav" and wav[:4] == b"RIFF" and len(wav) > 44,
              f"/generate_voice: {ctype}, {len(wav)} bytes")
        t = time.perf_counter()
        ctype, body = post("/v1/audio/speech", {
            "input": "Streaming over HTTP.", "stream": True,
            "max_new_token": 128, "min_new_token": 96, "manual_seed": 8})
        http_s = time.perf_counter() - t
        pcm, rate = read_wav_stream(body)
        check(ctype == "audio/wav" and body.count(b"RIFF") == 1
              and rate == 24000 and pcm.size > 0
              and bool(np.isfinite(pcm).all()),
              f"streamed /v1/audio/speech: {ctype}, {len(body)} bytes")
    finally:
        httpd.shutdown()
        httpd.server_close()  # closes the service too
        server.join(timeout=10)
    print(f"serving: HTTP /health, /generate_voice ({len(wav)} bytes) and a "
          f"streamed /v1/audio/speech ({pcm.size} samples in {http_s:.3f} s) "
          f"answered")


def phase_engine_wide(chat, kernels, launches):
    """The wide tier (32 slots on the int8 cache) as the facade builds and
    routes it: more than 16 requests on a quantized cache go there.  40
    seeded requests through ``Engine.generate``; every output checked, 32
    slots live at the peak, and kept calls (the first, and the first after
    the slots turned over) held against the plain version."""
    cfg = chat.config.gpt
    max_new = chat._code_engine_geometry("wide").max_new_tokens
    check(chat._code_tier_for(40, max_new, 200) == "wide",
          "40 requests are not routed to the wide tier")
    eng = chat._engine_for_code("wide")
    check(eng.ecfg.max_num_seqs == 32 and eng.state.kc.shape[2] == 2560,
          f"the wide tier is {eng.ecfg.max_num_seqs} slots of "
          f"{eng.state.kc.shape[2]} rows")
    eng.warmup()
    marks = {}

    def want(n, cur, kc):
        if n == 0:
            return True
        if "turned" not in marks and eng.stats["prefills"] > 32:
            marks["turned"] = n
            return True
        return False

    reqs = _engine_requests(cfg, 40)
    outs, wall, counts, keeper = _engine_run(eng, reqs, want)
    _check_engine_outputs(outs, reqs, cfg)
    check(eng.stats["peak_slots"] == 32,
          f"peak slots {eng.stats['peak_slots']}")
    check(not eng.has_unfinished() and "turned" in marks,
          "the wide engine left requests or kept no call after turning over")
    _fold(kernels, launches, counts, "k2k3", check_kept_calls(
        chat.packed, chat.gpt_params["norm"], cfg, keeper.kept,
        "engine wide 32 slots", 2))
    _print_engine_run("engine wide 32 slots", eng, outs, wall)
    del chat._code_engines["wide"]


def _engine_requests(cfg, n=24):
    """``n`` seeded code-mode requests: prompts of 20-200 tokens, max_new
    64-256, min_new 32; requests 3 and n - 4 are twins (same seed, prompt
    and knobs), admitted in different waves of an engine of at most n - 4
    slots."""
    import numpy as np
    from chattts_tpu_torch.engine.batching import EngineRequest

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(20, 201))
        spec = dict(
            ids=np.repeat(rng.integers(5, cfg.num_text_tokens - 200,
                                       (plen, 1)), cfg.num_vq, 1
                          ).astype(np.int32),
            text_mask=np.ones((plen,), bool),
            temperature=np.full((cfg.num_vq,), 0.3, np.float32),
            top_p=0.7, top_k=20, repetition_penalty=1.05, min_new=32,
            max_new=int(rng.integers(64, 257)), seed=1000 + i)
        if i == n - 4:
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


def _engine_run(eng, reqs, want, variant="k2k3"):
    """``eng.generate(reqs)`` with the launch counts set to 0 just before
    and read just after, and the calls ``want`` picks kept; every launch
    must be of ``variant``, one per engine step.  Returns (outputs, wall
    seconds, launches by variant, the keeper)."""
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
    check(counts[variant] == eng.stats["steps_launched"] == keeper.n
          and counts[variant] == sum(counts.values()),
          f"{variant} launches {counts} against "
          f"{eng.stats['steps_launched']} engine steps")
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


def _fold(kernels, launches, counts, variant, err):
    """Add a main-path run's launch counts to ``launches``, and fold its
    kept calls' largest error into every row ``variant`` belongs to."""
    launches.update(counts)
    for row, entry in kernels.items():
        if row == variant or (row in FEATURE_ROWS and row in variant):
            entry["max_abs_err"] = max(entry["max_abs_err"], err)


def phase_engine(chat, kernels, launches):
    """The Engine at the capacity geometry on 24 requests, with preemption
    off (twins held to equality) and as the facade configures it; then the
    facade's engine route on both caches and on int8 weights.  Adds the
    launches of its runs to ``launches``, folds the kept calls' errors into
    ``kernels``, and times K2 on a call its run made."""
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
        _fold(kernels, launches, counts, variant, err)

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

    # the facade's engine route: int8 cache (K2+K3), then bf16 (K2), then
    # int8 weights on the int8 cache (K2+K3+K4).  Kept: the first call on
    # each engine's cache (the text engine's, then the fast code tier's) and
    # the code engine's 40th
    refine = Chat.RefineTextParams(max_new_token=32, min_new_token=4,
                                   manual_seed=11, show_tqdm=False)
    code = Chat.InferCodeParams(max_new_token=128, min_new_token=64,
                                manual_seed=12, show_tqdm=False)
    for weight_bits, kv_bits, variant in ((0, 8, "k2k3"), (0, 0, "k2"),
                                          (8, 8, "k2k3k4")):
        echat = Chat(config=chat.config)
        echat.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                          decoder=chat.decoder_params,
                          vocos=chat.vocos_params, use_engine=True,
                          weight_bits=weight_bits, kv_bits=kv_bits)
        title = (f"infer use_engine weight_bits={weight_bits} "
                 f"kv_bits={kv_bits}")
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
              f"{title}: launches {counts}, engine steps {steps}")
        check(list(echat._code_engines) == ["fast"],
              f"tiers built: {list(echat._code_engines)}")
        code_T = echat._code_engines["fast"].state.kc.shape[2]
        check(sorted(seen) == [echat._text_engine.state.kc.shape[2], code_T]
              and code_T == 2304 and seen[code_T] >= 40,
              f"{title}: calls by cache length {seen}")
        fold(variant, counts, check_kept_calls(
            echat.packed, norm, cfg, keeper.kept, title, 3))
        audio_s = sum(w.size for w in wavs) / chat.config.vocos.mel.sample_rate
        print(f"{title}: 4 texts, {steps} engine "
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


def phase_engine_64(chat, kernels, launches):
    """An Engine of 64 slots on the int4 cache and int8 weights, at the
    capacity geometry's cache (512 + 2048 rows), on 96 seeded requests:
    every step K2+K6+K4.  Preemption is off, so the twins (requests 3 and
    92, admitted in different waves) are held to equality.  Checks every
    output, that more than 32 slots were live at the peak, and kept calls
    (the first, and the first after the slots turned over) against the
    plain version; times the variant on the last of them."""
    import dataclasses

    import numpy as np
    import torch
    from chattts_tpu_torch.engine import batching
    from chattts_tpu_torch.ops.decode_step import pack_weights

    cfg = chat.config.gpt
    tier = chat._code_engine_geometry("capacity")
    ecfg = dataclasses.replace(tier, max_num_seqs=64,
                               preempt_after_chunks=None,
                               max_stream_slots=None)
    check(batching.fused_slot_limit(4) == 64
          and batching.fused_slot_limit(8) == 32,
          "64 slots are not tied to the int4 cache")
    packed8 = pack_weights(chat.gpt_params, cfg, weight_bits=8)
    eng = batching.Engine(cfg, ecfg, chat.gpt_params, chat.embed_params,
                          spk_emb_ids=chat.tokenizer.spk_emb_ids,
                          packed=packed8, kv_bits=4)
    HD = cfg.num_attention_heads * cfg.head_dim
    check(eng.state.kc.dtype == torch.int8
          and tuple(eng.state.kc.shape[1:]) == (64, 2560, HD // 2 + 128),
          f"the engine's cache is {tuple(eng.state.kc.shape)}")
    print(f"engine 64 slots: kv4 caches {2 * eng.state.kc.numel() / 1e9:.2f} "
          f"GB")
    eng.warmup()
    marks = {}

    def want(n, cur, kc):
        if n == 0:
            return True
        if "turned" not in marks and eng.stats["prefills"] > ecfg.max_num_seqs:
            marks["turned"] = n
            return True
        return False

    reqs = _engine_requests(cfg, 96)
    outs, wall, counts, keeper = _engine_run(eng, reqs, want, "k2k6k4")
    _check_engine_outputs(outs, reqs, cfg)
    check(eng.stats["peak_slots"] == 64,
          f"peak slots {eng.stats['peak_slots']}")
    check(eng.stats["prefills"] == 96 and not eng.has_unfinished(),
          f"prefills {eng.stats['prefills']}")
    check(np.array_equal(outs[3].ids, outs[92].ids) and outs[3].ids.size > 0,
          "the twin requests (same seed and prompt, different waves) differ")
    check("turned" in marks, "no call was kept after the slots turned over")
    _fold(kernels, launches, counts, "k2k6k4", check_kept_calls(
        packed8, chat.gpt_params["norm"], cfg, keeper.kept,
        "engine 64 slots", 2))
    _print_engine_run("engine 64 slots kv4 w8", eng, outs, wall)
    (emb, kc0, vc0, cur, lo, pos), _, _, _ = keeper.kept[-1]
    del outs, eng
    kernels["k2k6k4"].update(_time_call(
        "k2k6k4", cfg, packed8, emb, kc0, vc0, cur, lo, pos,
        "the 64-slot run's first step after the slots turned over",
        profile=True))


def sweep_chunk(dev, chunks=(32, 64, 128), blocks=(1024, 2112, 4096)):
    """``python3 chip_smoke.py --sweep-chunk``: the attention chunk C at 32,
    64 and 128 keys, each with the grid aimed at ``blocks`` blocks
    (ATTN_BLOCKS), one library each (built together): at the Generator's
    shape on each cache tier (B 8, T 512, cur 256), at 16 slots on the kv8
    cache (T 2560, 171..430 keys) and at 64 slots on kv4 with int8 weights
    (T 2560, 24..247 keys), each chunk's step against the plain version
    (hidden within HIDDEN_ATOL), then the attention pair's device ms a step
    (profiled) and the step's ms (CUDA events), the chunks in turns
    (32, 64, 128, 128, 64, 32)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from chattts_tpu_torch.config import Config
    from chattts_tpu_torch.models import llama
    from chattts_tpu_torch.ops.decode_step import (DecodeStep,
                                                   decode_step_plain,
                                                   pack_weights)
    from chattts_tpu_torch.weights import to_device

    steppers = {(c, n): DecodeStep(defines=(f"-DATTN_CHUNK={c}",
                                            f"-DATTN_BLOCKS={n}"))
                for c in chunks for n in blocks}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(chunks)) as pool:
        list(pool.map(lambda st: st.library.get(), steppers.values()))
    print(f"sweep: {len(steppers)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = Config().gpt
    gen = torch.Generator().manual_seed(1)
    params = to_device(llama.init_params(gen, cfg), dev)
    packs = {bits: pack_weights(params, cfg, weight_bits=bits)
             for bits in (0, 8)}
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    HD = cfg.num_attention_heads * cfg.head_dim
    tgen = torch.Generator().manual_seed(5)
    lo_g = torch.tensor([0, 0, 3, 5, 0, 17, 1, 64])
    cur_e = 512 + torch.randint(0, 256, (16,), generator=tgen)
    lo_e = 512 - torch.randint(100, 201, (16,), generator=tgen)
    n64 = torch.randint(24, 248, (64,), generator=tgen)
    cur64 = 300 + torch.randint(0, 2000, (64,), generator=tgen)
    cases = [(v, 8, 512, 256, torch.full((8,), 256), lo_g)
             for v in ("k1", "k3", "k6")]
    cases += [("k2k3", 16, 2560, cur_e, cur_e, lo_e),
              ("k2k6k4", 64, 2560, cur64, cur64, cur64 - n64 + 1)]
    norm = params["norm"]
    for variant, B, T, cur, cur_rows, lo in cases:
        weight_bits, kv_bits, _ = _tier(variant)
        packed = packs[weight_bits]
        kk, vk = _random_caches((L, B, T, HD), kv_bits, cfg, gen, dev)
        emb = (torch.randn((B, D), generator=gen) * 0.3).to(dev)
        cur = cur.to(dev) if isinstance(cur, torch.Tensor) else cur
        cur_rows, lo = cur_rows.to(dev), lo.to(dev)
        pos = cur_rows - lo
        xp = decode_step_plain(packed, emb, kk.clone(), vk.clone(), cur, lo,
                               pos, cfg)
        hp = llama.rms_norm(xp, norm, cfg.rms_norm_eps)
        for c, st in steppers.items():
            xk = st(packed, emb, kk.clone(), vk.clone(), cur, lo, pos, cfg)
            err = float((llama.rms_norm(xk, norm, cfg.rms_norm_eps)
                         - hp).abs()[(cur_rows - lo + 1) >= KEYS_HELD]
                        .max())
            check(err <= HIDDEN_ATOL, f"chunk {c}, {variant}: hidden {err}")
        seen = cur_rows - lo + 1
        times = {c: [] for c in steppers}
        for c in (*steppers, *list(steppers)[::-1]):
            st = steppers[c]

            def step():
                return st(packed, emb, kk, vk, cur, lo, pos, cfg)

            attn = sum(us for name, us in _kernel_events(
                lambda: [step() for _ in range(5)])
                if name.startswith(ATTN_ROWS)) / 5 / 1e3
            times[c].append((attn, _time_ms(step)))
        print(f"sweep {variant}, B {B}, T {T}, keys {int(seen.min())}.."
              f"{int(seen.max())}: chunk: attention pair ms a step, step ms "
              "(two turns each) | " + " | ".join(
                  f"C {c}, blocks {n}: " + ", ".join(f"{a:.4f} {t:.4f}"
                                                      for a, t in v)
                  for (c, n), v in times.items()))


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
    if sys.argv[1:] == ["--sweep-chunk"]:
        sweep_chunk(dev)
        print(card)
        return 0
    if sys.argv[1:] == ["--gemv"]:
        phase_build()
        phase_gemv(dev)
        print(f"chip_smoke --gemv: {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0

    def lap(name, t=[t_start]):
        now = time.perf_counter()
        print(f"chip_smoke: {name} in {now - t[0]:.1f} s")
        t[0] = now

    phase_build()
    phase_gemv(dev)
    phase_kv4_append(dev)
    lap("build, gemv, kv4 append")
    kernels = phase_kernel(dev)
    lap("kernel cases")
    phase_attention(dev)
    phase_weight_scales(dev)
    lap("undiluted attention and MLP")
    torch.cuda.empty_cache()

    from chattts_tpu_torch import Chat

    launches = collections.Counter()
    chat = Chat()
    t0 = time.perf_counter()
    chat.load(source="random", seed=0)
    torch.cuda.synchronize()
    print(f"load: {time.perf_counter() - t0:.2f} s")

    def twin(**tiers):
        c = Chat(config=chat.config)
        c.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                      decoder=chat.decoder_params, vocos=chat.vocos_params,
                      dvae=chat.dvae_params, **tiers)
        return c

    # the Generator's main paths: K1, K3, then K4 on K3 and K5 on K6
    for variant, tiers, max_new in (
            ("k1", dict(kv_bits=0), 128), ("k3", None, 256),
            ("k3k4", dict(weight_bits=8, kv_bits=8), 128),
            ("k6k5", dict(weight_bits=4, kv_bits=4), 128)):
        c = chat if tiers is None else twin(**tiers)
        counts, err = phase_infer(c, variant, max_new=max_new,
                                  profile=variant == "k3")
        _fold(kernels, launches, counts, variant, err)
        del c
    lap("infer on the Generator")
    phase_load(chat, kernels, launches)
    lap("load")
    engine_chat = twin(use_engine=True)
    phase_multi_segment(chat, engine_chat, kernels, launches)
    lap("multi-segment")
    phase_stream(chat, engine_chat, kernels, launches)
    lap("stream")
    phase_serving(engine_chat, kernels, launches)
    lap("serving")
    del engine_chat
    torch.cuda.empty_cache()
    phase_engine(chat, kernels, launches)
    phase_engine_wide(chat, kernels, launches)
    torch.cuda.empty_cache()
    phase_engine_64(chat, kernels, launches)
    lap("engines")
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row, k in kernels.items():
        # a row by feature counts every variant that holds the feature
        k["launches"] = sum(n for v, n in launches.items()
                            if (row in v if row in FEATURE_ROWS else row == v))
        check(k["launches"] > 0, f"{k['name']} never launched on a main path")
    print("launches by variant on the main paths:", dict(launches))
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}
                                  for entry in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
