"""The whole decode step as a hand-written CUDA kernel, in every tier of the
reference, and its plain PyTorch version.

This replaces ``chattts_tpu/ops/pallas_step.py::_kernel`` (launched by
``decode_step_fused``).  One call runs all L layers of one autoregressive
step and returns the float32 residual *before* the final norm; the caller
applies ``llama.rms_norm``.  As in the reference, the variant follows from
the arguments: the cache's type and width, ``cur``'s rank, the weights'
type and width.

=====  ==========================  =========================================
name   ``cur``                     cache
=====  ==========================  =========================================
k1     one position (int or 0-d)   (L, B, T, HD) bf16
k2     a position per row (B,)     (L, B, T, HD) bf16
k3     one position                (L, B, T, HD + KV_PAD) int8 (kv8 rows)
k2k3   a position per row          (L, B, T, HD + KV_PAD) int8
k6     one position                (L, B, T, HD/2 + KV_PAD) int8 (kv4 rows)
k2k6   a position per row          (L, B, T, HD/2 + KV_PAD) int8
=====  ==========================  =========================================

With int8 weights the name gains ``k4`` (``k3k4``: K4 on the kv8 cache),
with nibble-packed int4 weights ``k5`` (``k6k5``).  The weight tier touches
only the matrix products and the cache tier only attention, so the 18
combinations are three gemv instantiations times three attention ones.

* :func:`pack_weights` lays the decoder weights out for the kernel: each
  projection as an (N, K) matrix with K contiguous, one per layer, stacked
  over layers; bf16, int8 with scales, or int4 nibbles with group scales.
  The quantized integers and scales are the reference's
  (``pack_step_params(int8=, int4=)``), value for value.
* :func:`decode_step_plain` is the same arithmetic in torch ops, every
  variant: the CPU path, and the card's reference for the kernel.
* :data:`decode_step` is the wrapper.  A CUDA tensor launches the kernel
  (``csrc/decode_step.cu``) and counts the launch under its variant's name
  in ``decode_step.variant_launches`` (``decode_step.launches`` is their
  sum); a CPU tensor takes the plain version.  There is no fallback from
  one to the other.  A call captured into a CUDA graph counts nothing: its
  caller counts each replay (:meth:`DecodeStep.replayed`), and passes the
  graph's own tickets.  Each call, of every variant and of
  :data:`decode_step_tp`, is one ``decode_step`` span
  (``utils/profiling.py``).
* :data:`gemv` launches one of the step's gemvs on its own (the kernel's
  entry for tests and timing, counted in ``decode_step.gemv_launches``),
  building its own bf16 input rows first; :func:`gemv_plain` is its plain
  version and :func:`gemv_tolerance` the error bound the kernel is held
  to.  Inside the step each gemv reads bf16 rows that another launch
  prepared (:func:`gemv_rows_plain` is how they are built);
  :meth:`DecodeStep.rows` and :meth:`DecodeStep.gemv_on_rows` launch the
  rows pass and a gemv with the step's epilogues on their own, for tests.
  ``decode_step.gemv_prepared`` counts gemvs that read prepared rows (4 L
  a step) and ``gemv_rebuilt`` those that built their own (the one-gemv
  entry).  :data:`kv4_append` likewise launches
  the kv4 cache's append alone (``decode_step.kv4_append_launches``), with
  :func:`kv4_append_plain` as its plain version.  The step never calls
  them.
* :data:`decode_step_tp` is one step of a tensor-parallel rank: its slabs
  (:func:`shard_packed`), its heads' caches (:class:`Heads`), and per
  layer the qkv gemv, :data:`attend` (one layer's attention through the
  library's ``decode_step_attend`` entry, counted in
  ``decode_step.attend_launches``), the wo gemv into a partial summed over
  the ranks by the caller's all_reduce, the gate/up and down gemvs, the
  down partial summed likewise: the step's kernels launched one by one
  (counted by variant in ``decode_step.tp_launches``).
  :func:`decode_step_plain` given the rank's heads and the all_reduce is
  its plain version.

The caches are updated in place (the TPU kernel aliases them too): only row
``cur_b`` of row b of every layer is written.  The kv8 and kv4 row formats
and their quantizers are ``ops/kv_quant.py``'s; rows appended here and rows
quantized at the prefill dequantize alike.  A position on the device is
never read back: the kernel takes ``cur`` as a device array, and a position
outside ``[0, T)`` turns that row's result into NaN instead of being
clamped.

Bound on an H100 at the full config: every weight is read once a step,
L*(4*D*D + 3*D*I) parameters of 2, 1 or 1/2 bytes (377, 189 or 94 MB: ~113,
~57 or ~28 us at 3.35 TB/s) plus their scales, plus the KV read of
2*L*sum_b(cur_b-lo_b)*R bytes and the appended rows 2*L*B*W, with W =
2*HD (bf16), HD + KV_PAD (kv8) or HD/2 + KV_PAD (kv4) and R the bytes of a
row attention reads (W on bf16; the values and one 32-byte sector of head
scales on kv8 and kv4).  The kernel's design is described at the top of
``csrc/decode_step.cu``: per layer four gemvs and the attention pair
(scores, then values over chunks of :attr:`DecodeStep.attn_chunk` keys, as
the library was built), six launches, seven on kv4, and one rows pass a
step, at any batch width: the gemv takes its rows in groups of 32 (a
weight is read once a group) and a row's result does not depend on the
batch.  The wrapper allocates the pair's scratch and the
gemvs' bf16 rows on every call and keeps the tickets (one counter per
(row, head), which the kernels leave at zero; the gemvs that build normed
rows take one a row group of the same buffer) per device and stream; a
step captured into a CUDA graph takes the graph's own.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..utils import profiling
from ._build import CudaLibrary
from .kv_quant import (KV_PAD, kv4_packable, kv_quantizer, row_scales,
                       row_width, unpack_nibbles)

NEG = -1e30  # masked-score value of the TPU kernel
# most batch rows a launch takes: the attention grid's gridDim.z (kMaxB in
# csrc/decode_step.cu); any B the reference takes fits
MAX_ROWS = 65535
MATRICES = ("wqkv", "wo", "wgu", "wd")
# cache and position part of a variant's name, then the weight tier's
VARIANTS = tuple(base + w for w in ("", "k4", "k5")
                 for base in ("k1", "k2", "k3", "k2k3", "k6", "k2k6"))
# the tensor-parallel step's variants: a position per row, bf16 weights
TP_VARIANTS = ("k2", "k2k3", "k2k6")


def int4_group(D: int) -> int:
    """Rows of a contraction group of the int4 scales: 128, or D/2 where a
    half slab is narrower (the reference's ``_int4_groups``)."""
    gs = 128 if (D // 2) % 128 == 0 else D // 2
    if gs == 0 or (D // 2) % gs:
        raise ValueError("geometry not int4-groupable")
    return gs


def _quantize_matrix(w: torch.Tensor, gs: int, weight_bits: int):
    """An (in, out) = (K, N) matrix -> (integers (N, K) int8, scales (N,
    K/gs) f32), one scale per (``gs``-row contraction group, output column).

    The reference's arithmetic, dtype for dtype: its int8 branch computes in
    the parameters' own dtype (bf16 parameters give bf16 scales and a bf16
    division), its int4 branch in f32."""
    K, N = w.shape
    if weight_bits == 8:
        wg = w.reshape(K // gs, gs, N)
        scale = torch.clamp(wg.abs().amax(dim=1), min=1e-8) / 127.0
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -127, 127)
    else:
        wg = w.to(torch.float32).reshape(K // gs, gs, N)
        scale = torch.clamp(wg.abs().amax(dim=1), min=1e-8) / 7.0
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    return (q.reshape(K, N).T.to(torch.int8).contiguous(),
            scale.T.to(torch.float32).contiguous())


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 values in [-8, 7] -> (N, K/2) int8: value 2j in the low
    nibble of byte j, value 2j + 1 in its high nibble."""
    q = q.to(torch.int32)
    u = (q[:, 0::2] & 15) | ((q[:, 1::2] & 15) << 4)
    return ((u << 24) >> 24).to(torch.int8).contiguous()


def unpack_matrix(w: torch.Tensor, K: int) -> torch.Tensor:
    """A packed (N, K) int8 or (N, K/2) nibble matrix -> (N, K) f32 integer
    values (exact)."""
    if w.shape[-1] == K:
        return w.to(torch.float32)
    lo_hi = unpack_nibbles(w)                     # (N, K): lows, then highs
    half = K // 2
    return torch.stack([lo_hi[:, :half], lo_hi[:, half:]],
                       dim=-1).reshape(w.shape[0], K).to(torch.float32)


def pack_weights(params: dict, cfg, weight_bits: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """The decoder's parameter tree -> the kernel's layout.

    Returns {"wqkv": (L, 3*HD, D), "wo": (L, D, HD), "wgu": (L, 2*I, D),
    "wd": (L, D, I)} with K contiguous in every matrix (rows of wgu are
    [gate | up]), and {"ln1", "ln2"}: (L, D) f32.  Tensors stay on the
    device of ``params``.

    ``weight_bits`` 0 keeps the matrices in bf16.  8 stores int8 values and
    adds {"sqkv", "so", "sgu", "sd"}: (L, N, K/D) f32 scales, one per
    (D-row contraction group, output column): one group everywhere but in
    ``wd``, whose contraction of I has I/D.  4 stores two values a byte,
    (L, N, K/2) int8, with (L, N, K/gs) scales, gs = :func:`int4_group`.
    Integers and scales equal ``pack_step_params(int8=, int4=)``'s, whose
    square (D, D) slabs set the groups: both need HD == D, I % D == 0 and
    D % 128 == 0.
    """
    if weight_bits not in (0, 8, 4):
        raise ValueError(f"weight_bits must be 0, 8 or 4, not {weight_bits}")
    D, I = cfg.hidden_size, cfg.intermediate_size
    HD = cfg.num_attention_heads * cfg.head_dim
    layers = params["layers"]

    def stack(fn, dtype):
        return torch.stack([fn(lp) for lp in layers]).to(dtype).contiguous()

    matrices = {  # (in, out) = (K, N), as the parameter tree stores them
        "wqkv": lambda lp: lp["attn"]["wqkv"].reshape(D, 3 * HD),
        "wo": lambda lp: lp["attn"]["wo"],
        "wgu": lambda lp: lp["mlp"]["wgu"].reshape(D, 2 * I),
        "wd": lambda lp: lp["mlp"]["down"],
    }
    out = {"ln1": stack(lambda lp: lp["ln1"], torch.float32),
           "ln2": stack(lambda lp: lp["ln2"], torch.float32)}
    if weight_bits == 0:
        for name, get in matrices.items():
            out[name] = stack(lambda lp: get(lp).T, torch.bfloat16)
        return out
    if HD != D or I % D or D % 128:
        raise ValueError("quantized weights need the reference's slab "
                         "geometry: heads * head_dim == hidden_size, "
                         "intermediate_size % hidden_size == 0, "
                         "hidden_size % 128 == 0")
    gs = D if weight_bits == 8 else int4_group(D)
    for name, get in matrices.items():
        qs = [_quantize_matrix(get(lp), gs, weight_bits) for lp in layers]
        q = [pack_nibbles(q) if weight_bits == 4 else q for q, _ in qs]
        out[name] = torch.stack(q).contiguous()
        out["s" + name[1:]] = torch.stack([s for _, s in qs]).contiguous()
    return out


def weight_bits_of(packed: dict, cfg) -> int:
    """The weight tier of a packed dict, from its type and width."""
    w = packed["wqkv"]
    if w.dtype != torch.int8:
        return 0
    return 8 if w.shape[-1] == cfg.hidden_size else 4


def kv_bits_of(k_cache: torch.Tensor, cfg) -> int:
    """The cache tier, from its type and width; raises on any other."""
    tiers = (0, 8, 4) if kv4_packable(cfg) else (0, 8)
    for bits in tiers:
        if (k_cache.ndim == 4 and k_cache.shape[-1] == row_width(bits, cfg)
                and k_cache.dtype == (torch.int8 if bits
                                      else torch.bfloat16)):
            return bits
    HD = cfg.num_attention_heads * cfg.head_dim
    raise ValueError(
        f"caches must be (L, B, T, {HD}) bf16, (L, B, T, {HD + KV_PAD}) "
        f"int8 or, where heads * head_dim % 256 == 0, (L, B, T, "
        f"{HD // 2 + KV_PAD}) int8, not {tuple(k_cache.shape)} "
        f"{k_cache.dtype}")


def rope_rows(cfg, positions: torch.Tensor):
    """cos/sin (B, Dh) f32 at each row's rope position."""
    from ..models.llama import rope_tables_torch

    cos_t, sin_t = rope_tables_torch(cfg, positions.device)
    return cos_t[positions], sin_t[positions]


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (exact bf16 products in f32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, scale=None) -> torch.Tensor:
    """(B, K) f32 x (N, K) -> (B, N) f32: bf16 inputs, f32 sums.  ``w`` is
    bf16, or int8 / nibble-packed with ``scale`` (N, G): the integers widen
    exactly, and each contraction group's f32 sum is multiplied by its scale
    (never the weight before the product)."""
    if scale is None:
        return _bf(a) @ w.to(torch.float32).T
    B, K = a.shape
    N, G = scale.shape
    part = torch.einsum("bgk,ngk->bgn", _bf(a).reshape(B, G, K // G),
                        unpack_matrix(w, K).reshape(N, G, K // G))
    return (part * scale.T[None]).sum(dim=1)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w[None, :]


# the gemv's prologues (``mode`` of :func:`gemv`): the input as given, its
# rms norm times ``lnw``, or silu(gate) * up of x = [gate | up]
GEMV_NONE, GEMV_RMS, GEMV_SILU = 0, 1, 2
# what a gemv of the step does with its sums (:meth:`DecodeStep.gemv_on_rows`,
# the kernel's OUT_* numbers)
GEMV_EPILOGUES = {"store": 0, "add": 1, "norm": 2, "silu": 3}


def _gemv_input(x: torch.Tensor, lnw, mode: int, eps: float) -> torch.Tensor:
    """The f32 input rows the gemv multiplies, before their bf16 rounding."""
    if mode == GEMV_RMS:
        return _rms(x, lnw, eps)
    if mode == GEMV_SILU:
        g, u = x.chunk(2, dim=-1)
        return g * torch.sigmoid(g) * u
    return x


def gemv_rows_plain(x: torch.Tensor, lnw, mode: int, eps: float = 1e-6
                    ) -> torch.Tensor:
    """The bf16 input rows (B, K) the kernel's gemvs multiply, built as the
    kernel builds them (``gemv_kernel_rows``, and the finishing and
    gate/up epilogues of the step's gemvs), so that on the card the two
    agree bit for bit.  :data:`GEMV_RMS`: x (B, K) f32 times rsqrt(mean of
    the squares + eps) times ``lnw``, with the squares summed in the
    kernel's order: lane l of a warp adds, for the float4s l, l + 32, ...
    of the row, ((x0^2 + x1^2) + x2^2) + x3^2, and the 32 lane sums meet in
    a butterfly (lane ^ 16, ^ 8, ..., ^ 1), every step rounded to f32.
    :data:`GEMV_SILU`: x = [gate | up] (B, 2K), (g / (1 + exp(-g))) * u.
    The same rows as :func:`_gemv_input` rounded to bf16, but for an
    element that lies within the f32 rounding of the two orders of a bf16
    tie, which may round to the other neighbour."""
    if mode == GEMV_SILU:
        K = x.shape[1] // 2
        g, u = x[:, :K], x[:, K:]
        return ((g / (1 + torch.exp(-g))) * u).to(torch.bfloat16)
    if mode != GEMV_RMS:
        raise ValueError(f"the rows pass builds rms (1) or silu (2) rows, "
                         f"not mode {mode}")
    B, K = x.shape
    sq = (x * x).reshape(B, K // 4, 4)
    terms = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    rounds = -(-(K // 4) // 32)
    terms = torch.nn.functional.pad(terms, (0, 32 * rounds - K // 4))
    lanes = torch.zeros((B, 32), dtype=x.dtype, device=x.device)
    for i in range(rounds):
        lanes = lanes + terms[:, 32 * i:32 * (i + 1)]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ o]
    ss = lanes[:, :1]
    # a tensor divisor: torch divides by a scalar through its reciprocal
    # on the card, the kernel as IEEE does
    rscale = torch.rsqrt(ss / torch.full_like(ss, K) + eps)
    return ((x * rscale) * lnw[None, :]).to(torch.bfloat16)


def _gemv_geometry(x: torch.Tensor, lnw, w: torch.Tensor, scale, group: int,
                   out: torch.Tensor, mode: int):
    """(K, weight_bits) of a gemv's arguments; raises ValueError on what the
    kernel does not take."""
    if mode not in (GEMV_NONE, GEMV_RMS, GEMV_SILU):
        raise ValueError(f"mode must be 0 (none), 1 (rms) or 2 (silu), not "
                         f"{mode}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("x must be a (B, K) float32 tensor, (B, 2K) for silu")
    B = x.shape[0]
    K = x.shape[1] // 2 if mode == GEMV_SILU else x.shape[1]
    if not 1 <= B <= MAX_ROWS or K < 8 or K % 8 or (
            mode == GEMV_SILU and x.shape[1] != 2 * K):
        raise ValueError(f"the gemv takes 1 to {MAX_ROWS} rows and K a "
                         f"multiple of 8, not x {tuple(x.shape)}")
    if w.ndim != 2 or w.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError("w must be an (N, K) bf16, (N, K) int8 or (N, K/2) "
                         "int4-nibble tensor")
    N = w.shape[0]
    if w.dtype == torch.bfloat16:
        bits = 0
    else:
        bits = {K: 8, K // 2: 4}.get(w.shape[1])
    if bits is None or (bits == 0 and w.shape[1] != K):
        raise ValueError(f"w {tuple(w.shape)} {w.dtype} does not match K {K}")
    if bits:
        if group < 32 or group % 32 or K % group:
            raise ValueError(f"a scale group of {group} rows: the gemv needs "
                             f"group % 32 == 0 and K % group == 0 (K {K})")
        if (scale is None or scale.dtype != torch.float32
                or tuple(scale.shape) != (N, K // group)):
            raise ValueError(f"scale must be ({N}, {K // group}) float32")
    if mode == GEMV_RMS and (lnw is None or lnw.dtype != torch.float32
                             or tuple(lnw.shape) != (K,)):
        raise ValueError(f"lnw must be ({K},) float32 for the rms prologue")
    if tuple(out.shape) != (B, N) or out.dtype != torch.float32:
        raise ValueError(f"out must be ({B}, {N}) float32")
    return K, bits


def gemv_plain(x: torch.Tensor, lnw, w: torch.Tensor, scale, group: int,
               out: torch.Tensor, mode: int, add: bool,
               eps: float = 1e-6) -> torch.Tensor:
    """The gemv's plain version: the prologue, then :func:`_mm`.  Returns
    ``out + y`` (``add``) or ``y``, y = bf16(in') W^T (B, N) f32; ``out``
    is not written.  Arguments as :func:`DecodeStep.gemv` takes them."""
    _gemv_geometry(x, lnw, w, scale, group, out, mode)
    y = _mm(_gemv_input(x, lnw, mode, eps), w,
            scale if w.dtype == torch.int8 else None)
    return out + y if add else y


def gemv_tolerance(x: torch.Tensor, lnw, w: torch.Tensor, scale, group: int,
                   out: torch.Tensor, mode: int, add: bool,
                   eps: float = 1e-6) -> torch.Tensor:
    """The largest |kernel - plain| a gemv may show, element by element
    (B, N), from f32 summation over K.

    With a_k the bf16 input and v_k the weight times its group's scale, the
    plain version's f32 sums (round to nearest) are off by at most
    K u S, S = sum_k |a_k v_k|, u = 2^-24.  The kernel's tensor cores sum
    each mma's 16 exact products from zero, aligned to the largest and
    truncated, at most 2u of their absolute sum for each of 16 additions
    (32 u S in all); the mma results join the running sums with K / 16
    rounded additions, the scale products, the groups' and the warps' sums
    with fewer than K / group + 16: at most (K / 8 + 64) u S.  Allowing
    twice the truncation everywhere, the two differ by at most
    (4 K + 64) u S.  On the rms and silu prologues the two sides' f32 inputs
    may differ by a relative delta (the order of the K squares' sum, halved
    by the square root, rsqrtf's and expf's 2 ulps: delta = max(2^-14,
    2 K u)), so an a_k within delta of a bf16 rounding tie may round to its
    other neighbour: such a_k add |a_k' - a_k| |v_k|.  With ``add`` the sum
    into ``out`` adds 2^-23 (|out| + |y|)."""
    K, bits = _gemv_geometry(x, lnw, w, scale, group, out, mode)
    u = 2.0 ** -24
    a = _gemv_input(x, lnw, mode, eps).double()
    v = (w.double() if bits == 0 else unpack_matrix(w, K).double()
         * scale.double().repeat_interleave(group, dim=1))
    bound = (4 * K + 64) * u * (_bf(a.float()).double().abs() @ v.abs().T)
    if mode != GEMV_NONE:
        delta = max(2.0 ** -14, 2 * K * u)
        lo = _bf((a * (1 - delta)).float()).double()
        hi = _bf((a * (1 + delta)).float()).double()
        bound = bound + (hi - lo).abs() @ v.abs().T
    if add:
        y = _mm(_gemv_input(x, lnw, mode, eps), w,
                scale if bits else None).double()
        bound = bound + 2 * u * (out.double().abs() + y.abs())
    return bound


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, H: int
          ) -> torch.Tensor:
    """x (B, HD) f32; rotate_half reads bf16-rounded values (the TPU kernel
    rotates with a +-1 bf16 matmul)."""
    B = x.shape[0]
    xh = x.reshape(B, H, -1)
    half = xh.shape[-1] // 2
    xr = _bf(xh)
    rot = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    return (xh * cos[:, None, :] + rot * sin[:, None, :]).reshape(B, -1)


def variant_of(k_cache: torch.Tensor, cur, packed=None, cfg=None) -> str:
    """The variant's name, from the arguments as the reference picks it.
    The widths that tell kv4 from kv8 rows and int4 from int8 weights come
    from ``cfg``: without it an int8 cache counts as kv8, and without it or
    ``packed`` the weights count as bf16."""
    per_slot = isinstance(cur, torch.Tensor) and cur.ndim == 1
    if cfg is not None:
        kvb = kv_bits_of(k_cache, cfg)
    else:
        kvb = 8 if k_cache.dtype == torch.int8 else 0
    name = {0: "k2" if per_slot else "k1",
            8: "k2k3" if per_slot else "k3",
            4: "k2k6" if per_slot else "k6"}[kvb]
    wb = 0 if packed is None or cfg is None else weight_bits_of(packed, cfg)
    return name + {0: "", 8: "k4", 4: "k5"}[wb]


def _check_caches(k_cache: torch.Tensor, v_cache: torch.Tensor, cfg) -> int:
    """The cache tier (0, 8, 4); raises unless both caches are of one."""
    kvb = kv_bits_of(k_cache, cfg)
    kv_bits_of(v_cache, cfg)
    if k_cache.dtype != v_cache.dtype or k_cache.shape != v_cache.shape:
        raise ValueError("k and v caches differ in type or shape")
    return kvb


def cache_values(rows: torch.Tensor, cfg) -> torch.Tensor:
    """The stored values of cache rows (..., W), any tier, as (..., HD) f32
    in feature order, scales not applied."""
    HD = cfg.num_attention_heads * cfg.head_dim
    if rows.dtype == torch.int8 and rows.shape[-1] == row_width(4, cfg):
        return unpack_nibbles(rows[..., :HD // 2]).to(torch.float32)
    return rows[..., :HD].to(torch.float32)


def attend_plain(q: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor,
                 visible: torch.Tensor, cfg, k_scales=None, v_scales=None,
                 round_p=_bf) -> torch.Tensor:
    """One layer's attention with the kernel's roundings: roped q (B, HD)
    f32 against cache rows kr/vr (B, Tv, W), bf16, kv8 or kv4, under the
    mask ``visible`` (B, 1, Tv); returns o (B, HD) f32.

    ``k_scales``/``v_scales`` (B, H, Tv) stand in for the scales embedded in
    quantized rows and ``round_p`` for the numerator's bf16 rounding: a
    check that plants a fault in this arithmetic passes them, the step never
    does.
    """
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD, (B, Tv) = H * Dh, kr.shape[:2]
    quant = kr.dtype == torch.int8
    qs = _bf(q * (1.0 / float(np.sqrt(Dh)))).reshape(B, H, Dh)
    keys = cache_values(kr, cfg).reshape(B, Tv, H, Dh)
    vals = cache_values(vr, cfg).reshape(B, Tv, H, Dh)
    s = torch.einsum("bhd,bthd->bht", qs, keys)
    if quant:  # the key's scale after the product
        s = s * (row_scales(kr, cfg).transpose(1, 2) if k_scales is None
                 else k_scales)
    s = torch.where(visible, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if quant:  # the value's scale goes into p before its bf16 rounding
        num = round_p(p * (row_scales(vr, cfg).transpose(1, 2)
                           if v_scales is None else v_scales))
    else:
        num = round_p(p)
    o = torch.einsum("bht,bthd->bhd", num, vals) / p.sum(-1)[..., None]
    return o.reshape(B, HD)


def _append_rows(cur: torch.Tensor, lo: torch.Tensor, T: int):
    """Rows whose position the kernel appends at: ``cur`` in [0, T) and at
    least one visible key from max(lo, 0)."""
    return (cur >= 0) & (cur < T) & (cur - torch.clamp(lo, min=0) + 1 > 0)


def kv4_append_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     k_rows: torch.Tensor, v_rows: torch.Tensor,
                     cur: torch.Tensor, lo: torch.Tensor, cfg) -> None:
    """One layer's kv4 append in torch ops: rope k of qkv (B, 3 HD) f32,
    quantize k and v per head (``kv_quant.kv4_quantize``) and write row
    ``cur[b]`` of row b of ``k_rows``/``v_rows`` (B, T, HD/2 + KV_PAD) int8
    where the kernel would (:func:`_append_rows`); other rows untouched."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    live = _append_rows(cur, lo, k_rows.shape[1])
    rows = torch.arange(qkv.shape[0], device=qkv.device)[live]
    k = _rope(qkv[:, HD:2 * HD], cos, sin, H)[live]
    quantize = kv_quantizer(4, cfg)
    k_rows[rows, cur[live].long()] = quantize(k, cfg)
    v_rows[rows, cur[live].long()] = quantize(qkv[live, 2 * HD:], cfg)


def attend_layer_plain(qkv: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, k_rows: torch.Tensor,
                       v_rows: torch.Tensor, cur: torch.Tensor,
                       lo: torch.Tensor, heads) -> torch.Tensor:
    """One layer's attention as the step does it with a position per row:
    rope q and k of qkv (B, 3 HD) f32, write k and v (quantized on kv8 and
    kv4) at row ``cur[b]`` of row b of the layer's caches (B, T, W), and
    attend over rows [lo_b, cur_b]; returns o (B, HD) f32.  ``heads`` is
    the config or a rank's :class:`Heads`."""
    H, Dh = heads.num_attention_heads, heads.head_dim
    HD = H * Dh
    B, T = qkv.shape[0], k_rows.shape[1]
    quantize = kv_quantizer(_check_caches(k_rows[None], v_rows[None], heads),
                            heads)
    dev = qkv.device
    cur = cur.to(device=dev, dtype=torch.long)
    rows = torch.arange(B, device=dev)
    t = torch.arange(T, device=dev)
    visible = ((t[None, :] >= lo[:, None].to(dev))
               & (t[None, :] <= cur[:, None]))[:, None, :]
    q = _rope(qkv[:, :HD], cos, sin, H)
    k = _rope(qkv[:, HD:2 * HD], cos, sin, H)
    v = qkv[:, 2 * HD:]
    if quantize:
        k_rows[rows, cur] = quantize(k, heads)
        v_rows[rows, cur] = quantize(v, heads)
    else:
        k_rows[rows, cur] = k.to(k_rows.dtype)
        v_rows[rows, cur] = v.to(v_rows.dtype)
    return attend_plain(q, k_rows, v_rows, visible, heads)


def decode_step_plain(packed: dict, emb: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur: Union[int, torch.Tensor],
                      lo: torch.Tensor, positions: torch.Tensor, cfg,
                      heads=None, all_reduce: Optional[Callable] = None
                      ) -> torch.Tensor:
    """Torch version of the step with the kernel's roundings, all variants.

    ``packed`` of any weight tier; emb (B, D); caches (L, B, T, W) bf16,
    kv8 or kv4, row ``cur_b`` of row b written in place; ``cur`` an int, a
    0-d tensor or (B,) positions; lo (B,) first visible slot; positions
    (B,) rope positions.  Returns the pre-final-norm residual (B, D) f32.

    With an int ``cur`` attention runs over rows [0, cur]; with a tensor it
    runs over all T rows under the mask [lo_b, cur_b], so that no position
    is read back from the device.

    A tensor-parallel rank (the plain version of :meth:`DecodeStep.tp`)
    passes its slabs (:func:`shard_packed`), caches of its ``heads``
    (:class:`Heads`) and ``all_reduce``, which sums the rank's partial
    (B, D) f32 after ``wo`` and after ``down`` over the ranks (in place,
    returns it) before the residual adds it.
    """
    heads = heads or cfg
    reduce = all_reduce or (lambda t: t)
    I, eps = packed["wgu"].shape[1] // 2, cfg.rms_norm_eps
    B, T = emb.shape[0], k_cache.shape[2]
    dev = emb.device

    def mm(a, name, li):
        scale = packed.get("s" + name[1:])
        return _mm(a, packed[name][li], None if scale is None else scale[li])

    cos, sin = rope_rows(cfg, positions)
    if isinstance(cur, torch.Tensor):
        Tv = T
        cur_rows = cur.to(device=dev, dtype=torch.long).expand(B)
    else:
        Tv = cur + 1
        cur_rows = torch.full((B,), cur, dtype=torch.long, device=dev)
    x = emb.to(torch.float32)
    for li in range(packed["wqkv"].shape[0]):
        qkv = mm(_rms(x, packed["ln1"][li], eps), "wqkv", li)
        o = attend_layer_plain(qkv, cos, sin, k_cache[li, :, :Tv],
                               v_cache[li, :, :Tv], cur_rows, lo, heads)
        x = x + reduce(mm(o, "wo", li))
        gu = mm(_rms(x, packed["ln2"][li], eps), "wgu", li)
        g, u = gu[:, :I], gu[:, I:]
        x = x + reduce(mm(g * torch.sigmoid(g) * u, "wd", li))
    return x


@dataclass(frozen=True)
class Heads:
    """The attention geometry of one tensor-parallel rank: its share of the
    heads, their width and the layer count.  It stands in for the config
    wherever a cache format or the attention reads heads (``kv_quant``,
    :func:`attend_plain`, ``llama.KVCache.create``): a config with fewer
    heads would derive another ``head_dim`` from its ``hidden_size``."""

    num_attention_heads: int
    head_dim: int
    num_hidden_layers: int


def local_heads(cfg, tp: int) -> Heads:
    """The heads of one rank of ``tp``; raises unless ``tp`` divides both
    the heads and the MLP's intermediate width."""
    H, I = cfg.num_attention_heads, cfg.intermediate_size
    if tp < 1 or H % tp or I % tp:
        raise ValueError(f"tp={tp} must divide the {H} heads and the "
                         f"intermediate size {I}")
    return Heads(H // tp, cfg.head_dim, cfg.num_hidden_layers)


def shard_packed(packed: dict, cfg, tp: int, rank: int) -> dict:
    """Rank ``rank`` of ``tp``'s slabs of bf16 packed weights: the q, k and
    v rows of its heads in ``wqkv`` ([q | k | v] of them, (L, 3 HD/tp, D)),
    the gate and up rows of its slice of I in ``wgu`` ((L, 2 I/tp, D)), and
    its columns of ``wo`` (L, D, HD/tp) and ``wd`` (L, D, I/tp); the norms
    whole.  The JAX package's specs shard the same axes (heads of (D, 3, H,
    Dh), columns of (D, 2, I), rows of wo and down).  Quantized tiers do
    not shard: an int8 scale group spans D rows of the contraction, which
    wo's HD/tp does not hold."""
    if weight_bits_of(packed, cfg):
        raise ValueError("quantized weights do not shard over tp: their "
                         "scale groups span the whole contraction")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    heads = local_heads(cfg, tp)
    HD, I = cfg.num_attention_heads * cfg.head_dim, cfg.intermediate_size
    hl, il = heads.num_attention_heads * heads.head_dim, I // tp

    def rows(w, width, part):
        return torch.cat([w[:, j * width + rank * part:
                            j * width + (rank + 1) * part]
                          for j in range(w.shape[1] // width)], dim=1)

    return {"wqkv": rows(packed["wqkv"], HD, hl).contiguous(),
            "wgu": rows(packed["wgu"], I, il).contiguous(),
            "wo": packed["wo"][:, :, rank * hl:(rank + 1) * hl].contiguous(),
            "wd": packed["wd"][:, :, rank * il:(rank + 1) * il].contiguous(),
            "ln1": packed["ln1"], "ln2": packed["ln2"]}


def _check_kv4_kernel(cfg) -> None:
    """What ``kv4_append_kernel`` takes beyond kv4 rows: an even head count
    and Dh 64 or 128 (a lane holds a feature and its rope partner)."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    if H % 2 or Dh not in (64, 128):
        raise ValueError(f"the kv4 append kernel needs an even head count "
                         f"and a head dim of 64 or 128, not H {H}, Dh {Dh}")


class DecodeStep:
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``variant_launches`` counts kernel launches (one per step)
    under the variant's name; ``launches`` is their sum and can be set to 0.
    """

    def __init__(self, defines: tuple = ()):
        """``defines`` (``-DNAME=v``, such as ``-DATTN_CHUNK=32``) build a
        library of their own, to compare attention chunk sizes and grids on
        the card."""
        self.variant_launches = dict.fromkeys(VARIANTS, 0)
        self.gemv_launches = 0  # launches of the one-gemv entry
        # gemvs that read rows another kernel prepared (4 L a step: the
        # rows pass, the finishers and gate/up build them), and gemvs that
        # built their own rows (every call of the one-gemv entry)
        self.gemv_prepared = 0
        self.gemv_rebuilt = 0
        self.rows_launches = 0  # launches of the one-rows-pass entry
        self.gemv_rows_launches = 0  # launches of the step-gemv entry
        self.kv4_append_launches = 0  # launches of the one-append entry
        self.attend_launches = 0  # launches of the one-layer attention entry
        # tensor-parallel steps (:meth:`tp`) by variant, one per step
        self.tp_launches = dict.fromkeys(TP_VARIANTS, 0)
        self.library = CudaLibrary("decode_step.cu", defines)
        self._chunk = None
        self._tickets: Dict[tuple, torch.Tensor] = {}
        # gemvs a step of each variant runs, from its last capture
        self._captured_gemvs: Dict[str, int] = {}

    @property
    def launches(self) -> int:
        return sum(self.variant_launches.values())

    @launches.setter
    def launches(self, value: int):
        if value != 0:
            raise ValueError("the launch counts can only be reset to 0")
        self.variant_launches = dict.fromkeys(VARIANTS, 0)

    def _fn(self):
        fn = self.library.get().decode_step_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        return fn

    def gemv(self, x: torch.Tensor, lnw, w: torch.Tensor, scale,
             group: int, out: torch.Tensor, mode: int, add: bool,
             eps: float = 1e-6) -> torch.Tensor:
        """One of the step's gemvs on its own: ``out`` (B, N) f32 becomes
        (``add``: ``out +``) bf16(in') W^T, in' the prologue ``mode``
        (:data:`GEMV_NONE`, :data:`GEMV_RMS` with ``lnw`` (K,) and ``eps``,
        :data:`GEMV_SILU` of x = [gate | up]) of x (B, K) f32 ((B, 2K) for
        silu), W (N, K) bf16, (N, K) int8 or (N, K/2) int4 nibbles with
        ``scale`` (N, K / group) f32.  CUDA tensors launch ``gemv_kernel``
        (counted in ``gemv_launches`` and ``gemv_rebuilt``), after
        ``gemv_kernel_rows`` for the rms and silu prologues, which builds
        the bf16 rows in scratch of its own; CPU tensors take
        :func:`gemv_plain`; returns ``out``.  The step does not call this:
        it is the kernel's entry for tests, timing and the tensor-parallel
        step."""
        K, bits = _gemv_geometry(x, lnw, w, scale, group, out, mode)
        tensors = [t for t in (x, lnw, w, scale, out) if t is not None]
        if any(t.device != x.device for t in tensors):
            raise ValueError("the gemv's tensors must be on one device")
        if x.device.type == "cpu":
            out.copy_(gemv_plain(x, lnw, w, scale, group, out, mode, add,
                                 eps))
            return out
        if x.device.type != "cuda":
            raise ValueError(f"the gemv runs on cuda or cpu, not {x.device}")
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in tensors):
            raise ValueError("the gemv's tensors must be contiguous and "
                             "16-byte aligned")
        fn = self.library.get().decode_step_gemv
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        rows = (None if mode == GEMV_NONE else
                torch.empty((x.shape[0], K), dtype=torch.bfloat16,
                            device=x.device))
        stream = torch.cuda.current_stream(x.device)
        err = fn(x.data_ptr(), x.shape[1],
                 None if lnw is None else lnw.data_ptr(), w.data_ptr(),
                 scale.data_ptr() if bits else None, group if bits else 1,
                 out.data_ptr(), out.shape[1],
                 None if rows is None else rows.data_ptr(), x.shape[0], K,
                 w.shape[0], mode, int(bool(add)), bits, eps,
                 stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_gemv failed with CUDA error "
                               f"{err}")
        self.gemv_launches += 1
        self.gemv_rebuilt += 1
        return out

    def rows(self, x: torch.Tensor, lnw, mode: int,
             eps: float = 1e-6) -> torch.Tensor:
        """The rows pass on its own: the bf16 rows (B, K) that a gemv with
        the prologue ``mode`` (:data:`GEMV_RMS` with ``lnw`` (K,), or
        :data:`GEMV_SILU` of x = [gate | up]) multiplies, from x (B, K)
        f32 ((B, 2K) for silu).  CUDA tensors launch ``gemv_kernel_rows``
        (counted in ``rows_launches``), CPU tensors take
        :func:`gemv_rows_plain`.  The kernel's entry for tests: the step
        runs the same pass on its layer-0 rows."""
        if mode not in (GEMV_RMS, GEMV_SILU):
            raise ValueError(f"the rows pass builds rms (1) or silu (2) "
                             f"rows, not mode {mode}")
        if x.ndim != 2 or x.dtype != torch.float32:
            raise ValueError("x must be a (B, K) float32 tensor, (B, 2K) for "
                             "silu")
        B = x.shape[0]
        K = x.shape[1] // 2 if mode == GEMV_SILU else x.shape[1]
        if not 1 <= B <= MAX_ROWS or K < 8 or K % 8 or (
                mode == GEMV_SILU and x.shape[1] != 2 * K):
            raise ValueError(f"the rows pass takes 1 to {MAX_ROWS} rows and "
                             f"K a multiple of 8, not x {tuple(x.shape)}")
        if mode == GEMV_RMS and (lnw is None or lnw.dtype != torch.float32
                                 or tuple(lnw.shape) != (K,)
                                 or lnw.device != x.device):
            raise ValueError(f"lnw must be ({K},) float32 beside x")
        if x.device.type == "cpu":
            return gemv_rows_plain(x, lnw, mode, eps)
        if x.device.type != "cuda":
            raise ValueError(f"the rows pass runs on cuda or cpu, not "
                             f"{x.device}")
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in (x, lnw) if t is not None):
            raise ValueError("the rows pass's tensors must be contiguous "
                             "and 16-byte aligned")
        rows = torch.empty((B, K), dtype=torch.bfloat16, device=x.device)
        fn = self.library.get().decode_step_rows
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_float,
                                               ctypes.c_void_p])
        stream = torch.cuda.current_stream(x.device)
        err = fn(x.data_ptr(), x.shape[1],
                 None if lnw is None else lnw.data_ptr(), rows.data_ptr(), B,
                 K, mode, eps, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_rows failed with CUDA error "
                               f"{err}")
        self.rows_launches += 1
        return rows

    def gemv_on_rows(self, rows: torch.Tensor, w: torch.Tensor, scale,
                     group: int, out, epilogue: str, lnw=None,
                     eps: float = 1e-6):
        """One gemv as the step launches it, on prepared bf16 ``rows``
        (B, K), y = rows W^T, W and ``scale`` as :meth:`gemv` takes them.
        ``epilogue`` (:data:`GEMV_EPILOGUES`): "store" writes y into
        ``out`` (B, N) f32, "add" adds it; "norm" adds it and returns the
        rms rows of the new ``out`` with ``lnw`` (N,) (bf16 (B, N), built
        by the launch's last block of each row group); "silu" returns
        bf16 (B, N/2) silu(y[:, :N/2]) * y[:, N/2:] (``out`` None).  CUDA
        tensors launch ``gemv_kernel`` (counted in
        ``gemv_rows_launches``), CPU tensors take :func:`_mm` and
        :func:`gemv_rows_plain`.  Returns ``out`` or the rows built.  The
        kernel's entry for tests: the step runs the same launches."""
        if epilogue not in GEMV_EPILOGUES:
            raise ValueError(f"epilogue must be one of "
                             f"{sorted(GEMV_EPILOGUES)}, not {epilogue!r}")
        if rows.ndim != 2 or rows.dtype != torch.bfloat16:
            raise ValueError("rows must be a (B, K) bf16 tensor")
        B, K = rows.shape
        probe = torch.empty((B, w.shape[0] if w.ndim == 2 else 0),
                            device="meta")
        _gemv_geometry(torch.empty((B, K), device="meta"), None, w, scale,
                       group, probe, GEMV_NONE)
        N = w.shape[0]
        if epilogue == "silu":
            if out is not None or N % 2:
                raise ValueError("the silu epilogue takes an even N and no "
                                 "out")
        elif (out is None or tuple(out.shape) != (B, N)
              or out.dtype != torch.float32):
            raise ValueError(f"out must be ({B}, {N}) float32")
        if epilogue == "norm" and (
                lnw is None or tuple(lnw.shape) != (N,)
                or lnw.dtype != torch.float32 or N % 8):
            raise ValueError(f"the norm epilogue takes lnw ({N},) float32 "
                             f"and N a multiple of 8")
        tensors = [t for t in (rows, w, scale, out, lnw) if t is not None]
        if any(t.device != rows.device for t in tensors):
            raise ValueError("the gemv's tensors must be on one device")
        bits = 0 if w.dtype == torch.bfloat16 else (8 if w.shape[1] == K
                                                     else 4)
        if rows.device.type == "cpu":
            y = _mm(rows.float(), w, scale if bits else None)
            if epilogue == "silu":
                return gemv_rows_plain(y, None, GEMV_SILU)
            out.copy_(y if epilogue == "store" else out + y)
            return (gemv_rows_plain(out, lnw, GEMV_RMS, eps)
                    if epilogue == "norm" else out)
        if rows.device.type != "cuda":
            raise ValueError(f"the gemv runs on cuda or cpu, not "
                             f"{rows.device}")
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in tensors):
            raise ValueError("the gemv's tensors must be contiguous and "
                             "16-byte aligned")
        dev = rows.device
        built = None
        if epilogue in ("norm", "silu"):
            width = N // 2 if epilogue == "silu" else N
            built = torch.empty((B, width), dtype=torch.bfloat16, device=dev)
        tickets = (torch.zeros(-(-B // 32), dtype=torch.int32, device=dev)
                   if epilogue == "norm" else None)
        fn = self.library.get().decode_step_gemv_rows
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        stream = torch.cuda.current_stream(dev)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(rows.data_ptr(), w.data_ptr(), ptr(scale if bits else None),
                 group if bits else 1, ptr(out), ptr(built), ptr(lnw),
                 ptr(tickets), B, K, N, GEMV_EPILOGUES[epilogue], bits, eps,
                 stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_gemv_rows failed with CUDA "
                               f"error {err}")
        self.gemv_rows_launches += 1
        return out if built is None else built

    def kv4_append(self, qkv: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, k_rows: torch.Tensor,
                   v_rows: torch.Tensor, cur: torch.Tensor, lo: torch.Tensor,
                   cfg) -> None:
        """The step's kv4 append on its own, for one layer: qkv (B, 3 HD)
        f32, cos/sin (B, Dh) f32, caches (B, T, HD/2 + KV_PAD) int8
        written in place, cur and lo (B,).  CUDA tensors launch
        ``kv4_append_kernel`` (counted in ``kv4_append_launches``), CPU
        tensors take :func:`kv4_append_plain`.  The step does not call
        this: it is the kernel's entry for tests and timing."""
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        B, HD = qkv.shape[0], H * Dh
        T = k_rows.shape[1]
        if (tuple(qkv.shape) != (B, 3 * HD) or qkv.dtype != torch.float32
                or tuple(cos.shape) != (B, Dh) or cos.shape != sin.shape
                or k_rows.dtype != torch.int8 or k_rows.shape != v_rows.shape
                or tuple(k_rows.shape) != (B, T, row_width(4, cfg))
                or tuple(cur.shape) != (B,) or tuple(lo.shape) != (B,)):
            raise ValueError("kv4_append takes qkv (B, 3 HD) f32, cos/sin "
                             "(B, Dh), caches (B, T, HD/2 + KV_PAD) int8, "
                             "cur and lo (B,)")
        tensors = (qkv, cos, sin, k_rows, v_rows, cur, lo)
        if any(t.device != qkv.device for t in tensors):
            raise ValueError("kv4_append's tensors must be on one device")
        if qkv.device.type == "cpu":
            kv4_append_plain(qkv, cos, sin, k_rows, v_rows, cur, lo, cfg)
            return
        if qkv.device.type != "cuda":
            raise ValueError(f"kv4_append runs on cuda or cpu, not "
                             f"{qkv.device}")
        _check_kv4_kernel(cfg)
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in (qkv, cos, sin, k_rows, v_rows)):
            raise ValueError("kv4_append's tensors must be contiguous and "
                             "16-byte aligned")
        cur32 = cur.to(torch.int32).contiguous()
        lo32 = lo.to(torch.int32).contiguous()
        fn = self.library.get().decode_step_kv4_append
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        stream = torch.cuda.current_stream(qkv.device)
        err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 k_rows.data_ptr(), v_rows.data_ptr(), cur32.data_ptr(),
                 lo32.data_ptr(), B, T, H, Dh, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_kv4_append failed with CUDA "
                               f"error {err}")
        self.kv4_append_launches += 1

    def attend(self, qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               k_rows: torch.Tensor, v_rows: torch.Tensor, cur: torch.Tensor,
               lo: torch.Tensor, o: torch.Tensor, heads) -> torch.Tensor:
        """One layer's attention on its own, as the step runs it: qkv
        (B, 3 HD) f32 from the qkv gemv, cos/sin (B, Dh) f32, the layer's
        caches (B, T, W) of any tier with row ``cur[b]`` of row b appended,
        cur and lo (B,); ``o`` (B, HD) f32 receives the output.  ``heads``
        is the config or a tensor-parallel rank's :class:`Heads`.  CUDA
        tensors launch the kv4 append (int4 cache) and the attention pair
        through ``decode_step_attend`` (counted in ``attend_launches``),
        CPU tensors take :func:`attend_layer_plain`; returns ``o``."""
        H, Dh = heads.num_attention_heads, heads.head_dim
        B, HD = qkv.shape[0], H * Dh
        T = k_rows.shape[1]
        kvb = _check_caches(k_rows[None], v_rows[None], heads)
        if (tuple(qkv.shape) != (B, 3 * HD) or qkv.dtype != torch.float32
                or tuple(cos.shape) != (B, Dh) or cos.shape != sin.shape
                or k_rows.shape[0] != B or tuple(cur.shape) != (B,)
                or tuple(lo.shape) != (B,) or tuple(o.shape) != (B, HD)
                or o.dtype != torch.float32):
            raise ValueError("attend takes qkv (B, 3 HD) f32, cos/sin (B, "
                             "Dh), caches (B, T, W), cur and lo (B,), o "
                             "(B, HD) f32")
        tensors = (qkv, cos, sin, k_rows, v_rows, cur, lo, o)
        if any(t.device != qkv.device for t in tensors):
            raise ValueError("attend's tensors must be on one device")
        if qkv.device.type == "cpu":
            o.copy_(attend_layer_plain(qkv, cos, sin, k_rows, v_rows, cur, lo,
                                       heads))
            return o
        if qkv.device.type != "cuda":
            raise ValueError(f"attend runs on cuda or cpu, not {qkv.device}")
        if kvb == 4:
            _check_kv4_kernel(heads)
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in (qkv, cos, sin, k_rows, v_rows, o)):
            raise ValueError("attend's tensors must be contiguous and "
                             "16-byte aligned")
        cur32 = cur.to(torch.int32).contiguous()
        lo32 = lo.to(torch.int32).contiguous()
        S = -(-T // self.attn_chunk)
        dev = qkv.device
        scores = torch.empty((B, H, T), dtype=torch.float32, device=dev)
        cmax = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        part = torch.empty((B, H, S, Dh + 1), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev)
        fn = self.library.get().decode_step_attend
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 k_rows.data_ptr(), v_rows.data_ptr(), cur32.data_ptr(),
                 lo32.data_ptr(), scores.data_ptr(), cmax.data_ptr(),
                 part.data_ptr(), self.tickets(stream, B * H).data_ptr(),
                 o.data_ptr(), B, T, H, Dh, kvb, 1.0 / float(np.sqrt(Dh)),
                 stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_attend failed with CUDA error "
                               f"{err}")
        self.attend_launches += 1
        return o

    def tp(self, packed: dict, emb: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, cur: torch.Tensor, lo: torch.Tensor,
           positions: torch.Tensor, cfg, heads: Heads,
           all_reduce: Callable) -> torch.Tensor:
        """One decode step on a tensor-parallel rank: its bf16 slabs
        (:func:`shard_packed`), its heads' caches (L, B, T, W) (bf16, kv8 or
        kv4 rows of ``heads``), a position per row ``cur`` (B,), lo and
        positions (B,).  Per layer: the qkv gemv (rms prologue) on its
        heads' rows, :meth:`attend`, the wo gemv into a partial that goes
        through ``all_reduce`` (in place, returns it) and is added to the
        residual, the gate/up gemv (rms) on its slice of I, the down gemv
        (silu) into a partial, ``all_reduce``, added: the same kernels as
        the whole step, launched one by one so the sums can cross ranks.
        Returns the pre-final-norm residual (B, D) f32, equal on every
        rank.  CPU tensors take :func:`decode_step_plain` with ``heads``
        and ``all_reduce``; a CUDA step counts one launch under its variant
        in ``tp_launches``."""
        with profiling.span("decode_step"):
            return self._tp(packed, emb, k_cache, v_cache, cur, lo,
                            positions, cfg, heads, all_reduce)

    def _tp(self, packed, emb, k_cache, v_cache, cur, lo, positions, cfg,
            heads, all_reduce):
        if emb.device.type == "cpu":
            return decode_step_plain(packed, emb, k_cache, v_cache, cur, lo,
                                     positions, cfg, heads, all_reduce)
        if emb.device.type != "cuda":
            raise ValueError(f"the decode step runs on cuda or cpu, not "
                             f"{emb.device}")
        if not isinstance(cur, torch.Tensor) or cur.ndim != 1:
            raise ValueError("the tensor-parallel step takes a position per "
                             "row: cur (B,)")
        D, eps = cfg.hidden_size, cfg.rms_norm_eps
        HD = heads.num_attention_heads * heads.head_dim
        L, B = k_cache.shape[:2]
        I = packed["wgu"].shape[1] // 2
        want = {"wqkv": (L, 3 * HD, D), "wo": (L, D, HD), "wgu": (L, 2 * I, D),
                "wd": (L, D, I)}
        for name, shape in want.items():
            if (tuple(packed[name].shape) != shape
                    or packed[name].dtype != torch.bfloat16):
                raise ValueError(f"packed[{name!r}] must be a bf16 {shape} "
                                 f"slab")
        variant = variant_of(k_cache, cur, cfg=heads)
        dev = emb.device
        x = emb.to(torch.float32).contiguous().clone()
        cos, sin = rope_rows(cfg, positions)
        cos, sin = cos.contiguous(), sin.contiguous()
        # int32 once, so each layer's attend converts nothing
        cur = cur.to(device=dev, dtype=torch.int32).expand(B).contiguous()
        lo = lo.to(device=dev, dtype=torch.int32).contiguous()
        qkv = torch.empty((B, 3 * HD), dtype=torch.float32, device=dev)
        o = torch.empty((B, HD), dtype=torch.float32, device=dev)
        gu = torch.empty((B, 2 * I), dtype=torch.float32, device=dev)
        part = torch.empty((B, D), dtype=torch.float32, device=dev)
        for li in range(L):
            self.gemv(x, packed["ln1"][li], packed["wqkv"][li], None, 1, qkv,
                      GEMV_RMS, False, eps)
            self.attend(qkv, cos, sin, k_cache[li], v_cache[li], cur, lo, o,
                        heads)
            self.gemv(o, None, packed["wo"][li], None, 1, part, GEMV_NONE,
                      False)
            x += all_reduce(part)
            self.gemv(x, packed["ln2"][li], packed["wgu"][li], None, 1, gu,
                      GEMV_RMS, False, eps)
            self.gemv(gu, None, packed["wd"][li], None, 1, part, GEMV_SILU,
                      False)
            x += all_reduce(part)
        self.tp_launches[variant] += 1
        return x

    @property
    def attn_chunk(self) -> int:
        """Keys of a row's window one attention block owns, as the
        library was built (builds it on first use)."""
        if self._chunk is None:
            self._chunk = int(self.library.get().decode_step_attn_chunk())
        return self._chunk

    def tickets(self, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
        """The attention pair's (row, head) tickets for ``stream``, at
        least ``n``: zeros, which every launch leaves zero, so one buffer
        serves every layer and step issued on that stream; steps on two
        streams never share one."""
        key = (stream.device, stream.cuda_stream)
        t = self._tickets.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros(n, dtype=torch.int32, device=stream.device)
            self._tickets[key] = t
        return t

    def replayed(self, variant: str) -> None:
        """Count one replay of a step captured into a CUDA graph under its
        variant, and its gemvs as the variant's last capture ran them: a
        captured launch counts when the graph runs it."""
        self.variant_launches[variant] += 1
        self.gemv_prepared += self._captured_gemvs.get(variant, 0)

    def __call__(self, packed: dict, emb: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cur: Union[int, torch.Tensor], lo: torch.Tensor,
                 positions: torch.Tensor, cfg,
                 tickets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step (module docstring).  ``tickets``: zeroed int32 (row,
        head) counters, at least B * H, for a step captured into a CUDA
        graph, which owns them; None takes the stream's kept ones, which a
        capture must not (the graph would hold them past its life)."""
        with profiling.span("decode_step"):
            return self._step(packed, emb, k_cache, v_cache, cur, lo,
                              positions, cfg, tickets)

    def _step(self, packed, emb, k_cache, v_cache, cur, lo, positions, cfg,
              tickets=None):
        if emb.device.type == "cpu":
            return decode_step_plain(packed, emb, k_cache, v_cache, cur, lo,
                                     positions, cfg)
        if emb.device.type != "cuda":
            raise ValueError(f"the decode step runs on cuda or cpu, not "
                             f"{emb.device}")
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        D, I = cfg.hidden_size, cfg.intermediate_size
        HD = H * Dh
        kvb = _check_caches(k_cache, v_cache, cfg)
        L, B, T, W = k_cache.shape
        dev = emb.device
        wb = weight_bits_of(packed, cfg)
        # values a byte (or a bf16 element) holds, and rows of a scale group
        per = 2 if wb == 4 else 1
        gs = int4_group(D) if wb == 4 else D
        wdt = torch.int8 if wb else torch.bfloat16
        shapes = {"wqkv": (3 * HD, D), "wo": (D, HD), "wgu": (2 * I, D),
                  "wd": (D, I)}
        want = {"ln1": ((L, D), torch.float32), "ln2": ((L, D), torch.float32)}
        for name, (N, K) in shapes.items():
            want[name] = ((L, N, K // per), wdt)
            if wb:
                want["s" + name[1:]] = ((L, N, K // gs), torch.float32)
        for name, (shape, dt) in want.items():
            t = packed.get(name)
            if (t is None or tuple(t.shape) != shape or t.dtype != dt
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"packed[{name!r}] must be a contiguous "
                                 f"{dt} {shape} tensor on {dev}")
        for c in (k_cache, v_cache):
            if c.device != dev or not c.is_contiguous():
                raise ValueError(f"caches must be contiguous tensors on {dev}")
        if kvb and 2 * H > KV_PAD:
            raise ValueError("too many heads for the kv-int8 scale lanes")
        if not 1 <= B <= MAX_ROWS:
            raise ValueError(f"the decode step takes 1 to {MAX_ROWS} rows")
        if D % 8 or I % 8 or Dh % 16 or 128 % Dh:
            raise ValueError("the decode step needs D, I multiples of 8 and "
                             "Dh a multiple of 16 dividing 128")
        if kvb == 4:
            _check_kv4_kernel(cfg)
        if wb and (gs % 32 or D % gs or I % gs):
            raise ValueError(f"the gemv needs scale groups of a multiple of "
                             f"32 rows dividing D and I, not {gs}")
        variant = variant_of(k_cache, cur, packed, cfg)
        if isinstance(cur, torch.Tensor):
            if cur.ndim > 1 or (cur.ndim == 1 and cur.shape[0] != B):
                raise ValueError(f"cur must be one position or (B,) = ({B},)")
            # stays on the device; the kernel poisons out-of-range rows
            cur32 = cur.to(device=dev, dtype=torch.int32).expand(B).contiguous()
        else:
            if not 0 <= cur < T:
                raise ValueError(f"cur {cur} outside the cache length {T}")
            cur32 = torch.full((B,), cur, dtype=torch.int32, device=dev)
        x = emb.to(torch.float32).contiguous().clone()
        if tuple(x.shape) != (B, D):
            raise ValueError(f"emb must be (B, D) = {(B, D)}")
        cos, sin = rope_rows(cfg, positions)
        cos, sin = cos.contiguous(), sin.contiguous()
        lo32 = lo.to(device=dev, dtype=torch.int32).contiguous()
        qkv = torch.empty((B, 3 * HD), dtype=torch.float32, device=dev)
        o = torch.empty((B, HD), dtype=torch.float32, device=dev)
        # the gemvs' prepared bf16 rows: (B, D) normed, then (B, I) silu
        rows = torch.empty(B * (D + I), dtype=torch.bfloat16, device=dev)
        S = -(-T // self.attn_chunk)
        scores = torch.empty((B, H, T), dtype=torch.float32, device=dev)
        cmax = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        part = torch.empty((B, H, S, Dh + 1), dtype=torch.float32, device=dev)
        scales = [packed["s" + name[1:]].data_ptr() if wb else None
                  for name in MATRICES]
        stream = torch.cuda.current_stream(dev)
        capturing = torch.cuda.is_current_stream_capturing()
        if tickets is None:
            if capturing:
                raise ValueError("a captured step takes its graph's own "
                                 "tickets")
            tickets = self.tickets(stream, B * H)
        elif (tickets.dtype != torch.int32 or tickets.device != dev
              or tickets.numel() < B * H):
            raise ValueError(f"tickets must be int32 on {dev}, at least "
                             f"{B * H}")
        err = self._fn()(
            x.data_ptr(), qkv.data_ptr(), o.data_ptr(), rows.data_ptr(),
            *(packed[name].data_ptr() for name in MATRICES), *scales,
            packed["ln1"].data_ptr(), packed["ln2"].data_ptr(),
            cos.data_ptr(), sin.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), cur32.data_ptr(), lo32.data_ptr(),
            scores.data_ptr(), cmax.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, D, H, Dh, I, L, T, kvb, wb, gs,
            cfg.rms_norm_eps, 1.0 / float(np.sqrt(Dh)), stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_launch failed with CUDA error "
                               f"{err}")
        if capturing:
            self._captured_gemvs[variant] = 4 * L
        else:
            self.variant_launches[variant] += 1
            self.gemv_prepared += 4 * L
        return x


decode_step = DecodeStep()
gemv = decode_step.gemv
kv4_append = decode_step.kv4_append
attend = decode_step.attend
decode_step_tp = decode_step.tp
