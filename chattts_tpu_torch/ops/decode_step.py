"""The whole decode step as a hand-written CUDA kernel, in four variants, and
its plain PyTorch version.

This replaces ``chattts_tpu/ops/pallas_step.py::_kernel`` (launched by
``decode_step_fused``) with bf16 weights.  One call runs all L layers of one
autoregressive step and returns the float32 residual *before* the final
norm; the caller applies ``llama.rms_norm``.  As in the reference, the
variant follows from the arguments:

=====  ==========================  =====================================
name   ``cur``                     cache
=====  ==========================  =====================================
k1     one position (int or 0-d)   (L, B, T, HD) bf16
k2     a position per row (B,)     (L, B, T, HD) bf16
k3     one position                (L, B, T, HD + KV_PAD) int8 (kv8 rows)
k2k3   a position per row          (L, B, T, HD + KV_PAD) int8
=====  ==========================  =====================================

* :func:`pack_weights` lays the decoder weights out for the kernel: each
  projection as an (N, K) bf16 matrix, one per layer, stacked over layers.
* :func:`decode_step_plain` is the same arithmetic in torch ops, every
  variant: the CPU path, and the card's reference for the kernel.
* :data:`decode_step` is the wrapper.  A CUDA tensor launches the kernel
  (``csrc/decode_step.cu``) and counts the launch under its variant's name
  in ``decode_step.variant_launches`` (``decode_step.launches`` is their
  sum); a CPU tensor takes the plain version.  There is no fallback from
  one to the other.

The caches are updated in place (the TPU kernel aliases them too): only row
``cur_b`` of row b of every layer is written.  The kv8 row format and its
quantizer are ``ops/kv_quant.py``'s; rows appended here and rows quantized
at the prefill dequantize alike.  A position on the device is never read
back: the kernel takes ``cur`` as a device array, and a position outside
``[0, T)`` turns that row's result into NaN instead of being clamped.

Bound on an H100 at the full config: every weight is read once a step,
L*(4*D*D + 3*D*I)*2 = 377 MB, ~113 us at 3.35 TB/s, plus the KV read of
2*L*sum_b(cur_b-lo_b+1)*W bytes and the appended rows 2*L*B*W, with W =
2*HD (bf16) or HD + KV_PAD (kv8).  The kernel's design is described at the
top of ``csrc/decode_step.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Union

import numpy as np
import torch

from ._build import CudaLibrary
from .kv_quant import KV_PAD, kv8_quantize, row_scales

NEG = -1e30  # masked-score value of the TPU kernel
MAX_ROWS = 32  # batch rows a step takes (kMaxB in csrc/decode_step.cu)
VARIANTS = ("k1", "k2", "k3", "k2k3")


def pack_weights(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """The decoder's parameter tree -> the kernel's layout.

    Returns {"wqkv": (L, 3*HD, D), "wo": (L, D, HD), "wgu": (L, 2*I, D),
    "wd": (L, D, I)} bf16 with K contiguous in every matrix (rows of wgu are
    [gate | up]), and {"ln1", "ln2"}: (L, D) f32.  Tensors stay on the
    device of ``params``.
    """
    D, I = cfg.hidden_size, cfg.intermediate_size
    HD = cfg.num_attention_heads * cfg.head_dim
    layers = params["layers"]

    def stack(fn, dtype):
        return torch.stack([fn(lp) for lp in layers]).to(dtype).contiguous()

    return {
        "wqkv": stack(lambda lp: lp["attn"]["wqkv"].reshape(D, 3 * HD).T,
                      torch.bfloat16),
        "wo": stack(lambda lp: lp["attn"]["wo"].T, torch.bfloat16),
        "wgu": stack(lambda lp: lp["mlp"]["wgu"].reshape(D, 2 * I).T,
                     torch.bfloat16),
        "wd": stack(lambda lp: lp["mlp"]["down"].T, torch.bfloat16),
        "ln1": stack(lambda lp: lp["ln1"], torch.float32),
        "ln2": stack(lambda lp: lp["ln2"], torch.float32),
    }


def rope_rows(cfg, positions: torch.Tensor):
    """cos/sin (B, Dh) f32 at each row's rope position."""
    from ..models.llama import rope_tables_torch

    cos_t, sin_t = rope_tables_torch(cfg, positions.device)
    return cos_t[positions], sin_t[positions]


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (exact bf16 products in f32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, K) f32 x (N, K) bf16 -> (B, N) f32: bf16 inputs, f32 sums."""
    return _bf(a) @ w.to(torch.float32).T


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w[None, :]


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


def variant_of(k_cache: torch.Tensor, cur) -> str:
    """The variant's name, from the arguments as the reference picks it."""
    per_slot = isinstance(cur, torch.Tensor) and cur.ndim == 1
    kv8 = k_cache.dtype == torch.int8
    return {(False, False): "k1", (True, False): "k2", (False, True): "k3",
            (True, True): "k2k3"}[(per_slot, kv8)]


def _check_cache_width(k_cache: torch.Tensor, v_cache: torch.Tensor, HD: int):
    """Raise unless both caches are bf16 HD wide or int8 HD + KV_PAD wide."""
    for c in (k_cache, v_cache):
        want = {torch.bfloat16: HD, torch.int8: HD + KV_PAD}.get(c.dtype)
        if want is None or c.ndim != 4 or c.shape[3] != want:
            raise ValueError(
                f"caches must be (L, B, T, {HD}) bf16 or (L, B, T, "
                f"{HD + KV_PAD}) int8, not {tuple(c.shape)} {c.dtype}")
    if k_cache.dtype != v_cache.dtype or k_cache.shape != v_cache.shape:
        raise ValueError("k and v caches differ in type or shape")


def attend_plain(q: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor,
                 visible: torch.Tensor, cfg, k_scales=None, v_scales=None,
                 round_p=_bf) -> torch.Tensor:
    """One layer's attention with the kernel's roundings: roped q (B, HD)
    f32 against cache rows kr/vr (B, Tv, W), bf16 or kv8, under the mask
    ``visible`` (B, 1, Tv); returns o (B, HD) f32.

    ``k_scales``/``v_scales`` (B, H, Tv) stand in for the scales embedded in
    kv8 rows and ``round_p`` for the numerator's bf16 rounding: a check that
    plants a fault in this arithmetic passes them, the step never does.
    """
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD, (B, Tv) = H * Dh, kr.shape[:2]
    kv8 = kr.dtype == torch.int8
    qs = _bf(q * (1.0 / float(np.sqrt(Dh)))).reshape(B, H, Dh)
    keys = kr[..., :HD].to(torch.float32).reshape(B, Tv, H, Dh)
    vals = vr[..., :HD].to(torch.float32).reshape(B, Tv, H, Dh)
    s = torch.einsum("bhd,bthd->bht", qs, keys)
    if kv8:  # the key's scale after the product
        s = s * (row_scales(kr, cfg).transpose(1, 2) if k_scales is None
                 else k_scales)
    s = torch.where(visible, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if kv8:  # the value's scale goes into p before its bf16 rounding
        num = round_p(p * (row_scales(vr, cfg).transpose(1, 2)
                           if v_scales is None else v_scales))
    else:
        num = round_p(p)
    o = torch.einsum("bht,bthd->bhd", num, vals) / p.sum(-1)[..., None]
    return o.reshape(B, HD)


def decode_step_plain(packed: dict, emb: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur: Union[int, torch.Tensor],
                      lo: torch.Tensor, positions: torch.Tensor, cfg
                      ) -> torch.Tensor:
    """Torch version of the step with the kernel's roundings, all variants.

    emb (B, D); caches (L, B, T, W) bf16 or kv8 int8, row ``cur_b`` of row
    b written in place; ``cur`` an int, a 0-d tensor or (B,) positions;
    lo (B,) first visible slot; positions (B,) rope positions.  Returns the
    pre-final-norm residual (B, D) f32.

    With an int ``cur`` attention runs over rows [0, cur]; with a tensor it
    runs over all T rows under the mask [lo_b, cur_b], so that no position
    is read back from the device.
    """
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD, I, eps = H * Dh, cfg.intermediate_size, cfg.rms_norm_eps
    _check_cache_width(k_cache, v_cache, HD)
    kv8 = k_cache.dtype == torch.int8
    B, T = emb.shape[0], k_cache.shape[2]
    dev = emb.device
    cos, sin = rope_rows(cfg, positions)
    if isinstance(cur, torch.Tensor):
        Tv = T
        cur_rows = cur.to(device=dev, dtype=torch.long).expand(B)
    else:
        Tv = cur + 1
        cur_rows = torch.full((B,), cur, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    t = torch.arange(Tv, device=dev)
    visible = ((t[None, :] >= lo[:, None].to(dev))
               & (t[None, :] <= cur_rows[:, None]))[:, None, :]  # (B, 1, Tv)
    x = emb.to(torch.float32)
    for li in range(packed["wqkv"].shape[0]):
        qkv = _mm(_rms(x, packed["ln1"][li], eps), packed["wqkv"][li])
        q = _rope(qkv[:, :HD], cos, sin, H)
        k = _rope(qkv[:, HD:2 * HD], cos, sin, H)
        v = qkv[:, 2 * HD:]
        if kv8:  # the f32 roped k and the f32 v are quantized
            k_cache[li, rows, cur_rows] = kv8_quantize(k, cfg)
            v_cache[li, rows, cur_rows] = kv8_quantize(v, cfg)
        else:
            k_cache[li, rows, cur_rows] = k.to(k_cache.dtype)
            v_cache[li, rows, cur_rows] = v.to(v_cache.dtype)
        o = attend_plain(q, k_cache[li, :, :Tv], v_cache[li, :, :Tv],
                         visible, cfg)
        x = x + _mm(o, packed["wo"][li])
        gu = _mm(_rms(x, packed["ln2"][li], eps), packed["wgu"][li])
        g, u = gu[:, :I], gu[:, I:]
        x = x + _mm(g * torch.sigmoid(g) * u, packed["wd"][li])
    return x


class DecodeStep:
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``variant_launches`` counts kernel launches (one per step)
    under the variant's name; ``launches`` is their sum and can be set to 0.
    """

    def __init__(self):
        self.variant_launches = dict.fromkeys(VARIANTS, 0)
        self.library = CudaLibrary("decode_step.cu")

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
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        return fn

    def __call__(self, packed: dict, emb: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cur: Union[int, torch.Tensor], lo: torch.Tensor,
                 positions: torch.Tensor, cfg) -> torch.Tensor:
        if emb.device.type == "cpu":
            return decode_step_plain(packed, emb, k_cache, v_cache, cur, lo,
                                     positions, cfg)
        if emb.device.type != "cuda":
            raise ValueError(f"the decode step runs on cuda or cpu, not "
                             f"{emb.device}")
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        D, I = cfg.hidden_size, cfg.intermediate_size
        HD = H * Dh
        _check_cache_width(k_cache, v_cache, HD)
        L, B, T, W = k_cache.shape
        dev = emb.device
        want = {"wqkv": (L, 3 * HD, D), "wo": (L, D, HD), "wgu": (L, 2 * I, D),
                "wd": (L, D, I), "ln1": (L, D), "ln2": (L, D)}
        for name, shape in want.items():
            t = packed[name]
            dt = torch.float32 if name.startswith("ln") else torch.bfloat16
            if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(f"packed[{name!r}] must be a contiguous "
                                 f"{dt} {shape} tensor on {dev}")
        for c in (k_cache, v_cache):
            if c.device != dev or not c.is_contiguous():
                raise ValueError(f"caches must be contiguous tensors on {dev}")
        kv8 = k_cache.dtype == torch.int8
        if kv8 and 2 * H > KV_PAD:
            raise ValueError("too many heads for the kv-int8 scale lanes")
        if not 1 <= B <= MAX_ROWS:
            raise ValueError(f"the decode step takes 1 to {MAX_ROWS} rows")
        if D % 8 or I % 8 or HD % 8 or 128 % Dh:
            raise ValueError("the decode step needs D, I, HD multiples of 8 "
                             "and Dh dividing 128")
        variant = variant_of(k_cache, cur)
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
        gu = torch.empty((B, 2 * I), dtype=torch.float32, device=dev)
        err = self._fn()(
            x.data_ptr(), qkv.data_ptr(), o.data_ptr(), gu.data_ptr(),
            packed["wqkv"].data_ptr(), packed["wo"].data_ptr(),
            packed["wgu"].data_ptr(), packed["wd"].data_ptr(),
            packed["ln1"].data_ptr(), packed["ln2"].data_ptr(),
            cos.data_ptr(), sin.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), cur32.data_ptr(), lo32.data_ptr(),
            B, D, H, Dh, I, L, T, int(kv8),
            cfg.rms_norm_eps, 1.0 / float(np.sqrt(Dh)),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_step_launch failed with CUDA error "
                               f"{err}")
        self.variant_launches[variant] += 1
        return x


decode_step = DecodeStep()
