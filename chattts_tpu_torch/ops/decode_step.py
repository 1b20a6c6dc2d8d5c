"""K1: the whole decode step as a hand-written CUDA kernel, and its plain
PyTorch version.

This replaces ``chattts_tpu/ops/pallas_step.py::_kernel`` (launched by
``decode_step_fused``) in the configuration with bf16 weights, a bf16 KV
cache and one shared write position ``cur``.  One call runs all L layers of
one autoregressive step and returns the float32 residual *before* the final
norm; the caller applies ``llama.rms_norm``.

* :func:`pack_weights` lays the decoder weights out for the kernel: each
  projection as an (N, K) bf16 matrix, one per layer, stacked over layers.
* :func:`decode_step_plain` is the same arithmetic in torch ops: the CPU
  path, and the card's reference for the kernel.
* :data:`decode_step` is the wrapper.  A CUDA tensor launches the kernel
  (``csrc/decode_step.cu``) and counts the launch in ``decode_step.launches``;
  a CPU tensor takes the plain version.  There is no fallback from one to
  the other.

The caches are updated in place (the TPU kernel aliases them too): only row
``cur`` of every layer is written.

Bound on an H100 at the full config: every weight is read once a step,
L*(4*D*D + 3*D*I)*2 = 377 MB, ~113 us at 3.35 TB/s, plus the KV read of
2*L*B*(cur-lo+1)*HD*2 bytes.  The kernel's design is described at the top
of ``csrc/decode_step.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ._build import CudaLibrary

NEG = -1e30  # masked-score value of the TPU kernel


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


def decode_step_plain(packed: dict, emb: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur: int, lo: torch.Tensor,
                      positions: torch.Tensor, cfg) -> torch.Tensor:
    """Torch version of K1 with the kernel's roundings.

    emb (B, D); caches (L, B, T, HD) bf16, row ``cur`` written in place;
    lo (B,) first visible slot; positions (B,) rope positions.  Returns the
    pre-final-norm residual (B, D) f32.
    """
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD, I, eps = H * Dh, cfg.intermediate_size, cfg.rms_norm_eps
    B = emb.shape[0]
    scale = 1.0 / float(np.sqrt(Dh))
    cos, sin = rope_rows(cfg, positions)
    t = torch.arange(cur + 1, device=emb.device)
    visible = (t[None, :] >= lo[:, None])[:, None, :]  # (B, 1, cur + 1)
    x = emb.to(torch.float32)
    for li in range(packed["wqkv"].shape[0]):
        qkv = _mm(_rms(x, packed["ln1"][li], eps), packed["wqkv"][li])
        q = _rope(qkv[:, :HD], cos, sin, H)
        k = _rope(qkv[:, HD:2 * HD], cos, sin, H)
        k_cache[li, :, cur] = k.to(k_cache.dtype)
        v_cache[li, :, cur] = qkv[:, 2 * HD:].to(v_cache.dtype)
        qs = _bf(q * scale).reshape(B, H, Dh)
        keys = k_cache[li, :, :cur + 1].to(torch.float32).reshape(
            B, cur + 1, H, Dh)
        vals = v_cache[li, :, :cur + 1].to(torch.float32).reshape(
            B, cur + 1, H, Dh)
        s = torch.einsum("bhd,bthd->bht", qs, keys)
        s = torch.where(visible, s, torch.full_like(s, NEG))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bht,bthd->bhd", _bf(p), vals) / p.sum(-1)[..., None]
        x = x + _mm(o.reshape(B, HD), packed["wo"][li])
        gu = _mm(_rms(x, packed["ln2"][li], eps), packed["wgu"][li])
        g, u = gu[:, :I], gu[:, I:]
        x = x + _mm(g * torch.sigmoid(g) * u, packed["wd"][li])
    return x


class K1DecodeStep:
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``launches`` counts kernel launches (one per step)."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("decode_step.cu")

    def _fn(self):
        fn = self.library.get().k1_decode_step
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        return fn

    def __call__(self, packed: dict, emb: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, cur: int,
                 lo: torch.Tensor, positions: torch.Tensor, cfg
                 ) -> torch.Tensor:
        if emb.device.type == "cpu":
            return decode_step_plain(packed, emb, k_cache, v_cache, cur, lo,
                                     positions, cfg)
        if emb.device.type != "cuda":
            raise ValueError(f"K1 runs on cuda or cpu, not {emb.device}")
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        D, I = cfg.hidden_size, cfg.intermediate_size
        HD = H * Dh
        L, B, T, _ = k_cache.shape
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
            if (c.dtype != torch.bfloat16 or tuple(c.shape) != (L, B, T, HD)
                    or c.device != dev or not c.is_contiguous()):
                raise ValueError("caches must be contiguous bf16 "
                                 f"(L, B, T, HD) tensors on {dev}")
        if not 1 <= B <= 16:
            raise ValueError("K1 takes 1 to 16 rows")
        if not 0 <= cur < T:
            raise ValueError(f"cur {cur} outside the cache length {T}")
        if D % 8 or I % 8 or HD % 8 or 128 % Dh:
            raise ValueError("K1 needs D, I, HD multiples of 8 and Dh "
                             "dividing 128")
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
            v_cache.data_ptr(), lo32.data_ptr(),
            cur, B, D, H, Dh, I, L, T,
            cfg.rms_norm_eps, 1.0 / float(np.sqrt(Dh)),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"k1_decode_step failed with CUDA error {err}")
        self.launches += 1
        return x


decode_step = K1DecodeStep()
