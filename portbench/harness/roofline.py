"""The least time of the decode step's kernels on an H100, from shapes.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; operations are 2 B N K a matrix product and 4 x the
visible rows x H Dh for attention (scores and values).  The peaks are
NVIDIA's published figures for the H100 SXM (dense, no sparsity) at its
700 W limit; the card's own limit is printed beside every run.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
KV_PAD = 128                # scale lanes and pad of a kv8 or kv4 cache row


def int4_group(D: int) -> int:
    """Input rows of an int4 scale group: 128, or D/2 where D/2 is not a
    multiple of 128."""
    return 128 if (D // 2) % 128 == 0 else D // 2


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for both."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kv_row_bytes(cfg: dict, kv_bits: int) -> Tuple[int, int]:
    """(bytes of a cache row, bytes of it attention reads): 2 HD bf16; a
    kv8 or kv4 row's values and its 2 H scale bytes, one 32-byte sector."""
    H = cfg["num_attention_heads"]
    HD = cfg["hidden_size"]
    if not kv_bits:
        return 2 * HD, 2 * HD
    qw = HD if kv_bits == 8 else HD // 2
    return qw + KV_PAD, qw + -(-2 * H // 32) * 32


def gemv_work(B, N, K, weight_bits, group, in_floats, adds, norm
              ) -> Tuple[float, float]:
    """(bytes, operations) of one gemv: its weights (2, 1 or 1/2 bytes a
    value) and f32 scales, its B f32 input rows of ``in_floats`` values
    and the norm's K weights, its output rows (read too where it adds)."""
    wb = {0: 2, 8: 1, 4: 0.5}[weight_bits]
    scales = N * (K // group) * 4 if weight_bits else 0
    return (N * K * wb + scales + B * in_floats * 4 + (K * 4 if norm else 0)
            + B * N * 4 * (2 if adds else 1), 2 * B * N * K)


def kernel_bounds(cfg: dict, seen: List[int], kv_bits: int, weight_bits: int
                  ) -> Dict[str, Tuple[float, str]]:
    """Least time of one launch of each of a layer's kernels, for B rows
    that see ``seen[b]`` keys each (the appended one included): the four
    gemvs, the attention pair (its visible rows, q, cos and sin, its
    appended rows on bf16 and kv8, o) and, on kv4, the append."""
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    H = cfg["num_attention_heads"]
    Dh = D // H
    HD = H * Dh
    B, rows = len(seen), sum(seen)
    live = sum(1 for n in seen if n > 0)
    row_bytes, read_bytes = kv_row_bytes(cfg, kv_bits)
    group = {0: None, 8: D, 4: int4_group(D)}[weight_bits]

    def gemv(N, K, in_floats, adds, norm):
        return gemv_work(B, N, K, weight_bits, group, in_floats, adds, norm)

    rope = 2 * B * Dh * 4 + 2 * B * 4
    appends = kv_bits != 4
    append = B * 2 * HD * 4 + 2 * live * row_bytes
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
    return {row: bound_ms(*w) for row, w in work.items()}


def layer_params(cfg: dict) -> int:
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    return 4 * D * D + 3 * D * I


def decode_step_flops(cfg: dict, seen: List[int]) -> float:
    """Model operations of one decode step: every layer's matrices, its
    attention over the visible rows, and the code heads."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    heads = 2 * D * cfg["num_audio_tokens"] * cfg["num_vq"]
    return (len(seen) * (2 * L * layer_params(cfg) + heads)
            + L * 4 * sum(seen) * D)


def prefill_flops(cfg: dict, prompt_lens: List[int]) -> float:
    """Model operations of a prefill: every prompt token through every
    layer's matrices, and causal attention over the prompt."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    return sum(2 * L * layer_params(cfg) * n + L * 4 * D * n * (n + 1) / 2
               for n in prompt_lens)
