"""The plain reference of ChatTTS's synthesis path, in float32 PyTorch.

It imports nothing of the program (``chattts_tpu_torch``) and nothing of
the JAX package: every function here is written out from the published
model (2noise/ChatTTS ``ChatTTS/model/gpt.py``, ``dvae.py``,
``velocity``'s Llama block, Vocos) and from the wire formats the
configuration states (the int8 and int4 KV cache rows, int8 and int4
weights).  The benchmark draws the weights and inputs and hands the same
trees to the program and to these functions; whatever the program derives
from them (packed or quantized weights, cache rows, prompt ids) is worked
out again here.

Semantics of one request, as the configuration states them:

* the prompt is the text between ``[Stts][spk_emb][speed_5]`` and
  ``[Ptts]``, tokenized character by character (the asset-free tokenizer,
  :func:`prompt_ids`), each position embedded by the text table, the
  ``[spk_emb]`` position by the L2-normalized speaker vector;
* the prompt runs through the decoder with attention over its own keys
  and values as computed (the prefill), on the weights as drawn: the
  configuration's weight tier is the decode step's (``weight_bits``
  quantizes the step's matrices; the prefill reads the bf16 tree);
* every generated position attends over the cache as stored: with a
  quantized cache tier, every key and value row (the prompt's and its own)
  quantized per (token, head) to the tier's integers and scale;
* a request preempted by recompute resumes with its prompt and the
  tokens it has generated run through the prefill, as a longer prompt;
* a generated code token's input is the sum of its four codebooks'
  embeddings, and its hidden state is the final-normed residual of the
  position before it; the code heads read that hidden;
* the mel decoder reads the hiddens of the generated steps, zero past the
  end and padded to a multiple of ``decode_pad`` positions; Vocos and the
  inverse STFT turn the mel into 24 kHz samples, zero past the end.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# the asset-free tokenizer's control tokens, in their id order (the
# highest ids of the text vocabulary)
CONTROL_TOKENS = (
    ["[break_0]", "[break_1]", "[break_2]", "[break_3]", "[break_4]",
     "[break_5]", "[break_6]", "[break_7]"]
    + [f"[laugh_{i}]" for i in range(3)]
    + [f"[oral_{i}]" for i in range(10)]
    + [f"[speed_{i}]" for i in range(10)]
    + ["[uv_break]", "[v_break]", "[lbreak]", "[llbreak]", "[laugh]",
       "[music]", "[pure]", "[Sbreak]", "[Pbreak]", "[Ebreak]",
       "[Stts]", "[Ptts]", "[Etts]", "[spk_emb]", "[empty_spk]"])
CODE_PREFIX = ("[Stts]", "[spk_emb]", "[speed_5]")
CODE_SUFFIX = ("[Ptts]",)
REP_WINDOW = 16   # generated tokens the repetition penalty looks back over


def control_ids(vocab: int) -> Dict[str, int]:
    base = vocab - len(CONTROL_TOKENS)
    return {t: base + i for i, t in enumerate(CONTROL_TOKENS)}


def char_id(c: str, vocab: int) -> int:
    """A character's id: a multiplicative hash into [100, base).  The
    benchmark's texts use a character set on which no two characters
    collide (``traffic.CHARSET``, checked by a test), so no probing."""
    base = vocab - len(CONTROL_TOKENS)
    return 100 + (ord(c) * 2654435761) % (base - 100)


def prompt_ids(text: str, vocab: int) -> List[int]:
    ctrl = control_ids(vocab)
    return ([ctrl[t] for t in CODE_PREFIX] + [char_id(c, vocab) for c in text]
            + [ctrl[t] for t in CODE_SUFFIX])


# -- weights as the configuration states them ---------------------------------

def quantize_weight(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """An (in, out) bf16 matrix -> the float32 matrix its integer tier
    represents: integers times a scale per (``group`` input rows, output
    column).  int8 takes absmax / 127 in the weights' own dtype (bf16
    scale, bf16 division, half-to-even rounding), int4 absmax / 7 in
    float32, as the deployment's quantizer states them."""
    K, N = w.shape
    if bits == 8:
        wg = w.reshape(K // group, group, N)
        scale = torch.clamp(wg.abs().amax(dim=1), min=1e-8) / 127.0
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -127, 127)
    elif bits == 4:
        wg = w.to(torch.float32).reshape(K // group, group, N)
        scale = torch.clamp(wg.abs().amax(dim=1), min=1e-8) / 7.0
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    else:
        raise ValueError(f"no {bits}-bit weight tier")
    return (q.to(torch.float32) * scale.to(torch.float32)[:, None, :]
            ).reshape(K, N)


def weight_group(bits: int, hidden: int) -> int:
    """Input rows that share a scale: the hidden size for int8, 128 (or
    half the hidden size where that is not a multiple of 128) for int4."""
    if bits == 8:
        return hidden
    return 128 if (hidden // 2) % 128 == 0 else hidden // 2


def layer_weights(lp: dict, cfg: dict, bits: int) -> dict:
    """One decoder layer's matrices in float32 (in, out) layout, through
    the weight tier ``bits`` (0: the bf16 values as they are)."""
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    mats = {"wqkv": lp["attn"]["wqkv"].reshape(D, -1), "wo": lp["attn"]["wo"],
            "wgu": lp["mlp"]["wgu"].reshape(D, 2 * I),
            "wd": lp["mlp"]["down"]}
    g = weight_group(bits, D) if bits else None
    out = {k: (quantize_weight(v, bits, g) if bits else v.to(torch.float32))
           for k, v in mats.items()}
    out["ln1"] = lp["ln1"].to(torch.float32)
    out["ln2"] = lp["ln2"].to(torch.float32)
    return out


# -- the KV cache rows --------------------------------------------------------

def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e exactly, for integer-valued ``e`` in [-126, 127], from the
    IEEE exponent bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive normal float32 values, from their
    exponent bits."""
    return ((x.contiguous().view(torch.int32) >> 23) - 127).to(torch.float32)


def kv_round_trip(x: torch.Tensor, bits: int, heads: int) -> torch.Tensor:
    """Rows (..., H*Dh) -> the values a cache tier stores for them: per
    (row, head) the scale m * 2^e, m the 7-bit mantissa of absmax / maxq
    rounded up (so no value clips), the values rounded half to even and
    clamped to [-maxq, maxq], times the scale.  ``bits`` 0 keeps them."""
    if not bits:
        return x
    maxq = 127.0 if bits == 8 else 7.0
    lead = x.shape[:-1]
    xh = x.reshape(lead + (heads, -1)).to(torch.float32)
    a = xh.abs().amax(dim=-1)
    sc = a / maxq
    e = _floor_log2(torch.clamp(sc, min=1e-30))
    m = torch.ceil(sc * _pow2(-e) * 64.0)
    e = torch.where(m > 127.0, e + 1, e)
    m = torch.where(m > 127.0, torch.full_like(m, 64.0), m)
    m = torch.where(a > 0.0, m, torch.zeros_like(m))
    s = m * _pow2(torch.clamp(e - 6, -126, 126))
    q = torch.clamp(torch.round(xh / torch.clamp(s, min=1e-30)[..., None]),
                    -maxq, maxq)
    return (q * s[..., None]).reshape(x.shape)


# -- the decoder --------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, Dh), HF half rotation at positions ``pos`` (T,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _attend(q, k, v, mask):
    """q (Tq, H, Dh), k/v (Tk, H, Dh), mask (Tq, Tk) bool -> (Tq, H*Dh)."""
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask[None], float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return o.reshape(q.shape[0], -1)


def gpt_hiddens(gpt: dict, cfg: dict, emb: torch.Tensor, n_prompt: int,
                kv_bits: int, weight_bits: int,
                prompt_bits: int = 0) -> torch.Tensor:
    """emb (T, D) float32, the first ``n_prompt`` rows the prompt ->
    final-normed hiddens (T, D).  Rows of the prompt attend over the
    prompt's keys and values as computed; later rows over every row as the
    cache tier ``kv_bits`` stores it.  The layers' matrices go through the
    weight tier ``prompt_bits`` for the prompt's rows and ``weight_bits``
    for the generated rows."""
    H = cfg["num_attention_heads"]
    Dh = cfg["hidden_size"] // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    T = emb.shape[0]
    dev = emb.device
    pos = torch.arange(T, device=dev)
    causal = pos[None, :] <= pos[:, None]
    pmask = causal[:n_prompt, :n_prompt]
    dmask = causal[n_prompt:]
    x = emb.to(torch.float32)

    def mm(a, w, key):
        """Each row through its own tier's matrix."""
        return torch.cat([a[:n_prompt] @ w[0][key], a[n_prompt:] @ w[1][key]])

    for lp in gpt["layers"]:
        wp = layer_weights(lp, cfg, prompt_bits)
        w = (wp, wp if weight_bits == prompt_bits
             else layer_weights(lp, cfg, weight_bits))
        ln1, ln2 = w[0]["ln1"], w[0]["ln2"]
        qkv = mm(rms_norm(x, ln1, eps), w, "wqkv").reshape(T, 3, H, Dh)
        q = rope(qkv[:, 0], pos, theta)
        k = rope(qkv[:, 1], pos, theta)
        v = qkv[:, 2]
        o_p = _attend(q[:n_prompt], k[:n_prompt], v[:n_prompt], pmask)
        if T > n_prompt:
            kq = kv_round_trip(k.reshape(T, -1), kv_bits, H).reshape(k.shape)
            vq = kv_round_trip(v.reshape(T, -1), kv_bits, H).reshape(v.shape)
            o = torch.cat([o_p, _attend(q[n_prompt:], kq, vq, dmask)])
        else:
            o = o_p
        x = x + mm(o, w, "wo")
        gu = mm(rms_norm(x, ln2, eps), w, "wgu")
        g, u = gu.chunk(2, dim=-1)
        x = x + mm(F.silu(g) * u, w, "wd")
    return rms_norm(x, gpt["norm"].to(torch.float32), eps)


def request_embeddings(embed: dict, cfg: dict, text: str, spk: np.ndarray,
                       codes: np.ndarray) -> tuple:
    """The decoder's input rows of one request: the prompt's, then each
    generated code token's but the last (its hidden is never read).
    Returns (emb (T, D), n_prompt)."""
    vocab = cfg["num_text_tokens"]
    ids = prompt_ids(text, vocab)
    dev = embed["emb_text"].device
    e = embed["emb_text"].to(torch.float32)[torch.as_tensor(ids, device=dev)]
    vec = torch.as_tensor(np.asarray(spk, np.float16).astype(np.float32),
                          device=dev)
    vec = vec / torch.clamp(torch.linalg.vector_norm(vec), min=1e-12)
    at = ids.index(control_ids(vocab)["[spk_emb]"])
    e[at] = vec
    c = torch.as_tensor(np.asarray(codes[:-1], np.int64), device=dev)
    tables = embed["emb_code"].to(torch.float32)
    ce = sum(tables[q][c[:, q]] for q in range(tables.shape[0]))
    return torch.cat([e, ce]), len(ids)


def code_logits(embed: dict, hid: torch.Tensor) -> torch.Tensor:
    """hid (n, D) -> the code heads' logits (n, num_vq, V)."""
    return torch.einsum("nd,qdv->nqv", hid,
                        embed["head_code"].to(torch.float32))


def penalized(logits: torch.Tensor, codes: np.ndarray, penalty: float,
              eos: int) -> torch.Tensor:
    """The scores a greedy request picks its token from: at step j each
    codebook's logits with the repetition penalty over the last
    ``REP_WINDOW`` generated tokens of that codebook (a score divided by
    penalty^count where positive, multiplied where negative; the EOS
    column exempt) and EOS removed (the request forces its length)."""
    n, Q, V = logits.shape
    dev = logits.device
    c = torch.as_tensor(np.asarray(codes, np.int64), device=dev)  # (n, Q)
    freq = torch.zeros((n, Q, V), device=dev)
    for d in range(1, REP_WINDOW + 1):
        if d >= n:
            break
        freq[d:].scatter_add_(2, c[:-d, :, None],
                              torch.ones((n - d, Q, 1), device=dev))
    freq[..., eos:] = 0.0
    alpha = torch.pow(torch.tensor(float(penalty), device=dev), freq)
    s = torch.where(logits < 0, logits * alpha, logits / alpha)
    s[..., eos] = float("-inf")
    return s


# -- the audio back end -------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, b=None, padding=0, dilation=1,
          groups=1) -> torch.Tensor:
    """x (B, T, Cin), w (k, Cin/groups, Cout) -> (B, T', Cout)."""
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=padding,
                    dilation=dilation, groups=groups).transpose(1, 2)


def _layer_norm(x, p, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _block(p: dict, x: torch.Tensor, kernel: int, dilation: int):
    y = _conv(x, p["dwconv"]["w"], p["dwconv"]["b"],
              padding=dilation * (kernel // 2), dilation=dilation,
              groups=x.shape[-1])
    y = _layer_norm(y, p["norm"])
    y = F.gelu(y @ p["pw1"]["w"] + p["pw1"]["b"]) @ p["pw2"]["w"]
    return x + (y + p["pw2"]["b"]) * p["gamma"]


def mel_from_hiddens(dec: dict, stack: dict, hid: torch.Tensor
                     ) -> torch.Tensor:
    """hid (B, T, D) -> mel (B, 2T, n_mels): each position split into two
    frames of D/2, the ConvNeXt stack, the k3 output conv, times coef."""
    B, T, C = hid.shape
    y = torch.stack([hid[..., :C // 2], hid[..., C // 2:]], 2)
    y = y.reshape(B, 2 * T, C // 2)
    p = dec["decoder"]
    y = F.gelu(_conv(y, p["conv_in0"]["w"], p["conv_in0"]["b"], padding=1))
    y = _conv(y, p["conv_in1"]["w"], p["conv_in1"]["b"], padding=1)
    for bp in p["blocks"]:
        y = _block(bp, y, stack["kernel"], stack["dilation"])
    y = _conv(y, p["conv_out"]["w"])
    return _conv(y, dec["out_conv"]["w"], padding=1) * dec["coef"]


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex spec (B, n_fft/2+1, T) -> (B, (T-1) hop): inverse real FFT
    of each frame (DC and Nyquist taken as real), periodic Hann window,
    overlap-add divided by the summed squared window, centre trimmed."""
    B, _, T = spec.shape
    spec = spec.clone()
    spec[:, 0] = spec[:, 0].real.to(spec.dtype)
    spec[:, n_fft // 2] = spec[:, n_fft // 2].real.to(spec.dtype)
    n = torch.arange(n_fft, device=spec.device, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)).to(torch.float32)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * win
    total = (T - 1) * hop + n_fft
    out = torch.zeros((B, total), device=spec.device)
    env = torch.zeros((total,), device=spec.device)
    for t in range(T):
        out[:, t * hop:t * hop + n_fft] += frames[:, t]
        env[t * hop:t * hop + n_fft] += win * win
    lo = n_fft // 2
    return out[:, lo:lo + (T - 1) * hop] / torch.clamp(
        env[lo:lo + (T - 1) * hop], min=1e-11)


def vocos_wav(voc: dict, vcfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) -> wav (B, (T - 1) hop)."""
    x = _conv(mel, voc["embed"]["w"], voc["embed"]["b"], padding=3)
    x = _layer_norm(x, voc["norm"])
    for bp in voc["blocks"]:
        x = _block(bp, x, 7, 1)
    h = _layer_norm(x, voc["final_norm"]) @ voc["head"]["w"] + voc["head"]["b"]
    nf = vcfg["n_fft"] // 2 + 1
    mag = torch.clamp(torch.exp(h[..., :nf]), max=1e2)
    spec = torch.polar(mag, h[..., nf:]).transpose(1, 2)
    return istft(spec, vcfg["n_fft"], vcfg["hop_length"])


def wav_from_hiddens(dec: dict, voc: dict, cfg: dict, hid: torch.Tensor,
                     decode_pad: int) -> torch.Tensor:
    """One request's hiddens (n, D) -> its wav (n * 2 * hop,)."""
    n = hid.shape[0]
    padded = -(-n // decode_pad) * decode_pad
    h = F.pad(hid, (0, 0, 0, padded - n))[None]
    wav = vocos_wav(voc, cfg["vocos"], mel_from_hiddens(
        dec, cfg["decoder"]["stack"], h))[0]
    return wav[:n * 2 * cfg["vocos"]["hop_length"]]


def request_reference(weights: dict, cfg: dict, text: str, spk: np.ndarray,
                      codes: np.ndarray, kv_bits: int, weight_bits: int,
                      prompt_bits: int = 0, resumes=(),
                      with_wav: bool = True) -> dict:
    """Hiddens, code logits and (``with_wav``) the wav of one request
    whose generated codes (n, num_vq) are given, teacher-forced; the
    prompt on the weight tier ``prompt_bits``, the generated rows on
    ``weight_bits``.

    ``resumes``: the generated lengths, rising, at which the request was
    preempted and resumed by recompute.  A resume runs the prompt and the
    tokens generated so far through the prefill, and the request goes on
    from there: each token's logits come from the pass of the tenure that
    made it, and the hiddens (and the wav) from the last pass."""
    emb, n_p = request_embeddings(weights["embed"], cfg["gpt"], text, spk,
                                  codes)
    starts = [0] + [int(r) for r in resumes]
    logits = []
    for i, r in enumerate(starts):
        hid = gpt_hiddens(weights["gpt"], cfg["gpt"], emb, n_p + r, kv_bits,
                          weight_bits, prompt_bits)[n_p - 1:]
        stop = starts[i + 1] if i + 1 < len(starts) else hid.shape[0]
        logits.append(code_logits(weights["embed"], hid[r:stop]))
    out = {"logits": torch.cat(logits), "hiddens": hid}
    if with_wav:
        out["wav"] = wav_from_hiddens(weights["decoder"], weights["vocos"],
                                      cfg, hid, cfg["decode_pad"])
    return out


def gaps(scores: torch.Tensor, picked: np.ndarray) -> torch.Tensor:
    """How far each picked token's score lies below the best (n, num_vq)."""
    idx = torch.as_tensor(np.asarray(picked, np.int64), device=scores.device)
    return scores.amax(-1) - scores.gather(-1, idx[..., None])[..., 0]


def relative_error(got: np.ndarray, want: torch.Tensor) -> float:
    w = want.detach().double().cpu().numpy()
    g = np.asarray(got, np.float64)
    if g.shape != w.shape:
        return float("inf")
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def tf32_off() -> None:
    """Float32 products in float32: the reference's own setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

