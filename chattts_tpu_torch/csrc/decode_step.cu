// One whole autoregressive decode step (all L layers) for the Llama decoder.
// Replaces the Pallas TPU kernel chattts_tpu/ops/pallas_step.py::_kernel in
// all of its variants:
//   K1    bf16 KV cache, one shared write position `cur`
//   K2    bf16 KV cache, a write position per row (continuous batching)
//   K3    int8 KV cache with embedded per-(token, head) scales
//   K4    int8 weights, a scale per (D-row contraction group, output column)
//   K5    int4 weights, two a byte, a scale per (128-row group, column)
//   K6    int4 KV cache: kv8's scales, two values a byte
// and their combinations.  `cur` is always a device array of B positions (a
// shared position is the array with equal entries), so no launch depends on
// a host copy of it.  The weight tier is a template parameter of the gemv
// and the cache tier one of the attention kernel: neither touches the
// other, so 3 x 3 instantiations give every combination.  Per layer:
//   h = rms(x)*ln1 ; q,k,v = h@Wqkv ; rope(q), rope(k) ;
//   cache[l, :, cur] = k, v ; o = softmax(q.K[lo..cur]/sqrt(Dh)) V[lo..cur] ;
//   x += o@Wo ; x += (silu(h2@Wg) * (h2@Wu)) @ Wd  with h2 = rms(x)*ln2
// with the kernel's roundings: f32 residual, matmul inputs rounded to bf16
// and accumulated in f32, rotate_half on bf16-rounded values, q*scale
// rounded to bf16 before the scores, and probabilities rounded to bf16 in
// the numerator (the denominator sums them in f32).
//
// The int8 cache row is [q(HD) | m(H) | e(H) | zeros], HD + 128 bytes, with
// head scale m * 2^e (chattts_tpu_torch/ops/kv_quant.py).  Appends quantize
// the f32 roped k and the f32 v with that module's arithmetic (exact powers
// of two, rintf, IEEE division).  Attention multiplies the int8 values as
// bf16 against bf16(q*scale), scales each score by its key's m*2^e after
// the sum, and folds each value row's m*2^e into p before p's bf16 rounding.
//
// The int4 cache row is [p(HD/2) | m(H) | e(H) | zeros], HD/2 + 128 bytes:
// feature f < HD/2 in the low nibble of byte f, feature HD/2 + f in its high
// nibble, scales from absmax / 7.  Two heads (h and h + H/2) share every
// byte there, so the append is a launch of its own before the attention
// pair (which for this tier only ropes q and attends), one warp to a head
// pair's bytes of the k or the v row: no two warps write one byte, and
// nothing rests on an order between them.
//
// Quantized weights are (N, K) int8, or (N, K/2) bytes with weight 2j in
// the low nibble of byte j and 2j + 1 in the high one, beside f32 scales
// (N, K/group).  The integers widen to bf16 in registers, exactly (|v| <=
// 127), and go through the same tensor-core product as bf16 weights; each
// warp sums a group's products into an f32 partial (group % 32 == 0, so a
// 32-value step never straddles two groups) and adds partial * scale[group]
// to its total where the group or its slice of K ends, so the scale
// multiplies a sum, never a weight.
//
// A row's result depends on that row's inputs only, never on B or on the
// other rows: every sum runs in an order fixed by K alone.  The gemv runs
// over row groups of 32 (grid.y): a block multiplies at most 32 input rows
// whatever B is, and the weights are read once per group, after the first
// mostly from L2.  A step takes 1 to
// kMaxB rows: the attention pair's grid has B in gridDim.z, whose limit is
// 65535, and every index that grows with B (cache rows, scores, chunk
// maxima, partials, tickets, the gemv's input and output rows) is formed
// in size_t; B * H, the ticket count, fits an int at that B.
//
// Bound on an H100: the step streams every weight once,
// L*(4*D*D + 3*D*I) of them at 2, 1 or 1/2 bytes (377, 189 or 94 MB at
// D 768, I 3072, L 20: ~113, ~57 or ~28 us at 3.35 TB/s) and their scales,
// plus 2*L*sum_b(cur_b-lo_b)*R bytes of KV reads and 2*L*B*W of appended
// rows, W = 2*HD (bf16), HD+128 (int8) or HD/2+128 (int4) the row's width,
// R the bytes of a row that attention reads: W on bf16, the QW = HD or HD/2
// value bytes and one 32-byte sector of head scales on int8 and int4 (the
// row's pad past the scales is written, never read).  Its arithmetic
// intensity is ~B flop/byte, far below the ~295 the tensor cores need, so
// it is bound by bytes.  The TPU kernel's sequential layer grid becomes a
// host loop over layers (six launches a layer, seven on the int4 cache,
// and one rows pass a step); its slab DMA ring and aligned append windows
// are TPU mechanics with no counterpart here.
//
// The gemv (four launches a layer) reads each weight byte once per row
// group: block (x, y) owns kGemvTiles tiles of 8 output columns for the up
// to 32 rows of group y.  Its input rows are bf16 and built once a gemv,
// in global memory, by the launch that produces them, so no block of the
// gemv spends anything before its first weight load: the gate/up gemv's
// epilogue writes down's rows bf16(silu(gate) * up) (a block owns 8 gate
// columns and the same 8 up columns, so both sums meet in its epilogue);
// the gemvs that add into the residual (wo, down) end with a finisher,
// the last block of each row group to add (an atomic ticket after a
// __threadfence, as attend_values does) writing the group's rms-normed
// rows for the next gemv (gate/up, the next layer's qkv); wo rounds the
// attention's f32 o as it loads it; layer 0's qkv rows come from a pass of
// their own over the embedding, one launch a step.  Its kGemvWarps warps
// split K into contiguous slices of 32-value steps; for each step a lane
// loads 8 weights of one column with one 16-, 8- or 4-byte load (bf16,
// int8, int4) and the 8 values of its input rows at the same k from L2,
// kGemvUnroll steps of both ahead of their products (half that at 32
// rows, to keep two blocks an SM), and two tensor-core mmas (mma.sync
// m16n8k16, bf16 in, f32 sums) multiply them, no ldmatrix, with one
// permutation of k on both sides.  The warps' partial tiles are
// added in warp order in shared memory: one block owns a column tile, so
// there is no cross-block sum and no atomic but the finisher's ticket.
// What bounds it now: every block of a row group still reads the group's
// bf16 rows (K values each) from L2, N / (8 kGemvTiles) times a group, and
// at 64 rows those reads outweigh a block's weight bytes; the finisher's
// pass over its group's rows stands after the last block of wo and down
// (PERF.md).
//
// Attention is bound by bytes too: a row reads 2 * n * R bytes of keys and
// values for n visible keys (6.3 MB a layer at 8 rows, 256 keys, bf16: 1.9
// us at 3.35 TB/s) and does 4 * n * HD flops.  The bytes are few, so what
// costs is latency: a block per (head, row) walking its keys one warp a key
// leaves the card idle.  The design spreads the keys over many blocks and
// keeps many 16-byte loads in flight (flash decoding):
//   attend_scores  grid (X, H, B): block (x, h, b) scores chunks x, x + X,
//                  ... of row b's window [lo_b, cur_b] for head h,
//                  kAttnChunk keys each, with G lanes a key each loading 16
//                  bytes of the head's row (bf16: 8 features; kv8 and kv4:
//                  16, kv4 taking its head's nibble of each byte) and two
//                  or four keys loaded before any is summed; it writes the
//                  scores and the chunk's max to scratch.  The block whose
//                  chunk holds cur_b ropes k and appends the row first.
//   attend_values  the same grid: each block takes the window's max from
//                  the chunk maxima, so every p = exp(s - m) is the one the
//                  plain version rounds (a per-chunk max rescaled later
//                  would round p otherwise), sums each of its chunks'
//                  bf16(p * v scale) * v and p into a partial, and the
//                  chunk that finishes last in its (row, head) (an atomic
//                  ticket after a __threadfence) adds the partials in chunk
//                  order, writes o = acc / l and resets the ticket to 0.
// The host knows T, never cur: a row has at most S = ceil(T / kAttnChunk)
// chunks, and X = min(S, ceil(kAttnBlocks / (B H))), so a short batch gets
// a block a chunk, and 64 rows on a long cache do not pay for thousands of
// blocks past every window (such blocks exit at once).  The chunk is fixed
// at compile time and the partials are added in chunk order whichever
// block made them, so a row's chunks, sums and result depend on its own
// window only.  Two launches a layer where there was one: twenty more a
// step.  The kernels allocate nothing: the scores (B, H, T), chunk maxima
// (B, H, S), partials (B, H, S, Dh + 1) and tickets (B * H, zero between
// launches, one buffer to a stream) come from the wrapper, which sizes them
// from decode_step_attn_chunk().
//
// Tensor parallelism needs an all_reduce after wo and after down in every
// layer, which a step that loops over the layers on the device has no room
// for.  A tp rank therefore launches the same kernels one by one from the
// host (ops/decode_step.py, DecodeStep.tp): the one-gemv entry on its
// slabs (qkv N 3 HD/tp, wo K HD/tp, gate/up N 2 I/tp, down K I/tp) and
// decode_step_attend, one layer's launch_attend on its H/tp heads; the
// partial sums cross ranks between launches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libdecode_step.so decode_step.cu
// Bound to Python with ctypes (chattts_tpu_torch/ops/decode_step.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 65535;     // most batch rows: gridDim.z of attention
constexpr int kRowsPerBlock = 32;  // input rows a gemv block keeps
constexpr int kKvPad = 128;      // pad lanes of a quantized cache row
// warps of a gemv block, each a contiguous slice of K, and the 8-column
// tiles the block owns: 8 warps and 2 tiles were the fastest of 4/8 x 1/2
// on the H100 (PERF.md)
constexpr int kGemvWarps = 8;
constexpr int kGemvTiles = 2;
constexpr int kGemvUnroll = 4;   // 32-value steps a warp loads before their mmas
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block may opt in to
constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxDh = 128;      // head width the attention pair takes
#ifndef ATTN_CHUNK
#define ATTN_CHUNK 64
#endif
// keys of a row's window one attention block owns (the wrapper reads it
// from decode_step_attn_chunk); the build may set it, and ATTN_BLOCKS
// below, with -D to compare sizes (chip_smoke.py --sweep-chunk)
constexpr int kAttnChunk = ATTN_CHUNK;
static_assert(kAttnChunk == 32 || kAttnChunk == 64 || kAttnChunk == 128,
              "the attention chunk is 32, 64 or 128 keys");
#ifndef ATTN_BLOCKS
#define ATTN_BLOCKS 2112
#endif
// attention blocks a launch aims at: by default 16 of 4 warps on each of an
// H100's 132 SMs, all the threads an SM holds at once
constexpr int kAttnBlocks = ATTN_BLOCKS;
// dynamic shared memory a launch may take without opting in: the 48 KB
// default, less room for the kernels' small static arrays
constexpr size_t kDefaultSmem = 46 * 1024;

// a gemv's input rows: prepared bf16, or f32 rounded as they are loaded
enum GemvIn { IN_BF16 = 0, IN_F32 = 1 };
// what a gemv does with its sums (gemv_kernel)
enum GemvOut { OUT_STORE = 0, OUT_ADD = 1, OUT_NORM = 2, OUT_SILU = 3 };
// the rows a pass of their own builds (gemv_kernel_rows), numbered as the
// one-gemv entry's modes (0 is its f32 input as it is)
enum RowsMode { ROWS_RMS = 1, ROWS_SILU = 2 };
enum WeightTier { W_BF16 = 0, W_INT8 = 8, W_INT4 = 4 };
enum CacheTier { KV_BF16 = 0, KV_INT8 = 8, KV_INT4 = 4 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The raw bytes of a lane's 8 weights at k0..k0+7 of a row: 16 (bf16), 8
// (int8, in .x and .y) or 4 (int4 nibbles, in .x).  Row starts and k0 are
// multiples of 8 values, so every load is aligned.
template <int WT>
__device__ __forceinline__ uint4 load_weights8(const char* row, int k0) {
  if (WT == W_BF16)
    return __ldg(reinterpret_cast<const uint4*>(row) + k0 / 8);
  if (WT == W_INT8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row) + k0 / 8);
    return make_uint4(v.x, v.y, 0u, 0u);
  }
  return make_uint4(__ldg(reinterpret_cast<const uint32_t*>(row) + k0 / 8),
                    0u, 0u, 0u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 weights as bf16 pairs (value 2i in the low half of word i).  The
// integers widen exactly: |v| <= 127 fits bf16's 8-bit significand.
template <int WT>
__device__ __forceinline__ uint4 widen_weights8(const uint4& raw) {
  if (WT == W_BF16) return raw;
  float f[8];
  if (WT == W_INT8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // byte i to the top, arithmetic shift down
      const uint32_t w = i < 4 ? raw.x : raw.y;
      f[i] = (float)((int32_t)(w << (24 - 8 * (i & 3))) >> 24);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)  // nibble i, sign-extended: (w << 28) >> 28
      f[i] = (float)((int32_t)(raw.x << (28 - 4 * i)) >> 28);
  }
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, "col"):
// one tensor-core product, the fragments in registers.  Lane 4g + t holds
// a0..a3 = rows g, g + 8, g, g + 8 at k pairs 2t, 2t, 2t + 8, 2t + 8;
// b0, b1 = column g at k pairs 2t, 2t + 8; c0..c3 = rows g, g, g + 8, g + 8
// at columns 2t, 2t + 1, 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16x8x16(float* c, uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0,
                                                 uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bytes of a gemv block's dynamic shared memory: the warps' partial tiles
// (f32), then the block's weight scales (f32, quantized tiers).
template <int BR>
__host__ __device__ __forceinline__ size_t gemv_red_bytes() {
  return (size_t)kGemvWarps * kGemvTiles * BR * 8 * sizeof(float);
}
__host__ __device__ __forceinline__ size_t gemv_scale_bytes(int G) {
  return ((size_t)kGemvTiles * 8 * G * sizeof(float) + 15) / 16 * 16;
}

// silu(v) * u as the rows are built for down: (v / (1 + e^-v)) * u, each
// step rounded to f32 (gemv_rows_plain)
__device__ __forceinline__ float silu_mul(float v, float u) {
  return __fmul_rn(__fdiv_rn(v, __fadd_rn(1.f, expf(-v))), u);
}

// bf16((v * rs) * w), four values, each product rounded to f32
__device__ __forceinline__ uint2 norm4(const float4& v, float rs,
                                       const float4& w) {
  return make_uint2(pack_bf16x2(__fmul_rn(__fmul_rn(v.x, rs), w.x),
                                __fmul_rn(__fmul_rn(v.y, rs), w.y)),
                    pack_bf16x2(__fmul_rn(__fmul_rn(v.z, rs), w.z),
                                __fmul_rn(__fmul_rn(v.w, rs), w.w)));
}

// v.x^2 + v.y^2 + v.z^2 + v.w^2, left to right, every product and sum
// rounded (no fused multiply-add): one lane's term of a row's squares
__device__ __forceinline__ float sum_sq4(const float4& v) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                             __fmul_rn(v.z, v.z)),
                   __fmul_rn(v.w, v.w));
}

// The rms-normed bf16 rows of rows [0, B) of a group (B <= kRowsPerBlock):
// rows[b, k] = bf16((x[b, k] * rsqrt(mean_k x[b, :]^2 + eps)) * lnw[k]).
// Warp w builds rows w, w + kGemvWarps, ...; lane l sums the squares of
// the float4s l, l + 32, ... of a row in that order (sum_sq4), and the
// warp's butterfly adds the 32 lane sums: an order fixed by K alone, so a
// row's bf16 values depend on its own values only (gemv_rows_plain).  It
// stands after the last block of a gemv, so its time is latency: up to
// K 32 * 4 * kRowChunks a lane holds its share of two rows and of lnw in
// registers, every load of both rows in flight at once; a wider row is
// read twice.  x is read through L2 (__ldcg): the finisher reads values
// that other blocks of its launch wrote.  K % 4 == 0.
constexpr int kRowChunks = 6;  // float4s of a row a lane holds (K <= 768)

__device__ __forceinline__ void rms_rows(const float* x, int x_stride,
                                         const float* __restrict__ lnw,
                                         __nv_bfloat16* rows, int B, int K,
                                         float eps, int warp, int lane) {
  const int K4 = K / 4;
  const float4* wr = reinterpret_cast<const float4*>(lnw);
  if (K4 <= 32 * kRowChunks) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 w[kRowChunks];
#pragma unroll
    for (int c = 0; c < kRowChunks; ++c)
      w[c] = lane + 32 * c < K4 ? __ldg(wr + lane + 32 * c) : zero;
    for (int b0 = warp; b0 < B; b0 += 2 * kGemvWarps) {
      float4 v[2][kRowChunks];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + r * kGemvWarps;
        const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * x_stride);
#pragma unroll
        for (int c = 0; c < kRowChunks; ++c)
          v[r][c] = b < B && lane + 32 * c < K4 ? __ldcg(xr + lane + 32 * c) : zero;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + r * kGemvWarps;
        float ss = 0.f;
#pragma unroll
        for (int c = 0; c < kRowChunks; ++c)  // + 0 past the row: exact
          ss = __fadd_rn(ss, sum_sq4(v[r][c]));
        const float rs = rsqrtf(warp_sum(ss) / (float)K + eps);
        uint2* out = reinterpret_cast<uint2*>(rows + (size_t)b * K);
#pragma unroll
        for (int c = 0; c < kRowChunks; ++c)
          if (b < B && lane + 32 * c < K4) out[lane + 32 * c] = norm4(v[r][c], rs, w[c]);
      }
    }
    return;
  }
  for (int b = warp; b < B; b += kGemvWarps) {
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * x_stride);
    uint2* out = reinterpret_cast<uint2*>(rows + (size_t)b * K);
    float ss = 0.f;
    for (int k4 = lane; k4 < K4; k4 += 32)
      ss = __fadd_rn(ss, sum_sq4(__ldcg(xr + k4)));
    const float rs = rsqrtf(warp_sum(ss) / (float)K + eps);
    for (int k4 = lane; k4 < K4; k4 += 32)
      out[k4] = norm4(__ldcg(xr + k4), rs, __ldg(wr + k4));
  }
}

// A gemv's bf16 input rows built by a pass of their own: the layer-0 qkv
// rows of a step (from the embedding), and the one-gemv entry's rows.
//   ROWS_RMS:  rows (B, K) = rms_rows of x with lnw; block y builds the
//              rows of group y, as a gemv's finisher does
//   ROWS_SILU: rows[b, k] = bf16(silu_mul(x[b, k], x[b, K + k]))
// x rows x_stride floats apart; rows (B, K) contiguous.
template <int MODE>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel_rows(const float* __restrict__ x, int x_stride,
                 const float* __restrict__ lnw,
                 __nv_bfloat16* __restrict__ rows, int B, int K, float eps) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nb = min(B - row0, kRowsPerBlock);
  x += (size_t)row0 * x_stride;
  rows += (size_t)row0 * K;
  if (MODE == ROWS_RMS) {
    rms_rows(x, x_stride, lnw, rows, nb, K, eps, warp, lane);
    return;
  }
  const int K8 = K / 8;
  for (int i = tid; i < nb * K8; i += blockDim.x) {
    const int b = i / K8, k = (i - b * K8) * 8;
    const float4* gr = reinterpret_cast<const float4*>(x + (size_t)b * x_stride + k);
    const float4* ur = reinterpret_cast<const float4*>(x + (size_t)b * x_stride + K + k);
    float v[8], u[8];
    *reinterpret_cast<float4*>(v) = __ldg(gr);
    *reinterpret_cast<float4*>(v + 4) = __ldg(gr + 1);
    *reinterpret_cast<float4*>(u) = __ldg(ur);
    *reinterpret_cast<float4*>(u + 4) = __ldg(ur + 1);
    uint4 packed;
    packed.x = pack_bf16x2(silu_mul(v[0], u[0]), silu_mul(v[1], u[1]));
    packed.y = pack_bf16x2(silu_mul(v[2], u[2]), silu_mul(v[3], u[3]));
    packed.z = pack_bf16x2(silu_mul(v[4], u[4]), silu_mul(v[5], u[5]));
    packed.w = pack_bf16x2(silu_mul(v[6], u[6]), silu_mul(v[7], u[7]));
    *reinterpret_cast<uint4*>(rows + (size_t)b * K + k) = packed;
  }
}

// 8 input values k0..k0+7 of a row as bf16 pairs (value 2i in the low half
// of word i): prepared bf16 rows as they are, f32 rows rounded here.  The
// rows were written by an earlier launch, so the read-only path is safe.
template <int IN>
__device__ __forceinline__ uint4 load_input8(const void* row, int k0) {
  if (IN == IN_BF16)
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(row) + k0));
  const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(row) + k0);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                    pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
}

// y[b, n] = sum_k in[b, k] * W[n, k]   for b < B, n < N, then the epilogue:
//   OUT_STORE: out[b, n] = y          OUT_ADD: out[b, n] += y
//   OUT_NORM:  out[b, n] += y, and the last block of the row group to add
//              writes rows = rms_rows of the group's new out with lnw
//              (N wide): the next gemv's prepared input
//   OUT_SILU:  N = 2I rows of W, [gate | up]; rows[b, c] =
//              bf16(silu_mul(y[b, c], y[b, I + c])) for c < I
// in is IN_BF16 rows (prepared: no rounding left) or IN_F32 rows rounded
// to bf16 as they are loaded, in_stride values apart.  W is (N, K)
// row-major of tier WT: bf16, int8, or int4 nibbles (K/2 bytes a row);
// quantized tiers carry wscale (N, K/group) f32 and W[n, k] stands for the
// integer times wscale[n, k / group].  K % 8 == 0, and group % 32 == 0
// with K % group == 0.  Block (x, y) serves rows [32 y, 32 y + 32) and
// kGemvTiles tiles of 8 weight rows: columns [8 T x, 8 T (x + 1)), T =
// kGemvTiles, or for OUT_SILU gate columns [8 T/2 x, 8 T/2 (x + 1)) and
// the same up columns, so one block holds both sums of its outputs.  BR
// (16 or 32) is the rows it multiplies, one m-tile of 16 or two.  The
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums):
// warp w takes the 32-value steps [w S / NW, (w + 1) S / NW) of K's S
// steps, lane 4g + t loading the 8 weights W[n0 + g, k + 8t .. k + 8t + 7]
// of a step at k with one 16-byte (int8: 8, int4: 4) load and the input
// rows g and g + 8 of each m-tile at the same 8 values straight from global
// memory (L2), U steps of both in flight before their products (U:
// kGemvUnroll, half that for two m-tiles or f32 rows, so two blocks fit an
// SM's registers);
// values 8t + {0,1,2,3} feed the first mma of the step as its k pairs 2t
// and 2t + 8, values 8t + {4,5,6,7} the second.  A and B take the same
// permutation of k, so every output sums the step's 32 products.  Nothing
// stands before the first loads: a quantized tier's scales go to shared
// memory while they are in flight, behind the one barrier of the main
// loop.  Rows >= B and values past K read zeros; columns past N (past I
// for OUT_SILU) recompute the last one and store nothing.  On a quantized
// tier each warp sums a scale group into `part` and adds part * scale to
// its total where the group or its slice ends.  The warps' partial tiles
// are added in warp order in shared memory, so a row's sum runs in an
// order fixed by K alone: it does not depend on B, on BR, on y or on the
// other rows.  OUT_NORM's finisher takes a ticket per row group after a
// __threadfence (attend_values_kernel's idiom) and resets it to 0.
template <int IN, int OUT, int BR, int WT>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel(const void* __restrict__ in, int in_stride,
            const void* __restrict__ W, const float* __restrict__ wscale,
            int group, float* out, int out_stride, __nv_bfloat16* rows,
            const float* __restrict__ lnw, unsigned int* tickets, int B,
            int K, int N, float eps) {
  constexpr int MT = BR / 16;  // m-tiles of 16 rows
  // steps loaded before their products: two m-tiles or f32 inputs take
  // twice the registers, and fewer steps keep two blocks on an SM
  constexpr int U = IN == IN_F32 || BR == 32 ? kGemvUnroll / 2 : kGemvUnroll;
  constexpr int IB = IN == IN_BF16 ? 2 : 4;  // bytes of an input value
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = WT == W_BF16 ? 0 : K / group;  // scale groups of a row
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][tile][m][4][32]
  float* scs = reinterpret_cast<float*>(smem_raw + gemv_red_bytes<BR>());
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int Bg = min(B - row0, kRowsPerBlock);  // rows of this group
  const char* inb = static_cast<const char*>(in) + (size_t)row0 * in_stride * IB;
  // the block's weight rows: tile j's 8 rows, the lane's row g of them
  constexpr int HALF = kGemvTiles / 2;
  const int I = N / 2;  // OUT_SILU: gate columns
  const int bx = blockIdx.x, col0 = bx * kGemvTiles * 8;
  auto wcol = [&](int j, int c) {  // weight row of tile j, column c of 8
    if (OUT == OUT_SILU)
      return min(bx * HALF * 8 + 8 * (j % HALF) + c, I - 1) +
             (j < HALF ? 0 : I);
    return min(col0 + 8 * j + c, N - 1);
  };
  // bytes of a weight row: 2, 1 or 1/2 a value
  const size_t row_bytes = WT == W_BF16 ? (size_t)K * 2
                           : WT == W_INT8 ? (size_t)K : (size_t)K / 2;
  const char* wrow[kGemvTiles];
#pragma unroll
  for (int j = 0; j < kGemvTiles; ++j)  // a ragged last column recomputes
    wrow[j] = static_cast<const char*>(W) + (size_t)wcol(j, g) * row_bytes;
  const int steps = (K + 31) / 32;
  const int s_begin = warp * steps / kGemvWarps;
  const int s_end = (warp + 1) * steps / kGemvWarps;
  float acc[kGemvTiles][MT][4], part[kGemvTiles][MT][4];
#pragma unroll
  for (int j = 0; j < kGemvTiles; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][m][i] = part[j][m][i] = 0.f;

  // every warp runs the first round, whose loads go out before the
  // barrier that publishes the scales; a warp without steps leaves after it
  for (int s = s_begin, first = 1; first || s < s_end; s += U, first = 0) {
    uint4 raw[U][kGemvTiles], xa[U][MT], xb[U][MT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k0 = (s + u) * 32 + 8 * t;
      const bool live = s + u < s_end && k0 < K;
#pragma unroll
      for (int j = 0; j < kGemvTiles; ++j)
        raw[u][j] = live ? load_weights8<WT>(wrow[j], k0)
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int m = 0; m < MT; ++m) {  // input rows g and g + 8 of m-tile m
        const int r = 16 * m + g;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        xa[u][m] = live && r < Bg
                       ? load_input8<IN>(inb + (size_t)r * in_stride * IB, k0)
                       : zero;
        xb[u][m] = live && r + 8 < Bg
                       ? load_input8<IN>(inb + (size_t)(r + 8) * in_stride * IB, k0)
                       : zero;
      }
    }
    if (first && WT != W_BF16) {  // the block's scales, [tile column][group]
      for (int i = tid; i < kGemvTiles * 8 * G; i += blockDim.x)
        scs[i] = __ldg(wscale + (size_t)wcol(i / (8 * G), i / G % 8) * G + i % G);
      __syncthreads();
    }
    if (s >= s_end) break;  // uniform over the warp
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u >= s_end) break;  // uniform over the warp
#pragma unroll
      for (int j = 0; j < kGemvTiles; ++j) {
        const uint4 w = widen_weights8<WT>(raw[u][j]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // each mma sums its 16 products from zero, and the result joins
          // the running f32 sum with a rounded add: the tensor cores'
          // truncation then reaches 16 products, not the whole slice
          float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16_16x8x16(c1, xa[u][m].x, xb[u][m].x, xa[u][m].y, xb[u][m].y,
                           w.x, w.y);
          mma_bf16_16x8x16(c2, xa[u][m].z, xb[u][m].z, xa[u][m].w, xb[u][m].w,
                           w.z, w.w);
          float* c = WT == W_BF16 ? acc[j][m] : part[j][m];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = (c[i] + c1[i]) + c2[i];
        }
      }
      // a quantized group's sum times its scale, where the group or the
      // warp's slice ends (group % 32 == 0: a step never straddles groups)
      if (WT != W_BF16 && (s + u + 1 == s_end || (s + u + 1) * 32 % group == 0)) {
        const int grp = (s + u) * 32 / group;
#pragma unroll
        for (int j = 0; j < kGemvTiles; ++j) {
          const float s_lo = scs[(8 * j + 2 * t) * G + grp];
          const float s_hi = scs[(8 * j + 2 * t + 1) * G + grp];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[j][m][i] += part[j][m][i] * (i & 1 ? s_hi : s_lo);
              part[j][m][i] = 0.f;
            }
          }
        }
      }
    }
  }

  // the warps' partial tiles, added in warp order
#pragma unroll
  for (int j = 0; j < kGemvTiles; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(((warp * kGemvTiles + j) * MT + m) * 4 + i) * 32 + lane] = acc[j][m][i];
  __syncthreads();
  auto tile_sum = [&](int j, int b, int c) {  // output (b, c) of tile j
    const int m = b / 16, i = (b % 16 >= 8 ? 2 : 0) + (c & 1);
    const int src = (j * MT + m) * 4 + i;
    const int ln = 4 * (b % 8) + c / 2;
    float sum = 0.f;
    for (int w = 0; w < kGemvWarps; ++w)
      sum += red[((w * kGemvTiles * MT * 4) + src) * 32 + ln];
    return sum;
  };
  if (OUT == OUT_SILU) {
    for (int o = tid; o < HALF * BR * 8; o += blockDim.x) {
      const int j = o / (BR * 8), b = (o / 8) % BR, c = o % 8;
      const int col = bx * HALF * 8 + 8 * j + c;
      if (b >= Bg || col >= I) continue;
      rows[(size_t)(row0 + b) * I + col] = __float2bfloat16_rn(
          silu_mul(tile_sum(j, b, c), tile_sum(j + HALF, b, c)));
    }
    return;
  }
  out += (size_t)row0 * out_stride;
  for (int o = tid; o < kGemvTiles * BR * 8; o += blockDim.x) {
    const int j = o / (BR * 8), b = (o / 8) % BR, c = o % 8;
    const int n = col0 + 8 * j + c;
    if (b >= Bg || n >= N) continue;
    float* dst = out + (size_t)b * out_stride + n;
    if (OUT == OUT_STORE) *dst = tile_sum(j, b, c);
    else *dst += tile_sum(j, b, c);
  }
  if (OUT != OUT_NORM) return;
  // the last block of the row group to add builds the group's normed rows
  __shared__ bool last;
  __threadfence();  // this block's sums are visible device-wide first
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  rms_rows(out, out_stride, lnw, rows + (size_t)row0 * N, Bg, N, eps, warp,
           lane);
  if (tid == 0) tickets[blockIdx.y] = 0;  // for the next launch
}

// The stored scale of one head of an appended row from its absmax `a`, for
// values quantized to [-maxq, maxq]: mantissa and exponent bytes, and the
// divisor m * 2^e (at least 1e-30).  ops/kv_quant.py::head_scales, step for
// step.
__device__ __forceinline__ float head_scale(float a, float maxq, float* mant_out,
                                            int* es_out) {
  const float sc = a / maxq;
  int e = ilogbf(fmaxf(sc, 1e-30f));            // floor(log2), exact
  float mant = ceilf(ldexpf(sc, -e) * 64.0f);   // in [64, 128]
  if (mant > 127.0f) {
    e += 1;
    mant = 64.0f;
  }
  if (!(a > 0.0f)) mant = 0.0f;
  const int es = min(max(e - 6, -126), 126);
  *mant_out = mant;
  *es_out = es;
  return fmaxf(ldexpf(mant, es), 1e-30f);
}

__device__ __forceinline__ float quantize_value(float x, float div, float maxq) {
  return fminf(fmaxf(rintf(x / div), -maxq), maxq);
}

// Quantize one head of an appended kv8 row: x holds the head's Dh f32 values
// in shared memory; row points at the int8 cache row.  Every thread derives
// the head's scale (the same value), thread d stores value d, thread 0 the
// scale bytes.
__device__ __forceinline__ void kv8_append_head(const float* x, int8_t* row,
                                                int h, int H, int Dh) {
  float a = 0.f;
  for (int d = 0; d < Dh; ++d) a = fmaxf(a, fabsf(x[d]));
  float mant;
  int es;
  const float div = head_scale(a, 127.0f, &mant, &es);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x)
    row[h * Dh + d] = (int8_t)quantize_value(x[d], div, 127.0f);
  if (threadIdx.x == 0) {
    row[H * Dh + h] = (int8_t)mant;
    row[H * Dh + H + h] = (int8_t)es;
  }
}

__device__ __forceinline__ bool row_is_live(int c, int lob, int T) {
  return c >= 0 && c < T && c - lob + 1 > 0;
}

// The kv4 append: one warp per (row b, head pair p, k or v), B * H warps,
// kAppendWarps to a block.  A packed byte f < QW = HD / 2 holds feature f in
// its low nibble and feature QW + f in its high one; H is even, so bytes
// [p Dh, (p + 1) Dh) of pair p < H / 2 hold head p in their low nibbles and
// head p + H / 2 in their high ones, and one warp owns them outright.  Lane
// l holds features l + 32 j (j < NJ = Dh / 32) of both heads; Dh % 64 == 0,
// so k's rope partner d -+ Dh / 2 is slice j -+ NJ / 2 of the same lane and
// the rope needs no shuffle.  Two warp maxima give the heads' absmax,
// head_scale their divisors; each lane packs and stores its NJ bytes, lane
// 0 the four scale bytes, and the k warp of pair 0 zeroes both rows' pad
// with 16-byte stores.  No shared memory, no block barrier.  Bound on an
// H100: bytes, 0.02-0.15 us at 8-64 rows; what a launch costs is the chain
// of latencies it walks, so a warp's chain is kept to its loads (issued
// before the position is read), two 5-step shuffle reductions and its
// stores (PERF.md).
// Every rounding is ops/kv_quant.py's kv4 path, step for step, so appended
// rows equal the plain version's bytes: the rope partner rounded to bf16,
// the two products and their sum each rounded (no fused multiply-add, as
// torch computes x * cos + rot * sin), head_scale, the IEEE division x / div
// and half-to-even rint.  A row the attention kernel poisons (position
// outside [0, T), or no visible key) is not written.
constexpr int kAppendWarps = 4;

template <int NJ>
__global__ void __launch_bounds__(kAppendWarps * 32)
kv4_append_kernel(const float* __restrict__ qkv, const float* __restrict__ cosb,
                  const float* __restrict__ sinb, int8_t* __restrict__ kc,
                  int8_t* __restrict__ vc, const int* __restrict__ cur,
                  const int* __restrict__ lo, int B, int T, int H) {
  constexpr int Dh = NJ * 32;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kAppendWarps + (threadIdx.x >> 5);
  if (w >= B * H) return;  // uniform over the warp
  const int b = w / H, HP = H / 2, HD = H * Dh, QW = HD / 2;
  const int W = QW + kKvPad;
  const bool is_v = w % H >= HP;
  const int p = w % H - (is_v ? HP : 0);
  // issue every load before the position is known
  const float* src = qkv + (size_t)b * 3 * HD + (is_v ? 2 : 1) * HD;
  float xl[NJ], xh[NJ];  // heads p and p + H / 2
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    xl[j] = src[p * Dh + lane + 32 * j];
    xh[j] = src[(p + HP) * Dh + lane + 32 * j];
  }
  const int c = cur[b], lob = max(lo[b], 0);
  if (!is_v) {  // rope k: x cos + rotate_half(bf16(x)) sin
    float cs[NJ], sn[NJ], rl[NJ], rh[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      cs[j] = cosb[b * Dh + lane + 32 * j];
      sn[j] = sinb[b * Dh + lane + 32 * j];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool first = j < NJ / 2;
      const int jp = first ? j + NJ / 2 : j - NJ / 2;
      const float pl = first ? -bf16_round(xl[jp]) : bf16_round(xl[jp]);
      const float ph = first ? -bf16_round(xh[jp]) : bf16_round(xh[jp]);
      rl[j] = __fadd_rn(__fmul_rn(xl[j], cs[j]), __fmul_rn(pl, sn[j]));
      rh[j] = __fadd_rn(__fmul_rn(xh[j], cs[j]), __fmul_rn(ph, sn[j]));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) xl[j] = rl[j], xh[j] = rh[j];
  }
  if (!row_is_live(c, lob, T)) return;  // uniform over the warp
  float al = 0.f, ah = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    al = fmaxf(al, fabsf(xl[j]));
    ah = fmaxf(ah, fabsf(xh[j]));
  }
  al = warp_max(al);
  ah = warp_max(ah);
  float ml, mh;
  int el, eh;
  const float dl = head_scale(al, 7.0f, &ml, &el);
  const float dh = head_scale(ah, 7.0f, &mh, &eh);
  int8_t* row = (is_v ? vc : kc) + ((size_t)b * T + c) * W;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int ql = (int)quantize_value(xl[j], dl, 7.0f);
    const int qh = (int)quantize_value(xh[j], dh, 7.0f);
    row[p * Dh + lane + 32 * j] = (int8_t)((ql & 15) | ((qh & 15) << 4));
  }
  if (lane == 0) {
    row[QW + p] = (int8_t)ml;
    row[QW + p + HP] = (int8_t)mh;
    row[QW + H + p] = (int8_t)el;
    row[QW + H + p + HP] = (int8_t)eh;
  }
  if (p == 0 && !is_v) {  // the pad past the 2H scale lanes of both rows
    int8_t* krow = kc + ((size_t)b * T + c) * W;
    int8_t* vrow = vc + ((size_t)b * T + c) * W;
    const int start = QW + 2 * H, a16 = (start + 15) & ~15;
    if (lane < a16 - start) krow[start + lane] = 0, vrow[start + lane] = 0;
    const int n16 = (W - a16) / 16;  // W % 16 == 0: QW % 128 == 0
    for (int i = lane; i < 2 * n16; i += 32)
      *reinterpret_cast<uint4*>((i < n16 ? krow : vrow) + a16 +
                                16 * (i % n16)) = make_uint4(0, 0, 0, 0);
  }
}

// One layer's kv4 append on caches kl/vl (B, T, HD/2 + 128) int8; needs H
// even and Dh 64 or 128 (the rope partner in the same lane).
cudaError_t launch_kv4_append(const float* qkv, const float* cosb,
                              const float* sinb, int8_t* kl, int8_t* vl,
                              const int* cur, const int* lo, int B, int T,
                              int H, int Dh, cudaStream_t st) {
  if (B < 1 || T < 1 || H < 2 || H % 2 || 2 * H > kKvPad || (H * Dh) % 256 ||
      (Dh != 64 && Dh != 128))
    return cudaErrorInvalidValue;
  const int blocks = (B * H + kAppendWarps - 1) / kAppendWarps;
  if (Dh == 64)
    kv4_append_kernel<2><<<blocks, kAppendWarps * 32, 0, st>>>(
        qkv, cosb, sinb, kl, vl, cur, lo, B, T, H);
  else
    kv4_append_kernel<4><<<blocks, kAppendWarps * 32, 0, st>>>(
        qkv, cosb, sinb, kl, vl, cur, lo, B, T, H);
  return cudaGetLastError();
}

// How the attention pair reads a head's part of a cache row: G = Dh / F
// lanes a key, lane j loading the 16 bytes that hold features
// [j F, (j + 1) F) of the head.  bf16: F = 8 values.  kv8: F = 16 bytes.
// kv4: F = 16 nibbles, the low or high halves of 16 bytes (feature f < QW
// lives in byte f, feature f >= QW in byte f - QW), which is the head's
// whole share of those bytes.  Dh % 16 == 0, so a lane's features never
// straddle QW and every load is 16-byte aligned.
template <int KV>
struct HeadLanes {
  static constexpr int F = KV == KV_BF16 ? 8 : 16;
  // keys a lane loads before it sums any (loads in flight per lane)
  static constexpr int U = KV == KV_BF16 ? 4 : 2;
};

// The 16 bytes of cache row `row` holding row feature f0 (a multiple of F).
template <int KV>
__device__ __forceinline__ uint4 load_lane(const char* row, int f0, int QW) {
  const int byte = KV == KV_BF16 ? 2 * f0
                   : KV == KV_INT8 ? f0 : (f0 < QW ? f0 : f0 - QW);
  return *reinterpret_cast<const uint4*>(row + byte);
}

// A lane's F stored values, widened to f32 (exact), scale not applied.
// `high`: the kv4 features sit in the high nibbles.
template <int KV>
__device__ __forceinline__ void widen_lane(const uint4& u, bool high, float* f) {
  if (KV == KV_BF16) {
    unpack8(u, f);
    return;
  }
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // byte k of the word to the top, then an arithmetic shift down:
      // int8 values, or the sign-extended low or high nibble
      const int up = KV == KV_INT8 ? 24 - 8 * k : (high ? 24 : 28) - 8 * k;
      f[4 * i + k] =
          (float)((int32_t)(w[i] << up) >> (KV == KV_INT8 ? 24 : 28));
    }
}

// The scale m * 2^e of head h of a quantized cache row.
__device__ __forceinline__ float head_scale_of(int8_t m, int8_t e) {
  return ldexpf((float)m, (int)e);
}

// Pass 1 of attention, block (x, h, b) of a grid (X, H, B): rope q (and, in
// the block whose chunks hold cur_b, k, appending row cur_b's head h: bf16
// and kv8; kv4's row is appended by kv4_append_kernel before this launch),
// then for chunks s = x, x + X, ... of the window [lo_b, cur_b] score the
// keys [lo_b + s C, lo_b + (s + 1) C), C = kAttnChunk, as
// (bf16(q * scale) . k) * k_scale, into scores[b, h, t - lo_b], and their
// max into cmax[b, h, s].  A block past the window, or of a row that is not
// live, does nothing (attend_values poisons the row).  No other block
// reads row cur_b, so the append needs only this block's barrier.
template <int KV>
__global__ void __launch_bounds__(kAttnThreads)
attend_scores_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ cosb,
                     const float* __restrict__ sinb, char* kc, char* vc,
                     const int* __restrict__ cur, const int* __restrict__ lo,
                     float* __restrict__ scores, float* __restrict__ cmax,
                     int T, int H, int Dh, float scale) {
  constexpr int F = HeadLanes<KV>::F, U = HeadLanes<KV>::U;
  __shared__ __align__(16) float qs[kMaxDh];
  __shared__ float kf[kMaxDh], vf[kMaxDh];  // roped k and v, f32 (kv8)
  __shared__ float red[kAttnWarps];
  const int h = blockIdx.y, b = blockIdx.z;
  const int c = cur[b], lob = max(lo[b], 0);
  if (!row_is_live(c, lob, T)) return;  // uniform over the block
  const int n = c - lob + 1;
  const int chunks = (n + kAttnChunk - 1) / kAttnChunk;
  if ((int)blockIdx.x >= chunks) return;
  const int S = (T + kAttnChunk - 1) / kAttnChunk;  // cmax's row length
  const int HD = H * Dh, half = Dh / 2;
  const int QW = KV == KV_INT4 ? HD / 2 : HD;
  const size_t W = KV == KV_BF16 ? (size_t)HD * 2 : (size_t)QW + kKvPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool owns_cur = (chunks - 1) % gridDim.x == blockIdx.x;

  const float* q = qkv + (size_t)b * 3 * HD + h * Dh;
  const float* k = q + HD;
  const float* v = q + 2 * HD;
  char* krow_cur = kc + ((size_t)b * T + c) * W;
  char* vrow_cur = vc + ((size_t)b * T + c) * W;
  for (int d = tid; d < Dh; d += kAttnThreads) {
    const float cs = cosb[b * Dh + d], sn = sinb[b * Dh + d];
    const float rq = d < half ? -bf16_round(q[d + half]) : bf16_round(q[d - half]);
    qs[d] = bf16_round((q[d] * cs + rq * sn) * scale);
    if (KV != KV_INT4 && owns_cur) {
      const float rk = d < half ? -bf16_round(k[d + half]) : bf16_round(k[d - half]);
      const float kr = k[d] * cs + rk * sn;
      if (KV == KV_INT8) {
        kf[d] = kr;
        vf[d] = v[d];
      } else {
        reinterpret_cast<__nv_bfloat16*>(krow_cur)[h * Dh + d] = __float2bfloat16_rn(kr);
        reinterpret_cast<__nv_bfloat16*>(vrow_cur)[h * Dh + d] = __float2bfloat16_rn(v[d]);
      }
    }
  }
  __syncthreads();  // qs, kf and vf, or the appended bf16 row, block-wide
  if (KV == KV_INT8 && owns_cur) {
    int8_t* kr8 = reinterpret_cast<int8_t*>(krow_cur);
    int8_t* vr8 = reinterpret_cast<int8_t*>(vrow_cur);
    kv8_append_head(kf, kr8, h, H, Dh);
    kv8_append_head(vf, vr8, h, H, Dh);
    if (h == 0) {  // the lanes after the scales are written zero
      for (int i = HD + 2 * H + tid; i < (int)W; i += kAttnThreads) {
        kr8[i] = 0;
        vr8[i] = 0;
      }
    }
    __syncthreads();  // the appended row is visible block-wide
  }

  const int G = Dh / F, j = tid % G, g = tid / G, groups = kAttnThreads / G;
  const int f0 = h * Dh + j * F;
  const bool high = KV == KV_INT4 && f0 >= QW;
  float qreg[F];
#pragma unroll
  for (int e = 0; e < F; ++e) qreg[e] = qs[j * F + e];
  for (int s = blockIdx.x; s < chunks; s += gridDim.x) {
    const int i0 = s * kAttnChunk;
    const int cnt = min(kAttnChunk, n - i0);
    const char* base = kc + ((size_t)b * T + lob + i0) * W;
    float* out = scores + ((size_t)b * H + h) * T + i0;
    float mx = -INFINITY;
    // every lane runs every round (the group sums shuffle), keys past the
    // chunk are masked
    for (int r0 = 0; r0 < cnt; r0 += U * groups) {
      uint4 raw[U];
      int8_t sm[U], se[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = r0 + g + u * groups;
        raw[u] = make_uint4(0, 0, 0, 0);
        sm[u] = se[u] = 0;
        if (i < cnt) {
          const char* row = base + (size_t)i * W;
          raw[u] = load_lane<KV>(row, f0, QW);
          if (KV != KV_BF16 && j == 0) {
            sm[u] = reinterpret_cast<const int8_t*>(row)[QW + h];
            se[u] = reinterpret_cast<const int8_t*>(row)[QW + H + h];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float f[F];
        widen_lane<KV>(raw[u], high, f);
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < F; ++e) a = fmaf(f[e], qreg[e], a);
        for (int o = G / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        const int i = r0 + g + u * groups;
        if (i < cnt && j == 0) {  // the key's scale after the sum
          const float sc = KV == KV_BF16 ? a : a * head_scale_of(sm[u], se[u]);
          out[i] = sc;
          mx = fmaxf(mx, sc);
        }
      }
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kAttnWarps; ++w) mx = fmaxf(mx, red[w]);
      cmax[((size_t)b * H + h) * S + s] = mx;
    }
    __syncthreads();  // red is free for the next chunk
  }
}

// Pass 2 of attention, the grid of pass 1: block (x, h, b) takes the
// window's max m (the max of its chunk maxima, exact), and for each of its
// chunks s sums l = sum p and acc = sum bf16(p * v_scale) v over the
// chunk's keys with p = exp(s - m) (the value row's scale goes into p
// before its rounding; bf16: no scale).  A window of one chunk writes
// o = acc / l at once.  Otherwise the block writes (acc, l) to
// part[b, h, s] and takes a ticket; the chunk that takes the last ticket
// adds the partials in chunk order, writes o and resets the ticket.  A row
// that is not live gets NaN in o (block 0), so the fault shows in the
// step's result.
template <int KV>
__global__ void __launch_bounds__(kAttnThreads)
attend_values_kernel(const char* vc, const int* __restrict__ cur,
                     const int* __restrict__ lo,
                     const float* __restrict__ scores,
                     const float* __restrict__ cmax, float* part,
                     unsigned int* tickets, float* __restrict__ o, int T,
                     int H, int Dh) {
  constexpr int F = HeadLanes<KV>::F, U = HeadLanes<KV>::U;
  __shared__ float accs[kAttnWarps][kMaxDh];
  __shared__ float ls[kAttnWarps];
  __shared__ bool last;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * Dh, S = (T + kAttnChunk - 1) / kAttnChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* orow = o + (size_t)b * HD + (size_t)h * Dh;
  const int c = cur[b], lob = max(lo[b], 0);
  if (!row_is_live(c, lob, T)) {  // uniform over the block
    if (blockIdx.x == 0)
      for (int d = tid; d < Dh; d += kAttnThreads)
        orow[d] = __int_as_float(0x7fc00000);
    return;
  }
  const int n = c - lob + 1;
  const int chunks = (n + kAttnChunk - 1) / kAttnChunk;
  if ((int)blockIdx.x >= chunks) return;
  const int QW = KV == KV_INT4 ? HD / 2 : HD;
  const size_t W = KV == KV_BF16 ? (size_t)HD * 2 : (size_t)QW + kKvPad;
  const size_t bh = (size_t)b * H + h;

  // the window's max, which every warp takes for itself
  float m = -INFINITY;
  for (int t = lane; t < chunks; t += 32) m = fmaxf(m, cmax[bh * S + t]);
  m = warp_max(m);

  const int G = Dh / F, j = tid % G, g = tid / G, groups = kAttnThreads / G;
  const int f0 = h * Dh + j * F;
  const bool high = KV == KV_INT4 && f0 >= QW;
  for (int s = blockIdx.x; s < chunks; s += gridDim.x) {
    const int i0 = s * kAttnChunk;
    const int cnt = min(kAttnChunk, n - i0);
    const char* base = vc + ((size_t)b * T + lob + i0) * W;
    const float* sc = scores + bh * T + i0;
    float acc[F];
#pragma unroll
    for (int e = 0; e < F; ++e) acc[e] = 0.f;
    float l = 0.f;
    for (int r0 = 0; r0 < cnt; r0 += U * groups) {
      uint4 raw[U];
      float sraw[U];
      int8_t sm[U], se[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = r0 + g + u * groups;
        raw[u] = make_uint4(0, 0, 0, 0);
        sraw[u] = -INFINITY;
        sm[u] = se[u] = 0;
        if (i < cnt) {
          const char* row = base + (size_t)i * W;
          raw[u] = load_lane<KV>(row, f0, QW);
          sraw[u] = sc[i];
          if (KV != KV_BF16) {
            sm[u] = reinterpret_cast<const int8_t*>(row)[QW + h];
            se[u] = reinterpret_cast<const int8_t*>(row)[QW + H + h];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r0 + g + u * groups < cnt) {
          const float p = expf(sraw[u] - m);
          if (j == 0) l += p;
          const float num = bf16_round(
              KV == KV_BF16 ? p : p * head_scale_of(sm[u], se[u]));
          float f[F];
          widen_lane<KV>(raw[u], high, f);
#pragma unroll
          for (int e = 0; e < F; ++e) acc[e] = fmaf(num, f[e], acc[e]);
        }
      }
    }
    // the key groups' sums: lanes of one feature group within a warp, then
    // the warps in order
#pragma unroll
    for (int e = 0; e < F; ++e)
      for (int off = G; off < 32; off <<= 1)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    l = warp_sum(l);
    if (lane < G)
#pragma unroll
      for (int e = 0; e < F; ++e) accs[warp][lane * F + e] = acc[e];
    if (lane == 0) ls[warp] = l;
    __syncthreads();
    float a = 0.f, lsum = 0.f;
    for (int w = 0; w < kAttnWarps; ++w) {
      if (tid < Dh) a += accs[w][tid];
      lsum += ls[w];
    }
    if (chunks == 1) {  // 0 + a and 0 + l: the bits the ticket path gives
      if (tid < Dh) orow[tid] = a / lsum;
      return;
    }
    float* mine = part + (bh * S + s) * (Dh + 1);
    if (tid < Dh) mine[tid] = a;
    if (tid == 0) mine[Dh] = lsum;
    __threadfence();  // the partial is visible device-wide before the ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + bh, 1u) == (unsigned)(chunks - 1);
    __syncthreads();  // also frees accs and ls for the next chunk
    if (!last) continue;
    __threadfence();
    if (tid < Dh) {
      float acc_all = 0.f, l_all = 0.f;
      for (int t = 0; t < chunks; ++t) {  // chunk order: the same bits each run
        const float* p = part + (bh * S + t) * (Dh + 1);
        acc_all += __ldcg(p + tid);
        l_all += __ldcg(p + Dh);
      }
      orow[tid] = acc_all / l_all;
    }
    if (tid == 0) tickets[bh] = 0;  // for the next layer's launch
    return;  // the last ticket: every other chunk is done
  }
}

// one matrix of a layer: its values, and for a quantized tier its scales
// (N, K / group) f32
struct Weights {
  const void* w;
  const float* scale;
  int group;
};

template <int IN, int OUT, int BR, int WT>
cudaError_t launch_gemv_br(const void* in, int in_stride, Weights wt,
                           float* out, int out_stride, __nv_bfloat16* rows,
                           const float* lnw, unsigned int* tickets, int B,
                           int K, int N, float eps, cudaStream_t st) {
  const int G = WT == W_BF16 ? 0 : K / wt.group;
  const size_t smem = gemv_red_bytes<BR>() + gemv_scale_bytes(G);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the attribute is per device, so it is set before every such launch
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<IN, OUT, BR, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // OUT_SILU: a block's columns are gate columns, each with its up column
  const int cols = (OUT == OUT_SILU ? kGemvTiles / 2 : kGemvTiles) * 8;
  const int n = OUT == OUT_SILU ? N / 2 : N;
  const dim3 grid((n + cols - 1) / cols,
                  (B + kRowsPerBlock - 1) / kRowsPerBlock);
  gemv_kernel<IN, OUT, BR, WT><<<grid, kGemvWarps * 32, smem, st>>>(
      in, in_stride, wt.w, wt.scale, wt.group, out, out_stride, rows, lnw,
      tickets, B, K, N, eps);
  return cudaGetLastError();
}

// BR: one m-tile of 16 rows up to 16 rows, two above
template <int IN, int OUT, int WT>
cudaError_t launch_gemv(const void* in, int in_stride, Weights wt,
                        float* out, int out_stride, __nv_bfloat16* rows,
                        const float* lnw, unsigned int* tickets, int B, int K,
                        int N, float eps, cudaStream_t st) {
  if (B <= 16)
    return launch_gemv_br<IN, OUT, 16, WT>(in, in_stride, wt, out,
                                           out_stride, rows, lnw, tickets, B,
                                           K, N, eps, st);
  return launch_gemv_br<IN, OUT, 32, WT>(in, in_stride, wt, out, out_stride,
                                         rows, lnw, tickets, B, K, N, eps,
                                         st);
}

// launch_gemv with the input, the epilogue and the weight tier given at
// run time (the entries for one gemv)
template <int WT>
cudaError_t launch_gemv_any(int in_kind, int out_kind, const void* in,
                            int in_stride, Weights wt, float* out,
                            int out_stride, __nv_bfloat16* rows,
                            const float* lnw, unsigned int* tickets, int B,
                            int K, int N, float eps, cudaStream_t st) {
#define GEMV_CASE(IN, OUT)                                                  \
  if (in_kind == IN && out_kind == OUT)                                     \
    return launch_gemv<IN, OUT, WT>(in, in_stride, wt, out, out_stride,     \
                                    rows, lnw, tickets, B, K, N, eps, st);
  GEMV_CASE(IN_BF16, OUT_STORE)
  GEMV_CASE(IN_BF16, OUT_ADD)
  GEMV_CASE(IN_BF16, OUT_NORM)
  GEMV_CASE(IN_BF16, OUT_SILU)
  GEMV_CASE(IN_F32, OUT_STORE)
  GEMV_CASE(IN_F32, OUT_ADD)
#undef GEMV_CASE
  return cudaErrorInvalidValue;
}

// The rows pass (gemv_kernel_rows) of `mode` on B rows: a block a group
cudaError_t launch_rows(int mode, const float* x, int x_stride,
                        const float* lnw, __nv_bfloat16* rows, int B, int K,
                        float eps, cudaStream_t st) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  if (mode == ROWS_RMS)
    gemv_kernel_rows<ROWS_RMS><<<blocks, kGemvWarps * 32, 0, st>>>(
        x, x_stride, lnw, rows, B, K, eps);
  else
    gemv_kernel_rows<ROWS_SILU><<<blocks, kGemvWarps * 32, 0, st>>>(
        x, x_stride, lnw, rows, B, K, eps);
  return cudaGetLastError();
}

struct StepArgs {
  float *x, *qkv, *o;
  // the gemvs' prepared bf16 rows: (B, D) normed rows for qkv and gate/up,
  // then (B, I) silu rows for down
  __nv_bfloat16* rows;
  const char *wqkv, *wo, *wgu, *wd;         // (L, N, K) of the weight tier
  const float *sqkv, *so, *sgu, *sd;        // (L, N, K / group), or null
  const float *ln1, *ln2, *cosb, *sinb;
  char *kc, *vc;
  const int *cur, *lo;
  // attention scratch: scores (B, H, T), chunk maxima (B, H, S), partials
  // (B, H, S, Dh + 1) f32; tickets (B * H), zero between launches, which
  // the finishing gemvs (wo, down) take too, one a row group
  float *scores, *cmax, *part;
  unsigned int* tickets;
  int B, D, H, Dh, I, L, T, kv_bits, group;
  float eps, scale;
  cudaStream_t st;
};

// One layer's attention on caches kl/vl: the kv4 append (kv4 only), then
// the scores and values passes over the S = ceil(T / kAttnChunk) chunks.
template <int KV>
cudaError_t launch_attend(const StepArgs& a, char* kl, char* vl) {
  const int B = a.B, T = a.T, H = a.H, Dh = a.Dh;
  cudaError_t e;
  if (KV == KV_INT4) {  // the append is its own launch: see kv4_append_kernel
    e = launch_kv4_append(a.qkv, a.cosb, a.sinb, reinterpret_cast<int8_t*>(kl),
                          reinterpret_cast<int8_t*>(vl), a.cur, a.lo, B, T, H,
                          Dh, a.st);
    if (e != cudaSuccess) return e;
  }
  // chunks a row may have, and blocks for them: enough for kAttnBlocks in
  // all, so a long cache's many chunks past every window cost no launch
  // of an empty block, yet a short batch still spreads over the card
  const int S = (T + kAttnChunk - 1) / kAttnChunk;
  const dim3 grid(min(S, (kAttnBlocks + B * H - 1) / (B * H)), H, B);
  attend_scores_kernel<KV><<<grid, kAttnThreads, 0, a.st>>>(
      a.qkv, a.cosb, a.sinb, kl, vl, a.cur, a.lo, a.scores, a.cmax, T, H, Dh,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attend_values_kernel<KV><<<grid, kAttnThreads, 0, a.st>>>(
      vl, a.cur, a.lo, a.scores, a.cmax, a.part, a.tickets, a.o, T, H, Dh);
  return cudaGetLastError();
}

// The layer loop for one weight tier: six launches a layer, seven on kv4,
// and one before the first layer.  Each gemv reads bf16 rows that an
// earlier launch prepared: layer 0's qkv rows come from the rows pass over
// the embedding, wo's finisher writes gate/up's rows (ln2 of the new x),
// gate/up writes down's silu rows, down's finisher the next layer's qkv
// rows (ln1 of the next layer); wo rounds o as it loads it.
template <int WT>
cudaError_t run_layers(const StepArgs& a) {
  const int HD = a.H * a.Dh, D = a.D, I = a.I, B = a.B;
  // bytes of a matrix of n values, and its scales' count
  auto wbytes = [](size_t n) {
    return WT == W_BF16 ? n * 2 : WT == W_INT8 ? n : n / 2;
  };
  const int group = WT == W_BF16 ? 1 : a.group;
  const size_t row_bytes = a.kv_bits == KV_BF16   ? (size_t)HD * 2
                           : a.kv_bits == KV_INT8 ? (size_t)HD + kKvPad
                                                  : (size_t)HD / 2 + kKvPad;
  const size_t layer_bytes = (size_t)B * a.T * row_bytes;
  auto weights = [&](const char* w, const float* s, int l, size_t N, size_t K) {
    return Weights{w + (size_t)l * wbytes(N * K),
                   WT == W_BF16 ? nullptr : s + (size_t)l * N * (K / group),
                   group};
  };
  __nv_bfloat16* hrows = a.rows;                   // (B, D)
  __nv_bfloat16* arows = a.rows + (size_t)B * D;   // (B, I)
  cudaError_t e = launch_rows(ROWS_RMS, a.x, D, a.ln1, hrows, B, D, a.eps,
                              a.st);
  if (e != cudaSuccess) return e;
  for (int l = 0; l < a.L; ++l) {
    char* kl = a.kc + (size_t)l * layer_bytes;
    char* vl = a.vc + (size_t)l * layer_bytes;
    e = launch_gemv<IN_BF16, OUT_STORE, WT>(
        hrows, D, weights(a.wqkv, a.sqkv, l, 3 * HD, D), a.qkv, 3 * HD,
        nullptr, nullptr, nullptr, B, D, 3 * HD, a.eps, a.st);
    if (e != cudaSuccess) return e;
    e = a.kv_bits == KV_INT8   ? launch_attend<KV_INT8>(a, kl, vl)
        : a.kv_bits == KV_INT4 ? launch_attend<KV_INT4>(a, kl, vl)
                               : launch_attend<KV_BF16>(a, kl, vl);
    if (e != cudaSuccess) return e;
    e = launch_gemv<IN_F32, OUT_NORM, WT>(
        a.o, HD, weights(a.wo, a.so, l, D, HD), a.x, D, hrows,
        a.ln2 + (size_t)l * D, a.tickets, B, HD, D, a.eps, a.st);
    if (e != cudaSuccess) return e;
    e = launch_gemv<IN_BF16, OUT_SILU, WT>(
        hrows, D, weights(a.wgu, a.sgu, l, 2 * I, D), nullptr, 0, arows,
        nullptr, nullptr, B, D, 2 * I, a.eps, a.st);
    if (e != cudaSuccess) return e;
    const Weights wd = weights(a.wd, a.sd, l, D, I);
    e = l + 1 < a.L
            ? launch_gemv<IN_BF16, OUT_NORM, WT>(
                  arows, I, wd, a.x, D, hrows, a.ln1 + (size_t)(l + 1) * D,
                  a.tickets, B, I, D, a.eps, a.st)
            : launch_gemv<IN_BF16, OUT_ADD, WT>(arows, I, wd, a.x, D,
                                                nullptr, nullptr, nullptr, B,
                                                I, D, a.eps, a.st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// All pointers are device pointers.  Shapes: emb-derived residual x (B, D)
// f32, updated in place to the pre-final-norm residual; scratch qkv
// (B, 3*HD), o (B, HD) f32, rows (B, D + I) bf16; weights wqkv (L, 3*HD, D),
// wo (L, D, HD), wgu (L, 2*I, D), wd (L, D, I) in bf16 (weight_bits 0), int8
// (8) or nibbles, K/2 bytes a row (4); for 8 and 4 their scales sqkv, so,
// sgu, sd (L, N, K / group) f32, group rows of the contraction to a scale;
// ln1/ln2 (L, D) f32; cos/sin (B, Dh) f32 at each row's rope position;
// caches kc/vc (L, B, T, HD) bf16 (kv_bits 0), (L, B, T, HD + 128) int8 (8)
// or (L, B, T, HD/2 + 128) int8 (4), written only at row cur[b] of row b;
// cur and lo (B,) int32; attention scratch with S = ceil(T / C),
// C = decode_step_attn_chunk(), of any contents: scores (B, H, T), cmax
// (B, H, S), part (B, H, S, Dh + 1) f32; tickets (B * H) uint32, zero on
// entry and left zero, used by no other stream while the step runs (the
// attention pair and the gemvs that finish rows take them in turn).
// Returns the first CUDA error of any launch (0 on success).
int decode_step_launch(void* x, void* qkv, void* o, void* rows,
                       const void* wqkv, const void* wo, const void* wgu,
                       const void* wd, const void* sqkv, const void* so,
                       const void* sgu, const void* sd, const void* ln1,
                       const void* ln2, const void* cosb, const void* sinb,
                       void* kc, void* vc, const void* cur, const void* lo,
                       void* scores, void* cmax, void* part, void* tickets,
                       int B, int D, int H, int Dh, int I, int L, int T,
                       int kv_bits, int weight_bits, int group, float eps,
                       float scale, void* stream) {
  const int HD = H * Dh;
  const bool quant = weight_bits != W_BF16;
  if (B < 1 || B > kMaxB || D % 8 || I % 8 || Dh % 16 || Dh > kMaxDh ||
      T < 1 || (kv_bits && 2 * H > kKvPad) ||
      (kv_bits != KV_BF16 && kv_bits != KV_INT8 && kv_bits != KV_INT4) ||
      (kv_bits == KV_INT4 && (HD % 256 || H % 2 || Dh % 64)) ||
      (weight_bits != W_BF16 && weight_bits != W_INT8 &&
       weight_bits != W_INT4) ||
      (quant && (group < 32 || group % 32 || D % group || HD % group ||
                 I % group || !sqkv || !so || !sgu || !sd)))
    return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.x = static_cast<float*>(x);
  a.qkv = static_cast<float*>(qkv);
  a.o = static_cast<float*>(o);
  a.rows = static_cast<__nv_bfloat16*>(rows);
  a.wqkv = static_cast<const char*>(wqkv);
  a.wo = static_cast<const char*>(wo);
  a.wgu = static_cast<const char*>(wgu);
  a.wd = static_cast<const char*>(wd);
  a.sqkv = static_cast<const float*>(sqkv);
  a.so = static_cast<const float*>(so);
  a.sgu = static_cast<const float*>(sgu);
  a.sd = static_cast<const float*>(sd);
  a.ln1 = static_cast<const float*>(ln1);
  a.ln2 = static_cast<const float*>(ln2);
  a.cosb = static_cast<const float*>(cosb);
  a.sinb = static_cast<const float*>(sinb);
  a.kc = static_cast<char*>(kc);
  a.vc = static_cast<char*>(vc);
  a.cur = static_cast<const int*>(cur);
  a.lo = static_cast<const int*>(lo);
  a.scores = static_cast<float*>(scores);
  a.cmax = static_cast<float*>(cmax);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.B = B, a.D = D, a.H = H, a.Dh = Dh, a.I = I, a.L = L, a.T = T;
  a.kv_bits = kv_bits, a.group = group, a.eps = eps, a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  if (weight_bits == W_INT8) return (int)run_layers<W_INT8>(a);
  if (weight_bits == W_INT4) return (int)run_layers<W_INT4>(a);
  return (int)run_layers<W_BF16>(a);
}

// One gemv of the step's kind, on its own: out (B, N) (=|+=) in' W^T with
// in' given by `mode` (0: x (B, K) f32 rounded as it is loaded; 1: the rms
// rows of x with lnw (K,) and eps; 2: the silu rows of x = [gate | up]
// (B, 2K)), x rows x_stride floats apart, W (N, K) of `weight_bits` (0
// bf16, 8 int8, 4 int4 nibbles) with scale (N, K / group) f32 on a
// quantized tier, out rows out_stride floats apart.  Modes 1 and 2 build
// their bf16 rows into `rows` (B, K) with a rows pass first (two
// launches).  Device pointers; 1 <= B <= 65535, K % 8 == 0, group % 32 ==
// 0 and K % group == 0.  Returns the first CUDA error (0 on success).
int decode_step_gemv(const void* x, int x_stride, const void* lnw,
                     const void* w, const void* scale, int group, void* out,
                     int out_stride, void* rows, int B, int K, int N,
                     int mode, int add, int weight_bits, float eps,
                     void* stream) {
  const bool quant = weight_bits != W_BF16;
  if (B < 1 || B > kMaxB || K < 8 || K % 8 || N < 1 || mode < 0 ||
      mode > ROWS_SILU || (mode == ROWS_RMS && !lnw) || (mode && !rows) ||
      x_stride % 4 || x_stride < (mode == ROWS_SILU ? 2 * K : K) ||
      out_stride < N ||
      (weight_bits != W_BF16 && weight_bits != W_INT8 &&
       weight_bits != W_INT4) ||
      (quant && (group < 32 || group % 32 || K % group || !scale)))
    return (int)cudaErrorInvalidValue;
  const Weights wt{w, static_cast<const float*>(scale), quant ? group : 1};
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  __nv_bfloat16* rb = static_cast<__nv_bfloat16*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in = x;
  int in_kind = IN_F32, in_stride = x_stride;
  if (mode) {
    cudaError_t e = launch_rows(mode, xf, x_stride,
                                static_cast<const float*>(lnw), rb, B, K,
                                eps, st);
    if (e != cudaSuccess) return (int)e;
    in = rows, in_kind = IN_BF16, in_stride = K;
  }
  const int out_kind = add ? OUT_ADD : OUT_STORE;
  if (weight_bits == W_INT8)
    return (int)launch_gemv_any<W_INT8>(in_kind, out_kind, in, in_stride, wt,
                                        of, out_stride, nullptr, nullptr,
                                        nullptr, B, K, N, eps, st);
  if (weight_bits == W_INT4)
    return (int)launch_gemv_any<W_INT4>(in_kind, out_kind, in, in_stride, wt,
                                        of, out_stride, nullptr, nullptr,
                                        nullptr, B, K, N, eps, st);
  return (int)launch_gemv_any<W_BF16>(in_kind, out_kind, in, in_stride, wt,
                                      of, out_stride, nullptr, nullptr,
                                      nullptr, B, K, N, eps, st);
}

// The rows pass on its own: rows (B, K) bf16 from x (B, K) f32 with lnw
// (K,) for mode 1 (rms), from x = [gate | up] (B, 2K) for mode 2 (silu), x
// rows x_stride floats apart.  Device pointers; 1 <= B <= 65535, K % 8 ==
// 0.  Returns the CUDA error (0 on success).
int decode_step_rows(const void* x, int x_stride, const void* lnw,
                     void* rows, int B, int K, int mode, float eps,
                     void* stream) {
  if (B < 1 || B > kMaxB || K < 8 || K % 8 || x_stride % 4 ||
      (mode != ROWS_RMS && mode != ROWS_SILU) || (mode == ROWS_RMS && !lnw) ||
      x_stride < (mode == ROWS_SILU ? 2 * K : K))
    return (int)cudaErrorInvalidValue;
  return (int)launch_rows(mode, static_cast<const float*>(x), x_stride,
                          static_cast<const float*>(lnw),
                          static_cast<__nv_bfloat16*>(rows), B, K, eps,
                          static_cast<cudaStream_t>(stream));
}

// One gemv as the step launches it, on prepared bf16 rows in (B, K): the
// epilogue `out_kind` (0 out = y, 1 out += y, 2 out += y and rows_out
// (B, N) bf16 = the rms rows of the new out with lnw (N,), 3 rows_out
// (B, N / 2) bf16 = silu(y[:, :N/2]) * y[:, N/2:]), y = in W^T; out (B, N)
// f32 contiguous (unused by 3); tickets (ceil(B / 32)) zero, left zero.
// W and scale as decode_step_gemv takes them.  Returns the first CUDA
// error (0 on success).
int decode_step_gemv_rows(const void* in, const void* w, const void* scale,
                          int group, void* out, void* rows_out,
                          const void* lnw, void* tickets, int B, int K,
                          int N, int out_kind, int weight_bits, float eps,
                          void* stream) {
  const bool quant = weight_bits != W_BF16;
  if (B < 1 || B > kMaxB || K < 8 || K % 8 || N < 1 || out_kind < OUT_STORE ||
      out_kind > OUT_SILU || (out_kind != OUT_SILU && !out) ||
      (out_kind >= OUT_NORM && !rows_out) ||
      (out_kind == OUT_NORM && (!lnw || !tickets || N % 8)) ||
      (out_kind == OUT_SILU && N % 2) ||
      (weight_bits != W_BF16 && weight_bits != W_INT8 &&
       weight_bits != W_INT4) ||
      (quant && (group < 32 || group % 32 || K % group || !scale)))
    return (int)cudaErrorInvalidValue;
  const Weights wt{w, static_cast<const float*>(scale), quant ? group : 1};
  float* of = static_cast<float*>(out);
  __nv_bfloat16* rb = static_cast<__nv_bfloat16*>(rows_out);
  const float* lf = static_cast<const float*>(lnw);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bits == W_INT8)
    return (int)launch_gemv_any<W_INT8>(IN_BF16, out_kind, in, K, wt, of, N,
                                        rb, lf, tk, B, K, N, eps, st);
  if (weight_bits == W_INT4)
    return (int)launch_gemv_any<W_INT4>(IN_BF16, out_kind, in, K, wt, of, N,
                                        rb, lf, tk, B, K, N, eps, st);
  return (int)launch_gemv_any<W_BF16>(IN_BF16, out_kind, in, K, wt, of, N, rb,
                                      lf, tk, B, K, N, eps, st);
}

// One layer's kv4 append on its own (the step's seventh launch on the int4
// cache): rope k of qkv (B, 3 HD) f32 with cos/sin (B, Dh) f32, quantize k
// and v per head and write row cur[b] of row b of kc/vc (B, T, HD/2 + 128)
// int8, pad zeroed, where cur[b] is in [0, T) and sees a key from lo[b];
// other rows are not touched.  Device pointers, kc and vc 16-byte aligned;
// H even, Dh 64 or 128, H * Dh % 256 == 0.  Returns the CUDA error (0 on
// success).
int decode_step_kv4_append(const void* qkv, const void* cosb,
                           const void* sinb, void* kc, void* vc,
                           const void* cur, const void* lo, int B, int T,
                           int H, int Dh, void* stream) {
  return (int)launch_kv4_append(
      static_cast<const float*>(qkv), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<int8_t*>(kc),
      static_cast<int8_t*>(vc), static_cast<const int*>(cur),
      static_cast<const int*>(lo), B, T, H, Dh,
      static_cast<cudaStream_t>(stream));
}

// One layer's attention on its own, as the step runs it (the kv4 append
// first on the int4 cache, then the scores and values passes): a tensor-
// parallel rank launches it between its qkv and wo gemvs on its own heads.
// qkv (B, 3 HD) f32 from the qkv gemv, cos/sin (B, Dh) f32; the layer's
// caches kc/vc (B, T, W) of the tier kv_bits (0 bf16, 8 int8, 4 int4), row
// cur[b] of row b appended; cur and lo (B,) int32; the attention scratch
// and tickets as decode_step_launch takes them; o (B, HD) f32 out.  H and
// Dh are the rank's: a quantized row's scale lanes are its H heads'.
// Returns the first CUDA error (0 on success).
int decode_step_attend(const void* qkv, const void* cosb, const void* sinb,
                       void* kc, void* vc, const void* cur, const void* lo,
                       void* scores, void* cmax, void* part, void* tickets,
                       void* o, int B, int T, int H, int Dh, int kv_bits,
                       float scale, void* stream) {
  if (B < 1 || B > kMaxB || H < 1 || Dh % 16 || Dh > kMaxDh || T < 1 ||
      (kv_bits && 2 * H > kKvPad) ||
      (kv_bits != KV_BF16 && kv_bits != KV_INT8 && kv_bits != KV_INT4) ||
      (kv_bits == KV_INT4 && ((H * Dh) % 256 || H % 2 || Dh % 64)))
    return (int)cudaErrorInvalidValue;
  StepArgs a{};
  a.qkv = static_cast<float*>(const_cast<void*>(qkv));
  a.o = static_cast<float*>(o);
  a.cosb = static_cast<const float*>(cosb);
  a.sinb = static_cast<const float*>(sinb);
  a.cur = static_cast<const int*>(cur);
  a.lo = static_cast<const int*>(lo);
  a.scores = static_cast<float*>(scores);
  a.cmax = static_cast<float*>(cmax);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.B = B, a.H = H, a.Dh = Dh, a.T = T, a.kv_bits = kv_bits, a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  char* kl = static_cast<char*>(kc);
  char* vl = static_cast<char*>(vc);
  if (kv_bits == KV_INT8) return (int)launch_attend<KV_INT8>(a, kl, vl);
  if (kv_bits == KV_INT4) return (int)launch_attend<KV_INT4>(a, kl, vl);
  return (int)launch_attend<KV_BF16>(a, kl, vl);
}

// Keys of a row's window one attention block owns, as built.
int decode_step_attn_chunk() { return kAttnChunk; }

}  // extern "C"
