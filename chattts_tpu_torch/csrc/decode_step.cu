// One whole autoregressive decode step (all L layers) for the Llama decoder
// with bf16 weights.  Replaces the Pallas TPU kernel
// chattts_tpu/ops/pallas_step.py::_kernel in four of its variants:
//   K1    bf16 KV cache, one shared write position `cur`
//   K2    bf16 KV cache, a write position per row (continuous batching)
//   K3    int8 KV cache with embedded per-(token, head) scales, shared `cur`
//   K2+K3 int8 KV cache, a write position per row
// `cur` is always a device array of B positions (a shared position is the
// array with equal entries), so no launch depends on a host copy of it; the
// cache type is a template parameter of the attention kernel.  Per layer:
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
// A row's result depends on that row's inputs only, never on B or on the
// other rows: every sum runs in an order fixed by the row's own shapes.
//
// Bound on an H100: the step streams every weight once,
// L*(4*D*D + 3*D*I)*2 bytes (377 MB at D 768, I 3072, L 20: ~113 us at
// 3.35 TB/s), plus 2*L*sum_b(cur_b-lo_b+1)*W bytes of KV reads and 2*L*B*W
// of appended rows, W = 2*HD (bf16) or HD+128 (int8).  Its arithmetic
// intensity is ~B flop/byte, far below the ~295 the tensor cores need, so
// it is bound by bytes.  The design therefore reads each weight byte once
// per step: `gemv` gives every block a tile of output columns for ALL B
// rows, with weights stored (N, K) so a warp streams one contiguous row
// with 16-byte loads while the bf16 input rows sit in shared memory.  The
// TPU kernel's sequential layer grid becomes a host loop over layers (five
// launches a layer); its slab DMA ring, chunking and aligned append windows
// are TPU mechanics with no counterpart here.  Launch overhead, not bytes,
// is expected to dominate this first version; CUDA graphs, split-T
// attention and a TMA/wgmma weight stream are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libdecode_step.so decode_step.cu
// Bound to Python with ctypes (chattts_tpu_torch/ops/decode_step.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 32;        // most batch rows a step takes
constexpr int kKvPad = 128;      // pad lanes of an int8 cache row
constexpr int kGemvWarps = 4;    // warps per gemv block
constexpr int kColsPerWarp = 2;  // output columns per warp
constexpr int kAttnThreads = 128;
// dynamic shared memory a launch may take without opting in: the 48 KB
// default, less room for the kernels' small static arrays
constexpr size_t kDefaultSmem = 46 * 1024;

enum InMode { IN_NONE = 0, IN_RMS = 1, IN_SILU = 2 };

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

// out[b, n] (=|+=) sum_k bf16(in'[b, k]) * W[n, k]   for b < B, n < N
// in' is the prologue's transform of x:
//   IN_NONE: x[b, k]
//   IN_RMS:  x[b, k] * rsqrt(mean_k x[b, :]^2 + eps) * lnw[k]
//   IN_SILU: silu(x[b, k]) * x[b, K + k]      (x holds [gate | up])
// W is (N, K) row-major bf16; K % 8 == 0; x rows are x_stride floats apart.
// BR (16 or 32) is the number of row accumulators a warp carries; a row's
// sum does not depend on it.
template <int MODE, bool ADD, int BR>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel(const float* __restrict__ x, int x_stride,
            const float* __restrict__ lnw, const __nv_bfloat16* __restrict__ W,
            float* __restrict__ out, int out_stride, int B, int K, int N,
            float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [B][K]
  __shared__ float rscale[kMaxB];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Prologue: every block builds the bf16 input rows in shared memory from
  // the f32 rows (L2-resident, a few KB).  Loads are 16 bytes wide and the
  // loops unrolled so many are in flight: the prologue is latency-bound.
  if (MODE == IN_RMS) {
    for (int b = warp; b < B; b += kGemvWarps) {
      const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * x_stride);
      float ss = 0.f;
#pragma unroll 4
      for (int k4 = lane; k4 < K / 4; k4 += 32) {
        const float4 v = xr[k4];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      ss = warp_sum(ss);
      if (lane == 0) rscale[b] = rsqrtf(ss / (float)K + eps);
    }
    __syncthreads();
  }
  const int K8 = K / 8;
#pragma unroll 4
  for (int i = tid; i < B * K8; i += blockDim.x) {
    const int b = i / K8, k = (i - b * K8) * 8;
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * x_stride + k);
    float v[8];
    *reinterpret_cast<float4*>(v) = xr[0];
    *reinterpret_cast<float4*>(v + 4) = xr[1];
    if (MODE == IN_RMS) {
      const float4* wr = reinterpret_cast<const float4*>(lnw + k);
      float w[8];
      *reinterpret_cast<float4*>(w) = wr[0];
      *reinterpret_cast<float4*>(w + 4) = wr[1];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (v[j] * rscale[b]) * w[j];
    } else if (MODE == IN_SILU) {
      const float4* ur = reinterpret_cast<const float4*>(x + (size_t)b * x_stride + K + k);
      float u[8];
      *reinterpret_cast<float4*>(u) = ur[0];
      *reinterpret_cast<float4*>(u + 4) = ur[1];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (v[j] / (1.f + expf(-v[j]))) * u[j];
    }
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) p2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(xs + (size_t)b * K + k) = packed;
  }
  __syncthreads();

  const int n0 = (blockIdx.x * kGemvWarps + warp) * kColsPerWarp;
  if (n0 >= N) return;
  float acc[kColsPerWarp][BR];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int b = 0; b < BR; ++b) acc[c][b] = 0.f;

  const __nv_bfloat16* wrow[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int n = min(n0 + c, N - 1);  // a ragged last column recomputes N-1
    wrow[c] = W + (size_t)n * K;
  }
#pragma unroll 2
  for (int k0 = lane * 8; k0 < K; k0 += 256) {
    float wf[kColsPerWarp][8];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow[c] + k0));
      unpack8(wv, wf[c]);
    }
#pragma unroll
    for (int b = 0; b < BR; ++b) {
      if (b < B) {
        float xf[8];
        unpack8(*reinterpret_cast<const uint4*>(xs + (size_t)b * K + k0), xf);
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][b] = fmaf(xf[j], wf[c][j], acc[c][b]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int n = n0 + c;
#pragma unroll
    for (int b = 0; b < BR; ++b) {
      if (b < B) {
        const float s = warp_sum(acc[c][b]);
        if (lane == 0 && n < N) {
          float* dst = out + (size_t)b * out_stride + n;
          if (ADD) *dst += s; else *dst = s;
        }
      }
    }
  }
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Quantize one head of an appended row: x holds the head's Dh f32 values in
// shared memory; row points at the int8 cache row.  Every thread derives the
// head's scale (the same value), thread d stores value d, thread 0 the scale
// bytes.  The arithmetic is ops/kv_quant.py::head_scales, step for step.
__device__ __forceinline__ void kv8_append_head(const float* x, int8_t* row,
                                                int h, int H, int Dh) {
  float a = 0.f;
  for (int d = 0; d < Dh; ++d) a = fmaxf(a, fabsf(x[d]));
  const float sc = a / 127.0f;
  int e = ilogbf(fmaxf(sc, 1e-30f));            // floor(log2), exact
  float mant = ceilf(ldexpf(sc, -e) * 64.0f);   // in [64, 128]
  if (mant > 127.0f) {
    e += 1;
    mant = 64.0f;
  }
  if (!(a > 0.0f)) mant = 0.0f;
  const int es = min(max(e - 6, -126), 126);
  const float div = fmaxf(ldexpf(mant, es), 1e-30f);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    const float q = fminf(fmaxf(rintf(x[d] / div), -127.0f), 127.0f);
    row[h * Dh + d] = (int8_t)q;
  }
  if (threadIdx.x == 0) {
    row[H * Dh + h] = (int8_t)mant;
    row[H * Dh + H + h] = (int8_t)es;
  }
}

// One block per (head h, row b): rope q and k, append k and v at row cur[b]
// of this layer's cache, then attend q over rows [lo[b], cur[b]] of the
// cache and write o[b, h*Dh:(h+1)*Dh].  Rows outside the window are never
// read, and only row cur[b] is written.  KV8 selects the int8 row format.
// A position outside [0, T), or a window with no key, is not clamped: the
// row's output is NaN, so the fault shows in the step's result.
// Dh divides blockDim (128); shared memory holds Dh bf16-rounded query
// values, the f32 k and v of the head (KV8), T scores and the partial sums.
template <bool KV8>
__global__ void __launch_bounds__(kAttnThreads)
rope_append_attend_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ cosb,
                          const float* __restrict__ sinb,
                          void* __restrict__ kc_raw, void* __restrict__ vc_raw,
                          const int* __restrict__ cur,
                          const int* __restrict__ lo, float* __restrict__ o,
                          int T, int H, int Dh, float scale) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kAttnThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int HD = H * Dh, half = Dh / 2;
  const int W = KV8 ? HD + kKvPad : HD;  // cache row width in elements
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  float* qs = sm;                     // [Dh]
  float* kf = qs + Dh;                // [Dh] roped k, f32 (KV8)
  float* vf = kf + Dh;                // [Dh] v, f32 (KV8)
  float* part = vf + Dh;              // [nthreads]
  float* sc = part + nthreads;        // [T]
  __nv_bfloat16* kcb = static_cast<__nv_bfloat16*>(kc_raw);
  __nv_bfloat16* vcb = static_cast<__nv_bfloat16*>(vc_raw);
  int8_t* kc8 = static_cast<int8_t*>(kc_raw);
  int8_t* vc8 = static_cast<int8_t*>(vc_raw);

  const int c = cur[b];
  const int lob = max(lo[b], 0);
  const int n = c - lob + 1;
  if (c < 0 || c >= T || n <= 0) {  // uniform over the block
    for (int d = tid; d < Dh; d += nthreads)
      o[(size_t)b * HD + (size_t)h * Dh + d] = __int_as_float(0x7fc00000);
    return;
  }

  const float* q = qkv + (size_t)b * 3 * HD + h * Dh;
  const float* k = q + HD;
  const float* v = q + 2 * HD;
  const size_t row_cur = ((size_t)b * T + c) * W;
  for (int d = tid; d < Dh; d += nthreads) {
    const float cs = cosb[b * Dh + d], sn = sinb[b * Dh + d];
    const float rq = d < half ? -bf16_round(q[d + half]) : bf16_round(q[d - half]);
    const float rk = d < half ? -bf16_round(k[d + half]) : bf16_round(k[d - half]);
    const float qr = q[d] * cs + rq * sn;
    const float kr = k[d] * cs + rk * sn;
    if (KV8) {
      kf[d] = kr;
      vf[d] = v[d];
    } else {
      kcb[row_cur + (size_t)h * Dh + d] = __float2bfloat16_rn(kr);
      vcb[row_cur + (size_t)h * Dh + d] = __float2bfloat16_rn(v[d]);
    }
    qs[d] = bf16_round(qr * scale);
  }
  __syncthreads();  // qs (and kf, vf, or the appended row) visible block-wide
  if (KV8) {
    kv8_append_head(kf, kc8 + row_cur, h, H, Dh);
    kv8_append_head(vf, vc8 + row_cur, h, H, Dh);
    if (h == 0) {  // the lanes after the scales are written zero
      for (int i = HD + 2 * H + tid; i < W; i += nthreads) {
        kc8[row_cur + i] = 0;
        vc8[row_cur + i] = 0;
      }
    }
    __syncthreads();  // the appended row is visible block-wide
  }

  for (int i = warp; i < n; i += nwarps) {
    const size_t row = ((size_t)b * T + lob + i) * W;
    float a = 0.f;
    if (KV8) {
      const int8_t* kr = kc8 + row;
      for (int d = lane; d < Dh; d += 32)
        a = fmaf((float)kr[h * Dh + d], qs[d], a);
      a = warp_sum(a);
      if (lane == 0) sc[i] = a * ldexpf((float)kr[HD + h], (int)kr[HD + H + h]);
    } else {
      const __nv_bfloat16* kr = kcb + row + (size_t)h * Dh;
      for (int d = lane; d < Dh; d += 32) a = fmaf(__bfloat162float(kr[d]), qs[d], a);
      a = warp_sum(a);
      if (lane == 0) sc[i] = a;
    }
  }
  __syncthreads();
  float m = -1e30f;
  for (int i = tid; i < n; i += nthreads) m = fmaxf(m, sc[i]);
  m = block_reduce(m, red, true);
  float l = 0.f;
  for (int i = tid; i < n; i += nthreads) {
    const float p = expf(sc[i] - m);
    l += p;
    if (KV8) {  // the value row's scale goes into p before its rounding
      const int8_t* vr = vc8 + ((size_t)b * T + lob + i) * W;
      sc[i] = bf16_round(p * ldexpf((float)vr[HD + h], (int)vr[HD + H + h]));
    } else {
      sc[i] = bf16_round(p);
    }
  }
  l = block_reduce(l, red, false);  // its barriers also publish sc

  const int d = tid % Dh, slice = tid / Dh, nslices = nthreads / Dh;
  float a = 0.f;
  for (int i = slice; i < n; i += nslices) {
    const size_t row = ((size_t)b * T + lob + i) * W + (size_t)h * Dh + d;
    const float vv = KV8 ? (float)vc8[row] : __bfloat162float(vcb[row]);
    a = fmaf(sc[i], vv, a);
  }
  part[tid] = a;
  __syncthreads();
  if (slice == 0) {
    for (int s2 = 1; s2 < nslices; ++s2) a += part[s2 * Dh + d];
    o[(size_t)b * HD + (size_t)h * Dh + d] = a / l;
  }
}

template <int MODE, bool ADD, int BR>
cudaError_t launch_gemv_rows(const float* x, int x_stride, const float* lnw,
                             const __nv_bfloat16* W, float* out,
                             int out_stride, int B, int K, int N, float eps,
                             cudaStream_t st) {
  const size_t smem = (size_t)B * K * sizeof(__nv_bfloat16);
  // the attribute is per device, so it is set before every such launch
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<MODE, ADD, BR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int cols = kGemvWarps * kColsPerWarp;
  gemv_kernel<MODE, ADD, BR>
      <<<(N + cols - 1) / cols, kGemvWarps * 32, smem, st>>>(
          x, x_stride, lnw, W, out, out_stride, B, K, N, eps);
  return cudaGetLastError();
}

template <int MODE, bool ADD>
cudaError_t launch_gemv(const float* x, int x_stride, const float* lnw,
                        const __nv_bfloat16* W, float* out, int out_stride,
                        int B, int K, int N, float eps, cudaStream_t st) {
  if (B <= 16)
    return launch_gemv_rows<MODE, ADD, 16>(x, x_stride, lnw, W, out,
                                           out_stride, B, K, N, eps, st);
  return launch_gemv_rows<MODE, ADD, 32>(x, x_stride, lnw, W, out, out_stride,
                                         B, K, N, eps, st);
}

template <bool KV8>
cudaError_t launch_attend(const float* qkv, const float* cosb,
                          const float* sinb, void* kc, void* vc,
                          const int* cur, const int* lo, float* o, int B,
                          int T, int H, int Dh, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(3 * Dh + kAttnThreads + T) * sizeof(float);
  if (smem > kDefaultSmem) {  // per device: set on every call
    cudaError_t e = cudaFuncSetAttribute(
        rope_append_attend_kernel<KV8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rope_append_attend_kernel<KV8><<<dim3(H, B), kAttnThreads, smem, st>>>(
      qkv, cosb, sinb, kc, vc, cur, lo, o, T, H, Dh, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers.  Shapes: emb-derived residual x (B, D)
// f32, updated in place to the pre-final-norm residual; scratch qkv
// (B, 3*HD), o (B, HD), gu (B, 2*I) f32; weights wqkv (L, 3*HD, D),
// wo (L, D, HD), wgu (L, 2*I, D), wd (L, D, I) bf16; ln1/ln2 (L, D) f32;
// cos/sin (B, Dh) f32 at each row's rope position; caches kc/vc
// (L, B, T, HD) bf16 (kv8 == 0) or (L, B, T, HD + 128) int8 (kv8 == 1),
// written only at row cur[b] of row b; cur and lo (B,) int32.
// Returns the first CUDA error of any launch (0 on success).
int decode_step_launch(void* x, void* qkv, void* o, void* gu,
                       const void* wqkv, const void* wo, const void* wgu,
                       const void* wd, const void* ln1, const void* ln2,
                       const void* cosb, const void* sinb, void* kc, void* vc,
                       const void* cur, const void* lo, int B, int D, int H,
                       int Dh, int I, int L, int T, int kv8, float eps,
                       float scale, void* stream) {
  if (B < 1 || B > kMaxB || D % 8 || I % 8 || (H * Dh) % 8 ||
      kAttnThreads % Dh || T < 1 || (kv8 && 2 * H > kKvPad))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HD = H * Dh;
  float* xf = static_cast<float*>(x);
  float* qkvf = static_cast<float*>(qkv);
  float* of = static_cast<float*>(o);
  float* guf = static_cast<float*>(gu);
  const __nv_bfloat16* Wqkv = static_cast<const __nv_bfloat16*>(wqkv);
  const __nv_bfloat16* Wo = static_cast<const __nv_bfloat16*>(wo);
  const __nv_bfloat16* Wgu = static_cast<const __nv_bfloat16*>(wgu);
  const __nv_bfloat16* Wd = static_cast<const __nv_bfloat16*>(wd);
  const float* l1 = static_cast<const float*>(ln1);
  const float* l2 = static_cast<const float*>(ln2);
  const float* cosf_ = static_cast<const float*>(cosb);
  const float* sinf_ = static_cast<const float*>(sinb);
  const int* curp = static_cast<const int*>(cur);
  const int* lop = static_cast<const int*>(lo);
  // bytes of one layer's cache
  const size_t layer_bytes =
      (size_t)B * T * (kv8 ? (size_t)(HD + kKvPad) : (size_t)HD * 2);

  cudaError_t e;
  for (int l = 0; l < L; ++l) {
    char* kl = static_cast<char*>(kc) + (size_t)l * layer_bytes;
    char* vl = static_cast<char*>(vc) + (size_t)l * layer_bytes;
    e = launch_gemv<IN_RMS, false>(xf, D, l1 + (size_t)l * D,
                                   Wqkv + (size_t)l * 3 * HD * D, qkvf, 3 * HD,
                                   B, D, 3 * HD, eps, st);
    if (e != cudaSuccess) return (int)e;
    e = kv8 ? launch_attend<true>(qkvf, cosf_, sinf_, kl, vl, curp, lop, of, B,
                                  T, H, Dh, scale, st)
            : launch_attend<false>(qkvf, cosf_, sinf_, kl, vl, curp, lop, of,
                                   B, T, H, Dh, scale, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_gemv<IN_NONE, true>(of, HD, nullptr, Wo + (size_t)l * D * HD, xf,
                                   D, B, HD, D, eps, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_gemv<IN_RMS, false>(xf, D, l2 + (size_t)l * D,
                                   Wgu + (size_t)l * 2 * I * D, guf, 2 * I, B,
                                   D, 2 * I, eps, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_gemv<IN_SILU, true>(guf, 2 * I, nullptr, Wd + (size_t)l * D * I,
                                   xf, D, B, I, D, eps, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
