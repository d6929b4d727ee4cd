// Fused decode-layer qkv head for M = 1..8 AR decode rows:
// RMSNorm or LayerNorm -> fused-QKV matvec (bf16 or int8 weights with a
// per-column scale) -> bias -> per-head q/k RMSNorm -> half-split RoPE.
//
// Replaces tts_tpu/ops/decode_qkv.py:fused_qkv_rope (Pallas body _kernel
// and the epilogues _norm_rope/_rope_only). Same rounding points: the
// normed input is rounded to bf16; the dot accumulates in fp32 and is
// rounded to bf16; the int8 scale is rounded to bf16 and multiplied in
// bf16, then the bf16 bias added; the per-head norm runs in fp32 (times its
// weight) and is rounded once; the rotation is hs*c + rot*s with each of
// the three ops rounded to bf16.
//
// What bounds it on an H100: the weight stream, 4 MB of bf16 (2 MB of
// int8) a layer at Kani width, about 1.2 us at 3.35 TB/s, against a few us
// of launch and latency for a matvec this small. Design: two launches.
//  1. qkv_matvec_kernel: a grid of (column tiles of 256) x (input-dim
//     slices), about two blocks per SM so the whole card streams the
//     weights. Each block computes the row statistics of x over the full
//     row, stages its slice of the normed input (rounded to bf16) in shared
//     memory, and its 8 warps each take every 8th input row of the slice:
//     a lane reads 8 consecutive weights in one 16-byte (bf16) or 8-byte
//     (int8) load, converts them in registers and accumulates all B rows.
//     The warps' sums meet in shared memory and the block writes one fp32
//     partial per (slice, row, column). No atomics: runs are bitwise
//     reproducible.
//  2. qkv_epilogue_kernel: one block per (head, row) of head_dim threads
//     sums the slices' partials in a fixed order and runs the epilogue,
//     which needs whole heads (the norm's statistic, the rotation's pairs).
#include "qkv_epilogue.cuh"

namespace tts {
namespace {

constexpr int MV_THREADS = 256;
constexpr int MV_WARPS = MV_THREADS / 32;
constexpr int MV_COLS = 256;   // columns per block: 32 lanes x 8

// 8 weights at w[0..8) as fp32
__device__ __forceinline__ void load8(const bf16* w, float* out) {
  Vec8 v;
  v.u = *reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = to_f(v.h[e]);
}
__device__ __forceinline__ void load8(const int8_t* w, float* out) {
  union {
    uint2 u;
    int8_t c[8];
  } v;
  v.u = *reinterpret_cast<const uint2*>(w);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = (float)v.c[e];
}

template <typename W, int NB>
__global__ void __launch_bounds__(MV_THREADS)
qkv_matvec_kernel(const bf16* __restrict__ x, const W* __restrict__ w,
                  const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
                  float* __restrict__ partial, int H, int N, int kslice,
                  float eps) {
  extern __shared__ float hs[];            // [NB][kslice] normed input slice
  __shared__ float red[MV_WARPS][MV_COLS];
  __shared__ float stat[2][NB];            // per row: mean, 1/sqrt(var+eps)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * kslice;
  const int kn = min(H, k0 + kslice) - k0;

  // row statistics over the whole row, one warp per row
  for (int b = warp; b < NB; b += MV_WARPS) {
    const bf16* xr = x + (size_t)b * H;
    float mean = 0.f, var = 0.f;
    if (lnw) {
      float s = 0.f;
      for (int k = lane; k < H; k += 32) s += to_f(xr[k]);
      mean = warp_sum(s) / (float)H;
      for (int k = lane; k < H; k += 32) {
        const float d = to_f(xr[k]) - mean;
        var += d * d;
      }
    } else {
      for (int k = lane; k < H; k += 32) {
        const float v = to_f(xr[k]);
        var += v * v;
      }
    }
    var = warp_sum(var) / (float)H;
    if (lane == 0) {
      stat[0][b] = mean;
      stat[1][b] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NB * kn; i += MV_THREADS) {
    const int b = i / kn, k = k0 + i % kn;
    float v = (to_f(x[(size_t)b * H + k]) - stat[0][b]) * stat[1][b];
    if (lnw) v = __fadd_rn(__fmul_rn(v, to_f(lnw[k])), to_f(lnb[k]));
    hs[i] = rnd(v);
  }
  __syncthreads();

  const int col = blockIdx.x * MV_COLS + lane * 8;
  float acc[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;
  if (col < N) {
#pragma unroll 4
    for (int r = warp; r < kn; r += MV_WARPS) {
      float wv[8];
      load8(w + (size_t)(k0 + r) * N + col, wv);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float hv = hs[b * kn + r];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(hv, wv[e], acc[b][e]);
      }
    }
  }
  const int c = blockIdx.x * MV_COLS + threadIdx.x;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp][lane * 8 + e] = acc[b][e];
    __syncthreads();
    if (c < N) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MV_WARPS; ++i) s += red[i][threadIdx.x];
      partial[((size_t)blockIdx.y * NB + b) * N + c] = s;
    }
    __syncthreads();
  }
}

template <int HD>
__global__ void __launch_bounds__(HD)
qkv_epilogue_kernel(const float* __restrict__ partial, int ksplit, int B, int N,
                    const float* __restrict__ scale, const bf16* __restrict__ bias,
                    const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                    const bf16* __restrict__ cosr, const bf16* __restrict__ sinr,
                    int heads, int kv_heads, float eps, bf16* __restrict__ q,
                    bf16* __restrict__ k, bf16* __restrict__ v) {
  __shared__ float scratch[HD / 32];
  __shared__ float row[HD];
  const int head = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const bool is_q = head < heads;
  const bf16* nw = is_q ? qn : kn;
  const float nw_i = nw ? to_f(nw[i]) : 0.f;
  const float cos_i = cosr ? to_f(cosr[i]) : 0.f, sin_i = cosr ? to_f(sinr[i]) : 0.f;
  float val = qkv_column(partial, ksplit, B, N, b, head * HD + i, scale, bias);
  if (head >= heads + kv_heads) {            // v: no norm, no rotation
    v[(size_t)b * kv_heads * HD + (head - heads - kv_heads) * HD + i] = to_bf(val);
    return;
  }
  val = norm_rope<HD>(val, false, nw, nw_i, cosr, cos_i, sin_i, eps, scratch, row);
  if (is_q)
    q[(size_t)b * heads * HD + head * HD + i] = to_bf(val);
  else
    k[(size_t)b * kv_heads * HD + (head - heads) * HD + i] = to_bf(val);
}

template <typename W, int NB>
cudaError_t launch_matvec(const bf16* x, const W* w, const bf16* lnw, const bf16* lnb,
                          float* partial, int H, int N, int ksplit, int kslice,
                          float eps, cudaStream_t s) {
  const dim3 grid((N + MV_COLS - 1) / MV_COLS, ksplit);
  const size_t smem = sizeof(float) * NB * kslice;
  qkv_matvec_kernel<W, NB><<<grid, MV_THREADS, smem, s>>>(x, w, lnw, lnb, partial,
                                                          H, N, kslice, eps);
  return cudaGetLastError();
}

template <typename W>
cudaError_t dispatch_matvec(int B, const bf16* x, const W* w, const bf16* lnw,
                            const bf16* lnb, float* partial, int H, int N, int ksplit,
                            int kslice, float eps, cudaStream_t s) {
  switch (B) {
#define TTS_MV_CASE(nb) \
  case nb:              \
    return launch_matvec<W, nb>(x, w, lnw, lnb, partial, H, N, ksplit, kslice, eps, s);
    TTS_MV_CASE(1)
    TTS_MV_CASE(2)
    TTS_MV_CASE(3)
    TTS_MV_CASE(4)
    TTS_MV_CASE(5)
    TTS_MV_CASE(6)
    TTS_MV_CASE(7)
    TTS_MV_CASE(8)
#undef TTS_MV_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tts

// The qkv head's first launch: x (B, H) bf16; w (H, N) bf16, or int8 when
// w_int8; ln_w/ln_b (H,) bf16 or null (LayerNorm when given, else the
// weightless RMSNorm); partial (ksplit, B, N) fp32; B 1..8, ksplit *
// kslice >= H with kslice a multiple of 8. Kernel 12 (decode_step.cu) runs
// it ahead of its attention launch, which takes the epilogue.
extern "C" int qkv_matvec(const void* x, const void* w, int w_int8, const void* lnw,
                          const void* lnb, void* partial, int B, int H, int N, int ksplit,
                          int kslice, float eps, void* stream) {
  using tts::bf16;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(w_int8 ? tts::dispatch_matvec(B, (const bf16*)x, (const int8_t*)w,
                                             (const bf16*)lnw, (const bf16*)lnb,
                                             (float*)partial, H, N, ksplit, kslice, eps, s)
                      : tts::dispatch_matvec(B, (const bf16*)x, (const bf16*)w,
                                             (const bf16*)lnw, (const bf16*)lnb,
                                             (float*)partial, H, N, ksplit, kslice, eps, s));
}

// x (B, H) bf16; w (H, N) bf16, or int8 when w_int8 with scale (N,) fp32;
// bias (N,), q_norm/k_norm (hd,), cos/sin (hd,), ln_w/ln_b (H,) bf16, each
// optional (null); partial (ksplit, B, N) fp32 scratch; q (B, heads*hd),
// k/v (B, kv_heads*hd) bf16. N = (heads + 2*kv_heads) * hd, hd 64 or 128,
// B 1..8, ksplit * kslice >= H with kslice a multiple of 8. LayerNorm when
// ln_w is given, else the weightless RMSNorm.
extern "C" int fused_qkv_rope(const void* x, const void* w, int w_int8,
                              const void* scale, const void* bias, const void* qn,
                              const void* kn, const void* cosr, const void* sinr,
                              const void* lnw, const void* lnb, void* partial, void* q,
                              void* k, void* v, int B, int H, int heads, int kv_heads,
                              int hd, int ksplit, int kslice, float eps, void* stream) {
  using tts::bf16;
  cudaStream_t s = (cudaStream_t)stream;
  const int N = (heads + 2 * kv_heads) * hd;
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  const int err = qkv_matvec(x, w, w_int8, lnw, lnb, partial, B, H, N, ksplit, kslice, eps,
                             stream);
  if (err) return err;
  const dim3 grid(heads + 2 * kv_heads, B);
#define TTS_EPI_ARGS                                                                  \
  (const float*)partial, ksplit, B, N, (const float*)scale, (const bf16*)bias,        \
      (const bf16*)qn, (const bf16*)kn, (const bf16*)cosr, (const bf16*)sinr, heads, \
      kv_heads, eps, (bf16*)q, (bf16*)k, (bf16*)v
  if (hd == 64)
    tts::qkv_epilogue_kernel<64><<<grid, 64, 0, s>>>(TTS_EPI_ARGS);
  else
    tts::qkv_epilogue_kernel<128><<<grid, 128, 0, s>>>(TTS_EPI_ARGS);
#undef TTS_EPI_ARGS
  return (int)cudaGetLastError();
}
