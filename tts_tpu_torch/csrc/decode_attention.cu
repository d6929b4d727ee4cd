// Decode-step GQA attention over the live rows of a static KV cache: q
// (B, H, D) against the layer's (B, KVH, T, D) k/v buffers, rows < kv_len
// only (kv_len counts the step's own appended row).
//
// Replaces tts_tpu/ops/decode_attention.py:decode_gqa_attention (Pallas
// body _kernel). Same numerics: fp32 scores (times `scale` when it is not
// 1), a softmax over blocks of bkv = min(256, T) rows with the denominator
// summed from the unrounded p = exp(s - m), p rounded to bf16 for the P.V
// product with fp32 accumulation, (acc / l) rounded to bf16 once.
//
// What bounds it on an H100: the live k/v rows, 2 x kv_len x D x 2 bytes a
// kv head (0.5 MB a layer at Qwen's 8 kv heads x 128 and kv_len 126), read
// once; the products are 4 x H x kv_len x D operations, far below the
// tensor cores' line. Design: the TPU kernel walked the blocks in order on
// one core, carrying (m, l, acc) in VMEM; here every live block is a CTA of
// its own, grid (blocks, KVH, B), so a long context spreads over the SMs
// (flash decoding). A CTA holds its G heads' scores of up to 256 rows in
// shared memory: scores one row a thread, the block's max and sum by block
// reductions, P.V with 8 bf16 values a thread and row groups reduced by
// warp shuffles and shared memory in a fixed order. With one live block the
// CTA writes the output itself (one launch); with more, each writes its
// (m, l, acc) and merge_kernel combines them in block order, scaling each
// by exp(m_i - M). No atomics: runs are bitwise reproducible. Blocks past
// the live length are never launched and rows >= kv_len never read.
#include "common.cuh"

namespace tts {
namespace {

constexpr int DA_THREADS = 256;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_MAX_G = 8;

__device__ __forceinline__ float da_warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float da_block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DA_WARPS; ++i) s += scratch[i];
  return s;
}

__device__ __forceinline__ float da_block_max(float v, float* scratch) {
  v = da_warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < DA_WARPS; ++i) m = fmaxf(m, scratch[i]);
  return m;
}

// One CTA per (live block, kv head, batch row). partial: per (b, kvh, block,
// g) the row [m, l, acc[0..HD)]; null when there is one block, and the CTA
// then writes out = acc / l.
template <int HD>
__global__ void __launch_bounds__(DA_THREADS)
block_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ partial,
             int KVH, int G, int T, int kv_len, int bkv, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                           // [G][HD]
  float* red = qs + G * HD;                 // [DA_WARPS][G][HD] P.V partials
  float* s = red + DA_WARPS * G * HD;       // [G][bkv] scores, then bf16 p
  __shared__ float mx[DA_MAX_G], den[DA_MAX_G];
  __shared__ float scratch[DA_WARPS];
  const int blk = blockIdx.x, j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = blk * bkv;
  const int n = min(kv_len - r0, bkv);      // live rows of this block, >= 1
  const size_t head = (size_t)b * KVH + j;
  const bf16* kj = k + (head * T + r0) * HD;
  const bf16* vj = v + (head * T + r0) * HD;

  for (int i = tid; i < G * HD; i += DA_THREADS) qs[i] = to_f(q[head * G * HD + i]);
  __syncthreads();

  // scores: one row a thread
  for (int t = tid; t < n; t += DA_THREADS) {
    float a[DA_MAX_G];
#pragma unroll
    for (int g = 0; g < DA_MAX_G; ++g) a[g] = 0.f;
    const bf16* kr = kj + (size_t)t * HD;
#pragma unroll 2
    for (int d = 0; d < HD; d += 8) {
      Vec8 kv;
      kv.u = *reinterpret_cast<const uint4*>(kr + d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float kf = to_f(kv.h[e]);
#pragma unroll
        for (int g = 0; g < DA_MAX_G; ++g)
          if (g < G) a[g] = fmaf(qs[g * HD + d + e], kf, a[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < DA_MAX_G; ++g)
      if (g < G) s[g * bkv + t] = scale != 1.f ? a[g] * scale : a[g];
  }
  __syncthreads();

  // the block's softmax statistics per q head; p kept rounded to bf16 for P.V
  for (int g = 0; g < G; ++g) {
    float* sg = s + g * bkv;
    float m = __int_as_float(static_cast<int>(0xff800000u));   // -inf
    for (int t = tid; t < n; t += DA_THREADS) m = fmaxf(m, sg[t]);
    m = da_block_max(m, scratch);
    float sum = 0.f;
    for (int t = tid; t < n; t += DA_THREADS) {
      const float p = expf(sg[t] - m);
      sg[t] = rnd(p);
      sum += p;
    }
    sum = da_block_sum(sum, scratch);
    if (tid == 0) {
      mx[g] = m;
      den[g] = sum;
    }
  }
  __syncthreads();

  // P.V: VT threads cover a row (8 values each), RG row groups take every
  // RG-th row
  constexpr int VT = HD / 8;
  constexpr int RG = DA_THREADS / VT;
  const int dv = tid % VT, rg = tid / VT;
  float acc[DA_MAX_G][8];
#pragma unroll
  for (int g = 0; g < DA_MAX_G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int t = rg; t < n; t += RG) {
    Vec8 vv;
    vv.u = *reinterpret_cast<const uint4*>(vj + (size_t)t * HD + dv * 8);
    float vf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vf[e] = to_f(vv.h[e]);
#pragma unroll
    for (int g = 0; g < DA_MAX_G; ++g) {
      if (g < G) {
        const float p = s[g * bkv + t];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  // lanes dv, dv + VT, ... of a warp hold the same columns
#pragma unroll
  for (int g = 0; g < DA_MAX_G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = VT; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (lane < VT) {
#pragma unroll
    for (int g = 0; g < DA_MAX_G; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * G + g) * HD + dv * 8 + e] = acc[g][e];
  }
  __syncthreads();
  const int nblk = gridDim.x;
  for (int i = tid; i < G * HD; i += DA_THREADS) {
    const int g = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) o += red[(w * G + g) * HD + d];
    if (partial == nullptr) {
      out[(head * G + g) * HD + d] = to_bf(o / den[g]);
    } else {
      float* row = partial + ((head * nblk + blk) * G + g) * (HD + 2);
      row[2 + d] = o;
      if (d == 0) {
        row[0] = mx[g];
        row[1] = den[g];
      }
    }
  }
}

// Merge the live blocks of one (kv head, batch row) in block order:
// out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), M = max_i m_i.
template <int HD>
__global__ void __launch_bounds__(DA_THREADS)
merge_kernel(const float* __restrict__ partial, bf16* __restrict__ out, int KVH, int G,
             int nblk) {
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t head = (size_t)b * KVH + j;
  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS) {
    const int g = i / HD, d = i % HD;
    float m = -1e30f;
    for (int blk = 0; blk < nblk; ++blk)
      m = fmaxf(m, partial[((head * nblk + blk) * G + g) * (HD + 2)]);
    float acc = 0.f, l = 0.f;
    for (int blk = 0; blk < nblk; ++blk) {
      const float* row = partial + ((head * nblk + blk) * G + g) * (HD + 2);
      const float w = expf(row[0] - m);
      l += row[1] * w;
      acc += row[2 + d] * w;
    }
    out[(head * G + g) * HD + d] = to_bf(acc / l);
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* partial, int B,
           int KVH, int G, int T, int kv_len, int bkv, float scale, cudaStream_t st) {
  const int nblk = (kv_len + bkv - 1) / bkv;
  const size_t smem = sizeof(float) * ((size_t)(1 + DA_WARPS) * G * HD + (size_t)G * bkv);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        block_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  block_kernel<HD><<<dim3(nblk, KVH, B), DA_THREADS, smem, st>>>(
      q, k, v, out, nblk > 1 ? partial : nullptr, KVH, G, T, kv_len, bkv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return (int)err;
  merge_kernel<HD><<<dim3(KVH, B), DA_THREADS, 0, st>>>(partial, out, KVH, G, nblk);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tts

// q (B, KVH*G, hd) bf16; k, v (B, KVH, T, hd) bf16; out like q; partial
// B * KVH * ceil(kv_len / bkv) * G * (hd + 2) fp32 scratch (null when
// kv_len <= bkv). hd 64 or 128, G <= 8, 1 <= kv_len <= T, bkv <= 256.
extern "C" int decode_gqa_attention(const void* q, const void* k, const void* v, void* out,
                                    void* partial, int B, int KVH, int G, int T, int kv_len,
                                    int bkv, int hd, float scale, void* stream) {
  using tts::bf16;
  if (G < 1 || G > tts::DA_MAX_G || kv_len < 1 || kv_len > T || bkv < 1 || bkv > 256 ||
      (kv_len > bkv && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return tts::launch<64>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
                           (float*)partial, B, KVH, G, T, kv_len, bkv, scale, st);
  if (hd == 128)
    return tts::launch<128>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
                            (float*)partial, B, KVH, G, T, kv_len, bkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
