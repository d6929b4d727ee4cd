// Fused decode step head for the M = 1 AR decode row: the qkv head of
// decode_qkv.cu, then GQA attention of one layer of the stacked KV cache
// over the rows < pos plus the step's own k/v row, which the kernel takes
// from registers and shared memory (the caller appends it to the cache
// after).
//
// Replaces tts_tpu/ops/decode_step.py:fused_qkv_attn (Pallas body _kernel).
// Same softmax: fp32 scores, one-shot max-then-exp (not the online form),
// m = max(max_t s, s_new), p = exp(s - m), denom = sum p + p_new,
// probabilities rounded to bf16 before P.V with fp32 accumulation. At
// head_dim 64 it follows the TPU kernel's packed branch (s_new an fp32 sum
// of q * k_new, p_new / denom kept in fp32, v_new in fp32); at 128 its
// other branch (p_new / denom rounded to bf16).
//
// What bounds it on an H100: the qkv head's weight stream (see
// decode_qkv.cu), then the cache rows: 2 x pos x head_dim x 2 bytes per kv
// head, 512 KB a layer at pos 2048 for Kani. Design: three launches (the
// qkv head's two, then attn_kernel); the TPU kernel was one program only
// because the TPU grid runs its steps in order. attn_kernel is one block
// per kv head: it reads only the rows < pos (masked rows add exactly 0),
// keeps the G score rows in shared memory (G x pos x 4 bytes, 16 KB at
// G = 2, pos = 2048), takes each row's max and sum with block reductions,
// and sums P.V with 8 bf16 values per thread per row and row groups
// reduced through warp shuffles and shared memory in a fixed order. With
// one block per kv head it uses 8 of the 132 SMs at Kani's geometry; a
// split over the rows (flash decoding) is the next step if it shows.
#include "common.cuh"

extern "C" int fused_qkv_rope(const void* x, const void* w, int w_int8,
                              const void* scale, const void* bias, const void* qn,
                              const void* kn, const void* cosr, const void* sinr,
                              const void* lnw, const void* lnb, void* partial, void* q,
                              void* k, void* v, int B, int H, int heads, int kv_heads,
                              int hd, int ksplit, int kslice, float eps, void* stream);

namespace tts {
namespace {

constexpr int AT_THREADS = 256;
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr int MAX_G = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// block-wide reductions over AT_THREADS threads; scratch holds AT_WARPS
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < AT_WARPS; ++i) s += scratch[i];
  return s;
}
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < AT_WARPS; ++i) m = fmaxf(m, scratch[i]);
  return m;
}

// q (heads*HD), knew/vnew (KVH*HD), kc/vc the layer's (KVH, T, HD) cache,
// out (heads*HD); G q heads per kv head, kv-head-major as gqa_attention.
template <int HD>
__global__ void __launch_bounds__(AT_THREADS)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ knew,
            const bf16* __restrict__ vnew, const bf16* __restrict__ kc,
            const bf16* __restrict__ vc, bf16* __restrict__ out, int T, int pos, int G) {
  extern __shared__ float sm[];
  float* qs = sm;                      // [G][HD]
  float* red = qs + G * HD;            // [AT_WARPS][G][HD] P.V partials
  float* s = red + AT_WARPS * G * HD;  // [G][pos] scores, then probabilities
  __shared__ float kn[HD], vn[HD], snew[MAX_G], mx[MAX_G], den[MAX_G];
  __shared__ float scratch[AT_WARPS];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bf16* kj = kc + (size_t)j * T * HD;
  const bf16* vj = vc + (size_t)j * T * HD;

  for (int i = tid; i < G * HD; i += AT_THREADS) qs[i] = to_f(q[(size_t)j * G * HD + i]);
  for (int i = tid; i < HD; i += AT_THREADS) {
    kn[i] = to_f(knew[j * HD + i]);
    vn[i] = to_f(vnew[j * HD + i]);
  }
  __syncthreads();

  // scores of the cache rows < pos: one row per thread
  for (int t = tid; t < pos; t += AT_THREADS) {
    float a[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) a[g] = 0.f;
    const bf16* kr = kj + (size_t)t * HD;
#pragma unroll 2
    for (int d = 0; d < HD; d += 8) {
      Vec8 kv;
      kv.u = *reinterpret_cast<const uint4*>(kr + d);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float kf = to_f(kv.h[e]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) a[g] = fmaf(qs[g * HD + d + e], kf, a[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) s[g * pos + t] = a[g];
  }
  // the step's own row, an fp32 sum of q * k_new
  if (warp < G) {
    float a = 0.f;
    for (int d = lane; d < HD; d += 32) a = fmaf(qs[warp * HD + d], kn[d], a);
    a = warp_sum(a);
    if (lane == 0) snew[warp] = a;
  }
  __syncthreads();

  // one-shot softmax per q head: max, then exp and sum
  for (int g = 0; g < G; ++g) {
    float* sg = s + g * pos;
    float m = __int_as_float(static_cast<int>(0xff800000u));   // -inf
    for (int t = tid; t < pos; t += AT_THREADS) m = fmaxf(m, sg[t]);
    m = fmaxf(block_max(m, scratch), snew[g]);
    float sum = 0.f;
    for (int t = tid; t < pos; t += AT_THREADS) {
      const float p = expf(sg[t] - m);
      sg[t] = p;
      sum += p;
    }
    sum = block_sum(sum, scratch);
    if (tid == 0) {
      mx[g] = m;
      den[g] = sum + expf(snew[g] - m);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * pos; i += AT_THREADS) s[i] = rnd(s[i] / den[i / pos]);
  __syncthreads();

  // P.V over the cache rows: VT threads cover a row (8 values each), RG
  // row groups take every RG-th row
  constexpr int VT = HD / 8;
  constexpr int RG = AT_THREADS / VT;
  const int dv = tid % VT, rg = tid / VT;
  float acc[MAX_G][8];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int t = rg; t < pos; t += RG) {
    Vec8 vv;
    vv.u = *reinterpret_cast<const uint4*>(vj + (size_t)t * HD + dv * 8);
    float vf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vf[e] = to_f(vv.h[e]);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float p = s[g * pos + t];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  // lanes dv, dv + VT, ... of a warp hold the same columns
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = VT; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (lane < VT) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[(warp * G + g) * HD + dv * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += AT_THREADS) {
    const int g = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < AT_WARPS; ++w) o += red[(w * G + g) * HD + d];
    float pn = expf(snew[g] - mx[g]) / den[g];
    if (HD >= 128) pn = rnd(pn);
    o = fmaf(pn, vn[d], o);
    out[(size_t)(j * G + g) * HD + d] = to_bf(o);
  }
}

template <int HD>
cudaError_t launch_attn(const bf16* q, const bf16* knew, const bf16* vnew, const bf16* kc,
                        const bf16* vc, bf16* out, int kv_heads, int T, int pos, int G,
                        cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)(1 + AT_WARPS) * G * HD + (size_t)G * pos);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  attn_kernel<HD><<<kv_heads, AT_THREADS, smem, s>>>(q, knew, vnew, kc, vc, out, T, pos, G);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tts

// The qkv head's arguments at B = 1 (see decode_qkv.cu), then kc/vc the
// layer's (KVH, T, hd) bf16 cache slices, attn (heads*hd) bf16, T the
// cache length and pos the valid rows (0 <= pos < T). heads / kv_heads <= 8
// and 4 * (9 * G * hd + G * pos) bytes of shared memory.
extern "C" int fused_qkv_attn(const void* x, const void* w, int w_int8,
                              const void* scale, const void* bias, const void* qn,
                              const void* kn, const void* cosr, const void* sinr,
                              const void* lnw, const void* lnb, void* partial, void* q,
                              void* k, void* v, int B, int H, int heads, int kv_heads,
                              int hd, int ksplit, int kslice, float eps, const void* kc,
                              const void* vc, void* attn, int T, int pos, void* stream) {
  using tts::bf16;
  if (B != 1 || heads % kv_heads || heads / kv_heads > tts::MAX_G || pos < 0 || pos >= T)
    return (int)cudaErrorInvalidValue;
  int err = fused_qkv_rope(x, w, w_int8, scale, bias, qn, kn, cosr, sinr, lnw, lnb,
                           partial, q, k, v, B, H, heads, kv_heads, hd, ksplit, kslice,
                           eps, stream);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = heads / kv_heads;
  if (hd == 64)
    return (int)tts::launch_attn<64>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                     (const bf16*)kc, (const bf16*)vc, (bf16*)attn,
                                     kv_heads, T, pos, G, s);
  if (hd == 128)
    return (int)tts::launch_attn<128>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                      (const bf16*)kc, (const bf16*)vc, (bf16*)attn,
                                      kv_heads, T, pos, G, s);
  return (int)cudaErrorInvalidValue;
}
