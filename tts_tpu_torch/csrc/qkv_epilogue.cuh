// The qkv head's epilogue, shared by kernel 11's epilogue launch
// (decode_qkv.cu) and kernel 12's attention launch (decode_step.cu), at the
// TPU kernel's rounding points: the slices' partial sums in order, rounded
// to bf16; times the bf16-rounded int8 scale in bf16; plus the bf16 bias;
// for q and k heads the per-head RMSNorm in fp32 times its weight, rounded
// once, and the half-split rotation, each of its three ops rounded.
#pragma once

#include "common.cuh"

namespace tts {
namespace {

// the slices' sum of a column rounded, times the rounded int8 scale, plus
// the bias (where given)
__device__ __forceinline__ float qkv_finish(float acc, bool scaled, float scale, bool biased,
                                            float bias) {
  float val = rnd(acc);
  if (scaled) val = rnd(val * rnd(scale));
  if (biased) val = rnd(val + bias);
  return val;
}

// column col of batch row b of the (ksplit, B, N) partials, summed in slice
// order, rounded, scaled and biased
__device__ __forceinline__ float qkv_column(const float* __restrict__ partial, int ksplit,
                                            int B, int N, int b, int col,
                                            const float* __restrict__ scale,
                                            const bf16* __restrict__ bias) {
  float acc = 0.f;
  for (int s = 0; s < ksplit; ++s) acc += partial[((size_t)s * B + b) * N + col];
  return qkv_finish(acc, scale, scale ? scale[col] : 0.f, bias, bias ? to_f(bias[col]) : 0.f);
}

// the sum of v over a head's HD threads (heads in consecutive threads of
// the CTA): a butterfly a warp, then the head's warps in order through
// scratch (one float a warp of the CTA)
template <int HD>
__device__ __forceinline__ float head_sum(float v, float* scratch) {
  constexpr int NW = HD / 32;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  const float* hs = scratch + threadIdx.x / HD * NW;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += hs[i];
  return s;
}

// column threadIdx.x % HD of a q or k head: the RMSNorm times its weight
// nw (when `norm`), then the rotation by cos / sin (when `rope`). Every
// thread of the CTA calls it (its barriers), with `norm` and `rope` the
// same for all; a thread with `skip` (a v head's) returns val as it came.
// row holds HD floats a head.
template <int HD>
__device__ __forceinline__ float norm_rope(float val, bool skip, bool norm, float nw, bool rope,
                                           float cos, float sin, float eps, float* scratch,
                                           float* row) {
  const int i = threadIdx.x % HD;
  if (norm) {
    const float ms = head_sum<HD>(val * val, scratch) / (float)HD;
    if (!skip) val = rnd(__fmul_rn(val * rsqrtf(ms + eps), nw));
  }
  if (rope) {
    float* r = row + threadIdx.x / HD * HD;
    r[i] = val;
    __syncthreads();
    const float rot = i < HD / 2 ? -r[i + HD / 2] : r[i - HD / 2];
    if (!skip) val = rnd(rnd(val * cos) + rnd(rot * sin));
  }
  return val;
}

}  // namespace
}  // namespace tts
