// The W8A8 core shared by the port's int8 kernels (kernels 6-9 of the TPU
// package): per-row symmetric int8 activations for an s8 x s8 -> s32
// product on the tensor cores and an fp32 rescale epilogue. Here the row
// pass, templated on the activation type it reads (bf16 or fp32, as the
// TPU kernels take either):
//
//   q8_rows   quantizes whole rows of A: one warp a row, the row staged in
//             shared memory as fp32 (after the LayerNorm prologue where
//             there is one), its amax, xs = max(amax, 1e-8) * f32(1/127),
//             and q = clip(rint(v / xs), -127, 127) written as int8 (M, K)
//             with xs (M,).
//
// The GEMM runs on the rows it writes: the s8 wgmma GEMM of q8_wgmma.cuh
// (kernels 6-9).
// Why a row pass before the GEMM: the row's amax needs the whole row before
// any of it can be quantized, and the TPU kernel had it because a grid step
// held whole rows in VMEM. A GEMM CTA holds 128 rows by 128 columns, so
// quantizing in its prologue would repeat the work for every column tile (24
// times for the qkv projection); measured on the card (on the earlier WMMA
// GEMM), that prologue cost more than the GEMM. Quantizing once is 1 B a value written and read back,
// against the 2 B (bf16) or 4 B (fp32) the GEMM would otherwise read.
//
// Rounding follows the TPU kernels exactly where the inputs are equal: the
// division is IEEE (__fdiv_rn), rint rounds half to even, and every
// multiply and add of the rescale and of the LayerNorm prologue is an
// explicit _rn intrinsic, so nvcc cannot contract a pair into an FMA (which
// rounds once where the TPU rounds twice).
#pragma once

#include "common.cuh"

namespace tts {
namespace q8 {

constexpr int NT = 128;                    // 4 warps a q8_rows block
constexpr float INV_127 = 0x1.020408p-7f;  // float32(1 / 127)

// what q8_rows quantizes, of rows of type T (bf16 or float)
enum Rows {
  ROWS_RAW,   // the rows as they are (kernels 8, 9)
  ROWS_LN,    // LayerNorm (fp32, eps 1e-6, no affine) * (1 + scale) + shift,
              // in fp32 (kernels 6 ff1, 7)
};

struct RowArgs {
  const void* a;      // (M, K) of the row type
  const float* mods;  // ROWS_LN: [shift (K), scale (K), ...] fp32 for batch
  int mods_bstride;   //   row `row / T`, this far apart (0 = shared)
  int8_t* q;          // (M, K) int8 out
  float* xs;          // (M,) fp32 out
  int M, K, T;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// clip(rint(v / xs), -127, 127): IEEE division, round half to even
__device__ __forceinline__ signed char quant(float v, float xs) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
}

// gelu, tanh form, in jax.nn.gelu's order: x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))
__device__ __forceinline__ float gelu_q8(float x) {
  const float c = 0x1.988454p-1f;  // float32(sqrt(2 / pi))
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float u = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(u))));
}

// 8 consecutive values of a row, as fp32
__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  Vec8 x;
  x.u = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = to_f(x.h[j]);
}

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// x rounded to T and back: a no-op for float
__device__ __forceinline__ float as_t(float x, const bf16*) { return rnd(x); }
__device__ __forceinline__ float as_t(float x, const float*) { return x; }

// K rounded up to whole 256-column strides of a warp
__host__ __device__ __forceinline__ int k256(int K) { return (K + 255) / 256 * 256; }

// One warp a row, rows blockIdx.x * 4 + warp. Lane l takes columns
// c = l*8 + 256*i and keeps value j of them at float 256*i + 32*j + l of its
// warp's k256(K) of shared memory, so a warp's accesses hit 32 banks.
template <Rows ROWS, typename T>
__global__ void __launch_bounds__(NT) q8_rows(const RowArgs p) {
  extern __shared__ float rowbuf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NT / 32) + warp;
  if (row >= p.M) return;
  const int K = p.K;
  float* buf = rowbuf + warp * k256(K) + lane;
  float amax = 0.f, sum = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    load8(static_cast<const T*>(p.a) + (size_t)row * K + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      buf[(c & ~255) + j * 32] = v[j];
      sum += v[j];
      amax = fmaxf(amax, fabsf(v[j]));
    }
  }
  if (ROWS == ROWS_LN) {
    const float mean = __fdiv_rn(warp_sum(sum), (float)K);
    float var = 0.f;
    for (int c = lane * 8; c < K; c += 256)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(buf[(c & ~255) + j * 32], mean);
        var = __fadd_rn(var, __fmul_rn(d, d));
      }
    const float rstd =
        __fdiv_rn(1.f, sqrtf(__fadd_rn(__fdiv_rn(warp_sum(var), (float)K), 1e-6f)));
    const float* m = p.mods + (size_t)(row / p.T) * p.mods_bstride;
    amax = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      __align__(16) float shift[8];
      __align__(16) float scale[8];
      *reinterpret_cast<float4*>(shift) = *reinterpret_cast<const float4*>(m + c);
      *reinterpret_cast<float4*>(shift + 4) = *reinterpret_cast<const float4*>(m + c + 4);
      *reinterpret_cast<float4*>(scale) = *reinterpret_cast<const float4*>(m + K + c);
      *reinterpret_cast<float4*>(scale + 4) = *reinterpret_cast<const float4*>(m + K + c + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ln = __fmul_rn(__fsub_rn(buf[(c & ~255) + j * 32], mean), rstd);
        const float n = __fadd_rn(__fmul_rn(ln, __fadd_rn(1.f, scale[j])), shift[j]);
        buf[(c & ~255) + j * 32] = n;
        amax = fmaxf(amax, fabsf(n));
      }
    }
  }
  const float xs = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), INV_127);
  for (int c = lane * 8; c < K; c += 256) {
    union {
      uint2 u;
      signed char b[8];
    } o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.b[j] = quant(buf[(c & ~255) + j * 32], xs);
    *reinterpret_cast<uint2*>(p.q + (size_t)row * K + c) = o.u;
  }
  if (lane == 0) p.xs[row] = xs;
}

// quantize the M rows of p.a; K % 8 == 0 and K <= 2048 (the row buffers
// stay under the 48 KB of shared memory a launch has without opting in)
template <Rows ROWS, typename T>
int launch_rows(const RowArgs& p, cudaStream_t s) {
  const int bytes = (NT / 32) * k256(p.K) * (int)sizeof(float);
  q8_rows<ROWS, T><<<(p.M + NT / 32 - 1) / (NT / 32), NT, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace q8
}  // namespace tts
