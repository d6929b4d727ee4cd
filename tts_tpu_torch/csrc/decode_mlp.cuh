// Fused decode-layer tail for M = 1..8 AR decode rows:
//   x2 = x + att @ wo;  h = rms_norm(x2);  g, u = h @ w_gate_up;
//   out = x2 + (silu(g) * u) @ w_down
// in two forms:
//   fused_out_mlp     bf16 activations, bf16 or int8 weight-only weights
//                     (per-column scale), at the TPU kernel's rounding
//                     points: each dot accumulated in fp32 and rounded to
//                     bf16, times the bf16-rounded scale in bf16; x2 and the
//                     output rounded bf16 sums; h rounded once from fp32;
//                     a = bf16(silu(g) * u) in fp32.
//   fused_out_mlp_q8  W8A8: att quantized per row, h per row, a per row and
//                     per F-block of fb columns; s8 x s8 products summed
//                     exactly in int32; fp32 rescales; the down product
//                     summed in fp32 over the F-blocks in order.
//
// Replaces tts_tpu/ops/decode_mlp.py:fused_out_mlp (Pallas bodies _kernel,
// _no_scale_kernel) and :fused_out_mlp_q8 (_kernel_q8, with the att row
// quantization that tts_tpu ran in XLA ahead of it). The quantization steps
// follow the TPU's exactly where the inputs are equal: xs = max(amax, 1e-8)
// * f32(1/127), an IEEE division (__fdiv_rn), rint (half to even), and every
// multiply and add of the rescales an explicit _rn intrinsic so nvcc cannot
// contract a pair into an FMA.
//
// What bounds it on an H100: the weights, read once: 11.5 M values a layer
// at Qwen3-TTS width (wo 2048 x 1024, gate/up 1024 x 6144, down 3072 x
// 1024), 23 MB in bf16 (6.9 us at 3.35 TB/s) or 11.5 MB in int8 (3.4 us);
// at B <= 8 rows the products are far below the tensor cores' line, so the
// kernels are matvecs on the CUDA cores, every weight read as 8 consecutive
// columns in one 16-byte (bf16) or 8-byte (int8) load and converted in
// registers (no bf16 copy of an int8 matrix). The TPU kernel streamed all
// three matrices through one sequential grid; a row's RMSNorm needs all of
// x2 and a's quantization all of an F-block, so here three launches:
//  1. oproj_kernel: grid (H / 32 column tiles) x (input-dim slices); fp32
//     (int32 for W8A8) partial sums of att @ wo per slice. In W8A8 every
//     CTA quantizes the att rows itself (amax over the whole row, then its
//     slice); CTA (0, 0) stores the row scales.
//  2. gateup_kernel: grid F / 32; every CTA sums the partials in slice
//     order and forms x2 and the normed rows for all B rows (CTA 0 stores
//     x2), then the gate and up columns of its tile over the whole input
//     dim and the product a (bf16, or fp32 for W8A8).
//  3. down_kernel: grid H / 16; a @ w_down over all of F (in W8A8 each CTA
//     quantizes the a rows per F-block, sums each block exactly and adds the
//     rescaled blocks in order), then the residual.
// Within a CTA, each thread takes 8 columns of every (256 / groups)-th
// weight row; the row lanes meet by warp shuffles and shared memory in a
// fixed order. No atomics: runs are bitwise reproducible.
//
// This header holds the kernels as templates; decode_mlp.cu instantiates
// the bf16 and int8 weight-only forms behind fused_out_mlp (kernel 14).
// The W8A8 form (Q8) is no longer instantiated: kernel 15 has its own
// kernels in decode_mlp_q8.cu. Its branches stay until kernel 14's own
// redesign: a copy of this file without them built kernel 14's bf16 form
// 12% slower on the card (chip_ab.py), for a reason not found.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tts {
namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int MAX_PER = 16;                // columns of H a thread holds: H <= 4096
constexpr float INV_127 = 0x1.020408p-7f;  // float32(1 / 127)
constexpr int OP_CG = 4, GU_CG = 8, DN_CG = 2;   // column groups of 8 per CTA

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
__device__ __forceinline__ void load8(const int8_t* w, int* out) {
  union {
    uint2 u;
    int8_t c[8];
  } v;
  v.u = *reinterpret_cast<const uint2*>(w);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = (int)v.c[e];
}

__device__ __forceinline__ float mlp_warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// block reductions over NT threads; scratch holds NW floats
__device__ __forceinline__ float mlp_block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += scratch[i];
  return s;
}
__device__ __forceinline__ float mlp_block_max(float v, float* scratch) {
  v = mlp_warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) m = fmaxf(m, scratch[i]);
  return m;
}

// clip(rint(v / xs), -127, 127): IEEE division, round half to even
__device__ __forceinline__ signed char quant(float v, float xs) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
}

// silu in fp32, jax.nn.silu's x * sigmoid(x) with sigmoid = 1 / (1 + e^-x)
__device__ __forceinline__ float silu(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))));
}

// The CTA's matvec tile: thread (row lane rl, column group cg) sums
// act[b][r] * w[r][col + e] for r = rl, rl + RL, ... < K and e < 8, where
// wp = w + col of its group (row stride ldw). The row lanes of a column meet
// by shuffles inside a warp, then over the warps in order through red
// [NW][NB][CG * 8]; the result lands in out [NB][CG * 8] (shared). ACT is
// float (bf16-valued activations) or signed char (W8A8), ACC float or int.
template <typename W, typename ACT, typename ACC, int NB, int CG>
__device__ __forceinline__ void tile_matvec(const ACT* __restrict__ act, int lda,
                                            const W* __restrict__ wp, size_t ldw, int K,
                                            ACC* red, ACC* out) {
  constexpr int RL = NT / CG;
  const int tid = threadIdx.x, rl = tid / CG, warp = tid >> 5, lane = tid & 31;
  ACC acc[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0;
#pragma unroll 4
  for (int r = rl; r < K; r += RL) {
    ACC wv[8];
    load8(wp + (size_t)r * ldw, wv);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const ACC a = (ACC)act[b * lda + r];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[b][e] += a * wv[e];
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = CG; off < 32; off <<= 1)
        acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], off);
  if (lane < CG) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * NB + b) * CG * 8 + lane * 8 + e] = acc[b][e];
  }
  __syncthreads();
  for (int i = tid; i < NB * CG * 8; i += NT) {
    ACC s = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w * NB * CG * 8 + i];
    out[i] = s;
  }
  __syncthreads();
}

struct Args {
  const bf16* x;      // (B, H) residual input
  const bf16* att;    // (B, A) attention rows
  const void* wo;     // (A, H)
  const void* wgu;    // (H, 2F)
  const void* wd;     // (F, H)
  const float* so;    // (H,) per-column scales (null: bf16 weights)
  const float* sgu;   // (2F,)
  const float* sd;    // (H,)
  float* partial;     // (ks, B, H) fp32 or int32 out-projection partials
  float* ats;         // (B,) W8A8 att row scales
  bf16* x2;           // (B, H)
  void* a;            // (B, F) bf16, or fp32 for W8A8
  bf16* out;          // (B, H)
  int A, H, F, kslice, ks, fb;
  float eps;
};

// ---------------------------------------------------------------- launch 1

template <typename W, bool Q8, int NB>
__global__ void __launch_bounds__(NT) oproj_kernel(const Args p) {
  using ACT = typename std::conditional<Q8, signed char, float>::type;
  using ACC = typename std::conditional<Q8, int, float>::type;
  extern __shared__ __align__(16) unsigned char dyn[];
  ACT* act = reinterpret_cast<ACT*>(dyn);                    // [NB][kslice]
  __shared__ ACC red[NW * NB * OP_CG * 8], res[NB * OP_CG * 8];
  __shared__ float scratch[NW], xs[NB];
  const int k0 = blockIdx.y * p.kslice;
  const int kn = min(p.A, k0 + p.kslice) - k0;
  if (Q8) {
    for (int b = 0; b < NB; ++b) {
      float amax = 0.f;
      for (int k = threadIdx.x; k < p.A; k += NT)
        amax = fmaxf(amax, fabsf(to_f(p.att[(size_t)b * p.A + k])));
      amax = mlp_block_max(amax, scratch);
      if (threadIdx.x == 0) xs[b] = __fmul_rn(fmaxf(amax, 1e-8f), INV_127);
    }
    __syncthreads();
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < NB) p.ats[threadIdx.x] = xs[threadIdx.x];
  }
  for (int i = threadIdx.x; i < NB * kn; i += NT) {
    const int b = i / kn, k = i % kn;
    const float v = to_f(p.att[(size_t)b * p.A + k0 + k]);
    if (Q8)
      act[b * kn + k] = (ACT)quant(v, xs[b]);
    else
      act[b * kn + k] = (ACT)v;
  }
  __syncthreads();
  const int cg = threadIdx.x % OP_CG, n0 = blockIdx.x * OP_CG * 8;
  const W* wp = static_cast<const W*>(p.wo) + (size_t)k0 * p.H + n0 + cg * 8;
  tile_matvec<W, ACT, ACC, NB, OP_CG>(act, kn, wp, p.H, kn, red, res);
  ACC* part = reinterpret_cast<ACC*>(p.partial);
  for (int i = threadIdx.x; i < NB * OP_CG * 8; i += NT) {
    const int b = i / (OP_CG * 8), c = i % (OP_CG * 8);
    part[((size_t)blockIdx.y * NB + b) * p.H + n0 + c] = res[i];
  }
}

// ---------------------------------------------------------------- launch 2

template <typename W, bool Q8, int NB>
__global__ void __launch_bounds__(NT) gateup_kernel(const Args p) {
  using ACT = typename std::conditional<Q8, signed char, float>::type;
  using ACC = typename std::conditional<Q8, int, float>::type;
  extern __shared__ __align__(16) unsigned char dyn[];
  ACT* act = reinterpret_cast<ACT*>(dyn);                    // [NB][H] normed rows
  __shared__ ACC red[NW * NB * GU_CG * 8], res[NB * GU_CG * 8];
  __shared__ float scratch[NW], hs[NB];
  const int H = p.H;
  for (int b = 0; b < NB; ++b) {
    float x2v[MAX_PER];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_PER; ++i) {
      const int n = threadIdx.x + i * NT;
      if (n >= H) break;
      float y;
      if (Q8) {
        const int* part = reinterpret_cast<const int*>(p.partial);
        int acc = 0;
        for (int s = 0; s < p.ks; ++s) acc += part[((size_t)s * NB + b) * H + n];
        y = rnd(__fmul_rn(__fmul_rn(__int2float_rn(acc), p.ats[b]), p.so[n]));
      } else {
        float acc = 0.f;
        for (int s = 0; s < p.ks; ++s) acc += p.partial[((size_t)s * NB + b) * H + n];
        y = rnd(acc);
        if (p.so) y = rnd(y * rnd(p.so[n]));
      }
      const float x2 = rnd(to_f(p.x[(size_t)b * H + n]) + y);
      x2v[i] = x2;
      ss = fmaf(x2, x2, ss);
      if (blockIdx.x == 0) p.x2[(size_t)b * H + n] = to_bf(x2);
    }
    ss = mlp_block_sum(ss, scratch);
    if (Q8) {
      const float rs = __fdiv_rn(1.f, sqrtf(__fadd_rn(__fdiv_rn(ss, (float)H), p.eps)));
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_PER; ++i) {
        if (threadIdx.x + i * NT >= H) break;
        x2v[i] = __fmul_rn(x2v[i], rs);
        amax = fmaxf(amax, fabsf(x2v[i]));
      }
      amax = mlp_block_max(amax, scratch);
      const float xsb = __fmul_rn(fmaxf(amax, 1e-8f), INV_127);
      if (threadIdx.x == 0) hs[b] = xsb;
#pragma unroll
      for (int i = 0; i < MAX_PER; ++i) {
        const int n = threadIdx.x + i * NT;
        if (n >= H) break;
        act[b * H + n] = (ACT)quant(x2v[i], xsb);
      }
    } else {
      const float rs = rsqrtf(ss / (float)H + p.eps);
#pragma unroll
      for (int i = 0; i < MAX_PER; ++i) {
        const int n = threadIdx.x + i * NT;
        if (n >= H) break;
        act[b * H + n] = (ACT)rnd(x2v[i] * rs);
      }
    }
  }
  __syncthreads();
  // column groups 0..3: gate columns f0 + 8 cg; 4..7: the up columns F + f0 + ...
  constexpr int HALF = GU_CG / 2;
  const int cg = threadIdx.x % GU_CG, f0 = blockIdx.x * HALF * 8;
  const int col = (cg < HALF ? 0 : p.F) + f0 + (cg % HALF) * 8;
  const W* wp = static_cast<const W*>(p.wgu) + col;
  tile_matvec<W, ACT, ACC, NB, GU_CG>(act, H, wp, 2 * (size_t)p.F, H, red, res);
  for (int i = threadIdx.x; i < NB * HALF * 8; i += NT) {
    const int b = i / (HALF * 8), c = i % (HALF * 8), f = f0 + c;
    const ACC gs = res[b * GU_CG * 8 + c], us = res[b * GU_CG * 8 + HALF * 8 + c];
    if (Q8) {
      const float g = __fmul_rn(__fmul_rn(__int2float_rn(gs), hs[b]), p.sgu[f]);
      const float u = __fmul_rn(__fmul_rn(__int2float_rn(us), hs[b]), p.sgu[p.F + f]);
      static_cast<float*>(p.a)[(size_t)b * p.F + f] = __fmul_rn(silu(g), u);
    } else {
      float g = rnd(gs), u = rnd(us);
      if (p.sgu) {
        g = rnd(g * rnd(p.sgu[f]));
        u = rnd(u * rnd(p.sgu[p.F + f]));
      }
      static_cast<bf16*>(p.a)[(size_t)b * p.F + f] = to_bf(__fmul_rn(silu(g), u));
    }
  }
}

// ---------------------------------------------------------------- launch 3

template <typename W, bool Q8, int NB>
__global__ void __launch_bounds__(NT) down_kernel(const Args p) {
  using ACT = typename std::conditional<Q8, signed char, float>::type;
  using ACC = typename std::conditional<Q8, int, float>::type;
  extern __shared__ __align__(16) unsigned char dyn[];
  ACT* act = reinterpret_cast<ACT*>(dyn);                    // [NB][F]
  float* as = reinterpret_cast<float*>(dyn + sizeof(ACT) * NB * p.F + 16);   // [NB][F / fb]
  __shared__ ACC red[NW * NB * DN_CG * 8], res[NB * DN_CG * 8];
  const int F = p.F, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (Q8) {
    // one warp per (row, F-block): amax, scale, then the block's int8 values
    const float* a = static_cast<const float*>(p.a);
    const int nfb = F / p.fb;
    for (int pr = warp; pr < NB * nfb; pr += NW) {
      const int b = pr / nfb, j = pr % nfb;
      const float* ar = a + (size_t)b * F + j * p.fb;
      float amax = 0.f;
      for (int c = lane; c < p.fb; c += 32) amax = fmaxf(amax, fabsf(ar[c]));
      const float xsj = __fmul_rn(fmaxf(mlp_warp_max(amax), 1e-8f), INV_127);
      for (int c = lane; c < p.fb; c += 32) act[b * F + j * p.fb + c] = (ACT)quant(ar[c], xsj);
      if (lane == 0) as[b * nfb + j] = xsj;
    }
  } else {
    const bf16* a = static_cast<const bf16*>(p.a);
    for (int i = threadIdx.x; i < NB * F; i += NT) act[i] = (ACT)to_f(a[i]);
  }
  __syncthreads();
  const int cg = threadIdx.x % DN_CG, n0 = blockIdx.x * DN_CG * 8;
  const W* wd = static_cast<const W*>(p.wd) + n0 + cg * 8;
  constexpr int TILE = NB * DN_CG * 8;
  float accf = 0.f;          // thread i < TILE: row i / 16, column n0 + i % 16
  if (Q8) {
    const int nfb = F / p.fb;
    for (int j = 0; j < nfb; ++j) {
      tile_matvec<W, ACT, ACC, NB, DN_CG>(act + j * p.fb, F, wd + (size_t)j * p.fb * p.H,
                                          p.H, p.fb, red, res);
      if (threadIdx.x < TILE) {
        const int b = threadIdx.x / (DN_CG * 8);
        accf = __fadd_rn(accf, __fmul_rn(__int2float_rn((int)res[threadIdx.x]), as[b * nfb + j]));
      }
    }
  } else {
    tile_matvec<W, ACT, ACC, NB, DN_CG>(act, F, wd, p.H, F, red, res);
    if (threadIdx.x < TILE) accf = (float)res[threadIdx.x];
  }
  if (threadIdx.x < TILE) {
    const int b = threadIdx.x / (DN_CG * 8), n = n0 + threadIdx.x % (DN_CG * 8);
    float y;
    if (Q8) {
      y = rnd(__fmul_rn(accf, p.sd[n]));
    } else {
      y = rnd(accf);
      if (p.sd) y = rnd(y * rnd(p.sd[n]));
    }
    p.out[(size_t)b * p.H + n] = to_bf(to_f(p.x2[(size_t)b * p.H + n]) + y);
  }
}

// ---------------------------------------------------------------- host side

// dynamic shared memory past 48 KB (with the static arrays) needs an opt-in,
// set once per kernel and device for the largest size asked so far
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int (&allowed)[MAX_DEVICES]) {
  if (bytes + 24 * 1024 <= 48 * 1024) return cudaSuccess;
  return raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes, allowed);
}

template <typename W, bool Q8, int NB>
int run(const Args& p, cudaStream_t st) {
  static int ok1[MAX_DEVICES], ok2[MAX_DEVICES], ok3[MAX_DEVICES];
  const size_t act = Q8 ? 1 : sizeof(float);
  const size_t s1 = act * NB * p.kslice;
  const size_t s2 = act * NB * p.H;
  const size_t s3 = act * NB * p.F + 16 + (Q8 ? sizeof(float) * NB * (p.F / p.fb) : 0);
  cudaError_t err;
  if ((err = allow_smem(oproj_kernel<W, Q8, NB>, s1, ok1)) != cudaSuccess) return (int)err;
  oproj_kernel<W, Q8, NB><<<dim3(p.H / (OP_CG * 8), p.ks), NT, s1, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(gateup_kernel<W, Q8, NB>, s2, ok2)) != cudaSuccess) return (int)err;
  gateup_kernel<W, Q8, NB><<<p.F / (GU_CG / 2 * 8), NT, s2, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(down_kernel<W, Q8, NB>, s3, ok3)) != cudaSuccess) return (int)err;
  down_kernel<W, Q8, NB><<<p.H / (DN_CG * 8), NT, s3, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename W, bool Q8>
int dispatch(int B, const Args& p, cudaStream_t st) {
  switch (B) {
#define TTS_MLP_CASE(nb) \
  case nb:               \
    return run<W, Q8, nb>(p, st);
    TTS_MLP_CASE(1)
    TTS_MLP_CASE(2)
    TTS_MLP_CASE(3)
    TTS_MLP_CASE(4)
    TTS_MLP_CASE(5)
    TTS_MLP_CASE(6)
    TTS_MLP_CASE(7)
    TTS_MLP_CASE(8)
#undef TTS_MLP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool shapes_ok(int B, int A, int H, int F, int kslice, int ks) {
  return B >= 1 && B <= 8 && A % 8 == 0 && H % 32 == 0 && F % 32 == 0 && H <= NT * MAX_PER &&
         F <= 4096 && kslice >= 1 && (long long)kslice * ks >= A && kslice * (ks - 1) < A;
}

}  // namespace
}  // namespace tts
