// Fused BigVGAN AMP resblock (AMPBlock1): for each dilation branch j,
//   x += crop(conv(crop(act(crop(conv(crop(act(x)), w1, b1, d)))), w2, b2, 1))
// with `act` the anti-aliased snakebeta in phase space (two polyphase
// streams of the 2x upsample, 6 taps each; the snake per stream in fp32; the
// streams zeroed outside [0, T); the 12-tap decimation split by parity) and
// `crop` zeroing every intermediate outside the sequence [0, T).
//
// Replaces tts_tpu/ops/bigvgan_stage.py:amp_block_fused (Pallas body
// _make_kernel), in bf16 and in fp32, as tts_tpu's kernel takes both. Same
// rounding points: each act runs in fp32 with the TPU kernel's tap order and
// is rounded to the dtype once; each conv accumulates in fp32, is rounded to
// the dtype, then the bias is added in the dtype; the residual is an add in
// the dtype. Every fp32 product and sum of the act is an explicit _rn op, so
// nvcc contracts none of them into an FMA. In bf16 the convs run on the
// tensor cores (WMMA); in fp32 they are true fp32 FMAs on the CUDA cores (no
// TF32), and every rounding to the dtype is exact.
//
// What bounds it on an H100: at the BigVGAN bench shapes the convs are
// 12 k C^2 T flops a resblock (0.02-0.08 ms of tensor-core time at C = 192)
// and the acts ~80 fp32 flops and two sines per (t, c) per act (~0.02 ms of
// CUDA-core time, the larger term below C ~ 96); the bytes, one read and one
// write of x, are the smallest term.
//
// Design (a simple first version): one launch per dilation branch, each a
// grid of (T / Tb tiles, B) CTAs. A CTA stages its x rows [t0 - R, t0 + Tb +
// R) in shared memory, feature-last and zero outside [0, T), with R = 12 +
// mid d + mid the branch's receptive radius (<= 42 at k = 11, d = 5), and
// runs the whole branch there: act (X -> T1), conv 1 (T1 -> X), act (X ->
// T3 in T1's place), conv 2 + bias + residual straight to device memory.
// So x is read once and written once per branch; the halo rows are
// recomputed by both neighbouring CTAs. The acts give each thread one
// channel and a strip of 16 rows held in registers, so each phase value and
// its sine is computed once per strip. The convs are a sum over the k taps
// of (rows x C_in) @ (C_in x C_out) products with bf16 WMMA fragments and
// fp32 accumulators, A from shared memory at row offset k*d, B read from
// device memory (a resblock's weights, <= 4.9 MB, stay in L2). Channels pad
// to a multiple of 16 with zeros (the wrapper pads the weights). Branches
// ping-pong between the output and a scratch tensor, since a CTA's halo
// reads rows its neighbours write. No atomics: bitwise reproducible.
#include <algorithm>

#include "common.cuh"

namespace tts {
namespace {

constexpr int NT = 256;      // threads a CTA
constexpr int NW = NT / 32;  // warps
constexpr int S = 16;        // rows a thread's act strip covers
constexpr int MAX_MT = 6;    // accumulator tiles a warp holds

// the act's 24 fp32 taps: up phase 0 (input offsets 2..-3), up phase 1
// (3..-2), decimation on phase 0 (-2..3), on phase 1 (-3..2)
struct Taps {
  float v[24];
};

template <typename E>
struct Branch {
  const E* x;    // branch input (B, T, C)
  E* y;          // branch output (B, T, C)
  const E* w1;   // (K, Cp, Cp) conv 1, dilation d
  const E* b1;   // (C,)
  const E* w2;   // (K, Cp, Cp) conv 2, dilation 1
  const E* b2;
  const E* a1;   // snake alpha / reciprocal of act 1, act 2 (C,)
  const E* r1;
  const E* a2;
  const E* r2;
  int T, C, Cp, K, d, Tb, R, rows_x, rows_t, gsize;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// a value of the element type to fp32 and back (the rounding point)
__device__ __forceinline__ float ld(bf16 v) { return to_f(v); }
__device__ __forceinline__ float ld(float v) { return v; }
template <typename E>
__device__ __forceinline__ E st(float v);
template <>
__device__ __forceinline__ bf16 st<bf16>(float v) { return to_bf(v); }
template <>
__device__ __forceinline__ float st<float>(float v) { return v; }

// out rows [0, rows_out) (global rows g0 + i) from in rows (global g0 - 6 + j)
template <typename E>
__device__ void act_rows(const E* __restrict__ in, E* __restrict__ out,
                         int rows_out, int g0, int T, int C, int Cp,
                         const E* __restrict__ alpha, const E* __restrict__ recip,
                         const Taps& tp) {
  const int strips = (rows_out + S - 1) / S;
  for (int item = threadIdx.x; item < strips * Cp; item += NT) {
    const int c = item % Cp, i0 = (item / Cp) * S;
    if (c >= C) {
#pragma unroll
      for (int s = 0; s < S; ++s) out[(i0 + s) * Cp + c] = st<E>(0.f);
      continue;
    }
    const float a = ld(alpha[c]), rc = ld(recip[c]);
    float u[S + 12];
#pragma unroll
    for (int q = 0; q < S + 12; ++q) u[q] = ld(in[(i0 + q) * Cp + c]);
    // phase position p is global row g0 + i0 + p - 3
    float pe[S + 6], po[S + 6];
#pragma unroll
    for (int p = 0; p < S + 6; ++p) {
      float e = mul(u[p + 5], tp.v[0]);
#pragma unroll
      for (int m = 1; m < 6; ++m) e = add(e, mul(u[p + 5 - m], tp.v[m]));
      float o = mul(u[p + 6], tp.v[6]);
#pragma unroll
      for (int m = 1; m < 6; ++m) o = add(o, mul(u[p + 6 - m], tp.v[6 + m]));
      const float se = sinf(mul(a, e)), so = sinf(mul(a, o));
      const int g = g0 + i0 + p - 3;
      const bool ok = g >= 0 && g < T;
      pe[p] = ok ? add(e, mul(rc, mul(se, se))) : 0.f;
      po[p] = ok ? add(o, mul(rc, mul(so, so))) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float r = mul(pe[s + 1], tp.v[12]);
#pragma unroll
      for (int m = 1; m < 6; ++m) r = add(r, mul(pe[s + 1 + m], tp.v[12 + m]));
#pragma unroll
      for (int m = 0; m < 6; ++m) r = add(r, mul(po[s + m], tp.v[18 + m]));
      const int g = g0 + i0 + s;
      out[(i0 + s) * Cp + c] = st<E>(g >= 0 && g < T ? r : 0.f);
    }
  }
}

// conv over A rows (global gbase - mid*dc + row): out rows [0, mt*16) at
// global rows gbase + r. With `res` the output goes to device memory as
// res + conv (rows [t0, t0 + Tb) of the tile), else to `dst` in shared memory.
__device__ void conv_rows(const bf16* __restrict__ a_s, const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, int mt, int dc, int gbase,
                          const Branch<bf16>& p, float* scratch, bf16* dst,
                          const bf16* __restrict__ res, bf16* __restrict__ y,
                          int t0, int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Cp = p.Cp, nt = Cp / 16, kt = Cp / 16;
  const int ngroups = (mt + p.gsize - 1) / p.gsize;
  for (int item = warp; item < nt * ngroups; item += NW) {
    const int n = item % nt, m0 = (item / nt) * p.gsize;
    const int cnt = min(p.gsize, mt - m0);
    FragC acc[MAX_MT];
#pragma unroll
    for (int i = 0; i < MAX_MT; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < p.K; ++k) {
      const bf16* wk = w + (size_t)k * Cp * Cp + n * 16;
      const bf16* ak = a_s + (k * dc) * Cp;
      for (int kk = 0; kk < kt; ++kk) {
        FragB bw;
        wmma::load_matrix_sync(bw, wk + (size_t)kk * 16 * Cp, Cp);
#pragma unroll
        for (int i = 0; i < MAX_MT; ++i) {
          if (i < cnt) {
            FragA fa;
            wmma::load_matrix_sync(fa, ak + (m0 + i) * 16 * Cp + kk * 16, Cp);
            wmma::mma_sync(acc[i], fa, bw, acc[i]);
          }
        }
      }
    }
    float* sc = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < MAX_MT; ++i) {
      if (i >= cnt) break;
      wmma::store_matrix_sync(sc, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = (m0 + i) * 16 + (e >> 4), c = n * 16 + (e & 15);
        const int g = gbase + r;
        const bool ok = c < p.C && g >= 0 && g < p.T;
        const float v = ok ? rnd(rnd(sc[e]) + to_f(bias[c])) : 0.f;
        if (res == nullptr) {
          dst[r * Cp + c] = to_bf(v);
        } else if (ok && g < t0 + p.Tb) {
          const size_t o = ((size_t)b * p.T + g) * p.C + c;
          y[o] = to_bf(to_f(res[o]) + v);
        }
      }
      __syncwarp();
    }
  }
}

// the fp32 form of conv_rows: out rows [0, mrows), 64 a pass, each thread
// rows ty + 16 i (i < 4) and channels tx + 16 j (j < Cp / 16 <= 8), true
// fp32 FMAs over the k taps and the input channels
__device__ void conv_rows_f32(const float* __restrict__ a_s, const float* __restrict__ w,
                              const float* __restrict__ bias, int mrows, int dc, int gbase,
                              const Branch<float>& p, float* dst,
                              const float* __restrict__ res, float* __restrict__ y, int t0,
                              int b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int Cp = p.Cp, nj = Cp / 16;
  for (int r0 = 0; r0 < mrows; r0 += 64) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    int rows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[i] = min(r0 + ty + 16 * i, mrows - 1);
    for (int k = 0; k < p.K; ++k) {
      const float* ak = a_s + (size_t)(k * dc) * Cp;
      const float* wk = w + (size_t)k * Cp * Cp + tx;
      for (int ci = 0; ci < Cp; ++ci) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ak[rows[i] * Cp + ci];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nj) {
            const float wv = __ldg(wk + (size_t)ci * Cp + 16 * j);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], wv, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r >= mrows) break;
      const int g = gbase + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nj) break;
        const int c = tx + 16 * j;
        const bool ok = c < p.C && g >= 0 && g < p.T;
        const float v = ok ? acc[i][j] + bias[c] : 0.f;
        if (res == nullptr) {
          dst[r * Cp + c] = v;
        } else if (ok && g < t0 + p.Tb) {
          const size_t o = ((size_t)b * p.T + g) * p.C + c;
          y[o] = res[o] + v;
        }
      }
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(NT)
amp_branch_kernel(Branch<E> p, Taps tp) {
  constexpr bool F32 = sizeof(E) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  E* xs = reinterpret_cast<E*>(smem);                       // X, then T2
  E* ts = xs + (size_t)p.rows_x * p.Cp;                     // T1, then T3
  float* scratch = reinterpret_cast<float*>(ts + (size_t)p.rows_t * p.Cp);
  const int t0 = blockIdx.x * p.Tb, b = blockIdx.y;
  const int Cp = p.Cp, C = p.C, T = p.T, mid = (p.K - 1) / 2;

  // stage x rows [t0 - R, t0 - R + rows_x), zero outside [0, T) and C
  const E* xb = p.x + (size_t)b * T * C;
  constexpr int VEC = 16 / sizeof(E);   // elements a 16-byte word
  const int chunks = Cp / VEC;
  for (int i = threadIdx.x; i < p.rows_x * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * VEC, g = t0 - p.R + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < T && c < C) v = *reinterpret_cast<const uint4*>(xb + (size_t)g * C + c);
    *reinterpret_cast<uint4*>(xs + (size_t)r * Cp + c) = v;
  }
  __syncthreads();

  const int w1_rows = p.Tb + 2 * (p.R - 6);   // act 1 output rows
  act_rows<E>(xs, ts, w1_rows, t0 - p.R + 6, T, C, Cp, p.a1, p.r1, tp);
  __syncthreads();
  const int m2 = (p.Tb + 2 * (6 + mid) + 15) / 16;
  if constexpr (F32)
    conv_rows_f32(ts, p.w1, p.b1, m2 * 16, p.d, t0 - 6 - mid, p, xs, nullptr, nullptr, t0, b);
  else
    conv_rows(ts, p.w1, p.b1, m2, p.d, t0 - 6 - mid, p, scratch, xs, nullptr, nullptr, t0, b);
  __syncthreads();
  act_rows<E>(xs, ts, p.Tb + 2 * mid, t0 - mid, T, C, Cp, p.a2, p.r2, tp);
  __syncthreads();
  if constexpr (F32)
    conv_rows_f32(ts, p.w2, p.b2, p.Tb, 1, t0, p, nullptr, p.x, p.y, t0, b);
  else
    conv_rows(ts, p.w2, p.b2, p.Tb / 16, 1, t0, p, scratch, nullptr, p.x, p.y, t0, b);
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// accumulator tiles a warp takes at once: the fewest mma rounds per warp
// over the CTA's work, ties to the larger group (more reuse of B)
int group_size(int mt, int nt) {
  int best = 1, best_cost = 1 << 30;
  for (int g = MAX_MT; g >= 1; --g) {
    const int items = nt * ((mt + g - 1) / g);
    const int cost = ((items + NW - 1) / NW) * g;
    if (cost < best_cost) best = g, best_cost = cost;
  }
  return best;
}

template <typename E>
int run_block(const void* x, void* out, void* tmp, const void* w1, const void* b1,
              const void* w2, const void* b2, const void* a1, const void* r1, const void* a2,
              const void* r2, const float* taps, const int* dils, int J, int B, int T, int C,
              int K, cudaStream_t s) {
  constexpr bool F32 = sizeof(E) == 4;
  Taps tp;
  for (int i = 0; i < 24; ++i) tp.v[i] = taps[i];
  const int Cp = round_up(C, 16), mid = (K - 1) / 2;
  if (F32 && Cp > 128) return (int)cudaErrorInvalidValue;
  // the row tile: two buffers of Tb + 2R rows fit 227 KB at R <= 42
  const int Tb = F32 ? (Cp > 64 ? 128 : 256) : (Cp > 128 ? 64 : Cp > 64 ? 128 : 256);
  static int smem_set[MAX_DEVICES];
  cudaError_t err = raise_attr(amp_branch_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024, smem_set);
  if (err != cudaSuccess) return (int)err;
  const E* src = (const E*)x;
  for (int j = 0; j < J; ++j) {
    const int d = dils[j];
    Branch<E> p;
    p.x = src;
    p.y = (E*)(((J - 1 - j) % 2 == 0) ? out : tmp);
    p.w1 = (const E*)w1 + (size_t)j * K * Cp * Cp;
    p.w2 = (const E*)w2 + (size_t)j * K * Cp * Cp;
    p.b1 = (const E*)b1 + (size_t)j * C;
    p.b2 = (const E*)b2 + (size_t)j * C;
    p.a1 = (const E*)a1 + (size_t)j * C;
    p.r1 = (const E*)r1 + (size_t)j * C;
    p.a2 = (const E*)a2 + (size_t)j * C;
    p.r2 = (const E*)r2 + (size_t)j * C;
    p.T = T, p.C = C, p.Cp = Cp, p.K = K, p.d = d, p.Tb = Tb;
    p.R = 12 + mid * d + mid;
    const int w1r = Tb + 2 * (p.R - 6);              // act 1 output rows
    const int m2 = round_up(Tb + 2 * (6 + mid), 16);  // conv 1 output rows
    const int w3r = Tb + 2 * mid;                     // act 2 output rows
    // act strips write S-row blocks and read 12 rows past them; conv 1 reads
    // 2 mid d rows past its padded output
    p.rows_x = std::max(std::max(round_up(w1r, S) + 12, m2), round_up(w3r, S) + 12);
    p.rows_t = std::max(std::max(round_up(w1r, S), m2 + 2 * mid * d), round_up(w3r, S));
    p.gsize = group_size(m2 / 16, Cp / 16);
    const size_t smem = (size_t)(p.rows_x + p.rows_t) * Cp * sizeof(E) +
                        (F32 ? 0 : NW * 256 * sizeof(float));
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((T + Tb - 1) / Tb, B);
    amp_branch_kernel<E><<<grid, NT, smem, s>>>(p, tp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = p.y;
  }
  return 0;
}

}  // namespace
}  // namespace tts

// x, out, tmp (B, T, C) bf16; w1, w2 (J, K, Cp, Cp) bf16 with Cp = C rounded
// up to 16 (zero-padded); b1, b2, a1, r1, a2, r2 (J, C) bf16; taps: 24 host
// floats; dils: J host ints. C a multiple of 8 and at most 256, K odd and at
// most 11. Branch j reads x (j = 0) or branch j-1's output and writes out or
// tmp so that the last branch writes out.
extern "C" int amp_block_fused(const void* x, void* out, void* tmp, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* a1, const void* r1, const void* a2,
                               const void* r2, const float* taps, const int* dils,
                               int J, int B, int T, int C, int K, void* stream) {
  return tts::run_block<tts::bf16>(x, out, tmp, w1, b1, w2, b2, a1, r1, a2, r2, taps, dils,
                                   J, B, T, C, K, (cudaStream_t)stream);
}

// The same in fp32: every tensor fp32, C a multiple of 8 and at most 128.
extern "C" int amp_block_fused_f32(const void* x, void* out, void* tmp, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   const void* a1, const void* r1, const void* a2,
                                   const void* r2, const float* taps, const int* dils,
                                   int J, int B, int T, int C, int K, void* stream) {
  return tts::run_block<float>(x, out, tmp, w1, b1, w2, b2, a1, r1, a2, r2, taps, dils, J,
                               B, T, C, K, (cudaStream_t)stream);
}
