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
// tensor cores (wgmma); in fp32 they are true fp32 FMAs on the CUDA cores
// (no TF32), and every rounding to the dtype is exact.
//
// What bounds it on an H100: at the BigVGAN bench shapes the convs are
// 12 k C^2 T flops a resblock (0.08 ms of bf16 tensor-core time at stage 2,
// C 192, T 16384, k 11; 0.6 ms of fp32 CUDA-core time at stage 3) and the
// acts ~80 fp32 flops and two sines per (t, c) per act (the larger term
// below C ~ 96 in bf16); the bytes, one read and one write of x, are the
// smallest term.
//
// Design: one launch per dilation branch, each a grid of (T / Tb row tiles,
// B) CTAs of 384 threads (three warpgroups). A CTA computes the branch for
// its Tb output rows with every intermediate in shared memory: act 1 reads
// its x rows [t0 - R, t0 + Tb + R) from device memory (R = 12 + mid d + mid,
// the branch's receptive radius) and writes T1; conv 1 reads T1 and writes
// T2; act 2 writes T3 in T1's place; conv 2 + bias + residual write to
// device memory. So x is read and written once a branch, and the halo rows
// are recomputed by both neighbouring CTAs: the row tile Tb is as wide as
// shared memory and registers allow (ops/bigvgan_stage.amp_plan; 128 rows
// at C 192 where the earlier form took 64), which the C entry checks.
//  * bf16 convs: an implicit-im2col GEMM on wgmma m64nNk16 (N = 64 NB, all
//    output channels in one product) with A from registers. The act writes
//    its rows straight into the layout the conv's A reads: planes of 64
//    channels, 128 bytes a row, each row's 16-byte chunks XOR-swizzled by
//    row % 8, so ldmatrix.x4 takes A at any tap offset k d without bank
//    conflicts (kernel 2's design, grouped_conv.cu). B, the weight taps,
//    streams through a ring of 4 shared-memory slots filled by cp.async in
//    the 128-byte swizzle (MN-major), a stage = one tap's 32 input
//    channels x all output channels; the copies of stage s + 2 are queued
//    after stage s's one barrier, and the first stages before the act
//    runs, so they land under it. Each warpgroup owns up to MT 64-row tiles
//    of fp32 accumulators in registers (MT NB <= 3, or MT 1). Conv 1's
//    epilogue writes T2 from the accumulators; conv 2's stages its rows in
//    T2's place, then y = x + v goes out in 16-byte loads and stores.
//  * the act: a strip of 16 rows of one channel a thread, its 2 (16 + 6)
//    sines by a branchless range-reduced polynomial (sinf past |x| 8192).
//  * fp32 convs: register tiles on the CUDA cores (as kernel 4's fp32
//    template, flash_mha.cu): a thread owns 8 rows x 8 output channels,
//    float4 operands from activation rows padded to C + 4 floats and from
//    the staged weight rows; the weights stream through a ring of 3 slots by
//    cp.async, a stage = one tap's 32 input channels.
// Branches ping-pong between the output and a scratch tensor, since a CTA's
// act 1 reads rows its neighbours write. No atomics: bitwise reproducible.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tts {
namespace {

constexpr int NT = 384;                 // threads a CTA: three warpgroups
constexpr int NWG = NT / 128;
constexpr int S = 16;                   // rows a thread's act strip covers
constexpr int KB = 32;                  // input channels a weight stage
constexpr int SLOTS_BF16 = 4, SLOTS_F32 = 3;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_TB = 1024;

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
  int T, C, Cp, K, d, mid, R, Tb;
  int Ck;             // the convs' input channels in the activation buffers (zero
                      // past C): bf16 C rounded up to a stage's 32, fp32 Cp
  int rows1, rows2;   // rows of buffer 1 (T1, then T3) and buffer 2 (T2)
  int done1, done2;   // rows of each that the act / conv 1 write; the rest zeroed
  int mr1;            // conv 1's output rows (bf16: whole 64-row tiles)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// a value of the element type to fp32 and back (the rounding point)
__device__ __forceinline__ float ld(bf16 v) { return to_f(v); }
__device__ __forceinline__ float ld(float v) { return v; }

// ------------------------------------------------------------ buffers

// bf16 activations: planes of 64 channels, `cap` rows of 128 bytes each,
// the row's 16-byte chunks XOR-swizzled by row % 8
__device__ __forceinline__ uint32_t plane_off(int r, int c, int cap) {
  return (uint32_t)((c >> 6) * cap * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                    (c & 7) * 2);
}
// Each buffer hands the act one channel's strip of rows i0 + q (i0 a
// multiple of 8, so the swizzle of row i0 + q is that of q, known where the
// act's loops unroll): get(q, edge) reads row q, which reads as 0 outside
// [0, T) where `edge` says the strip may cross an end; put(q, v) writes it.
struct PlanesBuf {
  unsigned char* base;
  int cap;
  struct Strip {
    unsigned char* p;  // the strip's row 0 at chunk 0 of the swizzle
    uint32_t cs;       // the channel's chunk, times 16
    __device__ __forceinline__ unsigned char* at(int q) const {
      return p + q * 128 + (cs ^ ((q & 7) << 4));
    }
    __device__ __forceinline__ float get(int q, bool) const {
      return to_f(*reinterpret_cast<const bf16*>(at(q)));
    }
    __device__ __forceinline__ void put(int q, float v) const {
      *reinterpret_cast<bf16*>(at(q)) = to_bf(v);
    }
  };
  __device__ Strip strip(int i0, int c) const {
    return Strip{base + (size_t)(c >> 6) * cap * 128 + i0 * 128 + (c & 7) * 2,
                 (uint32_t)(((c >> 3) & 7) << 4)};
  }
};
// fp32 activations: rows of ld floats
struct RowsBuf {
  float* base;
  int ld;
  struct Strip {
    float* p;
    int ld;
    __device__ __forceinline__ float get(int q, bool) const { return p[q * ld]; }
    __device__ __forceinline__ void put(int q, float v) const { p[q * ld] = v; }
  };
  __device__ Strip strip(int i0, int c) const { return Strip{base + i0 * ld + c, ld}; }
};
// act 1's input: x rows g0 + r of one batch row, zero outside [0, T)
template <typename E>
struct GlobalRows {
  const E* xb;
  int g0, T, C;
  struct Strip {
    const E* xc;   // the channel's column
    int g, T, C;   // the strip's first global row
    __device__ __forceinline__ float get(int q, bool edge) const {
      const int r = g + q;
      return !edge || (r >= 0 && r < T) ? ld(xc[(size_t)r * C]) : 0.f;
    }
  };
  __device__ Strip strip(int i0, int c) const { return Strip{xb + c, g0 + i0, T, C}; }
};
template <typename E>
using Buf = typename std::conditional<sizeof(E) == 2, PlanesBuf, RowsBuf>::type;

// ------------------------------------------------------------ the act

// sin(x)^2 without a branch, for |x| <= SIN_MAX: x reduced by the nearest
// multiple j of pi / 2 (a three-part Cody-Waite reduction in FMAs, j by
// the 1.5 * 2^23 rounding trick), then Cephes' single-precision sine or
// cosine polynomial on |r| <= pi / 4 by the parity of j (the sign drops out
// of the square). Relative error a few fp32 ulps, far inside the kernel's
// tolerance against the fp32 twin (2^-14 in fp32); sinf's own slow-path
// test is a branch a call, which keeps the compiler from interleaving the
// strip's 2 (S + 6) sines.
constexpr float SIN_MAX = 8192.f;
__device__ __forceinline__ float sin_sq(float x) {
  const float t = fmaf(x, 0.636619772367581343f, 12582912.f);
  const float jf = t - 12582912.f;
  const int n = __float_as_int(t);
  float r = fmaf(jf, -1.57079637050628662109375f, x);
  r = fmaf(jf, 4.37113900018624283e-8f, r);
  r = fmaf(jf, 1.7151245100059e-15f, r);
  const float z = r * r;
  const float sn = fmaf(z * r, fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                                    -1.6666654611e-1f), r);
  const float cs = fmaf(z * z, fmaf(fmaf(2.443315711809948e-5f, z, -1.388731625493765e-3f), z,
                                    4.166664568298827e-2f), fmaf(-0.5f, z, 1.f));
  const float v = (n & 1) ? cs : sn;
  return v * v;
}

// One strip: S output rows (global rows g from row 0 on) of one channel from
// its S + 12 input rows held in registers, each phase value and its sine
// computed once. EDGE: the strip may cross an end of [0, T), where the
// input reads 0 and the phase streams and the output are 0. FAST: sin_sq;
// it returns false, writing nothing, where an argument passes SIN_MAX
// (the caller then runs the strip with sinf).
template <bool EDGE, bool FAST, class In, class Out>
__device__ __forceinline__ bool act_strip(const In& in, const Out& out, int g, int T, float a,
                                          float rc, const Taps& tp) {
  float u[S + 12];
#pragma unroll
  for (int q = 0; q < S + 12; ++q) u[q] = in.get(q, EDGE);
  // phase position p is global row g + p - 3
  float pe[S + 6], po[S + 6];
  bool big = false;
#pragma unroll
  for (int p = 0; p < S + 6; ++p) {
    float e = mul(u[p + 5], tp.v[0]);
#pragma unroll
    for (int m = 1; m < 6; ++m) e = add(e, mul(u[p + 5 - m], tp.v[m]));
    float o = mul(u[p + 6], tp.v[6]);
#pragma unroll
    for (int m = 1; m < 6; ++m) o = add(o, mul(u[p + 6 - m], tp.v[6 + m]));
    const float xe = mul(a, e), xo = mul(a, o);
    float se2, so2;
    if (FAST) {
      big |= fabsf(xe) > SIN_MAX || fabsf(xo) > SIN_MAX;
      se2 = sin_sq(xe);
      so2 = sin_sq(xo);
    } else {
      const float se = sinf(xe), so = sinf(xo);
      se2 = mul(se, se);
      so2 = mul(so, so);
    }
    const bool ok = !EDGE || (g + p - 3 >= 0 && g + p - 3 < T);
    pe[p] = ok ? add(e, mul(rc, se2)) : 0.f;
    po[p] = ok ? add(o, mul(rc, so2)) : 0.f;
  }
  if (FAST && big) return false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float r = mul(pe[s + 1], tp.v[12]);
#pragma unroll
    for (int m = 1; m < 6; ++m) r = add(r, mul(pe[s + 1 + m], tp.v[12 + m]));
#pragma unroll
    for (int m = 0; m < 6; ++m) r = add(r, mul(po[s + m], tp.v[18 + m]));
    out.put(s, !EDGE || (g + s >= 0 && g + s < T) ? r : 0.f);
  }
  return true;
}

// out rows [0, rows_out) (global rows g0 + i) from in rows j (global g0 - 6
// + j): a thread takes one of the C channels and a strip of S rows (the
// items run over the channels in order, so a warp spans strips where C is
// not a multiple of 32); channels in [C, Cp) (Cp the convs' input
// channels) are written as zeros apart. A strip whose input rows all lie in
// [0, T) skips every edge check.
template <typename E, class In, class Out>
__device__ __forceinline__ void act_rows(const In& in, const Out& out, int rows_out, int g0,
                                         int T, int C,
                         int Cp, const E* __restrict__ alpha, const E* __restrict__ recip,
                         const Taps& tp) {
  const int strips = (rows_out + S - 1) / S, pad = Cp - C;
  for (int item = threadIdx.x; item < strips * pad; item += NT) {
    const auto dst = out.strip((item / pad) * S, C + item % pad);
#pragma unroll
    for (int s = 0; s < S; ++s) dst.put(s, 0.f);
  }
  for (int item = threadIdx.x; item < strips * C; item += NT) {
    const int c = item % C, i0 = (item / C) * S;
    const auto dst = out.strip(i0, c);
    const auto src = in.strip(i0, c);
    const float a = ld(alpha[c]), rc = ld(recip[c]);
    const int g = g0 + i0;
    const bool done = g - 6 >= 0 && g + S + 5 < T
                          ? act_strip<false, true>(src, dst, g, T, a, rc, tp)
                          : act_strip<true, true>(src, dst, g, T, a, rc, tp);
    if (!done) act_strip<true, false>(src, dst, g, T, a, rc, tp);   // an argument past SIN_MAX
  }
}

// ------------------------------------------------------------ weight stages

// Stage s of a conv's K taps of (Cp in, Cp out) weights: tap s / QB, input
// channels KB (s % QB) .. + KB - 1 (zero past Cp), all output channels.
// bf16: MN-major blocks of KB rows x 64 columns (4096 bytes each, column
// block j at j * 4096), the 128-byte swizzle; fp32: KB rows of Cp floats.
__device__ __forceinline__ void load_stage(uint32_t dst, const bf16* __restrict__ w, int Cp,
                                           int s, int nb) {
  const int QB = (Cp + KB - 1) / KB, k = s / QB, q = s % QB, chunks = nb * 8;
  for (int i = threadIdx.x; i < KB * chunks; i += NT) {
    const int r = i / chunks, ch = i % chunks, ci = q * KB + r, n = ch * 8;
    const bool ok = ci < Cp && n < Cp;
    cp_async16_or_zero(dst + (ch >> 3) * 4096 + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                       w + ((size_t)k * Cp + (ok ? ci : 0)) * Cp + (ok ? n : 0), ok);
  }
}
__device__ __forceinline__ void load_stage(uint32_t dst, const float* __restrict__ w, int Cp,
                                           int s, int) {
  const int QB = (Cp + KB - 1) / KB, k = s / QB, q = s % QB, chunks = Cp / 4;
  for (int i = threadIdx.x; i < KB * chunks; i += NT) {
    const int r = i / chunks, ch = i % chunks, ci = q * KB + r;
    const bool ok = ci < Cp;
    cp_async16_or_zero(dst + (r * Cp + ch * 4) * 4,
                       w + ((size_t)k * Cp + (ok ? ci : 0)) * Cp + ch * 4, ok);
  }
}

// queue a conv's first stages (the caller commits one group each)
template <typename E, int SLOTS>
__device__ __forceinline__ void conv_prologue(uint32_t ring, uint32_t slot_bytes, const E* w,
                                              int Cp, int nst, int nb) {
#pragma unroll
  for (int s = 0; s < SLOTS - 2; ++s) {
    if (s < nst) load_stage(ring + s * slot_bytes, w, Cp, s, nb);
    cp_commit();
  }
}

// the ring step of stage s: wait for its copies, one barrier (every thread
// is done with stage s - 2's slot), queue stage s + SLOTS - 2's copies
template <typename E, int SLOTS>
__device__ __forceinline__ void ring_step(uint32_t ring, uint32_t slot_bytes, const E* w, int Cp,
                                          int s, int nst, int nb) {
  cp_wait<SLOTS - 3>();
  fence_async_smem();
  __syncthreads();
  const int ns = s + SLOTS - 2;
  if (ns < nst) load_stage(ring + (ns % SLOTS) * slot_bytes, w, Cp, ns, nb);
  cp_commit();
}

// ------------------------------------------------------------ bf16 conv

// four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i of every lane holds matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// One conv: out rows [0, 64 mtiles) = sum over taps k of A rows r + k dil
// (the plane buffer at `a`, `cap` rows, Ck input channels) times tap k's
// weights, one wgmma m64nNk16 (N = 64 NB, all output columns) a tile and
// k16 slice. Warpgroup g takes the 64-row tiles MT g .. MT g + MT - 1 (a
// tile past the last recomputes the last, which the epilogue drops);
// acc[i] is tile i's accumulators. Every warpgroup issues the same
// products, with no branch around them: ptxas serializes wgmmas on a path
// it cannot prove uniform (C7520). A stage's products are in flight when
// the next stage's barrier is reached; its A fragments are loaded once the
// previous stage's products are done (writing a wgmma's A registers while
// one is in flight makes ptxas serialize them, C7513: a second set of A
// registers drew the same; loading them before the barrier ran ~7%
// slower on the card).
template <int NB, int MT>
__device__ __forceinline__ void conv_bf16(float (&acc)[MT][NB * 32], uint32_t ring, uint32_t a,
                                          int cap, const bf16* w, int Cp, int Ck, int K,
                                          int dil, int mtiles) {
  constexpr uint32_t SB = NB * 4096;
  const int QB = Ck / KB, nst = K * QB;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  for (int s = 0; s < nst; ++s) {
    ring_step<bf16, SLOTS_BF16>(ring, SB, w, Cp, s, nst, NB);
    wg_wait0();
#pragma unroll
    for (int i = 0; i < MT; ++i) hold(acc[i]);
    const int k = s / QB, q = s % QB;
    uint32_t af[MT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = min(wg * MT + i, mtiles - 1) * 64 + warp * 16 + (lane & 15) + k * dil;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4(af[i][kk], a + plane_off(r, q * KB + 16 * kk + 8 * (lane >> 4), cap));
    }
    const uint32_t slot = ring + (s % SLOTS_BF16) * SB;
    wg_fence();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs(acc[i], af[i][kk], gdesc(slot + kk * 2048, 4096, 1024), s > 0 || kk > 0);
    wg_commit();
  }
  wg_wait0();
#pragma unroll
  for (int i = 0; i < MT; ++i) hold(acc[i]);
}

// The bf16 convs' epilogue: v = bf16(bf16(acc) + bias), zero outside [0, T)
// and past C, for output row r at global row gbase + r, written to `dst`:
// the plane buffer (conv 1), or (stage) rows of ld bf16 values that
// residual_bf16 then adds to x (conv 2).
template <int NB, int MT, bool PLANES>
__device__ __forceinline__ void epilogue_bf16(const float (&acc)[MT][NB * 32],
                                              const Branch<bf16>& p, const bf16* bias,
                                              int mtiles, int gbase, unsigned char* dst,
                                              int ld) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int mcnt = min(MT, mtiles - wg * MT);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mcnt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * MT + i) * 64 + warp * 16 + (lane >> 2) + 8 * h, g = gbase + r;
      const bool row_ok = g >= 0 && g < p.T;
#pragma unroll
      for (int jj = 0; jj < NB * 8; ++jj) {
        const int c = 8 * jj + 2 * (lane & 3);
        if (c >= p.Cp) break;
        const bool ok = row_ok && c < p.C;   // C even: c + 1 < C too
        float v0 = 0.f, v1 = 0.f;
        if (ok) {
          const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
          v0 = rnd(rnd(acc[i][4 * jj + 2 * h]) + bv.x);
          v1 = rnd(rnd(acc[i][4 * jj + 2 * h + 1]) + bv.y);
        }
        const uint32_t off = PLANES ? plane_off(r, c, ld) : (uint32_t)(r * ld + c) * 2;
        *reinterpret_cast<uint32_t*>(dst + off) = pack_bf16(v0, v1);
      }
    }
  }
}

// conv 2's residual: y = x + v over the tile's rows [t0, t0 + Tb) in [0, T),
// v the staged rows (ld bf16 values a row), 8 channels a 16-byte load
__device__ __forceinline__ void residual_bf16(const Branch<bf16>& p, const unsigned char* stage,
                                              int ld, int t0, int b) {
  const int chunks = p.C / 8, rows = min(p.Tb, p.T - t0);
  const bf16* __restrict__ x = p.x;
  bf16* __restrict__ y = p.y;
  for (int i = threadIdx.x; i < rows * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const size_t o = ((size_t)b * p.T + t0 + r) * p.C + c;
    Vec8 xv, vv, out;
    xv.u = __ldg(reinterpret_cast<const uint4*>(x + o));
    vv.u = *reinterpret_cast<const uint4*>(stage + (size_t)(r * ld + c) * 2);
#pragma unroll
    for (int e = 0; e < 8; ++e) out.h[e] = to_bf(to_f(xv.h[e]) + to_f(vv.h[e]));
    *reinterpret_cast<uint4*>(y + o) = out.u;
  }
}

// ------------------------------------------------------------ fp32 conv

// A stage's products in fp32 for a thread's RT rows x 8 columns: nci input
// channels, 4 a step (float4 along them from each A row, float4 along the
// output channels from the staged weight rows: ws at the thread's first
// column, its second group Cp / 2 on)
template <int RT>
__device__ __forceinline__ void mac_f32(float (&acc)[8][8], const float* ws, const float* ak,
                                        int lda, const int (&rows)[8], int Cp, int nci) {
  for (int c4 = 0; c4 < nci; c4 += 4) {
    float4 wv[4][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      wv[e][0] = *reinterpret_cast<const float4*>(ws + (c4 + e) * Cp);
      wv[e][1] = *reinterpret_cast<const float4*>(ws + (c4 + e) * Cp + Cp / 2);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(ak + rows[i] * lda + c4);
      const float ae[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[i][4 * h + 0] = fmaf(ae[e], wv[e][h].x, acc[i][4 * h + 0]);
          acc[i][4 * h + 1] = fmaf(ae[e], wv[e][h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(ae[e], wv[e][h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(ae[e], wv[e][h].w, acc[i][4 * h + 3]);
        }
    }
  }
}

// One fp32 conv: out rows [0, mrows) = sum over taps k of A rows r + k dil
// (`a`, rows of lda floats, Ck input channels, zero past C; the weights
// zero past Cp) times tap k's weights, in passes of 8 TY rows:
// thread (tx, ty) (TX = Cp / 8 column lanes) owns rows ty + TY i (i < 8)
// and output channels 4 tx .. 4 tx + 3 and Cp / 2 + 4 tx .. + 3, summed
// over the taps, then the input channels, in order. The epilogue adds the
// bias (fp32) and zeroes rows outside [0, T) and channels past C; into
// `dst` (conv 1) or y = x + v at rows < Tb (conv 2).
__device__ __forceinline__ void conv_f32(uint32_t ring, const float* ringp, const float* a,
                                         int lda, const float* w, const float* bias, int mrows,
                                         int dil, int gbase, const Branch<float>& p,
                                         const RowsBuf* dst, const float* __restrict__ xres,
                                         float* __restrict__ y, int b) {
  const int Cp = p.Cp, TX = Cp / 8, TY = NT / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const bool active = ty < TY;
  const uint32_t SB = KB * Cp * 4;
  const int QB = (p.Ck + KB - 1) / KB, nst = p.K * QB;
  for (int r0 = 0; r0 < mrows; r0 += 8 * TY) {
    // rows ty + TY i, i < rt: the pass's live rows only
    const int rt = min(8, (mrows - r0 + TY - 1) / TY);
    if (r0 > 0) {
      __syncthreads();  // every thread is done with the ring's last stages
      conv_prologue<float, SLOTS_F32>(ring, SB, w, Cp, nst, 0);
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    int rows[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) rows[i] = min(r0 + ty + TY * i, mrows - 1);
    for (int s = 0; s < nst; ++s) {
      ring_step<float, SLOTS_F32>(ring, SB, w, Cp, s, nst, 0);
      if (!active) continue;
      const int k = s / QB, q = s % QB, nci = min(KB, p.Ck - q * KB);
      const float* ws = ringp + (s % SLOTS_F32) * (SB / 4) + 4 * tx;
      const float* ak = a + (size_t)k * dil * lda + q * KB;
      switch (rt) {
        case 1: mac_f32<1>(acc, ws, ak, lda, rows, Cp, nci); break;
        case 2: mac_f32<2>(acc, ws, ak, lda, rows, Cp, nci); break;
        case 3: mac_f32<3>(acc, ws, ak, lda, rows, Cp, nci); break;
        case 4: mac_f32<4>(acc, ws, ak, lda, rows, Cp, nci); break;
        case 5: mac_f32<5>(acc, ws, ak, lda, rows, Cp, nci); break;
        case 6: mac_f32<6>(acc, ws, ak, lda, rows, Cp, nci); break;
        case 7: mac_f32<7>(acc, ws, ak, lda, rows, Cp, nci); break;
        default: mac_f32<8>(acc, ws, ak, lda, rows, Cp, nci); break;
      }
    }
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + ty + TY * i, g = gbase + r;
      if (r >= mrows) break;
      const bool row_ok = g >= 0 && g < p.T;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * (Cp / 2) + 4 * tx;
        const bool ok = row_ok && c < p.C;   // C % 8 == 0: c .. c + 3 all in or all out
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          const float4 bv = *reinterpret_cast<const float4*>(bias + c);
          v = make_float4(acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y,
                          acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w);
        }
        if (dst) {
          *reinterpret_cast<float4*>(dst->base + r * dst->ld + c) = v;
        } else if (ok && r < p.Tb) {
          const size_t o = ((size_t)b * p.T + g) * p.C + c;
          const float4 xr = __ldg(reinterpret_cast<const float4*>(xres + o));
          *reinterpret_cast<float4*>(y + o) =
              make_float4(xr.x + v.x, xr.y + v.y, xr.z + v.z, xr.w + v.w);
        }
      }
    }
  }
}

// ------------------------------------------------------------ the kernel

// shared memory: the weight ring, buffer 1 (rows1), buffer 2 (rows2)
template <typename E>
__host__ __device__ constexpr int slots() { return sizeof(E) == 2 ? SLOTS_BF16 : SLOTS_F32; }
template <typename E>
__host__ __device__ inline int slot_bytes(int Cp) {
  return sizeof(E) == 2 ? (Cp + 63) / 64 * 4096 : KB * Cp * 4;
}
template <typename E>
__host__ __device__ inline int row_bytes(int Cp, int Ck) {
  return sizeof(E) == 2 ? (Cp + 63) / 64 * 128 : (Ck + 4) * 4;
}
template <typename E>
__host__ __device__ inline size_t smem_bytes(int Cp, int Ck, int rows1, int rows2) {
  return 1024 + (size_t)slots<E>() * slot_bytes<E>(Cp) +
         (size_t)(rows1 + rows2) * row_bytes<E>(Cp, Ck);
}

// zero rows [from, rows) of a buffer (rows its writer leaves unwritten
// that a later stage reads)
__device__ __forceinline__ void zero_rows(unsigned char* buf, int from, int rows, int rb) {
  uint4* p = reinterpret_cast<uint4*>(buf + (size_t)from * rb);
  for (int i = threadIdx.x; i < (rows - from) * rb / 16; i += NT) p[i] = make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void zero_plane_rows(unsigned char* buf, int from, int rows, int cap,
                                                int planes) {
  const int per = (rows - from) * 8;
  for (int i = threadIdx.x; i < planes * per; i += NT) {
    const int pl = i / per, j = i % per;
    *reinterpret_cast<uint4*>(buf + (size_t)pl * cap * 128 + (size_t)(from + j / 8) * 128 +
                              (j % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
}

template <typename E, int NB, int MT>
__global__ void __launch_bounds__(NT, 1) amp_branch_kernel(Branch<E> p, Taps tp) {
  constexpr bool F32 = sizeof(E) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* ringp = smem + (ring - smem_u32(smem));
  const int Cp = p.Cp, SB = slot_bytes<E>(Cp), RB = row_bytes<E>(Cp, p.Ck);
  unsigned char* b1p = ringp + slots<E>() * SB;
  unsigned char* b2p = b1p + (size_t)p.rows1 * RB;
  const int t0 = blockIdx.x * p.Tb, b = blockIdx.y;
  const int nst = p.K * ((p.Ck + KB - 1) / KB);
  Buf<E> buf1, buf2;
  if constexpr (F32) {
    buf1 = RowsBuf{reinterpret_cast<float*>(b1p), p.Ck + 4};
    buf2 = RowsBuf{reinterpret_cast<float*>(b2p), p.Ck + 4};
    zero_rows(b1p, p.done1, p.rows1, RB);
    zero_rows(b2p, p.done2, p.rows2, RB);
  } else {
    buf1 = PlanesBuf{b1p, p.rows1};
    buf2 = PlanesBuf{b2p, p.rows2};
    zero_plane_rows(b1p, p.done1, p.rows1, p.rows1, NB);
    zero_plane_rows(b2p, p.done2, p.rows2, p.rows2, NB);
  }
  // conv 1's first weight stages land while act 1 runs
  conv_prologue<E, slots<E>()>(ring, SB, p.w1, Cp, nst, NB);

  // act 1: x rows [t0 - R, ...) -> T1 rows (global t0 - R + 6 + i)
  const GlobalRows<E> xin{p.x + (size_t)b * p.T * p.C, t0 - p.R, p.T, p.C};
  act_rows<E>(xin, buf1, p.Tb + 2 * (p.R - 6), t0 - p.R + 6, p.T, p.C, p.Ck, p.a1, p.r1, tp);
  const int g1 = t0 - 6 - p.mid;   // conv 1's output row 0
  const float* ringf = reinterpret_cast<const float*>(ringp);
  if constexpr (F32) {
    conv_f32(ring, ringf, buf1.base, buf1.ld, p.w1, p.b1, p.mr1, p.d, g1, p, &buf2, nullptr,
             nullptr, b);
  } else {
    float acc[MT][NB * 32];
    conv_bf16<NB, MT>(acc, ring, smem_u32(b1p), p.rows1, p.w1, Cp, p.Ck, p.K, p.d, p.mr1 / 64);
    epilogue_bf16<NB, MT, true>(acc, p, p.b1, p.mr1 / 64, g1, b2p, p.rows2);
  }
  __syncthreads();  // T2 in; every thread is done with T1 and the ring
  conv_prologue<E, slots<E>()>(ring, SB, p.w2, Cp, nst, NB);
  // act 2: T2 rows (global t0 - 6 - mid + j) -> T3 rows (global t0 - mid + i)
  act_rows<E>(buf2, buf1, p.Tb + 2 * p.mid, t0 - p.mid, p.T, p.C, p.Ck, p.a2, p.r2, tp);
  if constexpr (F32) {
    conv_f32(ring, ringf, buf1.base, buf1.ld, p.w2, p.b2, p.Tb, 1, t0, p, nullptr, p.x, p.y,
             b);
  } else {
    float acc[MT][NB * 32];
    conv_bf16<NB, MT>(acc, ring, smem_u32(b1p), p.rows1, p.w2, Cp, p.Ck, p.K, 1, p.Tb / 64);
    // v staged in T2's place (free since act 2), then y = x + v
    epilogue_bf16<NB, MT, false>(acc, p, p.b2, p.Tb / 64, t0, b2p, Cp + 8);
    __syncthreads();
    residual_bf16(p, b2p, Cp + 8, t0, b);
  }
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// A branch's geometry at row tile Tb; false where the kernel does not take it
// (the C entry's check of ops/bigvgan_stage.amp_plan)
template <typename E>
bool geometry(Branch<E>& p, int Tb, int& mt) {
  constexpr bool F32 = sizeof(E) == 4;
  p.Tb = Tb;
  p.Ck = F32 ? p.Cp : round_up(p.C, KB);
  p.mid = (p.K - 1) / 2;
  p.R = 12 + p.mid * p.d + p.mid;
  const int n1 = round_up(Tb + 2 * (p.R - 6), S);   // act 1's rows, whole strips
  const int n3 = round_up(Tb + 2 * p.mid, S);       // act 2's rows
  p.mr1 = Tb + 2 * (6 + p.mid);
  if (!F32) p.mr1 = round_up(p.mr1, 64);
  p.done1 = n1;
  p.rows1 = std::max(std::max(n1, n3), p.mr1 + 2 * p.mid * p.d);
  p.done2 = F32 ? Tb + 2 * (6 + p.mid) : p.mr1;
  p.rows2 = std::max(p.done2, n3 + 12);
  const int nb = (p.Cp + 63) / 64;
  const int tiles = std::max(p.mr1, Tb) / 64;
  mt = (tiles + NWG - 1) / NWG;
  const bool regs = F32 || mt == 1 || mt * nb <= 3;
  // bf16: conv 2's output rows, staged in buffer 2 at rows of Cp + 8 values
  const bool stage =
      F32 || (size_t)Tb * (p.Cp + 8) * 2 <= (size_t)p.rows2 * row_bytes<E>(p.Cp, p.Ck);
  return Tb >= 64 && Tb <= MAX_TB && Tb % 64 == 0 && regs && stage &&
         smem_bytes<E>(p.Cp, p.Ck, p.rows1, p.rows2) <= (size_t)MAX_SMEM;
}

template <typename E, int NB, int MT>
cudaError_t launch_branch(const Branch<E>& p, const Taps& tp, int B, cudaStream_t s) {
  static int smem_set[MAX_DEVICES];
  const auto kernel = amp_branch_kernel<E, NB, MT>;
  const size_t smem = smem_bytes<E>(p.Cp, p.Ck, p.rows1, p.rows2);
  cudaError_t err =
      raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.T + p.Tb - 1) / p.Tb, B), NT, smem, s>>>(p, tp);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const Branch<E>& p, const Taps& tp, int mt, int B, cudaStream_t s) {
  if constexpr (sizeof(E) == 4) {
    return launch_branch<E, 1, 1>(p, tp, B, s);
  } else {
    const int nb = (p.Cp + 63) / 64;
    if (nb == 1 && mt == 1) return launch_branch<E, 1, 1>(p, tp, B, s);
    if (nb == 1 && mt == 2) return launch_branch<E, 1, 2>(p, tp, B, s);
    if (nb == 1 && mt == 3) return launch_branch<E, 1, 3>(p, tp, B, s);
    if (nb == 2 && mt == 1) return launch_branch<E, 2, 1>(p, tp, B, s);
    if (nb == 3 && mt == 1) return launch_branch<E, 3, 1>(p, tp, B, s);
    if (nb == 4 && mt == 1) return launch_branch<E, 4, 1>(p, tp, B, s);
    return cudaErrorInvalidValue;
  }
}

template <typename E>
int run_block(const void* x, void* out, void* tmp, const void* w1, const void* b1,
              const void* w2, const void* b2, const void* a1, const void* r1, const void* a2,
              const void* r2, const float* taps, const int* dils, int J, int B, int T, int C,
              int K, int Tb, cudaStream_t s) {
  constexpr bool F32 = sizeof(E) == 4;
  const int Cp = round_up(C, 16);
  if (J < 1 || J > 8 || B < 1 || T < 1 || C < 8 || C % 8 || C > (F32 ? 128 : 256) ||
      K < 1 || K % 2 == 0 || K > 11)
    return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int i = 0; i < 24; ++i) tp.v[i] = taps[i];
  Branch<E> ps[8];
  int mts[8];
  const E* src = (const E*)x;
  for (int j = 0; j < J; ++j) {
    Branch<E>& p = ps[j];
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
    p.T = T, p.C = C, p.Cp = Cp, p.K = K, p.d = dils[j];
    if (p.d < 1 || !geometry(p, Tb, mts[j])) return (int)cudaErrorInvalidValue;
    src = p.y;
  }
  for (int j = 0; j < J; ++j) {
    const cudaError_t err = dispatch(ps[j], tp, mts[j], B, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
}  // namespace tts

// x, out, tmp (B, T, C) bf16; w1, w2 (J, K, Cp, Cp) bf16 with Cp = C rounded
// up to 16 (zero-padded); b1, b2, a1, r1, a2, r2 (J, C) bf16; taps: 24 host
// floats; dils: J host ints. C a multiple of 8 and at most 256, K odd and at
// most 11, J at most 8. tb: the row tile, from ops/bigvgan_stage.amp_plan (a
// multiple of 64 that every branch's buffers fit; any other is refused).
// Branch j reads x (j = 0) or branch j-1's output and writes out or tmp so
// that the last branch writes out.
extern "C" int amp_block_fused(const void* x, void* out, void* tmp, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* a1, const void* r1, const void* a2,
                               const void* r2, const float* taps, const int* dils,
                               int J, int B, int T, int C, int K, int tb, void* stream) {
  return tts::run_block<tts::bf16>(x, out, tmp, w1, b1, w2, b2, a1, r1, a2, r2, taps, dils,
                                   J, B, T, C, K, tb, (cudaStream_t)stream);
}

// The same in fp32: every tensor fp32, C a multiple of 8 and at most 128.
extern "C" int amp_block_fused_f32(const void* x, void* out, void* tmp, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   const void* a1, const void* r1, const void* a2,
                                   const void* r2, const float* taps, const int* dils,
                                   int J, int B, int T, int C, int K, int tb, void* stream) {
  return tts::run_block<float>(x, out, tmp, w1, b1, w2, b2, a1, r1, a2, r2, taps, dils, J,
                               B, T, C, K, tb, (cudaStream_t)stream);
}
