// The s8 wgmma GEMM of the port's W8A8 kernels 6, 7 and 8 (sm_90a), over the
// int8 rows that q8_rows makes (q8_core.cuh):
//
//   y = (acc * xs) * ws + b,   acc = q(A) Wq summed exactly in s32,
//
// with one of four epilogues, run from the accumulator registers:
//   WEPI_SCALE     T((acc * xs) * ws), no bias (kernel 9, the bare int8
//                  matmul: adding a zero bias would turn -0 into +0);
//   WEPI_BIAS      T(y) (kernel 7, the qkv projection);
//   WEPI_RESIDUAL  T(x + T(T(gate) * T(y))) with the gate of batch row
//                  row / T (kernel 6's ff2; kernel 8, the attention's
//                  out-projection, with one gate for every row);
//   WEPI_HIDDEN    the int8 rows of h = gelu(y) and their scales (kernel 6's
//                  ff1, q8_wgmma_hidden_kernel): one thread-block cluster
//                  spans a whole hidden row; each CTA puts its rows' partial
//                  amax in shared memory, every CTA reads the cluster's
//                  partials through distributed shared memory, takes their
//                  max (exact in any order) and quantizes its own tile with
//                  the row's scale. The fp32 hidden never reaches device
//                  memory, and its quantization is what the TPU kernel did
//                  with whole rows in VMEM.
//                  Kernel 17's ablations swap its activation (the Gelu
//                  hook of q8_core.cuh) or its quantizer (QUANT_FIXED: one
//                  scale, no amax and no exchange across the cluster);
//                  the defaults are kernel 6's code.
// The rounding is q8_rows' and the TPU kernels': __int2float_rn(acc), then
// _rn multiplies and adds, gelu_q8, xs = max(amax, 1e-8) * f32(1/127) and
// quant(). The s8 x s8 sums are exact in s32 at K <= 2048, so these kernels
// give the bits of the WMMA GEMM that kernels 6-9 ran before them.
//
// The GEMM has the shape of kernel 3's bf16 one (dit_gemm_kernel in
// dit_mlp.cu), in bytes: a CTA is 128 rows in two warpgroups of 64 by 128
// columns; every k32 step a warpgroup issues one wgmma m64n128k32
// s32.s8.s8 with A and B read from shared memory by descriptor and s32
// accumulators in registers. 8-bit wgmma takes K-major operands only (the
// transpose bits are for 16-bit types), so B is the weight stored K-major,
// (N, K), as runtime/f5.quantize_dit lays the weights out once. A K step
// is 128 int8 values, one 128-byte row of the sw128 layout: a k32
// slice of int8 is 32 bytes, as a k16 slice of bf16 is, so kernel 3's
// swizzle and descriptors carry over byte for byte (gdesc(base + 32 kk,
// 16, 1024), 4 products a step). A K that is an odd number of 64s ends in a
// half step whose other half is copied in as zeros. K steps run through a
// ring of STAGES slots filled by cp.async: the copies of step
// k + STAGES - 2 are queued right after the one barrier of step k, and
// wgmma.wait_group 1 keeps one step's products in flight. Rows past M load
// the last row again and store nothing. No atomics: the output is the same
// bits from run to run.
//
// Every GEMM's form (ring depth, CTAs an SM, cluster size) is chosen on the
// host by ops/quant_matmul.q8_plan; the launchers (launch_wgemm_form and
// launch_hidden below) refuse others.
#pragma once

#include <cooperative_groups.h>

#include "q8_core.cuh"
#include "wgmma.cuh"

namespace tts {
namespace q8 {

namespace cg = cooperative_groups;

constexpr int WM = 128, WN = 128;        // CTA rows (2 warpgroups of 64) and columns
constexpr int WK = 128;                  // K step (bytes = int8 values)
constexpr int WNT = 256;                 // 2 warpgroups
constexpr uint32_t WA_BYTES = WM * WK;   // one A slot, 16 KB
constexpr uint32_t WSTAGE = 2 * WA_BYTES; // a ring slot: A and B (WN x WK), 32 KB
constexpr int MAX_CLUSTER = 16;          // the H100's non-portable cluster limit

enum WEpi { WEPI_SCALE, WEPI_BIAS, WEPI_RESIDUAL, WEPI_HIDDEN };

struct WgArgs {
  const int8_t* q;     // (M, K) int8 rows of A
  const float* xs;     // (M,) their scales
  const int8_t* wt;    // (N, K) int8: the weight, K-major
  const float* ws;     // (N,) fp32 per-column weight scale
  const float* bias;   // (N,) fp32 (not read by WEPI_SCALE)
  const void* res;     // WEPI_RESIDUAL: (M, N) residual input, of the output type
  const float* gate;   // WEPI_RESIDUAL: (N,) fp32 for batch row `row / T`,
  int gate_bstride;    //   this far apart (0 = shared)
  void* out;           // (M, N) of the output type; int8 for WEPI_HIDDEN
  float* out_xs;       // WEPI_HIDDEN: (M,) the scales of the int8 rows
  int M, K, N, T;
};

// d (+)= A B over k32: A (64 x 32) and B (32 x 128) int8, both K-major in
// shared memory by descriptor; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keep the compiler from moving other reads or writes of an accumulator
// across the asynchronous product
template <int N>
__device__ __forceinline__ void hold(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// two consecutive values of a row of T, as fp32, and back
__device__ __forceinline__ void load2(const bf16* src, float (&v)[2]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  v[0] = f.x, v[1] = f.y;
}

__device__ __forceinline__ void load2(const float* src, float (&v)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(src);
  v[0] = f.x, v[1] = f.y;
}

__device__ __forceinline__ void store2(bf16* dst, const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v[0], v[1]);
}

__device__ __forceinline__ void store2(float* dst, const float (&v)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

template <int STAGES>
constexpr size_t wgemm_smem() {
  return 1024 + (size_t)STAGES * WSTAGE;  // align slack, the ring
}

// queue the copies of the K step at k0: A rows m0 .. m0 + 127 (past M: the
// last row again) into sa, B rows n0 .. n0 + 127 into sb, both K-major in
// the sw128 layout, 8 chunks of 16 bytes a row; a last half step (64 values)
// fills chunks 4-7 with zeros, which add nothing to the sums. Thread t
// copies chunk t % 8 of rows t / 8 + 32 i, which share one swizzle phase,
// with 32-bit offsets (M K, N K < 2^32: wgemm_shape_ok).
__device__ __forceinline__ void wload_stage(uint32_t sa, uint32_t sb, const WgArgs& g, int m0,
                                            int n0, int k0) {
  const int ch = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const bool valid = ch * 16 < g.K - k0;
  const uint32_t kc = valid ? k0 + ch * 16 : 0;  // past a half step: the row's start
  const uint32_t sw = r0 * 128 + ((ch ^ (r0 & 7)) << 4);  // sw128(r0 + 32 i, ch) - 4096 i
#pragma unroll
  for (int i = 0; i < WM / 32; ++i) {
    const uint32_t row = min(m0 + r0 + 32 * i, g.M - 1);
    cp_async16_or_zero(sa + sw + 4096 * i, g.q + (row * g.K + kc), valid);
  }
#pragma unroll
  for (int i = 0; i < WN / 32; ++i)
    cp_async16_or_zero(sb + sw + 4096 * i, g.wt + ((uint32_t)(n0 + r0 + 32 * i) * g.K + kc),
                       valid);
}

// acc = the warpgroup's 64 x 128 tile of q(A) Wq for the CTA at rows m0,
// columns n0, through the ring at `base` (1024-byte aligned). The first
// product overwrites acc (scale_d 0), so no other instruction writes the
// accumulators while a product is in flight.
template <int STAGES>
__device__ __forceinline__ void wgemm_mainloop(int (&acc)[WN / 2], const WgArgs& g,
                                               uint32_t base, int m0, int n0, int wg) {
  static_assert(STAGES >= 3, "ring depth");
  const int KT = (g.K + WK - 1) / WK;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT)
      wload_stage(base + s * WSTAGE, base + s * WSTAGE + WA_BYTES, g, m0, n0, s * WK);
    cp_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 3>();  // this thread's copies of step kt have landed
    fence_async_smem();     // ... visible to the tensor cores' reads
    __syncthreads();        // step kt in for all; every product of step kt - 2 is done
    const int nk = kt + STAGES - 2;
    if (nk < KT) {
      const uint32_t st = base + (nk % STAGES) * WSTAGE;
      wload_stage(st, st + WA_BYTES, g, m0, n0, nk * WK);
    }
    cp_commit();  // (empty past the last step: the group count stays uniform)

    // the k32 slice kk starts 32 kk bytes into the rows: 2 kk in the
    // descriptors' address field (bytes / 16)
    const uint32_t st = base + (kt % STAGES) * WSTAGE;
    const uint64_t da = gdesc(st + wg * (WA_BYTES / 2), 16, 1024);
    const uint64_t db = gdesc(st + WA_BYTES, 16, 1024);
    hold(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 32; ++kk)
      wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();
    hold(acc);
  }
  wg_wait0();
  hold(acc);
}

// One CTA: the (128, 128) tile of the output at rows blockIdx.y * 128,
// columns blockIdx.x * 128, with epilogue WEPI_SCALE, WEPI_BIAS or
// WEPI_RESIDUAL in T; CTAS of them share an SM. Launch with WNT threads and
// wgemm_smem<STAGES>() of dynamic shared memory.
template <int STAGES, int CTAS, WEpi EPI, typename T>
__global__ void __launch_bounds__(WNT, CTAS) q8_wgmma_kernel(const WgArgs g) {
  static_assert(EPI != WEPI_HIDDEN, "epilogue");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * WM;
  int acc[WN / 2];
  wgemm_mainloop<STAGES>(acc, g, base, m0, n0, wg);

  // acc[4 j + 2 r + e]: row rb + 8 r, column cb + 8 j + e
  const int rb = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int cb = n0 + 2 * (lane & 3);
  float xs[2];
  const float* gate[2] = {g.gate, g.gate};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(rb + 8 * r, g.M - 1);
    xs[r] = g.xs[row];
    if constexpr (EPI == WEPI_RESIDUAL) gate[r] += (size_t)(row / g.T) * g.gate_bstride;
  }
  T* out = static_cast<T*>(g.out);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cb + 8 * j;
    const float2 ws = *reinterpret_cast<const float2*>(g.ws + col);
    const float2 b = EPI == WEPI_SCALE ? make_float2(0.f, 0.f)
                                       : *reinterpret_cast<const float2*>(g.bias + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rb + 8 * r;
      if (row >= g.M) continue;
      float y[2] = {__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * r]), xs[r]), ws.x),
                    __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * r + 1]), xs[r]), ws.y)};
      if constexpr (EPI != WEPI_SCALE) {
        y[0] = __fadd_rn(y[0], b.x);
        y[1] = __fadd_rn(y[1], b.y);
      }
      const size_t o = (size_t)row * g.N + col;
      if constexpr (EPI == WEPI_RESIDUAL) {
        float x[2];
        load2(static_cast<const T*>(g.res) + o, x);
        const float2 gt = *reinterpret_cast<const float2*>(gate[r] + col);
        y[0] = __fadd_rn(x[0], as_t(__fmul_rn(as_t(gt.x, out), as_t(y[0], out)), out));
        y[1] = __fadd_rn(x[1], as_t(__fmul_rn(as_t(gt.y, out), as_t(y[1], out)), out));
      }
      store2(out + o, y);
    }
  }
}

// WEPI_HIDDEN (kernel 6's ff1): a cluster of N / 128 CTAs along x covers the
// whole hidden row; each CTA writes its (128, 128) tile of int8 h and rank 0
// the rows' scales; CTAS of them share an SM. Launch as q8_wgmma_kernel, in
// clusters of gridDim.x (launch_hidden).
template <int STAGES, int CTAS, Gelu G = GELU_TANH, Quant QUANT = QUANT_ROW>
__global__ void __launch_bounds__(WNT, CTAS) q8_wgmma_hidden_kernel(const WgArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float part[WM];  // this CTA's amax of each of its rows over its 128 columns
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * WM;
  int acc[WN / 2];
  wgemm_mainloop<STAGES>(acc, g, base, m0, n0, wg);

  // h = gelu((acc * xs) * ws + b) in fp32, kept in the accumulator registers
  const int lr = wg * 64 + warp * 16 + (lane >> 2);  // the CTA's row of r = 0
  const int rb = m0 + lr, cb = n0 + 2 * (lane & 3);
  float xs[2], amax[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) xs[r] = g.xs[min(rb + 8 * r, g.M - 1)];
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = cb + 8 * j;
    const float2 ws = *reinterpret_cast<const float2*>(g.ws + col);
    const float2 b = *reinterpret_cast<const float2*>(g.bias + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (G == GELU_TANH_BF16) {
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          h[e] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * r + e]), xs[r]),
                                     e ? ws.y : ws.x),
                           e ? b.y : b.x);
        gelu_bf16x2(h);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[4 * j + 2 * r + e] = __float_as_int(h[e]);
          amax[r] = fmaxf(amax[r], fabsf(h[e]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int& a = acc[4 * j + 2 * r + e];
          const float h = act<G>(__fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(a), xs[r]), e ? ws.y : ws.x), e ? b.y : b.x));
          a = __float_as_int(h);
          amax[r] = fmaxf(amax[r], fabsf(h));
        }
      }
    }
  }
  float hs[2] = {FIXED_XS, FIXED_XS};
  if constexpr (QUANT == QUANT_ROW) {
    // a row lives in the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 1));
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 2));
      if ((lane & 3) == 0) part[lr + 8 * r] = amax[r];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's partials are in
    const int ranks = (int)cluster.num_blocks();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = 0.f;
      for (int c = 0; c < ranks; ++c)
        m = fmaxf(m, *cluster.map_shared_rank(part + lr + 8 * r, c));
      hs[r] = __fmul_rn(fmaxf(m, 1e-8f), INV_127);
    }
  }
  int8_t* hq = static_cast<int8_t*>(g.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rb + 8 * r;
    if (row >= g.M) continue;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      union {
        uint16_t u;
        signed char b[2];
      } o;
      const float h0 = __int_as_float(acc[4 * j + 2 * r]);
      const float h1 = __int_as_float(acc[4 * j + 2 * r + 1]);
      o.b[0] = QUANT == QUANT_FIXED ? quant_fixed(h0) : quant(h0, hs[r]);
      o.b[1] = QUANT == QUANT_FIXED ? quant_fixed(h1) : quant(h1, hs[r]);
      *reinterpret_cast<uint16_t*>(hq + (size_t)row * g.N + cb + 8 * j) = o.u;
    }
    if (blockIdx.x == 0 && (lane & 3) == 0) g.out_xs[row] = hs[r];
  }
  // no CTA's partials go before every CTA has read them
  if constexpr (QUANT == QUANT_ROW) cg::this_cluster().sync();
}

// ---------------------------------------------------------------- host side

// The shapes every form takes: K % 64 == 0 up to 2048, N % 128 == 0, M >= 1,
// and operands of fewer than 2^32 values (wload_stage's 32-bit offsets)
inline bool wgemm_shape_ok(const WgArgs& g) {
  return g.K % 64 == 0 && g.K <= 2048 && g.N % WN == 0 && g.N > 0 && g.M >= 1 &&
         (uint64_t)g.M * g.K < (1ull << 32) && (uint64_t)g.N * g.K < (1ull << 32);
}

template <int STAGES, int CTAS, WEpi EPI, typename T>
int launch_wgemm(const WgArgs& g, cudaStream_t s) {
  static int smem_set[MAX_DEVICES];
  constexpr size_t smem = wgemm_smem<STAGES>();
  const auto kernel = q8_wgmma_kernel<STAGES, CTAS, EPI, T>;
  const cudaError_t err =
      raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(g.N / WN, (g.M + WM - 1) / WM), WNT, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// The WEPI_HIDDEN GEMM in its one form (ops/quant_matmul.q8_plan with
// whole rows): one cluster of N / 128 <= 16 CTAs across the row (past 8
// with the non-portable size allowed), 3 stages, 2 CTAs an SM.
template <Gelu G = GELU_TANH, Quant QUANT = QUANT_ROW>
int launch_hidden(int stages, const WgArgs& g, cudaStream_t s) {
  static int smem_set[MAX_DEVICES], wide_set[MAX_DEVICES];
  const int cluster = g.N / WN;
  if (!wgemm_shape_ok(g) || stages != 3 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wgemm_smem<3>();
  const auto kernel = q8_wgmma_hidden_kernel<3, 2, G, QUANT>;
  cudaError_t err =
      raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err == cudaSuccess && cluster > 8)  // past the portable cluster size
    err = raise_attr(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1, wide_set);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(kernel, dim3(cluster, (g.M + WM - 1) / WM), WNT, smem, s, cluster,
                             g);
}

// The GEMM with epilogue WEPI_SCALE, WEPI_BIAS or WEPI_RESIDUAL in one of two forms
// (ring depth, CTAs an SM), as ops/quant_matmul.q8_plan picks it from the
// grid and the SM count: 4 stages, 1 CTA an SM, for a grid of at most one
// CTA an SM; else 3 stages, 2 CTAs an SM (97 KB of shared memory each).
// Shapes as wgemm_shape_ok admits.
template <WEpi EPI, typename T>
int launch_wgemm_form(int stages, const WgArgs& g, cudaStream_t s) {
  if (!wgemm_shape_ok(g)) return (int)cudaErrorInvalidValue;
  if (stages == 4) return launch_wgemm<4, 1, EPI, T>(g, s);
  if (stages == 3) return launch_wgemm<3, 2, EPI, T>(g, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 6's block (dit_mlp_q8.cu) as its three launches: the row pass,
// ff1 (launch_hidden), ff2 with the gated residual. Kernel 17's ablations
// (dit_mlp_q8_variants.cu) pick the row pass's ROWS, the quantizer QUANT of
// both quantizations and ff1's activation G; the defaults are kernel 6.
struct MlpArgs {
  const void* x;       // (M, D) of the activation type, and the output's
  const float* mods;   // [shift, scale, gate] (D each) for batch row `row / T`,
  int mods_bstride;    //   this far apart (0 = shared)
  const void* w1t;     // (F, D) int8, K-major
  const float* s1;     // (F,)
  const float* b1;     // (F,)
  const void* w2t;     // (D, F) int8, K-major
  const float* s2;     // (D,)
  const float* b2;     // (D,)
  void* xq;            // scratch: (M, D) int8 and (M,) fp32
  float* xs;
  void* hq;            // scratch: (M, F) int8 and (M,) fp32
  float* hs;
  void* out;           // (M, D)
  int M, T, D, F;
  int st1, st2;        // ff1's and ff2's ring depths (ops/quant_matmul.q8_plan)
};

// The C entries' arguments as MlpArgs; mods (mods_rows, 3, D), mods_rows 1
// (shared) or B
inline MlpArgs mlp_args(const void* x, const void* mods, int mods_rows, const void* w1t,
                        const void* s1, const void* b1, const void* w2t, const void* s2,
                        const void* b2, void* xq, void* xs, void* hq, void* hs, void* out,
                        int M, int T, int D, int F, int st1, int st2) {
  return MlpArgs{x, (const float*)mods, mods_rows == 1 ? 0 : 3 * D, w1t, (const float*)s1,
                 (const float*)b1, w2t, (const float*)s2, (const float*)b2, xq, (float*)xs,
                 hq, (float*)hs, out, M, T, D, F, st1, st2};
}

template <typename Act, Rows ROWS = ROWS_LN, Quant QUANT = QUANT_ROW, Gelu G = GELU_TANH>
int mlp_block(const MlpArgs& p, cudaStream_t s) {
  RowArgs r{};
  r.a = p.x;
  r.mods = p.mods;
  r.mods_bstride = p.mods_bstride;
  r.q = (int8_t*)p.xq;
  r.xs = p.xs;
  r.M = p.M, r.K = p.D, r.T = p.T;
  int err = launch_rows<ROWS, Act, QUANT>(r, s);
  if (err) return err;

  WgArgs g{};
  g.q = (const int8_t*)p.xq;
  g.xs = p.xs;
  g.wt = (const int8_t*)p.w1t;
  g.ws = p.s1;
  g.bias = p.b1;
  g.out = p.hq;
  g.out_xs = p.hs;
  g.M = p.M, g.K = p.D, g.N = p.F, g.T = p.T;
  if ((err = launch_hidden<G, QUANT>(p.st1, g, s))) return err;

  g.q = (const int8_t*)p.hq;
  g.xs = p.hs;
  g.wt = (const int8_t*)p.w2t;
  g.ws = p.s2;
  g.bias = p.b2;
  g.res = p.x;
  g.gate = p.mods + 2 * p.D;
  g.gate_bstride = p.mods_bstride;
  g.out = p.out;
  g.out_xs = nullptr;
  g.K = p.F, g.N = p.D;
  return launch_wgemm_form<WEPI_RESIDUAL, Act>(p.st2, g, s);
}

}  // namespace q8
}  // namespace tts
