// The W8A8 core shared by the port's int8 kernels (kernels 6-9 of the TPU
// package): per-row symmetric int8 activations, an s8 x s8 -> s32 product
// on the tensor cores, and an fp32 rescale epilogue. Two kernels, each
// templated on the activation type it reads or writes (bf16 or fp32, as
// the TPU kernels take either and write x.dtype):
//
//   q8_rows   quantizes whole rows of A: one warp a row, the row staged in
//             shared memory as fp32 (after the LayerNorm prologue where
//             there is one), its amax, xs = max(amax, 1e-8) * f32(1/127),
//             and q = clip(rint(v / xs), -127, 127) written as int8 (M, K)
//             with xs (M,);
//   q8_gemm   one block a 64 x 128 tile of f((acc * xs) * ws (+ b)): int8
//             tiles of q(A) and Wq (K, N), row-major (in, out), 64 deep,
//             brought in by cp.async into two stages of shared memory, WMMA
//             16x16x16 s8 fragments with s32 accumulators, 2 x 2 warps of
//             32 x 64; acc -> fp32 rounds to nearest, as the TPU's astype.
//             Kernels 8 and 9 run it; kernels 6 and 7 run the s8 wgmma GEMM
//             of q8_wgmma.cuh, with the same rounding.
//
// Why two kernels: the row's amax needs the whole row before any of it can
// be quantized, and the TPU kernel had it because a grid step held whole
// rows in VMEM. A GEMM block holds 64 rows by 128 columns, so quantizing in
// its prologue would repeat the work for every column tile (24 times for
// the qkv projection); measured on the card, that prologue cost more than
// the GEMM. Quantizing once is 1 B a value written and read back, against
// the 2 B (bf16) or 4 B (fp32) the GEMM would otherwise read.
//
// Rounding follows the TPU kernels exactly where the inputs are equal: the
// division is IEEE (__fdiv_rn), rint rounds half to even, and every
// multiply and add of the rescale and of the LayerNorm prologue is an
// explicit _rn intrinsic, so nvcc cannot contract a pair into an FMA (which
// rounds once where the TPU rounds twice).
//
// Shared-memory layout: an int8 WMMA fragment is 16 bytes deep, so in a
// row-major tile every other k-step would start 16 bytes off the 32-byte
// alignment WMMA asks for. A and W tiles are therefore stored as 16 x 16
// byte sub-tiles, each contiguous (ldm 16): every fragment pointer is
// 256-byte aligned and a fragment load reads 256 contiguous bytes.
#pragma once

#include "common.cuh"

namespace tts {
namespace q8 {

constexpr int BM = 64, BN = 128, BK = 64;  // GEMM block tile; BK bytes of depth a stage
constexpr int NT = 128;                    // 4 warps
constexpr float INV_127 = 0x1.020408p-7f;  // float32(1 / 127)

using FragA8 = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using FragB8 = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>;
using FragI = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// what q8_rows quantizes, of rows of type T (bf16 or float)
enum Rows {
  ROWS_RAW,   // the rows as they are (kernels 8, 9)
  ROWS_LN,    // LayerNorm (fp32, eps 1e-6, no affine) * (1 + scale) + shift,
              // in fp32 (kernels 6 ff1, 7)
};
// what q8_gemm writes, from y = (acc * xs) * ws (+ b), in type T: with T
// bf16 each value below is rounded where the TPU kernel casts to bf16; with
// T float those casts are no-ops and nothing is rounded past fp32
enum Epi {
  EPI_SCALE,     // T(y), no bias (kernel 9)
  EPI_RESIDUAL,  // T(x + T(T(gate) * T(y + b))) (kernel 8)
};

struct RowArgs {
  const void* a;      // (M, K) of the row type
  const float* mods;  // ROWS_LN: [shift (K), scale (K), ...] fp32 for batch
  int mods_bstride;   //   row `row / T`, this far apart (0 = shared)
  int8_t* q;          // (M, K) int8 out
  float* xs;          // (M,) fp32 out
  int M, K, T;
};

struct GemmArgs {
  const int8_t* q;     // (M, K) int8 rows of A
  const float* xs;     // (M,) their scales
  const int8_t* wq;    // (K, N) int8
  const float* ws;     // (N,) fp32 per-column weight scale
  const float* bias;   // (N,) fp32, unused by EPI_SCALE
  const void* res;     // EPI_RESIDUAL: (M, N) residual input, of the output type
  const float* gate;   // EPI_RESIDUAL: (N,) fp32 for batch row `row / T`,
  int gate_bstride;    //   this far apart (0 = shared)
  void* out;           // (M, N) of the output type
  int M, K, N, T;
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

// 4 consecutive values of a row of T, as fp32, and back
__device__ __forceinline__ void load4(const bf16* src, float (&v)[4]) {
  union {
    uint2 u;
    bf16 h[4];
  } x;
  x.u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_f(x.h[j]);
}

__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void store4(bf16* dst, const float (&v)[4]) {
  union {
    uint2 u;
    bf16 h[4];
  } o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.h[j] = to_bf(v[j]);
  *reinterpret_cast<uint2*>(dst) = o.u;
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
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

// byte offset of element (r, c) of a row-major tile stored as 16 x 16
// sub-tiles, `across` sub-tiles a row
__device__ __forceinline__ int tiled(int r, int c, int across) {
  return ((r >> 4) * across + (c >> 4)) * 256 + (r & 15) * 16 + (c & 15);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// stage layout: A tile (BM x BK) then W tile (BK x BN), both sub-tiled
constexpr int A_BYTES = BM * BK, B_BYTES = BK * BN, STAGE = A_BYTES + B_BYTES;

// queue the copies of depth k0's A and W tiles into stage `st`
__device__ __forceinline__ void load_stage(unsigned char* st, const GemmArgs& p, int m0,
                                           int n0, int k0) {
  for (int i = threadIdx.x; i < BM * (BK / 16); i += NT) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const int row = min(m0 + r, p.M - 1);  // the ragged edge reads a valid row, never stored
    cp_async16(st + tiled(r, c, BK / 16), p.q + (size_t)row * p.K + k0 + c);
  }
  for (int i = threadIdx.x; i < BK * (BN / 16); i += NT) {
    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    cp_async16(st + A_BYTES + tiled(r, c, BN / 16), p.wq + (size_t)(k0 + r) * p.N + n0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <Epi EPI, typename T>
__global__ void __launch_bounds__(NT) q8_gemm(const GemmArgs p) {
  // two stages of 12 KB during the main loop; the epilogue's 32 KB int32
  // tile reuses them
  __shared__ __align__(256) unsigned char smem[BM * BN * 4];
  static_assert(2 * STAGE <= BM * BN * 4, "stages must fit the epilogue tile");
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;

  FragI acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int steps = p.K / BK;
  load_stage(smem, p, m0, n0, 0);
  for (int s = 0; s < steps; ++s) {
    const signed char* st = reinterpret_cast<const signed char*>(smem + (s & 1) * STAGE);
    if (s + 1 < steps) {
      load_stage(smem + ((s + 1) & 1) * STAGE, p, m0, n0, (s + 1) * BK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA8 a[2];
      FragB8 b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], st + ((wm * 2 + i) * (BK / 16) + kk) * 256, 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], st + A_BYTES + (kk * (BN / 16) + wn * 4 + j) * 256, 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * BN + wn * 64 + j * 16,
                              acc[i][j], BN, wmma::mem_row_major);
  __syncthreads();

  // one warp a row; lane l takes columns 4l..4l+3 of the tile
  const int c = lane * 4, col = n0 + c;
  float ws[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ws[j] = p.ws[col + j];
    b[j] = EPI == EPI_SCALE ? 0.f : p.bias[col + j];
  }
  for (int r = warp; r < BM; r += NT / 32) {
    const int row = m0 + r;
    if (row >= p.M) break;
    const float xs = p.xs[row];
    const int4 a4 = *reinterpret_cast<const int4*>(cs + r * BN + c);
    const int av[4] = {a4.x, a4.y, a4.z, a4.w};
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = __fmul_rn(__fmul_rn(__int2float_rn(av[j]), xs), ws[j]);
      if (EPI != EPI_SCALE) y[j] = __fadd_rn(y[j], b[j]);
    }
    const size_t o = (size_t)row * p.N + col;
    T* out = static_cast<T*>(p.out) + o;
    if (EPI == EPI_RESIDUAL) {
      float x[4];
      load4(static_cast<const T*>(p.res) + o, x);
      const float* g = p.gate + (size_t)(row / p.T) * p.gate_bstride + col;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = __fadd_rn(x[j], as_t(__fmul_rn(as_t(g[j], out), as_t(y[j], out)), out));
    }
    store4(out, y);
  }
}

// quantize the M rows of p.a; K % 8 == 0 and K <= 2048 (the row buffers
// stay under the 48 KB of shared memory a launch has without opting in)
template <Rows ROWS, typename T>
int launch_rows(const RowArgs& p, cudaStream_t s) {
  const int bytes = (NT / 32) * k256(p.K) * (int)sizeof(float);
  q8_rows<ROWS, T><<<(p.M + NT / 32 - 1) / (NT / 32), NT, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// the (N / BN, ceil(M / BM)) grid of q8_gemm; K % 64 == 0, N % 128 == 0
template <Epi EPI, typename T>
int launch_gemm(const GemmArgs& p, cudaStream_t s) {
  q8_gemm<EPI, T><<<dim3(p.N / BN, (p.M + BM - 1) / BM), NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace q8
}  // namespace tts
