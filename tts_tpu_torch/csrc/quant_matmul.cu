// W8A8 matmuls of the F5 DiT attention, and the bare int8 matmul, on the
// int8 core of q8_core.cuh (q8_rows, then a GEMM).
//
// Replaces tts_tpu/ops/quant_matmul.py:
//   quantized_matmul      (Pallas body _kernel):          bf16(q(x) @ Wq * xs * ws)
//   ln_qkv_q8             (Pallas body _ln_qkv_kernel):   LN + modulate in fp32,
//                         row int8, s8 GEMM, T(acc * xs * ws + b)
//   out_proj_residual_q8  (Pallas body _out_proj_kernel): row int8 of the
//                         attention output, s8 GEMM, y = acc * xs * ws + b,
//                         x + T(gate) * T(y) in T
// with the TPU kernels' rounding points (see q8_core.cuh). T, the
// activation type, is bf16 or fp32 (f32 = 1), as the TPU kernels take
// either; quantized_matmul takes bf16.
//
// What bounds them on an H100, at the F5 bench shape (M = 2816 rows):
// ln_qkv_q8 does 2 * 2816 * 1024 * 3072 = 17.7 G int8 ops against 26.2 MB
// moved, so the tensor cores bound it (8.9 us at 1,979 TOPS);
// out_proj_residual_q8 does 5.9 G ops against 18.4 MB, so memory bounds it
// (5.5 us at 3.35 TB/s). Each TPU kernel was one program that held the
// weight in VMEM; here each is two launches, the row quantization and the
// GEMM, with the int8 rows (2.9 MB) between them in device memory.
// ln_qkv_q8's and out_proj_residual_q8's GEMM is the s8 wgmma GEMM of
// q8_wgmma.cuh (on the weight stored K-major, with the bias or the gated
// residual epilogue); quantized_matmul, which no pipeline calls, still runs
// q8_gemm, WMMA (mma.sync) from a two-stage cp.async ring.
#include "q8_wgmma.cuh"

namespace tts {
namespace q8 {
namespace {

// Kernel 9's GEMM, q8_gemm: one block a 64 x 128 tile of bf16((acc * xs) *
// ws), int8 tiles of q(A) and Wq (K, N), row-major (in, out), 64 deep,
// brought in by cp.async into two stages of shared memory, WMMA 16x16x16 s8
// fragments with s32 accumulators, 2 x 2 warps of 32 x 64; acc -> fp32
// rounds to nearest, as the TPU's astype.
//
// Shared-memory layout: an int8 WMMA fragment is 16 bytes deep, so in a
// row-major tile every other k-step would start 16 bytes off the 32-byte
// alignment WMMA asks for. A and W tiles are therefore stored as 16 x 16
// byte sub-tiles, each contiguous (ldm 16): every fragment pointer is
// 256-byte aligned and a fragment load reads 256 contiguous bytes.

constexpr int BM = 64, BN = 128, BK = 64;  // GEMM block tile; BK bytes of depth a stage

using FragA8 = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using FragB8 = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>;
using FragI = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

struct GemmArgs {
  const int8_t* q;     // (M, K) int8 rows of A
  const float* xs;     // (M,) their scales
  const int8_t* wq;    // (K, N) int8
  const float* ws;     // (N,) fp32 per-column weight scale
  bf16* out;           // (M, N) bf16(acc * xs * ws)
  int M, K, N;
};

// 4 fp32 values rounded to bf16, stored as 8 bytes
__device__ __forceinline__ void store4(bf16* dst, const float (&v)[4]) {
  union {
    uint2 u;
    bf16 h[4];
  } o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.h[j] = to_bf(v[j]);
  *reinterpret_cast<uint2*>(dst) = o.u;
}

// byte offset of element (r, c) of a row-major tile stored as 16 x 16
// sub-tiles, `across` sub-tiles a row
__device__ __forceinline__ int tiled(int r, int c, int across) {
  return ((r >> 4) * across + (c >> 4)) * 256 + (r & 15) * 16 + (c & 15);
}

// stage layout: A tile (BM x BK) then W tile (BK x BN), both sub-tiled
constexpr int A_BYTES = BM * BK, B_BYTES = BK * BN, STAGE = A_BYTES + B_BYTES;

// queue the copies of depth k0's A and W tiles into stage `st`
__device__ __forceinline__ void load_stage(unsigned char* st, const GemmArgs& p, int m0,
                                           int n0, int k0) {
  for (int i = threadIdx.x; i < BM * (BK / 16); i += NT) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const int row = min(m0 + r, p.M - 1);  // the ragged edge reads a valid row, never stored
    cp_async16(smem_u32(st + tiled(r, c, BK / 16)), p.q + (size_t)row * p.K + k0 + c);
  }
  for (int i = threadIdx.x; i < BK * (BN / 16); i += NT) {
    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    cp_async16(smem_u32(st + A_BYTES + tiled(r, c, BN / 16)),
               p.wq + (size_t)(k0 + r) * p.N + n0 + c);
  }
  cp_commit();
}

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
      cp_wait<1>();
    } else {
      cp_wait_all();
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
  float ws[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ws[j] = p.ws[col + j];
  for (int r = warp; r < BM; r += NT / 32) {
    const int row = m0 + r;
    if (row >= p.M) break;
    const float xs = p.xs[row];
    const int4 a4 = *reinterpret_cast<const int4*>(cs + r * BN + c);
    const int av[4] = {a4.x, a4.y, a4.z, a4.w};
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(__fmul_rn(__int2float_rn(av[j]), xs), ws[j]);
    store4(p.out + (size_t)row * p.N + col, y);
  }
}

// the (N / BN, ceil(M / BM)) grid of q8_gemm; K % 64 == 0, N % 128 == 0
inline int launch_gemm(const GemmArgs& p, cudaStream_t s) {
  q8_gemm<<<dim3(p.N / BN, (p.M + BM - 1) / BM), NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace q8
}  // namespace tts

using namespace tts::q8;

namespace {

RowArgs row_args(const void* a, void* xq, void* xs, int M, int K) {
  RowArgs r{};
  r.a = a;
  r.q = (int8_t*)xq;
  r.xs = (float*)xs;
  r.M = M, r.K = K, r.T = 1;
  return r;
}

// the s8 wgmma GEMM over rows already quantized, with a bias (N,) fp32
WgArgs wg_args(const void* xq, const void* xs, const void* wt, const void* ws, const void* b,
               void* out, int M, int K, int N) {
  WgArgs g{};
  g.q = (const int8_t*)xq;
  g.xs = (const float*)xs;
  g.wt = (const int8_t*)wt;
  g.ws = (const float*)ws;
  g.bias = (const float*)b;
  g.out = out;
  g.M = M, g.K = K, g.N = N, g.T = 1;
  return g;
}

// the row pass, then the GEMM in the form `stages` names
template <Rows ROWS, WEpi EPI, typename T>
int rows_then_gemm(const RowArgs& r, const WgArgs& g, int stages, cudaStream_t s) {
  const int err = launch_rows<ROWS, T>(r, s);
  return err ? err : launch_wgemm_form<EPI, T>(stages, g, s);
}

}  // namespace

// x (M, K) bf16; wq (K, N) int8; ws (N,) fp32 -> out (M, N) bf16; xq (M, K)
// int8 and xs (M,) fp32 scratch. K % 64 == 0, K <= 2048, N % 128 == 0.
extern "C" int quantized_matmul(const void* x, const void* wq, const void* ws,
                                void* xq, void* xs, void* out, int M, int K, int N,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_rows<ROWS_RAW, tts::bf16>(row_args(x, xq, xs, M, K), s);
  if (err) return err;
  GemmArgs g{};
  g.q = (const int8_t*)xq;
  g.xs = (const float*)xs;
  g.wq = (const int8_t*)wq;
  g.ws = (const float*)ws;
  g.out = (tts::bf16*)out;
  g.M = M, g.K = K, g.N = N;
  return launch_gemm(g, s);
}

// x (M, D) bf16 (f32 = 0) or fp32 (f32 = 1); mods (2, D) fp32 [shift,
// scale]; wt (N, D) int8, the weight K-major; ws, b (N,) fp32 -> out (M, N)
// of x's type; xq, xs scratch as above. D % 64 == 0, D <= 2048, N % 128 ==
// 0; stages the GEMM's ring depth (ops/quant_matmul.q8_plan).
extern "C" int ln_qkv_q8(const void* x, const void* mods, const void* wt,
                         const void* ws, const void* b, void* xq, void* xs, void* out,
                         int M, int D, int N, int f32, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RowArgs r = row_args(x, xq, xs, M, D);
  r.mods = (const float*)mods;
  r.mods_bstride = 0;
  const WgArgs g = wg_args(xq, xs, wt, ws, b, out, M, D, N);
  return f32 ? rows_then_gemm<ROWS_LN, WEPI_BIAS, float>(r, g, stages, s)
             : rows_then_gemm<ROWS_LN, WEPI_BIAS, tts::bf16>(r, g, stages, s);
}

// o (M, HD) attention output, x_res (M, D) and out (M, D), all bf16 (f32 =
// 0) or all fp32 (f32 = 1); wt (D, HD) int8, the weight K-major; ws, b,
// gate (D,) fp32; xq (M, HD), xs scratch. HD % 64 == 0, HD <= 2048, D % 128
// == 0; stages the GEMM's ring depth (ops/quant_matmul.q8_plan).
extern "C" int out_proj_residual_q8(const void* o, const void* wt, const void* ws,
                                    const void* b, const void* gate,
                                    const void* x_res, void* xq, void* xs, void* out,
                                    int M, int HD, int D, int f32, int stages,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowArgs r = row_args(o, xq, xs, M, HD);
  WgArgs g = wg_args(xq, xs, wt, ws, b, out, M, HD, D);
  g.res = x_res;
  g.gate = (const float*)gate;
  g.gate_bstride = 0;
  return f32 ? rows_then_gemm<ROWS_RAW, WEPI_RESIDUAL, float>(r, g, stages, s)
             : rows_then_gemm<ROWS_RAW, WEPI_RESIDUAL, tts::bf16>(r, g, stages, s);
}
