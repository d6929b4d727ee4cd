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
// ln_qkv_q8's GEMM is the s8 wgmma GEMM of q8_wgmma.cuh (on the weight
// stored K-major); the other two still run q8_gemm, WMMA (mma.sync) from a
// two-stage cp.async ring, well below either bound.
#include "q8_wgmma.cuh"

using namespace tts::q8;

namespace {

// the GEMM half of every entry below, over rows already quantized
GemmArgs gemm_args(const void* xq, const void* xs, const void* wq, const void* ws,
                   void* out, int M, int K, int N) {
  GemmArgs g{};
  g.q = (const int8_t*)xq;
  g.xs = (const float*)xs;
  g.wq = (const int8_t*)wq;
  g.ws = (const float*)ws;
  g.out = out;
  g.M = M, g.K = K, g.N = N, g.T = 1;
  return g;
}

RowArgs row_args(const void* a, void* xq, void* xs, int M, int K) {
  RowArgs r{};
  r.a = a;
  r.q = (int8_t*)xq;
  r.xs = (float*)xs;
  r.M = M, r.K = K, r.T = 1;
  return r;
}

template <typename T>
int ln_qkv(const RowArgs& r, const WgArgs& g, int stages, cudaStream_t s) {
  const int err = launch_rows<ROWS_LN, T>(r, s);
  return err ? err : launch_wgemm_form<WEPI_BIAS, T>(stages, g, s);
}

template <typename T>
int out_proj(const RowArgs& r, const GemmArgs& g, cudaStream_t s) {
  const int err = launch_rows<ROWS_RAW, T>(r, s);
  return err ? err : launch_gemm<EPI_RESIDUAL, T>(g, s);
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
  return launch_gemm<EPI_SCALE, tts::bf16>(gemm_args(xq, xs, wq, ws, out, M, K, N), s);
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
  WgArgs g{};
  g.q = (const int8_t*)xq;
  g.xs = (const float*)xs;
  g.wt = (const int8_t*)wt;
  g.ws = (const float*)ws;
  g.bias = (const float*)b;
  g.out = out;
  g.M = M, g.K = D, g.N = N, g.T = 1;
  return f32 ? ln_qkv<float>(r, g, stages, s) : ln_qkv<tts::bf16>(r, g, stages, s);
}

// o (M, HD) attention output, x_res (M, D) and out (M, D), all bf16 (f32 =
// 0) or all fp32 (f32 = 1); wq (HD, D) int8; ws, b, gate (D,) fp32; xq (M,
// HD), xs scratch. HD % 64 == 0, HD <= 2048, D % 128 == 0.
extern "C" int out_proj_residual_q8(const void* o, const void* wq, const void* ws,
                                    const void* b, const void* gate,
                                    const void* x_res, void* xq, void* xs, void* out,
                                    int M, int HD, int D, int f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowArgs r = row_args(o, xq, xs, M, HD);
  GemmArgs g = gemm_args(xq, xs, wq, ws, out, M, HD, D);
  g.bias = (const float*)b;
  g.res = x_res;
  g.gate = (const float*)gate;
  g.gate_bstride = 0;
  return f32 ? out_proj<float>(r, g, s) : out_proj<tts::bf16>(r, g, s);
}
