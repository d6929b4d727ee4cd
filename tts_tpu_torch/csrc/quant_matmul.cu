// W8A8 matmuls of the F5 DiT attention, and the bare int8 matmul, on the
// int8 core of q8_core.cuh (q8_rows, then q8_gemm).
//
// Replaces tts_tpu/ops/quant_matmul.py:
//   quantized_matmul      (Pallas body _kernel):          bf16(q(x) @ Wq * xs * ws)
//   ln_qkv_q8             (Pallas body _ln_qkv_kernel):   LN + modulate in fp32,
//                         row int8, s8 GEMM, bf16(acc * xs * ws + b)
//   out_proj_residual_q8  (Pallas body _out_proj_kernel): row int8 of the
//                         attention output, s8 GEMM, y = acc * xs * ws + b,
//                         bf16(x + bf16(gate) * bf16(y)) in bf16
// with the TPU kernels' rounding points (see q8_core.cuh).
//
// What bounds them on an H100, at the F5 bench shape (M = 2816 rows):
// ln_qkv_q8 does 2 * 2816 * 1024 * 3072 = 17.7 G int8 ops against 26.2 MB
// moved, so the tensor cores bound it (8.9 us at 1,979 TOPS);
// out_proj_residual_q8 does 5.9 G ops against 18.4 MB, so memory bounds it
// (5.5 us at 3.35 TB/s). Each TPU kernel was one program that held the
// weight in VMEM; here each is two launches, the row quantization and the
// GEMM, with the int8 rows (2.9 MB) between them in device memory. The GEMM
// runs WMMA (mma.sync) from a two-stage cp.async pipeline rather than
// Hopper's wgmma from TMA, so it runs well below either bound.
#include "q8_core.cuh"

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

}  // namespace

// x (M, K) bf16; wq (K, N) int8; ws (N,) fp32 -> out (M, N) bf16; xq (M, K)
// int8 and xs (M,) fp32 scratch. K % 64 == 0, K <= 2048, N % 128 == 0.
extern "C" int quantized_matmul(const void* x, const void* wq, const void* ws,
                                void* xq, void* xs, void* out, int M, int K, int N,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_rows<ROWS_BF16>(row_args(x, xq, xs, M, K), s);
  if (err) return err;
  return launch_gemm<EPI_SCALE>(gemm_args(xq, xs, wq, ws, out, M, K, N), s);
}

// x (M, D) bf16; mods (2, D) fp32 [shift, scale]; wq (D, N) int8; ws, b (N,)
// fp32 -> out (M, N) bf16; xq, xs scratch as above. D % 64 == 0,
// D <= 2048, N % 128 == 0.
extern "C" int ln_qkv_q8(const void* x, const void* mods, const void* wq,
                         const void* ws, const void* b, void* xq, void* xs, void* out,
                         int M, int D, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RowArgs r = row_args(x, xq, xs, M, D);
  r.mods = (const float*)mods;
  r.mods_bstride = 0;
  int err = launch_rows<ROWS_LN>(r, s);
  if (err) return err;
  GemmArgs g = gemm_args(xq, xs, wq, ws, out, M, D, N);
  g.bias = (const float*)b;
  return launch_gemm<EPI_BIAS>(g, s);
}

// o (M, HD) bf16 attention output; wq (HD, D) int8; ws, b, gate (D,) fp32;
// x_res (M, D) bf16 -> out (M, D) bf16; xq (M, HD), xs scratch. HD % 64 ==
// 0, HD <= 2048, D % 128 == 0.
extern "C" int out_proj_residual_q8(const void* o, const void* wq, const void* ws,
                                    const void* b, const void* gate,
                                    const void* x_res, void* xq, void* xs, void* out,
                                    int M, int HD, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_rows<ROWS_BF16>(row_args(o, xq, xs, M, HD), s);
  if (err) return err;
  GemmArgs g = gemm_args(xq, xs, wq, ws, out, M, HD, D);
  g.bias = (const float*)b;
  g.res = (const tts::bf16*)x_res;
  g.gate = (const float*)gate;
  g.gate_bstride = 0;
  return launch_gemm<EPI_RESIDUAL>(g, s);
}
