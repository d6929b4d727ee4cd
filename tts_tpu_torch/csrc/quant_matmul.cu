// W8A8 matmuls of the F5 DiT attention, and the bare int8 matmul, each a
// q8_rows pass (q8_core.cuh) and the s8 wgmma GEMM of q8_wgmma.cuh.
//
// Replaces tts_tpu/ops/quant_matmul.py:
//   quantized_matmul      (Pallas body _kernel):          T(q(x) @ Wq * xs * ws)
//   ln_qkv_q8             (Pallas body _ln_qkv_kernel):   LN + modulate in fp32,
//                         row int8, s8 GEMM, T(acc * xs * ws + b)
//   out_proj_residual_q8  (Pallas body _out_proj_kernel): row int8 of the
//                         attention output, s8 GEMM, y = acc * xs * ws + b,
//                         x + T(gate) * T(y) in T
// with the TPU kernels' rounding points (see q8_core.cuh). T, the
// activation type, is bf16 or fp32 (f32 = 1), as the TPU kernels take
// either.
//
// What bounds them on an H100, at the F5 bench shape (M = 2816 rows):
// quantized_matmul and ln_qkv_q8 do 2 * 2816 * 1024 * 3072 = 17.7 G int8
// ops against 23-26 MB moved, so the tensor cores bound them (8.9 us at
// 1,979 TOPS); out_proj_residual_q8 does 5.9 G ops against 18.4 MB, so
// memory bounds it (5.5 us at 3.35 TB/s). Each TPU kernel was one program
// that held the weight in VMEM; here each is two launches, the row
// quantization and the GEMM, with the int8 rows (2.9 MB) between them in
// device memory. The GEMM reads the weight stored K-major (the layout
// runtime/f5.quantize_dit gives the card) in the form ops/quant_matmul.q8_plan
// picks, with the scale-only (kernel 9), bias (kernel 7) or gated residual
// (kernel 8) epilogue.
#include "q8_wgmma.cuh"

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

// the s8 wgmma GEMM over rows already quantized, with a bias (N,) fp32 or null
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

// x (M, K) bf16 (f32 = 0) or fp32 (f32 = 1); wt (N, K) int8, the weight
// K-major; ws (N,) fp32 -> out (M, N) of x's type; xq (M, K) int8 and xs
// (M,) fp32 scratch. K % 64 == 0, K <= 2048, N % 128 == 0; stages the
// GEMM's ring depth (ops/quant_matmul.q8_plan).
extern "C" int quantized_matmul(const void* x, const void* wt, const void* ws, void* xq,
                                void* xs, void* out, int M, int K, int N, int f32, int stages,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowArgs r = row_args(x, xq, xs, M, K);
  const WgArgs g = wg_args(xq, xs, wt, ws, nullptr, out, M, K, N);
  return f32 ? rows_then_gemm<ROWS_RAW, WEPI_SCALE, float>(r, g, stages, s)
             : rows_then_gemm<ROWS_RAW, WEPI_SCALE, tts::bf16>(r, g, stages, s);
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
