// W8A8 fused DiT MLP block of the F5 transformer, on the int8 core of
// q8_core.cuh:
//   n = LN(x) * (1 + scale) + shift                          (fp32)
//   h = gelu_tanh(q(n) @ W1q * xs * s1 + b1)                 (fp32)
//   y = q(h) @ W2q * hs * s2 + b2                            (fp32)
//   out = x + gate * Act(y)                                  (Act)
//
// Replaces tts_tpu/ops/dit_mlp.py:mlp_block_fused_q8 (Pallas body
// _kernel_q8), with its rounding points: LN and modulate in fp32 (kernel 3
// rounds the LN to bf16 first; this one does not), mods taken in the
// activation dtype, each row quantized with xs = max(amax, 1e-8) * f32(1/127)
// and q = clip(rint(v / xs)), the rescale ((acc * xs) * ws + b) in fp32.
// Act, the activation type of x and out, is bf16 or fp32 (f32 = 1), as the
// TPU kernel takes either.
//
// Design: the TPU kernel held both int8 weights and a row block's whole
// (rows, F) hidden layer in VMEM, so the second quantization saw each
// hidden row whole. Here that row's amax spans every column tile of the
// first GEMM, and blocks share nothing, so the block is four launches (no
// atomics, reproducible): quantize the modulated LN rows; GEMM 1 with bias
// and gelu, writing the fp32 hidden (M, F); quantize the hidden rows; GEMM 2
// with bias and the gated residual.
// What bounds it on an H100, at the F5 bench shape (M = 2816, D = 1024,
// F = 2048): 4 * 2816 * 1024 * 2048 = 23.6 G int8 ops, 11.9 us at 1,979
// TOPS, with the hidden kept on chip. The fp32 hidden's round trip through
// device memory (23 MB each way) adds about 14 us of traffic, and its int8
// form 5.8 MB more: what a later version that keeps it on chip removes.
#include "q8_core.cuh"

using namespace tts::q8;

namespace {

template <typename Act>
int mlp(const void* x, const float* mods, int mstride, const void* w1q, const void* s1,
        const void* b1, const void* w2q, const void* s2, const void* b2, void* xq, void* xs,
        void* hid, void* out, int M, int T, int D, int F, cudaStream_t s) {
  RowArgs r{};
  r.a = x;
  r.mods = mods;
  r.mods_bstride = mstride;
  r.q = (int8_t*)xq;
  r.xs = (float*)xs;
  r.M = M, r.K = D, r.T = T;
  int err = launch_rows<ROWS_LN, Act>(r, s);
  if (err) return err;

  GemmArgs g{};
  g.q = (const int8_t*)xq;
  g.xs = (const float*)xs;
  g.wq = (const int8_t*)w1q;
  g.ws = (const float*)s1;
  g.bias = (const float*)b1;
  g.out = hid;
  g.M = M, g.K = D, g.N = F, g.T = T;
  if ((err = launch_gemm<EPI_GELU, float>(g, s))) return err;

  r.a = hid;
  r.K = F;
  if ((err = launch_rows<ROWS_RAW, float>(r, s))) return err;

  g.wq = (const int8_t*)w2q;
  g.ws = (const float*)s2;
  g.bias = (const float*)b2;
  g.res = x;
  g.gate = mods + 2 * D;
  g.gate_bstride = mstride;
  g.out = out;
  g.K = F, g.N = D;
  return launch_gemm<EPI_RESIDUAL, Act>(g, s);
}

}  // namespace

// x, out (M, D) with M = B * T, bf16 (f32 = 0) or fp32 (f32 = 1); mods (Bm,
// 3, D) fp32 rows [shift, scale, gate] (values of the activation dtype), Bm
// in {1, B}; w1q (D, F), w2q (F, D) int8; s1, b1 (F,), s2, b2 (D,) fp32.
// Scratch: xq (M, max(D, F)) int8, xs (M,) fp32, hid (M, F) fp32. D, F %
// 128 == 0 and <= 2048.
extern "C" int mlp_block_fused_q8(const void* x, const void* mods, int mods_rows,
                                  const void* w1q, const void* s1, const void* b1,
                                  const void* w2q, const void* s2, const void* b2,
                                  void* xq, void* xs, void* hid, void* out, int M,
                                  int T, int D, int F, int f32, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int mstride = mods_rows == 1 ? 0 : 3 * D;
  const float* m = (const float*)mods;
  if (f32)
    return mlp<float>(x, m, mstride, w1q, s1, b1, w2q, s2, b2, xq, xs, hid, out, M, T, D, F, s);
  return mlp<tts::bf16>(x, m, mstride, w1q, s1, b1, w2q, s2, b2, xq, xs, hid, out, M, T, D,
                        F, s);
}
