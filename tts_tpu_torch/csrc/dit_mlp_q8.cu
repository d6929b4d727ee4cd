// W8A8 fused DiT MLP block of the F5 transformer, on the int8 row pass of
// q8_core.cuh and the s8 wgmma GEMM of q8_wgmma.cuh:
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
// hidden row whole. Here the block is three launches (q8_wgmma.cuh's
// mlp_block, which kernel 17's ablations share):
//   q8_rows<ROWS_LN>        the modulated LN rows, int8 (M, D) and xs (M,);
//   q8_wgmma_hidden_kernel  ff1 over clusters that span whole hidden rows:
//                           gelu in registers, the row's amax across the
//                           cluster through distributed shared memory, int8
//                           h (M, F) and hs (M,) written; the fp32 hidden
//                           never reaches device memory;
//   q8_wgmma_kernel         ff2 with bias and the gated residual.
// What bounds it on an H100, at the F5 bench shape (M = 2816, D = 1024,
// F = 2048): 4 * 2816 * 1024 * 2048 = 23.6 G int8 ops, 11.9 us at 1,979
// TOPS, far above its bytes (x, the int8 weights, out: 16 MB, 4.8 us at
// 3.35 TB/s). The int8 rows of n (2.9 MB) and h (5.8 MB) pass through
// device memory between the launches, and stay in the card's 50 MB L2.
#include "q8_wgmma.cuh"

using namespace tts::q8;

// x, out (M, D) with M = B * T, bf16 (f32 = 0) or fp32 (f32 = 1); mods (Bm,
// 3, D) fp32 rows [shift, scale, gate] (values of the activation dtype), Bm
// in {1, B}; w1t (F, D), w2t (D, F) int8, the weights K-major; s1, b1 (F,),
// s2, b2 (D,) fp32. Scratch: xq (M, D) and hq (M, F) int8, xs and hs (M,)
// fp32. D % 128 == 0, F % 128 == 0, both <= 2048; ff1 runs in clusters of
// F / 128 CTAs. st1, st2: ff1's and ff2's ring depths
// (ops/quant_matmul.q8_plan).
extern "C" int mlp_block_fused_q8(const void* x, const void* mods, int mods_rows,
                                  const void* w1t, const void* s1, const void* b1,
                                  const void* w2t, const void* s2, const void* b2,
                                  void* xq, void* xs, void* hq, void* hs, void* out, int M,
                                  int T, int D, int F, int f32, int st1, int st2,
                                  void* stream) {
  const MlpArgs p = mlp_args(x, mods, mods_rows, w1t, s1, b1, w2t, s2, b2, xq, xs, hq, hs, out,
                             M, T, D, F, st1, st2);
  const cudaStream_t s = (cudaStream_t)stream;
  return f32 ? mlp_block<float>(p, s) : mlp_block<tts::bf16>(p, s);
}
