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
// hidden row whole. Here the block is three launches:
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

namespace {

// The WEPI_HIDDEN GEMM in its one form (ops/quant_matmul.q8_plan with
// whole rows): one cluster of N / 128 <= 16 CTAs across the row (past 8
// with the non-portable size allowed), 3 stages, 2 CTAs an SM.
int launch_hidden(int stages, const WgArgs& g, cudaStream_t s) {
  static int smem_set[tts::MAX_DEVICES], wide_set[tts::MAX_DEVICES];
  const int cluster = g.N / WN;
  if (!wgemm_shape_ok(g) || stages != 3 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wgemm_smem<3>();
  const auto kernel = q8_wgmma_hidden_kernel<3, 2>;
  cudaError_t err =
      tts::raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err == cudaSuccess && cluster > 8)  // past the portable cluster size
    err = tts::raise_attr(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1, wide_set);
  if (err != cudaSuccess) return (int)err;
  return (int)tts::launch_cluster(kernel, dim3(cluster, (g.M + WM - 1) / WM), WNT, smem, s,
                                  cluster, g);
}

template <typename Act>
int mlp(const void* x, const float* mods, int mstride, const void* w1t, const void* s1,
        const void* b1, const void* w2t, const void* s2, const void* b2, void* xq, void* xs,
        void* hq, void* hs, void* out, int M, int T, int D, int F, int st1, int st2,
        cudaStream_t s) {
  RowArgs r{};
  r.a = x;
  r.mods = mods;
  r.mods_bstride = mstride;
  r.q = (int8_t*)xq;
  r.xs = (float*)xs;
  r.M = M, r.K = D, r.T = T;
  int err = launch_rows<ROWS_LN, Act>(r, s);
  if (err) return err;

  WgArgs g{};
  g.q = (const int8_t*)xq;
  g.xs = (const float*)xs;
  g.wt = (const int8_t*)w1t;
  g.ws = (const float*)s1;
  g.bias = (const float*)b1;
  g.out = hq;
  g.out_xs = (float*)hs;
  g.M = M, g.K = D, g.N = F, g.T = T;
  if ((err = launch_hidden(st1, g, s))) return err;

  g.q = (const int8_t*)hq;
  g.xs = (const float*)hs;
  g.wt = (const int8_t*)w2t;
  g.ws = (const float*)s2;
  g.bias = (const float*)b2;
  g.res = x;
  g.gate = mods + 2 * D;
  g.gate_bstride = mstride;
  g.out = out;
  g.out_xs = nullptr;
  g.K = F, g.N = D;
  return launch_wgemm_form<WEPI_RESIDUAL, Act>(st2, g, s);
}

}  // namespace

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
  const cudaStream_t s = (cudaStream_t)stream;
  const int mstride = mods_rows == 1 ? 0 : 3 * D;
  const float* m = (const float*)mods;
  if (f32)
    return mlp<float>(x, m, mstride, w1t, s1, b1, w2t, s2, b2, xq, xs, hq, hs, out, M, T, D, F,
                      st1, st2, s);
  return mlp<tts::bf16>(x, m, mstride, w1t, s1, b1, w2t, s2, b2, xq, xs, hq, hs, out, M, T, D,
                        F, st1, st2, s);
}
