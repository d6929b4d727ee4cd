// Kernel 17: ablations of kernel 6, the W8A8 DiT MLP block (dit_mlp_q8.cu),
// for measuring what each of its pieces costs on the card.
//
// Replaces benchmarks/q8_kernel_profile.py:_mk (Pallas bodies _body and
// _body_dots_only, copies of tts_tpu's _kernel_q8 with pieces swapped or
// removed). Each variant but dots_only is kernel 6's three launches
// (q8_wgmma.cuh's mlp_block) with the hooks of q8_core.cuh and
// q8_wgmma.cuh, as the script's (ln, quant, gelu) triple names them:
//   ln     0 two-pass LayerNorm (ROWS_LN), 1 one-pass (ROWS_LN1), 2 none
//          (ROWS_MOD);
//   quant  0 per-row scales (QUANT_ROW), 1 one fixed scale 0.05
//          (QUANT_FIXED: no amax, and ff1's clusters exchange nothing);
//   gelu   0-6 the Gelu hook, in the order of ops/dit_mlp_q8_variants._GELU.
// full (0, 0, 0) is kernel 6 bit for bit. dots_only keeps the two products
// alone (q8_dots_kernel on the same mainloop): x converted to int8 toward
// zero (saturated), ff1's acc >> 8 (arithmetic) wrapped to int8, ff2's acc2
// written in bf16 with no scale, bias or residual.
//
// What bounds it on an H100, at the script's shape (M = 2 x 1408 = 2816, D
// 1024, F 2048): the int8 products, 4 M D F = 23.6 G ops, 11.9 us at 1,979
// TOPS; its bytes (x, the weights, out: 16 MB) take 4.8 us at 3.35 TB/s.
// bf16 activations; D and F multiples of 128 up to 2048, as kernel 6.
#include "q8_wgmma.cuh"

using namespace tts::q8;

namespace {

constexpr int TRUNC_NT = 256;

// dots_only's input: 8 bf16 values a thread to int8, toward zero, saturated
__global__ void __launch_bounds__(TRUNC_NT)
q8_trunc_kernel(const tts::bf16* __restrict__ x, int8_t* __restrict__ q, long long n8) {
  const long long i = (long long)blockIdx.x * TRUNC_NT + threadIdx.x;
  if (i >= n8) return;
  tts::Vec8 v;
  v.u = reinterpret_cast<const uint4*>(x)[i];
  union {
    uint2 u;
    signed char b[8];
  } o;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    o.b[j] = (signed char)max(-128, min(127, __float2int_rz(tts::to_f(v.h[j]))));
  reinterpret_cast<uint2*>(q)[i] = o.u;
}

// dots_only's GEMMs: the s8 wgmma mainloop, then (SHIFT8) int8 acc >> 8,
// wrapped (the low byte, as a two's complement conversion keeps it), or
// bf16(acc); CTAS of them share an SM
template <int STAGES, int CTAS, bool SHIFT8>
__global__ void __launch_bounds__(WNT, CTAS) q8_dots_kernel(const WgArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (tts::smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * WM;
  int acc[WN / 2];
  wgemm_mainloop<STAGES>(acc, g, base, m0, n0, wg);

  // acc[4 j + 2 r + e]: row rb + 8 r, column cb + 8 j + e
  const int rb = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int cb = n0 + 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rb + 8 * r;
    if (row >= g.M) continue;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const size_t o = (size_t)row * g.N + cb + 8 * j;
      const int a0 = acc[4 * j + 2 * r], a1 = acc[4 * j + 2 * r + 1];
      if constexpr (SHIFT8) {
        const uint32_t lo = (uint32_t)(a0 >> 8) & 0xffu, hi = (uint32_t)(a1 >> 8) & 0xffu;
        *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(g.out) + o) = (uint16_t)(lo | hi << 8);
      } else {
        const float y[2] = {__int2float_rn(a0), __int2float_rn(a1)};
        store2(static_cast<tts::bf16*>(g.out) + o, y);
      }
    }
  }
}

template <int STAGES, int CTAS, bool SHIFT8>
int launch_dots_form(const WgArgs& g, cudaStream_t s) {
  static int smem_set[tts::MAX_DEVICES];
  constexpr size_t smem = wgemm_smem<STAGES>();
  const auto kernel = q8_dots_kernel<STAGES, CTAS, SHIFT8>;
  const cudaError_t err =
      tts::raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(g.N / WN, (g.M + WM - 1) / WM), WNT, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// the two forms of launch_wgemm_form (ops/quant_matmul.q8_plan)
template <bool SHIFT8>
int launch_dots(int stages, const WgArgs& g, cudaStream_t s) {
  if (!wgemm_shape_ok(g)) return (int)cudaErrorInvalidValue;
  if (stages == 4) return launch_dots_form<4, 1, SHIFT8>(g, s);
  if (stages == 3) return launch_dots_form<3, 2, SHIFT8>(g, s);
  return (int)cudaErrorInvalidValue;
}

int dots_only(const MlpArgs& p, cudaStream_t s) {
  const long long n8 = (long long)p.M * p.D / 8;
  q8_trunc_kernel<<<(unsigned)((n8 + TRUNC_NT - 1) / TRUNC_NT), TRUNC_NT, 0, s>>>(
      static_cast<const tts::bf16*>(p.x), static_cast<int8_t*>(p.xq), n8);
  int err = (int)cudaGetLastError();
  if (err) return err;
  WgArgs g{};
  g.q = static_cast<const int8_t*>(p.xq);
  g.wt = static_cast<const int8_t*>(p.w1t);
  g.out = p.hq;
  g.M = p.M, g.K = p.D, g.N = p.F, g.T = p.T;
  if ((err = launch_dots<true>(p.st1, g, s))) return err;
  g.q = static_cast<const int8_t*>(p.hq);
  g.wt = static_cast<const int8_t*>(p.w2t);
  g.out = p.out;
  g.K = p.F, g.N = p.D;
  return launch_dots<false>(p.st2, g, s);
}

using Form = int (*)(const MlpArgs&, cudaStream_t);

// the script's eleven (ln, quant, gelu) triples
struct Variant {
  int ln, quant, gelu;
  Form run;
};

using tts::bf16;
constexpr Variant VARIANTS[] = {
    {0, 0, 0, mlp_block<bf16>},                                         // full
    {1, 0, 0, mlp_block<bf16, ROWS_LN1>},                               // ln_one_pass
    {2, 0, 0, mlp_block<bf16, ROWS_MOD>},                               // no_ln
    {0, 1, 0, mlp_block<bf16, ROWS_LN, QUANT_FIXED>},                   // fixed_scale
    {0, 0, 1, mlp_block<bf16, ROWS_LN, QUANT_ROW, GELU_TANH_BF16>},     // gelu_bf16
    {0, 0, 2, mlp_block<bf16, ROWS_LN, QUANT_ROW, GELU_RELU>},          // gelu_relu
    {0, 0, 3, mlp_block<bf16, ROWS_LN, QUANT_ROW, GELU_NONE>},          // no_gelu
    {0, 0, 4, mlp_block<bf16, ROWS_LN, QUANT_ROW, GELU_SIG>},           // gelu_sig
    {0, 0, 5, mlp_block<bf16, ROWS_LN, QUANT_ROW, GELU_SIG_EXP2>},      // gelu_sig_exp2
    {0, 0, 6, mlp_block<bf16, ROWS_LN, QUANT_ROW, GELU_TANH_EXP2>},     // gelu_tanh_exp2
    {1, 0, 1, mlp_block<bf16, ROWS_LN1, QUANT_ROW, GELU_TANH_BF16>},    // lean
};

}  // namespace

// kernel 6's arguments (dit_mlp_q8.cu), bf16 activations only, then the
// variant: dots != 0 for dots_only, else one of VARIANTS' (ln, quant,
// gelu) triples; st1, st2 ff1's and ff2's ring depths (dots_only's ff1
// takes launch_wgemm_form's forms, the others ff1 launch_hidden's).
extern "C" int mlp_block_q8_variant(const void* x, const void* mods, int mods_rows,
                                    const void* w1t, const void* s1, const void* b1,
                                    const void* w2t, const void* s2, const void* b2, void* xq,
                                    void* xs, void* hq, void* hs, void* out, int M, int T, int D,
                                    int F, int st1, int st2, int ln, int quant, int gelu,
                                    int dots, void* stream) {
  const MlpArgs p = mlp_args(x, mods, mods_rows, w1t, s1, b1, w2t, s2, b2, xq, xs, hq, hs, out,
                             M, T, D, F, st1, st2);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dots) return dots_only(p, s);
  for (const Variant& v : VARIANTS)
    if (v.ln == ln && v.quant == quant && v.gelu == gelu) return v.run(p, s);
  return (int)cudaErrorInvalidValue;
}
