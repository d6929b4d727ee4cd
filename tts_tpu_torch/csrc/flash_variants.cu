// Kernel 16: ablations of kernel 1's epilogue (flash_attention.cu) on the
// flash core, for measuring what each piece of the softmax costs on the
// card.
//
// Replaces benchmarks/flash_ablation.py:flash_variant (Pallas body _kernel,
// copies of tts_tpu's _kernel_flat) and the same script's kv_split sweep of
// kernel 1. Contract: kernel 1's (q, k, v off the flat (B, T, 3*H*D) qkv,
// RoPE on q and k in fp32 rounded to bf16, exp2(min(s c, 100) - 30) with no
// row max, P in bf16 for P.V, o / l), every key kept, c = f32(scale *
// log2e), in one of four variants:
//
//   0 base    c on the scores, as kernel 1 (scale 1: kernel 1 bit for bit);
//   1 qscale  c folded into q's RoPE tables in the pre-pass (each entry
//             times c, rounded once, as the script forms them in fp32), so
//             the core runs with c = 1 and the score tile is not scaled;
//   2 bf16sm  qscale, and the core's EPI_BF16 epilogue: the shifted score
//             rounded to bf16, exp2 in bf16 on the SFUs two at a time;
//   3 nodiv   bf16sm with o * (1 / l) (EPI_BF16_RCP).
//
// base also runs with its row blocks' keys split over a cluster of 2 or 4
// CTAs (the core's SPLIT, from kernel 4's fp32 form): at the script's shape
// (B 2, T 1408, H 16) kernel 1's grid is 11 x 16 x 2 = 352 CTAs on 264 slots
// (1.33 waves); split 2 gives 704 CTAs of half the keys, split 4 1408.
//
// What bounds it on an H100: as kernel 1, the two products (4 T^2 D flops a
// head at 989 TFLOP/s) and, as much at D 64, one exp2 a score on the SFUs
// (EPI_BF16 does two a lane an instruction). Head dim 64, T a multiple of 64.
// Two launches a call (the RoPE pre-pass into a (2, B, H, T, D) scratch, the
// core), counted as one. No atomics: bitwise reproducible run to run.
#include "flash_core.cuh"

namespace tts {
namespace {

constexpr int D = 64;

template <flash::Epi EPI, int SPLIT>
__global__ void __launch_bounds__(flash::CTA_THREADS) flash_variant_kernel(const flash::Args a) {
  flash::attend<D, flash::FIXED, EPI, SPLIT>(a);
}

template <flash::Epi EPI, int SPLIT>
int launch_core(const flash::Args& a, int B, int H, cudaStream_t stream) {
  static int smem_set[MAX_DEVICES];
  constexpr size_t smem = flash::smem_bytes<D>();
  const auto kernel = flash_variant_kernel<EPI, SPLIT>;
  const cudaError_t err =
      raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.S + flash::CTA_ROWS - 1) / flash::CTA_ROWS;
  if (SPLIT == 1) {
    kernel<<<dim3(tiles, H, B), flash::CTA_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)launch_cluster(kernel, dim3(tiles * SPLIT, H, B), flash::CTA_THREADS, smem, stream,
                             SPLIT, a);
}

}  // namespace
}  // namespace tts

// qkv (B, T, 3*H*D) bf16; cos, sin (T, D) fp32; kv_len (B,) int32 (T for
// every row: no key is masked); qk (2, B, H, T, D) bf16 scratch; out (B, T,
// H*D) bf16. D must be 64 and T a multiple of 64; c = f32(scale * log2e);
// variant 0-3 as above; split 1, 2 or 4 (base only).
extern "C" int flash_variant(const void* qkv, const void* cos_t, const void* sin_t,
                             const void* kv_len, void* qk, void* out, int B, int T, int H,
                             int d, float c, int variant, int split, void* stream) {
  using namespace tts;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d != D || T % 64 || variant < 0 || variant > 3 || (split != 1 && variant != 0) ||
      (split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  const auto* x = (const bf16*)qkv;
  const auto *ct = (const float*)cos_t, *st = (const float*)sin_t;
  auto *q = (bf16*)qk, *o = (bf16*)out;
  const long long n = (long long)B * T * 2 * H * (D / 8);
  const unsigned blocks = (unsigned)((n + flash::ROPE_NT - 1) / flash::ROPE_NT);
  if (variant == 0)
    flash::rope_qk_kernel<D><<<blocks, flash::ROPE_NT, 0, s>>>(x, ct, st, q, B, T, H, 1.f);
  else
    flash::rope_qk_kernel<D, true><<<blocks, flash::ROPE_NT, 0, s>>>(x, ct, st, q, B, T, H, c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const flash::Args a =
      flash::flat_args<D>(x, q, (const int*)kv_len, o, B, T, H, variant == 0 ? c : 1.f);
  if (variant == 1) return launch_core<flash::EPI_F32, 1>(a, B, H, s);
  if (variant == 2) return launch_core<flash::EPI_BF16, 1>(a, B, H, s);
  if (variant == 3) return launch_core<flash::EPI_BF16_RCP, 1>(a, B, H, s);
  if (split == 2) return launch_core<flash::EPI_F32, 2>(a, B, H, s);
  if (split == 4) return launch_core<flash::EPI_F32, 4>(a, B, H, s);
  return launch_core<flash::EPI_F32, 1>(a, B, H, s);
}
