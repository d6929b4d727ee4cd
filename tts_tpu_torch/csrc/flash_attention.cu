// Flat-qkv flash attention with RoPE, for the F5 DiT.
//
// Replaces tts_tpu/ops/flash_attention.py:flash_attention_flat (Pallas body
// _kernel_flat). Same contract: q, k and v are read off the fused
// (B, T, 3*H*D) qkv projection at column offsets h*D, H*D + h*D and
// 2*H*D + h*D; q and k get half-split RoPE in fp32 and are rounded to bf16
// before the dots; keys >= kv_len[b] are masked, query rows never are; the
// output is packed (B, T, H*D).
//
// Softmax: the TPU form has no row max. Scores are clamped at +100 in the
// log2 domain and exponentiated as exp2(s - 30), so the normaliser and the
// P.V sum are plain sums over keys: l = sum(p) + 1e-37, o = sum(bf16(p) v) / l.
// That is the FIXED contract of the flash core (flash_core.cuh), which
// streams 64-key tiles with S, P and O in registers.
//
// Two launches a call, counted as one (the wrapper's): a pre-pass
// (flash::rope_qk_kernel) ropes q and k once into a bf16 (2, B, H, T, D)
// scratch the wrapper allocates, computing x * cos + rot_half(x) * sin in
// fp32 with rot_half = [-x[D/2:], x[:D/2]], each product and the sum
// rounded once (no FMA), then rounding to bf16: tts_tpu's rounding point. The TPU kernel ropes k once per (b,
// head pair) into VMEM scratch; a CUDA block cannot share that with the
// other query tiles of its head, and roping k in every query tile would
// read k twice plus fp32 cos and sin rows for every key tile, 12 bytes of
// L2 traffic a k element where the core reads 2. The scratch costs
// 4 B*H*T*D bytes written and read once (11.5 MB at the bench shape). v is
// read in place, rows 3*H*D apart.
//
// Head dim 64 (F5) or 128, as tts_tpu's kernel takes both; T a multiple of
// 64, a warpgroup's rows (a CTA's second warpgroup past T stores nothing).
//
// What bounds it on an H100: tensor-core work (4*T*kv*D flops a head) and,
// as much at D 64, one exp2 a score on the SFUs; see flash_core.cuh.
// No atomics: the result is bitwise reproducible run to run.
#include "flash_core.cuh"

namespace tts {
namespace {

using flash::Args;

template <int D>
__global__ void __launch_bounds__(flash::CTA_THREADS) flash_flat_kernel(const Args a) {
  flash::attend<D, flash::FIXED>(a);
}

template <int D>
int launch_flat(const bf16* qkv, const float* cos_t, const float* sin_t, const int* kv_len,
                bf16* qk, bf16* out, int B, int T, int H, cudaStream_t stream) {
  static int smem_set[MAX_DEVICES];
  constexpr size_t smem = flash::smem_bytes<D>();
  cudaError_t err = raise_attr(flash_flat_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * T * 2 * H * (D / 8);
  flash::rope_qk_kernel<D><<<(unsigned)((n + flash::ROPE_NT - 1) / flash::ROPE_NT),
                             flash::ROPE_NT, 0, stream>>>(qkv, cos_t, sin_t, qk, B, T, H, 1.f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // log2e: the 1/sqrt(D) scale is folded into wqkv
  const Args a = flash::flat_args<D>(qkv, qk, kv_len, out, B, T, H, 1.4426950408889634f);
  const int tiles = (T + flash::CTA_ROWS - 1) / flash::CTA_ROWS;
  flash_flat_kernel<D><<<dim3(tiles, H, B), flash::CTA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tts

// qkv (B, T, 3*H*D) bf16; cos, sin (T, D) fp32; kv_len (B,) int32; qk
// (2, B, H, T, D) bf16 scratch; out (B, T, H*D) bf16. D is 64 or 128; T
// must be a multiple of 64.
extern "C" int flash_attention_flat(const void* qkv, const void* cos_t, const void* sin_t,
                                    const void* kv_len, void* qk, void* out, int B, int T,
                                    int H, int D, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (T % 64) return (int)cudaErrorInvalidValue;
  const auto* x = (const tts::bf16*)qkv;
  const auto *c = (const float*)cos_t, *sn = (const float*)sin_t;
  const auto* kv = (const int*)kv_len;
  auto *q = (tts::bf16*)qk, *o = (tts::bf16*)out;
  if (D == 64) return tts::launch_flat<64>(x, c, sn, kv, q, o, B, T, H, s);
  if (D == 128) return tts::launch_flat<128>(x, c, sn, kv, q, o, B, T, H, s);
  return (int)cudaErrorInvalidValue;
}
