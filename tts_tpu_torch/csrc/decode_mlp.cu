// Kernel 14: the decode-layer tail with bf16 or int8 weight-only weights.
// Replaces tts_tpu/ops/decode_mlp.py:fused_out_mlp (Pallas bodies _kernel,
// _no_scale_kernel); the kernels, their rounding points, their bound and
// their design are in decode_mlp.cuh.
#include "decode_mlp.cuh"

// x (B, H), att (B, A) bf16; wo (A, H), w_gate_up (H, 2F), w_down (F, H),
// bf16, or int8 when w_int8 with fp32 per-column scales so (H,), sgu (2F,),
// sd (H,); scratch: partial (ks, B, H) fp32, x2 (B, H) bf16, a (B, F) bf16;
// out (B, H) bf16. B 1..8, A % 8 == 0, H and F multiples of 32, H <= 4096,
// F <= 4096, ks slices of kslice input rows covering A.
extern "C" int fused_out_mlp(const void* x, const void* att, const void* wo, const void* wgu,
                             const void* wd, int w_int8, const void* so, const void* sgu,
                             const void* sd, void* partial, void* x2, void* a, void* out,
                             int B, int A, int H, int F, int kslice, int ks, float eps,
                             void* stream) {
  using tts::bf16;
  if (!tts::shapes_ok(B, A, H, F, kslice, ks) || (w_int8 && !(so && sgu && sd)))
    return (int)cudaErrorInvalidValue;
  tts::Args p{(const bf16*)x, (const bf16*)att, wo, wgu, wd,
              w_int8 ? (const float*)so : nullptr, w_int8 ? (const float*)sgu : nullptr,
              w_int8 ? (const float*)sd : nullptr, (float*)partial, nullptr, (bf16*)x2, a,
              (bf16*)out, A, H, F, kslice, ks, F, eps};
  cudaStream_t st = (cudaStream_t)stream;
  return w_int8 ? tts::dispatch<int8_t, false>(B, p, st) : tts::dispatch<bf16, false>(B, p, st);
}
