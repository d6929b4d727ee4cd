// Kernel 15: the decode-layer tail in W8A8. Replaces
// tts_tpu/ops/decode_mlp.py:fused_out_mlp_q8 (Pallas body _kernel_q8, with
// the att row quantization tts_tpu ran in XLA ahead of it); the kernels,
// their quantization steps, their bound and their design are in
// decode_mlp.cuh.
#include "decode_mlp.cuh"

// x (B, H), att (B, A) bf16; wo (A, H), w_gate_up (H, 2F), w_down (F, H)
// int8 with fp32 per-column scales so (H,), sgu (2F,), sd (H,); scratch:
// partial (ks, B, H) int32, ats (B,) fp32, x2 (B, H) bf16, a (B, F) fp32;
// out (B, H) bf16; fb the F-block of a's quantization (F % fb == 0, fb % 32
// == 0). B 1..8, A % 8 == 0, H and F multiples of 32, H <= 4096, F <= 4096,
// ks slices of kslice input rows covering A.
extern "C" int fused_out_mlp_q8(const void* x, const void* att, const void* wo,
                                const void* wgu, const void* wd, const void* so,
                                const void* sgu, const void* sd, void* partial, void* ats,
                                void* x2, void* a, void* out, int B, int A, int H, int F,
                                int kslice, int ks, int fb, float eps, void* stream) {
  using tts::bf16;
  if (!tts::shapes_ok(B, A, H, F, kslice, ks) || fb < 32 || fb % 32 || F % fb ||
      !(so && sgu && sd))
    return (int)cudaErrorInvalidValue;
  tts::Args p{(const bf16*)x, (const bf16*)att, wo, wgu, wd, (const float*)so,
              (const float*)sgu, (const float*)sd, (float*)partial, (float*)ats,
              (bf16*)x2, a, (bf16*)out, A, H, F, kslice, ks, fb, eps};
  return tts::dispatch<int8_t, true>(B, p, (cudaStream_t)stream);
}
