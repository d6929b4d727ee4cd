// Fused grouped-conv position embedding of the F5 input embedding:
// mish(conv2(mish(conv1(x)))) + x, two K-tap "same" grouped conv1d with 64
// channels per group.
//
// Replaces tts_tpu/ops/grouped_conv.py:conv_pos_embed_fused (Pallas body
// _kernel). Same rounding points: each dot accumulates in fp32 and is
// rounded to bf16, the bias is added in bf16, mish runs in fp32 and is
// rounded once, and the residual is a bf16 add.
//
// Design: an implicit-im2col GEMM per (batch, group, 64-row T tile). The
// block stages its 64 + K - 1 input rows (the halo of (K-1)/2 rows on each
// side, zero outside [0, T)) once in shared memory; tap k's im2col operand
// is then just that buffer read from row k, so the column matrix of the TPU
// kernel is never built. The contraction runs tap by tap over a 64x64
// weight slice, 31 x 64 = 1984 deep for F5. The two convs are two launches
// (conv1 + mish into a scratch tensor, conv2 + mish + residual into the
// output) rather than one launch that would recompute a 2x halo.
//
// What bounds it on an H100: tensor-core work (2 * 1984 * 64 flops per
// output element and conv) against only one read and one write of each
// activation; the weight slices (254 KB per group) come from L2. This first
// version is single-buffered (loads and dots do not overlap), so it runs
// well below the tensor-core peak. No atomics: bitwise reproducible.
#include "common.cuh"

namespace tts {
namespace {

constexpr int CPG = 64;   // channels per group, in and out
constexpr int BT = 64;    // output rows per block
constexpr int MAXK = 33;  // widest kernel the halo buffer takes
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
conv_mish_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, const bf16* __restrict__ resid,
                 bf16* __restrict__ out, int T, int C, int K) {
  __shared__ __align__(128) bf16 xs[(BT + MAXK - 1) * CPG];
  __shared__ __align__(128) bf16 ws[CPG * CPG];
  __shared__ __align__(128) float cs[BT * CPG];

  const int t0 = blockIdx.x * BT, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 32 x 32
  const int pad = (K - 1) / 2, rows = BT + K - 1;
  const bf16* xb = x + (size_t)b * T * C + g * CPG;

  for (int i = threadIdx.x; i < rows * (CPG / 8); i += NT) {
    const int r = i / (CPG / 8), c = (i % (CPG / 8)) * 8, t = t0 - pad + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < T) v = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + c);
    *reinterpret_cast<uint4*>(xs + r * CPG + c) = v;
  }

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the halo is staged / every warp is done with ws
    // ws[ci][co] = w[k, ci, g*64 + co]  (WIO layout, (K, C/groups, C))
    for (int i = threadIdx.x; i < CPG * (CPG / 8); i += NT) {
      const int r = i / (CPG / 8), c = (i % (CPG / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + r * CPG + c) =
          *reinterpret_cast<const uint4*>(w + ((size_t)k * CPG + r) * C + g * CPG + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CPG / 16; ++kk) {
      FragA a[2];
      FragB bw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (k + wm * 32 + i * 16) * CPG + kk * 16, CPG);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], ws + kk * 16 * CPG + wn * 32 + j * 16, CPG);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CPG + wn * 32 + j * 16,
                              acc[i][j], CPG, wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < BT * CPG; i += NT) {
    const int r = i / CPG, c = i % CPG;
    const size_t o = ((size_t)b * T + t0 + r) * C + g * CPG + c;
    const float y = rnd(rnd(cs[i]) + to_f(bias[g * CPG + c]));
    bf16 v = to_bf(mish(y));
    if (resid) v = to_bf(to_f(v) + to_f(resid[o]));
    out[o] = v;
  }
}

}  // namespace
}  // namespace tts

// x, scratch, out (B, T, C) bf16; w1, w2 (K, 64, C) bf16; b1, b2 (C,) bf16.
// C = 64 * groups, T a multiple of 64, K odd and at most 33.
extern "C" int conv_pos_embed_fused(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* scratch, void* out,
                                    int B, int T, int C, int K, void* stream) {
  const dim3 grid(T / tts::BT, C / tts::CPG, B);
  cudaStream_t s = (cudaStream_t)stream;
  tts::conv_mish_kernel<<<grid, tts::NT, 0, s>>>(
      (const tts::bf16*)x, (const tts::bf16*)w1, (const tts::bf16*)b1, nullptr,
      (tts::bf16*)scratch, T, C, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tts::conv_mish_kernel<<<grid, tts::NT, 0, s>>>(
      (const tts::bf16*)scratch, (const tts::bf16*)w2, (const tts::bf16*)b2,
      (const tts::bf16*)x, (tts::bf16*)out, T, C, K);
  return (int)cudaGetLastError();
}
