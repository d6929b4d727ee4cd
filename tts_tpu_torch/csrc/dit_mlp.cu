// Fused DiT MLP block of the F5 transformer:
//   x + gate * (ff2(gelu_tanh(ff1(LN(x) * (1 + scale) + shift) + b1)) + b2)
//
// Replaces tts_tpu/ops/dit_mlp.py:mlp_block_fused (Pallas body _kernel).
// Same rounding points: LayerNorm statistics in fp32 (eps 1e-6, no affine)
// rounded to bf16; the modulation in bf16; each dot accumulates in fp32 and
// is rounded to bf16 before its bias; the gated residual in bf16. The gelu
// runs in fp32 and is rounded once.
//
// Design: the TPU kernel keeps both weights (8.4 MB at D=1024, F=2048)
// resident in VMEM and the (rows, F) hidden tensor in VMEM. Shared memory
// holds 227 KB, so here the block becomes two tiled tensor-core GEMMs:
//   ff1: the LN + modulation prologue is applied while the x tile is staged
//        (per-row fp32 statistics computed first by the block), and bias +
//        gelu run in the epilogue;
//   ff2: bias + gated residual run in the epilogue.
// The (B*T, F) bf16 hidden tensor goes through device memory between them
// (11.5 MB at the F5 bench shape; the card's L2 holds 50 MB).
//
// What bounds it on an H100: tensor-core work, 4 * D * F flops per row,
// far above the bytes it moves. This first version uses 64x64 tiles,
// single-buffered, so loads and dots do not overlap and it runs well below
// the tensor-core peak. Mods are (Bm, 3, D) with Bm = 1 (shared) or B (one
// row of [shift, scale, gate] per batch row). No atomics: reproducible.
#include "common.cuh"

namespace tts {
namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // block tile; 2 x 2 warps of 32 x 32
constexpr int NT = 128;

// one BK-deep step of the 64x64 tile product: as (BM, BK), bs (BK, BN)
__device__ __forceinline__ void mma_step(const bf16* as, const bf16* bs,
                                         FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    FragA a[2];
    FragB bw[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * BK + kk * 16, BK);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(bw[j], bs + kk * 16 * BN + wn * 32 + j * 16, BN);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
  }
}

// bs = w[k0 : k0+BK, n0 : n0+BN] of a row-major (K, N) weight
__device__ __forceinline__ void load_b(bf16* bs, const bf16* w, int k0, int n0,
                                       int N) {
  for (int i = threadIdx.x; i < BK * (BN / 8); i += NT) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(bs + r * BN + c) =
        *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c);
  }
}

__device__ __forceinline__ void store_acc(float* cs, FragC (&acc)[2][2], int wm,
                                          int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * BN + wn * 32 + j * 16,
                              acc[i][j], BN, wmma::mem_row_major);
}

__global__ void __launch_bounds__(NT)
ff1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ mods,
           int mods_bstride, const bf16* __restrict__ w1,
           const bf16* __restrict__ b1, bf16* __restrict__ hid, int T, int D,
           int F) {
  __shared__ __align__(128) bf16 as[BM * BK];
  __shared__ __align__(128) bf16 bs[BK * BN];
  __shared__ __align__(128) float cs[BM * BN];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;

  // LayerNorm statistics of the block's rows, two-pass in fp32
  for (int r = warp; r < BM; r += NT / 32) {
    const bf16* xr = x + (size_t)(m0 + r) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = to_f(xr[c]) - mean;
      v += d * d;
    }
    const float var = warp_sum(v) / D;
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rsqrtf(var + 1e-6f);
    }
  }

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // statistics ready / every warp is done with as, bs
    // as = bf16(bf16(bf16(LN(x)) * bf16(1 + scale)) + shift)
    for (int i = threadIdx.x; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int row = m0 + r;
      const bf16* md = mods + (size_t)(row / T) * mods_bstride;
      Vec8 xv, ov;
      xv.u = *reinterpret_cast<const uint4*>(x + (size_t)row * D + k0 + c);
      const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ln = rnd((to_f(xv.h[j]) - mu) * rs);
        const float onep = rnd(1.f + to_f(md[D + k0 + c + j]));
        ov.h[j] = to_bf(rnd(ln * onep) + to_f(md[k0 + c + j]));
      }
      *reinterpret_cast<uint4*>(as + r * BK + c) = ov.u;
    }
    load_b(bs, w1, k0, n0, F);
    __syncthreads();
    mma_step(as, bs, acc, wm, wn);
  }

  store_acc(cs, acc, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    const float h = rnd(rnd(cs[i]) + to_f(b1[n0 + c]));
    hid[(size_t)(m0 + r) * F + n0 + c] = to_bf(gelu_tanh(h));
  }
}

__global__ void __launch_bounds__(NT)
ff2_kernel(const bf16* __restrict__ hid, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, const bf16* __restrict__ x,
           const bf16* __restrict__ mods, int mods_bstride,
           bf16* __restrict__ out, int T, int D, int F) {
  __shared__ __align__(128) bf16 as[BM * BK];
  __shared__ __align__(128) bf16 bs[BK * BN];
  __shared__ __align__(128) float cs[BM * BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < F; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(as + r * BK + c) =
          *reinterpret_cast<const uint4*>(hid + (size_t)(m0 + r) * F + k0 + c);
    }
    load_b(bs, w2, k0, n0, D);
    __syncthreads();
    mma_step(as, bs, acc, wm, wn);
  }

  store_acc(cs, acc, wm, wn);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r;
    const float gate = to_f(mods[(size_t)(row / T) * mods_bstride + 2 * D + n0 + c]);
    const float y = rnd(rnd(cs[i]) + to_f(b2[n0 + c]));
    const size_t o = (size_t)row * D + n0 + c;
    out[o] = to_bf(to_f(x[o]) + rnd(gate * y));
  }
}

}  // namespace
}  // namespace tts

// x, out (B, T, D) bf16; mods (Bm, 3, D) bf16 with Bm in {1, B};
// w1 (D, F), b1 (F,), w2 (F, D), b2 (D,) bf16; hid (B*T, F) bf16 scratch.
// B*T, D and F multiples of 64.
extern "C" int mlp_block_fused(const void* x, const void* mods,
                               int mods_rows, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* hid,
                               void* out, int B, int T, int D, int F,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int mstride = mods_rows == 1 ? 0 : 3 * D;
  const int M = B * T;
  tts::ff1_kernel<<<dim3(F / tts::BN, M / tts::BM), tts::NT, 0, s>>>(
      (const tts::bf16*)x, (const tts::bf16*)mods, mstride,
      (const tts::bf16*)w1, (const tts::bf16*)b1, (tts::bf16*)hid, T, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tts::ff2_kernel<<<dim3(D / tts::BN, M / tts::BM), tts::NT, 0, s>>>(
      (const tts::bf16*)hid, (const tts::bf16*)w2, (const tts::bf16*)b2,
      (const tts::bf16*)x, (const tts::bf16*)mods, mstride, (tts::bf16*)out, T,
      D, F);
  return (int)cudaGetLastError();
}
