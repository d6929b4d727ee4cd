// Fused DiT MLP block of the F5 transformer:
//   x + gate * (ff2(gelu_tanh(ff1(LN(x) * (1 + scale) + shift) + b1)) + b2)
//
// Replaces tts_tpu/ops/dit_mlp.py:mlp_block_fused (Pallas body _kernel).
// Same rounding points: LayerNorm statistics in fp32, two passes (eps 1e-6,
// no affine), ln rounded to bf16; n = bf16(bf16(ln * bf16(1 + scale)) +
// shift); each dot accumulates in fp32 and is rounded to bf16 before its
// bias; h = bf16(gelu_tanh(bf16(bf16(acc1) + b1))) with the gelu in fp32;
// y = bf16(bf16(acc2) + b2); out = bf16(x + bf16(gate * y)). Mods are (Bm,
// 3, D) with Bm = 1 (shared) or B (one [shift, scale, gate] a batch row).
//
// What bounds it on an H100: the two products, 4 M D F operations for M =
// B T rows (23.6 GFLOP at the F5 bench shape, M 2816, D 1024, F 2048: 0.0239
// ms at 989 TFLOP/s bf16), far above the bytes it must move (x, the
// weights, out: 20 MB, 0.006 ms at 3.35 TB/s). The TPU kernel keeps both
// weights (8.4 MB) and the (rows, F) hidden in VMEM; an SM holds 227 KB, so
// here the block is three launches that feed the tensor cores:
//   ln_mod_kernel  one row pass: a warp a row reads x once from device
//                  memory (its second and third passes hit L1), takes the
//                  statistics once and writes n (M, D) bf16 to a scratch,
//                  with 16-byte loads of x and the mods;
//   dit_gemm_kernel<EPI_GELU>   hid = bf16 gelu(n w1 + b1), (M, F);
//   dit_gemm_kernel<EPI_RESID>  out = x + gate (hid w2 + b2), (M, D).
// n (5.8 MB) and hid (11.5 MB at the bench shape) pass through device
// memory between them, and stay in the card's 50 MB L2.
//
// The GEMM, C = A B: A (M, K) bf16 K-major, B (K, N) bf16 in tts_tpu's own
// (D, F) / (F, D) weight layout, which is an MN-major wgmma operand, so no
// transposed copy of the weights exists. A CTA computes a BM x BN tile with
// two warpgroups of 64 rows each; every k16 step a warpgroup issues one
// m64nBNk16 wgmma (BN 64 or 128) with A and B read from shared memory by
// descriptor and fp32 accumulators in registers. K steps of 64 (one
// 128-byte swizzle atom of A) run through a ring of STAGES slots in
// dynamic shared memory, filled by cp.async (16 bytes a thread) in the
// sw128 layout: the copies of step k + STAGES - 2 are queued right after
// the one barrier of step k, before its products, and wgmma.wait_group 1
// keeps one step's products in flight while the next is issued (so the
// slot refilled at step k is the one step k - 2 read). The epilogues run
// straight from the accumulator registers (lane -> (row, column) map in
// wgmma.cuh): bias, gelu, gate and residual in fp32 at the rounding points
// above, bf16x2 stores; no fp32 tile goes through shared memory. Rows past
// M (M % 128 = 64 leaves a CTA's second warpgroup past the end) load a
// repeated last row and store nothing.
//
// Each GEMM takes one of three forms (BN, ring depth, CTAs an SM; see
// launch_form), which the host picks from the grid and the SM count
// (ops/dit_mlp.gemm_plan). No TMA, no producer warp, no persistent
// scheduler: cp.async from every thread keeps the copies off the critical
// path, as in the flash core. No atomics: the output is bitwise the same
// from run to run.
#include "common.cuh"
#include "wgmma.cuh"

namespace tts {
namespace {

constexpr int BM = 128, BK = 64;  // CTA rows (2 warpgroups of 64) and K step
constexpr int NT = 256;
constexpr uint32_t A_BYTES = BM * BK * 2;  // one A slot (K-major, 16 KB)
constexpr int LN_NT = 256;                 // row pass: a warp a row

enum Epi { EPI_GELU, EPI_RESID };

struct GemmArgs {
  const bf16* a;     // (M, K)
  const bf16* b;     // (K, N)
  const bf16* bias;  // (N,)
  bf16* c;           // (M, N)
  const bf16* x;     // EPI_RESID: the residual (M, N)
  const bf16* gate;  // EPI_RESID: gate of batch row i at gate + i * mstride
  int mstride, T;    // rows of x a batch row
  int M, N, K;
};

__global__ void __launch_bounds__(LN_NT)
ln_mod_kernel(const bf16* __restrict__ x, const bf16* __restrict__ mods, int mstride,
              bf16* __restrict__ n, int M, int T, int D) {
  const int row = blockIdx.x * (LN_NT / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nch = D / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  float s = 0.f;
  for (int c = lane; c < nch; c += 32) {
    Vec8 v;
    v.u = xr[c];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += to_f(v.h[j]);
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
  for (int c = lane; c < nch; c += 32) {
    Vec8 v;
    v.u = xr[c];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = to_f(v.h[j]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / D + 1e-6f);
  const uint4* shift = reinterpret_cast<const uint4*>(mods + (size_t)(row / T) * mstride);
  const uint4* scale = shift + nch;
  uint4* nr = reinterpret_cast<uint4*>(n + (size_t)row * D);
  for (int c = lane; c < nch; c += 32) {
    Vec8 v, sh, sc, o;
    v.u = xr[c];
    sh.u = shift[c];
    sc.u = scale[c];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ln = rnd((to_f(v.h[j]) - mean) * rstd);
      o.h[j] = to_bf(rnd(ln * rnd(1.f + to_f(sc.h[j]))) + to_f(sh.h[j]));
    }
    nr[c] = o.u;
  }
}

template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return A_BYTES + BK * BN * 2;
}

template <int BN, int STAGES>
constexpr size_t gemm_smem() {
  return 1024 + (size_t)STAGES * stage_bytes<BN>();  // align slack, the ring
}

// queue the copies of K step k0: A rows m0 .. m0 + BM - 1 (past M: the last
// row again) into sa, B rows k0 .. k0 + BK - 1, columns n0 .. n0 + BN - 1
// into sb, both in the sw128 layout
template <int BN>
__device__ __forceinline__ void load_stage(uint32_t sa, uint32_t sb, const GemmArgs& g, int m0,
                                           int n0, int k0) {
#pragma unroll
  for (int i = threadIdx.x; i < BM * 8; i += NT) {
    const int r = i >> 3, ch = i & 7;
    cp_async16(sa + sw128(r, ch), g.a + (size_t)min(m0 + r, g.M - 1) * g.K + k0 + ch * 8);
  }
#pragma unroll
  for (int i = threadIdx.x; i < BK * (BN / 8); i += NT) {
    const int r = i / (BN / 8), ch = i % (BN / 8);
    cp_async16(sb + sw128(r, ch), g.b + (size_t)(k0 + r) * g.N + n0 + ch * 8);
  }
}

// One CTA: the (BM, BN) tile of C at rows blockIdx.y * BM, columns
// blockIdx.x * BN; CTAS of them share an SM. Launch with NT threads and
// gemm_smem<BN, STAGES>() of dynamic shared memory.
template <int BN, int STAGES, int CTAS, int EPI>
__global__ void __launch_bounds__(NT, CTAS) dit_gemm_kernel(const GemmArgs g) {
  static_assert((BN == 64 || BN == 128) && STAGES >= 3, "tile shape");
  constexpr uint32_t STAGE = stage_bytes<BN>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = g.K / BK;

  float acc[BN / 2];  // one m64nBNk16 product's accumulators
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load_stage<BN>(base + s * STAGE, base + s * STAGE + A_BYTES, g, m0, n0, s * BK);
    cp_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 3>();  // this thread's copies of step kt have landed
    fence_async_smem();     // ... visible to the tensor cores' reads
    __syncthreads();        // step kt in for all; every product of step kt - 2 is done
    const int nk = kt + STAGES - 2;
    if (nk < KT) {
      const uint32_t st = base + (nk % STAGES) * STAGE;
      load_stage<BN>(st, st + A_BYTES, g, m0, n0, nk * BK);
    }
    cp_commit();  // (empty past the last step: the group count stays uniform)

    const uint32_t sa = base + (kt % STAGES) * STAGE + wg * (A_BYTES / 2);
    const uint32_t sb = base + (kt % STAGES) * STAGE + A_BYTES;
    hold(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_mnb(acc, gdesc(sa + kk * 32, 16, 1024), gdesc(sb + kk * 2048, 8192, 1024), 1);
    wg_commit();
    wg_wait<1>();
    hold(acc);
  }
  wg_wait0();
  hold(acc);

  // acc[4 jj + 2 r + e]: row rb + 8 r, column cb + 8 jj + e
  const int rb = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int cb = n0 + 2 * (lane & 3);
  const bf16* gate[2] = {g.gate, g.gate};
  if constexpr (EPI == EPI_RESID) {
#pragma unroll
    for (int r = 0; r < 2; ++r) gate[r] += (size_t)(min(rb + 8 * r, g.M - 1) / g.T) * g.mstride;
  }
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int col = cb + 8 * jj;
    const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rb + 8 * r;
      if (row >= g.M) continue;
      const float v0 = rnd(rnd(acc[4 * jj + 2 * r]) + bias.x);
      const float v1 = rnd(rnd(acc[4 * jj + 2 * r + 1]) + bias.y);
      const size_t o = (size_t)row * g.N + col;
      if constexpr (EPI == EPI_GELU) {
        *reinterpret_cast<uint32_t*>(g.c + o) = pack_bf16(gelu_tanh(v0), gelu_tanh(v1));
      } else {
        const float2 gt = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gate[r] + col));
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.x + o));
        *reinterpret_cast<uint32_t*>(g.c + o) =
            pack_bf16(xv.x + rnd(gt.x * v0), xv.y + rnd(gt.y * v1));
      }
    }
  }
}

template <int BN, int STAGES, int CTAS, int EPI>
int launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  static int smem_set[MAX_DEVICES];
  constexpr size_t smem = gemm_smem<BN, STAGES>();
  const auto kernel = dit_gemm_kernel<BN, STAGES, CTAS, EPI>;
  const cudaError_t err =
      raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(g.N / BN, (g.M + BM - 1) / BM), NT, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// The GEMM's three forms, one a call as ops/dit_mlp.gemm_plan picks it from
// the grid and the SM count (trial builds on an H100 at M 1088-9216, D
// 1024, F 2048 against BN 256, 64-column products at BN 128 and 6 stages):
//   BN 128, 4 stages, 1 CTA an SM: a grid of at most one CTA an SM, where
//     a lone CTA needs the deeper ring to hide its copies;
//   BN 128, 3 stages, 2 CTAs an SM (97 KB of shared memory and <= 128
//     registers each): one CTA's epilogue and copies overlap the other's
//     products;
//   BN 64, 4 stages, 2 CTAs an SM: where 64-column tiles leave the last
//     wave fuller (ff2 at M 2816 and 9216), or N % 128 = 64.
template <int EPI>
int launch_form(int bn, int stages, const GemmArgs& g, cudaStream_t s) {
  if (g.N % bn) return (int)cudaErrorInvalidValue;
  if (bn == 128 && stages == 4) return launch_gemm<128, 4, 1, EPI>(g, s);
  if (bn == 128 && stages == 3) return launch_gemm<128, 3, 2, EPI>(g, s);
  if (bn == 64 && stages == 4) return launch_gemm<64, 4, 2, EPI>(g, s);
  return (int)cudaErrorInvalidValue;
}

int run_block(const void* x, const void* mods, int mods_rows, const void* w1, const void* b1,
              const void* w2, const void* b2, void* nrm, void* hid, void* out, int B, int T,
              int D, int F, int bn1, int st1, int bn2, int st2, cudaStream_t s) {
  const int M = B * T;
  if (M % 64 || D % 64 || F % 64) return (int)cudaErrorInvalidValue;
  const int mstride = mods_rows == 1 ? 0 : 3 * D;
  ln_mod_kernel<<<(M + LN_NT / 32 - 1) / (LN_NT / 32), LN_NT, 0, s>>>(
      (const bf16*)x, (const bf16*)mods, mstride, (bf16*)nrm, M, T, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  GemmArgs g = {};
  g.a = (const bf16*)nrm, g.b = (const bf16*)w1, g.bias = (const bf16*)b1, g.c = (bf16*)hid;
  g.M = M, g.N = F, g.K = D, g.T = T;
  const int e = launch_form<EPI_GELU>(bn1, st1, g, s);
  if (e) return e;
  g.a = (const bf16*)hid, g.b = (const bf16*)w2, g.bias = (const bf16*)b2, g.c = (bf16*)out;
  g.x = (const bf16*)x, g.gate = (const bf16*)mods + 2 * D, g.mstride = mstride;
  g.N = D, g.K = F;
  return launch_form<EPI_RESID>(bn2, st2, g, s);
}

}  // namespace
}  // namespace tts

// x, out (B, T, D) bf16; mods (Bm, 3, D) bf16 with Bm in {1, B}; w1 (D, F),
// b1 (F,), w2 (F, D), b2 (D,) bf16; scratch nrm (B*T, D) and hid (B*T, F)
// bf16. B*T, D and F multiples of 64. (bn1, st1) and (bn2, st2): the column
// tile and ring depth of ff1 and ff2 (ops/dit_mlp.gemm_plan).
extern "C" int mlp_block_fused(const void* x, const void* mods, int mods_rows, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* nrm,
                               void* hid, void* out, int B, int T, int D, int F, int bn1,
                               int st1, int bn2, int st2, void* stream) {
  return tts::run_block(x, mods, mods_rows, w1, b1, w2, b2, nrm, hid, out, B, T, D, F, bn1, st1,
                        bn2, st2, (cudaStream_t)stream);
}
