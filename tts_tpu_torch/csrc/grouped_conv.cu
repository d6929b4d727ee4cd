// Fused grouped-conv position embedding of the F5 input embedding:
// mish(conv2(mish(conv1(x)))) + x, two K-tap "same" grouped conv1d with 64
// channels per group.
//
// Replaces tts_tpu/ops/grouped_conv.py:conv_pos_embed_fused (Pallas body
// _kernel). Same rounding points: each dot accumulates in fp32 and is
// rounded to bf16, the bias is added in bf16, mish runs in fp32 (softplus
// guarded at x > 20) and is rounded once, and the residual is a bf16 add.
//
// What bounds it on an H100: tensor-core work. Each conv is, per group, the
// product (B T x 64 K) . (64 K x 64): at the F5 bench bucket (B 2, T 1408,
// C 1024, K 31) the two convs are 22.9 GFLOP, 0.0231 ms at 989 TFLOP/s
// bf16, against about 31 MB moved (activations, the scratch, 8.1 MB of
// weights: 9 us at 3.35 TB/s).
//
// Design: an implicit-im2col GEMM on wgmma, one CTA a (128-row tile, group,
// batch row), two CTAs an SM. Its two warpgroups each own 64 rows and issue
// wgmma m64n64k16 f32.bf16.bf16: N 64 is exactly one group's output
// channels, and the fp32 accumulators stay in registers for all K taps.
//   A (the im2col rows): the tile's rows + K - 1 input rows (zero outside
//     [0, T), never across a batch row) are staged once in shared memory,
//     64 channels = 128 bytes a row, each row's 16-byte chunks XOR-swizzled
//     by row % 8. Tap k's operand is that buffer read from row k on. A k
//     that is not a multiple of 8 starts inside a 128-byte swizzle atom,
//     which a shared-memory descriptor cannot address, so A goes through
//     registers: ldmatrix.x4 takes any row (8 consecutive rows hit 8
//     distinct chunks, so no bank conflicts) and wgmma reads A from
//     registers. A tap's ldmatrix waits until the previous tap's products
//     are done (ptxas serializes the products, C7513, where an instruction
//     writes a wgmma's input registers while one is in flight), so a tap's
//     products overlap the next tap's barrier and copies, and the other
//     warpgroups' ldmatrix.
//   B (the weights): tap k's slice w[k, :, 64 g : 64 g + 64] is 64 x 64
//     bf16 with the output channel contiguous, an MN-major B operand of
//     128-byte rows in the sw128 layout (as kernel 3 reads its weights).
//     The K slices stream through a ring of STAGES = 4 slots filled by
//     cp.async; the copies of tap k + 2 are queued right after tap k's one
//     barrier, while tap k - 1's products run. A CTA reads its group's 254
//     KB of weights (K 31) from L2 once a conv. 256-row CTAs (each
//     warpgroup two m64 tiles, one CTA an SM) would halve that traffic; on
//     an H100 they ran 18-44% slower than 128-row ones at T 1088, 1408 and
//     4096 (PERF.md §6), so the tile is 128 rows.
//   Epilogue from the accumulator registers: rnd(rnd(acc) + bias), mish,
//   round, and for conv2 + x in bf16, bf16x2 stores; rows past T (a ragged
//   last tile) store nothing.
// The two convs are two launches (conv1 + mish into a scratch tensor, conv2
// + mish + residual into the output), not one launch that would recompute
// a 2x halo. No atomics: bitwise reproducible.
#include "common.cuh"
#include "wgmma.cuh"

namespace tts {
namespace {

constexpr int CPG = 64;                       // channels per group, in and out
constexpr int MAXK = 33;                      // widest kernel the halo buffer takes
constexpr int R = 128;                        // output rows a CTA: 2 warpgroups of 64
constexpr int NT = 256;
constexpr int STAGES = 4;                     // weight ring slots (taps)
constexpr uint32_t TAP_BYTES = CPG * CPG * 2; // one tap's weight slice, 8 KB
// dynamic shared memory: align slack, the weight ring, the halo of R + MAXK - 1 rows
constexpr size_t SMEM = 1024 + STAGES * TAP_BYTES + (size_t)(R + MAXK - 1) * 128;

// byte offset of 16-byte chunk ch of halo row r: 128-byte rows, chunks
// XOR-swizzled by r % 8
__device__ __forceinline__ uint32_t halo_at(int r, int ch) {
  return (uint32_t)(r * 128 + ((ch ^ (r & 7)) << 4));
}

// four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i of every lane holds matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// queue the copies of tap k's weight slice (64 input x 64 output channels
// of group g, the output channel contiguous) into the slot at dst, sw128
__device__ __forceinline__ void load_tap(uint32_t dst, const bf16* wg, int C, int k) {
#pragma unroll
  for (int i = threadIdx.x; i < CPG * 8; i += NT) {
    const int r = i >> 3, ch = i & 7;
    cp_async16(dst + sw128(r, ch), wg + ((size_t)k * CPG + r) * C + ch * 8);
  }
}

struct Tile {
  uint32_t ring, halo;  // shared addresses: the weight ring, the staged input rows
  const bf16* wg;       // the group's weights, w + 64 g
  int C, K;
  int row0;             // the halo row of the warp's first output row at tap 0
};

// Tap k: wait for its weight slot, queue tap k + STAGES - 2's copies, wait
// for tap k - 1's products, load the warp's A fragments (its 16 rows
// shifted by k) and issue tap k's products, which are in flight on return.
// The first product overwrites the accumulators (scale-d 0).
__device__ __forceinline__ void conv_tap(float (&acc)[32], const Tile& t, int k) {
  cp_wait<STAGES - 3>();  // this thread's copies of tap k (and the halo) have landed
  fence_async_smem();     // ... visible to the tensor cores' reads
  __syncthreads();        // tap k in for all; every product of tap k - 2 is done
  const int nk = k + STAGES - 2;
  if (nk < t.K) load_tap(t.ring + (nk % STAGES) * TAP_BYTES, t.wg, t.C, nk);
  cp_commit();  // (empty past the last tap: the group count stays uniform)
  wg_wait0();   // tap k - 1's products are done: A and the accumulators are free
  hold(acc);

  const int lane = threadIdx.x & 31, r = t.row0 + k + (lane & 15);
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], t.halo + halo_at(r, 2 * kk + (lane >> 4)));
  // the k16 slice kk of the tap's B starts 2048 kk bytes in: 128 kk in the
  // descriptor's address field (bytes / 16)
  const uint64_t db = gdesc(t.ring + (k % STAGES) * TAP_BYTES, 8192, 1024);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], db + 128 * kk, k > 0 || kk > 0);
  wg_commit();
}

// One CTA: output rows t0 .. t0 + R - 1 (blockIdx.x) of group blockIdx.y,
// batch row blockIdx.z; out = mish(conv(x) + bias) (+ resid). Launch with
// NT threads and SMEM bytes of dynamic shared memory.
__global__ void __launch_bounds__(NT, 2)
pos_embed_mish_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ bias, const bf16* __restrict__ resid,
                      bf16* __restrict__ out, int T, int C, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * R, g = blockIdx.y, b = blockIdx.z;
  Tile tile;
  tile.ring = (smem_u32(smem) + 1023) & ~1023u;
  tile.halo = tile.ring + STAGES * TAP_BYTES;
  tile.wg = w + g * CPG;
  tile.C = C, tile.K = K;
  tile.row0 = wgi * 64 + warp * 16;

  // group 0: the halo rows t0 - pad .. t0 + R + K - 2 - pad, zero outside [0, T)
  const int pad = (K - 1) / 2;
  const bf16* xb = x + (size_t)b * T * C + g * CPG;
  for (int i = threadIdx.x; i < (R + K - 1) * 8; i += NT) {
    const int r = i >> 3, ch = i & 7, tt = t0 - pad + r;
    const bool in = tt >= 0 && tt < T;
    cp_async16_or_zero(tile.halo + halo_at(r, ch), xb + (size_t)(in ? tt : 0) * C + ch * 8, in);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < K) load_tap(tile.ring + s * TAP_BYTES, tile.wg, C, s);
    cp_commit();
  }

  float acc[32];
  for (int k = 0; k < K; ++k) conv_tap(acc, tile, k);
  wg_wait0();
  hold(acc);

  // acc[4 j + 2 r + e]: row tile.row0 + lane / 4 + 8 r, column 8 j + 2
  // (lane % 4) + e of the group
  const int cb = g * CPG + 2 * (lane & 3);
  float2 bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + cb + 8 * j));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tt = t0 + tile.row0 + (lane >> 2) + 8 * r;
    if (tt >= T) continue;
    const size_t o = ((size_t)b * T + tt) * C + cb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float h0 = mish(rnd(rnd(acc[4 * j + 2 * r]) + bv[j].x));
      float h1 = mish(rnd(rnd(acc[4 * j + 2 * r + 1]) + bv[j].y));
      if (resid) {
        const float2 xr =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + o + 8 * j));
        h0 = rnd(h0) + xr.x;
        h1 = rnd(h1) + xr.y;
      }
      *reinterpret_cast<uint32_t*>(out + o + 8 * j) = pack_bf16(h0, h1);
    }
  }
}

}  // namespace
}  // namespace tts

// x, scratch, out (B, T, C) bf16; w1, w2 (K, 64, C) bf16; b1, b2 (C,) bf16.
// C = 64 * groups, T >= 1, K odd and at most 33. Two launches: conv1 + mish
// into scratch, conv2 + mish + x into out.
extern "C" int conv_pos_embed_fused(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* scratch, void* out,
                                    int B, int T, int C, int K, void* stream) {
  using namespace tts;
  static int smem_set[MAX_DEVICES];
  if (B < 1 || T < 1 || C < CPG || C % CPG || K < 1 || K % 2 == 0 || K > MAXK)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      raise_attr(pos_embed_mish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM,
                 smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + R - 1) / R, C / CPG, B);
  const cudaStream_t s = (cudaStream_t)stream;
  pos_embed_mish_kernel<<<grid, NT, SMEM, s>>>((const bf16*)x, (const bf16*)w1,
                                               (const bf16*)b1, nullptr, (bf16*)scratch, T, C, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pos_embed_mish_kernel<<<grid, NT, SMEM, s>>>((const bf16*)scratch, (const bf16*)w2,
                                               (const bf16*)b2, (const bf16*)x, (bf16*)out, T,
                                               C, K);
  return (int)cudaGetLastError();
}
