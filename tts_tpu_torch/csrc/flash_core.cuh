// The port's flash-attention core for Hopper: one device-side loop over key
// tiles for bf16 q, k and v, head dim D (64 to 256, a multiple of 64),
// templated on D and on the softmax contract. Kernel 1
// (flash_attention.cu, FIXED) and kernel 5's bf16 form (flash_mha.cu,
// ONLINE) launch it, and so do kernel 16's ablations of kernel 1
// (flash_variants.cu), through two compile-time hooks of the FIXED form
// whose defaults are kernels 1 and 4's code:
//
//   Epi     EPI_F32: p in fp32 as above; EPI_BF16: the clamped and shifted
//           score rounded to bf16 and exp2 taken in bf16 by
//           ex2.approx.ftz.bf16x2 (two results an instruction, on the same
//           SFUs), l summed in fp32 over the bf16 p, which is the P.V
//           operand as it is; EPI_BF16_RCP: EPI_BF16, then o * (1 / l)
//           in place of o / l;
//   SPLIT   CTAs of one thread-block cluster sharing a row block's key
//           tiles (kernel 4's fp32 key split, flash_mha.cu): rank r takes
//           tiles [r n / SPLIT, (r + 1) n / SPLIT), leaves its O and its
//           lanes' l in shared memory, and rank 0 adds ranks 1 .. SPLIT - 1
//           to its own in rank order through distributed shared memory.
//           The FIXED sums split exactly; only their fp32 order changes.
//
//   FIXED   tts_tpu's _kernel_flat / _kernel_onepass: p = exp2(min(s * c,
//           100) - 30) on keys < kv_len[b], 0 past it; l = sum(p) + 1e-37
//           over the unrounded p; O = sum(bf16(p) v); o = O / l. Nothing is
//           rescaled, so the sums split over key tiles exactly. exp2 flushes
//           a result below 2^-126 to 0 (ex2.approx.ftz), as the TPU does, so
//           a row whose every logit is below about -66 gives 0, not NaN.
//   ONLINE  tts_tpu's _kernel: s * scale, -1e30 at masked keys before the
//           max; a running row max m from -1e30; p = exp(s - m_new), alpha =
//           exp(m - m_new), l = l alpha + sum(p), O = O alpha + bf16(p) v;
//           O / l at the end. The natural exp runs as exp2 in the log2
//           domain, c = f32(scale * log2e): exp2(s c - m c) for exp(s scale
//           - m) moves p by a few fp32 ulps, far inside the kernel's bf16
//           tolerance. With kv_len 0 every tile runs and each row is the
//           mean of v; otherwise tiles wholly past kv_len are skipped (their
//           p are 0 once a valid key has set a finite max).
//
// Design. S, P and O never leave registers. A CTA is CTA_WG warpgroups,
// each owning 64 query rows. S = Q K^T is wgmma m64n64k16 with Q and the K tile
// read from shared memory by descriptor; its fp32 accumulators give lane l
// of warp w rows 16 w + l/4 and 16 w + l/4 + 8, columns 2(l%4) and 2(l%4)+1
// of each 8-key block, so a row lives in the 4 lanes of a quad and its max
// and sum take 2 shuffles. The softmax runs on those registers; P is
// rounded to bf16 and packed straight into the register A operand of the
// wgmma for O += P V (the accumulators of two 8-key blocks are the A
// fragment of one 16-key slice), with V read from shared memory as an
// MN-major B operand, so it needs no transpose. O (D/64 x 32 registers a
// lane) and l stay in registers over the whole key loop; ONLINE rescales O
// there.
//
// Copies overlap the dots: K and V tiles of 64 keys sit in two slots each,
// filled by cp.async (16 bytes a thread) in the wgmma 128-byte swizzle
// layout; the copies for the next tile are queued right after the one
// barrier of an iteration and land while the products and the softmax run.
// The warpgroups of a CTA and the CTAs of an SM interleave one's exp2 with
// another's wgmma; no warpgroup is a producer, so none needs setmaxnreg.
// No TMA: a tensor map would be built on the host for each call's
// pointers, and cp.async already keeps the copies off the critical path.
//
// Why 2 warpgroups (128 query rows) a CTA: in trial builds on an H100
// against 1 and 3, 2 ran as fast as 3 at the F5 bench shape and fastest at
// S 8192 (3 won at D 128, whose grid then fits one wave), and each K and V
// tile feeds 128 rows, halving the L2 traffic of 64-row CTAs. At D 64 a CTA holds 49 KB of shared memory and
// 94-128 registers a thread, so 2 CTAs share an SM; capping registers for a
// third spilled and ran slower. T need only be a multiple of 64: a CTA's
// second warpgroup past T computes on repeated rows and stores nothing.
//
// What bounds it on an H100: the two products, 4 T kv D flops a head (989
// TFLOP/s bf16), and beside them one exp2 a score on the SFUs (16 a clock
// an SM, about 3.9e12 a second): at D 64 the two floors are equal.
//
// The cp.async, wgmma and descriptor primitives are wgmma.cuh's, shared
// with the DiT MLP GEMMs (dit_mlp.cu).
//
// No atomics: the result is bitwise reproducible run to run.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace tts {
namespace flash {

enum Softmax { FIXED, ONLINE };
enum Epi { EPI_F32, EPI_BF16, EPI_BF16_RCP };  // the FIXED form's softmax epilogue

constexpr int BKV = 64;   // keys a tile
constexpr float NEG = -1e30f;
// the kernels' launch shape: warpgroups (of 64 query rows) a CTA
constexpr int CTA_WG = 2;
constexpr int CTA_ROWS = 64 * CTA_WG;
constexpr int CTA_THREADS = 128 * CTA_WG;

// q, k, v and out are addressed as base + b * _b + h * _h + row * _r
// (elements); each row holds D contiguous bf16, 16-byte aligned
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  long long q_b, q_h, q_r, k_b, k_h, k_r, v_b, v_h, v_r, o_b, o_h, o_r;
  const int* kv_len;  // (B,)
  float c;            // FIXED: the logit scale in the log2 domain; ONLINE: scale * log2e
  int S;              // keys (and query rows) a head
};

// 2^x, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x of two bf16 values (lo, hi), results below 2^-126 flushed to 0
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// quad (4-lane) reductions of a row held by lanes 4g .. 4g+3
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// queue the copy of rows row0 .. row0 + 63 of `src` (pitch elements apart;
// rows past `rows` repeat the last one, their results never stored)
template <int D>
__device__ __forceinline__ void load64(uint32_t dst, const bf16* src, long long pitch,
                                       int row0, int rows) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += CTA_THREADS) {
    const int r = i / (D / 8), ch = i % (D / 8);
    cp_async16(dst + sw128(r, ch), src + min(row0 + r, rows - 1) * pitch + ch * 8);
  }
}

constexpr int ROPE_NT = 256;

// Kernel 1's RoPE pre-pass: one thread ropes 8 columns of q or k of one (b,
// t, head) of the flat (B, T, 3*H*D) qkv into the (2, B, H, T, D) scratch,
// x * cos + rot_half(x) * sin in fp32 with rot_half = [-x[D/2:], x[:D/2]],
// each product and the sum rounded once (no FMA), then rounded to bf16.
// With QSCALE, q's table entries are first multiplied by qs (rounded once;
// kernel 16's tables with the logit scale folded in); k's are not.
template <int D, bool QSCALE = false>
__global__ void __launch_bounds__(ROPE_NT)
rope_qk_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, bf16* __restrict__ qk, int B, int T, int H,
               float qs) {
  const long long i = (long long)blockIdx.x * ROPE_NT + threadIdx.x;
  if (i >= (long long)B * T * 2 * H * (D / 8)) return;
  const int c = (int)(i % (D / 8)) * 8;
  const long long rest = i / (D / 8);
  const int hh = (int)(rest % (2 * H));  // q heads, then k heads
  const long long bt = rest / (2 * H);
  const int t = (int)(bt % T), b = (int)(bt / T);
  const int pc = c < D / 2 ? c + D / 2 : c - D / 2;
  const float sign = c < D / 2 ? -1.f : 1.f;
  const int which = hh / H, h = hh % H;
  const bf16* row = qkv + bt * 3 * H * D + (long long)hh * D;
  Vec8 xv, pv, ov;
  xv.u = *reinterpret_cast<const uint4*>(row + c);
  pv.u = *reinterpret_cast<const uint4*>(row + pc);
  const float* cr = cos_t + (long long)t * D + c;
  const float* sr = sin_t + (long long)t * D + c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float cj = cr[j], sj = sr[j];
    if constexpr (QSCALE) {
      if (which == 0) cj = __fmul_rn(cj, qs), sj = __fmul_rn(sj, qs);
    }
    const float x = __fmul_rn(to_f(xv.h[j]), cj);
    const float y = __fmul_rn(sign * to_f(pv.h[j]), sj);
    ov.h[j] = to_bf(__fadd_rn(x, y));
  }
  bf16* dst = qk + ((((long long)which * B + b) * H + h) * T + t) * D + c;
  *reinterpret_cast<uint4*>(dst) = ov.u;
}

// The core's arguments for kernel 1's layout: roped q and k in the (2, B,
// H, T, D) scratch, v read in place off the flat qkv (rows 3*H*D apart),
// the packed (B, T, H*D) output
template <int D>
inline Args flat_args(const bf16* qkv, const bf16* qk, const int* kv_len, bf16* out, int B,
                      int T, int H, float c) {
  const long long head = (long long)T * D, stride = 3LL * H * D;
  Args a;
  a.q = qk;
  a.k = qk + (long long)B * H * head;
  a.q_b = a.k_b = H * head, a.q_h = a.k_h = head, a.q_r = a.k_r = D;
  a.v = qkv + 2LL * H * D;
  a.v_b = T * stride, a.v_h = D, a.v_r = stride;
  a.out = out;
  a.o_b = (long long)T * H * D, a.o_h = D, a.o_r = (long long)H * D;
  a.kv_len = kv_len;
  a.c = c;
  a.S = T;
  return a;
}

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(CTA_WG + 4) * 64 * D * sizeof(bf16);  // align slack, Q, 2 x (K, V)
}

// One CTA: query rows [blockIdx.x / SPLIT * CTA_ROWS, +CTA_ROWS) of head
// blockIdx.y of batch row blockIdx.z, 64 a warpgroup (rows past S are
// computed from a repeated row and not stored); with SPLIT > 1, its rank's
// share of the key tiles, in clusters of SPLIT along x. Launch with
// CTA_THREADS threads and smem_bytes<D>() of dynamic shared memory.
template <int D, Softmax MODE, Epi EPI = EPI_F32, int SPLIT = 1>
__device__ __forceinline__ void attend(const Args& a) {
  static_assert(D % 64 == 0 && D <= 256, "head dim a multiple of 64 up to 256");
  static_assert(MODE == FIXED || (EPI == EPI_F32 && SPLIT == 1), "hooks of the FIXED form");
  constexpr int DB = D / 64;
  constexpr uint32_t T64 = 64 * D * 2;  // bytes of one (64, D) tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x / SPLIT * CTA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rank = blockIdx.x % SPLIT;
  const uint32_t qs = base + wg * T64;     // this warpgroup's Q
  const uint32_t kv0 = base + CTA_WG * T64;  // slot s: K at kv0 + 2 s T64, V after it

  const int kvl = min(max(a.kv_len[b], 0), a.S);
  const int kv_end = (MODE == ONLINE && kvl == 0) ? a.S : kvl;
  const int all_tiles = (kv_end + BKV - 1) / BKV;
  const int t0 = rank * all_tiles / SPLIT;  // this rank's first key tile
  const int ntiles = (rank + 1) * all_tiles / SPLIT - t0;
  const bf16* kg = a.k + b * a.k_b + h * a.k_h;
  const bf16* vg = a.v + b * a.v_b + h * a.v_h;

  float o[DB][32];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  // this lane's rows g = lane / 4 and g + 8 of its warp's 16: its share of
  // l (the quad sums it at the end) and, ONLINE, the row max (log2 domain)
  float l[2] = {0.f, 0.f}, m[2] = {NEG, NEG};

  if (ntiles > 0) {
    const bf16* qg = a.q + b * a.q_b + h * a.q_h;
#pragma unroll
    for (int w = 0; w < CTA_WG; ++w) load64<D>(base + w * T64, qg, a.q_r, q0 + 64 * w, a.S);
    load64<D>(kv0, kg, a.k_r, t0 * BKV, a.S);
    load64<D>(kv0 + T64, vg, a.v_r, t0 * BKV, a.S);
    cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (t0 + it) * BKV;
    cp_wait_all();
    fence_async_smem();  // this thread's copies, visible to the tensor cores' reads
    __syncthreads();     // tile it in for all; every warpgroup is done with tile it - 1
    if (it + 1 < ntiles) {
      const uint32_t st = kv0 + ((it + 1) & 1) * 2 * T64;
      load64<D>(st, kg, a.k_r, k0 + BKV, a.S);
      load64<D>(st + T64, vg, a.v_r, k0 + BKV, a.S);
      cp_commit();
    }
    const uint32_t ks = kv0 + (it & 1) * 2 * T64, vs = ks + T64;

    // S = Q K^T: 64 rows x 64 keys a warpgroup, fp32 in registers
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hold(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
      wgmma_ss(s, gdesc(qs + off, 16, 1024), gdesc(ks + off, 16, 1024), kk);
    }
    wg_commit();
    wg_wait0();
    hold(s);

    // softmax on the accumulators: s[4 j + e] is row 16 warp + g + 8 (e / 2)
    // of the warpgroup, key k0 + 8 j + 2 (lane % 4) + e % 2
    const int key0 = k0 + 2 * (lane & 3);
    if constexpr (EPI != EPI_F32) {
      // keys key0 + 8 (i / 4) and the next one: one bf16 pair, p left in
      // s[i] as its bits (s[i + 1] unused)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = key0 + 8 * (i >> 2);
        uint32_t p = ex2_bf16x2(
            pack_bf16(fminf(s[i] * a.c, 100.f) - 30.f, fminf(s[i + 1] * a.c, 100.f) - 30.f));
        if (key >= kvl) p &= 0xffff0000u;
        if (key + 1 >= kvl) p &= 0x0000ffffu;
        l[(i >> 1) & 1] += bf16_lo(p);
        l[(i >> 1) & 1] += bf16_hi(p);
        s[i] = __uint_as_float(p);
      }
    } else if (MODE == FIXED) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = key0 + 8 * (i >> 2) + (i & 1) < kvl
                            ? ex2(fminf(s[i] * a.c, 100.f) - 30.f)
                            : 0.f;
        l[(i >> 1) & 1] += p;
        s[i] = p;
      }
    } else {
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float v = key0 + 8 * (i >> 2) + (i & 1) < kvl ? s[i] * a.c : NEG;
        s[i] = v;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = ex2(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int j = 0; j < DB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
    }

    // O += bf16(P) V: keys 16 kk .. 16 kk + 15 are accumulators 8 kk .. 8 kk + 7
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = EPI != EPI_F32 ? __float_as_uint(s[8 * kk + 2 * i])
                                   : pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
#pragma unroll
    for (int j = 0; j < DB; ++j) hold(o[j]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < DB; ++j)
        wgmma_rs(o[j], pa[kk], gdesc(vs + j * 8192 + kk * 2048, 8192, 1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < DB; ++j) hold(o[j]);
  }

  if constexpr (SPLIT > 1) {
    // ranks 1 .. SPLIT - 1 leave O and l in their shared memory (thread-
    // major, as this thread holds them; the tiles are done with: every
    // copy has landed and every product retired), rank 0 adds them in rank
    // order
    static_assert((DB * 32 + 2) * CTA_THREADS * 4 <= (CTA_WG + 4) * T64, "room for O and l");
    float* po = reinterpret_cast<float*>(smem + (base - smem_u32(smem)));
    float* pl = po + DB * 32 * CTA_THREADS;
    __syncthreads();
    if (rank != 0) {
#pragma unroll
      for (int j = 0; j < DB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) po[(j * 32 + i) * CTA_THREADS + threadIdx.x] = o[j][i];
      pl[threadIdx.x] = l[0];
      pl[CTA_THREADS + threadIdx.x] = l[1];
    }
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int rr = 1; rr < SPLIT; ++rr) {
        const float* ro = cluster.map_shared_rank(po, rr);
        const float* rl = cluster.map_shared_rank(pl, rr);
#pragma unroll
        for (int j = 0; j < DB; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[j][i] += ro[(j * 32 + i) * CTA_THREADS + threadIdx.x];
        l[0] += rl[threadIdx.x];
        l[1] += rl[CTA_THREADS + threadIdx.x];
      }
    }
    cluster.sync();  // no rank's shared memory goes before rank 0 has read it
    if (rank != 0) return;
  }

  // o / l (EPI_BF16_RCP: o * (1 / l)), rounded to bf16: rows g and g + 8 of
  // the warp's 16, columns 64 j + 8 jj + 2 (lane % 4)
  float lt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = quad_sum(l[r]) + (MODE == FIXED ? 1e-37f : 0.f);
    if constexpr (EPI == EPI_BF16_RCP) lt[r] = 1.f / lt[r];
  }
  const int row = q0 + wg * 64 + warp * 16 + (lane >> 2);
  bf16* ob = a.out + b * a.o_b + h * a.o_h + 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= a.S) continue;
    bf16* orow = ob + (long long)(row + 8 * r) * a.o_r;
#pragma unroll
    for (int j = 0; j < DB; ++j)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(orow + 64 * j + 8 * jj) =
            EPI == EPI_BF16_RCP
                ? pack_bf16(__fmul_rn(o[j][4 * jj + 2 * r], lt[r]),
                            __fmul_rn(o[j][4 * jj + 2 * r + 1], lt[r]))
                : pack_bf16(o[j][4 * jj + 2 * r] / lt[r], o[j][4 * jj + 2 * r + 1] / lt[r]);
  }
}

}  // namespace flash
}  // namespace tts
