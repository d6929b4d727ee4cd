// The port's flash-attention core for Hopper: one device-side loop over key
// tiles for bf16 q, k and v, head dim D (64 to 256, a multiple of 64),
// templated on D and on the softmax contract. Kernel 1
// (flash_attention.cu, FIXED) and kernel 5's bf16 form (flash_mha.cu,
// ONLINE) launch it.
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

#include "common.cuh"
#include "wgmma.cuh"

namespace tts {
namespace flash {

enum Softmax { FIXED, ONLINE };

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

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(CTA_WG + 4) * 64 * D * sizeof(bf16);  // align slack, Q, 2 x (K, V)
}

// One CTA: query rows [blockIdx.x * CTA_ROWS, +CTA_ROWS) of head blockIdx.y
// of batch row blockIdx.z, 64 a warpgroup (rows past S are computed from a
// repeated row and not stored). Launch with CTA_THREADS threads and
// smem_bytes<D>() of dynamic shared memory.
template <int D, Softmax MODE>
__device__ __forceinline__ void attend(const Args& a) {
  static_assert(D % 64 == 0 && D <= 256, "head dim a multiple of 64 up to 256");
  constexpr int DB = D / 64;
  constexpr uint32_t T64 = 64 * D * 2;  // bytes of one (64, D) tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * CTA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const uint32_t qs = base + wg * T64;     // this warpgroup's Q
  const uint32_t kv0 = base + CTA_WG * T64;  // slot s: K at kv0 + 2 s T64, V after it

  const int kvl = min(max(a.kv_len[b], 0), a.S);
  const int kv_end = (MODE == ONLINE && kvl == 0) ? a.S : kvl;
  const int ntiles = (kv_end + BKV - 1) / BKV;
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
    load64<D>(kv0, kg, a.k_r, 0, a.S);
    load64<D>(kv0 + T64, vg, a.v_r, 0, a.S);
    cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BKV;
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
    if (MODE == FIXED) {
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
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
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

  // o / l, rounded to bf16: rows g and g + 8 of the warp's 16, columns
  // 64 j + 8 jj + 2 (lane % 4)
  float lt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lt[r] = quad_sum(l[r]) + (MODE == FIXED ? 1e-37f : 0.f);
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
            pack_bf16(o[j][4 * jj + 2 * r] / lt[r], o[j][4 * jj + 2 * r + 1] / lt[r]);
  }
}

}  // namespace flash
}  // namespace tts
