// Flash attention on roped (B, H, S, D) q, k and v, for the F5 DiT's head
// geometries that the flat kernel does not take, for fp32, and for
// sequences past it.
//
// Replaces two paths of tts_tpu/ops/flash_attention.py:flash_attention:
//   * kernel 4, the single pass (Pallas body _kernel_onepass): the whole key
//     row at once, s * f32(scale * log2e) clamped at +100 plus a bias row of
//     -30 (valid keys) or -1e30 (keys >= kv_len[b]), exp2 with no row max,
//     l = sum(p) + 1e-37, P.V with P in v's dtype, then o / l; output (B, H,
//     S, D) or packed (B, S, H*D);
//   * kernel 5, the online softmax (Pallas body _kernel): scores times
//     scale, -1e30 at masked keys before a running row max m (from -1e30),
//     p = exp(s - m_new), alpha = exp(m - m_new), l = l alpha + sum(p),
//     acc = acc alpha + P.V, acc / l at the end.
// Both take bf16 or fp32, with D a multiple of 64 up to 256. Kv tiles
// wholly past kv_len are skipped: their p are exact zeros in kernel 4, and
// in kernel 5 too once a valid key has set a finite max (kv_len >= 1). With
// kv_len 0, kernel 5 runs every tile, so each row gets the mean of v over
// all S keys (every score is -1e30, as in tts_tpu), while kernel 4 gives
// zeros (its 1e-37 guard).
//
// bf16: both kernels are the flash core (flash_core.cuh), kernel 4 in its
// FIXED mode (kernel 1's contract) and kernel 5 in ONLINE mode, addressed
// through strides, so kernel 4's packed output is only other strides. S, P
// and O stay in registers (wgmma), K and V tiles arrive by cp.async one
// tile ahead. Bound on an H100: the two products, 4 S kv_len D flops a
// head at 989 TFLOP/s, and beside them one exp2 a score on the SFUs.
//
// fp32 (true fp32 products on the CUDA cores, no TF32): one template for
// both softmax contracts, mha_f32_kernel<D, ONLINE>. Bound: the same 4 S
// kv_len D flops at 67 TFLOP/s, so the design feeds the FMA pipes and
// keeps shared memory off the critical path:
//   * register tiles: a thread owns RT query rows (ty + 16 i) and, for S =
//     Q K^T, 4 keys of a 32-key tile (tx + 8 j); for O += P V the same rows
//     and D / 8 columns (4 tx + 32 c .. + 3). Operands come as float4 along
//     D (S) or along the keys (P) from rows padded to D + 4 (and 32 + 8)
//     floats: 16-byte aligned, the 8 rows a warp reads at once on distinct
//     banks, and the 4 rows it shares broadcast; no transpose. At D 64 (RT
//     8) S takes 12 float4 loads for 128 FMAs and P.V 16 for 256;
//   * K and V tiles arrive by cp.async (16 bytes a thread) in two slots
//     each, the next tile's copies queued right after the one barrier of an
//     iteration, so they land while this tile's products run;
//   * P crosses lanes through shared memory, but only within a warp (a
//     warp's 8 tx lanes hold all keys of its rows): a __syncwarp, no block
//     barrier; each row's max (ONLINE) takes 3 shuffles over those lanes,
//     and l is a lane's partial sum until the end;
//   * rows a CTA: 128 at D 64 (2 CTAs an SM, 90 KB of shared memory each;
//     in trial builds 128 rows ran faster than 64 at kernel 5's shape),
//     64 at D >= 128, where an O tile of 128 rows would not fit in
//     registers. 128 threads a CTA;
//   * kernel 4's sums split exactly (no row max), so where the row blocks
//     would leave the card's last wave part empty (the F5 bench shape: 352
//     CTAs on 2 x 132 slots), 2 or 4 CTAs of one thread-block cluster share
//     a row block's key tiles (f32_splits); each leaves its O and l in its
//     shared memory, and rank 0 adds them in rank order through distributed
//     shared memory. Kernel 5 fills the card at the lengths that reach it.
// The exps are those of tts_tpu's fp32 bodies: exp2f in kernel 4 (keeping
// denormal p, as the twin does), expf in kernel 5. Every sum runs in a
// fixed order, with no atomics: bitwise reproducible run to run.
#include <cooperative_groups.h>

#include "flash_core.cuh"

namespace tts {
namespace {

namespace cg = cooperative_groups;

constexpr float NEG = -1e30f;

struct MhaArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;  // (B,)
  void* out;
  float c;            // kernel 4: f32(scale * log2e); kernel 5: scale
  int H, S, packed;
  int splits;         // fp32 kernel 4: CTAs (one cluster) sharing a row block's keys
};

// element offset of (b, h, row, 0) in the output
template <int D>
__device__ __forceinline__ size_t out_offset(const MhaArgs& a, int b, int h, int row) {
  return a.packed ? (((size_t)b * a.S + row) * a.H + h) * D
                  : (((size_t)b * a.H + h) * a.S + row) * D;
}

// ------------------------------------------------------------------ bf16

template <int D>
__global__ void __launch_bounds__(flash::CTA_THREADS) mha_fixed_kernel(const flash::Args a) {
  flash::attend<D, flash::FIXED>(a);
}

template <int D>
__global__ void __launch_bounds__(flash::CTA_THREADS) mha_online_kernel(const flash::Args a) {
  flash::attend<D, flash::ONLINE>(a);
}

// the core on contiguous (B, H, S, D) q, k, v; out (B, H, S, D) or packed
// (B, S, H*D)
template <int D, flash::Softmax MODE>
int launch_bf16(const MhaArgs& m, int B, cudaStream_t stream) {
  const auto kernel = MODE == flash::ONLINE ? mha_online_kernel<D> : mha_fixed_kernel<D>;
  constexpr size_t smem = flash::smem_bytes<D>();
  static int smem_set[MAX_DEVICES];
  const cudaError_t err =
      raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long head = (long long)m.S * D;
  flash::Args a;
  a.q = static_cast<const bf16*>(m.q);
  a.k = static_cast<const bf16*>(m.k);
  a.v = static_cast<const bf16*>(m.v);
  a.out = static_cast<bf16*>(m.out);
  a.q_b = a.k_b = a.v_b = a.o_b = m.H * head;  // packed: S * H * D as well
  a.q_h = a.k_h = a.v_h = head;
  a.q_r = a.k_r = a.v_r = D;
  a.o_h = m.packed ? D : head;
  a.o_r = m.packed ? (long long)m.H * D : D;
  a.kv_len = m.kv_len;
  // FIXED takes kernel 4's f32(scale * log2e) as it is; ONLINE works in the
  // log2 domain, scale * log2e
  a.c = MODE == flash::ONLINE ? (float)((double)m.c * 1.4426950408889634) : m.c;
  a.S = m.S;
  const int tiles = (m.S + flash::CTA_ROWS - 1) / flash::CTA_ROWS;
  kernel<<<dim3(tiles, m.H, B), flash::CTA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

constexpr int NT32 = 128;  // threads a CTA: ty = 4 warp + lane / 8 (16), tx = lane % 8

template <int D>
struct F32Shape {
  static constexpr int RT = D == 64 ? 8 : 4;   // query rows a thread
  static constexpr int BQ = 16 * RT;           // query rows a CTA
  static constexpr int BKV = 32;               // keys a tile
  static constexpr int LDQ = D + 4;            // pitch of q, k, v rows (floats)
  static constexpr int LDP = BKV + 8;          // pitch of p rows
  static constexpr size_t smem =
      ((size_t)BQ * LDQ + 4 * (size_t)BKV * LDQ + (size_t)BQ * LDP) * sizeof(float);
  // CTAs an SM by shared memory (228 KB, 1 KB of it reserved a CTA), at most 3
  static constexpr int CTAS = (int)(228 * 1024 / (smem + 1024)) < 3
                                  ? (int)(228 * 1024 / (smem + 1024)) : 3;
};

// queue the copy of rows row0 .. row0 + ROWS - 1 of a (S, D) fp32 head into
// shared rows of pitch D + 4 (rows past S repeat the last; never stored)
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT32) {
    const int r = i / CH, ch = i % CH;
    cp_async16(smem_u32(dst + r * F32Shape<D>::LDQ + ch * 4),
                      src + (size_t)min(row0 + r, S - 1) * D + ch * 4);
  }
}

template <int D, bool ONLINE>
__global__ void __launch_bounds__(NT32, F32Shape<D>::CTAS) mha_f32_kernel(const MhaArgs a) {
  using Sh = F32Shape<D>;
  constexpr int RT = Sh::RT, BQ = Sh::BQ, BKV = Sh::BKV, LDQ = Sh::LDQ, LDP = Sh::LDP;
  constexpr int KJ = BKV / 8, DC = D / 32;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;                   // (BQ, LDQ)
  float* kvs = qs + BQ * LDQ;        // slot s: K at kvs + 2 s BKV LDQ, V after it
  float* ps = kvs + 4 * BKV * LDQ;   // (BQ, LDP): each warp's rows, its p

  // the `splits` CTAs of a cluster (consecutive in x) share one row block;
  // rank r takes its key tiles [r n / splits, (r + 1) n / splits)
  const int splits = ONLINE ? 1 : a.splits, rank = blockIdx.x % splits;
  const int q0 = blockIdx.x / splits * BQ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, tx = lane & 7, ty = (threadIdx.x >> 5) * 4 + (lane >> 3);
  const size_t head = ((size_t)b * a.H + h) * a.S * D;
  const float* qg = static_cast<const float*>(a.q) + head;
  const float* kg = static_cast<const float*>(a.k) + head;
  const float* vg = static_cast<const float*>(a.v) + head;
  const int kvl = min(max(a.kv_len[b], 0), a.S);
  const int kv_end = ONLINE && kvl == 0 ? a.S : kvl;
  const int all_tiles = (kv_end + BKV - 1) / BKV;
  const int t0 = rank * all_tiles / splits;
  const int ntiles = (rank + 1) * all_tiles / splits - t0;

  float o[RT][DC][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  // this lane's share of each row's l, and (ONLINE) the row's running max
  float l[RT], m[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) l[i] = 0.f, m[i] = NEG;

  if (ntiles > 0) {
    load_rows<D, BQ>(qs, qg, q0, a.S);
    load_rows<D, BKV>(kvs, kg, t0 * BKV, a.S);
    load_rows<D, BKV>(kvs + BKV * LDQ, vg, t0 * BKV, a.S);
    cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (t0 + it) * BKV;
    cp_wait_all();
    __syncthreads();  // tile it in for all; every warp is done with tile it - 1
    if (it + 1 < ntiles) {
      float* st = kvs + ((it + 1) & 1) * 2 * BKV * LDQ;
      load_rows<D, BKV>(st, kg, k0 + BKV, a.S);
      load_rows<D, BKV>(st + BKV * LDQ, vg, k0 + BKV, a.S);
      cp_commit();
    }
    const float* ks = kvs + (it & 1) * 2 * BKV * LDQ;
    const float* vs = ks + BKV * LDQ;

    // S = Q K^T: rows ty + 16 i, keys k0 + tx + 8 j, summed over d in order
    float s[RT][KJ];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kb[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qa.x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa.y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa.z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa.w, kb[j].w, s[i][j]);
        }
      }
    }

    // the softmax on the registers; p to this warp's rows of ps
    const int key = k0 + tx;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (ONLINE) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = key + 8 * j < kvl ? s[i][j] * a.c : NEG;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float mn = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          l[i] += s[i][j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
      } else {
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = exp2f(fminf(s[i][j] * a.c, 100.f) + (key + 8 * j < kvl ? -30.f : NEG));
          l[i] += s[i][j];
        }
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) ps[(ty + 16 * i) * LDP + tx + 8 * j] = s[i][j];
    }
    __syncwarp();  // the warp's p rows in

    // O += P V: keys in order, 4 at a time
#pragma unroll 2
    for (int n = 0; n < BKV; n += 4) {
      float4 pa[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LDP + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 vb =
              *reinterpret_cast<const float4*>(vs + (n + nn) * LDQ + 4 * tx + 32 * c);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float p = nn == 0 ? pa[i].x : nn == 1 ? pa[i].y : nn == 2 ? pa[i].z : pa[i].w;
            o[i][c][0] = fmaf(p, vb.x, o[i][c][0]);
            o[i][c][1] = fmaf(p, vb.y, o[i][c][1]);
            o[i][c][2] = fmaf(p, vb.z, o[i][c][2]);
            o[i][c][3] = fmaf(p, vb.w, o[i][c][3]);
          }
        }
      }
    }
  }

  // l over the row's 8 lanes
  float lt[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    lt[i] = l[i];
    lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 1);
    lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 2);
    lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 4);
  }

  if (!ONLINE && splits > 1) {
    // FIXED sums split exactly: each rank leaves its O and l in its shared
    // memory (thread-major, as this thread holds them) and rank 0 adds
    // ranks 1 .. splits - 1 to its own, in rank order
    constexpr int NO = RT * DC * 4;
    __syncthreads();  // every warp is done with its tiles' shared memory
    float* po = smf;
    float* pl = po + NO * NT32;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          po[((i * DC + c) * 4 + e) * NT32 + threadIdx.x] = o[i][c][e];
      pl[i * NT32 + threadIdx.x] = lt[i];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < splits; ++r) {
        const float* ro = cluster.map_shared_rank(po, r);
        const float* rl = cluster.map_shared_rank(pl, r);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int c = 0; c < DC; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][c][e] += ro[((i * DC + c) * 4 + e) * NT32 + threadIdx.x];
          lt[i] += rl[i * NT32 + threadIdx.x];
        }
      }
    }
    cluster.sync();  // no rank's shared memory goes before rank 0 has read it
    if (rank != 0) return;
  }

  // o / l
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float li = ONLINE ? lt[i] : lt[i] + 1e-37f;
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    float* orow = out + out_offset<D>(a, b, h, row) + 4 * tx;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<float4*>(orow + 32 * c) =
          make_float4(o[i][c][0] / li, o[i][c][1] / li, o[i][c][2] / li, o[i][c][3] / li);
  }
}

// Kernel 4's split: the CTAs that share a row block's keys, 1, 2 or 4 (a
// cluster of 3 placed worse in trial builds on an H100), at most a quarter
// of the key tiles, chosen to fill the card's CTA slots in whole waves
// (units * splits over SMs * CTAs an SM); the smaller on a tie.
int f32_splits(long long units, int ctas_per_sm, int tiles) {
  const int sms = sm_count();  // the current device's
  if (sms == 0) return 1;
  const long long slots = (long long)sms * ctas_per_sm;
  int best = 1;
  double best_fill = 0.0;
  for (int f = 1; f <= 4 && (f == 1 || 4 * f <= tiles); f *= 2) {
    const long long n = units * f, waves = (n + slots - 1) / slots;
    const double fill = (double)n / (double)(waves * slots);
    if (fill > best_fill + 1e-9) best = f, best_fill = fill;
  }
  return best;
}

template <int D, bool ONLINE>
int launch_f32(const MhaArgs& m, int B, cudaStream_t stream) {
  using Sh = F32Shape<D>;
  static int smem_set[MAX_DEVICES];
  const cudaError_t err = raise_attr(
      mha_f32_kernel<D, ONLINE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::smem,
      smem_set);
  if (err != cudaSuccess) return (int)err;
  MhaArgs a = m;
  const int rows = (a.S + Sh::BQ - 1) / Sh::BQ;
  a.splits = ONLINE ? 1 : f32_splits((long long)rows * a.H * B, Sh::CTAS, a.S / Sh::BKV);
  const dim3 grid(rows * a.splits, a.H, B);
  if (a.splits == 1) {
    mha_f32_kernel<D, ONLINE><<<grid, NT32, Sh::smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)launch_cluster(mha_f32_kernel<D, ONLINE>, grid, NT32, Sh::smem, stream,
                             a.splits, a);
}

// ---------------------------------------------------------------- launch

template <bool ONLINE>
int launch(const MhaArgs& a, int B, int D, int fp32, cudaStream_t s) {
  constexpr flash::Softmax MODE = ONLINE ? flash::ONLINE : flash::FIXED;
  if (a.S < 64 || a.S % 64) return (int)cudaErrorInvalidValue;
  switch (D * 2 + (fp32 ? 1 : 0)) {
    case 128: return launch_bf16<64, MODE>(a, B, s);
    case 129: return launch_f32<64, ONLINE>(a, B, s);
    case 256: return launch_bf16<128, MODE>(a, B, s);
    case 257: return launch_f32<128, ONLINE>(a, B, s);
    case 384: return launch_bf16<192, MODE>(a, B, s);
    case 385: return launch_f32<192, ONLINE>(a, B, s);
    case 512: return launch_bf16<256, MODE>(a, B, s);
    case 513: return launch_f32<256, ONLINE>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

MhaArgs make_args(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                  float c, int H, int S, int packed) {
  MhaArgs a;
  a.q = q, a.k = k, a.v = v, a.kv_len = (const int*)kv_len, a.out = out;
  a.c = c, a.H = H, a.S = S, a.packed = packed, a.splits = 1;
  return a;
}

}  // namespace
}  // namespace tts

// q, k, v (B, H, S, D), bf16 (fp32 = 0) or fp32 (fp32 = 1); kv_len (B,)
// int32; out (B, H, S, D), or (B, S, H*D) with packed = 1, in q's dtype.
// c = f32(scale * log2e). D in {64, 128, 192, 256}; S a multiple of 64.
extern "C" int flash_attention_onepass(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* out, float c, int B,
                                       int H, int S, int D, int fp32, int packed,
                                       void* stream) {
  return tts::launch<false>(tts::make_args(q, k, v, kv_len, out, c, H, S, packed), B, D,
                            fp32, (cudaStream_t)stream);
}

// As flash_attention_onepass with c = scale; packed must be 0.
extern "C" int flash_attention_online(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, float c, int B,
                                      int H, int S, int D, int fp32, int packed,
                                      void* stream) {
  if (packed) return (int)cudaErrorInvalidValue;
  return tts::launch<true>(tts::make_args(q, k, v, kv_len, out, c, H, S, 0), B, D, fp32,
                           (cudaStream_t)stream);
}
