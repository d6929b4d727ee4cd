// Decode-step GQA attention over the live rows of a static KV cache: q
// (B, H, D) against the layer's (B, KVH, T, D) k/v buffers, rows < kv_len
// only (kv_len counts the step's own appended row).
//
// Replaces tts_tpu/ops/decode_attention.py:decode_gqa_attention (Pallas
// body _kernel). Same numerics: fp32 scores (times `scale` when it is not
// 1), softmax statistics in fp32 with the denominator summed from the
// unrounded p = exp(s - m), p rounded to bf16 for the P.V product with fp32
// accumulation, (acc / l) rounded to bf16 once. The TPU kernel walks blocks
// of up to 256 rows in order with a running max; here the rows split into
// contiguous slices, each with its own max, merged at the end, so p rounds
// to bf16 at another max: the same sums, other bf16 roundings.
//
// What bounds it on an H100: the live k/v rows, 2 x kv_len x D x 2 bytes a
// kv head (0.5 MB a layer at Qwen's 8 kv heads x 128 and kv_len 126), read
// once; the products are 4 x H x kv_len x D operations, far below the
// tensor cores' line. At decode sizes that is a fraction of a microsecond,
// so the kernel is latency-bound: one launch, every load in flight at once,
// few barriers and shuffles.
//
// Design: one CTA, or one thread-block cluster of up to 8 CTAs (the
// portable cluster size), for each (kv head, batch row); the wrapper's
// cluster_plan picks the split from kv_len (one CTA up to 128 rows: in
// trial builds a cluster's launch and merge cost more than they saved
// there). CTA r takes the live rows r * rows .. min((r + 1) * rows,
// kv_len) - 1. In a CTA, a group of D / 8 lanes covers one row with
// 16-byte loads (8 bf16 a lane), q in registers. Up to 8 rows a group are
// loaded at once (128 rows a round at D 128, 256 at D 64; half that at G >
// 4); when the slice fits one round its K and V loads are all issued up
// front, else pass 1 reads K round by round and pass 2 reads V. The dot
// products of a group's rows and the G q heads are summed over the group
// by a transposing butterfly (n values over the group in n - 1 shuffles).
// The scores wait in shared memory for the slice's max, which every warp
// takes for itself; then p = exp(s - m) per q head in registers, l summed
// from the unrounded p, P rounded to bf16 for P.V, and the sums over the
// warps in a fixed order. A lone CTA writes out = acc / l. In a cluster
// each CTA leaves (m, l, acc[G][D]) in its own shared memory; after
// cluster.sync(), rank 0 reads ranks 0 .. ctas - 1 through distributed
// shared memory in rank order, scales each by exp(m_i - M) and writes out
// = sum acc / sum l; a second cluster.sync() keeps every CTA's shared
// memory alive until rank 0 has read it. One launch at every kv_len, no
// scratch in device memory, no atomics (bitwise reproducible runs), rows
// >= kv_len never read.
#include <cooperative_groups.h>

#include "decode_rows.cuh"

namespace tts {
namespace {

namespace cg = cooperative_groups;

constexpr int DA_THREADS = 256;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_MAX_G = 8;
constexpr int DA_MAX_CTAS = 8;  // the portable cluster size
constexpr int SMEM_MAX = 232448;

struct DaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int KVH, T, kv_len, rows;  // rows: the live rows a CTA takes (the last fewer)
  float scale;
};

// shared memory, in floats: what rank 0 reads (acc [G][HD], m [G], l [G]),
// then the per-warp sums ([DA_WARPS][G][HD] acc, [DA_WARPS][G] l) and the
// slice's scores [G][rows]
template <int HD, int G>
constexpr size_t da_smem_floats(int rows) {
  return (size_t)(1 + DA_WARPS) * G * HD + 2 * G + DA_WARPS * G + (size_t)G * rows;
}

template <int HD, int G>
__global__ void __launch_bounds__(DA_THREADS) cluster_kernel(const DaArgs a) {
  constexpr int LG = HD / 8;           // lanes a row
  constexpr int NG = DA_THREADS / LG;  // lane groups
  constexpr int U = G <= 4 ? 8 : 4;    // rows a group loads at once (registers)
  constexpr int GP = G <= 2 ? G : G <= 4 ? 4 : 8;  // G padded to a power of two
  constexpr int RR = NG * U;           // rows a round: 128 at D 128, 256 at D 64
  extern __shared__ __align__(16) float sm[];
  float* acc_s = sm;
  float* m_s = acc_s + G * HD;
  float* l_s = m_s + G;
  float* wacc = l_s + G;
  float* wl = wacc + DA_WARPS * G * HD;
  float* sc = wl + DA_WARPS * G;

  // one CTA (the short slices of a predictor step) launches without a
  // cluster and writes its output itself
  const int nct = gridDim.x;
  const int rank = nct > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, li = tid % LG, grp = tid / LG;
  const int r0 = rank * a.rows;
  const int n = min(a.kv_len - r0, a.rows);  // >= 1: the plan leaves no slice empty
  const size_t head = (size_t)b * a.KVH + j;
  const bf16* kj = a.k + (head * a.T + r0) * HD + li * 8;
  const bf16* vj = a.v + (head * a.T + r0) * HD + li * 8;
  const int rounds = (n + RR - 1) / RR;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Vec8 x;
    x.u = *reinterpret_cast<const uint4*>(a.q + (head * G + g) * HD + li * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] = to_f(x.h[e]);
  }

  // pass 1: scores of the slice into shared memory
  uint4 kr[U], vr[U];
  for (int rd = 0; rd < rounds; ++rd) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = rd * RR + u * NG + grp;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t < n) {
        kr[u] = *reinterpret_cast<const uint4*>(kj + (size_t)t * HD);
        if (rounds == 1) vr[u] = *reinterpret_cast<const uint4*>(vj + (size_t)t * HD);
      }
    }
    // the group's rows this round: fewer rows take a smaller butterfly
    const int t0 = rd * RR, need = min(U, (n - t0 + NG - 1) / NG);
    if (need > U / 2)
      round_scores<LG, NG, G, GP, U>(kr, qf, li, grp, t0, n, sc, a.rows, a.scale);
    else if (need > U / 4)
      round_scores<LG, NG, G, GP, U / 2>(kr, qf, li, grp, t0, n, sc, a.rows, a.scale);
    else
      round_scores<LG, NG, G, GP, U / 4>(kr, qf, li, grp, t0, n, sc, a.rows, a.scale);
  }
  __syncthreads();

  // the slice's max per q head, each warp over every score (no barrier)
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int t = lane; t < n; t += 32) v = fmaxf(v, sc[g * a.rows + t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    mx[g] = v;
  }

  // pass 2: p = exp(s - m); l from the unrounded p, P.V from bf16(p)
  float acc[G][8], lsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int rd = 0; rd < rounds; ++rd) {
    if (rounds > 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = rd * RR + u * NG + grp;
        if (t < n) vr[u] = *reinterpret_cast<const uint4*>(vj + (size_t)t * HD);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = rd * RR + u * NG + grp;
      if (t >= n) break;
      Vec8 vx;
      vx.u = vr[u];
      float vf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[e] = to_f(vx.h[e]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(sc[g * a.rows + t] - mx[g]);
        lsum[g] += p;
        const float pr = rnd(p);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
    }
  }

  // the CTA's sums: over the lane groups of a warp by shuffles (lanes li,
  // li + LG, ... hold the same columns), then over the warps in order
#pragma unroll
  for (int off = LG; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], off);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  if (lane < LG) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[(warp * G + g) * HD + li * 8 + e] = acc[g][e];
      if (li == 0) wl[warp * G + g] = lsum[g];
    }
  }
  __syncthreads();
  if (nct == 1) {
    for (int i = tid; i < G * HD; i += DA_THREADS) {
      float s = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w) {
        s += wacc[w * G * HD + i];
        l += wl[w * G + i / HD];
      }
      a.out[head * G * HD + i] = to_bf(s / l);
    }
    return;
  }
  for (int i = tid; i < G * HD; i += DA_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) s += wacc[w * G * HD + i];
    acc_s[i] = s;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w) s += wl[w * G + g];
      l_s[g] = s;
      m_s[g] = mx[g];
    }
  }

  // the merge: rank 0 reads every CTA's (m, l, acc) in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < G * HD; i += DA_THREADS) {
      const int g = i / HD;
      float M = __int_as_float(static_cast<int>(0xff800000u));
      for (int r = 0; r < nct; ++r) M = fmaxf(M, cluster.map_shared_rank(m_s, r)[g]);
      float L = 0.f, A = 0.f;
      for (int r = 0; r < nct; ++r) {
        const float w = expf(cluster.map_shared_rank(m_s, r)[g] - M);
        L += cluster.map_shared_rank(l_s, r)[g] * w;
        A += cluster.map_shared_rank(acc_s, r)[i] * w;
      }
      a.out[head * G * HD + i] = to_bf(A / L);
    }
  }
  cluster.sync();  // no CTA's shared memory goes before rank 0 has read it
}

template <int HD, int G>
int launch(const DaArgs& a, int B, int ctas, cudaStream_t st) {
  const size_t smem = sizeof(float) * da_smem_floats<HD, G>(a.rows);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int allowed[MAX_DEVICES];
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_attr(
        cluster_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem, allowed);
    if (err != cudaSuccess) return (int)err;
  }
  if (ctas == 1) {
    cluster_kernel<HD, G><<<dim3(1, a.KVH, B), DA_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)launch_cluster(cluster_kernel<HD, G>, dim3(ctas, a.KVH, B), DA_THREADS, smem,
                             st, ctas, a);
}

template <int HD>
int launch_hd(const DaArgs& a, int B, int G, int ctas, cudaStream_t st) {
  switch (G) {
    case 1: return launch<HD, 1>(a, B, ctas, st);
    case 2: return launch<HD, 2>(a, B, ctas, st);
    case 3: return launch<HD, 3>(a, B, ctas, st);
    case 4: return launch<HD, 4>(a, B, ctas, st);
    case 5: return launch<HD, 5>(a, B, ctas, st);
    case 6: return launch<HD, 6>(a, B, ctas, st);
    case 7: return launch<HD, 7>(a, B, ctas, st);
    case 8: return launch<HD, 8>(a, B, ctas, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tts

// q (B, KVH*G, hd) bf16; k, v (B, KVH, T, hd) bf16; out like q. hd 64 or
// 128, G <= 8, 1 <= kv_len <= T. The live rows split into `ctas` (1 to 8)
// slices of `rows`, the last one shorter and none empty (the wrapper's
// cluster_plan); the slice's scores need G * rows floats of shared memory.
extern "C" int decode_gqa_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int KVH, int G, int T, int kv_len, int ctas,
                                    int rows, int hd, float scale, void* stream) {
  if (G < 1 || G > tts::DA_MAX_G || kv_len < 1 || kv_len > T || ctas < 1 ||
      ctas > tts::DA_MAX_CTAS || rows < 1 || (long long)ctas * rows < kv_len ||
      (long long)(ctas - 1) * rows >= kv_len)
    return (int)cudaErrorInvalidValue;
  tts::DaArgs a;
  a.q = (const tts::bf16*)q;
  a.k = (const tts::bf16*)k;
  a.v = (const tts::bf16*)v;
  a.out = (tts::bf16*)out;
  a.KVH = KVH, a.T = T, a.kv_len = kv_len, a.rows = rows, a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return tts::launch_hd<64>(a, B, G, ctas, st);
  if (hd == 128) return tts::launch_hd<128>(a, B, G, ctas, st);
  return (int)cudaErrorInvalidValue;
}
