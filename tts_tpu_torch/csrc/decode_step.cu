// Kernel 12: the fused decode step head for the M = 1 AR decode row: the
// qkv head of decode_qkv.cu, then GQA attention of one layer of the stacked
// KV cache over the rows < pos plus the step's own k/v row, which the
// attention takes from the qkv launch's rows (the caller appends them to
// the cache after).
//
// Replaces tts_tpu/ops/decode_step.py:fused_qkv_attn (Pallas body _kernel).
// Same softmax: fp32 scores, one-shot max-then-exp (not the online form),
// m = max(max_t s, s_new), p = exp(s - m), denom = sum p + p_new,
// probabilities rounded to bf16 before P.V with fp32 accumulation. At
// head_dim 64 it follows the TPU kernel's packed branch (s_new an fp32 sum
// of q * k_new, p_new / denom kept in fp32, v_new in fp32); at 128 its
// other branch (p_new / denom rounded to bf16).
//
// What bounds it on an H100: the qkv head's weight stream (see
// decode_qkv.cu; 8.4 MB of bf16 at Qwen3-TTS width, 2.5 us at 3.35 TB/s),
// then the live cache rows, 2 x pos x head_dim x 2 bytes a kv head (1.4 MB a
// layer at Kani's pos 700). Both are far below the tensor cores' line, and
// at decode sizes the attention is bound by latency. Design: two launches.
//  1. qkv_head_kernel (decode_qkv.cu, kernel 11 at one row, in the form
//     ops/decode_qkv.qkv_plan gives it): q of every head into a bf16
//     scratch row, the step's k and v rows; q is rounded to bf16 in the
//     epilogue, so the scratch loses nothing.
//  2. step_attn_kernel, launched with programmatic stream serialization
//     when the plan's qkv launch is (it then starts under the qkv launch's
//     tail): one thread-block cluster a kv head, its CTAs splitting the
//     live rows (ops/decode_step.step_plan, up to 8 CTAs, the portable
//     cluster size). Each CTA first issues its rows' K loads (and V's, when
//     the slice fits one round) in 16-byte loads, a group of head_dim / 8
//     lanes a row (decode_rows.cuh, kernel 13's score pass), then waits for
//     the qkv launch and reads the kv head's G q heads, k_new and v_new.
//     Then the scores of its rows into shared memory and the softmax, a
//     warp for each q head (no block barrier inside): the new row's own
//     score, the slice's max, sent to every CTA through distributed shared
//     memory so each takes one max over all rows and s_new before any exp;
//     p = exp(s - m) and the slice's sum, the sums sent likewise and added
//     in rank order, plus p_new; p / denom rounded to bf16 in place. Then
//     P.V of its rows with fp32 accumulation, the lane groups by shuffles
//     and the warps in order; each output's sum sent to the CTA that owns
//     it, which adds the CTAs' sums in rank order plus p_new / denom times
//     v_new. Three cluster barriers; one CTA alone (the plan's choice up to
//     128 rows at head_dim 128, 64 at 64) has none.
//     No atomics (bitwise reproducible runs); rows >= pos are never read.
//
// The device form (fused_qkv_attn_dev) reads pos from a device int32, for a
// CUDA graph that replays a decode step at positions the host never reads.
// Its cluster is launched at the most CTAs (and its scores' shared memory at
// the most rows a CTA) that the plan gives any position up to `top`, the
// bucket's largest; each CTA derives from the device pos the slice that
// step_plan(pos) gives it, so the CTAs past that plan take no rows. Such a
// CTA's max is -inf and its sums are exact zeros: the max over the cluster
// is the plan's CTAs' max, and each sum in rank order adds +0 after the
// plan's terms, so the output is bitwise the host form's at the same pos
// (no NaN: m is at least s_new, which is finite).
#include <cooperative_groups.h>

#include "decode_rows.cuh"

extern "C" int fused_qkv_rope(const void* x, const void* w, int w_int8, const void* scale,
                              const void* bias, const void* qn, const void* kn,
                              const void* cosr, const void* sinr, const void* lnw,
                              const void* lnb, void* q, void* k, void* v, int B, int H,
                              int heads, int kv_heads, int hd, int ctas, int rows, int pdl,
                              float eps, void* stream);

namespace tts {
namespace {

namespace cg = cooperative_groups;

constexpr int ST_THREADS = 256;
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int MAX_G = 8;
constexpr int ST_MAX_CTAS = 8;  // the portable cluster size
constexpr int ST_SMEM_MAX = 232448;

struct StepArgs {
  const bf16* q;         // (heads * HD,) the step's q, k and v rows (the qkv launch's)
  const bf16* k_new;     // (KVH * HD,)
  const bf16* v_new;
  const bf16* kc;        // the layer's (KVH, T, HD) cache slices
  const bf16* vc;
  bf16* out;             // (heads * HD,)
  int kv_heads, T, pos, rows;  // rows: a CTA's slice (the last fewer)
  const int* pos_dev;    // the device form's pos (null: the host form's pos, rows)
  int top, stride;       // the device form's largest pos; the scores' row stride
};

// step_plan's slice for `pos` (ops/decode_step.py): up to CR rows one CTA,
// past that a CTA for each CR rows, at most ST_MAX_CTAS; pos 0 none
template <int HD>
__device__ __forceinline__ void plan_slice(int pos, int& ctas, int& rows) {
  constexpr int CR = HD == 64 ? 64 : 128;
  if (pos == 0) {
    ctas = 1, rows = 0;
    return;
  }
  const int c = min(ST_MAX_CTAS, (pos + CR - 1) / CR);
  rows = (pos + c - 1) / c;
  ctas = (pos + rows - 1) / rows;
}

// shared memory, in floats: q [G][HD], k_new and v_new [HD] each, the
// warps' P.V sums [ST_WARPS][G][HD], the cluster's [ctas][G][HD] (each
// CTA's sums of the outputs this CTA owns), and the slice's scores [G][rows]
template <int HD, int G>
constexpr size_t st_smem_floats(int ctas, int rows) {
  return (size_t)(1 + ST_WARPS + ctas) * G * HD + 2 * HD + (size_t)G * rows;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cta_or_cluster_sync(int nct) {
  if (nct > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// v into *p of CTA `to` of the cluster (this CTA's own shared memory when
// the launch has no cluster)
__device__ __forceinline__ void send(float* p, int to, float v, int nct) {
  if (nct > 1)
    *cg::this_cluster().map_shared_rank(p, to) = v;
  else
    *p = v;
}

template <int HD, int G>
__global__ void __launch_bounds__(ST_THREADS) step_attn_kernel(const StepArgs a) {
  constexpr int LG = HD / 8;           // lanes a row
  constexpr int NG = ST_THREADS / LG;  // lane groups
  constexpr int U = G <= 4 ? 8 : 4;    // rows a group loads at once (registers)
  constexpr int GP = G <= 2 ? G : G <= 4 ? 4 : 8;  // G padded to a power of two
  constexpr int RR = NG * U;           // rows a round: 128 at D 128, 256 at D 64
  extern __shared__ __align__(16) float sm[];
  const int nct = gridDim.x;
  float* qs = sm;
  float* kn = qs + G * HD;
  float* vn = kn + HD;
  float* wacc = vn + HD;
  float* recv = wacc + ST_WARPS * G * HD;
  float* sc = recv + nct * G * HD;
  __shared__ float m_recv[ST_MAX_CTAS][G], l_recv[ST_MAX_CTAS][G];
  __shared__ float snew[G], mx[G], den[G];

  const int rank = nct > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int j = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, li = tid % LG, grp = tid / LG;
  // the device form reads pos here, before the wait for the qkv launch: it
  // is written, as the cache rows below are, by an ordinary launch of an
  // earlier step (see the premise below)
  int pos = a.pos, rows = a.rows;
  if (a.pos_dev != nullptr) {
    int ctas;
    pos = *a.pos_dev;
    if (pos < 0 || pos > a.top) __trap();
    plan_slice<HD>(pos, ctas, rows);
    if (ctas > nct || rows > a.stride) __trap();
  }
  const int r0 = rank * rows;
  // >= 1 for the plan's CTAs when pos >= 1; 0 past them (the device form)
  const int n = max(0, min(pos - r0, rows));
  const bf16* kj = a.kc + ((size_t)j * a.T + r0) * HD + li * 8;
  const bf16* vj = a.vc + ((size_t)j * a.T + r0) * HD + li * 8;
  const int rounds = (n + RR - 1) / RR;

  // the first round's K rows (and V rows when one round takes the slice),
  // before the wait for the qkv launch. No grid that can still be running
  // writes cache rows < pos: they were appended by the update_layer of
  // earlier steps, an ordinary launch, which completes before the next
  // launch in the stream starts (an ordinary grid triggers its dependents
  // only at its end), so before this grid or any grid still running ahead
  // of it could start; the launches of this step before this one (kernels
  // 11-15 and plain ops) write no cache row, and this step's row pos is
  // appended after it. Inside a CUDA graph (the Kani decode programs) the
  // premise is kept, not moved: the append stays an ordinary launch, so in
  // a captured step the programmatic edges run into the qkv launch and from
  // it into this one, from nodes that write no cache row; chip_smoke.py
  // phase 16 reads the captured graph's edges (cuGraphGetEdges_v2) and fails
  // a run where a programmatic edge reaches this kernel from a node that
  // writes the cache.
  uint4 kr[U], vr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = u * NG + grp;
    kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) {
      kr[u] = *reinterpret_cast<const uint4*>(kj + (size_t)t * HD);
      if (rounds == 1) vr[u] = *reinterpret_cast<const uint4*>(vj + (size_t)t * HD);
    }
  }
  if (nct > 1) cluster_arrive_relaxed();
  pdl_launch();
  pdl_wait();
  // the kv head's G q heads (contiguous), k_new and v_new, 8 values a load
  for (int c = tid; c < (G + 2) * HD / 8; c += ST_THREADS) {
    const int e = c * 8;
    const bf16* src = e < G * HD ? a.q + j * G * HD + e
                      : e < (G + 1) * HD ? a.k_new + j * HD + e - G * HD
                                         : a.v_new + j * HD + e - (G + 1) * HD;
    Vec8 v;
    v.u = *reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) qs[e + i] = to_f(v.h[i]);   // q, then k_new, then v_new
  }
  __syncthreads();

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] = qs[g * HD + li * 8 + e];

  // the slice's scores into shared memory, round by round
  for (int rd = 0; rd < rounds; ++rd) {
    if (rd > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = rd * RR + u * NG + grp;
        kr[u] = t < n ? *reinterpret_cast<const uint4*>(kj + (size_t)t * HD)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    const int t0 = rd * RR, need = min(U, (n - t0 + NG - 1) / NG);
    if (need > U / 2)
      round_scores<LG, NG, G, GP, U>(kr, qf, li, grp, t0, n, sc, a.stride, 1.f);
    else if (need > U / 4)
      round_scores<LG, NG, G, GP, U / 2>(kr, qf, li, grp, t0, n, sc, a.stride, 1.f);
    else
      round_scores<LG, NG, G, GP, U / 4>(kr, qf, li, grp, t0, n, sc, a.stride, 1.f);
  }
  __syncthreads();  // the slice's scores are in

  // the softmax, warp g for q head g (no block barrier): the step's own
  // row's score, an fp32 sum of q * k_new; the slice's max, sent to every
  // CTA of the cluster, and one max m over the cluster's slices and s_new;
  // p = exp(s - m) over the slice and its sum, sent likewise; denom = the
  // slices' sums in rank order plus p_new; then p / denom rounded to bf16
  // in place for P.V
  if (nct > 1) cluster_wait();  // every CTA started: its shared memory is there
  float sn = 0.f, m = 0.f, l = 0.f;
  float* sg = sc + warp * a.stride;
  if (warp < G) {
    for (int d = lane; d < HD; d += 32) sn = fmaf(qs[warp * HD + d], kn[d], sn);
    sn = warp_sum(sn);
    m = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sg[t]);
    m = warp_max(m);
    if (nct > 1 && lane < nct) send(&m_recv[rank][warp], lane, m, nct);
  }
  if (nct > 1) cg::this_cluster().sync();
  if (warp < G) {
    m = fmaxf(m, sn);
    for (int r = 0; r < nct && nct > 1; ++r) m = fmaxf(m, m_recv[r][warp]);
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sg[t] - m);
      sg[t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (nct > 1 && lane < nct) send(&l_recv[rank][warp], lane, l, nct);
  }
  if (nct > 1) cg::this_cluster().sync();
  if (warp < G) {
    if (nct > 1) {
      l = 0.f;
      for (int r = 0; r < nct; ++r) l += l_recv[r][warp];
    }
    const float dn = l + expf(sn - m);
    for (int t = lane; t < n; t += 32) sg[t] = rnd(sg[t] / dn);
    if (lane == 0) {
      snew[warp] = sn;
      mx[warp] = m;
      den[warp] = dn;
    }
  }
  __syncthreads();

  // P.V over the slice's rows with bf16(p / denom), fp32 accumulation
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
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
        const float pr = sc[g * a.stride + t];
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
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (lane < LG) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[(warp * G + g) * HD + li * 8 + e] = acc[g][e];
  }
  __syncthreads();
  // the CTA's sum of output k to its owner, CTA k % nct
  for (int k = tid; k < G * HD; k += ST_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ST_WARPS; ++w) s += wacc[w * G * HD + k];
    send(recv + rank * G * HD + k, k % nct, s, nct);
  }
  cta_or_cluster_sync(nct);

  // the output, its G x HD elements spread over the ranks: the CTAs' sums
  // in rank order, plus p_new / denom times v_new
  for (int k = rank + tid * nct; k < G * HD; k += nct * ST_THREADS) {
    const int g = k / HD, d = k % HD;
    float o = 0.f;
    for (int r = 0; r < nct; ++r) o += recv[r * G * HD + k];
    float pn = expf(snew[g] - mx[g]) / den[g];
    if (HD >= 128) pn = rnd(pn);
    o = fmaf(pn, vn[d], o);
    a.out[(size_t)(j * G + g) * HD + d] = to_bf(o);
  }
}

template <int HD, int G>
int launch(const StepArgs& a, int ctas, bool pdl, cudaStream_t st) {
  const size_t smem = sizeof(float) * st_smem_floats<HD, G>(ctas, a.stride);
  if (smem > (size_t)ST_SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int allowed[MAX_DEVICES];
  const cudaError_t err = raise_attr(step_attn_kernel<HD, G>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem,
                                     allowed);
  if (err != cudaSuccess) return (int)err;
  if (ctas == 1 && !pdl) {
    step_attn_kernel<HD, G><<<dim3(1, a.kv_heads), ST_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)launch_cluster(step_attn_kernel<HD, G>, dim3(ctas, a.kv_heads), ST_THREADS,
                             smem, st, ctas, a, pdl);
}

template <int HD>
int launch_hd(const StepArgs& a, int G, int ctas, bool pdl, cudaStream_t st) {
  switch (G) {
    case 1: return launch<HD, 1>(a, ctas, pdl, st);
    case 2: return launch<HD, 2>(a, ctas, pdl, st);
    case 3: return launch<HD, 3>(a, ctas, pdl, st);
    case 4: return launch<HD, 4>(a, ctas, pdl, st);
    case 5: return launch<HD, 5>(a, ctas, pdl, st);
    case 6: return launch<HD, 6>(a, ctas, pdl, st);
    case 7: return launch<HD, 7>(a, ctas, pdl, st);
    case 8: return launch<HD, 8>(a, ctas, pdl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tts

// x (1, H) bf16; w (H, N) bf16, or int8 when w_int8 with scale (N,) fp32;
// bias (N,), q_norm/k_norm (hd,), cos/sin (hd,), ln_w/ln_b (H,) bf16, each
// optional (null), as fused_qkv_rope (decode_qkv.cu) takes them; q
// (heads*hd) bf16 scratch; k/v (kv_heads*hd) bf16, the step's rows; N =
// (heads + 2*kv_heads) * hd, hd 64 or 128, heads / kv_heads <= 8; kc/vc the
// layer's (KVH, T, hd) bf16 cache slices, attn (heads*hd) bf16, T the cache
// length and pos the valid rows (0 <= pos < T). The qkv launch takes the
// form (qctas, qrows, pdl) of ops/decode_qkv.qkv_plan, and fused_qkv_rope
// refuses any other; the attention launch follows with programmatic stream
// serialization when pdl is 1, its rows split into `ctas` (1 to 8) slices
// of `rows`, the last shorter and none empty (ops/decode_step.step_plan;
// pos 0: one CTA of 0 rows); any other split is refused.
extern "C" int fused_qkv_attn(const void* x, const void* w, int w_int8, const void* scale,
                              const void* bias, const void* qn, const void* kn,
                              const void* cosr, const void* sinr, const void* lnw,
                              const void* lnb, void* q, void* k, void* v, int H, int heads,
                              int kv_heads, int hd, int qctas, int qrows, int pdl, float eps,
                              const void* kc, const void* vc, void* attn, int T, int pos,
                              int ctas, int rows, void* stream) {
  using tts::bf16;
  const bool split = pos == 0 ? ctas == 1 && rows == 0
                              : ctas >= 1 && ctas <= tts::ST_MAX_CTAS && rows >= 1 &&
                                    (long long)ctas * rows >= pos &&
                                    (long long)(ctas - 1) * rows < pos;
  if (kv_heads < 1 || heads % kv_heads || heads / kv_heads > tts::MAX_G || pos < 0 ||
      pos >= T || (hd != 64 && hd != 128) || !split)
    return (int)cudaErrorInvalidValue;
  const int err = fused_qkv_rope(x, w, w_int8, scale, bias, qn, kn, cosr, sinr, lnw, lnb, q, k,
                                 v, 1, H, heads, kv_heads, hd, qctas, qrows, pdl, eps, stream);
  if (err) return err;
  tts::StepArgs a;
  a.q = (const bf16*)q;
  a.k_new = (const bf16*)k;
  a.v_new = (const bf16*)v;
  a.kc = (const bf16*)kc;
  a.vc = (const bf16*)vc;
  a.out = (bf16*)attn;
  a.kv_heads = kv_heads, a.T = T, a.pos = pos, a.rows = rows;
  a.pos_dev = nullptr, a.top = pos, a.stride = rows;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = heads / kv_heads;
  return hd == 64 ? tts::launch_hd<64>(a, G, ctas, pdl == 1, s)
                  : tts::launch_hd<128>(a, G, ctas, pdl == 1, s);
}

// The device form: as fused_qkv_attn, but pos is read on the card from
// pos_dev (an int32, 0 <= *pos_dev <= top < T), and the attention launch
// takes `ctas` CTAs a cluster with scores of `rows` rows each: the most
// that step_plan gives any position up to top (ops/decode_step.step_bound).
// A device pos outside [0, top], or one whose plan needs more, traps.
extern "C" int fused_qkv_attn_dev(const void* x, const void* w, int w_int8, const void* scale,
                                  const void* bias, const void* qn, const void* kn,
                                  const void* cosr, const void* sinr, const void* lnw,
                                  const void* lnb, void* q, void* k, void* v, int H,
                                  int heads, int kv_heads, int hd, int qctas, int qrows,
                                  int pdl, float eps, const void* kc, const void* vc,
                                  void* attn, int T, const void* pos_dev, int top, int ctas,
                                  int rows, void* stream) {
  using tts::bf16;
  if (kv_heads < 1 || heads % kv_heads || heads / kv_heads > tts::MAX_G || pos_dev == nullptr ||
      top < 0 || top >= T || (hd != 64 && hd != 128) || ctas < 1 || ctas > tts::ST_MAX_CTAS ||
      rows < 0 || (long long)ctas * rows < top)
    return (int)cudaErrorInvalidValue;
  const int err = fused_qkv_rope(x, w, w_int8, scale, bias, qn, kn, cosr, sinr, lnw, lnb, q, k,
                                 v, 1, H, heads, kv_heads, hd, qctas, qrows, pdl, eps, stream);
  if (err) return err;
  tts::StepArgs a;
  a.q = (const bf16*)q;
  a.k_new = (const bf16*)k;
  a.v_new = (const bf16*)v;
  a.kc = (const bf16*)kc;
  a.vc = (const bf16*)vc;
  a.out = (bf16*)attn;
  a.kv_heads = kv_heads, a.T = T, a.pos = 0, a.rows = 0;
  a.pos_dev = (const int*)pos_dev, a.top = top, a.stride = rows;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = heads / kv_heads;
  return hd == 64 ? tts::launch_hd<64>(a, G, ctas, pdl == 1, s)
                  : tts::launch_hd<128>(a, G, ctas, pdl == 1, s);
}
