// Kernel 11: the fused decode-layer qkv head for M = 1..8 AR decode rows,
// RMSNorm or LayerNorm -> fused-QKV matvec (bf16 or int8 weights with a
// per-column scale) -> bias -> per-head q/k RMSNorm -> half-split RoPE, in
// one launch. Kernel 12 (decode_step.cu) runs it at one row as its first
// launch.
//
// Replaces tts_tpu/ops/decode_qkv.py:fused_qkv_rope (Pallas body _kernel
// and the epilogues _norm_rope/_rope_only). Same rounding points: the
// normed input is rounded to bf16; the dot accumulates in fp32 and is
// rounded to bf16; the int8 scale is rounded to bf16 and multiplied in
// bf16, then the bf16 bias added; the per-head norm runs in fp32 (times its
// weight) and is rounded once; the rotation is hs*c + rot*s with each of
// the three ops rounded to bf16 (qkv_finish, norm_rope). A dot's fp32 sum
// runs over slices of the input dim, then the cluster's ranks: within the
// contract's tolerance, not bitwise an earlier form's.
//
// What bounds it on an H100: the weight stream, read once: 4 MB of bf16 (2
// MB of int8) a layer at Kani width, 8.4 MB at Qwen3-TTS's, 9.8 MB at
// IndexTTS's (1.2-2.9 us at 3.35 TB/s); the rest is latency. Design: the
// weight stream of weight_stream.cuh with the epilogue where the sums meet.
//  * A CTA takes a column tile of whole heads, at least 128 bytes of each
//    weight row (bf16: one head, 128 or 256 bytes; int8: two heads at head
//    dim 64, one at 128), over a slice of the input dim; the CTAs of a tile
//    form a cluster along it (ops/decode_qkv.qkv_plan, from the SM count).
//  * A thread issues its 16-byte weight row loads first, then (with
//    programmatic dependent launch) lets the next launch start and waits
//    for the previous one; only then does it read x. Every CTA takes the
//    statistics of the whole rows (warp b for row b, 16-byte loads), and
//    forms its slice of the normed input in bf16 in shared memory.
//  * The cluster's fp32 sums meet on the CTA that owns each (row, head)
//    unit of the tile, which adds them in rank order and runs the epilogue
//    on whole heads (the q/k norm needs the head's sum of squares; the
//    rotation pairs column i with i +- hd/2), and writes q, k and v in bf16.
// No partial sums in device memory, no second launch, no atomics: runs
// repeat bitwise.
#include "weight_stream.cuh"

namespace tts {
namespace {

constexpr int MAX_H = 8192;                   // input width: the slice in shared memory
constexpr int SMEM_MAX = 216 * 1024;          // dynamic shared memory a CTA

struct QkvArgs {
  const bf16* x;       // (B, H)
  const void* w;       // (H, N) bf16 or int8, N = (heads + 2 kv_heads) HD
  const float* scale;  // (N,) int8 scales, or null
  const bf16* bias;    // (N,) or null
  const bf16* qn;      // (HD,) q/k norm weights, or null
  const bf16* kn;
  const bf16* cosr;    // (HD,) RoPE row, or null
  const bf16* sinr;
  const bf16* lnw;     // (H,) LayerNorm weight and bias, or null (RMSNorm)
  const bf16* lnb;
  bf16* q;             // (B, heads HD)
  bf16* k;             // (B, kv_heads HD)
  bf16* v;
  int H, heads, kv_heads, rows;  // rows: input rows a CTA takes
  float eps;
};

// ---------------------------------------------------------------- epilogue
// a column's fp32 sum rounded, times the rounded int8 scale, plus the bias
// (where given)
__device__ __forceinline__ float qkv_finish(float acc, bool scaled, float scale, bool biased,
                                            float bias) {
  float val = rnd(acc);
  if (scaled) val = rnd(val * rnd(scale));
  if (biased) val = rnd(val + bias);
  return val;
}

// the sum of v over a head's HD threads (heads in consecutive threads of
// the CTA): a butterfly a warp, then the head's warps in order through
// scratch (one float a warp of the CTA)
template <int HD>
__device__ __forceinline__ float head_sum(float v, float* scratch) {
  constexpr int NW = HD / 32;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  const float* hs = scratch + threadIdx.x / HD * NW;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += hs[i];
  return s;
}

// column threadIdx.x % HD of a q or k head: the RMSNorm times its weight
// nw (when `norm`), then the rotation by cos / sin (when `rope`). Every
// thread of the CTA calls it (its barriers), with `norm` and `rope` the
// same for all; a thread with `skip` (a v head's) returns val as it came.
// row holds HD floats a head.
template <int HD>
__device__ __forceinline__ float norm_rope(float val, bool skip, bool norm, float nw, bool rope,
                                           float cos, float sin, float eps, float* scratch,
                                           float* row) {
  const int i = threadIdx.x % HD;
  if (norm) {
    const float ms = head_sum<HD>(val * val, scratch) / (float)HD;
    if (!skip) val = rnd(__fmul_rn(val * rsqrtf(ms + eps), nw));
  }
  if (rope) {
    float* r = row + threadIdx.x / HD * HD;
    r[i] = val;
    __syncthreads();
    const float rot = i < HD / 2 ? -r[i + HD / 2] : r[i - HD / 2];
    if (!skip) val = rnd(rnd(val * cos) + rnd(rot * sin));
  }
  return val;
}

// ---------------------------------------------------------------- the stream

// The column tile: HPT whole heads, at least 128 bytes of each weight row;
// CG column groups of one 16-byte load; NP fp32 sums a CTA
template <typename W, int NB, int HD>
struct Tile {
  static constexpr int HPT = HD * (int)sizeof(W) >= 128 ? 1 : 128 / (HD * (int)sizeof(W));
  static constexpr int COLS = HPT * HD, V = vals<W>(), CG = COLS / V, NP = NB * COLS;
  static constexpr int NR = rows_in_flight<W, NB>();
};

template <typename W, int NB, int HD>
__global__ void __launch_bounds__(NT) qkv_head_kernel(const QkvArgs p) {
  using T = Tile<W, NB, HD>;
  constexpr int HPT = T::HPT, COLS = T::COLS, V = T::V, CG = T::CG, NP = T::NP, NR = T::NR;
  constexpr int HPP = NT / HD;                          // (row, head) units an epilogue pass
  constexpr int UNITS = NB * HPT, PASSES = (UNITS + HPP - 1) / HPP;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[NP];
  __shared__ float stat[2][NB];                          // per row: mean (LN), 1/sqrt(var + eps)
  __shared__ float scratch[NW], row[NT];
  const int nct = gridDim.x, rank = cluster_rank(nct), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int H = p.H, k0 = rank * p.rows, kn = min(H - k0, p.rows);
  const int kp = padded<W, CG, NB>(p.rows);
  const int nh = p.heads + 2 * p.kv_heads, N = nh * HD;
  bf16* act = reinterpret_cast<bf16*>(smem);             // [NB][kp]
  float* red = reinterpret_cast<float*>(act + NB * kp);  // [NW][NP]
  float* recv = red + NW * NP;                           // [nct][NP]
  const int n0 = blockIdx.y * COLS, nw = n0 + (tid % CG) * V;
  const W* w = nw < N ? static_cast<const W*>(p.w) + nw : nullptr;
  uint4 wr[NR];
  load_rows<W, CG, NR>(w, N, k0, kn, tid / CG, wr);
  if (nct > 1) cluster_arrive_relaxed();
  pdl_launch();
  pdl_wait();

  // each row's statistics over the whole row, warp b for row b: the mean
  // (LayerNorm) and the mean square, of the centred values for LayerNorm
  if (warp < NB) {
    const bf16* xr = p.x + (size_t)warp * H;
    float s = 0.f, ss = 0.f;
#pragma unroll 4
    for (int c = lane * 8; c < H; c += 256) {
      Vec8 v;
      v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = to_f(v.h[e]);
        s += f;
        ss = fmaf(f, f, ss);
      }
    }
    float mean = 0.f;
    if (p.lnw) {
      mean = warp_sum(s) / (float)H;
      ss = 0.f;
#pragma unroll 4
      for (int c = lane * 8; c < H; c += 256) {
        Vec8 v;
        v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = to_f(v.h[e]) - mean;
          ss = fmaf(d, d, ss);
        }
      }
    }
    const float var = warp_sum(ss) / (float)H;
    if (lane == 0) {
      stat[0][warp] = mean;
      stat[1][warp] = rsqrtf(var + p.eps);
    }
  }
  __syncthreads();
  // the slice of the normed input in bf16, zero past it (kn, k0 multiples of 8)
  for (int c = tid; c < NB * kp / 8; c += NT) {
    const int b = c / (kp / 8), k = c % (kp / 8) * 8;
    Vec8 o;
    o.u = make_uint4(0u, 0u, 0u, 0u);
    if (k < kn) {
      Vec8 v;
      v.u = *reinterpret_cast<const uint4*>(p.x + (size_t)b * H + k0 + k);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float f = (to_f(v.h[e]) - stat[0][b]) * stat[1][b];
        if (p.lnw)
          f = __fadd_rn(__fmul_rn(f, to_f(p.lnw[k0 + k + e])), to_f(p.lnb[k0 + k + e]));
        o.h[e] = to_bf(f);
      }
    }
    *reinterpret_cast<uint4*>(act + b * kp + k) = o.u;
  }
  __syncthreads();

  float acc[NB][V];
  stream<W, CG, NB, NR>(w, N, k0, kn, kp, wr, act, acc);

  // this rank's (row, head) units: rank, rank + nct, ...; pass ps of the
  // epilogue takes HPP of them, a head's HD columns in consecutive threads.
  // Their scales and biases load here, under the sums' exchange.
  const int i = tid % HD, mine = (UNITS - rank + nct - 1) / nct;
  float e_scale[PASSES], e_bias[PASSES];
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
    const int slot = ps * HPP + tid / HD, gh = blockIdx.y * HPT + (rank + slot * nct) % HPT;
    const bool live = slot < mine && gh < nh;
    e_scale[ps] = live && p.scale ? p.scale[gh * HD + i] : 0.f;
    e_bias[ps] = live && p.bias ? to_f(p.bias[gh * HD + i]) : 0.f;
  }
  const float nw_q = p.qn ? to_f(p.qn[i]) : 0.f, nw_k = p.qn ? to_f(p.kn[i]) : 0.f;
  const float cs = p.cosr ? to_f(p.cosr[i]) : 0.f, sn = p.cosr ? to_f(p.sinr[i]) : 0.f;

  tile_sums<CG, NB, V>(acc, red, part);
  // sum i (row i / COLS, head i % COLS / HD of the tile) to its unit's owner
  send_parts(part, NP, recv, rank, nct,
             [=](int j) { return (j / COLS * HPT + j % COLS / HD) % nct; });

#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
    if (ps * HPP >= mine) break;                         // the same for the whole CTA
    const int slot = ps * HPP + tid / HD, u = rank + slot * nct, h = u % HPT, b = u / HPT;
    const int gh = blockIdx.y * HPT + h;
    const bool live = slot < mine && gh < nh;
    const bool is_q = gh < p.heads, is_v = gh >= p.heads + p.kv_heads;
    float val = 0.f;
    if (live)
      val = qkv_finish(cluster_sum(part, recv, NP, nct, b * COLS + h * HD + i), p.scale,
                       e_scale[ps], p.bias, e_bias[ps]);
    val = norm_rope<HD>(val, !live || is_v, p.qn, is_q ? nw_q : nw_k, p.cosr, cs, sn, p.eps,
                        scratch, row);
    if (live) {
      if (is_q)
        p.q[((size_t)b * p.heads + gh) * HD + i] = to_bf(val);
      else if (!is_v)
        p.k[((size_t)b * p.kv_heads + gh - p.heads) * HD + i] = to_bf(val);
      else
        p.v[((size_t)b * p.kv_heads + gh - p.heads - p.kv_heads) * HD + i] = to_bf(val);
    }
    __syncthreads();                                     // scratch and row free for the next
  }
}

// dynamic shared memory of a launch, bytes: the normed slice in whole
// chunks, the warps' and the cluster's fp32 sums
template <typename W, int NB, int HD>
size_t smem_bytes(int k, int ctas) {
  using T = Tile<W, NB, HD>;
  return sizeof(bf16) * NB * padded<W, T::CG, NB>(k) + sizeof(float) * (NW + ctas) * T::NP;
}

template <typename W, int NB, int HD>
int run(const QkvArgs& p, int ctas, bool pdl, cudaStream_t st) {
  static int big[MAX_DEVICES];
  using T = Tile<W, NB, HD>;
  const size_t smem = smem_bytes<W, NB, HD>(p.rows, ctas);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int tiles = (p.heads + 2 * p.kv_heads + T::HPT - 1) / T::HPT;
  return (int)launch_stream(qkv_head_kernel<W, NB, HD>, ctas, tiles, smem, pdl, st, p, big);
}

template <typename W, int HD>
int dispatch(int B, const QkvArgs& p, int ctas, bool pdl, cudaStream_t st) {
  switch (B) {
    case 1: return run<W, 1, HD>(p, ctas, pdl, st);
    case 2: return run<W, 2, HD>(p, ctas, pdl, st);
    case 3: return run<W, 3, HD>(p, ctas, pdl, st);
    case 4: return run<W, 4, HD>(p, ctas, pdl, st);
    case 5: return run<W, 5, HD>(p, ctas, pdl, st);
    case 6: return run<W, 6, HD>(p, ctas, pdl, st);
    case 7: return run<W, 7, HD>(p, ctas, pdl, st);
    default: return run<W, 8, HD>(p, ctas, pdl, st);
  }
}

}  // namespace
}  // namespace tts

// x (B, H) bf16; w (H, N) bf16, or int8 when w_int8 with scale (N,) fp32;
// bias (N,), q_norm/k_norm (hd,), cos/sin (hd,), ln_w/ln_b (H,) bf16, each
// optional (null; the norms, the RoPE rows and the LayerNorm's in pairs);
// q (B, heads*hd), k/v (B, kv_heads*hd) bf16. N = (heads + 2*kv_heads) *
// hd, hd 64 or 128, B 1..8, H a multiple of 8 up to 8192; LayerNorm when
// ln_w is given, else the weightless RMSNorm. The form, from
// ops/decode_qkv.qkv_plan: the input dim cut into `ctas` slices of `rows`,
// a cluster of `ctas` CTAs a column tile; pdl 1 launches with programmatic
// stream serialization. Any other form is refused.
extern "C" int fused_qkv_rope(const void* x, const void* w, int w_int8, const void* scale,
                              const void* bias, const void* qn, const void* kn,
                              const void* cosr, const void* sinr, const void* lnw,
                              const void* lnb, void* q, void* k, void* v, int B, int H,
                              int heads, int kv_heads, int hd, int ctas, int rows, int pdl,
                              float eps, void* stream) {
  using tts::bf16;
  const bool shapes = B >= 1 && B <= 8 && (hd == 64 || hd == 128) && H >= 8 && H % 8 == 0 &&
                      H <= tts::MAX_H && heads >= 1 && kv_heads >= 1 && (!w_int8 || scale) &&
                      !qn == !kn && !cosr == !sinr && !lnw == !lnb;
  const bool form = tts::cut_ok(H, ctas, rows) && (pdl == 0 || pdl == 1);
  if (!shapes || !form) return (int)cudaErrorInvalidValue;
  const tts::QkvArgs p{(const bf16*)x, w, w_int8 ? (const float*)scale : nullptr,
                       (const bf16*)bias, (const bf16*)qn, (const bf16*)kn,
                       (const bf16*)cosr, (const bf16*)sinr, (const bf16*)lnw,
                       (const bf16*)lnb, (bf16*)q, (bf16*)k, (bf16*)v, H, heads, kv_heads,
                       rows, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (w_int8)
    return hd == 64 ? tts::dispatch<int8_t, 64>(B, p, ctas, pdl == 1, st)
                    : tts::dispatch<int8_t, 128>(B, p, ctas, pdl == 1, st);
  return hd == 64 ? tts::dispatch<bf16, 64>(B, p, ctas, pdl == 1, st)
                  : tts::dispatch<bf16, 128>(B, p, ctas, pdl == 1, st);
}
