// Kernel 14: the decode-layer tail with bf16 or int8 weight-only weights,
// for M = 1..8 AR decode rows:
//   x2 = x + att @ wo;  h = rms_norm(x2);  g, u = h @ w_gate_up;
//   out = x2 + (silu(g) * u) @ w_down
//
// Replaces tts_tpu/ops/decode_mlp.py:fused_out_mlp (Pallas bodies _kernel,
// _no_scale_kernel), at its rounding points: each dot accumulated in fp32
// and rounded to bf16, then (int8) times the bf16-rounded scale in bf16; x2
// and the output rounded sums; h rounded once from fp32; a = bf16(silu(g)
// u) in fp32. A dot's fp32 sum runs in another order than a single pass
// (slices of the input dim, then the cluster's ranks): within the
// contract's tolerance, not bitwise an earlier form's.
//
// What bounds it on an H100: the weights, read once: 11.5 M values a layer
// at Qwen3-TTS width (wo 2048 x 1024, gate/up 1024 x 6144, down 3072 x
// 1024), 23 MB in bf16 (6.9 us at 3.35 TB/s) or 11.5 MB in int8 (3.4 us).
// At B <= 8 rows the products are far below the tensor cores' line, so the
// kernels are matvecs on the CUDA cores. Design: three launches, each the
// weight stream of weight_stream.cuh (kernel 15's design, decode_mlp_q8.cu,
// on fp32 sums) over tiles of 128 contiguous bytes of each weight row (64
// bf16 or 128 int8 columns), cut by ops/decode_mlp.out_mlp_plan, with
// programmatic dependent launch where the plan says so (each launch waits
// before it reads x, att, x2 or a):
//  1. oproj_kernel: att @ wo over slices of A; x2 = x + y.
//  2. gateup_kernel: 32 gate and 32 matching up columns a tile in bf16 (64
//     and 64 in int8); each CTA copies the x2 rows into shared memory
//     (cp.async), takes their RMSNorm statistics and forms its slice of h;
//     the cluster sums g and u and writes a = silu(g) u in bf16.
//  3. down_kernel: a @ w_down over slices of F, then the residual.
// No atomics: runs are bitwise reproducible.
#include "wgmma.cuh"
#include "weight_stream.cuh"

namespace tts {
namespace {

constexpr int CG = 8;            // column groups of 16 bytes a CTA: 128 bytes a weight row
constexpr int MAX_H = 4096;      // the RMSNorm's columns: 16 a thread

struct Args {
  const bf16* x;      // (B, H) residual input
  const bf16* att;    // (B, A) attention rows
  const void* wo;     // (A, H)
  const void* wgu;    // (H, 2F)
  const void* wd;     // (F, H)
  const float* so;    // (H,) per-column scales (null: bf16 weights)
  const float* sgu;   // (2F,)
  const float* sd;    // (H,)
  bf16* x2;           // (B, H) scratch
  bf16* a;            // (B, F) scratch
  bf16* out;          // (B, H)
  int A, H, F;
  int k1, k2, k3;     // input rows a CTA takes in launches 1, 2, 3
  float eps;
};

// the CTA of the cluster that sums output i (of a tile of `cols` columns) in
// a cluster of nct: i % nct, or with `half` (gate-up: columns c and c + half
// of a row meet in one a) that of the pair
__device__ __forceinline__ int owner(int i, int nct, int cols, int half) {
  return (half ? i / cols * half + i % half : i) % nct;
}

// act [NB][kp] <- bf16 rows src (NB rows of ld values) over k0 .. k0 + kn - 1,
// zero past kn: 16-byte copies (k0, kn multiples of 8)
template <int NB>
__device__ __forceinline__ void stage_slice(const bf16* __restrict__ src, int ld, int k0, int kn,
                                            int kp, bf16* act) {
  for (int i = threadIdx.x; i < NB * kp / 8; i += NT) {
    const int b = i / (kp / 8), k = i % (kp / 8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < kn) v = *reinterpret_cast<const uint4*>(src + (size_t)b * ld + k0 + k);
    *reinterpret_cast<uint4*>(act + b * kp + k) = v;
  }
}

// a dot's epilogue: fp32 sum rounded to bf16, then (int8) times the scale
// rounded to bf16
__device__ __forceinline__ float dot_out(float s, const float* scale, int n) {
  const float y = rnd(s);
  return scale ? rnd(y * rnd(scale[n])) : y;
}

// ---------------------------------------------------------------- launch 1

template <typename W, int NB>
__global__ void __launch_bounds__(NT) oproj_kernel(const Args p) {
  constexpr int V = vals<W>(), COLS = CG * V, N = NB * COLS, NR = rows_in_flight<W, NB>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[N];
  const int nct = gridDim.x, rank = cluster_rank(nct), tid = threadIdx.x, ql = tid / CG;
  const int k0 = rank * p.k1, kn = min(p.A - k0, p.k1), kp = padded<W, CG, NB>(p.k1);
  bf16* act = reinterpret_cast<bf16*>(smem);            // [NB][kp]
  float* red = reinterpret_cast<float*>(act + NB * kp);  // [NW][N]
  float* recv = red + NW * N;                            // [nct][N]
  const int n0 = blockIdx.y * COLS, nw = n0 + (tid % CG) * V;
  const W* w = nw < p.H ? static_cast<const W*>(p.wo) + nw : nullptr;
  uint4 wr[NR];
  load_rows<W, CG, NR>(w, p.H, k0, kn, ql, wr);
  if (nct > 1) cluster_arrive_relaxed();
  pdl_launch();
  pdl_wait();

  stage_slice<NB>(p.att, p.A, k0, kn, kp, act);
  __syncthreads();
  float acc[NB][V];
  stream<W, CG, NB, NR>(w, p.H, k0, kn, kp, wr, act, acc);
  tile_sums<CG, NB, V>(acc, red, part);
  send_parts(part, N, recv, rank, nct, [=](int i) { return owner(i, nct, COLS, 0); });

  // x2 = x + y over the cluster's slices, on the owner rank
  for (int i = rank + tid * nct; i < N; i += NT * nct) {
    const int b = i / COLS, n = n0 + i % COLS;
    if (n >= p.H) continue;
    const float y = dot_out(cluster_sum(part, recv, N, nct, i), p.so, n);
    p.x2[(size_t)b * p.H + n] = to_bf(to_f(p.x[(size_t)b * p.H + n]) + y);
  }
}

// ---------------------------------------------------------------- launch 2

template <typename W, int NB>
__global__ void __launch_bounds__(NT) gateup_kernel(const Args p) {
  constexpr int V = vals<W>(), COLS = CG * V, HALF = COLS / 2, N = NB * COLS;
  constexpr int NR = rows_in_flight<W, NB>(), PER = MAX_H / NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[N];
  __shared__ float scratch[NW], rs_s[NB];
  const int nct = gridDim.x, rank = cluster_rank(nct), tid = threadIdx.x, ql = tid / CG;
  const int H = p.H, k0 = rank * p.k2, kn = min(H - k0, p.k2), kp = padded<W, CG, NB>(p.k2);
  bf16* x2s = reinterpret_cast<bf16*>(smem);             // [NB][H], the x2 rows
  bf16* act = x2s + NB * H;                              // [NB][kp]
  float* red = reinterpret_cast<float*>(act + NB * kp);  // [NW][N]
  float* recv = red + NW * N;                            // [nct][N]
  // column groups 0 .. CG/2 - 1: gate columns f0 + V g; the rest the
  // matching up columns F + f0 + ...
  const int f0 = blockIdx.y * HALF, cgi = tid % CG;
  const int fw = f0 + (cgi % (CG / 2)) * V;
  const W* w = fw < p.F ? static_cast<const W*>(p.wgu) + (cgi < CG / 2 ? 0 : p.F) + fw : nullptr;
  uint4 wr[NR];
  load_rows<W, CG, NR>(w, 2 * (size_t)p.F, k0, kn, ql, wr);
  if (nct > 1) cluster_arrive_relaxed();
  pdl_launch();
  pdl_wait();

  for (int c = tid; c < NB * H / 8; c += NT) cp_async16(smem_u32(x2s + c * 8), p.x2 + c * 8);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  // per row: the sum of squares of x2 (lane t over columns t, t + 256, ...,
  // a butterfly, the 8 warps in order), h = bf16(x2 rsqrt(mean + eps)) over
  // this CTA's slice
  for (int b = 0; b < NB; ++b) {
    const bf16* xr = x2s + b * H;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = tid + i * NT;
      if (n >= H) break;
      const float v = to_f(xr[n]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if ((tid & 31) == 0) scratch[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NW; ++i) s += scratch[i];
      rs_s[b] = rsqrtf(s / (float)H + p.eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < NB * kp; i += NT) {
    const int b = i / kp, k = i % kp;
    act[i] = to_bf(k < kn ? to_f(x2s[b * H + k0 + k]) * rs_s[b] : 0.f);
  }
  __syncthreads();

  float acc[NB][V];
  stream<W, CG, NB, NR>(w, 2 * (size_t)p.F, k0, kn, kp, wr, act, acc);
  tile_sums<CG, NB, V>(acc, red, part);
  send_parts(part, N, recv, rank, nct,
             [=](int i) { return owner(i, nct, COLS, HALF); });

  // a = silu(g) u over the cluster's slices, on the owner rank of the pair
  // of g's column (i, i % COLS < HALF) and u's (i + HALF)
  for (int pr = rank + tid * nct; pr < NB * HALF; pr += NT * nct) {
    const int b = pr / HALF, c = pr % HALF, f = f0 + c, i = b * COLS + c;
    if (f >= p.F) continue;
    const float g = dot_out(cluster_sum(part, recv, N, nct, i), p.sgu, f);
    const float u = dot_out(cluster_sum(part, recv, N, nct, i + HALF), p.sgu, p.F + f);
    const float sg = __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
    p.a[(size_t)b * p.F + f] = to_bf(__fmul_rn(sg, u));
  }
}

// ---------------------------------------------------------------- launch 3

template <typename W, int NB>
__global__ void __launch_bounds__(NT) down_kernel(const Args p) {
  constexpr int V = vals<W>(), COLS = CG * V, N = NB * COLS, NR = rows_in_flight<W, NB>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[N];
  const int nct = gridDim.x, rank = cluster_rank(nct), tid = threadIdx.x, ql = tid / CG;
  const int k0 = rank * p.k3, kn = min(p.F - k0, p.k3), kp = padded<W, CG, NB>(p.k3);
  bf16* act = reinterpret_cast<bf16*>(smem);            // [NB][kp]
  float* red = reinterpret_cast<float*>(act + NB * kp);  // [NW][N]
  float* recv = red + NW * N;                            // [nct][N]
  const int n0 = blockIdx.y * COLS, nw = n0 + (tid % CG) * V;
  const W* w = nw < p.H ? static_cast<const W*>(p.wd) + nw : nullptr;
  uint4 wr[NR];
  load_rows<W, CG, NR>(w, p.H, k0, kn, ql, wr);
  if (nct > 1) cluster_arrive_relaxed();
  pdl_launch();
  pdl_wait();

  stage_slice<NB>(p.a, p.F, k0, kn, kp, act);
  __syncthreads();
  float acc[NB][V];
  stream<W, CG, NB, NR>(w, p.H, k0, kn, kp, wr, act, acc);
  tile_sums<CG, NB, V>(acc, red, part);
  send_parts(part, N, recv, rank, nct, [=](int i) { return owner(i, nct, COLS, 0); });

  // out = x2 + y, on the owner rank
  for (int i = rank + tid * nct; i < N; i += NT * nct) {
    const int b = i / COLS, n = n0 + i % COLS;
    if (n >= p.H) continue;
    const float y = dot_out(cluster_sum(part, recv, N, nct, i), p.sd, n);
    p.out[(size_t)b * p.H + n] = to_bf(to_f(p.x2[(size_t)b * p.H + n]) + y);
  }
}

// ---------------------------------------------------------------- host side

// dynamic shared memory of each launch, bytes
template <typename W, int NB>
size_t smem_bytes(int launch, const Args& p, int ctas) {
  constexpr size_t N = sizeof(float) * NB * CG * vals<W>();   // a CTA's sums
  const int k = launch == 1 ? p.k1 : launch == 2 ? p.k2 : p.k3;
  const size_t x2s = launch == 2 ? sizeof(bf16) * NB * p.H : 0;
  return x2s + sizeof(bf16) * NB * padded<W, CG, NB>(k) + (NW + ctas) * N;
}

template <typename W, int NB>
int run(const Args& p, int c1, int c2, int c3, bool pdl, cudaStream_t st) {
  static int b1[MAX_DEVICES], b2[MAX_DEVICES], b3[MAX_DEVICES];
  constexpr int COLS = CG * vals<W>();
  const size_t s1 = smem_bytes<W, NB>(1, p, c1), s2 = smem_bytes<W, NB>(2, p, c2),
               s3 = smem_bytes<W, NB>(3, p, c3);
  if (s1 > 227 * 1024 || s2 > 227 * 1024 || s3 > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int tiles = (p.H + COLS - 1) / COLS;
  cudaError_t err;
  if ((err = launch_stream(oproj_kernel<W, NB>, c1, tiles, s1, pdl, st, p, b1))) return (int)err;
  if ((err = launch_stream(gateup_kernel<W, NB>, c2, (p.F + COLS / 2 - 1) / (COLS / 2), s2, pdl,
                           st, p, b2)))
    return (int)err;
  return (int)launch_stream(down_kernel<W, NB>, c3, tiles, s3, pdl, st, p, b3);
}

template <typename W>
int dispatch(int B, const Args& p, int c1, int c2, int c3, bool pdl, cudaStream_t st) {
  switch (B) {
    case 1: return run<W, 1>(p, c1, c2, c3, pdl, st);
    case 2: return run<W, 2>(p, c1, c2, c3, pdl, st);
    case 3: return run<W, 3>(p, c1, c2, c3, pdl, st);
    case 4: return run<W, 4>(p, c1, c2, c3, pdl, st);
    case 5: return run<W, 5>(p, c1, c2, c3, pdl, st);
    case 6: return run<W, 6>(p, c1, c2, c3, pdl, st);
    case 7: return run<W, 7>(p, c1, c2, c3, pdl, st);
    default: return run<W, 8>(p, c1, c2, c3, pdl, st);
  }
}

}  // namespace
}  // namespace tts

// x (B, H), att (B, A) bf16; wo (A, H), w_gate_up (H, 2F), w_down (F, H),
// bf16, or int8 when w_int8 with fp32 per-column scales so (H,), sgu (2F,),
// sd (H,); scratch x2 (B, H) and a (B, F) bf16; out (B, H) bf16. B 1..8,
// A % 8 == 0, H and F multiples of 32, H <= 4096, F <= 4096. The form, from
// ops/decode_mlp.out_mlp_plan: launch l cuts its input dim (A, H, F) into
// c_l slices of k_l rows, a cluster of c_l CTAs a column tile; pdl 1
// launches all three with programmatic stream serialization. Any other form
// is refused.
extern "C" int fused_out_mlp(const void* x, const void* att, const void* wo, const void* wgu,
                             const void* wd, int w_int8, const void* so, const void* sgu,
                             const void* sd, void* x2, void* a, void* out, int B, int A, int H,
                             int F, int c1, int k1, int c2, int k2, int c3, int k3, int pdl,
                             float eps, void* stream) {
  using tts::bf16;
  const bool shapes = B >= 1 && B <= 8 && A % 8 == 0 && A >= 8 && H % 32 == 0 && H >= 32 &&
                      H <= tts::MAX_H && F % 32 == 0 && F >= 32 && F <= 4096 &&
                      (!w_int8 || (so && sgu && sd));
  const bool form = tts::cut_ok(A, c1, k1) && tts::cut_ok(H, c2, k2) &&
                    tts::cut_ok(F, c3, k3) && (pdl == 0 || pdl == 1);
  if (!shapes || !form) return (int)cudaErrorInvalidValue;
  tts::Args p{(const bf16*)x, (const bf16*)att, wo, wgu, wd,
              w_int8 ? (const float*)so : nullptr, w_int8 ? (const float*)sgu : nullptr,
              w_int8 ? (const float*)sd : nullptr, (bf16*)x2, (bf16*)a, (bf16*)out,
              A, H, F, k1, k2, k3, eps};
  cudaStream_t st = (cudaStream_t)stream;
  return w_int8 ? tts::dispatch<int8_t>(B, p, c1, c2, c3, pdl == 1, st)
                : tts::dispatch<bf16>(B, p, c1, c2, c3, pdl == 1, st);
}
