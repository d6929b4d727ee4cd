// Kernel 15: the decode-layer tail in W8A8 for M = 1..8 AR decode rows:
//   x2 = x + att @ wo;  h = rms_norm(x2);  g, u = h @ w_gate_up;
//   out = x2 + (silu(g) * u) @ w_down
// att quantized per row, h per row, a per row and per F-block of fb
// columns; s8 x s8 products summed exactly in int32; fp32 rescales; the
// down product summed in fp32 over the F-blocks in order.
//
// Replaces tts_tpu/ops/decode_mlp.py:fused_out_mlp_q8 (Pallas body
// _kernel_q8, with the att row quantization that tts_tpu ran in XLA ahead
// of it). The quantization steps follow the TPU's exactly where the inputs
// are equal: xs = max(amax, 1e-8) * f32(1/127), an IEEE division
// (__fdiv_rn), rint (half to even), and every multiply and add of the
// rescales an explicit _rn intrinsic so nvcc cannot contract a pair into an
// FMA. The RMSNorm's sum of squares runs in the order of the earlier form
// (256 lanes, each over every 256th column, then a butterfly and the 8
// warps in order), so the outputs are bitwise those of that form.
//
// What bounds it on an H100: the int8 weights, read once: 11.5 MB a layer
// at Qwen3-TTS width (wo 2048 x 1024, gate/up 1024 x 6144, down 3072 x
// 1024), 3.4 us at 3.35 TB/s. At B <= 8 rows the products are far below
// the tensor cores' line (wgmma's 64 rows would be 1/8 to 1/64 used), so
// the kernels are matvecs on the CUDA cores. Design: three launches, each a
// weight stream, and every split a sum that is exact:
//  * every CTA takes a 128-column tile of its matrix (128 contiguous bytes
//    of each weight row: the card streamed 16- and 32-byte row pieces at a
//    fraction of the rate) over a slice of the input dim; the CTAs of one
//    tile form a thread-block cluster along that dim (q8_tail_plan in
//    ops/decode_mlp.py: at most 8 CTAs a cluster, slices of at least 512
//    rows; more CTAs with shorter slices lost on the card: a cluster's
//    barrier grows with its CTAs);
//  * a thread loads 4 quads of 4 consecutive rows x 16 columns, each row
//    in one 16-byte load, all issued before anything else the CTA does
//    (quantizing its activations, reading the previous launch's output);
//    a byte transpose (__byte_perm) turns a quad into 16 words of one
//    column each, and __dp4a multiplies them by the 4 rows' int8
//    activations: 4 products a lane-instruction, summed exactly in int32;
//  * the lanes of a column meet by a transposing butterfly, the warps
//    through shared memory; then each CTA sends its sums through
//    distributed shared memory to the CTA of the cluster that owns each
//    output (the tile's outputs spread over the ranks), one cluster
//    barrier, and the owner adds them and runs the tile's last step. A CTA
//    arrives at that barrier's first half right after issuing its loads,
//    so waiting for the cluster's CTAs to start costs nothing.
//  1. q8_oproj_kernel: each CTA takes the amax of every att row (4 KB at
//     A 2048, from L2) and quantizes only its own slice: att is quantized
//     once. The cluster sums the slices and writes x2 = x + y.
//  2. q8_gateup_kernel: 64 gate and the 64 matching up columns a tile;
//     each CTA copies the x2 rows into shared memory (cp.async), takes
//     their RMSNorm statistics and quantizes its slice of h; the cluster
//     sums g and u and writes a = silu(g) * u in fp32.
//  3. q8_down_kernel: the input dim cut into sub-blocks of k3 rows that
//     divide the F-block; each CTA takes the amax of its F-block of a
//     (an exact max, the same in every CTA) and quantizes its sub-block
//     once; the outputs' owners add the sub-blocks of each F-block in
//     int32, rescale the block, and add the blocks in order in fp32, then
//     the residual.
// No atomics: runs are bitwise reproducible.
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace tts {
namespace {

namespace cg = cooperative_groups;

constexpr float INV_127 = 0x1.020408p-7f;  // float32(1 / 127)
constexpr int CG = 8;                      // column groups of 16 a CTA
constexpr int COLS = CG * 16;              // columns a CTA's tile takes: 128 bytes a row
constexpr int NQ = 4;                      // row quads a thread loads at once
constexpr int MAX_CTAS = 16;               // the H100's non-portable cluster limit
constexpr int MAX_PASSES = 2;              // sub-blocks a down CTA takes
constexpr int MAX_H = 4096;                // the RMSNorm's columns: 16 a lane

struct Q8Args {
  const bf16* x;      // (B, H) residual input
  const bf16* att;    // (B, A) attention rows
  const int8_t* wo;   // (A, H)
  const int8_t* wgu;  // (H, 2F)
  const int8_t* wd;   // (F, H)
  const float* so;    // (H,) per-column scales
  const float* sgu;   // (2F,)
  const float* sd;    // (H,)
  bf16* x2;           // (B, H) scratch
  float* a;           // (B, F) scratch
  bf16* out;          // (B, H)
  int A, H, F, fb;
  int k1, k2, k3;     // input rows a CTA takes in launches 1, 2, 3
  float eps;
};

// clip(rint(v / xs), -127, 127): IEEE division, round half to even
__device__ __forceinline__ signed char quant(float v, float xs) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
}

// silu in fp32, jax.nn.silu's x * sigmoid(x) with sigmoid = 1 / (1 + e^-x)
__device__ __forceinline__ float silu(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// max over the CTA's NT threads; scratch holds NT / 32 floats
template <int NT>
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) m = fmaxf(m, scratch[i]);
  return m;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A thread's weights: quads q = ql + i * QL (i < NQ) of a slice of kn rows
// starting at row k0 of w (row stride ldw), rows 4q .. 4q + 3, 16 columns
// each; rows past kn, and every row of a null w (a column group past the
// matrix's edge), read as 0.
template <int QL>
__device__ __forceinline__ void load_quads(const int8_t* __restrict__ w, size_t ldw, int k0,
                                           int kn, int ql, int chunk, uint4 (&wr)[NQ][4]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * (ql + (chunk * NQ + i) * QL) + j;
      wr[i][j] = r < kn && w ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ldw))
                             : make_uint4(0u, 0u, 0u, 0u);
    }
}

// acc[b][c] += sum over the quad's 4 rows of w[row][c] * act[b][row]: the
// 4 x 16 bytes transposed to 16 column words, one __dp4a a column and row
template <int NB>
__device__ __forceinline__ void mac_quad(const uint4 (&w)[4], const int (&a4)[NB],
                                         int (&acc)[NB][16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t w0 = word(w[0], j), w1 = word(w[1], j), w2 = word(w[2], j),
                   w3 = word(w[3], j);
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
    const int t[4] = {(int)__byte_perm(lo01, lo23, 0x5410), (int)__byte_perm(lo01, lo23, 0x7632),
                      (int)__byte_perm(hi01, hi23, 0x5410), (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[b][4 * j + c] = __dp4a(t[c], a4[b], acc[b][4 * j + c]);
  }
}

// One step of a transposing butterfly over the lanes OFF apart, on CNT
// values a lane, then the next down to the offset STOP: each lane sends the
// half it does not keep and adds the partner's copy of the half it keeps
// (the upper lane keeps the upper half; `base` counts the values it passed
// over). Integer sums: any order gives the same bits.
template <int OFF, int CNT, int STOP>
__device__ __forceinline__ void butterfly(int* val, int lane, int& base) {
  if constexpr (OFF >= STOP) {
    constexpr int HALF = CNT / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int sent = upper ? val[i] : val[i + HALF];
      const int kept = upper ? val[i + HALF] : val[i];
      val[i] = kept + __shfl_xor_sync(0xffffffffu, sent, OFF);
    }
    base += upper ? HALF : 0;
    butterfly<OFF / 2, HALF, STOP>(val, lane, base);
  }
}

// The CTA's tile: the int32 sums of its NT threads' acc over the quad lanes,
// into out [NB][COLS] (shared). Lanes with one column group meet in a
// butterfly (each ends with 16 NB CG / 32 sums), the warps through red
// [NT/32][NB][COLS].
template <int NT, int NB>
__device__ __forceinline__ void tile_sums(int (&acc)[NB][16], int* red, int* out) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cgi = threadIdx.x % CG;
  int val[NB * 16];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 16; ++e) val[b * 16 + e] = acc[b][e];
  int base = 0;
  butterfly<16, NB * 16, CG>(val, lane, base);
  // 32 / CG lanes a column group: 16 NB values halved log2(32 / CG) times
  constexpr int LEFT = NB * 16 * CG / 32;
#pragma unroll
  for (int i = 0; i < LEFT; ++i) {
    const int v = base + i, b = v / 16, e = v % 16;
    red[(warp * NB + b) * COLS + cgi * 16 + e] = val[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NB * COLS; i += NT) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w * NB * COLS + i];
    out[i] = s;
  }
}

// the MACs of one chunk of quads: act is the CTA's int8 activations [NB][kp]
template <int QL, int NB>
__device__ __forceinline__ void mac_chunk(const uint4 (&wr)[NQ][4], const signed char* act,
                                          int kp, int ql, int chunk, int (&acc)[NB][16]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int r = 4 * (ql + (chunk * NQ + i) * QL);
    if (r < kp) {
      int a4[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) a4[b] = *reinterpret_cast<const int*>(act + b * kp + r);
      mac_quad<NB>(wr[i], a4, acc);
    }
  }
}

// act [NB][kp] <- the int8 rows of src (NB rows of `ld` values, bf16 or
// fp32) over the slice k0 .. k0 + kn - 1 at scales xs, zero past kn: 16
// bytes of src a load (kn and k0 multiples of 16 / sizeof(T) values)
__device__ __forceinline__ void load_vals(const bf16* src, float (&v)[8]) {
  Vec8 x;
  x.u = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = to_f(x.h[e]);
}
__device__ __forceinline__ void load_vals(const float* src, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
template <typename T, int NB>
__device__ __forceinline__ void quant_slice(const T* __restrict__ src, int ld, int k0, int kn,
                                            int kp, const float* xs, signed char* act) {
  constexpr int V = 16 / sizeof(T);
  for (int i = threadIdx.x; i < NB * kp / V; i += blockDim.x) {
    const int b = i / (kp / V), k = i % (kp / V) * V;
    float v[V] = {};
    if (k < kn) load_vals(src + (size_t)b * ld + k0 + k, v);
#pragma unroll
    for (int e = 0; e < V; ++e) act[b * kp + k + e] = k < kn ? quant(v[e], xs[b]) : 0;
  }
}

// the slice's rows a thread pass covers, padded: chunks of NQ quads of 4 rows
// for each of QL quad lanes
template <int QL>
__host__ __device__ constexpr int padded(int k) {
  return (k + 4 * NQ * QL - 1) / (4 * NQ * QL) * (4 * NQ * QL);
}

// The weight stream of one tile over the CTA's slice of kn rows (act [NB][kp]
// in shared memory, rows past kn zero): chunks of NQ quads, the first of
// which the caller loaded (wr) before it built act.
template <int NT, int NB>
__device__ __forceinline__ void stream(const int8_t* __restrict__ w, size_t ldw, int k0,
                                       int kn, int kp, uint4 (&wr)[NQ][4],
                                       const signed char* act, int (&acc)[NB][16]) {
  constexpr int QL = NT / CG;
  const int ql = threadIdx.x / CG;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[b][e] = 0;
  const int chunks = kp / (4 * NQ * QL);
  for (int c = 0; c < chunks; ++c) {
    if (c > 0) load_quads<QL>(w, ldw, k0, kn, ql, c, wr);
    mac_chunk<QL, NB>(wr, act, kp, ql, c, acc);
  }
}

// ---------------------------------------------------------------- launch 1

constexpr int NT1 = 128, NT2 = 256, NT3 = 256;
constexpr int HALF = COLS / 2;             // gate-up: gate columns, then as many up

// The cluster's sums: each CTA sends its value of output i (of n, in
// part) to the CTA that owns i through distributed shared memory, into
// recv[its rank][i]; after the cluster's barrier the owner adds them. Output
// i's owner is i % nct, or with `pairs` (gate-up: columns c and c + HALF of
// a row meet in one a) that of the pair, (i / COLS * HALF + i % HALF) % nct. The
// caller arrived at the cluster's barrier (cluster_arrive_relaxed) at its
// start, before its loads, and waits here before the first send. One CTA
// alone only waits for its threads' sums.
__device__ __forceinline__ int owner(int i, int nct, bool pairs) {
  return (pairs ? i / COLS * HALF + i % HALF : i) % nct;
}
__device__ __forceinline__ void send_parts(const int* part, int n, int* recv, int rank,
                                           int nct, int nt, bool pairs) {
  if (nct == 1) {
    __syncthreads();
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  for (int i = threadIdx.x; i < n; i += nt)
    *cluster.map_shared_rank(recv + rank * n + i, owner(i, nct, pairs)) = part[i];
  cluster.sync();
}

template <int NB>
__global__ void __launch_bounds__(NT1) q8_oproj_kernel(const Q8Args p) {
  constexpr int QL = NT1 / CG, N = NB * COLS, NW = NT1 / 32;
  extern __shared__ __align__(16) signed char act[];   // [NB][kp], then red, recv
  __shared__ int part[N];
  __shared__ float scratch[NW], xs[NB];
  const int nct = gridDim.x;
  const int rank = nct > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, ql = tid / CG;
  const int k0 = rank * p.k1, kn = min(p.A - k0, p.k1), kp = padded<QL>(p.k1);
  int* red = reinterpret_cast<int*>(act + NB * kp);    // [NW][N]
  int* recv = red + NW * N;                            // [nct][N]
  const int n0 = blockIdx.y * COLS, nw = n0 + (tid % CG) * 16;
  const int8_t* w = nw < p.H ? p.wo + nw : nullptr;
  uint4 wr[NQ][4];
  load_quads<QL>(w, p.H, k0, kn, ql, 0, wr);
  // the operands of the outputs this thread will own: x and the scale
  constexpr int OWN = (N + NT1 - 1) / NT1;
  float own_x[OWN], own_s[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int i = rank + (tid + o * NT1) * nct, n = n0 + i % COLS;
    const bool mine = i < N && n < p.H;
    own_x[o] = mine ? to_f(p.x[(size_t)(i / COLS) * p.H + n]) : 0.f;
    own_s[o] = mine ? p.so[n] : 0.f;
  }
  if (nct > 1) cluster_arrive_relaxed();

  // each att row's amax over the whole row (4 KB at A 2048, read by every
  // CTA, 8 values a 16-byte load); each CTA quantizes only its own slice
  for (int b = 0; b < NB; ++b) {
    const uint4* row = reinterpret_cast<const uint4*>(p.att + (size_t)b * p.A);
    float m = 0.f;
#pragma unroll 4
    for (int c = tid; c < p.A / 8; c += NT1) {
      Vec8 v;
      v.u = __ldg(row + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(to_f(v.h[e])));
    }
    m = block_max<NT1>(m, scratch);
    if (tid == 0) xs[b] = __fmul_rn(fmaxf(m, 1e-8f), INV_127);
  }
  __syncthreads();
  quant_slice<bf16, NB>(p.att, p.A, k0, kn, kp, xs, act);
  __syncthreads();

  int acc[NB][16];
  stream<NT1, NB>(w, p.H, k0, kn, kp, wr, act, acc);
  tile_sums<NT1, NB>(acc, red, part);
  send_parts(part, N, recv, rank, nct, NT1, false);

  // x2 = x + (acc * xs) * so over the cluster's slices, on the owner rank
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int i = rank + (tid + o * NT1) * nct;
    const int b = i / COLS, n = n0 + i % COLS;
    if (i >= N || n >= p.H) continue;
    int s = nct > 1 ? 0 : part[i];
    for (int r = 0; r < nct && nct > 1; ++r) s += recv[r * N + i];
    const float y = rnd(__fmul_rn(__fmul_rn(__int2float_rn(s), xs[b]), own_s[o]));
    p.x2[(size_t)b * p.H + n] = to_bf(own_x[o] + y);
  }
}

// ---------------------------------------------------------------- launch 2

template <int NB>
__global__ void __launch_bounds__(NT2) q8_gateup_kernel(const Q8Args p) {
  constexpr int QL = NT2 / CG, NW = NT2 / 32, PER = MAX_H / NT2, N = NB * COLS;
  extern __shared__ __align__(16) signed char act[];   // [NB][kp], then x2s, red, recv
  __shared__ int part[N];
  __shared__ float scratch[NW], rs_s[NB], hs[NB];
  const int nct = gridDim.x;
  const int rank = nct > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, ql = tid / CG, H = p.H;
  const int k0 = rank * p.k2, kn = min(H - k0, p.k2), kp = padded<QL>(p.k2);
  bf16* x2s = reinterpret_cast<bf16*>(act + NB * kp);    // [NB][H], the x2 rows
  int* red = reinterpret_cast<int*>(x2s + NB * H);        // [NW][N]
  int* recv = red + NW * N;                               // [nct][N]
  // column groups 0 .. CG/2 - 1: gate columns f0 + 16 g; the rest the
  // matching up columns F + f0 + ...
  const int f0 = blockIdx.y * HALF, cgi = tid % CG;
  const int fw = f0 + (cgi % (CG / 2)) * 16;
  const int8_t* w = fw < p.F ? p.wgu + (cgi < CG / 2 ? 0 : p.F) + fw : nullptr;
  uint4 wr[NQ][4];
  load_quads<QL>(w, 2 * (size_t)p.F, k0, kn, ql, 0, wr);
  for (int c = tid; c < NB * H / 8; c += NT2) cp_async16(smem_u32(x2s + c * 8), p.x2 + c * 8);
  cp_commit();
  // the scales of the gate / up pairs this thread will own
  constexpr int OWN = (NB * HALF + NT2 - 1) / NT2;
  float own_g[OWN], own_u[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int pr = rank + (tid + o * NT2) * nct, f = f0 + pr % HALF;
    const bool mine = pr < NB * HALF && f < p.F;
    own_g[o] = mine ? p.sgu[f] : 0.f;
    own_u[o] = mine ? p.sgu[p.F + f] : 0.f;
  }
  if (nct > 1) cluster_arrive_relaxed();
  cp_wait_all();
  __syncthreads();

  // per row: the sum of squares of x2 in the earlier form's order (lane t
  // over columns t, t + 256, ..., a butterfly, the 8 warps in order), the
  // amax of the normed row, its scale; then this CTA's slice quantized
  for (int b = 0; b < NB; ++b) {
    const bf16* xr = x2s + b * H;
    float ss = 0.f, m = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = tid + i * NT2;
      if (n >= H) break;
      const float v = to_f(xr[n]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    __syncthreads();
    if ((tid & 31) == 0) scratch[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) ss += scratch[i];
    const float rs = __fdiv_rn(1.f, sqrtf(__fadd_rn(__fdiv_rn(ss, (float)H), p.eps)));
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = tid + i * NT2;
      if (n >= H) break;
      m = fmaxf(m, fabsf(__fmul_rn(to_f(xr[n]), rs)));
    }
    m = block_max<NT2>(m, scratch);
    if (tid == 0) {
      rs_s[b] = rs;
      hs[b] = __fmul_rn(fmaxf(m, 1e-8f), INV_127);
    }
  }
  __syncthreads();
  for (int i = tid; i < NB * kp; i += NT2) {
    const int b = i / kp, k = i % kp;
    act[i] = k < kn ? quant(__fmul_rn(to_f(x2s[b * H + k0 + k]), rs_s[b]), hs[b])
                    : (signed char)0;
  }
  __syncthreads();

  int acc[NB][16];
  stream<NT2, NB>(w, 2 * (size_t)p.F, k0, kn, kp, wr, act, acc);
  tile_sums<NT2, NB>(acc, red, part);
  send_parts(part, N, recv, rank, nct, NT2, true);

  // a = silu(g) * u over the cluster's slices, on the owner rank of the
  // pair of g's column (part[i], i % COLS < HALF) and u's (part[i + HALF])
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int pr = rank + (tid + o * NT2) * nct;
    const int b = pr / HALF, c = pr % HALF, f = f0 + c, i = b * COLS + c;
    if (pr >= NB * HALF || f >= p.F) continue;
    int gs = nct > 1 ? 0 : part[i], us = nct > 1 ? 0 : part[i + HALF];
    for (int r = 0; r < nct && nct > 1; ++r) {
      gs += recv[r * N + i];
      us += recv[r * N + i + HALF];
    }
    const float g = __fmul_rn(__fmul_rn(__int2float_rn(gs), hs[b]), own_g[o]);
    const float u = __fmul_rn(__fmul_rn(__int2float_rn(us), hs[b]), own_u[o]);
    p.a[(size_t)b * p.F + f] = __fmul_rn(silu(g), u);
  }
}

// ---------------------------------------------------------------- launch 3

template <int NB>
__global__ void __launch_bounds__(NT3) q8_down_kernel(const Q8Args p) {
  constexpr int QL = NT3 / CG, N = NB * COLS, NW = NT3 / 32;
  extern __shared__ __align__(16) signed char act[];   // [NB][kp], then red, recv, xs_recv
  __shared__ int part[MAX_PASSES][N];
  __shared__ float scratch[NW], xs[MAX_PASSES][NB];
  const int nct = gridDim.x;
  const int rank = nct > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, ql = tid / CG;
  const int kp = padded<QL>(p.k3), nsub = p.F / p.k3;
  int* red = reinterpret_cast<int*>(act + NB * kp);    // [NW][N]
  int* recv = red + NW * N;                            // [nsub][N]
  float* xs_recv = reinterpret_cast<float*>(recv + nsub * N);   // [F / fb][NB]
  const int n0 = blockIdx.y * COLS, nw = n0 + (tid % CG) * 16;
  const int8_t* w = nw < p.H ? p.wd + nw : nullptr;
  // the operands of the outputs this thread will own: x2 and the scale
  constexpr int OWN = (N + NT3 - 1) / NT3;
  float own_x[OWN], own_s[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int i = rank + (tid + o * NT3) * nct, n = n0 + i % COLS;
    const bool mine = i < N && n < p.H;
    own_x[o] = mine ? to_f(p.x2[(size_t)(i / COLS) * p.H + n]) : 0.f;
    own_s[o] = mine ? p.sd[n] : 0.f;
  }
  if (nct > 1) cluster_arrive_relaxed();

  // sub-blocks rank, rank + nct, ...: each one pass
  int passes = 0;
  for (int pass = 0; pass < MAX_PASSES; ++pass) {
    const int sb = rank + pass * nct;
    if (sb >= nsub) break;
    ++passes;
    const int k0 = sb * p.k3, j0 = k0 / p.fb * p.fb;
    uint4 wr[NQ][4];
    load_quads<QL>(w, p.H, k0, p.k3, ql, 0, wr);
    // the amax of the F-block's a row (the same in every CTA of the block),
    // 4 values a 16-byte load
    for (int b = 0; b < NB; ++b) {
      const float4* row = reinterpret_cast<const float4*>(p.a + (size_t)b * p.F + j0);
      float m = 0.f;
#pragma unroll 4
      for (int c = tid; c < p.fb / 4; c += NT3) {
        const float4 v = row[c];
        m = fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
      }
      m = block_max<NT3>(m, scratch);
      if (tid == 0) xs[pass][b] = __fmul_rn(fmaxf(m, 1e-8f), INV_127);
    }
    __syncthreads();
    quant_slice<float, NB>(p.a, p.F, k0, p.k3, kp, xs[pass], act);
    __syncthreads();
    int acc[NB][16];
    stream<NT3, NB>(w, p.H, k0, p.k3, kp, wr, act, acc);
    tile_sums<NT3, NB>(acc, red, part[pass]);
    __syncthreads();
  }

  // every sub-block's sums to the owner ranks of its outputs, and every
  // F-block's scale (from its first sub-block) to all ranks
  const int per = p.fb / p.k3;  // sub-blocks an F-block
  if (nct > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    for (int pass = 0; pass < passes; ++pass) {
      const int sb = rank + pass * nct;
      for (int i = tid; i < N; i += NT3)
        *cluster.map_shared_rank(recv + sb * N + i, i % nct) = part[pass][i];
      if (sb % per == 0 && tid < NB * nct)
        *cluster.map_shared_rank(xs_recv + sb / per * NB + tid % NB, tid / NB) =
            xs[pass][tid % NB];
    }
    cluster.sync();
  } else {
    for (int sb = 0; sb < nsub; ++sb) {
      for (int i = tid; i < N; i += NT3) recv[sb * N + i] = part[sb][i];
      if (sb % per == 0 && tid < NB) xs_recv[sb / per * NB + tid] = xs[sb][tid];
    }
    __syncthreads();
  }

  // per F-block in order: its sub-blocks' int32 sums, rescaled, added in
  // fp32; then the residual, on the owner rank
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int i = rank + (tid + o * NT3) * nct;
    const int b = i / COLS, n = n0 + i % COLS;
    if (i >= N || n >= p.H) continue;
    float accf = 0.f;
    for (int sb = 0; sb < nsub; sb += per) {
      int s = 0;
      for (int q = sb; q < sb + per; ++q) s += recv[q * N + i];
      accf = __fadd_rn(accf, __fmul_rn(__int2float_rn(s), xs_recv[sb / per * NB + b]));
    }
    const float y = rnd(__fmul_rn(accf, own_s[o]));
    p.out[(size_t)b * p.H + n] = to_bf(own_x[o] + y);
  }
}

// ---------------------------------------------------------------- host side

template <typename K>
cudaError_t launch_tail(K kernel, int ctas, int tiles, int threads, size_t smem,
                        cudaStream_t st, const Q8Args& p, int (&big)[MAX_DEVICES],
                        int (&wide)[MAX_DEVICES]) {
  cudaError_t err = raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem,
                               big);
  if (err != cudaSuccess) return err;
  if (ctas == 1) {
    kernel<<<dim3(1, tiles), threads, smem, st>>>(p);
    return cudaGetLastError();
  }
  if (ctas > 8)  // past the portable cluster size
    err = raise_attr(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1, wide);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, dim3(ctas, tiles), threads, smem, st, ctas, p);
}

template <int NB>
int run(const Q8Args& p, int c1, int c2, int c3, cudaStream_t st) {
  static int b1[MAX_DEVICES], b2[MAX_DEVICES], b3[MAX_DEVICES];
  static int w1[MAX_DEVICES], w2[MAX_DEVICES], w3[MAX_DEVICES];
  cudaError_t err;
  constexpr size_t N = sizeof(int) * NB * COLS;  // a CTA's sums, bytes
  const int tiles = (p.H + COLS - 1) / COLS;
  const size_t s1 = (size_t)NB * padded<NT1 / CG>(p.k1) + (NT1 / 32 + c1) * N;
  const size_t s2 = (size_t)NB * padded<NT2 / CG>(p.k2) + sizeof(bf16) * NB * p.H +
                    (NT2 / 32 + c2) * N;
  const size_t s3 = (size_t)NB * padded<NT3 / CG>(p.k3) + (NT3 / 32 + p.F / p.k3) * N +
                    sizeof(float) * NB * (p.F / p.fb);
  if ((err = launch_tail(q8_oproj_kernel<NB>, c1, tiles, NT1, s1, st, p, b1, w1)))
    return (int)err;
  if ((err = launch_tail(q8_gateup_kernel<NB>, c2, (p.F + HALF - 1) / HALF, NT2, s2, st, p, b2,
                         w2)))
    return (int)err;
  return (int)launch_tail(q8_down_kernel<NB>, c3, tiles, NT3, s3, st, p, b3, w3);
}

// a cut of `dim` input rows into `ctas` slices of `k` rows (multiples of 8:
// a thread's row quads, 16-byte loads of bf16 att; in order, none empty,
// the last the shorter)
bool cut_ok(int dim, int ctas, int k) {
  return ctas >= 1 && ctas <= MAX_CTAS && k >= 8 && k % 8 == 0 && (long long)ctas * k >= dim &&
         (long long)(ctas - 1) * k < dim;
}

}  // namespace
}  // namespace tts

// x (B, H), att (B, A) bf16; wo (A, H), w_gate_up (H, 2F), w_down (F, H)
// int8 with fp32 per-column scales so (H,), sgu (2F,), sd (H,); scratch:
// x2 (B, H) bf16, a (B, F) fp32; out (B, H) bf16; fb the F-block of a's
// quantization. B 1..8, A % 8 == 0, H and F multiples of 32, H <= 4096,
// F <= 4096. The form, from ops/decode_mlp.q8_tail_plan: launch 1 cuts A
// into c1 slices of k1 rows, launch 2 cuts H into c2 slices of k2 rows,
// launch 3 cuts F into sub-blocks of k3 rows (k3 divides fb) over c3 CTAs
// (each sub-block one CTA's pass, at most 2 a CTA); any other form is
// refused.
extern "C" int fused_out_mlp_q8(const void* x, const void* att, const void* wo,
                                const void* wgu, const void* wd, const void* so,
                                const void* sgu, const void* sd, void* x2, void* a, void* out,
                                int B, int A, int H, int F, int fb, int c1, int k1, int c2,
                                int k2, int c3, int k3, float eps, void* stream) {
  using tts::bf16;
  const bool shapes = B >= 1 && B <= 8 && A % 8 == 0 && H % 32 == 0 && F % 32 == 0 &&
                      H >= 32 && H <= tts::MAX_H && F >= 32 && F <= 4096 && fb >= 32 &&
                      fb % 32 == 0 && F % fb == 0 && so && sgu && sd;
  const int nsub = k3 > 0 ? F / k3 : 0;
  const bool form = tts::cut_ok(A, c1, k1) && tts::cut_ok(H, c2, k2) && k3 >= 4 &&
                    k3 % 4 == 0 && fb % k3 == 0 && c3 >= 1 && c3 <= tts::MAX_CTAS &&
                    c3 <= nsub && (nsub + c3 - 1) / c3 <= tts::MAX_PASSES;
  if (!shapes || !form) return (int)cudaErrorInvalidValue;
  tts::Q8Args p{(const bf16*)x, (const bf16*)att, (const int8_t*)wo, (const int8_t*)wgu,
                (const int8_t*)wd, (const float*)so, (const float*)sgu, (const float*)sd,
                (bf16*)x2, (float*)a, (bf16*)out, A, H, F, fb, k1, k2, k3, eps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (B) {
    case 1: return tts::run<1>(p, c1, c2, c3, st);
    case 2: return tts::run<2>(p, c1, c2, c3, st);
    case 3: return tts::run<3>(p, c1, c2, c3, st);
    case 4: return tts::run<4>(p, c1, c2, c3, st);
    case 5: return tts::run<5>(p, c1, c2, c3, st);
    case 6: return tts::run<6>(p, c1, c2, c3, st);
    case 7: return tts::run<7>(p, c1, c2, c3, st);
    default: return tts::run<8>(p, c1, c2, c3, st);
  }
}
