// Flash attention on roped (B, H, S, D) q, k and v, for the F5 DiT's head
// geometries that the flat kernel does not take and for sequences past it.
//
// Replaces two paths of tts_tpu/ops/flash_attention.py:flash_attention:
//   * kernel 4, the single pass (Pallas body _kernel_onepass): the whole key
//     row at once, s * f32(scale * log2e) clamped at +100 plus a bias row of
//     -30 (valid keys) or -1e30 (keys >= kv_len[b]), exp2 with no row max,
//     l = sum(p) + 1e-37, bf16(P).V, then o / l; output (B, H, S, D) or
//     packed (B, S, H*D);
//   * kernel 5, the online softmax (Pallas body _kernel): scores times
//     scale, -1e30 at masked keys before a running row max m (from -1e30),
//     p = exp(s - m_new), alpha = exp(m - m_new), l = l alpha + sum(p),
//     acc = acc alpha + bf16(P).V, acc / l at the end.
// Both take bf16 or fp32 (true fp32 products on the CUDA cores, no TF32),
// with D a multiple of 64 up to 256. P is rounded to v's dtype before the
// P.V dot, as the TPU kernel casts it.
//
// Kernel 5 in bf16 is the flash core (flash_core.cuh) in ONLINE mode: S, P
// and O in registers (wgmma), cp.async double-buffered K and V tiles.
// The other three forms (kernel 4 in bf16, both in fp32): a CTA takes 64
// query rows of one (b, h) and streams 64-key tiles of k and v through
// shared memory.
// Kernel 4's fixed exp2 shift needs no rescale, so its sums split over kv
// tiles exactly (as in kernel 1); kernel 5 keeps the running max and
// rescales its accumulator row by alpha each tile. The TPU grid's kv axis
// becomes the CTA's loop. Kv tiles wholly past kv_len are skipped: their p
// are exact zeros in kernel 4, and in kernel 5 too once a valid key has set
// a finite max (kv_len >= 1). With kv_len 0, kernel 5 runs every tile, so
// each row gets the mean of v over all S keys (every score is -1e30, as in
// tts_tpu), while kernel 4 gives zeros (its 1e-37 guard).
//
// What bounds it on an H100: the dots, 4 S kv_len D flops a head (bf16
// tensor cores at 989 TFLOP/s, or fp32 CUDA cores at 67), and in bf16 at D
// 64 as much the one exp a score on the SFUs. Kernel 4's bf16 form keeps
// its WMMA accumulator in shared memory (a WMMA fragment has no exposed
// element layout) and does not overlap loads with dots, so it runs far
// below either peak; its contract is the core's FIXED mode. The fp32 forms
// give each of 256 threads a 4 x 4 score tile and a 4 x D/16 output tile,
// with q, k and v rows padded to D + 1 floats against bank conflicts. No
// atomics: bitwise reproducible run to run.
#include "flash_core.cuh"

namespace tts {
namespace {

constexpr int BQ = 64;    // query rows a CTA
constexpr int BKV = 64;   // keys a tile
constexpr float NEG = -1e30f;

struct MhaArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;  // (B,)
  void* out;
  float c;            // kernel 4: f32(scale * log2e); kernel 5: scale
  int H, S, packed;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// element offset of (b, h, row, 0) in the output
template <int D>
__device__ __forceinline__ size_t out_offset(const MhaArgs& a, int b, int h, int row) {
  return a.packed ? (((size_t)b * a.S + row) * a.H + h) * D
                  : (((size_t)b * a.H + h) * a.S + row) * D;
}

__device__ __forceinline__ int kv_limit(const MhaArgs& a, int b, bool online, int* kvl) {
  *kvl = min(max(a.kv_len[b], 0), a.S);
  return online && *kvl == 0 ? a.S : *kvl;
}

// ------------------------------------------------------- bf16 kernel 5

template <int D>
__global__ void __launch_bounds__(flash::CTA_THREADS) mha_online_kernel(const flash::Args a) {
  flash::attend<D, flash::ONLINE>(a);
}

// ------------------------------------------------------- bf16 kernel 4

constexpr int NT16 = 128;  // 4 warps, 16 query rows each

template <int D>
constexpr size_t smem_bf16() {
  return (size_t)(BQ + 2 * BKV) * D * sizeof(bf16) + (size_t)BQ * BKV * sizeof(float) +
         (size_t)BQ * BKV * sizeof(bf16) + (size_t)BQ * D * sizeof(float);
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, int n, int nt) {
  for (int i = threadIdx.x * 8; i < n; i += nt * 8)
    *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
}

template <int D>
__global__ void __launch_bounds__(NT16) mha_bf16_kernel(MhaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * D;
  bf16* vs = ks + BKV * D;
  float* ss = reinterpret_cast<float*>(vs + BKV * D);
  bf16* ps = reinterpret_cast<bf16*>(ss + BQ * BKV);
  float* os = reinterpret_cast<float*>(ps + BQ * BKV);  // the P.V accumulator

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = ((size_t)b * a.H + h) * a.S * D;
  const bf16* kg = reinterpret_cast<const bf16*>(a.k) + head;
  const bf16* vg = reinterpret_cast<const bf16*>(a.v) + head;
  int kvl;
  const int kv_end = kv_limit(a, b, false, &kvl);

  copy16(qs, reinterpret_cast<const bf16*>(a.q) + head + (size_t)q0 * D, BQ * D, NT16);
  for (int i = threadIdx.x; i < BQ * D; i += NT16) os[i] = 0.f;

  const bf16* qw = qs + warp * 16 * D;
  float* sw = ss + warp * 16 * BKV;
  bf16* pw = ps + warp * 16 * BKV;
  float* ow = os + warp * 16 * D;
  float lr[16];  // this lane's share of each row's sum of p
#pragma unroll
  for (int r = 0; r < 16; ++r) lr[r] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // q staged; every warp is done with the last k, v tiles
    copy16(ks, kg + (size_t)k0 * D, BKV * D, NT16);
    copy16(vs, vg + (size_t)k0 * D, BKV * D, NT16);
    __syncthreads();

    // S = Q K^T, 16 rows x 64 keys a warp
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        FragA qa;
        FragBt kb;
        wmma::load_matrix_sync(qa, qw + kk * 16, D);
        wmma::load_matrix_sync(kb, ks + n * 16 * D + kk * 16, D);
        wmma::mma_sync(s, qa, kb, s);
      }
      wmma::store_matrix_sync(sw + n * 16, s, BKV, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float s0 = sw[r * BKV + lane], s1 = sw[r * BKV + lane + 32];
      const bool v0 = k0 + lane < kvl, v1 = k0 + lane + 32 < kvl;
      const float p0 = exp2f(fminf(s0 * a.c, 100.f) + (v0 ? -30.f : NEG));
      const float p1 = exp2f(fminf(s1 * a.c, 100.f) + (v1 ? -30.f : NEG));
      lr[r] += p0 + p1;
      pw[r * BKV + lane] = to_bf(p0);
      pw[r * BKV + lane + 32] = to_bf(p1);
    }
    __syncwarp();

    // O += bf16(P) V, the accumulator through shared memory
#pragma unroll 2
    for (int n = 0; n < D / 16; ++n) {
      FragC acc;
      wmma::load_matrix_sync(acc, ow + n * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        FragA pa;
        FragB vb;
        wmma::load_matrix_sync(pa, pw + kk * 16, BKV);
        wmma::load_matrix_sync(vb, vs + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(ow + n * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();  // the zeroed accumulator when no tile ran

  bf16* out = reinterpret_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float l = warp_sum(lr[r]) + 1e-37f;
    bf16* o = out + out_offset<D>(a, b, h, q0 + warp * 16 + r);
    for (int c = lane; c < D; c += 32) o[c] = to_bf(ow[r * D + c] / l);
  }
}

// ---------------------------------------------------------------- fp32

constexpr int NT32 = 256;  // a 16 x 16 grid of threads

template <int D>
constexpr size_t smem_f32() {
  return ((size_t)(BQ + BKV) * (D + 1) + (size_t)BQ * (BKV + 1) + 2 * BQ) * sizeof(float);
}

template <int D, bool ONLINE>
__global__ void __launch_bounds__(NT32) mha_f32_kernel(MhaArgs a) {
  constexpr int LD = D + 1, SL = BKV + 1, DJ = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = qs + BQ * LD;        // the k tile, then the v tile
  float* ss = kvs + BKV * LD;       // scores, then p
  float* alpha_s = ss + BQ * SL;    // kernel 5: each row's rescale this tile
  float* l_s = alpha_s + BQ;        // each row's normaliser, at the end

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = ((size_t)b * a.H + h) * a.S * D;
  const float* kg = reinterpret_cast<const float*>(a.k) + head;
  const float* vg = reinterpret_cast<const float*>(a.v) + head;
  int kvl;
  const int kv_end = kv_limit(a, b, ONLINE, &kvl);

  const float* qg = reinterpret_cast<const float*>(a.q) + head + (size_t)q0 * D;
  for (int i = threadIdx.x; i < BQ * D; i += NT32) qs[(i / D) * LD + i % D] = qg[i];

  // thread (ty, tx) owns output rows ty + 16 i and columns tx + 16 j;
  // warp w owns the softmax of rows 8 w .. 8 w + 7
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  float lr[8], mr[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) lr[r] = 0.f, mr[r] = NEG;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // q staged; the last tile's P.V is done with kvs and ss
    for (int i = threadIdx.x; i < BKV * D; i += NT32)
      kvs[(i / D) * LD + i % D] = kg[(size_t)k0 * D + i];
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ss[(ty + 16 * i) * SL + tx + 16 * j] = s[i][j];
    __syncthreads();  // scores in; every thread is done reading the k tile

    for (int i = threadIdx.x; i < BKV * D; i += NT32)
      kvs[(i / D) * LD + i % D] = vg[(size_t)k0 * D + i];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      float s0 = ss[r * SL + lane], s1 = ss[r * SL + lane + 32];
      const bool v0 = k0 + lane < kvl, v1 = k0 + lane + 32 < kvl;
      float p0, p1;
      if (ONLINE) {
        s0 = v0 ? s0 * a.c : NEG;
        s1 = v1 ? s1 * a.c : NEG;
        const float mn = fmaxf(mr[rr], warp_max(fmaxf(s0, s1)));
        const float alpha = expf(mr[rr] - mn);
        p0 = expf(s0 - mn);
        p1 = expf(s1 - mn);
        lr[rr] = lr[rr] * alpha + warp_sum(p0 + p1);
        mr[rr] = mn;
        if (lane == 0) alpha_s[r] = alpha;
      } else {
        p0 = exp2f(fminf(s0 * a.c, 100.f) + (v0 ? -30.f : NEG));
        p1 = exp2f(fminf(s1 * a.c, 100.f) + (v1 ? -30.f : NEG));
        lr[rr] += p0 + p1;
      }
      ss[r * SL + lane] = p0;
      ss[r * SL + lane + 32] = p1;
    }
    __syncthreads();  // p, alpha and the v tile in

    if (ONLINE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = alpha_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] *= al;
      }
    }
#pragma unroll 2
    for (int n = 0; n < BKV; ++n) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ss[(ty + 16 * i) * SL + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vb = kvs[n * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pa[i], vb, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const float l = ONLINE ? lr[rr] : warp_sum(lr[rr]) + 1e-37f;
    if (lane == 0) l_s[warp * 8 + rr] = l;
  }
  __syncthreads();
  float* out = reinterpret_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
    float* orow = out + out_offset<D>(a, b, h, q0 + r);
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = o[i][j] / l;
  }
}

// ---------------------------------------------------------------- launch

// kernel 5 in bf16: the core on contiguous (B, H, S, D) q, k, v and out
template <int D>
int launch_online_bf16(const MhaArgs& m, int B, cudaStream_t stream) {
  static bool attr_set = false;
  constexpr size_t smem = flash::smem_bytes<D>();
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_online_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long head = (long long)m.S * D;
  flash::Args a;
  a.q = static_cast<const bf16*>(m.q);
  a.k = static_cast<const bf16*>(m.k);
  a.v = static_cast<const bf16*>(m.v);
  a.out = static_cast<bf16*>(m.out);
  a.q_b = a.k_b = a.v_b = a.o_b = m.H * head;
  a.q_h = a.k_h = a.v_h = a.o_h = head;
  a.q_r = a.k_r = a.v_r = a.o_r = D;
  a.kv_len = m.kv_len;
  a.c = (float)((double)m.c * 1.4426950408889634);  // scale * log2e
  a.S = m.S;
  const int tiles = (m.S + flash::CTA_ROWS - 1) / flash::CTA_ROWS;
  mha_online_kernel<D><<<dim3(tiles, m.H, B), flash::CTA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool ONLINE, bool F32>
int launch_one(const MhaArgs& a, int B, cudaStream_t stream) {
  if constexpr (ONLINE && !F32) return launch_online_bf16<D>(a, B, stream);
  static bool attr_set = false;
  const size_t smem = F32 ? smem_f32<D>() : smem_bf16<D>();
  auto kernel = F32 ? mha_f32_kernel<D, ONLINE> : mha_bf16_kernel<D>;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(a.S / BQ, a.H, B);
  kernel<<<grid, F32 ? NT32 : NT16, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool ONLINE>
int launch(const MhaArgs& a, int B, int D, int fp32, cudaStream_t s) {
  if (a.S % BQ) return (int)cudaErrorInvalidValue;
  switch (D * 2 + (fp32 ? 1 : 0)) {
    case 128: return launch_one<64, ONLINE, false>(a, B, s);
    case 129: return launch_one<64, ONLINE, true>(a, B, s);
    case 256: return launch_one<128, ONLINE, false>(a, B, s);
    case 257: return launch_one<128, ONLINE, true>(a, B, s);
    case 384: return launch_one<192, ONLINE, false>(a, B, s);
    case 385: return launch_one<192, ONLINE, true>(a, B, s);
    case 512: return launch_one<256, ONLINE, false>(a, B, s);
    case 513: return launch_one<256, ONLINE, true>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

MhaArgs make_args(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                  float c, int H, int S, int packed) {
  MhaArgs a;
  a.q = q, a.k = k, a.v = v, a.kv_len = (const int*)kv_len, a.out = out;
  a.c = c, a.H = H, a.S = S, a.packed = packed;
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
