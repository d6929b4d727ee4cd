// The weight stream of the decode kernels 14 (decode_mlp.cu) and 11 and
// 12's first launch (decode_qkv.cu): a matvec of M = 1..8 activation rows
// against a weight that is read once, spread over the whole card.
//
//  * A CTA of NT threads takes a column tile of CG x 16 contiguous bytes of
//    each weight row (CG column groups of one 16-byte load: 8 bf16 or 16
//    int8 columns; the card streamed 16- and 32-byte row pieces at a
//    fraction of the rate of 128-byte ones) over a slice of the input dim;
//    the CTAs of one tile form a thread-block cluster along that dim (at
//    most MAX_CTAS, the portable size), cut on the host from the SM count.
//  * A thread issues its NR 16-byte row loads before anything else; int8
//    values turn into fp32 by a byte permute into a float's mantissa and
//    one exact subtraction (no conversion instruction), bf16 by a shift.
//  * The lanes of a column meet by a transposing butterfly, the warps
//    through shared memory in order; each CTA sends its fp32 sums through
//    distributed shared memory to the CTA of the cluster that owns each
//    output (one cluster barrier, its first half arrived at right after
//    the loads), and the owner adds them in rank order. No atomics: runs
//    repeat bitwise.
//  * Programmatic dependent launch (where the caller asks for it): a launch
//    issues its weight loads, lets the next launch start
//    (griddepcontrol.launch_dependents) and only then waits for the
//    previous one (griddepcontrol.wait) before it reads its activations, so
//    its weight loads run under the previous launch's tail. Before the wait
//    a launch reads only parameters (weights, scales, biases, norm
//    vectors), which no kernel writes.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace tts {
namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256, NW = NT / 32;
constexpr int MAX_CTAS = 8;      // the portable cluster size

// columns a 16-byte load holds, and the 16-byte row loads a thread keeps in
// flight (int8 at B > 4: 8, or its 16 NB accumulators spill)
template <typename W>
__host__ __device__ constexpr int vals() { return 16 / (int)sizeof(W); }
template <typename W, int NB>
__host__ __device__ constexpr int rows_in_flight() { return sizeof(W) == 1 && NB > 4 ? 8 : 16; }

// the 16-byte load's values in fp32: bf16 by a shift; int8 by a byte
// permute into the mantissa of 2^23 (0x4B0000uu is 2^23 + uu, uu = v + 128)
// and one exact subtraction
__device__ __forceinline__ void unpack(const uint4& v, const bf16*, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, const int8_t*, float (&f)[16]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = w[j] ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[4 * j + e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.f;
  }
}

// rows row0 + i QL (i < NR, QL = NT / CG row lanes) of the slice of kn rows
// at row k0 of w (row stride ldw, w already at the thread's column group);
// rows past kn, and every row of a null w (a column group past the
// matrix's edge), read as 0
template <typename W, int CG, int NR>
__device__ __forceinline__ void load_rows(const W* __restrict__ w, size_t ldw, int k0, int kn,
                                          int row0, uint4 (&wr)[NR]) {
  constexpr int QL = NT / CG;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row0 + i * QL;
    wr[i] = r < kn && w ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ldw))
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[b][e] += act[b][r] * w[r][e] over the thread's NR rows, act the CTA's
// bf16 activations [NB][kp] (zero past the slice)
template <typename W, int CG, int NB, int NR>
__device__ __forceinline__ void mac_rows(const uint4 (&wr)[NR], const bf16* act, int kp,
                                         int row0, float (&acc)[NB][vals<W>()]) {
  constexpr int V = vals<W>(), QL = NT / CG;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row0 + i * QL;
    float f[V];
    unpack(wr[i], (const W*)nullptr, f);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float av = to_f(act[b * kp + r]);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[b][e] = fmaf(av, f[e], acc[b][e]);
    }
  }
}

// The weight stream of the thread's column group over the slice: chunks of
// NR rows a row lane, the first of which the caller loaded (wr) before it
// built act
template <typename W, int CG, int NB, int NR>
__device__ __forceinline__ void stream(const W* __restrict__ w, size_t ldw, int k0, int kn,
                                       int kp, uint4 (&wr)[NR], const bf16* act,
                                       float (&acc)[NB][vals<W>()]) {
  constexpr int QL = NT / CG;
  const int ql = threadIdx.x / CG;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < vals<W>(); ++e) acc[b][e] = 0.f;
  for (int c = 0; c * QL * NR < kp; ++c) {
    if (c > 0) load_rows<W, CG, NR>(w, ldw, k0, kn, ql + c * QL * NR, wr);
    mac_rows<W, CG, NB, NR>(wr, act, kp, ql + c * QL * NR, acc);
  }
}

// One step of a transposing butterfly over the lanes OFF apart, on CNT
// values a lane, then the next down to the offset STOP: each lane sends the
// half it does not keep and adds the partner's copy of the half it keeps
// (the upper lane keeps the upper half; `base` counts the values it passed
// over). The order of each sum is fixed: runs repeat bitwise.
template <int OFF, int CNT, int STOP>
__device__ __forceinline__ void butterfly(float* val, int lane, int& base) {
  if constexpr (OFF >= STOP) {
    constexpr int HALF = CNT / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float sent = upper ? val[i] : val[i + HALF];
      const float kept = upper ? val[i + HALF] : val[i];
      val[i] = kept + __shfl_xor_sync(0xffffffffu, sent, OFF);
    }
    base += upper ? HALF : 0;
    butterfly<OFF / 2, HALF, STOP>(val, lane, base);
  }
}

// The CTA's tile: the sums of its threads' acc over the row lanes, into out
// [NB][CG V] (shared). Lanes of one column group meet in a butterfly, the
// warps through red [NW][NB][CG V] in order.
template <int CG, int NB, int V>
__device__ __forceinline__ void tile_sums(float (&acc)[NB][V], float* red, float* out) {
  constexpr int COLS = CG * V, N = NB * COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cgi = threadIdx.x % CG;
  float val[NB * V];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < V; ++e) val[b * V + e] = acc[b][e];
  int base = 0;
  butterfly<16, NB * V, CG>(val, lane, base);
  constexpr int LEFT = NB * V * CG / 32;   // 32 / CG lanes a group: halved log2(32 / CG) times
#pragma unroll
  for (int i = 0; i < LEFT; ++i) {
    const int v = base + i, b = v / V, e = v % V;
    red[(warp * NB + b) * COLS + cgi * V + e] = val[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w * N + i];
    out[i] = s;
  }
}

// The cluster's sums: each CTA sends its value of output i (of n, in part)
// to the CTA that owns i, owner(i), through distributed shared memory, into
// recv[its rank][i]; after the cluster's barrier the owner adds them in
// rank order (cluster_sum). The caller arrived at the barrier
// (cluster_arrive_relaxed) before its loads and waits here before the first
// send; one CTA alone only syncs.
template <typename Owner>
__device__ __forceinline__ void send_parts(const float* part, int n, float* recv, int rank,
                                           int nct, Owner owner) {
  if (nct == 1) {
    __syncthreads();
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  for (int i = threadIdx.x; i < n; i += NT)
    *cluster.map_shared_rank(recv + rank * n + i, owner(i)) = part[i];
  cluster.sync();
}
__device__ __forceinline__ float cluster_sum(const float* part, const float* recv, int n,
                                             int nct, int i) {
  if (nct == 1) return part[i];
  float s = 0.f;
  for (int r = 0; r < nct; ++r) s += recv[r * n + i];
  return s;
}

// the rows a slice of k rows occupies in shared memory: whole chunks
template <typename W, int CG, int NB>
__host__ __device__ constexpr int padded(int k) {
  constexpr int CH = NT / CG * rows_in_flight<W, NB>();
  return (k + CH - 1) / CH * CH;
}

// the rank of this CTA in its cluster along x (0 for one CTA)
__device__ __forceinline__ int cluster_rank(int nct) {
  return nct > 1 ? (int)cg::this_cluster().block_rank() : 0;
}

// a cut of `dim` input rows into `ctas` slices of `k` rows (multiples of 8:
// 16-byte copies of bf16 activations; in order, none empty, the last the
// shorter)
inline bool cut_ok(int dim, int ctas, int k) {
  return ctas >= 1 && ctas <= MAX_CTAS && k >= 8 && k % 8 == 0 && (long long)ctas * k >= dim &&
         (long long)(ctas - 1) * k < dim;
}

// Launch a kernel of NT threads on grid (ctas, tiles), a cluster of the ctas
// of a tile, with programmatic stream serialization when pdl; `big` is the
// call site's record of the shared memory it opted into (raise_attr)
template <typename K, typename Arg>
cudaError_t launch_stream(K kernel, int ctas, int tiles, size_t smem, bool pdl, cudaStream_t st,
                          const Arg& p, int (&big)[MAX_DEVICES]) {
  cudaError_t err = raise_attr(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem,
                               big);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (ctas > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = ctas;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace tts
