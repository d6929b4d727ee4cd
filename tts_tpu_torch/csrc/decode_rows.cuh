// The score pass shared by the decode attention kernels (decode_attention.cu,
// kernel 13, and decode_step.cu, kernel 12): a group of LG = D / 8 lanes
// covers one cache row with 16-byte loads (8 bf16 a lane), and a round's
// dot products with the G q heads are summed over the group by a
// transposing butterfly.
#pragma once

#include "common.cuh"

namespace tts {
namespace {

// One step of a transposing butterfly over the lanes OFF apart, on CNT
// values a lane, then the next: each lane sends the half it does not keep
// and adds the partner's copy of the half it keeps (the upper lane keeps
// the upper half, `base` counting the values it passed over); once one
// value is left, the steps are plain sums.
template <int OFF, int CNT>
__device__ __forceinline__ void butterfly(float* val, int li, int& base) {
  if constexpr (OFF > 0) {
    if constexpr (CNT > 1) {
      constexpr int HALF = CNT / 2;
      const bool upper = (li & OFF) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float sent = upper ? val[i] : val[i + HALF];
        const float kept = upper ? val[i + HALF] : val[i];
        val[i] = kept + __shfl_xor_sync(0xffffffffu, sent, OFF);
      }
      base += upper ? HALF : 0;
      butterfly<OFF / 2, HALF>(val, li, base);
    } else {
      val[0] += __shfl_xor_sync(0xffffffffu, val[0], OFF);
      butterfly<OFF / 2, 1>(val, li, base);
    }
  }
}

// The scores of a round's rows t0 + u NG + grp (u < UE) for the G q heads
// into sc: each lane's dot products over its 8 elements for GP heads (G
// padded with zeros), summed over the group's LG lanes by the transposing
// butterfly (UE * GP values take UE * GP - 1 shuffles, not UE * GP * log2
// LG); the lane holding a sum writes it (with fewer values than lanes,
// LG / (UE * GP) lanes hold each, and the first of them writes).
template <int LG, int NG, int G, int GP, int UE, int U>
__device__ __forceinline__ void round_scores(const uint4 (&kr)[U], const float (&qf)[G][8],
                                             int li, int grp, int t0, int n, float* sc,
                                             int rows, float scale) {
  constexpr int CP = UE * GP, CNT = CP > LG ? CP / LG : 1;
  float val[CP];
#pragma unroll
  for (int u = 0; u < UE; ++u) {
    Vec8 kx;
    kx.u = kr[u];
    float kf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) kf[e] = to_f(kx.h[e]);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float acc = 0.f;
      if (g < G) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(qf[g][e], kf[e], acc);
      }
      val[u * GP + g] = acc;
    }
  }
  int base = 0;
  butterfly<LG / 2, CP>(val, li, base);
#pragma unroll
  for (int i = 0; i < CNT; ++i) {
    const int u = (base + i) / GP, g = (base + i) % GP;
    const int t = t0 + u * NG + grp;
    if (g < G && t < n && (CP >= LG || li % (LG / CP) == 0))
      sc[g * rows + t] = scale != 1.f ? val[i] * scale : val[i];
  }
}

}  // namespace
}  // namespace tts
