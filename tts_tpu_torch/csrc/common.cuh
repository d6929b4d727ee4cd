// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel keeps the rounding points of the TPU kernel it replaces: a
// tensor-core dot accumulates in fp32 and is rounded to bf16 where the TPU
// kernel casts to the activation dtype; elementwise work on bf16 values runs
// in fp32 and is rounded once per op, as PyTorch and XLA do for bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tts {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// 16x16x16 tensor-core fragments: bf16 operands, fp32 accumulator
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16(x); }
// round an fp32 value to bf16 and back
__device__ __forceinline__ float rnd(float x) { return to_f(to_bf(x)); }

// gelu with the tanh approximation (jax.nn.gelu(approximate=True))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// mish with the TPU kernel's softplus guard (tts_tpu/ops/grouped_conv.py)
__device__ __forceinline__ float mish(float x) {
  const float sp = x > 20.f ? x : log1pf(expf(x));
  return x * tanhf(sp);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 8 bf16 values moved as one 16-byte word
union Vec8 {
  uint4 u;
  bf16 h[8];
};

// Per-device state of the C entries. A kernel attribute set with
// cudaFuncSetAttribute holds only on the device current when it was set,
// and each wrapper launches under its tensor's device (ops/_build.launch),
// so every cache of such state has one slot a device, indexed by
// cudaGetDevice.
constexpr int MAX_DEVICES = 64;

// Raise attribute `attr` of `kernel` to `value` on the current device,
// unless this call site has already set it that high there; `done` is the
// site's record (a static array, zero at start).
template <typename K>
cudaError_t raise_attr(K kernel, cudaFuncAttribute attr, int value, int (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (value <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) done[dev] = value;
  return err;
}

// The current device's SM count, 0 if it cannot be read
inline int sm_count() {
  static int sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms[dev] = n;
  }
  return sms[dev];
}

// Launch `kernel` in thread-block clusters of `cx` CTAs along x (grid.x a
// multiple of cx); returns the launch's error.
template <typename Arg>
cudaError_t launch_cluster(void (*kernel)(Arg), dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, int cx, Arg arg) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, arg);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tts
