// Shared helpers for the port's kernels: scalar conversions to and from the
// fp32 compute type, warp and block reductions, and the launchers' opt-in
// to large dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ralf {

// dtype codes passed from Python (ralf_tpu_torch/ops/_build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the rounding a TPU kernel applies with .astype(T)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max / sum of x over the whole block (blockDim.x a multiple of 32, at most
// 1024); every thread gets the result.  `red` is shared scratch of 32 floats.
__device__ __forceinline__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  x = warp_max(x);
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < nwarps ? red[lane] : -INFINITY;
  return warp_max(x);
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(x);
}

// Allows `smem` bytes of dynamic shared memory (above 48 KB a kernel must
// opt in), at most the 227 KB of a block; with kMaxShared the SM's carveout
// prefers shared memory to L1.  Returns the cudaError_t.
template <bool kMaxShared, typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (kMaxShared) {
    if (int err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared))
      return err;
  }
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// allow_smem once per device and size: the attribute calls would otherwise
// cost microseconds of host time on every launch.
template <auto kKernel, bool kMaxShared = true>
int allow_smem_once(size_t smem) {
  static size_t allowed[64] = {};  // per device, the largest size allowed so far
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (dev < 64 && smem <= allowed[dev]) return 0;
  if (int err = allow_smem<kMaxShared>(kKernel, smem)) return err;
  if (dev < 64) allowed[dev] = smem;
  return 0;
}

}  // namespace ralf
