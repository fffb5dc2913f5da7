// K9: the fp32 sum of each batch row, a probe of the device-memory stream rate.
//
// Replaces the Pallas TPU kernel scripts/probe_dma_rate.py stream_sum
// (_sum_kernel): out[b] = sum over every other dimension of x[b] in fp32,
// for int8, int16, int32, fp32 and bf16 inputs.  The TPU kernel takes B in
// blocks of bb rows and needs B % bb == 0 (a tiling artefact); this one
// takes any B.
//
// What bounds it: the bytes.  At the probe's shape ([2048, 680, 256] int8,
// 356.5 MB) the row sums are one operation per element against 0.106 ms at
// 3.35 TB/s.  The arithmetic must stay far below that: int8 rows are summed
// four bytes at a time by __dp4a into an exact int32 (what the fp32 sum
// gives as long as the partial sums stay below 2^24, as they do for the
// probe's data), the other types element by element into fp32.
//
// Design: one block of 512 threads per row; each thread streams 16-byte
// vectors, four in flight, and the block reduces its threads' sums.  A row
// whose bytes or start are not 16-byte aligned is read element by element.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kThreads = 512;
constexpr int kInFlight = 4;

// dtype codes of this entry point (ralf_tpu_torch/ops/stream_sum.py)
constexpr int kInt8 = 2;
constexpr int kInt16 = 3;
constexpr int kInt32 = 4;

template <typename T>
struct Sum {
  float f = 0.f;
  int i = 0;  // int8 only: the exact sum
  __device__ __forceinline__ void word(uint32_t w);
  __device__ __forceinline__ void scalar(T v) { f += to_f32(v); }
  __device__ __forceinline__ void vec(const uint4& v) {
    word(v.x);
    word(v.y);
    word(v.z);
    word(v.w);
  }
  __device__ __forceinline__ float total() const { return f + static_cast<float>(i); }
};

template <>
__device__ __forceinline__ void Sum<int8_t>::word(uint32_t w) {
  i = __dp4a(static_cast<int>(w), 0x01010101, i);
}
template <>
__device__ __forceinline__ void Sum<int8_t>::scalar(int8_t v) { i += v; }
template <>
__device__ __forceinline__ void Sum<int16_t>::word(uint32_t w) {
  f += static_cast<float>(static_cast<int16_t>(w & 0xffffu)) +
       static_cast<float>(static_cast<int16_t>(w >> 16));
}
template <>
__device__ __forceinline__ void Sum<int16_t>::scalar(int16_t v) { f += static_cast<float>(v); }
template <>
__device__ __forceinline__ void Sum<int32_t>::word(uint32_t w) {
  f += static_cast<float>(static_cast<int32_t>(w));
}
template <>
__device__ __forceinline__ void Sum<int32_t>::scalar(int32_t v) { f += static_cast<float>(v); }
template <>
__device__ __forceinline__ void Sum<float>::word(uint32_t w) { f += __uint_as_float(w); }
template <>
__device__ __forceinline__ void Sum<__nv_bfloat16>::word(uint32_t w) {
  f += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) stream_sum_kernel(const T* __restrict__ x,
                                                              float* __restrict__ out,
                                                              long long row_elems) {
  __shared__ float red[32];
  const T* row = x + static_cast<size_t>(blockIdx.x) * row_elems;
  const size_t row_bytes = static_cast<size_t>(row_elems) * sizeof(T);
  Sum<T> s;
  if (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const long long n = static_cast<long long>(row_bytes / 16);
    long long i = threadIdx.x;
    for (; i + (kInFlight - 1) * kThreads < n; i += kInFlight * kThreads) {
      uint4 r[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) r[u] = __ldg(v + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) s.vec(r[u]);
    }
    for (; i < n; i += kThreads) s.vec(__ldg(v + i));
  } else {
    for (long long i = threadIdx.x; i < row_elems; i += kThreads) s.scalar(row[i]);
  }
  const float total = block_sum(s.total(), red);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

template <typename T>
int launch(const void* x, float* out, int B, long long row_elems, cudaStream_t stream) {
  stream_sum_kernel<T><<<B, kThreads, 0, stream>>>(static_cast<const T*>(x), out, row_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ralf

// Returns the cudaError_t of the launch (0 on success).  x [B, row_elems]
// of the dtype code (0 fp32, 1 bf16, 2 int8, 3 int16, 4 int32); out [B] fp32.
extern "C" int ralf_stream_sum(int dtype, const void* x, float* out, int B, long long row_elems,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ralf::kFloat32: return ralf::launch<float>(x, out, B, row_elems, st);
    case ralf::kBFloat16: return ralf::launch<__nv_bfloat16>(x, out, B, row_elems, st);
    case ralf::kInt8: return ralf::launch<int8_t>(x, out, B, row_elems, st);
    case ralf::kInt16: return ralf::launch<int16_t>(x, out, B, row_elems, st);
    case ralf::kInt32: return ralf::launch<int32_t>(x, out, B, row_elems, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
