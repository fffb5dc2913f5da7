// K2 and K3: one-query cross-attention of a decode step over the SHARED
// encoder memory, with Wk folded into the query and Wv left to the caller.
//
// K2 replaces the Pallas TPU kernel ralf_tpu/ops/pallas/decode_attention.py
// fused_decode_shared_attention (_shared_kernel):
//
//   o[b, h] = softmax_m(q_tilde[b, h] . mem[b, m]) mem[b, m]      [B, H, E]
//
// K3 replaces fused_decode_shared_attention_q8 (_shared_kernel_q8): the same
// over an int8 memory with a per-token fp32 scale s (memory = s * mem_i8):
//
//   scores = (q_tilde . mem_i8[m]) * s[m];  p = softmax(scores);
//   o = sum_m (p[m] * s[m]) mem_i8[m]
//
// The TPU kernel takes s broadcast to [B, H, M] for its tiling; this one
// reads [B, M].  Both keep p in fp32 through the p . mem contraction, where
// the TPU kernel rounds p to the memory's dtype first (see the tolerance in
// ralf_tpu_torch/ops/decode_attention.py).
//
// What bounds them on the H100: each call reads the memory once per batch
// row.  At the decode's shape (B=128, M=680, E=256) that is B*M*E*2 = 44.6 MB
// in bf16 (13.3 us at 3.35 TB/s) and B*M*E + 4*B*M = 22.6 MB for int8 with
// its scales (6.7 us), against 4*B*H*M*E = 0.71 GFLOP: memory-bound by far.
//
// Design (simple and right first): one block of 256 threads per batch row.
// q_tilde [8, 256] sits in shared memory as fp32; the memory streams through
// shared memory in tiles of 32 tokens, converted to fp32 (a row is 348 KB in
// bf16 and does not fit whole).  Per tile, thread (h, j) = (warp, lane) takes
// one score, warp h runs the online softmax of head h, and thread e
// accumulates o[0..7, e] in registers.  With one block per row, B=128 blocks
// fill at most 128 of the 132 SMs and each SM streams one row with no copy in
// flight behind the compute: the time sits well above the bound.  Splitting M
// across blocks (flash-decoding) and asynchronous tile copies are later work.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kHeads = 8;
constexpr int kWidth = 256;   // E = d_model
constexpr int kTile = 32;     // memory tokens per tile (one per lane)
constexpr int kThreads = 256;

static_assert(kThreads == kHeads * kTile, "one score per thread");
static_assert(kThreads == kWidth, "one output column per thread");

template <typename T, typename MemT, bool kScaled>
__global__ void __launch_bounds__(kThreads) decode_shared_attention_kernel(
    const T* __restrict__ q_tilde, const MemT* __restrict__ mem,
    const float* __restrict__ mem_scale, T* __restrict__ out, int M) {
  __shared__ float q_s[kHeads][kWidth];
  __shared__ float mem_s[kTile][kWidth + 1];  // +1: conflict-free row-per-lane reads
  __shared__ float p_s[kHeads][kTile];
  __shared__ float alpha_s[kHeads];
  __shared__ float scale_s[kTile];
  __shared__ float inv_l_s[kHeads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int h = tid >> 5;  // this warp's head in the softmax phase
  const size_t mem0 = static_cast<size_t>(b) * M;

  for (int i = tid; i < kHeads * kWidth; i += kThreads) {
    q_s[i / kWidth][i % kWidth] = to_f32(q_tilde[static_cast<size_t>(b) * kHeads * kWidth + i]);
  }

  float m = -INFINITY, l = 0.f;  // running max and sum of head h
  float acc[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) acc[hh] = 0.f;

  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();  // the previous tile's mem_s / p_s are consumed
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      mem_s[jj][tid] = j0 + jj < M ? to_f32(mem[(mem0 + j0 + jj) * kWidth + tid]) : 0.f;
    }
    if (kScaled && tid < kTile) scale_s[tid] = j0 + tid < M ? mem_scale[mem0 + j0 + tid] : 0.f;
    __syncthreads();

    float s = -INFINITY;
    if (j0 + lane < M) {
      float dot = 0.f;
#pragma unroll 16
      for (int e = 0; e < kWidth; ++e) dot = fmaf(q_s[h][e], mem_s[lane][e], dot);
      s = kScaled ? dot * scale_s[lane] : dot;
    }
    const float m_new = fmaxf(m, warp_max(s));  // finite: lane 0 of a tile is in range
    const float alpha = expf(m - m_new);        // 0 on the first tile
    const float p = s == -INFINITY ? 0.f : expf(s - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
    p_s[h][lane] = kScaled ? p * scale_s[lane] : p;
    if (lane == 0) alpha_s[h] = alpha;
    __syncthreads();

#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      float o = acc[hh] * alpha_s[hh];
#pragma unroll 8
      for (int jj = 0; jj < kTile; ++jj) o = fmaf(p_s[hh][jj], mem_s[jj][tid], o);
      acc[hh] = o;
    }
  }

  if (lane == 0) inv_l_s[h] = 1.f / l;
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    out[(static_cast<size_t>(b) * kHeads + hh) * kWidth + tid] = from_f32<T>(acc[hh] * inv_l_s[hh]);
  }
}

template <typename T, typename MemT, bool kScaled>
int launch(const void* q_tilde, const void* mem, const float* mem_scale, void* out, int B, int M,
           cudaStream_t stream) {
  decode_shared_attention_kernel<T, MemT, kScaled><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(q_tilde), static_cast<const MemT*>(mem), mem_scale,
      static_cast<T*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ralf

// q_tilde and out are [B, 8, 256] of the dtype code; mem is [B, M, 256] of the
// same dtype.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ralf_decode_shared_attention(int dtype, const void* q_tilde, const void* mem,
                                            void* out, int B, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch<float, float, false>(q_tilde, mem, nullptr, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch<__nv_bfloat16, __nv_bfloat16, false>(q_tilde, mem, nullptr, out, B, M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above over mem_i8 [B, M, 256] int8 with mem_scale [B, M] fp32.
extern "C" int ralf_decode_shared_attention_q8(int dtype, const void* q_tilde, const void* mem_i8,
                                               const float* mem_scale, void* out, int B, int M,
                                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch<float, int8_t, true>(q_tilde, mem_i8, mem_scale, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch<__nv_bfloat16, int8_t, true>(q_tilde, mem_i8, mem_scale, out, B, M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
