// K5: the encoder's fused feed-forward block, forward only.
//
// Replaces the Pallas TPU kernel ralf_tpu/ops/pallas/encoder_ffn.py
// fused_ffn (_kernel), which computes max(x W1, -b1) W2 with the [B, S, F]
// hidden tile kept on chip; its caller adds the tail b1 W2 + b2 (relu(h +
// b1) = max(h, -b1) + b1).  In its order, for x [M, E] (M = B*S rows) and
// the weights as nn.Linear stores them, W1 [F, E] and W2 [E, F]:
//
//   h = x . W1^T          (fp32 sums)
//   g = T(max(h, nb1))    nb1 = T(-b1), rounded to x's dtype T
//   o = T(g . W2^T)       (fp32 sums)
//   out = T(o + T(tail))  tail = b1 . W2^T + b2 in fp32 (the wrapper's)
//
// What bounds it on the H100, at the image encoder's shape (M = 128*330,
// E=256, F=1024, bf16): 4*M*E*F = 44.3 GFLOP (44.8 us at the bf16
// tensor-core peak) against the bytes of x, the output and the weights,
// 44.3 MB (13.2 us): operation-bound.
//
// Design (simple and right first; CUDA cores, not the tensor cores): one
// block of 256 threads per tile of 64 rows.  The x tile [64, E] stays in
// shared memory; the block walks F in chunks of 64: it loads W1's rows and
// W2's columns of the chunk, computes the [64, 64] hidden tile (16 sums a
// thread) into shared memory as g, and adds g . W2_chunk^T to the [64, E]
// fp32 accumulator held in registers (E/4 a thread).  The hidden [M, F]
// never reaches device memory; the weights are re-read by every block from
// L2.  All tiles are stored in T with rows padded to an odd number of
// words: about 108 KB of shared memory in bf16 at E=256, two blocks a SM.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kThreads = 256;
constexpr int kRowsTile = 64;  // rows of x per block
constexpr int kChunk = 64;     // hidden units per step

template <typename T>
__host__ __device__ constexpr int pad_of() { return 4 / static_cast<int>(sizeof(T)); }

template <typename T, int E>
size_t ffn_smem() {
  constexpr int ldx = E + pad_of<T>(), ldc = kChunk + pad_of<T>();
  return (static_cast<size_t>(kRowsTile) * ldx     // x tile
          + static_cast<size_t>(kChunk) * ldx      // W1 rows of the chunk
          + static_cast<size_t>(E) * ldc           // W2 columns of the chunk
          + static_cast<size_t>(kRowsTile) * ldc)  // g
         * sizeof(T);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2) fused_ffn_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ nb1,
    const T* __restrict__ w2, const float* __restrict__ tail, T* __restrict__ out, int M, int F) {
  constexpr int ldx = E + pad_of<T>(), ldc = kChunk + pad_of<T>();
  constexpr int kCols = E / 32;     // output columns per lane
  constexpr int kRows = kRowsTile / (kThreads / 32);  // rows per warp: 8
  extern __shared__ __align__(16) unsigned char smem[];
  T* x_s = reinterpret_cast<T*>(smem);     // [kRowsTile][ldx]
  T* w1_s = x_s + kRowsTile * ldx;         // [kChunk][ldx]: W1[f0 + f, :]
  T* w2_s = w1_s + kChunk * ldx;           // [E][ldc]: W2[c, f0 + f]
  T* g_s = w2_s + E * ldc;                 // [kRowsTile][ldc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t m0 = static_cast<size_t>(blockIdx.x) * kRowsTile;
  const int n_rows = static_cast<int>(min(static_cast<size_t>(kRowsTile), M - m0));

  for (int i = tid; i < kRowsTile * E; i += kThreads) {
    const int r = i / E, e = i % E;
    x_s[r * ldx + e] = r < n_rows ? x[(m0 + r) * E + e] : from_f32<T>(0.f);
  }
  float acc[kRows][kCols] = {};
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    __syncthreads();  // x_s is written / the previous chunk is consumed
    for (int i = tid; i < kChunk * E; i += kThreads) {
      const int f = i / E, e = i % E;
      w1_s[f * ldx + e] = w1[static_cast<size_t>(f0 + f) * E + e];
    }
    for (int i = tid; i < E * kChunk; i += kThreads) {
      const int c = i / kChunk, f = i % kChunk;
      w2_s[c * ldc + f] = w2[static_cast<size_t>(c) * F + f0 + f];
    }
    __syncthreads();

    // h[r, f] for rows warp*8 + i and hidden units lane, lane + 32
    float h[kRows][2] = {};
    const T* wa = w1_s + lane * ldx;
    const T* wb = w1_s + (lane + 32) * ldx;
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      const float a = to_f32(wa[e]), b = to_f32(wb[e]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xv = to_f32(x_s[(warp * kRows + i) * ldx + e]);
        h[i][0] = fmaf(xv, a, h[i][0]);
        h[i][1] = fmaf(xv, b, h[i][1]);
      }
    }
    const float na = to_f32(nb1[f0 + lane]), nb = to_f32(nb1[f0 + lane + 32]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      T* g = g_s + (warp * kRows + i) * ldc;
      g[lane] = from_f32<T>(fmaxf(h[i][0], na));
      g[lane + 32] = from_f32<T>(fmaxf(h[i][1], nb));
    }
    __syncthreads();

    // acc[r, c] += g[r, :] . W2[c, f0:f0+64] for rows warp*8 + i and columns lane + 32j
#pragma unroll 2
    for (int f = 0; f < kChunk; ++f) {
      float wv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) wv[j] = to_f32(w2_s[(lane + 32 * j) * ldc + f]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float gv = to_f32(g_s[(warp * kRows + i) * ldc + f]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(gv, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      out[(m0 + r) * E + c] = from_f32<T>(round_to<T>(acc[i][j]) + round_to<T>(tail[c]));
    }
  }
}

template <typename T, int E>
int launch(const void* x, const void* w1, const void* nb1, const void* w2, const float* tail,
           void* out, int M, int F, cudaStream_t stream) {
  auto kernel = fused_ffn_kernel<T, E>;
  const size_t smem = ffn_smem<T, E>();
  if (int err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared))
    return err;
  if (int err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem)))
    return err;
  const int blocks = (M + kRowsTile - 1) / kRowsTile;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(nb1),
      static_cast<const T*>(w2), tail, static_cast<T*>(out), M, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* nb1, const void* w2, const float* tail,
             void* out, int M, int E, int F, cudaStream_t st) {
  if (F % kChunk || E != 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, 256>(x, w1, nb1, w2, tail, out, M, F, st);
}

}  // namespace
}  // namespace ralf

// Returns the cudaError_t of the launch (0 on success).  x and out [M, E],
// w1 [F, E], nb1 [F] (= -b1), w2 [E, F] of the dtype code; tail [E] fp32;
// E = 256 (d_model of every full-width model), F a multiple of 64.
extern "C" int ralf_fused_ffn(int dtype, const void* x, const void* w1, const void* nb1,
                              const void* w2, const float* tail, void* out, int M, int E, int F,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::dispatch<float>(x, w1, nb1, w2, tail, out, M, E, F, st);
  if (dtype == ralf::kBFloat16)
    return ralf::dispatch<__nv_bfloat16>(x, w1, nb1, w2, tail, out, M, E, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
