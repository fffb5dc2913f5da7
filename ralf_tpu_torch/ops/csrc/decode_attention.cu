// The decode step's one-query cross-attention kernels.
//
// Over the SHARED encoder memory, with Wk folded into the query and Wv left
// to the caller (o[b, h] is [B, H, E]):
//
// K2 replaces the Pallas TPU kernel ralf_tpu/ops/pallas/decode_attention.py
// fused_decode_shared_attention (_shared_kernel):
//
//   p = softmax_m(q_tilde[b, h] . mem[b, m]);  o = sum_m T(p[m]) mem[b, m]
//
// K3 replaces fused_decode_shared_attention_q8 (_shared_kernel_q8): the same
// over an int8 memory with a per-token fp32 scale s (memory = s * mem_i8):
//
//   p = softmax((q_tilde . mem_i8[m]) * s[m]);  o = sum_m T(p[m] * s[m]) mem_i8[m]
//
// K4 replaces fused_decode_shared_attention_q8mxu (_shared_kernel_q8mxu):
// K3 with both contractions int8 x int8 -> int32.  The query arrives
// absmax-quantised per head (qi, qs); the kernel quantises p * s per row:
//
//   sc = int(qi . mem_i8[m]) * qs * s[m];  p2 = softmax(sc) * s
//   ps = max(max_m p2, 1e-30);  pi = clip(round(p2 * (127 / ps)), -127, 127)
//   o  = int(pi . mem_i8) * (ps / 127)
//
// T(x) is x rounded to the working type (bf16 or fp32), as the TPU kernels
// round p before their second dot; every sum is fp32 (int32 in K4).  The TPU
// kernels take s (and K4's qs) broadcast to [B, H, M] (and [B, H, 128]) for
// their tiling, and K4 repeats the 8 heads 4x to fill an int8 tile of 32
// rows; these read s as [B, M] and qs as [B, H] and compute the 8 real heads.
//
// Over PER-LAYER cross K/V caches in the [B, H, Dh, M] decode layout:
//
// K7 replaces fused_decode_attention (_kernel): o[b, h] = sum_m p[m] v[:, m]
// with p = softmax_m(scale * q[b, h] . k[:, m]), scale = Dh^-1/2, p in fp32.
// K8 replaces fused_decode_attention_q8: the same kernel on int8 K/V with
// q already scaled by Dh^-1/2 * k_scale (fp32) and scale 1; the wrapper
// applies v_scale to the fp32 output.
//
// What bounds them on the H100: each call reads the memory (or the K/V
// caches) once.  At the decode's shape (B=128, M=680, E=256) that is
// B*M*E*2 = 44.6 MB in bf16 (13.3 us at 3.35 TB/s), B*M*E + 4*B*M = 22.6 MB
// for int8 with its scales (6.7 us), against 4*B*H*M*E = 0.71 GFLOP (K4:
// 0.71 G int8 operations): memory-bound by far.  K7 reads K and V,
// 2*B*H*Dh*M*2 = 89.1 MB in bf16 (26.6 us), twice the shared memory: the
// reason the JAX package defaults to the shared path; K8 half of that.
//
// Design (simple and right first).  K2-K4: one block of 256 threads per
// batch row.  The query [8, 256] sits in shared memory; the memory streams
// through shared memory in tiles of 32 tokens (a row is 348 KB in bf16 and
// does not fit whole).  Because the TPU rounds the NORMALISED p, which an
// online softmax does not know until the last tile, the kernels take two
// passes over the memory: pass 1 writes the [8, M] scores into dynamic
// shared memory (thread (h, j) = (warp, lane) takes one score per tile),
// warp h turns row h into rounded probabilities, and pass 2 streams the
// memory again while thread e accumulates o[0..7, e].  The second pass
// doubles the memory reads (partly from the 50 MB L2).  K4's scores are
// __dp4a dot products of packed int8 (exact), its PV sums int32.  K7/K8: one
// block per (b, h) over a [Dh, M] cache pair, M contiguous: threads stride M
// for the scores (coalesced along M), a block-wide softmax, then warp w sums
// rows d = w, w + 8, ... of p . v.  No split of M across blocks and no copy
// in flight behind the compute: the times sit well above the bound.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kHeads = 8;
constexpr int kWidth = 256;   // E = d_model
constexpr int kTile = 32;     // memory tokens per tile (one per lane)
constexpr int kThreads = 256;
constexpr int kWords = kWidth / 4;  // int8 row packed in 32-bit words

static_assert(kThreads == kHeads * kTile, "one score per thread");
static_assert(kThreads == kWidth, "one output column per thread");

// Row h of the [kHeads, M] scores becomes probabilities in place, by warp h:
// p = exp(s - max) / sum, times s[m] when kScaled, rounded to T.
template <typename T, bool kScaled>
__device__ __forceinline__ void softmax_row(float* row, const float* scale, int M, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < M; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < M; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int j = lane; j < M; j += 32) {
    const float p = row[j] / l;
    row[j] = round_to<T>(kScaled ? p * scale[j] : p);
  }
}

template <typename T, typename MemT, bool kScaled>
__global__ void __launch_bounds__(kThreads) decode_shared_attention_kernel(
    const T* __restrict__ q_tilde, const MemT* __restrict__ mem,
    const float* __restrict__ mem_scale, T* __restrict__ out, int M) {
  extern __shared__ float sc[];  // [kHeads][M]: scores, then rounded probabilities
  __shared__ float q_s[kHeads][kWidth];
  __shared__ float mem_s[kTile][kWidth + 1];  // +1: conflict-free row-per-lane reads
  __shared__ float scale_s[kTile];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int h = tid >> 5;  // this warp's head
  const size_t mem0 = static_cast<size_t>(b) * M;

  for (int i = tid; i < kHeads * kWidth; i += kThreads) {
    q_s[i / kWidth][i % kWidth] = to_f32(q_tilde[static_cast<size_t>(b) * kHeads * kWidth + i]);
  }

  // pass 1: scores
  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      mem_s[jj][tid] = j0 + jj < M ? to_f32(mem[(mem0 + j0 + jj) * kWidth + tid]) : 0.f;
    }
    if (kScaled && tid < kTile) scale_s[tid] = j0 + tid < M ? mem_scale[mem0 + j0 + tid] : 0.f;
    __syncthreads();
    if (j0 + lane < M) {
      float dot = 0.f;
#pragma unroll 16
      for (int e = 0; e < kWidth; ++e) dot = fmaf(q_s[h][e], mem_s[lane][e], dot);
      sc[h * M + j0 + lane] = kScaled ? dot * scale_s[lane] : dot;
    }
  }
  __syncthreads();
  softmax_row<T, kScaled>(sc + h * M, kScaled ? mem_scale + mem0 : nullptr, M, lane);

  // pass 2: o[hh, tid] = sum_j p[hh, j] mem[j, tid]
  float acc[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) acc[hh] = 0.f;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();  // the probabilities are written / the previous tile is consumed
    const int n = min(kTile, M - j0);
    for (int jj = 0; jj < n; ++jj) mem_s[jj][tid] = to_f32(mem[(mem0 + j0 + jj) * kWidth + tid]);
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float* p = sc + hh * M + j0;
      float o = acc[hh];
      for (int jj = 0; jj < n; ++jj) o = fmaf(p[jj], mem_s[jj][tid], o);
      acc[hh] = o;
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    out[(static_cast<size_t>(b) * kHeads + hh) * kWidth + tid] = from_f32<T>(acc[hh]);
  }
}

// Loads rows j0 .. j0 + kTile of one batch row's int8 memory as packed words
// (zeros past M); 4-byte aligned because a row is 256 bytes.
__device__ __forceinline__ void load_i8_tile(int32_t (*tile)[kWords + 1], const int8_t* mem,
                                             size_t mem0, int j0, int M, int tid) {
  const int32_t* src = reinterpret_cast<const int32_t*>(mem);
  for (int i = tid; i < kTile * kWords; i += kThreads) {
    const int jj = i / kWords, w = i % kWords;
    tile[jj][w] = j0 + jj < M ? src[(mem0 + j0 + jj) * kWords + w] : 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_shared_attention_q8mxu_kernel(
    const int8_t* __restrict__ qi, const float* __restrict__ qs, const int8_t* __restrict__ mem,
    const float* __restrict__ mem_scale, T* __restrict__ out, int M) {
  extern __shared__ float sc[];  // [kHeads][M]: scores, then the quantised p2
  __shared__ int32_t q_s[kHeads][kWords];
  __shared__ int32_t mem_s[kTile][kWords + 1];  // +1 word: conflict-free row-per-lane reads
  __shared__ float ps_s[kHeads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int h = tid >> 5;
  const size_t mem0 = static_cast<size_t>(b) * M;
  const float* s = mem_scale + mem0;
  const float qs_h = qs[b * kHeads + h];

  const int32_t* qw = reinterpret_cast<const int32_t*>(qi + static_cast<size_t>(b) * kHeads * kWidth);
  for (int i = tid; i < kHeads * kWords; i += kThreads) q_s[i / kWords][i % kWords] = qw[i];

  // pass 1: int32 scores, dequantised
  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();
    load_i8_tile(mem_s, mem, mem0, j0, M, tid);
    __syncthreads();
    if (j0 + lane < M) {
      int dot = 0;
#pragma unroll 16
      for (int w = 0; w < kWords; ++w) dot = __dp4a(q_s[h][w], mem_s[lane][w], dot);
      sc[h * M + j0 + lane] = static_cast<float>(dot) * qs_h * s[j0 + lane];
    }
  }
  __syncthreads();

  // warp h: p2 = softmax * s, then its absmax quantisation
  float* row = sc + h * M;
  softmax_row<float, true>(row, s, M, lane);
  float ps = 0.f;
  for (int j = lane; j < M; j += 32) ps = fmaxf(ps, fabsf(row[j]));
  ps = fmaxf(warp_max(ps), 1e-30f);
  const float inv = 127.0f / ps;
  for (int j = lane; j < M; j += 32) row[j] = fminf(fmaxf(rintf(row[j] * inv), -127.f), 127.f);
  if (lane == 0) ps_s[h] = ps;

  // pass 2: int32 o[hh, tid] = sum_j pi[hh, j] mem_i8[j, tid]
  int acc[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) acc[hh] = 0;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    __syncthreads();
    load_i8_tile(mem_s, mem, mem0, j0, M, tid);
    __syncthreads();
    const int n = min(kTile, M - j0);
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float* p = sc + hh * M + j0;
      int o = acc[hh];
      for (int jj = 0; jj < n; ++jj) {
        o += static_cast<int>(p[jj]) * static_cast<int>(reinterpret_cast<const int8_t*>(mem_s[jj])[tid]);
      }
      acc[hh] = o;
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    out[(static_cast<size_t>(b) * kHeads + hh) * kWidth + tid] =
        from_f32<T>(static_cast<float>(acc[hh]) * (ps_s[hh] * (1.0f / 127.0f)));
  }
}

// K7 / K8: one block per (b, h); k_t and v_t are [B*H, Dh, M], q and out [B*H, Dh].
template <typename QT, typename KT, typename OT>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_t, const KT* __restrict__ v_t,
    OT* __restrict__ out, int Dh, int M, float scale) {
  extern __shared__ float smem[];  // q_s [Dh], then p [M]
  __shared__ float red[32];
  float* q_s = smem;
  float* p = smem + Dh;
  const size_t bh = blockIdx.x;
  const size_t base = bh * Dh * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int d = tid; d < Dh; d += kThreads) q_s[d] = to_f32(q[bh * Dh + d]);
  __syncthreads();
  float mx = -INFINITY;
  for (int m = tid; m < M; m += kThreads) {
    float dot = 0.f;
    for (int d = 0; d < Dh; ++d) dot = fmaf(q_s[d], to_f32(k_t[base + static_cast<size_t>(d) * M + m]), dot);
    p[m] = dot * scale;
    mx = fmaxf(mx, p[m]);
  }
  mx = block_max(mx, red);
  float l = 0.f;
  for (int m = tid; m < M; m += kThreads) {
    p[m] = expf(p[m] - mx);
    l += p[m];
  }
  l = block_sum(l, red);  // its barriers also publish p
  for (int m = tid; m < M; m += kThreads) p[m] = p[m] / l;
  __syncthreads();
  for (int d = warp; d < Dh; d += kThreads / 32) {
    const KT* v = v_t + base + static_cast<size_t>(d) * M;
    float o = 0.f;
    for (int m = lane; m < M; m += 32) o = fmaf(p[m], to_f32(v[m]), o);
    o = warp_sum(o);
    if (lane == 0) out[bh * Dh + d] = from_f32<OT>(o);
  }
}

size_t scores_bytes(int M) { return static_cast<size_t>(kHeads) * M * sizeof(float); }

// Allows `smem` bytes of dynamic shared memory (above the default 48 KB
// the kernel must opt in); returns the cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, typename MemT, bool kScaled>
int launch_shared(const void* q_tilde, const void* mem, const float* mem_scale, void* out, int B,
                  int M, cudaStream_t stream) {
  auto kernel = decode_shared_attention_kernel<T, MemT, kScaled>;
  const size_t smem = scores_bytes(M);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<B, kThreads, smem, stream>>>(static_cast<const T*>(q_tilde),
                                        static_cast<const MemT*>(mem), mem_scale,
                                        static_cast<T*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_q8mxu(const int8_t* qi, const float* qs, const int8_t* mem, const float* mem_scale,
                 void* out, int B, int M, cudaStream_t stream) {
  auto kernel = decode_shared_attention_q8mxu_kernel<T>;
  const size_t smem = scores_bytes(M);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<B, kThreads, smem, stream>>>(qi, qs, mem, mem_scale, static_cast<T*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, typename OT>
int launch_kv(const void* q, const void* k_t, const void* v_t, void* out, int BH, int Dh, int M,
              float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, KT, OT>;
  const size_t smem = static_cast<size_t>(Dh + M) * sizeof(float);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<BH, kThreads, smem, stream>>>(static_cast<const QT*>(q), static_cast<const KT*>(k_t),
                                         static_cast<const KT*>(v_t), static_cast<OT*>(out), Dh,
                                         M, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ralf

// Every entry point returns the cudaError_t of its launch (0 on success).

// K2: q_tilde and out [B, 8, 256] of the dtype code; mem [B, M, 256] of the same dtype.
extern "C" int ralf_decode_shared_attention(int dtype, const void* q_tilde, const void* mem,
                                            void* out, int B, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_shared<float, float, false>(q_tilde, mem, nullptr, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_shared<__nv_bfloat16, __nv_bfloat16, false>(q_tilde, mem, nullptr, out,
                                                                    B, M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3: as K2 over mem_i8 [B, M, 256] int8 with mem_scale [B, M] fp32.
extern "C" int ralf_decode_shared_attention_q8(int dtype, const void* q_tilde, const void* mem_i8,
                                               const float* mem_scale, void* out, int B, int M,
                                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_shared<float, int8_t, true>(q_tilde, mem_i8, mem_scale, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_shared<__nv_bfloat16, int8_t, true>(q_tilde, mem_i8, mem_scale, out, B,
                                                            M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4: qi [B, 8, 256] int8 with qs [B, 8] fp32, mem_i8 [B, M, 256] int8 with
// mem_scale [B, M] fp32; out [B, 8, 256] of the dtype code.
extern "C" int ralf_decode_shared_attention_q8mxu(int dtype, const int8_t* qi, const float* qs,
                                                  const int8_t* mem_i8, const float* mem_scale,
                                                  void* out, int B, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_q8mxu<float>(qi, qs, mem_i8, mem_scale, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_q8mxu<__nv_bfloat16>(qi, qs, mem_i8, mem_scale, out, B, M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7: q and out [BH, Dh], k_t and v_t [BH, Dh, M], all of the dtype code.
extern "C" int ralf_decode_attention(int dtype, const void* q, const void* k_t, const void* v_t,
                                     void* out, int BH, int Dh, int M, float scale,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_kv<float, float, float>(q, k_t, v_t, out, BH, Dh, M, scale, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_kv<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(q, k_t, v_t, out, BH,
                                                                         Dh, M, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8: q and out [BH, Dh] fp32 (q pre-scaled), k_i8 and v_i8 [BH, Dh, M] int8.
extern "C" int ralf_decode_attention_q8(const float* q, const int8_t* k_i8, const int8_t* v_i8,
                                        float* out, int BH, int Dh, int M, void* stream) {
  return ralf::launch_kv<float, int8_t, float>(q, k_i8, v_i8, out, BH, Dh, M, 1.0f,
                                               static_cast<cudaStream_t>(stream));
}
