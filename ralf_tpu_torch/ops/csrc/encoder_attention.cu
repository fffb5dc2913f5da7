// The encoder's bidirectional multi-head self-attention, forward only.
//
// K1 replaces the Pallas TPU kernel ralf_tpu/ops/pallas/encoder_attention.py
// fused_encoder_attention (_kernel / _kernel_bias through _attend_block):
// q, k, v [B, S, E] with head h in columns h*Dh.. (the layout the
// projections write, read directly), the softmax scale folded into q.
//
// K6 replaces fused_encoder_self_attention (_kernel_qkv): the same attention
// with the projections folded in, qkv = T(x . wqkv) from x [B, S, E] and
// wqkv [3E, E] (the rows of q_proj * scale, k_proj and v_proj, as nn.Linear
// stores them; fp32 sums rounded to T), so q, k and v never reach device
// memory.  Its keep weights are per head.
//
// Both compute _attend_block's softmax with keep weights w = exp(key_bias)
// (K1: one [B, S] row shared by the heads, 0 / -1e9 key padding; K6: [B, S]
// or per-head [B, H, S], any real value; no bias: w = 1):
//
//   m = max over the scores whose w > 0;  p = exp(min(s - m, 0)) * w
//   p = T(p / max(sum p, 1e-30));          o = sum_j p[j] v[j]  (fp32, then T)
//
// and a row with no w > 0 attends uniformly over all S keys (the mean of
// V).  T(x) rounds to the working type (bf16 or fp32), as the TPU kernel
// rounds the NORMALISED p to v's dtype before the second dot; both dots
// accumulate in fp32.
//
// What bounds them on the H100, at the image encoder's shape (B=128, S=330,
// E=256, bf16): K1 must move 4*B*S*E*2 = 86.5 MB (25.8 us at 3.35 TB/s)
// against 4*B*S*S*E = 14.3 GFLOP (14.5 us at the bf16 tensor-core peak):
// memory-bound.  K6 moves x and the output, 43.3 MB plus the per-head
// biases, against 2*B*S*E*3E = 16.6 GFLOP of projection and the same 14.3
// of attention (31.2 us): operation-bound.
//
// Design (simple and right first; the contractions run on the CUDA cores,
// not the tensor cores).  Because p is rounded after normalisation, a query
// tile holds its whole [32, S] score row in shared memory (fp32; 132 KB at
// S=1024, the most K1 takes): scores, then a warp per row turns them into
// rounded probabilities, then the PV sums.
//   K1: one block per (query tile of 32, head, batch row).  Pass 1 streams
//   the head's keys through shared memory in tiles of 64 for the scores;
//   pass 2 streams the values (again, mostly from L2).
//   K6: one block per (head, batch row).  A block cannot hold a whole
//   row's qkv [S, 3E] (507 KB in bf16 at S=330, against 227 KB of shared
//   memory), so it splits by head: it projects q_h, k_h, v_h [S, Dh] of its
//   head into shared memory (x streamed in [32, 32] tiles, wqkv's 3*Dh rows
//   of the head in [3*Dh, 32] tiles), then walks its query tiles over them.
//   x is read once per head, 8 times at H=8, mostly from L2.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;                 // queries per tile
constexpr int kRowsPerWarp = kQT / kWarps;
constexpr int kKT = 64;                 // keys per score step: two per lane
constexpr int kKC = 32;                 // K6 projection: depth of an x / wqkv tile

// Row padding, in elements, that makes a row's stride an odd number of
// 32-bit words when Dh is a multiple of 8: lanes that read one column of
// consecutive rows then hit distinct banks.
template <typename T>
__host__ __device__ constexpr int pad_of() { return 4 / static_cast<int>(sizeof(T)); }

// sc[r * lds + j] = q[r] . k[j] for r < kQT and j < n; q rows of stride
// ldq, k rows of stride ldk, all in shared memory.  Warp w takes rows
// 4w..4w+3, lane l keys l and l + 32 of each step of 64.
template <typename T, int DH>
__device__ __forceinline__ void tile_scores(const T* q, int ldq, const T* k, int ldk, int n,
                                            float* sc, int lds) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < n; j0 += kKT) {
    const int ja = j0 + lane, jb = ja + 32;
    const T* ka = k + min(ja, n - 1) * ldk;  // past n: read a valid row, drop the sum
    const T* kb = k + min(jb, n - 1) * ldk;
    float acc[kRowsPerWarp][2] = {};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float a = to_f32(ka[d]), b = to_f32(kb[d]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = to_f32(q[(warp * kRowsPerWarp + i) * ldq + d]);
        acc[i][0] = fmaf(qv, a, acc[i][0]);
        acc[i][1] = fmaf(qv, b, acc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* row = sc + (warp * kRowsPerWarp + i) * lds;
      if (ja < n) row[ja] = acc[i][0];
      if (jb < n) row[jb] = acc[i][1];
    }
  }
}

// Rows 0..kQT-1 of sc ([kQT][lds], n scores each) become T-rounded
// probabilities in place, warp w taking rows 4w..4w+3 (_attend_block's
// masked softmax; see the top of the file).  w_s: the n keep weights.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* sc, int lds, int n, const float* w_s,
                                             bool dead) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float* row = sc + (warp * kRowsPerWarp + i) * lds;
    float m = 0.f;
    if (!dead) {
      m = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        if (w_s[j] > 0.f) m = fmaxf(m, row[j]);
      }
      m = warp_max(m);
    }
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = dead ? 1.f : expf(fminf(row[j] - m, 0.f)) * w_s[j];
      row[j] = p;
      l += p;
    }
    l = fmaxf(warp_sum(l), 1e-30f);
    for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] / l);
  }
}

// acc[a] += sum_j p[r][j] v[j][d] over j < n, for column d = tid % DH and
// rows r = tid / DH + (kThreads / DH) * a.
template <typename T, int DH>
__device__ __forceinline__ void tile_pv(const float* p, int ldp, const T* v, int ldv, int n,
                                        float* acc) {
  constexpr int kGroups = kThreads / DH;
  constexpr int kAcc = kQT / kGroups;
  const int d = threadIdx.x % DH, rg = threadIdx.x / DH;
  for (int j = 0; j < n; ++j) {
    const float vv = to_f32(v[j * ldv + d]);
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[a] = fmaf(p[(rg + kGroups * a) * ldp + j], vv, acc[a]);
  }
}

// w_s[j] = exp(bias[j]) (1 without a bias) for j < S; returns true when no
// key of the row has w > 0 (the row attends uniformly).  Ends in a barrier.
__device__ __forceinline__ bool keep_weights(const float* bias, int S, float* w_s) {
  int kept = 0;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const float w = bias == nullptr ? 1.f : expf(bias[j]);
    w_s[j] = w;
    kept |= w > 0.f;
  }
  return !__syncthreads_or(kept);
}

// Rows q0.. of one head's output: out[(row0 + q0 + r) * E + col + d].
template <typename T, int DH>
__device__ __forceinline__ void store_rows(const float* acc, T* out, size_t row0, int q0, int S,
                                           int E, int col) {
  constexpr int kGroups = kThreads / DH;
  const int d = threadIdx.x % DH, rg = threadIdx.x / DH;
#pragma unroll
  for (int a = 0; a < kQT / kGroups; ++a) {
    const int r = rg + kGroups * a;
    if (q0 + r < S) out[(row0 + q0 + r) * E + col + d] = from_f32<T>(acc[a]);
  }
}

template <typename T, int DH>
size_t k1_smem(int S) {
  constexpr int ld = DH + pad_of<T>();
  return static_cast<size_t>(kQT + kKT) * ld * sizeof(T) + static_cast<size_t>(S) * sizeof(float) +
         static_cast<size_t>(kQT) * S * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) encoder_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_bias, T* __restrict__ out, int S, int E) {
  constexpr int ld = DH + pad_of<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                       // [kQT][ld]
  T* kv_s = q_s + kQT * ld;                                  // [kKT][ld]: a key, then a value tile
  float* w_s = reinterpret_cast<float*>(kv_s + kKT * ld);    // [S]
  float* sc = w_s + S;                                       // [kQT][S]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQT;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int col = h * DH;

  const bool dead = keep_weights(key_bias == nullptr ? nullptr : key_bias + row0, S, w_s);
  for (int i = tid; i < kQT * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_s[r * ld + d] = q0 + r < S ? q[(row0 + q0 + r) * E + col + d] : from_f32<T>(0.f);
  }
  // pass 1: the scores of every key (a dead row needs none)
  for (int j0 = 0; j0 < S && !dead; j0 += kKT) {
    const int n = min(kKT, S - j0);
    __syncthreads();  // q_s is written / the previous tile is consumed
    for (int i = tid; i < n * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      kv_s[j * ld + d] = k[(row0 + j0 + j) * E + col + d];
    }
    __syncthreads();
    tile_scores<T, DH>(q_s, ld, kv_s, ld, n, sc + j0, S);
  }
  __syncthreads();
  softmax_rows<T>(sc, S, S, w_s, dead);

  // pass 2: o = p . v
  float acc[kQT * DH / kThreads] = {};
  for (int j0 = 0; j0 < S; j0 += kKT) {
    const int n = min(kKT, S - j0);
    __syncthreads();  // the probabilities are written / the previous tile is consumed
    for (int i = tid; i < n * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      kv_s[j * ld + d] = v[(row0 + j0 + j) * E + col + d];
    }
    __syncthreads();
    tile_pv<T, DH>(sc + j0, S, kv_s, ld, n, acc);
  }
  store_rows<T, DH>(acc, out, row0, q0, S, E, col);
}

// K6 shared memory: q_s [Sq][ld] (Sq = S rounded up to kQT, zero rows past
// S), k_s and v_s [S][ld], w_s [S], then one region that holds first the
// projection's x tile [32][kKC + 1] and wqkv tile [3*DH][kKC + 1] (fp32) and
// then sc [kQT][S]: 112 KB in bf16 at S=330, Dh=32, two blocks a SM.
template <int DH>
size_t k6_scratch(int S) {
  return static_cast<size_t>(max(kQT * S, (32 + 3 * DH) * (kKC + 1))) * sizeof(float);
}

template <typename T, int DH>
size_t k6_smem(int S) {
  constexpr int ld = DH + pad_of<T>();
  const size_t sq = static_cast<size_t>((S + kQT - 1) / kQT) * kQT;
  return (sq + 2 * static_cast<size_t>(S)) * ld * sizeof(T) +
         static_cast<size_t>(S) * sizeof(float) + k6_scratch<DH>(S);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) encoder_self_attention_kernel(
    const T* __restrict__ x, const T* __restrict__ wqkv, const float* __restrict__ key_bias,
    int bias_head_stride, T* __restrict__ out, int S, int E, int H) {
  constexpr int ld = DH + pad_of<T>();
  constexpr int kCols = 3 * DH / 32;  // projection columns per lane
  constexpr int kRows = 32 / kWarps;  // projection rows per warp
  const int Sq = (S + kQT - 1) / kQT * kQT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + static_cast<size_t>(Sq) * ld;
  T* v_s = k_s + static_cast<size_t>(S) * ld;
  float* w_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(S) * ld);
  float* sc = w_s + S;                 // [kQT][S], once the projection is done
  float* x_t = sc;                     // [32][kKC + 1], during the projection
  float* w_t = x_t + 32 * (kKC + 1);   // [3 * DH][kKC + 1], during the projection

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int col = h * DH;

  const float* bias = key_bias == nullptr
                          ? nullptr
                          : key_bias + static_cast<size_t>(b) * (bias_head_stride ? H : 1) * S +
                                static_cast<size_t>(h) * bias_head_stride;
  const bool dead = keep_weights(bias, S, w_s);

  // projection: [q_h | k_h | v_h] = T(x[rows] . wqkv[head rows]^T), 32 rows at a time
  for (int r0 = 0; r0 < Sq; r0 += 32) {
    float acc[kRows][kCols] = {};
    for (int e0 = 0; e0 < E; e0 += kKC) {
      __syncthreads();  // the previous tiles are consumed
      for (int i = tid; i < 32 * kKC; i += kThreads) {
        const int r = i / kKC, e = i % kKC;
        x_t[r * (kKC + 1) + e] = r0 + r < S ? to_f32(x[(row0 + r0 + r) * E + e0 + e]) : 0.f;
      }
      for (int i = tid; i < 3 * DH * kKC; i += kThreads) {
        const int c = i / kKC, e = i % kKC;
        const int part = c / DH;  // 0 q, 1 k, 2 v
        const size_t wrow = static_cast<size_t>(part) * E + col + (c - part * DH);
        w_t[c * (kKC + 1) + e] = to_f32(wqkv[wrow * E + e0 + e]);
      }
      __syncthreads();
#pragma unroll 4
      for (int e = 0; e < kKC; ++e) {
        float wv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) wv[c] = w_t[(lane + 32 * c) * (kKC + 1) + e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float xv = x_t[(warp * kRows + i) * (kKC + 1) + e];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(xv, wv[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + warp * kRows + i;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int cc = lane + 32 * c, part = cc / DH, d = cc - part * DH;
        const T val = from_f32<T>(r < S ? acc[i][c] : 0.f);
        if (part == 0) q_s[r * ld + d] = val;
        else if (r < S) (part == 1 ? k_s : v_s)[r * ld + d] = val;
      }
    }
  }

  for (int q0 = 0; q0 < S; q0 += kQT) {
    __syncthreads();  // q_s, k_s, v_s are written / the previous tile's sc is consumed
    if (!dead) tile_scores<T, DH>(q_s + static_cast<size_t>(q0) * ld, ld, k_s, ld, S, sc, S);
    __syncthreads();
    softmax_rows<T>(sc, S, S, w_s, dead);
    __syncthreads();
    float acc[kQT * DH / kThreads] = {};
    tile_pv<T, DH>(sc, S, v_s, ld, S, acc);
    store_rows<T, DH>(acc, out, row0, q0, S, E, col);
  }
}

// Allows `smem` bytes of dynamic shared memory (above 48 KB a kernel must
// opt in); returns the cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);  // 227 KB per block
  if (int err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared))
    return err;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int DH>
int launch_k1(const void* q, const void* k, const void* v, const float* key_bias, void* out,
              int B, int S, int E, int nhead, cudaStream_t stream) {
  auto kernel = encoder_attention_kernel<T, DH>;
  const size_t smem = k1_smem<T, DH>(S);
  if (int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((S + kQT - 1) / kQT, nhead, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), key_bias,
                                           static_cast<T*>(out), S, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_k6(const void* x, const void* wqkv, const float* key_bias, int bias_head_stride,
              void* out, int B, int S, int E, int nhead, cudaStream_t stream) {
  auto kernel = encoder_self_attention_kernel<T, DH>;
  const size_t smem = k6_smem<T, DH>(S);
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<dim3(nhead, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), key_bias, bias_head_stride,
      static_cast<T*>(out), S, E, nhead);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k1(const void* q, const void* k, const void* v, const float* key_bias, void* out,
                int B, int S, int E, int nhead, cudaStream_t st) {
  const int dh = E / nhead;
  if (dh == 32) return launch_k1<T, 32>(q, k, v, key_bias, out, B, S, E, nhead, st);
  if (dh == 64) return launch_k1<T, 64>(q, k, v, key_bias, out, B, S, E, nhead, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_k6(const void* x, const void* wqkv, const float* key_bias, int bias_head_stride,
                void* out, int B, int S, int E, int nhead, cudaStream_t st) {
  const int dh = E / nhead;
  if (dh == 32)
    return launch_k6<T, 32>(x, wqkv, key_bias, bias_head_stride, out, B, S, E, nhead, st);
  if (dh == 64)
    return launch_k6<T, 64>(x, wqkv, key_bias, bias_head_stride, out, B, S, E, nhead, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace ralf

// Every entry point returns the cudaError_t of its launch (0 on success).

// K1: q, k, v, out [B, S, E] of the dtype code; key_bias [B, S] fp32 or null.
extern "C" int ralf_encoder_attention(int dtype, const void* q, const void* k, const void* v,
                                      const float* key_bias, void* out, int B, int S, int E,
                                      int nhead, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::dispatch_k1<float>(q, k, v, key_bias, out, B, S, E, nhead, st);
  if (dtype == ralf::kBFloat16)
    return ralf::dispatch_k1<__nv_bfloat16>(q, k, v, key_bias, out, B, S, E, nhead, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6: x, out [B, S, E] and wqkv [3E, E] of the dtype code; key_bias fp32
// [B, S] (bias_head_stride 0), [B, H, S] (bias_head_stride S) or null.
extern "C" int ralf_encoder_self_attention(int dtype, const void* x, const void* wqkv,
                                           const float* key_bias, int bias_head_stride,
                                           void* out, int B, int S, int E, int nhead,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::dispatch_k6<float>(x, wqkv, key_bias, bias_head_stride, out, B, S, E, nhead, st);
  if (dtype == ralf::kBFloat16)
    return ralf::dispatch_k6<__nv_bfloat16>(x, wqkv, key_bias, bias_head_stride, out, B, S, E,
                                            nhead, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
