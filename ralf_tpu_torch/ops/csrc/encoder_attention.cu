// K1: bidirectional multi-head encoder self-attention, forward only.
//
// Replaces the Pallas TPU kernel ralf_tpu/ops/pallas/encoder_attention.py
// fused_encoder_attention (_kernel / _kernel_bias through _attend_block).
//
//   out[b, s, h*Dh:(h+1)*Dh] = softmax_m(q_h[s] . k_h[m] + key_bias[b, m]) v_h[m]
//
// q, k, v and out are [B, S, E] with head h in columns h*Dh.. (the layout the
// projections write, read directly: no head-major transposes through device
// memory).  The softmax scale is already folded into q.  key_bias is the
// key-padding bias, 0 for a kept key and -1e9 for a masked one; a batch row
// with no kept key attends uniformly over all S keys (the mean of V), the
// TPU kernel's rule, never 0/0.
//
// What bounds it on the H100: at the image encoder's shape (B=128, S=330,
// E=256, bf16) the call must move 4*B*S*E*2 = 86.5 MB (q, k, v read once,
// out written once), 25.8 us at 3.35 TB/s, against 14.3 GFLOP, 14.5 us at the
// bf16 tensor-core peak: memory-bound.
//
// Design (simple and right first): one block per (query tile of 32, head,
// batch row).  The block streams the head's keys and values through shared
// memory in tiles of 2048/Dh keys, converts them to fp32, and runs an online
// softmax with fp32 accumulators in registers, so the [S, S] score matrix
// never exists.  Every query tile of a row re-reads that row's K and V, from
// L2 after the first; the dot products run on the CUDA cores, not the tensor
// cores.  Both cost time against the bound; a later change can hold one row
// per block and move the contractions to mma.sync.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kThreads = 128;
constexpr int kQueries = 32;  // queries per block

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) encoder_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_bias, T* __restrict__ out, int S, int E) {
  constexpr int KT = 2048 / DH;                          // keys per tile
  constexpr int kWarps = kThreads / 32;
  constexpr int kRowsPerWarp = kQueries / kWarps;        // softmax rows per warp
  constexpr int kRowGroups = kThreads / DH;              // threads sharing a column d
  constexpr int kAcc = kQueries / kRowGroups;            // accumulators per thread

  __shared__ float q_s[kQueries][DH];
  __shared__ float k_s[KT][DH + 1];  // +1: conflict-free column reads
  __shared__ float v_s[KT][DH];
  __shared__ float p_s[kQueries][KT];
  __shared__ float bias_s[KT];
  __shared__ float alpha_s[kQueries];
  __shared__ float inv_l_s[kQueries];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kQueries;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int col = h * DH;

  // A row whose keys are all masked attends uniformly: every score is 0.
  int kept = key_bias == nullptr;
  if (key_bias != nullptr) {
    for (int j = tid; j < S; j += kThreads) kept |= expf(key_bias[row0 + j]) > 0.f;
  }
  const bool dead = !__syncthreads_or(kept);

  for (int i = tid; i < kQueries * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_s[r][d] = q0 + r < S ? to_f32(q[(row0 + q0 + r) * E + col + d]) : 0.f;
  }

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_r[rr] = -INFINITY;
    l_r[rr] = 0.f;
  }
  const int d = tid % DH;
  const int r_base = tid / DH;
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  for (int j0 = 0; j0 < S; j0 += KT) {
    __syncthreads();  // the previous tile's k_s / v_s / p_s are consumed
    for (int i = tid; i < KT * DH; i += kThreads) {
      const int jj = i / DH, dd = i % DH;
      float kv = 0.f, vv = 0.f;
      if (j0 + jj < S) {
        const size_t off = (row0 + j0 + jj) * E + col + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[jj][dd] = kv;
      v_s[jj][dd] = vv;
    }
    for (int jj = tid; jj < KT; jj += kThreads) {
      float bv = -INFINITY;  // past the end of the row: no weight
      if (j0 + jj < S) bv = (dead || key_bias == nullptr) ? 0.f : key_bias[row0 + j0 + jj];
      bias_s[jj] = bv;
    }
    __syncthreads();

    // scores of this tile: lanes of a warp take consecutive keys of one query
    for (int i = tid; i < kQueries * KT; i += kThreads) {
      const int r = i / KT, jj = i % KT;
      float s = bias_s[jj];
      if (!dead && s != -INFINITY) {
        float dot = 0.f;
#pragma unroll
        for (int dd = 0; dd < DH; ++dd) dot = fmaf(q_s[r][dd], k_s[jj][dd], dot);
        s += dot;
      }
      p_s[r][jj] = s;
    }
    __syncthreads();

    // online softmax: each warp owns kRowsPerWarp query rows
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float tmax = -INFINITY;
      for (int jj = lane; jj < KT; jj += 32) tmax = fmaxf(tmax, p_s[r][jj]);
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m_r[rr], tmax);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_r[rr] - m_new);
      float sum = 0.f;
      for (int jj = lane; jj < KT; jj += 32) {
        const float s = p_s[r][jj];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        p_s[r][jj] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      l_r[rr] = l_r[rr] * alpha + sum;
      m_r[rr] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // rescale and accumulate p . v; lanes of a warp take consecutive columns d
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int r = r_base + kRowGroups * a;
      float o = acc[a] * alpha_s[r];
#pragma unroll 8
      for (int jj = 0; jj < KT; ++jj) o = fmaf(p_s[r][jj], v_s[jj][d], o);
      acc[a] = o;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (lane == 0) inv_l_s[warp * kRowsPerWarp + rr] = 1.f / l_r[rr];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int r = r_base + kRowGroups * a;
    if (q0 + r < S) out[(row0 + q0 + r) * E + col + d] = from_f32<T>(acc[a] * inv_l_s[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* key_bias, void* out,
           int B, int S, int E, int nhead, cudaStream_t stream) {
  const dim3 grid((S + kQueries - 1) / kQueries, nhead, B);
  const int dh = E / nhead;
  if (dh == 32) {
    encoder_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_bias,
        static_cast<T*>(out), S, E);
  } else if (dh == 64) {
    encoder_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_bias,
        static_cast<T*>(out), S, E);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ralf

// Returns the cudaError_t of the launch (0 on success).  key_bias may be null.
extern "C" int ralf_encoder_attention(int dtype, const void* q, const void* k, const void* v,
                                      const float* key_bias, void* out, int B, int S, int E,
                                      int nhead, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch<float>(q, k, v, key_bias, out, B, S, E, nhead, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch<__nv_bfloat16>(q, k, v, key_bias, out, B, S, E, nhead, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
