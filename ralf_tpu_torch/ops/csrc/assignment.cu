// The exact linear-sum assignment of each batch row (Jonker-Volgenant,
// shortest augmenting paths with potentials).
//
// Replaces ralf_tpu/ops/assignment.py batched_lsa (:99, _lsa_one :28), which
// JAX computes with lax while-loops vmapped over the batch (XLA, no Pallas
// kernel).  cost [B, n, n] fp32 -> out [B, n] int32, the column assigned to
// each row; the GANs' Hungarian matching calls it once a generator step at
// n = max_seq_length = 10.
//
// What bounds it: neither bytes nor operations.  A row's solve is a chain of
// data-dependent steps (about n^2 / 2 Dijkstra steps, each a masked min over
// n + 1 columns) on 4 n^2 + 4 n bytes; at B = 32, n = 10 the card's bound is
// nanoseconds and the launch itself is the cost.  The plain version
// (ops/assignment.py batched_lsa_plain) runs the same steps as masked tensor
// ops, some 25 launches a step; this kernel is one launch with no read-back.
//
// Design: one warp per batch row, lane l holding column j = l + 1 (so n <= 32):
// its v[j], minv[j], used[j], way[j] and p[j] live in registers, the virtual
// column 0 (p[0] = the row being added, used from the first step) is handled
// by every lane alike, and the row's cost and the row potentials u sit in
// shared memory.  The masked min is a butterfly over (value, column) with the
// lower column winning a tie, and the virtual column's (1e30, 0) candidate
// last: JAX's first-index argmin over the same masked vector.  Every float
// operation is JAX's, in its order: cur = (a[i0] - u[i0]) - v, then u += delta
// on the used columns' rows, v -= delta on the used columns and minv -= delta
// on the others, so the assignment is JAX's bit for bit, ties included.  The
// loops are bounded (n + 1 steps each), so that a cost holding NaN or values
// near 1e30, which the callers never pass, cannot hang the card.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kMaxN = 32;
constexpr float kInf = 1e30f;  // ralf_tpu/ops/assignment.py _INF
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32) batched_lsa_kernel(const float* __restrict__ cost,
                                                                  int* __restrict__ out, int B,
                                                                  int n) {
  __shared__ float a_sh[kWarps][kMaxN * kMaxN];
  __shared__ float u_sh[kWarps][kMaxN + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps only
  float* a = a_sh[warp];  // a[(i - 1) * n + (j - 1)]: row i, column j, 1-based
  float* u = u_sh[warp];  // u[i], row potentials, i in 0..n
  const float* c = cost + static_cast<size_t>(b) * n * n;
  for (int k = lane; k < n * n; k += 32) a[k] = c[k];
  for (int k = lane; k <= n; k += 32) u[k] = 0.f;
  __syncwarp();

  const bool real = lane < n;
  float v = 0.f;  // v[j]
  int p = 0;      // p[j]: the row matched to column j, 0 for none
  for (int i = 1; i <= n; ++i) {
    float minv = kInf;
    bool used = false;
    int way = 0;
    int j0 = 0;  // uniform across the warp
    for (int step = 0; step <= n; ++step) {
      if (lane == j0 - 1) used = true;
      const int pj = __shfl_sync(kFull, p, j0 > 0 ? j0 - 1 : 0);
      const int i0 = j0 == 0 ? i : pj;
      const float ui0 = u[i0];
      const bool live = real && !used;
      if (live) {
        const float cur = (a[(i0 - 1) * n + lane] - ui0) - v;
        if (cur < minv) {
          minv = cur;
          way = j0;
        }
      }
      float m = live ? minv : kInf;
      int idx = lane + 1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(kFull, m, o);
        const int idx2 = __shfl_xor_sync(kFull, idx, o);
        if (m2 < m || (m2 == m && idx2 < idx)) {
          m = m2;
          idx = idx2;
        }
      }
      if (m >= kInf) {  // the virtual column's (1e30, 0) comes first in a tie
        m = kInf;
        idx = 0;
      }
      const float delta = m;
      __syncwarp();  // every lane has read u[i0]
      if (lane == 0) u[i] += delta;  // column 0, matched to row i
      if (real && used) u[p] += delta;
      __syncwarp();
      if (real) {
        if (used) {
          v = v - delta;
        } else {
          minv = minv - delta;
        }
      }
      j0 = idx;
      const int pj1 = __shfl_sync(kFull, p, j0 > 0 ? j0 - 1 : 0);
      if ((j0 == 0 ? i : pj1) == 0) break;  // reached a free column
    }
    // walk back along way[], shifting each column's row to the next
    for (int step = 0; step <= n && j0 != 0; ++step) {
      const int j1 = __shfl_sync(kFull, way, j0 - 1);
      const int pj1 = __shfl_sync(kFull, p, j1 > 0 ? j1 - 1 : 0);
      if (lane == j0 - 1) p = j1 == 0 ? i : pj1;
      j0 = j1;
    }
  }
  if (real && p > 0) out[static_cast<size_t>(b) * n + p - 1] = lane;
}

}  // namespace
}  // namespace ralf

// Returns the cudaError_t of the launch (0 on success).  cost [B, n, n] fp32,
// out [B, n] int32 (zeroed by the caller), 1 <= n <= 32.
extern "C" int ralf_batched_lsa(const float* cost, int* out, int B, int n, void* stream) {
  if (n < 1 || n > ralf::kMaxN || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + ralf::kWarps - 1) / ralf::kWarps;
  ralf::batched_lsa_kernel<<<grid, ralf::kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      cost, out, B, n);
  return static_cast<int>(cudaGetLastError());
}
