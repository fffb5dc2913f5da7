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
// against 4*B*S*S*E = 14.3 GFLOP (14.5 us at the bf16 tensor-core peak).
// On the CUDA cores the same 14.3 GFLOP take 0.21 ms even at the 67 TFLOP/s
// fp32 peak, so in bf16 both products run on the tensor cores.  What is
// left is the B*H*S*S = 111.5 M scores: each takes a max, an expf (about
// eight instructions, one on the SFU), a sum, the scaling by 1 / l and a
// rounding, some ten times the instructions of its share of the mma, and
// each row's max and sum cross warps through shared memory and barriers.
// The ALU and the latency of those steps, not the bytes, bound it.  K6 moves
// x and the output, 43.3 MB plus the per-head biases, against 2*B*S*E*3E =
// 16.6 GFLOP of projection and the same 14.3 of attention (31.2 us):
// operation-bound.
//
// K1 in bf16: both products on the tensor cores (mma.sync.m16n8k16, bf16
// in, fp32 sums, ldmatrix from shared memory; K and V by 16-byte cp.async,
// zero rows past S with keep weight 0).  Because p is rounded AFTER
// normalisation, an online softmax alone cannot produce it:
//   S <= 384 (every shape the model sends: 330, 4..89, 11): the score row
//     in registers.  One block of 8 warps per (head, batch row), two blocks
//     a SM, loads K_h and V_h into shared memory once.  Its 2 row groups of
//     4 warps then walk the query tiles of 16 in turns, each at its own pace
//     (a named barrier per group); the 4 warps of a group each take every
//     4th chunk of 16 keys, so a row's scores fit in their registers.  The
//     row max over kept keys and then the row sum go between the 4 warps
//     through shared memory, so each score takes ONE expf and one Q K^T; p =
//     T(exp(min(s - m, 0)) w / l) goes from the accumulator fragment into
//     the A fragment of P V.  Variants timed on the card at B=128, S=330
//     and dropped: one block of 16 warps a SM, and block-wide barriers, were
//     slower; so was one warp holding all of a row's scores (192 registers
//     a thread, 8 warps a SM); a fast exp barely helped.  The latency that
//     16 warps a SM hide, not the arithmetic, decides.
//   S > 384: recompute, two passes over K streamed in tiles of 64 (the
//     registers cannot hold the row): pass A keeps each row's running max
//     over kept keys and its rescaled sum, pass B recomputes the scores and
//     forms p.
// Other head widths up to 64 (ICVT's image encoder: E=200, H=8, Dh=25) run
// the same kernels, bf16 and fp32, on heads padded with zero columns to the
// next of 32 and 64 (the kPad instances): zero columns change neither q . k
// nor p . v, so the tensor-core tiles run as at 32.  A head then starts at
// no 16-byte boundary (col = h * Dh, 50 bytes a head in bf16), so its rows
// are copied element by element rather than by cp.async, and only its Dh
// real columns are stored.  The 32 and 64 instances are unchanged.
// A row with no kept key takes s = m = 0, w = 1 for j < S and l = S: p =
// T(1/S), the mean of V.  1 / l multiplies (within an ulp of the division
// before rounding); expf stays (ex2.approx's few ulps flip roundings of p
// that the cancelling-pairs card test shows).  In fp32 K1 keeps the
// CUDA-core kernel below (encoder_attention_kernel<float, DH>): TF32 would
// not be exact.
//
// K6 in bf16 with S <= 384 (every shape the model sends: 330, 4..89, 10
// and 11): one block per (head, batch row).  A block cannot hold a whole
// row's qkv [S, 3E] (507 KB in bf16 at S=330, against 227 KB of shared
// memory), so it splits by head.  It projects Q_h, K_h, V_h [S, Dh] of its
// head on the tensor cores (x and the head's 3*Dh rows of wqkv streamed
// along E by cp.async, fp32 sums rounded once to bf16), K_h and V_h into
// shared memory and Q_h into the head's columns of its own output, then
// runs K1's rows route over them (rows_attention, the same device code as
// K1's), with the head's keep weights.  x is read once per head, 8 times at
// H=8, mostly from L2.
//
// K1 in fp32, and K6 in fp32 or past S=384 (simple and right; the
// contractions run on the CUDA cores; TF32 would not be exact).  Because p
// is rounded after normalisation, a query tile holds its whole [32, S]
// score row in shared memory (fp32; 132 KB at S=1024, the most K1 takes):
// scores, then a warp per row turns them into rounded probabilities, then
// the PV sums.
//   K1 fp32: one block per (query tile of 32, head, batch row).  Pass 1
//   streams the head's keys through shared memory in tiles of 64 for the
//   scores; pass 2 streams the values (again, mostly from L2).
//   K6: one block per (head, batch row) projects q_h, k_h, v_h into shared
//   memory (x streamed in [32, 32] tiles, wqkv's 3*Dh rows of the head in
//   [3*Dh, 32] tiles), then walks its query tiles over them.

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// Rows q0.. of one head's output: out[(row0 + q0 + r) * E + col + d]; a
// padded head (kPad) stores its dh real columns only.
template <typename T, int DH, bool kPad = false>
__device__ __forceinline__ void store_rows(const float* acc, T* out, size_t row0, int q0, int S,
                                           int E, int col, int dh = DH) {
  constexpr int kGroups = kThreads / DH;
  const int d = threadIdx.x % DH, rg = threadIdx.x / DH;
  if (kPad && d >= dh) return;
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

// kPad: a head of dh < DH columns (dh = E / nhead, nhead = gridDim.y) held
// with zero columns dh..DH-1, which change neither q . k nor p . v.
template <typename T, int DH, bool kPad>
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
  const int dh = kPad ? E / static_cast<int>(gridDim.y) : DH;
  const int col = h * dh;

  const bool dead = keep_weights(key_bias == nullptr ? nullptr : key_bias + row0, S, w_s);
  for (int i = tid; i < kQT * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_s[r * ld + d] = q0 + r < S && (!kPad || d < dh) ? q[(row0 + q0 + r) * E + col + d]
                                                      : from_f32<T>(0.f);
  }
  // pass 1: the scores of every key (a dead row needs none)
  for (int j0 = 0; j0 < S && !dead; j0 += kKT) {
    const int n = min(kKT, S - j0);
    __syncthreads();  // q_s is written / the previous tile is consumed
    for (int i = tid; i < n * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      kv_s[j * ld + d] = !kPad || d < dh ? k[(row0 + j0 + j) * E + col + d] : from_f32<T>(0.f);
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
      kv_s[j * ld + d] = !kPad || d < dh ? v[(row0 + j0 + j) * E + col + d] : from_f32<T>(0.f);
    }
    __syncthreads();
    tile_pv<T, DH>(sc + j0, S, kv_s, ld, n, acc);
  }
  store_rows<T, DH, kPad>(acc, out, row0, q0, S, E, col, dh);
}

// ---- K1 in bf16 on the tensor cores (see the top of the file) ----

// Row stride of a bf16 tile in shared memory, in elements: Dh + 8 makes it
// an odd number of 16-byte units, so the 8 rows that one ldmatrix matrix
// reads fall on distinct banks.
template <int DH>
__host__ __device__ constexpr int mma_ld() { return DH + 8; }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// w_s[j] = exp(bias[j]) (1 without a bias) for j < S, 0 for S <= j < n;
// returns true when no key of the row is kept, and then w_s[j] = 1 for j < S
// (a dead row attends uniformly: s = m = 0, w = 1).  Ends in a barrier that
// publishes all but the dead row's rewrite, which the caller's next barrier does.
__device__ __forceinline__ bool mma_keep_weights(const float* bias, int S, int n, float* w_s) {
  int kept = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float w = j >= S ? 0.f : bias == nullptr ? 1.f : expf(bias[j]);
    w_s[j] = w;
    kept |= w > 0.f;
  }
  const bool dead = !__syncthreads_or(kept);
  if (dead) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) w_s[j] = j < S ? 1.f : 0.f;
  }
  return dead;
}

// Rows r0 .. r0+n of one head (columns col ..) of src [rows of E] into dst
// [n][ld] by 16-byte cp.async, issued by threads tid of nthreads; zeros for
// rows at or past S.
template <int DH>
__device__ __forceinline__ void load_head_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               size_t row0, int r0, int n, int S, int E, int col,
                                               int tid, int nthreads) {
  constexpr int kChunks = DH / 8;
  for (int i = tid; i < n * kChunks; i += nthreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool valid = r0 + r < S;
    cp_async16(dst + r * mma_ld<DH>() + ch * 8,
               src + (row0 + (valid ? r0 + r : 0)) * E + col + ch * 8, valid);
  }
}

// load_head_rows for K1 at any head width: with kPad a head of dh < DH
// columns starts at no 16-byte boundary (col = h * dh), so its rows are
// copied element by element, with zero columns dh..DH-1 (they change
// neither q . k nor p . v), kPadBatch loads of a thread in flight before
// their stores (plain loads block, where cp.async does not); else by
// cp.async.
constexpr int kPadBatch = 8;

template <int DH, bool kPad>
__device__ __forceinline__ void load_head(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row0, int r0, int n, int S, int E, int col,
                                          int dh, int tid, int nthreads) {
  if constexpr (kPad) {
    const int total = n * DH;
    for (int i0 = tid; i0 < total; i0 += nthreads * kPadBatch) {
      __nv_bfloat16 x[kPadBatch];
#pragma unroll
      for (int u = 0; u < kPadBatch; ++u) {
        const int i = i0 + u * nthreads, r = i / DH, d = i % DH;
        x[u] = i < total && r0 + r < S && d < dh ? src[(row0 + r0 + r) * E + col + d]
                                                 : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kPadBatch; ++u) {
        const int i = i0 + u * nthreads;
        if (i < total) dst[(i / DH) * mma_ld<DH>() + i % DH] = x[u];
      }
    }
  } else {
    load_head_rows<DH>(dst, src, row0, r0, n, S, E, col, tid, nthreads);
  }
}

template <int DH, bool kPad>
__device__ __forceinline__ void load_head(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row0, int r0, int n, int S, int E, int col,
                                          int dh) {
  load_head<DH, kPad>(dst, src, row0, r0, n, S, E, col, dh, threadIdx.x, blockDim.x);
}

// The Q fragments of the 16 rows at q (stride mma_ld): matrices rows 0-7 |
// d 0-7 (a0), rows 8-15 | d 0-7 (a1), rows 0-7 | d 8-15, rows 8-15 | d 8-15.
template <int DH>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[DH / 16][4], const __nv_bfloat16* q) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = q + ((lane & 7) + ((lane >> 3) & 1) * 8) * mma_ld<DH>() + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) ldmatrix_x4(qa[ks], row + ks * 16);
}

// s[0], s[1] (n-tiles of keys 0-7 and 8-15) = Q K^T for one chunk of 16
// keys at kt (stride mma_ld).
template <int DH>
__device__ __forceinline__ void chunk_scores(const uint32_t (&qa)[DH / 16][4],
                                             const __nv_bfloat16* kt, float (&s0)[4], float (&s1)[4]) {
  const int lane = threadIdx.x & 31;
  s0[0] = s0[1] = s0[2] = s0[3] = s1[0] = s1[1] = s1[2] = s1[3] = 0.f;
  // matrices: keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7, keys 8-15 | d 8-15
  const __nv_bfloat16* row = kt + ((lane & 7) + (lane >> 4) * 8) * mma_ld<DH>() + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t bk[4];
    ldmatrix_x4(bk, row + ks * 16);
    mma_bf16(s0, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], bk[0], bk[1]);
    mma_bf16(s1, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], bk[2], bk[3]);
  }
}

// o += T(p) V for one chunk of 16 keys at vt (stride mma_ld); p0, p1 are the
// probabilities of n-tiles 0 and 1 in accumulator layout, rounded here.
template <int DH>
__device__ __forceinline__ void chunk_pv(const float (&p0)[4], const float (&p1)[4],
                                         const __nv_bfloat16* vt, float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = pack_bf16(p0[0], p0[1]), a1 = pack_bf16(p0[2], p0[3]);
  const uint32_t a2 = pack_bf16(p1[0], p1[1]), a3 = pack_bf16(p1[2], p1[3]);
  // matrices: keys 0-7 | d 0-7, keys 8-15 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 8-15
  const __nv_bfloat16* row = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * mma_ld<DH>() + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, row + dp * 16);
    mma_bf16(o[2 * dp], a0, a1, a2, a3, bv[0], bv[1]);
    mma_bf16(o[2 * dp + 1], a0, a1, a2, a3, bv[2], bv[3]);
  }
}

// The rows g and g + 8 of a warp's [16, DH] output, rounded, to out; a
// padded head (kPad) stores its dh real columns, one element at a time.
template <int DH, bool kPad = false>
__device__ __forceinline__ void store_frag_rows(const float (&o)[DH / 8][4], __nv_bfloat16* out,
                                                size_t row0, int qr0, int S, int E, int col,
                                                int dh = DH) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = qr0 + g + 8 * r;
    if (qr >= S) continue;
    __nv_bfloat16* dst = out + (row0 + qr) * E + col + 2 * c;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if constexpr (kPad) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n * 8 + 2 * c + e < dh) dst[n * 8 + e] = __float2bfloat16(o[n][2 * r + e]);
        }
      } else {
        *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
}

// -- S <= 384: one pass, the scores in registers --
//
// One block per (head, batch row) loads K_h and V_h whole.  Then its 2 row
// groups of 4 warps walk the query tiles of 16 in turns (group rg takes the
// tiles rg, rg + 2, ...), each at its own pace: a group synchronises only
// its own threads (named barrier 1 + rg) and keeps its next tile's Q in
// flight behind the current one.  Warp (rg, ks) owns the chunks of 16 keys
// ks, ks + 4, ...: its scores stay in registers (48 of them at S=384).  The
// row max over kept keys and then the row sum go between the 4 warps of the
// group through shared memory; each score takes one expf, p = T(e / l)
// feeds the P V product from registers, and the 4 partial outputs of a row
// are added through shared memory in a fixed order.
constexpr int kRowGroups = 2;
constexpr int kKeySplit = 4;
constexpr int kGroupThreads = 32 * kKeySplit;
constexpr int kRowsThreads = kGroupThreads * kRowGroups;
constexpr int kRowsQ = 2 * 16 * kRowGroups;  // rows of Q in shared memory: two tiles a group
constexpr int kRowsMaxS = 384;
constexpr int kRowsChunks = kRowsMaxS / 16 / kKeySplit;  // chunks of 16 keys a warp holds
template <int DH>
__host__ __device__ constexpr int ox_ld() { return DH + 8; }  // 8 mod 32 words: float2 stores spread

// Synchronises the threads of row group rg (barrier 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(kGroupThreads) : "memory");
}

template <int DH>
size_t k1_rows_smem(int S) {
  const size_t s16 = round16(S);
  return (kRowsQ + 2 * s16) * mma_ld<DH>() * sizeof(__nv_bfloat16) +
         (static_cast<size_t>(kRowGroups) * kKeySplit * 16 * ox_ld<DH>() + s16 +
          2 * kRowGroups * kKeySplit * 16) * sizeof(float);
}

// The rows route from the query tiles on, shared by K1 and K6.  K_h, V_h
// (zero rows past S) and the keep weights w_s [s16] are in shared memory
// or in flight by this thread's cp.async; the query rows are streamed from
// q (rows of E, the head's columns at col), each row group's next tile in
// flight behind the current one in its two buffers of q_s [2][2][16][ld].
// o_x [2][4][16][ox_ld] and red_m, red_l [2][4][16] are its scratch.  The
// output rows go to out[(row0 + r) * E + col ..] (K6 passes its own output
// as q: a tile's rows are read before they are written).  kPad: a head of
// dh < DH columns, loaded and stored element by element (`load_head`).
template <int DH, bool kPad = false>
__device__ __forceinline__ void rows_attention(const __nv_bfloat16* q, __nv_bfloat16* q_s,
                                               const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
                                               const float* w_s, bool dead, float* o_x,
                                               float* red_m, float* red_l, __nv_bfloat16* out,
                                               size_t row0, int S, int E, int col, int dh = DH) {
  constexpr int ld = mma_ld<DH>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / kKeySplit, ks = warp % kKeySplit;
  const int tg = threadIdx.x - rg * kGroupThreads;  // thread of its row group
  const int g = lane >> 2, c = lane & 3;
  __nv_bfloat16* q_g = q_s + rg * 2 * 16 * ld;  // the group's two Q tiles
  load_head<DH, kPad>(q_g, q, row0, rg * 16, 16, S, E, col, dh, tg, kGroupThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K, V, w and each group's first Q tile landed

  float* my_m = red_m + (rg * kKeySplit + ks) * 16;
  float* my_l = red_l + (rg * kKeySplit + ks) * 16;
  const int tiles = (S + 15) / 16;
  for (int t = rg, buf = 0; t < tiles; t += kRowGroups, buf ^= 1) {
    const int q0 = t * 16;
    if (t != rg) {
      cp_async_wait<0>();
      group_sync(rg);  // this tile's Q landed; the last tile's o_x, red_* are read
    }
    if (t + kRowGroups < tiles) {
      load_head<DH, kPad>(q_g + (buf ^ 1) * 16 * ld, q, row0, q0 + kRowGroups * 16, 16, S, E, col,
                          dh, tg, kGroupThreads);
      cp_async_commit();
    }
    float s[2 * kRowsChunks][4];
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 2 * kRowsChunks; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    if (!dead) {
      uint32_t qa[DH / 16][4];
      load_q_frags<DH>(qa, q_g + buf * 16 * ld);
#pragma unroll
      for (int i = 0; i < kRowsChunks; ++i) {
        const int key0 = (ks + kKeySplit * i) * 16;
        if (key0 >= S) break;
        chunk_scores<DH>(qa, k_s + key0 * ld, s[2 * i], s[2 * i + 1]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (w_s[key0 + n * 8 + 2 * c + e] > 0.f) {
              mt[0] = fmaxf(mt[0], s[2 * i + n][e]);
              mt[1] = fmaxf(mt[1], s[2 * i + n][2 + e]);
            }
          }
        }
      }
    }
    mt[0] = quad_max(mt[0]);
    mt[1] = quad_max(mt[1]);
    if (c == 0) {
      my_m[g] = mt[0];
      my_m[g + 8] = mt[1];
    }
    group_sync(rg);
    float m[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeySplit; ++kk) m[r] = fmaxf(m[r], red_m[(rg * kKeySplit + kk) * 16 + g + 8 * r]);
      if (dead) m[r] = 0.f;  // and s = 0: e = w
    }
#pragma unroll
    for (int i = 0; i < kRowsChunks; ++i) {
      const int key0 = (ks + kKeySplit * i) * 16;
      if (key0 >= S) break;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = w_s[key0 + n * 8 + 2 * c + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float x = expf(fminf(s[2 * i + n][2 * r + e] - m[r], 0.f)) * w;
            s[2 * i + n][2 * r + e] = x;
            l[r] += x;
          }
        }
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    if (c == 0) {
      my_l[g] = l[0];
      my_l[g + 8] = l[1];
    }
    group_sync(rg);
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeySplit; ++kk) sum += red_l[(rg * kKeySplit + kk) * 16 + g + 8 * r];
      inv[r] = 1.f / fmaxf(sum, 1e-30f);  // within an ulp of the division before rounding
    }
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsChunks; ++i) {
      const int key0 = (ks + kKeySplit * i) * 16;
      if (key0 >= S) break;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * i + n][e] *= inv[e >> 1];
      }
      chunk_pv<DH>(s[2 * i], s[2 * i + 1], v_s + key0 * ld, o);
    }
    float* ox = o_x + ((rg * kKeySplit + ks) * 16 + g) * ox_ld<DH>() + 2 * c;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<float2*>(ox + n * 8) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(ox + 8 * ox_ld<DH>() + n * 8) = make_float2(o[n][2], o[n][3]);
    }
    group_sync(rg);
    // the 4 partials of each row, added in the order of ks, rounded and stored
    for (int i = tg; i < 16 * DH / 2; i += kGroupThreads) {
      const int rr = i / (DH / 2), cp = i % (DH / 2);
      if (q0 + rr >= S) continue;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < kKeySplit; ++kk) {
        const float2 x = *reinterpret_cast<const float2*>(
            o_x + ((rg * kKeySplit + kk) * 16 + rr) * ox_ld<DH>() + 2 * cp);
        acc.x += x.x;
        acc.y += x.y;
      }
      __nv_bfloat16* dst = out + (row0 + q0 + rr) * E + col + 2 * cp;
      if constexpr (kPad) {
        if (2 * cp < dh) dst[0] = __float2bfloat16(acc.x);
        if (2 * cp + 1 < dh) dst[1] = __float2bfloat16(acc.y);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc.x, acc.y);
      }
    }
  }
}

template <int DH, bool kPad>
__global__ void __launch_bounds__(kRowsThreads, 2) encoder_attention_rows_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
    __nv_bfloat16* __restrict__ out, int S, int E) {
  constexpr int ld = mma_ld<DH>();
  const int s16 = round16(S);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [2 groups][2][16][ld]
  __nv_bfloat16* k_s = q_s + kRowsQ * ld;                         // [s16][ld]
  __nv_bfloat16* v_s = k_s + static_cast<size_t>(s16) * ld;       // [s16][ld]
  float* o_x = reinterpret_cast<float*>(v_s + static_cast<size_t>(s16) * ld);  // [2][4][16][ox_ld]
  float* w_s = o_x + kRowGroups * kKeySplit * 16 * ox_ld<DH>();   // [s16]
  float* red_m = w_s + s16;                                       // [2][4][16]
  float* red_l = red_m + kRowGroups * kKeySplit * 16;             // [2][4][16]

  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int dh = kPad ? E / static_cast<int>(gridDim.x) : DH;  // gridDim.x = nhead
  const int col = h * dh;

  const bool dead = mma_keep_weights(key_bias == nullptr ? nullptr : key_bias + row0, S, s16, w_s);
  if (!dead) load_head<DH, kPad>(k_s, k, row0, 0, s16, S, E, col, dh);
  load_head<DH, kPad>(v_s, v, row0, 0, s16, S, E, col, dh);
  rows_attention<DH, kPad>(q, q_s, k_s, v_s, w_s, dead, o_x, red_m, red_l, out, row0, S, E, col,
                           dh);
}

// -- S > 384: recompute, two passes over K streamed in tiles --
//
// One block of 8 warps per (query tile of 128, head, batch row); each warp
// owns 16 query rows, their Q fragments in registers.  Key tiles of 64 take
// turns in two slots of shared memory, the next in flight behind the current.
//   pass A: per tile the scores, then per row the running max m over kept
//     keys and the sum l of exp(s - m) w, rescaled when m grows (a tile with
//     no kept key leaves m at -inf and rescales nothing: no exp(-inf + inf));
//   pass B: the scores again, p = T(exp(min(s - m, 0)) w / l) into P V.
constexpr int kRecWarps = 8;
constexpr int kRecThreads = 32 * kRecWarps;
constexpr int kRecQ = 16 * kRecWarps;  // queries a block
constexpr int kRecK = 64;              // keys a tile

template <int DH>
size_t k1_rec_smem(int S) {
  const int tiles = (S + kRecK - 1) / kRecK;
  return (static_cast<size_t>(kRecQ) + 4 * kRecK) * mma_ld<DH>() * sizeof(__nv_bfloat16) +
         static_cast<size_t>(tiles) * kRecK * sizeof(float);
}

template <int DH, bool kPad>
__global__ void __launch_bounds__(kRecThreads) encoder_attention_rec_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
    __nv_bfloat16* __restrict__ out, int S, int E) {
  constexpr int ld = mma_ld<DH>();
  constexpr int kN = kRecK / 8;  // n-tiles of a key tile
  const int tiles = (S + kRecK - 1) / kRecK;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRecQ][ld]
  __nv_bfloat16* k_s = q_s + kRecQ * ld;                         // [2][kRecK][ld]
  __nv_bfloat16* v_s = k_s + 2 * kRecK * ld;                     // [2][kRecK][ld]
  float* w_s = reinterpret_cast<float*>(v_s + 2 * kRecK * ld);   // [tiles * kRecK]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRecQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 3;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int dh = kPad ? E / static_cast<int>(gridDim.y) : DH;  // gridDim.y = nhead
  const int col = h * dh;

  const bool dead =
      mma_keep_weights(key_bias == nullptr ? nullptr : key_bias + row0, S, tiles * kRecK, w_s);
  // visits 0..tiles-1 are pass A (K), tiles..2*tiles-1 pass B (K and V), each
  // into slot t % 2
  const int visits = 2 * tiles;
  auto issue = [&](int t) {
    const int j = t % tiles, slot = t & 1;
    if (!dead) load_head<DH, kPad>(k_s + slot * kRecK * ld, k, row0, j * kRecK, kRecK, S, E, col, dh);
    if (t >= tiles) load_head<DH, kPad>(v_s + slot * kRecK * ld, v, row0, j * kRecK, kRecK, S, E, col, dh);
  };
  load_head<DH, kPad>(q_s, q, row0, q0, kRecQ, S, E, col, dh);
  issue(0);
  cp_async_commit();

  const bool active = q0 + warp * 16 < S;  // a warp whose rows all lie past S only loads
  uint32_t qa[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < visits; ++t) {
    if (t + 1 < visits) issue(t + 1);
    cp_async_commit();  // an empty group keeps the count of the wait below
    cp_async_wait<1>();
    __syncthreads();
    const int key0 = (t % tiles) * kRecK;
    const __nv_bfloat16* kt = k_s + (t & 1) * kRecK * ld;
    const __nv_bfloat16* vt = v_s + (t & 1) * kRecK * ld;
    if (t == 0) load_q_frags<DH>(qa, q_s + warp * 16 * ld);
    if (t == tiles) {  // pass A is done: the row sums of the quad, and the dead row's m, l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = 1.f / (dead ? static_cast<float>(S) : fmaxf(quad_sum(l[r]), 1e-30f));  // 1 / l
        if (dead) m[r] = 0.f;
      }
    }
    const bool pass_a = t < tiles;
    if (active && !(pass_a && dead)) {
      float s[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kRecK / 16; ++kc) {
        if (dead || key0 + kc * 16 >= S) break;  // past S: w = 0; dead: s = 0
        chunk_scores<DH>(qa, kt + kc * 16 * ld, s[2 * kc], s[2 * kc + 1]);
      }
      const int nlim = min(kN, (S - key0 + 7) / 8);  // n-tiles that hold keys < S
      if (pass_a) {
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          if (n >= nlim) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (w_s[key0 + n * 8 + 2 * c + e] > 0.f) {
              mt[0] = fmaxf(mt[0], s[n][e]);
              mt[1] = fmaxf(mt[1], s[n][2 + e]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mt[r]));
          if (m_new == -INFINITY) continue;  // no kept key yet: l stays 0
          l[r] *= expf(m[r] - m_new);        // m[r] = -inf: l is 0 and exp gives 0, not NaN
          m[r] = m_new;
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            if (n >= nlim) break;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              l[r] += expf(fminf(s[n][2 * r + e] - m_new, 0.f)) * w_s[key0 + n * 8 + 2 * c + e];
            }
          }
        }
      } else {
        // l holds 1 / l here
#pragma unroll
        for (int kc = 0; kc < kRecK / 16; ++kc) {
          if (key0 + kc * 16 >= S) break;
#pragma unroll
          for (int n = 2 * kc; n < 2 * kc + 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] = expf(fminf(s[n][e] - m[e >> 1], 0.f)) * w_s[key0 + n * 8 + 2 * c + (e & 1)] *
                        l[e >> 1];
            }
          }
          chunk_pv<DH>(s[2 * kc], s[2 * kc + 1], vt + kc * 16 * ld, o);
        }
      }
    }
    __syncthreads();  // the slot is consumed before visit t + 2 refills it
  }
  cp_async_wait<0>();
  if (active) store_frag_rows<DH, kPad>(o, out, row0, q0 + warp * 16, S, E, col, dh);
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

// -- K6 in bf16 with S <= 384: the projection on the tensor cores, then K1's rows route --
//
// One block of 8 warps per (head, batch row), as K1's rows route.  Phase 1
// computes [s16, 3 Dh] = x_b . W_h^T (W_h: the head's Dh rows of each of
// Wq s, Wk, Wv) by mma.sync m16n8k16, bf16 in and fp32 sums, in rounds of
// proj_rows rows of x: warp w takes the m-tile w % (8 / split) and the
// column part w / (8 / split) (split = Dh / 32, so a warp holds 12 n-tiles,
// 48 sums).  x's rows and W_h's 3 Dh rows stream along E in depth tiles of
// 32 by 16-byte cp.async through a ring of 3 stages, two in flight behind
// the one in use; rows of x past S are zeros.  At the end of a round the
// sums round once to bf16: K_h and V_h into shared memory (rows past S
// zero, as K1 loads them), Q_h into the head's own columns of the output,
// which only this block writes.  Phase 2 is rows_attention with the head's
// keep weights, streaming the query tiles from there as K1 streams them
// from q (a tile's rows are read before its output overwrites them); the
// 27 KB a resident Q_h would take at S=330 go to the ring instead, and the
// block stays at two a SM.  The ring shares its space with phase 2's
// scratch (o_x, red_m, red_l), which only phase 2 uses.
constexpr int kProjK = 32;                            // depth of a staging tile along E
constexpr int kProjLd = kProjK + 8;                   // 80 bytes: an odd number of 16-byte units
constexpr int kProjStages = 3;
constexpr int kProjWarpRows = 16;
template <int DH>
__host__ __device__ constexpr int proj_split() { return DH / 32; }  // column parts
template <int DH>
__host__ __device__ constexpr int proj_rows() { return kProjWarpRows * (kRowsThreads / 32) / proj_split<DH>(); }

template <int DH>
__host__ __device__ constexpr size_t k6_rows_scratch() {
  const size_t ring = static_cast<size_t>(kProjStages) * (proj_rows<DH>() + 3 * DH) * kProjLd * 2;
  const size_t phase2 = (static_cast<size_t>(kRowGroups) * kKeySplit * 16 * ox_ld<DH>() +
                         2 * kRowGroups * kKeySplit * 16) * sizeof(float);
  return ring > phase2 ? ring : phase2;
}

// K_h, V_h [s16][mma_ld], the query tiles [kRowsQ][mma_ld], the scratch,
// then w_s [s16]: 111.3 KB at S=330, Dh=32, two blocks a SM.
template <int DH>
size_t k6_rows_smem(int S) {
  const size_t s16 = round16(S);
  return (2 * s16 + kRowsQ) * mma_ld<DH>() * sizeof(__nv_bfloat16) + k6_rows_scratch<DH>() +
         s16 * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kRowsThreads, 2) encoder_self_attention_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wqkv,
    const float* __restrict__ key_bias, int bias_head_stride, __nv_bfloat16* out, int S, int E,
    int H) {
  constexpr int ld = mma_ld<DH>();
  constexpr int kRows = proj_rows<DH>();
  constexpr int kMTiles = kRows / 16;                  // m-tiles a round
  constexpr int kWarpN = 3 * DH / 8 / proj_split<DH>();  // n-tiles a warp: 12
  constexpr int kStage = (kRows + 3 * DH) * kProjLd;   // elements of a ring stage
  const int s16 = round16(S);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [s16][ld]
  __nv_bfloat16* v_s = k_s + static_cast<size_t>(s16) * ld;      // [s16][ld]
  __nv_bfloat16* q_s = v_s + static_cast<size_t>(s16) * ld;      // [2 groups][2][16][ld]
  unsigned char* scratch = reinterpret_cast<unsigned char*>(q_s + kRowsQ * ld);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(scratch);  // phase 1: [3][kRows + 3 Dh][kProjLd]
  float* o_x = reinterpret_cast<float*>(scratch);                   // phase 2: [2][4][16][ox_ld]
  float* red_m = o_x + kRowGroups * kKeySplit * 16 * ox_ld<DH>();   // [2][4][16]
  float* red_l = red_m + kRowGroups * kKeySplit * 16;               // [2][4][16]
  float* w_s = reinterpret_cast<float*>(scratch + k6_rows_scratch<DH>());  // [s16]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int col = h * DH;

  // phase 1: step i is depth tile i % ktiles of round i / ktiles, in ring slot i % 3
  const int ktiles = E / kProjK, steps = (s16 + kRows - 1) / kRows * ktiles;
  auto issue = [&](int i) {
    if (i < steps) {
      const int r0 = i / ktiles * kRows, e0 = i % ktiles * kProjK;
      const int xrows = min(kRows, s16 - r0);
      __nv_bfloat16* xs = ring + (i % kProjStages) * kStage;
      __nv_bfloat16* ws = xs + kRows * kProjLd;
      constexpr int kChunks = kProjK / 8;  // 16-byte chunks of a tile row
      for (int j = tid; j < (xrows + 3 * DH) * kChunks; j += kRowsThreads) {
        const int r = j / kChunks, ch = j % kChunks;
        if (r < xrows) {
          const bool valid = r0 + r < S;
          cp_async16(xs + r * kProjLd + ch * 8,
                     x + (row0 + (valid ? r0 + r : 0)) * E + e0 + ch * 8, valid);
        } else {
          const int n = r - xrows, part = n / DH;  // W_h's row n: row part * E + col + n % DH of wqkv
          cp_async16(ws + n * kProjLd + ch * 8,
                     wqkv + static_cast<size_t>(part * E + col + n - part * DH) * E + e0 + ch * 8, true);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count of the wait below
  };
  for (int i = 0; i < kProjStages - 1; ++i) issue(i);
  const int mt = warp % kMTiles, np = warp / kMTiles;  // this warp's m-tile and column part
  float acc[kWarpN][4];
  for (int i = 0; i < steps; ++i) {
    const int r0 = i / ktiles * kRows, kt = i % ktiles;
    if (kt == 0) {
#pragma unroll
      for (int n = 0; n < kWarpN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    cp_async_wait<kProjStages - 2>();
    __syncthreads();  // step i's tiles landed for all; step i - 1's slot is consumed
    issue(i + kProjStages - 1);
    const bool active = r0 + mt * 16 < s16;
    if (active) {
      const __nv_bfloat16* xs = ring + (i % kProjStages) * kStage;
      const __nv_bfloat16* ws = xs + kRows * kProjLd + np * kWarpN * 8 * kProjLd;
#pragma unroll
      for (int kk = 0; kk < kProjK / 16; ++kk) {
        // A: rows 0-7 | k 0-7, rows 8-15 | k 0-7, rows 0-7 | k 8-15, rows 8-15 | k 8-15
        uint32_t a[4];
        ldmatrix_x4(a, xs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kProjLd + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < kWarpN; n += 2) {
          // B from W_h's rows (n-major, as K in chunk_scores): cols 0-7 | k 0-7,
          // cols 0-7 | k 8-15, cols 8-15 | k 0-7, cols 8-15 | k 8-15
          uint32_t bw[4];
          ldmatrix_x4(bw, ws + (n * 8 + (lane & 7) + (lane >> 4) * 8) * kProjLd + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(acc[n], a[0], a[1], a[2], a[3], bw[0], bw[1]);
          mma_bf16(acc[n + 1], a[0], a[1], a[2], a[3], bw[2], bw[3]);
        }
      }
    }
    if (kt == ktiles - 1 && active) {
      // the round's sums, rounded once to bf16: K_h | V_h into shared memory,
      // Q_h's rows below S into the head's columns of the output
#pragma unroll
      for (int n = 0; n < kWarpN; ++n) {
        const int cc = (np * kWarpN + n) * 8 + 2 * c, part = cc / DH, d = cc - part * DH;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + mt * 16 + g + 8 * r;
          const uint32_t val = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
          if (part != 0) {
            *reinterpret_cast<uint32_t*>((part == 1 ? k_s : v_s) + row * ld + d) = val;
          } else if (row < S) {
            *reinterpret_cast<uint32_t*>(out + (row0 + row) * E + col + d) = val;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // phase 2; the keep weights' barrier also publishes K_h, V_h and Q_h and frees the ring
  const float* bias = key_bias == nullptr
                          ? nullptr
                          : key_bias + static_cast<size_t>(b) * (bias_head_stride ? H : 1) * S +
                                static_cast<size_t>(h) * bias_head_stride;
  const bool dead = mma_keep_weights(bias, S, s16, w_s);
  rows_attention<DH>(out, q_s, k_s, v_s, w_s, dead, o_x, red_m, red_l, out, row0, S, E, col);
}

template <typename T, int DH, bool kPad = false>
int launch_k1(const void* q, const void* k, const void* v, const float* key_bias, void* out,
              int B, int S, int E, int nhead, cudaStream_t stream) {
  auto kernel = encoder_attention_kernel<T, DH, kPad>;
  const size_t smem = k1_smem<T, DH>(S);
  if (int err = allow_smem_once<encoder_attention_kernel<T, DH, kPad>>(smem)) return err;
  const dim3 grid((S + kQT - 1) / kQT, nhead, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), key_bias,
                                           static_cast<T*>(out), S, E);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool kPad = false>
int launch_k1_mma(const void* q, const void* k, const void* v, const float* key_bias, void* out,
                  int B, int S, int E, int nhead, cudaStream_t stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (S <= kRowsMaxS) {
    const size_t smem = k1_rows_smem<DH>(S);
    if (int err = allow_smem_once<encoder_attention_rows_kernel<DH, kPad>>(smem)) return err;
    encoder_attention_rows_kernel<DH, kPad>
        <<<dim3(nhead, B), kRowsThreads, smem, stream>>>(qb, kb, vb, key_bias, ob, S, E);
  } else {
    const size_t smem = k1_rec_smem<DH>(S);
    if (int err = allow_smem_once<encoder_attention_rec_kernel<DH, kPad>>(smem)) return err;
    encoder_attention_rec_kernel<DH, kPad><<<dim3((S + kRecQ - 1) / kRecQ, nhead, B), kRecThreads,
                                             smem, stream>>>(qb, kb, vb, key_bias, ob, S, E);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6's route: bf16 with S <= 384 on the tensor cores; fp32, and bf16 past
// 384, on the CUDA cores
template <typename T>
bool k6_rows_route(int S) {
  return std::is_same<T, __nv_bfloat16>::value && S <= kRowsMaxS;
}

// Shared memory of one K6 block on the route launch_k6 takes
template <typename T, int DH>
size_t k6_route_smem(int S) {
  return k6_rows_route<T>(S) ? k6_rows_smem<DH>(S) : k6_smem<T, DH>(S);
}

template <typename T, int DH>
int launch_k6(const void* x, const void* wqkv, const float* key_bias, int bias_head_stride,
              void* out, int B, int S, int E, int nhead, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (k6_rows_route<T>(S)) {
      const size_t smem = k6_rows_smem<DH>(S);
      if (int err = allow_smem_once<encoder_self_attention_rows_kernel<DH>>(smem)) return err;
      encoder_self_attention_rows_kernel<DH><<<dim3(nhead, B), kRowsThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(wqkv), key_bias, bias_head_stride,
          static_cast<T*>(out), S, E, nhead);
      return static_cast<int>(cudaGetLastError());
    }
  }
  auto kernel = encoder_self_attention_kernel<T, DH>;
  const size_t smem = k6_smem<T, DH>(S);
  if (int err = allow_smem_once<encoder_self_attention_kernel<T, DH>>(smem)) return err;
  kernel<<<dim3(nhead, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), key_bias, bias_head_stride,
      static_cast<T*>(out), S, E, nhead);
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the CUDA cores, bf16 on the tensor cores; a head width dh below
// 64 other than 32 runs padded with zero columns to the next of 32 and 64
template <typename T>
int dispatch_k1(const void* q, const void* k, const void* v, const float* key_bias, void* out,
                int B, int S, int E, int nhead, cudaStream_t st) {
  if (nhead < 1 || E % nhead) return static_cast<int>(cudaErrorInvalidValue);
  const int dh = E / nhead;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (dh == 32) return launch_k1_mma<32>(q, k, v, key_bias, out, B, S, E, nhead, st);
    if (dh == 64) return launch_k1_mma<64>(q, k, v, key_bias, out, B, S, E, nhead, st);
    if (dh < 32) return launch_k1_mma<32, true>(q, k, v, key_bias, out, B, S, E, nhead, st);
    if (dh < 64) return launch_k1_mma<64, true>(q, k, v, key_bias, out, B, S, E, nhead, st);
  } else {
    if (dh == 32) return launch_k1<T, 32>(q, k, v, key_bias, out, B, S, E, nhead, st);
    if (dh == 64) return launch_k1<T, 64>(q, k, v, key_bias, out, B, S, E, nhead, st);
    if (dh < 32) return launch_k1<T, 32, true>(q, k, v, key_bias, out, B, S, E, nhead, st);
    if (dh < 64) return launch_k1<T, 64, true>(q, k, v, key_bias, out, B, S, E, nhead, st);
  }
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

template <typename T>
int dispatch_k6_smem(int S, int dh) {
  const size_t smem = dh == 32 ? k6_route_smem<T, 32>(S) : dh == 64 ? k6_route_smem<T, 64>(S) : 0;
  return smem == 0 ? -1 : static_cast<int>(smem < INT_MAX ? smem : INT_MAX);
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

// K6: the bytes of shared memory one block takes on the route the launcher
// picks for this dtype code, S and head width, at most INT_MAX (-1: no route).
extern "C" int ralf_encoder_self_attention_smem(int dtype, int S, int dh) {
  if (dtype == ralf::kFloat32) return ralf::dispatch_k6_smem<float>(S, dh);
  if (dtype == ralf::kBFloat16) return ralf::dispatch_k6_smem<__nv_bfloat16>(S, dh);
  return -1;
}
