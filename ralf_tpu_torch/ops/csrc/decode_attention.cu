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
// K2: a cluster of 8 CTAs per batch row, grid (8, B): 1024 CTAs at the main
// shape instead of 128 blocks for 132 SMs.  What held the one-block design
// back was the two reads of the memory (needed because the NORMALISED p is
// rounded, which an online softmax does not know until the last tile), one
// scalar load at a time, and 8 warps a SM with no copy in flight.  Now
// each CTA copies its contiguous slice of ceil(M/8) tokens (85 at M=680:
// 43.5 KB in bf16) into shared memory with 16-byte cp.async, once, and
// everything else happens on that copy:
//   scores   [8, slice]: bf16 on the tensor cores (mma.sync m16n8k16, the 8
//            heads padded to 16 rows, ldmatrix on the slice); fp32 by FMAs
//            (no TF32);
//   softmax  each CTA writes its row max m_r and sum l_r of exp(s - m_r)
//            into every CTA of the cluster through distributed shared memory
//            (map_shared_rank, one cluster.sync()), so each holds the global
//            m and l = sum_r l_r exp(m_r - m); p = T(exp(s - m) / l), as the
//            TPU rounds it;
//   p . mem  the CTA's partial o [8, 256] in fp32 (bf16: mma with
//            ldmatrix.trans on the slice), into its shared memory;
//   reduce   CTA r sums columns 32r..32r+31 of all 8 heads over the 8
//            partials through distributed shared memory and writes them.
// A CTA with no tokens (M < 8 leaves some) gives m = -inf, l = 0 and o = 0.
// A slice larger than its buffer (192 tokens in bf16, 96 in fp32; M > 1536
// and M > 768) streams in chunks and reads all but its last chunk a second
// time for p . mem, mostly from L2.  The kernel is templated on the memory
// type; an int8 instance with per-token scales (K3) would add the scale to
// the scores and to p, as decode_shared_attention_kernel does.
// What holds it back on the card: a slice stays in shared memory until the
// cluster's softmax is known, so at most 62 clusters (four CTAs a SM) are
// resident and B=128 rows run in three waves (62, 62, 4).  Each row then
// waits on a chain of block and cluster barriers (the statistics, the
// partials, the exit), and that chain, more than the copies, sets the time.
// Variants timed on the card and dropped: a persistent kernel whose CTAs
// copy the next row's slice while they work on this one (two buffers, two
// CTAs a SM) was slower, and clusters of 4 (two waves of 64 rows) no faster.
//
// K3, K4 (simple and right first): one block of 256 threads per
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
// rows d = w, w + 8, ... of p . v.  K3, K4, K7, K8: no split of M across
// blocks and no copy in flight behind the compute: the times sit well above
// the bound.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// ---- K2 over a cluster of 8 CTAs per batch row (see the top of the file) ----

constexpr int kCluster = 8;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Tokens of the slice that shared memory holds at once, and the row stride
// in elements: an odd number of 16-byte units, so the 8 rows of an ldmatrix
// matrix (bf16) or of 8 lanes' 16-byte loads (fp32) fall on distinct banks.
template <typename T>
__host__ __device__ constexpr int slice_cap() { return std::is_same<T, float>::value ? 96 : 192; }
template <typename T>
__host__ __device__ constexpr int slice_ld() { return kWidth + 16 / static_cast<int>(sizeof(T)); }

// Shared memory of a CTA: one region that holds the slice mem_s [rows][ld]
// and, once p . mem is done, the partial o [8][256] fp32; then sc
// [8][sc_ld(per)] fp32 and q_s [8][ld] of T.  per = ceil(M / 8) tokens a
// CTA, rows = min(per, cap): 51 KB in bf16 at M=680, four CTAs a SM.
// Row stride of the scores: round16(per) + 8 words, 8 or 24 modulo 32, so
// the float2 reads of a half warp (rows g, columns 2c) fall on distinct banks.
__host__ __device__ constexpr int sc_ld(int per) { return round16(per) + 8; }

template <typename T>
__host__ __device__ size_t slice_region(int per) {
  const size_t slice = static_cast<size_t>(per < slice_cap<T>() ? per : slice_cap<T>()) *
                       slice_ld<T>() * sizeof(T);
  const size_t o_part = kHeads * kWidth * sizeof(float);
  return ((slice > o_part ? slice : o_part) + 15) / 16 * 16;
}

template <typename T>
size_t cluster_smem(int M) {
  const int per = (M + kCluster - 1) / kCluster;
  return slice_region<T>(per) + static_cast<size_t>(kHeads) * sc_ld(per) * sizeof(float) +
         kHeads * slice_ld<T>() * sizeof(T);
}

// bf16 packs four CTAs a SM (64 registers a thread); fp32's slice allows two.
template <typename T>
__host__ __device__ constexpr int cluster_blocks_per_sm() { return std::is_same<T, float>::value ? 2 : 4; }

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, cluster_blocks_per_sm<T>())
    decode_shared_cluster_kernel(const T* __restrict__ q_tilde, const T* __restrict__ mem,
                                 T* __restrict__ out, int M) {
  namespace cg = cooperative_groups;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int ld = slice_ld<T>();
  constexpr int cap = slice_cap<T>();
  constexpr int kVec = 16 / sizeof(T);      // elements of a 16-byte chunk
  constexpr int kChunks = kWidth / kVec;    // 16-byte chunks of a token
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int per = (M + kCluster - 1) / kCluster;
  const int begin = min(M, rank * per), cnt = min(M, begin + per) - begin;  // this CTA's tokens
  const int per_pad = sc_ld(per);  // sc's row stride; entries past cnt are 0
  extern __shared__ __align__(16) unsigned char slice_smem[];
  T* mem_s = reinterpret_cast<T*>(slice_smem);      // [min(per, cap)][ld]
  float* o_part = reinterpret_cast<float*>(slice_smem);  // [8][256], after p . mem
  float* sc = reinterpret_cast<float*>(slice_smem + slice_region<T>(per));  // [8][per_pad]
  T* q_s = reinterpret_cast<T*>(sc + kHeads * per_pad);  // [8][ld]
  __shared__ float red_m[kCluster][kHeads], red_l[kCluster][kHeads];  // [CTA][head]
  const T* src = mem + (static_cast<size_t>(b) * M + begin) * kWidth;

  // tokens j0 .. j0+n of the slice into rows 0 .. n-1 of mem_s
  auto load_chunk = [&](int j0, int n) {
    for (int i = tid; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      cp_async16(mem_s + r * ld + ch * kVec, src + static_cast<size_t>(j0 + r) * kWidth + ch * kVec,
                 true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  };
  const int chunks = (cnt + cap - 1) / cap;

  // pass 1: scores of every token of the slice into sc
  const T* qb = q_tilde + static_cast<size_t>(b) * kHeads * kWidth;
  for (int i = tid; i < kHeads * kWidth; i += kThreads) q_s[i / kWidth * ld + i % kWidth] = qb[i];
  for (int ci = 0; ci < chunks; ++ci) {
    const int j0 = ci * cap, n = min(cap, cnt - j0);
    __syncthreads();  // q_s is written / the previous chunk is consumed
    load_chunk(j0, n);
    __syncthreads();
    if constexpr (kF32) {
      const float4* q4 = reinterpret_cast<const float4*>(q_s + warp * ld);
      for (int j = lane; j < n; j += 32) {
        const float4* m4 = reinterpret_cast<const float4*>(mem_s + j * ld);
        float dot = 0.f;
#pragma unroll 8
        for (int e = 0; e < kWidth / 4; ++e) {
          const float4 a = q4[e], x = m4[e];
          dot = fmaf(a.x, x.x, dot);
          dot = fmaf(a.y, x.y, dot);
          dot = fmaf(a.z, x.z, dot);
          dot = fmaf(a.w, x.w, dot);
        }
        sc[warp * per_pad + j0 + j] = dot;
      }
    } else {
      // A: q_tilde's 8 heads as rows 0-7 (a0, a2), rows 8-15 zero (a1, a3)
      const T* qr = q_s + g * ld + 2 * c;
      for (int nt = warp; nt < (n + 7) / 8; nt += kThreads / 32) {
        float acc[2][4] = {};  // even and odd k-steps: two chains of mma
        // matrices: tokens 0-7 | e 0-7, 8-15, 16-23, 24-31: b0, b1 of two k-steps;
        // rows past n repeat row n - 1 (their scores are dropped)
        const T* row = mem_s + min(nt * 8 + (lane & 7), n - 1) * ld + (lane >> 3) * 8;
#pragma unroll
        for (int ks = 0; ks < kWidth / 16; ks += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, row + ks * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const T* qk = qr + (ks + i) * 16;
            mma_bf16(acc[i], *reinterpret_cast<const uint32_t*>(qk), 0u,
                     *reinterpret_cast<const uint32_t*>(qk + 8), 0u, bk[2 * i], bk[2 * i + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * c + e;
          if (j < n) sc[g * per_pad + j0 + j] = acc[0][e] + acc[1][e];  // row g is head g
        }
      }
    }
  }
  __syncthreads();

  // softmax over the cluster; warp h takes head h.  Each CTA writes its max
  // and sum of exp(s - max) into every CTA's shared memory, then reads all 8
  // from its own: m = max_r m_r, l = sum_r l_r exp(m_r - m) (a CTA with no
  // token gives m_r = -inf, l_r = 0: exp gives 0)
  float* row = sc + warp * per_pad;
  float mx = -INFINITY;
  for (int j = lane; j < cnt; j += 32) mx = fmaxf(mx, row[j]);
  mx = warp_max(mx);
  float l = 0.f;
  for (int j = lane; j < cnt; j += 32) l += expf(row[j] - mx);
  l = warp_sum(l);
  if (lane < kCluster) {
    *cluster.map_shared_rank(&red_m[rank][warp], lane) = mx;
    *cluster.map_shared_rank(&red_l[rank][warp], lane) = l;
  }
  cluster.sync();
  const float m_r = lane < kCluster ? red_m[lane][warp] : -INFINITY;
  const float l_r = lane < kCluster ? red_l[lane][warp] : 0.f;
  const float m_all = warp_max(m_r);
  const float l_all = warp_sum(m_r == -INFINITY ? 0.f : l_r * expf(m_r - m_all));
  for (int j = lane; j < per_pad; j += 32) {
    row[j] = j < cnt ? round_to<T>(expf(row[j] - m_all) / l_all) : 0.f;
  }
  __syncthreads();

  // pass 2: the partial o = p . slice, last chunk first (it is still in place)
  if constexpr (kF32) {
    float acc[kHeads] = {};
    for (int ci = chunks - 1; ci >= 0; --ci) {
      const int j0 = ci * cap, n = min(cap, cnt - j0);
      if (ci != chunks - 1) {
        __syncthreads();
        load_chunk(j0, n);
        __syncthreads();
      }
      for (int j = 0; j < n; ++j) {
        const float x = mem_s[j * ld + tid];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) acc[h] = fmaf(sc[h * per_pad + j0 + j], x, acc[h]);
      }
    }
    __syncthreads();  // every thread is done with mem_s, which o_part overwrites
#pragma unroll
    for (int h = 0; h < kHeads; ++h) o_part[h * kWidth + tid] = acc[h];
  } else {
    float acc[4][4] = {};  // n-tiles of columns 32w .. 32w+31
    for (int ci = chunks - 1; ci >= 0; --ci) {
      const int j0 = ci * cap, n = min(cap, cnt - j0);
      if (ci != chunks - 1) {
        __syncthreads();
        load_chunk(j0, n);
        __syncthreads();
      }
      for (int kk = 0; kk < (n + 15) / 16; ++kk) {
        const float* p = sc + g * per_pad + j0 + kk * 16 + 2 * c;  // zeros past cnt
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8);
        const uint32_t a0 = pack_bf16(lo.x, lo.y), a2 = pack_bf16(hi.x, hi.y);
        // matrices: tokens 0-7 | e 0-7, tokens 8-15 | e 0-7, tokens 0-7 | e 8-15,
        // tokens 8-15 | e 8-15; rows past n repeat row n - 1 (their p is 0)
        const T* mr = mem_s + min(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, n - 1) * ld +
                      warp * 32 + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, mr + dp * 16);
          mma_bf16(acc[2 * dp], a0, 0u, a2, 0u, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], a0, 0u, a2, 0u, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with mem_s, which o_part overwrites
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float* dst = o_part + g * kWidth + warp * 32 + n * 8 + 2 * c;
      dst[0] = acc[n][0];
      dst[1] = acc[n][1];
    }
  }
  cluster.sync();

  // CTA r: columns 32r .. 32r+31 of every head, summed over the 8 partials
  const int hh = tid / 32, cc = rank * 32 + lane;
  float part[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) part[r] = *cluster.map_shared_rank(o_part + hh * kWidth + cc, r);
  // no CTA leaves while another still reads its shared memory: arrive once
  // the reads are done, wait after the store
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) sum += part[r];
  out[(static_cast<size_t>(b) * kHeads + hh) * kWidth + cc] = from_f32<T>(sum);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// allow_smem once per device and size: the attribute calls would otherwise
// cost microseconds of host time on every launch.
template <auto kKernel>
int allow_smem_once(size_t smem) {
  static size_t allowed[64] = {};  // per device, the largest size allowed so far
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (dev < 64 && smem <= allowed[dev]) return 0;
  if (int err = allow_smem(kKernel, smem)) return err;
  if (dev < 64) allowed[dev] = smem;
  return 0;
}

template <typename T>
int launch_shared_cluster(const void* q_tilde, const void* mem, void* out, int B, int M,
                          cudaStream_t stream) {
  auto kernel = decode_shared_cluster_kernel<T>;
  const size_t smem = cluster_smem<T>(M);
  if (int err = allow_smem_once<decode_shared_cluster_kernel<T>>(smem)) return err;
  kernel<<<dim3(kCluster, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q_tilde), static_cast<const T*>(mem), static_cast<T*>(out), M);
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
  if (dtype == ralf::kFloat32) return ralf::launch_shared_cluster<float>(q_tilde, mem, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_shared_cluster<__nv_bfloat16>(q_tilde, mem, out, B, M, st);
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
