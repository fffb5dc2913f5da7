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
// K3 with both contractions int8 x int8 -> int32.  The kernel quantises the
// query per head, as quantize_q_tilde (qs = max(amax, 1e-8) / 127, qi =
// clip(rint(q / qs), -127, 127)), and p * s per row:
//
//   sc = int(qi . mem_i8[m]) * qs * s[m];  p2 = softmax(sc) * s
//   ps = max(max_m p2, 1e-30);  pi = clip(round(p2 * (127 / ps)), -127, 127)
//   o  = int(pi . mem_i8) * (ps / 127)
//
// T(x) is x rounded to the working type (bf16 or fp32), as the TPU kernels
// round p before their second dot; every sum is fp32 (int32 in K4).  The TPU
// kernels take s (and K4's qs) broadcast to [B, H, M] (and [B, H, 128]) for
// their tiling, and K4 repeats the 8 heads 4x to fill an int8 tile of 32
// rows, an artifact of that tile; these read s as [B, M], pad the 8 heads
// with zero rows to the 16 of an mma tile, and compute the 8 real heads.
//
// Over PER-LAYER cross K/V caches in the [B, H, Dh, M] decode layout:
//
// K7 replaces fused_decode_attention (_kernel): o[b, h] = sum_m p[m] v[:, m]
// with p = softmax_m(scale * q[b, h] . k[:, m]), scale = Dh^-1/2, p in fp32.
// K8 replaces fused_decode_attention_q8: the same on int8 K/V with the
// per-(b, h) scales folded in, in the TPU wrapper's order: q' = (float(q) *
// Dh^-1/2) * k_scale, o = softmax(q' . k_i8) . v_i8 in fp32, out = T(o *
// v_scale).  K7 and K8 keep p in fp32 and never round it.
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
// time for p . mem, mostly from L2.
// What holds it back on the card: a slice stays in shared memory until the
// cluster's softmax is known, so at most 62 clusters (four CTAs a SM) are
// resident and B=128 rows run in three waves (62, 62, 4).  Each row then
// waits on a chain of block and cluster barriers (the statistics, the
// partials, the exit), and that chain, more than the copies, sets the time.
// Variants timed on the card and dropped: a persistent kernel whose CTAs
// copy the next row's slice while they work on this one (two buffers, two
// CTAs a SM) was slower, and clusters of 4 (two waves of 64 rows) no faster.
//
// K3 and K4: K2's cluster over the int8 memory, one kernel templated on
// kMxu.  Each CTA copies its slice (85 tokens at M=680: 21.8 KB of int8,
// rows padded to 272 bytes so that ldmatrix and 16-byte loads meet no bank
// conflict) once with 16-byte cp.async, and its scales s with 4-byte loads
// (the [B, M] fp32 scales are not 16-byte aligned at odd M).  At M <= 4096
// a slice is at most 512 tokens, 139 KB, so it always fits whole: no
// streamed chunks.  The scores and p . mem are built straight from the
// int8 bytes in shared memory (no bf16 copy of the slice), which keeps a
// CTA at 30-36 KB at M=680:
//   K3 bf16  scores by mma m16n8k16: ldmatrix on the int8 rows hands thread
//            (g, c) bytes 4c..4c+3 of token g, widened exactly to bf16 as b0
//            and b1 (an int8 is exact in bf16, as the TPU's astype); the
//            query's A fragment takes the same 4 positions of E.  p . mem by
//            mma with ldmatrix.trans on pairs of int8 columns: thread (g, c)
//            gets tokens 2c, 2c+1 at columns 2g and 2g+1 (bytes 0, 2 and 1,
//            3), one n-tile of even and one of odd columns;
//   K3 fp32  FMAs (no TF32), as K2's fp32 path;
//   K4       the CTA quantises its row's query itself (warp h, head h; the
//            IEEE division and rint of quantize_q_tilde, so qi and qs are
//            bit for bit the wrapper's old ones) and one call is one launch.
//            Scores by mma m16n8k32 s8, the slice's rows as they are the
//            K-major B operand (non-transposed ldmatrix); sc = float(dot) *
//            qs * s.  A second exchange through distributed shared memory
//            gives ps from each CTA's max |p2|.  p . mem by m16n8k32 s8 too:
//            sm_90 has no 8-bit ldmatrix.trans, but the 16-bit one on pairs
//            of int8 columns, with __byte_perm, hands thread (g, c) tokens
//            2c, 2c+1, 8+2c, 9+2c of column 2g or 2g+1, which is a B
//            fragment whose k order the A fragment of pi (two 16-bit loads)
//            follows; so no transposed copy of the slice and no __dp4a.
//            The int32 partials are summed exactly, then times ps / 127.
// p * s is rounded (K4: quantised) only after the cluster's m and l are
// known, as the TPU kernels do; expf, not ex2.approx, whose ulps would flip
// roundings.  CTAs with no token give m = -inf, l = 0, max |p2| = 0 and zero
// partials.  The same bound as K2 holds: 8 CTAs of 256 threads at 64
// registers, four a SM by registers, and the same chain of cluster barriers
// (K4: one more).
//
// K7: one block per (b, h) over a [Dh, M] cache pair, M contiguous:
// threads stride M for the scores (coalesced along M), a block-wide softmax,
// then warp w sums rows d = w, w + 8, ... of p . v.  No split of M across
// blocks and no copy in flight behind the compute: the time sits well above
// the bound.
//
// K8 (decode_attention_q8_kernel): one block of 4 warps per (b, h); the
// warps split M into contiguous slices, and in a slice each lane owns 8
// tokens of a step: 8 consecutive ones, read as one 8-byte vector per cache
// row d, where M and both caches' starts are multiples of 8 (the caches
// quantize_kv makes at M=680), else the tokens l, l + 32, ... of the step,
// read as bytes that the warp loads 32 consecutive at a time; so a warp
// reads every byte of its K and V rows once, neighbouring lanes on
// neighbouring bytes.  At M=680 85 lanes of a block's 128 carry tokens.
// Each warp keeps an online softmax over its
// slice (running max, rescaled sum; the scores and p stay in registers, p in
// fp32 as the TPU kernel keeps it, and V is read in the same pass as K).
// p . v: each lane sums its 8 tokens for 8 rows of V at a time (8 loads
// in flight), and one transpose reduction across the warp (9 shuffles)
// leaves each row's sum in 4 lanes.  The only block barrier is the merge of the 4 warps' (m, l, o)
// in warp order.  int8 widens exactly to fp32 by a byte permute into 2^23 + x
// + 128 and one subtraction (no I2F).  No cast, multiply or copy is left to
// the wrapper: one call is one launch.  What bounds it: it moves 2*B*H*Dh*M
// bytes (44.6 MB at B=128, H=8, Dh=32, M=680: 13.3 us at 3.35 TB/s) against
// 4*B*H*Dh*M = 89 MFLOP: bytes.  1024 blocks keep about eight a SM.
//
// Every launcher sets its shared-memory attribute once per device and size
// (allow_smem_once).

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace ralf {
namespace {

constexpr int kHeads = 8;
constexpr int kWidth = 256;   // E = d_model
constexpr int kThreads = 256;

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

// ---- K3 and K4 over a cluster of 8 CTAs per batch row (see the top of the file) ----

constexpr int kRowI8 = kWidth + 16;  // bytes a token row of the int8 slice takes in shared memory
constexpr int kQLd = kWidth + 16;    // elements a query row takes in shared memory

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }
// row strides: scores (floats; 8 modulo 32 words, as K2's) and K4's pi (bytes)
__host__ __device__ constexpr int q8_sc_ld(int per) { return round32(per) + 8; }
__host__ __device__ constexpr int q8_pi_ld(int per) { return round32(per) + 16; }

// Byte offsets of a CTA's dynamic shared memory for slices of `per` tokens:
// the slice [per][kRowI8] int8 (later the partial o [8][256] fp32 or int32),
// the scores sc [8][q8_sc_ld], the scales s [round32(per)], the query [8][kQLd]
// (K3: q_tilde in T; K4: its int8 quantisation) and K4's pi [8][q8_pi_ld].
struct Q8Smem {
  size_t sc, scale, q, pi, total;
};

template <typename T, bool kMxu>
__host__ __device__ Q8Smem q8_smem(int per) {
  const size_t slice = static_cast<size_t>(per) * kRowI8, o_part = kHeads * kWidth * 4;
  Q8Smem s;
  s.sc = ((slice > o_part ? slice : o_part) + 15) / 16 * 16;
  s.scale = s.sc + static_cast<size_t>(kHeads) * q8_sc_ld(per) * sizeof(float);
  s.q = s.scale + static_cast<size_t>(round32(per)) * sizeof(float);
  s.pi = s.q + static_cast<size_t>(kHeads) * kQLd * (kMxu ? 1 : sizeof(T));
  s.total = s.pi + (kMxu ? static_cast<size_t>(kHeads) * q8_pi_ld(per) : 0);
  return s;
}

// byte i of w, an int8, as a float
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

// K3 (kMxu false) and K4 (kMxu true); see the top of the file.
template <typename T, bool kMxu>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
    decode_shared_q8_cluster_kernel(const T* __restrict__ q_tilde, const int8_t* __restrict__ mem,
                                    const float* __restrict__ mem_scale, T* __restrict__ out,
                                    int M) {
  namespace cg = cooperative_groups;
  constexpr bool kF32 = std::is_same<T, float>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int per = (M + kCluster - 1) / kCluster;
  const int begin = min(M, rank * per), cnt = min(M, begin + per) - begin;  // this CTA's tokens
  const int sc_ld = q8_sc_ld(per), pad = round32(per);
  const Q8Smem lay = q8_smem<T, kMxu>(per);
  extern __shared__ __align__(16) unsigned char q8_smem_buf[];
  int8_t* mem_s = reinterpret_cast<int8_t*>(q8_smem_buf);
  float* sc = reinterpret_cast<float*>(q8_smem_buf + lay.sc);
  float* scale_s = reinterpret_cast<float*>(q8_smem_buf + lay.scale);
  T* q_s = reinterpret_cast<T*>(q8_smem_buf + lay.q);
  int8_t* qi_s = reinterpret_cast<int8_t*>(q8_smem_buf + lay.q);
  int8_t* pi_s = reinterpret_cast<int8_t*>(q8_smem_buf + lay.pi);
  __shared__ float red_m[kCluster][kHeads], red_l[kCluster][kHeads], red_p[kCluster][kHeads];
  __shared__ float qs_s[kHeads], ps_s[kHeads];

  // this CTA has started; before the first write into another CTA's shared
  // memory, each waits until all 8 have
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the slice, once, with 16-byte cp.async; in flight while the query and the
  // scales load
  const int8_t* src = mem + (static_cast<size_t>(b) * M + begin) * kWidth;
  for (int i = tid; i < cnt * (kWidth / 16); i += kThreads) {
    const int r = i / (kWidth / 16), ch = i % (kWidth / 16);
    cp_async16(mem_s + r * kRowI8 + ch * 16, src + r * kWidth + ch * 16, true);
  }
  cp_async_commit();
  const float* sb = mem_scale + static_cast<size_t>(b) * M + begin;  // 4-byte loads: any M
  for (int j = tid; j < pad; j += kThreads) scale_s[j] = j < cnt ? sb[j] : 0.f;
  const T* qb = q_tilde + static_cast<size_t>(b) * kHeads * kWidth;
  if constexpr (kMxu) {
    // warp h quantises head h exactly as quantize_q_tilde: qs = max(amax, 1e-8) / 127,
    // qi = clip(rint(x / qs), -127, 127), IEEE division, rint half to even
    float x[8];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = to_f32(qb[warp * kWidth + lane * 8 + i]);
      amax = fmaxf(amax, fabsf(x[i]));
    }
    const float qs = fmaxf(warp_max(amax), 1e-8f) / 127.0f;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = static_cast<int>(fminf(fmaxf(rintf(x[i] / qs), -127.f), 127.f));
      w[i >> 2] |= (static_cast<uint32_t>(v) & 0xffu) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qi_s + warp * kQLd + lane * 8) = make_uint2(w[0], w[1]);
    if (lane == 0) qs_s[warp] = qs;
  } else {
    for (int i = tid; i < kHeads * kWidth; i += kThreads) q_s[i / kWidth * kQLd + i % kWidth] = qb[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  // scores of the slice's tokens into sc: K3 (q . mem_i8) * s, K4 float(qi . mem_i8) * qs * s
  if constexpr (kF32 && !kMxu) {
    const float4* q4 = reinterpret_cast<const float4*>(q_s + warp * kQLd);  // head = warp
    for (int j = lane; j < cnt; j += 32) {
      const int4* m16 = reinterpret_cast<const int4*>(mem_s + j * kRowI8);
      float dot = 0.f;
#pragma unroll 4
      for (int ch = 0; ch < kWidth / 16; ++ch) {
        const int4 v = m16[ch];
        const uint32_t words[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                                   static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 a = q4[ch * 4 + k];
          dot = fmaf(a.x, i8_at(words[k], 0), dot);
          dot = fmaf(a.y, i8_at(words[k], 1), dot);
          dot = fmaf(a.z, i8_at(words[k], 2), dot);
          dot = fmaf(a.w, i8_at(words[k], 3), dot);
        }
      }
      sc[warp * sc_ld + j] = dot * scale_s[j];
    }
  } else {
    // tensor cores, warp by tiles of 8 tokens; A is the query, heads 0-7 as
    // rows 0-7 (rows 8-15 zero); B comes from ldmatrix on the int8 rows:
    // lane l gives token nt*8 + l%8 (rows past cnt repeat the last; their
    // scores are dropped) and 16-byte chunk l/8 of a 64-byte group, so
    // register i holds bytes 4c .. 4c+3 of chunk i of token g
    for (int nt = warp; nt < (cnt + 7) / 8; nt += kThreads / 32) {
      const int8_t* row = mem_s + min(nt * 8 + (lane & 7), cnt - 1) * kRowI8 + (lane >> 3) * 16;
      float dot[2];
      if constexpr (kMxu) {
        // m16n8k32 s8: chunks 2i and 2i+1 are b0 and b1 of one k-step as they come;
        // a0 and a2 are bytes 4c and 16 + 4c of the step's 32 in row g of qi
        int acc[2][4] = {};
        const int8_t* qr = qi_s + g * kQLd + 4 * c;
#pragma unroll
        for (int grp = 0; grp < kWidth / 64; ++grp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, row + grp * 64);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int8_t* qk = qr + grp * 64 + i * 32;
            mma_s8(acc[i], *reinterpret_cast<const uint32_t*>(qk), 0u,
                   *reinterpret_cast<const uint32_t*>(qk + 16), 0u, bk[2 * i], bk[2 * i + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) dot[e] = static_cast<float>(acc[0][e] + acc[1][e]) * qs_s[g];
      } else {
        // m16n8k16 bf16, one k-step per chunk, its 16 positions of E taken in
        // the order the chunk's bytes arrive: thread c holds E 4c .. 4c+3 of
        // token g, as b0 = (4c, 4c+1) and b1 = (4c+2, 4c+3) widened exactly to
        // bf16, so A takes a0 = q[g][4c, 4c+1] and a2 = q[g][4c+2, 4c+3]
        float acc[2][4] = {};
        const T* qr = q_s + g * kQLd + 4 * c;
#pragma unroll
        for (int grp = 0; grp < kWidth / 64; ++grp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, row + grp * 64);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint2 a = *reinterpret_cast<const uint2*>(qr + grp * 64 + i * 16);
            mma_bf16(acc[i & 1], a.x, 0u, a.y, 0u, pack_bf16(i8_at(bk[i], 0), i8_at(bk[i], 1)),
                     pack_bf16(i8_at(bk[i], 2), i8_at(bk[i], 3)));
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) dot[e] = acc[0][e] + acc[1][e];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * c + e;
        if (j < cnt) sc[g * sc_ld + j] = dot[e] * scale_s[j];  // row g is head g
      }
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started

  // softmax over the cluster, warp h on head h, as K2: each CTA writes its
  // max and sum into every CTA's shared memory, m = max_r m_r and
  // l = sum_r l_r exp(m_r - m); a CTA with no token gives m_r = -inf, l_r = 0
  float* row = sc + warp * sc_ld;
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
  if constexpr (kMxu) {
    // p2 = (exp(sc - m) / l) * s; its row max crosses the cluster the same
    // way; pi = clip(rint(p2 * (127 / ps)), -127, 127), 0 past cnt
    float pmax = 0.f;
    for (int j = lane; j < cnt; j += 32) {
      const float p2 = expf(row[j] - m_all) / l_all * scale_s[j];
      row[j] = p2;
      pmax = fmaxf(pmax, fabsf(p2));
    }
    pmax = warp_max(pmax);
    if (lane < kCluster) *cluster.map_shared_rank(&red_p[rank][warp], lane) = pmax;
    cluster.sync();
    const float ps = fmaxf(warp_max(lane < kCluster ? red_p[lane][warp] : 0.f), 1e-30f);
    const float inv = 127.0f / ps;
    int8_t* pr = pi_s + warp * q8_pi_ld(per);
    for (int j = lane; j < pad; j += 32) {
      pr[j] = j < cnt ? static_cast<int8_t>(fminf(fmaxf(rintf(row[j] * inv), -127.f), 127.f)) : 0;
    }
    if (lane == 0) ps_s[warp] = ps;
  } else {
    // p = T((exp(sc - m) / l) * s), the TPU kernel's rounding; 0 past cnt
    for (int j = lane; j < sc_ld; j += 32) {
      row[j] = j < cnt ? round_to<T>(expf(row[j] - m_all) / l_all * scale_s[j]) : 0.f;
    }
  }
  __syncthreads();

  // the partial o = p . slice into o_part [8][256] over the slice's buffer
  float* o_part = reinterpret_cast<float*>(q8_smem_buf);
  int* oi_part = reinterpret_cast<int*>(q8_smem_buf);
  if constexpr (kF32 && !kMxu) {
    float acc[kHeads] = {};
    for (int j = 0; j < cnt; ++j) {
      const float x = static_cast<float>(mem_s[j * kRowI8 + tid]);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) acc[h] = fmaf(sc[h * sc_ld + j], x, acc[h]);
    }
    __syncthreads();  // every thread is done with mem_s, which o_part overwrites
#pragma unroll
    for (int h = 0; h < kHeads; ++h) o_part[h * kWidth + tid] = acc[h];
  } else {
    // warp w: columns 32w .. 32w+31 as 4 n-tiles; ldmatrix.trans on pairs of
    // int8 columns gives thread (g, c) tokens 2c, 2c+1 at columns 2g and
    // 2g+1 of a matrix (bytes 0, 2 and 1, 3 of the word), so n-tile
    // t = 2 half + par holds columns 32w + 16 half + 2n + par
    float accf[4][4] = {};
    int acci[4][4] = {};
    if constexpr (kMxu) {
      // m16n8k32 s8 by k-steps of 32 tokens: B's k 4c .. 4c+3 are tokens 2c,
      // 2c+1, 8+2c, 9+2c (and 16 more for b1), as the four matrices of tokens
      // 0-7, 8-15, 16-23, 24-31 hand them out; A's pi follows that order
      const int8_t* pr = pi_s + g * q8_pi_ld(per) + 2 * c;
      for (int k0 = 0; k0 < cnt; k0 += 32) {
        auto pair = [&](int k) { return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(pr + k)); };
        const uint32_t a0 = pair(k0) | pair(k0 + 8) << 16, a2 = pair(k0 + 16) | pair(k0 + 24) << 16;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, mem_s + min(k0 + lane, cnt - 1) * kRowI8 + warp * 32 + half * 16);
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const uint32_t sel = par ? 0x7531u : 0x6420u;
            mma_s8(acci[2 * half + par], a0, 0u, a2, 0u, __byte_perm(bv[0], bv[1], sel),
                   __byte_perm(bv[2], bv[3], sel));
          }
        }
      }
    } else {
      // m16n8k16 bf16 by k-steps of 16 tokens; matrices: tokens 0-7 | 16
      // columns, tokens 8-15 | the same, then the next 16 columns; rows past
      // cnt repeat the last (their p is 0)
      for (int k0 = 0; k0 < cnt; k0 += 16) {
        const float* p = sc + g * sc_ld + k0 + 2 * c;  // zeros past cnt
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8);
        const uint32_t a0 = pack_bf16(lo.x, lo.y), a2 = pack_bf16(hi.x, hi.y);
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, mem_s + min(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, cnt - 1) * kRowI8 +
                                  warp * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const uint32_t w0 = bv[2 * half], w1 = bv[2 * half + 1];
            mma_bf16(accf[2 * half + par], a0, 0u, a2, 0u,
                     pack_bf16(i8_at(w0, par), i8_at(w0, par + 2)),
                     pack_bf16(i8_at(w1, par), i8_at(w1, par + 2)));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with mem_s, which o_part overwrites
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = g * kWidth + warp * 32 + 16 * (t >> 1) + 4 * c + (t & 1);  // n = 2c, then 2c+1
      if constexpr (kMxu) {
        oi_part[e] = acci[t][0];
        oi_part[e + 2] = acci[t][1];
      } else {
        o_part[e] = accf[t][0];
        o_part[e + 2] = accf[t][1];
      }
    }
  }
  cluster.sync();

  // CTA r: columns 32r .. 32r+31 of every head, summed over the 8 partials
  // (K4: exactly, in int32, then times ps / 127 in the TPU kernel's order)
  const int hh = warp, cc = rank * 32 + lane;
  float sum = 0.f;
  if constexpr (kMxu) {
    int part[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) part[r] = *cluster.map_shared_rank(oi_part + hh * kWidth + cc, r);
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    int isum = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) isum += part[r];
    sum = static_cast<float>(isum) * (ps_s[hh] * (1.0f / 127.0f));
  } else {
    float part[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) part[r] = *cluster.map_shared_rank(o_part + hh * kWidth + cc, r);
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < kCluster; ++r) sum += part[r];
  }
  out[(static_cast<size_t>(b) * kHeads + hh) * kWidth + cc] = from_f32<T>(sum);
  // no CTA leaves while another still reads its shared memory
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// ---- K8: int8 per-layer decode attention (see the top of the file) ----

constexpr int kQ8Warps = 4;
constexpr int kQ8Threads = 32 * kQ8Warps;
constexpr int kQ8Rows = 8;                // rows of V a lane's partial sums cover at once
constexpr int kQ8Tok = 8;                 // tokens a lane owns in a step
constexpr int kMaxHeadDim = 256;

// The kQ8Tok tokens a lane owns in one int8 cache row as two words, its
// first token lowest: t .. t+7 read as one 8-byte vector (VECTOR: M % 8 ==
// 0 and the row starts on an 8-byte boundary, so no vector straddles M), or
// tokens t, t+32, t+64, ... read as bytes (rows of any M and alignment), so
// that each byte load of the warp covers 32 consecutive bytes.  Tokens at or
// past M read nothing and give zeros.
template <bool VECTOR>
__device__ __forceinline__ void load_tok(uint32_t (&w)[kQ8Tok / 4], const int8_t* __restrict__ row,
                                         int t, int M) {
  if constexpr (VECTOR) {
    const uint2 x = t < M ? *reinterpret_cast<const uint2*>(row + t) : make_uint2(0u, 0u);
    w[0] = x.x, w[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < kQ8Tok / 4; ++i) {
      w[i] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tok = t + 32 * (4 * i + j);
        if (tok < M) w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(row[tok])) << (8 * j);
      }
    }
  }
}

// Token i of the kQ8Tok a lane owns, from its first token t (see load_tok).
template <bool VECTOR>
__device__ __forceinline__ int tok_at(int t, int i) { return VECTOR ? t + i : t + 32 * i; }

// Byte j of a word whose int8 bytes were biased by w ^ 0x80808080 (x + 128),
// as the float x: the bits 0x4B0000uu are 2^23 + uu, exact.
__device__ __forceinline__ float i8_biased(uint32_t wb, int j) {
  return __int_as_float(static_cast<int>(__byte_perm(wb, 0x4B00u, 0x5440u | j))) - 8388736.0f;
}

// x[i] summed over the 32 lanes of the warp, for i < V (a power of two up
// to 32): lane l returns the sum of x[l / (32 / V)].  While a lane holds
// more than one value, each step keeps half of them (the upper half in the
// lanes with that bit set) and adds its partner's; then plain butterfly
// sums.  log2(32) steps, V - 1 + 5 - log2(V) shuffles, in an order that does
// not depend on the data.
template <int N, int OFF, int V>
__device__ __forceinline__ float transpose_sum_step(float (&x)[V], int lane) {
  if constexpr (N > 1) {
    constexpr int kHalf = N / 2;
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? x[i] : x[i + kHalf];
      x[i] = (upper ? x[i + kHalf] : x[i]) + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
  } else {
    x[0] += __shfl_xor_sync(0xffffffffu, x[0], OFF);
  }
  if constexpr (OFF > 1) {
    return transpose_sum_step<(N > 1 ? N / 2 : 1), OFF / 2, V>(x, lane);
  } else {
    return x[0];
  }
}

template <int V>
__device__ __forceinline__ float warp_transpose_sum(float (&x)[V]) {
  return transpose_sum_step<V, 16, V>(x, threadIdx.x & 31);
}

// q and out [BH, Dh] of T, k_i8 and v_i8 [BH, Dh, M] int8 (VECTOR: rows
// 8-byte aligned), k_scale and v_scale [BH] fp32; scale = Dh^-1/2.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kQ8Threads, 4) decode_attention_q8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_i8, const int8_t* __restrict__ v_i8,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, T* __restrict__ out,
    int Dh, int M, float scale) {
  __shared__ float q_s[kQ8Warps][kMaxHeadDim];  // each warp's copy of the folded query
  __shared__ float o_s[kQ8Warps][kMaxHeadDim];  // each warp's unnormalised o over its slice
  __shared__ float m_s[kQ8Warps], l_s[kQ8Warps];
  const size_t bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* kb = k_i8 + bh * Dh * M;
  const int8_t* vb = v_i8 + bh * Dh * M;
  // warp w: tokens [begin, end), slices of a multiple of kQ8Tok tokens (some may be empty)
  constexpr int kStep = 32 * kQ8Tok;  // tokens a warp covers in one step
  const int per = (M + kQ8Warps * kQ8Tok - 1) / (kQ8Warps * kQ8Tok) * kQ8Tok;
  const int begin = min(M, warp * per), end = min(M, begin + per);

  // the folded query in the plain version's order, (float(q) * Dh^-1/2) * k_scale
  const float ks = k_scale[bh];
  for (int d = lane; d < Dh; d += 32) {
    q_s[warp][d] = to_f32(q[bh * Dh + d]) * scale * ks;
    o_s[warp][d] = 0.f;
  }
  __syncwarp();

  float m = -INFINITY, l = 0.f;  // the warp's running max; this lane's share of the sum
  for (int t0 = begin; t0 < end; t0 += kStep) {
    // this lane's first token; tokens at or past end give p = 0
    const int t = t0 + (VECTOR ? lane * kQ8Tok : lane);
    float s[kQ8Tok] = {};
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) {
      uint32_t w[kQ8Tok / 4];
      load_tok<VECTOR>(w, kb + static_cast<size_t>(d) * M, t, M);
      const float qd = q_s[warp][d];
#pragma unroll
      for (int i = 0; i < kQ8Tok / 4; ++i) {
        const uint32_t wb = w[i] ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) s[4 * i + j] = fmaf(qd, i8_biased(wb, j), s[4 * i + j]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kQ8Tok; ++i) mx = tok_at<VECTOR>(t, i) < end ? fmaxf(mx, s[i]) : mx;
    const float m_new = fmaxf(m, warp_max(mx));  // finite: the step holds a token
    const float alpha = expf(m - m_new);          // 0 at the first step (m = -inf)
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < kQ8Tok; ++i) {
      s[i] = tok_at<VECTOR>(t, i) < end ? expf(s[i] - m_new) : 0.f;
      ls += s[i];
    }
    l = l * alpha + ls;
    m = m_new;
    // p . v, kQ8Rows rows of V at a time (rows past Dh read row Dh - 1 and
    // count 0): each lane sums its kQ8Tok tokens of each row, and a transpose
    // reduction leaves row d0 + r's sum in lanes 4r .. 4r+3
    for (int d0 = 0; d0 < Dh; d0 += kQ8Rows) {
      float part[kQ8Rows];
#pragma unroll
      for (int j = 0; j < kQ8Rows; ++j) {
        uint32_t w[kQ8Tok / 4];
        load_tok<VECTOR>(w, vb + static_cast<size_t>(min(d0 + j, Dh - 1)) * M, t, M);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kQ8Tok / 4; ++i) {
          const uint32_t wb = w[i] ^ 0x80808080u;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc = fmaf(s[4 * i + jj], i8_biased(wb, jj), acc);
        }
        part[j] = d0 + j < Dh ? acc : 0.f;
      }
      const float sum = warp_transpose_sum(part);
      const int d = d0 + lane / (32 / kQ8Rows);
      if (lane % (32 / kQ8Rows) == 0 && d < Dh) o_s[warp][d] = o_s[warp][d] * alpha + sum;
    }
  }
  l = warp_sum(l);
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();

  // the merge, in warp order; a warp with no token has m = -inf and counts 0
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kQ8Warps; ++w) m_all = fmaxf(m_all, m_s[w]);
  float f[kQ8Warps], l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kQ8Warps; ++w) {
    f[w] = m_s[w] == -INFINITY ? 0.f : expf(m_s[w] - m_all);
    l_all += l_s[w] * f[w];
  }
  const float vs = v_scale[bh];
  for (int d = threadIdx.x; d < Dh; d += kQ8Threads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kQ8Warps; ++w) o += o_s[w][d] * f[w];
    out[bh * Dh + d] = from_f32<T>(o / l_all * vs);
  }
}

template <typename T>
int launch_shared_cluster(const void* q_tilde, const void* mem, void* out, int B, int M,
                          cudaStream_t stream) {
  auto kernel = decode_shared_cluster_kernel<T>;
  const size_t smem = cluster_smem<T>(M);
  if (int err = allow_smem_once<decode_shared_cluster_kernel<T>, false>(smem)) return err;
  kernel<<<dim3(kCluster, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q_tilde), static_cast<const T*>(mem), static_cast<T*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMxu>
int launch_shared_q8(const void* q_tilde, const int8_t* mem_i8, const float* mem_scale, void* out,
                     int B, int M, cudaStream_t stream) {
  auto kernel = decode_shared_q8_cluster_kernel<T, kMxu>;
  const size_t smem = q8_smem<T, kMxu>((M + kCluster - 1) / kCluster).total;
  if (int err = allow_smem_once<decode_shared_q8_cluster_kernel<T, kMxu>, false>(smem))
    return err;
  kernel<<<dim3(kCluster, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q_tilde), mem_i8, mem_scale, static_cast<T*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, typename OT>
int launch_kv(const void* q, const void* k_t, const void* v_t, void* out, int BH, int Dh, int M,
              float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, KT, OT>;
  const size_t smem = static_cast<size_t>(Dh + M) * sizeof(float);
  if (int err = allow_smem_once<decode_attention_kernel<QT, KT, OT>, false>(smem)) return err;
  kernel<<<BH, kThreads, smem, stream>>>(static_cast<const QT*>(q), static_cast<const KT*>(k_t),
                                         static_cast<const KT*>(v_t), static_cast<OT*>(out), Dh,
                                         M, scale);
  return static_cast<int>(cudaGetLastError());
}

// 8-byte vectors where M and both caches' starts allow, else single bytes.
template <typename T>
int launch_kv_q8(const void* q, const int8_t* k_i8, const int8_t* v_i8, const float* k_scale,
                 const float* v_scale, void* out, int BH, int Dh, int M, float scale,
                 cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k_i8) | reinterpret_cast<uintptr_t>(v_i8);
  const auto* qt = static_cast<const T*>(q);
  auto* ot = static_cast<T*>(out);
  const dim3 grid(BH), block(kQ8Threads);
  if (M % 8 == 0 && addr % 8 == 0)
    decode_attention_q8_kernel<T, true><<<grid, block, 0, stream>>>(qt, k_i8, v_i8, k_scale, v_scale, ot, Dh, M, scale);
  else
    decode_attention_q8_kernel<T, false><<<grid, block, 0, stream>>>(qt, k_i8, v_i8, k_scale, v_scale, ot, Dh, M, scale);
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

// K3: as K2 over mem_i8 [B, M, 256] int8 (16-byte aligned) with mem_scale [B, M] fp32.
extern "C" int ralf_decode_shared_attention_q8(int dtype, const void* q_tilde,
                                               const int8_t* mem_i8, const float* mem_scale,
                                               void* out, int B, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_shared_q8<float, false>(q_tilde, mem_i8, mem_scale, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_shared_q8<__nv_bfloat16, false>(q_tilde, mem_i8, mem_scale, out, B, M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4: K3's arguments; the kernel quantises q_tilde itself.
extern "C" int ralf_decode_shared_attention_q8mxu(int dtype, const void* q_tilde,
                                                  const int8_t* mem_i8, const float* mem_scale,
                                                  void* out, int B, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_shared_q8<float, true>(q_tilde, mem_i8, mem_scale, out, B, M, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_shared_q8<__nv_bfloat16, true>(q_tilde, mem_i8, mem_scale, out, B, M, st);
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

// K8: q and out [BH, Dh] of the dtype code, k_i8 and v_i8 [BH, Dh, M] int8,
// k_scale and v_scale [BH] fp32; scale = Dh^-1/2 as the caller rounds it to fp32.
extern "C" int ralf_decode_attention_q8(int dtype, const void* q, const int8_t* k_i8,
                                        const int8_t* v_i8, const float* k_scale,
                                        const float* v_scale, void* out, int BH, int Dh, int M,
                                        float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ralf::kFloat32)
    return ralf::launch_kv_q8<float>(q, k_i8, v_i8, k_scale, v_scale, out, BH, Dh, M, scale, st);
  if (dtype == ralf::kBFloat16)
    return ralf::launch_kv_q8<__nv_bfloat16>(q, k_i8, v_i8, k_scale, v_scale, out, BH, Dh, M,
                                             scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
