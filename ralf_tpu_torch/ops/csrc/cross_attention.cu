// K10: multi-head cross-attention of S queries over a memory of M != S
// tokens, forward only.
//
// It replaces no Pallas kernel: the JAX package leaves this attention to
// XLA's einsums (ralf_tpu/models/nn.py MultiHeadAttention).  It was added
// for the denoising decoder's cross-attention (models/diffusion.py), which
// attends from the L = 50 tokens to the 330 image tokens at every layer of
// every step, over K and V projected once a request
// (DiffusionDecoderCore.cross_kv); PyTorch's einsum path wrote the bf16
// logits, their fp32 copy, the fp32 probabilities and their bf16 copy to
// device memory at every call.
//
// q [B, S, E] and k, v [B, M, E] with head h in columns h*dh.. (the layout
// the projections write, read directly, as K1 reads it), an optional fp32
// key bias [B, M] added to every head's logits:
//
//   s = scale * (q . k) + bias   (fp32);   p = softmax over the M keys (fp32)
//   o = sum_j T(p~[j]) v[j] / l          (fp32 sums, then T)
//
// the einsum path's function with the logits kept in fp32 (the einsum path
// rounds them to bf16 first and folds the scale into a bf16 q).  The
// softmax is online over key tiles: p~ = exp(s - m) against the running max,
// rounded to T (the working type) before P V, and l sums the unrounded p~;
// the plain version rounds the normalised p instead, a difference of one
// rounding of p.  A bias of -1e9 on every key of a row gives the mean of V,
// as the einsum path's softmax does.
//
// What bounds it on the H100, at the denoising decoder's shape (B=1024,
// S=50, M=330, E=256, H=8, bf16): it must move q, k, v and o once,
// B*(2S + 2M)*E*2 = 398 MB (0.119 ms at 3.35 TB/s), against 4*B*S*M*E =
// 17.3 GFLOP (0.017 ms at the bf16 tensor-core peak): 43 operations a byte,
// far below the 295 where the tensor cores become the limit.  So K and V
// stream through shared memory once and nothing else reaches device memory.
//
// Design (bf16): one block of 4 warps per (head, batch row, 64 queries);
// each warp owns a query tile of 16 rows.  The head's K and V rows stream in
// tiles of 64 keys through a ring of 3 stages in shared memory (16-byte
// cp.async; one barrier a tile), so the next two tiles load while the warps
// work on one.  Q's fragments stay in registers for the whole walk; Q K^T
// and P V run on the tensor cores (mma.sync.m16n8k16, fp32 sums, ldmatrix
// from rows padded by 8 elements: no bank conflicts); the scores, the
// running max and sum and p stay in registers, and a score tile becomes the
// A fragment of P V without leaving them.  The exp is exp2 of scores
// scaled by scale * log2(e).  The M tail (330 = 5*64 + 10) is masked: keys
// past M take s = -inf and zero rows, and the n-tiles wholly past M are
// skipped.  B*H = 8192 blocks of 35.8 KB (Dh=32) keep several blocks a SM
// in flight over the 132 SMs.
// Head widths: up to 64, padded with zero columns to 32 or 64 (zero columns
// change neither q . k nor p . v); a width that is not a multiple of 8, or
// an operand off a 16-byte boundary, is copied element by element.
// fp32 runs a CUDA-core kernel (TF32 would not be exact): a warp a query row
// at a time, a lane two keys of a tile of 64, then a lane a column of P V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace ralf {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kXKeys = 64;            // keys a tile
constexpr int kXStages = 3;           // tiles in the ring
constexpr int kXWarps = 4;            // query tiles of 16 a block
constexpr int kXRows = 16 * kXWarps;  // queries a block (bf16)
constexpr int kXThreads = 32 * kXWarps;
constexpr int kFRows = 16;  // queries a block (fp32): 4 a warp

// Row stride in elements of a tile in shared memory: DH + 8 makes it an odd
// number of 16-byte chunks, so ldmatrix's 8 rows fall in distinct banks.
template <int DH>
__host__ __device__ constexpr int x_ld() {
  return DH + 8;
}

// 2^x in one MUFU instruction (a few ulp; 0 for -inf, results below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
constexpr size_t x_smem() {
  return static_cast<size_t>(kXRows + 2 * kXStages * kXKeys) * x_ld<DH>() *
         sizeof(__nv_bfloat16);
}

// Rows [0, n) of a head's [rows, dh] slab at src (row stride E) into dst
// [rows][x_ld<DH>()]; the other rows, and the columns past dh, zeros.
// kVec: 16-byte cp.async (dh a multiple of 8, src on a 16-byte boundary),
// completed by the caller's wait; else element by element.
template <int DH, bool kVec>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                          int n, int E, int dh) {
  constexpr int LD = x_ld<DH>();
  if constexpr (kVec) {
    constexpr int kChunks = DH / 8;
    for (int i = threadIdx.x; i < rows * kChunks; i += kXThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const bool valid = r < n && ch * 8 < dh;
      cp_async16(dst + r * LD + ch * 8, valid ? src + static_cast<size_t>(r) * E + ch * 8 : src,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DH; i += kXThreads) {
      const int r = i / DH, d = i - r * DH;
      dst[r * LD + d] =
          r < n && d < dh ? src[static_cast<size_t>(r) * E + d] : __float2bfloat16(0.f);
    }
  }
}

template <int DH, bool kVec>
__global__ void __launch_bounds__(kXThreads, 4) cross_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
    __nv_bfloat16* __restrict__ out, int S, int M, int E, int dh, float scale) {
  constexpr int LD = x_ld<DH>(), kTile = kXKeys * LD, kNT = kXKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = q_s + kXRows * LD;  // a stage: the K tile, then the V tile
  const int h = blockIdx.x, b = blockIdx.y, s0 = blockIdx.z * kXRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t col = static_cast<size_t>(h) * dh;
  const int nq = min(kXRows, S - s0), ntiles = (M + kXKeys - 1) / kXKeys;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * M * E + col;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * M * E + col;
  const float* bias = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * M;

  load_rows<DH, kVec>(q_s, q + (static_cast<size_t>(b) * S + s0) * E + col, kXRows, nq, E, dh);
  auto issue = [&](int t) {  // tile t into its stage; Q rides in tile 0's group
    if (t < ntiles) {
      __nv_bfloat16* ks = ring + (t % kXStages) * 2 * kTile;
      const size_t off = static_cast<size_t>(t) * kXKeys * E;
      const int n = min(kXKeys, M - t * kXKeys);
      load_rows<DH, kVec>(ks, kb + off, kXKeys, n, E, dh);
      load_rows<DH, kVec>(ks + kTile, vb + off, kXKeys, n, E, dh);
    }
    cp_async_commit();  // an empty group keeps the count of the wait below
  };
  for (int t = 0; t < kXStages - 1; ++t) issue(t);

  const int r0 = warp * 16;
  const bool active = r0 < nq;
  const float sl = scale * kLog2e;
  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (l: this lane's keys)

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kXStages - 2>();
    __syncthreads();  // tile i landed for all; tile i - 1's stage is consumed
    issue(i + kXStages - 1);
    if (!active) continue;
    if (i == 0) {
      // A: rows 0-7 | k 0-7, rows 8-15 | k 0-7, rows 0-7 | k 8-15, rows 8-15 | k 8-15
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], q_s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = ring + (i % kXStages) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const int key0 = i * kXKeys, nt = (min(kXKeys, M - key0) + 7) / 8;  // n-tiles with a key

    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      if (n < nt) {
#pragma unroll
        for (int kc = 0; kc < DH / 32; ++kc) {
          // B from K's rows: keys n*8.. | dims 8j.. for j = 0..3 of this 32
          uint32_t kf[4];
          ldmatrix_x4(kf, ks + (n * 8 + (lane & 7)) * LD + kc * 32 + (lane >> 3) * 8);
          const uint32_t* a = qf[2 * kc];
          const uint32_t* a2 = qf[2 * kc + 1];
          mma_bf16(sc[n], a[0], a[1], a[2], a[3], kf[0], kf[1]);
          mma_bf16(sc[n], a2[0], a2[1], a2[2], a2[3], kf[2], kf[3]);
        }
      }
    }

    // scores in the log2 domain (keys past M at -inf, the bias read where
    // there is one); the tile's row max
    float mx[2] = {m[0], m[1]};
    if (bias == nullptr && key0 + kXKeys <= M) {  // a whole tile: no mask, no bias
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] *= sl;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * c + (e & 1);
          float x = -INFINITY;
          if (n < nt && key < M)
            x = bias == nullptr ? sc[n][e] * sl : fmaf(sc[n][e], sl, bias[key] * kLog2e);
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    }
    float ref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ref[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no exp(-inf + inf)
      const float alpha = ex2(m[r] - ref[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // p~ = exp2(x - m), into the A fragments of P V: k-step j takes n-tiles 2j, 2j + 1
    uint32_t pf[kNT / 2][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = ex2(sc[n][e] - ref[e >> 1]);
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pf[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      if (2 * j < nt) {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          // B from V's rows, transposed: keys 0-7 | dims 0-7, keys 8-15 | dims 0-7,
          // keys 0-7 | dims 8-15, keys 8-15 | dims 8-15 (of this k-step and 16 dims)
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pf[j][0], pf[j][1], pf[j][2], pf[j][3], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf[j][0], pf[j][1], pf[j][2], pf[j][3], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int d = n * 8 + 2 * c;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= nq || d >= dh) continue;
      __nv_bfloat16* dst = out + (static_cast<size_t>(b) * S + s0 + row) * E + col + d;
      const float x = o[n][2 * r] * inv[r], y = o[n][2 * r + 1] * inv[r];
      if constexpr (kVec) {  // dh even: both columns inside the head, 4-byte aligned
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
      } else {
        dst[0] = __float2bfloat16(x);
        if (d + 1 < dh) dst[1] = __float2bfloat16(y);
      }
    }
  }
}

// fp32 on the CUDA cores: one block per (head, batch row, kFRows queries),
// warp w the rows 4w..4w+3 of the block, each walked over the key tiles with
// its own running max and sum; lane l scores keys l and l + 32 of a tile and
// accumulates output columns l and l + 32.
template <int DH>
__global__ void __launch_bounds__(kXThreads) cross_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_bias, float* __restrict__ out, int S, int M, int E, int dh,
    float scale) {
  constexpr int kRowsWarp = kFRows / kXWarps, kCols = DH / 32;
  __shared__ float q_s[kFRows][DH];
  __shared__ float k_s[kXKeys][DH + 1];  // odd stride: lanes on consecutive keys, distinct banks
  __shared__ float v_s[kXKeys][DH];
  __shared__ float p_s[kXWarps][kRowsWarp][kXKeys];
  const int h = blockIdx.x, b = blockIdx.y, s0 = blockIdx.z * kFRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t col = static_cast<size_t>(h) * dh;
  const int nq = min(kFRows, S - s0);
  const float* kb = k + static_cast<size_t>(b) * M * E + col;
  const float* vb = v + static_cast<size_t>(b) * M * E + col;
  const float* bias = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * M;
  const float sl = scale * kLog2e;

  for (int i = threadIdx.x; i < kFRows * DH; i += kXThreads) {
    const int r = i / DH, d = i - r * DH;
    q_s[r][d] = r < nq && d < dh ? q[(static_cast<size_t>(b) * S + s0 + r) * E + col + d] : 0.f;
  }
  float m[kRowsWarp], l[kRowsWarp], acc[kRowsWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] = 0.f;
  }
  for (int key0 = 0; key0 < M; key0 += kXKeys) {
    const int n = min(kXKeys, M - key0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kXKeys * DH; i += kXThreads) {
      const int r = i / DH, d = i - r * DH;
      const size_t at = static_cast<size_t>(key0 + r) * E + d;
      const bool in = r < n && d < dh;
      k_s[r][d] = in ? kb[at] : 0.f;
      v_s[r][d] = in ? vb[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsWarp; ++rr) {
      const int row = warp * kRowsWarp + rr;
      if (row >= nq) break;  // warp-uniform
      float x[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s = fmaf(q_s[row][d], k_s[j][d], s);
        x[jj] = j >= n ? -INFINITY
                       : bias == nullptr ? s * sl : fmaf(s, sl, bias[key0 + j] * kLog2e);
      }
      const float mx = fmaxf(m[rr], warp_max(fmaxf(x[0], x[1])));
      const float ref = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m[rr] - ref);
      const float p0 = exp2f(x[0] - ref), p1 = exp2f(x[1] - ref);
      m[rr] = mx;
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      p_s[warp][rr][lane] = p0;
      p_s[warp][rr][lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = lane + 32 * cc;
        float a = acc[rr][cc] * alpha;
        for (int j = 0; j < n; ++j) a = fmaf(p_s[warp][rr][j], v_s[j][d], a);
        acc[rr][cc] = a;
      }
      __syncwarp();  // p_s of this row read before the next tile's writes
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsWarp; ++rr) {
    const int row = warp * kRowsWarp + rr;
    if (row >= nq) break;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = lane + 32 * cc;
      if (d < dh) out[(static_cast<size_t>(b) * S + s0 + row) * E + col + d] = acc[rr][cc] / l[rr];
    }
  }
}

template <int DH, bool kVec>
int launch_x(const void* q, const void* k, const void* v, const float* key_bias, void* out, int B,
             int S, int M, int E, int nhead, float scale, cudaStream_t stream) {
  constexpr size_t smem = x_smem<DH>();
  if (int err = allow_smem_once<cross_attention_kernel<DH, kVec>>(smem)) return err;
  cross_attention_kernel<DH, kVec><<<dim3(nhead, B, (S + kXRows - 1) / kXRows), kXThreads, smem,
                                     stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), key_bias, static_cast<__nv_bfloat16*>(out), S, M, E,
      E / nhead, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_x_f32(const void* q, const void* k, const void* v, const float* key_bias, void* out,
                 int B, int S, int M, int E, int nhead, float scale, cudaStream_t stream) {
  cross_attention_f32_kernel<DH><<<dim3(nhead, B, (S + kFRows - 1) / kFRows), kXThreads, 0,
                                   stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      key_bias, static_cast<float*>(out), S, M, E, E / nhead, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// bf16 on the tensor cores, fp32 on the CUDA cores; head widths up to 64,
// padded to the next of 32 and 64
int dispatch_x(int dtype, const void* q, const void* k, const void* v, const float* key_bias,
               void* out, int B, int S, int M, int E, int nhead, float scale, cudaStream_t st) {
  if (nhead < 1 || E % nhead || E / nhead > 64 || B < 1 || B > 65535 || S < 1 || M < 1 ||
      (S + kFRows - 1) / kFRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dh = E / nhead;
  if (dtype == kBFloat16) {
    const bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
    if (dh <= 32)
      return vec ? launch_x<32, true>(q, k, v, key_bias, out, B, S, M, E, nhead, scale, st)
                 : launch_x<32, false>(q, k, v, key_bias, out, B, S, M, E, nhead, scale, st);
    return vec ? launch_x<64, true>(q, k, v, key_bias, out, B, S, M, E, nhead, scale, st)
               : launch_x<64, false>(q, k, v, key_bias, out, B, S, M, E, nhead, scale, st);
  }
  if (dtype == kFloat32) {
    if (dh <= 32) return launch_x_f32<32>(q, k, v, key_bias, out, B, S, M, E, nhead, scale, st);
    return launch_x_f32<64>(q, k, v, key_bias, out, B, S, M, E, nhead, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace ralf

// K10: q, out [B, S, E] and k, v [B, M, E] of the dtype code; key_bias [B, M]
// fp32 or null; scale multiplies q . k.  Returns the launch's cudaError_t.
extern "C" int ralf_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                    const float* key_bias, void* out, int B, int S, int M, int E,
                                    int nhead, float scale, void* stream) {
  return ralf::dispatch_x(dtype, q, k, v, key_bias, out, B, S, M, E, nhead, scale,
                          static_cast<cudaStream_t>(stream));
}
