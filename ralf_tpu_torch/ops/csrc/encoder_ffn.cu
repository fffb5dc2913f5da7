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
// 44.3 MB (13.2 us): operation-bound, so both products belong on the
// tensor cores.  The unfused sequence writes and reads back the [M, F]
// hidden (173 MB more); here it never leaves the SM.
//
// bf16 (fused_ffn_tc_kernel): a back-to-back GEMM in the shape of
// FlashAttention-3's S = Q K^T, O += P V.  A block of three warpgroups
// takes a tile of 128 rows, one block a SM (192 KB of shared memory):
//   - the producer warpgroup (40 registers a thread, setmaxnreg) has one
//     thread issue TMA loads: the x tile once (4 panels of 64 columns),
//     then F in chunks of Fc = 64, W1_c [64, 256] and W2_c [256, 64]
//     alternating through a ring of 4 slots of 32 KB, each with a full and
//     an empty mbarrier.  TMA writes the 128-byte swizzle that wgmma reads
//     and zero-fills the rows of a ragged last tile;
//   - two consumer warpgroups (232 registers) own 64 rows each and read
//     every weight chunk from the same slot: the weights stream from L2
//     once per 128 rows, 330 MB a call at the main shape (a block of 64
//     rows would double that; a cluster multicasting the chunks, which
//     would halve it, is not built).  Per chunk a consumer computes h_c
//     [64, 64] = x . W1_c^T by 16 wgmma m64n64k16 over E (both operands in
//     shared memory), applies the max against T(-b1) and rounds to bf16 in
//     registers, and feeds g_c from registers as the A operand of o [64,
//     256] += g_c . W2_c^T, 4 wgmma m64n256k16 (128 fp32 accumulators a
//     thread; the accumulator layout of the first product is the A layout
//     of the second, hopper.cuh).  The next chunk's h product is issued
//     behind o's, then both are waited on;
//   - the two consumers take turns to issue a chunk's products (named
//     barriers, FlashAttention-3's ping-pong), so that one's batch runs on
//     the tensor cores while the other packs g;
//   - the epilogue rounds T(T(o) + T(tail)) into the warpgroup's own rows
//     of the x tile (no longer read) in the swizzled layout, and one thread
//     stores them by TMA, which clips the rows past M.
// The grid is one block per 128-row tile, except that a last wave at most
// half full becomes twice as many half tiles of 64 rows, one a SM, where
// warpgroup 0 has the tensor cores to itself and warpgroup 1 only keeps
// the ring's and the turns' counts: at the main shape 264 tiles and 132
// half tiles in place of 330 tiles in 2.5 waves.
// Measured on one H100 80GB HBM3 at 700 W (kernel_ab.py, device ms at the
// main shape): 0.105 before the ping-pong, 0.098 with it, 0.092 with the
// half tiles (the unfused sequence: 0.150).  Timed apart (kernel_ab.py
// --k5-phases, before the half tiles): no weight copied after the ring's
// first fill 0.099 (the copies from L2 cost nothing measurable, so a
// cluster multicasting them would gain nothing), h over half of E 0.082,
// no second product 0.054.  Tried and slower: a persistent grid that
// loads the next tile's x behind the last chunk and stores the output
// from registers (0.118), and g double-buffered so that its packing
// overlaps o's product (0.130: ptxas then serialises every wgmma, C7514).
// Every wait on an mbarrier loops inside PTX: a C++ loop around it is a
// divergent path after which ptxas serialised the wgmma (C7520).
//
// fp32 (fused_ffn_kernel): wgmma takes no fp32 operands (and TF32 would
// not hold the fp32 result), so it keeps the CUDA-core design: one block
// of 256 threads per 64 rows, the x tile and each chunk's W1 rows, W2
// columns and g in shared memory (rows padded to an odd number of words),
// scalar fp32 FMAs, the [64, E] accumulator in registers.

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ralf {
namespace {

constexpr int kWidth = 256;  // E
constexpr int kChunk = 64;   // hidden units a step (Fc)

// ---- bf16: tensor cores ----

constexpr int kWgRows = 64;                    // rows a consumer warpgroup
constexpr int kTileRows = 2 * kWgRows;         // rows a block
constexpr int kTcThreads = 3 * 128;            // two consumer warpgroups, one producer
constexpr int kPanel = 64;                     // bf16 values in a 128-byte swizzled row
constexpr int kPanels = kWidth / kPanel;       // panels of x along E
constexpr int kXBytes = kTileRows * kWidth * 2;  // 64 KB
constexpr int kSlotBytes = kChunk * kWidth * 2;  // 32 KB: one W1_c or W2_c
constexpr int kSlots = 4;
constexpr size_t kTcSmem = 1024 + kXBytes + kSlots * kSlotBytes + (2 * kSlots + 1) * 8;

// h [64, 64] = x rows of the warpgroup . W1_c^T over E: 16 k-steps, issued
// and committed, not waited on; the first overwrites h.
__device__ __forceinline__ void h_product(float (&h)[32], const unsigned char* x_wg,
                                          const unsigned char* w1_slot) {
  fence_regs(h);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kWidth / 16; ++k) {
    const int p = k / 4, kk = k % 4;
    wgmma_m64n64k16_ss(h, sw128_desc(x_wg + p * kTileRows * 128 + kk * 32),
                       sw128_desc(w1_slot + p * kChunk * 128 + kk * 32), k > 0);
  }
  wgmma_commit();
}

// g = T(max(h, T(-b1))) as A fragments: n8 blocks 2kk, 2kk+1 of h are k-step
// kk; nb holds T(-b1) of the thread's columns 8j + 2(lane % 4), j < 8, in pairs.
__device__ __forceinline__ void pack_g(uint32_t (&g)[4][4], const float (&h)[32],
                                       const uint32_t (&nb)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 n = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&nb[j]));
    g[j / 2][2 * (j % 2)] = pack_bf16(fmaxf(h[4 * j], n.x), fmaxf(h[4 * j + 1], n.y));
    g[j / 2][2 * (j % 2) + 1] = pack_bf16(fmaxf(h[4 * j + 2], n.x), fmaxf(h[4 * j + 3], n.y));
  }
}

__device__ __forceinline__ void load_nb(uint32_t (&nb)[8], const __nv_bfloat16* nb1, int c,
                                        int lane) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(nb1 + c * kChunk + 2 * (lane % 4));
#pragma unroll
  for (int j = 0; j < 8; ++j) nb[j] = p[4 * j];
}

__global__ void __launch_bounds__(kTcThreads, 1) fused_ffn_tc_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w1_map,
    const __grid_constant__ CUtensorMap w2_map, const __grid_constant__ CUtensorMap out_map,
    const __nv_bfloat16* __restrict__ nb1, const float* __restrict__ tail, int M, int F,
    int full_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // every swizzled tile starts on a 1024-byte boundary
  unsigned char* x_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = x_s + kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSlots * kSlotBytes);
  uint64_t* empty = full + kSlots;
  uint64_t* x_full = empty + kSlots;

  // blocks past full_tiles take half tiles of 64 rows: warpgroup 0 computes them alone
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const bool half = static_cast<int>(blockIdx.x) >= full_tiles;
  const int m0 = half ? full_tiles * kTileRows + (blockIdx.x - full_tiles) * kWgRows
                      : blockIdx.x * kTileRows;
  const int chunks = F / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(x_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: ring item i is W1_{i/2} (i even) or W2_{i/2} (i odd)
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_expect_tx(x_full, kXBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load_2d(x_s + p * kTileRows * 128, &x_map, x_full, p * kPanel, m0);
      for (int i = 0; i < 2 * chunks; ++i) {
        const int s = i % kSlots, c = i / 2;
        mbar_wait(&empty[s], ((i / kSlots) & 1) ^ 1);
        mbar_expect_tx(&full[s], kSlotBytes);
        unsigned char* slot = ring + s * kSlotBytes;
        if (i % 2 == 0) {
          for (int p = 0; p < kPanels; ++p)
            tma_load_2d(slot + p * kChunk * 128, &w1_map, &full[s], p * kPanel, c * kChunk);
        } else {
          tma_load_2d(slot, &w2_map, &full[s], c * kChunk, 0);
        }
      }
    }
  } else if (wg == 1 && half) {
    // no rows: keeps the ring's and the turns' counts, waiting for each chunk
    // before it frees it, so that it never frees a slot ahead of warpgroup 0
    setmaxnreg_dec<40>();
    mbar_wait(&full[0], 0);
    if (tid == 0) mbar_arrive(&empty[0]);
    named_bar_arrive(3, 256);
    for (int c = 0; c < chunks; ++c) {
      const int i2 = 2 * c + 1, i3 = i2 + 1;
      mbar_wait(&full[i2 % kSlots], (i2 / kSlots) & 1);
      if (c + 1 < chunks) mbar_wait(&full[i3 % kSlots], (i3 / kSlots) & 1);
      named_bar_sync(4, 256);
      if (c + 1 < chunks) named_bar_arrive(3, 256);
      if (tid == 0) {
        mbar_arrive(&empty[i2 % kSlots]);
        if (c + 1 < chunks) mbar_arrive(&empty[i3 % kSlots]);
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg ..
    setmaxnreg_inc<232>();
    const int lane = tid % 32, warp = tid / 32;
    unsigned char* x_wg = x_s + wg * kWgRows * 128;  // its rows of panel 0
    // defined before any wgmma names them: ptxas may otherwise place an
    // undefined h over o's registers
    float h[32] = {}, o[128] = {};
    uint32_t g[4][4];
    mbar_wait(x_full, 0);
    mbar_wait(&full[0], 0);
    h_product(h, x_wg, ring);
    wgmma_wait<0>();
    fence_regs(h);
    if (tid == 0) mbar_arrive(&empty[0]);
    uint32_t nb[8];  // T(-b1) of the thread's 16 columns of the chunk, as bf16 pairs
    load_nb(nb, nb1, 0, lane);
    if (wg == 1) named_bar_arrive(3, 256);  // warpgroup 0 issues first
    for (int c = 0; c < chunks; ++c) {
      pack_g(g, h, nb);
      const int i2 = 2 * c + 1, s2 = i2 % kSlots;  // W2_c
      const int i3 = i2 + 1, s3 = i3 % kSlots;     // W1_{c+1}
      mbar_wait(&full[s2], (i2 / kSlots) & 1);
      if (c + 1 < chunks) mbar_wait(&full[s3], (i3 / kSlots) & 1);
      // ping-pong: the warpgroups take turns to issue a chunk's products, so
      // that one's batch runs on the tensor cores while the other packs g
      named_bar_sync(3 + wg, 256);
      const unsigned char* w2_slot = ring + s2 * kSlotBytes;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_m64n256k16_rs(o, g[kk], sw128_desc(w2_slot + kk * 32), 1);
      wgmma_commit();
      if (c + 1 < chunks) h_product(h, x_wg, ring + s3 * kSlotBytes);
      if (wg == 0 || c + 1 < chunks) named_bar_arrive(3 + (1 - wg), 256);
      if (c + 1 < chunks) load_nb(nb, nb1, c + 1, lane);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(h);
      if (tid == 0) {
        mbar_arrive(&empty[s2]);
        if (c + 1 < chunks) mbar_arrive(&empty[s3]);
      }
    }

    // out = T(T(o) + T(tail)) into the warpgroup's rows of x, swizzled as TMA reads them
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * (lane % 4), p = col / kPanel, cb = (col % kPanel) * 2;
      const float2 t = *reinterpret_cast<const float2*>(tail + col);
      const float tx = round_to<__nv_bfloat16>(t.x), ty = round_to<__nv_bfloat16>(t.y);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + lane / 4 + 8 * r;
        const uint32_t v = pack_bf16(round_to<__nv_bfloat16>(o[4 * j + 2 * r]) + tx,
                                     round_to<__nv_bfloat16>(o[4 * j + 2 * r + 1]) + ty);
        *reinterpret_cast<uint32_t*>(x_wg + p * kTileRows * 128 + row * 128 +
                                     (((cb / 16) ^ (row % 8)) * 16) + cb % 16) = v;
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (tid == 0 && m0 + wg * kWgRows < M) {
      for (int p = 0; p < kPanels; ++p)
        tma_store_2d(&out_map, x_wg + p * kTileRows * 128, p * kPanel, m0 + wg * kWgRows);
      tma_store_commit_and_wait_read();
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, which no library of the port
// links: it is looked up in the libcuda.so.1 that the CUDA runtime has
// loaded into the process; null if it is not there.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bf16 [rows, cols] row-major map read or written in boxes of [box_rows,
// 64] with the 128-byte swizzle; false if it cannot be encoded.
bool make_map(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kPanel), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SM count of the current device, asked once per device.
int sm_count(int* count) {
  static int counts[64] = {};
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (dev < 64 && counts[dev] > 0) {
    *count = counts[dev];
    return 0;
  }
  if (int err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev)) return err;
  if (dev < 64) counts[dev] = *count;
  return 0;
}

int launch_tc(const void* x, const void* w1, const void* nb1, const void* w2, const float* tail,
              void* out, int M, int F, cudaStream_t stream) {
  CUtensorMap x_map, w1_map, w2_map, out_map;
  if (!make_map(&x_map, x, kWidth, M, kTileRows) || !make_map(&w1_map, w1, kWidth, F, kChunk) ||
      !make_map(&w2_map, w2, F, kWidth, kWidth) || !make_map(&out_map, out, kWidth, M, kWgRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem_once<fused_ffn_tc_kernel>(kTcSmem)) return err;
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  // A last wave of 128-row tiles at most half full (66 of 132 at the main
  // shape) runs as twice as many half tiles instead, one a SM
  const int tiles = (M + kTileRows - 1) / kTileRows, last = tiles % sms;
  const int full_tiles = last > 0 && 2 * last <= sms ? tiles - last : tiles;
  const int rest = M - full_tiles * kTileRows;
  const int blocks = full_tiles + (rest > 0 ? (rest + kWgRows - 1) / kWgRows : 0);
  fused_ffn_tc_kernel<<<blocks, kTcThreads, kTcSmem, stream>>>(
      x_map, w1_map, w2_map, out_map, static_cast<const __nv_bfloat16*>(nb1), tail, M, F,
      full_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: CUDA cores ----

constexpr int kThreads = 256;
constexpr int kRowsTile = 64;  // rows of x per block
constexpr int kPad = 1;        // words of padding a row

constexpr size_t ffn_smem() {
  constexpr int ldx = kWidth + kPad, ldc = kChunk + kPad;
  return (static_cast<size_t>(kRowsTile) * ldx     // x tile
          + static_cast<size_t>(kChunk) * ldx      // W1 rows of the chunk
          + static_cast<size_t>(kWidth) * ldc      // W2 columns of the chunk
          + static_cast<size_t>(kRowsTile) * ldc)  // g
         * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 2) fused_ffn_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ nb1,
    const float* __restrict__ w2, const float* __restrict__ tail, float* __restrict__ out, int M,
    int F) {
  constexpr int E = kWidth, ldx = E + kPad, ldc = kChunk + kPad;
  constexpr int kCols = E / 32;     // output columns per lane
  constexpr int kRows = kRowsTile / (kThreads / 32);  // rows per warp: 8
  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);  // [kRowsTile][ldx]
  float* w1_s = x_s + kRowsTile * ldx;          // [kChunk][ldx]: W1[f0 + f, :]
  float* w2_s = w1_s + kChunk * ldx;            // [E][ldc]: W2[c, f0 + f]
  float* g_s = w2_s + E * ldc;                  // [kRowsTile][ldc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t m0 = static_cast<size_t>(blockIdx.x) * kRowsTile;
  const int n_rows = static_cast<int>(min(static_cast<size_t>(kRowsTile), M - m0));

  for (int i = tid; i < kRowsTile * E; i += kThreads) {
    const int r = i / E, e = i % E;
    x_s[r * ldx + e] = r < n_rows ? x[(m0 + r) * E + e] : 0.f;
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
    const float* wa = w1_s + lane * ldx;
    const float* wb = w1_s + (lane + 32) * ldx;
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      const float a = wa[e], b = wb[e];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xv = x_s[(warp * kRows + i) * ldx + e];
        h[i][0] = fmaf(xv, a, h[i][0]);
        h[i][1] = fmaf(xv, b, h[i][1]);
      }
    }
    const float na = nb1[f0 + lane], nb = nb1[f0 + lane + 32];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* g = g_s + (warp * kRows + i) * ldc;
      g[lane] = fmaxf(h[i][0], na);
      g[lane + 32] = fmaxf(h[i][1], nb);
    }
    __syncthreads();

    // acc[r, c] += g[r, :] . W2[c, f0:f0+64] for rows warp*8 + i and columns lane + 32j
#pragma unroll 2
    for (int f = 0; f < kChunk; ++f) {
      float wv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) wv[j] = w2_s[(lane + 32 * j) * ldc + f];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float gv = g_s[(warp * kRows + i) * ldc + f];
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
      out[(m0 + r) * E + c] = acc[i][j] + tail[c];
    }
  }
}

int launch_fp32(const void* x, const void* w1, const void* nb1, const void* w2, const float* tail,
                void* out, int M, int F, cudaStream_t stream) {
  constexpr size_t smem = ffn_smem();
  if (int err = allow_smem_once<fused_ffn_kernel>(smem)) return err;
  const int blocks = (M + kRowsTile - 1) / kRowsTile;
  fused_ffn_kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(nb1),
      static_cast<const float*>(w2), tail, static_cast<float*>(out), M, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ralf

// Returns the cudaError_t of the launch (0 on success).  x and out [M, E],
// w1 [F, E], nb1 [F] (= -b1), w2 [E, F] of the dtype code; tail [E] fp32;
// E = 256 (d_model of every full-width model), F a multiple of 64.  bf16
// needs x, w1, w2 and out on a 16-byte boundary (TMA); a tensor map that
// cannot be encoded returns cudaErrorInvalidValue.
extern "C" int ralf_fused_ffn(int dtype, const void* x, const void* w1, const void* nb1,
                              const void* w2, const float* tail, void* out, int M, int E, int F,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E != ralf::kWidth || F <= 0 || F % ralf::kChunk || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ralf::kFloat32) return ralf::launch_fp32(x, w1, nb1, w2, tail, out, M, F, st);
  if (dtype == ralf::kBFloat16) return ralf::launch_tc(x, w1, nb1, w2, tail, out, M, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
