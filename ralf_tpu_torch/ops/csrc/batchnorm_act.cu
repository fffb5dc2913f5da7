// K11: ResNet's eval-mode BatchNorm with its optional residual add and ReLU,
// in one pass over a convolution's output, forward only.
//
// It replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA
// (ralf_tpu/models/resnet.py), which fuses the scale, the shift, the
// residual add and the ReLU into one loop.  It replaces, in the port's
// eval-mode BatchNorm (models/resnet.py BatchNorm), some ten small launches
// that rebuilt the per-channel scale and shift at every call, PyTorch's
// broadcast multiply and add over the activation, and the block's separate
// residual add and ReLU: up to four passes over each convolution's output.
//
//   s[c] = w[c] * (1 / sqrt(var[c] + eps)),   t[c] = b[c] - mean[c] * s[c]
//   y = relu?(x * s[c] + t[c] (+ r))      (fp32, one rounding to x's type)
//
// x, r and y are [N, C, H, W] in channels_last storage, so that the flat
// index runs over the C channels fastest; w, b, mean and var are [C], each
// in fp32 or bf16 as the module stores it.  s and t are worked out here
// from them, so that no cache has to follow a weight load.
//
// What bounds it on the H100: the bytes.  It reads x (and r) and writes y
// once each, against 2-3 operations an element.  At ResNet50's largest call
// in the benchmark's requests (layer1's last BatchNorm with its residual,
// [1024, 256, 88, 60] bf16) that is 3 x 2.77 GB, 2.48 ms at 3.35 TB/s; a
// forward at 350x240 moves 19.2G outputs a request of 1,024 canvases, with
// 9.55G residual elements read beside them.
//
// Design: a streaming pass.  Each block first works out s and t of all C
// channels into shared memory (C <= 4096: at most 32 KB), laid out so that
// the four channels of a float4 are one load and neighbouring threads read
// neighbouring float4s (no bank conflict).  Then it walks the tensor in
// 16-byte vectors (8 bf16 or 4 fp32 of consecutive channels; C is a
// multiple of 8, so no vector straddles a pixel) with a grid-stride loop
// over as many blocks as the SMs hold at once, kUnroll vectors of x (and of
// r) a thread in flight, loaded with the evict-first hint (each is read
// once), and the last stride's ragged end masked.  A vector's channel group
// is kept up to date by one add and one compare a stride, not by a
// division.  It allocates nothing: the wrapper hands it y.

#include "common.cuh"

namespace ralf {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors of x (and of r) in flight a thread
constexpr int kMaxChannels = 4096;
constexpr size_t kMaxSmem = 2 * kMaxChannels * sizeof(float);  // s and t

struct Params {
  const void* weight;
  const void* bias;
  const void* mean;
  const void* var;
  int weight_code, bias_code, mean_code, var_code;  // kFloat32 or kBFloat16 each
  float eps;
};

__device__ __forceinline__ float load_param(const void* p, int code, int c) {
  return code == kFloat32 ? static_cast<const float*>(p)[c]
                          : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]);
}

// 16 bytes of T as kVec fp32 values and back (one rounding to T)
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kVec = 4;
  __device__ static __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // element 2i in the low half of word i (little endian)
  __device__ static __forceinline__ void unpack_word(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static __forceinline__ uint32_t pack_word(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static __forceinline__ void unpack(const uint4& v, float* f) {
    unpack_word(v.x, f);
    unpack_word(v.y, f + 2);
    unpack_word(v.z, f + 4);
    unpack_word(v.w, f + 6);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack_word(f[0], f[1]), pack_word(f[2], f[3]), pack_word(f[4], f[5]),
                      pack_word(f[6], f[7]));
  }
};

// n vectors of x (and r) into y; groups = C / kVec vectors a pixel.
template <typename T, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads) batchnorm_act_kernel(const uint4* __restrict__ x,
                                                                 const uint4* __restrict__ r,
                                                                 uint4* __restrict__ y,
                                                                 long long n, int groups,
                                                                 Params p) {
  using P = Pack<T>;
  constexpr int kVec = P::kVec, kParts = kVec / 4;  // float4s of s (and of t) a vector
  // [kParts][groups] float4s of s, then as many of t: float4 (q, g) holds
  // channels g*kVec + 4q .. + 3
  extern __shared__ float4 st[];
  float* stf = reinterpret_cast<float*>(st);
  const int C = groups * kVec;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float s = __fmul_rn(load_param(p.weight, p.weight_code, c),
                              1.f / sqrtf(load_param(p.var, p.var_code, c) + p.eps));
    const float t = __fsub_rn(load_param(p.bias, p.bias_code, c),
                              __fmul_rn(load_param(p.mean, p.mean_code, c), s));
    const int j = c % kVec, slot = (j / 4) * groups + c / kVec;
    stf[4 * slot + j % 4] = s;
    stf[4 * (kParts * groups + slot) + j % 4] = t;
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  const int step = static_cast<int>(stride % groups);
  long long i0 = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  int g[kUnroll];  // the channel group of vector i0 + u * kThreads
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) g[u] = static_cast<int>((i0 + u * kThreads) % groups);

  for (; i0 < n; i0 += stride) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < n) {
        xv[u] = __ldcs(x + i);
        if constexpr (kResidual) rv[u] = __ldcs(r + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < n) {
        float f[kVec];
        P::unpack(xv[u], f);
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          const float4 s = st[q * groups + g[u]];
          const float4 t = st[(kParts + q) * groups + g[u]];
          f[4 * q + 0] = fmaf(f[4 * q + 0], s.x, t.x);
          f[4 * q + 1] = fmaf(f[4 * q + 1], s.y, t.y);
          f[4 * q + 2] = fmaf(f[4 * q + 2], s.z, t.z);
          f[4 * q + 3] = fmaf(f[4 * q + 3], s.w, t.w);
        }
        if constexpr (kResidual) {
          float rf[kVec];
          P::unpack(rv[u], rf);
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] += rf[e];
        }
        if constexpr (kRelu) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = f[e] < 0.f ? 0.f : f[e];  // NaN stays NaN
        }
        y[i] = P::pack(f);
      }
      g[u] += step;
      if (g[u] >= groups) g[u] -= groups;
    }
  }
}

// Blocks that the device's SMs hold at once, at the largest shared memory
// the kernel asks for; worked out once per device.
template <auto kKernel>
int resident_blocks(int* blocks) {
  static int cached[64] = {};
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  if (int err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return err;
  if (int err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads,
                                                              kMaxSmem))
    return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *blocks;
  return 0;
}

template <typename T, bool kResidual, bool kRelu>
int launch(const void* x, const void* r, void* y, long long elems, int C, const Params& p,
           cudaStream_t stream) {
  constexpr int kVec = Pack<T>::kVec;
  const long long n = elems / kVec;
  if (n == 0) return 0;
  int blocks = 0;
  if (int err = resident_blocks<batchnorm_act_kernel<T, kResidual, kRelu>>(&blocks)) return err;
  const long long needed = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int grid = static_cast<int>(needed < blocks ? needed : blocks);
  batchnorm_act_kernel<T, kResidual, kRelu><<<grid, kThreads, 2 * C * sizeof(float), stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(r), static_cast<uint4*>(y), n,
      C / kVec, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* r, void* y, long long elems, int C, const Params& p,
             bool relu, cudaStream_t stream) {
  if (r != nullptr) {
    return relu ? launch<T, true, true>(x, r, y, elems, C, p, stream)
                : launch<T, true, false>(x, r, y, elems, C, p, stream);
  }
  return relu ? launch<T, false, true>(x, r, y, elems, C, p, stream)
              : launch<T, false, false>(x, r, y, elems, C, p, stream);
}

bool is_code(int code) { return code == kFloat32 || code == kBFloat16; }

}  // namespace
}  // namespace ralf

// Returns the cudaError_t of the launch (0 on success).  x, r (or null) and
// y: `elems` elements of the dtype code (0 fp32, 1 bf16) in channels_last
// storage, C channels (a multiple of 8, at most 4096), each on a 16-byte
// boundary; weight, bias, mean, var: [C] of their own dtype codes.
extern "C" int ralf_batchnorm_act(int dtype, const void* x, const void* r, void* y,
                                  long long elems, int C, const void* weight, const void* bias,
                                  const void* mean, const void* var, int weight_code,
                                  int bias_code, int mean_code, int var_code, float eps, int relu,
                                  void* stream) {
  if (C <= 0 || C % 8 || C > ralf::kMaxChannels || elems % C || !ralf::is_code(weight_code) ||
      !ralf::is_code(bias_code) || !ralf::is_code(mean_code) || !ralf::is_code(var_code))
    return static_cast<int>(cudaErrorInvalidValue);
  const ralf::Params p{weight, bias, mean, var, weight_code, bias_code, mean_code, var_code, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ralf::kFloat32: return ralf::dispatch<float>(x, r, y, elems, C, p, relu != 0, st);
    case ralf::kBFloat16:
      return ralf::dispatch<__nv_bfloat16>(x, r, y, elems, C, p, relu != 0, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
