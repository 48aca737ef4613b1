// Enformer's conv-block prologue for Hopper (sm_90a): batch norm over the
// channels of a contiguous (N, C, L) tensor, then the published GELU
// z = u * sigmoid(1.702 u), forward and backward, in float32 between an
// input and an output of one dtype (bf16 or float32), rounded once.
//
// It ports no Pallas kernel: the JAX package has no Enformer.  It was added
// for the conv blocks of haplohyped_tpu_torch/models/enformer.py, where
// F.batch_norm, then 1.702 * y, sigmoid and the product as torch ops make
// about 29 bf16 passes over every activation a train step, and it computes
// ops/batchnorm_gelu.py::batchnorm_gelu_plain, the same function in torch
// ops.  With M = N * L positions a channel and, per channel c,
//   training: mean, var = the batch's mean and biased variance over (N, L)
//             moving_mean = m * mean + (1 - m) * moving_mean,
//             moving_var  = m * var * M / (M - 1) + (1 - m) * moving_var
//   eval:     mean, var = moving_mean, moving_var
//   invstd = 1 / sqrt(var + eps), a = scale * invstd, b = bias - mean * a
//   u = a x + b,  s = sigmoid(1.702 u),  z = u s
// and backward from dz:
//   dy = dz (s + 1.702 u s (1 - s)),  xh = (x - mean) invstd
//   dbias = sum dy,  dscale = sum dy xh                    (over N and L)
//   dx = a (dy - dbias / M - xh dscale / M)   (training; eval: dx = a dy)
//
// What bounds it on this card.  Bytes: a few flops an element against 2 bytes
// (bf16) read or written, far below the card's ~295 flops a byte.  The
// forward reads x twice (statistics, then the transform) and writes z once:
// 3 passes.  The backward reads x and dz twice (sums, then dx) and writes dx:
// 5 passes.  Nothing the size of an activation is saved but x: u and s are
// recomputed from x and the per-channel coefficients.
//
// What the design does about it.
//   1. Every (n, c) row of the (N, C, L) layout is contiguous: a block takes
//      one chunk of one row (8,192 bf16 or 4,096 float32: 256 threads, 4
//      vectors of 16 bytes each, all loaded before any is used), so the
//      per-channel coefficients are one broadcast load a block and every
//      load is 16 bytes, neighbouring threads on neighbouring addresses.  L
//      decides the chunks a row (at Enformer's widest, 196,608 bf16 a row,
//      24).
//   2. No atomics.  Each block writes its channel's partial (a Welford
//      count, mean and M2 for the statistics; sum dy and sum dy xh for the
//      backward) to its own slot, and a second small launch merges each
//      channel's partials in a fixed order (Chan's formula for the
//      statistics), one warp a channel.  The same inputs give the same bits.
//   3. The forward's second launch also finishes the coefficients (a, b,
//      mean, invstd) a channel and updates the moving averages; the
//      backward's finishes dscale, dbias and the two means dx needs.  So the
//      wide passes do one FMA for u and read four floats a block.
// A launch takes L * sizeof(element) a multiple of 16 and 16-byte aligned
// tensors; the wrapper refuses anything else.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;  // 16-byte vectors a thread a block
constexpr float kGelu = 1.702f;

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);        // elements in 16 bytes
  static constexpr int chunk = kThreads * kVecs * n;  // elements a block
};

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&r);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  const float4 f = make_float4(v[0], v[1], v[2], v[3]);
  return *reinterpret_cast<const uint4*>(&f);
}

__device__ __forceinline__ float sigmoid_gelu(float u) {  // sigmoid(1.702 u)
  return __fdividef(1.0f, 1.0f + __expf(-kGelu * u));
}

// the block's place: row = n * C + c, chunk k of the row; its elements
// [begin, end) of the row
struct Place {
  int n, c, k, begin, end;
};

template <typename T>
__device__ __forceinline__ Place place(int C, int L, int chunks) {
  const int row = blockIdx.x / chunks, k = blockIdx.x - row * chunks;
  const int n = row / C;
  const int begin = k * Vec<T>::chunk;
  return {n, row - n * C, k, begin, min(L, begin + Vec<T>::chunk)};
}

// the kVecs vectors of this thread in [begin, end) of `row`, loaded before
// any is used; `live[i]` says which exist
template <typename T>
__device__ __forceinline__ void load(const T* __restrict__ row, const Place& p, uint4 (&r)[kVecs],
                                     bool (&live)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int at = p.begin + (threadIdx.x + i * kThreads) * Vec<T>::n;
    live[i] = at < p.end;
    if (live[i]) r[i] = *reinterpret_cast<const uint4*>(row + at);
  }
}

// Welford state: count, mean, M2
struct Moments {
  float n, mean, m2;
};

// Chan's merge of b into a
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.0f) return;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  a.mean += d * f;
  a.m2 += b.m2 + d * d * a.n * f;
  a.n = n;
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int off) {
  return {__shfl_down_sync(0xffffffffu, m.n, off), __shfl_down_sync(0xffffffffu, m.mean, off),
          __shfl_down_sync(0xffffffffu, m.m2, off)};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(m, shfl_down(m, off));
  return m;
}

__device__ __forceinline__ float2 warp_sum(float2 s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.x += __shfl_down_sync(0xffffffffu, s.x, off);
    s.y += __shfl_down_sync(0xffffffffu, s.y, off);
  }
  return s;
}

// --- forward ---------------------------------------------------------------

// partial[c][n * chunks + k] = (count, mean, M2, 0) of block (n, c, k)
template <typename T>
__global__ void __launch_bounds__(kThreads) stats_kernel(const T* __restrict__ x, int C, int L,
                                                         int chunks, float4* __restrict__ partial,
                                                         int N) {
  constexpr int V = Vec<T>::n;
  const Place p = place<T>(C, L, chunks);
  uint4 r[kVecs];
  bool live[kVecs];
  load(x + (static_cast<size_t>(p.n) * C + p.c) * L, p, r, live);
  Moments m = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (!live[i]) continue;
    float v[V];
    unpack(r[i], v);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[j];
    const float mu = s * (1.0f / V);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) q += (v[j] - mu) * (v[j] - mu);
    merge(m, {static_cast<float>(V), mu, q});
  }
  __shared__ Moments warps[kWarps];
  m = warp_merge(m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warps[lane] : Moments{0.0f, 0.0f, 0.0f};
    m = warp_merge(m);
    if (lane == 0)
      partial[static_cast<size_t>(p.c) * N * chunks + p.n * chunks + p.k] =
          make_float4(m.n, m.mean, m.m2, 0.0f);
  }
}

// one warp a channel: merge its partials in a fixed order (or take the
// moving statistics when partial is null), then coef[c] = (a, b, mean,
// invstd), and in training the moving averages
__global__ void __launch_bounds__(kThreads) coef_kernel(
    const float4* __restrict__ partial, int parts, int C, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ moving_mean,
    float* __restrict__ moving_var, float momentum, float eps, float4* __restrict__ coef) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= C) return;
  float mean, var;
  if (partial != nullptr) {
    Moments m = {0.0f, 0.0f, 0.0f};
    const float4* pc = partial + static_cast<size_t>(c) * parts;
    for (int j = lane; j < parts; j += 32) {
      const float4 q = pc[j];
      merge(m, {q.x, q.y, q.z});
    }
    m = warp_merge(m);
    if (lane != 0) return;
    mean = m.mean;
    var = m.m2 / m.n;
    const float unbiased = m.n > 1.0f ? m.m2 / (m.n - 1.0f) : var;
    moving_mean[c] = momentum * mean + (1.0f - momentum) * moving_mean[c];
    moving_var[c] = momentum * unbiased + (1.0f - momentum) * moving_var[c];
  } else {
    if (lane != 0) return;
    mean = moving_mean[c];
    var = moving_var[c];
  }
  const float invstd = 1.0f / sqrtf(var + eps);
  const float a = scale[c] * invstd;
  coef[c] = make_float4(a, bias[c] - mean * a, mean, invstd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) apply_kernel(const T* __restrict__ x, int C, int L,
                                                         int chunks,
                                                         const float4* __restrict__ coef,
                                                         T* __restrict__ out) {
  constexpr int V = Vec<T>::n;
  const Place p = place<T>(C, L, chunks);
  const size_t at = (static_cast<size_t>(p.n) * C + p.c) * L;
  uint4 r[kVecs];
  bool live[kVecs];
  load(x + at, p, r, live);
  const float4 k = coef[p.c];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (!live[i]) continue;
    float v[V];
    unpack(r[i], v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float u = fmaf(k.x, v[j], k.y);
      v[j] = u * sigmoid_gelu(u);
    }
    *reinterpret_cast<uint4*>(out + at + p.begin + (threadIdx.x + i * kThreads) * V) = pack(v);
  }
}

// --- backward --------------------------------------------------------------

// dy of one element: dz times the GELU's derivative at u = a x + b
__device__ __forceinline__ float grad_u(float x, float dz, const float4& k) {
  const float u = fmaf(k.x, x, k.y);
  const float s = sigmoid_gelu(u);
  return dz * (s + kGelu * u * s * (1.0f - s));
}

// partial[c][n * chunks + k] = (sum dy, sum dy xh) of block (n, c, k)
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_sums_kernel(
    const T* __restrict__ x, const T* __restrict__ dz, int C, int L, int chunks,
    const float4* __restrict__ coef, float2* __restrict__ partial, int N) {
  constexpr int V = Vec<T>::n;
  const Place p = place<T>(C, L, chunks);
  const size_t at = (static_cast<size_t>(p.n) * C + p.c) * L;
  uint4 rx[kVecs], rg[kVecs];
  bool live[kVecs];
  load(x + at, p, rx, live);
  load(dz + at, p, rg, live);
  const float4 k = coef[p.c];
  float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (!live[i]) continue;
    float v[V], g[V];
    unpack(rx[i], v);
    unpack(rg[i], g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dy = grad_u(v[j], g[j], k);
      s.x += dy;
      s.y += dy * ((v[j] - k.z) * k.w);
    }
  }
  __shared__ float2 warps[kWarps];
  s = warp_sum(s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warps[lane] : make_float2(0.0f, 0.0f);
    s = warp_sum(s);
    if (lane == 0) partial[static_cast<size_t>(p.c) * N * chunks + p.n * chunks + p.k] = s;
  }
}

// one warp a channel: dbias, dscale, and gcoef[c] = (dbias / M, dscale / M)
// in training, zeros in eval
__global__ void __launch_bounds__(kThreads) grad_coef_kernel(
    const float2* __restrict__ partial, int parts, int C, double positions, int training,
    float* __restrict__ dscale, float* __restrict__ dbias, float2* __restrict__ gcoef) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= C) return;
  float2 s = make_float2(0.0f, 0.0f);
  const float2* pc = partial + static_cast<size_t>(c) * parts;
  for (int j = lane; j < parts; j += 32) {
    const float2 q = pc[j];
    s.x += q.x;
    s.y += q.y;
  }
  s = warp_sum(s);
  if (lane != 0) return;
  dbias[c] = s.x;
  dscale[c] = s.y;
  gcoef[c] = training ? make_float2(static_cast<float>(s.x / positions),
                                    static_cast<float>(s.y / positions))
                      : make_float2(0.0f, 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) grad_input_kernel(
    const T* __restrict__ x, const T* __restrict__ dz, int C, int L, int chunks,
    const float4* __restrict__ coef, const float2* __restrict__ gcoef, T* __restrict__ dx) {
  constexpr int V = Vec<T>::n;
  const Place p = place<T>(C, L, chunks);
  const size_t at = (static_cast<size_t>(p.n) * C + p.c) * L;
  uint4 rx[kVecs], rg[kVecs];
  bool live[kVecs];
  load(x + at, p, rx, live);
  load(dz + at, p, rg, live);
  const float4 k = coef[p.c];
  const float2 m = gcoef[p.c];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (!live[i]) continue;
    float v[V], g[V];
    unpack(rx[i], v);
    unpack(rg[i], g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dy = grad_u(v[j], g[j], k);
      const float xh = (v[j] - k.z) * k.w;
      v[j] = k.x * (dy - m.x - xh * m.y);
    }
    *reinterpret_cast<uint4*>(dx + at + p.begin + (threadIdx.x + i * kThreads) * V) = pack(v);
  }
}

enum Dtype { kBf16 = 0, kFloat32 = 1 };

int chunks_of(int dtype, int L) {
  const int k = dtype == kBf16 ? Vec<__nv_bfloat16>::chunk : Vec<float>::chunk;
  return (L + k - 1) / k;
}

// the launch's shape, or false where the kernels do not take it
bool shape_ok(int dtype, int N, int C, int L) {
  if (dtype != kBf16 && dtype != kFloat32) return false;
  const int v = dtype == kBf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  if (N < 1 || C < 1 || L < 1 || L % v) return false;
  return static_cast<long long>(N) * C * chunks_of(dtype, L) < (1LL << 31);
}

template <typename T>
int forward(const void* x, int N, int C, int L, const float* scale, const float* bias,
            float* moving_mean, float* moving_var, float momentum, float eps, int training,
            float4* partial, float4* coef, void* out, cudaStream_t stream) {
  const int chunks = chunks_of(sizeof(T) == 2 ? kBf16 : kFloat32, L);
  const int blocks = N * C * chunks, coef_blocks = (C + kWarps - 1) / kWarps;
  const T* xt = static_cast<const T*>(x);
  if (training) {
    stats_kernel<T><<<blocks, kThreads, 0, stream>>>(xt, C, L, chunks, partial, N);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  coef_kernel<<<coef_blocks, kThreads, 0, stream>>>(training ? partial : nullptr, N * chunks, C,
                                                    scale, bias, moving_mean, moving_var,
                                                    momentum, eps, coef);
  if (cudaError_t e = cudaGetLastError()) return e;
  apply_kernel<T><<<blocks, kThreads, 0, stream>>>(xt, C, L, chunks, coef, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* dz, int N, int C, int L, const float4* coef,
             int training, float2* partial, float2* gcoef, float* dscale, float* dbias,
             void* dx, cudaStream_t stream) {
  const int chunks = chunks_of(sizeof(T) == 2 ? kBf16 : kFloat32, L);
  const int blocks = N * C * chunks, coef_blocks = (C + kWarps - 1) / kWarps;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dz);
  grad_sums_kernel<T><<<blocks, kThreads, 0, stream>>>(xt, gt, C, L, chunks, coef, partial, N);
  if (cudaError_t e = cudaGetLastError()) return e;
  grad_coef_kernel<<<coef_blocks, kThreads, 0, stream>>>(
      partial, N * chunks, C, static_cast<double>(N) * L, training, dscale, dbias, gcoef);
  if (cudaError_t e = cudaGetLastError()) return e;
  grad_input_kernel<T><<<blocks, kThreads, 0, stream>>>(xt, gt, C, L, chunks, coef, gcoef,
                                                        static_cast<T*>(dx));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials a channel for an (N, C, L) launch of `dtype` (0: bf16, 1:
// float32): the forward's `partial` holds C times this many float4, the
// backward's C times this many float2.  0 where the kernels refuse the shape.
int hh_bngelu_parts(int dtype, int N, int C, int L) {
  return shape_ok(dtype, N, C, L) ? N * chunks_of(dtype, L) : 0;
}

// The forward on `stream`: z = gelu(batch norm(x)) into `out`, coef (C
// float4) = (a, b, mean, invstd).  In training (`training` != 0) the batch's
// statistics, through `partial`, and the moving averages updated in place;
// else the moving statistics.  Returns cudaGetLastError() of the last launch
// (3 in training, 2 in eval), or cudaErrorInvalidValue for a refused shape.
int hh_bngelu_forward(const void* x, int dtype, int N, int C, int L, const float* scale,
                      const float* bias, float* moving_mean, float* moving_var, float momentum,
                      float eps, int training, void* partial, void* coef, void* out,
                      void* stream) {
  if (!shape_ok(dtype, N, C, L)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float4*>(partial);
  auto k = static_cast<float4*>(coef);
  if (dtype == kBf16)
    return forward<__nv_bfloat16>(x, N, C, L, scale, bias, moving_mean, moving_var, momentum,
                                  eps, training, p, k, out, s);
  return forward<float>(x, N, C, L, scale, bias, moving_mean, moving_var, momentum, eps,
                        training, p, k, out, s);
}

// The backward on `stream` from the forward's x and coef and the output's
// gradient dz: dx, dscale and dbias (C floats each), through `partial` and
// `gcoef` (C float2).  Returns cudaGetLastError() of the last of its 3
// launches, or cudaErrorInvalidValue for a refused shape.
int hh_bngelu_backward(const void* x, const void* dz, int dtype, int N, int C, int L,
                       const void* coef, int training, void* partial, void* gcoef,
                       float* dscale, float* dbias, void* dx, void* stream) {
  if (!shape_ok(dtype, N, C, L)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const float4*>(coef);
  auto p = static_cast<float2*>(partial);
  auto g = static_cast<float2*>(gcoef);
  if (dtype == kBf16)
    return backward<__nv_bfloat16>(x, dz, N, C, L, k, training, p, g, dscale, dbias, dx, s);
  return backward<float>(x, dz, N, C, L, k, training, p, g, dscale, dbias, dx, s);
}

const char* hh_bngelu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
