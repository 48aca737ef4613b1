// RMSNorm for Hopper (sm_90a), plain and gated, forward and backward, in
// float32 between an input and an output of one dtype (bf16 or float32),
// rounded once.  Over each row of D elements:
//
//   u = x * silu(g)  (gated: Mamba-2's mixer, g its gate z)   or   u = x
//   r = 1 / sqrt(mean(u^2) + eps),  xh = u r,  out = xh w
//
// where the mean is over the row, or (grouped, gated only: Mamba-2's mixer
// with several groups of B and C, which normalises each group's columns on
// their own) over each group of `group` consecutive columns, r one a group;
// and backward from dout, with gy = dout w and c = mean(gy xh) over the row
// (or the group):
//
//   du = r (gy - xh c),  dw = sum over rows of dout xh
//   dx = du silu(g),  dg = du x sigmoid(g) (1 + g (1 - sigmoid(g)))   (gated)
//   dx = du                                                           (plain)
//
// It ports no Pallas kernel: the JAX package has no Granite hybrid.  It was
// added for the norms of haplohyped_tpu_torch/models/granite_hybrid.py (and
// serves models/nemotron_h.py's, grouped in its mixers), where RMSNorm as
// torch ops (a float32 copy, pow, mean, rsqrt, two products, the cast
// back) and the mixer's gate before it (two float32 copies, silu and a
// product) make about 138 and 206 bytes of elementwise traffic an element
// forward and backward, and autograd keeps their float32 intermediates.  It
// computes ops/rms_norm.py::rms_norm_plain, the same function in torch ops.
//
// What bounds it on this card.  Bytes: some ten flops an element against
// 4-10 bytes read or written, far below the card's ~295 flops a byte.  The
// least traffic is one read of x (and g) and one write of out forward; one
// read of x (and g) and dout and one write of dx (and dg) backward: 4 and 6
// bytes an element in bf16 plain, 6 and 10 gated.
//
// What the design does about it.
//   1. A row is held in registers by 128 threads (up to 8 16-byte vectors a
//      thread of each input), so every input is read once: the sum of squares
//      (forward) or of gy xh (backward) is a warp-shuffle and shared-memory
//      reduction over the row, and the outputs are computed from the same
//      registers.  Neighbouring threads load neighbouring 16 bytes.  A block
//      holds 2 rows at a time.
//   2. Nothing the size of an activation is saved: the forward writes out
//      and one float32 r a row; the backward recomputes u and xh from x, g
//      and r.  x and g are read through a row stride, so the mixer's gate is
//      read in place from in_proj's output.
//   3. No atomics.  The backward's blocks each take a stripe of rows and
//      write their float32 partial of dw over it (the column sums kept in
//      registers); a second launch sums the partials in a fixed order.  The
//      same inputs give the same bits.
//   4. What keeps bytes in flight is rows resident on an SM, and registers
//      bound them: the backward's registers are fitted per width and gate
//      (backward_blocks below).
// A launch takes D a multiple of 8 (16 bytes of bf16 or 32 of float32) up to
// 128 threads x 8 vectors (8,192 bf16, 4,096 float32), and 16-byte aligned
// rows; a group that divides D into whole warps' vectors (a multiple of 32
// vectors: 256 bf16 or 128 float32 columns); the wrapper refuses anything
// else.  A grouped row's sums are a warp's shuffle a vector, then the
// warps' sums of one group added in a fixed order through shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 128;  // threads a row
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kGroups = 2;  // rows a block holds at a time
constexpr int kThreads = kRowThreads * kGroups;
constexpr int kMaxVecs = 8;        // 16-byte vectors a thread a row, at most
constexpr int kMaxPartials = 512;  // the backward's blocks (dw partials), at most
constexpr int kSumWarps = 8;       // the partials' sum: warps a block, 32 columns

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // elements in 16 bytes
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

// V consecutive float32 weights (V * 4 bytes, 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_weight(const float* __restrict__ w, float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(w + j));
    v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
  }
}

__device__ __forceinline__ float sigmoid(float g) { return 1.0f / (1.0f + expf(-g)); }

// the sum of v over the kRowThreads threads of this thread's row; every
// thread of the row gets the same bits.  `red` is the block's shared slots,
// `parity` alternates between consecutive calls, so one barrier a call
// suffices.  Every thread of the block calls it.
__device__ __forceinline__ float row_sum(float v, float (*red)[kGroups][kRowWarps], int parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[parity][warp / kRowWarps][warp % kRowWarps] = v;
  __syncthreads();
  const float* s = red[parity][warp / kRowWarps];
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) total += s[w];
  return total;
}

// The slots of a row's grouped sums: one a (warp, vector index); slot k
// holds the sum over vectors [32 k, 32 k + 32) of the row.
constexpr int kSlots = kRowWarps * kMaxVecs;

// Grouped: out[i] = the sum of v over the group of this thread's vector i,
// the groups `slots` slots (32 `slots` vectors) wide; every thread of a
// group gets the same bits.  As row_sum, one barrier a call.
template <int kVecs>
__device__ __forceinline__ void group_sums(const float (&v)[kVecs], float (&out)[kVecs],
                                           float (*red)[kGroups][kSlots], int parity, int slots) {
  const int warp = (threadIdx.x % kRowThreads) / 32, rg = threadIdx.x / kRowThreads;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    float a = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (threadIdx.x % 32 == 0) red[parity][rg][warp + kRowWarps * i] = a;
  }
  __syncthreads();
  const float* s = red[parity][rg];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int first = (warp + kRowWarps * i) / slots * slots;
    float total = 0.0f;
    for (int k = first; k < first + slots; ++k) total += s[k];
    out[i] = total;
  }
}

// --- forward ---------------------------------------------------------------

// block b holds rows b * kGroups + {0, 1}: out (contiguous) and rstd (one
// a row, or grouped one a group: D / group a row)
template <typename T, int kVecs, bool kGated, bool kGrouped>
__global__ void __launch_bounds__(kThreads) rms_norm_fwd_kernel(
    const T* __restrict__ x, long long x_stride, const T* __restrict__ g, long long g_stride,
    const float* __restrict__ weight, int R, int D, int group, float eps, T* __restrict__ out,
    float* __restrict__ rstd) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[2][kGroups][kGrouped ? kSlots : kRowWarps];
  const int t = threadIdx.x % kRowThreads;
  const int row = blockIdx.x * kGroups + threadIdx.x / kRowThreads;
  const bool on = row < R;
  float u[kVecs][V];
  float ss = 0.0f, ssv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int at = (t + i * kRowThreads) * V;
    ssv[i] = 0.0f;
    if (!on || at >= D) continue;
    unpack(*reinterpret_cast<const uint4*>(x + row * x_stride + at), u[i]);
    if constexpr (kGated) {
      float gv[V];
      unpack(*reinterpret_cast<const uint4*>(g + row * g_stride + at), gv);
#pragma unroll
      for (int j = 0; j < V; ++j) u[i][j] *= gv[j] * sigmoid(gv[j]);
    }
    if constexpr (kGrouped) {
#pragma unroll
      for (int j = 0; j < V; ++j) ssv[i] += u[i][j] * u[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) ss += u[i][j] * u[i][j];
    }
  }
  float rv[kVecs];
  if constexpr (kGrouped) {
    group_sums<kVecs>(ssv, rv, red, 0, group / V / 32);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) rv[i] = rsqrtf(rv[i] / static_cast<float>(group) + eps);
  } else {
    const float r = rsqrtf(row_sum(ss, red, 0) / static_cast<float>(D) + eps);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) rv[i] = r;
  }
  if (!on) return;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int at = (t + i * kRowThreads) * V;
    if (at >= D) continue;
    float w[V];
    load_weight(weight + at, w);
#pragma unroll
    for (int j = 0; j < V; ++j) u[i][j] = u[i][j] * rv[i] * w[j];
    *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * D + at) = pack(u[i]);
    // a group's first vector writes its r
    if constexpr (kGrouped)
      if (at % group == 0) rstd[static_cast<long long>(row) * (D / group) + at / group] = rv[i];
  }
  if constexpr (!kGrouped)
    if (t == 0) rstd[row] = rv[0];
}

// --- backward --------------------------------------------------------------

// Blocks an SM the backward's registers are fitted to.  A thread holds its
// columns' raw inputs across the row's barrier and their dw sums across the
// stripe: some 2 registers a column plain and 2.5 gated.  On an H100 the
// gated norm at 4,096 bf16 (32 columns a thread) took 162 registers
// unbounded, one block an SM, at 56% of its byte bound, and fitted to two
// blocks (128 registers, sigmoid(g) recomputed after the barrier rather than
// kept) 66%; the plain norm at 2,048 (16 columns) took 63 unbounded, four
// blocks, at 71%, and fitted to two 72 registers and 65%.
template <bool kGated, int kColumns>
constexpr int backward_blocks() {
  return kColumns > 32 ? 1 : kGated ? 2 : kColumns > 16 ? 2 : 4;
}

// block b takes rows [b * per_block, min(R, (b + 1) * per_block)), kGroups at
// a time: dx (and dg), contiguous, and partial[b] = its rows' sum of dout xh
template <typename T, int kVecs, bool kGated, bool kGrouped>
__global__ void __launch_bounds__(kThreads, (backward_blocks<kGated, kVecs * Vec<T>::n>()))
    rms_norm_bwd_kernel(
    const T* __restrict__ x, long long x_stride, const T* __restrict__ g, long long g_stride,
    const T* __restrict__ dout, long long dout_stride, const float* __restrict__ weight,
    const float* __restrict__ rstd, int R, int D, int group, int per_block, T* __restrict__ dx,
    T* __restrict__ dg, float* __restrict__ partial) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[2][kGroups][kGrouped ? kSlots : kRowWarps];
  const int t = threadIdx.x % kRowThreads;
  const int begin = blockIdx.x * per_block, end = min(R, begin + per_block);
  float acc[kVecs][V];
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.0f;
  int parity = 0;
  for (int base = begin; base < end; base += kGroups) {
    const int row = base + threadIdx.x / kRowThreads;
    const bool on = row < end;
    uint4 rx[kVecs], rg[kVecs], rd[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int at = (t + i * kRowThreads) * V;
      if (!on || at >= D) continue;
      rx[i] = *reinterpret_cast<const uint4*>(x + row * x_stride + at);
      rd[i] = *reinterpret_cast<const uint4*>(dout + row * dout_stride + at);
      if constexpr (kGated) rg[i] = *reinterpret_cast<const uint4*>(g + row * g_stride + at);
    }
    // grouped: r and c of each vector's group
    float r = 0.0f, dot = 0.0f, rv[kVecs], dotv[kVecs], cv[kVecs];
    if constexpr (!kGrouped) r = on ? rstd[row] : 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int at = (t + i * kRowThreads) * V;
      if constexpr (kGrouped) {
        rv[i] = on && at < D ? rstd[static_cast<long long>(row) * (D / group) + at / group] : 0.0f;
        dotv[i] = 0.0f;
        r = rv[i];
      }
      if (!on || at >= D) continue;
      float xv[V], dv[V], w[V];
      unpack(rx[i], xv);
      unpack(rd[i], dv);
      load_weight(weight + at, w);
      if constexpr (kGated) {
        float gv[V];
        unpack(rg[i], gv);
#pragma unroll
        for (int j = 0; j < V; ++j) xv[j] *= gv[j] * sigmoid(gv[j]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = xv[j] * r;
        if constexpr (kGrouped)
          dotv[i] += dv[j] * w[j] * xh;
        else
          dot += dv[j] * w[j] * xh;
        acc[i][j] += dv[j] * xh;
      }
    }
    float c = 0.0f;
    if constexpr (kGrouped) {
      group_sums<kVecs>(dotv, cv, red, parity, group / V / 32);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) cv[i] /= static_cast<float>(group);
    } else {
      c = row_sum(dot, red, parity) / static_cast<float>(D);
    }
    parity ^= 1;
    if (!on) continue;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int at = (t + i * kRowThreads) * V;
      if (at >= D) continue;
      if constexpr (kGrouped) {
        r = rv[i];
        c = cv[i];
      }
      float xv[V], dv[V], w[V];
      unpack(rx[i], xv);
      unpack(rd[i], dv);
      load_weight(weight + at, w);
      const long long o = static_cast<long long>(row) * D + at;
      if constexpr (kGated) {
        float gv[V], dgv[V];
        unpack(rg[i], gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float s = sigmoid(gv[j]), silu = gv[j] * s;
          const float du = r * (dv[j] * w[j] - xv[j] * silu * r * c);
          dgv[j] = du * xv[j] * s * (1.0f + gv[j] * (1.0f - s));
          dv[j] = du * silu;
        }
        *reinterpret_cast<uint4*>(dg + o) = pack(dgv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dv[j] = r * (dv[j] * w[j] - xv[j] * r * c);
      }
      *reinterpret_cast<uint4*>(dx + o) = pack(dv);
    }
  }
  // the block's two row groups hold partials of the same columns: group 1's
  // go through shared memory into group 0's, so the block writes one row
  static_assert(kGroups == 2, "the partials' merge below takes two row groups");
  __shared__ float group_sum[kRowThreads * kVecs * V];
  if (threadIdx.x >= kRowThreads) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) group_sum[(t + i * kRowThreads) * V + j] = acc[i][j];
  }
  __syncthreads();
  if (threadIdx.x >= kRowThreads) return;
  float* p = partial + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int at = (t + i * kRowThreads) * V;
    if (at >= D) continue;
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + at + j) =
          make_float4(acc[i][j] + group_sum[at + j], acc[i][j + 1] + group_sum[at + j + 1],
                      acc[i][j + 2] + group_sum[at + j + 2], acc[i][j + 3] + group_sum[at + j + 3]);
  }
}

// dw[c] = the sum of partial[0..parts)[c] in a fixed order: a block takes
// 32 columns, warp k the partials k, k + kSumWarps, ..., then warp 0 adds
// the warps' sums in order
__global__ void __launch_bounds__(kSumWarps * 32)
    rms_norm_dw_sum_kernel(const float* __restrict__ partial, int parts, int D,
                           float* __restrict__ dw) {
  __shared__ float s[kSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.0f;
  if (c < D) {
#pragma unroll 8
    for (int p = warp; p < parts; p += kSumWarps) a += partial[static_cast<long long>(p) * D + c];
  }
  s[warp][lane] = a;
  __syncthreads();
  if (warp != 0 || c >= D) return;
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < kSumWarps; ++k) total += s[k][lane];
  dw[c] = total;
}

enum Dtype { kBf16 = 0, kFloat32 = 1 };

int elements(int dtype) { return dtype == kBf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n; }

// 16-byte vectors a thread a row (1, 2, 4 or 8), or 0 where the kernels do
// not take the shape
int vecs_of(int dtype, int R, int D) {
  if (dtype != kBf16 && dtype != kFloat32) return 0;
  if (R < 1 || D < 8 || D % 8) return 0;
  const int need = (D / elements(dtype) + kRowThreads - 1) / kRowThreads;
  for (int v = 1; v <= kMaxVecs; v *= 2)
    if (v >= need) return v;
  return 0;
}

// rows a block of the backward takes: a multiple of kGroups, so that at
// most kMaxPartials blocks cover the R rows
int rows_per_block(int R) {
  int per = (R + kMaxPartials - 1) / kMaxPartials;
  per = (per + kGroups - 1) / kGroups * kGroups;
  return per;
}

int parts_of(int R) {
  const int per = rows_per_block(R);
  return (R + per - 1) / per;
}

// 1 where `group` columns divide a row of D into whole warps' vectors of
// `dtype` (or group == D: one group, the plain row), else 0
int group_ok(int dtype, int D, int group) {
  if (group == D) return 1;
  return group > 0 && D % group == 0 && group % (32 * elements(dtype)) == 0;
}

template <typename T, int kVecs, bool kGated, bool kGrouped>
int forward(const void* x, long long xs, const void* g, long long gs, const float* w, int R,
            int D, int group, float eps, void* out, float* rstd, cudaStream_t stream) {
  const int blocks = (R + kGroups - 1) / kGroups;
  rms_norm_fwd_kernel<T, kVecs, kGated, kGrouped><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), xs, static_cast<const T*>(g), gs, w, R, D, group, eps,
      static_cast<T*>(out), rstd);
  return cudaGetLastError();
}

template <typename T, int kVecs, bool kGated, bool kGrouped>
int backward(const void* x, long long xs, const void* g, long long gs, const void* dout,
             long long ds, const float* w, const float* rstd, int R, int D, int group, void* dx,
             void* dg, float* partial, float* dw, cudaStream_t stream) {
  const int per = rows_per_block(R), parts = parts_of(R);
  rms_norm_bwd_kernel<T, kVecs, kGated, kGrouped><<<parts, kThreads, 0, stream>>>(
      static_cast<const T*>(x), xs, static_cast<const T*>(g), gs, static_cast<const T*>(dout),
      ds, w, rstd, R, D, group, per, static_cast<T*>(dx), static_cast<T*>(dg), partial);
  if (cudaError_t e = cudaGetLastError()) return e;
  rms_norm_dw_sum_kernel<<<(D + 31) / 32, kSumWarps * 32, 0, stream>>>(partial, parts, D, dw);
  return cudaGetLastError();
}

// the instantiation for (dtype, vecs, gated, grouped)
template <typename T, bool kGated, bool kGrouped>
int forward_of(int vecs, const void* x, long long xs, const void* g, long long gs,
               const float* w, int R, int D, int group, float eps, void* out, float* rstd,
               cudaStream_t s) {
  switch (vecs) {
    case 1: return forward<T, 1, kGated, kGrouped>(x, xs, g, gs, w, R, D, group, eps, out, rstd, s);
    case 2: return forward<T, 2, kGated, kGrouped>(x, xs, g, gs, w, R, D, group, eps, out, rstd, s);
    case 4: return forward<T, 4, kGated, kGrouped>(x, xs, g, gs, w, R, D, group, eps, out, rstd, s);
    default:
      return forward<T, 8, kGated, kGrouped>(x, xs, g, gs, w, R, D, group, eps, out, rstd, s);
  }
}

template <typename T, bool kGated, bool kGrouped>
int backward_of(int vecs, const void* x, long long xs, const void* g, long long gs,
                const void* dout, long long ds, const float* w, const float* rstd, int R, int D,
                int group, void* dx, void* dg, float* partial, float* dw, cudaStream_t s) {
  switch (vecs) {
    case 1:
      return backward<T, 1, kGated, kGrouped>(x, xs, g, gs, dout, ds, w, rstd, R, D, group, dx,
                                              dg, partial, dw, s);
    case 2:
      return backward<T, 2, kGated, kGrouped>(x, xs, g, gs, dout, ds, w, rstd, R, D, group, dx,
                                              dg, partial, dw, s);
    case 4:
      return backward<T, 4, kGated, kGrouped>(x, xs, g, gs, dout, ds, w, rstd, R, D, group, dx,
                                              dg, partial, dw, s);
    default:
      return backward<T, 8, kGated, kGrouped>(x, xs, g, gs, dout, ds, w, rstd, R, D, group, dx,
                                              dg, partial, dw, s);
  }
}

// the instantiation for dtype and kind: plain, gated, or gated over groups
template <typename T>
int forward_kind(int vecs, const void* x, long long xs, const void* g, long long gs,
                 const float* w, int R, int D, int group, float eps, void* out, float* rstd,
                 cudaStream_t s) {
  if (!g) return forward_of<T, false, false>(vecs, x, xs, g, gs, w, R, D, D, eps, out, rstd, s);
  if (group == D)
    return forward_of<T, true, false>(vecs, x, xs, g, gs, w, R, D, D, eps, out, rstd, s);
  return forward_of<T, true, true>(vecs, x, xs, g, gs, w, R, D, group, eps, out, rstd, s);
}

template <typename T>
int backward_kind(int vecs, const void* x, long long xs, const void* g, long long gs,
                  const void* dout, long long ds, const float* w, const float* rstd, int R, int D,
                  int group, void* dx, void* dg, float* partial, float* dw, cudaStream_t s) {
  if (!g)
    return backward_of<T, false, false>(vecs, x, xs, g, gs, dout, ds, w, rstd, R, D, D, dx, dg,
                                        partial, dw, s);
  if (group == D)
    return backward_of<T, true, false>(vecs, x, xs, g, gs, dout, ds, w, rstd, R, D, D, dx, dg,
                                       partial, dw, s);
  return backward_of<T, true, true>(vecs, x, xs, g, gs, dout, ds, w, rstd, R, D, group, dx, dg,
                                    partial, dw, s);
}

}  // namespace

extern "C" {

// Rows of the backward's dw partials for R rows of width D in `dtype` (0:
// bf16, 1: float32): `partial` holds this many times D floats.  0 where the
// kernels refuse the shape.
int hh_rmsnorm_parts(int dtype, int R, int D) {
  return vecs_of(dtype, R, D) ? parts_of(R) : 0;
}

// 1 where the kernels take groups of `group` columns in rows of D of
// `dtype` (group == D: the whole row), else 0.
int hh_rmsnorm_group_ok(int dtype, int D, int group) {
  return vecs_of(dtype, 1, D) && group_ok(dtype, D, group);
}

// The forward on `stream` over R rows of D: x's row i at x + i * x_stride
// elements, the gate's (null: plain) at g + i * g_stride; out (R, D)
// contiguous, rstd R * (D / group) floats.  A group narrower than the row
// takes a gate.  Returns cudaGetLastError() of its one launch, or
// cudaErrorInvalidValue for a refused shape.
int hh_rmsnorm_forward(const void* x, long long x_stride, const void* g, long long g_stride,
                       int dtype, int R, int D, int group, const float* weight, float eps,
                       void* out, float* rstd, void* stream) {
  const int vecs = vecs_of(dtype, R, D);
  if (!vecs || !group_ok(dtype, D, group) || (group != D && !g)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBf16)
    return forward_kind<__nv_bfloat16>(vecs, x, x_stride, g, g_stride, weight, R, D, group, eps,
                                       out, rstd, s);
  return forward_kind<float>(vecs, x, x_stride, g, g_stride, weight, R, D, group, eps, out, rstd,
                             s);
}

// The backward on `stream` from the forward's x, g (null: plain) and rstd
// and the output's gradient dout (row stride dout_stride): dx and, gated,
// dg, (R, D) contiguous in x's dtype, and dw (D floats), through `partial`
// (hh_rmsnorm_parts rows of D floats).  Returns cudaGetLastError() of the
// last of its 2 launches, or cudaErrorInvalidValue for a refused shape.
int hh_rmsnorm_backward(const void* x, long long x_stride, const void* g, long long g_stride,
                        const void* dout, long long dout_stride, int dtype, int R, int D,
                        int group, const float* weight, const float* rstd, void* dx, void* dg,
                        float* partial, float* dw, void* stream) {
  const int vecs = vecs_of(dtype, R, D);
  if (!vecs || (g != nullptr) != (dg != nullptr) || !group_ok(dtype, D, group) ||
      (group != D && !g))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBf16)
    return backward_kind<__nv_bfloat16>(vecs, x, x_stride, g, g_stride, dout, dout_stride, weight,
                                        rstd, R, D, group, dx, dg, partial, dw, s);
  return backward_kind<float>(vecs, x, x_stride, g, g_stride, dout, dout_stride, weight, rstd, R,
                              D, group, dx, dg, partial, dw, s);
}

const char* hh_rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
