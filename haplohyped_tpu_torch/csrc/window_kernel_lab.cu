// The window-kernel lab for Hopper (sm_90a): the window encode of
// csrc/window_kernel.cu with its load and compute legs switchable.
//
// Replaces the TPU kernel tools/window_kernel_lab.py::lab_kernel_variant
// (launched by make_variant_call): the Pallas window kernel's clone whose DMA
// and compute legs can be switched off one at a time, to split that kernel's
// time between them.  csrc/window_kernel.cu itself stays as it is.  Each
// variant is bit-equal to its plain PyTorch version in
// haplohyped_tpu_torch/ops/window_lab.py.
//
// Every variant runs the production kernel's dependency chain where it loads:
//   indices -> count, offset and coarse grid -> one SP chunk of positions
//   -> the applied variants -> the genome window.
// - kFull: that chain and the last-wins substitution: the encode itself
//   (sink = 0).
// - kDmaOnly: every load and both block counts, no substitution.  It writes
//   the genome window read from an SP-word-aligned base (the bytes the JAX
//   lab's DMA-only variant returns), n_variants = pos[row, lo0], overflow =
//   sub12[row, lo0], and sink = the XOR of pos ^ sub12 over the applied
//   variants, so that no load of the chain is dead code.
// - kComputeOnly: loads only donor[b], chrom[b], start[b], offsets[c] and
//   counts[row] (the JAX lab's scalar prefetch).  Every other value is
//   computed in registers where kFull loads it, from a synthetic state:
//   genome byte x is x & 3; variant i < count sits at i * kSynthStride and
//   INT32_MAX past it; sub1 = i & 3, sub2 = (i >> 2) & 3.  The same two-level
//   count, staging and substitution then run (sink = 0).
//
// w windows share one block of 256 threads (w in {1, 2, 4, 8, 16, 32}), each
// window a group of 256 / w threads.  A sum over a group is a warp shuffle
// (of width 256 / w below a warp) and, above a warp, a pass through shared
// memory.  Staging in shared memory is per window.  The last block masks the
// windows >= B: their threads load nothing but reach every barrier.  No
// output depends on w.
//
// What bounds it on this card.  As for csrc/window_kernel.cu, latency, not
// bytes: a window moves about 3 KB, but through a chain of dependent trips to
// device memory.  The lab times the chain without the substitution
// (kDmaOnly) and the substitution without the chain (kComputeOnly), and what
// several windows per block buy, for the kernel's redesign.  It is one
// simple kernel; it is not tuned.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;
constexpr int kMaxW = 32;
// compute_only: bp between synthetic variants (~1.2 SNVs per kb, as a
// human genome against the reference)
constexpr int kSynthStride = 833;

enum Variant : int { kFull = 0, kDmaOnly = 1, kComputeOnly = 2 };

struct Add {
  __device__ static int f(int a, int b) { return a + b; }
};
struct Xor {
  __device__ static int f(int a, int b) { return a ^ b; }
};

// Reduces a and b over each group of gs threads (gs = kThreads / w, a power
// of two); every thread of the group gets both results.  Every thread of the
// block calls it: for gs > 32 it holds two block barriers.
template <class Op>
__device__ __forceinline__ int2 group_reduce2(int a, int b, int gs, int2* scratch) {
  const int width = gs < 32 ? gs : 32;
  for (int o = width >> 1; o > 0; o >>= 1) {
    a = Op::f(a, __shfl_xor_sync(0xffffffffu, a, o, width));
    b = Op::f(b, __shfl_xor_sync(0xffffffffu, b, o, width));
  }
  if (gs <= 32) return make_int2(a, b);
  __syncthreads();  // an earlier call may still be reading scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  const int per = gs >> 5;
  const int first = (threadIdx.x / gs) * per;
  int2 t = scratch[first];
  for (int i = 1; i < per; ++i) {
    t.x = Op::f(t.x, scratch[first + i].x);
    t.y = Op::f(t.y, scratch[first + i].y);
  }
  return t;
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads) lab_kernel(
    const int8_t* __restrict__ genome, long long G,
    const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ pos,      // (D*C, V)
    const int16_t* __restrict__ sub12,    // (D*C, V): sub1 | sub2 << 8
    const int32_t* __restrict__ grid,     // (D*C, Vg): pos[:, ::SP]
    const int32_t* __restrict__ counts,   // (D*C,)
    int D, int C, int V, int Vg, int SP,
    const int32_t* __restrict__ donor, const int32_t* __restrict__ chrom,
    const int32_t* __restrict__ start, int B, int L, int K, int w,
    int8_t* __restrict__ hap1, int8_t* __restrict__ hap2,
    int32_t* __restrict__ n_variants, int32_t* __restrict__ overflow,
    int32_t* __restrict__ sink) {
  __shared__ int2 red[kThreads / 32];
  __shared__ int s_rel[kMaxW * kMaxK];
  __shared__ int8_t s_sub1[kMaxW * kMaxK];
  __shared__ int8_t s_sub2[kMaxW * kMaxK];

  const int gs = kThreads / w;  // threads per window
  const int slot = threadIdx.x / gs;
  const int lane = threadIdx.x - slot * gs;
  const long long b = (long long)blockIdx.x * w + slot;
  const bool active = b < B;
  int* rel = s_rel + slot * kMaxK;
  int8_t* sub1 = s_sub1 + slot * kMaxK;
  int8_t* sub2 = s_sub2 + slot * kMaxK;

  // the scalars (out-of-range indices clamp, as in the plain version)
  int s = 0, count = 0;
  long long row = 0, flat = 0;
  if (active) {
    const int d = min(max(donor[b], 0), D - 1);
    const int c = min(max(chrom[b], 0), C - 1);
    s = start[b];
    row = (long long)d * C + c;
    count = counts[row];
    flat = min(max((long long)offsets[c] + s, 0LL), G - L);
  }
  const long long s_end = (long long)s + L;
  const int32_t* prow = pos + row * V;
  const int16_t* srow = sub12 + row * V;
  // position i < V of the row: loaded, or computed (i * kSynthStride < 2^31,
  // which the wrapper checks for every i < V)
  auto pos_at = [&](long long i) -> int {
    if (kVariant == kComputeOnly) return i < count ? (int)i * kSynthStride : INT_MAX;
    return prow[i];
  };

  // level 1: buckets of the coarse grid below s and below s + L
  int blo = 0, bhi = 0;
  for (int j = lane; j < (active ? Vg : 0); j += gs) {
    const int g = kVariant == kComputeOnly ? pos_at((long long)j * SP) : grid[row * Vg + j];
    blo += g < s;
    bhi += g < s_end;
  }
  const int2 bk = group_reduce2<Add>(blo, bhi, gs, red);
  const long long lo0 = (long long)max(bk.x - 1, 0) * SP;
  const long long hi0 = (long long)max(bk.y - 1, 0) * SP;

  // level 2: count inside one chunk of SP positions each
  int clo = 0, chi = 0;
  for (int j = lane; j < (active ? SP : 0); j += gs) {
    if (lo0 + j < V) clo += pos_at(lo0 + j) < s;
    if (hi0 + j < V) chi += pos_at(hi0 + j) < s_end;
  }
  const int2 cc = group_reduce2<Add>(clo, chi, gs, red);
  const long long lo = lo0 + cc.x;
  const long long hi = hi0 + cc.y;
  const int n_in = (int)max(min(hi, (long long)count) - min(lo, (long long)count), 0LL);
  const int n_apply = min(n_in, K);

  // the applied variants: lo + k < min(hi, count) <= V for k < n_apply
  int x = 0;
  for (int k = lane; k < n_apply; k += gs) {
    const long long i = lo + k;
    const int p = pos_at(i);
    const int v = kVariant == kComputeOnly ? (int)((i & 3) | (((i >> 2) & 3) << 8))
                                           : (int)srow[i];
    if (kVariant == kDmaOnly) {
      x ^= p ^ v;
    } else {
      rel[k] = p - s;
      sub1[k] = (int8_t)(v & 0xFF);
      sub2[k] = (int8_t)((v >> 8) & 0xFF);
    }
  }
  const int sk = kVariant == kDmaOnly ? group_reduce2<Xor>(x, 0, gs, red).x : 0;
  __syncthreads();  // the staged variants are visible to their group

  const int nl = active ? L : 0;
  int8_t* out1 = hap1 + b * L;
  int8_t* out2 = hap2 + b * L;
  if (kVariant == kDmaOnly) {
    // the window from its SP-word-aligned base, where the DMA put it
    const int8_t* win = genome + ((flat >> 2) / SP * SP * 4 + (flat & 3));
    for (int j = lane; j < nl; j += gs) {
      const int8_t h = win[j];
      out1[j] = h;
      out2[j] = h;
    }
  } else {
    const int8_t* win = genome + flat;
    for (int j = lane; j < nl; j += gs) {
      int8_t h1 = kVariant == kComputeOnly ? (int8_t)((flat + j) & 3) : win[j];
      int8_t h2 = h1;
      for (int k = 0; k < n_apply; ++k) {
        if (rel[k] == j) {  // in order: the last matching variant wins
          h1 = sub1[k];
          h2 = sub2[k];
        }
      }
      out1[j] = h1;
      out2[j] = h2;
    }
  }
  if (active && lane == 0) {
    if (kVariant == kDmaOnly) {
      n_variants[b] = prow[lo0];  // lo0 <= (Vg - 1) * SP < V
      overflow[b] = srow[lo0];
    } else {
      n_variants[b] = n_in;
      overflow[b] = max(n_in - K, 0);
    }
    sink[b] = sk;
  }
}

template <int kVariant>
int launch(const int8_t* genome, long long G, const int32_t* offsets,
           const int32_t* pos, const int16_t* sub12, const int32_t* grid,
           const int32_t* counts, int D, int C, int V, int Vg, int SP,
           const int32_t* donor, const int32_t* chrom, const int32_t* start,
           int B, int L, int K, int w, int8_t* hap1, int8_t* hap2,
           int32_t* n_variants, int32_t* overflow, int32_t* sink,
           cudaStream_t stream) {
  lab_kernel<kVariant><<<(B + w - 1) / w, kThreads, 0, stream>>>(
      genome, G, offsets, pos, sub12, grid, counts, D, C, V, Vg, SP, donor,
      chrom, start, B, L, K, w, hap1, hap2, n_variants, overflow, sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches variant `variant` (0 full, 1 dma_only, 2 compute_only) on
// `stream` for B windows, w a block; returns cudaGetLastError().
int hh_window_lab(int variant, const int8_t* genome, long long G,
                  const int32_t* offsets, const int32_t* pos,
                  const int16_t* sub12, const int32_t* grid,
                  const int32_t* counts, int D, int C, int V, int Vg, int SP,
                  const int32_t* donor, const int32_t* chrom,
                  const int32_t* start, int B, int L, int K, int w,
                  int8_t* hap1, int8_t* hap2, int32_t* n_variants,
                  int32_t* overflow, int32_t* sink, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK || L < 1 || G < L || SP < 1 || w < 1 || w > kMaxW ||
      (w & (w - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case kFull:
      return launch<kFull>(genome, G, offsets, pos, sub12, grid, counts, D, C,
                           V, Vg, SP, donor, chrom, start, B, L, K, w, hap1,
                           hap2, n_variants, overflow, sink, st);
    case kDmaOnly:
      return launch<kDmaOnly>(genome, G, offsets, pos, sub12, grid, counts, D,
                              C, V, Vg, SP, donor, chrom, start, B, L, K, w,
                              hap1, hap2, n_variants, overflow, sink, st);
    case kComputeOnly:
      return launch<kComputeOnly>(genome, G, offsets, pos, sub12, grid, counts,
                                  D, C, V, Vg, SP, donor, chrom, start, B, L,
                                  K, w, hap1, hap2, n_variants, overflow, sink,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hh_lab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
