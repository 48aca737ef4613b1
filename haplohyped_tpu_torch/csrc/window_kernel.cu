// Variant-aware haplotype window encode for Hopper (sm_90a).
//
// Replaces the TPU kernel haplohyped_tpu/ops/pallas_window.py::_window_kernel
// (launched by encode_windows_pallas), and computes in one launch the whole
// contract of that wrapper, including the row/offset/count lookups and the
// coarse search that the JAX wrapper does outside its kernel.  Output is
// bit-equal to the plain PyTorch version,
// haplohyped_tpu_torch/ops/haplotype_window.py::encode_haplotype_windows.
//
// Per window b (one block of kThreads threads):
//   row   = donor[b] * C + chrom[b]
//   flat  = clamp(offsets[chrom] + start, 0, G - L)       (64-bit address)
//   lo/hi = number of positions < start / < start + L in the row
//   n_in  = max(min(hi, count) - min(lo, count), 0)
//   the first min(n_in, K) variants from lo overwrite byte pos - start with
//   sub1 (hap1) and sub2 (hap2); the last variant wins on duplicates
//   overflow = max(n_in - K, 0)
//
// What bounds it on this card.  The bytes are few: L genome bytes, a few KB
// of searches, 6 bytes per applied variant and 2L + 8 output bytes per
// window; at B=64, L=1000 that is about 0.2 MB, some 60 ns at 3.35 TB/s.
// The time goes to latency: a window needs a chain of dependent loads
// (indices -> row count and coarse grid -> position chunk -> applied
// variants), each a trip to device memory.
//
// What the design does about it.  The search is two levels, each one round
// of loads that all threads of the block issue together: the block counts
// over the coarse grid pos[row, ::SP] (contiguous, a few KB), then over one
// SP-long chunk of positions.  The lo and hi searches share both rounds.
// The genome window is read straight into registers, independently of the
// search.  The <= K applied variants are staged in shared memory; each
// thread owns output bytes j and walks k = 0..n_apply-1 in order, keeping
// the last match: last-wins with no atomics and no scatter.  Unapplied lanes
// are never read (the loop stops at n_apply).  One block per window takes
// any B with no tail case.  Making it fast (several windows per block, async
// copies that overlap the chains of many windows) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums two per-thread counts over the block; every thread gets both sums.
__device__ __forceinline__ int2 block_sum2(int a, int b, int2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still be reading scratch
  if ((threadIdx.x & 31) == 0) scratch[warp] = make_int2(a, b);
  __syncthreads();
  int2 t = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    t.x += scratch[w].x;
    t.y += scratch[w].y;
  }
  return t;
}

__global__ void __launch_bounds__(kThreads) window_kernel(
    const int8_t* __restrict__ genome, long long G,
    const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ pos,      // (D*C, V)
    const int16_t* __restrict__ sub12,    // (D*C, V): sub1 | sub2 << 8
    const int32_t* __restrict__ grid,     // (D*C, Vg): pos[:, ::SP]
    const int32_t* __restrict__ counts,   // (D*C,)
    int D, int C, int V, int Vg, int SP,
    const int32_t* __restrict__ donor, const int32_t* __restrict__ chrom,
    const int32_t* __restrict__ start, int L, int K,
    int8_t* __restrict__ hap1, int8_t* __restrict__ hap2,
    int32_t* __restrict__ n_variants, int32_t* __restrict__ overflow) {
  __shared__ int2 red[kThreads / 32];
  __shared__ int s_rel[kMaxK];
  __shared__ int8_t s_sub1[kMaxK];
  __shared__ int8_t s_sub2[kMaxK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // out-of-range indices clamp, as the plain version (and a JAX gather) does
  const int d = min(max(donor[b], 0), D - 1);
  const int c = min(max(chrom[b], 0), C - 1);
  const int s = start[b];
  const long long row = (long long)d * C + c;
  const int count = counts[row];
  long long flat = (long long)offsets[c] + s;
  flat = min(max(flat, 0LL), G - L);
  const long long s_end = (long long)s + L;

  // level 1: buckets of the coarse grid below s and below s + L
  const int32_t* grow = grid + row * Vg;
  int blo = 0, bhi = 0;
  for (int j = tid; j < Vg; j += kThreads) {
    const int g = grow[j];
    blo += g < s;
    bhi += g < s_end;
  }
  const int2 bk = block_sum2(blo, bhi, red);
  // every position before lo0 is < s, and every one from lo0 + SP on is
  // >= s (rows are sorted); the same holds for hi0 and s + L
  const long long lo0 = (long long)max(bk.x - 1, 0) * SP;
  const long long hi0 = (long long)max(bk.y - 1, 0) * SP;

  // level 2: count inside one chunk of SP positions each
  const int32_t* prow = pos + row * V;
  int clo = 0, chi = 0;
  for (int j = tid; j < SP; j += kThreads) {
    if (lo0 + j < V) clo += prow[lo0 + j] < s;
    if (hi0 + j < V) chi += prow[hi0 + j] < s_end;
  }
  const int2 cc = block_sum2(clo, chi, red);
  const long long lo = lo0 + cc.x;
  const long long hi = hi0 + cc.y;
  const int n_in = (int)max(min(hi, (long long)count) - min(lo, (long long)count), 0LL);
  const int n_apply = min(n_in, K);

  // stage the applied variants: lo + k < min(hi, count) <= V for k < n_apply
  if (tid < n_apply) {
    s_rel[tid] = prow[lo + tid] - s;
    const int v = sub12[row * V + lo + tid];
    s_sub1[tid] = (int8_t)(v & 0xFF);
    s_sub2[tid] = (int8_t)((v >> 8) & 0xFF);
  }
  __syncthreads();

  const int8_t* win = genome + flat;
  int8_t* out1 = hap1 + (long long)b * L;
  int8_t* out2 = hap2 + (long long)b * L;
  for (int j = tid; j < L; j += kThreads) {
    int8_t h1 = win[j];
    int8_t h2 = h1;
    for (int k = 0; k < n_apply; ++k) {
      if (s_rel[k] == j) {  // in order: the last matching variant wins
        h1 = s_sub1[k];
        h2 = s_sub2[k];
      }
    }
    out1[j] = h1;
    out2[j] = h2;
  }
  if (tid == 0) {
    n_variants[b] = n_in;
    overflow[b] = max(n_in - K, 0);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for B windows; returns cudaGetLastError().
int hh_window_encode(const int8_t* genome, long long G, const int32_t* offsets,
                     const int32_t* pos, const int16_t* sub12,
                     const int32_t* grid, const int32_t* counts, int D, int C,
                     int V, int Vg, int SP, const int32_t* donor,
                     const int32_t* chrom, const int32_t* start, int B, int L,
                     int K, int8_t* hap1, int8_t* hap2, int32_t* n_variants,
                     int32_t* overflow, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK || L < 1 || G < L) return (int)cudaErrorInvalidValue;
  window_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      genome, G, offsets, pos, sub12, grid, counts, D, C, V, Vg, SP, donor,
      chrom, start, L, K, hap1, hap2, n_variants, overflow);
  return (int)cudaGetLastError();
}

const char* hh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
