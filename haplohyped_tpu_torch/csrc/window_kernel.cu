// Variant-aware haplotype window encode for Hopper (sm_90a).
//
// Replaces the TPU kernel haplohyped_tpu/ops/pallas_window.py::_window_kernel
// (launched by encode_windows_pallas), and computes in one launch the whole
// contract of that wrapper, including the row/offset/count lookups and the
// search that the JAX wrapper does outside its kernel.  Output is bit-equal
// to the plain PyTorch version,
// haplohyped_tpu_torch/ops/haplotype_window.py::encode_haplotype_windows.
//
// Per window b (one block of kThreads threads, or one a part of a long window):
//   row   = donor[b] * C + chrom[b]
//   flat  = clamp(offsets[chrom] + start, 0, G - L)       (64-bit address)
//   lo/hi = number of positions < start / < start + L in the row
//   n_in  = max(min(hi, count) - min(lo, count), 0)
//   the first min(n_in, K) variants from lo overwrite byte pos - start with
//   sub1 (hap1) and sub2 (hap2); the last variant wins on duplicates
//   overflow = max(n_in - K, 0)
//
// What bounds it on this card.  The bytes are few: L genome bytes, a few
// dozen bytes of search, 6 bytes per applied variant and 2L + 8 output bytes
// per window; at B=64, L=1000 about 0.2 MB, some 60 ns at 3.35 TB/s.  The
// time goes to latency: every dependent trip to device memory costs about a
// microsecond, and a window's loads form a chain.
//
// What the design does about it.  Three dependent trips, each a round of
// independent loads in flight together, then the stores:
//   1. donor, chrom, start;
//   2. counts[row], offsets[chrom], and two entries of the row's bucket table
//      first[row, j] = #{pos < j << kBK}: j = start >> kBK and
//      j = ((start + L - 1) >> kBK) + 1.  Every position before the first
//      entry is < start and every one from the second on is >= start + L
//      (rows are sorted), so the slice between them holds every applied
//      variant and what lo and hi need to be counted.  No coarse grid is
//      read.  Buckets past the table clamp: the slice then runs to the
//      row's count;
//   3. the genome window, copied with cp.async (16 bytes a thread, a
//      16-byte-aligned superset of the window, one copy a plane) into two
//      shared planes, hap1's and hap2's, issued first; then the slice's
//      positions and codes, one entry a thread, into registers.
// lo and hi come from one block reduction over the slice.  Substitution is
// a scatter: the thread holding applied variant k writes its codes at byte
// pos - start of the planes if it is the last applied variant at that
// position (k + 1 == n_apply or the next position differs), so sorted order
// gives last-wins with one writer a byte and no atomics.  Rows are stored
// from the planes with 16-byte vector stores; the ragged head and tail of a
// row go byte by byte.  A slice longer than the block (dense rows) is
// counted in strides of kThreads and its applied variants are loaded again
// after the count, in strides of kThreads too: a thread holds applied
// variants tid, tid + kThreads, ... (kPer of them, a template parameter: 1
// for one part with K <= kThreads, else kMaxK / kThreads).  A window longer
// than kTile bytes is staged and stored in tiles, kPartTiles of them a
// block: a window longer than that is cut into parts of kPartTiles * kTile
// bytes, one block each (kSplit, a template parameter), so its tiles go in
// parallel instead of one after another; every part makes the same search,
// and part 0 writes the counts.  A window of one part with K <= kThreads
// (kPer 1, no kSplit) runs the code the kernel had before either; every
// other window runs kPer = kMaxK / kThreads with kSplit.  All of it stays
// correct for any input.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using namespace hh_window;

// tiles of kTile bytes one block stages and stores: a window's part
constexpr int kPartTiles = 4;
constexpr int kPartBytes = kPartTiles * kTile;
static_assert(kMaxK % kThreads == 0, "a thread holds kMaxK / kThreads applied variants");

template <int kPer, bool kSplit>
__global__ void __launch_bounds__(kThreads) window_kernel(
    const int8_t* __restrict__ genome, long long G,
    const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ pos,      // (D*C, V)
    const int16_t* __restrict__ sub12,    // (D*C, V): sub1 | sub2 << 8
    const int32_t* __restrict__ first,    // (D*C, NB1): #{pos < j << kBK}
    const int32_t* __restrict__ counts,   // (D*C,)
    int D, int C, int V, int NB1,
    const int32_t* __restrict__ donor, const int32_t* __restrict__ chrom,
    const int32_t* __restrict__ start, int L, int K, int parts,
    int8_t* __restrict__ hap1, int8_t* __restrict__ hap2,
    int32_t* __restrict__ n_variants, int32_t* __restrict__ overflow) {
  __shared__ __align__(16) int8_t planes[2][kPlane];
  int8_t* const pl0 = &planes[0][0];
  __shared__ int2 red[kThreads / 32];

  // a window a block, or (kSplit) a part of a window: its bytes [t_lo, t_hi)
  const int b = kSplit ? blockIdx.x / parts : blockIdx.x;
  const int part = kSplit ? blockIdx.x - b * parts : 0;
  const int t_lo = kSplit ? part * kPartBytes : 0;
  const int t_hi = kSplit ? min(L, t_lo + kPartBytes) : L;
  const int tid = threadIdx.x;

  // trip 1: the window's indices; out-of-range indices clamp, as the plain
  // version (and a JAX gather) does
  const int d = min(max(donor[b], 0), D - 1);
  const int c = min(max(chrom[b], 0), C - 1);
  const int s = start[b];
  const long long row = (long long)d * C + c;
  const long long s_end = (long long)s + L;
  const int nb = NB1 - 1;
  const int ja = min(max(s, 0) >> kBK, nb);
  const long long je = max(((s_end - 1) >> kBK) + 1, 0LL);

  // trip 2: four independent loads
  const int32_t* frow = first + row * NB1;
  const int count = counts[row];
  const int off = offsets[c];
  const int fa = frow[ja];
  const int fe = je <= nb ? frow[je] : INT_MAX;

  // the slice [a, e) of the row: entries before a are < s (a negative start
  // has none before it), entries from e to the count are >= s + L
  const int cnt = min(max(count, 0), V);
  const int a = s < 0 ? 0 : min(fa, cnt);
  const int e = max(a, min(fe, cnt));
  long long flat = (long long)off + s;
  flat = min(max(flat, 0LL), G - L);

  // trip 3: the genome window's copy first, then the slice, in flight together
  int head = stage_tile<kThreads>(pl0, kPlane, genome, G, flat + t_lo, min(t_hi - t_lo, kTile),
                                  tid);
  const int32_t* prow = pos + row * V;
  const int16_t* srow = sub12 + row * V;
  const int n = e - a;
  const bool mine = tid < n;
  int p = 0, pn = 0, v = 0;
  if (mine) {
    p = prow[a + tid];
    v = srow[a + tid];
    if (tid + 1 < n) pn = prow[a + tid + 1];
  }
  int clo = mine && p < s;
  int chi = mine && p < s_end;
  for (int k = tid + kThreads; k < n; k += kThreads) {  // dense rows: the rest of the slice
    const int q = prow[a + k];
    clo += q < s;
    chi += q < s_end;
  }

  // lo and hi in one block reduction; the barrier also publishes the planes
  clo = warp_sum(clo);
  chi = warp_sum(chi);
  if ((tid & 31) == 0) red[tid >> 5] = make_int2(clo, chi);
  cp_async_wait_all();
  __syncthreads();
  int2 t = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  // lo and hi here are already min(., count)
  const int lo = a + t.x;
  const int hi = a + t.y;
  const int n_in = max(hi - lo, 0);
  const int n_apply = min(n_in, K);

  // this thread's applied variants: from the slice it holds, or, for a dense
  // row, loaded again, i = tid + j kThreads for j < kPer (n_apply <= K <=
  // kPer kThreads); the last applied variant at its position writes, at
  // rel = p - s in [0, L), and -1 marks none
  int rel[kPer], val[kPer];
  if (n > kThreads) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      const bool has = i < n_apply;
      int q = 0, qn = 0, u = 0;
      if (has) {
        q = prow[lo + i];
        u = srow[lo + i];
        if (i + 1 < n_apply) qn = prow[lo + i + 1];
      }
      rel[j] = has && (i + 1 == n_apply || qn != q) ? q - s : -1;
      val[j] = u;
    }
  } else {
    const int i = a + tid - lo;
    const bool has = mine && i >= 0 && i < n_apply;
    rel[0] = has && (i + 1 == n_apply || pn != p) ? p - s : -1;
    val[0] = v;
#pragma unroll
    for (int j = 1; j < kPer; ++j) rel[j] = -1;
  }

  int8_t* out1 = hap1 + (long long)b * L;
  int8_t* out2 = hap2 + (long long)b * L;
  for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
    const int len = min(kTile, t_hi - t0);
    if (t0 > t_lo) {
      __syncthreads();  // the last tile's stores are done with the planes
      head = stage_tile<kThreads>(pl0, kPlane, genome, G, flat + t0, len, tid);
      cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (rel[j] >= t0 && rel[j] - t0 < len) {
        planes[0][head + rel[j] - t0] = static_cast<int8_t>(val[j] & 0xFF);
        planes[1][head + rel[j] - t0] = static_cast<int8_t>(val[j] >> 8);
      }
    }
    __syncthreads();
    store_tile<kThreads>(pl0, kPlane, head, out1 + t0, out2 + t0, len, tid);
  }
  if (tid == 0 && part == 0) {
    n_variants[b] = n_in;
    overflow[b] = max(n_in - K, 0);
  }
}

}  // namespace

extern "C" {

// The bucket width the kernel searches with, log2 in bp; the wrapper holds
// the table it is given to it.
int hh_window_bucket_bits() { return kBK; }

// Launches the kernel on `stream` for B windows; returns cudaGetLastError().
int hh_window_encode(const int8_t* genome, long long G, const int32_t* offsets,
                     const int32_t* pos, const int16_t* sub12,
                     const int32_t* first, const int32_t* counts, int D, int C,
                     int V, int NB1, const int32_t* donor, const int32_t* chrom,
                     const int32_t* start, int B, int L, int K, int8_t* hap1,
                     int8_t* hap2, int32_t* n_variants, int32_t* overflow,
                     void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK || L < 1 || G < L || NB1 < 1) return (int)cudaErrorInvalidValue;
  const int parts = (L + kPartBytes - 1) / kPartBytes;
  if ((long long)B * parts > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // a short window with K <= kThreads runs the kernel's one-part, one-variant
  // code; any other, kPer applied variants a thread over parts
  const auto kernel = K <= kThreads && parts == 1 ? &window_kernel<1, false>
                                                  : &window_kernel<kMaxK / kThreads, true>;
  kernel<<<B * parts, kThreads, 0, st>>>(genome, G, offsets, pos, sub12, first, counts, D, C, V,
                                         NB1, donor, chrom, start, L, K, parts, hap1, hap2,
                                         n_variants, overflow);
  return (int)cudaGetLastError();
}

const char* hh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
