// The window-kernel lab for Hopper (sm_90a): the window encode of
// csrc/window_kernel.cu with its load and compute legs switchable.
//
// Replaces the TPU kernel tools/window_kernel_lab.py::lab_kernel_variant
// (launched by make_variant_call): the Pallas window kernel's clone whose DMA
// and compute legs can be switched off one at a time, to split that kernel's
// time between them.  Each variant is bit-equal to its plain PyTorch version
// in haplohyped_tpu_torch/ops/window_lab.py.
//
// Each variant is the production kernel with one leg switched off, built from
// its own device code (window_common.cuh: the cp.async staging, the 16-byte
// stores, the reductions, the block and tile sizes).  Per window, as there:
//   1. donor, chrom, start;
//   2. counts[row], offsets[c] and the two bucket-table entries
//      first[row, start >> kBK] and first[row, ((start + L - 1) >> kBK) + 1];
//   3. the genome window by cp.async into two shared planes, issued first,
//      then the slice's positions and codes into registers;
// one reduction over the slice gives lo and hi, a scatter substitution
// applies the variants (the last applied variant at a position is its only
// writer), and 16-byte stores write the rows.
// - kFull: all of it, the encode itself (sink = 0).
// - kDmaOnly: every load of kFull and no scatter.  The window is copied from
//   the SP-word-aligned base 4 * ((flat >> 2) / SP) * SP + (flat & 3), the
//   bytes the JAX lab's DMA-only variant returns (SP a power of two, as the
//   JAX lab's strides are: a mask, not a division, for every thread).  n_variants and overflow
//   are pos and sub12 at lo0 = max(#{pos[row, ::SP] < start} - 1, 0) * SP,
//   with #{pos[row, ::SP] < start} = ceil(lo / SP): rows are sorted over all
//   V entries (INT32_MAX past the count), so the entries below start are the
//   first lo.  lo0 lies between those of a and e, the slice's ends, so trip 3
//   loads pos and sub12 at both; only a slice of more than SP entries needs a
//   load after the count.  sink = the XOR of pos ^ sub12 over the applied
//   variants, so that no load of the chain is dead code (nvcc drops loads
//   that reach no store).
// - kComputeOnly: loads donor, chrom, start, offsets[c] and counts[row] (the
//   JAX lab's scalar prefetch).  Every other value kFull loads is computed
//   in registers from a synthetic state: variant i < count sits at i *
//   kSynthStride, so first[row, j] = min(ceil((j << kBK) / kSynthStride),
//   count); sub12 = (i & 3) | ((i >> 2) & 3) << 8; genome byte x is x & 3,
//   written into the planes with no copy.  The scatter and the stores run
//   as in kFull (sink = 0).
//
// w windows share a block of kThreads threads (w in {1, 2, 4, 8, 16, 32},
// a template parameter), each window a group of kThreads / w threads; at
// w = 1 the kFull instance is window_kernel.cu's code.  A group's sums are
// warp shuffles of the group's width and, above a warp, the production
// kernel's pass through shared memory.  The last block masks the windows >= B:
// their threads load nothing but reach every barrier.  No output depends on w.
//
// Shared memory.  Each window has two planes of plane_bytes(L) = min(L, kTile)
// rounded up to 16, plus 32, bytes: 2 * w of them a block, in dynamic shared
// memory.  At w = 32 that is 66,560 B for L = 1,000 and 133,120 B for L >
// kTile, above the 48 KB a block gets without asking, so hh_window_lab_init
// raises each instance's limit to 2 * w * kPlane.  Shrinking the tile with w
// instead would stage a window of 1,000 bytes in 16 tiles at w = 32, 32
// barriers where the production kernel has none: the lab would no longer
// time the production kernel's staging.
//
// What bounds it on this card.  As for csrc/window_kernel.cu, latency, not
// bytes: a window moves about 2 KB, through three dependent trips to device
// memory.  The lab times the trips without the substitution (kDmaOnly), the
// substitution and stores without the trips (kComputeOnly), and what several
// windows a block buy.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "window_common.cuh"

namespace {

using namespace hh_window;

constexpr int kMaxW = 32;
// compute_only: bp between synthetic variants (~1.2 SNVs per kb, as a
// human genome against the reference)
constexpr int kSynthStride = 833;

enum Variant : int { kFull = 0, kDmaOnly = 1, kComputeOnly = 2 };

struct LabArgs {
  const int8_t* genome;
  long long G;
  const int32_t* offsets;
  const int32_t* pos;     // (D*C, V)
  const int16_t* sub12;   // (D*C, V): sub1 | sub2 << 8
  const int32_t* first;   // (D*C, NB1): #{pos < j << kBK}
  const int32_t* counts;  // (D*C,)
  int D, C, V, NB1, SP;
  const int32_t* donor;
  const int32_t* chrom;
  const int32_t* start;
  int B, L, K;
  int8_t* hap1;
  int8_t* hap2;
  int32_t* n_variants;
  int32_t* overflow;
  int32_t* sink;
};

// Bytes of one plane of a window of L bytes: its first tile's 16-byte-aligned
// superset and one word of over-read (stage_tile, store_tile).
__host__ __device__ constexpr int plane_bytes(int L) {
  return ((L < kTile ? L : kTile) + 15) / 16 * 16 + 32;
}

template <int kWidth>
__device__ __forceinline__ int warp_xor(int v) {
  for (int o = kWidth >> 1; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o, kWidth);
  return v;
}

// compute_only's stage_tile: writes the synthetic genome bytes [lo, lo + len)
// (byte x is x & 3) into both planes where stage_tile would copy them, in
// 16-byte chunks of one repeated word.  Returns head.
template <int kN>
__device__ __forceinline__ int fill_tile(int8_t* planes, int stride, const int8_t* genome,
                                         long long lo, int len, int tid) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(genome + lo) & 15);
  const long long base = lo - head;
  const int nch = (head + len + 15) >> 4;
  const uint32_t word = __funnelshift_r(0x03020100u, 0x03020100u, 8 * static_cast<unsigned>(base & 3));
  const uint4 chunk = make_uint4(word, word, word, word);
  for (int i = tid; i < 2 * nch; i += kN) {
    const int pl = i >= nch;
    *reinterpret_cast<uint4*>(planes + pl * stride + 16 * (i - pl * nch)) = chunk;
  }
  return head;
}

// dma_only: max(ceil(c / sp) - 1, 0) * sp for c >= 0 and sp a power of
// two, the first entry of the grid chunk that holds entry c - 1
__device__ __forceinline__ int lo0_of(int c, int sp) { return c == 0 ? 0 : (c - 1) & -sp; }

template <int kVariant, int kW>
__global__ void __launch_bounds__(kThreads) lab_kernel(const LabArgs g) {
  constexpr int kGS = kThreads / kW;          // threads a window
  constexpr int kWidth = kGS < 32 ? kGS : 32; // a group's lanes in one warp
  constexpr bool kCompute = kVariant == kComputeOnly;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int2 red[kThreads / 32];
  __shared__ int xred[kThreads / 32];

  const int tid = threadIdx.x;
  const int slot = tid / kGS;
  const int lane = tid - slot * kGS;
  const long long b = (long long)blockIdx.x * kW + slot;
  const bool active = b < g.B;
  const int L = g.L;
  const int stride = plane_bytes(L);
  int8_t* const pl0 = smem + 2 * slot * stride;

  // trip 1: the window's indices; out-of-range indices clamp, as the plain
  // version (and a JAX gather) does
  int d = 0, c = 0, s = 0;
  if (active) {
    d = min(max(g.donor[b], 0), g.D - 1);
    c = min(max(g.chrom[b], 0), g.C - 1);
    s = g.start[b];
  }
  const long long row = (long long)d * g.C + c;
  const long long s_end = (long long)s + L;
  const int nb = g.NB1 - 1;
  const int ja = min(max(s, 0) >> kBK, nb);
  const long long je = max(((s_end - 1) >> kBK) + 1, 0LL);

  // trip 2: count, offset and two table entries.  compute_only: the closed
  // form of the synthetic positions' own table, which has every bucket (the
  // index's table ends at the last real position, and a slice past it would
  // run to the count); buckets from 2^19 on (bp 2^31) hold the whole count,
  // as V * kSynthStride < 2^31
  int count = 0, off = 0, fa = 0, fe = INT_MAX;
  if (active) {
    count = g.counts[row];
    off = g.offsets[c];
    if (kCompute) {
      const unsigned nv = min(max(count, 0), g.V);
      const unsigned j0 = max(s, 0) >> kBK;
      const unsigned j1 = static_cast<unsigned>(min(je, 1LL << (31 - kBK)));
      fa = static_cast<int>(min(((j0 << kBK) + kSynthStride - 1) / kSynthStride, nv));
      fe = static_cast<int>(min(((j1 << kBK) + kSynthStride - 1) / kSynthStride, nv));
    } else {
      const int32_t* frow = g.first + row * g.NB1;
      fa = frow[ja];
      if (je <= nb) fe = frow[je];
    }
  }
  const int cnt = min(max(count, 0), g.V);
  const int a = s < 0 ? 0 : min(fa, cnt);
  const int e = max(a, min(fe, cnt));
  long long flat = (long long)off + s;
  flat = min(max(flat, 0LL), g.G - L);
  // dma_only reads the window from its SP-word-aligned base,
  // 4 * ((flat >> 2) / SP) * SP + (flat & 3) for SP a power of two
  const int sp = g.SP;
  const long long src = kVariant == kDmaOnly ? (flat & -4LL * sp) | (flat & 3) : flat;

  // trip 3: the genome window's copy first, then the slice, in flight together
  int head = 0;
  if (active)
    head = kCompute ? fill_tile<kGS>(pl0, stride, g.genome, src, min(L, kTile), lane)
                    : stage_tile<kGS>(pl0, stride, g.genome, g.G, src, min(L, kTile), lane);
  const int32_t* prow = g.pos + row * g.V;
  const int16_t* srow = g.sub12 + row * g.V;
  auto pos_at = [&](int i) -> int { return kCompute ? i * kSynthStride : prow[i]; };
  auto sub_at = [&](int i) -> int {
    return kCompute ? (i & 3) | (((i >> 2) & 3) << 8) : srow[i];
  };
  const int n = e - a;  // 0 for a masked window
  const bool mine = lane < n;
  int p = 0, pn = 0, v = 0;
  if (mine) {
    p = pos_at(a + lane);
    v = sub_at(a + lane);
    if (lane + 1 < n) pn = pos_at(a + lane + 1);
  }
  int clo = mine && p < s;
  int chi = mine && p < s_end;
  for (int k = lane + kGS; k < n; k += kGS) {  // dense rows: the rest of the slice
    const int q = pos_at(a + k);
    clo += q < s;
    chi += q < s_end;
  }
  // dma_only: pos and sub12 at lo0 for lo = a and lo = e
  int la0 = 0, le0 = 0, nv_a = 0, ov_a = 0, nv_e = 0, ov_e = 0;
  if (kVariant == kDmaOnly && active && lane == 0) {
    la0 = lo0_of(a, sp);
    le0 = lo0_of(e, sp);
    nv_a = prow[la0];
    ov_a = srow[la0];
    if (le0 != la0) {
      nv_e = prow[le0];
      ov_e = srow[le0];
    }
  }

  // lo and hi in one reduction; the barrier also publishes the planes
  clo = warp_sum<kWidth>(clo);
  chi = warp_sum<kWidth>(chi);
  if (kGS > 32 && (tid & 31) == 0) red[tid >> 5] = make_int2(clo, chi);
  if (!kCompute) cp_async_wait_all();
  __syncthreads();
  int2 t = make_int2(clo, chi);
  if (kGS > 32) {
    t = make_int2(0, 0);
#pragma unroll
    for (int w = 0; w < kGS / 32; ++w) {
      t.x += red[slot * (kGS / 32) + w].x;
      t.y += red[slot * (kGS / 32) + w].y;
    }
  }
  // lo and hi here are already min(., count)
  const int lo = a + t.x;
  const int hi = a + t.y;
  const int n_in = max(hi - lo, 0);
  const int n_apply = min(n_in, g.K);

  // this thread's first applied variant i, if any: from the slice it holds,
  // or loaded again for a slice longer than the group (i = lane); a group
  // narrower than n_apply has more, i = lane + kGS, lane + 2 kGS, ...
  int i;
  bool has;
  if (n > kGS) {
    i = lane;
    has = lane < n_apply;
    if (has) {
      p = pos_at(lo + lane);
      v = sub_at(lo + lane);
      if (lane + 1 < n_apply) pn = pos_at(lo + lane + 1);
    }
  } else {
    i = a + lane - lo;
    has = mine && i >= 0 && i < n_apply;
  }
  // the last applied variant at its position writes, at rel = p - s in [0, L)
  const bool writes = has && (i + 1 == n_apply || pn != p);
  const int rel = writes ? p - s : -1;

  int x = 0;  // dma_only's sink
  if (kVariant == kDmaOnly) {
    x = has ? p ^ v : 0;
    if (kGS < kMaxK && n > kGS)
      for (int k = lane + kGS; k < n_apply; k += kGS) x ^= pos_at(lo + k) ^ sub_at(lo + k);
    x = warp_xor<kWidth>(x);
    if (kGS > 32 && (tid & 31) == 0) xred[tid >> 5] = x;  // read after the next barrier
  }

  int8_t* out1 = g.hap1 + b * L;
  int8_t* out2 = g.hap2 + b * L;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int len = min(kTile, L - t0);
    if (t0 > 0) {
      __syncthreads();  // the last tile's stores are done with the planes
      if (active)
        head = kCompute ? fill_tile<kGS>(pl0, stride, g.genome, src + t0, len, lane)
                        : stage_tile<kGS>(pl0, stride, g.genome, g.G, src + t0, len, lane);
      if (!kCompute) cp_async_wait_all();
      __syncthreads();
    }
    if (kVariant != kDmaOnly) {
      if (writes && rel >= t0 && rel - t0 < len) {
        pl0[head + rel - t0] = static_cast<int8_t>(v & 0xFF);
        pl0[stride + head + rel - t0] = static_cast<int8_t>(v >> 8);
      }
      if (kGS < kMaxK && n > kGS) {  // n_apply <= K <= kMaxK
        for (int k = lane + kGS; k < n_apply; k += kGS) {
          const int q = pos_at(lo + k);
          if (k + 1 < n_apply && pos_at(lo + k + 1) == q) continue;  // not the last
          const int r = q - s - t0;
          if (r >= 0 && r < len) {
            const int u = sub_at(lo + k);
            pl0[head + r] = static_cast<int8_t>(u & 0xFF);
            pl0[stride + head + r] = static_cast<int8_t>(u >> 8);
          }
        }
      }
    }
    __syncthreads();
    if (active) store_tile<kGS>(pl0, stride, head, out1 + t0, out2 + t0, len, lane);
  }
  if (active && lane == 0) {
    if (kVariant == kDmaOnly) {
      if (kGS > 32) {
        x = 0;
#pragma unroll
        for (int w = 0; w < kGS / 32; ++w) x ^= xred[slot * (kGS / 32) + w];
      }
      const int lo0 = lo0_of(lo, sp);
      int nv = nv_a, ov = ov_a;
      if (lo0 != la0) {
        if (lo0 == le0) {
          nv = nv_e;
          ov = ov_e;
        } else {  // a slice of more than SP entries
          nv = prow[lo0];
          ov = srow[lo0];
        }
      }
      g.n_variants[b] = nv;
      g.overflow[b] = ov;
      g.sink[b] = x;
    } else {
      g.n_variants[b] = n_in;
      g.overflow[b] = max(n_in - g.K, 0);
      g.sink[b] = 0;
    }
  }
}

template <int kVariant, int kW>
int launch(const LabArgs& args, cudaStream_t stream) {
  lab_kernel<kVariant, kW><<<(args.B + kW - 1) / kW, kThreads, 2 * kW * plane_bytes(args.L),
                             stream>>>(args);
  return (int)cudaGetLastError();
}

template <int kVariant>
int launch_w(int w, const LabArgs& args, cudaStream_t stream) {
  switch (w) {
    case 1: return launch<kVariant, 1>(args, stream);
    case 2: return launch<kVariant, 2>(args, stream);
    case 4: return launch<kVariant, 4>(args, stream);
    case 8: return launch<kVariant, 8>(args, stream);
    case 16: return launch<kVariant, 16>(args, stream);
    case 32: return launch<kVariant, 32>(args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int kVariant, int kW>
int allow_smem() {
  return (int)cudaFuncSetAttribute(lab_kernel<kVariant, kW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   2 * kW * plane_bytes(kTile));
}

template <int kVariant>
int allow_smem_w() {
  const int rc[] = {allow_smem<kVariant, 1>(), allow_smem<kVariant, 2>(),
                    allow_smem<kVariant, 4>(), allow_smem<kVariant, 8>(),
                    allow_smem<kVariant, 16>(), allow_smem<kVariant, 32>()};
  for (int r : rc)
    if (r != 0) return r;
  return 0;
}

}  // namespace

extern "C" {

// The bucket width the kernel searches with, log2 in bp.
int hh_window_lab_bucket_bits() { return kBK; }

// Dynamic shared memory of a launch at w windows a block of L bytes each.
int hh_window_lab_smem(int w, int L) { return 2 * w * plane_bytes(L); }

// Raises every instance's dynamic shared memory limit on the current device
// to what its w needs at any L; once, before the first launch.  Returns the
// first error.
int hh_window_lab_init() {
  int rc = allow_smem_w<kFull>();
  if (rc == 0) rc = allow_smem_w<kDmaOnly>();
  if (rc == 0) rc = allow_smem_w<kComputeOnly>();
  return rc;
}

// Launches variant `variant` (0 full, 1 dma_only, 2 compute_only) on
// `stream` for B windows, w a block; returns cudaGetLastError().
int hh_window_lab(int variant, int w, const int8_t* genome, long long G,
                  const int32_t* offsets, const int32_t* pos, const int16_t* sub12,
                  const int32_t* first, const int32_t* counts, int D, int C, int V,
                  int NB1, int SP, const int32_t* donor, const int32_t* chrom,
                  const int32_t* start, int B, int L, int K, int8_t* hap1,
                  int8_t* hap2, int32_t* n_variants, int32_t* overflow,
                  int32_t* sink, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK || L < 1 || G < L || NB1 < 1 || SP < 1 || (SP & (SP - 1)) != 0 ||
      w < 1 || w > kMaxW)
    return (int)cudaErrorInvalidValue;
  const LabArgs args{genome, G, offsets, pos, sub12, first, counts, D, C, V, NB1, SP,
                     donor, chrom, start, B, L, K, hap1, hap2, n_variants, overflow, sink};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case kFull: return launch_w<kFull>(w, args, st);
    case kDmaOnly: return launch_w<kDmaOnly>(w, args, st);
    case kComputeOnly: return launch_w<kComputeOnly>(w, args, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* hh_lab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
