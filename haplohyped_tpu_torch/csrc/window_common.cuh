// Device code shared by the window encode (window_kernel.cu) and the
// window-kernel lab (window_kernel_lab.cu), so that the lab times the
// production kernel's own staging, reductions and stores.
//
// The helpers take the calling thread's rank `tid` among the `kN` threads
// that share the work: the production kernel passes threadIdx.x and its
// block, the lab a window's group of threads.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hh_window {

// threads a block: at 40 registers a thread, 256 would leave room for 6
// blocks an SM, and a batch of 1,024 windows would take two waves on 132 SMs
constexpr int kThreads = 128;
constexpr int kMaxK = 128;           // most variants applied to a window
constexpr int kBK = 12;              // log2 of the bucket width in bp
constexpr int kTile = 2048;          // window bytes staged at once
constexpr int kPlane = kTile + 32;   // a tile's aligned superset + one word of over-read

// Sum over aligned groups of kWidth lanes of a warp (kWidth a power of two
// <= 32); every lane of the group gets the sum.
template <int kWidth = 32>
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = kWidth >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, kWidth);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(gmem)) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying genome bytes [lo, lo + len) into both planes (plane 1 at
// `planes + stride`, 16-byte aligned, stride a multiple of 16); byte j of
// the range lands at plane offset head + j, where head = (address of lo) &
// 15.  Chunks of 16 bytes inside [0, G) go by cp.async; a chunk that
// straddles the genome's ends goes byte by byte.  Returns head.
template <int kN>
__device__ __forceinline__ int stage_tile(int8_t* planes, int stride, const int8_t* genome,
                                          long long G, long long lo, int len, int tid) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(genome + lo) & 15);
  const long long base = lo - head;
  const int nch = (head + len + 15) >> 4;
  for (int i = tid; i < 2 * nch; i += kN) {
    const int pl = i >= nch;
    const int ch = i - pl * nch;
    const long long g = base + 16LL * ch;
    int8_t* dst = planes + pl * stride + 16 * ch;
    if (g >= 0 && g + 16 <= G) {
      cp_async16(dst, genome + g);
    } else {
      for (int x = 0; x < 16; ++x)
        if (g + x >= 0 && g + x < G) dst[x] = genome[g + x];
    }
  }
  return head;
}

// Stores plane bytes [head, head + n) of both planes to out1 and out2:
// 16-byte stores where a 16-byte-aligned chunk of the output lies inside the
// row, byte stores for the ragged head and tail.
template <int kN>
__device__ __forceinline__ void store_tile(const int8_t* planes, int stride, int head,
                                           int8_t* out1, int8_t* out2, int n, int tid) {
  const int h1 = static_cast<int>(reinterpret_cast<uintptr_t>(out1) & 15);
  const int h2 = static_cast<int>(reinterpret_cast<uintptr_t>(out2) & 15);
  const int n1 = (h1 + n + 15) >> 4;
  const int n2 = (h2 + n + 15) >> 4;
  for (int i = tid; i < n1 + n2; i += kN) {
    const int pl = i >= n1;
    const int ch = pl ? i - n1 : i;
    const int oh = pl ? h2 : h1;
    const int8_t* plane = planes + pl * stride;
    int8_t* dst = (pl ? out2 : out1) - oh + 16 * ch;
    const int j0 = 16 * ch - oh;  // row byte of the chunk's first byte
    if (j0 >= 0 && j0 + 16 <= n) {
      // plane bytes q .. q + 15 from five aligned words and funnel shifts
      const int q = head + j0;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(plane + (q & ~3));
      const unsigned sh = (q & 3) * 8;
      uint4 r;
      r.x = __funnelshift_r(w[0], w[1], sh);
      r.y = __funnelshift_r(w[1], w[2], sh);
      r.z = __funnelshift_r(w[2], w[3], sh);
      r.w = __funnelshift_r(w[3], w[4], sh);
      *reinterpret_cast<uint4*>(dst) = r;
    } else {
      const int8_t* src = plane + head;
      for (int x = 0; x < 16; ++x) {
        const int j = j0 + x;
        if (j >= 0 && j < n) dst[x] = src[j];
      }
    }
  }
}

}  // namespace hh_window
