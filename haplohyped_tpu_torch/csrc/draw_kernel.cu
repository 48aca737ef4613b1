// The haplotype sampler's draws for Hopper (sm_90a): the JAX package's
// jax.random threefry2x32 stream, bit for bit, and each window's start.
//
// It ports no Pallas kernel.  It stands for the jax.random ops that
// haplohyped_tpu/data/sampler.py::_sample_batch runs under XLA for each step
// of each call (fold_in, split, three randint) and for the window crop that
// follows them there, and it is bit-equal to the plain PyTorch versions,
// haplohyped_tpu_torch/ops/threefry.py (the draws) and
// haplohyped_tpu_torch/ops/draw_kernel.py::window_starts (the crop).
//
// One thread a lane t = i * B + j of n = n_batches * B lanes (batch i, lane j
// of the batch), all in uint32 arithmetic that wraps, as XLA's:
//   base  = key, or fold_in(key, digest) where a digest is given (the chain's
//           link update, so the chain's key never leaves the card); lane 0
//           writes base to key_out
//   bk    = fold_in(base, step0 + i)             threefry(base, (0, step0 + i))
//   kf    = split(bk, 3)[f]                      threefry(bk, (0, f)), f < 3
//   kh,kl = split(kf)                            threefry(kf, (0, 0)), (0, 1)
//   h, l  = random bits of lane j                y0 ^ y1 of threefry(kh|kl, (0, j))
//   v_f   = ((h % s) * m + l % s) % s,  s = size_f >= 1, m = (2^16 % s)^2 % s
//   start = min(max(mid - L/2, 0), max(len[chrom] - L, 0)),
//           mid = (regions[r][0] + regions[r][1]) >> 1   (int32, floor)
// with (region, donor, chrom) = (v_0, v_1, v_2) and sizes (R, D, C).
//
// What bounds it on this card.  Integer work: 16 threefry hashes a lane of
// ~80 int32 operations each (the lane's 6 bit draws, and the 10 key
// derivations of its batch, which every lane of the batch repeats), against
// 16 bytes of stores and 12 of gathers a lane.  At the chain's 16,384 lanes
// the work the function needs (6 hashes a lane, 10 a batch) is ~8.4 M int32
// operations, ~0.5 us at 64 int32 lanes an SM; the stores take 0.08 us at
// 3.35 TB/s.  So one launch sits at the launch floor.
//
// What the design does about it.  Nothing is shared between threads: each
// recomputes its batch's keys in registers (no shared memory, no barrier, no
// second launch) and the three fields' hashes are independent, which gives
// the scheduler instruction-level parallelism over the 4-hash dependent
// chain.  Rotations are one funnel shift.  Keys come either as two words by
// value (a host key: no copy to the card) or from device memory (a key the
// card made: the graph's input, the last link's key_out).  Computing each
// batch's keys once (one warp a batch, through shared memory) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

// rotation distance of round r (0..3) in group g: (13, 15, 26, 6) in even
// groups, (17, 29, 16, 24) in odd ones; a constant after unrolling
__device__ __forceinline__ int rotation(int g, int r) {
  return (g & 1) ? (r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24)
                 : (r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6);
}

__device__ __forceinline__ uint2 threefry(uint2 k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(g, r));
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t bits32(uint2 k, uint32_t j) {
  const uint2 y = threefry(k, 0u, j);
  return y.x ^ y.y;
}

// JAX's randint over [0, s) from the field key kf, lane j
__device__ __forceinline__ int32_t randint(uint2 kf, uint32_t j, uint32_t s) {
  const uint32_t h = bits32(threefry(kf, 0u, 0u), j);
  const uint32_t l = bits32(threefry(kf, 0u, 1u), j);
  uint32_t m = 65536u % s;
  m = (m * m) % s;  // wraps to 0 for s > 2^16, as in uint32 XLA
  return static_cast<int32_t>(((h % s) * m + l % s) % s);
}

__global__ void __launch_bounds__(kThreads) draw_kernel(
    const long long* __restrict__ key_in, uint32_t k0, uint32_t k1,
    const long long* __restrict__ digest, long long* __restrict__ key_out,
    uint32_t step0, int n, int B, int R, int D, int C,
    const int32_t* __restrict__ regions,  // (R, 2)
    const int32_t* __restrict__ lengths,  // (C,)
    int L, int32_t* __restrict__ out) {   // (4, n): region, donor, chrom, start
  const int t = blockIdx.x * kThreads + threadIdx.x;
  uint2 base = key_in ? make_uint2(static_cast<uint32_t>(key_in[0]),
                                   static_cast<uint32_t>(key_in[1]))
                      : make_uint2(k0, k1);
  if (digest) base = threefry(base, 0u, static_cast<uint32_t>(*digest));
  if (t == 0) {
    key_out[0] = base.x;
    key_out[1] = base.y;
  }
  if (t >= n) return;
  const int i = t / B;
  const uint32_t j = static_cast<uint32_t>(t - i * B);
  const uint2 bk = threefry(base, 0u, step0 + static_cast<uint32_t>(i));
  const int32_t r = randint(threefry(bk, 0u, 0u), j, static_cast<uint32_t>(R));
  const int32_t d = randint(threefry(bk, 0u, 1u), j, static_cast<uint32_t>(D));
  const int32_t c = randint(threefry(bk, 0u, 2u), j, static_cast<uint32_t>(C));

  // the window's start, in int32 arithmetic that wraps as torch's does
  const int2 span = reinterpret_cast<const int2*>(regions)[r];
  const int32_t mid = static_cast<int32_t>(static_cast<uint32_t>(span.x) +
                                           static_cast<uint32_t>(span.y)) >> 1;
  const int32_t lo = static_cast<int32_t>(static_cast<uint32_t>(mid) -
                                          static_cast<uint32_t>(L / 2));
  const int32_t lim = static_cast<int32_t>(static_cast<uint32_t>(lengths[c]) -
                                           static_cast<uint32_t>(L));
  out[t] = r;
  out[n + t] = d;
  out[2 * n + t] = c;
  out[3 * n + t] = min(max(lo, 0), max(lim, 0));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for n = n_batches * B lanes; returns
// cudaGetLastError().  key_in may be null (the key is then (k0, k1)), and
// digest may be null (no link update); key_out gets the key the draws used.
int hh_draw(const long long* key_in, uint32_t k0, uint32_t k1, const long long* digest,
            long long* key_out, uint32_t step0, int n_batches, int B, int R, int D,
            int C, const int32_t* regions, const int32_t* lengths, int L,
            int32_t* out, void* stream) {
  if (n_batches < 1 || B < 1 || R < 1 || D < 1 || C < 1 || L < 1 || key_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_batches * B;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  draw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key_in, k0, k1, digest, key_out, step0, (int)n, B, R, D, C, regions, lengths, L,
      out);
  return (int)cudaGetLastError();
}

const char* hh_draw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
