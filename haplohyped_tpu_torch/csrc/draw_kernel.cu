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
// For lane t = i * B + j of n = n_batches * B lanes (batch i, lane j of the
// batch), all in uint32 arithmetic that wraps, as XLA's:
//   base  = key, or fold_in(key, digest) where a digest is given (the chain's
//           link update, so the chain's key never leaves the card); written
//           to key_out
//   bk    = fold_in(base, step0 + i)             threefry(base, (0, step0 + i))
//   kf    = split(bk, 3)[f]                      threefry(bk, (0, f)), f < 3
//   kh,kl = split(kf)                            threefry(kf, (0, 0)), (0, 1)
//   h, l  = random bits of lane j                y0 ^ y1 of threefry(kh|kl, (0, j))
//   v_f   = ((h % s) * m + l % s) % s,  s = size_f >= 1, m = (2^16 % s)^2 % s
//   start = min(max(mid - L/2, 0), max(len[chrom] - L, 0)),
//           mid = (regions[r][0] + regions[r][1]) >> 1   (int32, floor)
// with (region, donor, chrom) = (v_0, v_1, v_2) and sizes (R, D, C).
//
// What bounds it on this card.  Latency, not work.  A threefry hash is ~79
// int32 operations in a dependent chain ~45 deep.  The function needs 10
// hashes a batch (its keys) and, a lane, 2 a field, or 1 where m wraps to 0
// (then v = l % s and h is never read): at the deployment's sizes (R, D, C)
// = (100,000, 128, 12) m is 0 for R and D, so 4.  At the chain's 16,384
// lanes that is ~6.0 M int32 operations, ~0.36 us on 64 INT32 lanes an SM,
// against 16 bytes a lane stored (0.08 us at 3.35 TB/s).  But no lane can
// start its own hashes before its batch's keys exist, three dependent hashes
// after the launch (four with a digest, after the key's and the digest's
// loads), and the crop's gather of the region waits on the region's hash:
// at every lane count the sampler uses, the launch's floor and that chain
// set the time.
//
// What the design does about it.
//   1. Keys once a block.  Thread (b, f) of a block's first 3 * nb threads
//      derives field f's (kh, kl) of the block's batch b (nb <= 64 batches)
//      into shared memory: the digest fold, bk, kf, kh and kl, the chain's
//      depth and no more.  After one barrier each thread hashes only its
//      lane's bits: 4 hashes a lane at the deployment's sizes, not 17.
//   2. Invariant divisors.  R, D, C and B are fixed for a launch, so every
//      % and / is a multiply-high, a 64-bit add and a shift by constants the
//      host computes once per size tuple (ops/draw_kernel.py::divisor), and
//      m comes from the host too.  No division instruction runs.
//   3. Spread the lane's work.  A block is 64 lanes and two warps a field
//      (192 threads), so each thread hashes 1-2 words, and 16,384 lanes
//      make 256 blocks over the 132 SMs, 1,024 make 16 (256-lane blocks of
//      a thread a lane would make 64 and 4).  32-lane blocks spread
//      further, but their extra blocks cost more than they save.  The region
//      warps hand max(mid - L/2, 0) to the chrom warps through shared
//      memory for the crop.
// Keys come either as two words by value (a host key: no copy to the card)
// or from device memory (a key the card made: the graph's input, the last
// link's key_out).  Rotations are one funnel shift.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 64;            // lanes a block
constexpr int kThreads = 3 * kLanes;  // two warps a field: region, donor, chrom
constexpr uint32_t kParity = 0x1BD11BDAu;

// a divisor fixed for the launch: n / d = (umulhi(n, magic) + n) >> shift for
// every uint32 n, the sum in 64 bits (Granlund and Montgomery's round-up
// method); mult is randint's (2^16 % d)^2 % d in wrapping uint32
struct Divisor {
  uint32_t d, magic, shift, mult;
};

struct Divisors {
  Divisor field[3];  // R, D, C
  Divisor batch;     // B
};
static_assert(sizeof(Divisors) == 16 * sizeof(uint32_t), "hh_draw takes 16 words");

__device__ __forceinline__ uint32_t quotient(uint32_t n, const Divisor& v) {
  return static_cast<uint32_t>((static_cast<uint64_t>(__umulhi(n, v.magic)) + n) >> v.shift);
}

__device__ __forceinline__ uint32_t remainder(uint32_t n, const Divisor& v) {
  return n - quotient(n, v) * v.d;
}

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

__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1, uint32_t j) {
  const uint2 y = threefry(make_uint2(k0, k1), 0u, j);
  return y.x ^ y.y;
}

__global__ void __launch_bounds__(kThreads) draw_kernel(
    const long long* __restrict__ key_in, uint32_t k0, uint32_t k1,
    const long long* __restrict__ digest, long long* __restrict__ key_out,
    uint32_t step0, uint32_t n, Divisors div,
    const int32_t* __restrict__ regions,  // (R, 2)
    const int32_t* __restrict__ lengths,  // (C,)
    int L, int32_t* __restrict__ out) {   // (4, n): region, donor, chrom, start
  __shared__ uint4 keys[kLanes][3];  // (kh, kl) of batch i0 + b, field f
  __shared__ int32_t low[kLanes];    // max(mid - L/2, 0) of each lane's region
  const uint32_t t0 = blockIdx.x * kLanes;
  const uint32_t i0 = quotient(t0, div.batch);
  const uint32_t nb = quotient(min(t0 + kLanes, n) - 1, div.batch) - i0 + 1;

  // 1. the block's keys: thread (b, f) derives field f's of batch i0 + b
  if (threadIdx.x < 3 * nb) {
    const uint32_t b = threadIdx.x / 3, f = threadIdx.x - 3 * b;
    uint2 base = key_in ? make_uint2(static_cast<uint32_t>(key_in[0]),
                                     static_cast<uint32_t>(key_in[1]))
                        : make_uint2(k0, k1);
    if (digest) base = threefry(base, 0u, static_cast<uint32_t>(*digest));
    if (t0 == 0 && threadIdx.x == 0) {
      key_out[0] = base.x;
      key_out[1] = base.y;
    }
    const uint2 kf = threefry(threefry(base, 0u, step0 + i0 + b), 0u, f);
    const uint2 kh = threefry(kf, 0u, 0u), kl = threefry(kf, 0u, 1u);
    keys[b][f] = make_uint4(kh.x, kh.y, kl.x, kl.y);
  }
  __syncthreads();

  // 2. one field of one lane a thread; a warp's field is uniform
  const uint32_t f = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const uint32_t t = t0 + lane;
  const bool live = t < n;
  const Divisor s = f == 0 ? div.field[0] : f == 1 ? div.field[1] : div.field[2];
  uint32_t v = 0;
  int32_t len = 0;
  if (live) {
    const uint32_t i = quotient(t, div.batch);
    const uint32_t j = t - i * div.batch.d;
    const uint4 k = keys[i - i0][f];
    v = remainder(bits32(k.z, k.w, j), s);
    if (s.mult != 0) {  // else (h % s) * m is 0 and h is not needed
      const uint32_t h = remainder(bits32(k.x, k.y, j), s);
      v = remainder(h * s.mult + v, s);
    }
    const size_t at = static_cast<size_t>(f) * n + t;
    out[at] = static_cast<int32_t>(v);
    if (f == 0) {  // the region's midpoint crop, in int32 arithmetic that wraps as torch's
      const int2 span = reinterpret_cast<const int2*>(regions)[v];
      const int32_t mid = static_cast<int32_t>(static_cast<uint32_t>(span.x) +
                                               static_cast<uint32_t>(span.y)) >> 1;
      low[lane] = max(static_cast<int32_t>(static_cast<uint32_t>(mid) -
                                           static_cast<uint32_t>(L / 2)), 0);
    } else if (f == 2) {
      len = lengths[v];
    }
  }
  __syncthreads();
  if (live && f == 2) {
    const int32_t lim = static_cast<int32_t>(static_cast<uint32_t>(len) -
                                             static_cast<uint32_t>(L));
    out[3 * static_cast<size_t>(n) + t] = min(low[lane], max(lim, 0));
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for n = n_batches * B lanes; returns
// cudaGetLastError().  key_in may be null (the key is then (k0, k1)), and
// digest may be null (no link update); key_out gets the key the draws used.
// `divisors` holds 16 words, (d, magic, shift, mult) of R, D, C and B in that
// order, as ops/draw_kernel.py::divisor makes them; the kernel takes them by
// value, so the host array may go once this returns.
int hh_draw(const long long* key_in, uint32_t k0, uint32_t k1, const long long* digest,
            long long* key_out, uint32_t step0, int n_batches, const uint32_t* divisors,
            const int32_t* regions, const int32_t* lengths, int L, int32_t* out,
            void* stream) {
  if (n_batches < 1 || L < 1 || key_out == nullptr || divisors == nullptr)
    return (int)cudaErrorInvalidValue;
  Divisors div;
  std::memcpy(&div, divisors, sizeof div);
  const Divisor all[4] = {div.field[0], div.field[1], div.field[2], div.batch};
  for (const Divisor& v : all)
    if (v.d < 1 || v.d > 0x7FFFFFFFu || v.shift > 31) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_batches * div.batch.d;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n + kLanes - 1) / kLanes);
  draw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key_in, k0, k1, digest, key_out, step0, (uint32_t)n, div, regions, lengths, L, out);
  return (int)cudaGetLastError();
}

const char* hh_draw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
