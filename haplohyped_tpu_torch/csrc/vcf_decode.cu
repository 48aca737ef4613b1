// Framed VCF record decode for Hopper (sm_90a): the 12-byte and the 64-byte
// layouts of haplohyped_tpu_torch/hostio/frame_format.py.
//
// decode12_kernel replaces the TPU kernel
//   haplohyped_tpu/ops/pallas_decode.py::_decode12_kernel (_pallas_decode12_call)
// and decode64_kernel replaces
//   haplohyped_tpu/ops/pallas_decode.py::_decode_kernel (_pallas_decode_call).
// Each computes its wrapper's whole contract for any N in one launch, bit-equal
// to the plain PyTorch versions decode_frames12_packed / decode_frames_packed
// of haplohyped_tpu_torch/ops/vcf_decode.py:
//
//   decode12, per record (12 B in):  start   = POS - 1                (uint32 bits)
//                                    meta    = ref | alt<<8 | chrom_id<<16 | flags<<24
//                                    ref_len = REF length byte
//     flags = snp | valid<<1 | missing<<2 | phased<<3 | phase1<<4 | phase2<<5
//   decode64, per record (64 B in):  start, stop = start + ref_len, ref_char,
//     alt_char, phase1, phase2, flags = snp | valid<<1 | missing<<2 | phased<<3
//
// POS is computed in uint32, as the JAX package does: malformed records (BCD
// nibbles above 9, bytes below '0' among the ASCII digits, POS = 0) wrap
// exactly as there.  A 64-byte digit slot i counts with weight 10^(pos_len-1-i)
// only where 0 <= pos_len-1-i <= 9, for any pos_len byte.
//
// What bounds it on this card.  Only bytes: a handful of integer operations
// a record against 24 B (decode12: 12 in, 12 out) or 92 B (decode64: 64 in,
// 28 out) of device memory.  At 6.47 M records (chr1 of the 1000 Genomes
// release) decode12 moves 0.155 GB, 46 us at 3.35 TB/s.
//
// What the design does about it.  One thread per record, 256 a block, the
// grid covering N and the tail masked (the Pallas call dropped N % block
// records; here every record decodes).  Every byte is read once, straight
// into registers, with the widest load the record's alignment allows: three
// aligned 32-bit words for a 12-byte record (the base is 4-byte aligned) and
// four 16-byte vectors for a 64-byte record (16-byte aligned); a warp's loads
// cover one contiguous span, so no sector is fetched twice from memory.  Each
// output column is one coalesced int32 store a thread.  No shared memory, no
// synchronisation.  Making it faster (several records a thread, wider
// stores) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// byte k of a record held as little-endian 32-bit words (k is a constant
// after unrolling, so this is a shift and a mask on a register)
__device__ __forceinline__ uint32_t rec_byte(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

__device__ __forceinline__ bool is_acgt(uint32_t c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// 10^e for e in [0, 9] (binary exponentiation with constant factors)
__device__ __forceinline__ uint32_t pow10_u32(int e) {
  uint32_t w = 1u;
  if (e & 1) w *= 10u;
  if (e & 2) w *= 100u;
  if (e & 4) w *= 10000u;
  if (e & 8) w *= 100000000u;
  return w;
}

// ---- 12-byte layout (frame_format.py REC12_*) ----------------------------
constexpr int kR12PosBytes = 5;  // bytes 0..4: 10 BCD nibbles, MSD first
constexpr int kR12Ref = 5, kR12Alt = 6, kR12RefLen = 7, kR12AltLen = 8;
constexpr int kR12ChromId = 9, kR12Gt = 10, kR12Flags = 11;
constexpr uint32_t kF12WellFormed = 1, kF12HasGt = 2, kF12DiploidLen = 4;
constexpr uint32_t kF12SepPipe = 8, kF12SepSlash = 16;
constexpr uint32_t kGtNibbleMissing = 0xA;

__global__ void __launch_bounds__(kThreads) decode12_kernel(
    const uint32_t* __restrict__ frames, long long n, int with_sample,
    int32_t* __restrict__ start_out, int32_t* __restrict__ meta_out,
    int32_t* __restrict__ reflen_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = __ldg(frames + 3 * i + k);

  // POS: Horner over the 10 nibbles, mod 2^32 (equal to the weighted sum
  // nibble_k * 10^(9-k) in uint32, which is what the JAX package computes)
  uint32_t pos = 0;
#pragma unroll
  for (int b = 0; b < kR12PosBytes; ++b) {
    const uint32_t byte = rec_byte(w, b);
    pos = pos * 10u + (byte >> 4);
    pos = pos * 10u + (byte & 0xFu);
  }
  const uint32_t start = pos - 1u;

  const uint32_t ref_char = rec_byte(w, kR12Ref), alt_char = rec_byte(w, kR12Alt);
  const uint32_t ref_len = rec_byte(w, kR12RefLen), alt_len = rec_byte(w, kR12AltLen);
  const uint32_t flags = rec_byte(w, kR12Flags);
  const bool snp = ref_len == 1 && alt_len == 1 && is_acgt(alt_char);
  const bool well_formed = (flags & kF12WellFormed) != 0;

  bool valid = well_formed, missing = false, phased = false;
  uint32_t phase1 = 0, phase2 = 0;
  if (with_sample) {
    const uint32_t gt = rec_byte(w, kR12Gt);
    const uint32_t g0n = gt >> 4, g2n = gt & 0xFu;
    const bool diploid = (flags & kF12HasGt) && (flags & kF12DiploidLen) &&
                         (flags & (kF12SepPipe | kF12SepSlash));
    missing = diploid && (g0n == kGtNibbleMissing || g2n == kGtNibbleMissing);
    phase1 = missing ? 1u : (g0n != 0);
    phase2 = missing ? 0u : (g2n != 0);
    phased = diploid && (flags & kF12SepPipe);
    valid = well_formed && diploid;
  }
  const uint32_t out_flags = uint32_t(snp) | (uint32_t(valid) << 1) |
                             (uint32_t(missing) << 2) | (uint32_t(phased) << 3) |
                             ((phase1 & 1u) << 4) | ((phase2 & 1u) << 5);
  start_out[i] = static_cast<int32_t>(start);
  meta_out[i] = static_cast<int32_t>(ref_char | (alt_char << 8) |
                                     (rec_byte(w, kR12ChromId) << 16) | (out_flags << 24));
  reflen_out[i] = static_cast<int32_t>(ref_len);
}

// ---- 64-byte layout (frame_format.py REC_SIZE, *_OFF) ----------------------
constexpr int kPosOff = 9, kPosCap = 12, kPosLen = 21;
constexpr int kRefOff = 22, kRefLen = 38, kAltOff = 39, kAltLen = 55;
constexpr int kGtOff = 56, kGtLen = 62, kFlagsOff = 63;
constexpr uint32_t kFWellFormed = 1, kFHasGt = 2;

__global__ void __launch_bounds__(kThreads) decode64_kernel(
    const uint4* __restrict__ frames, long long n, int with_sample,
    int32_t* __restrict__ start_out, int32_t* __restrict__ stop_out,
    int32_t* __restrict__ ref_out, int32_t* __restrict__ alt_out,
    int32_t* __restrict__ phase1_out, int32_t* __restrict__ phase2_out,
    int32_t* __restrict__ flags_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 q = __ldg(frames + 4 * i + v);
    w[4 * v] = q.x;
    w[4 * v + 1] = q.y;
    w[4 * v + 2] = q.z;
    w[4 * v + 3] = q.w;
  }

  // POS: sum of (digit - '0') * 10^(pos_len-1-k) over the slots whose
  // exponent lies in [0, 9], in uint32
  const int pos_len = static_cast<int>(rec_byte(w, kPosLen));
  uint32_t pos = 0;
#pragma unroll
  for (int k = 0; k < kPosCap; ++k) {
    const int e = pos_len - 1 - k;
    const uint32_t weight = (e >= 0 && e <= 9) ? pow10_u32(e) : 0u;
    pos += (rec_byte(w, kPosOff + k) - uint32_t('0')) * weight;
  }
  const uint32_t start = pos - 1u;

  const uint32_t ref_len = rec_byte(w, kRefLen), alt_len = rec_byte(w, kAltLen);
  const uint32_t alt_char = rec_byte(w, kAltOff);
  const uint32_t flags = rec_byte(w, kFlagsOff);
  const bool snp = ref_len == 1 && alt_len == 1 && is_acgt(alt_char);
  const bool well_formed = (flags & kFWellFormed) != 0;

  bool valid = well_formed, missing = false, phased = false;
  uint32_t phase1 = 0, phase2 = 0;
  if (with_sample) {
    const uint32_t g0 = rec_byte(w, kGtOff), g1 = rec_byte(w, kGtOff + 1);
    const uint32_t g2 = rec_byte(w, kGtOff + 2);
    const bool diploid = (flags & kFHasGt) && rec_byte(w, kGtLen) >= 3 &&
                         (g1 == '|' || g1 == '/');
    missing = diploid && (g0 == '.' || g2 == '.');
    phase1 = missing ? 1u : (g0 != '0');
    phase2 = missing ? 0u : (g2 != '0');
    phased = diploid && g1 == '|';
    valid = well_formed && diploid;
  }
  start_out[i] = static_cast<int32_t>(start);
  stop_out[i] = static_cast<int32_t>(start + ref_len);
  ref_out[i] = static_cast<int32_t>(rec_byte(w, kRefOff));
  alt_out[i] = static_cast<int32_t>(alt_char);
  phase1_out[i] = static_cast<int32_t>(phase1);
  phase2_out[i] = static_cast<int32_t>(phase2);
  flags_out[i] = static_cast<int32_t>(uint32_t(snp) | (uint32_t(valid) << 1) |
                                      (uint32_t(missing) << 2) | (uint32_t(phased) << 3));
}

int grid_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// out: (3, n) int32 -- start, meta, ref_len.  Launches on `stream`, does
// not synchronise; returns the launch's cudaError_t (0 = launched).
int hh_decode12(const void* frames, long long n, int with_sample, void* out,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int32_t* o = static_cast<int32_t*>(out);
  decode12_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frames), n, with_sample, o, o + n, o + 2 * n);
  return static_cast<int>(cudaGetLastError());
}

// out: (7, n) int32 -- start, stop, ref_char, alt_char, phase1, phase2, flags.
int hh_decode64(const void* frames, long long n, int with_sample, void* out,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int32_t* o = static_cast<int32_t*>(out);
  decode64_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(frames), n, with_sample, o, o + n, o + 2 * n,
      o + 3 * n, o + 4 * n, o + 5 * n, o + 6 * n);
  return static_cast<int>(cudaGetLastError());
}

const char* hh_decode_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
