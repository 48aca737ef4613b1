// Mamba-2's chunked state-space scan (SSD) for Hopper (sm_90a): the parts of
// its forward and backward that are no matrix product, in float32 between
// bf16 inputs and outputs.  The matrix products go to cuBLAS through
// torch.bmm (ops/ssd_scan.py sets them out); these kernels compute the decay
// mask (the segment sums of dt * A inside a chunk and their exponentials),
// the sequential float32 state pass over the chunks, and the elementwise
// passes and reductions around them.
//
// It ports no Pallas kernel: the JAX package has no state-space model.  It
// was added for the Mamba-2 mixers of models/granite_hybrid.py and
// models/nemotron_h.py, and computes ops/ssd_scan.py::ssd_scan_plain.  Per
// batch row b and head h, with chunk length Q, s_i the inclusive sum of a_k =
// dt_k A over the chunk up to i, G = C B^T of h's group (the heads come in
// groups of H / NG consecutive heads that share one B and one C; NG = 1 is
// one group for every head), and a chunk's entering state H_c (H_0 = 0):
//   M[i, j]  = G[i, j] exp(s_i - s_j) dt_j    (j <= i; else 0)
//   y_diag   = M x
//   w_j      = exp(s_last - s_j) dt_j,   S_c = (x * w)^T B
//   H_{c+1}  = exp(s_last) H_c + S_c                (the state pass)
//   y        = y_diag + exp(s_i) (C H_c^T)_i + D x
// The backward recomputes everything from the inputs; its products are
//   dM = dy x^T, dx_diag = M^T dy, dH_c = (dy e^s)^T C, dC_off = (dy e^s) H_c,
//   dS_c = dH_{c+1} (the reverse pass), dB_state = (x w) dS, d(xw) = B dS^T,
//   dG = sum over the group's h of dM exp(s_i - s_j) dt_j, dC_diag = dG B,
//   dB_diag = dG^T C,
// and these kernels the rest: the reverse state pass, the mask's gradient
// (dG, and its row and column sums into ds and ddt), and the finish (dx, the
// gradient of s through the chunk's inclusive sum into dt and A, and dD).
//
// Layouts (b batch rows, T tokens, H heads, P head size, N state size, NG
// groups of Hg = H / NG heads, Q = 128 or 256 (a template argument), nc = T /
// Q): x, y, dx, dy (b, T, H, P); xw, dye = dy exp(s), y_off, d(xw) group-major
// (b nc NG, Q, Hg P), the operands of the per-group products (with NG = 1
// the layout of x); dt, ddt (b, T, H) float32; s, dt^T, ds, ddt_acc (b, H, T)
// float32; e = exp(s_last) and de (b, H, nc) float32; G, dG (b nc NG, Q, Q)
// float32; M, dM (b nc H, Q, Q); x_h, dy_h, y_diag, dx_diag (b nc H, Q, P);
// S, H_c float32 and H_c's bf16 copy Hb, dH, dS (b nc, H P, N).  Everything
// bf16 that is not named float32.  Each kernel that indexes by group has a
// one-group build (kOne) whose index arithmetic is x's layout alone, so one
// group (the Granite hybrid) runs the arithmetic it ran before groups were
// taken: an index by group in every element of the combine cost its forward
// 12% on the card.  The states stay float32 from the product that makes S (float32
// out) through the pass; Hb, an entering state rounded once, is only the
// operand of the tensor-core products C H_c^T and (dy e^s) H_c, as Mamba-2's
// own kernels round the states they multiply by C.
//
// What bounds it on this card.  Bytes: a few flops an element against 2 or 4
// bytes.  The mask is the largest array, Q * Q a chunk and head, written
// once by the prep kernel and read once by the product; its gradient dM is
// read once by the mask-backward kernel, which sums it over the heads in
// registers (one block owns 16 rows of one chunk for all Hg heads of a group) so dG is
// written once, with no atomics (a block sums the heads of one group); the
// row and column sums go to ds and ddt by
// warp-reduced atomics.  The state passes run one thread an element of the
// (P, N) state, looping over the chunks in order: the state never leaves a
// register, and the chunks' states are read and written once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // rows of a chunk a mask-backward block
constexpr int kPass = 256;  // threads a state-pass block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Inclusive sum over the block's Q threads; `tmp` holds Q / 32 floats.
template <int Q>
__device__ __forceinline__ float block_scan(float v, float* tmp) {
  constexpr int kWarps = Q / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? tmp[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kWarps) tmp[lane] = t;
  }
  __syncthreads();
  const float out = v + (warp > 0 ? tmp[warp - 1] : 0.f);
  __syncthreads();
  return out;
}

// The sum over the block's Q threads, in every thread; `tmp` holds Q / 32 floats.
template <int Q>
__device__ __forceinline__ float block_sum(float v, float* tmp) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < Q / 32; ++w) t += tmp[w];
  __syncthreads();
  return t;
}

struct Dims {
  int b, T, H, P, nc, NG, Hg;  // NG groups of Hg = H / NG heads
  // element p of head h at position i of chunk c of batch row bb in the
  // group-major layout (b nc NG, Q, Hg P), given its index `src` in x's
  // layout (b, T, H, P), which it is with one group (kOne: the kernels'
  // one-group build, whose index arithmetic is the layout of x's alone)
  template <bool kOne>
  __device__ __forceinline__ size_t gm(int Q, int bb, int c, int h, int i, int p,
                                       size_t src) const {
    if constexpr (kOne) return src;
    const int g = h / Hg, k = h - g * Hg;
    return ((((size_t)bb * nc + c) * NG + g) * Q + i) * ((size_t)Hg * P) + (size_t)k * P + p;
  }
};

// One block a (batch row, chunk, head), one thread a position of the chunk:
// s (the inclusive sum of dt A), e = exp(s_last), the mask M, x_h (x
// head-major) and xw = x * w (group-major); with dy, also dy_h (dy
// head-major), dye = dy exp(s) (group-major) and dt^T.
template <int Q, bool kOne>
__device__ __forceinline__ void prep(const Dims d, const bf16* x, const float* dt, const float* A,
                                     const float* G, float* s, float* e, bf16* M, bf16* xh,
                                     bf16* xw, const bf16* dy, bf16* dyh, bf16* dye, float* dtT) {
  constexpr int kWarps = Q / 32;
  __shared__ float sh_s[Q], sh_dt[Q], tmp[kWarps];
  const int blk = blockIdx.x, h = blk % d.H, bc = blk / d.H, bb = bc / d.nc, c = bc % d.nc;
  const int i = threadIdx.x, t = c * Q + i;
  const float dti = dt[((size_t)bb * d.T + t) * d.H + h];
  const float si = block_scan<Q>(dti * A[h], tmp);
  sh_s[i] = si;
  sh_dt[i] = dti;
  const size_t row = ((size_t)bb * d.H + h) * d.T + t;
  s[row] = si;
  if (dtT) dtT[row] = dti;
  __syncthreads();
  const float slast = sh_s[Q - 1];
  if (i == 0) e[((size_t)bb * d.H + h) * d.nc + c] = expf(slast);
  // the mask: thread i owns column j = i
  const float* g = G + (kOne ? (size_t)bc : (size_t)bc * d.NG + h / d.Hg) * Q * Q;
  bf16* m = M + (size_t)blk * Q * Q;
  for (int r = 0; r < Q; ++r) {
    const float v = i <= r ? g[r * Q + i] * __expf(sh_s[r] - si) * dti : 0.f;
    st(m + r * Q + i, v);
  }
  // x, dy head-major and weighted: a warp a row
  const int lane = i & 31, warp = i >> 5;
  for (int r = warp; r < Q; r += kWarps) {
    const float w = expf(slast - sh_s[r]) * sh_dt[r], es = expf(sh_s[r]);
    const size_t src = (((size_t)bb * d.T + c * Q + r) * d.H + h) * d.P;
    const size_t dst = ((size_t)blk * Q + r) * d.P;
    const size_t gdst = d.gm<kOne>(Q, bb, c, h, r, 0, src);
    for (int p = lane; p < d.P; p += 32) {
      const bf16 v = x[src + p];
      xh[dst + p] = v;
      st(xw + gdst + p, __bfloat162float(v) * w);
      if (dy) {
        const bf16 g2 = dy[src + p];
        dyh[dst + p] = g2;
        st(dye + gdst + p, __bfloat162float(g2) * es);
      }
    }
  }
}

template <int Q, bool kOne>
__global__ void __launch_bounds__(Q) ssd_fwd_prep_kernel(Dims d, const bf16* x, const float* dt,
                                                         const float* A, const float* G, float* s,
                                                         float* e, bf16* M, bf16* xh, bf16* xw) {
  prep<Q, kOne>(d, x, dt, A, G, s, e, M, xh, xw, nullptr, nullptr, nullptr, nullptr);
}

template <int Q, bool kOne>
__global__ void __launch_bounds__(Q) ssd_bwd_prep_kernel(Dims d, const bf16* x, const float* dt,
                                                         const float* A, const float* G, float* s,
                                                         float* e, bf16* M, bf16* xh, bf16* xw,
                                                         const bf16* dy, bf16* dyh, bf16* dye,
                                                         float* dtT) {
  prep<Q, kOne>(d, x, dt, A, G, s, e, M, xh, xw, dy, dyh, dye, dtT);
}

// The state pass: one thread an element k of a (batch row, head)'s (P, N)
// state, in order over the chunks: Hin_c = H_c, H_{c+1} = e_c H_c + S_c, in
// float32; Hb_c = H_c rounded to bf16, the products' operand.
__device__ __forceinline__ void state_pass(const Dims d, int PN, const float* S, const float* e,
                                           float* Hin, bf16* Hb) {
  const int bh = blockIdx.x, bb = bh / d.H, h = bh % d.H;
  const int k = blockIdx.y * kPass + threadIdx.x;
  if (k >= PN) return;
  float state = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const size_t idx = (((size_t)bb * d.nc + c) * d.H + h) * PN + k;
    Hin[idx] = state;
    st(Hb + idx, state);
    state = e[(size_t)bh * d.nc + c] * state + S[idx];
  }
}

__global__ void __launch_bounds__(kPass) ssd_fwd_state_pass_kernel(Dims d, int PN, const float* S,
                                                                   const float* e, float* Hin,
                                                                   bf16* Hb) {
  state_pass(d, PN, S, e, Hin, Hb);
}

__global__ void __launch_bounds__(kPass) ssd_bwd_state_pass_kernel(Dims d, int PN, const float* S,
                                                                   const float* e, float* Hin,
                                                                   bf16* Hb) {
  state_pass(d, PN, S, e, Hin, Hb);
}

// y = y_diag + exp(s) y_off + D x, one thread an element, in y's order.
template <int Q, bool kOne>
__global__ void __launch_bounds__(256) ssd_fwd_combine_kernel(Dims d, const bf16* ydiag,
                                                              const bf16* yoff, const float* s,
                                                              const bf16* x, const float* D,
                                                              bf16* y) {
  const size_t n = (size_t)d.b * d.T * d.H * d.P;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int p = idx % d.P;
    const size_t rest = idx / d.P;
    const int h = rest % d.H;
    const size_t bt = rest / d.H;
    const int t = bt % d.T, bb = bt / d.T, c = t / Q, i = t % Q;
    const size_t di = ((((size_t)bb * d.nc + c) * d.H + h) * Q + i) * d.P + p;
    const float es = expf(s[((size_t)bb * d.H + h) * d.T + t]);
    st(y + idx, ld(ydiag + di) + es * ld(yoff + d.gm<kOne>(Q, bb, c, h, i, p, idx)) + D[h] * ld(x + idx));
  }
}

// The reverse state pass: g = dH_{c+1}, the gradient of the state after
// chunk c; dS_c = g, de_c = <g, H_c>, and dH_c = dH_local_c + e_c g.
__global__ void __launch_bounds__(kPass) ssd_bwd_reverse_pass_kernel(Dims d, int PN,
                                                                     const bf16* dHloc,
                                                                     const float* Hin,
                                                                     const float* e, bf16* dS,
                                                                     float* de) {
  __shared__ float tmp[kPass / 32];
  const int bh = blockIdx.x, bb = bh / d.H, h = bh % d.H;
  const int k = blockIdx.y * kPass + threadIdx.x;
  const bool on = k < PN;
  float g = 0.f;
  for (int c = d.nc - 1; c >= 0; --c) {
    const size_t idx = (((size_t)bb * d.nc + c) * d.H + h) * PN + k;
    float part = 0.f;
    if (on) {
      st(dS + idx, g);
      part = g * Hin[idx];
    }
    part = warp_sum(part);
    if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < kPass / 32; ++w) t += tmp[w];
      atomicAdd(de + (size_t)bh * d.nc + c, t);
    }
    __syncthreads();
    if (on) g = ld(dHloc + idx) + e[(size_t)bh * d.nc + c] * g;
  }
}

// The mask's gradient.  One block a (batch row, chunk, group, kRows rows),
// one thread a column j, looping over the group's heads: P = dM G exp(s_i -
// s_j) (j <= i); dG[i, j] = sum_h dM exp(s_i - s_j) dt_j, ds_i += sum_j P
// dt_j, ds_j -= dt_j sum_i P, ddt_j += sum_i P.
template <int Q, bool kOne>
__global__ void __launch_bounds__(Q) ssd_bwd_mask_kernel(Dims d, const bf16* dM, const float* G,
                                                         const float* s, const float* dtT,
                                                         float* dG, float* ds, float* ddt_acc) {
  __shared__ float sh_si[kRows], sh_row[kRows];
  constexpr int nrb = Q / kRows;
  const int bcg = blockIdx.x / nrb, i0 = (blockIdx.x % nrb) * kRows;
  const int bc = kOne ? bcg : bcg / d.NG, grp = kOne ? 0 : bcg % d.NG;
  const int bb = bc / d.nc, c = bc % d.nc;
  const int j = threadIdx.x, lane = j & 31, warp0 = j & ~31;
  const float* g = G + (size_t)bcg * Q * Q;
  float gij[kRows], acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    gij[r] = g[(size_t)(i0 + r) * Q + j];
    acc[r] = 0.f;
  }
  const bool live = j <= i0 + kRows - 1;  // some row of the block is at or below j's diagonal
  const int h0 = kOne ? 0 : grp * d.Hg, h1 = kOne ? d.H : h0 + d.Hg;
  for (int h = h0; h < h1; ++h) {
    const size_t row0 = ((size_t)bb * d.H + h) * d.T + (size_t)c * Q;
    if (j < kRows) {
      sh_si[j] = s[row0 + i0 + j];
      sh_row[j] = 0.f;
    }
    __syncthreads();
    const float sj = s[row0 + j], dtj = dtT[row0 + j];
    const bf16* m = dM + ((size_t)bc * d.H + h) * Q * Q;
    float col = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (warp0 > i) continue;  // the whole warp lies above the diagonal
      float rowv = 0.f;
      if (j <= i) {
        const float me = ld(m + (size_t)i * Q + j) * __expf(sh_si[r] - sj);
        acc[r] += me * dtj;
        const float pij = me * gij[r];
        col += pij;
        rowv = pij * dtj;
      }
      rowv = warp_sum(rowv);
      if (lane == 0) atomicAdd(&sh_row[r], rowv);
    }
    __syncthreads();
    if (j < kRows) atomicAdd(ds + row0 + i0 + j, sh_row[j]);
    if (live) {
      atomicAdd(ds + row0 + j, -col * dtj);
      atomicAdd(ddt_acc + row0 + j, col);
    }
    __syncthreads();
  }
  float* out = dG + (size_t)bcg * Q * Q;
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[(size_t)(i0 + r) * Q + j] = acc[r];
}

// The finish.  One block a (batch row, chunk, head).  A warp a row: dx =
// dx_diag + w d(xw) + D dy, and the row's dw = <x, d(xw)>, its y_off term
// <dy, y_off> e^s and <dy, x> for dD.  Then a thread a position: ds gains
// the y_off term, -w dw, and at the chunk's last position sum w dw and e_c
// de_c; the gradient of a = dt A is the reverse inclusive sum of ds; ddt =
// ddt_acc + exp(s_last - s) dw + A da, dA += sum dt da.
template <int Q, bool kOne>
__global__ void __launch_bounds__(Q) ssd_bwd_finish_kernel(
    Dims d, const bf16* dxdiag, const bf16* dxw, const bf16* dy, const bf16* x, const bf16* yoff,
    const float* s, const float* dtT, const float* e, const float* de, const float* A,
    const float* D, const float* ds, const float* ddt_acc, bf16* dx, float* ddt, float* dA,
    float* dD) {
  constexpr int kWarps = Q / 32;
  __shared__ float sh_s[Q], sh_dw[Q], sh_yo[Q], tmp[kWarps];
  const int blk = blockIdx.x, h = blk % d.H, bc = blk / d.H, bb = bc / d.nc, c = bc % d.nc;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const size_t row0 = ((size_t)bb * d.H + h) * d.T + (size_t)c * Q;
  sh_s[i] = s[row0 + i];
  __syncthreads();
  const float slast = sh_s[Q - 1], Dh = D[h];
  float dDp = 0.f;
  for (int r = warp; r < Q; r += kWarps) {
    const float w = expf(slast - sh_s[r]) * dtT[row0 + r];
    const size_t src = (((size_t)bb * d.T + c * Q + r) * d.H + h) * d.P;
    const size_t hm = ((size_t)blk * Q + r) * d.P;
    const size_t gsrc = d.gm<kOne>(Q, bb, c, h, r, 0, src);
    float dw = 0.f, yo = 0.f;
    for (int p = lane; p < d.P; p += 32) {
      const float g = ld(dy + src + p), xv = ld(x + src + p), gw = ld(dxw + gsrc + p);
      st(dx + src + p, ld(dxdiag + hm + p) + w * gw + Dh * g);
      dw += xv * gw;
      yo += g * ld(yoff + gsrc + p);
      dDp += g * xv;
    }
    dw = warp_sum(dw);
    yo = warp_sum(yo);
    if (lane == 0) {
      sh_dw[r] = dw;
      sh_yo[r] = yo * expf(sh_s[r]);
    }
  }
  __syncthreads();
  const float dDsum = block_sum<Q>(dDp, tmp);
  const float si = sh_s[i], dti = dtT[row0 + i], decay = expf(slast - si), wi = decay * dti;
  const float dwi = sh_dw[i];
  float dsi = ds[row0 + i] + sh_yo[i] - wi * dwi;
  const float last = block_sum<Q>(wi * dwi, tmp);
  if (i == Q - 1) dsi += last + expf(slast) * de[((size_t)bb * d.H + h) * d.nc + c];
  const float incl = block_scan<Q>(dsi, tmp);
  const float total = block_sum<Q>(dsi, tmp);
  const float da = total - incl + dsi;  // sum of ds over positions >= i
  ddt[((size_t)bb * d.T + (size_t)c * Q + i) * d.H + h] =
      ddt_acc[row0 + i] + decay * dwi + A[h] * da;
  const float dAsum = block_sum<Q>(dti * da, tmp);
  if (i == 0) {
    atomicAdd(dA + h, dAsum);
    atomicAdd(dD + h, dDsum);
  }
}

bool chunk_ok(int Q) { return Q == 128 || Q == 256; }

// The dims of a call, or nc = 0 where the kernels do not take them.
Dims dims_of(int b, int T, int H, int P, int NG, int Q) {
  Dims d{b, T, H, P, 0, NG, 0};
  if (chunk_ok(Q) && b > 0 && H > 0 && P > 0 && NG > 0 && H % NG == 0 && T > 0 && T % Q == 0) {
    d.nc = T / Q;
    d.Hg = H / NG;
  }
  return d;
}

int blocks_for(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 132 * 32 ? b : 132 * 32);
}

// Launch `kernel<Q, one group>` for the chunk Q (128 or 256) and d's groups.
#define HH_BY_CHUNK(Q, kernel, grid, block, stream, d, ...)                               \
  do {                                                                                  \
    if ((Q) == 128 && (d).NG == 1)                                                      \
      kernel<128, true><<<(grid), (block), 0, (stream)>>>((d), __VA_ARGS__);            \
    else if ((Q) == 128)                                                                \
      kernel<128, false><<<(grid), (block), 0, (stream)>>>((d), __VA_ARGS__);           \
    else if ((d).NG == 1)                                                               \
      kernel<256, true><<<(grid), (block), 0, (stream)>>>((d), __VA_ARGS__);            \
    else                                                                                \
      kernel<256, false><<<(grid), (block), 0, (stream)>>>((d), __VA_ARGS__);           \
  } while (0)

}  // namespace

extern "C" {

// 1 where the kernels take a chunk of Q positions (128 or 256), else 0.
int hh_ssd_chunk_ok(int Q) { return chunk_ok(Q) ? 1 : 0; }

// The forward's prep: s, e, M, x_h, xw (layouts above), for NG groups of
// heads and chunks of Q.  Returns cudaGetLastError() of the launch.
int hh_ssd_fwd_prep(int b, int T, int H, int P, int NG, int Q, const void* x, const float* dt,
                    const float* A, const float* G, float* s, float* e, void* M, void* xh,
                    void* xw, void* stream) {
  const Dims d = dims_of(b, T, H, P, NG, Q);
  if (!d.nc) return (int)cudaErrorInvalidValue;
  HH_BY_CHUNK(Q, ssd_fwd_prep_kernel, b * d.nc * H, Q, static_cast<cudaStream_t>(stream), d,
              static_cast<const bf16*>(x), dt, A, G, s, e, static_cast<bf16*>(M),
              static_cast<bf16*>(xh), static_cast<bf16*>(xw));
  return (int)cudaGetLastError();
}

// The backward's prep: the forward's, and dy_h, dye, dt^T.
int hh_ssd_bwd_prep(int b, int T, int H, int P, int NG, int Q, const void* x, const float* dt,
                    const float* A, const float* G, float* s, float* e, void* M, void* xh,
                    void* xw, const void* dy, void* dyh, void* dye, float* dtT, void* stream) {
  const Dims d = dims_of(b, T, H, P, NG, Q);
  if (!d.nc) return (int)cudaErrorInvalidValue;
  HH_BY_CHUNK(Q, ssd_bwd_prep_kernel, b * d.nc * H, Q, static_cast<cudaStream_t>(stream), d,
              static_cast<const bf16*>(x), dt, A, G, s, e, static_cast<bf16*>(M),
              static_cast<bf16*>(xh), static_cast<bf16*>(xw), static_cast<const bf16*>(dy),
              static_cast<bf16*>(dyh), static_cast<bf16*>(dye), dtT);
  return (int)cudaGetLastError();
}

// The state pass over the chunks' float32 states S (b nc, H P, N) into the
// float32 entering states Hin and their bf16 copy Hb; `backward` != 0
// launches the backward's recompute (its own kernel name, for the profile).
int hh_ssd_state_pass(int b, int T, int H, int P, int N, int Q, const float* S, const float* e,
                      float* Hin, void* Hb, int backward, void* stream) {
  const Dims d = dims_of(b, T, H, P, 1, Q);
  if (!d.nc || N <= 0) return (int)cudaErrorInvalidValue;
  const int PN = P * N;
  const dim3 grid(b * H, (PN + kPass - 1) / kPass);
  auto st_ = static_cast<cudaStream_t>(stream);
  auto hb = static_cast<bf16*>(Hb);
  if (backward)
    ssd_bwd_state_pass_kernel<<<grid, kPass, 0, st_>>>(d, PN, S, e, Hin, hb);
  else
    ssd_fwd_state_pass_kernel<<<grid, kPass, 0, st_>>>(d, PN, S, e, Hin, hb);
  return (int)cudaGetLastError();
}

// y = y_diag + exp(s) y_off + D x.
int hh_ssd_fwd_combine(int b, int T, int H, int P, int NG, int Q, const void* ydiag,
                       const void* yoff, const float* s, const void* x, const float* D, void* y,
                       void* stream) {
  const Dims d = dims_of(b, T, H, P, NG, Q);
  if (!d.nc) return (int)cudaErrorInvalidValue;
  HH_BY_CHUNK(Q, ssd_fwd_combine_kernel, blocks_for((size_t)b * T * H * P), 256,
              static_cast<cudaStream_t>(stream), d, static_cast<const bf16*>(ydiag),
              static_cast<const bf16*>(yoff), s, static_cast<const bf16*>(x), D,
              static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}

// The reverse state pass: dS and de (zeroed by the caller, summed into).
int hh_ssd_bwd_reverse_pass(int b, int T, int H, int P, int N, int Q, const void* dHloc,
                            const float* Hin, const float* e, void* dS, float* de, void* stream) {
  const Dims d = dims_of(b, T, H, P, 1, Q);
  if (!d.nc || N <= 0) return (int)cudaErrorInvalidValue;
  const int PN = P * N;
  const dim3 grid(b * H, (PN + kPass - 1) / kPass);
  ssd_bwd_reverse_pass_kernel<<<grid, kPass, 0, static_cast<cudaStream_t>(stream)>>>(
      d, PN, static_cast<const bf16*>(dHloc), Hin, e,
      static_cast<bf16*>(dS), de);
  return (int)cudaGetLastError();
}

// The mask's gradient: dG (b nc NG, Q, Q), and ds and ddt_acc (zeroed by
// the caller, summed into).
int hh_ssd_bwd_mask(int b, int T, int H, int P, int NG, int Q, const void* dM, const float* G,
                    const float* s, const float* dtT, float* dG, float* ds, float* ddt_acc,
                    void* stream) {
  const Dims d = dims_of(b, T, H, P, NG, Q);
  if (!d.nc) return (int)cudaErrorInvalidValue;
  HH_BY_CHUNK(Q, ssd_bwd_mask_kernel, b * d.nc * NG * (Q / kRows), Q,
              static_cast<cudaStream_t>(stream), d, static_cast<const bf16*>(dM), G, s, dtT, dG,
              ds, ddt_acc);
  return (int)cudaGetLastError();
}

// The finish: dx, ddt, and dA and dD (zeroed by the caller, summed into).
int hh_ssd_bwd_finish(int b, int T, int H, int P, int NG, int Q, const void* dxdiag,
                      const void* dxw, const void* dy, const void* x, const void* yoff,
                      const float* s, const float* dtT, const float* e, const float* de,
                      const float* A, const float* D, const float* ds, const float* ddt_acc,
                      void* dx, float* ddt, float* dA, float* dD, void* stream) {
  const Dims d = dims_of(b, T, H, P, NG, Q);
  if (!d.nc) return (int)cudaErrorInvalidValue;
  HH_BY_CHUNK(Q, ssd_bwd_finish_kernel, b * d.nc * H, Q, static_cast<cudaStream_t>(stream), d,
              static_cast<const bf16*>(dxdiag), static_cast<const bf16*>(dxw),
              static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
              static_cast<const bf16*>(yoff), s, dtT, e, de, A, D, ds, ddt_acc,
              static_cast<bf16*>(dx), ddt, dA, dD);
  return (int)cudaGetLastError();
}

const char* hh_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
