// Kernel I: entry extraction from a batch of HSS matrices.
//
// Replaces hsolve/ops/hss.py `hss_entries_prepared` (:293-312), which XLA
// lowered as a D gather plus, for EVERY internal level, two row gathers and a
// batched product, then a select by the leaf pair's LCA level:
//
//   out[b, j, a, c] = D[b, row / ls][row % ls][col % ls]     same leaf
//                   = T[b, lev-1, row, :] . V[b, lev-1, col, :]  otherwise
//
// with row = rows[b, j, a], col = cols[b, j, c] and lev the bit length of
// (row / ls) ^ (col / ls), the level of the two leaves' lowest common
// ancestor (the JAX code's ceil(log2(x + 1)), without the rounding).
// `T` folds each row's materialized basis with its node's B12 or B21 and `V`
// holds the materialized column bases (hss_entry_factors, once per matrix).
// An index outside [0, n_pad) yields NaN rather than a stray read.
//
// Bound: bytes.  An index block of p rows and q columns needs, per LCA level
// present in it, its p T rows and q V rows (r doubles each), one D entry per
// same-leaf entry, the indices and the p q outputs.
//
// The indices are read through their strides (rows[b, j, a] at rows + b srb
// + j srm + a srp), so an expanded index block needs no copy.
//
// Design: one CTA of 256 threads per (index block, 64 x 64 tile of it).  It
// stages the tile's indices, finds the levels its entries meet, and per
// level streams the tile's T and V rows through shared memory in 32-column
// slices (coalesced: 16 lanes along a row), so each row is read once per
// block and level, not once per entry.  Each thread keeps a 4 x 4 register
// tile of the 64 x 64 product (rows ty + 16 i, columns tx + 16 j) and keeps
// the entries whose level is the one being summed.  Same-leaf entries load
// their D entry directly (lanes along a D row).  A block whose entries all
// meet one level (the compressors' B12/B21 and leaf blocks) takes one pass.
//
// Values are float64 (hs_hss_entries), float32 (hs_hss_entries_f32, the JAX
// bench's device configuration: 64-column slices, the same 34 KB, summed in
// float32) or complex128 (hs_hss_entries_c128,
// the damped Helmholtz system's levels): the product stays T . V with no
// conjugate (hsolve/ops/hss.py:293-313), a complex multiply-add as four
// real ones on the CUDA cores.  A complex128 slice is 16 columns, so the two
// staged tiles take 34 KB, within the 48 KB of static shared memory, as the
// float64 ones' 32 columns do.  Complex64 (hs_hss_entries_c64, the bench's
// complex device configuration) takes 32-column slices, the same 34 KB,
// summed in complex64.
#include <math.h>

#include "hs_common.cuh"
#include "hs_complex.cuh"

#define I_TILE 64

template <typename VT>
__global__ void __launch_bounds__(256) hss_entries_kernel(
    const VT* __restrict__ D, const VT* __restrict__ T,
    const VT* __restrict__ V, const long long* __restrict__ rows,
    const long long* __restrict__ cols, VT* __restrict__ out,
    long long srb, long long srm, long long srp, long long scb, long long scm,
    long long scq, int M, int p, int q, int n_pad, int ls, int r, int depth,
    int tiles_q) {
  // T / V columns a slice (16 lanes along a row, VPL values a lane)
  constexpr int I_RC = 256 / (int)sizeof(VT);
  constexpr int I_LD = I_RC + 1;
  constexpr int VPL = I_RC / 16;
  __shared__ VT Ts[I_TILE][I_LD];
  __shared__ VT Vs[I_TILE][I_LD];
  __shared__ int ri[I_TILE], ci[I_TILE];
  __shared__ unsigned levels;
  const int64_t bj = blockIdx.x;  // b * M + j
  const int64_t b = bj / M, j = bj - b * M;
  const long long* rw = rows + b * srb + j * srm;  // rows[b, j, :]
  const long long* cw = cols + b * scb + j * scm;
  const int a0 = (blockIdx.y / tiles_q) * I_TILE;
  const int c0 = (blockIdx.y % tiles_q) * I_TILE;
  const int tp = min(I_TILE, p - a0), tq = min(I_TILE, q - c0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // an index outside [0, n_pad) becomes -1 (NaN), whatever its width
  if (tid < I_TILE) {
    const long long v = tid < tp ? rw[(a0 + tid) * srp] : -1;
    ri[tid] = v >= 0 && v < n_pad ? (int)v : -1;
  } else if (tid < 2 * I_TILE) {
    const int t = tid - I_TILE;
    const long long v = t < tq ? cw[(c0 + t) * scq] : -1;
    ci[t] = v >= 0 && v < n_pad ? (int)v : -1;
  }
  if (tid == 0) levels = 0;
  __syncthreads();

  // the entries' levels: -1 out of range (or outside the tile), 0 same leaf
  int lev[4][4];
  VT o[4][4];
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ri[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ci[tx + 16 * j];
      int lv = -1;
      if (ty + 16 * i < tp && tx + 16 * j < tq) {
        if (row >= 0 && col >= 0) {
          const int x = (row / ls) ^ (col / ls);
          lv = x == 0 ? 0 : 32 - __clz(x);
        } else {
          lv = -2;  // in the tile, out of range: NaN
        }
      }
      lev[i][j] = lv;
      o[i][j] = lv == -2 ? VT(NAN) : VT(0.0);
      if (lv == 0) o[i][j] = hs_ldg(D + (b * n_pad + row) * ls + col % ls);
      if (lv > 0) mine |= 1u << lv;
    }
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if ((tid & 31) == 0 && mine) atomicOr(&levels, mine);
  __syncthreads();
  const unsigned lv_mask = levels;

  for (int L = 1; L <= depth; ++L) {
    if (!(lv_mask & (1u << L))) continue;  // uniform across the CTA
    const int64_t base = (b * depth + L - 1) * (int64_t)n_pad;
    VT s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = VT(0.0);
    for (int k0 = 0; k0 < r; k0 += I_RC) {
      // stage the slice: 16 lanes along a row, VPL values a lane
      for (int e = tid; e < I_TILE * 16; e += 256) {
        const int a = e >> 4, kk = VPL * (e & 15);
        const int rt = ri[a], cv = ci[a];
        const bool rok = a < tp && rt >= 0;
        const bool cok = a < tq && cv >= 0;
        const VT* tr = T + (base + (rok ? rt : 0)) * r + k0;
        const VT* vr = V + (base + (cok ? cv : 0)) * r + k0;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const bool kin = k0 + kk + u < r;
          Ts[a][kk + u] = rok && kin ? hs_ldg(tr + kk + u) : VT(0.0);
          Vs[a][kk + u] = cok && kin ? hs_ldg(vr + kk + u) : VT(0.0);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < I_RC; ++kk) {
        VT tv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tv[i] = Ts[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = Vs[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += tv[i] * vv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lev[i][j] == L) o[i][j] = s[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = ty + 16 * i;
    if (a >= tp) continue;
    VT* orow = out + (bj * p + a0 + a) * q + c0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tx + 16 * j < tq) orow[tx + 16 * j] = o[i][j];
  }
}

template <typename VT>
static int launch_entries(const void* D, const void* T, const void* V,
                          const void* rows, const void* cols, void* out,
                          long long srb, long long srm, long long srp,
                          long long scb, long long scm, long long scq,
                          long long B, int M, int p, int q, int n_pad, int ls,
                          int r, int depth, void* stream) {
  if (B < 0 || M < 0 || p < 0 || q < 0 || depth < 1 || depth > 30 || ls < 1)
    return (int)cudaErrorInvalidValue;
  if (B * M == 0 || p == 0 || q == 0) return (int)cudaSuccess;
  const int tiles_q = (q + I_TILE - 1) / I_TILE;
  const int tiles = ((p + I_TILE - 1) / I_TILE) * tiles_q;
  hss_entries_kernel<VT><<<dim3((unsigned)(B * M), (unsigned)tiles), 256, 0,
                           (cudaStream_t)stream>>>(
      (const VT*)D, (const VT*)T, (const VT*)V, (const long long*)rows,
      (const long long*)cols, (VT*)out, srb, srm, srp, scb, scm, scq, M, p, q,
      n_pad, ls, r, depth, tiles_q);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_hss_entries(const void* D, const void* T, const void* V,
                             const void* rows, const void* cols, void* out,
                             long long srb, long long srm, long long srp,
                             long long scb, long long scm, long long scq,
                             long long B, int M, int p, int q, int n_pad,
                             int ls, int r, int depth, void* stream) {
  return launch_entries<double>(D, T, V, rows, cols, out, srb, srm, srp, scb,
                                scm, scq, B, M, p, q, n_pad, ls, r, depth,
                                stream);
}

HS_EXPORT int hs_hss_entries_f32(const void* D, const void* T, const void* V,
                                 const void* rows, const void* cols, void* out,
                                 long long srb, long long srm, long long srp,
                                 long long scb, long long scm, long long scq,
                                 long long B, int M, int p, int q, int n_pad,
                                 int ls, int r, int depth, void* stream) {
  return launch_entries<float>(D, T, V, rows, cols, out, srb, srm, srp, scb,
                               scm, scq, B, M, p, q, n_pad, ls, r, depth,
                               stream);
}

HS_EXPORT int hs_hss_entries_c128(const void* D, const void* T, const void* V,
                                  const void* rows, const void* cols,
                                  void* out, long long srb, long long srm,
                                  long long srp, long long scb, long long scm,
                                  long long scq, long long B, int M, int p,
                                  int q, int n_pad, int ls, int r, int depth,
                                  void* stream) {
  return launch_entries<hs_c128>(D, T, V, rows, cols, out, srb, srm, srp, scb,
                                 scm, scq, B, M, p, q, n_pad, ls, r, depth,
                                 stream);
}

HS_EXPORT int hs_hss_entries_c64(const void* D, const void* T, const void* V,
                                 const void* rows, const void* cols, void* out,
                                 long long srb, long long srm, long long srp,
                                 long long scb, long long scm, long long scq,
                                 long long B, int M, int p, int q, int n_pad,
                                 int ls, int r, int depth, void* stream) {
  return launch_entries<hs_c64>(D, T, V, rows, cols, out, srb, srm, srp, scb,
                                scm, scq, B, M, p, q, n_pad, ls, r, depth,
                                stream);
}
