// Kernel I: entry extraction from a batch of HSS matrices.
//
// Replaces hsolve/ops/hss.py `hss_entries_prepared` (:293-312), which XLA
// lowered as a D gather plus, for EVERY internal level, two row gathers and a
// batched product, then a select by the leaf pair's LCA level.  Here each
// entry costs one load or one r-long dot, at its LCA level only:
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
// Bound: memory latency.  The randomized compressors extract the leaf D
// blocks ([B, nl, ls, ls]) and one [r, r] coupling block per node and level;
// every entry reads two r-long rows (r = 48 at the n=512 plan), which the
// entries of one block share through L1/L2.  One thread per entry, threads
// along the block's columns, so a warp reads one T row (a broadcast) and
// neighbouring V rows.
#include <math.h>

#include "hs_common.cuh"

__global__ void hss_entries_kernel(const double* __restrict__ D,
                                   const double* __restrict__ T,
                                   const double* __restrict__ V,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ cols,
                                   double* __restrict__ out, int64_t total,
                                   int M, int p, int q, int n_pad, int ls,
                                   int r, int depth) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % q);
    const int64_t t = e / q;
    const int a = (int)(t % p);
    const int64_t bj = t / p;  // b * M + j
    const int64_t b = bj / M;
    const int row = rows[bj * p + a];
    const int col = cols[bj * q + c];
    double v;
    if (row < 0 || row >= n_pad || col < 0 || col >= n_pad) {
      v = NAN;
    } else {
      const int x = (row / ls) ^ (col / ls);
      if (x == 0) {
        v = D[(b * n_pad + row) * ls + col % ls];
      } else {
        const int lev = 32 - __clz(x);  // 1..depth
        const int64_t base = (b * depth + lev - 1) * (int64_t)n_pad;
        const double* tr = T + (base + row) * r;
        const double* vr = V + (base + col) * r;
        double s = 0.0;
        for (int i = 0; i < r; ++i) s += tr[i] * vr[i];
        v = s;
      }
    }
    out[e] = v;
  }
}

HS_EXPORT int hs_hss_entries(const void* D, const void* T, const void* V,
                             const void* rows, const void* cols, void* out,
                             long long B, int M, int p, int q, int n_pad,
                             int ls, int r, int depth, void* stream) {
  const int64_t total = (int64_t)B * M * p * q;
  if (total > 0) {
    const int threads = 256;
    hss_entries_kernel<<<hs_blocks(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (const double*)D, (const double*)T, (const double*)V,
        (const int*)rows, (const int*)cols, (double*)out, total, M, p, q,
        n_pad, ls, r, depth);
  }
  return (int)cudaGetLastError();
}
