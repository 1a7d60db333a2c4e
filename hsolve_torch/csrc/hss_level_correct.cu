// Kernel K: one level of the telescoping Woodbury correction of an HSS solve.
//
// Replaces hsolve/ops/hss.py `_apply_level_correction` after its upsweep
// (:641-658): a concatenation, two batched coupling products, a pivoted LU
// solve (a gather and two triangular solves) and a batched GEMM-subtract,
// per level of every hss_solve.  Per node j of the level, with the children's
// upsweep xi [2m, r, k], the stored LU (lu, perm) of the 2r x 2r core and the
// correction basis Phi [n_pad, r]:
//
//   eta = [op(Bl[j]) xi[2j+1]; op(Br[j]) xi[2j]]      op = transpose if set
//   w   = U^{-1} L^{-1} eta[perm]                      (lu_solve)
//   Y[rows of child 2j + s] -= Phi[those rows] w[s r : (s + 1) r]   s = 0, 1
//
// in place on Y [B, n_pad, k].  The forward solve passes (B12, B21, M), the
// adjoint (B21, B12, N) with transpose set.
//
// Bound: latency.  It runs in hss_factor (k = r = 48) and in every hss_solve,
// three or four times per structured level per preconditioner application
// (k = 1 in GMRES); the core is 96 x 96 and the triangular solves are a chain
// of 2 * 2r dependent rows.  One block per (node, tile of kc columns) stages
// the core's LU (rows padded by one double against bank conflicts) and its
// permutation in shared memory, coalesced, beside eta and w.  Both triangular
// solves are blocked: a 32-row diagonal block is solved by one warp per
// column with one lane per row, each solved value broadcast by a shuffle (32
// dependent steps of one multiply-add), and the whole block then updates the
// rows below (above) it, so the dependent chain is 2 * ceil(2r / 32) warp
// solves instead of 2 * 2r reductions.
#include "hs_common.cuh"

#define K_THREADS 256
#define K_FULL 0xffffffffu

__global__ void __launch_bounds__(K_THREADS) hss_level_correct_kernel(
    double* Y, const double* __restrict__ xi, const double* __restrict__ Bl,
    const double* __restrict__ Br, const double* __restrict__ lu,
    const long long* __restrict__ perm, const double* __restrict__ Phi, int m,
    int r, int blk, int k, int kc, int transpose) {
  extern __shared__ double smem[];
  const int r2 = 2 * r;
  double* eta = smem;              // [2r][kc]
  double* w = eta + r2 * kc;       // [2r][kc]
  const int ld = r2 + 1;           // padded row stride of LU
  double* LU = w + r2 * kc;        // [2r][ld] the core's LU
  int* pv = (int*)(LU + r2 * ld);  // [2r] its row permutation
  const int64_t bj = blockIdx.x;  // b * m + j
  const int64_t b = bj / m;
  const int j = (int)(bj - b * m);
  const int c0 = blockIdx.y * kc;
  const int nc = min(kc, k - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t rr = (int64_t)r * r;
  const int64_t npad = (int64_t)2 * m * blk;
  const double* xb = xi + (b * 2 * m + 2 * j) * (int64_t)r * k;  // child 2j
  double* Yb = Y + b * npad * k;
  const double* lub = lu + bj * (int64_t)r2 * r2;
  for (int e = tid; e < r2 * r2; e += K_THREADS)
    LU[(e / r2) * ld + e % r2] = lub[e];
  for (int e = tid; e < r2; e += K_THREADS) pv[e] = (int)perm[bj * r2 + e];

  // eta[s r + a][c] = sum_i op(C_s)[a][i] xi[2j + 1 - s][i][c]
  for (int e = tid; e < r2 * nc; e += K_THREADS) {
    const int c = e % nc, row = e / nc;
    const int s = row >= r, a = row - s * r;
    const double* cp = (s ? Br : Bl) + bj * rr;
    const double* xp = xb + (int64_t)(1 - s) * r * k + c0 + c;
    double acc = 0.0;
    if (!transpose) {
      for (int i = 0; i < r; ++i) acc += cp[(int64_t)a * r + i] * xp[(int64_t)i * k];
    } else {
      for (int i = 0; i < r; ++i) acc += cp[(int64_t)i * r + a] * xp[(int64_t)i * k];
    }
    eta[row * kc + c] = acc;
  }
  __syncthreads();
  // w = U^{-1} L^{-1} eta[perm], blocked by 32 rows
  for (int e = tid; e < r2 * nc; e += K_THREADS) {
    const int c = e % nc, i = e / nc;
    w[i * kc + c] = eta[pv[i] * kc + c];
  }
  __syncthreads();
  const int nb = (r2 + 31) / 32;
  for (int jb = 0; jb < nb; ++jb) {  // unit lower
    const int j0 = jb * 32, bs = min(32, r2 - j0);
    for (int c = warp; c < nc; c += K_THREADS / 32) {
      double x = lane < bs ? w[(j0 + lane) * kc + c] : 0.0;
      for (int j = 0; j < bs - 1; ++j) {
        const double xj = __shfl_sync(K_FULL, x, j);
        if (lane > j && lane < bs) x -= LU[(j0 + lane) * ld + j0 + j] * xj;
      }
      if (lane < bs) w[(j0 + lane) * kc + c] = x;
    }
    __syncthreads();
    for (int e = tid; e < (r2 - j0 - bs) * nc; e += K_THREADS) {  // rows below
      const int c = e % nc, i = j0 + bs + e / nc;
      const double* li = LU + i * ld + j0;
      double acc = 0.0;
      for (int j = 0; j < bs; ++j) acc += li[j] * w[(j0 + j) * kc + c];
      w[i * kc + c] -= acc;
    }
    __syncthreads();
  }
  for (int jb = nb - 1; jb >= 0; --jb) {  // upper
    const int j0 = jb * 32, bs = min(32, r2 - j0);
    for (int c = warp; c < nc; c += K_THREADS / 32) {
      double x = lane < bs ? w[(j0 + lane) * kc + c] : 0.0;
      for (int j = bs - 1; j >= 0; --j) {
        if (lane == j) x /= LU[(j0 + j) * ld + j0 + j];
        const double xj = __shfl_sync(K_FULL, x, j);
        if (lane < j) x -= LU[(j0 + lane) * ld + j0 + j] * xj;
      }
      if (lane < bs) w[(j0 + lane) * kc + c] = x;
    }
    __syncthreads();
    for (int e = tid; e < j0 * nc; e += K_THREADS) {  // rows above
      const int c = e % nc, i = e / nc;
      const double* ui = LU + i * ld + j0;
      double acc = 0.0;
      for (int j = 0; j < bs; ++j) acc += ui[j] * w[(j0 + j) * kc + c];
      w[i * kc + c] -= acc;
    }
    __syncthreads();
  }
  // Y[child rows] -= Phi[child rows] w[child part]
  const int64_t row0 = (int64_t)2 * j * blk;
  for (int e = tid; e < 2 * blk * nc; e += K_THREADS) {
    const int c = e % nc, i = e / nc;
    const int s = i >= blk;
    const double* pp = Phi + (b * npad + row0 + i) * r;
    const double* wp = w + (int64_t)s * r * kc + c;
    double acc = 0.0;
    for (int a = 0; a < r; ++a) acc += pp[a] * wp[a * kc];
    Yb[(row0 + i) * k + c0 + c] -= acc;
  }
}

HS_EXPORT int hs_hss_level_correct(void* Y, const void* xi, const void* Bl,
                                   const void* Br, const void* lu,
                                   const void* perm, const void* Phi,
                                   long long B, int m, int r, int blk, int k,
                                   int kc, int transpose, void* stream) {
  if (B > 0 && m > 0 && r > 0 && k > 0 && kc > 0) {
    const size_t smem =
        ((size_t)4 * r * kc + (size_t)2 * r * (2 * r + 1)) * sizeof(double) +
        (size_t)2 * r * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hss_level_correct_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)(B * m), (unsigned)((k + kc - 1) / kc));
    hss_level_correct_kernel<<<grid, K_THREADS, smem, (cudaStream_t)stream>>>(
        (double*)Y, (const double*)xi, (const double*)Bl, (const double*)Br,
        (const double*)lu, (const long long*)perm, (const double*)Phi, m, r,
        blk, k, kc, transpose);
  }
  return (int)cudaGetLastError();
}
