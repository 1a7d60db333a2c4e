// Kernel H: the pivot loop of the column-pivoted QR behind every
// interpolative decomposition of the HSS path.
//
// Replaces the `lax.fori_loop` of hsolve/ops/lowrank.py `cpqr` (:195-219),
// about ten XLA ops per step for `cap` steps, run for every level of every
// HSS compression.  Per matrix A [m, n] (A^T of the ID's input) it runs
// k = min(cap, m, n) steps of Businger-Golub pivoting with norm downdating:
//
//   p     = first argmax of the downdated column norms^2 (chosen pivots: -inf)
//   nrm   = sqrt(max(|A[:, p]|^2, 1e-300))        (the exact norm)
//   ok    = active && nrm > max(atol, rtol * norm0)
//   piv[j] = ok ? p : -1;  rank += ok;  active = ok
//   q     = ok ? A[:, p] / nrm : 0
//   coef  = q^T A;  A -= q coef;  norms^2 = max(norms^2 - coef^2, 0)
//   norms^2[p] = -inf
//
// Ties go to the first maximal index, as `jnp.argmax` and `torch.argmax` do.
// The elementwise steps round as the plain version's separate torch ops do
// (no fused multiply-add: __dmul_rn / __dsub_rn / __ddiv_rn), so the two
// differ only in the summation order of the three reductions.
//
// Bound: latency.  The matrices are small ([58, 32] at the leaves, [58, 96]
// at the upper levels, [92, 64] in the transition at the n=512 plan: at most
// 47 KB) and the k steps are sequential.  One block per matrix holds it whole
// in shared memory, so the k steps touch device memory only for the first
// load and the k pivot writes; a step is four barriers: argmax, pivot norm,
// projection coefficients, rank-1 downdate.
#include <math.h>

#include "hs_common.cuh"

#define H_THREADS 256

// (value, index) pair reduction favouring the larger value, then the smaller
// index: the first maximum.
__device__ __forceinline__ void argmax_merge(double& v, int& i, double ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(H_THREADS)
    hss_cpqr_kernel(const double* __restrict__ A, int* __restrict__ piv,
                    int* __restrict__ rank, double atol, double rtol, int m,
                    int n, int k) {
  extern __shared__ double smem[];
  double* a = smem;           // [m][n] working copy
  double* nrm2 = a + m * n;   // [n] downdated squared column norms
  double* q = nrm2 + n;       // [m] pivot direction
  double* coef = q + m;       // [n] projection coefficients
  __shared__ double red_v[H_THREADS / 32];
  __shared__ int red_i[H_THREADS / 32];
  __shared__ int s_p, s_ok, s_rank;
  __shared__ double s_thr, s_nrm;

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = H_THREADS / 32;
  const double* Ab = A + b * (int64_t)m * n;
  for (int e = tid; e < m * n; e += H_THREADS) a[e] = Ab[e];
  __syncthreads();

  // initial norms and the rtol reference norm0 = sqrt(max norms^2)
  double mx = -INFINITY;
  for (int c = tid; c < n; c += H_THREADS) {
    double s = 0.0;
    for (int i = 0; i < m; ++i) {
      const double v = a[i * n + c];
      s += v * v;
    }
    nrm2[c] = s;
    mx = fmax(mx, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    mx = fmax(mx, __shfl_down_sync(0xffffffffu, mx, off));
  if (lane == 0) red_v[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    double v = red_v[0];
    for (int w = 1; w < nwarps; ++w) v = fmax(v, red_v[w]);
    s_thr = fmax(rtol * __dsqrt_rn(v), atol);
    s_ok = 1;
    s_rank = 0;
  }
  __syncthreads();
  const double thr = s_thr;

  for (int j = 0; j < k; ++j) {
    // 1. p = first argmax of nrm2
    double bv = -INFINITY;
    int bi = n;
    for (int c = tid; c < n; c += H_THREADS) argmax_merge(bv, bi, nrm2[c], c);
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      argmax_merge(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      // 2. the exact norm of the pivot column (warp 0 alone)
      double v = -INFINITY;
      int i = n;
      if (lane < nwarps) {
        v = red_v[lane];
        i = red_i[lane];
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        argmax_merge(v, i, ov, oi);
      }
      const int p = __shfl_sync(0xffffffffu, i, 0);
      double s = 0.0;
      for (int r = lane; r < m; r += 32) {
        const double x = a[r * n + p];
        s += x * x;
      }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) {
        const double nrm = __dsqrt_rn(fmax(s, 1e-300));
        const int ok = s_ok && nrm > thr;
        piv[b * k + j] = ok ? p : -1;
        s_rank += ok;
        s_ok = ok;
        s_p = p;
        s_nrm = nrm;
      }
    }
    __syncthreads();
    const int p = s_p, ok = s_ok;
    const double nrm = s_nrm;
    for (int r = tid; r < m; r += H_THREADS)
      q[r] = ok ? __ddiv_rn(a[r * n + p], nrm) : 0.0;
    __syncthreads();
    // 3. coef = q^T A
    for (int c = tid; c < n; c += H_THREADS) {
      double s = 0.0;
      for (int r = 0; r < m; ++r) s += q[r] * a[r * n + c];
      coef[c] = s;
    }
    __syncthreads();
    // 4. A -= q coef; downdate the norms; exclude the pivot
    for (int e = tid; e < m * n; e += H_THREADS) {
      const int r = e / n, c = e - r * n;
      a[e] = __dsub_rn(a[e], __dmul_rn(q[r], coef[c]));
    }
    for (int c = tid; c < n; c += H_THREADS) {
      const double d = fmax(__dsub_rn(nrm2[c], __dmul_rn(coef[c], coef[c])), 0.0);
      nrm2[c] = c == p ? -INFINITY : d;
    }
    __syncthreads();
  }
  if (tid == 0) rank[b] = s_rank;
}

HS_EXPORT int hs_cpqr(const void* A, void* piv, void* rank, double atol,
                      double rtol, long long B, int m, int n, int k,
                      void* stream) {
  if (B > 0 && k > 0) {
    const size_t smem = ((size_t)m * n + 2 * (size_t)n + m) * sizeof(double);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hss_cpqr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    hss_cpqr_kernel<<<(unsigned)B, H_THREADS, smem, (cudaStream_t)stream>>>(
        (const double*)A, (int*)piv, (int*)rank, atol, rtol, m, n, k);
  }
  return (int)cudaGetLastError();
}
