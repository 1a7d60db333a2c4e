// Kernel G: truncation epilogue of the randomized low-rank factorization.
//
// Replaces the tail of hsolve/ops/lowrank.py `rand_lowrank` (:157-165),
// `_rank_mask` (:130-138) plus the scaling, transposition and cap padding,
// about eight small XLA ops, four times per compressed level:
//
//     rank[b] = min(#{i : sv[b, i] > max(atol, rtol * sv[b, 0])}, cap)
//     U[b, i, j] = QU[b, i, j] * (sv[b, j] * mask_j)     j < min(cap, r)
//     V[b, i, j] = Vh[b, j, i] * mask_j                  j < min(cap, r)
//     U, V = 0                                           min(cap, r) <= j < cap
//
// with mask_j = 1.0 for j < rank[b], else 0.0; QU = Q @ Uw is [B, m, r], sv
// [B, r] (descending), Vh [B, r, n].  The products are the plain version's,
// operand for operand, so U and V come out bitwise equal to it.
//
// Bound: memory.  One read of QU and Vh and one write of U and V, no
// arithmetic to speak of.  One block per batch element: thread 0 counts the
// rank over the r <= cap + 8 singular values into shared memory, then the
// block writes U and V with consecutive threads on consecutive output
// addresses (V's reads of Vh are strided by n; it is the smaller of the two
// and L2-resident at these sizes).
#include "hs_common.cuh"

__global__ void lowrank_truncate_kernel(const double* __restrict__ QU,
                                        const double* __restrict__ sv,
                                        const double* __restrict__ Vh,
                                        double* __restrict__ U,
                                        double* __restrict__ V,
                                        int* __restrict__ rank, double atol,
                                        double rtol, int m, int n, int r,
                                        int cap) {
  __shared__ int s_rank;
  const int64_t b = blockIdx.x;
  const double* s = sv + b * r;
  if (threadIdx.x == 0) {
    int cnt = 0;
    if (r > 0) {
      const double thr = fmax(rtol * s[0], atol);
      for (int i = 0; i < r; ++i) cnt += s[i] > thr ? 1 : 0;
    }
    s_rank = cnt < cap ? cnt : cap;
    rank[b] = s_rank;
  }
  __syncthreads();
  const int rk = s_rank;
  const int kk = cap < r ? cap : r;
  const double* qu = QU + b * m * (int64_t)r;
  const double* vh = Vh + b * r * (int64_t)n;
  double* u = U + b * m * (int64_t)cap;
  double* v = V + b * n * (int64_t)cap;
  for (int64_t e = threadIdx.x; e < (int64_t)m * cap; e += blockDim.x) {
    const int i = (int)(e / cap), j = (int)(e % cap);
    double val = 0.0;
    if (j < kk) val = qu[(int64_t)i * r + j] * (s[j] * (j < rk ? 1.0 : 0.0));
    u[e] = val;
  }
  for (int64_t e = threadIdx.x; e < (int64_t)n * cap; e += blockDim.x) {
    const int i = (int)(e / cap), j = (int)(e % cap);
    double val = 0.0;
    if (j < kk) val = vh[(int64_t)j * n + i] * (j < rk ? 1.0 : 0.0);
    v[e] = val;
  }
}

HS_EXPORT int hs_lowrank_truncate(const void* QU, const void* sv,
                                  const void* Vh, void* U, void* V, void* rank,
                                  double atol, double rtol, long long B, int m,
                                  int n, int r, int cap, void* stream) {
  if (B > 0 && cap > 0) {
    lowrank_truncate_kernel<<<(unsigned)B, 256, 0, (cudaStream_t)stream>>>(
        (const double*)QU, (const double*)sv, (const double*)Vh, (double*)U,
        (double*)V, (int*)rank, atol, rtol, m, n, r, cap);
  }
  return (int)cudaGetLastError();
}
