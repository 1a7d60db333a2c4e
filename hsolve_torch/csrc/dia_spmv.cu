// Kernel D: DIA sparse matrix-vector product, optionally fused into a residual.
//
// Replaces hsolve/ops/sparse.py `dia_matvec` (:98-111), which XLA lowered as
// shifted multiply-adds over a zero-padded copy of x:
//
//     y[i, :] = sum_d vals[d, i] * x[i + off[d], :]     (0 outside [0, N))
//     r[i, :] = b[i, :] - y[i, :]                        (when b is given)
//
// The residual form serves GMRES's true-residual check (hsolve/krylov.py:302)
// without a second pass over N.  At most 64 diagonals; their offsets are read
// from a small device array into shared memory once per block.  Instantiated
// for double (`hs_dia_spmv`) and float (`hs_dia_spmv_f32`, the float32
// operator of mixed-precision GMRES's inner cycles).
//
// Bound: memory streaming.  Per row and right-hand side it reads nd values of
// `vals` and nd neighbours of x (the latter mostly from L1/L2: stencil
// neighbours are close in i) and writes one result.  Threads run along i, so
// every stream is coalesced; no padded copy of x is made.
#include "hs_common.cuh"

#define HS_MAX_DIAGS 64

template <typename T>
__global__ void dia_spmv_kernel(T* __restrict__ y, const T* __restrict__ vals,
                                const int* __restrict__ offs,
                                const T* __restrict__ x,
                                const T* __restrict__ b, int nd,
                                int64_t N, int k) {
  __shared__ int soff[HS_MAX_DIAGS];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) soff[d] = offs[d];
  __syncthreads();
  const int64_t total = N * k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t i = e / k;
    const int64_t kk = e - i * k;
    T acc = T(0);
    for (int d = 0; d < nd; ++d) {
      const int64_t j = i + soff[d];
      if (j >= 0 && j < N) acc += vals[d * N + i] * x[j * k + kk];
    }
    y[e] = b != nullptr ? b[e] - acc : acc;
  }
}

template <typename T>
static int dia_spmv(void* y, const void* vals, const void* offs,
                    const void* x, const void* b, int nd, long long N, int k,
                    void* stream) {
  if (nd > HS_MAX_DIAGS) return (int)cudaErrorInvalidValue;
  if (N > 0 && k > 0) {
    const int threads = 256;
    dia_spmv_kernel<T><<<hs_blocks((int64_t)N * k, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (T*)y, (const T*)vals, (const int*)offs, (const T*)x, (const T*)b,
        nd, (int64_t)N, k);
  }
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_dia_spmv(void* y, const void* vals, const void* offs,
                          const void* x, const void* b, int nd, long long N,
                          int k, void* stream) {
  return dia_spmv<double>(y, vals, offs, x, b, nd, N, k, stream);
}

HS_EXPORT int hs_dia_spmv_f32(void* y, const void* vals, const void* offs,
                              const void* x, const void* b, int nd,
                              long long N, int k, void* stream) {
  return dia_spmv<float>(y, vals, offs, x, b, nd, N, k, stream);
}
