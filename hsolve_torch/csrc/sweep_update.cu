// Kernel C: fused gather -> batched GEMV -> scatter-add of the solve sweeps.
//
// Replaces the per-level updates of hsolve/factor.py `_apply_impl` (:526-559),
// which XLA lowered as a gather, a batched GEMM and a scatter-add:
//
//   forward  (M = L, out = bnd_ids, Y = X = C[int_ids] gathered before the
//             pivot solve overwrites C[int]):
//       C[bnd_ids[b, r], :] -= sum_c L[b, r, c] * X[b, c, :]
//   backward (M = R, out = int_ids, Y gathered here from in = bnd_ids):
//       C[int_ids[b, r], :] -= sum_c R[b, r, c] * C[bnd_ids[b, c], :]
//
// C is [rows, k] with k >= 1 right-hand sides.  Ids >= N are the planner's
// sentinel: such output rows are skipped (C's sentinel row N stays untouched,
// JAX's mode="drop") and such input rows read as 0.
//
// The update is an atomicAdd on double.  On the generated trees bnd_ids are
// unique within a level, so no two warps hit one address and the result is
// deterministic.  Trees from parse_elimtree carry no such guarantee: there the
// result is still correct, but its summation order is not fixed.  In the
// backward sweep the rows read (bnd) and written (int) of one level are
// disjoint, so reads never race with writes.
//
// Bound: memory.  M (L or R, [B, R, Cc]) dominates the bytes and is read once
// per right-hand side; the work per byte is one multiply-add.  One warp per
// output row reads M's row with consecutive lanes on consecutive addresses,
// reduces with shuffles and issues one atomic per right-hand side; padded
// output rows exit before reading their M row.
#include "hs_common.cuh"

__global__ void sweep_update_kernel(double* C, const int* __restrict__ ids_out,
                                    const double* __restrict__ M,
                                    const double* __restrict__ X,
                                    const int* __restrict__ ids_in,
                                    int64_t rows, int R, int Cc, int k,
                                    int N) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < rows; row += nwarps) {
    const int out = ids_out[row];
    if (out >= N) continue;  // uniform across the warp
    const int64_t b = row / R;
    const double* mrow = M + row * Cc;
    for (int kk = 0; kk < k; ++kk) {
      double acc = 0.0;
      for (int c = lane; c < Cc; c += 32) {
        double y;
        if (X != nullptr) {
          y = X[(b * Cc + c) * k + kk];
        } else {
          const int id = ids_in[b * Cc + c];
          y = id < N ? C[(int64_t)id * k + kk] : 0.0;
        }
        acc += mrow[c] * y;
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) atomicAdd(C + (int64_t)out * k + kk, -acc);
    }
  }
}

HS_EXPORT int hs_sweep_update(void* C, const void* ids_out, const void* M,
                              const void* X, const void* ids_in, long long B,
                              int R, int Cc, int k, int N, void* stream) {
  const int64_t rows = (int64_t)B * R;
  if (rows > 0 && Cc > 0 && k > 0) {
    const int threads = 256;  // 8 warps, one output row each
    sweep_update_kernel<<<hs_blocks(rows * 32, threads), threads, 0,
                          (cudaStream_t)stream>>>(
        (double*)C, (const int*)ids_out, (const double*)M, (const double*)X,
        (const int*)ids_in, rows, R, Cc, k, N);
  }
  return (int)cudaGetLastError();
}
