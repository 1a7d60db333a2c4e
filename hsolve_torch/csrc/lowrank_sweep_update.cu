// Kernel E: low-rank sweep update of a compressed level in the solve sweeps.
//
// Replaces the compressed branches of hsolve/factor.py `_apply_impl`, which
// XLA lowered as a gather, two batched GEMMs and a scatter-add:
//
//   forward  (U = LU_, V = LV_, out = bnd_ids, Y = X = C[int_ids] gathered
//             before the pivot solve overwrites C[int]; :527-532):
//       C[bnd_ids[b, r], :] -= (LU_[b] @ (LV_[b]^T @ X[b]))[r, :]
//   backward (U = RU_, V = RV_, out = int_ids, Y gathered here from
//             in = bnd_ids; :554-559):
//       C[int_ids[b, r], :] -= (RU_[b] @ (RV_[b]^T @ C[bnd_ids[b]]))[r, :]
//
// The API and the sentinel rules are kernel C's (sweep_update.cu): C is
// [rows, k]; output ids >= N are skipped, input ids >= N read as 0; the
// update is an atomicAdd, deterministic where the output ids of one level are
// unique; in the backward form the rows read (bnd) and written (int) of one
// level are disjoint, so no block reads what another writes.
//
// Bound: memory.  U [B, R, kc] and V [B, Cc, kc] are read once per chunk of
// right-hand sides (once in GMRES, k = 1), with two multiply-adds per element
// of them.  It runs twice per compressed level per preconditioner
// application, so on every GMRES iteration.  One block per front: phase 1
// stages t = V^T Y ([kc, rc], rc right-hand sides) in shared memory, threads
// along kc reading V's rows coalesced and groups of threads splitting the Cc
// sum, reduced in shared memory; phase 2 applies U t with one warp per output
// row, lanes along kc (U's row is contiguous), a shuffle reduction and one
// atomic per right-hand side.  Nothing of t goes through device memory.  The
// top levels hold few fronts (B = 1 at the root's children), so a launch with
// fewer fronts than SMs takes 1024 threads a block instead of 256, for four
// times the loads in flight per front.
#include "hs_common.cuh"

#define E_SMEM_DOUBLES 4096  // t tile; LOWRANK_SMEM_DOUBLES in ops/sweep.py

__global__ void lowrank_sweep_update_kernel(
    double* C, const int* __restrict__ ids_out, const double* __restrict__ U,
    const double* __restrict__ V, const double* __restrict__ X,
    const int* __restrict__ ids_in, int R, int Cc, int kc, int k, int rc,
    int N) {
  extern __shared__ double smem[];
  double* t = smem;              // [kc][rc]
  double* red = smem + kc * rc;  // [blockDim.x] partial sums
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const double* Vb = V + b * Cc * kc;
  const double* Ub = U + b * R * kc;

  for (int r0 = blockIdx.y * rc; r0 < k; r0 += gridDim.y * rc) {
    const int nr = min(rc, k - r0);
    // phase 1: t[kk][r] = sum_c V[b, c, kk] * Y[b, c, r0 + r]
    for (int r = 0; r < nr; ++r) {
      for (int k0 = 0; k0 < kc; k0 += nt) {
        const int kw = min(nt, kc - k0);
        const int groups = nt / kw;
        const int kk = k0 + tid % kw, g = tid / kw;
        double acc = 0.0;
        if (g < groups) {
          for (int c = g; c < Cc; c += groups) {
            double y;
            if (X != nullptr) {
              y = X[(b * Cc + c) * k + r0 + r];
            } else {
              const int id = ids_in[b * Cc + c];
              y = id < N ? C[(int64_t)id * k + r0 + r] : 0.0;
            }
            acc += Vb[(int64_t)c * kc + kk] * y;
          }
        }
        red[tid] = acc;
        __syncthreads();
        if (tid < kw) {
          double s = 0.0;
          for (int gg = 0; gg < groups; ++gg) s += red[gg * kw + tid];
          t[(k0 + tid) * rc + r] = s;
        }
        __syncthreads();
      }
    }
    // phase 2: C[ids_out[b, row], r0 + r] -= U[b, row, :] . t[:, r]
    for (int row = warp; row < R; row += nwarps) {
      const int out = ids_out[b * R + row];
      if (out >= N) continue;  // uniform across the warp
      const double* urow = Ub + (int64_t)row * kc;
      for (int r = 0; r < nr; ++r) {
        double acc = 0.0;
        for (int kk = lane; kk < kc; kk += 32) acc += urow[kk] * t[kk * rc + r];
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) atomicAdd(C + (int64_t)out * k + r0 + r, -acc);
      }
    }
    __syncthreads();  // t is rewritten by the next chunk
  }
}

HS_EXPORT int hs_lowrank_sweep_update(void* C, const void* ids_out,
                                      const void* U, const void* V,
                                      const void* X, const void* ids_in,
                                      long long B, int R, int Cc, int kc,
                                      int k, int N, void* stream) {
  if (B > 0 && R > 0 && Cc > 0 && kc > 0 && k > 0 && kc <= E_SMEM_DOUBLES) {
    int rc = E_SMEM_DOUBLES / kc;
    if (rc > k) rc = k;
    int chunks = (k + rc - 1) / rc;
    if (chunks > 65535) chunks = 65535;
    const int threads = B < 132 ? 1024 : 256;
    const size_t smem = ((size_t)kc * rc + threads) * sizeof(double);
    dim3 grid((unsigned)B, (unsigned)chunks);
    lowrank_sweep_update_kernel<<<grid, threads, smem,
                                  (cudaStream_t)stream>>>(
        (double*)C, (const int*)ids_out, (const double*)U, (const double*)V,
        (const double*)X, (const int*)ids_in, R, Cc, kc, k, rc, N);
  }
  return (int)cudaGetLastError();
}
