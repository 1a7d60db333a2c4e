// Kernel M: the Givens bookkeeping of one Arnoldi step, and the cycle end.
//
// Replaces the scalar tail of hsolve/krylov.py `_gmres_cycles.inner_body`
// (:237-266), its loop test `inner_cond` (:269-273) and the cycle end's masked
// triangular solve (:293-298), which XLA ran as a scan of rotations and a
// handful of scalar ops per step.  With J = j + 1, on one step's column
// hc[:J+1] (kernel L's output: h1 + h2 and ||w||):
//
//   - the j earlier rotations (cs[i], sn[i]) are applied to the column,
//   - rotation j is formed with JAX's safe branches (denominator 0 -> (1, 0);
//     |a| = 0 -> (0, 1); else (|a| / d, a b / max(|a| d, tiny))),
//   - H[:, j] = the rotated column, cs[j], sn[j], g[j], g[j+1] = -sn_j g[j],
//   - st[0] = |g[j+1]| (the residual estimate), st[1] = ||w|| or 1 where it
//     is 0 (the divisor that scales w into V[J]),
//   - done = !(cont && st[0] > floor): `cont` carries the loop conditions the
//     host already knows (J < m and it + J < maxiter), the floor is
//     max(tol, m_eps beta) in the value type;
//   - when done, y[:J] solves the upper triangular H[:J, :J] y = g[:J] and
//     y[J:m] = 0 (JAX's identity-masked solve).
//
// Every product, sum, quotient and root is rounded on its own
// (`__dmul_rn`, `__fadd_rn`, ...): no fused multiply-add, so the rotations
// and the done flag are those of the plain torch version bit for bit.
// Instantiated for double (`hs_arnoldi_givens`) and float
// (`hs_arnoldi_givens_f32`).
//
// Bound: latency.  The rotations are a chain of j dependent steps and the
// solve one of J(J+1)/2 multiply-adds on m <= 256 values, so one warp does
// the step (lane 0 the chain, the warp the column's loads and stores).  It
// replaces the per-step host fetch of the Hessenberg column: the host reads
// only the 4-byte done flag.
#include <float.h>

#include "hs_common.cuh"

#define HS_GIVENS_MAX_M 256

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }
__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }

template <typename T>
__global__ void arnoldi_givens_kernel(T* __restrict__ H, T* __restrict__ cs,
                                      T* __restrict__ sn, T* __restrict__ g,
                                      const T* __restrict__ hc,
                                      T* __restrict__ st, int* __restrict__ done,
                                      T* __restrict__ y, int j, int m, T res_floor,
                                      int cont) {
  __shared__ T col[HS_GIVENS_MAX_M + 1];
  __shared__ int s_done;
  const int lane = threadIdx.x;
  for (int i = lane; i <= m; i += 32) col[i] = i <= j + 1 ? hc[i] : T(0);
  __syncwarp();
  if (lane == 0) {
    for (int i = 0; i < j; ++i) {
      const T a = col[i], b = col[i + 1];
      col[i] = add_rn(mul_rn(cs[i], a), mul_rn(sn[i], b));
      col[i + 1] = add_rn(mul_rn(-sn[i], a), mul_rn(cs[i], b));
    }
    const T a = col[j], b = col[j + 1];
    const T absa = fabs(a), absb = fabs(b);
    const T denom = sqrt_rn(add_rn(mul_rn(absa, absa), mul_rn(absb, absb)));
    const bool safe = denom > T(0);
    T csj, snj;
    if (safe && absa > T(0)) {
      csj = div_rn(absa, denom);
      snj = div_rn(mul_rn(a, b), fmax(mul_rn(absa, denom), tiny_of(a)));
    } else {
      csj = safe ? T(0) : T(1);
      snj = safe ? T(1) : T(0);
    }
    col[j] = add_rn(mul_rn(csj, a), mul_rn(snj, b));
    col[j + 1] = T(0);
    cs[j] = csj;
    sn[j] = snj;
    const T gj = g[j];
    const T gj1 = mul_rn(-snj, gj);
    g[j + 1] = gj1;
    g[j] = mul_rn(csj, gj);
    const T res = fabs(gj1);
    const T hn = hc[j + 1];
    st[0] = res;
    st[1] = hn > T(0) ? hn : T(1);
    s_done = !(cont && res > res_floor);
    *done = s_done;
  }
  __syncwarp();
  for (int i = lane; i <= m; i += 32) H[(int64_t)i * m + j] = col[i];
  __syncwarp();
  if (!s_done) return;
  // the cycle end: y[:J] = H[:J, :J]^{-1} g[:J] by back substitution
  const int J = j + 1;
  for (int i = J + lane; i < m; i += 32) y[i] = T(0);
  if (lane == 0) {
    for (int i = J - 1; i >= 0; --i) {
      T acc = g[i];
      for (int k = i + 1; k < J; ++k)
        acc = add_rn(acc, -mul_rn(H[(int64_t)i * m + k], y[k]));
      y[i] = div_rn(acc, H[(int64_t)i * m + i]);
    }
  }
}

template <typename T>
static int arnoldi_givens(void* H, void* cs, void* sn, void* g, const void* hc,
                          void* st, void* done, void* y, int j, int m,
                          double res_floor, int cont, void* stream) {
  if (m < 1 || m > HS_GIVENS_MAX_M || j < 0 || j >= m)
    return (int)cudaErrorInvalidValue;
  arnoldi_givens_kernel<T><<<1, 32, 0, (cudaStream_t)stream>>>(
      (T*)H, (T*)cs, (T*)sn, (T*)g, (const T*)hc, (T*)st, (int*)done, (T*)y,
      j, m, (T)res_floor, cont);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_arnoldi_givens(void* H, void* cs, void* sn, void* g,
                                const void* hc, void* st, void* done, void* y,
                                int j, int m, double res_floor, int cont,
                                void* stream) {
  return arnoldi_givens<double>(H, cs, sn, g, hc, st, done, y, j, m,
                                res_floor, cont, stream);
}

HS_EXPORT int hs_arnoldi_givens_f32(void* H, void* cs, void* sn, void* g,
                                    const void* hc, void* st, void* done,
                                    void* y, int j, int m, double res_floor,
                                    int cont, void* stream) {
  return arnoldi_givens<float>(H, cs, sn, g, hc, st, done, y, j, m,
                               res_floor, cont, stream);
}
