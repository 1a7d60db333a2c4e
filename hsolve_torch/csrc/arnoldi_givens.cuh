// Kernel M's step: the Givens bookkeeping of one Arnoldi step, and the cycle
// end, run by one warp on a column in shared memory.  Included by
// arnoldi_givens.cu (M alone, one warp a launch) and arnoldi_cgs2.cu (M as
// the tail of kernel L's cooperative launch, `hs_arnoldi_step`).
//
// Replaces the scalar tail of hsolve/krylov.py `_gmres_cycles.inner_body`
// (:237-266), its loop test `inner_cond` (:269-273) and the cycle end's
// masked triangular solve (:293-298).  With J = j + 1, on the step's column
// col[:J+1] (h1 + h2 and ||w||, zero beyond):
//
//   - the j earlier rotations (cs[i], sn[i]) are applied to the column,
//   - rotation j is formed with JAX's safe branches (denominator 0 -> (1, 0);
//     |a| = 0 -> (0, 1); else (|a| / d, a b / max(|a| d, tiny))),
//   - H[:, j] = the rotated column, cs[j], sn[j], g[j], g[j+1] = -sn_j g[j],
//   - st[0] = |g[j+1]| (the residual estimate), st[1] = ||w|| or 1 where it
//     is 0 (the divisor that scales w into V[J]),
//   - done = !(cont && st[0] > floor): `cont` carries the rest of the
//     loop's test (J < m and it + J < maxiter; the step's tail reads it and
//     the floor, max(tol, m_eps beta) in the value type, from the loop
//     state in device memory, M alone takes both from its caller);
//   - when done, y[:J] solves the upper triangular H[:J, :J] y = g[:J] and
//     y[J:m] = 0 (JAX's identity-masked solve).
//
// Every product, sum, quotient and root is rounded on its own
// (`__dmul_rn`, `__fadd_rn`, ...): no fused multiply-add, so the rotations,
// the done flag and y are those of the plain torch version bit for bit.
//
// Bound: latency.  The rotations are a chain of j dependent steps and the
// solve one of J(J+1)/2 dependent subtractions, so one warp does the step.
// Before lane 0's chain the warp loads cs[:j], sn[:j] and g[:J] into shared
// memory in one coalesced pass, so the chain reads no global memory.  The
// back substitution stages H[:J, :J] in shared memory where the caller's
// buffer holds it (`h_smem`; else it reads H from global memory, the same
// values in the same order); for each row the warp forms the products
// H[i, k] y[k] (all of them known) in parallel and lane 0 subtracts them in
// the plain version's order, ascending k.
#pragma once

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

// the step's state in global memory (the GMRES run's Arnoldi state)
template <typename T>
struct GivensArgs {
  T* H;       // [m+1, m]
  T* cs;      // [m]
  T* sn;      // [m]
  T* g;       // [m+1]
  T* st;      // [2]
  int* done;  // [1]
  T* y;       // [m]
  int m;
  T floor;
  int cont;
  int h_smem;  // stage H[:J, :J] in shared memory for the back substitution
};

// values of the shared scratch `givens_step` takes (H[:J, :J] staged or not)
__host__ __device__ inline long long givens_smem_values(int m, int J,
                                                        bool h_smem) {
  return 5LL * m + 2 + (h_smem ? (long long)J * J : 0LL);
}

// One warp (lane = threadIdx.x & 31) runs step j on col[0..m] (shared
// memory; col[i] for i <= j + 1 the step's column, 0 beyond; rotated in
// place) with `buf` (shared, givens_smem_values(m, j + 1, p.h_smem)
// values) as scratch.  Returns whether the step ended the cycle.
template <typename T>
__device__ bool givens_step(T* col, T* buf, const GivensArgs<T>& p, int j) {
  const int lane = threadIdx.x & 31;
  const int m = p.m, J = j + 1;
  T* css = buf;          // [m]    cs[:j]
  T* sns = css + m;      // [m]    sn[:j]
  T* gs = sns + m;       // [m+1]  g[:J], then the rotated g[j]
  T* ys = gs + m + 1;    // [m]    y[:J]
  T* pr = ys + m;        // [m+1]  one row's products H[i, k] y[k]
  T* Hs = pr + m + 1;    // [J][J] H[:J, :J] where staged
  for (int i = lane; i < j; i += 32) {
    css[i] = p.cs[i];
    sns[i] = p.sn[i];
  }
  for (int i = lane; i < J; i += 32) gs[i] = p.g[i];
  __syncwarp();
  int done = 0;
  if (lane == 0) {
    for (int i = 0; i < j; ++i) {
      const T a = col[i], b = col[i + 1];
      col[i] = add_rn(mul_rn(css[i], a), mul_rn(sns[i], b));
      col[i + 1] = add_rn(mul_rn(-sns[i], a), mul_rn(css[i], b));
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
    const T hn = col[j + 1];  // ||w||, before the rotation zeroes it
    col[j] = add_rn(mul_rn(csj, a), mul_rn(snj, b));
    col[j + 1] = T(0);
    p.cs[j] = csj;
    p.sn[j] = snj;
    const T gj = gs[j];
    const T gj1 = mul_rn(-snj, gj);
    const T gjn = mul_rn(csj, gj);
    gs[j] = gjn;
    p.g[j + 1] = gj1;
    p.g[j] = gjn;
    const T res = fabs(gj1);
    p.st[0] = res;
    p.st[1] = hn > T(0) ? hn : T(1);
    done = !(p.cont && res > p.floor);
    *p.done = done;
  }
  done = __shfl_sync(0xffffffffu, done, 0);
  for (int i = lane; i <= m; i += 32) p.H[(int64_t)i * m + j] = col[i];
  __syncwarp();
  if (!done) return false;
  // the cycle end: y[:J] = H[:J, :J]^{-1} g[:J] by back substitution
  const T* Hr = p.H;
  int ld = m;
  if (p.h_smem) {
    for (int e = lane; e < J * J; e += 32) {
      const int i = e / J, k = e - i * J;
      Hs[e] = k == j ? col[i] : (k >= i ? p.H[(int64_t)i * m + k] : T(0));
    }
    Hr = Hs;
    ld = J;
  }
  for (int i = J + lane; i < m; i += 32) p.y[i] = T(0);
  __syncwarp();
  for (int i = J - 1; i >= 0; --i) {
    for (int k = i + 1 + lane; k < J; k += 32)
      pr[k] = mul_rn(Hr[(int64_t)i * ld + k], ys[k]);
    __syncwarp();
    if (lane == 0) {
      T acc = gs[i];
      for (int k = i + 1; k < J; ++k) acc = add_rn(acc, -pr[k]);
      ys[i] = div_rn(acc, Hr[(int64_t)i * ld + i]);
    }
    __syncwarp();
  }
  for (int i = lane; i < J; i += 32) p.y[i] = ys[i];
  return true;
}
