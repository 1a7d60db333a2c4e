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
// of them: at the n=512 plans' top levels (one front, R = Cc = 512, kc = 48)
// 393 KB, 0.12 us at 3.35 TB/s.  What held the first design back was not
// bytes: one CTA per front left the top levels (1-16 fronts) on 1-16 of the
// 132 SMs, each walking ~25 dependent load steps, and its reduction took two
// barriers per chunk of kc.  This design:
//
// - few fronts: one front spreads over a thread block cluster of cs CTAs of
//   256 threads (up to 16, non-portable above 8) until the launch has about
//   four CTAs per SM (`lowrank_sweep_geometry` in ops/sweep.py picks the
//   geometry).  CTA j reduces its slice of the Cc rows into a partial
//   t_j = V[c-slice]^T Y[c-slice] ([kc, kb]) in its shared memory; after a
//   cluster barrier each CTA sums the cs partials through distributed
//   shared memory (in rank order, so every CTA holds the same t) and
//   applies U to its own slice of the R rows.  No t goes through device
//   memory;
// - fronts filling between a half and one wave of SMs (k = 1): one CTA of
//   1024 threads a front (it beat clusters of 256-thread CTAs there,
//   tools/eb_breakdown.py);
// - many fronts: one front a CTA of 256 threads, no cluster;
// - phase 1 (t): the slice's Y rows are staged in shared memory, one row a
//   thread (in the backward form the gather C[ids_in] runs once per row,
//   all of them in flight together, not once per column group); thread
//   (g, p) owns the column pair p (16-byte loads of V's rows where kc is
//   even and V is 16-byte aligned) and walks every G-th row of the slice,
//   loading 4 rows before it multiplies them; one shared-memory reduction
//   over the G row groups per launch and chunk of right-hand sides, not per
//   chunk of kc;
// - phase 2 (U t): L lanes per row (L the power of two >= kc / 2, at most
//   32), 32 / L rows per warp and 4 rows per lane group loaded before they
//   multiply, a shuffle reduction over the L lanes and one atomic per row
//   and right-hand side (streaming U's rows as one block with a segmented
//   warp sum, which keeps every lane busy whatever kc, lost at all but one
//   shape);
// - launches of at most 16 fronts (the top levels) sum in double-double and
//   keep t as a pair (see acc_add below): there a row's terms of U t sum to
//   up to 650 times the update, and plain sums (the first design's, the
//   plain version's) land ~1e-13 of C off the exact update; from 31 fronts
//   on the terms sum to at most 0.8 times it, and double-double sums would
//   cost 1.2-2.2x the time there (1.2-1.4x at the top levels;
//   tools/eb_breakdown.py, with --accuracy for the errors);
// - k > 1 goes in chunks of 4 right-hand sides (kb = 4), k = 1 in one
//   (kb = 1).
//
// Float32 (the JAX bench's device configuration, T = float): the same
// kernel loading float32 values (four a 16-byte load, VEC = 4) and summing
// in float64 (the accumulator type A = hs_acc_t<T>: t, the partials and
// the staged Y rows in doubles), the update rounded to float32 once before
// its atomic: fault F4's rule, as kernel C's float32 sweep.  Sums in
// float64 sit far below float32's rounding, so no double-double (dd = 0).
//
// Complex128 (the damped Helmholtz system's low-rank levels, T = hs_c128):
// the same kernel over values of 16 bytes, one a 16-byte load (VEC = 1,
// hs_vec16's rule).  A complex multiply-add is four real FMAs, two into
// each part's sum; at launches of at most 16 fronts each part sums in
// double-double as a real sum does (its own pair), t is kept as a pair of
// complex values, and a row's update is scattered with two real atomics.
//
// Complex64 (the bench's complex device configuration on compressed levels,
// T = hs_c64): float32's rule on complex values.  Two values a 16-byte load
// (VEC = 2), widened to complex128 as they are read; t, the partials and the
// staged Y rows in complex128 (A = hs_c128); the update rounded to complex64
// once, each part on its own, and scattered with two float atomics; no
// double-double (dd = 0).
#include <cooperative_groups.h>

#include "hs_common.cuh"
#include "hs_complex.cuh"

namespace cg = cooperative_groups;

#define E_UNROLL 4  // rows in flight per thread (phase 1) and lane group (2)

// VEC values from p (16 bytes where VEC = 2 doubles or one complex128)
template <int VEC>
__device__ __forceinline__ void e_load(const double* p, double* v) {
  if (VEC == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// float32 values widened to float64 (four a 16-byte load where VEC = 4)
template <int VEC>
__device__ __forceinline__ void e_load(const float* p, double* v) {
  if (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// complex64 values widened to complex128 (two a 16-byte load where VEC = 2)
template <int VEC>
__device__ __forceinline__ void e_load(const hs_c64* p, hs_c128* v) {
  if (VEC == 2) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = hs_c128(t.x, t.y);
    v[1] = hs_c128(t.z, t.w);
  } else {
    v[0] = hs_wide(hs_ldg(p));
  }
}

template <int VEC>
__device__ __forceinline__ void e_load(const hs_c128* p, hs_c128* v) {
  static_assert(VEC == 1, "one complex128 value a 16-byte load");
  v[0] = hs_ldg(p);
}

// Sums in double-double (DD): a running (hi, lo) pair gains an exact product
// a*b as (p, fma(a, b, -p)) and a pair as (hi, lo); hi + lo is rounded once
// at the end, and t is kept as a pair that U multiplies half by half.  At
// the top levels the terms of a row of U t sum to far more than the update
// (n=512, default caps, batch 15: 650 times the largest entry of C), and
// rounding t to doubles alone then moves the result by ~1e-13 of C.
// Without DD the pairs' lo halves stay 0 and the sums are plain FMAs.
template <bool DD>
__device__ __forceinline__ void acc_add(double& hi, double& lo, double a,
                                        double a_lo) {
  if (DD) {
    const double s = hi + a;
    const double bb = s - hi;
    lo += ((hi - (s - bb)) + (a - bb)) + a_lo;
    hi = s;
  } else {
    hi += a;
  }
}

template <bool DD>
__device__ __forceinline__ void acc_fma(double& hi, double& lo, double a,
                                        double b) {
  if (DD) {
    const double p = a * b;
    acc_add<true>(hi, lo, p, fma(a, b, -p));
  } else {
    hi = fma(a, b, hi);
  }
}

// the same on complex values, each part its own (hi, lo) pair
template <bool DD>
__device__ __forceinline__ void acc_add(hs_c128& hi, hs_c128& lo, hs_c128 a,
                                        hs_c128 a_lo) {
  acc_add<DD>(hi.re, lo.re, a.re, a_lo.re);
  acc_add<DD>(hi.im, lo.im, a.im, a_lo.im);
}

template <bool DD>
__device__ __forceinline__ void acc_fma(hs_c128& hi, hs_c128& lo, hs_c128 a,
                                        hs_c128 b) {
  acc_fma<DD>(hi.re, lo.re, a.re, b.re);
  acc_fma<DD>(hi.re, lo.re, -a.im, b.im);
  acc_fma<DD>(hi.im, lo.im, a.re, b.im);
  acc_fma<DD>(hi.im, lo.im, a.im, b.re);
}

// hi + lo += u (t + t_lo), t a pair: u t exactly (in DD) and u t_lo plainly
template <bool DD>
__device__ __forceinline__ void acc_mul_pair(double& hi, double& lo, double u,
                                             double t, double t_lo) {
  if (DD) {
    const double a = u * t;
    acc_add<true>(hi, lo, a, fma(u, t, -a) + u * t_lo);
  } else {
    hi = fma(u, t, hi);
  }
}

template <bool DD>
__device__ __forceinline__ void acc_mul_pair(hs_c128& hi, hs_c128& lo,
                                             hs_c128 u, hs_c128 t,
                                             hs_c128 t_lo) {
  acc_fma<DD>(hi, lo, u, t);
  if (DD) {
    lo.re += u.re * t_lo.re - u.im * t_lo.im;
    lo.im += u.re * t_lo.im + u.im * t_lo.re;
  }
}

template <typename T, int NT, int VEC, int KB, bool DD>
__global__ void __launch_bounds__(NT)
    lowrank_sweep_update_kernel(T* C, const int* __restrict__ ids_out,
                                const T* __restrict__ U,
                                const T* __restrict__ V,
                                const T* __restrict__ X,
                                const int* __restrict__ ids_in, int R, int Cc,
                                int kc, int k, int N, int cs, int rstep,
                                int cstep) {
  typedef hs_acc_t<T> A;  // sums: T, or its wide type for 32-bit parts
  extern __shared__ __align__(16) unsigned char e_smem[];
  A* smem = reinterpret_cast<A*>(e_smem);
  A* red = smem;                   // [2][NT][VEC][KB] phase-1 partials
  A* ys = red + 2 * NT * VEC * KB;  // [NT][KB] staged Y rows
  A* tpart = ys + NT * KB;         // [2][kc][KB] this CTA's partial t
  A* tfull = tpart + 2 * kc * KB;  // [2][kc][KB] the cluster's sum
  const int red_lo = NT * VEC * KB, t_lo = kc * KB;  // offsets of the lo halves
  const int64_t b = blockIdx.x / cs;
  const int rank = blockIdx.x % cs;  // the CTA's rank in its cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = (kc + VEC - 1) / VEC;  // column groups of VEC
  const T* Vb = V + b * Cc * kc;
  const T* Ub = U + b * R * kc;
  const int c0 = min(rank * cstep, Cc), c1 = min(c0 + cstep, Cc);
  const int q0 = min(rank * rstep, R), q1 = min(q0 + rstep, R);
  // phase 2's lanes per row: a power of two covering P, at most a warp
  int L = 1;
  while (L < P && L < 32) L <<= 1;
  const int rpw = 32 / L, sub = lane % L, slot = lane / L;
  const int span = (NT / 32) * rpw;  // rows per pass of the CTA

  for (int r0 = 0; r0 < k; r0 += KB) {
    // phase 1: tpart[kk][r] = sum_{c in slice} V[b, c, kk] * Y[b, c, r0 + r]
    for (int p0 = 0; p0 < P; p0 += NT) {
      const int pw = min(P - p0, NT);
      const int G = NT / pw;
      const int g = tid / pw, pl = tid % pw;
      const int col = (p0 + pl) * VEC;
      A acc[VEC][KB], acl[VEC][KB];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int r = 0; r < KB; ++r) acc[v][r] = acl[v][r] = A(0.0);
      // the slice's rows in chunks of NT: each thread stages one Y row (the
      // gather of the backward form happens once per row, all of a chunk's
      // in flight together), then the column groups walk the chunk, loading
      // E_UNROLL rows of V before they multiply
      for (int cb = c0; cb < c1; cb += NT) {
        const int nc = min(NT, c1 - cb);
        if (tid < nc) {
          const int c = cb + tid;
          if (X != nullptr) {
            const T* xr = X + (b * Cc + c) * (int64_t)k + r0;
#pragma unroll
            for (int r = 0; r < KB; ++r)
              ys[tid * KB + r] = r0 + r < k ? hs_wide(hs_ldg(xr + r)) : A(0.0);
          } else {
            const int id = __ldg(ids_in + b * Cc + c);
#pragma unroll
            for (int r = 0; r < KB; ++r)
              ys[tid * KB + r] =
                  id < N && r0 + r < k ? hs_wide(C[(int64_t)id * k + r0 + r])
                                       : A(0.0);
          }
        }
        __syncthreads();
        if (g < G) {
          for (int c = g; c < nc; c += E_UNROLL * G) {
            A vv[E_UNROLL][VEC];
#pragma unroll
            for (int u = 0; u < E_UNROLL; ++u) {
              if (c + u * G < nc) {
                e_load<VEC>(Vb + (int64_t)(cb + c + u * G) * kc + col, vv[u]);
              } else {
#pragma unroll
                for (int v = 0; v < VEC; ++v) vv[u][v] = A(0.0);
              }
            }
#pragma unroll
            for (int u = 0; u < E_UNROLL; ++u) {
              if (c + u * G < nc) {
#pragma unroll
                for (int v = 0; v < VEC; ++v)
#pragma unroll
                  for (int r = 0; r < KB; ++r)
                    acc_fma<DD>(acc[v][r], acl[v][r], vv[u][v],
                           ys[(c + u * G) * KB + r]);
              }
            }
          }
        }
        __syncthreads();  // ys is restaged for the next chunk
      }
      if (g < G) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
#pragma unroll
          for (int r = 0; r < KB; ++r) {
            const int at = ((g * pw + pl) * VEC + v) * KB + r;
            red[at] = acc[v][r];
            red[red_lo + at] = acl[v][r];
          }
      }
      __syncthreads();
      for (int e = tid; e < pw * VEC * KB; e += NT) {
        const int kk = p0 * VEC + e / KB;
        A hi = A(0.0), lo = A(0.0);
        for (int gg = 0; gg < G; ++gg) {
          const int at = gg * pw * VEC * KB + e;
          acc_add<DD>(hi, lo, red[at], red[red_lo + at]);
        }
        if (kk < kc) {
          tpart[kk * KB + e % KB] = hi;
          tpart[t_lo + kk * KB + e % KB] = lo;
        }
      }
      __syncthreads();
    }
    // the cluster's sum, the same on every CTA (ranks in order)
    const A* t = tpart;
    if (cs > 1) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      for (int e = tid; e < kc * KB; e += NT) {
        A hi = A(0.0), lo = A(0.0);
        for (int j = 0; j < cs; ++j) {
          const A* peer = cl.map_shared_rank(tpart, j);
          acc_add<DD>(hi, lo, peer[e], peer[t_lo + e]);
        }
        tfull[e] = hi;
        tfull[t_lo + e] = lo;
      }
      __syncthreads();
      t = tfull;
    }
    // phase 2: C[ids_out[b, row], r0 + r] -= U[b, row, :] . t[:, r] over the
    // CTA's rows, E_UNROLL rows of U loaded before they multiply
    for (int base = q0; base < q1; base += span * E_UNROLL) {
      int row[E_UNROLL];
      A acc[E_UNROLL][KB], acl[E_UNROLL][KB];
#pragma unroll
      for (int u = 0; u < E_UNROLL; ++u) {
        row[u] = base + u * span + warp * rpw + slot;
#pragma unroll
        for (int r = 0; r < KB; ++r) acc[u][r] = acl[u][r] = A(0.0);
      }
      for (int p = sub; p < P; p += L) {
        A uu[E_UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < E_UNROLL; ++u) {
          if (row[u] < q1) {
            e_load<VEC>(Ub + (int64_t)row[u] * kc + p * VEC, uu[u]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) uu[u][v] = A(0.0);
          }
        }
        A tv[VEC][KB], tl[VEC][KB];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
#pragma unroll
          for (int r = 0; r < KB; ++r) {
            const bool in = p * VEC + v < kc;
            tv[v][r] = in ? t[(p * VEC + v) * KB + r] : A(0.0);
            tl[v][r] = in ? t[t_lo + (p * VEC + v) * KB + r] : A(0.0);
          }
#pragma unroll
        for (int u = 0; u < E_UNROLL; ++u)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int r = 0; r < KB; ++r)
              acc_mul_pair<DD>(acc[u][r], acl[u][r], uu[u][v], tv[v][r],
                               tl[v][r]);
      }
#pragma unroll
      for (int u = 0; u < E_UNROLL; ++u) {
#pragma unroll
        for (int r = 0; r < KB; ++r)
          for (int off = L >> 1; off > 0; off >>= 1) {
            const A h = hs_shfl_xor(acc[u][r], off);
            const A l = DD ? hs_shfl_xor(acl[u][r], off) : A(0.0);
            acc_add<DD>(acc[u][r], acl[u][r], h, l);
          }
        if (sub == 0 && row[u] < q1) {
          const int out = __ldg(ids_out + b * R + row[u]);
          if (out < N) {
#pragma unroll
            for (int r = 0; r < KB; ++r)
              if (r0 + r < k)
                hs_atomic_add(C + (int64_t)out * k + r0 + r,
                              static_cast<T>(-(acc[u][r] + acl[u][r])));
          }
        }
      }
    }
    // the next chunk rewrites red, ys, tpart and tfull, and a peer may still
    // be reading this CTA's tpart
    if (cs > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
}

template <typename T, int NT, int VEC, int KB, bool DD>
static int lowrank_sweep_launch(T* C, const int* ids_out, const T* U,
                                const T* V, const T* X, const int* ids_in,
                                long long B, int R, int Cc, int kc, int k,
                                int N, int cs, int rstep, int cstep,
                                size_t smem, cudaStream_t stream) {
  auto kern = lowrank_sweep_update_kernel<T, NT, VEC, KB, DD>;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  if (cs > 8 &&
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, C, ids_out, U, V, X, ids_in, R, Cc, kc,
                           k, N, cs, rstep, cstep);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// the instances of one value type: VEC is 1, or the values of a 16-byte
// load where that is more (two doubles, four floats, two complex64 values; a
// complex128 value is its own 16 bytes)
template <typename T, int NT, bool DD>
static int lowrank_sweep_dispatch(T* c, const int* o, const T* u, const T* v,
                                  const T* x, const int* in, long long B,
                                  int R, int Cc, int kc, int k, int N, int cs,
                                  int rstep, int cstep, int vec, int kb,
                                  size_t smem, cudaStream_t s) {
  constexpr int V16 = hs_vec16<T>::n;
  if (V16 > 1 && vec == V16) {
    if (kb == 1)
      return lowrank_sweep_launch<T, NT, V16, 1, DD>(
          c, o, u, v, x, in, B, R, Cc, kc, k, N, cs, rstep, cstep, smem, s);
    return lowrank_sweep_launch<T, NT, V16, 4, DD>(
        c, o, u, v, x, in, B, R, Cc, kc, k, N, cs, rstep, cstep, smem, s);
  }
  if (kb == 1)
    return lowrank_sweep_launch<T, NT, 1, 1, DD>(c, o, u, v, x, in, B, R, Cc,
                                                 kc, k, N, cs, rstep, cstep,
                                                 smem, s);
  return lowrank_sweep_launch<T, NT, 1, 4, DD>(c, o, u, v, x, in, B, R, Cc, kc,
                                               k, N, cs, rstep, cstep, smem, s);
}

// The geometry (cs, threads, rstep, cstep, vec, kb, dd, smem) is
// lowrank_sweep_geometry's in ops/sweep.py; this entry point only checks that
// it covers the front and that its shared memory holds the kernel's tiles.
template <typename T>
static int lowrank_sweep_entry(void* C, const void* ids_out, const void* U,
                               const void* V, const void* X,
                               const void* ids_in, long long B, int R, int Cc,
                               int kc, int k, int N, int cs, int threads,
                               int rstep, int cstep, int vec, int kb, int dd,
                               long long smem, void* stream) {
  if (B <= 0 || R <= 0 || Cc <= 0 || kc <= 0 || k <= 0) return 0;
  if (cs < 1 || cs > 16 || (threads != 256 && threads != 1024) ||
      (long long)rstep * cs < R || (long long)cstep * cs < Cc ||
      (vec != 1 && vec != hs_vec16<T>::n) || kc % vec ||
      (kb != 1 && kb != 4) ||
      smem < (long long)(threads * (2 * vec + 1) * kb + 4 * kc * kb) *
                 (long long)sizeof(hs_acc_t<T>) ||
      B * cs > 0x7fffffffLL || (dd && hs_widened<T>))
    return (int)cudaErrorInvalidValue;
  T* c = (T*)C;
  const int* o = (const int*)ids_out;
  const T *u = (const T*)U, *v = (const T*)V, *x = (const T*)X;
  const int* in = (const int*)ids_in;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  if constexpr (hs_widened<T>) {  // float32, complex64: wide sums, no dd
    if (threads == 1024)
      return lowrank_sweep_dispatch<T, 1024, false>(c, o, u, v, x, in, B, R,
                                                    Cc, kc, k, N, cs, rstep,
                                                    cstep, vec, kb, sm, s);
    return lowrank_sweep_dispatch<T, 256, false>(c, o, u, v, x, in, B, R, Cc,
                                                 kc, k, N, cs, rstep, cstep,
                                                 vec, kb, sm, s);
  } else {
    if (threads == 1024)
      return dd ? lowrank_sweep_dispatch<T, 1024, true>(
                      c, o, u, v, x, in, B, R, Cc, kc, k, N, cs, rstep, cstep,
                      vec, kb, sm, s)
                : lowrank_sweep_dispatch<T, 1024, false>(
                      c, o, u, v, x, in, B, R, Cc, kc, k, N, cs, rstep, cstep,
                      vec, kb, sm, s);
    return dd ? lowrank_sweep_dispatch<T, 256, true>(c, o, u, v, x, in, B, R,
                                                     Cc, kc, k, N, cs, rstep,
                                                     cstep, vec, kb, sm, s)
              : lowrank_sweep_dispatch<T, 256, false>(c, o, u, v, x, in, B, R,
                                                      Cc, kc, k, N, cs, rstep,
                                                      cstep, vec, kb, sm, s);
  }
}

#define HS_SWEEP_ARGS                                                        \
  void *C, const void *ids_out, const void *U, const void *V, const void *X, \
      const void *ids_in, long long B, int R, int Cc, int kc, int k, int N,  \
      int cs, int threads, int rstep, int cstep, int vec, int kb, int dd,    \
      long long smem, void *stream
#define HS_SWEEP_PASS                                                        \
  C, ids_out, U, V, X, ids_in, B, R, Cc, kc, k, N, cs, threads, rstep, cstep, \
      vec, kb, dd, smem, stream

HS_EXPORT int hs_lowrank_sweep_update(HS_SWEEP_ARGS) {
  return lowrank_sweep_entry<double>(HS_SWEEP_PASS);
}

HS_EXPORT int hs_lowrank_sweep_update_f32(HS_SWEEP_ARGS) {
  return lowrank_sweep_entry<float>(HS_SWEEP_PASS);
}

HS_EXPORT int hs_lowrank_sweep_update_c128(HS_SWEEP_ARGS) {
  return lowrank_sweep_entry<hs_c128>(HS_SWEEP_PASS);
}

HS_EXPORT int hs_lowrank_sweep_update_c64(HS_SWEEP_ARGS) {
  return lowrank_sweep_entry<hs_c64>(HS_SWEEP_PASS);
}
