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
// differ only in the summation order of the three reductions; each column's
// arithmetic is the same whatever the cluster size.
//
// Float32 input (hs_cpqr_f32, the JAX bench's device configuration) is
// widened to float64 as it is loaded, and the pivot loop runs in float64, as
// kernels C and E sum a float32 sweep in float64 (fault F4's rule): in
// float32 the downdate norms^2 - coef^2 cancels to rounding noise once a
// column's residual falls to 3e-4 of its norm (norms^2 at float32's epsilon),
// which is where the transition compressions' 2.5e-4 truncations decide
// their ranks, so a float32 loop and its plain version part on the rank of
// thousands of the n=512 plans' matrices (a downdated norm^2 rounded to 0,
// the column never pivoted), not at rounding ties (fault F8, ROADMAP).
//
// Values are float64 (hs_cpqr) or complex128 (hs_cpqr_c128, the damped
// Helmholtz system's levels, stored interleaved as torch stores them).  In
// complex the norms stay real: |a|^2 = re^2 + im^2 (each product rounded,
// as the plain version's), coef = conj(q)^T A (the JAX package's q^H A),
// q = a / nrm divides each part, and the downdate subtracts |coef|^2.
// The elementwise update A -= q coef rounds each product and each sum of a
// complex product (torch's order); the complex dot products of coef
// accumulate with fused multiply-adds.
//
// Bound: latency.  The k steps are sequential, and at the default rank caps
// a panel is up to [202, 384] (620 KB), more than one SM's shared memory.
// So one matrix's columns are spread over a thread block cluster of cs CTAs
// (1, 2, 4 or 8, the fewest whose shared memory holds them; the wrapper
// picks cs by bytes): CTA c keeps columns [c w, c w + w) resident, w =
// ceil(n / cs), and a step is
//   - each CTA's argmax over its columns, stored into every CTA's slot c
//     through distributed shared memory (st.shared::cluster), one cluster
//     barrier, and the same reduction over the cs slots in every CTA;
//   - the owner CTA of column p forms the pivot norm and q and stores q
//     and ok into every CTA, one cluster barrier;
//   - each CTA projects and downdates its own columns.
// A matrix beyond 8 CTAs' shared memory keeps its columns in a global
// scratch copy instead (resident in L2), with the same steps.
#include <math.h>

#include <cooperative_groups.h>

#include "hs_common.cuh"
#include "hs_complex.cuh"

namespace cg = cooperative_groups;

#define H_THREADS 256
#define H_MAX_CLUSTER 8

// (value, index) pair reduction favouring the larger value, then the smaller
// index: the first maximum.
__device__ __forceinline__ void argmax_merge(double& v, int& i, double ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// a barrier over the CTAs of one matrix
__device__ __forceinline__ void matrix_sync(int cs) {
  if (cs > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// the address of `p` (in this CTA's shared memory) in CTA `c` of the cluster
template <typename T>
__device__ __forceinline__ T* in_cta(T* p, int c, int rank) {
  return c == rank ? p : cg::this_cluster().map_shared_rank(p, c);
}

// |v|^2, each product rounded (the plain version's elementwise order)
__device__ __forceinline__ double h_abs2(hs_c128 v) {
  return __dadd_rn(__dmul_rn(v.re, v.re), __dmul_rn(v.im, v.im));
}

// a - q c with each product and sum rounded, as torch's complex product and
// difference
__device__ __forceinline__ hs_c128 h_sub_prod(hs_c128 a, hs_c128 q,
                                              hs_c128 c) {
  const double pr = __dsub_rn(__dmul_rn(q.re, c.re), __dmul_rn(q.im, c.im));
  const double pi = __dadd_rn(__dmul_rn(q.re, c.im), __dmul_rn(q.im, c.re));
  return hs_c128(__dsub_rn(a.re, pr), __dsub_rn(a.im, pi));
}

// TI the input's type; T the loop's (hs_acc_t<TI>: double for float32 and
// float64, hs_c128 for complex128)
template <typename TI, typename T = hs_acc_t<TI>>
__global__ void __launch_bounds__(H_THREADS)
    hss_cpqr_kernel(const TI* __restrict__ A, int* __restrict__ piv,
                    int* __restrict__ rank_out, T* __restrict__ gwork,
                    double atol, double rtol, int m, int n, int k, int cs) {
  constexpr bool CPLX = hs_traits<T>::complex;
  extern __shared__ __align__(16) unsigned char h_smem[];
  __shared__ double slot_v[H_MAX_CLUSTER], slot_max[H_MAX_CLUSTER];
  __shared__ int slot_i[H_MAX_CLUSTER];
  __shared__ double red_v[H_THREADS / 32];
  __shared__ int red_i[H_THREADS / 32];
  __shared__ int s_ok, s_rank, s_p;
  __shared__ double s_thr, s_nrm;

  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t b = blockIdx.x / cs;
  const int w = (n + cs - 1) / cs;               // columns per CTA
  const int c0 = rank * w;
  const int nc = max(0, min(w, n - c0));         // this CTA's columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = H_THREADS / 32;
  // this CTA's columns, [m][w] row-major: in shared memory, or in the
  // global scratch for matrices beyond the cluster's shared memory
  T* smem = reinterpret_cast<T*>(h_smem);
  T* a = gwork != nullptr ? gwork + blockIdx.x * (int64_t)m * w : smem;
  T* coef = gwork != nullptr ? smem : smem + (int64_t)m * w;  // [w]
  T* q = coef + w;            // [m] pivot direction (stored by the owner)
  double* nrm2 = reinterpret_cast<double*>(q + m);  // [w] squared norms
  const TI* Ab = A + b * (int64_t)m * n;
  for (int e = tid; e < m * nc; e += H_THREADS) {
    const int r = e / nc, c = e - r * nc;
    a[r * w + c] = hs_wide(Ab[(int64_t)r * n + c0 + c]);
  }
  __syncthreads();

  // initial norms and the rtol reference norm0 = sqrt(max norms^2)
  double mx = -INFINITY;
  for (int c = tid; c < nc; c += H_THREADS) {
    double s = 0.0;
    for (int i = 0; i < m; ++i) {
      const T v = a[i * w + c];
      if constexpr (CPLX)
        s += h_abs2(v);
      else
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
    for (int i = 1; i < nwarps; ++i) v = fmax(v, red_v[i]);
    for (int c = 0; c < cs; ++c) in_cta(slot_max, c, rank)[rank] = v;
    s_ok = 1;
    s_rank = 0;
  }
  matrix_sync(cs);
  if (tid == 0) {
    double v = slot_max[0];
    for (int c = 1; c < cs; ++c) v = fmax(v, slot_max[c]);
    s_thr = fmax(rtol * __dsqrt_rn(v), atol);
  }
  __syncthreads();
  const double thr = s_thr;

  for (int j = 0; j < k; ++j) {
    // 1. this CTA's first argmax of nrm2, into every CTA's slot `rank`
    double bv = -INFINITY;
    int bi = n;
    for (int c = tid; c < nc; c += H_THREADS)
      argmax_merge(bv, bi, nrm2[c], c0 + c);
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
      const double v0 = __shfl_sync(0xffffffffu, v, 0);
      const int i0 = __shfl_sync(0xffffffffu, i, 0);
      if (lane < cs) {    // lane c stores into CTA c
        in_cta(slot_v, lane, rank)[rank] = v0;
        in_cta(slot_i, lane, rank)[rank] = i0;
      }
    }
    matrix_sync(cs);
    // 2. the cluster's pivot, the same in every CTA
    double pv = slot_v[0];
    int p = slot_i[0];
    for (int c = 1; c < cs; ++c) argmax_merge(pv, p, slot_v[c], slot_i[c]);
    const int owner = p / w;
    if (owner == rank) {
      // the exact norm of the pivot column (warp 0 alone), then q and ok
      // into every CTA
      const int pl = p - c0;
      if (warp == 0) {
        double s = 0.0;
        for (int r = lane; r < m; r += 32) {
          const T x = a[r * w + pl];
          if constexpr (CPLX)
            s += h_abs2(x);
          else
            s += x * x;
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) {
          const double nrm = __dsqrt_rn(fmax(s, 1e-300));
          const int ok = s_ok && nrm > thr;
          piv[b * k + j] = ok ? p : -1;
          s_nrm = nrm;
          for (int c = 0; c < cs; ++c) in_cta(&s_ok, c, rank)[0] = ok;
        }
      }
      __syncthreads();
      const int ok = s_ok;
      const double nrm = s_nrm;
      for (int e = tid; e < m * cs; e += H_THREADS) {
        const int r = e % m, c = e / m;
        T v = T(0.0);
        if (ok) {
          if constexpr (CPLX)
            v = hs_c128(__ddiv_rn(a[r * w + pl].re, nrm),
                        __ddiv_rn(a[r * w + pl].im, nrm));
          else
            v = __ddiv_rn(a[r * w + pl], nrm);
        }
        in_cta(q, c, rank)[r] = v;
      }
    }
    matrix_sync(cs);
    const int ok = s_ok;
    if (tid == 0) s_rank += ok;
    // 3. coef = q^H A on this CTA's columns
    for (int c = tid; c < nc; c += H_THREADS) {
      T s = T(0.0);
      for (int r = 0; r < m; ++r) s += hs_conj(q[r]) * a[r * w + c];
      coef[c] = s;
    }
    __syncthreads();
    // 4. A -= q coef; downdate the norms; exclude the pivot
    for (int e = tid; e < m * nc; e += H_THREADS) {
      const int r = e / nc, c = e - r * nc;
      if constexpr (CPLX)
        a[r * w + c] = h_sub_prod(a[r * w + c], q[r], coef[c]);
      else
        a[r * w + c] = __dsub_rn(a[r * w + c], __dmul_rn(q[r], coef[c]));
    }
    for (int c = tid; c < nc; c += H_THREADS) {
      double c2;
      if constexpr (CPLX)
        c2 = h_abs2(coef[c]);
      else
        c2 = __dmul_rn(coef[c], coef[c]);
      const double d = fmax(__dsub_rn(nrm2[c], c2), 0.0);
      nrm2[c] = c0 + c == p ? -INFINITY : d;
    }
    __syncthreads();
  }
  if (tid == 0 && rank == 0) rank_out[b] = s_rank;
  // no CTA leaves while others may still store into its shared memory
  matrix_sync(cs);
}

// smem: the CTA's columns (unless in the global scratch), coefficients and
// pivot direction in the loop's type T, the norms in double
// (ops/lowrank.py cpqr_smem); TI the input's type
template <typename TI>
static int launch_cpqr(const void* A, void* piv, void* rank, void* gwork,
                       double atol, double rtol, long long B, int m, int n,
                       int k, int cs, void* stream) {
  typedef hs_acc_t<TI> T;
  if (B > 0 && k > 0) {
    if (cs < 1 || cs > H_MAX_CLUSTER || n < 1 || m < 1)
      return (int)cudaErrorInvalidValue;
    const size_t w = (size_t)(n + cs - 1) / cs;
    const size_t smem =
        ((gwork != nullptr ? 0 : (size_t)m * w) + w + (size_t)m) * sizeof(T) +
        w * sizeof(double);
    auto kern = hss_cpqr_kernel<TI>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * cs));
    cfg.blockDim = dim3(H_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kern, (const TI*)A, (int*)piv, (int*)rank, (T*)gwork, atol, rtol,
        m, n, k, cs);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_cpqr(const void* A, void* piv, void* rank, void* gwork,
                      double atol, double rtol, long long B, int m, int n,
                      int k, int cs, void* stream) {
  return launch_cpqr<double>(A, piv, rank, gwork, atol, rtol, B, m, n, k, cs,
                             stream);
}

HS_EXPORT int hs_cpqr_f32(const void* A, void* piv, void* rank, void* gwork,
                          double atol, double rtol, long long B, int m, int n,
                          int k, int cs, void* stream) {
  return launch_cpqr<float>(A, piv, rank, gwork, atol, rtol, B, m, n, k, cs,
                            stream);
}

HS_EXPORT int hs_cpqr_c128(const void* A, void* piv, void* rank, void* gwork,
                           double atol, double rtol, long long B, int m, int n,
                           int k, int cs, void* stream) {
  return launch_cpqr<hs_c128>(A, piv, rank, gwork, atol, rtol, B, m, n, k, cs,
                              stream);
}
