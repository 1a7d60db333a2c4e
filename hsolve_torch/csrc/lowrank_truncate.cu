// Kernel G: the product and truncation epilogue of the randomized low-rank
// factorization.
//
// Replaces the tail of hsolve/ops/lowrank.py `rand_lowrank` (:157-165): the
// product Q @ Uw, `_rank_mask` (:130-138) and the scaling, transposition and
// cap padding, about nine XLA ops, twice per compressed level:
//
//     rank[b] = min(#{i : sv[b, i] > max(atol, rtol * sv[b, 0])}, cap)
//     U[b, i, j] = (sum_k Q[b, i, k] Uw[b, k, j]) * sv[b, j]   j < rank[b]
//     V[b, i, j] = Vh[b, j, i]                                 j < rank[b]
//     U, V = 0                                                 rank[b] <= j < cap
//
// with Q [B, m, s], Uw [B, s, r], sv [B, r] (descending), Vh [B, r, n].  Only
// the rank's columns of the product are computed: the rest of U is zero.
//
// Bound: Q, Uw, sv and Vh read once, U and V written once; the product's
// 2 m s rank operations a front on the FP64 tensor cores (mma.sync
// m16n8k16 .f64).  Layout: one CTA of 256 threads per 64 x 64 tile of U
// (rows of m, columns of cap) or of V (rows of n, columns of cap), every
// front's tiles in one grid (blockIdx.y the front), so a front of 2216 rows
// at cap 560 spreads over hundreds of CTAs.  Each CTA counts its front's
// rank with warp 0's ballots over sv.  A U tile streams 32-deep chunks of
// Q's rows and Uw's columns through a two-stage cp.async ring in shared
// memory (16-byte copies where the rows allow), its eight warps each
// holding four 16 x 8 blocks of the tile; a tile past the rank only writes
// zeros.  A V tile reads Vh's rows coalesced into a shared-memory tile and
// writes its transpose coalesced.
//
// Complex128 (the damped Helmholtz system's low-rank levels): Q, Uw, Vh, U
// and V hs_c128, sv real; V = Vh^T, the plain transpose (A ~= U V^T, the
// JAX package's convention: not conjugated).  The same tiles on the CUDA
// cores, a complex multiply-add as four real FMAs: each thread a 4 x 4
// register tile of U (rows ty + 16 a, columns tx + 16 c), 16-deep chunks of
// Q and Uw staged in shared memory, whose size is counted in the value's
// bytes.  Float32 (the JAX bench's device configuration) takes the same
// CUDA-core kernel, one FMA a multiply-add (no TF32), sv float32 and the
// threshold rounded in float32 as the plain version rounds it; complex64
// (the bench's complex device configuration) too, a complex multiply-add
// four float FMAs, summed in complex64, sv float32.
#include "hs_common.cuh"
#include "hs_complex.cuh"

#define G_THREADS 256
#define G_TILE 64
#define G_KC 32
#define G_LDA (G_KC + 4)
#define G_LDB (G_TILE + 4)
#define G_LDT (G_TILE + 1)
#define G_STAGE (G_TILE * G_LDA + G_KC * G_LDB)  // doubles of one stage
#define G_SMEM (2 * G_STAGE * 8)                 // bytes: the two stages
// V's transposition tile fits one stage, which a depth of one chunk needs
static_assert(G_TILE * G_LDT <= G_STAGE, "V's tile fits one stage");

// cp.async of 8 or 16 bytes, zero-filled where not `ok` (src must still be
// a mapped address)
__device__ __forceinline__ void g_cp8(double* dst, const double* src,
                                      bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void g_cp16(double* dst, const double* src,
                                       bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void g_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int n>
__device__ __forceinline__ void g_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// d += A B on the FP64 tensor cores, one warp, for a 16 x 8 output block
// and a depth of 16 (m16n8k16 .f64): lane l holds A's rows l / 4 (a0[j])
// and l / 4 + 8 (a1[j]) at columns l % 4 + 4 j, B's rows l % 4 + 4 j (b[j])
// at column l / 4, and D's rows l / 4 (d[0]) and l / 4 + 8 (d[1]) at
// columns 2 (l % 4) + i
__device__ __forceinline__ void gmma(double (&d)[2][2], const double (&a0)[4],
                                     const double (&a1)[4],
                                     const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0][0]), "+d"(d[0][1]), "+d"(d[1][0]), "+d"(d[1][1])
      : "d"(a0[0]), "d"(a1[0]), "d"(a0[1]), "d"(a1[1]), "d"(a0[2]),
        "d"(a1[2]), "d"(a0[3]), "d"(a1[3]), "d"(b[0]), "d"(b[1]), "d"(b[2]),
        "d"(b[3]));
}

// the threshold max(atol, rtol sv[0]) in sv's real type: in float32 as the
// plain version's float32 ops round it (rtol and atol rounded to float32,
// one product, a maximum)
__device__ __forceinline__ double g_thr(double s0, double atol, double rtol) {
  return fmax(rtol * s0, atol);
}
__device__ __forceinline__ float g_thr(float s0, double atol, double rtol) {
  return fmaxf(__fmul_rn((float)rtol, s0), (float)atol);
}

// the rank: warp 0 counts sv's values above max(atol, rtol sv[0]), 32 a
// ballot, capped; block 0 of the front stores it; every thread gets it
template <typename R>
__device__ __forceinline__ int g_rank(const R* sb, int r, double atol,
                                      double rtol, int cap, int* s_rank,
                                      int* rank_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int cnt = 0;
    if (r > 0) {
      const R thr = g_thr(sb[0], atol, rtol);
      for (int i0 = 0; i0 < r; i0 += 32) {
        const int i = i0 + lane;
        cnt += __popc(__ballot_sync(0xffffffffu, i < r && sb[i] > thr));
      }
    }
    if (lane == 0) {
      *s_rank = cnt < cap ? cnt : cap;
      if (blockIdx.x == 0) *rank_out = *s_rank;
    }
  }
  __syncthreads();
  return *s_rank;
}

// What a CTA of G does besides the product, for values T of one front:
// the rank, the CTA's tile (blockIdx.x: U's tiles, rows of m by columns of
// cap, then V's, rows of n), a V tile (V[i, j] = Vh[j, i] for j below the
// rank, the plain transpose, coalesced both ways through `tile`, [G_TILE]
// [G_LDT]) and a U tile at or past the rank (zeros).  Returns true where
// the CTA is done; else it owns the U tile at rows i0.., columns j0.. below
// the rank rk.
template <typename T, typename R>
__device__ __forceinline__ bool g_other_tiles(
    const T* vh, T* u, T* v, const R* sb, int* rank_out, int* s_rank,
    T* tile, double atol, double rtol, int m, int n, int r, int cap, int& i0,
    int& j0, int& rk) {
  const int tid = threadIdx.x;
  rk = g_rank(sb, r, atol, rtol, cap, s_rank, rank_out);
  const int ct = (cap + G_TILE - 1) / G_TILE;
  const int tiles_u = ((m + G_TILE - 1) / G_TILE) * ct;
  int t = blockIdx.x;
  const bool is_u = t < tiles_u;
  if (!is_u) t -= tiles_u;
  i0 = (t / ct) * G_TILE;
  j0 = (t % ct) * G_TILE;
  if (!is_u) {
    if (j0 < rk) {
      for (int e = tid; e < G_TILE * G_TILE; e += G_THREADS) {
        const int jj = e / G_TILE, ii = e % G_TILE;
        const int i = i0 + ii, j = j0 + jj;
        tile[jj * G_LDT + ii] =
            (j < rk && i < n) ? vh[(int64_t)j * n + i] : T(0.0);
      }
      __syncthreads();
    }
    for (int e = tid; e < G_TILE * G_TILE; e += G_THREADS) {
      const int ii = e / G_TILE, jj = e % G_TILE;
      const int i = i0 + ii, j = j0 + jj;
      if (i < n && j < cap)
        v[(int64_t)i * cap + j] = j0 < rk ? tile[jj * G_LDT + ii] : T(0.0);
    }
    return true;
  }
  if (j0 >= rk) {  // past the rank: zeros
    for (int e = tid; e < G_TILE * G_TILE; e += G_THREADS) {
      const int i = i0 + e / G_TILE, j = j0 + e % G_TILE;
      if (i < m && j < cap) u[(int64_t)i * cap + j] = T(0.0);
    }
    return true;
  }
  return false;
}

__global__ void __launch_bounds__(G_THREADS)
    lowrank_truncate_kernel(const double* __restrict__ Q,
                            const double* __restrict__ Uw,
                            const double* __restrict__ sv,
                            const double* __restrict__ Vh,
                            double* __restrict__ U, double* __restrict__ V,
                            int* __restrict__ rank, double atol, double rtol,
                            int m, int n, int s, int r, int cap, int vec) {
  // the product's two stages, or V's transposition tile
  extern __shared__ double smem[];
  __shared__ int s_rank;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double* sb = sv + b * r;
  int i0, j0, rk;
  if (g_other_tiles(Vh + b * r * (int64_t)n, U + b * m * (int64_t)cap,
                    V + b * n * (int64_t)cap, sb, rank + b, &s_rank, smem,
                    atol, rtol, m, n, r, cap, i0, j0, rk))
    return;
  double* u = U + b * m * (int64_t)cap;

  // U tile: Q[i0:i0+64, :] @ Uw[:, j0:j0+64] in chunks of G_KC of depth,
  // chunk kt + 1 in flight while chunk kt is multiplied
  const double* qb = Q + b * m * (int64_t)s;
  const double* ub = Uw + b * s * (int64_t)r;
  auto stage = [&](int buf, int k0) {
    double* As = smem + buf * G_STAGE;  // [G_TILE][G_LDA]
    double* Bs = As + G_TILE * G_LDA;   // [G_KC][G_LDB]
    if (vec) {  // s and r even: every row starts on 16 bytes
      for (int c = tid; c < G_TILE * G_KC / 2; c += G_THREADS) {
        const int ii = c / (G_KC / 2), kk = 2 * (c % (G_KC / 2));
        const int i = i0 + ii, k = k0 + kk;
        const bool ok = i < m && k < s;
        g_cp16(As + ii * G_LDA + kk, ok ? qb + (int64_t)i * s + k : qb, ok);
      }
      for (int c = tid; c < G_KC * G_TILE / 2; c += G_THREADS) {
        const int kk = c / (G_TILE / 2), jj = 2 * (c % (G_TILE / 2));
        const int k = k0 + kk, j = j0 + jj;
        const bool ok = k < s && j < r;
        g_cp16(Bs + kk * G_LDB + jj, ok ? ub + (int64_t)k * r + j : ub, ok);
      }
    } else {
      for (int c = tid; c < G_TILE * G_KC; c += G_THREADS) {
        const int ii = c / G_KC, kk = c % G_KC;
        const int i = i0 + ii, k = k0 + kk;
        const bool ok = i < m && k < s;
        g_cp8(As + ii * G_LDA + kk, ok ? qb + (int64_t)i * s + k : qb, ok);
      }
      for (int c = tid; c < G_KC * G_TILE; c += G_THREADS) {
        const int kk = c / G_TILE, jj = c % G_TILE;
        const int k = k0 + kk, j = j0 + jj;
        const bool ok = k < s && j < r;
        g_cp8(Bs + kk * G_LDB + jj, ok ? ub + (int64_t)k * r + j : ub, ok);
      }
    }
    g_commit();
  };
  const int qr = lane >> 2, qc = lane & 3;
  const int rb = (warp & 3) * 16;     // this warp's 16 rows
  const int cb0 = (warp >> 2) * 4;    // and its four column blocks of 8
  double acc[4][2][2];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    acc[x][0][0] = acc[x][0][1] = acc[x][1][0] = acc[x][1][1] = 0.0;
  const int nk = (s + G_KC - 1) / G_KC;
  if (nk > 0) stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * G_KC);
      g_wait<1>();
    } else {
      g_wait<0>();
    }
    __syncthreads();
    const double* As = smem + (kt & 1) * G_STAGE;
    const double* Bs = As + G_TILE * G_LDA;
#pragma unroll
    for (int k16 = 0; k16 < G_KC; k16 += 16) {
      double a0[4], a1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a0[q] = As[(rb + qr) * G_LDA + k16 + qc + 4 * q];
        a1[q] = As[(rb + qr + 8) * G_LDA + k16 + qc + 4 * q];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        double bf[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bf[q] = Bs[(k16 + qc + 4 * q) * G_LDB + (cb0 + x) * 8 + qr];
        gmma(acc[x], a0, a1, bf);
      }
    }
    __syncthreads();  // the stage is refilled next
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + rb + qr + 8 * h;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + (cb0 + x) * 8 + 2 * qc + c;
        if (i < m && j < cap)
          u[(int64_t)i * cap + j] = j < rk ? acc[x][h][c] * sb[j] : 0.0;
      }
    }
  }
}

HS_EXPORT int hs_lowrank_truncate(const void* Q, const void* Uw,
                                  const void* sv, const void* Vh, void* U,
                                  void* V, void* rank, double atol,
                                  double rtol, long long B, int m, int n,
                                  int s, int r, int cap, void* stream) {
  if (B <= 0 || cap <= 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const long long ct = (cap + G_TILE - 1) / G_TILE;
  const long long tiles = (((long long)m + G_TILE - 1) / G_TILE +
                           ((long long)n + G_TILE - 1) / G_TILE) * ct;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        lowrank_truncate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  // 16-byte copies where every row of Q and Uw starts on 16 bytes
  const int vec = s % 2 == 0 && r % 2 == 0 &&
                  ((uintptr_t)Q | (uintptr_t)Uw) % 16 == 0;
  // a depth of one chunk (the 2D plans' sketches of 32) takes one stage:
  // twice the CTAs an SM
  const int smem = s > G_KC ? G_SMEM : G_SMEM / 2;
  dim3 grid((unsigned)(tiles > 0 ? tiles : 1), (unsigned)B);
  lowrank_truncate_kernel<<<grid, G_THREADS, smem, (cudaStream_t)stream>>>(
      (const double*)Q, (const double*)Uw, (const double*)sv,
      (const double*)Vh, (double*)U, (double*)V, (int*)rank, atol, rtol, m, n,
      s, r, cap, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The CUDA-core form: complex128 and complex64 (a complex multiply-add four
// real FMAs) and float32 (one FMA; float32 and complex64 summed in their
// own type as the JAX package's float32 and complex64 factors sum; no
// TF32), sv in the real type
// ---------------------------------------------------------------------------
#define GC_KC 16                          // depth of a staged chunk
#define GC_STAGE (2 * G_TILE * GC_KC)     // values: Q's and Uw's chunks
#define GC_SMEM_V (G_TILE * G_LDT)        // values: V's transposition tile
#define GC_VALUES (GC_STAGE > GC_SMEM_V ? GC_STAGE : GC_SMEM_V)

__device__ __forceinline__ void g_fma(hs_c128& acc, hs_c128 a, hs_c128 b) {
  acc.re = fma(a.re, b.re, acc.re);
  acc.re = fma(-a.im, b.im, acc.re);
  acc.im = fma(a.re, b.im, acc.im);
  acc.im = fma(a.im, b.re, acc.im);
}

__device__ __forceinline__ void g_fma(hs_c64& acc, hs_c64 a, hs_c64 b) {
  acc.re = fmaf(a.re, b.re, acc.re);
  acc.re = fmaf(-a.im, b.im, acc.re);
  acc.im = fmaf(a.re, b.im, acc.im);
  acc.im = fmaf(a.im, b.re, acc.im);
}

__device__ __forceinline__ void g_fma(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    lowrank_truncate_cc_kernel(const T* __restrict__ Q,
                               const T* __restrict__ Uw,
                               const hs_real_t<T>* __restrict__ sv,
                               const T* __restrict__ Vh, T* __restrict__ U,
                               T* __restrict__ V, int* __restrict__ rank,
                               double atol, double rtol, int m, int n, int s,
                               int r, int cap) {
  extern __shared__ __align__(16) unsigned char gsm_c[];
  T* smem = reinterpret_cast<T*>(gsm_c);
  __shared__ int s_rank;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const hs_real_t<T>* sb = sv + b * r;
  const T zero(0.0);
  int i0, j0, rk;
  if (g_other_tiles(Vh + b * r * (int64_t)n, U + b * m * (int64_t)cap,
                    V + b * n * (int64_t)cap, sb, rank + b, &s_rank, smem,
                    atol, rtol, m, n, r, cap, i0, j0, rk))
    return;
  T* u = U + b * m * (int64_t)cap;

  // U tile: Q[i0:i0+64, :] @ Uw[:, j0:j0+64] in chunks of GC_KC of depth
  const T* qb = Q + b * m * (int64_t)s;
  const T* ub = Uw + b * s * (int64_t)r;
  T* As = smem;                   // [G_TILE][GC_KC]
  T* Bs = As + G_TILE * GC_KC;    // [GC_KC][G_TILE]
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 16 a, cols tx + 16 c
  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = zero;
  for (int k0 = 0; k0 < s; k0 += GC_KC) {
    for (int e = tid; e < G_TILE * GC_KC; e += G_THREADS) {
      const int ii = e / GC_KC, kk = e % GC_KC;
      const int i = i0 + ii, k = k0 + kk;
      As[e] = i < m && k < s ? qb[(int64_t)i * s + k] : zero;
    }
    for (int e = tid; e < GC_KC * G_TILE; e += G_THREADS) {
      const int kk = e / G_TILE, jj = e % G_TILE;
      const int k = k0 + kk, j = j0 + jj;
      Bs[e] = k < s && j < r ? ub[(int64_t)k * r + j] : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < GC_KC; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[(ty + 16 * a) * GC_KC + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk * G_TILE + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) g_fma(acc[a][c], av[a], bv[c]);
    }
    __syncthreads();  // the chunk is restaged next
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < m && j < cap)
        u[(int64_t)i * cap + j] = j < rk ? sb[j] * acc[a][c] : zero;
    }
  }
}

template <typename T>
static int launch_truncate_cc(const void* Q, const void* Uw, const void* sv,
                              const void* Vh, void* U, void* V, void* rank,
                              double atol, double rtol, long long B, int m,
                              int n, int s, int r, int cap, void* stream) {
  if (B <= 0 || cap <= 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const long long ct = (cap + G_TILE - 1) / G_TILE;
  const long long tiles = (((long long)m + G_TILE - 1) / G_TILE +
                           ((long long)n + G_TILE - 1) / G_TILE) * ct;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = GC_VALUES * (int)sizeof(T);
  auto kern = lowrank_truncate_cc_kernel<T>;
  static bool attr = false;
  if (!attr && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((unsigned)(tiles > 0 ? tiles : 1), (unsigned)B);
  kern<<<grid, G_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)Q, (const T*)Uw, (const hs_real_t<T>*)sv, (const T*)Vh, (T*)U,
      (T*)V, (int*)rank, atol, rtol, m, n, s, r, cap);
  return (int)cudaGetLastError();
}

#define HS_TRUNC_ARGS                                                         \
  const void *Q, const void *Uw, const void *sv, const void *Vh, void *U,     \
      void *V, void *rank, double atol, double rtol, long long B, int m,      \
      int n, int s, int r, int cap, void *stream
#define HS_TRUNC_PASS \
  Q, Uw, sv, Vh, U, V, rank, atol, rtol, B, m, n, s, r, cap, stream

HS_EXPORT int hs_lowrank_truncate_c128(HS_TRUNC_ARGS) {
  return launch_truncate_cc<hs_c128>(HS_TRUNC_PASS);
}

HS_EXPORT int hs_lowrank_truncate_f32(HS_TRUNC_ARGS) {
  return launch_truncate_cc<float>(HS_TRUNC_PASS);
}

HS_EXPORT int hs_lowrank_truncate_c64(HS_TRUNC_ARGS) {
  return launch_truncate_cc<hs_c64>(HS_TRUNC_PASS);
}
