// Kernel F: Schur complement of a compressed level, stored already permuted,
// both of its products in one kernel.
//
// Replaces hsolve/factor.py `_factor_front_compressed_impl`'s
//
//     S = Abb - (Abi @ RU) @ RV^T;  S = permute_sym(S, sperm)     (:378-379)
//
// which XLA lowered as two GEMMs, a subtraction and two gathers.  With
// p = sperm[b] this kernel computes
//
//     W = Abi RU   (Abi = front[b, ni_pad:, :ni_pad], RU [ni_pad, kc])
//     S[b, i, j] = Abb[b, p_i, p_j] - sum_k W[p_i, k] RV[b, p_j, k]
//
// reading Abi and Abb in place from the front buffer (row stride m_pad; no
// copy) and storing S already in [int_loc; bnd_loc] order for the parent's
// extend-add.  W never reaches device memory.
//
// Bound: bytes at every n=512 launch shape: Abb and Abi are read and S
// written once; the two products add 2 kc (nb + ni_pad) operations an entry
// of S on the FP64 tensor cores, which run them (mma.sync m16n8k16 .f64:
// the deepest shape, so a chain of accumulations is a quarter as long as
// with m8n8k4's).
//
// Design.  A CTA of 256 threads (two a SM: at most 128 registers a thread)
// computes a bm x bn tile of one front's S: the band of rows [i0, i0 + bm)
// and columns [j0, j0 + bn).  All its loads are cp.async copies into shared
// memory; RU's first depth chunk is issued before the permutation arrives,
// and phase 2's operands behind phase 1's first chunk, without blocking it.
//   1. W for the band's rows, -(Abi[p_band, :] RU), over depth chunks of kd
//      (a multiple of 16 up to 64; Abi's rows and RU's rows staged per
//      chunk, one chunk at most of the n=512 launches);
//   2. S's tile = Abb's tile + (-W) RV[p_cols]^T, the accumulators started
//      from Abb's entries, written through shared memory to coalesced rows
//      of S.
// The geometry comes from ops/schur.py (`schur_geometry`, from the plan's
// shapes):
//   - whole rows (bn covers the front's nb columns; the many-front levels,
//     nb <= 128): the band's Abb rows are staged in their natural column
//     order, 16 bytes a copy, and the column permutation is applied from
//     shared memory; one CTA a front where nb <= 64;
//   - tiles of 32 x 64 on the wider fronts of the many-front levels, each
//     CTA computing its band's W itself (Abi's rows and RU from L2);
//   - tiles on the top levels, whose few fronts leave SMs idle: a row
//     band's column tiles form a thread block cluster of cs CTAs (at most
//     8).  Each CTA computes W's band over its share of the depth ni_pad
//     (rank r: rows [r kq, (r + 1) kq) of RU); between two cluster
//     barriers each rank sums a 1/cs share of the band's entries over the
//     ranks' partials, in rank order, through distributed shared memory and
//     stores the sums into every rank's copy of the band's W (a
//     reduce-scatter and a push: each CTA reads and writes about one band's
//     worth remotely, not cs of them): no product of W is computed twice,
//     and no entry summed twice.
//   Abb's tile is gathered entry by entry (sperm's runs of consecutive
//   indices keep the reads coalesced: 1-10 runs a front in the n=512
//   plans).
// The kernel's sums run in another order than the plain version's (the
// tensor cores', the depth split): it agrees to a relative 1e-13.
#include <cooperative_groups.h>

#include "hs_common.cuh"
#include "hs_complex.cuh"

namespace cg = cooperative_groups;

#define F_THREADS 256
#define F_WARPS (F_THREADS / 32)
#define F_MAX_KD 64         // the deepest staged chunk of Abi and RU
#define F_MAX_CLUSTER 8

// d += A B on the FP64 tensor cores, one warp, for a 16 x 8 output block
// and a depth of 16 (m16n8k16 .f64): lane l holds A's rows l / 4 (a0[j])
// and l / 4 + 8 (a1[j]) at columns l % 4 + 4 j, B's rows l % 4 + 4 j (b[j])
// at column l / 4, and D's rows l / 4 (d[0]) and l / 4 + 8 (d[1]) at
// columns 2 (l % 4) + i
__device__ __forceinline__ void fmma(double (&d)[2][2], const double (&a0)[4],
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

// this lane's A fragment of rows r and r + 8, columns k + l % 4 + 4 j, of a
// row-major tile with stride ld
__device__ __forceinline__ void frag_a(const double* t, int ld, int r, int k,
                                       double (&a0)[4], double (&a1)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a0[j] = t[r * ld + k + 4 * j];
    a1[j] = t[(r + 8) * ld + k + 4 * j];
  }
}

// cp.async of 8 or 16 bytes, the bytes past `valid` zero-filled (valid 0:
// nothing read; src must still be a mapped address)
__device__ __forceinline__ void cp8(double* dst, const double* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp16(double* dst, const double* src,
                                     int valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(8 * valid)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait for every copy group this thread committed but the newest `n`
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// dst[r][0, w) = src_r[0, w) for rows r < nr (src_r null: zeros); `n` of
// the w values are read (the rest zero-filled); 16 bytes a copy where `vec`
// (w, n even; rows 16-byte aligned)
template <typename RowFn>
__device__ __forceinline__ void stage_rows(double* dst, int ldd, int nr, int w,
                                           int n, bool vec, const double* any,
                                           RowFn row) {
  if (vec) {
    const int hw = w / 2;
    for (int e = threadIdx.x; e < nr * hw; e += F_THREADS) {
      const int r = e / hw, c = 2 * (e - r * hw);
      const double* s = row(r);
      const int ok = s == nullptr ? 0 : (n - c >= 2 ? 2 : (n - c > 0 ? n - c : 0));
      cp16(dst + r * ldd + c, ok ? s + c : any, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nr * w; e += F_THREADS) {
      const int r = e / w, c = e - r * w;
      const double* s = row(r);
      const bool ok = s != nullptr && c < n;
      cp8(dst + r * ldd + c, ok ? s + c : any, ok);
    }
  }
}

// dst[r][0, cols) = src[r][0, cols) for rows r < nrows (dst's row stride
// ld, src's lds), by the CTA's threads along the rows
__device__ void store_rows(double* dst, int ld, const double* src, int lds,
                           int nrows, int cols, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int hc = (cols + 1) / 2;
    for (int e = tid; e < nrows * hc; e += F_THREADS) {
      const int r = e / hc, c = 2 * (e - r * hc);
      if (c + 1 < cols) {
        *reinterpret_cast<double2*>(dst + (long long)r * ld + c) =
            *reinterpret_cast<const double2*>(src + r * lds + c);
      } else {
        dst[(long long)r * ld + c] = src[r * lds + c];
      }
    }
  } else {
    for (int e = tid; e < nrows * cols; e += F_THREADS) {
      const int r = e / cols, c = e - r * cols;
      dst[(long long)r * ld + c] = src[r * lds + c];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, 2)
lowrank_schur_update_kernel(const double* __restrict__ front,
                            const double* __restrict__ RU,
                            const double* __restrict__ RV,
                            const long long* __restrict__ sperm,
                            double* __restrict__ S, int m_pad, int ni_pad,
                            int kc, int bm, int bn, int cs, int kd, int whole,
                            int vec) {
  extern __shared__ __align__(16) double fsm[];
  const int nb = m_pad - ni_pad;
  const int kcp = (kc + 15) & ~15;
  const int ldw = kcp + 4;  // rows of W, RV, RU: 4 mod 16 doubles,
                            // conflict-free mma fragments
  const int aw = whole ? ((nb + 7) & ~7) : bn;  // Abb tile width
  const int lds = aw + (aw % 16 == 0 ? 8 : 0);
  double* Wp = fsm;                             // [bm][ldw] W (partial)
  double* Ws = cs > 1 ? Wp + bm * ldw : Wp;     // [bm][ldw] -W, the band's
  double* RVs = Ws + bm * ldw;                  // [bn][ldw] RV[p_cols]
  double* Ab = RVs + bn * ldw;                  // [bm][lds] Abb, then S
  const int lda = kd + 4;                       // 4 mod 16 doubles
  double* Ach = Ab + bm * lds;                  // [bm][lda] Abi chunk
  double* Uch = Ach + bm * lda;                 // [kd][ldw] RU chunk
  int* pi = reinterpret_cast<int*>(Uch + kd * ldw);     // [bm]
  int* pj = pi + bm;                                    // [bn]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = lane >> 2, qc = lane & 3;  // a fragment's row, column
  const long long b = blockIdx.z;
  const int i0 = blockIdx.y * bm, j0 = whole ? 0 : blockIdx.x * bn;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long* p = sperm + b * nb;
  const double* F = front + b * (long long)m_pad * m_pad +
                    (long long)ni_pad * m_pad;  // row ni_pad of the front

  // phase 1's depth: this rank's rows [kr0, kr1) of RU, in chunks of kd
  const int kq = ((ni_pad + cs - 1) / cs + 3) & ~3;
  const int kr0 = rank * kq, kr1 = min(ni_pad, kr0 + kq);
  const double* RUb = RU + b * (long long)ni_pad * kc;
  auto stage_ru = [&](int k0, int nk) {
    stage_rows(Uch, ldw, kd, kcp, kc, vec, RU, [&](int t) {
      return t < nk ? RUb + (long long)(k0 + t) * kc : nullptr;
    });
  };
  auto stage_abi = [&](int k0, int nk) {
    stage_rows(Ach, lda, bm, kd, nk, vec, front, [&](int r) {
      return pi[r] >= 0 ? F + (long long)pi[r] * m_pad + k0 : nullptr;
    });
  };
  // RU's first chunk needs no permutation: its copies fly while the
  // permutation loads; then Abi's rows (group 1), then phase 2's operands,
  // RV's rows p_cols and Abb's tile (group 2), which phase 1 does not wait for
  if (kr0 < kr1) stage_ru(kr0, min(kd, kr1 - kr0));
  for (int r = tid; r < bm; r += F_THREADS)
    pi[r] = i0 + r < nb ? (int)p[i0 + r] : -1;
  for (int c = tid; c < bn; c += F_THREADS)
    pj[c] = j0 + c < nb ? (int)p[j0 + c] : -1;
  __syncthreads();
  if (kr0 < kr1) stage_abi(kr0, min(kd, kr1 - kr0));
  cp_commit();
  const double* RVb = RV + b * (long long)nb * kc;
  stage_rows(RVs, ldw, bn, kcp, kc, vec, RV, [&](int c) {
    return pj[c] >= 0 ? RVb + (long long)pj[c] * kc : nullptr;
  });
  if (whole) {
    stage_rows(Ab, lds, bm, aw, nb, vec, front, [&](int r) {
      return pi[r] >= 0 ? F + (long long)pi[r] * m_pad + ni_pad : nullptr;
    });
  } else {
    for (int e = tid; e < bm * bn; e += F_THREADS) {
      const int r = e / bn, c = e - r * bn;
      const bool ok = pi[r] >= 0 && pj[c] >= 0;
      cp8(Ab + r * lds + c,
          ok ? F + (long long)pi[r] * m_pad + ni_pad + pj[c] : front, ok);
    }
  }
  cp_commit();

  // warp tiling of a bm-row block: 16-row block rp (rows r0, r0 + 8 of
  // each fragment), 8-column blocks cg0 + wpr u
  const int nrp = bm / 16, wpr = F_WARPS / nrp;
  const bool active = warp < nrp * wpr;
  const int r0 = (warp % nrp) * 16 + qr, cg0 = warp / nrp;

  // phase 1: W = Abi[p_band, kr0:kr1] RU[kr0:kr1, :], this rank's depth
  const int ncb = kcp / 8;
  for (int n0 = 0; n0 < ncb; n0 += 8 * wpr) {  // column groups of W
    double acc[8][2][2];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc[u][0][0] = acc[u][0][1] = acc[u][1][0] = acc[u][1][1] = 0.0;
    for (int k0 = kr0; k0 < kr1; k0 += kd) {
      const int nk = min(kd, kr1 - k0);
      if (n0 == 0 && k0 == kr0) {
        cp_wait<1>();  // the first chunk, staged above
      } else {
        stage_ru(k0, nk);
        stage_abi(k0, nk);
        cp_commit();
        cp_wait<0>();
      }
      __syncthreads();
      if (active) {
#pragma unroll 1
        for (int k16 = 0; k16 < (nk + 15) / 16; ++k16) {
          double a0[4], a1[4];
          frag_a(Ach, lda, r0, k16 * 16 + qc, a0, a1);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int cb = n0 + cg0 + wpr * u;
            if (cb < ncb) {  // warp-uniform
              double bf[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                bf[j] = Uch[(k16 * 16 + qc + 4 * j) * ldw + cb * 8 + qr];
              fmma(acc[u], a0, a1, bf);
            }
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      const double sg = cs > 1 ? 1.0 : -1.0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int cb = n0 + cg0 + wpr * u;
        if (cb < ncb) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            double* d = Wp + (r0 + 8 * h) * ldw + cb * 8 + 2 * qc;
            d[0] = sg * acc[u][h][0];
            d[1] = sg * acc[u][h][1];
          }
        }
      }
    }
  }
  if (cs > 1) {
    // the band's W, reduce-scattered: each rank sums its share of the
    // band's entries over the ranks' partials in rank order (one sum an
    // entry in the cluster, the same bits wherever it lands) and stores it
    // into every rank's Ws, two entries a copy; the second barrier makes
    // the stores visible and ends every read of another CTA's memory
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const int pairs = bm * kcp / 2, hk = kcp / 2;
    const int share = (pairs + cs - 1) / cs;
    const int e1 = min(pairs, (rank + 1) * share);
    for (int e = rank * share + tid; e < e1; e += F_THREADS) {
      const int at = (e / hk) * ldw + 2 * (e % hk);
      double2 v[F_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < F_MAX_CLUSTER; ++q)
        if (q < cs)
          v[q] = *reinterpret_cast<const double2*>(cl.map_shared_rank(Wp, q) +
                                                   at);
      double2 s = v[0];
#pragma unroll
      for (int q = 1; q < F_MAX_CLUSTER; ++q)
        if (q < cs) {
          s.x += v[q].x;
          s.y += v[q].y;
        }
      s.x = -s.x;
      s.y = -s.y;
#pragma unroll
      for (int q = 0; q < F_MAX_CLUSTER; ++q)
        if (q < cs) *reinterpret_cast<double2*>(cl.map_shared_rank(Ws, q) + at) = s;
    }
    cl.sync();
  }
  cp_wait<0>();  // phase 2's operands
  __syncthreads();

  // phase 2: S's tile = Abb's tile + (-W) RV^T, started from Abb's entries
  double acc[4][2][2];
  if (active) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cb = cg0 + wpr * u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cb * 8 + 2 * qc + e;
          double v = 0.0;
          if (c < bn)
            v = whole ? (pj[c] >= 0 ? Ab[r * lds + pj[c]] : 0.0)
                      : Ab[r * lds + c];
          acc[u][h][e] = v;
        }
      }
    }
    for (int k16 = 0; k16 < kcp / 16; ++k16) {
      double a0[4], a1[4];
      frag_a(Ws, ldw, r0, k16 * 16 + qc, a0, a1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cb = cg0 + wpr * u;
        if (cb * 8 < bn) {  // warp-uniform
          double bf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bf[j] = RVs[(cb * 8 + qr) * ldw + k16 * 16 + qc + 4 * j];
          fmma(acc[u], a0, a1, bf);
        }
      }
    }
  }
  __syncthreads();  // every Abb entry read before S overwrites the tile
  if (active) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cb = cg0 + wpr * u;
      if (cb * 8 < bn) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double* d = Ab + (r0 + 8 * h) * lds + cb * 8 + 2 * qc;
          d[0] = acc[u][h][0];
          d[1] = acc[u][h][1];
        }
      }
    }
  }
  __syncthreads();
  // S's rows, coalesced (16 bytes a store where nb is even)
  const int rows = min(bm, nb - i0), cols = min(bn, nb - j0);
  if (rows > 0 && cols > 0) store_rows(S + (b * nb + i0) * (long long)nb + j0,
                                       nb, Ab, lds, rows, cols,
                                       vec && nb % 2 == 0);
}

// bytes of shared memory a CTA takes (ops/schur.py `schur_smem` mirrors it)
static long long schur_smem(int bm, int bn, int cs, int kd, int kc,
                            int whole, int nb) {
  const long long kcp = (kc + 15) & ~15, ldw = kcp + 4;
  const long long aw = whole ? ((nb + 7) & ~7) : bn;
  const long long lds = aw + (aw % 16 == 0 ? 8 : 0);
  return 8 * (bm * ldw * (cs > 1 ? 2 : 1) + bn * ldw + bm * lds +
              bm * (kd + 4LL) + kd * ldw) +
         4LL * (bm + bn);
}

HS_EXPORT int hs_lowrank_schur_update(const void* front, const void* RU,
                                      const void* RV, const void* sperm,
                                      void* S, long long B, int m_pad,
                                      int ni_pad, int kc, int bm, int bn,
                                      int cs, int nct, int kd, int whole,
                                      void* stream) {
  const int nb = m_pad - ni_pad;
  if (B <= 0 || nb <= 0) return (int)cudaGetLastError();
  if (kc < 1 || bm < 16 || bm > 64 || bm % 16 || bn < 8 || bn % 8 ||
      bn > 32 * (F_WARPS / (bm / 16)) || cs < 1 || cs > F_MAX_CLUSTER ||
      nct % cs || B > 65535 || (whole && (bn < nb || nct != 1)) ||
      kd < 16 || kd > F_MAX_KD || kd % 16 ||
      (!whole && (long long)nct * bn < nb))
    return (int)cudaErrorInvalidValue;
  const bool vec = m_pad % 2 == 0 && ni_pad % 2 == 0 && kc % 2 == 0 &&
                   ((reinterpret_cast<uintptr_t>(front) |
                     reinterpret_cast<uintptr_t>(RU) |
                     reinterpret_cast<uintptr_t>(RV)) & 15u) == 0;
  const long long smem = schur_smem(bm, bn, cs, kd, kc, whole, nb);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = lowrank_schur_update_kernel;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nct, (unsigned)((nb + bm - 1) / bm),
                     (unsigned)B);
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, (const double*)front,
                           (const double*)RU, (const double*)RV,
                           (const long long*)sperm, (double*)S, m_pad, ni_pad,
                           kc, bm, bn, cs, kd, whole, (int)vec);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The CUDA-core form, for complex128 (the damped Helmholtz system's low-rank
// levels) and float32 (the JAX bench's device configuration: no TF32, so
// the float32 products run on the CUDA cores at full precision): the same
// function on values T, a complex multiply-add four real FMAs, a float32
// one one FMA (summed in float32, as the JAX package's float32 factor sums);
// no tensor-core form (a complex product there would be four real ones over
// the parts held apart in shared memory) yet.
//
// A CTA of 256 threads takes a band of F_C_BM = 32 rows of one front's S:
//   1. W = Abi[p_band, :] RU over depth chunks of kd (Abi's rows and RU's
//      rows staged in shared memory per chunk), for column groups of 64 of
//      W, each thread a 2 x 4 register tile (rows 2 g, 2 g + 1; columns
//      c + 16 j), kept in shared memory;
//   2. then `walk` column tiles of bn columns (tiles x, x + nct, ...): RV's
//      rows p_cols staged, each thread's 2 x 4 entries of S started from
//      Abb[p_i, p_j] (gathered from the front) less W RV^T, stored straight
//      to S (a warp's columns consecutive).
// Rows of W and RV in shared memory have an odd stride (kc | 1 values), so
// a quarter warp's 16-byte reads (a warp's 4-byte ones) fall on distinct
// banks.
// ---------------------------------------------------------------------------
#define F_C_BM 32

__device__ __forceinline__ void cfma_sub(hs_c128& acc, hs_c128 a, hs_c128 b) {
  // acc -= a b
  acc.re = fma(-a.re, b.re, acc.re);
  acc.re = fma(a.im, b.im, acc.re);
  acc.im = fma(-a.re, b.im, acc.im);
  acc.im = fma(-a.im, b.re, acc.im);
}

__device__ __forceinline__ void cfma_add(hs_c128& acc, hs_c128 a, hs_c128 b) {
  // acc += a b
  acc.re = fma(a.re, b.re, acc.re);
  acc.re = fma(-a.im, b.im, acc.re);
  acc.im = fma(a.re, b.im, acc.im);
  acc.im = fma(a.im, b.re, acc.im);
}

__device__ __forceinline__ void cfma_sub(float& acc, float a, float b) {
  acc = fmaf(-a, b, acc);
}

__device__ __forceinline__ void cfma_add(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS, 2)
lowrank_schur_update_cc_kernel(const T* __restrict__ front,
                               const T* __restrict__ RU,
                               const T* __restrict__ RV,
                               const long long* __restrict__ sperm,
                               T* __restrict__ S, int m_pad, int ni_pad,
                               int kc, int bn, int nct, int kd, int walk) {
  extern __shared__ __align__(16) unsigned char fsm_c[];
  const int nb = m_pad - ni_pad;
  const int ld = kc | 1;  // odd: conflict-free reads down a column
  T* Ws = reinterpret_cast<T*>(fsm_c);              // [F_C_BM][ld] W
  T* RVs = Ws + F_C_BM * ld;                        // [bn][ld] RV[p_cols]
  T* Ach = RVs + bn * ld;                           // [F_C_BM][kd] Abi chunk
  T* Uch = Ach + F_C_BM * kd;                       // [kd][kc] RU chunk
  int* pi = reinterpret_cast<int*>(Uch + kd * kc);  // [F_C_BM]
  int* pj = pi + F_C_BM;                            // [bn]

  const int tid = threadIdx.x;
  const int g = tid >> 4, q = tid & 15;  // rows 2 g, 2 g + 1; columns q + 16 j
  const long long b = blockIdx.z;
  const int i0 = blockIdx.y * F_C_BM;
  const long long* p = sperm + b * nb;
  const T* F = front + b * (long long)m_pad * m_pad +
               (long long)ni_pad * m_pad;  // row ni_pad of the front
  const T* RUb = RU + b * (long long)ni_pad * kc;
  const T* RVb = RV + b * (long long)nb * kc;
  const T zero(0.0);

  for (int r = tid; r < F_C_BM; r += F_THREADS)
    pi[r] = i0 + r < nb ? (int)p[i0 + r] : -1;
  __syncthreads();

  // phase 1: W = Abi[p_band, :] RU, 64 of W's columns a pass
  for (int n0 = 0; n0 < kc; n0 += 64) {
    T acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = zero;
    for (int k0 = 0; k0 < ni_pad; k0 += kd) {
      const int nk = min(kd, ni_pad - k0);
      for (int e = tid; e < F_C_BM * kd; e += F_THREADS) {
        const int r = e / kd, kk = e - r * kd;
        Ach[e] = pi[r] >= 0 && kk < nk
                     ? F[(long long)pi[r] * m_pad + k0 + kk]
                     : zero;
      }
      for (int e = tid; e < kd * kc; e += F_THREADS) {
        const int kk = e / kc;
        Uch[e] = kk < nk ? RUb[(long long)k0 * kc + e] : zero;
      }
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        const T a0 = Ach[(2 * g) * kd + kk];
        const T a1 = Ach[(2 * g + 1) * kd + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + q + 16 * j;
          if (c < kc) {
            const T u = Uch[kk * kc + c];
            cfma_add(acc[0][j], a0, u);
            cfma_add(acc[1][j], a1, u);
          }
        }
      }
      __syncthreads();  // the chunk is restaged next
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + q + 16 * j;
      if (c < kc) {
        Ws[(2 * g) * ld + c] = acc[0][j];
        Ws[(2 * g + 1) * ld + c] = acc[1][j];
      }
    }
  }

  // phase 2: S's tiles x, x + nct, ... of this band
  const int tiles = (nb + bn - 1) / bn;
  for (int w = 0; w < walk; ++w) {
    const int t = blockIdx.x + w * nct;
    if (t >= tiles) break;
    const int j0 = t * bn;
    __syncthreads();  // W written; the last tile's RV rows read
    for (int c = tid; c < bn; c += F_THREADS)
      pj[c] = j0 + c < nb ? (int)p[j0 + c] : -1;
    __syncthreads();
    for (int e = tid; e < bn * kc; e += F_THREADS) {
      const int c = e / kc, kk = e - c * kc;
      RVs[c * ld + kk] =
          pj[c] >= 0 ? RVb[(long long)pj[c] * kc + kk] : zero;
    }
    __syncthreads();
    T acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = 2 * g + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = q + 16 * j;
        acc[a][j] = pi[r] >= 0 && c < bn && pj[c] >= 0
                        ? F[(long long)pi[r] * m_pad + ni_pad + pj[c]]
                        : zero;
      }
    }
    for (int kk = 0; kk < kc; ++kk) {
      const T w0 = Ws[(2 * g) * ld + kk];
      const T w1 = Ws[(2 * g + 1) * ld + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = q + 16 * j;
        if (c < bn) {
          const T v = RVs[c * ld + kk];
          cfma_sub(acc[0][j], w0, v);
          cfma_sub(acc[1][j], w1, v);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + 2 * g + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = q + 16 * j;
        if (i < nb && c < bn && j0 + c < nb)
          S[(b * nb + i) * (long long)nb + j0 + c] = acc[a][j];
      }
    }
  }
}

// bytes of shared memory a CTA of the CUDA-core form takes (ops/schur.py
// `schur_smem_cc` mirrors it)
template <typename T>
static long long schur_smem_cc(int bn, int kd, int kc) {
  const long long ld = kc | 1;
  return (long long)sizeof(T) * (F_C_BM * ld + bn * ld +
                                 (long long)F_C_BM * kd + (long long)kd * kc) +
         4LL * (F_C_BM + bn);
}

// the geometry is schur_geometry_cc's: bm = 32, cs = 1, whole = 0; nct
// CTAs a band, each walking ceil(tiles / nct) column tiles of bn
template <typename T>
static int launch_schur_cc(const void* front, const void* RU, const void* RV,
                           const void* sperm, void* S, long long B, int m_pad,
                           int ni_pad, int kc, int bm, int bn, int cs, int nct,
                           int kd, int whole, void* stream) {
  const int nb = m_pad - ni_pad;
  if (B <= 0 || nb <= 0) return (int)cudaGetLastError();
  const int tiles = bn > 0 ? (nb + bn - 1) / bn : 0;
  if (kc < 1 || bm != F_C_BM || bn < 8 || bn > 64 || bn % 8 || cs != 1 ||
      whole || nct < 1 || nct > tiles || kd < 1 || kd > 64 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long smem = schur_smem_cc<T>(bn, kd, kc);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = lowrank_schur_update_cc_kernel<T>;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)nct, (unsigned)((nb + F_C_BM - 1) / F_C_BM),
                  (unsigned)B);
  kern<<<grid, F_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)front, (const T*)RU, (const T*)RV, (const long long*)sperm,
      (T*)S, m_pad, ni_pad, kc, bn, nct, kd, (tiles + nct - 1) / nct);
  return (int)cudaGetLastError();
}

#define HS_SCHUR_ARGS                                                       \
  const void *front, const void *RU, const void *RV, const void *sperm,     \
      void *S, long long B, int m_pad, int ni_pad, int kc, int bm, int bn,  \
      int cs, int nct, int kd, int whole, void *stream
#define HS_SCHUR_PASS \
  front, RU, RV, sperm, S, B, m_pad, ni_pad, kc, bm, bn, cs, nct, kd, whole, stream

HS_EXPORT int hs_lowrank_schur_update_c128(HS_SCHUR_ARGS) {
  return launch_schur_cc<hs_c128>(HS_SCHUR_PASS);
}

HS_EXPORT int hs_lowrank_schur_update_f32(HS_SCHUR_ARGS) {
  return launch_schur_cc<float>(HS_SCHUR_PASS);
}
