// Kernel J: the HSS matrix-vector product y = A x (or A^T x), all levels in
// one launch.
//
// Replaces hsolve/ops/hss.py `hss_matvec` (:207-242), which XLA lowered as
// one batched GEMM pair per level and direction plus the reshapes between
// them (about 4 depth + 3 small ops).  With Vl, Ul, Wu, Rd the column basis,
// row basis, upsweep and downsweep translations (V, U, W, R forward; U, V,
// R, W for the adjoint) and Cl/Cr the sibling couplings (B12/B21; B21^T/B12^T
// for the adjoint):
//
//   upsweep    xi_0[l]   = Vl[l]^T x[l]                        leaves
//              xi_L[j]   = sum_{t=2j,2j+1} Wu_{L-1}[t]^T xi_{L-1}[t]
//   couplings  eta_L[2j]   = Cl_{L+1}[j] xi_L[2j+1]
//              eta_L[2j+1] = Cr_{L+1}[j] xi_L[2j]
//   downsweep  acc_L[t]  = Rd_L[t] acc_{L+1}[t/2] + eta_L[t]
//              (acc = eta at the root's children)
//   leaves     y[l]      = D[l] x[l] + Ul[l] acc_0[l]          (D^T: adjoint)
//
// Tree level L counts from the leaves (0) to the root's children (depth - 1);
// the translation and coupling stacks arrive concatenated over the levels
// (Hss.packed()).
//
// Bound: bytes at k = 1 (every generator read once), operations on the
// FP64 tensor cores at the factor's widths (58-400 columns).
//
// Design (ops/hss.py hss_matvec_geometry picks the launch;
// tools/j_breakdown.py times its alternatives):
// - One matrix's tree is taken by one CTA or by a thread block cluster of cs
//   CTAs (cs <= 8, a power of two): CTA rho owns the subtree of leaves
//   [rho nl/cs, (rho + 1) nl/cs), whose root sits at level Ls = depth -
//   log2(cs), and the nodes of the top levels above whose leftmost leaf it
//   owns.  Each generator is read by the one CTA that owns its node.
// - A CTA walks the columns in chunks of kc (8, 16 or 32); xi and eta/acc
//   of its nodes live in shared memory for the chunk ([r, kc] a node,
//   leading dimension ld = 8 mod 16 doubles so that a fragment load touches
//   every bank twice).  Where a CTA's slots pass 227 KB (ranks 64-192 over
//   8-16 leaves at 32 columns), they live instead in a scratch of the
//   wrapper's, one region a CTA, which stays in L2 and is read through L1:
//   chunks of 8 columns in shared memory read the generators 4x as often
//   and lost 3-6x to the plain version there.  Column groups (gridDim.y)
//   take every groups-th chunk, and come before a wider cluster, whose
//   barriers sit on every chunk's path; each group re-reads the generators,
//   from L2.
// - The top log2(cs) levels run across the cluster: a node's owner reads its
//   sibling's xi, and a right child's owner its parent's acc, from the other
//   CTA's state (distributed shared memory, or the other CTA's scratch
//   region through L2), one cluster barrier per level up and down.
// - Products run on the FP64 tensor cores (mma.sync m16n8k16 .f64): a warp
//   takes one (node, group of RB 8-row output blocks) and all the chunk's
//   8-column blocks, so each B fragment (from the state, or from x) feeds
//   RB / 2 products; its A fragments come straight from global memory
//   (lanes 4g..4g+3 read 4 consecutive doubles of a row, or 8 lanes along a
//   row for a transposed operand: every 32-byte sector a load touches is
//   used whole), KU depth-4 steps loaded while the previous KU multiply.
//   The deepest shape (m16n8k16 against m8n8k4) took the largest launches
//   down by a quarter; the forms differ in the work a warp has in flight:
//   (256 threads, RB 2, KU 8) at rank 32 (four row blocks a node), (512, 2,
//   8) at k <= 8, (256, 4, 4) above.  At k = 1 a chunk is one 8-column block
//   with one live column: the operands' bytes, not the products, set the
//   time there.
// - Complex128 values (hs_hss_matvec_c128, the damped Helmholtz system's
//   levels) and float32 ones (hs_hss_matvec_f32, the JAX bench's device
//   configuration, one FMA a multiply-add, no TF32) take the same tree
//   walk, chunks, cluster and state, with the products on the CUDA cores (jmm_c: a complex multiply-add as four real
//   fused multiply-adds, each lane its fragment's two columns of the same
//   rows, the operands of four depth steps loaded before their products);
//   adjoint stays the plain transpose
//   A^T, as in the JAX package.  The state's slots hold complex values
//   (ld counted in values), and the launch takes (512 threads, RB 2) at
//   k <= 8, else (256, 2).
#include "hs_common.cuh"
#include "hs_complex.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// d += A B on the FP64 tensor cores for two 8-row blocks and a depth of 16
// (m16n8k16), one warp: lane l holds A rows l / 4 (a0[u + j]) and l / 4 + 8
// (a1[u + j]) at columns l % 4 + 4 j, B rows l % 4 + 4 j (b_j) at column
// l / 4, and D's rows l / 4 (d0) and l / 4 + 8 (d1) at columns 2 (l % 4) + i
template <int KU>
__device__ __forceinline__ void jmma(double (&d0)[2], double (&d1)[2],
                                     const double (&a0)[KU],
                                     const double (&a1)[KU], int u, double b0,
                                     double b1, double b2, double b3) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};"
      : "+d"(d0[0]), "+d"(d0[1]), "+d"(d1[0]), "+d"(d1[1])
      : "d"(a0[u]), "d"(a1[u]), "d"(a0[u + 1]), "d"(a1[u + 1]),
        "d"(a0[u + 2]), "d"(a1[u + 2]), "d"(a0[u + 3]), "d"(a1[u + 3]),
        "d"(b0), "d"(b1), "d"(b2), "d"(b3));
}

// acc[q][n] += A[rows of block rg RB + q] B[0:kd, n 8 : n 8 + 8] for this
// warp (RB row blocks of 8 share each B fragment), with A(i, kk) =
// g[kk ld + i] (TRANS) or g[i ld + kk], i < m, kk < kd, and B(kk, c) =
// bs[kk bld + c]; BM: how B is read (J_B_LOCAL: this CTA's state or a
// cluster peer's shared memory; J_B_X: x, read-only, its columns past
// `bcols` read as 0; J_B_PEER: a peer's scratch region, from L2, past this
// SM's L1).  Out-of-range A and B entries are 0.  The A fragments of the
// next KU depth-4 steps load while this KU's multiply.
#define J_B_LOCAL 0
#define J_B_X 1
#define J_B_PEER 2
template <int NB, int RB, int KU, bool TRANS, int BM>
__device__ __forceinline__ void jmm(const double* __restrict__ g, int ld,
                                    int m, int kd, int rg, const double* bs,
                                    int bld, int bcols,
                                    double (&acc)[RB][NB][2], int lane) {
  const int i0 = rg * RB * 8 + (lane >> 2);
  const int kq = lane & 3, bn = lane >> 2;
  auto load_a = [&](double (&a)[RB][KU], int k0) {
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int i = i0 + 8 * q;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int kk = k0 + 4 * u + kq;
        a[q][u] = (i < m && kk < kd)
                      ? __ldg(g + (TRANS ? (int64_t)kk * ld + i
                                         : (int64_t)i * ld + kk))
                      : 0.0;
      }
    }
  };
  double a[RB][KU], an[RB][KU];
  load_a(an, 0);
  for (int k0 = 0; k0 < kd; k0 += 4 * KU) {
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int u = 0; u < KU; ++u) a[q][u] = an[q][u];
    if (k0 + 4 * KU < kd) load_a(an, k0 + 4 * KU);
    // B(kk, c) for this lane, 0 out of range
    auto load_b = [&](int kk, int c) -> double {
      if (kk >= kd || (BM == J_B_X && c >= bcols)) return 0.0;
      return BM == J_B_X      ? __ldg(bs + (int64_t)kk * bld + c)
             : BM == J_B_PEER ? __ldcg(bs + (int64_t)kk * bld + c)
                              : bs[kk * bld + c];
    };
    // pairs of row blocks, fours of depth-4 steps: one m16n8k16 each
#pragma unroll
    for (int u = 0; u < KU; u += 4) {
      const int kk = k0 + 4 * u + kq;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int c = n * 8 + bn;
        const double b0 = load_b(kk, c), b1 = load_b(kk + 4, c);
        const double b2 = load_b(kk + 8, c), b3 = load_b(kk + 12, c);
#pragma unroll
        for (int q = 0; q < RB; q += 2)
          jmma(acc[q][n], acc[q + 1][n], a[q], a[q + 1], u, b0, b1, b2, b3);
      }
    }
  }
}

// The complex form of jmm, on the CUDA cores, with jmm's operands and
// output layout: lane l holds rows rg RB 8 + 8 q + l / 4 at columns n 8 +
// 2 (l % 4) + {0, 1}; in place of KU's prefetch, the A and B entries of
// four depth steps load before their products.
template <int BM>
__device__ __forceinline__ hs_c128 jload_b(const hs_c128* p) {
  if (BM == J_B_X) return hs_ldg(p);
  if (BM == J_B_PEER) {
    const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
    return hs_c128(v.x, v.y);
  }
  return *p;
}

template <int BM>
__device__ __forceinline__ float jload_b(const float* p) {
  if (BM == J_B_X) return __ldg(p);
  if (BM == J_B_PEER) return __ldcg(p);
  return *p;
}

// VT: complex128, or float32 (one FMA a multiply-add, summed in float32;
// no TF32)
template <int NB, int RB, bool TRANS, int BM, typename VT>
__device__ __forceinline__ void jmm_c(const VT* __restrict__ g, int ld,
                                      int m, int kd, int rg, const VT* bs,
                                      int bld, int bcols,
                                      VT (&acc)[RB][NB][2], int lane) {
  constexpr int KS = 4;  // depth steps whose operands load together
  const int i0 = rg * RB * 8 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  for (int k0 = 0; k0 < kd; k0 += KS) {
    VT av[KS][RB], bv[KS][NB][2];
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const int kk = k0 + u;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = n * 8 + cb + t;
          bv[u][n][t] = kk >= kd || (BM == J_B_X && c >= bcols)
                            ? VT(0.0)
                            : jload_b<BM>(bs + (int64_t)kk * bld + c);
        }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = i0 + 8 * q;
        av[u][q] = i < m && kk < kd
                       ? hs_ldg(g + (TRANS ? (int64_t)kk * ld + i
                                           : (int64_t)i * ld + kk))
                       : VT(0.0);
      }
    }
#pragma unroll
    for (int u = 0; u < KS; ++u)
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int t = 0; t < 2; ++t) acc[q][n][t] += av[u][q] * bv[u][n][t];
  }
}

// jmm in the value type: the FP64 tensor cores for double, jmm_c for
// complex128 and float32
template <int NB, int RB, int KU, bool TRANS, int BM>
__device__ __forceinline__ void jmm_v(const double* __restrict__ g, int ld,
                                      int m, int kd, int rg, const double* bs,
                                      int bld, int bcols,
                                      double (&acc)[RB][NB][2], int lane) {
  jmm<NB, RB, KU, TRANS, BM>(g, ld, m, kd, rg, bs, bld, bcols, acc, lane);
}

template <int NB, int RB, int KU, bool TRANS, int BM>
__device__ __forceinline__ void jmm_v(const hs_c128* __restrict__ g, int ld,
                                      int m, int kd, int rg, const hs_c128* bs,
                                      int bld, int bcols,
                                      hs_c128 (&acc)[RB][NB][2], int lane) {
  jmm_c<NB, RB, TRANS, BM>(g, ld, m, kd, rg, bs, bld, bcols, acc, lane);
}

template <int NB, int RB, int KU, bool TRANS, int BM>
__device__ __forceinline__ void jmm_v(const float* __restrict__ g, int ld,
                                      int m, int kd, int rg, const float* bs,
                                      int bld, int bcols,
                                      float (&acc)[RB][NB][2], int lane) {
  jmm_c<NB, RB, TRANS, BM>(g, ld, m, kd, rg, bs, bld, bcols, acc, lane);
}

template <int NB, int RB, typename VT>
__device__ __forceinline__ void jzero(VT (&acc)[RB][NB][2]) {
#pragma unroll
  for (int q = 0; q < RB; ++q)
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[q][n][0] = acc[q][n][1] = VT(0.0);
}

// acc <- s[rows of block group rg] (an [m, ld] node slot)
template <int NB, int RB, typename VT>
__device__ __forceinline__ void jload(VT (&acc)[RB][NB][2], const VT* s,
                                      int ld, int m, int rg, int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = (rg * RB + q) * 8 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      acc[q][n][0] = i < m ? s[i * ld + n * 8 + c] : VT(0.0);
      acc[q][n][1] = i < m ? s[i * ld + n * 8 + c + 1] : VT(0.0);
    }
  }
}

template <int NB, int RB, typename VT>
__device__ __forceinline__ void jstore(const VT (&acc)[RB][NB][2], VT* s,
                                       int ld, int m, int rg, int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = (rg * RB + q) * 8 + (lane >> 2);
    if (i >= m) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      s[i * ld + n * 8 + c] = acc[q][n][0];
      s[i * ld + n * 8 + c + 1] = acc[q][n][1];
    }
  }
}

// The cluster geometry of one CTA: owned nodes and their shared-memory slots.
struct JTree {
  int nl, depth, c, nlc, Ls, sub, rho;
  // the owner of node (L, j) and the node's slot in the owner's state
  __device__ __forceinline__ int owner(int L, int j) const {
    return L <= Ls ? j / (nlc >> L) : j << (L - Ls);
  }
  __device__ __forceinline__ int slot(int L, int j) const {
    if (L > Ls) return sub + (L - Ls - 1);
    int off = 0;
    for (int q = 0; q < L; ++q) off += nlc >> q;
    return off + j - owner(L, j) * (nlc >> L);
  }
};

// NB 8-column blocks a chunk, TH threads a CTA, RB 8-row blocks a warp's
// item, KU depth-4 steps of A fragments loaded ahead; VT the value type
template <typename VT, int NB, int TH, int RB, int KU>
__global__ void __launch_bounds__(TH, 1) hss_matvec_kernel(
    const VT* __restrict__ D, const VT* __restrict__ U,
    const VT* __restrict__ V, const VT* __restrict__ Rc,
    const VT* __restrict__ Wc, const VT* __restrict__ B12c,
    const VT* __restrict__ B21c, const VT* __restrict__ x,
    VT* __restrict__ y, VT* state, int nl, int ls, int r, int depth,
    int k, int cs, int ld, int nown, int adjoint) {
  extern __shared__ __align__(16) unsigned char j_smem[];
  constexpr int J_WARPS = TH / 32;
  const int kc = NB * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  JTree T;
  T.nl = nl;
  T.depth = depth;
  T.c = 31 - __clz(cs);
  T.nlc = nl >> T.c;
  T.Ls = depth - T.c;
  T.rho = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  {
    const int top = T.Ls < depth - 1 ? T.Ls : depth - 1;
    int sub = 0;
    for (int L = 0; L <= top; ++L) sub += T.nlc >> L;
    T.sub = sub;
  }
  const int rho = T.rho;
  const int64_t b = blockIdx.x / cs;
  const int npad = nl * ls;
  const int64_t rr = (int64_t)r * r;
  const int64_t slot_sz = (int64_t)r * ld;
  // a CTA's state: shared memory, or its region of the scratch (peers of a
  // cluster are neighbours in blockIdx.x, so a peer's region is an offset)
  const int64_t region = 2 * nown * slot_sz;
  VT* XI = state == nullptr
               ? reinterpret_cast<VT*>(j_smem)
               : state + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) *
                             region;
  VT* ETA = XI + nown * slot_sz;
  const VT* Db = D + b * (int64_t)nl * ls * ls;
  const VT* Vl = (adjoint ? U : V) + b * (int64_t)npad * r;
  const VT* Ul = (adjoint ? V : U) + b * (int64_t)npad * r;
  const VT* Wu = (adjoint ? Rc : Wc) + b * (int64_t)(2 * nl - 2) * rr;
  const VT* Rd = (adjoint ? Wc : Rc) + b * (int64_t)(2 * nl - 2) * rr;
  const VT* Cl = (adjoint ? B21c : B12c) + b * (int64_t)(nl - 1) * rr;
  const VT* Cr = (adjoint ? B12c : B21c) + b * (int64_t)(nl - 1) * rr;
  const VT* xb = x + b * (int64_t)npad * k;
  VT* yb = y + b * (int64_t)npad * k;
  // row groups (RB blocks of 8) of an r-row and an ls-row output
  const int rbr = (r + 8 * RB - 1) / (8 * RB);
  const int rbl = (ls + 8 * RB - 1) / (8 * RB);
  const int nchunks = (k + kc - 1) / kc;
  // node offset of child level L in the packed translations; coupling
  // offset (internal level L + 1) of child level L
#define J_OFF(L) (2 * nl - 2 * (nl >> (L)))
#define J_BOFF(L) (nl - 2 * (nl >> ((L) + 1)))
  // acc += G xs (G^T xs: trans) for an r x r generator G and a node's state
  // xs, in this CTA's state or a cluster peer's shared memory, or (far) in
  // a peer's scratch region
  auto gen = [&](const VT* G, bool trans, const VT* xs, bool far, int rg,
                 VT (&acc)[RB][NB][2]) {
    if (far) {
      if (trans)
        jmm_v<NB, RB, KU, true, J_B_PEER>(G, r, r, r, rg, xs, ld, kc, acc,
                                          lane);
      else
        jmm_v<NB, RB, KU, false, J_B_PEER>(G, r, r, r, rg, xs, ld, kc, acc,
                                           lane);
    } else if (trans) {
      jmm_v<NB, RB, KU, true, J_B_LOCAL>(G, r, r, r, rg, xs, ld, kc, acc,
                                         lane);
    } else {
      jmm_v<NB, RB, KU, false, J_B_LOCAL>(G, r, r, r, rg, xs, ld, kc, acc,
                                          lane);
    }
  };
  // the coupling that makes eta of child t of level L from its sibling's xi
  auto coupling = [&](int L, int t) {
    return ((t & 1) ? Cr : Cl) + (J_BOFF(L) + (t >> 1)) * rr;
  };
  // slot p of this CTA in CTA o of the cluster, and whether it lies in L2
  const bool far = state != nullptr;
  auto peer = [&](VT* p, int o) -> const VT* {
    if (far) return p + (int64_t)(o - rho) * region;
    return cg::this_cluster().map_shared_rank(p, o);
  };
  auto xi = [&](int L, int j) { return XI + T.slot(L, j) * slot_sz; };
  auto eta = [&](int L, int j) { return ETA + T.slot(L, j) * slot_sz; };

  for (int ch = blockIdx.y; ch < nchunks; ch += gridDim.y) {
    const int c0 = ch * kc;
    // 1. leaves: xi_0[l] = Vl[l]^T x[l]
    for (int e = warp; e < T.nlc * rbr; e += J_WARPS) {
      const int l = rho * T.nlc + e / rbr, rg = e % rbr;
      VT acc[RB][NB][2];
      jzero(acc);
      jmm_v<NB, RB, KU, true, J_B_X>(Vl + (int64_t)l * ls * r, r, r, ls, rg,
                                     xb + (int64_t)l * ls * k + c0, k, k - c0,
                                     acc, lane);
      jstore(acc, xi(0, l), ld, r, rg, lane);
    }
    __syncthreads();
    // 2. the subtree's upsweep: xi_L of its nodes, eta_{L-1} of their
    // children (with one CTA a matrix, up to the root's children)
    for (int L = 1; L <= T.Ls; ++L) {
      const int nodes = L <= depth - 1 ? T.nlc >> L : 0;
      const int kids = T.nlc >> (L - 1);
      for (int e = warp; e < (nodes + kids) * rbr; e += J_WARPS) {
        const int q = e / rbr, rg = e % rbr;
        VT acc[RB][NB][2];
        jzero(acc);
        if (q < nodes) {
          const int j = rho * nodes + q;
          for (int t = 2 * j; t < 2 * j + 2; ++t)
            gen(Wu + (J_OFF(L - 1) + t) * rr, true, xi(L - 1, t), false, rg,
                acc);
          jstore(acc, xi(L, j), ld, r, rg, lane);
        } else {
          const int t = rho * kids + q - nodes;
          gen(coupling(L - 1, t), adjoint, xi(L - 1, t ^ 1), false, rg, acc);
          jstore(acc, eta(L - 1, t), ld, r, rg, lane);
        }
      }
      __syncthreads();
    }
    if (cs > 1) {
      cg::cluster_group cl = cg::this_cluster();
      // 3. the top levels' upsweep across the cluster
      for (int L = T.Ls; L < depth; ++L) {
        cl.sync();  // xi_L of every owner is complete
        const int span = 1 << (L - T.Ls);
        if (rho % span) continue;
        const int t = rho / span, s = t ^ 1;
        const VT* xs = peer(xi(L, s), T.owner(L, s));
        const bool up = !(t & 1) && L + 1 < depth;
        for (int e = warp; e < (up ? 2 : 1) * rbr; e += J_WARPS) {
          const int rg = e % rbr;
          VT acc[RB][NB][2];
          jzero(acc);
          if (e < rbr) {
            gen(coupling(L, t), adjoint, xs, far, rg, acc);
            jstore(acc, eta(L, t), ld, r, rg, lane);
          } else {
            gen(Wu + (J_OFF(L) + t) * rr, true, xi(L, t), false, rg, acc);
            gen(Wu + (J_OFF(L) + s) * rr, true, xs, far, rg, acc);
            jstore(acc, xi(L + 1, t >> 1), ld, r, rg, lane);
          }
        }
      }
      cl.sync();  // every eta is complete
      // 4. the top levels' downsweep: acc_L[t] = eta_L[t] + Rd acc_{L+1}
      for (int L = depth - 2; L >= T.Ls; --L) {
        const int span = 1 << (L - T.Ls);
        if (rho % span == 0) {
          const int t = rho / span, p = t >> 1;
          const VT* ap = peer(eta(L + 1, p), T.owner(L + 1, p));
          for (int rg = warp; rg < rbr; rg += J_WARPS) {
            VT acc[RB][NB][2];
            jload(acc, eta(L, t), ld, r, rg, lane);
            gen(Rd + (J_OFF(L) + t) * rr, false, ap, far, rg, acc);
            jstore(acc, eta(L, t), ld, r, rg, lane);
          }
        }
        cl.sync();  // acc_L is complete; no CTA reads another's state after
                    // the last of these
      }
    }
    // 5. the subtree's downsweep
    for (int L = (T.Ls < depth - 1 ? T.Ls : depth - 1) - 1; L >= 0; --L) {
      const int nodes = T.nlc >> L;
      for (int e = warp; e < nodes * rbr; e += J_WARPS) {
        const int t = rho * nodes + e / rbr, rg = e % rbr;
        VT acc[RB][NB][2];
        jload(acc, eta(L, t), ld, r, rg, lane);
        gen(Rd + (J_OFF(L) + t) * rr, false, eta(L + 1, t >> 1), false, rg,
            acc);
        jstore(acc, eta(L, t), ld, r, rg, lane);
      }
      __syncthreads();
    }
    // 6. leaves: y[l] = D[l] x[l] + Ul[l] acc_0[l]
    for (int e = warp; e < T.nlc * rbl; e += J_WARPS) {
      const int l = rho * T.nlc + e / rbl, rg = e % rbl;
      VT acc[RB][NB][2];
      jzero(acc);
      const VT* xl = xb + (int64_t)l * ls * k + c0;
      const VT* dl = Db + (int64_t)l * ls * ls;
      if (adjoint)
        jmm_v<NB, RB, KU, true, J_B_X>(dl, ls, ls, ls, rg, xl, k, k - c0, acc,
                                       lane);
      else
        jmm_v<NB, RB, KU, false, J_B_X>(dl, ls, ls, ls, rg, xl, k, k - c0,
                                        acc, lane);
      jmm_v<NB, RB, KU, false, J_B_LOCAL>(Ul + (int64_t)l * ls * r, r, ls, r,
                                          rg, eta(0, l), ld, kc, acc, lane);
      const int c = 2 * (lane & 3);
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = (rg * RB + q) * 8 + (lane >> 2);
        if (i >= ls) continue;
        VT* yr = yb + ((int64_t)l * ls + i) * k + c0;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (c0 + n * 8 + c < k) yr[n * 8 + c] = acc[q][n][0];
          if (c0 + n * 8 + c + 1 < k) yr[n * 8 + c + 1] = acc[q][n][1];
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the state
  }
#undef J_OFF
#undef J_BOFF
}

template <typename VT, int NB, int TH, int RB, int KU>
static cudaError_t launch_matvec(const void* D, const void* U, const void* V,
                                 const void* Rc, const void* Wc,
                                 const void* B12c, const void* B21c,
                                 const void* x, void* y, void* state,
                                 long long B, int nl, int ls, int r, int depth,
                                 int k, int cs, int groups, int ld, int nown,
                                 size_t smem, int adjoint,
                                 cudaStream_t stream) {
  static size_t granted = 0;
  auto kern = hss_matvec_kernel<VT, NB, TH, RB, KU>;
  if (smem > 48 * 1024 && smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs), (unsigned)groups);
  cfg.blockDim = dim3(TH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, (const VT*)D, (const VT*)U, (const VT*)V, (const VT*)Rc,
      (const VT*)Wc, (const VT*)B12c, (const VT*)B21c, (const VT*)x, (VT*)y,
      (VT*)state, nl, ls, r, depth, k, cs, ld, nown, adjoint);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

static bool j_valid(long long B, int nleaves, int depth, int kc, int cs,
                    int groups, int ld, int nown, long long smem,
                    const void* state) {
  return !(B < 0 || depth < 1 || nleaves != (1 << depth) || cs < 1 || cs > 8 ||
           (cs & (cs - 1)) || cs > nleaves ||
           (kc != 8 && kc != 16 && kc != 32) || groups < 1 || ld < kc ||
           nown < 1 || smem < 0 || (state == nullptr) != (smem > 0));
}

// kc columns a chunk (8, 16 or 32), threads a CTA (256 or 512) and rb
// 8-row blocks a warp's item (2 or 4), cs CTAs a matrix (a power of two,
// at most
// 8 and nleaves), groups column groups, ld the state's leading dimension,
// nown the node slots of a CTA and smem its bytes (all from ops/hss.py
// hss_matvec_geometry); state: null (the state in shared memory) or the
// scratch of B cs groups regions of 2 nown r ld values (smem 0)
HS_EXPORT int hs_hss_matvec(const void* D, const void* U, const void* V,
                            const void* Rc, const void* Wc, const void* B12c,
                            const void* B21c, const void* x, void* y,
                            void* state, long long B, int nleaves, int ls,
                            int r, int depth, int k, int kc, int threads,
                            int rb, int cs,
                            int groups, int ld, int nown, long long smem,
                            int adjoint, void* stream) {
  if (!j_valid(B, nleaves, depth, kc, cs, groups, ld, nown, smem, state) ||
      !((threads == 512 && rb == 2) ||
        (threads == 256 && (rb == 2 || rb == 4))))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || k == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define J_LAUNCH(NB, TH, RB, KU)                                              \
  launch_matvec<double, NB, TH, RB, KU>(D, U, V, Rc, Wc, B12c, B21c, x, y,    \
                                        state, B, nleaves, ls, r, depth, k,   \
                                        cs, groups, ld, nown, (size_t)smem,   \
                                        adjoint, s)
  // (threads, rb): (256, 2) at r <= 32, else (512, 2) for k <= 8 and
  // (256, 4) above; a warp loads the A fragments of 8 (rb 4: 4) depth-4
  // steps ahead
#define J_MODES(NB)                                              \
  (threads == 512 ? J_LAUNCH(NB, 512, 2, 8)                      \
   : rb == 2      ? J_LAUNCH(NB, 256, 2, 8)                      \
                  : J_LAUNCH(NB, 256, 4, 4))
  const cudaError_t err = kc == 8    ? J_MODES(1)
                          : kc == 16 ? J_MODES(2)
                                     : J_MODES(4);
#undef J_MODES
#undef J_LAUNCH
  return (int)err;
}

// the CUDA-core form (complex128, float32): (threads, rb) is (512, 2) at
// kc 8, else (256, 2)
template <typename VT>
static int matvec_cc(const void* D, const void* U, const void* V,
                     const void* Rc, const void* Wc, const void* B12c,
                     const void* B21c, const void* x, void* y, void* state,
                     long long B, int nleaves, int ls, int r, int depth, int k,
                     int kc, int threads, int rb, int cs, int groups, int ld,
                     int nown, long long smem, int adjoint, void* stream) {
  if (!j_valid(B, nleaves, depth, kc, cs, groups, ld, nown, smem, state) ||
      rb != 2 || threads != (kc == 8 ? 512 : 256))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || k == 0) return (int)cudaSuccess;
#define J_LAUNCH(NB, TH)                                                      \
  launch_matvec<VT, NB, TH, 2, 8>(D, U, V, Rc, Wc, B12c, B21c, x, y, state,   \
                                  B, nleaves, ls, r, depth, k, cs, groups,    \
                                  ld, nown, (size_t)smem, adjoint,            \
                                  (cudaStream_t)stream)
  const cudaError_t err = kc == 8    ? J_LAUNCH(1, 512)
                          : kc == 16 ? J_LAUNCH(2, 256)
                                     : J_LAUNCH(4, 256);
#undef J_LAUNCH
  return (int)err;
}

#define HS_MATVEC_ARGS                                                       \
  const void *D, const void *U, const void *V, const void *Rc,               \
      const void *Wc, const void *B12c, const void *B21c, const void *x,     \
      void *y, void *state, long long B, int nleaves, int ls, int r,         \
      int depth, int k, int kc, int threads, int rb, int cs, int groups,     \
      int ld, int nown, long long smem, int adjoint, void *stream
#define HS_MATVEC_PASS                                                       \
  D, U, V, Rc, Wc, B12c, B21c, x, y, state, B, nleaves, ls, r, depth, k, kc, \
      threads, rb, cs, groups, ld, nown, smem, adjoint, stream

HS_EXPORT int hs_hss_matvec_c128(HS_MATVEC_ARGS) {
  return matvec_cc<hs_c128>(HS_MATVEC_PASS);
}

HS_EXPORT int hs_hss_matvec_f32(HS_MATVEC_ARGS) {
  return matvec_cc<float>(HS_MATVEC_PASS);
}
