// Kernel K: one level of the telescoping Woodbury correction of an HSS solve.
//
// Replaces hsolve/ops/hss.py `_apply_level_correction` after its upsweep
// (:641-658): a concatenation, two batched coupling products, a pivoted LU
// solve (a gather and two triangular solves) and a batched GEMM-subtract,
// per level of every hss_solve.  Per node j of the level, with the children's
// upsweep xi [2m, r, k], the stored LU (lu, perm) of the 2r x 2r core and the
// correction basis Phi [n_pad, r]:
//
//   eta = [op(Bl[j]) xi[2j+1]; op(Br[j]) xi[2j]]      op = transpose if set
//   w   = U^{-1} L^{-1} eta[perm]                      (lu_solve)
//   Y[rows of child 2j + s] -= Phi[those rows] w[s r : (s + 1) r]   s = 0, 1
//
// in place on Y [B, n_pad, k].  The forward solve passes (B12, B21, M), the
// adjoint (B21, B12, N) with transpose set.
//
// Bound: latency, then the bytes of the node's operands.  It runs in every
// hss_solve (k = 1: three or four times per structured level per
// preconditioner application in GMRES) and in hss_factor (k = the level's
// basis width, up to 400 at the default rank caps).  At the default caps the
// core is up to 384 x 384 (1.2 MB), more than a CTA's shared memory, and the
// triangular solves are a chain of 2 * ceil(2r / 32) dependent 32-row steps.
// So the operands stream through shared memory in tiles, shared memory holds
// only a ring of tiles and the right-hand sides, and the pivoted solve stays
// the reference's lu_solve (no explicit inverse): a 32 x 32 diagonal block
// is solved one lane per row, each solved value broadcast by a shuffle.
//
// Two kernels:
//
// - k = 1 (hss_level_correct_vec_kernel): one CTA per node.  cp.async fills
//   a ring of three LU tiles of 32 rows by up to 64 columns, in the order the
//   blocked substitution consumes them (per 32-row panel its off-diagonal
//   tiles, then its diagonal block; the lower triangle top-down, then the
//   upper one bottom-up), so the loads of the next two overlap the work on
//   the current one; a tile's 32 rows take their dot products with the
//   solved values on 8 lanes per row, folded by shuffles; eta and the
//   correction are 8-lane dot products from device memory.
//
// - k > 1 (hss_level_correct_block_kernel): one thread block cluster of cs
//   CTAs per node (up to 16) takes all k columns, nc <= 32 per CTA, so the
//   node's operands are read once per launch: every tile of Bl, Br, the LU
//   and Phi is one TMA box (cp.async.bulk.tensor, 64 rows by 32 columns,
//   from a tensor map per operand) that the cluster's first CTA multicasts
//   into the same stage of every CTA, whose full mbarrier counts the bytes.
//   A producer warp per CTA runs up to `ns` tiles ahead; eight consumer
//   warps release a stage by arriving on the first CTA's `empty` mbarrier
//   (and on their own CTA's, which re-arms its full barrier).  The products
//   are right-looking, so each warp keeps a 32-column chunk of the right
//   operand in registers across the chunk's tiles and takes 8 rows of each:
//   eta per chunk of 32 columns of op(C); the LU per 32-row panel (its
//   diagonal block solved, then the panel's columns applied to the rows
//   below it, or above it in the upper triangle); Phi x per chunk.  The
//   products run on the FP64 tensor cores (mma.sync m8n8k4 .f64).  The
//   right-hand sides stay in shared memory in eta's order (z[i] = eta[perm[i]]
//   lives in row perm[i]), so eta is stored without a scatter; xi's two
//   children sit in rows [r, 2r) and [2r, 3r) until eta overwrites the
//   first of them after op(Bl)'s products have read it.  Where 16 CTAs of nc
//   columns do not cover k (ranks far above the default caps), `groups`
//   clusters per node split the columns, each reading the operands once.
//
// Complex128 (hs_hss_level_correct_c128, the damped Helmholtz system's
// levels), float32 (hs_hss_level_correct_f32, the JAX bench's device
// configuration) and complex64 (hs_hss_level_correct_c64, its complex
// one): one kernel for every k on the CUDA cores (a complex multiply-add as
// four real fused multiply-adds), op still the plain transpose, as in the
// JAX package.  Float32 operands are widened as they are read and the
// kernel computes in float64, complex64 ones in complex128, rounding the
// correction once (F4's rule): a float32 solve with the 2r x 2r cores' LU
// (2r up to 384 at the n=512 default caps) lands cond(core) float32
// epsilons off, and two float32 solves that sum in other orders part by
// more than 1e-5 of Y.  A CTA takes one node and nc of its columns: the
// children's upsweep xi [2r, nc] and the right-hand sides w [2r, nc] stay
// resident in shared memory, w in the solve's order (w[i] =
// eta[perm[i]]); eta, the blocked substitution and the correction are dot
// products of G lanes an item (G = 32 down to 1 as the items of a step fill
// the CTA; four partial sums a lane, folded by shuffles), their left
// operand's rows (op(Bl), op(Br), the LU, Phi) read from device memory, a
// warp's lanes on one row; the substitution is left-looking (each 32-row
// panel takes the solved rows before it, below it in the upper triangle),
// the 32 x 32 diagonal blocks staged in shared memory and solved one lane
// per row, a warp per column.
#include <cooperative_groups.h>
#include <cuda.h>

#include "hs_common.cuh"
#include "hs_complex.cuh"

namespace cg = cooperative_groups;

#define K_THREADS 256
#define K_FULL 0xffffffffu
#define K_PANEL 32
#define K_CW 64            // columns of a tile

// ---------------------------------------------------------------------------
// k = 1
// ---------------------------------------------------------------------------
#define K_LDT (K_CW + 2)   // a ring tile's padded row stride (16-byte rows)
#define K_STAGES 3

struct KTile {
  int row0, col0, ncols, kind;  // kind 0: off-diagonal, 1: L diagonal, 2: U
};

// the LU tiles in the order of consumption (see the note at the top)
__host__ __device__ inline int k_tiles(int r2, KTile* out) {
  const int np = (r2 + K_PANEL - 1) / K_PANEL;
  int n = 0;
  for (int p = 0; p < np; ++p) {
    const int p0 = p * K_PANEL;
    for (int c = 0; c < p0; c += K_CW) {
      if (out) out[n] = {p0, c, p0 - c < K_CW ? p0 - c : K_CW, 0};
      ++n;
    }
    if (out) out[n] = {p0, p0, r2 - p0 < K_PANEL ? r2 - p0 : K_PANEL, 1};
    ++n;
  }
  for (int p = np - 1; p >= 0; --p) {
    const int p0 = p * K_PANEL;
    for (int c = p0 + K_PANEL; c < r2; c += K_CW) {
      if (out) out[n] = {p0, c, r2 - c < K_CW ? r2 - c : K_CW, 0};
      ++n;
    }
    if (out) out[n] = {p0, p0, r2 - p0 < K_PANEL ? r2 - p0 : K_PANEL, 2};
    ++n;
  }
  return n;
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Issue tile t's copy into stage `st` (rows past r2 skipped; a partial
// diagonal block padded to 32 x 32 with the identity).
__device__ __forceinline__ void issue_tile(const KTile& t,
                                           const double* __restrict__ lub,
                                           int r2, double* st, int tid) {
  const int nr = r2 - t.row0 < K_PANEL ? r2 - t.row0 : K_PANEL;
  const int ch = t.ncols / 2;  // 16-byte chunks per row
  for (int e = tid; e < nr * ch; e += K_THREADS) {
    const int i = e / ch, c = e - i * ch;
    cp_async16(st + i * K_LDT + 2 * c,
               lub + (int64_t)(t.row0 + i) * r2 + t.col0 + 2 * c);
  }
  if (t.kind != 0 && (nr < K_PANEL || t.ncols < K_PANEL)) {
    for (int e = tid; e < K_PANEL * K_PANEL; e += K_THREADS) {
      const int i = e / K_PANEL, j = e - i * K_PANEL;
      if (i >= nr || j >= t.ncols) st[i * K_LDT + j] = i == j ? 1.0 : 0.0;
    }
  }
}

__global__ void __launch_bounds__(K_THREADS) hss_level_correct_vec_kernel(
    double* Y, const double* __restrict__ xi, const double* __restrict__ Bl,
    const double* __restrict__ Br, const double* __restrict__ lu,
    const long long* __restrict__ perm, const double* __restrict__ Phi, int m,
    int r, int blk, int ntiles, int transpose) {
  extern __shared__ __align__(16) double smem[];
  const int r2 = 2 * r;
  const int64_t bj = blockIdx.x;  // b * m + j
  const int64_t b = bj / m;
  const int j = (int)(bj - b * m);
  double* ring = smem;                                  // [STAGES][32][LDT]
  double* w = ring + K_STAGES * K_PANEL * K_LDT;        // [2r]
  KTile* tiles = reinterpret_cast<KTile*>(w + r2);      // [ntiles]
  int* pv = reinterpret_cast<int*>(tiles + ntiles);     // [2r] perm
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = tid >> 3, g = tid & 7;  // 32 rows x 8 lanes
  const double* lub = lu + bj * (int64_t)r2 * r2;

  if (tid == 0) k_tiles(r2, tiles);
  for (int e = tid; e < r2; e += K_THREADS) pv[e] = (int)perm[bj * r2 + e];
  __syncthreads();
  for (int s = 0; s < K_STAGES - 1; ++s) {
    if (s < ntiles) issue_tile(tiles[s], lub, r2, ring + s * K_PANEL * K_LDT, tid);
    cp_async_commit();
  }

  // w[i] = eta[perm[i]], eta[s r + a] = op(C_s)[a] . xi[2j + 1 - s]; the
  // 8-lane groups fold with shuffles (warp-uniform trip count)
  const int64_t rr = (int64_t)r * r;
  const double* xb = xi + (b * 2 * m + 2 * j) * (int64_t)r;
  for (int it0 = warp * 4; it0 < r2; it0 += K_THREADS / 8) {
    const int i = it0 + (lane >> 3);
    const bool ok = i < r2;
    const int src = pv[ok ? i : 0];
    const int s = src >= r, a = src - s * r;
    const double* cp = (s ? Br : Bl) + bj * rr;
    const double* xp = xb + (int64_t)(1 - s) * r;
    double acc = 0.0;
    if (ok && !transpose) {
      for (int t = g; t < r; t += 8) acc += cp[(int64_t)a * r + t] * xp[t];
    } else if (ok) {
      for (int t = g; t < r; t += 8) acc += cp[(int64_t)t * r + a] * xp[t];
    }
    for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(K_FULL, acc, off);
    if (ok && g == 0) w[i] = acc;
  }
  __syncthreads();

  // the blocked substitution over the streamed tiles
  double part = 0.0;  // this lane's share of row gr
  for (int ti = 0; ti < ntiles; ++ti) {
    const int nx = ti + K_STAGES - 1;
    if (nx < ntiles)
      issue_tile(tiles[nx], lub, r2, ring + (nx % K_STAGES) * K_PANEL * K_LDT, tid);
    cp_async_commit();
    cp_async_wait<K_STAGES - 1>();
    __syncthreads();
    const KTile t = tiles[ti];
    const double* T = ring + (ti % K_STAGES) * K_PANEL * K_LDT;
    const int row = t.row0 + gr;
    if (t.kind == 0) {
      // the panel's rows take the solved values of the tile's columns
      if (row < r2) {
        const double* Tr = T + gr * K_LDT;
        const double* wc = w + t.col0;
        for (int q = g; q < t.ncols; q += 8) part += Tr[q] * wc[q];
      }
    } else {
      // fold the partial sums into the panel's rows of w
      for (int off = 4; off > 0; off >>= 1)
        part += __shfl_xor_sync(K_FULL, part, off);
      if (g == 0 && row < r2) w[row] -= part;
      part = 0.0;
      __syncthreads();
      // the 32 x 32 diagonal block (identity-padded), by warp 0
      if (warp == 0) {
        const int lr = t.row0 + lane;
        double x = lr < r2 ? w[lr] : 0.0;
        if (t.kind == 1) {
#pragma unroll
          for (int i = 0; i < K_PANEL; ++i) {
            const double xv = __shfl_sync(K_FULL, x, i);
            if (lane > i) x -= T[lane * K_LDT + i] * xv;
          }
        } else {
          const double rd = 1.0 / T[lane * K_LDT + lane];
#pragma unroll
          for (int i = K_PANEL - 1; i >= 0; --i) {
            if (lane == i) x *= rd;
            const double xv = __shfl_sync(K_FULL, x, i);
            if (lane < i) x -= T[lane * K_LDT + i] * xv;
          }
        }
        if (lr < r2) w[lr] = x;
      }
    }
    __syncthreads();  // the stage is free, w's new rows are visible
  }

  // Y[child rows] -= Phi[child rows] w[child part]
  const int64_t npad = (int64_t)2 * m * blk;
  const int64_t row0 = (int64_t)2 * j * blk;
  double* Yb = Y + b * npad;
  for (int it0 = warp * 4; it0 < 2 * blk; it0 += K_THREADS / 8) {
    const int i = it0 + (lane >> 3);
    const bool ok = i < 2 * blk;
    const int s = i >= blk;
    const double* pp = Phi + (b * npad + row0 + (ok ? i : 0)) * r;
    const double* wp = w + (int64_t)s * r;
    double a = 0.0;
    if (ok)
      for (int t = g; t < r; t += 8) a += pp[t] * wp[t];
    for (int off = 4; off > 0; off >>= 1) a += __shfl_xor_sync(K_FULL, a, off);
    if (ok && g == 0) Yb[row0 + i] -= a;
  }
}

// ---------------------------------------------------------------------------
// k > 1
// ---------------------------------------------------------------------------
#define KB_CONSUMERS 256                 // eight consumer warps
#define KB_THREADS (KB_CONSUMERS + 32)   // and one producer warp
#define KB_ROWS 64    // rows of a tile: 8 warps x 8
#define KB_LD 32      // row stride of a tile's 32 columns (the TMA box)
#define KB_LDT 64     // row stride of a transposed eta tile's 64 columns
#define KB_STAGE (KB_ROWS * KB_LD)  // doubles per stage: one 16 KB box
#define KB_BOX_BYTES (KB_STAGE * 8)
#define KB_MAX_NC 32  // right-hand sides per CTA: 4 column blocks of 8
#define KB_MAX_CLUSTER 16
#define KB_DG_LD 33   // row stride of the diagonal block's copy

enum { KB_ETA = 0, KB_ETA_T, KB_LDIAG, KB_UDIAG, KB_LCOL, KB_UCOL, KB_PHI };

struct KbTile {
  int kind, s, row0, col0, nrows, ncols, first, load_b, assign;
};

// The tiles of one node in the order of consumption, each at most 64 rows
// of a product's left operand by a chunk of 32 of its columns (the depth):
// eta's rows of op(Bl) (s = 0) then of op(Br) (s = 1), per chunk of 32
// columns its 64-row tiles; the LU right-looking, per 32-row panel p (the
// lower triangle top-down, then the upper one bottom-up) its diagonal block,
// then the tiles of the panel's 32 columns below it (lower) or above it
// (upper); Phi's rows of child 0 then child 1, per chunk of 32 columns.
// `load_b` marks a chunk's first tile (the consumers load the chunk's right
// operand into registers), `assign` eta's first chunk (stored, not added),
// `first` the tile before which the consumers synchronise (eta of op(Br),
// which overwrites xi[2j + 1]: op(Bl)'s chunks must have read it).
struct KbIter {
  int r, r2, blk, transpose, ph, a, b, c;

  __device__ void init(int r_, int blk_, int transpose_) {
    r = r_;
    r2 = 2 * r_;
    blk = blk_;
    transpose = transpose_;
    ph = a = b = c = 0;
  }

  __device__ KbTile next() {
    KbTile t;
    t.first = t.load_b = t.assign = t.s = 0;
    if (ph == 0) {  // eta: side a, column chunk b, row tile c
      t.kind = transpose ? KB_ETA_T : KB_ETA;
      t.s = a;
      t.row0 = c;
      t.col0 = b;
      t.nrows = min(KB_ROWS, r - c);
      t.ncols = min(K_PANEL, r - b);
      t.load_b = c == 0;
      t.assign = b == 0;
      t.first = a == 1 && b == 0 && c == 0;
      c += KB_ROWS;
      if (c >= r) {
        c = 0;
        b += K_PANEL;
        if (b >= r) {
          b = 0;
          if (++a == 2) {
            ph = 1;
            a = 0;
            b = -1;
          }
        }
      }
    } else if (ph == 1 || ph == 2) {  // LU: panel a, row b (-1: diagonal)
      const bool lower = ph == 1;
      const int nr = min(K_PANEL, r2 - a);
      if (b < 0) {
        t.kind = lower ? KB_LDIAG : KB_UDIAG;
        t.row0 = t.col0 = a;
        t.nrows = t.ncols = nr;
        b = lower ? a + K_PANEL : 0;
      } else {
        const int end = lower ? r2 : a;
        t.kind = lower ? KB_LCOL : KB_UCOL;
        t.row0 = b;
        t.col0 = a;
        t.nrows = min(KB_ROWS, end - b);
        t.ncols = nr;
        t.load_b = b == (lower ? a + K_PANEL : 0);
        b += KB_ROWS;
      }
      if (b >= (lower ? r2 : a)) {
        if (lower) {
          a += K_PANEL;
          b = -1;
          if (a >= r2) {
            ph = 2;
            a = (r2 - 1) / K_PANEL * K_PANEL;
          }
        } else {
          a -= K_PANEL;
          b = -1;
          if (a < 0) {
            ph = 3;
            a = b = c = 0;
          }
        }
      }
    } else {  // Phi: child a, column chunk b, row tile c
      t.kind = KB_PHI;
      t.s = a;
      t.row0 = c;
      t.col0 = b;
      t.nrows = min(KB_ROWS, blk - c);
      t.ncols = min(K_PANEL, r - b);
      t.load_b = c == 0;
      c += KB_ROWS;
      if (c >= blk) {
        c = 0;
        b += K_PANEL;
        if (b >= r) {
          b = 0;
          ++a;
        }
      }
    }
    return t;
  }
};

static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

static int kb_ntiles(int r, int blk) {
  const int r2 = 2 * r;
  int n = 2 * cdiv(r, K_PANEL) * (cdiv(r, KB_ROWS) + cdiv(blk, KB_ROWS));
  for (int p0 = 0; p0 < r2; p0 += K_PANEL) {
    const int below = r2 - p0 - K_PANEL;
    n += 2 + cdiv(below > 0 ? below : 0, KB_ROWS) + cdiv(p0, KB_ROWS);
  }
  return n;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival on the barrier at `bar`'s offset in CTA `cta` of the cluster
// (release at CTA scope: a cluster-scope release costs thousands of cycles
// per tile, and the stage's reads it orders are this CTA's own)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int cta) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

// the box of `tmap` at (c0 inner, c1 outer) into dst's offset in every CTA
// of the cluster (cs > 1) or into this CTA, completing on the barrier at
// bar's offset in each
__device__ __forceinline__ void tma_load(double* dst, const CUtensorMap* tmap,
                                         int c0, int c1, uint64_t* bar,
                                         int cs) {
  if (cs > 1) {
    const unsigned short mask = (unsigned short)((1u << cs) - 1u);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
            smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1),
        "r"(smem_addr(bar)), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1),
        "r"(smem_addr(bar))
        : "memory");
  }
}

// a consumer warp is done with a stage: one arrival on the leader's empty
// barrier (it issues the next copy into every CTA) and, in the other CTAs, on
// their own (their producer arms the stage's full barrier again)
__device__ __forceinline__ void release(uint64_t* bar, int lane, int rank) {
  __syncwarp();
  if (lane == 0) mbar_arrive_cluster(bar, 0);
  if (lane == 1 && rank != 0) mbar_arrive_cluster(bar, rank);
}

// a barrier of the eight consumer warps (the producer warp runs ahead)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(KB_CONSUMERS) : "memory");
}

// d += A B on the FP64 tensor cores, one warp, for an 8 x 8 output tile and
// a depth of 4: lane l holds A[l / 4][l % 4], B[l % 4][l / 4], and
// D[l / 4][2 (l % 4) + i] in d[i] (the m8n8k4 .f64 fragments)
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// acc[u] += A B_u for this warp's 8 x 32 row block of a tile and CT of the
// chunk's 8-column blocks (af, bf: the fragments; past the chunk's columns
// both are 0); CT is a template argument so that no branch (and no
// reconvergence point) sits between two products
template <int CT>
__device__ __forceinline__ void tile_mma(double (&acc)[4][2],
                                         const double (&af)[8],
                                         const double (&bf)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int u = 0; u < CT; ++u) dmma(acc[u], af[ks], bf[ks][u]);
  }
}

// The 32 x 32 diagonal block's solve for NV of a warp's columns at once:
// lane = row, Trow its row of the (identity-padded) block, rd the inverse of
// its diagonal entry; each solved value is broadcast by a shuffle, with
// selects in place of branches between the shuffles
template <int NV>
__device__ __forceinline__ void diag_solve(double (&x)[4],
                                           const double (&Trow)[K_PANEL],
                                           double rd, int lane, bool lower) {
  if (lower) {
#pragma unroll
    for (int i = 0; i < K_PANEL; ++i) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const double xv = __shfl_sync(K_FULL, x[v], i);
        x[v] = lane > i ? x[v] - Trow[i] * xv : x[v];
      }
    }
  } else {
#pragma unroll
    for (int i = K_PANEL - 1; i >= 0; --i) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        x[v] = lane == i ? x[v] * rd : x[v];
        const double xv = __shfl_sync(K_FULL, x[v], i);
        x[v] = lane < i ? x[v] - Trow[i] * xv : x[v];
      }
    }
  }
}

__global__ void __launch_bounds__(KB_THREADS) hss_level_correct_block_kernel(
    double* Y, const double* __restrict__ xi,
    const __grid_constant__ CUtensorMap tm_l,
    const __grid_constant__ CUtensorMap tm_r,
    const __grid_constant__ CUtensorMap tm_lu,
    const __grid_constant__ CUtensorMap tm_phi,
    const long long* __restrict__ perm, int m, int r, int blk, int k, int nc,
    int groups, int ns, int ntiles, int transpose) {
  extern __shared__ __align__(128) double smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t cid = blockIdx.x / cs;  // the cluster: (node, column group)
  const int64_t bj = cid / groups;      // b * m + j
  const int grp = (int)(cid - bj * groups);
  const int64_t b = bj / m;
  const int j = (int)(bj - b * m);
  const int c0 = (grp * cs + rank) * nc;  // this CTA's first column
  const int ncl = max(0, min(nc, k - c0));
  const int r2 = 2 * r, ldw = nc + 4;     // 4 mod 8: conflict-free B loads
  double* ring = smem;                                  // [ns][KB_STAGE]
  double* w = ring + (size_t)ns * KB_STAGE;             // [3r][ldw]
  uint64_t* full = reinterpret_cast<uint64_t*>(w + (size_t)3 * r * ldw);
  uint64_t* empty = full + ns;
  double* dg = reinterpret_cast<double*>(empty + ns);   // [32][KB_DG_LD]
  int* pv = reinterpret_cast<int*>(dg + K_PANEL * KB_DG_LD);  // [2r] perm
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, 1);
      // the leader's counts every consumer warp of the cluster (it issues
      // every copy), the others' their own eight
      mbar_init(empty + s, (KB_CONSUMERS / 32) * (rank == 0 ? cs : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = tid; e < r2; e += KB_THREADS) pv[e] = (int)perm[bj * r2 + e];
  // rows [0, r): eta of op(Bl), zero until then; [r, 2r): xi[2j + 1];
  // [2r, 3r): xi[2j]; columns past ncl zero
  const double* xb = xi + (b * 2 * m + 2 * j) * (int64_t)r * k + c0;
  for (int e = tid; e < 3 * r * ldw; e += KB_THREADS) {
    const int row = e / ldw, c = e - row * ldw;
    double v = 0.0;
    if (row >= r && c < ncl) {
      const int child = row < r2 ? 1 : 0, t = row - (row < r2 ? r : r2);
      v = xb[((int64_t)child * r + t) * k + c];
    }
    w[e] = v;
  }
  cl.sync();  // every CTA's barriers are set before any copy lands

  if (warp == KB_CONSUMERS / 32) {
    // the producer: tile t into stage t % ns once the stage's previous
    // tile is released (the leader: by every consumer warp of the cluster;
    // the others: by their own), each CTA arming its own full barrier for
    // the box's bytes; the leader issues one box per tile, multicast
    const int64_t nrow = bj * (int64_t)r2;   // this node's first LU row
    const int64_t crow = bj * (int64_t)r;    // of Bl and Br
    const int64_t prow = (b * 2 * m + 2 * j) * (int64_t)blk;  // of Phi
    KbIter it;
    it.init(r, blk, transpose);
    for (int t = 0; t < ntiles; ++t) {
      const KbTile d = it.next();
      const int s = t % ns;
      if (lane == 0) {
        if (t >= ns) mbar_wait(empty + s, (t / ns - 1) & 1);
        mbar_expect_tx(full + s, KB_BOX_BYTES);
        if (rank == 0) {
          double* st = ring + (size_t)s * KB_STAGE;
          if (d.kind == KB_ETA)
            tma_load(st, d.s ? &tm_r : &tm_l, d.col0, (int)(crow + d.row0),
                     full + s, cs);
          else if (d.kind == KB_ETA_T)  // op(C)[a][t] = C[t][a]: rows t
            tma_load(st, d.s ? &tm_r : &tm_l, d.row0, (int)(crow + d.col0),
                     full + s, cs);
          else if (d.kind == KB_PHI)
            tma_load(st, &tm_phi, d.col0,
                     (int)(prow + (int64_t)d.s * blk + d.row0), full + s, cs);
          else
            tma_load(st, &tm_lu, d.col0, (int)(nrow + d.row0), full + s, cs);
        }
      }
      __syncwarp();
    }
  } else {
    // the consumers: warp w takes rows [8 w, 8 w + 8) of every tile and all
    // of this CTA's 8-column blocks; a chunk's right operand (32 rows of
    // this CTA's columns) stays in registers across the chunk's tiles, so a
    // tile costs each warp 8 fragment loads for up to 32 products
    const int qr = lane >> 2, qc = lane & 3;  // an mma fragment's row, column
    const int ct = (ncl + 7) / 8;
    const int tr = warp * 8 + qr;  // this lane's row of a tile
    double bf[8][4];               // the chunk's right operand fragments
    double* Yn = Y + ((b * 2 * m + 2 * j) * (int64_t)blk) * k + c0;
    KbIter it;
    it.init(r, blk, transpose);
    for (int t = 0; t < ntiles; ++t) {
      const KbTile d = it.next();
      const int s = t % ns;
      if (d.first) consumers_sync();
      if (d.load_b) {
        // B's rows: eta reads xi (rows [r, 2r) for op(Bl), [2r, 3r) for
        // op(Br)), the LU's tiles z and Phi's tiles x, both in eta's order
        const bool direct = d.kind <= KB_ETA_T;
        const int base = direct ? (d.s ? r2 : r) + d.col0
                                : (d.kind == KB_PHI ? d.s * r : 0) + d.col0;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int q = 4 * ks + qc;
          const bool qok = q < d.ncols;
          const int brow = qok ? (direct ? base + q : pv[base + q]) : 0;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            bf[ks][u] = qok && u < ct ? w[brow * ldw + u * 8 + qr] : 0.0;
        }
      }
      mbar_wait(full + s, (t / ns) & 1);
      const double* T = ring + (size_t)s * KB_STAGE;
      if (d.kind == KB_LDIAG || d.kind == KB_UDIAG) {
        // the diagonal block copied to dg (stride 33: a lane per row reads it
        // without bank conflicts, identity-padded to 32 x 32); then the
        // block's solve: lane = row, warp w takes columns w, w + 8, w + 16,
        // w + 24, all at once
        const int nr = d.nrows;
        for (int e = tid; e < K_PANEL * K_PANEL; e += KB_CONSUMERS) {
          const int i = e >> 5, jj = e & 31;
          dg[i * KB_DG_LD + jj] =
              i < nr && jj < nr ? T[i * KB_LD + jj] : (i == jj ? 1.0 : 0.0);
        }
        release(empty + s, lane, rank);
        consumers_sync();
        const bool rok = lane < nr;
        const int prow = rok ? pv[d.row0 + lane] : 0;
        const int nv = ncl > warp ? (ncl - warp + 7) / 8 : 0;  // warp-uniform
        if (nv > 0) {
          double Trow[K_PANEL];
#pragma unroll
          for (int i = 0; i < K_PANEL; ++i) Trow[i] = dg[lane * KB_DG_LD + i];
          const double rd = 1.0 / dg[lane * KB_DG_LD + lane];
          double x[4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            x[v] = rok && v < nv ? w[prow * ldw + warp + 8 * v] : 0.0;
          const bool lower = d.kind == KB_LDIAG;
          switch (nv) {
            case 1: diag_solve<1>(x, Trow, rd, lane, lower); break;
            case 2: diag_solve<2>(x, Trow, rd, lane, lower); break;
            case 3: diag_solve<3>(x, Trow, rd, lane, lower); break;
            default: diag_solve<4>(x, Trow, rd, lane, lower); break;
          }
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (rok && v < nv) w[prow * ldw + warp + 8 * v] = x[v];
        }
        consumers_sync();
      } else {
        // this warp's 8 rows of the tile times the chunk's right operand
        const bool trans = d.kind == KB_ETA_T;
        double af[8];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int q = 4 * ks + qc;
          af[ks] = tr < d.nrows && q < d.ncols
                       ? (trans ? T[q * KB_LDT + tr] : T[tr * KB_LD + q])
                       : 0.0;
        }
        release(empty + s, lane, rank);
        if (warp * 8 < d.nrows) {  // warp-uniform
          double acc[4][2] = {};
          switch (ct) {  // warp-uniform: no branch around an mma
            case 1: tile_mma<1>(acc, af, bf); break;
            case 2: tile_mma<2>(acc, af, bf); break;
            case 3: tile_mma<3>(acc, af, bf); break;
            case 4: tile_mma<4>(acc, af, bf); break;
            default: break;
          }
          // eta's rows into w (eta's order), the LU's updates out of z's
          // rows, Phi x out of this CTA's columns of Y: every old value is
          // loaded before the first store (one load latency, not eight)
          double* dst[4][2];
          double old[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int c = u * 8 + 2 * qc + i;
              dst[u][i] = nullptr;
              if (u < ct && tr < d.nrows && c < ncl)
                dst[u][i] =
                    d.kind == KB_ETA || d.kind == KB_ETA_T
                        ? w + (d.s * r + d.row0 + tr) * ldw + c
                    : d.kind == KB_PHI
                        ? Yn + ((int64_t)d.s * blk + d.row0 + tr) * k + c
                        : w + pv[d.row0 + tr] * ldw + c;
              old[u][i] = dst[u][i] != nullptr && !d.assign ? *dst[u][i] : 0.0;
            }
          }
          const double sg = d.kind == KB_ETA || d.kind == KB_ETA_T ? 1.0 : -1.0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (dst[u][i] != nullptr) *dst[u][i] = old[u][i] + sg * acc[u][i];
          }
        }
      }
    }
  }
  cl.sync();  // no CTA leaves while others may still arrive on its barriers
}

// ---------------------------------------------------------------------------
// The CUDA-core form, every k: complex128 (the damped Helmholtz system's
// levels, a complex multiply-add four real FMAs), float32 and complex64
// (the JAX bench's device configurations: computed in float64 and
// complex128 on their operands, no TF32)
// ---------------------------------------------------------------------------
#define KC_LDD (K_PANEL + 1)   // the diagonal block's row stride

// sink(it, sum) for items it < nitems of sum_{t < len} term(it, t), G lanes
// an item (G a power of two, at most 32), folded by shuffles; every thread of
// the CTA takes part (a uniform trip count)
template <typename VT, typename Term, typename Sink>
__device__ __forceinline__ void kc_dots(int nitems, int len, int G, Term term,
                                        Sink sink) {
  const int tid = threadIdx.x, g = tid & (G - 1), per = K_THREADS / G;
  for (int base = 0; base < nitems; base += per) {
    const int it = base + tid / G;
    const bool ok = it < nitems;
    // four partial sums: independent chains of multiply-adds and loads
    VT a0(0.0), a1(0.0), a2(0.0), a3(0.0);
    if (ok) {
      int t = g;
      for (; t + 3 * G < len; t += 4 * G) {
        a0 += term(it, t);
        a1 += term(it, t + G);
        a2 += term(it, t + 2 * G);
        a3 += term(it, t + 3 * G);
      }
      for (; t < len; t += G) a0 += term(it, t);
    }
    VT acc = (a0 + a1) + (a2 + a3);
    for (int off = G >> 1; off > 0; off >>= 1) acc += hs_shfl_xor(acc, off);
    if (ok && g == 0) sink(it, acc);
  }
}

// lanes an item: the most (up to 32, at most len) that keep nitems items
// within one pass of the CTA
__device__ __forceinline__ int kc_lanes(int nitems, int len) {
  int G = 1;
  while (G < 32 && 2 * G <= len && 2 * G * nitems <= K_THREADS) G *= 2;
  return G;
}

// TI the operands' type; VT the type the kernel computes in (hs_acc_t<TI>:
// double for float32 operands and complex128 for complex64 ones, widened as
// they are read, F4's rule; the
// correction rounded once as it is subtracted from Y)
template <typename TI, typename VT = hs_acc_t<TI>>
__global__ void __launch_bounds__(K_THREADS) hss_level_correct_cc_kernel(
    TI* Y, const TI* __restrict__ xi, const TI* __restrict__ Bl,
    const TI* __restrict__ Br, const TI* __restrict__ lu,
    const long long* __restrict__ perm, const TI* __restrict__ Phi, int m,
    int r, int blk, int k, int nc, int groups, int transpose) {
  extern __shared__ __align__(16) unsigned char kc_smem[];
  const int r2 = 2 * r;
  const int64_t bj = blockIdx.x / groups;  // b * m + j
  const int c0 = (int)(blockIdx.x - bj * groups) * nc;
  const int ncl = min(nc, k - c0);         // this CTA's columns
  const int64_t b = bj / m;
  const int j = (int)(bj - b * m);
  VT* w = reinterpret_cast<VT*>(kc_smem);                   // [2r][nc]
  VT* xs = w + (size_t)r2 * nc;                             // [2r][nc]
  VT* dg = xs + (size_t)r2 * nc;                            // [32][KC_LDD]
  int* pv = reinterpret_cast<int*>(dg + K_PANEL * KC_LDD);  // [2r]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TI* lub = lu + bj * (int64_t)r2 * r2;
  const int64_t rr = (int64_t)r * r;
  for (int e = tid; e < r2; e += K_THREADS) pv[e] = (int)perm[bj * r2 + e];
  // xs[child r + t][c] = xi[2j + child][t][c0 + c]
  const TI* xb = xi + (b * 2 * m + 2 * j) * (int64_t)r * k + c0;
  for (int e = tid; e < r2 * ncl; e += K_THREADS) {
    const int row = e / ncl, c = e - row * ncl;
    xs[row * nc + c] = hs_wide(hs_ldg(xb + (int64_t)row * k + c));
  }
  __syncthreads();

  // w[i][c] = eta[perm[i]][c], eta[s r + a] = op(C_s)[a] . xi[2j + 1 - s]
  const int ne = r2 * ncl;
  kc_dots<VT>(
      ne, r, kc_lanes(ne, r),
      [&](int it, int t) {
        const int src = pv[it / ncl], c = it % ncl;
        const int s = src >= r, a = src - s * r;
        const TI* cp = (s ? Br : Bl) + bj * rr;
        const VT cv = hs_wide(hs_ldg(cp + (transpose ? (int64_t)t * r + a
                                                     : (int64_t)a * r + t)));
        return cv * xs[((1 - s) * r + t) * nc + c];
      },
      [&](int it, VT v) { w[(it / ncl) * nc + it % ncl] = v; });
  __syncthreads();

  // stage the diagonal block at p0 (nr rows), identity-padded to 32 x 32
  auto stage = [&](int p0, int nr) {
    for (int e = tid; e < K_PANEL * K_PANEL; e += K_THREADS) {
      const int i = e / K_PANEL, t = e - i * K_PANEL;
      dg[i * KC_LDD + t] = i < nr && t < nr
                               ? hs_wide(hs_ldg(lub + (int64_t)(p0 + i) * r2 +
                                                p0 + t))
                               : VT(i == t ? 1.0 : 0.0);
    }
  };
  const int np = (r2 + K_PANEL - 1) / K_PANEL;
  // L (unit lower), panel by panel, top-down
  for (int pp = 0; pp < np; ++pp) {
    const int p0 = pp * K_PANEL, nr = min(K_PANEL, r2 - p0);
    const int ni = nr * ncl;
    if (p0 > 0)
      kc_dots<VT>(
          ni, p0, kc_lanes(ni, p0),
          [&](int it, int t) {
            return hs_wide(hs_ldg(lub + (int64_t)(p0 + it / ncl) * r2 + t)) *
                   w[t * nc + it % ncl];
          },
          [&](int it, VT v) { w[(p0 + it / ncl) * nc + it % ncl] -= v; });
    stage(p0, nr);
    __syncthreads();
    for (int c = warp; c < ncl; c += K_THREADS / 32) {
      VT x = lane < nr ? w[(p0 + lane) * nc + c] : VT(0.0);
      for (int i = 0; i < K_PANEL; ++i) {
        const VT xv = hs_shfl(x, i);
        if (lane > i) x -= dg[lane * KC_LDD + i] * xv;
      }
      if (lane < nr) w[(p0 + lane) * nc + c] = x;
    }
    __syncthreads();
  }
  // U, panel by panel, bottom-up
  for (int pp = np - 1; pp >= 0; --pp) {
    const int p0 = pp * K_PANEL, nr = min(K_PANEL, r2 - p0);
    const int q0 = p0 + nr, ni = nr * ncl;
    if (q0 < r2)
      kc_dots<VT>(
          ni, r2 - q0, kc_lanes(ni, r2 - q0),
          [&](int it, int t) {
            return hs_wide(hs_ldg(lub + (int64_t)(p0 + it / ncl) * r2 + q0 +
                                  t)) *
                   w[(q0 + t) * nc + it % ncl];
          },
          [&](int it, VT v) { w[(p0 + it / ncl) * nc + it % ncl] -= v; });
    stage(p0, nr);
    __syncthreads();
    for (int c = warp; c < ncl; c += K_THREADS / 32) {
      VT x = lane < nr ? w[(p0 + lane) * nc + c] : VT(0.0);
      const VT rd = hs_inv(dg[lane * KC_LDD + lane]);
      for (int i = K_PANEL - 1; i >= 0; --i) {
        if (lane == i) x = x * rd;
        const VT xv = hs_shfl(x, i);
        if (lane < i) x -= dg[lane * KC_LDD + i] * xv;
      }
      if (lane < nr) w[(p0 + lane) * nc + c] = x;
    }
    __syncthreads();
  }

  // Y[child rows] -= Phi[child rows] w[child part]
  const int64_t npad = (int64_t)2 * m * blk;
  const int64_t row0 = b * npad + (int64_t)2 * j * blk;
  const int ny = 2 * blk * ncl;
  kc_dots<VT>(
      ny, r, kc_lanes(ny, r),
      [&](int it, int t) {
        const int i = it / ncl;
        return hs_wide(hs_ldg(Phi + (row0 + i) * r + t)) *
               w[((i >= blk) * r + t) * nc + it % ncl];
      },
      [&](int it, VT v) {
        TI* y = Y + (row0 + it / ncl) * k + c0 + it % ncl;
        *y = static_cast<TI>(hs_wide(*y) - v);
      });
}

// xi and w in the type the kernel computes in
template <typename TI>
static size_t k_smem_cc(int r, int nc) {
  return (size_t)(4 * r * nc + K_PANEL * KC_LDD) * sizeof(hs_acc_t<TI>) +
         (size_t)2 * r * sizeof(int);
}

// nc columns a CTA (ops/hss.py level_correct_geometry_cc); cs and ns are
// not read
template <typename TI>
static int level_correct_cc(void* Y, const void* xi, const void* Bl,
                            const void* Br, const void* lu, const void* perm,
                            const void* Phi, long long B, int m, int r,
                            int blk, int k, int nc, int transpose,
                            void* stream) {
  if (B <= 0 || m <= 0 || r <= 0 || k <= 0) return (int)cudaGetLastError();
  if (nc < 1) return (int)cudaErrorInvalidValue;
  const int groups = (k + nc - 1) / nc;
  const size_t smem = k_smem_cc<TI>(r, nc);
  auto kern = hss_level_correct_cc_kernel<TI>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)(B * m * groups), K_THREADS, smem, (cudaStream_t)stream>>>(
      (TI*)Y, (const TI*)xi, (const TI*)Bl, (const TI*)Br, (const TI*)lu,
      (const long long*)perm, (const TI*)Phi, m, r, blk, k, nc, groups,
      transpose);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_hss_level_correct_c128(void* Y, const void* xi,
                                        const void* Bl, const void* Br,
                                        const void* lu, const void* perm,
                                        const void* Phi, long long B, int m,
                                        int r, int blk, int k, int nc, int cs,
                                        int ns, int transpose, void* stream) {
  (void)cs;
  (void)ns;
  return level_correct_cc<hs_c128>(Y, xi, Bl, Br, lu, perm, Phi, B, m, r, blk,
                                   k, nc, transpose, stream);
}

HS_EXPORT int hs_hss_level_correct_c64(void* Y, const void* xi,
                                       const void* Bl, const void* Br,
                                       const void* lu, const void* perm,
                                       const void* Phi, long long B, int m,
                                       int r, int blk, int k, int nc, int cs,
                                       int ns, int transpose, void* stream) {
  (void)cs;
  (void)ns;
  return level_correct_cc<hs_c64>(Y, xi, Bl, Br, lu, perm, Phi, B, m, r, blk,
                                  k, nc, transpose, stream);
}

HS_EXPORT int hs_hss_level_correct_f32(void* Y, const void* xi,
                                       const void* Bl, const void* Br,
                                       const void* lu, const void* perm,
                                       const void* Phi, long long B, int m,
                                       int r, int blk, int k, int nc, int cs,
                                       int ns, int transpose, void* stream) {
  (void)cs;
  (void)ns;
  return level_correct_cc<float>(Y, xi, Bl, Br, lu, perm, Phi, B, m, r, blk, k,
                                 nc, transpose, stream);
}

// dynamic shared memory of the k = 1 kernel
static size_t k_smem_vec(int r) {
  return (size_t)(K_STAGES * K_PANEL * K_LDT + 2 * r) * sizeof(double) +
         (size_t)k_tiles(2 * r, nullptr) * sizeof(KTile) +
         (size_t)2 * r * sizeof(int);
}

// dynamic shared memory of the k > 1 kernel (the wrapper sizes nc and ns
// with the same sum)
static size_t k_smem_block(int r, int nc, int ns) {
  return (size_t)(ns * KB_STAGE + 3 * r * (nc + 4) + K_PANEL * KB_DG_LD) *
             sizeof(double) +
         (size_t)2 * ns * sizeof(uint64_t) + (size_t)2 * r * sizeof(int);
}

typedef CUresult (*KEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 2-D tensor map of `rows` rows of `cols` doubles (row-major) whose box is
// `box_in` columns by `box_out` rows, read zero past the last column and row
// (the driver's encoder, found through the runtime: no link to libcuda).
static bool k_map(CUtensorMap* map, const void* base, uint64_t cols,
                  uint64_t rows, unsigned box_in, unsigned box_out) {
  static KEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || fn == nullptr)
      return false;
    encode = (KEncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols * 8};
  const cuuint32_t box[2] = {box_in, box_out}, elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
static cudaError_t k_allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// k = 1: one CTA per node; k > 1: clusters of cs CTAs of nc columns, `groups`
// of them per node, ns ring stages
HS_EXPORT int hs_hss_level_correct(void* Y, const void* xi, const void* Bl,
                                   const void* Br, const void* lu,
                                   const void* perm, const void* Phi,
                                   long long B, int m, int r, int blk, int k,
                                   int nc, int cs, int ns, int transpose,
                                   void* stream) {
  if (B <= 0 || m <= 0 || r <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (k == 1) {
    const size_t smem = k_smem_vec(r);
    if ((err = k_allow_smem(hss_level_correct_vec_kernel, smem)) != cudaSuccess)
      return (int)err;
    hss_level_correct_vec_kernel<<<(unsigned)(B * m), K_THREADS, smem,
                                   (cudaStream_t)stream>>>(
        (double*)Y, (const double*)xi, (const double*)Bl, (const double*)Br,
        (const double*)lu, (const long long*)perm, (const double*)Phi, m, r,
        blk, k_tiles(2 * r, nullptr), transpose);
    return (int)cudaGetLastError();
  }
  // the tensor maps' row strides are 16-byte multiples: r even
  if (r % 2 || nc < 4 || nc > KB_MAX_NC || nc % 4 || cs < 1 ||
      cs > KB_MAX_CLUSTER || ns < 2)
    return (int)cudaErrorInvalidValue;
  const int groups = (k + cs * nc - 1) / (cs * nc);
  const int r2 = 2 * r;
  const uint64_t nodes = (uint64_t)B * m, npad = (uint64_t)2 * m * blk;
  CUtensorMap tm_l, tm_r, tm_lu, tm_phi;
  const unsigned ci = transpose ? KB_LDT : KB_LD, co = transpose ? 32 : KB_ROWS;
  if (!k_map(&tm_l, Bl, r, nodes * r, ci, co) ||
      !k_map(&tm_r, Br, r, nodes * r, ci, co) ||
      !k_map(&tm_lu, lu, r2, nodes * r2, KB_LD, KB_ROWS) ||
      !k_map(&tm_phi, Phi, r, (uint64_t)B * npad, KB_LD, KB_ROWS))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k_smem_block(r, nc, ns);
  auto kern = hss_level_correct_block_kernel;
  if ((err = k_allow_smem(kern, smem)) != cudaSuccess) return (int)err;
  if (cs > 8 && (err = cudaFuncSetAttribute(
                     kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
                    cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * m * groups * cs));
  cfg.blockDim = dim3(KB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (double*)Y, (const double*)xi, tm_l,
                           tm_r, tm_lu, tm_phi, (const long long*)perm, m, r,
                           blk, k, nc, groups, ns, kb_ntiles(r, blk),
                           transpose);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// the most clusters of cs CTAs with the k > 1 kernel's shared memory that the
// card holds at once (0: such a cluster cannot be scheduled)
HS_EXPORT int hs_hss_level_correct_clusters(int r, int nc, int cs, int ns) {
  auto kern = hss_level_correct_block_kernel;
  const size_t smem = k_smem_block(r, nc, ns);
  if (k_allow_smem(kern, smem) != cudaSuccess) return -1;
  if (cs > 8 && cudaFuncSetAttribute(
                    kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
                    cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(KB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}
