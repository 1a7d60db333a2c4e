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
// Every value type takes the same two kernels, templated on the operands'
// type TI and the type they compute in, VT = hs_acc_t<TI>: float64 and
// complex128 in their own type; float32 (the JAX bench's device
// configuration) in float64 and complex64 (its complex one) in complex128,
// the operands read in their own width and widened as the products read
// them, the correction rounded once as it is subtracted from Y (F4's rule:
// a 32-bit solve with the 2r x 2r cores' LU, 2r up to 384 at the n=512
// default caps, lands cond(core) epsilons off, and two such solves that sum
// in other orders part by more than 1e-5 of Y).  op stays the plain
// transpose for complex values, as in the JAX package.
//
// - k = 1 (hss_level_correct_vec_kernel): one CTA per node.  cp.async fills
//   a ring of three LU tiles of 32 rows by up to 64 columns of TI values, in
//   the order the blocked substitution consumes them (per 32-row panel its
//   off-diagonal tiles, then its diagonal block; the lower triangle
//   top-down, then the upper one bottom-up), so the loads of the next two
//   overlap the work on the current one; a tile's 32 rows take their dot
//   products with the solved values on 8 lanes per row, folded by shuffles
//   (a complex multiply-add four real fused ones); eta and the correction
//   are 8-lane dot products from device memory.  The same kernel takes one
//   CTA per (node, column) of a k > 1 launch whose right-hand sides do not
//   fit the k > 1 kernel's shared memory (complex128 ranks above 568).
//
// - k > 1 (hss_level_correct_block_kernel): one thread block cluster of cs
//   CTAs per node (up to 16) takes all k columns, nc <= 32 per CTA (16 for
//   complex values), so the node's operands are read once per launch: every
//   tile of Bl, Br, the LU and Phi is one TMA box (cp.async.bulk.tensor, 64
//   rows by 32 columns of TI values, from a tensor map per operand; TMA has
//   no complex type: complex64 travels as float64, complex128 as float64
//   pairs) that the cluster's first CTA multicasts into the same stage of
//   every CTA, whose full mbarrier counts the bytes.  An operand whose rows
//   are not 16-byte multiples (a float32 rank not a multiple of 4, an odd
//   float64 or complex64 rank) or whose base is not 16-byte aligned cannot
//   be a tensor map: the producer warp copies its tiles with cp.async
//   instead (zero past the array, as TMA reads), the copies arriving on the
//   stage's full barrier as they land, and the launch takes no cluster (a
//   CTA's own copies would let it release a stage ahead of its peers, and
//   the leader's empty barrier counts the cluster's releases by phase).
//   A producer warp per CTA runs up to `ns` tiles ahead;
//   eight consumer warps release a stage by arriving on the first CTA's
//   `empty` mbarrier (and on their own CTA's, which re-arms its full
//   barrier).  The products are right-looking, so each warp keeps a 32-row
//   chunk of the right operand in registers across the chunk's tiles and
//   takes 8 rows of each: eta per chunk of 32 columns of op(C); the LU per
//   32-row panel (its diagonal block solved, then the panel's columns
//   applied to the rows below it, or above it in the upper triangle); Phi x
//   per chunk.  The products run on the FP64 tensor cores (mma.sync m8n8k4
//   .f64), the consumers widening the tile's values as they build the
//   fragments; a complex product is four real ones on fragments whose real
//   and imaginary parts are split as they are loaded (the real part summed
//   in two accumulators, re re and im im, subtracted at the end), and the
//   register chunk holds 16 complex right-hand sides in place of 32.  The
//   right-hand sides stay in shared memory in VT, in eta's order (z[i] =
//   eta[perm[i]] lives in row perm[i]), so eta is stored without a scatter;
//   eta's products read their right operand, the children's upsweep xi,
//   from device memory (once a chunk), so shared memory holds 2r rows of
//   right-hand sides, not 3r (complex: 16 columns a CTA at r = 192 where
//   w of 3r rows took 8, halving the CTAs that stream a node's operands).
//   The diagonal blocks' solves are a chain of 32 dependent steps, a
//   lane's row of the block in registers: at a diagonal tile the chunk's
//   right operand is dead (zeroed), so the solve does not spill at the 168
//   registers a thread that nine warps leave.  Where 16 CTAs
//   of nc columns do not cover k (ranks far above the default caps),
//   `groups` clusters per node split the columns, each reading the operands
//   once.
#include <cooperative_groups.h>
#include <cuda.h>

#include "hs_common.cuh"
#include "hs_complex.cuh"

namespace cg = cooperative_groups;

#define K_THREADS 256
#define K_FULL 0xffffffffu
#define K_PANEL 32
#define K_CW 64            // columns of a tile

// cpa: the operands copied by cp.async value by value (their rows are not
// 16-byte multiples, or their base is not 16-byte aligned); the bits of
// ops/hss.py's HSS_CORRECT_CPA (a test holds the two equal)
#define K_CPA_C 1          // Bl and Br
#define K_CPA_LU 2
#define K_CPA_PHI 4

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// one value of B bytes, or zeros where src_bytes is 0
template <int B>
__device__ __forceinline__ void cp_async_value(void* dst, const void* src,
                                               int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// k = 1 (and one column a CTA)
// ---------------------------------------------------------------------------
#define K_STAGES 3

// a ring tile's padded row stride in values (rows of 16-byte multiples)
template <typename TI>
__host__ __device__ constexpr int k_ldt() {
  return K_CW + 16 / (int)sizeof(TI);
}

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

// Issue tile t's copy into stage `st`: 16-byte chunks (v16) or one value a
// copy (rows past r2 skipped; a partial diagonal block padded to 32 x 32
// with the identity).
template <typename TI>
__device__ __forceinline__ void issue_tile(const KTile& t,
                                           const TI* __restrict__ lub, int r2,
                                           TI* st, int tid, bool v16) {
  constexpr int LDT = k_ldt<TI>(), V = 16 / (int)sizeof(TI);
  const int nr = r2 - t.row0 < K_PANEL ? r2 - t.row0 : K_PANEL;
  if (v16) {
    const int ch = t.ncols / V;  // 16-byte chunks per row
    for (int e = tid; e < nr * ch; e += K_THREADS) {
      const int i = e / ch, c = e - i * ch;
      cp_async16(st + i * LDT + V * c,
                 lub + (int64_t)(t.row0 + i) * r2 + t.col0 + V * c);
    }
  } else {
    for (int e = tid; e < nr * t.ncols; e += K_THREADS) {
      const int i = e / t.ncols, c = e - i * t.ncols;
      cp_async_value<sizeof(TI)>(st + i * LDT + c,
                                 lub + (int64_t)(t.row0 + i) * r2 + t.col0 + c,
                                 sizeof(TI));
    }
  }
  if (t.kind != 0 && (nr < K_PANEL || t.ncols < K_PANEL)) {
    for (int e = tid; e < K_PANEL * K_PANEL; e += K_THREADS) {
      const int i = e / K_PANEL, j = e - i * K_PANEL;
      if (i >= nr || j >= t.ncols) st[i * LDT + j] = TI(i == j ? 1.0f : 0.0f);
    }
  }
}

// column blockIdx.y of k: Y [B, n_pad, k], xi [B, 2m, r, k]
template <typename TI>
__global__ void __launch_bounds__(K_THREADS) hss_level_correct_vec_kernel(
    TI* Y, const TI* __restrict__ xi, const TI* __restrict__ Bl,
    const TI* __restrict__ Br, const TI* __restrict__ lu,
    const long long* __restrict__ perm, const TI* __restrict__ Phi, int m,
    int r, int blk, int k, int ntiles, int transpose, int v16) {
  typedef hs_acc_t<TI> VT;
  constexpr int LDT = k_ldt<TI>();
  extern __shared__ __align__(16) unsigned char kv_smem[];
  const int r2 = 2 * r;
  const int64_t bj = blockIdx.x;  // b * m + j
  const int64_t b = bj / m;
  const int j = (int)(bj - b * m);
  const int col = blockIdx.y;
  TI* ring = reinterpret_cast<TI*>(kv_smem);             // [STAGES][32][LDT]
  VT* w = reinterpret_cast<VT*>(ring + K_STAGES * K_PANEL * LDT);  // [2r]
  KTile* tiles = reinterpret_cast<KTile*>(w + r2);        // [ntiles]
  int* pv = reinterpret_cast<int*>(tiles + ntiles);       // [2r] perm
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = tid >> 3, g = tid & 7;  // 32 rows x 8 lanes
  const TI* lub = lu + bj * (int64_t)r2 * r2;

  if (tid == 0) k_tiles(r2, tiles);
  for (int e = tid; e < r2; e += K_THREADS) pv[e] = (int)perm[bj * r2 + e];
  __syncthreads();
  for (int s = 0; s < K_STAGES - 1; ++s) {
    if (s < ntiles)
      issue_tile(tiles[s], lub, r2, ring + s * K_PANEL * LDT, tid, v16);
    cp_async_commit();
  }

  // w[i] = eta[perm[i]], eta[s r + a] = op(C_s)[a] . xi[2j + 1 - s]; the
  // 8-lane groups fold with shuffles (warp-uniform trip count)
  const int64_t rr = (int64_t)r * r;
  const TI* xb = xi + (b * 2 * m + 2 * j) * (int64_t)r * k + col;
  for (int it0 = warp * 4; it0 < r2; it0 += K_THREADS / 8) {
    const int i = it0 + (lane >> 3);
    const bool ok = i < r2;
    const int src = pv[ok ? i : 0];
    const int s = src >= r, a = src - s * r;
    const TI* cp = (s ? Br : Bl) + bj * rr;
    const TI* xp = xb + (int64_t)(1 - s) * r * k;
    VT acc(0.0);
    if (ok && !transpose) {
      for (int t = g; t < r; t += 8)
        acc += hs_wide(hs_ldg(cp + (int64_t)a * r + t)) *
               hs_wide(hs_ldg(xp + (int64_t)t * k));
    } else if (ok) {
      for (int t = g; t < r; t += 8)
        acc += hs_wide(hs_ldg(cp + (int64_t)t * r + a)) *
               hs_wide(hs_ldg(xp + (int64_t)t * k));
    }
    for (int off = 4; off > 0; off >>= 1) acc += hs_shfl_xor(acc, off);
    if (ok && g == 0) w[i] = acc;
  }
  __syncthreads();

  // the blocked substitution over the streamed tiles
  VT part(0.0);  // this lane's share of row gr
  for (int ti = 0; ti < ntiles; ++ti) {
    const int nx = ti + K_STAGES - 1;
    if (nx < ntiles)
      issue_tile(tiles[nx], lub, r2, ring + (nx % K_STAGES) * K_PANEL * LDT,
                 tid, v16);
    cp_async_commit();
    cp_async_wait<K_STAGES - 1>();
    __syncthreads();
    const KTile t = tiles[ti];
    const TI* T = ring + (ti % K_STAGES) * K_PANEL * LDT;
    const int row = t.row0 + gr;
    if (t.kind == 0) {
      // the panel's rows take the solved values of the tile's columns
      if (row < r2) {
        const TI* Tr = T + gr * LDT;
        const VT* wc = w + t.col0;
        for (int q = g; q < t.ncols; q += 8) part += hs_wide(Tr[q]) * wc[q];
      }
    } else {
      // fold the partial sums into the panel's rows of w
      for (int off = 4; off > 0; off >>= 1) part += hs_shfl_xor(part, off);
      if (g == 0 && row < r2) w[row] -= part;
      part = VT(0.0);
      __syncthreads();
      // the 32 x 32 diagonal block (identity-padded), by warp 0
      if (warp == 0) {
        const int lr = t.row0 + lane;
        VT x = lr < r2 ? w[lr] : VT(0.0);
        if (t.kind == 1) {
#pragma unroll
          for (int i = 0; i < K_PANEL; ++i) {
            const VT xv = hs_shfl(x, i);
            if (lane > i) x -= hs_wide(T[lane * LDT + i]) * xv;
          }
        } else {
          const VT rd = hs_inv(hs_wide(T[lane * LDT + lane]));
#pragma unroll
          for (int i = K_PANEL - 1; i >= 0; --i) {
            if (lane == i) x = x * rd;
            const VT xv = hs_shfl(x, i);
            if (lane < i) x -= hs_wide(T[lane * LDT + i]) * xv;
          }
        }
        if (lr < r2) w[lr] = x;
      }
    }
    __syncthreads();  // the stage is free, w's new rows are visible
  }

  // Y[child rows] -= Phi[child rows] w[child part], rounded once
  const int64_t npad = (int64_t)2 * m * blk;
  const int64_t row0 = (int64_t)2 * j * blk;
  TI* Yb = Y + b * npad * k + col;
  for (int it0 = warp * 4; it0 < 2 * blk; it0 += K_THREADS / 8) {
    const int i = it0 + (lane >> 3);
    const bool ok = i < 2 * blk;
    const int s = i >= blk;
    const TI* pp = Phi + (b * npad + row0 + (ok ? i : 0)) * r;
    const VT* wp = w + (int64_t)s * r;
    VT a(0.0);
    if (ok)
      for (int t = g; t < r; t += 8) a += hs_wide(hs_ldg(pp + t)) * wp[t];
    for (int off = 4; off > 0; off >>= 1) a += hs_shfl_xor(a, off);
    if (ok && g == 0) {
      TI* y = Yb + (row0 + i) * k;
      *y = static_cast<TI>(hs_wide(*y) - a);
    }
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
#define KB_STAGE (KB_ROWS * KB_LD)  // values per stage: one TMA box
#define KB_MAX_NC 32  // right-hand sides per CTA: 4 column blocks of 8
#define KB_MAX_NC_CX 16  // complex: 2 column blocks (split parts, twice the registers)
#define KB_MAX_CLUSTER 16
#define KB_DG_LD 33   // row stride of the diagonal block's copy

enum { KB_ETA = 0, KB_ETA_T, KB_LDIAG, KB_UDIAG, KB_LCOL, KB_UCOL, KB_PHI };

struct KbTile {
  int kind, s, row0, col0, nrows, ncols, load_b, assign;
};

// The tiles of one node in the order of consumption, each at most 64 rows
// of a product's left operand by a chunk of 32 of its columns (the depth):
// eta's rows of op(Bl) (s = 0) then of op(Br) (s = 1), per chunk of 32
// columns its 64-row tiles; the LU right-looking, per 32-row panel p (the
// lower triangle top-down, then the upper one bottom-up) its diagonal block,
// then the tiles of the panel's 32 columns below it (lower) or above it
// (upper); Phi's rows of child 0 then child 1, per chunk of 32 columns.
// `load_b` marks a chunk's first tile (the consumers load the chunk's right
// operand into registers), `assign` eta's first chunk (stored, not added).
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
    t.load_b = t.assign = t.s = 0;
    if (ph == 0) {  // eta: side a, column chunk b, row tile c
      t.kind = transpose ? KB_ETA_T : KB_ETA;
      t.s = a;
      t.row0 = c;
      t.col0 = b;
      t.nrows = min(KB_ROWS, r - c);
      t.ncols = min(K_PANEL, r - b);
      t.load_b = c == 0;
      t.assign = b == 0;
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tmap,
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

// The box a tensor map would read, by the producer warp with cp.async: the
// box_out x box_in values at (c0, c1) of a [rows, cols] array, zeros past
// its last column and row.  Each lane's copies arrive on the stage's full
// barrier as they land (cp.async.mbarrier.arrive, which first adds one to
// the pending arrivals), and lane 0 makes the phase's one arrival: the
// producer does not wait for the copies
template <typename TI>
__device__ __forceinline__ void copy_box(TI* dst, const TI* __restrict__ base,
                                         int cols, int64_t rows, int box_in,
                                         int box_out, int c0, int64_t c1,
                                         uint64_t* full, int lane) {
  for (int e = lane; e < box_in * box_out; e += 32) {
    const int i = e / box_in, c = e - i * box_in;
    const bool ok = c0 + c < cols && c1 + i < rows;
    cp_async_value<sizeof(TI)>(dst + e,
                               ok ? base + (c1 + i) * cols + c0 + c : base,
                               ok ? (int)sizeof(TI) : 0);
  }
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(full))
               : "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
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

// A warp's fragments of one tile product in the compute type: real (one
// part) or complex (NP = 2, the parts split as they are loaded; the real
// part of the product sums in two accumulators, re re and im im)
template <int NP, int CTM>
struct KbFrags {
  double a[NP][8];        // this warp's 8 rows of the tile, 8 depth steps
  double b[NP][8][CTM];   // the chunk's right operand, CTM column blocks
};

// acc[u] += A B_u for this warp's 8 x 32 row block of a tile and CT of the
// chunk's 8-column blocks (past the chunk's columns both fragments are 0);
// complex: acc[0] the re re, acc[1] the im im and acc[2] the imaginary
// sums.  CT is a template argument so that no branch (and no reconvergence
// point) sits between two products
template <int CT, int NP, int CTM>
__device__ __forceinline__ void tile_mma(double (&acc)[2 * NP - 1][CTM][2],
                                         const KbFrags<NP, CTM>& f) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int u = 0; u < CT; ++u) {
      dmma(acc[0][u], f.a[0][ks], f.b[0][ks][u]);
      if constexpr (NP == 2) {
        dmma(acc[1][u], f.a[1][ks], f.b[1][ks][u]);
        dmma(acc[2][u], f.a[0][ks], f.b[1][ks][u]);
        dmma(acc[2][u], f.a[1][ks], f.b[0][ks][u]);
      }
    }
  }
}

// the parts of a compute-type value
__device__ __forceinline__ double kb_part(double v, int p) {
  (void)p;
  return v;
}
__device__ __forceinline__ double kb_part(hs_c128 v, int p) {
  return p ? v.im : v.re;
}

// One step of the 32 x 32 diagonal block's solve for NV of a warp's
// columns at once: lane = row, t its row's entry i of the (identity-padded)
// block, rd the inverse of its diagonal entry; the solved value of row i is
// broadcast by a shuffle, with selects in place of branches between the
// shuffles
template <int NV, int NVM, typename VT>
__device__ __forceinline__ void diag_step(VT (&x)[NVM], VT t, VT rd, int i,
                                          int lane, bool lower) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!lower) x[v] = lane == i ? x[v] * rd : x[v];
    const VT xv = hs_shfl(x[v], i);
    x[v] = (lower ? lane > i : lane < i) ? x[v] - t * xv : x[v];
  }
}

// The block's solve, the lane's row (drow, in shared memory) loaded into
// registers first and every step unrolled
template <int NV, int NVM, typename VT>
__device__ __forceinline__ void diag_solve(VT (&x)[NVM], const VT* drow,
                                           VT rd, int lane, bool lower) {
  VT Trow[K_PANEL];
#pragma unroll
  for (int i = 0; i < K_PANEL; ++i) Trow[i] = drow[i];
  if (lower) {
#pragma unroll
    for (int i = 0; i < K_PANEL; ++i)
      diag_step<NV>(x, Trow[i], rd, i, lane, true);
  } else {
#pragma unroll
    for (int i = K_PANEL - 1; i >= 0; --i)
      diag_step<NV>(x, Trow[i], rd, i, lane, false);
  }
}

// TI the operands' type, VT = hs_acc_t<TI> the one the kernel computes in;
// cpa the operands copied by cp.async (K_CPA_*); TW doubles a value in the
// tensor maps (complex128: 2)
template <typename TI>
__global__ void __launch_bounds__(KB_THREADS, 1) hss_level_correct_block_kernel(
    TI* Y, const TI* __restrict__ xi, const TI* __restrict__ Bl,
    const TI* __restrict__ Br, const TI* __restrict__ lu,
    const TI* __restrict__ Phi, const __grid_constant__ CUtensorMap tm_l,
    const __grid_constant__ CUtensorMap tm_r,
    const __grid_constant__ CUtensorMap tm_lu,
    const __grid_constant__ CUtensorMap tm_phi,
    const long long* __restrict__ perm, int64_t nodes, int64_t phi_rows,
    int m, int r, int blk, int k, int nc, int groups, int ns, int ntiles,
    int transpose, int cpa) {
  typedef hs_acc_t<TI> VT;
  constexpr bool CX = hs_traits<TI>::complex;
  constexpr int NP = CX ? 2 : 1;                 // parts of a value
  constexpr int CTM = (CX ? KB_MAX_NC_CX : KB_MAX_NC) / 8;
  constexpr int TW = sizeof(TI) == 16 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char kb_smem[];
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
  TI* ring = reinterpret_cast<TI*>(kb_smem);            // [ns][KB_STAGE]
  VT* w = reinterpret_cast<VT*>(ring + (size_t)ns * KB_STAGE);  // [2r][ldw]
  uint64_t* full = reinterpret_cast<uint64_t*>(w + (size_t)r2 * ldw);
  uint64_t* empty = full + ns;
  VT* dg = reinterpret_cast<VT*>(empty + ns);           // [32][KB_DG_LD]
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
  // w: eta of op(Bl) in rows [0, r), of op(Br) in [r, 2r) (zero until then,
  // and in the columns past ncl)
  for (int e = tid; e < r2 * ldw; e += KB_THREADS) w[e] = VT(0.0);
  // this CTA's columns of the children's upsweep, xi[2j] and xi[2j + 1]
  const TI* xb = xi + (b * 2 * m + 2 * j) * (int64_t)r * k + c0;
  cl.sync();  // every CTA's barriers are set before any copy lands

  if (warp == KB_CONSUMERS / 32) {
    // the producer: tile t into stage t % ns once the stage's previous
    // tile is released (the leader: by every consumer warp of the cluster;
    // the others: by their own), each CTA arming its own full barrier for
    // the box's bytes; the leader issues one box per tile, multicast (or
    // every CTA copies its own with cp.async, in a launch of no cluster)
    const int64_t nrow = bj * (int64_t)r2;   // this node's first LU row
    const int64_t crow = bj * (int64_t)r;    // of Bl and Br
    const int64_t prow = (b * 2 * m + 2 * j) * (int64_t)blk;  // of Phi
    KbIter it;
    it.init(r, blk, transpose);
    for (int t = 0; t < ntiles; ++t) {
      const KbTile d = it.next();
      const int s = t % ns;
      TI* st = ring + (size_t)s * KB_STAGE;
      if (lane == 0 && t >= ns) mbar_wait(empty + s, (t / ns - 1) & 1);
      __syncwarp();
      const bool coupling = d.kind == KB_ETA || d.kind == KB_ETA_T;
      const int op = coupling ? K_CPA_C : d.kind == KB_PHI ? K_CPA_PHI : K_CPA_LU;
      // the box: its inner (column) and outer (row) coordinates and sizes
      int bi;
      int64_t oc;
      if (d.kind == KB_ETA) {
        bi = d.col0, oc = crow + d.row0;
      } else if (d.kind == KB_ETA_T) {  // op(C)[a][t] = C[t][a]: rows t
        bi = d.row0, oc = crow + d.col0;
      } else if (d.kind == KB_PHI) {
        bi = d.col0, oc = prow + (int64_t)d.s * blk + d.row0;
      } else {
        bi = d.col0, oc = nrow + d.row0;
      }
      if (cpa & op) {
        const TI* base = coupling ? (d.s ? Br : Bl) : d.kind == KB_PHI ? Phi : lu;
        const int cols = d.kind == KB_LDIAG || d.kind == KB_UDIAG ||
                                 d.kind == KB_LCOL || d.kind == KB_UCOL
                             ? r2
                             : r;
        const int64_t rows = coupling ? nodes * r
                             : d.kind == KB_PHI ? phi_rows
                                                : nodes * r2;
        const bool tr = d.kind == KB_ETA_T;
        copy_box(st, base, cols, rows, tr ? KB_LDT : KB_LD,
                 tr ? K_PANEL : KB_ROWS, bi, oc, full + s, lane);
      } else if (lane == 0) {
        mbar_expect_tx(full + s, KB_STAGE * sizeof(TI));
        if (rank == 0)
          tma_load(st,
                   coupling ? (d.s ? &tm_r : &tm_l)
                   : d.kind == KB_PHI ? &tm_phi
                                      : &tm_lu,
                   TW * bi, (int)oc, full + s, cs);
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
    KbFrags<NP, CTM> f;
    TI* Yn = Y + ((b * 2 * m + 2 * j) * (int64_t)blk) * k + c0;
    KbIter it;
    it.init(r, blk, transpose);
    for (int t = 0; t < ntiles; ++t) {
      const KbTile d = it.next();
      const int s = t % ns;
      if (d.load_b) {
        // B's rows: eta reads xi[2j + 1] (op(Bl)) or xi[2j] (op(Br)) from
        // device memory, the LU's tiles z and Phi's tiles x from w, both
        // in eta's order
        const bool direct = d.kind <= KB_ETA_T;
        const TI* xc = xb + (int64_t)(1 - d.s) * r * k;
        const int base = (d.kind == KB_PHI ? d.s * r : 0) + d.col0;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int q = 4 * ks + qc;
          const bool qok = q < d.ncols;
          const int brow = qok && !direct ? pv[base + q] : 0;
#pragma unroll
          for (int u = 0; u < CTM; ++u) {
            const int c = u * 8 + qr;
            VT v(0.0);
            if (qok && u < ct)
              v = direct ? (c < ncl ? hs_wide(hs_ldg(
                                          xc + (int64_t)(d.col0 + q) * k + c))
                                    : VT(0.0))
                         : w[brow * ldw + c];
#pragma unroll
            for (int p = 0; p < NP; ++p) f.b[p][ks][u] = kb_part(v, p);
          }
        }
      }
      mbar_wait(full + s, (t / ns) & 1);
      const TI* T = ring + (size_t)s * KB_STAGE;
      if (d.kind == KB_LDIAG || d.kind == KB_UDIAG) {
        // the chunk's right operand is dead until the next chunk loads it:
        // its registers go to the solve
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
#pragma unroll
          for (int u = 0; u < CTM; ++u)
#pragma unroll
            for (int p = 0; p < NP; ++p) f.b[p][ks][u] = 0.0;
        // the diagonal block copied to dg (stride 33: a lane per row reads it
        // without bank conflicts, identity-padded to 32 x 32); then the
        // block's solve: lane = row, warp w takes columns w, w + 8, w + 16,
        // w + 24, all at once
        const int nr = d.nrows;
        for (int e = tid; e < K_PANEL * K_PANEL; e += KB_CONSUMERS) {
          const int i = e >> 5, jj = e & 31;
          dg[i * KB_DG_LD + jj] = i < nr && jj < nr
                                      ? hs_wide(T[i * KB_LD + jj])
                                      : VT(i == jj ? 1.0 : 0.0);
        }
        release(empty + s, lane, rank);
        consumers_sync();
        const bool rok = lane < nr;
        const int prow = rok ? pv[d.row0 + lane] : 0;
        const int nv = ncl > warp ? (ncl - warp + 7) / 8 : 0;  // warp-uniform
        if (nv > 0) {
          const VT* drow = dg + lane * KB_DG_LD;
          const VT rd = hs_inv(drow[lane]);
          VT x[CTM];
#pragma unroll
          for (int v = 0; v < CTM; ++v)
            x[v] = rok && v < nv ? w[prow * ldw + warp + 8 * v] : VT(0.0);
          const bool lower = d.kind == KB_LDIAG;
          switch (nv) {
            case 1: diag_solve<1>(x, drow, rd, lane, lower); break;
            case 2: diag_solve<2>(x, drow, rd, lane, lower); break;
            case 3:
              if constexpr (CTM > 2) diag_solve<3>(x, drow, rd, lane, lower);
              break;
            default:
              if constexpr (CTM > 2) diag_solve<4>(x, drow, rd, lane, lower);
              break;
          }
#pragma unroll
          for (int v = 0; v < CTM; ++v)
            if (rok && v < nv) w[prow * ldw + warp + 8 * v] = x[v];
        }
        consumers_sync();
      } else {
        // this warp's 8 rows of the tile times the chunk's right operand
        const bool trans = d.kind == KB_ETA_T;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int q = 4 * ks + qc;
          const VT v = tr < d.nrows && q < d.ncols
                           ? hs_wide(trans ? T[q * KB_LDT + tr]
                                           : T[tr * KB_LD + q])
                           : VT(0.0);
#pragma unroll
          for (int p = 0; p < NP; ++p) f.a[p][ks] = kb_part(v, p);
        }
        release(empty + s, lane, rank);
        if (warp * 8 < d.nrows) {  // warp-uniform
          double acc[2 * NP - 1][CTM][2] = {};
          switch (ct) {  // warp-uniform: no branch around an mma
            case 1: tile_mma<1>(acc, f); break;
            case 2: tile_mma<2>(acc, f); break;
            case 3:
              if constexpr (CTM > 2) tile_mma<3>(acc, f);
              break;
            case 4:
              if constexpr (CTM > 2) tile_mma<4>(acc, f);
              break;
            default: break;
          }
          // the products in the compute type
          VT pr[CTM][2];
#pragma unroll
          for (int u = 0; u < CTM; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if constexpr (CX)
                pr[u][i] = VT(acc[0][u][i] - acc[1][u][i], acc[2][u][i]);
              else
                pr[u][i] = acc[0][u][i];
            }
          if (d.kind == KB_PHI) {
            // Phi x out of this CTA's columns of Y, rounded once: every old
            // value is loaded before the first store (one load latency)
            TI* dst[CTM][2];
            VT old[CTM][2];
#pragma unroll
            for (int u = 0; u < CTM; ++u) {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int c = u * 8 + 2 * qc + i;
                dst[u][i] = u < ct && tr < d.nrows && c < ncl
                                ? Yn + ((int64_t)d.s * blk + d.row0 + tr) * k + c
                                : nullptr;
                old[u][i] = dst[u][i] != nullptr ? hs_wide(*dst[u][i]) : VT(0.0);
              }
            }
#pragma unroll
            for (int u = 0; u < CTM; ++u) {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (dst[u][i] != nullptr)
                  *dst[u][i] = static_cast<TI>(old[u][i] - pr[u][i]);
            }
          } else {
            // eta's rows into w (eta's order), the LU's updates out of z's
            // rows
            const bool eta = d.kind == KB_ETA || d.kind == KB_ETA_T;
            VT* dst[CTM][2];
            VT old[CTM][2];
#pragma unroll
            for (int u = 0; u < CTM; ++u) {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int c = u * 8 + 2 * qc + i;
                dst[u][i] = nullptr;
                if (u < ct && tr < d.nrows && c < ncl)
                  dst[u][i] = eta ? w + (d.s * r + d.row0 + tr) * ldw + c
                                  : w + pv[d.row0 + tr] * ldw + c;
                old[u][i] =
                    dst[u][i] != nullptr && !d.assign ? *dst[u][i] : VT(0.0);
              }
            }
#pragma unroll
            for (int u = 0; u < CTM; ++u) {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (dst[u][i] != nullptr)
                  *dst[u][i] = eta ? old[u][i] + pr[u][i] : old[u][i] - pr[u][i];
            }
          }
        }
      }
    }
  }
  cl.sync();  // no CTA leaves while others may still arrive on its barriers
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// dynamic shared memory of the k = 1 kernel
template <typename TI>
static size_t k_smem_vec(int r) {
  return (size_t)K_STAGES * K_PANEL * k_ldt<TI>() * sizeof(TI) +
         (size_t)2 * r * sizeof(hs_acc_t<TI>) +
         (size_t)k_tiles(2 * r, nullptr) * sizeof(KTile) +
         (size_t)2 * r * sizeof(int);
}

// dynamic shared memory of the k > 1 kernel (the wrapper sizes nc and ns
// with the same sum, ops/hss.py level_correct_smem)
template <typename TI>
static size_t k_smem_block(int r, int nc, int ns) {
  return (size_t)ns * KB_STAGE * sizeof(TI) +
         (size_t)(2 * r * (nc + 4) + K_PANEL * KB_DG_LD) *
             sizeof(hs_acc_t<TI>) +
         (size_t)2 * ns * sizeof(uint64_t) + (size_t)2 * r * sizeof(int);
}

typedef CUresult (*KEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 2-D tensor map of `rows` rows of `cols` TI values (row-major) whose box
// is `box_in` values by `box_out` rows, read zero past the last column and
// row (cuTensorMapEncodeTiled, found through the runtime: no link to libcuda).
// float32 maps as FLOAT32, float64 and complex64 as FLOAT64 (8 bytes a
// value), complex128 as FLOAT64 pairs (the inner dimension doubled).  A
// null map where the array cannot be one (cpa: its tiles go by cp.async).
template <typename TI>
static bool k_map(CUtensorMap* map, const void* base, uint64_t cols,
                  uint64_t rows, unsigned box_in, unsigned box_out, bool cpa) {
  if (cpa) {
    memset(map, 0, sizeof(*map));
    return true;
  }
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
  const unsigned tw = sizeof(TI) == 16 ? 2 : 1;
  const cuuint64_t dims[2] = {cols * tw, rows},
                   strides[1] = {cols * (cuuint64_t)sizeof(TI)};
  const cuuint32_t box[2] = {box_in * tw, box_out}, elem[2] = {1, 1};
  return encode(map,
                sizeof(TI) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                2, const_cast<void*>(base), dims, strides, box, elem,
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

// k = 1, or nc = 0: one CTA per (node, column); k > 1: clusters of cs CTAs
// of nc columns, `groups` of them per node, ns ring stages; cpa: the
// operands copied by cp.async (K_CPA_*, ops/hss.py level_correct_cp_async),
// with which a launch takes one CTA a cluster whatever cs is asked
template <typename TI>
static int level_correct(void* Y, const void* xi, const void* Bl,
                         const void* Br, const void* lu, const void* perm,
                         const void* Phi, long long B, int m, int r, int blk,
                         int k, int nc, int cs, int ns, int transpose, int cpa,
                         void* stream) {
  if (B <= 0 || m <= 0 || r <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (k == 1 || nc == 0) {
    const size_t smem = k_smem_vec<TI>(r);
    auto kern = hss_level_correct_vec_kernel<TI>;
    if ((err = k_allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3((unsigned)(B * m), (unsigned)k), K_THREADS, smem,
           (cudaStream_t)stream>>>(
        (TI*)Y, (const TI*)xi, (const TI*)Bl, (const TI*)Br, (const TI*)lu,
        (const long long*)perm, (const TI*)Phi, m, r, blk, k,
        k_tiles(2 * r, nullptr), transpose, (cpa & K_CPA_LU) ? 0 : 1);
    return (int)cudaGetLastError();
  }
  // an operand copied by cp.async: no cluster (a CTA that copies its own
  // tiles could release a stage ahead of its peers, and the leader counts
  // their releases by phase), the same columns a CTA
  if (cpa) cs = 1;
  const int max_nc = hs_traits<TI>::complex ? KB_MAX_NC_CX : KB_MAX_NC;
  if (nc < 4 || nc > max_nc || nc % 4 || cs < 1 || cs > KB_MAX_CLUSTER ||
      ns < 2)
    return (int)cudaErrorInvalidValue;
  const int groups = (k + cs * nc - 1) / (cs * nc);
  const int r2 = 2 * r;
  const uint64_t nodes = (uint64_t)B * m, npad = (uint64_t)2 * m * blk;
  CUtensorMap tm_l, tm_r, tm_lu, tm_phi;
  const unsigned ci = transpose ? KB_LDT : KB_LD, co = transpose ? 32 : KB_ROWS;
  if (!k_map<TI>(&tm_l, Bl, r, nodes * r, ci, co, cpa & K_CPA_C) ||
      !k_map<TI>(&tm_r, Br, r, nodes * r, ci, co, cpa & K_CPA_C) ||
      !k_map<TI>(&tm_lu, lu, r2, nodes * r2, KB_LD, KB_ROWS, cpa & K_CPA_LU) ||
      !k_map<TI>(&tm_phi, Phi, r, (uint64_t)B * npad, KB_LD, KB_ROWS,
                 cpa & K_CPA_PHI))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k_smem_block<TI>(r, nc, ns);
  auto kern = hss_level_correct_block_kernel<TI>;
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
  err = cudaLaunchKernelEx(&cfg, kern, (TI*)Y, (const TI*)xi, (const TI*)Bl,
                           (const TI*)Br, (const TI*)lu, (const TI*)Phi, tm_l,
                           tm_r, tm_lu, tm_phi, (const long long*)perm,
                           (int64_t)nodes, (int64_t)(B * npad), m, r, blk, k,
                           nc, groups, ns, kb_ntiles(r, blk), transpose, cpa);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// the most clusters of cs CTAs with the k > 1 kernel's shared memory that the
// card holds at once (0: such a cluster cannot be scheduled)
template <typename TI>
static int level_correct_clusters(int r, int nc, int cs, int ns) {
  auto kern = hss_level_correct_block_kernel<TI>;
  const size_t smem = k_smem_block<TI>(r, nc, ns);
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

#define HS_K_ARGS                                                              \
  void *Y, const void *xi, const void *Bl, const void *Br, const void *lu,    \
      const void *perm, const void *Phi, long long B, int m, int r, int blk,  \
      int k, int nc, int cs, int ns, int transpose, int cpa, void *stream
#define HS_K_PASS \
  Y, xi, Bl, Br, lu, perm, Phi, B, m, r, blk, k, nc, cs, ns, transpose, cpa, stream

HS_EXPORT int hs_hss_level_correct(HS_K_ARGS) {
  return level_correct<double>(HS_K_PASS);
}
HS_EXPORT int hs_hss_level_correct_f32(HS_K_ARGS) {
  return level_correct<float>(HS_K_PASS);
}
HS_EXPORT int hs_hss_level_correct_c64(HS_K_ARGS) {
  return level_correct<hs_c64>(HS_K_PASS);
}
HS_EXPORT int hs_hss_level_correct_c128(HS_K_ARGS) {
  return level_correct<hs_c128>(HS_K_PASS);
}

HS_EXPORT int hs_hss_level_correct_clusters(int r, int nc, int cs, int ns) {
  return level_correct_clusters<double>(r, nc, cs, ns);
}
HS_EXPORT int hs_hss_level_correct_clusters_f32(int r, int nc, int cs, int ns) {
  return level_correct_clusters<float>(r, nc, cs, ns);
}
HS_EXPORT int hs_hss_level_correct_clusters_c64(int r, int nc, int cs, int ns) {
  return level_correct_clusters<hs_c64>(r, nc, cs, ns);
}
HS_EXPORT int hs_hss_level_correct_clusters_c128(int r, int nc, int cs,
                                                 int ns) {
  return level_correct_clusters<hs_c128>(r, nc, cs, ns);
}
