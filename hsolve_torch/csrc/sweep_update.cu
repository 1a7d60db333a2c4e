// Kernel C: a dense level's two solve steps, one launch each.
//
// Replaces the per-level steps of hsolve/factor.py `_apply_impl`, which XLA
// lowered as a gather, a batched GEMM, a scatter-add, two batched triangular
// solves (hsolve/ops/dense.py:34-39, `lu_solve`) and a scatter per level:
//
//   forward (`hs_level_forward`, factor.py:527-539), per front b:
//       x = C[int_ids[b]]                      (ids >= N read as 0)
//       C[bnd_ids[b]] -= L[b] @ x              (ids >= N skipped)
//       x' = D[b]^-1 x: with (lu, perm) z = x[perm], z = Lunit^-1 z,
//            x' = U^-1 z; with dinv x' = dinv[b] @ x
//       C[int_ids[b]] = x'                     (ids >= N skipped: C's
//                                               sentinel row N stays 0)
//   backward (`hs_sweep_update`, factor.py:553-559):
//       C[int_ids[b]] -= R[b] @ C[bnd_ids[b]]
//
// C is [rows, k].  The forward step takes one right-hand side per pass (k = 1
// on the solve's path); the backward step takes them in chunks of HS_C_KMAX.
// Instantiated for double, float (`_f32`, the float32 factor's solve),
// complex128 (`_c128`) and complex64 (`_c64`: the damped Helmholtz system's
// factors, hs_complex.cuh).  All accumulate in double (complex128 for the
// complex types): every dot, the substitution's running values and the
// solved values it shares (ys, and the windows' scratch X, Z) are in
// hs_acc_t, and a float32 or complex64 result is rounded once, where it is
// stored.  Loads and stores keep the value type and stay 16 bytes wide
// (two doubles, four floats, one complex128 or two complex64 values), so
// the narrow forms move the same bytes; the top levels of a float32 factor
// are nearly singular, and a float summation there cost the mixed-precision
// solve half again as many GMRES iterations as the reference's (fault F4).
// In complex the pivot solve's division by U's diagonal is a product with
// its complex reciprocal, and the forward update of C[bnd] two real
// atomics.  A complex128 value takes twice a double's shared memory and
// registers: the forward step's CTA at ni_pad 2048 holds 196 KB (ys, xs and
// eight staged 32 x 33 diagonal blocks of 16 bytes), inside the 227 KB a
// CTA has.
//
// Bound: bytes.  A forward step must read lu[b] (or dinv[b]), L[b], the ids
// and x once and write x' and the boundary updates once; the backward step
// reads R[b] once; both do about 2 flops per matrix entry.  The rows of L[b],
// dinv[b] and R[b] are read by groups of 8 lanes with 16-byte loads (scalar
// loads where a row is not 16-byte aligned) and reduced with 3 shuffles; the
// gathered vectors live in shared memory, gathered once per front.
//
// The substitution is sequential in its 32-row panels, so at the top levels
// (1-16 fronts of 256-1024 rows) latency, not bytes, sets its time.  Warp w
// of a front's CTA owns one panel P, one lane per row, and keeps the row's
// running value in a register.  In each direction (forward, then backward)
//   - the owner of panel p solves its 32 x 32 diagonal block (staged in
//     shared memory once per launch, identity-padded so the unrolled solve
//     has no bounds) with one shuffle and one multiply-add per row, and
//     shares the solved values y_p in ys;
//   - every warp whose rows take panel p's update multiplies its 32 x 32
//     block lu[rows, p cols] by y_p.  The block was loaded one panel ahead,
//     coalesced: lu is column-major (as the LU returns it, so the factor
//     makes no copy), a 16-byte load covers W = 4 (float), 2 (double,
//     complex64) or 1 (complex128) rows of a column, and the block stays in
//     registers (32 values a lane: 128 registers in complex128; loaded by
//     value, load16v, so it never goes to local memory).  A fold over the W
//     lanes that share rows (log2 W shuffles) and one permuting shuffle
//     leave each row's sum in its lane.
// On one CTA (a front of up to 256 rows, substitute_steps) the panels are
// steps with a CTA barrier between the solve and the products, the waiting
// warps asleep at it (and so, with the cluster's barrier, are a float32
// front's on a cluster).  On a cluster (substitute_signals) no barrier over
// the front lies between the panels: the owner of p stores y_p into every
// CTA and then a signal (publish_ready), and a warp waits only for the
// panels it takes (wait_ready), so the critical path per panel is one
// solve, one signal and one block product, and the other warps' products
// run beside it; there a complex64 front's diagonal blocks are staged as
// complex128, so no conversion sits in its solve's chain (stage_t).
// lu[b] is read once.  A front of up to 8 panels (ni_pad <= 256) runs on one
// CTA of up to 8 warps; a wider one on a thread block cluster of
// ceil(panels / 8) CTAs (the wrapper picks it per level, at most 8): CTA c
// owns the panels p with p % cs == c and stores y_p and the signal into
// every CTA through distributed shared memory.  The rows of L[b] and
// dinv[b] are split the same way.  A front wider than 8 CTAs' 2048 rows
// takes the wide form (launch_windowed, below): one substitution launch on
// a cluster of up to 16 CTAs, by inverted diagonal blocks.
//
// Races: within a level the int ids of the fronts are disjoint, no front's
// bnd ids are another front's int ids, and every CTA of a front reads x before
// any of them writes x' (a barrier lies between).  The forward update of
// C[bnd] is an atomicAdd: bnd ids are unique within a level on generated
// trees (deterministic result), but trees from parse_elimtree carry no such
// guarantee (correct, summation order not fixed).  The backward step writes
// C[int] with plain stores: each int id has one writer, and the rows read
// (bnd) and written (int) of one level are disjoint.
#include "hs_common.cuh"
#include "hs_complex.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define HS_C_THREADS 128  // the backward step's CTA
#define HS_C_KMAX 4      // right-hand sides per pass of the backward step
#define HS_C_LPR 8       // lanes per matrix row
#define HS_C_RPW (32 / HS_C_LPR)
#define HS_C_PANEL 32    // rows per substitution panel
#define HS_C_DG_LD 33    // padded leading dimension of a staged diagonal block
#define HS_C_DG (HS_C_PANEL * HS_C_DG_LD)
#define HS_C_MAX_PW 8    // panels (warps) per CTA of the forward step
#define HS_C_FWD_MAX (32 * HS_C_MAX_PW)  // its CTA (registers: up to 255)
#define HS_C_MAX_PANELS (HS_C_MAX_PW * 8)  // of a cluster of 8: 2048 rows

template <typename T>
using Vec16 = hs_vec16<T>;

// one 16-byte read-only load of Vec16<T>::n values, returned by value: a
// register array the caller copies from at constant indices, so its own
// array never has its address taken (a pointer into a lane's block of lu
// put the whole block in local memory)
template <typename T>
struct Vals16 {
  T v[Vec16<T>::n];
};

__device__ __forceinline__ Vals16<double> load16v(const double* p) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  return {{x.x, x.y}};
}
__device__ __forceinline__ Vals16<float> load16v(const float* p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  return {{x.x, x.y, x.z, x.w}};
}
__device__ __forceinline__ Vals16<hs_c128> load16v(const hs_c128* p) {
  return {{hs_ldg(p)}};
}
__device__ __forceinline__ Vals16<hs_c64> load16v(const hs_c64* p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  return {{hs_c64(x.x, x.y), hs_c64(x.z, x.w)}};
}

// acc[q] += row[0:len] . v[q * vstride + 0:len] over lane `gl`'s share of
// the row (a group of HS_C_LPR lanes covers it).  VEC: 16-byte loads (the
// row 16-byte aligned, len a multiple of the vector width).
template <typename T, bool VEC, typename VT>
__device__ __forceinline__ void group_dot(const T* __restrict__ row,
                                          const VT* v, int vstride, int len,
                                          int kc, int gl,
                                          hs_acc_t<T> (&acc)[HS_C_KMAX]) {
  if (VEC) {
    constexpr int W = Vec16<T>::n;
    for (int c = gl * W; c < len; c += HS_C_LPR * W) {
      const Vals16<T> a = load16v(row + c);
#pragma unroll
      for (int q = 0; q < HS_C_KMAX; ++q) {
        if (q < kc) {
#pragma unroll
          for (int e = 0; e < W; ++e)
            acc[q] += hs_wide(a.v[e]) * hs_wide(v[q * vstride + c + e]);
        }
      }
    }
  } else {
    for (int c = gl; c < len; c += HS_C_LPR) {
      const T a = hs_ldg(row + c);
#pragma unroll
      for (int q = 0; q < HS_C_KMAX; ++q)
        if (q < kc) acc[q] += hs_wide(a) * hs_wide(v[q * vstride + c]);
    }
  }
}

// sum over the lanes of a group (xor partners stay inside aligned groups);
// kc is uniform across the warp, so every lane shuffles
template <typename A>
__device__ __forceinline__ void group_sum(A (&acc)[HS_C_KMAX], int kc) {
#pragma unroll
  for (int q = 0; q < HS_C_KMAX; ++q)
    if (q < kc)
      for (int off = HS_C_LPR / 2; off > 0; off >>= 1)
        acc[q] += hs_shfl_xor(acc[q], off);
}

// The panels p in [p_lo, p_hi) with p % cs == rank, as rows: own_count is a
// multiple of HS_C_PANEL and own_row(t) the t-th row (it may pass the
// matrix's last row inside the last panel; callers skip those).
__device__ __forceinline__ int first_own(int p_lo, int rank, int cs) {
  return p_lo + ((rank - p_lo % cs) % cs + cs) % cs;
}

__device__ __forceinline__ int own_count(int p_lo, int p_hi, int rank, int cs) {
  const int f = first_own(p_lo, rank, cs);
  return f < p_hi ? ((p_hi - 1 - f) / cs + 1) * HS_C_PANEL : 0;
}

__device__ __forceinline__ int own_row(int t, int p_lo, int rank, int cs) {
  return (first_own(p_lo, rank, cs) + (t / HS_C_PANEL) * cs) * HS_C_PANEL +
         t % HS_C_PANEL;
}

// a barrier over the CTAs of one front
__device__ __forceinline__ void front_sync(int cs) {
  if (cs > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// On a cluster, panel p's solved values are published point to point: its
// owner warp stores them into every CTA's ys, then sets ready[p] = epoch in
// every CTA (a release store at cluster scope, after the warp's stores); a
// warp that takes panel p's update polls its own CTA's ready[p] with
// acquire loads until it reaches epoch.  Each ready[p] has one writer, the
// owner of p, and rises once a direction (epoch: 2 q0 + dir + 1), so no
// store overtakes another.  (Relaxed polls with one fence after them read
// slower on the H100: the fence sits on the critical path.)
__device__ __forceinline__ void publish_ready(int* ready, int p, int epoch,
                                              int cs, int rank, int lane) {
  __syncwarp();
  if (lane < cs) {
    int* f = lane == rank ? ready + p
                          : cg::this_cluster().map_shared_rank(ready + p, lane);
    asm volatile("st.release.cluster.b32 [%0], %1;" ::"l"(f), "r"(epoch)
                 : "memory");
  }
}

__device__ __forceinline__ void wait_ready(const int* ready, int p,
                                           int epoch) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(ready + p);
  int v;
  do {
    asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(a)
                 : "memory");
  } while (v < epoch);
}

// cp.async of one element into shared memory (no register round trip), and
// its commit / wait
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy the pw x pw diagonal block of panel p of the front's lu (stored
// column-major, as the LU returns it) into dst row-major (leading dimension
// HS_C_DG_LD), by one warp; a partial block is padded to 32 x 32 with the
// identity, so the solve needs no bounds.  D is T (an asynchronous copy,
// cp.async) or the accumulator type (float32 and complex64 widened on the
// way, so no conversion sits in the solve's chain).
template <typename T, typename D>
__device__ __forceinline__ void stage_block(const T* __restrict__ A, int ni,
                                            int p, D* dst, int lane) {
  const int p0 = p * HS_C_PANEL;
  const int pw = ni - p0 < HS_C_PANEL ? ni - p0 : HS_C_PANEL;
  const T* src = A + (int64_t)p0 * ni + p0 + lane;  // column j at j ni
  if constexpr (std::is_same<T, D>::value) {
    for (int j = 0; j < HS_C_PANEL; ++j) {
      if (j < pw && lane < pw)
        cp_async_elem(dst + lane * HS_C_DG_LD + j, src + (int64_t)j * ni);
      else
        dst[lane * HS_C_DG_LD + j] = lane == j ? D(1) : D(0);
    }
  } else {
    // the 32 loads issued together, then widened
    T v[HS_C_PANEL];
#pragma unroll
    for (int j = 0; j < HS_C_PANEL; ++j)
      v[j] = j < pw && lane < pw ? hs_ldg(src + (int64_t)j * ni) : T(0);
#pragma unroll
    for (int j = 0; j < HS_C_PANEL; ++j)
      dst[lane * HS_C_DG_LD + j] =
          j < pw && lane < pw ? hs_wide(v[j]) : (lane == j ? D(1) : D(0));
  }
}

// The 32 x 32 block lu[32 P : 32 P + 32, 32 p : 32 p + 32] of a warp's rows
// and panel p's columns (lu column-major: a column's 32 rows are contiguous),
// read coalesced; rows and columns past ni read as 0.  VEC (16-byte loads of
// W rows each, LR = 32 / W): lane g LR + c holds in seg[i W + e] row c W + e
// of column i W + g, so one load instruction covers W columns; else lane r
// holds row r, seg[j] its column j.
template <typename T, bool VEC>
__device__ __forceinline__ void load_seg(const T* __restrict__ A, int ni, int P,
                                         int p, int lane,
                                         T (&seg)[HS_C_PANEL]) {
  const int p0 = p * HS_C_PANEL;
  if constexpr (VEC) {
    constexpr int W = Vec16<T>::n, LR = HS_C_PANEL / W;
    const int g = lane / LR, c = lane % LR;
    const int row = P * HS_C_PANEL + c * W;
    const T* src = A + (int64_t)(p0 + g) * ni + row;
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      if (row < ni && p0 + i * W + g < ni) {
        const Vals16<T> a = load16v(src + (int64_t)i * W * ni);
#pragma unroll
        for (int e = 0; e < W; ++e) seg[i * W + e] = a.v[e];
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) seg[i * W + e] = T(0);
      }
    }
  } else {
    const int row = P * HS_C_PANEL + lane;
    const T* src = A + (int64_t)p0 * ni + row;
#pragma unroll
    for (int j = 0; j < HS_C_PANEL; ++j)
      seg[j] = row < ni && p0 + j < ni ? hs_ldg(src + (int64_t)j * ni) : T(0);
  }
}

// one step of the fold of panel_update: keep half of the values, send the
// other half to lane ^ LANE_OFF, add what it sends back
template <int LANE_OFF, int HALF, int NV, typename T>
__device__ __forceinline__ void fold_stage(T (&v)[NV], int lane) {
  const bool upper = lane & LANE_OFF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T send = upper ? v[i] : v[i + HALF];
    const T keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + hs_shfl_xor(send, LANE_OFF);
  }
}

// The update of one warp's 32 rows by panel p: returns, in lane r, the dot of
// row 32 P + r's segment lu[32 P + r, p0:p0+32] with y[p0:p0+32] (yp[j] =
// y[p0 + j]), seg as
// load_seg lays it out.  VEC: each lane sums its W rows over its columns,
// the W lanes that share rows fold them (log2 W shuffles; lane g LR + c ends
// with row c W + g), and one shuffle brings row r to lane r.
template <typename T, bool VEC>
__device__ __forceinline__ hs_acc_t<T> panel_update(
    const T (&seg)[HS_C_PANEL], const hs_acc_t<T>* yp, int ni, int p0,
    int lane) {
  typedef hs_acc_t<T> Acc;
  if constexpr (VEC) {
    constexpr int W = Vec16<T>::n, LR = HS_C_PANEL / W;
    const int g = lane / LR;
    Acc t[W];
#pragma unroll
    for (int e = 0; e < W; ++e) t[e] = Acc(0);
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      const int col = p0 + i * W + g;
      const Acc y = col < ni ? yp[i * W + g] : Acc(0);
#pragma unroll
      for (int e = 0; e < W; ++e) t[e] += hs_wide(seg[i * W + e]) * y;
    }
    if constexpr (W == 4) {
      fold_stage<16, 2>(t, lane);
      fold_stage<8, 1>(t, lane);
    } else if constexpr (W == 2) {
      fold_stage<16, 1>(t, lane);
    } else {
      return t[0];  // one value a lane: lane r holds row r
    }
    return hs_shfl(t[0], (lane % W) * LR + lane / W);
  } else {
    Acc acc = Acc(0);
#pragma unroll
    for (int j = 0; j < HS_C_PANEL; ++j)
      acc += hs_wide(seg[j]) * (p0 + j < ni ? yp[j] : Acc(0));
    return acc;
  }
}

// The owner warp's solve of its panel's 32 x 32 diagonal block (staged
// identity-padded: no bounds, so its shared-memory reads leave the shuffle
// chain) on the running values v, one lane a row: forward unit lower, else
// upper.
template <typename D, typename Acc>
__device__ __forceinline__ Acc solve_diag(Acc v, const D* dgw, bool fwd,
                                          int lane) {
  if (fwd) {
#pragma unroll
    for (int i = 0; i < HS_C_PANEL; ++i) {
      const Acc yi = hs_shfl(v, i);
      if (lane > i) v -= hs_wide(dgw[lane * HS_C_DG_LD + i]) * yi;
    }
  } else {
    const Acc rd = hs_inv(hs_wide(dgw[lane * HS_C_DG_LD + lane]));
#pragma unroll
    for (int i = HS_C_PANEL - 1; i >= 0; --i) {
      if (lane == i) v *= rd;
      const Acc yi = hs_shfl(v, i);
      if (lane < i) v -= hs_wide(dgw[lane * HS_C_DG_LD + i]) * yi;
    }
  }
  return v;
}

// a solved value into ys[i] of every CTA of the cluster
template <typename Acc>
__device__ __forceinline__ void share_y(Acc* ys, int i, Acc v, int cs,
                                        int rank) {
  ys[i] = v;
  if (cs > 1) {
    cg::cluster_group cl = cg::this_cluster();
    for (int c = 0; c < cs; ++c)
      if (c != rank) cl.map_shared_rank(ys, c)[i] = v;
  }
}

// One direction of the substitution over the panels [p_lo, p_hi) of a front
// (fwd: unit lower, panels in increasing order; else upper, decreasing): warp
// `warp` of CTA `rank` owns panel P (`owner`), lane = row r = 32 P + lane,
// whose running value zr stays in a register; dgw holds P's staged diagonal
// block (its cp.async group is waited for on the first call, `wait_stage`);
// ys receives the solved values, in every CTA of the cluster: row i at
// ys[i - y0] (a window's first row y0; the whole front: 0).
//
// On one CTA (cs = 1), in steps: per panel p the owner of p solves and
// shares y_p, one CTA barrier, and every warp whose rows take p's update
// multiplies its block (loaded one step ahead) by y_p.  The waiting warps
// sleep at the barrier, and a front's few panels leave little to overlap.
template <typename T, bool VEC, typename D>
__device__ __forceinline__ void substitute_steps(
    const T* __restrict__ A, int ni, int p_lo, int p_hi, bool fwd, bool owner,
    int P, int r, int lane, hs_acc_t<T>& zr, hs_acc_t<T>* ys, int y0,
    const D* dgw, int cs, int rank, bool wait_stage) {
  T seg[HS_C_PANEL];
  const int npan = p_hi - p_lo;
  // do panel P's rows take panel p's update in this direction?
  auto takes = [&](int p) { return owner && (fwd ? P > p : P < p); };
  int p = fwd ? p_lo : p_hi - 1;
  if (takes(p)) load_seg<T, VEC>(A, ni, P, p, lane, seg);
  if (owner && wait_stage) {
    cp_async_wait_all();
    __syncwarp();
  }
  for (int st = 0; st < npan; ++st, p += fwd ? 1 : -1) {
    const int p0 = p * HS_C_PANEL;
    if (owner && P == p) {
      zr = solve_diag(zr, dgw, fwd, lane);
      if (lane < min(ni - p0, HS_C_PANEL)) share_y(ys, r - y0, zr, cs, rank);
    }
    front_sync(cs);
    if (takes(p)) zr -= panel_update<T, VEC>(seg, ys + (p0 - y0), ni, p0, lane);
    const int pn = p + (fwd ? 1 : -1);
    if (st + 1 < npan && takes(pn)) load_seg<T, VEC>(A, ni, P, pn, lane, seg);
  }
}

// On a cluster (cs > 1), by signals: the owner of P takes the updates of the
// panels before P in this direction, each as soon as its values are
// published (wait_ready: no barrier over the front, so the critical path
// per panel is one solve, one signal and one block product, and the other
// warps' products run beside it), the next one's block of lu loaded while
// it waits; then it solves its diagonal block and publishes P's values
// (publish_ready).  The block of the updates and the solve's registers are
// live one after the other, not at once.
template <typename T, bool VEC, typename D>
__device__ __forceinline__ void substitute_signals(
    const T* __restrict__ A, int ni, int p_lo, int p_hi, bool fwd, bool owner,
    int P, int r, int lane, hs_acc_t<T>& zr, hs_acc_t<T>* ys, int y0,
    const D* dgw, int cs, int rank, bool wait_stage, int* ready, int epoch) {
  if (!owner) return;  // warp-uniform
  {
    T seg[HS_C_PANEL];
    const int n_take = fwd ? P - p_lo : p_hi - 1 - P;
    const int step = fwd ? 1 : -1;
    int p = fwd ? p_lo : p_hi - 1;
    if (n_take > 0) load_seg<T, VEC>(A, ni, P, p, lane, seg);
    for (int t = 0; t < n_take; ++t, p += step) {
      const int p0 = p * HS_C_PANEL;
      wait_ready(ready, p - p_lo, epoch);
      zr -= panel_update<T, VEC>(seg, ys + (p0 - y0), ni, p0, lane);
      if (t + 1 < n_take) load_seg<T, VEC>(A, ni, P, p + step, lane, seg);
    }
  }
  if (wait_stage) {
    cp_async_wait_all();
    __syncwarp();
  }
  zr = solve_diag(zr, dgw, fwd, lane);
  if (lane < min(ni - P * HS_C_PANEL, HS_C_PANEL))
    share_y(ys, r - y0, zr, cs, rank);
  publish_ready(ready, P - p_lo, epoch, cs, rank, lane);
}

// The type a cluster's diagonal blocks are staged in: complex64 widened to
// complex128, which takes the solve's conversions out of its chain (0.80x
// at the n=512 exact plan's cluster levels on the H100), the other types
// as they are (float32 staged as float64 read 1.05-1.08x there).
template <typename T>
using stage_t =
    typename std::conditional<std::is_same<T, hs_c64>::value, hs_c128, T>::type;

// the forward step's shared memory: ys [ni] in the accumulator type, x [ni]
// in T, then (16-byte aligned) the warps' staged diagonal blocks
template <typename T>
__host__ __device__ __forceinline__ size_t forward_dg_offset(int ni) {
  return ((size_t)ni * (sizeof(hs_acc_t<T>) + sizeof(T)) + 15) & ~(size_t)15;
}

// SIG: the lu form on a cluster (substitute_signals), else the lu form on
// one CTA (substitute_steps) or the dinv form; one instance each, so the
// other forms carry none of the signals' code
template <typename T, bool VEC, bool SIG>
__global__ void __launch_bounds__(HS_C_FWD_MAX)
level_forward_kernel(T* C, const int* __restrict__ int_ids,
                     const int* __restrict__ bnd_ids, const T* __restrict__ L,
                     const T* __restrict__ lu,
                     const long long* __restrict__ perm,
                     const T* __restrict__ dinv, int ni, int nb, int k, int N,
                     int cs) {
  typedef hs_acc_t<T> Acc;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  __shared__ int ready[HS_C_MAX_PANELS];      // substitute's signals
  Acc* ys = reinterpret_cast<Acc*>(hs_smem);  // [ni] solved values
  T* xs = reinterpret_cast<T*>(ys + ni);      // [ni] x
  // [warps][PANEL][DG_LD] diagonal blocks: in stage_t<T> on a cluster
  // (substitute_signals), in T on one CTA (substitute_steps)
  unsigned char* dg = hs_smem + forward_dg_offset<T>(ni);
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t b = blockIdx.x / cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % HS_C_LPR, gi = lane / HS_C_LPR;
  const int nwarps = blockDim.x >> 5;
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  const int* iid = int_ids + b * ni;
  const int* bid = bnd_ids + b * nb;
  const T* A = dinv != nullptr ? dinv + b * ni * ni : lu + b * ni * ni;
  // zeroed before the first front_sync, which every CTA passes before any
  // signal reaches it
  if constexpr (SIG)
    for (int i = threadIdx.x; i < HS_C_MAX_PANELS; i += blockDim.x)
      ready[i] = 0;

  for (int q0 = 0; q0 < k; ++q0) {  // one right-hand side per pass
    for (int i = threadIdx.x; i < ni; i += blockDim.x) {
      const int id = iid[i];
      xs[i] = id < N ? C[(int64_t)id * k + q0] : T(0);
    }
    __syncthreads();

    // C[bnd] -= L x on this CTA's rows of L[b]
    {
      const int cnt = own_count(0, (nb + HS_C_PANEL - 1) / HS_C_PANEL, rank, cs);
      for (int t0 = warp * HS_C_RPW; t0 < cnt; t0 += nwarps * HS_C_RPW) {
        const int r = own_row(t0 + gi, 0, rank, cs);
        Acc acc[HS_C_KMAX] = {};
        if (r < nb)
          group_dot<T, VEC>(L + (b * nb + r) * ni, xs, ni, ni, 1, gl, acc);
        group_sum(acc, 1);
        if (r < nb && gl == 0) {
          const int id = bid[r];
          if (id < N)
            hs_atomic_add(C + (int64_t)id * k + q0, -static_cast<T>(acc[0]));
        }
      }
    }

    const int cnt_all = own_count(0, npan, rank, cs);
    if (dinv != nullptr) {
      front_sync(cs);  // the whole front has read x before x' is written
      for (int t0 = warp * HS_C_RPW; t0 < cnt_all; t0 += nwarps * HS_C_RPW) {
        const int r = own_row(t0 + gi, 0, rank, cs);
        Acc acc[HS_C_KMAX] = {};
        if (r < ni)
          group_dot<T, VEC>(A + (int64_t)r * ni, xs, ni, ni, 1, gl, acc);
        group_sum(acc, 1);
        if (r < ni && gl == 0) {
          const int id = iid[r];
          if (id < N) C[(int64_t)id * k + q0] = static_cast<T>(acc[0]);
        }
      }
    } else {
      // Warp w owns panel P = rank + w cs (CTA rank's w-th panel), one lane
      // per row r = 32 P + lane, whose running value zr stays in a register
      // (see the note at the top for the steps).
      const int npw = own_count(0, npan, rank, cs) / HS_C_PANEL;
      const bool owner = warp < npw;                  // warp-uniform
      const int P = rank + warp * cs;
      const int r = P * HS_C_PANEL + lane;
      const bool row_ok = owner && r < ni;
      stage_t<T>* dga = reinterpret_cast<stage_t<T>*>(dg) + warp * HS_C_DG;
      T* dgt = reinterpret_cast<T*>(dg) + warp * HS_C_DG;
      if (owner) {
        if constexpr (SIG)
          stage_block(A, ni, P, dga, lane);
        else
          stage_block(A, ni, P, dgt, lane);
        cp_async_commit();
      }
      Acc zr = row_ok ? hs_wide(xs[(int)perm[b * ni + r]]) : Acc(0);
      front_sync(cs);  // also: every CTA of the cluster has started
      for (int dir = 0; dir < 2; ++dir) {
        if constexpr (SIG)
          substitute_signals<T, VEC>(A, ni, 0, npan, dir == 0, owner, P, r,
                                     lane, zr, ys, 0, dga, cs, rank, dir == 0,
                                     ready, 2 * q0 + dir + 1);
        else
          substitute_steps<T, VEC>(A, ni, 0, npan, dir == 0, owner, P, r,
                                   lane, zr, ys, 0, dgt, cs, rank, dir == 0);
      }
      if (row_ok) {
        const int id = iid[r];
        if (id < N) C[(int64_t)id * k + q0] = static_cast<T>(zr);
      }
    }
    // the next right-hand side reuses xs and ys; no CTA leaves while others
    // may still store into its shared memory
    front_sync(cs);
  }
}

// ---------------------------------------------------------------------------
// The forward step of a front wider than 2048 rows: one substitution launch
// on a thread block cluster of up to 16 CTAs (non-portable above 8).
//
// A cluster of 8 CTAs of 8 panel warps holds 2048 rows in
// level_forward_kernel.  A wider front's step is a short launch sequence on
// the stream:
//   1. wide_prep_kernel, over the whole card: X = x and Z = x[perm]
//      gathered into scratch [B][k][ni] (the accumulator type), and, in the
//      lu form, every panel's 32 x 32 diagonal block of the unit lower and
//      of the upper factor inverted into the scratch Dinv (one warp a block,
//      a substitution of the identity's columns, in the accumulator type);
//   2. row_dot_kernel, over the whole card: C[bnd] -= L X (with dinv:
//      C[int] = dinv Z, and the step ends);
//   3. wide_solve_kernel: both triangles' substitution, one cluster a front
//      and right-hand side.
// A front of up to wide_window_panels panels (16384 rows in float64 and
// float32, 8192 in the complex types: every front of the repo's plans) is
// one window, so step 3 is one launch for both triangles.  A wider front
// runs in windows of that many panels: per window its substitution alone,
// then window_update_kernel brings the rows after it (forward) or before
// it (backward) up to date by the window's values through Z.
//
// Where each value lives (wide_solve_kernel).  Panel p (rows 32 p to
// 32 p + 31) of a window of npw panels belongs to CTA (p - p_lo) % cs of the
// cluster, as its m-th panel (m = (p - p_lo) / cs), and there to warp m % nw,
// one lane a row.  Each CTA's shared memory holds the window's solved
// values ys [npw][32] (the accumulator type: every CTA a full copy, 8 or 16
// bytes a row), its own panels' running values zs [ceil(npw / cs)][32],
// and one [32][32] slot a warp for the (transposed) inverse of the
// diagonal block of the next panel it solves, copied from Dinv (cp.async)
// while the warp waits for earlier panels.  The blocks of lu that update
// a warp's rows are read from device memory, each once, into registers
// (one block at a time: the loops over a warp's panels are rolled, so
// nothing spills into local memory, which shares the SM's 256 KB with the
// shared memory), a few panels after cp.async.bulk.prefetch.L2 asked for
// them.  At 7944 complex rows that is 127 KB of values, 8 KB of running
// values and five 16 KB slots a CTA.
//
// One panel step.  ys starts as HS_C_UNSET (a signalling NaN: no
// arithmetic returns one) in every CTA.  The owner of panel P applies the
// update of each earlier panel p (in this direction) as soon as y_p is
// there, z -= lu[P rows, p cols] y_p (the block in registers, the lanes
// polling their own words of y_p in their own CTA's ys); after the last one
// it forms y_P = Dinv_P z (32 independent shuffles and four chains of
// multiply-adds, not a 32-step dependent chain) and stores each value into
// every CTA's ys with relaxed cluster-scope stores (the next panel's CTA
// first).  A stored value is its own signal: no flag, no fence, no barrier
// lies between two panels, so a step's critical path is one store across
// the cluster, one 32 x 32 block product and one 32 x 32 inverse product.
// A warp of several panels applies each p to all of its unsolved panels, in
// solve order, and solves the first the moment its last update is in.
// Between the triangles (and right-hand sides) the cluster resets ys behind
// two cluster barriers.  The substitution stays a substitution by blocks:
// the pivot block D is never inverted, only its 32 x 32 diagonal blocks of
// L and U (bounded entries: |L| <= 1 by partial pivoting).
// ---------------------------------------------------------------------------
#define HS_C_WIDE_CS 16    // CTAs of a wide front's cluster, at most
#define HS_C_WIDE_PF 4     // panels ahead whose blocks go to L2
#define HS_C_INV_WARPS 8   // warps of a prep CTA that invert diagonal blocks
#define HS_C_UNSET 0x7ff4c0dec0dec0deULL

// warps of a wide CTA (registers: a complex lane's block takes 64 or 128
// of them) and panels of a window (ys and zs fit beside a few slots)
template <typename T>
__host__ __device__ constexpr int wide_max_warps() {
  return sizeof(hs_acc_t<T>) > 8 ? 8 : 16;
}
template <typename T>
__host__ __device__ constexpr int wide_window_panels() {
  return sizeof(hs_acc_t<T>) > 8 ? 256 : 512;
}

template <typename T>
__global__ void __launch_bounds__(256)
wide_prep_kernel(const T* __restrict__ C, const int* __restrict__ int_ids,
                 const long long* __restrict__ perm, const T* __restrict__ lu,
                 hs_acc_t<T>* X, hs_acc_t<T>* Z, hs_acc_t<T>* Dinv,
                 long long B, int ni, int k, int N, int inv_ctas) {
  typedef hs_acc_t<T> Acc;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  if ((int)blockIdx.x < inv_ctas) {
    // block t = (b 2 + d) npan + p: d = 0 the unit lower factor, 1 the upper
    const int64_t t = (int64_t)blockIdx.x * HS_C_INV_WARPS + warp;
    if (t >= B * 2 * npan) return;  // warp-uniform; no CTA barrier follows
    const int64_t b = t / (2 * npan);
    const int d = (int)(t / npan % 2), p = (int)(t % npan);
    Acc* dg = reinterpret_cast<Acc*>(hs_smem) + warp * HS_C_DG;
    stage_block(lu + b * ni * ni, ni, p, dg, lane);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    // lane j: column j of the block's inverse, row by row
    Acc x[HS_C_PANEL];
    if (d == 0) {
#pragma unroll
      for (int i = 0; i < HS_C_PANEL; ++i) {
        Acc s = i == lane ? Acc(1) : Acc(0);
#pragma unroll
        for (int c = 0; c < i; ++c) s -= dg[i * HS_C_DG_LD + c] * x[c];
        x[i] = s;
      }
    } else {
#pragma unroll
      for (int i = HS_C_PANEL - 1; i >= 0; --i) {
        Acc s = i == lane ? Acc(1) : Acc(0);
#pragma unroll
        for (int c = i + 1; c < HS_C_PANEL; ++c)
          s -= dg[i * HS_C_DG_LD + c] * x[c];
        x[i] = s * hs_inv(dg[i * HS_C_DG_LD + i]);
      }
    }
    // transposed: column j of the inverse at out[32 j, 32 j + 32)
    Acc* out = Dinv + t * (HS_C_PANEL * HS_C_PANEL) + lane * HS_C_PANEL;
#pragma unroll
    for (int i = 0; i < HS_C_PANEL; ++i) out[i] = x[i];
    return;
  }
  const int64_t total = B * (int64_t)k * ni;
  const int64_t stride = (int64_t)(gridDim.x - inv_ctas) * blockDim.x;
  for (int64_t e = (blockIdx.x - inv_ctas) * (int64_t)blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int i = (int)(e % ni);
    const int64_t bq = e / ni;
    const int q = (int)(bq % k);
    const int64_t b = bq / k;
    const int id = int_ids[b * ni + i];
    X[e] = id < N ? hs_wide(C[(int64_t)id * k + q]) : Acc(0);
    const int j = perm != nullptr ? (int)perm[b * ni + i] : i;
    const int idp = int_ids[b * ni + j];
    Z[e] = idp < N ? hs_wide(C[(int64_t)idp * k + q]) : Acc(0);
  }
}

// C[ids[b][r]][q] -= M[b][r] . v[b][q] (store: =), M [B][R][ni] row-major,
// v [B][k][ni] (hs_acc_t); ids >= N skipped; one CTA per (front, chunk of
// rows)
template <typename T, bool VEC>
__global__ void __launch_bounds__(HS_C_THREADS)
row_dot_kernel(T* C, const int* __restrict__ ids, const T* __restrict__ M,
               const hs_acc_t<T>* v, int R, int ni, int k, int N, int split,
               int store) {
  const int64_t b = blockIdx.x / split;
  const int per = (R + split - 1) / split;
  const int r_lo = (int)(blockIdx.x % split) * per;
  const int r_hi = r_lo + per < R ? r_lo + per : R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % HS_C_LPR, gi = lane / HS_C_LPR;
  const int nwarps = blockDim.x >> 5;
  for (int q = 0; q < k; ++q) {
    for (int t0 = r_lo + warp * HS_C_RPW; t0 < r_hi; t0 += nwarps * HS_C_RPW) {
      const int r = t0 + gi;
      const int id = r < r_hi ? ids[b * R + r] : N;
      hs_acc_t<T> acc[HS_C_KMAX] = {};
      if (id < N)
        group_dot<T, VEC>(M + (b * R + r) * ni, v + (b * k + q) * ni, 0, ni,
                          1, gl, acc);
      group_sum(acc, 1);
      if (id < N && gl == 0) {
        if (store)
          C[(int64_t)id * k + q] = static_cast<T>(acc[0]);
        else
          hs_atomic_add(C + (int64_t)id * k + q, -static_cast<T>(acc[0]));
      }
    }
  }
}

// a value's 8-byte words: a double one, a complex128 two (each stored and
// polled on its own: a relaxed access of 8 bytes is single-copy atomic)
__device__ __forceinline__ void put_word(void* p, unsigned long long v) {
  asm volatile("st.relaxed.cluster.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void put_value(double* p, double v) {
  put_word(p, (unsigned long long)__double_as_longlong(v));
}

__device__ __forceinline__ void put_value(hs_c128* p, hs_c128 v) {
  put_word(&p->re, (unsigned long long)__double_as_longlong(v.re));
  put_word(&p->im, (unsigned long long)__double_as_longlong(v.im));
}

// spin until this CTA's word at p is no longer HS_C_UNSET (a fault that
// stops the chain traps after some seconds rather than hanging the card)
__device__ __forceinline__ void wait_word(const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned long long v;
  long long spins = 0;
  do {
    asm volatile("ld.relaxed.cluster.shared::cta.b64 %0, [%1];"
                 : "=l"(v)
                 : "r"(a)
                 : "memory");
    if (++spins > (1LL << 28)) __trap();
  } while (v == HS_C_UNSET);
}

__device__ __forceinline__ void wait_value(const double* p) { wait_word(p); }

__device__ __forceinline__ void wait_value(const hs_c128* p) {
  wait_word(&p->re);
  wait_word(&p->im);
}

// y_P into ys[i] of every CTA of the cluster, the next panel's CTA first
template <typename Acc>
__device__ __forceinline__ void publish_y(Acc* ys, int i, Acc v, int cs,
                                          int rank) {
  cg::cluster_group cl = cg::this_cluster();
  for (int c = 1; c <= cs; ++c)
    put_value(cl.map_shared_rank(ys, (rank + c) % cs) + i, v);
}

// ys[0, n) = HS_C_UNSET, by the CTA's threads
template <typename Acc>
__device__ __forceinline__ void unset_values(Acc* ys, int n) {
  unsigned long long* w = reinterpret_cast<unsigned long long*>(ys);
  const int words = n * (int)(sizeof(Acc) / 8);
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = HS_C_UNSET;
}

// the inverse of a diagonal block (transposed, 32 x 32 in Dinv) into a
// warp's [32][32] slot, asynchronously; waited for before the solve
template <typename Acc>
__device__ __forceinline__ void stage_inverse(Acc* slot, const Acc* src,
                                              int lane) {
#pragma unroll 4
  for (int e = 0; e < HS_C_PANEL; ++e)
    cp_async_elem(slot + e * HS_C_PANEL + lane, src + e * HS_C_PANEL + lane);
  cp_async_commit();
}

// lane r: row r of the staged inverse (its column r of the transposed
// slot: the lanes read consecutive words) times the panel's running values
template <typename Acc>
__device__ __forceinline__ Acc inverse_apply(const Acc* slot, Acc z,
                                             int lane) {
  Acc a[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
#pragma unroll
  for (int c = 0; c < HS_C_PANEL; ++c)
    a[c & 3] += slot[c * HS_C_PANEL + lane] * hs_shfl(z, c);
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// the block lu[P rows, p cols] (column-major: 32 columns of 32 contiguous
// rows) asked of L2 ahead of its use, one bulk prefetch a lane and column
template <typename T>
__device__ __forceinline__ void prefetch_block(const T* A, int ni, int P,
                                               int p, int lane) {
  const int col = p * HS_C_PANEL + lane;
  if ((P + 1) * HS_C_PANEL > ni || col >= ni) return;
  const T* src = A + (int64_t)col * ni + P * HS_C_PANEL;
  if (reinterpret_cast<uintptr_t>(src) & 15u) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src),
               "r"((unsigned)(HS_C_PANEL * sizeof(T)))
               : "memory");
}

// One direction of a window's substitution for one warp of CTA `rank`: its
// panels P_j = p_lo + rank + cs (warp + nw j) (j < npj) over the window's
// panels [p_lo, p_hi), their running values in zs[(warp + nw j) 32 + lane]
// (in: the direction's right-hand side, out: its solution); dinv the
// direction's inverted diagonal blocks (panel p's transposed at dinv +
// 1024 p).  Rolled loops: one block of lu in registers at a time.
template <typename T, bool VEC, bool FWD>
__device__ __forceinline__ void wide_direction(
    const T* __restrict__ A, const hs_acc_t<T>* __restrict__ dinv, int ni,
    int p_lo, int p_hi, int rank, int cs, int warp, int nw, int npj, int lane,
    hs_acc_t<T>* ys, hs_acc_t<T>* zs, hs_acc_t<T>* slot) {
  typedef hs_acc_t<T> Acc;
  if (npj == 0) return;  // warp-uniform
  const int step = FWD ? 1 : -1;
  const int first = FWD ? p_lo : p_hi - 1;
  auto panel = [&](int j) { return p_lo + rank + cs * (warp + nw * j); };
  auto zrow = [&](int j) { return zs + (warp + nw * j) * HS_C_PANEL; };
  int nxt = FWD ? 0 : npj - 1;  // the warp's next panel to solve
  stage_inverse(slot, dinv + (int64_t)panel(nxt) * 1024, lane);
  // panel j's updates are all in: y = Dinv zr, published
  auto solve = [&](int j) {
    cp_async_wait_all();
    __syncwarp();
    const int P = panel(j);
    const Acc y = inverse_apply(slot, zrow(j)[lane], lane);
    zrow(j)[lane] = y;
    if (P * HS_C_PANEL + lane < ni)
      publish_y(ys, (P - p_lo) * HS_C_PANEL + lane, y, cs, rank);
    __syncwarp();  // the slot read; this CTA's ys written for the warp
    nxt += step;
    if (nxt >= 0 && nxt < npj)
      stage_inverse(slot, dinv + (int64_t)panel(nxt) * 1024, lane);
  };
  if (panel(nxt) == first) solve(nxt);  // the first panel takes no update
  for (int p = first; nxt >= 0 && nxt < npj; p += step) {
    const int p0 = p * HS_C_PANEL;
    // the unsolved panels (all past p), in solve order
    const int j0 = nxt, cnt = FWD ? npj - nxt : nxt + 1;
#pragma unroll 1
    for (int t = 0; t < cnt; ++t) {
      const int j = FWD ? j0 + t : j0 - t;
      const int P = panel(j);
      T seg[HS_C_PANEL];
      load_seg<T, VEC>(A, ni, P, p, lane, seg);
      if (t == 0) {  // y_p there
        if (p0 + lane < ni) wait_value(ys + (p - p_lo) * HS_C_PANEL + lane);
        __syncwarp();
      }
      zrow(j)[lane] -= panel_update<T, VEC>(seg, ys + (p - p_lo) * HS_C_PANEL,
                                            ni, p0, lane);
      const int pf = p + HS_C_WIDE_PF * step;
      if (FWD ? pf < P : pf > P) prefetch_block(A, ni, P, pf, lane);
      if (t == 0 && P == p + step) solve(j);
    }
  }
}

// A window's substitution, panels [p_lo, p_hi) of front b and right-hand
// side blockIdx.y, on a cluster of cs CTAs of nw = blockDim.x / 32 warps
// (see the note above): dirs bit 0 the forward (unit lower) triangle, bit
// 1 the backward (upper) one.  z comes from Z; store_z writes the result
// back to Z (a window of several), the backward triangle also to C[int].
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * wide_max_warps<T>(), 1)
wide_solve_kernel(hs_acc_t<T>* Z, const T* __restrict__ lu,
                  const hs_acc_t<T>* __restrict__ Dinv, T* C,
                  const int* __restrict__ int_ids, int ni, int k, int N,
                  int p_lo, int p_hi, int dirs, int store_z, int cs) {
  typedef hs_acc_t<T> Acc;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  const int npw = p_hi - p_lo, nw = blockDim.x >> 5;
  const int per = (npw + cs - 1) / cs;         // panels of one CTA, at most
  Acc* ys = reinterpret_cast<Acc*>(hs_smem);  // [npw][32] solved values
  Acc* zs = ys + npw * HS_C_PANEL;            // [per][32] running values
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int64_t b = blockIdx.x / cs;
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  Acc* slot = zs + per * HS_C_PANEL + warp * HS_C_PANEL * HS_C_PANEL;
  const T* A = lu + b * ni * ni;
  // this CTA's panels: window panel rank + cs m, m < mine; warp w's m = w +
  // nw j
  const int mine = rank < npw ? (npw - 1 - rank) / cs + 1 : 0;
  const int npj = warp < mine ? (mine - 1 - warp) / nw + 1 : 0;
  Acc* zb = Z + (b * k + q) * ni;
  for (int m = warp; m < mine; m += nw) {
    const int r = (p_lo + rank + cs * m) * HS_C_PANEL + lane;
    zs[m * HS_C_PANEL + lane] = r < ni ? zb[r] : Acc(0);
  }
  unset_values(ys, npw * HS_C_PANEL);
  cl.sync();  // also: every CTA of the cluster has started
  if (dirs & 1)
    wide_direction<T, VEC, true>(A, Dinv + (b * 2) * npan * 1024LL, ni, p_lo,
                                 p_hi, rank, cs, warp, nw, npj, lane, ys, zs,
                                 slot);
  if (dirs == 3) {  // every read of the forward values done, then reset
    cl.sync();
    unset_values(ys, npw * HS_C_PANEL);
    cl.sync();
  }
  if (dirs & 2)
    wide_direction<T, VEC, false>(A, Dinv + (b * 2 + 1) * npan * 1024LL, ni,
                                  p_lo, p_hi, rank, cs, warp, nw, npj, lane,
                                  ys, zs, slot);
  for (int m = warp; m < mine; m += nw) {
    const int r = (p_lo + rank + cs * m) * HS_C_PANEL + lane;
    if (r < ni) {
      const Acc v = zs[m * HS_C_PANEL + lane];
      if (store_z) zb[r] = v;
      if (dirs & 2) {
        const int id = int_ids[b * ni + r];
        if (id < N) C[(int64_t)id * k + q] = static_cast<T>(v);
      }
    }
  }
  cl.sync();  // no CTA leaves while others may still store into its ys
}

// Z[b][q][r_lo:r_hi] -= lu[r_lo:r_hi, c_lo:c_hi] Z[b][q][c_lo:c_hi] (lu
// column-major): one CTA per (front, 32 rows), lane = row, warp w sums its
// eighth of the columns in order; the eight partial sums are added in warp
// order, so the result does not depend on scheduling.
template <typename T>
__global__ void __launch_bounds__(256)
window_update_kernel(hs_acc_t<T>* Z, const T* __restrict__ lu, int ni, int k,
                     int r_lo, int r_hi, int c_lo, int c_hi, int tiles) {
  typedef hs_acc_t<T> Acc;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  Acc* zs = reinterpret_cast<Acc*>(hs_smem);  // [c_hi - c_lo]
  __shared__ Acc part[8][32];
  const int64_t b = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = c_hi - c_lo;
  Acc* zb = Z + (b * k + q) * ni;
  for (int c = threadIdx.x; c < nc; c += blockDim.x) zs[c] = zb[c_lo + c];
  __syncthreads();
  const int row = r_lo + tile * 32 + lane;
  const int per = (nc + 7) / 8;
  const int c0 = warp * per, c1 = c0 + per < nc ? c0 + per : nc;
  Acc acc = Acc(0);
  if (row < r_hi) {
    const T* col = lu + b * ni * ni + (int64_t)(c_lo + c0) * ni + row;
    for (int c = c0; c < c1; ++c, col += ni) acc += hs_wide(hs_ldg(col)) * zs[c];
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && row < r_hi) {
    Acc s = part[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) s += part[w][lane];
    zb[row] -= s;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(HS_C_THREADS)
sweep_update_kernel(T* C, const int* __restrict__ ids_out,
                    const T* __restrict__ M, const int* __restrict__ ids_in,
                    int R, int Cc, int k, int N, int split) {
  extern __shared__ __align__(16) unsigned char hs_smem[];
  T* ys = reinterpret_cast<T*>(hs_smem);  // [kmax][Cc] C[ids_in[b]]
  const int64_t b = blockIdx.x / split;
  const int per = (R + split - 1) / split;
  const int r_lo = (int)(blockIdx.x % split) * per;
  const int r_hi = r_lo + per < R ? r_lo + per : R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % HS_C_LPR, gi = lane / HS_C_LPR;
  const int nwarps = blockDim.x >> 5;
  const int* iin = ids_in + b * Cc;
  const int* iout = ids_out + b * R;
  for (int k0 = 0; k0 < k; k0 += HS_C_KMAX) {
    const int kc = k - k0 < HS_C_KMAX ? k - k0 : HS_C_KMAX;
    for (int t = threadIdx.x; t < kc * Cc; t += blockDim.x) {
      const int q = t / Cc, c = t - q * Cc;
      const int id = iin[c];
      ys[q * Cc + c] = id < N ? C[(int64_t)id * k + k0 + q] : T(0);
    }
    __syncthreads();
    for (int t0 = r_lo + warp * HS_C_RPW; t0 < r_hi;
         t0 += nwarps * HS_C_RPW) {
      const int r = t0 + gi;
      const int id = r < r_hi ? iout[r] : N;
      hs_acc_t<T> acc[HS_C_KMAX] = {};
      if (id < N)  // padded output rows skip their row of M
        group_dot<T, VEC>(M + (b * R + r) * Cc, ys, Cc, Cc, kc, gl, acc);
      group_sum(acc, kc);
      if (id < N && gl == 0) {
#pragma unroll
        for (int q = 0; q < HS_C_KMAX; ++q)
          if (q < kc) {
            T* out = C + (int64_t)id * k + k0 + q;
            *out = *out - static_cast<T>(acc[q]);
          }
      }
    }
    __syncthreads();
  }
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// raise the kernel's dynamic shared memory limit once, to what it asks for
template <typename K>
static cudaError_t allow_smem(K kern, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

template <typename T, bool VEC>
static cudaError_t launch_forward(T* C, const int* int_ids, const int* bnd_ids,
                                  const T* L, const T* lu,
                                  const long long* perm, const T* dinv,
                                  long long B, int ni, int nb, int k, int N,
                                  int cs, cudaStream_t stream) {
  static size_t granted_steps = 0, granted_signals = 0;
  // one warp per panel of the CTA (at most HS_C_MAX_PW), at least 2: a
  // front of few panels takes a small CTA, so several share an SM
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  const int pw_cta = (npan + cs - 1) / cs;
  if (pw_cta > HS_C_MAX_PW) return cudaErrorInvalidValue;
  const int warps = pw_cta > 2 ? pw_cta : 2;
  const int threads = 32 * warps;
  // the lu form on a cluster substitutes by signals; the other forms by
  // steps (the dinv form does not substitute), and so does float32 on a
  // cluster, whose signals read 1.18x the steps' at the n=512 exact plan's
  // cluster levels on the H100
  const bool sig = cs > 1 && dinv == nullptr && !std::is_same<T, float>::value;
  const size_t smem =
      forward_dg_offset<T>(ni) +
      (size_t)warps * HS_C_DG * (sig ? sizeof(stage_t<T>) : sizeof(T));
  auto kern = sig ? level_forward_kernel<T, VEC, true>
                  : level_forward_kernel<T, VEC, false>;
  cudaError_t err =
      allow_smem(kern, smem, sig ? &granted_signals : &granted_steps);
  if (err != cudaSuccess) return err;
  if (cs == 1) {
    kern<<<(unsigned)B, threads, smem, stream>>>(
        C, int_ids, bnd_ids, L, lu, perm, dinv, ni, nb, k, N, cs);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, C, int_ids, bnd_ids, L, lu, perm, dinv,
                           ni, nb, k, N, cs);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// The launch of a window of npw panels (ops/sweep.py forward_wide_launch
// mirrors it): a cluster of cs = min(cs_max, npw) CTAs, each of nw warps
// (as many as its panels, within wide_max_warps and what shared memory
// leaves beside the window's solved values and the CTA's running values:
// one inverse slot a warp), in smem bytes.
template <typename T>
static bool wide_launch(int npw, int cs_max, int* cs, int* nw, size_t* smem) {
  const size_t acc = sizeof(hs_acc_t<T>);
  if (npw < 1 || cs_max < 1 || cs_max > HS_C_WIDE_CS) return false;
  *cs = npw < cs_max ? npw : cs_max;
  const int per = (npw + *cs - 1) / *cs;
  const size_t fixed = (size_t)(npw + per) * HS_C_PANEL * acc;
  const size_t slot = (size_t)HS_C_PANEL * HS_C_PANEL * acc;
  if (fixed + slot > 232448) return false;
  int w = wide_max_warps<T>();
  const int fit = (int)((232448 - fixed) / slot);
  if (fit < w) w = fit;
  if (per < w) w = per;
  *nw = w;
  *smem = fixed + (size_t)w * slot;
  return true;
}

static cudaLaunchConfig_t wide_config(int cs, int nw, size_t smem,
                                      long long B, int k, cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs), (unsigned)k);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the solve kernel's attributes: its shared memory, and clusters above 8
template <typename T, bool VEC>
static cudaError_t wide_attributes(size_t smem) {
  static size_t granted = 0;
  static bool nonportable = false;
  auto kern = wide_solve_kernel<T, VEC>;
  cudaError_t err = allow_smem(kern, smem, &granted);
  if (err != cudaSuccess || nonportable) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) nonportable = true;
  return err;
}

// how many clusters of a window of npw panels at cs_max the card holds at
// once (cudaOccupancyMaxActiveClusters; 0: none, -1: the query failed)
template <typename T>
static int wide_clusters(int npw, int cs_max) {
  int cs, nw;
  size_t smem;
  if (!wide_launch<T>(npw, cs_max, &cs, &nw, &smem)) return 0;
  if (wide_attributes<T, true>(smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config(cs, nw, smem, 1, 1, nullptr, attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, wide_solve_kernel<T, true>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return count;
}

template <typename T, bool VEC>
static cudaError_t launch_windowed(T* C, const int* int_ids, const int* bnd_ids,
                                   const T* L, const T* lu,
                                   const long long* perm, const T* dinv,
                                   hs_acc_t<T>* X, hs_acc_t<T>* Z,
                                   hs_acc_t<T>* Dinv, long long B, int ni,
                                   int nb, int k, int N, int cs_max,
                                   cudaStream_t stream) {
  typedef hs_acc_t<T> Acc;
  static size_t granted_prep = 0, granted_update = 0;
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  const int wpan = wide_window_panels<T>();
  const int nwin = (npan + wpan - 1) / wpan;
  // every window's launch first: a refused one launches nothing
  int cs[2], nw[2];
  size_t smem[2];
  for (int w = 0; w < 2; ++w) {
    const int npw = w == 0 ? (npan < wpan ? npan : wpan) : npan - (nwin - 1) * wpan;
    if (dinv == nullptr &&
        !wide_launch<T>(npw, cs_max, &cs[w], &nw[w], &smem[w]))
      return cudaErrorInvalidValue;
  }
  cudaError_t err;
  const int64_t total = B * (int64_t)k * ni;
  const int gather = (int)(total / 256 + 1 < 8192 ? total / 256 + 1 : 8192);
  const int inv_ctas =
      dinv != nullptr ? 0 : (int)((B * 2 * npan + HS_C_INV_WARPS - 1) /
                                  HS_C_INV_WARPS);
  const size_t smem_prep =
      inv_ctas > 0 ? (size_t)HS_C_INV_WARPS * HS_C_DG * sizeof(Acc) : 0;
  if ((err = allow_smem(wide_prep_kernel<T>, smem_prep, &granted_prep)) !=
      cudaSuccess)
    return err;
  wide_prep_kernel<T><<<(unsigned)(inv_ctas + gather), 256, smem_prep,
                        stream>>>(C, int_ids, dinv != nullptr ? nullptr : perm,
                                  lu, X, Z, Dinv, B, ni, k, N, inv_ctas);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nb > 0) {
    const int split = (nb + HS_C_PANEL - 1) / HS_C_PANEL;
    row_dot_kernel<T, VEC><<<(unsigned)(B * split), HS_C_THREADS, 0, stream>>>(
        C, bnd_ids, L, X, nb, ni, k, N, split, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (dinv != nullptr) {
    const int split = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
    row_dot_kernel<T, VEC><<<(unsigned)(B * split), HS_C_THREADS, 0, stream>>>(
        C, int_ids, dinv, Z, ni, ni, k, N, split, 1);
    return cudaGetLastError();
  }
  for (int w = 0; w < 2; ++w)
    if ((err = wide_attributes<T, VEC>(smem[w])) != cudaSuccess) return err;
  if (nwin > 1 &&
      (err = allow_smem(window_update_kernel<T>,
                        (size_t)wpan * HS_C_PANEL * sizeof(Acc),
                        &granted_update)) != cudaSuccess)
    return err;
  auto solve = wide_solve_kernel<T, VEC>;
  for (int dir = 0; dir < 2; ++dir) {
    for (int s = 0; s < nwin; ++s) {
      const int w = dir == 0 ? s : nwin - 1 - s;
      const int g = w == nwin - 1 ? 1 : 0;  // the last window's launch
      const int p_lo = w * wpan, p_hi = p_lo + wpan < npan ? p_lo + wpan : npan;
      const int dirs = nwin == 1 ? 3 : 1 << dir;
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t cfg =
          wide_config(cs[g], nw[g], smem[g], B, k, stream, attr);
      err = cudaLaunchKernelEx(&cfg, solve, Z, lu, (const Acc*)Dinv, C,
                               int_ids, ni, k, N, p_lo, p_hi, dirs,
                               (int)(nwin > 1), cs[g]);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      if (nwin == 1) return cudaSuccess;  // both triangles in one launch
      // the rows the window's values update: after it (forward), before it
      // (backward)
      const int c_lo = p_lo * HS_C_PANEL;
      const int c_hi = p_hi * HS_C_PANEL < ni ? p_hi * HS_C_PANEL : ni;
      const int r_lo = dir == 0 ? c_hi : 0, r_hi = dir == 0 ? ni : c_lo;
      if (r_hi > r_lo) {
        const int tiles = (r_hi - r_lo + 31) / 32;
        window_update_kernel<T><<<dim3((unsigned)(B * tiles), (unsigned)k),
                                  256, (size_t)(c_hi - c_lo) * sizeof(Acc),
                                  stream>>>(
            Z, lu, ni, k, r_lo, r_hi, c_lo, c_hi, tiles);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
    }
  }
  return cudaSuccess;
}

template <typename T>
static int level_forward_windowed(void* C, const void* int_ids,
                                  const void* bnd_ids, const void* L,
                                  const void* lu, const void* perm,
                                  const void* dinv, void* X, void* Z,
                                  void* Dinv, long long B, int ni, int nb,
                                  int k, int N, int cs_max, void* stream) {
  if (B < 0 || ni < 0 || nb < 0 || k < 1 || X == nullptr || Z == nullptr ||
      (dinv == nullptr &&
       (lu == nullptr || perm == nullptr || Dinv == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ni == 0) return (int)cudaSuccess;
  const T* A = dinv != nullptr ? (const T*)dinv : (const T*)lu;
  const bool vec = ni % Vec16<T>::n == 0 && aligned16(L) && aligned16(A);
  auto run = vec ? &launch_windowed<T, true> : &launch_windowed<T, false>;
  return (int)run((T*)C, (const int*)int_ids, (const int*)bnd_ids,
                  (const T*)L, (const T*)lu, (const long long*)perm,
                  (const T*)dinv, (hs_acc_t<T>*)X, (hs_acc_t<T>*)Z,
                  (hs_acc_t<T>*)Dinv, B, ni, nb, k, N, cs_max,
                  (cudaStream_t)stream);
}

template <typename T>
static int level_forward(void* C, const void* int_ids, const void* bnd_ids,
                         const void* L, const void* lu, const void* perm,
                         const void* dinv, long long B, int ni, int nb, int k,
                         int N, int cs, void* stream) {
  if (B < 0 || ni < 0 || nb < 0 || k < 1 || cs < 1 || cs > 8 ||
      (dinv == nullptr && (lu == nullptr || perm == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ni == 0) return (int)cudaSuccess;
  const T* A = dinv != nullptr ? (const T*)dinv : (const T*)lu;
  if (ni % Vec16<T>::n == 0 && aligned16(L) && aligned16(A))
    return (int)launch_forward<T, true>(
        (T*)C, (const int*)int_ids, (const int*)bnd_ids, (const T*)L,
        (const T*)lu, (const long long*)perm, (const T*)dinv, B, ni, nb, k, N,
        cs, (cudaStream_t)stream);
  return (int)launch_forward<T, false>(
      (T*)C, (const int*)int_ids, (const int*)bnd_ids, (const T*)L,
      (const T*)lu, (const long long*)perm, (const T*)dinv, B, ni, nb, k, N,
      cs, (cudaStream_t)stream);
}

template <typename T, bool VEC>
static cudaError_t launch_backward(T* C, const int* ids_out, const T* M,
                                   const int* ids_in, long long B, int R,
                                   int Cc, int k, int N, int split,
                                   cudaStream_t stream) {
  static size_t granted = 0;
  const int kmax = k < HS_C_KMAX ? k : HS_C_KMAX;
  const size_t smem = (size_t)kmax * Cc * sizeof(T);
  auto kern = sweep_update_kernel<T, VEC>;
  const cudaError_t err = allow_smem(kern, smem, &granted);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)(B * split), HS_C_THREADS, smem, stream>>>(
      C, ids_out, M, ids_in, R, Cc, k, N, split);
  return cudaGetLastError();
}

template <typename T>
static int sweep_update(void* C, const void* ids_out, const void* M,
                        const void* ids_in, long long B, int R, int Cc, int k,
                        int N, int split, void* stream) {
  if (B < 0 || R < 0 || Cc < 0 || k < 1 || split < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0 || Cc == 0) return (int)cudaSuccess;
  if (Cc % Vec16<T>::n == 0 && aligned16(M))
    return (int)launch_backward<T, true>(
        (T*)C, (const int*)ids_out, (const T*)M, (const int*)ids_in, B, R, Cc,
        k, N, split, (cudaStream_t)stream);
  return (int)launch_backward<T, false>(
      (T*)C, (const int*)ids_out, (const T*)M, (const int*)ids_in, B, R, Cc, k,
      N, split, (cudaStream_t)stream);
}

HS_EXPORT int hs_level_forward(void* C, const void* int_ids,
                               const void* bnd_ids, const void* L,
                               const void* lu, const void* perm,
                               const void* dinv, long long B, int ni, int nb,
                               int k, int N, int cs, void* stream) {
  return level_forward<double>(C, int_ids, bnd_ids, L, lu, perm, dinv, B, ni,
                               nb, k, N, cs, stream);
}

HS_EXPORT int hs_level_forward_f32(void* C, const void* int_ids,
                                   const void* bnd_ids, const void* L,
                                   const void* lu, const void* perm,
                                   const void* dinv, long long B, int ni,
                                   int nb, int k, int N, int cs, void* stream) {
  return level_forward<float>(C, int_ids, bnd_ids, L, lu, perm, dinv, B, ni,
                              nb, k, N, cs, stream);
}

HS_EXPORT int hs_level_forward_windowed(void* C, const void* int_ids,
                                        const void* bnd_ids, const void* L,
                                        const void* lu, const void* perm,
                                        const void* dinv, void* X, void* Z,
                                        void* Dinv, long long B, int ni,
                                        int nb, int k, int N, int cs_max,
                                        void* stream) {
  return level_forward_windowed<double>(C, int_ids, bnd_ids, L, lu, perm, dinv,
                                        X, Z, Dinv, B, ni, nb, k, N, cs_max,
                                        stream);
}

HS_EXPORT int hs_level_forward_windowed_f32(void* C, const void* int_ids,
                                            const void* bnd_ids, const void* L,
                                            const void* lu, const void* perm,
                                            const void* dinv, void* X, void* Z,
                                            void* Dinv, long long B, int ni,
                                            int nb, int k, int N, int cs_max,
                                            void* stream) {
  return level_forward_windowed<float>(C, int_ids, bnd_ids, L, lu, perm, dinv,
                                       X, Z, Dinv, B, ni, nb, k, N, cs_max,
                                       stream);
}

// clusters of a wide window of npw panels the card holds at once
HS_EXPORT int hs_level_forward_wide_clusters(int npw, int cs_max) {
  return wide_clusters<double>(npw, cs_max);
}

HS_EXPORT int hs_level_forward_wide_clusters_f32(int npw, int cs_max) {
  return wide_clusters<float>(npw, cs_max);
}

HS_EXPORT int hs_sweep_update(void* C, const void* ids_out, const void* M,
                              const void* ids_in, long long B, int R, int Cc,
                              int k, int N, int split, void* stream) {
  return sweep_update<double>(C, ids_out, M, ids_in, B, R, Cc, k, N, split,
                              stream);
}

HS_EXPORT int hs_sweep_update_f32(void* C, const void* ids_out, const void* M,
                                  const void* ids_in, long long B, int R,
                                  int Cc, int k, int N, int split,
                                  void* stream) {
  return sweep_update<float>(C, ids_out, M, ids_in, B, R, Cc, k, N, split,
                             stream);
}

// the complex types (the damped Helmholtz system's exact factors)
#define HS_C_EXPORTS(SFX, T)                                                   \
  HS_EXPORT int hs_level_forward##SFX(                                         \
      void* C, const void* int_ids, const void* bnd_ids, const void* L,        \
      const void* lu, const void* perm, const void* dinv, long long B, int ni, \
      int nb, int k, int N, int cs, void* stream) {                            \
    return level_forward<T>(C, int_ids, bnd_ids, L, lu, perm, dinv, B, ni, nb, \
                            k, N, cs, stream);                                 \
  }                                                                            \
  HS_EXPORT int hs_level_forward_windowed##SFX(                                \
      void* C, const void* int_ids, const void* bnd_ids, const void* L,        \
      const void* lu, const void* perm, const void* dinv, void* X, void* Z,    \
      void* Dinv, long long B, int ni, int nb, int k, int N, int cs_max,       \
      void* stream) {                                                          \
    return level_forward_windowed<T>(C, int_ids, bnd_ids, L, lu, perm, dinv,   \
                                     X, Z, Dinv, B, ni, nb, k, N, cs_max,      \
                                     stream);                                  \
  }                                                                            \
  HS_EXPORT int hs_level_forward_wide_clusters##SFX(int npw, int cs_max) {     \
    return wide_clusters<T>(npw, cs_max);                                      \
  }                                                                            \
  HS_EXPORT int hs_sweep_update##SFX(void* C, const void* ids_out,             \
                                     const void* M, const void* ids_in,        \
                                     long long B, int R, int Cc, int k, int N, \
                                     int split, void* stream) {                \
    return sweep_update<T>(C, ids_out, M, ids_in, B, R, Cc, k, N, split,       \
                           stream);                                            \
  }
HS_C_EXPORTS(_c128, hs_c128)
HS_C_EXPORTS(_c64, hs_c64)
