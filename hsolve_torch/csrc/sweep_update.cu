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
// eight staged 32 x 33 blocks of 16 bytes), inside the 227 KB a CTA has.
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
// running value in a register.  Per panel step p (forward, then backward):
//   - the owner warp of panel p solves its 32 x 32 diagonal block (staged in
//     shared memory once per launch, identity-padded so the unrolled solve
//     has no bounds) with one shuffle and one multiply-add per row, and
//     publishes the solved values in ys;
//   - one barrier;
//   - every warp whose rows take panel p's update multiplies its 32 x 32
//     block lu[rows, p cols] by y_p.  The block was loaded one step ahead,
//     coalesced: lu is column-major (as the LU returns it, so the factor
//     makes no copy), a 16-byte load covers W = 4 (float) or 2 (double) rows
//     of a column, and a warp issues 8 or 16 loads for the block.  A fold
//     over the W lanes that share rows (log2 W shuffles) and one permuting
//     shuffle leave each row's sum in its lane.
// lu[b] is read once.  A front of up to 8 panels (ni_pad <= 256) runs on one
// CTA of up to 8 warps with CTA barriers; a wider one on a thread block
// cluster of ceil(panels / 8) CTAs (the wrapper picks it per level, at most
// 8): CTA c owns the panels p with p % cs == c, stores y_p into every CTA's
// ys through distributed shared memory, and the step's barrier is the
// cluster's.  The rows of L[b] and dinv[b] are split the same way.  A front
// wider than 8 CTAs' 2048 rows runs in windows (launch_windowed, below).
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

template <typename T>
using Vec16 = hs_vec16<T>;

// one 16-byte read-only load of Vec16<T>::n values
template <typename T>
__device__ __forceinline__ void load16(const T* p, T* o) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  memcpy(o, &v, 16);
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
      T a[W];
      load16(row + c, a);
#pragma unroll
      for (int q = 0; q < HS_C_KMAX; ++q) {
        if (q < kc) {
#pragma unroll
          for (int e = 0; e < W; ++e)
            acc[q] += hs_wide(a[e]) * hs_wide(v[q * vstride + c + e]);
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
// HS_C_DG_LD), asynchronously, by one warp; a partial block is padded to
// 32 x 32 with the identity, so the solve needs no bounds.
template <typename T>
__device__ __forceinline__ void stage_block(const T* __restrict__ A, int ni,
                                            int p, T* dst, int lane) {
  const int p0 = p * HS_C_PANEL;
  const int pw = ni - p0 < HS_C_PANEL ? ni - p0 : HS_C_PANEL;
  for (int j = 0; j < HS_C_PANEL; ++j) {
    if (j < pw && lane < pw)
      cp_async_elem(dst + lane * HS_C_DG_LD + j,
                    A + (int64_t)(p0 + j) * ni + p0 + lane);
    else
      dst[lane * HS_C_DG_LD + j] = lane == j ? T(1) : T(0);
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
        load16(src + (int64_t)i * W * ni, seg + i * W);
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

// One direction of the substitution over the panels [p_lo, p_hi) of a front
// (fwd: unit lower, panels in increasing order; else upper, decreasing): warp
// `warp` of CTA `rank` owns panel P (`owner`), lane = row r = 32 P + lane,
// whose running value zr stays in a register; dgw holds P's staged diagonal
// block (its cp.async group is waited for on the first call, `wait_stage`);
// ys receives the solved values, in every CTA of the cluster: row i at
// ys[i - y0] (a window's first row y0; the whole front: 0).
template <typename T, bool VEC>
__device__ __forceinline__ void substitute(const T* __restrict__ A, int ni,
                                           int p_lo, int p_hi, bool fwd,
                                           bool owner, int P, int r, int lane,
                                           hs_acc_t<T>& zr, hs_acc_t<T>* ys,
                                           int y0,
                                           const T* dgw,
                                           int cs, int rank, bool wait_stage) {
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
    const int pw = ni - p0 < HS_C_PANEL ? ni - p0 : HS_C_PANEL;
    if (owner && P == p) {
      // the staged block is 32 x 32 (identity-padded): no bounds, so its
      // shared-memory reads leave the shuffle chain
      hs_acc_t<T> v = zr;
      if (fwd) {
#pragma unroll
        for (int i = 0; i < HS_C_PANEL; ++i) {
          const hs_acc_t<T> yi = hs_shfl(v, i);
          if (lane > i) v -= hs_wide(dgw[lane * HS_C_DG_LD + i]) * yi;
        }
      } else {
        const hs_acc_t<T> rd = hs_inv(hs_wide(dgw[lane * HS_C_DG_LD + lane]));
#pragma unroll
        for (int i = HS_C_PANEL - 1; i >= 0; --i) {
          if (lane == i) v *= rd;
          const hs_acc_t<T> yi = hs_shfl(v, i);
          if (lane < i) v -= hs_wide(dgw[lane * HS_C_DG_LD + i]) * yi;
        }
      }
      zr = v;
      if (lane < pw) {
        ys[r - y0] = v;
        if (cs > 1) {
          cg::cluster_group cl = cg::this_cluster();
          for (int c = 0; c < cs; ++c)
            if (c != rank) cl.map_shared_rank(ys, c)[r - y0] = v;
        }
      }
    }
    front_sync(cs);
    if (takes(p)) zr -= panel_update<T, VEC>(seg, ys + (p0 - y0), ni, p0, lane);
    const int pn = p + (fwd ? 1 : -1);
    if (st + 1 < npan && takes(pn)) load_seg<T, VEC>(A, ni, P, pn, lane, seg);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(HS_C_FWD_MAX)
level_forward_kernel(T* C, const int* __restrict__ int_ids,
                     const int* __restrict__ bnd_ids, const T* __restrict__ L,
                     const T* __restrict__ lu,
                     const long long* __restrict__ perm,
                     const T* __restrict__ dinv, int ni, int nb, int k, int N,
                     int cs) {
  typedef hs_acc_t<T> Acc;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  Acc* ys = reinterpret_cast<Acc*>(hs_smem);  // [ni] solved values
  T* xs = reinterpret_cast<T*>(ys + ni);      // [ni] x
  T* dg = xs + ni;  // [warps][PANEL][DG_LD] diag blocks
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t b = blockIdx.x / cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % HS_C_LPR, gi = lane / HS_C_LPR;
  const int nwarps = blockDim.x >> 5;
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  const int* iid = int_ids + b * ni;
  const int* bid = bnd_ids + b * nb;
  const T* A = dinv != nullptr ? dinv + b * ni * ni : lu + b * ni * ni;

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
      T* dgw = dg + warp * HS_C_DG;
      if (owner) {
        stage_block(A, ni, P, dgw, lane);
        cp_async_commit();
      }
      Acc zr = row_ok ? hs_wide(xs[(int)perm[b * ni + r]]) : Acc(0);
      front_sync(cs);  // also: every CTA of the cluster has started
      for (int dir = 0; dir < 2; ++dir)
        substitute<T, VEC>(A, ni, 0, npan, dir == 0, owner, P, r, lane, zr, ys, 0,
                           dgw, cs, rank, dir == 0);
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
// The forward step of a front wider than HS_C_WIN rows, in windows.
//
// A cluster holds at most 8 CTAs of 8 panel warps: 2048 rows.  A wider front
// is cut into windows of at most HS_C_WIN rows, and the step runs as a
// sequence of launches on the stream: gather (x and z = x[perm] into the
// scratch X, Z [B][k][ni]), the update C[bnd] -= L x (row_dot_kernel), then
// per window in order the window's substitution on its cluster
// (window_solve_kernel: the panels of the window only, z in and out of Z)
// and the update of the rows after it (unit lower, forward) or before it
// (upper, backward) by the window's solved values (window_update_kernel:
// z[rows] -= lu[rows, window] z[window], parallel over 32-row tiles and bound
// by the bytes of lu).  The backward window writes its final rows to C[int].
// With dinv the substitution is one row_dot_kernel, C[int] = dinv z.
// ---------------------------------------------------------------------------
#define HS_C_WIN (HS_C_PANEL * HS_C_MAX_PW * 8)  // rows per window: 2048

template <typename T>
__global__ void fwd_gather_kernel(const T* __restrict__ C,
                                  const int* __restrict__ int_ids,
                                  const long long* __restrict__ perm,
                                  hs_acc_t<T>* X, hs_acc_t<T>* Z, long long B,
                                  int ni, int k, int N) {
  const int64_t total = B * (int64_t)k * ni;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int i = (int)(e % ni);
    const int64_t bq = e / ni;
    const int q = (int)(bq % k);
    const int64_t b = bq / k;
    const int id = int_ids[b * ni + i];
    X[e] = id < N ? hs_wide(C[(int64_t)id * k + q]) : hs_acc_t<T>(0);
    const int j = perm != nullptr ? (int)perm[b * ni + i] : i;
    const int idp = int_ids[b * ni + j];
    Z[e] = idp < N ? hs_wide(C[(int64_t)idp * k + q]) : hs_acc_t<T>(0);
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

// One window's substitution: panels [p_lo, p_hi) of front b, right-hand side
// blockIdx.y, on a cluster of cs CTAs (the panel ownership of
// level_forward_kernel); z comes from and goes back to Z, and the backward
// pass also stores its final rows in C[int].
template <typename T, bool VEC>
__global__ void __launch_bounds__(HS_C_FWD_MAX)
window_solve_kernel(hs_acc_t<T>* Z, const T* __restrict__ lu, T* C,
                    const int* __restrict__ int_ids, int ni, int k, int N,
                    int p_lo, int p_hi, int fwd, int cs) {
  typedef hs_acc_t<T> Acc;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  Acc* ys = reinterpret_cast<Acc*>(hs_smem);  // [HS_C_WIN] its values
  T* dg = reinterpret_cast<T*>(ys + HS_C_WIN);  // [warps][PANEL][DG_LD]
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t b = blockIdx.x / cs;
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* A = lu + b * ni * ni;
  const int npw = own_count(p_lo, p_hi, rank, cs) / HS_C_PANEL;
  const bool owner = warp < npw;                  // warp-uniform
  const int P = first_own(p_lo, rank, cs) + warp * cs;
  const int r = P * HS_C_PANEL + lane;
  const bool row_ok = owner && r < ni;
  T* dgw = dg + warp * HS_C_DG;
  if (owner) {
    stage_block(A, ni, P, dgw, lane);
    cp_async_commit();
  }
  Acc* zb = Z + (b * k + q) * ni;
  Acc zr = row_ok ? zb[r] : Acc(0);
  front_sync(cs);  // also: every CTA of the cluster has started
  substitute<T, VEC>(A, ni, p_lo, p_hi, fwd != 0, owner, P, r, lane, zr, ys,
                     p_lo * HS_C_PANEL,
                     dgw, cs, rank, true);
  if (row_ok) {
    zb[r] = zr;
    const int id = int_ids[b * ni + r];
    if (!fwd && id < N) C[(int64_t)id * k + q] = static_cast<T>(zr);
  }
  front_sync(cs);  // no CTA leaves while others may still store into its ys
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
  static size_t granted = 0;
  // one warp per panel of the CTA (at most HS_C_MAX_PW), at least 2: a
  // front of few panels takes a small CTA, so several share an SM
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  const int pw_cta = (npan + cs - 1) / cs;
  if (pw_cta > HS_C_MAX_PW) return cudaErrorInvalidValue;
  const int warps = pw_cta > 2 ? pw_cta : 2;
  const int threads = 32 * warps;
  const size_t smem = (size_t)ni * sizeof(hs_acc_t<T>) +
                      (size_t)(ni + warps * HS_C_DG) * sizeof(T);
  auto kern = level_forward_kernel<T, VEC>;
  cudaError_t err = allow_smem(kern, smem, &granted);
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

template <typename T, bool VEC>
static cudaError_t launch_windowed(T* C, const int* int_ids, const int* bnd_ids,
                                   const T* L, const T* lu,
                                   const long long* perm, const T* dinv,
                                   hs_acc_t<T>* X, hs_acc_t<T>* Z, long long B,
                                   int ni, int nb, int k, int N,
                                   cudaStream_t stream) {
  static size_t granted_solve = 0, granted_update = 0;
  const int64_t total = B * (int64_t)k * ni;
  const unsigned gblocks = (unsigned)(total / 256 + 1 < 8192 ? total / 256 + 1
                                                              : 8192);
  fwd_gather_kernel<T><<<gblocks, 256, 0, stream>>>(
      C, int_ids, dinv != nullptr ? nullptr : perm, X, Z, B, ni, k, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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
  const int npan = (ni + HS_C_PANEL - 1) / HS_C_PANEL;
  const int wpan = HS_C_WIN / HS_C_PANEL;
  const int nwin = (npan + wpan - 1) / wpan;
  // the window's solved values only: the same whatever ni
  const size_t smem_solve = (size_t)HS_C_WIN * sizeof(hs_acc_t<T>) +
                            (size_t)HS_C_MAX_PW * HS_C_DG * sizeof(T);
  auto solve = window_solve_kernel<T, VEC>;
  if ((err = allow_smem(solve, smem_solve, &granted_solve)) != cudaSuccess)
    return err;
  const size_t smem_update = (size_t)HS_C_WIN * sizeof(hs_acc_t<T>);
  auto update = window_update_kernel<T>;
  if ((err = allow_smem(update, smem_update, &granted_update)) != cudaSuccess)
    return err;
  for (int dir = 0; dir < 2; ++dir) {
    for (int s = 0; s < nwin; ++s) {
      const int w = dir == 0 ? s : nwin - 1 - s;
      const int p_lo = w * wpan, p_hi = p_lo + wpan < npan ? p_lo + wpan : npan;
      const int cs = (p_hi - p_lo + HS_C_MAX_PW - 1) / HS_C_MAX_PW;
      const int pw_cta = (p_hi - p_lo + cs - 1) / cs;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)(B * cs), (unsigned)k);
      cfg.blockDim = dim3(32 * (pw_cta > 2 ? pw_cta : 2));
      cfg.dynamicSmemBytes = smem_solve;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)cs;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, solve, Z, lu, C, int_ids, ni, k, N, p_lo,
                               p_hi, dir == 0, cs);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      // the rows the window's values update: after it (forward), before it
      // (backward)
      const int c_lo = p_lo * HS_C_PANEL;
      const int c_hi = p_hi * HS_C_PANEL < ni ? p_hi * HS_C_PANEL : ni;
      const int r_lo = dir == 0 ? c_hi : 0, r_hi = dir == 0 ? ni : c_lo;
      if (r_hi > r_lo) {
        const int tiles = (r_hi - r_lo + 31) / 32;
        update<<<dim3((unsigned)(B * tiles), (unsigned)k), 256,
                 (size_t)(c_hi - c_lo) * sizeof(hs_acc_t<T>), stream>>>(
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
                                  long long B, int ni, int nb, int k, int N,
                                  void* stream) {
  if (B < 0 || ni < 0 || nb < 0 || k < 1 || X == nullptr || Z == nullptr ||
      (dinv == nullptr && (lu == nullptr || perm == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ni == 0) return (int)cudaSuccess;
  const T* A = dinv != nullptr ? (const T*)dinv : (const T*)lu;
  if (ni % Vec16<T>::n == 0 && aligned16(L) && aligned16(A))
    return (int)launch_windowed<T, true>(
        (T*)C, (const int*)int_ids, (const int*)bnd_ids, (const T*)L,
        (const T*)lu, (const long long*)perm, (const T*)dinv,
        (hs_acc_t<T>*)X, (hs_acc_t<T>*)Z, B, ni, nb, k, N,
        (cudaStream_t)stream);
  return (int)launch_windowed<T, false>(
      (T*)C, (const int*)int_ids, (const int*)bnd_ids, (const T*)L,
      (const T*)lu, (const long long*)perm, (const T*)dinv, (hs_acc_t<T>*)X,
      (hs_acc_t<T>*)Z, B, ni, nb, k, N, (cudaStream_t)stream);
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
                                        long long B, int ni, int nb, int k,
                                        int N, void* stream) {
  return level_forward_windowed<double>(C, int_ids, bnd_ids, L, lu, perm, dinv,
                                        X, Z, B, ni, nb, k, N, stream);
}

HS_EXPORT int hs_level_forward_windowed_f32(void* C, const void* int_ids,
                                            const void* bnd_ids, const void* L,
                                            const void* lu, const void* perm,
                                            const void* dinv, void* X, void* Z,
                                            long long B, int ni, int nb, int k,
                                            int N, void* stream) {
  return level_forward_windowed<float>(C, int_ids, bnd_ids, L, lu, perm, dinv,
                                       X, Z, B, ni, nb, k, N, stream);
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
      long long B, int ni, int nb, int k, int N, void* stream) {               \
    return level_forward_windowed<T>(C, int_ids, bnd_ids, L, lu, perm, dinv,   \
                                     X, Z, B, ni, nb, k, N, stream);           \
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
