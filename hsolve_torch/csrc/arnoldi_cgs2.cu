// Kernel L: the CGS2 orthogonalization of one Arnoldi step, one launch, and
// with it (`hs_arnoldi_step`) the rest of the step: kernel M's Givens
// bookkeeping and the scaling of w into V[j+1].
//
// Replaces the classical Gram-Schmidt, applied twice, of hsolve/krylov.py
// `_gmres_cycles.inner_body` (:231-237), which XLA lowered as two GEMV pairs
// and a norm over the basis V [m+1, N]:
//
//     h1 = V[:R] w,  w -= V[:R]^T h1,  h2 = V[:R] w,  w -= V[:R]^T h2
//     hc[:R] = h1 + h2,  hc[R] = ||w||                    (R = j + 1)
//
// and, in `hs_arnoldi_step`, `V[j+1] = w / hnorm` (:238) with the Givens
// step, `inner_cond` (:269-273) and the cycle end (arnoldi_givens.cuh).
// The step reads its loop state from device memory (gmres_loop.cuh: j, it,
// maxiter and the cycle's floor), so that a CUDA graph can replay it under a
// WHILE node: R = j + 1 is read at the kernel's start, the tail evaluates
// `inner_cond` for the next step (j + 1 < m, the estimate above the floor,
// it + j + 1 < maxiter) into the loop's done flag and advances j.
// Instantiated for double and float (`_f32`: the inner cycles of
// mixed-precision GMRES).
//
// Bound: bytes for the passes (a step must read the R rows of V and w and
// write V[j+1]; four multiply-adds per value of V), latency for the tail
// (M's dependent chains, arnoldi_givens.cuh).
//
// Design: one persistent cooperative launch (cudaLaunchCooperativeKernel;
// the grid, one CTA per SM, is co-resident or the launch is refused) with
// grid barriers on one counter, the ticket.  CTA b owns the contiguous
// slice [b S, (b+1) S) of N (S a multiple of 4, so a slice starts on a
// 16-byte boundary wherever its row does) and keeps that slice of w in
// shared memory for the whole step: w is read once.
//   1. partial dots of V[:R] with w -> P1 [R, G]; the first Rs rows of the
//      slice are staged in shared memory on the way (Rs: as many as fit);
//   barrier; every CTA sums P1 in one fixed order, so all hold the same h1
//   bit for bit;
//   2. w -= V^T h1 on the slice, then the partial dots of the new w -> P2;
//   barrier; h2 the same way;
//   3. w -= V^T h2, ||w||^2 partials -> P3 [G].
// Kernel L alone (`hs_arnoldi_cgs2`): the slice of w is written back; the
// last CTA to finish (the ticket) sums P3 in a fixed order, writes hc[R] =
// ||w|| and re-arms the ticket; CTA 0 writes hc[:R] = h1 + h2.
// The step (`hs_arnoldi_step`): a third barrier; every CTA sums P3 in the
// same fixed order, so all hold ||w|| bit for bit, and writes its slice of
// V[j+1] = w / ||w|| (1 where ||w|| is 0) from shared memory, and the same
// slice to `vj`, the fixed buffer the next step's preconditioner reads (w
// itself is not written back: the GMRES loop reads only V[j+1]).  Its
// shared memory is sized for R = m, the most rows a step can have.  The
// CTA that arrived last at the third barrier writes hc and runs kernel M's
// step in its warp 0 on the column, h1 + h2 and ||w||, already in its
// shared memory, with its slice of w's buffer as M's scratch (H[:J, :J]
// staged there where it fits: always at the restarts GMRES uses, J <= 30),
// then advances j.  Each CTA then counts its exit on the ticket; the last
// one out re-arms it.
// The staged rows come from shared memory after pass 1; the others are swept
// in alternating directions so that the rows read last are still in L2.  V
// is read with 16-byte loads along N: a row whose start is not 16-byte
// aligned (N odd) takes two aligned loads per chunk and a shift.  Each thread
// keeps several rows of V in flight (independent accumulators).  The ticket
// is 0 at rest, G after barrier 1, 2G after barrier 2, 3G after barrier 3
// (or when L alone's last CTA resets it), 4G when the step's last CTA out
// resets it.  Nothing goes to the host.
#include "arnoldi_givens.cuh"
#include "gmres_loop.cuh"

#define HS_CGS2_THREADS 512
#define HS_CGS2_WARPS (HS_CGS2_THREADS / 32)
#define HS_CGS2_MAX_ROWS 512
#define HS_CGS2_ROW_BATCH 64     // rows per block reduction of the dots
#define HS_CGS2_SMEM 230400      // dynamic shared memory per CTA, bytes

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  static constexpr int n = 2;
};
template <>
struct Vec16<float> {
  static constexpr int n = 4;
};

// W-wide shared-memory chunk <-> registers (one 16-byte access)
__device__ __forceinline__ void sload(const double* p, double (&o)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  o[0] = a.x;
  o[1] = a.y;
}

__device__ __forceinline__ void sload(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void sstore(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__device__ __forceinline__ void sstore(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// V[i, e0:e0+W] (e0 a multiple of W; entries past N read as 0).  The shift
// s = (i N) mod W is the same for every thread of a row; rows i < R <= m
// have a next row, so the second aligned load stays inside V.
__device__ __forceinline__ void load_chunk(const double* __restrict__ V,
                                           int64_t N, int i, int64_t e0,
                                           double (&o)[2]) {
  const int64_t f = (int64_t)i * N + e0;
  if (e0 + 2 <= N) {
    if ((f & 1) == 0) {
      const double2 a = __ldg(reinterpret_cast<const double2*>(V + f));
      o[0] = a.x;
      o[1] = a.y;
    } else {
      const double2 a = __ldg(reinterpret_cast<const double2*>(V + f - 1));
      const double2 c = __ldg(reinterpret_cast<const double2*>(V + f + 1));
      o[0] = a.y;
      o[1] = c.x;
    }
  } else {
    o[0] = e0 < N ? V[f] : 0.0;
    o[1] = 0.0;
  }
}

__device__ __forceinline__ void load_chunk(const float* __restrict__ V,
                                           int64_t N, int i, int64_t e0,
                                           float (&o)[4]) {
  const int64_t f = (int64_t)i * N + e0;
  if (e0 + 4 <= N) {
    const int s = (int)(f & 3);
    const float4 a = __ldg(reinterpret_cast<const float4*>(V + f - s));
    if (s == 0) {
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
      return;
    }
    const float4 c = __ldg(reinterpret_cast<const float4*>(V + f - s + 4));
    if (s == 1) {
      o[0] = a.y; o[1] = a.z; o[2] = a.w; o[3] = c.x;
    } else if (s == 2) {
      o[0] = a.z; o[1] = a.w; o[2] = c.x; o[3] = c.y;
    } else {
      o[0] = a.w; o[1] = c.x; o[2] = c.y; o[3] = c.z;
    }
  } else {
    for (int e = 0; e < 4; ++e) o[e] = e0 + e < N ? V[f + e] : 0.0f;
  }
}

// wait until `target` CTAs have arrived on the counter (co-residency is
// guaranteed by the cooperative launch); true in the CTA that arrived last
__device__ __forceinline__ bool grid_sync(unsigned* ticket, unsigned target) {
  __shared__ bool arrived_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    arrived_last = atomicAdd(ticket, 1u) == target - 1u;
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(ticket) : "memory");
    } while (seen < target);
  }
  __syncthreads();
  return arrived_last;
}

// h[i] = sum_b P[i * G + b], one warp per row, the same order in every CTA
template <typename T>
__device__ void sum_partials(const T* P, int G, int R, T* h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < R; i += HS_CGS2_WARPS) {
    T acc = T(0);
    for (int b = lane; b < G; b += 32) acc += __ldcg(P + (int64_t)i * G + b);
    acc = warp_sum(acc);
    if (lane == 0) h[i] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(HS_CGS2_THREADS, 1)
arnoldi_cgs2_kernel(const T* __restrict__ V, T* __restrict__ w,
                    T* __restrict__ hc, T* __restrict__ part,
                    unsigned* __restrict__ ticket, int R_arg, int64_t N,
                    int S, int Rs_max, GivensArgs<T> p, int* loop,
                    const T* __restrict__ floor, T* __restrict__ vj) {
  constexpr int W = Vec16<T>::n;
  extern __shared__ __align__(16) unsigned char hs_smem[];
  T* h1 = reinterpret_cast<T*>(hs_smem);            // [MAX_ROWS]
  T* h2 = h1 + HS_CGS2_MAX_ROWS;                    // [MAX_ROWS]
  T* red = h2 + HS_CGS2_MAX_ROWS;                   // [ROW_BATCH][WARPS]
  T* ws = red + HS_CGS2_ROW_BATCH * HS_CGS2_WARPS;  // [S] the slice of w
  T* stage = ws + S;                                // [Rs][S] rows of V
  __shared__ bool last;
  __shared__ T hnorm;
  const bool step = loop != nullptr;                // M's tail and V[j+1]
  // the step's rows: j + 1, read once (the tail advances j after every CTA
  // has passed the third barrier)
  const int R = step ? __ldcg(loop + HS_LOOP_J) + 1 : R_arg;
  const int Rs = R < Rs_max ? R : Rs_max;
  T* Vn = step ? const_cast<T*>(V) + (int64_t)R * N : nullptr;
  const int G = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t lo = (int64_t)blockIdx.x * S;
  const int len = N - lo < S ? (N - lo > 0 ? (int)(N - lo) : 0) : S;
  const int nch = (len + W - 1) / W;               // W-wide chunks of the slice
  T* P1 = part;
  T* P2 = part + (int64_t)R * G;
  T* P3 = part + 2 * (int64_t)R * G;

  for (int t = threadIdx.x; t < nch * W; t += HS_CGS2_THREADS)
    ws[t] = t < len ? w[lo + t] : T(0);
  __syncthreads();

  // chunk c of row i: staged rows from shared memory after pass 1
  auto get = [&](int i, int c, bool first, T (&v)[W]) {
    T* st = stage + (int64_t)i * S + c * W;
    if (i < Rs && !first) {
      sload(st, v);
    } else {
      load_chunk(V, N, i, lo + (int64_t)c * W, v);
      if (i < Rs) sstore(st, v);
    }
  };

  // P[i, blockIdx] = V[i, slice] . ws for every row (ascending)
  auto dots = [&](T* P, bool first) {
    for (int i0 = 0; i0 < R; i0 += HS_CGS2_ROW_BATCH) {
      const int nr = R - i0 < HS_CGS2_ROW_BATCH ? R - i0 : HS_CGS2_ROW_BATCH;
      for (int ii = 0; ii < nr; ii += 4) {
        T acc[4] = {T(0), T(0), T(0), T(0)};
        for (int c = threadIdx.x; c < nch; c += HS_CGS2_THREADS) {
          T x[W];
          sload(ws + c * W, x);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (ii + u < nr) {
              T v[W];
              get(i0 + ii + u, c, first, v);
#pragma unroll
              for (int e = 0; e < W; ++e) acc[u] += v[e] * x[e];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const T s = warp_sum(acc[u]);
          if (lane == 0 && ii + u < nr) red[(ii + u) * HS_CGS2_WARPS + warp] = s;
        }
      }
      __syncthreads();
      for (int ii = threadIdx.x; ii < nr; ii += HS_CGS2_THREADS) {
        T s = T(0);
        for (int k = 0; k < HS_CGS2_WARPS; ++k) s += red[ii * HS_CGS2_WARPS + k];
        P[(int64_t)(i0 + ii) * G + blockIdx.x] = s;
      }
      __syncthreads();
    }
  };

  // ws -= V[:R, slice]^T h (rows descending), returns this thread's ||ws||^2
  auto update = [&](const T* h) {
    T sq = T(0);
    for (int c = threadIdx.x; c < nch; c += HS_CGS2_THREADS) {
      T acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = T(0);
      for (int t = 0; t < R; t += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (t + u < R) {
            const int i = R - 1 - (t + u);
            T v[W];
            get(i, c, false, v);
            const T hi = h[i];
#pragma unroll
            for (int e = 0; e < W; ++e) acc[e] += v[e] * hi;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const T wn = ws[c * W + e] - acc[e];
        ws[c * W + e] = wn;
        sq += wn * wn;
      }
    }
    return sq;
  };

  dots(P1, true);
  grid_sync(ticket, (unsigned)G);
  sum_partials(P1, G, R, h1);
  update(h1);
  dots(P2, false);
  grid_sync(ticket, 2u * (unsigned)G);
  sum_partials(P2, G, R, h2);
  T sq = update(h2);
  __syncthreads();
  if (!step)
    for (int t = threadIdx.x; t < len; t += HS_CGS2_THREADS) w[lo + t] = ws[t];
  sq = warp_sum(sq);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int k = 0; k < HS_CGS2_WARPS; ++k) s += red[k];
    P3[blockIdx.x] = s;
  }

  if (!step) {
    // kernel L alone: the last CTA writes ||w|| and re-arms the ticket
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < R; i += HS_CGS2_THREADS)
        hc[i] = h1[i] + h2[i];
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(ticket, 1u) == 3u * (unsigned)G - 1u;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (warp == 0) {
      T s = T(0);
      for (int b = lane; b < G; b += 32) s += __ldcg(P3 + b);
      s = warp_sum(s);
      if (lane == 0) {
        hc[R] = sqrt(s);
        *ticket = 0u;
      }
    }
    return;
  }

  // the step: every CTA sums P3 alike, so all hold ||w|| bit for bit
  const bool tail = grid_sync(ticket, 3u * (unsigned)G);
  if (warp == 0) {
    T s = T(0);
    for (int b = lane; b < G; b += 32) s += __ldcg(P3 + b);
    s = warp_sum(s);
    if (lane == 0) hnorm = sqrt(s);
  }
  __syncthreads();
  const T hn = hnorm;
  const T dv = hn > T(0) ? hn : T(1);
  for (int t = threadIdx.x; t < len; t += HS_CGS2_THREADS) {
    const T v = div_rn(ws[t], dv);
    Vn[lo + t] = v;
    vj[lo + t] = v;
  }
  if (tail) {
    // the column h1 + h2, ||w|| in place of h1 (zero up to m), written to
    // hc; then M's step in warp 0, w's buffer its scratch
    T* col = h1;
    for (int i = threadIdx.x; i <= p.m; i += HS_CGS2_THREADS) {
      const T v = i < R ? h1[i] + h2[i] : (i == R ? hn : T(0));
      col[i] = v;
      if (i <= R) hc[i] = v;
    }
    __syncthreads();
    if (warp == 0) {
      // inner_cond for the next step, from the loop state
      const int j = R - 1;
      GivensArgs<T> q = p;
      q.floor = *floor;
      q.cont = j + 1 < p.m && loop[HS_LOOP_IT] + j + 1 < loop[HS_LOOP_MAXITER];
      givens_step(col, ws, q, j);
      if (lane == 0) loop[HS_LOOP_J] = R;
    }
  }
  // the last CTA out re-arms the ticket
  if (threadIdx.x == 0 &&
      atomicAdd(ticket, 1u) == 4u * (unsigned)G - 1u)
    *ticket = 0u;
}

// the slice of N per CTA: ceil(N / G) rounded up to a multiple of 4
static inline long long cgs2_slice(long long N, int G) {
  const long long s = (N + G - 1) / G;
  return (s + 3) / 4 * 4;
}

// Kernel L's launch.  Alone: R rows, w written back.  With `tail` (the
// step): R is the most rows a step of the loop state `loop` can have (m),
// the kernel reads its own from `loop`, runs M's step and writes V[j+1] =
// w / ||w|| to V and `vj` (w not written back)
template <typename T>
static int arnoldi_cgs2(const void* V, void* w, void* hc, void* part,
                        void* ticket, int R, long long N, int G,
                        const GivensArgs<T>* tail, int* loop,
                        const void* floor, void* vj, void* stream) {
  if (R < 1 || R > HS_CGS2_MAX_ROWS || G < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (tail && (tail->m < 1 || tail->m > HS_GIVENS_MAX_M || R > tail->m ||
               !loop || !floor || !vj))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(V) & 15u)
    return (int)cudaErrorMisalignedAddress;
  const long long e = (long long)sizeof(T);
  const long long S = cgs2_slice(N, G);
  const long long small = 2 * HS_CGS2_MAX_ROWS + HS_CGS2_ROW_BATCH * HS_CGS2_WARPS;
  const long long fixed = (small + S) * e;
  if (fixed > HS_CGS2_SMEM) return (int)cudaErrorInvalidValue;
  long long rs = (HS_CGS2_SMEM - fixed) / (S * e);
  if (rs > R) rs = R;
  long long smem = fixed + rs * S * e;
  GivensArgs<T> p = {};
  if (tail) {
    // M's scratch lives in w's buffer and past it: stage H[:J, :J] where
    // the CTA's shared memory holds it at the largest J
    p = *tail;
    p.h_smem = (small + givens_smem_values(p.m, R, true)) * e <= HS_CGS2_SMEM;
    const long long need = (small + givens_smem_values(p.m, R, p.h_smem)) * e;
    if (need > smem) smem = need;
  }
  auto kern = arnoldi_cgs2_kernel<T>;
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, HS_CGS2_SMEM);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  const T* Vp = (const T*)V;
  T* wp = (T*)w;
  T* hcp = (T*)hc;
  T* pp = (T*)part;
  unsigned* tp = (unsigned*)ticket;
  const T* fp = (const T*)floor;
  T* vjp = (T*)vj;
  int64_t N64 = N;
  int Si = (int)S, Rsi = (int)rs;
  void* args[] = {&Vp, &wp, &hcp, &pp, &tp, &R, &N64, &Si, &Rsi, &p, &loop,
                  &fp, &vjp};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kern, dim3(G), dim3(HS_CGS2_THREADS), args, (size_t)smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_arnoldi_cgs2(const void* V, void* w, void* hc, void* part,
                              void* ticket, int R, long long N, int nb,
                              void* stream) {
  return arnoldi_cgs2<double>(V, w, hc, part, ticket, R, N, nb, nullptr,
                              nullptr, nullptr, nullptr, stream);
}

HS_EXPORT int hs_arnoldi_cgs2_f32(const void* V, void* w, void* hc,
                                  void* part, void* ticket, int R,
                                  long long N, int nb, void* stream) {
  return arnoldi_cgs2<float>(V, w, hc, part, ticket, R, N, nb, nullptr,
                             nullptr, nullptr, nullptr, stream);
}

// One Arnoldi step of the loop state `loop` (gmres_loop.cuh; j = loop[J]):
// L's passes, V[j+1] (and `vj`), M's step against `*floor`, loop[DONE] and
// j + 1
template <typename T>
static int arnoldi_step(const void* V, void* w, void* hc, void* part,
                        void* ticket, void* H, void* cs, void* sn, void* g,
                        void* st, void* y, void* vj, void* loop,
                        const void* floor, long long N, int nb, int m,
                        void* stream) {
  int* lp = (int*)loop;
  const GivensArgs<T> p = {(T*)H, (T*)cs, (T*)sn, (T*)g, (T*)st,
                           lp ? lp + HS_LOOP_DONE : nullptr, (T*)y, m, T(0),
                           0, 0};
  return arnoldi_cgs2<T>(V, w, hc, part, ticket, m, N, nb, &p, lp, floor, vj,
                         stream);
}

HS_EXPORT int hs_arnoldi_step(const void* V, void* w, void* hc, void* part,
                              void* ticket, void* H, void* cs, void* sn,
                              void* g, void* st, void* y, void* vj,
                              void* loop, const void* floor, long long N,
                              int nb, int m, void* stream) {
  return arnoldi_step<double>(V, w, hc, part, ticket, H, cs, sn, g, st, y, vj,
                              loop, floor, N, nb, m, stream);
}

HS_EXPORT int hs_arnoldi_step_f32(const void* V, void* w, void* hc,
                                  void* part, void* ticket, void* H, void* cs,
                                  void* sn, void* g, void* st, void* y,
                                  void* vj, void* loop, const void* floor,
                                  long long N, int nb, int m, void* stream) {
  return arnoldi_step<float>(V, w, hc, part, ticket, H, cs, sn, g, st, y, vj,
                             loop, floor, N, nb, m, stream);
}
