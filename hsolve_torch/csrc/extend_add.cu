// Kernel B: extend-add of one child group into a batch of fronts.
//
// Replaces hsolve/factor.py `_stage_children` (:432-464) + `_extend_add_impl`
// (:390-403).  The JAX code first copies the children's Schur complements into
// a zero-padded [B, s_pad, s_pad] staging buffer and then gathers from it;
// this kernel reads straight from the source batch's Schur stack S [Bs, w, w]:
//
//     for k < G, r = dst_rows[k], s = src_rows[k], i, j < m:
//       front[r, i, j] += S[s, imap[r, i], imap[r, j]]
//       only where 0 <= imap[r, i] < w and 0 <= imap[r, j] < w
//
// An index inside the planner's s_pad but outside the source width w adds 0,
// exactly what the zero padding of the staging buffer gave.  Rows of the front
// that belong to no group are untouched (the staging buffer held zeros there).
// The caller launches the left groups before the right ones, as JAX adds them;
// each entry gets one add per launch, so the result is bitwise the plain
// version's.  Instantiated for double (`hs_extend_add`), float
// (`hs_extend_add_f32`) and the complex types (`_c128`, `_c64`), which add
// one value (16 or 8 bytes, one load) at a time: a complex add is the two
// real adds torch's is, so the result stays bitwise too.
//
// Bound: memory (one read of the child's Schur entries a group covers, one
// read-modify-write of the front entries).  The first design ran one
// 128-thread CTA per (group, front row): at the n=512 exact plan's batch 1
// (1024 fronts of 96 rows) 196,608 CTAs, of which only the 21-44 rows a
// child covers did any work, the rest exiting at once; it ran at 4.6x its
// bound in float64 and 9x in float32, bound by scheduling CTAs.  Now:
//
// - one CTA per (group, tile of the child's valid rows): the CTA reads its
//   front's map row once and compacts the valid (front index, source index)
//   pairs into shared memory, in order (each thread a run of entries, one
//   prefix sum over the CTA: two barriers whatever the front's width);
// - it walks its tile of the compacted rows times all compacted columns,
//   threads along the columns two entries at a time: one vector load of S,
//   one of the front and one store where the pair's front columns and
//   source columns are both consecutive and aligned to the pair (the
//   nested-dissection maps hold runs), else one entry at a time, so a
//   general map (repeats, gaps, entries < 0 or >= w) stays right;
// - the tiles per group (`extend_add_geometry` in ops/assembly.py) come from
//   the largest valid row count of the group's fronts, which the plan
//   carries (`interop.plan_to_torch`), so that a launch fills the card: 1024
//   groups of 21-44 valid rows take one CTA each, one group of 511 one CTA
//   per row.  The CTAs stride over the tiles, so any count is correct; a
//   count above the valid rows only leaves CTAs without work.
#include "hs_common.cuh"
#include "hs_complex.cuh"

#define B_THREADS 256  // B_THREADS in ops/assembly.py

// two entries a thread: 16 bytes of double, 8 of float (four floats a
// thread were slower: the maps' runs seldom start 16-byte aligned in both
// the front and the source)
template <typename T>
struct BVec2;
template <>
struct BVec2<double> {
  typedef double2 V;
};
template <>
struct BVec2<float> {
  typedef float2 V;
};
template <>
struct BVec2<hs_c128> {  // one value at a time
  typedef hs_c128 V;
};
template <>
struct BVec2<hs_c64> {
  typedef hs_c64 V;
};

template <typename T>
__global__ void __launch_bounds__(B_THREADS)
    extend_add_kernel(T* __restrict__ front, const T* __restrict__ S,
                      const int* __restrict__ src_rows,
                      const int* __restrict__ dst_rows,
                      const int* __restrict__ imap, int G, int m, int w,
                      int trows) {
  constexpr int VEC = hs_traits<T>::complex ? 1 : 2;
  typedef typename BVec2<T>::V VT;
  constexpr unsigned ALIGN = sizeof(VT) - 1;
  extern __shared__ int cmp[];  // [m] front index, then [m] source index
  __shared__ int wsum[B_THREADS / 32];
  int* fj = cmp;
  int* sc = cmp + m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = blockIdx.y; k < G; k += gridDim.y) {
    const int64_t r = dst_rows[k];
    const int64_t s = src_rows[k];
    const int* map = imap + r * m;
    // compact the valid map entries, in order: thread t counts its run of
    // ept consecutive entries, an exclusive prefix over the CTA (a warp scan,
    // then the warps' totals) places them
    const int ept = (m + B_THREADS - 1) / B_THREADS;
    const int i0 = min(tid * ept, m), i1 = min(i0 + ept, m);
    int cnt = 0;
    for (int i = i0; i < i1; ++i) {
      const int a = __ldg(map + i);
      cnt += a >= 0 && a < w;
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int at = incl - cnt, nv = 0;
#pragma unroll
    for (int q = 0; q < B_THREADS / 32; ++q) {
      at += q < warp ? wsum[q] : 0;
      nv += wsum[q];
    }
    for (int i = i0; i < i1; ++i) {
      const int a = __ldg(map + i);
      if (a >= 0 && a < w) {
        fj[at] = i;
        sc[at] = a;
        ++at;
      }
    }
    __syncthreads();  // fj, sc are read below; wsum is rewritten next group
    const int ncg = (nv + VEC - 1) / VEC;  // column groups of a row
    T* fr = front + r * m * (int64_t)m;
    const T* sr = S + s * w * (int64_t)w;
    for (int q0 = blockIdx.x * trows; q0 < nv; q0 += gridDim.x * trows) {
      const int nrow = min(trows, nv - q0);
      for (int idx = tid; idx < nrow * ncg; idx += B_THREADS) {
        const int q = q0 + idx / ncg, j0 = (idx % ncg) * VEC;
        T* frow = fr + (int64_t)fj[q] * m;
        const T* srow = sr + (int64_t)sc[q] * w;
        const int cnt = min(VEC, nv - j0);
        bool run = cnt == VEC;
#pragma unroll
        for (int u = 1; u < VEC; ++u)
          run = run && fj[j0 + u] == fj[j0] + u && sc[j0 + u] == sc[j0] + u;
        T* fp = frow + fj[j0];
        const T* sp = srow + sc[j0];
        bool vec = false;
        if constexpr (VEC > 1)
          vec = run && (reinterpret_cast<uintptr_t>(fp) & ALIGN) == 0 &&
                (reinterpret_cast<uintptr_t>(sp) & ALIGN) == 0;
        if (vec) {
          if constexpr (VEC > 1) {
            const VT a = __ldg(reinterpret_cast<const VT*>(sp));
            VT f = *reinterpret_cast<VT*>(fp);
            const T* av = reinterpret_cast<const T*>(&a);
            T* fv = reinterpret_cast<T*>(&f);
#pragma unroll
            for (int u = 0; u < VEC; ++u) fv[u] += av[u];
            *reinterpret_cast<VT*>(fp) = f;
          }
        } else {
          for (int u = 0; u < cnt; ++u)
            frow[fj[j0 + u]] += hs_ldg(srow + sc[j0 + u]);
        }
      }
    }
    __syncthreads();  // fj and sc are rewritten for the next group
  }
}

template <typename T>
static int extend_add(void* front, const void* S, const void* src_rows,
                      const void* dst_rows, const void* imap, int G, int m,
                      int w, int tiles, int trows, void* stream) {
  if (G <= 0 || m <= 0 || w <= 0) return 0;
  if (tiles < 1 || trows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * m * sizeof(int);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(extend_add_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  dim3 grid((unsigned)(tiles < 65535 ? tiles : 65535),
            (unsigned)(G < 65535 ? G : 65535));
  extend_add_kernel<T><<<grid, B_THREADS, smem, (cudaStream_t)stream>>>(
      (T*)front, (const T*)S, (const int*)src_rows, (const int*)dst_rows,
      (const int*)imap, G, m, w, trows);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_extend_add(void* front, const void* S, const void* src_rows,
                            const void* dst_rows, const void* imap, int G,
                            int m, int w, int tiles, int trows, void* stream) {
  return extend_add<double>(front, S, src_rows, dst_rows, imap, G, m, w, tiles,
                            trows, stream);
}

HS_EXPORT int hs_extend_add_f32(void* front, const void* S,
                                const void* src_rows, const void* dst_rows,
                                const void* imap, int G, int m, int w,
                                int tiles, int trows, void* stream) {
  return extend_add<float>(front, S, src_rows, dst_rows, imap, G, m, w, tiles,
                           trows, stream);
}

HS_EXPORT int hs_extend_add_c128(void* front, const void* S,
                                 const void* src_rows, const void* dst_rows,
                                 const void* imap, int G, int m, int w,
                                 int tiles, int trows, void* stream) {
  return extend_add<hs_c128>(front, S, src_rows, dst_rows, imap, G, m, w,
                             tiles, trows, stream);
}

HS_EXPORT int hs_extend_add_c64(void* front, const void* S,
                                const void* src_rows, const void* dst_rows,
                                const void* imap, int G, int m, int w,
                                int tiles, int trows, void* stream) {
  return extend_add<hs_c64>(front, S, src_rows, dst_rows, imap, G, m, w,
                            tiles, trows, stream);
}
