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
// The caller launches the left groups before the right ones, as JAX adds them.
//
// Bound: memory (one read of the child's Schur rows, one read-modify-write of
// the front entries it covers).  One block per (group row, front row i): the
// row map entry imap[r, i] is read once and a row outside the child's
// placement exits before touching memory; threads run along j, where imap is
// an offset identity, so the loads of S and the front row are coalesced.
#include "hs_common.cuh"

__global__ void extend_add_kernel(double* __restrict__ front,
                                  const double* __restrict__ S,
                                  const int* __restrict__ src_rows,
                                  const int* __restrict__ dst_rows,
                                  const int* __restrict__ imap, int G, int m,
                                  int w) {
  for (int k = blockIdx.y; k < G; k += gridDim.y) {
    const int64_t r = dst_rows[k];
    const int64_t s = src_rows[k];
    const int* map = imap + r * m;
    for (int i = blockIdx.x; i < m; i += gridDim.x) {
      const int a = map[i];
      if (a < 0 || a >= w) continue;
      double* frow = front + (r * m + i) * (int64_t)m;
      const double* srow = S + (s * w + a) * (int64_t)w;
      for (int j = threadIdx.x; j < m; j += blockDim.x) {
        const int c = map[j];
        if (c >= 0 && c < w) frow[j] += srow[c];
      }
    }
  }
}

HS_EXPORT int hs_extend_add(void* front, const void* S, const void* src_rows,
                            const void* dst_rows, const void* imap, int G,
                            int m, int w, void* stream) {
  if (G > 0 && m > 0 && w > 0) {
    const int threads = 128;
    dim3 grid((unsigned)(m < 65535 ? m : 65535),
              (unsigned)(G < 65535 ? G : 65535));
    extend_add_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (double*)front, (const double*)S, (const int*)src_rows,
        (const int*)dst_rows, (const int*)imap, G, m, w);
  }
  return (int)cudaGetLastError();
}
